"""``tokenizer.json`` fixtures for the port's reader tests, built offline.

Each family's structure (as its published ``tokenizer.json`` has it) is
trained by the ``tokenizers`` wheel's own trainers on a seeded corpus and
saved into a directory; the SentencePiece-style ones then get their 256
``<0xXX>`` byte tokens in the model's vocabulary, where Llama-2's and
Gemma's files keep them. ``hazard_strings`` draws test strings with
numpy from an alphabet of the characters where a reader is most likely to
part from the wheel.
"""

import json
import os

import numpy as np
from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models, normalizers,
                        pre_tokenizers, processors, trainers)

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

WORDS = ("the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog", "river",
         "bank", "notes", "say", "about", "What", "Which", "mention", "Tell", "more",
         "ka", "lo", "mi", "ne", "ru", "ta", "vo", "si", "de", "pa", "gu", "hi", "zo",
         "kalomi", "taneru", "vosi", "depagu", "don't", "it's", "we'll", "they've",
         "I'm", "HELLO", "World", "2024", "12345", "3.14", "café", "naïve", "über",
         "日本語", "中文", "字", "😀", "👍🏽", "Σίσυφος", "Привет", "नमस्ते")
ATOMS = WORDS + (
    " ", " ", " ", "  ", "\n", "\r\n", "\n\n", "\t", ".", ",", "!", "?", "'s", "'S",
    "'ll", "'LL", "'", "\"", "-", "(", ")", "<", ">", "|", "#", "##", "_", "▁",
    "\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0", "　", " ", "​",
    "\x00", "\x0b", "\x0c", "�", "é", "̈", "à̖", "ſ", "K",
    "İ", "ß", "ﬁ", "Å", "①", "¹", "½", "🥰", "👨‍👩‍👧", "🇳🇱", "\U0001fae8", "𝔘", "ΑΣ",
    "<|begin_of_text|>", "<|eot_id|>", "<|start_header_id|>", "<|end_header_id|>",
    "<s>", "</s>", "<unk>", "<bos>", "<eos>", "<|im_start|>", "<|im_end|>",
    "<tool_call>", "<|assistant|>", "<|end|>", "<|user|>", "<|placeholder1|>",
    "[CLS]", "[SEP]", "[MASK]", "[PAD]", "zork", "Zork", "xzork", "<0x41>", "0x41",
    "<start_of_turn>", "<end_of_turn>")


def corpus(seed: int, n: int = 400) -> list:
    """Seeded training sentences over WORDS."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = rng.choice(len(WORDS), int(rng.integers(3, 14)))
        seps = rng.choice([" ", " ", " ", ", ", ". ", "\n", "  "], len(words))
        out.append("".join(WORDS[w] + s for w, s in zip(words, seps)).strip())
    return out


def hazard_strings(seed: int, n: int) -> list:
    """``n`` strings of 0-14 atoms drawn from ATOMS (the first is empty)."""
    rng = np.random.default_rng(seed)
    out = [""]
    while len(out) < n:
        k = int(rng.integers(1, 15))
        out.append("".join(ATOMS[i] for i in rng.choice(len(ATOMS), k)))
    return out


def _bpe_trainer(vocab: int, specials=(), alphabet=()):
    return trainers.BpeTrainer(vocab_size=vocab, special_tokens=list(specials),
                               initial_alphabet=list(alphabet), show_progress=False,
                               min_frequency=1)


def _save(tok: Tokenizer, path: str, edit=None) -> str:
    os.makedirs(path, exist_ok=True)
    obj = json.loads(tok.to_str())
    if edit is not None:
        edit(obj)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)
    return path


def _with_byte_tokens(specials: list):
    """An edit that puts ``specials`` first, the 256 ``<0xXX>`` tokens next
    and the trained vocabulary after, renumbering the added tokens."""
    def edit(obj):
        vocab = obj["model"]["vocab"]
        order = list(specials) + [f"<0x{b:02X}>" for b in range(256)]
        order += [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1]) if t not in order]
        obj["model"]["vocab"] = {t: i for i, t in enumerate(order)}
        ids = obj["model"]["vocab"]
        base = len(order)
        for i, tok in enumerate(obj["added_tokens"]):
            tok["id"] = ids.get(tok["content"], base)
            if tok["content"] not in ids:
                base += 1
        _renumber_specials(obj)
    return edit


def _renumber_specials(obj):
    ids = {t["content"]: t["id"] for t in obj["added_tokens"]}
    ids.update(obj["model"]["vocab"])
    post = obj.get("post_processor") or {}
    for p in [post] + post.get("processors", []):
        for name, spec in (p.get("special_tokens") or {}).items():
            spec["ids"] = [ids[t] for t in spec["tokens"]]


def _template(bos: str, bos_id: int, pair_bos: bool = True):
    pair = f"{bos} $A {bos}:1 $B:1" if pair_bos else f"{bos} $A $B:1"
    return processors.TemplateProcessing(single=f"{bos} $A", pair=pair,
                                         special_tokens=[(bos, bos_id)])


def llama3(path: str, seed: int = 0, vocab: int = 700) -> str:
    """Llama-3's structure: Split(regex) + ByteLevel, ignore_merges, the
    specials after the BPE vocabulary, BOS by a template after ByteLevel."""
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), "isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus(seed), _bpe_trainer(
        vocab, alphabet=pre_tokenizers.ByteLevel.alphabet()))
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
                "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False) for s in specials])
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        _template("<|begin_of_text|>", bos)])
    return _save(tok, path)


def qwen2(path: str, seed: int = 0, vocab: int = 700) -> str:
    """Qwen2's: NFC, Split(regex) + ByteLevel, ByteLevel post-processor,
    special and non-special added tokens."""
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), "isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.train_from_iterator(corpus(seed + 1), _bpe_trainer(
        vocab, alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False)
                            for s in ("<|endoftext|>", "<|im_start|>", "<|im_end|>")])
    tok.add_tokens([AddedToken(s, special=False, normalized=False)
                    for s in ("<tool_call>", "</tool_call>")])
    return _save(tok, path)


def mistral(path: str, seed: int = 0, vocab: int = 600) -> str:
    """Mixtral's and Llama-2's: Prepend + Replace, no pre-tokenizer, BPE
    with byte fallback and fused unknowns, <unk> <s> </s> at 0-2, the byte
    tokens at 3-258; a normalized added token ("zork", single word)."""
    specials = ["<unk>", "<s>", "</s>"]
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator(corpus(seed + 2), _bpe_trainer(vocab, specials))
    tok.post_processor = _template("<s>", 1)
    tok.add_tokens([AddedToken("zork", single_word=True, normalized=True, special=False)])
    return _save(tok, path, _with_byte_tokens(specials))


def phi3(path: str, seed: int = 0, vocab: int = 600) -> str:
    """Phi-3's: Metaspace (prepend "first", no split) in place of the
    normalizers, byte fallback, and its chat tokens after the vocabulary
    (rstrip on the role tokens; one with lstrip)."""
    specials = ["<unk>", "<s>", "</s>"]
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first",
                                                 split=False)
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator(corpus(seed + 3), _bpe_trainer(vocab, specials))
    tok.post_processor = _template("<s>", 1)
    tok.add_special_tokens(
        [AddedToken("<|endoftext|>", special=True, normalized=False)]
        + [AddedToken(s, rstrip=True, special=True, normalized=False)
           for s in ("<|assistant|>", "<|system|>", "<|end|>", "<|user|>")]
        + [AddedToken("<|placeholder1|>", lstrip=True, special=True, normalized=False)])
    return _save(tok, path, _with_byte_tokens(specials))


def gemma(path: str, seed: int = 0, vocab: int = 600) -> str:
    """Gemma's: Replace(" ", "▁") alone, a Split on " " merged with the
    previous piece, byte fallback, no dummy prefix, <bos> by a template."""
    specials = ["<pad>", "<eos>", "<bos>", "<unk>", "<mask>", "<start_of_turn>",
                "<end_of_turn>"]
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Replace(" ", "▁")
    tok.pre_tokenizer = pre_tokenizers.Split(" ", "merged_with_previous")
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse()])
    tok.train_from_iterator(corpus(seed + 4), _bpe_trainer(vocab, specials))
    tok.post_processor = _template("<bos>", 2, pair_bos=False)
    return _save(tok, path, _with_byte_tokens(specials))


def bert(path: str, seed: int = 0, vocab: int = 500, truncation=None, padding=None) -> str:
    """BERT's WordPiece (uncased): BertNormalizer, BertPreTokenizer, the
    [CLS] A [SEP] B [SEP] template, the WordPiece decoder; a normalized
    added token ("Zork"); optional truncation and padding sections."""
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]", max_input_chars_per_word=12))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece(prefix="##", cleanup=True)
    tok.train_from_iterator(corpus(seed + 5), trainers.WordPieceTrainer(
        vocab_size=vocab, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"],
        show_progress=False))
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", tok.token_to_id("[CLS]")),
                        ("[SEP]", tok.token_to_id("[SEP]"))])
    tok.add_tokens([AddedToken("Zork", normalized=True, special=False)])
    if truncation:
        tok.enable_truncation(**truncation)
    if padding:
        tok.enable_padding(**padding)
    return _save(tok, path)


FAMILIES = {"llama3": llama3, "qwen2": qwen2, "mistral": mistral, "phi3": phi3,
            "gemma": gemma, "bert": bert}
