"""Write a ``tokenizer.json`` of a model family's structure, in plain Python.

``tools/synthetic_checkpoint.py`` writes one beside every checkpoint, so
the loaders tokenize through the port's reader (``models/tokenizer_json.py``)
as they would a published checkpoint. Each file has its family's structure,
as the published ``tokenizer.json`` of that family has it:

- ``llama3`` (Llama-3.1-8B): byte-level BPE behind Llama-3's split regex,
  ``ignore_merges``, 128,000 tokens, then 256 special tokens at
  128000-128255 (``<|begin_of_text|>``, ``<|end_of_text|>`` 128001,
  ``<|eot_id|>`` 128009, ...), BOS added by a template;
- ``qwen25`` / ``qwen3`` (Qwen2.5-7B, Qwen3-30B-A3B): NFC, byte-level BPE
  behind Qwen2's regex, 151,643 tokens, then the 22 (Qwen3: 26) added
  tokens from ``<|endoftext|>`` 151643 on, no BOS;
- ``llama2`` (Mixtral-8x7B) and ``phi3`` (Phi-3-mini): SentencePiece-style
  BPE with byte fallback and fused unknowns (``Prepend("▁")`` and
  ``Replace(" ", "▁")``), ``<unk>`` ``<s>`` ``</s>`` at 0-2, the 256
  ``<0xXX>`` tokens at 3-258, 32,000 tokens; Phi-3 adds its 11 chat tokens
  at 32000-32010;
- ``gemma`` (Gemma-7B, Gemma-2-9B): ``Replace(" ", "▁")`` alone, byte
  fallback, ``<pad>`` ``<eos>`` ``<bos>`` ``<unk>`` at 0-3, 256,000 tokens;
- ``bert`` (the GIST-small and MiniLM encoders): uncased WordPiece,
  ``[PAD]`` 0, ``[UNK]`` 100, ``[CLS]`` 101, ``[SEP]`` 102, ``[MASK]`` 103,
  30,522 tokens (GIST-small's file truncates at 512).

BPE merges are valid (each merge's parts are already tokens) and follow
from ``seed``: a pair-count pass learns the first ones from a seeded
sample of syllable words (as chip_smoke.py's corpus has them) and of the
port's prompt texts; seeded merges of existing tokens fill the rest.
``vocab`` cuts the model's vocabulary (before the added tokens) to a
smaller size of the same structure; ``write_tokenizer`` cuts it to fit a
model config's ``vocab_size``. ``GOLDEN_STRINGS`` are the strings
whose ids ``tools/tokenizer_goldens.py`` holds for ``GOLDEN_SEED``.
"""

from __future__ import annotations

import json
import os
import textwrap
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ragmeup_tpu_torch import config as port_config
from ragmeup_tpu_torch.models.tokenizer_json import BYTE_CHAR, byte_level, translate

SYLLABLES = ("ka", "lo", "mi", "ne", "ru", "ta", "vo", "si", "de", "pa",
             "gu", "hi", "zo", "be", "fa", "ti", "mo", "ly", "xa", "qe")
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LEARNED_MERGES = 1500        # merges the pair-count pass learns before the fill
MAX_TOKEN_CHARS = 16         # the fill's merged tokens are at most this long

# model -> structure; the structure's model vocabulary at full size
STRUCTURES = {"llama31_8b": "llama3", "qwen25_7b": "qwen25", "qwen3_30b_a3b": "qwen3",
              "mixtral_8x7b": "llama2", "phi3_mini_4k": "phi3", "gemma_7b": "gemma",
              "gemma2_9b": "gemma", "gist_small": "bert", "minilm_l6_cross": "bert"}
FULL_VOCAB = {"llama3": 128000, "qwen25": 151643, "qwen3": 151643, "llama2": 32000,
              "phi3": 32000, "gemma": 256000, "bert": 30522}
GOLDEN_SEED = 0
# each structure's goldens come from this model's file at GOLDEN_SEED, full size
GOLDEN_MODELS = {"llama3": "llama31_8b", "qwen25": "qwen25_7b", "qwen3": "qwen3_30b_a3b",
                 "llama2": "mixtral_8x7b", "phi3": "phi3_mini_4k", "gemma": "gemma2_9b",
                 "bert": "gist_small"}

LLAMA3_SPECIALS = (["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                    "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                    "<|reserved_special_token_2|>", "<|start_header_id|>",
                    "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
                   + [f"<|reserved_special_token_{i}|>" for i in range(3, 248)])
QWEN25_ADDED = ([(t, True) for t in (
    "<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
    "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>", "<|quad_end|>",
    "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>", "<|image_pad|>",
    "<|video_pad|>")] + [(t, False) for t in (
        "<tool_call>", "</tool_call>", "<|fim_prefix|>", "<|fim_middle|>", "<|fim_suffix|>",
        "<|fim_pad|>", "<|repo_name|>", "<|file_sep|>")])
QWEN3_ADDED = QWEN25_ADDED + [(t, False) for t in (
    "<tool_response>", "</tool_response>", "<think>", "</think>")]
PHI3_ADDED = ["<|endoftext|>", "<|assistant|>", "<|placeholder1|>", "<|placeholder2|>",
              "<|placeholder3|>", "<|placeholder4|>", "<|system|>", "<|end|>",
              "<|placeholder5|>", "<|placeholder6|>", "<|user|>"]
# the added tokens a structure puts past its model vocabulary
ADDED_PAST = {"llama3": len(LLAMA3_SPECIALS), "qwen25": len(QWEN25_ADDED),
              "qwen3": len(QWEN3_ADDED), "phi3": len(PHI3_ADDED)}
GEMMA_SPECIALS = (["<pad>", "<eos>", "<bos>", "<unk>", "<mask>", "[@BOS@]"]
                  + [f"<unused{i}>" for i in range(99)]
                  + ["<start_of_turn>", "<end_of_turn>"])
BERT_SPECIALS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103}
# the characters a SentencePiece or WordPiece vocabulary starts from
BASE_CHARS = ("".join(chr(c) for c in range(0x21, 0x7F))
              + "àáâäçèéêëíîïñóôöúûüßæøåœ—–‘’“”…€£°·×"
              + "αβγδεσπωабвгдежиклмнопрстуя的一是不了人我在有他这中大来上国个到说们为子和你地出道也时年")

GOLDEN_STRINGS = (
    "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\nYou are a helpful "
    "assistant.<|eot_id|><|start_header_id|>user<|end_header_id|>\n\nWhat do the notes say "
    "about kalomi tane?<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n",
    "What do the notes say about kalomi taneru vosi?",
    "Emoji: 😀 👍🏽 👨‍👩‍👧 🇳🇱 \U0001fae8 done",
    "CJK: 日本語のテキスト、中文字符，한국어 텍스트.",
    "Combining: é ä ñ क्ष à̖",
    "Controls: a\x1cb\x1dc\x1ed\x1fe | next\x85line | no\xa0break | ideo　space",
    "Digits: 1 12 123 1234 12345 3.14159 2024-10-18 0x41",
    "IT'S, it's, we'll, WE'LL, they've, I'm, you'd, she'S",
    "Line one\r\nLine two\r\n\r\n  indented\ttab\n\n\nend  ",
    "Special text: <s> </s> <unk> [CLS] [SEP] <|im_start|> <bos> <0x41>",
    "Ünïcödé naïve café façade Straße ſ K İ ﬁ ①",
    "",
)


# ---------------------------------------------------------------------------
# merges
# ---------------------------------------------------------------------------


def _sample_text(seed: int) -> List[str]:
    """Seeded sample of the text a run tokenizes: sentences of syllable
    words over a Zipf vocabulary (chip_smoke.py's corpus) and the port's
    prompt texts."""
    rng = np.random.default_rng(seed)
    words = sorted({"".join(rng.choice(SYLLABLES, rng.integers(2, 4))) for _ in range(3000)})
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    sample = [" ".join(rng.choice(words, int(rng.integers(20, 40)), p=p)) for _ in range(400)]
    prompts = [v for k, v in sorted(vars(port_config).items())
               if k.isupper() and isinstance(v, str)]
    return sample + prompts * 4


def learn_merges(words: Dict[Tuple[str, ...], int], n: int) -> List[Tuple[str, str]]:
    """Up to ``n`` BPE merges over ``words`` (symbol tuples with counts):
    each step merges the most frequent adjacent pair (ties: the larger
    pair of strings), while a pair occurs at least twice."""
    seqs = [list(w) for w in words]
    counts = list(words.values())
    pairs: Counter = Counter()
    where: Dict[Tuple[str, str], set] = defaultdict(set)
    for i, w in enumerate(seqs):
        for pair in zip(w, w[1:]):
            pairs[pair] += counts[i]
            where[pair].add(i)
    merges = []
    while len(merges) < n and pairs:
        best, cnt = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if cnt < 2:
            break
        merges.append(best)
        a, b = best
        for i in sorted(where.pop(best, ())):
            w, c = seqs[i], counts[i]
            for pair in zip(w, w[1:]):
                pairs[pair] -= c
            out, j = [], 0
            while j < len(w):
                if j + 1 < len(w) and w[j] == a and w[j + 1] == b:
                    out.append(a + b)
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            seqs[i] = out
            for pair in zip(out, out[1:]):
                pairs[pair] += c
                where[pair].add(i)
        pairs = Counter({k: v for k, v in pairs.items() if v > 0})
    return merges


def fill_merges(tokens: List[str], known: set, merges: List[Tuple[str, str]], size: int,
                rng: np.random.Generator) -> None:
    """Seeded merges until ``tokens`` holds ``size``: a drawn token and one
    of the tokens held before the fill (the base and learned ones), when
    the result is new and at most MAX_TOKEN_CHARS long."""
    short = len(tokens)
    while len(tokens) < size:
        n = len(tokens)
        for i, j in zip(rng.integers(0, n, 8192).tolist(), rng.integers(0, short, 8192).tolist()):
            a, b = tokens[i], tokens[j]
            new = a + b
            if len(new) <= MAX_TOKEN_CHARS and new not in known:
                tokens.append(new)
                known.add(new)
                merges.append((a, b))
                if len(tokens) == size:
                    return


def _bpe_vocab(base: List[str], words: Counter, size: int, seed: int,
               first_ids: int = 0) -> Tuple[List[str], List[Tuple[str, str]]]:
    """``base`` tokens, then learned and filled merges up to ``size``
    tokens (``first_ids`` more come before them in the file)."""
    rng = np.random.default_rng(seed)
    tokens, merges = list(base), []
    known = set(tokens)
    budget = size - first_ids
    if budget < len(tokens):
        raise ValueError(f"a vocabulary of {size} is below the structure's "
                         f"{first_ids + len(tokens)} base tokens")
    for a, b in learn_merges(words, min(LEARNED_MERGES, budget - len(tokens))):
        if a in known and b in known and a + b not in known:
            tokens.append(a + b)
            known.add(a + b)
            merges.append((a, b))
    fill_merges(tokens, known, merges, budget, rng)
    return tokens, merges


def _added(content: str, tid: int, special: bool = True, rstrip: bool = False) -> dict:
    return {"id": tid, "content": content, "single_word": False, "lstrip": False,
            "rstrip": rstrip, "normalized": False, "special": special}


def _template(bos: Optional[str], bos_id: Optional[int]) -> Optional[dict]:
    if bos is None:
        return None
    tok = {"SpecialToken": {"id": bos, "type_id": 0}}
    return {"type": "TemplateProcessing",
            "single": [tok, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [tok, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": bos, "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {bos: {"id": bos, "ids": [bos_id], "tokens": [bos]}}}


def _bpe_model(vocab: Dict[str, int], merges, pairs: bool, **kw) -> dict:
    return {"type": "BPE", "dropout": None, "unk_token": kw.get("unk_token"),
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": kw.get("fuse_unk", False), "byte_fallback": kw.get("byte_fallback", False),
            "ignore_merges": kw.get("ignore_merges", False), "vocab": vocab,
            "merges": [[a, b] for a, b in merges] if pairs else [f"{a} {b}" for a, b in merges]}


# ---------------------------------------------------------------------------
# the structures
# ---------------------------------------------------------------------------


def byte_level_file(structure: str, size: int, seed: int) -> dict:
    """Llama-3's or Qwen2's file: ``size`` BPE tokens, then the added ones."""
    pattern = LLAMA3_PATTERN if structure == "llama3" else QWEN2_PATTERN
    split = translate(pattern)
    words: Counter = Counter()
    for text in _sample_text(seed):
        for m in split.finditer(text):
            words[tuple(byte_level(m.group()))] += 1
    base = [BYTE_CHAR[b] for b in sorted(BYTE_CHAR, key=lambda b: ord(BYTE_CHAR[b]))]
    tokens, merges = _bpe_vocab(base, words, size, seed)
    vocab = {t: i for i, t in enumerate(tokens)}
    byte_pre = {"type": "ByteLevel", "add_prefix_space": False,
                "trim_offsets": structure == "llama3", "use_regex": False}
    obj = {"version": "1.0", "truncation": None, "padding": None,
           "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
               {"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated",
                "invert": False}, byte_pre]},
           "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                       "use_regex": True}}
    if structure == "llama3":
        obj["added_tokens"] = [_added(t, size + i) for i, t in enumerate(LLAMA3_SPECIALS)]
        obj["normalizer"] = None
        obj["post_processor"] = {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True}, _template("<|begin_of_text|>", size)]}
        obj["model"] = _bpe_model(vocab, merges, pairs=False, ignore_merges=True)
    else:
        added = QWEN25_ADDED if structure == "qwen25" else QWEN3_ADDED
        obj["added_tokens"] = [_added(t, size + i, special)
                               for i, (t, special) in enumerate(added)]
        obj["normalizer"] = {"type": "NFC"}
        obj["post_processor"] = dict(byte_pre, trim_offsets=False)
        obj["decoder"] = dict(byte_pre, trim_offsets=False)
        obj["model"] = _bpe_model(vocab, merges, pairs=False)
    return obj


def sentencepiece_file(structure: str, size: int, seed: int) -> dict:
    """Mixtral's (Llama-2's), Phi-3's or Gemma's file: byte-fallback BPE
    over "▁"-joined words, specials and byte tokens first."""
    specials = ["<unk>", "<s>", "</s>"] if structure != "gemma" else GEMMA_SPECIALS
    first = specials + [f"<0x{b:02X}>" for b in range(256)]
    words: Counter = Counter()
    for text in _sample_text(seed):
        text = ("" if structure == "gemma" else "▁") + text.replace(" ", "▁")
        for w in text.replace("▁", " ▁").split(" "):
            if w:
                words[tuple(w)] += 1
    tokens, merges = _bpe_vocab(list(dict.fromkeys("▁" + BASE_CHARS)), words, size, seed,
                                first_ids=len(first))
    vocab = {t: i for i, t in enumerate(first + tokens)}
    if structure == "gemma":
        added = [_added(t, i) for i, t in enumerate(specials)]
        normalizer = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
        post = _template("<bos>", 2)
        tail = []
    else:
        added = [_added(t, i) for i, t in enumerate(specials)]
        if structure == "phi3":
            added += [_added(t, size + i, rstrip=i > 0) for i, t in enumerate(PHI3_ADDED)]
        normalizer = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
        post = _template("<s>", 1)
        tail = [{"type": "Strip", "content": " ", "start": 1, "stop": 0}]
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": normalizer, "pre_tokenizer": None, "post_processor": post,
            "decoder": {"type": "Sequence", "decoders": [
                {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"}] + tail},
            "model": _bpe_model(vocab, merges, pairs=True, unk_token="<unk>", fuse_unk=True,
                                byte_fallback=True)}


def bert_file(size: int, seed: int, truncate: bool) -> dict:
    """An uncased WordPiece file: the specials where BERT has them,
    single characters and their ``##`` forms, the sample's words and
    word pieces by count, then seeded syllable words to ``size``."""
    rng = np.random.default_rng(seed)
    vocab: Dict[str, int] = dict(BERT_SPECIALS)
    free = (i for i in range(size) if i not in BERT_SPECIALS.values())
    order = [f"[unused{i}]" for i in range(99)] + list(BASE_CHARS.lower())
    order += ["##" + c for c in BASE_CHARS.lower()]
    counts: Counter = Counter()
    for text in _sample_text(seed):
        for w in text.lower().replace(".", " ").replace(",", " ").split():
            counts[w] += 1
            for k in range(2, len(w) - 1, 2):
                counts["##" + w[k:]] += 1
    order += [w for w, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))]
    for t in order:
        if len(vocab) < size and t not in vocab:
            vocab[t] = next(free)
    while len(vocab) < size:
        w = "".join(rng.choice(SYLLABLES, int(rng.integers(1, 5))))
        w = "##" + w if rng.random() < 0.3 else w
        if w not in vocab:
            vocab[w] = next(free)
    added = [_added(t, i) for t, i in sorted(BERT_SPECIALS.items(), key=lambda kv: kv[1])]
    cls_sep = {t: {"id": t, "ids": [BERT_SPECIALS[t]], "tokens": [t]} for t in ("[CLS]", "[SEP]")}
    seq = lambda s, t: {"Sequence": {"id": s, "type_id": t}}  # noqa: E731
    special = lambda s, t: {"SpecialToken": {"id": s, "type_id": t}}  # noqa: E731
    return {
        "version": "1.0",
        "truncation": ({"direction": "Right", "max_length": 512, "strategy": "LongestFirst",
                        "stride": 0} if truncate else None),
        "padding": ({"strategy": "BatchLongest", "direction": "Right", "pad_to_multiple_of": None,
                     "pad_id": 0, "pad_type_id": 0, "pad_token": "[PAD]"} if truncate else None),
        "added_tokens": added,
        "normalizer": {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True,
                       "strip_accents": None, "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [special("[CLS]", 0), seq("A", 0), special("[SEP]", 0)],
                           "pair": [special("[CLS]", 0), seq("A", 0), special("[SEP]", 0),
                                    seq("B", 1), special("[SEP]", 1)],
                           "special_tokens": cls_sep},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab}}


def tokenizer_file(model: str, seed: int = GOLDEN_SEED, vocab: Optional[int] = None) -> dict:
    """``model``'s ``tokenizer.json`` as a dict (``STRUCTURES``)."""
    structure = STRUCTURES[model]
    size = int(vocab or FULL_VOCAB[structure])
    if structure in ("llama3", "qwen25", "qwen3"):
        return byte_level_file(structure, size, seed)
    if structure == "bert":
        return bert_file(size, seed, truncate=model == "gist_small")
    return sentencepiece_file(structure, size, seed)


def file_ids(obj: dict) -> List[int]:
    """Every id a file's vocabulary and added tokens give."""
    return list(obj["model"]["vocab"].values()) + [t["id"] for t in obj["added_tokens"]]


def model_vocab(model: str, vocab_size: Optional[int] = None) -> int:
    """The model vocabulary of ``model``'s file: the family's, cut so that
    the added tokens past it stay below ``vocab_size`` (the model config's;
    None: no cut)."""
    structure = STRUCTURES[model]
    if vocab_size is None:
        return FULL_VOCAB[structure]
    return min(FULL_VOCAB[structure], int(vocab_size) - ADDED_PAST.get(structure, 0))


def write_tokenizer(out_dir: str, model: str, seed: int = GOLDEN_SEED,
                    vocab_size: Optional[int] = None) -> Dict[str, float]:
    """Write ``out_dir/tokenizer.json`` for ``model``, its ids below
    ``vocab_size`` (``model_vocab``). Returns its token count, bytes and
    seconds."""
    t0 = time.perf_counter()
    obj = tokenizer_file(model, seed, model_vocab(model, vocab_size))
    top = max(file_ids(obj))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "tokenizer.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)
    return {"tokens": float(top + 1), "bytes": float(os.path.getsize(path)),
            "seconds": time.perf_counter() - t0}


def golden_ids(structure: str) -> List[List[int]]:
    """The reader's ids of GOLDEN_STRINGS on ``structure``'s golden file."""
    from ragmeup_tpu_torch.models.tokenizer_json import Tokenizer
    model = GOLDEN_MODELS[structure]
    tok = Tokenizer(tokenizer_file(model, GOLDEN_SEED), source=f"{model} seed {GOLDEN_SEED}")
    return [tok.encode(s)[0] for s in GOLDEN_STRINGS]


def check_goldens() -> Dict[str, dict]:
    """Each structure's golden file built again and read by the reader: its
    ids of GOLDEN_STRINGS against ``tools/tokenizer_goldens.py``. Returns,
    per structure, the strings that differ and the seconds it took."""
    from ragmeup_tpu_torch.tools.tokenizer_goldens import GOLDEN_IDS
    out = {}
    for structure in GOLDEN_MODELS:
        t0 = time.perf_counter()
        got = golden_ids(structure)
        out[structure] = {"differ": [i for i, (g, w) in enumerate(zip(got, GOLDEN_IDS[structure]))
                                     if g != w] + list(range(len(GOLDEN_IDS[structure]), len(got))),
                          "ids": sum(map(len, got)), "s": time.perf_counter() - t0}
    return out


def write_goldens(path: str) -> None:
    """Write ``tools/tokenizer_goldens.py`` from the reader's ids (tests
    hold them against the `tokenizers` wheel on the same files)."""
    lines = ['"""Golden ids of ``synthetic_tokenizer.GOLDEN_STRINGS`` on each structure\'s',
             "file at GOLDEN_SEED, full size. Written by ``python3 -m",
             "ragmeup_tpu_torch.tools.synthetic_tokenizer --goldens PATH``;",
             "tests/test_torch_tokenizer_system.py holds them against the `tokenizers`",
             'wheel, chip_smoke.py against the reader on the card."""', "",
             "GOLDEN_IDS = {"]
    for structure in GOLDEN_MODELS:
        lines.append(f"    {structure!r}: [")
        for ids in golden_ids(structure):
            text = textwrap.fill(", ".join(map(str, ids)), width=88, initial_indent="        [",
                                 subsequent_indent="         ")
            lines.append((text or "        [") + "],")
        lines.append("    ],")
    lines.append("}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--goldens", metavar="PATH", help="write the goldens module to PATH")
    args = ap.parse_args()
    if args.goldens:
        write_goldens(args.goldens)
    print(json.dumps(check_goldens()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
