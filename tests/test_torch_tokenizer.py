"""The port's ``tokenizer.json`` reader against the `tokenizers` wheel, on the CPU.

The port's ``load_tokenizer`` (``ragmeup_tpu_torch/models/tokenizer.py`` on
``models/tokenizer_json.py``) must give exactly what the JAX package's
``load_tokenizer`` gives (its ``HFTokenizer`` wraps the wheel). Held here:

- one fixture per family structure (Llama-3, Qwen2, Mistral/Llama-2 with
  byte fallback, Phi-3 with its chat tokens, Gemma, BERT WordPiece), each
  trained in the test by the wheel's trainers (tests/tokenizer_fixtures.py):
  ``encode``, ``encode(max_len)``, ``encode_pair`` ids and type ids,
  ``tokenize_ids``, ``decode`` (with special ids, random ids and broken
  byte sequences), ``vocab_size`` and ``pad_id``, over 300 strings drawn
  with numpy from an alphabet of hazard characters (U+001C-U+001F, U+0085,
  U+00A0, CJK, emoji, combining marks, special-token text);
- each other component and option the reader takes, one file each (every
  Split behavior with and without ``invert``, ByteLevel with GPT-2's regex,
  Metaspace's schemes, the other normalizers, pre-tokenizers,
  post-processors and decoders, BPE's prefix and suffix, added tokens'
  ``single_word`` / ``lstrip`` / ``rstrip`` / ``normalized``, and
  ``truncation`` and ``padding`` sections): ids and type ids with and
  without special tokens, single and pair, and decoded text, against the
  wheel's ``Tokenizer``;
- a component the reader does not take raises ``NotImplementedError``
  naming it and the file, and ``load_tokenizer`` never falls through to
  ``SimpleTokenizer`` when ``tokenizer.json`` exists.
"""

import json
import os

import numpy as np
import pytest
from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models, normalizers,
                        pre_tokenizers as pt, processors, trainers)

import tokenizer_fixtures as fx
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)
from ragmeup_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer
from ragmeup_tpu_torch.models import tokenizer_json
from ragmeup_tpu_torch.models.tokenizer import (HFTokenizer, SimpleTokenizer,
                                                WordPieceTokenizer, load_tokenizer)

STRINGS = fx.hazard_strings(0, 300)
PAIRS = [(s, STRINGS[(7 * i + 3) % len(STRINGS)]) for i, s in enumerate(STRINGS)]


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """family -> (the port's tokenizer, the JAX package's, the wheel's)."""
    root = tmp_path_factory.mktemp("families")
    out = {}
    for name, build in fx.FAMILIES.items():
        d = build(str(root / name))
        port, jax_tok = load_tokenizer(d), jax_load_tokenizer(d)
        out[name] = (port, jax_tok, Tokenizer.from_file(os.path.join(d, "tokenizer.json")))
    return out


@pytest.mark.parametrize("family", list(fx.FAMILIES))
def test_family_encodes_as_the_wheel(families, family):
    port, jax_tok, _ = families[family]
    assert isinstance(port, HFTokenizer) and type(jax_tok).__name__ == "HFTokenizer"
    for s in STRINGS:
        assert port.encode(s) == jax_tok.encode(s), s
        assert port.encode(s, max_len=7) == jax_tok.encode(s, max_len=7), s
        assert port.tokenize_ids(s) == jax_tok.tokenize_ids(s), s


@pytest.mark.parametrize("family", list(fx.FAMILIES))
def test_family_pairs_as_the_wheel(families, family):
    port, jax_tok, _ = families[family]
    for a, b in PAIRS:
        assert port.encode_pair(a, b) == jax_tok.encode_pair(a, b), (a, b)
        assert port.encode_pair(a, b, max_len=9) == jax_tok.encode_pair(a, b, max_len=9)


def _byte_ids(wheel: Tokenizer, family: str, data: bytes) -> list:
    """The ids of ``data``'s bytes as the family's byte tokens."""
    if family in ("llama3", "qwen2"):
        return [wheel.token_to_id(tokenizer_json.BYTE_CHAR[b]) for b in data]
    if family == "bert":
        return []
    return [wheel.token_to_id(f"<0x{b:02X}>") for b in data]


@pytest.mark.parametrize("family", list(fx.FAMILIES))
def test_family_decodes_as_the_wheel(families, family):
    """Encoded strings with their special ids, random ids (unknown ones
    too) and broken UTF-8 byte runs between ordinary tokens."""
    port, jax_tok, wheel = families[family]
    rng = np.random.default_rng(1)
    cases = [jax_tok.encode(s) for s in STRINGS]
    vocab = wheel.get_vocab_size()
    cases += [rng.integers(0, vocab + 3, int(rng.integers(0, 16))).tolist()
              for _ in range(200)]
    word = jax_tok.tokenize_ids("kalomi notes")
    for broken in (b"\xe2\x82", b"\xf0\x9f\x98", b"\x80\x80", b"\xc3", b"\xff\xfe",
                   b"\xe2\x82\xac\xe2", b"a\xed\xa0\x80b"):
        cases.append(word + _byte_ids(wheel, family, broken) + word)
        cases.append(_byte_ids(wheel, family, broken))
    for ids in cases:
        assert port.decode(ids) == jax_tok.decode(ids), ids
        assert (tokenizer_json_of(port).decode(ids, skip_special_tokens=False)
                == wheel.decode(ids, skip_special_tokens=False)), ids


def tokenizer_json_of(tok: HFTokenizer) -> tokenizer_json.Tokenizer:
    return tok._tok


@pytest.mark.parametrize("family", list(fx.FAMILIES))
def test_family_vocab_size_and_pad_id(families, family):
    port, jax_tok, wheel = families[family]
    assert port.vocab_size == jax_tok.vocab_size == wheel.get_vocab_size()
    assert port.pad_id == jax_tok.pad_id
    reader = tokenizer_json_of(port)
    for tid in range(wheel.get_vocab_size() + 2):
        assert reader.id_to_token(tid) == wheel.id_to_token(tid), tid
    for token in ("[PAD]", "<s>", "<unk>", "<|eot_id|>", "<tool_call>", "zork", "##a", "ka"):
        assert reader.token_to_id(token) == wheel.token_to_id(token), token


# -- each component and option -----------------------------------------------------


def _trained(model, pre, normalizer=None, trainer=None, byte_alphabet=False):
    tok = Tokenizer(model)
    tok.normalizer = normalizer
    tok.pre_tokenizer = pre
    if trainer is None:
        trainer = trainers.BpeTrainer(
            vocab_size=400, show_progress=False, special_tokens=["<s>", "</s>", "<unk>"],
            initial_alphabet=pt.ByteLevel.alphabet() if byte_alphabet else [])
    tok.train_from_iterator(fx.corpus(9), trainer)
    return tok


def _bpe():
    return models.BPE(unk_token="<unk>")


BERT_PAIR = processors.BertProcessing(("</s>", 1), ("<s>", 0))
BEHAVIORS = ("removed", "isolated", "merged_with_previous", "merged_with_next", "contiguous")
VARIANTS = {
    "bytelevel_gpt2_roberta": dict(pre=pt.ByteLevel(add_prefix_space=True, use_regex=True),
                                   dec=decoders.ByteLevel(), byte_alphabet=True,
                                   post=processors.RobertaProcessing(("</s>", 1), ("<s>", 0))),
    "bytelevel_no_prefix": dict(pre=pt.ByteLevel(add_prefix_space=False),
                                dec=decoders.ByteLevel(), post=processors.ByteLevel(),
                                byte_alphabet=True),
    "nfkc_lowercase_bert": dict(
        post=BERT_PAIR, norm=normalizers.Sequence([normalizers.NFKC(), normalizers.Lowercase()])),
    "bert_normalizer_accents_strip_decoder": dict(
        dec=decoders.Strip("a", 2, 0),
        norm=normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=False,
                                        strip_accents=True, lowercase=False)),
    "regex_replace_split_sequence": dict(
        pre=pt.Sequence([pt.Split(Regex(r"\p{N}"), "isolated"), pt.Whitespace()]),
        norm=normalizers.Replace(Regex(r"\s+"), " ")),
    **{f"split_regex_{b}_invert{inv}": dict(pre=pt.Split(Regex(r"\p{N}+|[^\s\p{L}]"), b,
                                                         invert=inv))
       for b in BEHAVIORS for inv in (False, True)},
    **{f"split_string_{b}": dict(pre=pt.Split("a", b)) for b in BEHAVIORS},
    **{f"metaspace_{scheme}_split{split}": dict(
        pre=pt.Metaspace(prepend_scheme=scheme, split=split),
        dec=decoders.Metaspace(prepend_scheme=scheme, split=split),
        added=[AddedToken("<s>", special=True)])
       for scheme in ("always", "never", "first") for split in (True, False)},
    "bpe_prefix_suffix": dict(
        model=lambda: models.BPE(continuing_subword_prefix="##", end_of_word_suffix="</w>",
                                 unk_token="<unk>"),
        trainer=lambda: trainers.BpeTrainer(
            vocab_size=400, show_progress=False, continuing_subword_prefix="##",
            end_of_word_suffix="</w>", special_tokens=["<s>", "</s>", "<unk>"]),
        dec=decoders.Sequence([decoders.Replace("</w>", " "), decoders.Fuse()])),
    "bpe_unfused_unknowns": dict(),
    "added_token_options": dict(
        norm=normalizers.NFKC(),
        added=[AddedToken("ka", single_word=True), AddedToken("lo", lstrip=True, rstrip=True),
               AddedToken("<|end|>", rstrip=True, special=True), AddedToken(" zz", lstrip=True),
               AddedToken("é", normalized=True)]),
    "template_truncation_fixed_left_padding": dict(
        pre=pt.ByteLevel(), byte_alphabet=True,
        post=processors.TemplateProcessing(single="<s> $A </s>",
                                           pair="<s> $A </s> </s> $B:1 </s>:1",
                                           special_tokens=[("<s>", 0), ("</s>", 1)]),
        trunc=dict(max_length=9), pad=dict(length=14, direction="left", pad_id=2,
                                           pad_type_id=3, pad_token="<unk>")),
    "truncation_left_only_second_multiple": dict(
        post=BERT_PAIR, trunc=dict(max_length=7, direction="left", strategy="only_second"),
        pad=dict(pad_to_multiple_of=8)),
    "truncation_only_first": dict(trunc=dict(max_length=5, strategy="only_first")),
    "truncation_longest_first_fixed_padding": dict(post=BERT_PAIR, trunc=dict(max_length=20),
                                                   pad=dict(length=26)),
}


def _variant_file(root, name) -> str:
    v = VARIANTS[name]
    tok = _trained(v["model"]() if "model" in v else _bpe(), v.get("pre", pt.Whitespace()),
                   v.get("norm"), v["trainer"]() if "trainer" in v else None,
                   v.get("byte_alphabet", False))
    if "dec" in v:
        tok.decoder = v["dec"]
    if "post" in v:
        tok.post_processor = v["post"]
    if "added" in v:
        tok.add_tokens(v["added"])
    if "trunc" in v:
        tok.enable_truncation(**v["trunc"])
    if "pad" in v:
        tok.enable_padding(**v["pad"])
    path = os.path.join(root, "tokenizer.json")
    tok.save(path)
    return path


def _either(fn):
    try:
        return fn()
    except Exception:
        return "raises"


@pytest.mark.parametrize("name", list(VARIANTS))
def test_component_matches_the_wheel(tmp_path, name):
    path = _variant_file(str(tmp_path), name)
    wheel, reader = Tokenizer.from_file(path), tokenizer_json.Tokenizer.from_file(path)
    strings = STRINGS[:150]
    for i, s in enumerate(strings):
        for args in ((s,), PAIRS[i]):
            for add in (True, False):
                want = _either(lambda: (lambda e: (e.ids, e.type_ids))(
                    wheel.encode(*args, add_special_tokens=add)))
                assert _either(lambda: reader.encode(*args, add_special_tokens=add)) == want, \
                    (args, add)
        ids = wheel.encode(s, add_special_tokens=False).ids if "only_second" not in name else []
        assert reader.decode(ids) == wheel.decode(ids), s


# -- refusals ----------------------------------------------------------------------


def test_unigram_raises_naming_the_component(tmp_path):
    tok = Tokenizer(models.Unigram([("<unk>", 0.0), ("a", -1.0), ("b", -2.0)], 0))
    path = str(tmp_path / "tokenizer.json")
    tok.save(path)
    with pytest.raises(NotImplementedError, match=r"Unigram.*|.*tokenizer\.json.*Unigram"):
        load_tokenizer(str(tmp_path))
    with pytest.raises(NotImplementedError) as err:
        tokenizer_json.Tokenizer.from_file(path)
    assert "Unigram" in str(err.value) and path in str(err.value)


@pytest.mark.parametrize("section, component", [
    ("normalizer", {"type": "Precompiled", "precompiled_charsmap": None}),
    ("normalizer", {"type": "NFD"}),
    ("pre_tokenizer", {"type": "UnicodeScripts"}),
    ("pre_tokenizer", {"type": "Digits", "individual_digits": True}),
    ("decoder", {"type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "|",
                 "cleanup": True}),
    ("post_processor", {"type": "Unknown"}),
    ("model", {"type": "WordLevel", "vocab": {"a": 0}, "unk_token": "a"})])
def test_unsupported_components_raise(tmp_path, section, component):
    d = fx.bert(str(tmp_path / "bert"))
    path = os.path.join(d, "tokenizer.json")
    obj = json.load(open(path, encoding="utf-8"))
    obj[section] = component
    json.dump(obj, open(path, "w", encoding="utf-8"))
    with pytest.raises(NotImplementedError) as err:
        load_tokenizer(d)
    assert component["type"] in str(err.value) and path in str(err.value)


def test_load_tokenizer_never_falls_through(tmp_path):
    """A tokenizer.json the reader cannot read raises even beside a
    vocab.txt; without one the tiers are as before."""
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "##b"]))
    (d / "tokenizer.json").write_text("{not json")
    with pytest.raises(ValueError):
        load_tokenizer(str(d))
    os.remove(d / "tokenizer.json")
    assert isinstance(load_tokenizer(str(d)), WordPieceTokenizer)
    assert isinstance(load_tokenizer(str(tmp_path / "missing")), SimpleTokenizer)
    assert isinstance(load_tokenizer(None, 100), SimpleTokenizer)


def test_regex_translation_matches_oniguruma_white_space():
    """Python's \\s matches U+001C-U+001F; the translated pattern does not,
    as Oniguruma's \\s in the wheel does not; \\p{..} inside and outside a
    class, also a class with no ASCII member on ASCII text."""
    pat = tokenizer_json.translate(r"\s+|[^\s\p{L}]+|\p{N}+|\P{L}")
    assert [m.group() for m in pat.finditer("a\x1c\x1d b\x85\xa0c1")] == [
        "\x1c\x1d", " ", "\x85\xa0", "1"]
    for pattern, text in [(r"\s+", "x\x1cy　z\x85w"), (r"[\p{Lo}]+", "ab cd"),
                          (r"[\p{Lo}]+", "ab日本cd"), (r"[^\p{Lo}]+", "ab cd"),
                          (r"[^\p{Lo}]+", "ab日本cd")]:
        wheel = pt.Split(Regex(pattern), "isolated")
        want = [p for p, _ in wheel.pre_tokenize_str(text)]
        got = [t for t, _ in tokenizer_json.split_text(
            text, 0, [m.span() for m in tokenizer_json.translate(pattern).finditer(text)],
            "Isolated")]
        assert got == want, (pattern, text)


def test_single_word_takes_the_wheels_word_characters():
    """An added token with ``single_word`` beside \\w characters as the
    wheel has them: connector punctuation, the zero-width (non-)joiner and
    letter numbers count as word characters, other numbers do not."""
    tok = Tokenizer(models.BPE({"<unk>": 0, "k": 1, "a": 2}, [], unk_token="<unk>"))
    tok.add_tokens([AddedToken("ka", single_word=True)])
    reader = tokenizer_json.Tokenizer(json.loads(tok.to_str()))
    for text in ("ka", "x ka y", "\uff3fka", "ka\u200c", "\u200dka", "ka\u2040", "_ka",
                 "\u00b2ka", "\u2167ka", "ka-", "\u00e9ka", "a\u0301ka"):
        assert reader.encode(text)[0] == tok.encode(text).ids, text
