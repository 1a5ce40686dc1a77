"""A reader of Hugging Face ``tokenizer.json`` files, in plain Python.

The port's ``HFTokenizer`` reads a checkpoint's ``tokenizer.json`` with
this module, so a checkpoint tokenizes the same on a machine without the
Rust ``tokenizers`` wheel. It uses ``json``, ``re`` and ``unicodedata``
only, and gives the wheel's ids: it follows the wheel's stages in order.

Encoding: added tokens are split off first (those with ``normalized``
false on the raw text, then the others on each normalized piece;
leftmost-longest, with ``single_word``, ``lstrip`` and ``rstrip``), then
the normalizer, the pre-tokenizer and the model run on what is left, and
the file's ``truncation``, post-processor and ``padding`` sections on the
result. Decoding drops unknown ids and, by default, the special added
tokens, then runs the decoder.

Components (each raises ``NotImplementedError`` naming its ``type`` and
the file when it is not one of these):

- models: ``BPE`` (merges as ``"a b"`` strings or ``[a, b]`` pairs,
  ``ignore_merges``, ``byte_fallback``, ``fuse_unk``, ``unk_token``,
  ``continuing_subword_prefix``, ``end_of_word_suffix``; no dropout),
  ``WordPiece``;
- normalizers: ``NFC``, ``NFKC``, ``Lowercase``, ``BertNormalizer``,
  ``Prepend``, ``Replace``, ``Sequence``;
- pre-tokenizers: ``Split`` (``Regex`` or ``String`` pattern, every
  behavior, ``invert``), ``ByteLevel``, ``Metaspace``,
  ``BertPreTokenizer``, ``Whitespace``, ``Sequence``;
- post-processors: ``TemplateProcessing``, ``BertProcessing``,
  ``RobertaProcessing``, ``ByteLevel``, ``Sequence``;
- decoders: ``ByteLevel``, ``Metaspace``, ``Replace``, ``ByteFallback``,
  ``Fuse``, ``Strip``, ``WordPiece``, ``Sequence``.

These are what the published files of the families the loaders take
(``models/hf_loader.py``'s FAMILIES) and of the BERT encoders use.

The files' regular expressions are written for Oniguruma. ``translate``
rewrites one for Python's ``re`` once (a module-level cache):
``\\p{...}`` / ``\\P{...}`` become classes built from ``unicodedata``, and
``\\s`` / ``\\S`` the Unicode White_Space set, which Oniguruma's ``\\s``
matches (Python's also matches U+001C-U+001F).
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Unicode classes
# ---------------------------------------------------------------------------

Ranges = List[Tuple[int, int]]

# the White_Space property: Oniguruma's \s, Rust's char::is_whitespace
WHITE_SPACE: Ranges = [(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                       (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                       (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000)]
WHITE_SPACE_CHARS = frozenset(chr(c) for lo, hi in WHITE_SPACE for c in range(lo, hi + 1))
_CATEGORY_RANGES: Optional[Dict[str, Ranges]] = None


def _categories() -> Dict[str, Ranges]:
    """Every general category's code point ranges (one pass, cached)."""
    global _CATEGORY_RANGES
    if _CATEGORY_RANGES is None:
        out: Dict[str, Ranges] = {}
        cat, start = None, 0
        for cp in range(0x110000):
            c = unicodedata.category(chr(cp))
            if c != cat:
                if cat is not None:
                    out.setdefault(cat, []).append((start, cp - 1))
                cat, start = c, cp
        out.setdefault(cat, []).append((start, 0x10FFFF))
        _CATEGORY_RANGES = out
    return _CATEGORY_RANGES


def _merge(ranges) -> Ranges:
    out: Ranges = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _complement(ranges: Ranges) -> Ranges:
    out, nxt = [], 0
    for lo, hi in _merge(ranges):
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= 0x10FFFF:
        out.append((nxt, 0x10FFFF))
    return out


def category_ranges(*cats: str) -> Ranges:
    """The ranges of the general categories ``cats``: two-letter names
    (``Lu``) or one-letter majors (``L``: every ``L*``)."""
    table = _categories()
    return _merge(r for name, rs in table.items() for r in rs
                  if any(name == c or (len(c) == 1 and name[0] == c) for c in cats))


def class_body(ranges: Ranges, ascii: bool = False) -> str:
    """``ranges`` as the inside of a ``re`` character class (``ascii``:
    their ASCII part alone; where that is empty, U+10FFFF, which no ASCII
    text holds, so that ``[...]`` matches nothing and ``[^...]`` all)."""
    if ascii:
        ranges = [(lo, min(hi, 0x7F)) for lo, hi in ranges if lo <= 0x7F] or [(0x10FFFF,) * 2]
    return "".join(f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}"
                   for lo, hi in _merge(ranges))


def char_class(ranges: Ranges, negate: bool = False, ascii: bool = False) -> str:
    return f"[{'^' if negate else ''}{class_body(ranges, ascii)}]"


class Dual:
    """A pattern compiled twice: as written, and with its classes cut to
    ASCII for ASCII text, which ``re`` matches many times faster (a class
    of thousands of ranges is scanned range by range)."""

    __slots__ = ("full", "ascii")

    def __init__(self, build: Callable[[bool], str], flags: int = 0):
        self.full = re.compile(build(False), flags)
        self.ascii = re.compile(build(True), flags)

    def _pick(self, text: str) -> "re.Pattern":
        return self.ascii if text.isascii() else self.full

    def finditer(self, text: str):
        return self._pick(text).finditer(text)

    def fullmatch(self, text: str):
        return self._pick(text).fullmatch(text)

    def sub(self, repl, text: str) -> str:
        return self._pick(text).sub(repl, text)


def _property(name: str, source: str) -> Ranges:
    """A general category (``Lu``) or a major one (``L``)."""
    table = _categories()
    if name in table or len(name) == 1 and any(k[0] == name for k in table):
        return category_ranges(name)
    raise NotImplementedError(f"{source}: the regex property \\p{{{name}}} is not supported")


def _word() -> Ranges:
    """Unicode \\w as Oniguruma and Rust's regex crate have it (up to a few
    Other_Alphabetic symbols); Python's \\w leaves out the marks."""
    return _merge(category_ranges("L", "M", "Nd", "Nl", "Pc") + [(0x200C, 0x200D)])


_SHORTHANDS: Dict[str, Callable[[], Ranges]] = {"s": lambda: list(WHITE_SPACE), "w": _word}
_TRANSLATED: Dict[str, "Dual"] = {}


def translate(pattern: str, source: str = "tokenizer.json") -> Dual:
    """An Oniguruma pattern as a compiled ``re`` pattern (cached)."""
    hit = _TRANSLATED.get(pattern)
    if hit is None:
        hit = _TRANSLATED[pattern] = Dual(lambda ascii: _translate(pattern, source, ascii),
                                          re.MULTILINE)
    return hit


def _translate(pattern: str, source: str, ascii: bool) -> str:
    out: List[str] = []
    i, n, in_class, class_start = 0, len(pattern), False, -1
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            d = pattern[i + 1]
            if d in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    j = pattern.index("}", i + 3)
                    name, i_next = pattern[i + 3:j], j + 1
                else:
                    name, i_next = pattern[i + 2:i + 3], i + 3
                negate = d == "P"
                if name.startswith("^"):
                    negate, name = not negate, name[1:]
                ranges = _property(name, source)
            elif d.lower() in _SHORTHANDS:
                ranges, negate, i_next = _SHORTHANDS[d.lower()](), d.isupper(), i + 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                out.append(class_body(_complement(ranges) if negate else ranges, ascii))
            else:
                out.append(char_class(ranges, negate, ascii))
            i = i_next
            continue
        if in_class:
            if c == "]" and i > class_start:
                in_class = False
            elif c == "[" or pattern.startswith("&&", i):
                raise NotImplementedError(f"{source}: nested or intersected character "
                                          f"classes in the regex {pattern!r}")
        elif c == "[":
            in_class = True
            class_start = i + 1 + (pattern[i + 1:i + 2] == "^")
            out.append(pattern[i:class_start])
            if pattern[class_start:class_start + 1] == "]":   # a literal ] first
                out.append("\\]")
                class_start += 1
            i = class_start
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _pattern(spec: dict, source: str):
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern, compiled."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return translate(spec["Regex"], source)
    raise NotImplementedError(f"{source}: pattern {spec!r} is not supported")


# ---------------------------------------------------------------------------
# normalizers: str -> str
# ---------------------------------------------------------------------------

_CJK = [(0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)]
_BERT_RE: Dict[str, Dual] = {}


def _bert_re(name: str) -> Dual:
    if not _BERT_RE:
        keep = _complement([(0x09, 0x0A), (0x0D, 0x0D)])
        control = [(max(lo, klo), min(hi, khi)) for lo, hi in category_ranges("C")
                   for klo, khi in keep if max(lo, klo) <= min(hi, khi)]
        # C* but \t \n \r, and U+FFFD
        control += [(0xFFFD, 0xFFFD)]
        _BERT_RE["drop"] = Dual(lambda a: char_class(control, ascii=a) + "+")
        _BERT_RE["space"] = Dual(lambda a: char_class(WHITE_SPACE, ascii=a))
        _BERT_RE["cjk"] = Dual(lambda a: f"({char_class(_CJK, ascii=a)})")
        _BERT_RE["mn"] = Dual(lambda a: char_class(category_ranges("Mn"), ascii=a) + "+")
    return _BERT_RE[name]


def lowercase(s: str) -> str:
    """Rust's char::to_lowercase, char by char (no final-sigma rule)."""
    return s.lower() if s.isascii() else "".join(c.lower() for c in s)


def strip_accents(s: str) -> str:
    return s if s.isascii() else _bert_re("mn").sub("", unicodedata.normalize("NFD", s))


def _bert_normalizer(cfg: dict) -> Callable[[str], str]:
    clean, chinese = cfg.get("clean_text", True), cfg.get("handle_chinese_chars", True)
    lower = cfg.get("lowercase", True)
    accents = cfg.get("strip_accents")
    accents = lower if accents is None else accents

    def normalize(s: str) -> str:
        if clean:
            s = _bert_re("space").sub(" ", _bert_re("drop").sub("", s))
        if chinese and not s.isascii():
            s = _bert_re("cjk").sub(r" \1 ", s)
        if accents:
            s = strip_accents(s)
        return lowercase(s) if lower else s
    return normalize


def build_normalizer(cfg: Optional[dict], source: str) -> Optional[Callable[[str], str]]:
    if cfg is None:
        return None
    kind = cfg.get("type")
    if kind in ("NFC", "NFKC"):
        return lambda s, form=kind: s if s.isascii() else unicodedata.normalize(form, s)
    if kind == "Lowercase":
        return lowercase
    if kind == "BertNormalizer":
        return _bert_normalizer(cfg)
    if kind == "Prepend":
        return lambda s, p=cfg["prepend"]: p + s if s else s
    if kind == "Replace":
        pat, content = _pattern(cfg["pattern"], source), cfg["content"]
        if "String" in cfg["pattern"]:
            return lambda s, old=cfg["pattern"]["String"]: s.replace(old, content)
        return lambda s: pat.sub(lambda m: content, s)
    if kind == "Sequence":
        steps = [build_normalizer(c, source) for c in cfg["normalizers"]]

        def chain(s: str) -> str:
            for step in steps:
                s = step(s)
            return s
        return chain
    raise NotImplementedError(f"{source}: normalizer type {kind!r} is not supported")


# ---------------------------------------------------------------------------
# pre-tokenizers: [(text, original start)] -> [(text, original start)]
# ---------------------------------------------------------------------------

Split = Tuple[str, int]
BEHAVIORS = ("Removed", "Isolated", "MergedWithPrevious", "MergedWithNext", "Contiguous")


def _segments(text: str, matches) -> List[Tuple[int, int, bool]]:
    """(start, end, is_match) covering ``text``: the gaps and the matches."""
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for start, end in matches:
        if prev != start:
            out.append((prev, start, False))
        out.append((start, end, True))
        prev = end
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def split_text(text: str, orig: int, matches, behavior: str,
               invert: bool = False) -> List[Split]:
    """NormalizedString::split: ``matches`` (start, end) cut ``text`` by
    ``behavior``; empty pieces are dropped."""
    segs = [(s, e, m != invert) for s, e, m in _segments(text, matches)]
    if behavior == "Isolated":
        kept = [(s, e) for s, e, _ in segs]
    elif behavior == "Removed":
        kept = [(s, e) for s, e, m in segs if not m]
    elif behavior == "Contiguous":
        kept, prev = [], False
        for s, e, m in segs:
            if m == prev and kept:
                kept[-1] = (kept[-1][0], e)
            else:
                kept.append((s, e))
            prev = m
    elif behavior == "MergedWithPrevious":
        kept, prev = [], False
        for s, e, m in segs:
            if m and not prev and kept:
                kept[-1] = (kept[-1][0], e)
            else:
                kept.append((s, e))
            prev = m
    elif behavior == "MergedWithNext":
        kept, prev = [], False
        for s, e, m in reversed(segs):
            if m and not prev and kept:
                kept[-1] = (s, kept[-1][1])
            else:
                kept.append((s, e))
            prev = m
        kept.reverse()
    else:
        raise NotImplementedError(f"split behavior {behavior!r} is not supported")
    return [(text[s:e], orig if s == 0 else orig + s) for s, e in kept if e > s]


def _spans(pattern, text: str):
    return [m.span() for m in pattern.finditer(text) if m.end() > m.start()]


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


def byte_level(text: str) -> str:
    """Each UTF-8 byte of ``text`` as its GPT-2 character."""
    return text.encode("utf-8").decode("latin-1").translate(BYTE_CHAR)


class PreTokenizer:
    def __call__(self, splits: List[Split]) -> List[Split]:
        return [p for text, orig in splits for p in self.split(text, orig)]

    def split(self, text: str, orig: int) -> List[Split]:
        raise NotImplementedError


class SplitPre(PreTokenizer):
    def __init__(self, cfg: dict, source: str):
        self.pattern = _pattern(cfg["pattern"], source)
        self.behavior, self.invert = cfg["behavior"], cfg.get("invert", False)
        if self.behavior not in BEHAVIORS:
            raise NotImplementedError(f"{source}: Split behavior {self.behavior!r}")

    def split(self, text, orig):
        return split_text(text, orig, _spans(self.pattern, text), self.behavior, self.invert)


class FindAllPre(PreTokenizer):
    """Keeps the matches of a pattern (built by ``build(ascii)``), drops
    the rest."""

    def __init__(self, build: Callable[[bool], str]):
        self.pattern = Dual(build)

    def split(self, text, orig):
        return [(m.group(), orig + m.start()) for m in self.pattern.finditer(text)]


def _bert_punct() -> Ranges:
    ascii_punct = [(0x21, 0x2F), (0x3A, 0x40), (0x5B, 0x60), (0x7B, 0x7E)]
    return _merge(ascii_punct + category_ranges("P"))


class ByteLevelPre(PreTokenizer):
    def __init__(self, cfg: dict, source: str):
        self.prefix = cfg.get("add_prefix_space", True)
        self.regex = translate(GPT2_PATTERN, source) if cfg.get("use_regex", True) else None

    def __call__(self, splits):
        out = []
        for text, orig in splits:
            if self.prefix and not text.startswith(" "):
                text = " " + text
            parts = ([(text, orig)] if self.regex is None else
                     split_text(text, orig, _spans(self.regex, text), "Isolated"))
            out += [(byte_level(t), o) for t, o in parts]
        return out


class MetaspacePre(PreTokenizer):
    def __init__(self, cfg: dict, source: str):
        self.rep = cfg.get("replacement", "▁")
        self.scheme = _prepend_scheme(cfg, source)
        self.split_on = cfg.get("split", True)
        self.pattern = re.compile(re.escape(self.rep))

    def split(self, text, orig):
        text = text.replace(" ", self.rep)
        if not text.startswith(self.rep) and (
                self.scheme == "always" or (self.scheme == "first" and orig == 0)):
            text = self.rep + text
        if not self.split_on:
            return [(text, orig)] if text else []
        return split_text(text, orig, _spans(self.pattern, text), "MergedWithNext")


def _prepend_scheme(cfg: dict, source: str) -> str:
    scheme = cfg.get("prepend_scheme",
                     "always" if cfg.get("add_prefix_space", True) else "never")
    if scheme not in ("always", "first", "never"):
        raise NotImplementedError(f"{source}: Metaspace prepend_scheme {scheme!r}")
    return scheme


class SequencePre(PreTokenizer):
    def __init__(self, steps):
        self.steps = steps

    def __call__(self, splits):
        for step in self.steps:
            splits = step(splits)
        return splits


def build_pre_tokenizer(cfg: Optional[dict], source: str) -> Optional[PreTokenizer]:
    if cfg is None:
        return None
    kind = cfg.get("type")

    def ws(a: bool) -> str:
        return class_body(WHITE_SPACE, a)
    if kind == "Split":
        return SplitPre(cfg, source)
    if kind == "ByteLevel":
        return ByteLevelPre(cfg, source)
    if kind == "Metaspace":
        return MetaspacePre(cfg, source)
    if kind == "BertPreTokenizer":
        punct = _bert_punct()
        return FindAllPre(lambda a: f"[{class_body(punct, a)}]|[^{ws(a)}{class_body(punct, a)}]+")
    if kind == "Whitespace":
        word = _word()
        return FindAllPre(lambda a: f"[{class_body(word, a)}]+|[^{class_body(word, a)}{ws(a)}]+")
    if kind == "Sequence":
        return SequencePre([build_pre_tokenizer(c, source) for c in cfg["pretokenizers"]])
    raise NotImplementedError(f"{source}: pre_tokenizer type {kind!r} is not supported")


# ---------------------------------------------------------------------------
# models: word -> ids
# ---------------------------------------------------------------------------


class BPE:
    def __init__(self, cfg: dict, source: str):
        if cfg.get("dropout") not in (None, 0, 0.0):
            raise NotImplementedError(f"{source}: BPE dropout {cfg['dropout']} is not supported")
        self.vocab: Dict[str, int] = cfg["vocab"]
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk_token = cfg.get("unk_token")
        self.prefix = cfg.get("continuing_subword_prefix")
        self.suffix = cfg.get("end_of_word_suffix")
        self.fuse_unk = cfg.get("fuse_unk", False)
        self.byte_fallback = cfg.get("byte_fallback", False)
        self.ignore_merges = cfg.get("ignore_merges", False)
        cut = len(self.prefix.encode()) if self.prefix else 0
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(cfg.get("merges", ())):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            new = a + b.encode()[cut:].decode("utf-8", "surrogateescape")
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[new])
            except KeyError as e:
                raise ValueError(f"{source}: merge {merge!r}: {e.args[0]!r} is not in the "
                                 "vocabulary") from None
        self.cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        hit = self.cache.get(word)
        if hit is None:
            if self.ignore_merges and word in self.vocab:
                hit = [self.vocab[word]]
            else:
                hit = self._merge_all(self._symbols(word))
            if len(self.cache) < 100_000:
                self.cache[word] = hit
        return hit

    def _symbols(self, word: str) -> List[int]:
        ids: List[int] = []
        unk = None
        last = len(word) - 1
        for i, ch in enumerate(word):
            s = ch
            if i > 0 and self.prefix is not None:
                s = self.prefix + s
            if i == last and self.suffix is not None:
                s = s + self.suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                codes = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode()]
                if None not in codes:
                    ids += codes
                    continue
            if self.unk_token is not None:
                if self.unk_token not in self.vocab:
                    raise ValueError(f"unk token {self.unk_token!r} is not in the vocabulary")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk_token]
        if unk is not None:
            ids.append(unk)
        return ids

    def _merge_all(self, c: List[int]) -> List[int]:
        """The wheel's Word::merge_all: the lowest-ranked pair first, the
        leftmost among equals, new pairs queued as they form."""
        n = len(c)
        if n < 2:
            return c
        merges = self.merges
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        if not heap:
            return c
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos]:
                continue
            j = nxt[pos]
            if j == -1:
                continue
            m = merges.get((c[pos], c[j]))
            if m is None or m[1] != new_id:
                continue
            c[pos] = new_id
            alive[j] = False
            k = nxt[j]
            nxt[pos] = k
            if k != -1:
                prev[k] = pos
            p = prev[pos]
            if p >= 0:
                m = merges.get((c[p], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if k != -1:
                m = merges.get((new_id, c[k]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [c[i] for i in range(n) if alive[i]]


class WordPiece:
    def __init__(self, cfg: dict, source: str):
        self.vocab: Dict[str, int] = cfg["vocab"]
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk_token = cfg.get("unk_token", "[UNK]")
        self.prefix = cfg.get("continuing_subword_prefix", "##")
        self.max_chars = cfg.get("max_input_chars_per_word", 100)
        self.cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        hit = self.cache.get(word)
        if hit is None:
            hit = self._pieces(word)
            if len(self.cache) < 100_000:
                self.cache[word] = hit
        return hit

    def _pieces(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self._unk()]
        ids, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                cur = self.vocab.get(sub)
                if cur is not None:
                    break
                end -= 1
            if cur is None:
                return [self._unk()]
            ids.append(cur)
            start = end
        return ids

    def _unk(self) -> int:
        if self.unk_token not in self.vocab:
            raise ValueError(f"unk token {self.unk_token!r} is not in the vocabulary")
        return self.vocab[self.unk_token]


def build_model(cfg: dict, source: str):
    kind = cfg.get("type")
    models = {"BPE": BPE, "WordPiece": WordPiece}
    if kind not in models:
        raise NotImplementedError(f"{source}: model type {kind!r} is not supported")
    return models[kind](cfg, source)


# ---------------------------------------------------------------------------
# post-processors: [(ids, type ids)] -> [(ids, type ids)]
# ---------------------------------------------------------------------------

Encoding = Tuple[List[int], List[int]]


class Template:
    def __init__(self, cfg: dict):
        self.single, self.pair = cfg["single"], cfg["pair"]
        self.specials = {k: v["ids"] for k, v in cfg.get("special_tokens", {}).items()}

    def added_tokens(self, is_pair: bool) -> int:
        return sum(len(self.specials.get(p["SpecialToken"]["id"], ()))
                   for p in (self.pair if is_pair else self.single) if "SpecialToken" in p)

    def process(self, encs: List[Encoding], add_special: bool) -> List[Encoding]:
        out = []
        for piece in self.pair if len(encs) == 2 else self.single:
            if "Sequence" in piece:
                seq = piece["Sequence"]
                ids = encs[0 if seq["id"] == "A" else 1][0]
                out.append((ids, [seq["type_id"]] * len(ids)))
            elif add_special:
                tok = piece["SpecialToken"]
                ids = self.specials[tok["id"]]
                out.append((list(ids), [tok["type_id"]] * len(ids)))
        return out


class BertLike:
    """BertProcessing ([CLS] A [SEP] B [SEP]) and RobertaProcessing
    (<s> A </s> </s> B </s>)."""

    def __init__(self, cfg: dict, roberta: bool):
        self.cls, self.sep, self.roberta = cfg["cls"][1], cfg["sep"][1], roberta

    def added_tokens(self, is_pair: bool) -> int:
        return (4 if self.roberta else 3) if is_pair else 2

    def process(self, encs, add_special):
        if self.roberta:   # every type id is 0, as the wheel's RobertaProcessing has it
            encs = [(ids, [0] * len(ids)) for ids, _ in encs]
        if not add_special:
            return encs
        (a, ta), rest = encs[0], encs[1:]
        out = [([self.cls] + a + [self.sep], [0] + ta + [0])]
        for b, tb in rest:
            if self.roberta:
                out.append(([self.sep] + b + [self.sep], [0] * (len(b) + 2)))
            else:
                out.append((b + [self.sep], tb + [1]))
        return out


class NoOpProcessor:
    """ByteLevel's post-processor: offsets only, the ids stay."""

    def added_tokens(self, is_pair: bool) -> int:
        return 0

    def process(self, encs, add_special):
        return encs


class SequenceProcessor:
    def __init__(self, steps):
        self.steps = steps

    def added_tokens(self, is_pair):
        return sum(s.added_tokens(is_pair) for s in self.steps)

    def process(self, encs, add_special):
        for step in self.steps:
            encs = step.process(encs, add_special)
        return encs


def build_post_processor(cfg: Optional[dict], source: str):
    if cfg is None:
        return NoOpProcessor()
    kind = cfg.get("type")
    if kind == "TemplateProcessing":
        return Template(cfg)
    if kind in ("BertProcessing", "RobertaProcessing"):
        return BertLike(cfg, roberta=kind == "RobertaProcessing")
    if kind == "ByteLevel":
        return NoOpProcessor()
    if kind == "Sequence":
        return SequenceProcessor([build_post_processor(c, source) for c in cfg["processors"]])
    raise NotImplementedError(f"{source}: post_processor type {kind!r} is not supported")


# ---------------------------------------------------------------------------
# decoders: [token] -> [token]
# ---------------------------------------------------------------------------

_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
            (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"),
            (" 've", "'ve"), (" 're", "'re"))
_BYTE_TOKEN = re.compile(r"<0x([0-9A-Fa-f]{2})>")


def _byte_level_decode(tokens: List[str]) -> List[str]:
    out = bytearray()
    for t in tokens:
        try:
            out += bytes(CHAR_BYTE[c] for c in t)
        except KeyError:
            out += t.encode()
    return [out.decode("utf-8", "replace")]


def _byte_fallback_decode(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending = bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(pending))
            pending.clear()
    for t in tokens:
        m = _BYTE_TOKEN.fullmatch(t) if len(t) == 6 else None
        if m:
            pending.append(int(m.group(1), 16))
        else:
            flush()
            out.append(t)
    flush()
    return out


def _metaspace_decode(cfg: dict, source: str) -> Callable[[List[str]], List[str]]:
    rep, scheme = cfg.get("replacement", "▁"), _prepend_scheme(cfg, source)

    def decode(tokens):
        return ["".join(("" if i == 0 and scheme != "never" else " ") if c == rep else c
                        for c in t) for i, t in enumerate(tokens)]
    return decode


def _strip_decode(cfg: dict) -> Callable[[List[str]], List[str]]:
    content, start, stop = cfg["content"], cfg.get("start", 0), cfg.get("stop", 0)

    def one(t: str) -> str:
        i = 0
        while i < start and i < len(t) and t[i] == content:
            i += 1
        j = len(t)
        for _ in range(stop):
            if j > 0 and t[j - 1] == content:
                j -= 1
            else:
                break
        return t[i:j]
    return lambda tokens: [one(t) for t in tokens]


def _wordpiece_decode(cfg: dict) -> Callable[[List[str]], List[str]]:
    prefix, cleanup = cfg.get("prefix", "##"), cfg.get("cleanup", True)

    def decode(tokens):
        out = []
        for i, t in enumerate(tokens):
            if i:
                t = t.replace(prefix, "", 1) if t.startswith(prefix) else " " + t
            if cleanup:
                for a, b in _CLEANUP:
                    t = t.replace(a, b)
            out.append(t)
        return out
    return decode


def build_decoder(cfg: Optional[dict], source: str):
    if cfg is None:
        return None
    kind = cfg.get("type")
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Metaspace":
        return _metaspace_decode(cfg, source)
    if kind == "Strip":
        return _strip_decode(cfg)
    if kind == "WordPiece":
        return _wordpiece_decode(cfg)
    if kind == "Replace":
        pat, content = _pattern(cfg["pattern"], source), cfg["content"]
        return lambda tokens: [pat.sub(lambda m: content, t) for t in tokens]
    if kind == "Sequence":
        steps = [build_decoder(c, source) for c in cfg["decoders"]]

        def chain(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return chain
    raise NotImplementedError(f"{source}: decoder type {kind!r} is not supported")


# ---------------------------------------------------------------------------
# added tokens, truncation, padding and the tokenizer
# ---------------------------------------------------------------------------


class AddedToken:
    __slots__ = ("id", "content", "single_word", "lstrip", "rstrip", "normalized", "special")

    def __init__(self, cfg: dict, tid: int):
        self.id, self.content = tid, cfg["content"]
        self.single_word = cfg.get("single_word", False)
        self.lstrip, self.rstrip = cfg.get("lstrip", False), cfg.get("rstrip", False)
        self.special = cfg.get("special", False)
        self.normalized = cfg.get("normalized", not self.special)


def _alternation(patterns: Dict[str, AddedToken]) -> Optional["re.Pattern"]:
    """Leftmost-longest over literal strings: ``re`` tries the alternatives
    in order, so the longest goes first."""
    if not patterns:
        return None
    keys = sorted(patterns, key=lambda k: (-len(k), k))
    return re.compile("|".join(re.escape(k) for k in keys))


def _is_word_char(c: str) -> bool:
    """The wheel's single_word test: ``c`` is a \\w character (``_word``)."""
    return translate(r"\w").fullmatch(c) is not None


class Tokenizer:
    """One ``tokenizer.json``: ``encode``, ``decode``, ``token_to_id``,
    ``id_to_token``, ``get_vocab_size``, as the wheel's ``Tokenizer``."""

    def __init__(self, obj: dict, source: str = "tokenizer.json"):
        self.source = source
        self.model = build_model(obj["model"], source)
        self.normalizer = build_normalizer(obj.get("normalizer"), source)
        self.pre_tokenizer = build_pre_tokenizer(obj.get("pre_tokenizer"), source)
        self.post_processor = build_post_processor(obj.get("post_processor"), source)
        self.decoder = build_decoder(obj.get("decoder"), source)
        self.truncation, self.padding = obj.get("truncation"), obj.get("padding")
        if self.truncation and self.truncation.get("strategy", "LongestFirst") not in (
                "LongestFirst", "OnlyFirst", "OnlySecond"):
            raise NotImplementedError(f"{source}: truncation {self.truncation!r}")
        self.added: Dict[str, AddedToken] = {}
        for cfg in obj.get("added_tokens") or ():
            tid = self.model.vocab.get(cfg["content"], cfg["id"])
            self.added[cfg["content"]] = AddedToken(cfg, tid)
        self.added_r = {t.id: t.content for t in self.added.values()}
        self.special = {t.content for t in self.added.values() if t.special}
        raw = {t.content: t for t in self.added.values() if not t.normalized}
        norm = {}
        for t in self.added.values():
            if t.normalized:
                key = self.normalizer(t.content) if self.normalizer else t.content
                if key:
                    norm[key] = t
        self._raw, self._raw_re = raw, _alternation(raw)
        self._norm, self._norm_re = norm, _alternation(norm)

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f), source=path)

    # -- vocabulary --------------------------------------------------------

    def token_to_id(self, token: str) -> Optional[int]:
        t = self.added.get(token)
        return t.id if t is not None else self.model.vocab.get(token)

    def id_to_token(self, tid: int) -> Optional[str]:
        tok = self.added_r.get(tid)
        return tok if tok is not None else self.model.vocab_r.get(tid)

    def get_vocab_size(self) -> int:
        return len(self.model.vocab.keys() | self.added.keys())

    # -- encoding ----------------------------------------------------------

    def _find(self, text: str, pattern, tokens: Dict[str, AddedToken]):
        """AddedVocabulary::find_matches: (token id or None, start, end)."""
        if pattern is None or not text:
            return [(None, 0, len(text))]
        out, offset = [], 0
        for m in pattern.finditer(text):
            start, stop = m.span()
            tok = tokens[m.group()]
            if tok.single_word:
                before = start == 0 or not _is_word_char(text[start - 1])
                after = stop == len(text) or not _is_word_char(text[stop])
                if not (before and after):
                    continue
            if tok.lstrip:
                s = start
                while s > 0 and text[s - 1] in WHITE_SPACE_CHARS:
                    s -= 1
                start = max(s, offset)
            if tok.rstrip:
                while stop < len(text) and text[stop] in WHITE_SPACE_CHARS:
                    stop += 1
            if offset < start:
                out.append((None, offset, start))
            out.append((tok.id, start, stop))
            offset = stop
        if offset != len(text):
            out.append((None, offset, len(text)))
        return out

    def _tokenize(self, text: str) -> List[int]:
        """Added tokens, normalizer, pre-tokenizer and model: one sequence's
        ids before post-processing."""
        ids: List[int] = []
        for tid, s, e in self._find(text, self._raw_re, self._raw):
            if tid is not None:
                ids.append(tid)
                continue
            piece = text[s:e]
            if self.normalizer is not None:
                piece = self.normalizer(piece)
            for tid2, s2, e2 in self._find(piece, self._norm_re, self._norm):
                if tid2 is not None:
                    ids.append(tid2)
                elif e2 > s2:
                    part = [(piece[s2:e2], s if s2 == 0 else s + s2 + 1)]
                    if self.pre_tokenizer is not None:
                        part = self.pre_tokenizer(part)
                    for word, _ in part:
                        if word:
                            ids += self.model.tokenize(word)
        return ids

    def _truncate(self, encs: List[Encoding], max_length: int) -> List[Encoding]:
        t = self.truncation
        strategy, left = t.get("strategy", "LongestFirst"), t.get("direction") == "Left"

        def cut(enc: Encoding, n: int) -> Encoding:
            if len(enc[0]) <= n:
                return enc
            return (enc[0][-n:], enc[1][-n:]) if left and n else (enc[0][:n], enc[1][:n])
        if max_length == 0:
            return [cut(e, 0) for e in encs]
        total = sum(len(e[0]) for e in encs)
        if total <= max_length:
            return encs
        remove = total - max_length
        if strategy == "LongestFirst":
            if len(encs) == 1:
                return [cut(encs[0], total - remove)]
            n1, n2 = len(encs[0][0]), len(encs[1][0])
            swap = n1 > n2
            if swap:
                n1, n2 = n2, n1
            n2 = n1 if n1 > max_length else max(n1, max_length - n1)
            if n1 + n2 > max_length:
                n1 = max_length // 2
                n2 = n1 + max_length % 2
            if swap:
                n1, n2 = n2, n1
            return [cut(encs[0], n1), cut(encs[1], n2)]
        i = 0 if strategy == "OnlyFirst" else 1
        if i >= len(encs):
            raise ValueError("truncation OnlySecond needs a second sequence")
        n = len(encs[i][0])
        if n <= remove:
            raise ValueError("the sequence to truncate is shorter than what must go")
        encs = list(encs)
        encs[i] = cut(encs[i], n - remove)
        return encs

    def _pad(self, ids: List[int], types: List[int]) -> Encoding:
        p = self.padding
        strategy = p.get("strategy", "BatchLongest")
        length = strategy["Fixed"] if isinstance(strategy, dict) else len(ids)
        multiple = p.get("pad_to_multiple_of")
        if multiple and length % multiple:
            length += multiple - length % multiple
        n = length - len(ids)
        if n <= 0:
            return ids, types
        pid, ptype = p.get("pad_id", 0), p.get("pad_type_id", 0)
        if p.get("direction") == "Left":
            return [pid] * n + ids, [ptype] * n + types
        return ids + [pid] * n, types + [ptype] * n

    def encode(self, a: str, b: Optional[str] = None,
               add_special_tokens: bool = True) -> Encoding:
        """(ids, type ids) of ``a`` or of the pair ``a``, ``b``."""
        encs = [(ids, [i] * len(ids)) for i, ids in enumerate(
            [self._tokenize(a)] + ([] if b is None else [self._tokenize(b)]))]
        if self.truncation:
            n_added = self.post_processor.added_tokens(b is not None)
            max_length = self.truncation["max_length"]
            if add_special_tokens and n_added:
                max_length -= n_added
            encs = self._truncate(encs, max_length)
        encs = self.post_processor.process(encs, add_special_tokens)
        ids = [i for e in encs for i in e[0]]
        types = [t for e in encs for t in e[1]]
        if self.padding:
            ids, types = self._pad(ids, types)
        return ids, types

    # -- decoding ----------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self.id_to_token(int(i))
            if tok is not None and not (skip_special_tokens and tok in self.special):
                tokens.append(tok)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))
