"""Tokenizers.

Counterpart of ``ragmeup_tpu/models/tokenizer.py``, copied because that
module cannot be imported without jax (``ragmeup_tpu/models/__init__.py``
imports the flax encoder first). Ids are identical to the JAX package's for
every tokenizer; ``SimpleTokenizer`` uses the same native fast path
(``ragmeup_tpu.native.simpletok_encode``).

Three tiers:

- ``HFTokenizer``: wraps a ``tokenizer.json`` via the `tokenizers` Rust
  library when a real checkpoint directory is supplied.
- ``WordPieceTokenizer``: self-contained BERT-style WordPiece (basic
  tokenization: lowercase, punctuation split, CJK char split; greedy
  longest-match subwords) — works with any BERT ``vocab.txt``.
- ``SimpleTokenizer``: deterministic hashing tokenizer so the framework runs
  fully self-contained (random-init models) with a stable text→ids map.

All expose ``encode(text) -> List[int]`` (with special tokens) and
``encode_pair(a, b)`` for cross-encoder inputs.
"""

from __future__ import annotations

import os
import unicodedata
from typing import List, Optional, Tuple


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or
            0xF900 <= cp <= 0xFAFF or 0x20000 <= cp <= 0x2A6DF)


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT basic tokenizer: whitespace split, punctuation/CJK isolation."""
    if lowercase:
        text = text.lower()
    out: List[str] = []
    buf: List[str] = []

    def flush():
        if buf:
            out.append("".join(buf))
            buf.clear()

    for ch in text:
        if ch.isspace():
            flush()
        elif _is_punct(ch) or _is_cjk(ch):
            flush()
            out.append(ch)
        else:
            buf.append(ch)
    flush()
    return out


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a BERT vocab."""

    def __init__(self, vocab: dict, unk_token: str = "[UNK]",
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]", lowercase: bool = True,
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.lowercase = lowercase
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_chars = max_input_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    @classmethod
    def build_from_corpus(cls, texts, vocab_size: int = 8192,
                          lowercase: bool = True) -> "WordPieceTokenizer":
        """Train a frequency-based WordPiece-ish vocab (whole words + char
        fallback) so self-contained deployments get a real subword map."""
        from collections import Counter
        counts: Counter = Counter()
        chars: set = set()
        for t in texts:
            for w in basic_tokenize(t, lowercase):
                counts[w] += 1
                chars.update(w)
        specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        vocab = {s: i for i, s in enumerate(specials)}
        for ch in sorted(chars):
            if ch not in vocab:
                vocab[ch] = len(vocab)
            cont = "##" + ch
            if cont not in vocab:
                vocab[cont] = len(vocab)
        for w, _ in counts.most_common():
            if len(vocab) >= vocab_size:
                break
            if w not in vocab:
                vocab[w] = len(vocab)
        return cls(vocab, lowercase=lowercase)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for w in basic_tokenize(text, self.lowercase):
            ids.extend(self._wordpiece(w))
        return ids

    def encode(self, text: str, max_len: Optional[int] = None) -> List[int]:
        ids = [self.cls_id] + self.tokenize_ids(text) + [self.sep_id]
        return ids[:max_len] if max_len else ids

    def encode_pair(self, a: str, b: str, max_len: Optional[int] = None
                    ) -> Tuple[List[int], List[int]]:
        """Returns (ids, token_type_ids) for a [CLS] a [SEP] b [SEP] pair."""
        ia = self.tokenize_ids(a)
        ib = self.tokenize_ids(b)
        if max_len:
            # truncate the longer of the two (HF 'longest_first')
            budget = max_len - 3
            while len(ia) + len(ib) > budget:
                if len(ia) >= len(ib):
                    ia.pop()
                else:
                    ib.pop()
        ids = [self.cls_id] + ia + [self.sep_id] + ib + [self.sep_id]
        types = [0] * (len(ia) + 2) + [1] * (len(ib) + 1)
        return ids, types

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def decode(self, ids: List[int]) -> str:
        inv = getattr(self, "_inv", None)
        if inv is None:
            inv = self._inv = {v: k for k, v in self.vocab.items()}
        parts: List[str] = []
        for i in ids:
            tok = inv.get(int(i), "[UNK]")
            if tok.startswith("##") and parts:
                parts[-1] += tok[2:]
            elif tok not in ("[CLS]", "[SEP]", "[PAD]"):
                parts.append(tok)
        return " ".join(parts)


class SimpleTokenizer:
    """Deterministic hashing tokenizer: stable ids without any vocab file.

    Used when no checkpoint/vocab is configured; ids hash into
    [n_special, vocab_size)."""

    def __init__(self, vocab_size: int = 30522):
        self._vocab_size = vocab_size
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 1, 2, 3
        self.n_special = 4

    def _tok_id(self, tok: str) -> int:
        import hashlib
        h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little")
        return self.n_special + h % (self._vocab_size - self.n_special)

    def tokenize_ids(self, text: str) -> List[int]:
        # native fast path (simpletok.cpp): byte-identical ids for ASCII
        # text, 16x faster than the per-char Python loop + per-token md5
        # (the hashing fallback was the fast-reranker wave bottleneck —
        # BENCH_NOTES "fast reranker"); non-ASCII falls back here
        from ragmeup_tpu.native import simpletok_encode
        ids = simpletok_encode(text, self._vocab_size, self.n_special)
        if ids is not None:
            return ids
        return [self._tok_id(t) for t in basic_tokenize(text)]

    def encode(self, text: str, max_len: Optional[int] = None) -> List[int]:
        ids = [self.cls_id] + self.tokenize_ids(text) + [self.sep_id]
        return ids[:max_len] if max_len else ids

    def encode_pair(self, a: str, b: str, max_len: Optional[int] = None):
        ia, ib = self.tokenize_ids(a), self.tokenize_ids(b)
        if max_len:
            budget = max_len - 3
            while len(ia) + len(ib) > budget:
                (ia if len(ia) >= len(ib) else ib).pop()
        ids = [self.cls_id] + ia + [self.sep_id] + ib + [self.sep_id]
        types = [0] * (len(ia) + 2) + [1] * (len(ib) + 1)
        return ids, types

    def decode(self, ids: List[int]) -> str:
        """Hash ids are not invertible; emit placeholders (self-contained
        random-init mode produces token-id text by design)."""
        return " ".join(f"<{int(i)}>" for i in ids
                        if int(i) >= self.n_special)

    @property
    def vocab_size(self) -> int:
        return self._vocab_size


class HFTokenizer:
    """tokenizer.json via the Rust `tokenizers` library (when available)."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer  # rust wheel, baked in
        self._tok = Tokenizer.from_file(path)
        self.pad_id = self._tok.token_to_id("[PAD]") or 0

    def encode(self, text: str, max_len: Optional[int] = None) -> List[int]:
        ids = self._tok.encode(text).ids
        return ids[:max_len] if max_len else ids

    def encode_pair(self, a: str, b: str, max_len: Optional[int] = None):
        enc = self._tok.encode(a, b)
        ids, types = enc.ids, enc.type_ids
        if max_len:
            ids, types = ids[:max_len], types[:max_len]
        return ids, types

    def tokenize_ids(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(list(ids))

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()


def load_tokenizer(checkpoint_dir: Optional[str] = None,
                   vocab_size: int = 30522):
    """Tokenizer resolution: checkpoint tokenizer.json → vocab.txt →
    deterministic SimpleTokenizer."""
    if checkpoint_dir:
        tj = os.path.join(checkpoint_dir, "tokenizer.json")
        if os.path.exists(tj):
            try:
                return HFTokenizer(tj)
            except Exception:
                pass
        vt = os.path.join(checkpoint_dir, "vocab.txt")
        if os.path.exists(vt):
            return WordPieceTokenizer.from_vocab_file(vt)
    return SimpleTokenizer(vocab_size)
