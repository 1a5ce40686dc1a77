"""Text splitters.

Two splitters, matching the reference's dispatch (``RAGHelper.py:343-349``):

- ``RecursiveCharacterSplitter`` — recursive separator-based splitting with
  the reference's CJK-aware separator list (``RAGHelper.py:311-326``),
  ``chunk_size`` measured in characters, with ``chunk_overlap``.
- ``SemanticSplitter`` — embedding-based semantic chunking
  (``RAGHelper.py:329-341``): sentences are embedded (batched on device by
  the caller-supplied ``embed_fn``), adjacent-window cosine distances are
  thresholded (percentile / standard_deviation / interquartile / gradient),
  and breakpoints become chunk boundaries.

Both are original implementations against NumPy, not ports of LangChain code.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

import numpy as np

from ragmeup_tpu_torch.data.documents import Chunk

# Separator list semantics from the reference (RAGHelper.py:311-326):
# paragraph, line, CJK zero-width space and punctuation, ASCII sentence
# punctuation, space, then character-level fallback.
DEFAULT_SEPARATORS = [
    "\n\n",
    "\n",
    ".",
    "​",  # zero-width space (CJK word boundary)
    "，",  # fullwidth comma
    "、",  # ideographic comma
    "．",  # fullwidth full stop
    "。",  # ideographic full stop
    " ",
    "",
]


class RecursiveCharacterSplitter:
    """Recursively split text on a separator hierarchy, merging pieces into
    chunks of at most ``chunk_size`` characters with ``chunk_overlap``."""

    def __init__(self, chunk_size: int = 512, chunk_overlap: int = 20,
                 separators: Optional[Sequence[str]] = None,
                 keep_separator: bool = True):
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be < chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = list(separators) if separators is not None else list(DEFAULT_SEPARATORS)
        self.keep_separator = keep_separator

    # -- core ---------------------------------------------------------------

    def split_text(self, text: str) -> List[str]:
        return [t for t in self._split(text, self.separators) if t.strip()]

    def _split(self, text: str, separators: Sequence[str]) -> List[str]:
        """Split `text` with the first separator present, recursing into
        oversized fragments with the remaining separators."""
        if len(text) <= self.chunk_size:
            return [text]
        # choose separator: first in hierarchy that occurs in text ('' always)
        sep, rest = "", []
        for i, s in enumerate(separators):
            if s == "":
                sep, rest = "", []
                break
            if s in text:
                sep, rest = s, separators[i + 1:]
                break
        if sep == "":
            pieces = [text[i:i + self.chunk_size] for i in range(0, len(text), self.chunk_size - self.chunk_overlap)]
            return pieces
        raw = text.split(sep)
        if self.keep_separator:
            # re-attach separator to the end of each piece except the last
            pieces = [p + sep for p in raw[:-1]] + [raw[-1]]
        else:
            pieces = raw
        # recurse into any piece still too large, then merge small pieces
        expanded: List[str] = []
        for p in pieces:
            if len(p) > self.chunk_size and rest:
                expanded.extend(self._split(p, rest))
            elif len(p) > self.chunk_size:
                step = self.chunk_size - self.chunk_overlap
                expanded.extend(p[i:i + self.chunk_size] for i in range(0, len(p), step))
            else:
                expanded.append(p)
        return self._merge(expanded)

    def _merge(self, pieces: List[str]) -> List[str]:
        """Greedily pack pieces into chunks <= chunk_size, carrying
        chunk_overlap characters of trailing context into the next chunk."""
        chunks: List[str] = []
        cur = ""
        for p in pieces:
            if not p:
                continue
            if len(cur) + len(p) <= self.chunk_size:
                cur += p
            else:
                if cur:
                    chunks.append(cur)
                    # seed next chunk with overlap tail
                    if self.chunk_overlap > 0:
                        tail = cur[-self.chunk_overlap:]
                        cur = tail + p if len(tail) + len(p) <= self.chunk_size else p
                    else:
                        cur = p
                else:
                    cur = p
        if cur:
            chunks.append(cur)
        return chunks

    def split_chunks(self, docs: Sequence[Chunk]) -> List[Chunk]:
        out: List[Chunk] = []
        for d in docs:
            for piece in self.split_text(d.content):
                out.append(Chunk(content=piece, metadata=dict(d.metadata)))
        return out


_SENTENCE_RE = re.compile(r"(?<=[.!?。．])\s+|\n+")


def split_sentences(text: str) -> List[str]:
    sents = [s.strip() for s in _SENTENCE_RE.split(text)]
    return [s for s in sents if s]


class SemanticSplitter:
    """Embedding-based semantic chunking.

    ``embed_fn(list[str]) -> np.ndarray (n, d)`` is supplied by the caller —
    in production it is the batched sentence-encoder forward, so the whole
    document's sentences embed in one device call (vs the reference's
    dependency on langchain_experimental.SemanticChunker).
    """

    def __init__(self, embed_fn: Callable[[List[str]], np.ndarray],
                 breakpoint_threshold_type: str = "percentile",
                 breakpoint_threshold_amount: Optional[float] = None,
                 number_of_chunks: Optional[int] = None,
                 buffer_size: int = 1,
                 min_chunk_chars: int = 1):
        self.embed_fn = embed_fn
        self.threshold_type = breakpoint_threshold_type
        self.threshold_amount = breakpoint_threshold_amount
        self.number_of_chunks = number_of_chunks
        self.buffer_size = buffer_size
        self.min_chunk_chars = min_chunk_chars

    def _window(self, sents: List[str]) -> List[str]:
        b = self.buffer_size
        out = []
        for i in range(len(sents)):
            lo, hi = max(0, i - b), min(len(sents), i + b + 1)
            out.append(" ".join(sents[lo:hi]))
        return out

    def split_text(self, text: str) -> List[str]:
        sents = split_sentences(text)
        if len(sents) <= 1:
            return [text] if text.strip() else []
        emb = np.asarray(self.embed_fn(self._window(sents)), dtype=np.float32)
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
        sims = np.sum(emb[:-1] * emb[1:], axis=1)
        dists = (1.0 - sims).astype(np.float64)  # adjacent-window distances
        if self.number_of_chunks is not None and self.number_of_chunks > 1:
            # exact-count mode: break at the top (n-1) distances
            k = min(self.number_of_chunks - 1, len(dists))
            breakpoints = np.sort(np.argpartition(dists, -k)[-k:])
        else:
            thresh = self._breakpoint_threshold(dists)
            breakpoints = np.nonzero(dists > thresh)[0]  # break AFTER sentence i
        chunks, start = [], 0
        for bp in breakpoints:
            piece = " ".join(sents[start:bp + 1]).strip()
            if len(piece) >= self.min_chunk_chars:
                chunks.append(piece)
                start = bp + 1
        tail = " ".join(sents[start:]).strip()
        if tail:
            chunks.append(tail)
        return chunks

    def _breakpoint_threshold(self, dists: np.ndarray) -> float:
        amt = self.threshold_amount
        t = self.threshold_type
        if t == "percentile":
            return float(np.percentile(dists, 95.0 if amt is None else amt))
        if t == "standard_deviation":
            m = 3.0 if amt is None else amt
            return float(dists.mean() + m * dists.std())
        if t == "interquartile":
            m = 1.5 if amt is None else amt
            q1, q3 = np.percentile(dists, [25, 75])
            return float(dists.mean() + m * (q3 - q1))
        if t == "gradient":
            grad = np.gradient(dists) if len(dists) > 1 else dists
            return float(np.percentile(grad, 95.0 if amt is None else amt))
        raise ValueError(f"unknown breakpoint_threshold_type: {t}")

    def split_chunks(self, docs: Sequence[Chunk]) -> List[Chunk]:
        out: List[Chunk] = []
        for d in docs:
            for piece in self.split_text(d.content):
                out.append(Chunk(content=piece, metadata=dict(d.metadata)))
        return out


def make_splitter(cfg, embed_fn: Optional[Callable] = None):
    """Splitter dispatch (parity with RAGHelper.py:343-349)."""
    name = cfg.data.splitter
    if name in ("RecursiveCharacterTextSplitter", "recursive"):
        return RecursiveCharacterSplitter(cfg.data.chunk_size, cfg.data.chunk_overlap)
    if name in ("SemanticChunker", "semantic"):
        if embed_fn is None:
            raise ValueError("SemanticChunker requires an embed_fn")
        return SemanticSplitter(
            embed_fn,
            breakpoint_threshold_type=cfg.data.breakpoint_threshold_type,
            breakpoint_threshold_amount=cfg.data.breakpoint_threshold_amount,
            number_of_chunks=cfg.data.number_of_chunks,
        )
    raise ValueError(f"unknown splitter: {name}")
