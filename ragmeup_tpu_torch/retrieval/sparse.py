"""BM25 sparse index with device scoring.

Counterpart of ``ragmeup_tpu/retrieval/sparse.py``. The host side (the
analyzer, the native C++ postings builder via ``ragmeup_tpu.native``, the
flush into per-posting Okapi contributions, query preparation and the
NumPy oracle) is the JAX package's, copied because that module imports jax.
Scoring is exact Okapi BM25 with ``rank_bm25.BM25Okapi`` idf semantics.

Device scoring (``_bm25_score_topk``): high-df head terms are rows of a
device-resident contribution matrix scored with one matmul ``qsel @ head``;
the query terms' tail postings stream to the device and add into the score
plane; then the additive mask and top-k by (-score, index).

The tail sum is deterministic: a query's stream holds each document at most
once per term, so the stream is cut into layers (first occurrence of each
(query, doc) slot, second occurrence, ...) with no repeated slot inside a
layer, and the layers add in stream order. Every slot thus sums its
addends in the order the JAX package's sequential scatter does, and
documents with identical term statistics get bit-identical scores.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch.ops.topk import NEG_INF, rank_topk

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def analyze(text: str) -> List[str]:
    """Default analyzer: lowercase, split on non-alphanumeric (Tantivy's
    'simple' tokenizer behavior)."""
    return _TOKEN_RE.findall(text.lower())


def sanitize_query(query: str, re2_prompt: Optional[str] = None) -> str:
    """Drop the Re2 suffix if present and strip ():' characters."""
    if re2_prompt:
        pos = query.find(re2_prompt)
        if pos >= 0:
            query = query[:pos]
    return query.translate(str.maketrans("", "", "():'"))


BM25_EPSILON = 0.25  # rank_bm25 BM25Okapi default


def _okapi_idf(df: np.ndarray, n_live: int) -> np.ndarray:
    """Exact rank_bm25 BM25Okapi idf: log((N-df+0.5)/(df+0.5)); negative
    values floored to epsilon * average_idf, where the average runs over
    the corpus vocabulary (terms with df > 0, negatives included)."""
    df = np.asarray(df, np.float64)
    present = df > 0
    raw = np.zeros_like(df)
    raw[present] = (np.log(n_live - df[present] + 0.5)
                    - np.log(df[present] + 0.5))
    if present.any():
        eps = BM25_EPSILON * raw[present].mean()
        raw[present & (raw < 0)] = eps
    return raw


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def _tail_layers(flat: np.ndarray) -> List[np.ndarray]:
    """Positions of the stream grouped by occurrence rank of their slot:
    layer r holds the (r+1)-th occurrence of every slot, in stream order."""
    order = np.argsort(flat, kind="stable")
    sorted_keys = flat[order]
    starts = np.r_[0, np.nonzero(np.diff(sorted_keys))[0] + 1]
    run_start = np.repeat(starts, np.diff(np.r_[starts, len(flat)]))
    rank = np.empty(len(flat), np.int64)
    rank[order] = np.arange(len(flat)) - run_start
    return [np.nonzero(rank == r)[0] for r in range(int(rank.max()) + 1)]


def _bm25_score_topk(qsel: torch.Tensor, head: torch.Tensor,
                     docs_cat: np.ndarray, contrib_cat: np.ndarray,
                     qid_cat: np.ndarray, mask: torch.Tensor, k: int, nq: int,
                     cap: int, has_head: bool, has_tail: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qsel (nq, H) one-hot over head terms; head (H, cap) contribution
    matrix; tail stream (L,) on the host (padding entries target slot `cap`
    with contribution 0); mask (cap,) additive → (scores, rows) top-k."""
    dev = head.device
    scores = torch.zeros((nq, cap + 1), dtype=torch.float32, device=dev)
    if has_head:
        scores[:, :cap] += qsel @ head
    real = docs_cat < cap  # power-of-two padding only feeds the unread slot
    if has_tail and real.any():
        flat = qid_cat[real].astype(np.int64) * (cap + 1) + docs_cat[real]
        contrib_cat = contrib_cat[real]
        plane = scores.view(-1)
        idx = torch.from_numpy(flat).to(dev)
        con = torch.from_numpy(np.asarray(contrib_cat, np.float32)).to(dev)
        for layer in _tail_layers(flat):
            sel = torch.from_numpy(layer).to(dev)
            plane.index_add_(0, idx[sel], con[sel])
    out = scores[:, :cap] + mask[None, :]
    s, i = rank_topk(out, k)
    return s, i.to(torch.int32)


class BM25Index:
    """Okapi BM25: dense-head + sparse-tail device scoring."""

    def __init__(self, k1: float = 1.5, b: float = 0.75, tile_n: int = 1024,
                 dense_df_ratio: float = 1.0 / 64.0,
                 dense_min_df: int = 1024, use_native: str = "auto",
                 device=None):
        self.k1 = k1
        self.b = b
        self.tile_n = tile_n
        # a term goes in the dense head when df >= max(dense_min_df,
        # cap * dense_df_ratio)
        self.dense_df_ratio = dense_df_ratio
        self.dense_min_df = dense_min_df
        self.device = torch.device(device or "cpu")
        self.vocab: Dict[str, int] = {}
        self._tri: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._doc_len: List[int] = []
        self.dead: set = set()
        self.n = 0
        self._device: Optional[dict] = None
        # native C++ analyzer/postings builder (ragmeup_tpu/native); 'auto'
        # uses it when the toolchain-built library is available
        self.use_native = use_native
        self._native = None

    def _native_analyzer(self):
        if self.use_native == "off":
            return None
        if self._native is None:
            try:
                from ragmeup_tpu import native
                if native.available():
                    self._native = native.NativeAnalyzer(
                        vocab=list(self.vocab))
                elif self.use_native == "on":
                    raise RuntimeError("native analyzer requested but unavailable")
                else:
                    self.use_native = "off"
            except ImportError:
                self.use_native = "off"
        return self._native

    # -- build -----------------------------------------------------------------

    def add(self, texts: Sequence[str]) -> List[int]:
        """Tokenize and append documents; returns their row ids."""
        native = self._native_analyzer()
        if native is not None and texts:
            t, r, f, dl = native.add_batch(list(texts), row_start=self.n)
            self._doc_len.extend(int(x) for x in dl)
            if len(t):
                self._tri.append((t, r, f))
            terms = native.vocab()
            for i in range(len(self.vocab), len(terms)):
                self.vocab[terms[i]] = i
            out = list(range(self.n, self.n + len(texts)))
            self.n += len(texts)
            self._device = None
            return out
        rows: List[int] = []
        tids: List[int] = []
        rids: List[int] = []
        tfs: List[int] = []
        for text in texts:
            row = self.n
            toks = analyze(text)
            self._doc_len.append(len(toks))
            counts: Dict[int, int] = {}
            for term in toks:
                tid = self.vocab.get(term)
                if tid is None:
                    tid = len(self.vocab)
                    self.vocab[term] = tid
                counts[tid] = counts.get(tid, 0) + 1
            tids.extend(counts.keys())
            rids.extend([row] * len(counts))
            tfs.extend(counts.values())
            self.n += 1
            rows.append(row)
        if tids:
            self._tri.append((np.asarray(tids, np.int32),
                              np.asarray(rids, np.int32),
                              np.asarray(tfs, np.float32)))
        self._device = None
        return rows

    def delete_rows(self, rows: Sequence[int]) -> None:
        changed = False
        for r in rows:
            r = int(r)
            if 0 <= r < self.n and r not in self.dead:
                self.dead.add(r)
                changed = True
        if changed:
            self._device = None  # idf/avgdl change globally

    @property
    def live_count(self) -> int:
        return self.n - len(self.dead)

    # -- flush -------------------------------------------------------------------

    def _capacity(self) -> int:
        cap = self.tile_n
        while cap < max(self.n, 1):
            cap *= 2
        return cap

    def _postings(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self._tri:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        return (np.concatenate([t for t, _, _ in self._tri]),
                np.concatenate([r for _, r, _ in self._tri]),
                np.concatenate([f for _, _, f in self._tri]))

    def _flush(self) -> dict:
        if self._device is not None:
            return self._device
        cap = self._capacity()
        V = len(self.vocab)
        t_all, r_all, f_all = self._postings()
        live_mask_rows = np.ones(max(self.n, 1), bool)
        if self.dead:
            live_mask_rows[list(self.dead)] = False
        live_post = live_mask_rows[r_all] if len(r_all) else np.zeros(0, bool)
        n_live = max(self.live_count, 1)
        dl = np.asarray(self._doc_len, np.float64) if self.n else np.zeros(0)
        avgdl = float(dl[live_mask_rows[:self.n]].mean()) if n_live and self.n else 1.0
        # live df per term, exact rank_bm25 idf (dead rows excluded)
        df = np.bincount(t_all[live_post], minlength=V).astype(np.float64)
        idf = _okapi_idf(df, n_live)
        denom = f_all + self.k1 * (1 - self.b + self.b *
                                   (dl[r_all] if len(r_all) else 0) / avgdl)
        contrib = (idf[t_all] * f_all * (self.k1 + 1) / np.maximum(denom, 1e-9)
                   ).astype(np.float32)
        # sort postings by term → CSR offsets
        order = np.argsort(t_all, kind="stable")
        t_s, r_s, c_s = t_all[order], r_all[order], contrib[order]
        counts = np.bincount(t_s, minlength=V)
        offsets = np.zeros(V + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        # dense head / sparse tail split
        thresh = max(self.dense_min_df, int(cap * self.dense_df_ratio))
        head_terms = np.nonzero(df >= thresh)[0].astype(np.int32)
        head_row_of = np.full(V, -1, np.int32)
        head_row_of[head_terms] = np.arange(len(head_terms), dtype=np.int32)
        H = np.zeros((len(head_terms), cap), np.float32)
        for hrow, tid in enumerate(head_terms):
            lo, hi = offsets[tid], offsets[tid + 1]
            H[hrow, r_s[lo:hi]] = c_s[lo:hi]
        mask = np.full(cap, NEG_INF, np.float32)
        mask[np.nonzero(live_mask_rows[:self.n])[0]] = 0.0
        self._device = {
            "cap": cap,
            "offsets": offsets,
            "pdoc": r_s,
            "pcontrib": c_s,
            "idf": idf.astype(np.float32),
            "df": df,
            "head_terms": head_terms,
            "head_row_of": head_row_of,
            "head": torch.from_numpy(H).to(self.device),
            "mask": torch.from_numpy(mask).to(self.device),
            "avgdl": avgdl,
        }
        return self._device

    # -- query --------------------------------------------------------------------

    def build_query_inputs(self, queries: Sequence[str],
                           re2_prompt: Optional[str] = None):
        """Host-side query preparation shared by search() and the fused
        hybrid path: one-hot head-term selector + concatenated tail posting
        stream (padded to a power of two). Returns None when no query term
        is in the vocabulary."""
        dev = self._flush()
        cap = dev["cap"]
        nq = len(queries)
        n_head = len(dev["head_terms"])
        qsel = np.zeros((nq, max(n_head, 1)), np.float32)
        doc_l, con_l, qid_l = [], [], []
        any_head = False
        for qi, qtext in enumerate(queries):
            for term in set(analyze(sanitize_query(qtext, re2_prompt))):
                tid = self.vocab.get(term)
                if tid is None:
                    continue
                hrow = dev["head_row_of"][tid]
                if hrow >= 0:
                    qsel[qi, hrow] = 1.0
                    any_head = True
                else:
                    lo, hi = dev["offsets"][tid], dev["offsets"][tid + 1]
                    doc_l.append(dev["pdoc"][lo:hi])
                    con_l.append(dev["pcontrib"][lo:hi])
                    qid_l.append(np.full(hi - lo, qi, np.int32))
        has_tail = bool(doc_l)
        if not has_tail and not any_head:
            return None
        if has_tail:
            docs_cat = np.concatenate(doc_l)
            L = _next_pow2(max(len(docs_cat), 1))
            pad = L - len(docs_cat)
            docs_cat = np.concatenate([docs_cat, np.full(pad, cap, np.int32)])
            con_cat = np.concatenate(con_l + [np.zeros(pad, np.float32)])
            qid_cat = np.concatenate(qid_l + [np.zeros(pad, np.int32)])
        else:
            docs_cat = np.full(1, cap, np.int32)
            con_cat = np.zeros(1, np.float32)
            qid_cat = np.zeros(1, np.int32)
        return {"dev": dev, "qsel": qsel, "docs_cat": docs_cat,
                "con_cat": con_cat, "qid_cat": qid_cat,
                "has_head": n_head > 0, "has_tail": has_tail, "cap": cap}

    def score_topk(self, inputs: dict, k: int, nq: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device scoring of prepared query inputs → (scores, rows) top-k."""
        dev = inputs["dev"]
        return _bm25_score_topk(
            torch.from_numpy(inputs["qsel"]).to(self.device), dev["head"],
            inputs["docs_cat"], inputs["con_cat"], inputs["qid_cat"],
            dev["mask"], k=k, nq=nq, cap=inputs["cap"],
            has_head=inputs["has_head"], has_tail=inputs["has_tail"])

    def search(self, queries: Sequence[str], k: int,
               re2_prompt: Optional[str] = None) -> List[List[Tuple[int, float]]]:
        """BM25 top-k per query string: one head matmul + tail adds.
        Returns per-query lists of (row, score>0), desc."""
        if self.n == 0 or self.live_count == 0:
            return [[] for _ in queries]
        inputs = self.build_query_inputs(queries, re2_prompt)
        if inputs is None:
            return [[] for _ in queries]
        nq = len(queries)
        s, idx = self.score_topk(inputs, min(k, self.live_count), nq)
        s, idx = s.cpu().numpy(), idx.cpu().numpy()
        return [[(int(i), float(v)) for i, v in zip(idx[r], s[r]) if v > 0.0]
                for r in range(nq)]

    # -- persistence ------------------------------------------------------------------

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        t_all, r_all, f_all = self._postings()
        np.savez(os.path.join(directory, "bm25_postings.npz"),
                 tids=t_all, rows=r_all, tfs=f_all,
                 doc_len=np.asarray(self._doc_len, np.int32))
        meta = {"k1": self.k1, "b": self.b, "tile_n": self.tile_n,
                "dense_df_ratio": self.dense_df_ratio,
                "dense_min_df": self.dense_min_df, "n": self.n,
                "dead": sorted(self.dead), "vocab": list(self.vocab.keys())}
        with open(os.path.join(directory, "bm25_meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str, device=None) -> "BM25Index":
        with open(os.path.join(directory, "bm25_meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["k1"], meta["b"], meta["tile_n"],
                  meta.get("dense_df_ratio", 1 / 64),
                  meta.get("dense_min_df", 1024), device=device)
        data = np.load(os.path.join(directory, "bm25_postings.npz"))
        idx.vocab = {t: i for i, t in enumerate(meta["vocab"])}
        if len(data["tids"]):
            idx._tri = [(data["tids"], data["rows"], data["tfs"])]
        idx._doc_len = data["doc_len"].astype(int).tolist()
        idx.n = meta["n"]
        idx.dead = set(meta.get("dead", []))
        return idx

    @classmethod
    def exists(cls, directory: str) -> bool:
        return os.path.exists(os.path.join(directory, "bm25_meta.json"))


# ---------------------------------------------------------------------------
# NumPy oracle (rank_bm25 Okapi semantics) for tests.
# ---------------------------------------------------------------------------

def bm25_oracle(corpus_texts: Sequence[str], query: str, k1: float = 1.5,
                b: float = 0.75, dead_rows=()) -> np.ndarray:
    """Exact Okapi BM25 scores of `query` against every live document."""
    docs = [analyze(t) for t in corpus_texts]
    live = [i for i in range(len(docs)) if i not in set(dead_rows)]
    n = len(live)
    dl = np.array([len(docs[i]) for i in live], np.float64)
    avgdl = dl.mean() if n else 1.0
    vocab = sorted({t for i in live for t in docs[i]})
    df = np.array([sum(1 for i in live if term in docs[i]) for term in vocab],
                  np.float64)
    idf_arr = _okapi_idf(df, n)
    idf_of = {term: idf_arr[j] for j, term in enumerate(vocab)}
    qterms = set(analyze(query))
    scores = np.zeros(len(docs), np.float64)
    for term in qterms:
        if term not in idf_of:
            continue
        idf = idf_of[term]
        for pos, i in enumerate(live):
            tf = docs[i].count(term)
            if tf:
                denom = tf + k1 * (1 - b + b * dl[pos] / avgdl)
                scores[i] += idf * tf * (k1 + 1) / denom
    scores[list(dead_rows)] = -np.inf
    return scores
