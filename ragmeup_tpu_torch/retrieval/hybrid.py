"""Hybrid retrieval: sparse BM25 + dense cosine, fused with weighted RRF.

Counterpart of ``ragmeup_tpu/retrieval/hybrid.py`` for one device and the
exact dense engine. ``hybrid_fused_search`` runs, as one function on
tensors: dense top-k (the fused kernel) → MMR over the top-fetch_k
candidates when ``search_type="mmr"`` → BM25 → weighted RRF, and brings one
small result back to the host. The corpus-sharded mesh path and the IVF
engine are not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ragmeup_tpu.data.documents import Chunk
from ragmeup_tpu.data.store import ChunkStore
from ragmeup_tpu_torch.ops.fusion import (mmr_select_device, rrf_fuse,
                                          rrf_fuse_device)
from ragmeup_tpu_torch.ops.topk import NEG_INF, dense_topk
from ragmeup_tpu_torch.retrieval.dense import DenseIndex
from ragmeup_tpu_torch.retrieval.sparse import BM25Index


class HybridRetriever:
    """sparse ∪ dense → RRF → (optional) rerank."""

    def __init__(self, store: ChunkStore, dense: DenseIndex, sparse: BM25Index,
                 embed_query_fn: Callable[[Sequence[str]], np.ndarray],
                 k: int = 10, weights: Sequence[float] = (0.5, 0.5),
                 rrf_c: int = 60, search_type: str = "mmr",
                 mmr_fetch_k: int = 20, mmr_lambda: float = 0.5,
                 reranker=None, rerank_k: int = 3,
                 re2_prompt: Optional[str] = None, ann: str = "exact"):
        if ann != "exact":
            raise NotImplementedError(
                f"retrieval.ann={ann!r}: only the exact engine is ported "
                "(ROADMAP queue 1: IVF)")
        self.store = store
        self.dense = dense
        self.sparse = sparse
        self.embed_query_fn = embed_query_fn
        self.k = k
        self.weights = tuple(weights)
        self.rrf_c = rrf_c
        self.search_type = search_type
        self.mmr_fetch_k = mmr_fetch_k
        self.mmr_lambda = mmr_lambda
        self.reranker = reranker
        self.rerank_k = rerank_k
        self.re2_prompt = re2_prompt

    def retrieve_rows(self, query: str, k: Optional[int] = None) -> List[tuple]:
        """Hybrid top-k as (row, fused_score) pairs."""
        k = k or self.k
        qv = np.asarray(self.embed_query_fn([query]))
        return hybrid_fused_search(
            self.dense, self.sparse, [query], qv, k,
            weights=self.weights, rrf_c=self.rrf_c,
            re2_prompt=self.re2_prompt, search_type=self.search_type,
            fetch_k=self.mmr_fetch_k, mmr_lambda=self.mmr_lambda)[0]

    def retrieve(self, query: str, k: Optional[int] = None,
                 rerank: Optional[bool] = None) -> List[Chunk]:
        """Hybrid fuse → chunks with relevance_score metadata → optional
        cross-encoder rerank down to rerank_k."""
        fused = self.retrieve_rows(query, k)
        chunks: List[Chunk] = []
        for row, score in fused:
            c = self.store[row]
            md = dict(c.metadata)
            md["relevance_score"] = float(score)
            md["pk"] = int(row)
            chunks.append(Chunk(content=c.content, metadata=md, id=c.id))
        do_rerank = self.reranker is not None if rerank is None else (
            rerank and self.reranker is not None)
        if do_rerank and chunks:
            chunks = self.reranker.rerank(query, chunks, top_n=self.rerank_k)
        return chunks


def _hybrid_fused(qv: torch.Tensor, dense: DenseIndex, sparse: BM25Index,
                  inputs: dict, k: int, nq: int, w_sparse: float,
                  w_dense: float, rrf_c: int, mmr: bool, fetch_k: int,
                  mmr_lambda: float):
    """Dense top-k → optional MMR → BM25 → RRF, all on the index device.
    qv: (nq, d) normalized f32 queries. Returns (scores, ids) (nq, k)."""
    corpus_t = dense._corpus_t
    kd = fetch_k if mmr else k
    ds, di = dense_topk(qv, corpus_t, kd, mask=dense._mask)
    valid = ds > NEG_INF / 2
    di = torch.where(valid, di, torch.full_like(di, -1))
    if mmr:
        safe = torch.clamp_min(di, 0).long()
        cand = corpus_t.T[safe].float()                    # (nq, kd, d)
        order = torch.stack([
            mmr_select_device(qv[i], cand[i], valid[i], k, mmr_lambda)
            for i in range(nq)])                           # (nq, k)
        sel = torch.gather(di, 1, torch.clamp_min(order, 0).long())
        di = torch.where(order >= 0, sel, torch.full_like(sel, -1))
    ss, si = sparse.score_topk(inputs, k, nq)
    si = torch.where(ss > 0, si, torch.full_like(si, -1))
    return rrf_fuse_device(si, di, w_sparse, w_dense, rrf_c, k)


def hybrid_fused_search(dense: DenseIndex, sparse: BM25Index, queries, qvecs,
                        k, weights=(0.5, 0.5), rrf_c: int = 60,
                        re2_prompt=None, search_type: str = "similarity",
                        fetch_k: int = 20, mmr_lambda: float = 0.5):
    """Batched hybrid top-k over both indexes with RRF on the device.

    Returns per-query lists of (row, fused_score). Falls back to separate
    searches fused on the host only for empty indexes or a query with no
    BM25 term in the vocabulary, as the JAX package does."""
    nq = len(queries)
    if dense.n == 0 and sparse.n == 0:
        return [[] for _ in range(nq)]
    if dense.n == 0 or sparse.live_count == 0:
        s_hits = sparse.search(queries, k, re2_prompt=re2_prompt)
        d_hits = dense.search(qvecs, k, search_type=search_type,
                              fetch_k=fetch_k, mmr_lambda=mmr_lambda
                              ) if dense.n else [[] for _ in range(nq)]
        return [
            rrf_fuse([[r for r, _ in s_hits[i]], [r for r, _ in d_hits[i]]],
                     weights=weights, c=rrf_c, k=k)
            for i in range(nq)
        ]
    q = np.asarray(qvecs, np.float32)
    if dense.normalize:
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    inputs = sparse.build_query_inputs(queries, re2_prompt)
    kk = min(k, max(dense.n - len(dense.dead), 1))
    if inputs is None:
        d_hits = dense.search(qvecs, k, search_type=search_type,
                              fetch_k=fetch_k, mmr_lambda=mmr_lambda)
        return [[(r, 1.0 / (rank + 1 + rrf_c) * weights[1])
                 for rank, (r, _) in enumerate(d_hits[i])]
                for i in range(nq)]
    fs, fi = _hybrid_fused(
        torch.from_numpy(q).to(dense.device), dense, sparse, inputs, k=kk,
        nq=nq, w_sparse=weights[0], w_dense=weights[1], rrf_c=rrf_c,
        mmr=search_type == "mmr", fetch_k=min(fetch_k, dense.n),
        mmr_lambda=mmr_lambda)
    fs, fi = fs.cpu().numpy(), fi.cpu().numpy()
    return [[(int(r), float(s)) for r, s in zip(fi[i], fs[i]) if r >= 0]
            for i in range(nq)]
