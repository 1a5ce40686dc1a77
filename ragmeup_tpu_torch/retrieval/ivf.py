"""IVF (inverted-file) cluster pruning for the dense index.

Counterpart of ``ragmeup_tpu/retrieval/ivf.py``: the engine behind
``retrieval.ann="ivf"``, for single-query latency on very large corpora.
Everything is dense products, sorts and gathers on the device, as in the
JAX package (no Pallas kernel there either).

- **fit**: Lloyd's k-means on the device (assign = argmax of an (n, K)
  product, first maximum on ties; update = segment means, renormalized;
  an empty cluster keeps its centroid).
- **layout**: corpus rows regroup into (K, C_pad, d) cluster buckets padded
  to a common size, plus (K, C_pad) row ids and a validity mask; within a
  bucket rows keep their order.
- **search**: queries score the centroids, probe the top ``nprobe``
  clusters (ties to the lowest cluster), gather those buckets and score
  them in one batched product; the result is ordered by (-score, row).
  Memory read per query drops from the corpus to ``nprobe * C_pad`` rows.

The k-means init draws K distinct rows from a ``torch.Generator`` seeded
with ``seed``; ``fit(..., init=rows)`` takes the rows instead (JAX draws
them from ``jax.random.choice``, so a test can hand the port JAX's draw).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch.devices import resolve_device
from ragmeup_tpu_torch.ops.fusion import mmr_select
from ragmeup_tpu_torch.ops.topk import NEG_INF, merge_sorted, rank_topk


def _kmeans(vectors: torch.Tensor, init: torch.Tensor, iters: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means. vectors (n, d) f32 (normalized upstream), init (K,)
    row indices. Returns centroids (K, d) and assignments (n,)."""
    centroids = vectors[init]
    n_clusters = centroids.shape[0]
    for _ in range(iters):
        assign = torch.argmax(vectors @ centroids.T, dim=1)
        sums = torch.zeros_like(centroids).index_add_(0, assign, vectors)
        counts = torch.bincount(assign, minlength=n_clusters).to(vectors.dtype)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        # re-normalize so assignment stays an inner-product argmax
        new = new / torch.clamp_min(torch.linalg.norm(new, dim=1, keepdim=True), 1e-9)
        centroids = torch.where((counts == 0)[:, None], centroids, new)
    return centroids, torch.argmax(vectors @ centroids.T, dim=1)


def _bucket_layout(assign: torch.Tensor, n_clusters: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Slot of every row in its cluster's bucket, rows in increasing order:
    returns (order, slot, C_pad) where ``order`` lists the rows cluster by
    cluster and ``slot[j]`` is the position of row ``order[j]``."""
    n = assign.shape[0]
    order = torch.sort(assign, stable=True).indices
    counts = torch.bincount(assign, minlength=n_clusters)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=assign.device) - starts[assign[order]]
    return order, slot, max(8, int(counts.max()))


def probe_and_score(q: torch.Tensor, centroids: torch.Tensor,
                    buckets: torch.Tensor, row_ids: torch.Tensor,
                    valid: torch.Tensor, nprobe: int,
                    cmask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores (b, P * C) f32 of the probed buckets' slots (NEG_INF for empty
    ones) and their row ids. q is in the buckets' dtype; the centroid scores
    are too, the bucket scores accumulate in f32. ``cmask`` (K,) drops
    clusters that only pad a shard."""
    b = q.shape[0]
    cscores = q @ centroids.T                              # (b, K)
    if cmask is not None:
        cscores = torch.where(cmask[None, :], cscores,
                              torch.full_like(cscores, NEG_INF))
    probe = rank_topk(cscores, nprobe)[1]                  # (b, P)
    cand = buckets[probe]                                  # (b, P, C, d)
    s = torch.matmul(cand.reshape(b, -1, cand.shape[-1]).float(),
                     q.float()[:, :, None])[..., 0]        # (b, P * C)
    s = torch.where(valid[probe].reshape(b, -1), s, torch.full_like(s, NEG_INF))
    return s, row_ids[probe].reshape(b, -1)


def _ivf_search(q, centroids, buckets, row_ids, valid, k: int, nprobe: int):
    """q (b, d); buckets (K, C, d); row_ids/valid (K, C). Returns
    (scores (b, k), rows (b, k)) with -1 for empty slots."""
    s, rows = probe_and_score(q, centroids, buckets, row_ids, valid, nprobe)
    top_s, top_r = merge_sorted(s, rows, k)
    return top_s, torch.where(top_s > NEG_INF / 2, top_r, torch.full_like(top_r, -1))


class IVFIndex:
    """Cluster-pruned dense index (build-once over a vector set)."""

    def __init__(self, n_clusters: Optional[int] = None, iters: int = 10,
                 normalize: bool = True, seed: int = 0, device=None):
        self.n_clusters = n_clusters
        self.iters = iters
        self.normalize = normalize
        self.seed = seed
        self.device = resolve_device(device)
        self.n = 0
        self.centroids: Optional[torch.Tensor] = None
        self.buckets: Optional[torch.Tensor] = None
        self.row_ids: Optional[torch.Tensor] = None
        self.valid: Optional[torch.Tensor] = None

    def fit(self, vectors, dtype=torch.bfloat16,
            init: Optional[Sequence[int]] = None) -> None:
        """vectors: (n, d) numpy or tensor. ``init``: the K rows k-means
        starts from (default: drawn from ``seed``)."""
        v = torch.as_tensor(vectors).to(self.device, torch.float32)
        self.n, d = v.shape
        if self.normalize:
            v = v / torch.clamp_min(torch.linalg.norm(v, dim=1, keepdim=True), 1e-12)
        K = self.n_clusters or max(1, int(np.sqrt(self.n)))
        K = min(K, self.n)
        if init is None:
            gen = torch.Generator().manual_seed(self.seed)
            init = torch.randperm(self.n, generator=gen)[:K]
        init = torch.as_tensor(np.array(init, np.int64)).to(self.device)
        centroids, assign = _kmeans(v, init, self.iters)
        order, slot, c_pad = _bucket_layout(assign, K)
        cl = assign[order]
        buckets = torch.zeros((K, c_pad, d), dtype=dtype, device=self.device)
        buckets[cl, slot] = v[order].to(dtype)
        row_ids = torch.full((K, c_pad), -1, dtype=torch.int32, device=self.device)
        row_ids[cl, slot] = order.to(torch.int32)
        valid = torch.zeros((K, c_pad), dtype=torch.bool, device=self.device)
        valid[cl, slot] = True
        self.centroids = centroids.to(dtype)
        self.buckets, self.row_ids, self.valid = buckets, row_ids, valid

    def search(self, queries, k: int, nprobe: int = 8
               ) -> List[List[Tuple[int, float]]]:
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.n == 0:
            return [[] for _ in range(q.shape[0])]
        if self.normalize:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        nprobe = min(nprobe, self.centroids.shape[0])
        s, r = _ivf_search(torch.from_numpy(q).to(self.device, self.buckets.dtype),
                           self.centroids, self.buckets, self.row_ids, self.valid,
                           k=min(k, self.n), nprobe=nprobe)
        s, r = s.cpu().numpy(), r.cpu().numpy()
        return [[(int(ri), float(si)) for ri, si in zip(r[i], s[i]) if ri >= 0]
                for i in range(q.shape[0])]

    @property
    def memory_bytes(self) -> int:
        if self.buckets is None:
            return 0
        return (self.buckets.numel() * self.buckets.element_size()
                + self.centroids.numel() * self.centroids.element_size()
                + self.row_ids.numel() * 4 + self.valid.numel())


def live_rows(dense) -> np.ndarray:
    """Row ids of the index's live rows, ascending."""
    rows = np.arange(dense.n, dtype=np.int64)
    if dense.dead:
        rows = rows[~np.isin(rows, np.fromiter(dense.dead, np.int64))]
    return rows


def ivf_hits(rows: np.ndarray, hits, q: np.ndarray, dense, k: int,
             search_type: str, mmr_lambda: float) -> List[List[Tuple[int, float]]]:
    """Per-query (position, score) hits of an IVF search mapped to global
    rows, then MMR over the candidates when asked (their vectors gathered
    on the device)."""
    out: List[List[Tuple[int, float]]] = []
    for i, h in enumerate(hits):
        live = [(int(rows[p]), float(si)) for p, si in h]
        if search_type == "mmr" and live:
            cand = dense.gather_rows([row for row, _ in live])
            chosen = mmr_select(q[i], cand, k, mmr_lambda)
            live = [live[c] for c in chosen]
        out.append(live[:k])
    return out


class IVFDenseView:
    """Lazily refreshed IVF view over a mutable ``DenseIndex``.

    Wires IVF into the product (``retrieval.ann="ivf"``): the DenseIndex
    stays the system of record (CRUD, persistence, row ids); this view
    rebuilds its cluster layout from the index's vectors whenever the
    corpus changes (add/delete), and serves dense search with the same
    (row, score) contract as ``DenseIndex.search``, MMR over the top
    ``fetch_k`` included. Positions map back to global row ids through the
    live-row table, so hybrid fusion and the ChunkStore see the exact
    path's ids."""

    def __init__(self, dense, nprobe: int = 8, n_clusters: int = 0,
                 seed: int = 0):
        self.dense = dense
        self.nprobe = nprobe
        self.n_clusters = n_clusters or None
        self.seed = seed
        self._ivf: Optional[IVFIndex] = None
        self._rows = np.zeros(0, np.int64)
        self._stamp = None

    def _refresh(self) -> None:
        stamp = (self.dense.n, len(self.dense.dead))
        if self._ivf is not None and stamp == self._stamp:
            return
        self._rows = live_rows(self.dense)
        ivf = IVFIndex(n_clusters=self.n_clusters, normalize=self.dense.normalize,
                       seed=self.seed, device=self.dense.device)
        if self._rows.size:
            ivf.fit(self.dense.host_vectors()[self._rows].astype(np.float32))
        self._ivf = ivf
        self._stamp = stamp

    def search(self, queries, k: int, search_type: str = "similarity",
               fetch_k: int = 20, mmr_lambda: float = 0.5
               ) -> List[List[Tuple[int, float]]]:
        self._refresh()
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self._rows.size == 0:
            return [[] for _ in range(q.shape[0])]
        kk = fetch_k if search_type == "mmr" else k
        hits = self._ivf.search(q, min(kk, self._rows.size), nprobe=self.nprobe)
        if self.dense.normalize:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        return ivf_hits(self._rows, hits, q, self.dense, k, search_type, mmr_lambda)
