"""IVF cluster pruning over a corpus-sharded mesh.

Counterpart of ``ragmeup_tpu/parallel/sharded_ivf.py``. The cluster layout
shards instead of the columns:

- **layout**: the (K, C_pad, d) buckets, row ids, validity mask and
  centroids split their cluster axis over 'corpus' (each device owns K/D
  whole clusters, padded with empty ones up to a multiple of D), so bucket
  gathers stay on their device.
- **search**: each shard probes its own top ``nprobe`` clusters (the probed
  union is a superset of the global top ``nprobe``, so recall at equal
  nprobe is at least the single-device view's), scores the gathered
  buckets and takes a local top-k; the (score, row) pairs merge on the
  first device by (-score, row), as the exact sharded path does.

The view keeps ``IVFDenseView``'s lazy-refresh contract over the mutable
``ShardedDenseIndex`` (the system of record for CRUD, persistence and row
ids).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch.ops.topk import NEG_INF, merge_sorted
from ragmeup_tpu_torch.parallel.mesh import Mesh
from ragmeup_tpu_torch.retrieval.ivf import IVFIndex, ivf_hits, live_rows, probe_and_score


def _sharded_ivf_search(mesh: Mesh, q: torch.Tensor, centroids, cmask, buckets,
                        row_ids, valid, k: int, nprobe: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (b, d) in the buckets' dtype; per shard: centroids (Kl, d), cmask
    (Kl,) bool, buckets (Kl, C, d), row_ids / valid (Kl, C). Returns
    (scores (b, k), rows (b, k)), -1 rows for empty slots."""
    devs = mesh.axis_devices("corpus")
    outs_s, outs_r = [], []
    for j, dev in enumerate(devs):
        s, rows = probe_and_score(q.to(dev), centroids[j], buckets[j], row_ids[j],
                                  valid[j], min(nprobe, centroids[j].shape[0]),
                                  cmask=cmask[j])
        kk = min(k, s.shape[1])
        ls, lr = merge_sorted(s, rows, kk)
        if kk < k:
            ls = torch.nn.functional.pad(ls, (0, k - kk), value=NEG_INF)
            lr = torch.nn.functional.pad(lr, (0, k - kk), value=-1)
        outs_s.append(ls.to(devs[0]))
        outs_r.append(lr.to(devs[0]))
    return merge_sorted(torch.cat(outs_s, 1), torch.cat(outs_r, 1), k)


class ShardedIVFView:
    """Lazily refreshed sharded IVF view over a ``ShardedDenseIndex``.

    Same (row, score) search contract as ``IVFDenseView`` (MMR over the top
    ``fetch_k`` included), so ``HybridRetriever`` wires either view behind
    the one ``ann="ivf"`` knob."""

    def __init__(self, dense, mesh: Mesh, nprobe: int = 8, n_clusters: int = 0,
                 seed: int = 0):
        self.dense = dense
        self.mesh = mesh
        self.nprobe = nprobe
        self.n_clusters = n_clusters or None
        self.seed = seed
        self._rows = np.zeros(0, np.int64)
        self._stamp = None
        self._centroids: Optional[List[torch.Tensor]] = None
        self._cmask = self._buckets = self._row_ids = self._valid = None

    def _dtype(self) -> torch.dtype:
        return torch.float32 if self.dense.dtype == "float32" else torch.bfloat16

    def _refresh(self) -> None:
        stamp = (self.dense.n, len(self.dense.dead))
        if self._centroids is not None and stamp == self._stamp:
            return
        self._rows = live_rows(self.dense)
        self._stamp = stamp
        if not self._rows.size:
            self._centroids = None
            return
        devs = self.mesh.axis_devices("corpus")
        ivf = IVFIndex(n_clusters=self.n_clusters, normalize=self.dense.normalize,
                       seed=self.seed, device=devs[0])
        # fitted in bf16 and then held in the view's dtype, as in the JAX view
        ivf.fit(self.dense.host_vectors()[self._rows].astype(np.float32))
        dt = self._dtype()
        K = ivf.centroids.shape[0]
        D = len(devs)
        kl = -(-K // D)
        pad = kl * D - K

        def split(t: torch.Tensor, fill) -> List[torch.Tensor]:
            if pad:
                t = torch.cat([t, torch.full((pad, *t.shape[1:]), fill, dtype=t.dtype,
                                             device=t.device)])
            return [t[j * kl:(j + 1) * kl].to(dev, copy=True) for j, dev in enumerate(devs)]

        self._centroids = split(ivf.centroids.to(dt), 0)
        self._cmask = split(torch.ones(K, dtype=torch.bool, device=devs[0]), False)
        self._buckets = split(ivf.buckets.to(dt), 0)
        self._row_ids = split(ivf.row_ids, -1)
        self._valid = split(ivf.valid, False)

    def search(self, queries, k: int, search_type: str = "similarity",
               fetch_k: int = 20, mmr_lambda: float = 0.5
               ) -> List[List[Tuple[int, float]]]:
        self._refresh()
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self._rows.size == 0 or self._centroids is None:
            return [[] for _ in range(q.shape[0])]
        if self.dense.normalize:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        kk = min(fetch_k if search_type == "mmr" else k, self._rows.size)
        s, r = _sharded_ivf_search(
            self.mesh, torch.from_numpy(q).to(self.dense.device, self._dtype()),
            self._centroids, self._cmask, self._buckets, self._row_ids, self._valid,
            k=kk, nprobe=self.nprobe)
        s, r = s.cpu().numpy(), r.cpu().numpy()
        hits = [[(p, sv) for p, sv in zip(r[i], s[i]) if p >= 0 and sv > NEG_INF / 2]
                for i in range(q.shape[0])]
        return ivf_hits(self._rows, hits, q, self.dense, k, search_type, mmr_lambda)
