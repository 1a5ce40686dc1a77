"""Device-resident dense vector index.

Counterpart of ``ragmeup_tpu/retrieval/dense.py``. The corpus embedding
matrix lives on the device transposed, ``(d, capacity)``, padded to the
kernel tile, and is queried with the fused scoring + top-k kernel
(``ops/topk.py``). Cosine similarity comes from storing normalized rows.

- *insert* writes columns in place into pre-grown capacity; capacity doubles
  when exhausted (one copy, amortized O(1) per row).
- *delete* flips the additive mask to NEG_INF (a tombstone).
- *compact* rebuilds densely from the ChunkStore's row mapping.

The on-disk artifact (``vectors.npy`` + ``dense_meta.json``) is the JAX
package's format, so an index saved by either package loads in the other.
int8 storage is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch.ops.fusion import mmr_select
from ragmeup_tpu_torch.ops.topk import NEG_INF, dense_topk

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DenseIndex:
    """Dense cosine/IP index over a device-resident transposed corpus matrix."""

    def __init__(self, dim: int, dtype: str = "bfloat16", tile_n: int = 1024,
                 normalize: bool = True, device=None):
        if dtype == "int8":
            raise NotImplementedError(
                "int8 dense storage is not ported yet (ROADMAP queue 1)")
        if dtype not in _STORE_DTYPES:
            raise ValueError(f"unsupported dense dtype: {dtype}")
        self.dim = dim
        self.dtype = dtype
        self.tile_n = tile_n
        self.normalize = normalize
        self.device = torch.device(device or "cpu")
        self.n = 0  # rows ever added (device columns in use)
        self.capacity = 0
        self.dead: set = set()
        self._corpus_t: Optional[torch.Tensor] = None  # (d, cap)
        self._mask: Optional[torch.Tensor] = None      # (1, cap) f32 additive

    # -- capacity ---------------------------------------------------------------

    def _grow(self, need: int) -> None:
        new_cap = max(self.tile_n, self.capacity)
        while new_cap < need:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        corpus = torch.zeros((self.dim, new_cap), dtype=_STORE_DTYPES[self.dtype],
                             device=self.device)
        mask = torch.full((1, new_cap), NEG_INF, dtype=torch.float32,
                          device=self.device)
        if self._corpus_t is not None:
            corpus[:, :self.capacity] = self._corpus_t
            mask[:, :self.capacity] = self._mask
        self._corpus_t, self._mask = corpus, mask
        self.capacity = new_cap

    # -- mutation ----------------------------------------------------------------

    def add(self, vectors: np.ndarray) -> List[int]:
        """Append (m, dim) vectors; returns their row ids."""
        v = np.asarray(vectors, np.float32)
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"expected (m, {self.dim}) vectors, got {v.shape}")
        m = v.shape[0]
        if m == 0:
            return []
        if self.normalize:
            v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        self._grow(self.n + m)
        start = self.n
        cols = torch.from_numpy(np.ascontiguousarray(v.T)).to(self.device)
        self._corpus_t[:, start:start + m] = cols.to(self._corpus_t.dtype)
        self._mask[:, start:start + m] = 0.0
        self.n += m
        return list(range(start, start + m))

    def delete_rows(self, rows: Sequence[int]) -> None:
        rows = [int(r) for r in rows if 0 <= int(r) < self.n]
        if not rows:
            return
        self.dead.update(rows)
        self._mask[0, torch.tensor(rows, device=self.device)] = NEG_INF

    def compact(self, mapping: Sequence[int]) -> None:
        """Rebuild densely given old→new row mapping (-1 = dropped), as
        produced by ChunkStore.compact(). One device gather of the kept
        columns; the stored values are kept exactly."""
        keep = [i for i, m in enumerate(mapping) if m >= 0]
        old_ct, n_old = self._corpus_t, self.n
        self.__init__(self.dim, self.dtype, self.tile_n,
                      normalize=self.normalize, device=self.device)
        if not keep or old_ct is None:
            return
        self._grow(len(keep))
        idx = torch.tensor(keep, dtype=torch.long, device=self.device)
        self._corpus_t[:, :len(keep)] = old_ct[:, :n_old].index_select(1, idx)
        self._mask[:, :len(keep)] = 0.0
        self.n = len(keep)

    # -- query --------------------------------------------------------------------

    def host_vectors(self) -> np.ndarray:
        """(n, d) f16 corpus fetched from the device buffer (save path)."""
        if self.n == 0 or self._corpus_t is None:
            return np.zeros((0, self.dim), np.float16)
        ct = self._corpus_t[:, :self.n].float().cpu().numpy()
        return ct.T.astype(np.float16)

    def gather_rows(self, rows: Sequence[int]) -> np.ndarray:
        """(m, d) f32 vectors for the given rows, gathered on the device."""
        idx = torch.tensor(list(rows), dtype=torch.long, device=self.device)
        return np.ascontiguousarray(
            self._corpus_t.index_select(1, idx).float().T.cpu().numpy())

    def search(self, queries: np.ndarray, k: int, search_type: str = "similarity",
               fetch_k: int = 20, mmr_lambda: float = 0.5
               ) -> List[List[Tuple[int, float]]]:
        """Top-k search. Returns per-query lists of (row, score), score desc.

        search_type: 'similarity' → fused top-k; 'mmr' → fused top-fetch_k
        then maximal marginal relevance down to k."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.n == 0:
            return [[] for _ in range(q.shape[0])]
        if self.normalize:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        kk = min(fetch_k if search_type == "mmr" else k, self.n)
        s, idx = dense_topk(torch.from_numpy(q).to(self.device), self._corpus_t,
                            kk, mask=self._mask)
        s, idx = s.cpu().numpy(), idx.cpu().numpy()
        results: List[List[Tuple[int, float]]] = []
        for r in range(q.shape[0]):
            live = [(int(i), float(v)) for i, v in zip(idx[r], s[r])
                    if v > NEG_INF / 2 and i >= 0]
            if search_type == "mmr" and live:
                cand_vecs = self.gather_rows([i for i, _ in live])
                chosen = mmr_select(q[r], cand_vecs, k, mmr_lambda)
                live = [live[c] for c in chosen]
            results.append(live[:k])
        return results

    # -- persistence -----------------------------------------------------------------

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "vectors.npy"), self.host_vectors())
        meta = {"dim": self.dim, "dtype": self.dtype, "tile_n": self.tile_n,
                "normalize": self.normalize, "n": self.n,
                "dead": sorted(self.dead)}
        with open(os.path.join(directory, "dense_meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str, device=None) -> "DenseIndex":
        with open(os.path.join(directory, "dense_meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["dim"], meta["dtype"], meta["tile_n"], normalize=False,
                  device=device)
        vecs = np.load(os.path.join(directory, "vectors.npy"))
        if len(vecs):
            idx.add(vecs.astype(np.float32))
        idx.normalize = meta["normalize"]
        idx.delete_rows(meta.get("dead", []))
        return idx

    @classmethod
    def exists(cls, directory: str) -> bool:
        return os.path.exists(os.path.join(directory, "dense_meta.json"))
