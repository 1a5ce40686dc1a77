"""Device-resident dense vector index.

Counterpart of ``ragmeup_tpu/retrieval/dense.py``. The corpus embedding
matrix lives on the device transposed, ``(d, capacity)``, padded to the
kernel tile, and is queried with the fused scoring + top-k kernel
(``ops/topk.py``). Cosine similarity comes from storing normalized rows.

- *insert* writes columns in place into pre-grown capacity; capacity doubles
  when exhausted (one copy, amortized O(1) per row).
- *delete* flips the additive mask to NEG_INF (a tombstone).
- *compact* rebuilds densely from the ChunkStore's row mapping.

With ``dtype="int8"`` the corpus is stored as int8 codes ``(d, capacity)``
with one f32 scale per column ``(1, capacity)`` (symmetric per-vector
quantization), scored by the int8 fused top-k; reads (``gather_rows``,
``host_vectors``) dequantize with the stored scales.

The on-disk artifact (``vectors.npy`` + ``dense_meta.json``, and for int8
the exact ``codes_int8.npy`` + ``scales.npy``) is the JAX package's format,
so an index saved by either package loads in the other and searches
identically.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch.ops.fusion import mmr_select
from ragmeup_tpu_torch.ops.topk import (NEG_INF, dense_topk, dense_topk_int8,
                                        quantize_int8)

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


class DenseIndex:
    """Dense cosine/IP index over a device-resident transposed corpus matrix."""

    def __init__(self, dim: int, dtype: str = "bfloat16", tile_n: int = 1024,
                 normalize: bool = True, device=None):
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
        self._scales: Optional[torch.Tensor] = None    # (1, cap) f32 (int8 only)
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
        scales = (torch.zeros((1, new_cap), dtype=torch.float32, device=self.device)
                  if self.dtype == "int8" else None)
        if self._corpus_t is not None:
            corpus[:, :self.capacity] = self._corpus_t
            mask[:, :self.capacity] = self._mask
            if scales is not None:
                scales[:, :self.capacity] = self._scales
        self._corpus_t, self._mask, self._scales = corpus, mask, scales
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
        rows = torch.from_numpy(v).to(self.device)
        if self.dtype == "int8":
            q, scale = quantize_int8(rows, axis=1)          # (m, d), (m, 1)
            self._corpus_t[:, start:start + m] = q.T
            self._scales[:, start:start + m] = scale.T
        else:
            self._corpus_t[:, start:start + m] = rows.T.to(self._corpus_t.dtype)
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
        columns; the stored values (int8: codes and scales) are kept exactly,
        since re-quantizing would perturb near-tie ranks."""
        keep = [i for i, m in enumerate(mapping) if m >= 0]
        old_ct, old_scales, n_old = self._corpus_t, self._scales, self.n
        self.__init__(self.dim, self.dtype, self.tile_n,
                      normalize=self.normalize, device=self.device)
        if not keep or old_ct is None:
            return
        self._grow(len(keep))
        idx = torch.tensor(keep, dtype=torch.long, device=self.device)
        self._corpus_t[:, :len(keep)] = old_ct[:, :n_old].index_select(1, idx)
        if old_scales is not None:
            self._scales[:, :len(keep)] = old_scales[:, :n_old].index_select(1, idx)
        self._mask[:, :len(keep)] = 0.0
        self.n = len(keep)

    # -- query --------------------------------------------------------------------

    def _columns(self, idx: torch.Tensor) -> torch.Tensor:
        """(d, m) f32 columns at ``idx``, int8 dequantized with their scales."""
        cols = self._corpus_t.index_select(1, idx).float()
        if self.dtype == "int8":
            cols = cols * self._scales[0].index_select(0, idx)[None, :]
        return cols

    def host_vectors(self) -> np.ndarray:
        """(n, d) f16 corpus fetched from the device buffer (save path)."""
        if self.n == 0 or self._corpus_t is None:
            return np.zeros((0, self.dim), np.float16)
        idx = torch.arange(self.n, device=self.device)
        return self._columns(idx).T.cpu().numpy().astype(np.float16)

    def gather_rows(self, rows: Sequence[int]) -> np.ndarray:
        """(m, d) f32 vectors for the given rows, gathered on the device
        (int8 rows dequantized: the values the hybrid MMR scores)."""
        idx = torch.tensor(list(rows), dtype=torch.long, device=self.device)
        return np.ascontiguousarray(self._columns(idx).T.cpu().numpy())

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
        qt = torch.from_numpy(q).to(self.device)
        if self.dtype == "int8":
            s, idx = dense_topk_int8(qt, self._corpus_t, self._scales, kk,
                                     mask=self._mask)
        else:
            s, idx = dense_topk(qt, self._corpus_t, kk, mask=self._mask)
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
        if self.dtype == "int8" and self.n:
            # the exact codes and scales: reloading must search identically
            # (vectors.npy holds the dequantized f16 for format compatibility)
            np.save(os.path.join(directory, "codes_int8.npy"),
                    self._corpus_t[:, :self.n].T.cpu().numpy())
            np.save(os.path.join(directory, "scales.npy"),
                    self._scales[0, :self.n].cpu().numpy())
        meta = {"dim": self.dim, "dtype": self.dtype, "tile_n": self.tile_n,
                "normalize": self.normalize, "n": self.n,
                "dead": sorted(self.dead)}
        with open(os.path.join(directory, "dense_meta.json"), "w") as f:
            json.dump(meta, f)

    def _install_int8(self, codes: np.ndarray, scales: np.ndarray) -> None:
        """Install exact (n, d) int8 codes and (n,) scales (artifact reload)."""
        m = codes.shape[0]
        if m == 0:
            return
        self._grow(m)
        self._corpus_t[:, :m] = torch.from_numpy(
            np.ascontiguousarray(codes.T, np.int8)).to(self.device)
        self._scales[0, :m] = torch.from_numpy(
            np.asarray(scales, np.float32)).to(self.device)
        self._mask[:, :m] = 0.0
        self.n = m

    @classmethod
    def load(cls, directory: str, device=None) -> "DenseIndex":
        with open(os.path.join(directory, "dense_meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["dim"], meta["dtype"], meta["tile_n"], normalize=False,
                  device=device)
        vecs = np.load(os.path.join(directory, "vectors.npy"))
        codes_path = os.path.join(directory, "codes_int8.npy")
        if meta["dtype"] == "int8" and os.path.exists(codes_path):
            idx._install_int8(np.load(codes_path),
                              np.load(os.path.join(directory, "scales.npy")))
        elif len(vecs):
            idx.add(vecs.astype(np.float32))
        idx.normalize = meta["normalize"]
        idx.delete_rows(meta.get("dead", []))
        return idx

    @classmethod
    def exists(cls, directory: str) -> bool:
        return os.path.exists(os.path.join(directory, "dense_meta.json"))
