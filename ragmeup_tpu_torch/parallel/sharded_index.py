"""Corpus-sharded dense and BM25 retrieval over the mesh's 'corpus' axis.

Counterpart of ``ragmeup_tpu/parallel/sharded_index.py``. Corpus columns
partition over the ``corpus`` axis: shard j holds global columns
``[j * shard_n, (j + 1) * shard_n)`` as a tensor of its own on the axis's
j-th device (never a view into another shard, also where devices repeat).
Each shard scores its columns and selects a local top-k with global ids;
the (b, k) pairs of every shard are copied to the mesh's first device (the
JAX program's one ``all_gather``) and merged by (-score, id), so the result
equals the single-device top-k, ties to the lowest global id.

Each shard's dense top-k is the port's fused kernel: #1 (``dense_topk``)
for a float corpus, #2 (``dense_topk_int8``) for an int8 one, one launch a
shard on a card, the plain version on the CPU. The int8 query is quantized
inside #2 per row (the same codes and scales on every shard) and scored
``(acc * q_scale) * c_scale + mask``, the single-device order, so
rounding-made ties break as there. A float query is cast to the corpus
dtype as #1 does: on a bf16 corpus the sharded ids equal the port's
single-device ones (the JAX sharded program scores the f32 query instead).

Shard widths are multiples of the kernel's 1024-column chunk, so an index
built with a smaller ``tile_n`` has more padding columns than the JAX one;
they carry the NEG_INF mask and never surface.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch.ops.fusion import (mmr_select, mmr_select_device, rrf_fuse,
                                          rrf_fuse_device)
from ragmeup_tpu_torch.ops.topk import (_CHUNK, NEG_INF, dense_topk, dense_topk_int8,
                                        merge_sorted, quantize_int8)
from ragmeup_tpu_torch.parallel.mesh import Mesh
from ragmeup_tpu_torch.retrieval.sparse import _bm25_score_topk

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def split_columns(devices: Sequence[torch.device], t: torch.Tensor, fill: float,
                  width: Optional[int] = None) -> List[torch.Tensor]:
    """Per-shard copies of t's columns (last axis split evenly over
    ``devices``), each padded with ``fill`` to ``width`` columns."""
    sn = t.shape[-1] // len(devices)
    width = width or sn
    out = []
    for j, dev in enumerate(devices):
        buf = torch.full((*t.shape[:-1], width), fill, dtype=t.dtype, device=dev)
        buf[..., :sn] = t[..., j * sn:(j + 1) * sn].to(dev)
        out.append(buf)
    return out


def _shard(x, j: int, sn: int, dev: torch.device) -> torch.Tensor:
    """Shard j of a per-shard list, or columns [j * sn, (j + 1) * sn) of a
    whole (replicated) tensor."""
    if isinstance(x, (list, tuple)):
        return x[j]
    return x[..., j * sn:(j + 1) * sn].to(dev)


def sharded_topk(mesh: Mesh, queries, corpus_t, k: int, mask=None, scales=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k over a corpus sharded on the 'corpus' mesh axis.

    queries: (b, d) float (for an int8 corpus too: #2 quantizes them);
    corpus_t: (d, N) with N divisible by the corpus axis, or a list of the
    shards' (d, N / S) tensors; mask: (1, N) additive, or per shard;
    scales: (1, N) per-column multipliers of an int8 corpus, or per shard.
    Returns (b, k) scores and global ids on the mesh's first device, equal
    to the single-device result; unfilled slots are (NEG_INF, -1)."""
    devs = mesh.axis_devices("corpus")
    n_shards = len(devs)
    if isinstance(corpus_t, torch.Tensor):
        d, n = corpus_t.shape
        if n % n_shards != 0:
            raise ValueError(f"corpus cols {n} not divisible by corpus axis {n_shards}")
        sn = n // n_shards
        width = _round_up(sn, _CHUNK)  # the kernel scores whole 1024-column chunks
        if mask is None:
            mask = torch.zeros((1, n), dtype=torch.float32, device=corpus_t.device)
        corpus_t = split_columns(devs, corpus_t, 0, width)
        mask = split_columns(devs, mask.float(), NEG_INF, width)
        if scales is not None:
            scales = split_columns(devs, scales.float(), 1.0, width)
    else:
        if len(corpus_t) != n_shards:
            raise ValueError(f"{len(corpus_t)} shards for corpus axis {n_shards}")
        sn = corpus_t[0].shape[1]
    quantized = corpus_t[0].dtype == torch.int8
    if quantized and scales is None:
        raise ValueError("an int8 corpus needs its per-column scales")
    q = torch.as_tensor(queries).float()
    kl = min(k, sn)
    outs_s, outs_i = [], []
    for j, dev in enumerate(devs):
        m = mask[j] if mask is not None else None
        if quantized:
            s, i = dense_topk_int8(q.to(dev), corpus_t[j], scales[j], kl, mask=m)
        else:
            s, i = dense_topk(q.to(dev), corpus_t[j], kl, mask=m)
        outs_s.append(s.to(devs[0]))
        outs_i.append(torch.where(i >= 0, i + j * sn, i).to(devs[0]))
    return merge_sorted(torch.cat(outs_s, 1), torch.cat(outs_i, 1), k)


class ShardedDenseIndex:
    """Multi-device dense index: corpus columns live sharded over the mesh's
    'corpus' axis; queries go to every shard; the shards' top-k merge on
    the first device.

    Drop-in for ``DenseIndex`` at the ``RagSystem`` level (same add /
    delete_rows / compact / search / save / load surface and the JAX
    package's artifact format), so ``parallel.corpus_axis > 1`` turns an
    existing index multi-device with identical top-k. Adds write the new
    columns in place into each shard's spare capacity."""

    def __init__(self, mesh: Mesh, dim: int, tile_n: int = 1024,
                 normalize: bool = True, dtype: str = "bfloat16"):
        if dtype not in _STORE_DTYPES:
            raise ValueError(f"sharded dense dtype must be "
                             f"float32/bfloat16/int8, got {dtype}")
        self.mesh = mesh
        self.devices = mesh.axis_devices("corpus")
        self.device = self.devices[0]  # where results merge
        self.dim = dim
        self.tile_n = tile_n
        self.normalize = normalize
        self.dtype = dtype
        self.n = 0
        self.capacity = 0
        self.dead: set = set()
        self._corpus_t: Optional[List[torch.Tensor]] = None  # per shard (d, cap / S)
        self._mask: Optional[List[torch.Tensor]] = None      # per shard (1, cap / S)
        self._scales: Optional[List[torch.Tensor]] = None    # per shard, int8 only

    @property
    def _shards(self) -> int:
        return len(self.devices)

    @property
    def shard_n(self) -> int:
        return self.capacity // self._shards

    def _unit(self) -> int:
        """Capacity growth unit: every shard a whole number of the top-k
        kernel's 1024-column chunks."""
        return _round_up(self.tile_n, _CHUNK) * self._shards

    def _grow(self, need: int) -> None:
        if need <= self.capacity:
            return
        new_cap = max(self._unit(), self.capacity)
        while new_cap < need:
            new_cap *= 2
        sn = new_cap // self._shards
        corpus = [torch.zeros((self.dim, sn), dtype=_STORE_DTYPES[self.dtype], device=dev)
                  for dev in self.devices]
        mask = [torch.full((1, sn), NEG_INF, dtype=torch.float32, device=dev)
                for dev in self.devices]
        scales = ([torch.ones((1, sn), dtype=torch.float32, device=dev)
                   for dev in self.devices] if self.dtype == "int8" else None)
        if self._corpus_t is not None:
            # the capacity doubles, so each old shard lands whole in one new one
            old_sn = self.shard_n
            for i in range(self._shards):
                j, off = divmod(i * old_sn, sn)
                corpus[j][:, off:off + old_sn] = self._corpus_t[i].to(self.devices[j])
                mask[j][:, off:off + old_sn] = self._mask[i].to(self.devices[j])
                if scales is not None:
                    scales[j][:, off:off + old_sn] = self._scales[i].to(self.devices[j])
        self._corpus_t, self._mask, self._scales = corpus, mask, scales
        self.capacity = new_cap

    def _write(self, bufs: List[torch.Tensor], start: int, vals: torch.Tensor) -> None:
        """vals (r, m) into global columns [start, start + m) of per-shard
        (r, shard_n) buffers."""
        sn, m = self.shard_n, vals.shape[1]
        for j in range(start // sn, (start + m - 1) // sn + 1):
            lo, hi = max(start, j * sn), min(start + m, (j + 1) * sn)
            bufs[j][:, lo - j * sn:hi - j * sn] = vals[:, lo - start:hi - start].to(
                bufs[j].device)

    def _take(self, bufs: List[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
        """Columns ``idx`` (1-D, global) of per-shard buffers, on the first
        device: each shard gathers every index (clamped into its range) and
        keeps its own, so the device never waits on the host."""
        idx = idx.to(self.device)
        sn = self.shard_n
        shard, local = idx // sn, idx % sn
        out = None
        for j, buf in enumerate(bufs):
            cols = buf.index_select(1, local.to(buf.device)).to(self.device)
            out = cols if out is None else torch.where((shard == j)[None, :], cols, out)
        return out

    def columns(self, idx: torch.Tensor) -> torch.Tensor:
        """(..., d) f32 vectors of the global rows ``idx``, int8 dequantized
        with their scales (the values MMR scores)."""
        flat = idx.reshape(-1).long()
        cols = self._take(self._corpus_t, flat).float()
        if self.dtype == "int8":
            cols = cols * self._take(self._scales, flat)
        return cols.T.reshape(*idx.shape, self.dim)

    # -- mutation ----------------------------------------------------------------

    def add(self, vectors: np.ndarray) -> List[int]:
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
            # the single-device index's quantizer: exactness between modes
            q8, scale = quantize_int8(rows, axis=1)          # (m, d), (m, 1)
            self._write(self._corpus_t, start, q8.T)
            self._write(self._scales, start, scale.T)
        else:
            self._write(self._corpus_t, start, rows.T.to(_STORE_DTYPES[self.dtype]))
        self._write(self._mask, start, torch.zeros((1, m), device=self.device))
        self.n += m
        return list(range(start, start + m))

    def delete_rows(self, rows) -> None:
        rows = [int(r) for r in rows if 0 <= int(r) < self.n]
        if not rows:
            return
        self.dead.update(rows)
        rows = np.asarray(rows, np.int64)
        shard, local = np.divmod(rows, self.shard_n)
        for j in np.unique(shard):
            m = self._mask[j]
            m[0, torch.from_numpy(local[shard == j]).to(m.device)] = NEG_INF

    def host_vectors(self) -> np.ndarray:
        """(n, d) f16 corpus fetched from the shards (int8 dequantized):
        the save and IVF-build path."""
        if self.n == 0 or self._corpus_t is None:
            return np.zeros((0, self.dim), np.float16)
        sn, parts = self.shard_n, []
        for j in range(-(-self.n // sn)):
            w = min(sn, self.n - j * sn)
            cols = self._corpus_t[j][:, :w].float()
            if self.dtype == "int8":
                cols = cols * self._scales[j][:, :w]
            parts.append(cols.T.cpu().numpy())
        return np.concatenate(parts).astype(np.float16)

    def gather_rows(self, rows) -> np.ndarray:
        """(m, d) f32 vectors for the given rows, gathered from their shards
        (the MMR working set)."""
        idx = torch.tensor(np.asarray(rows, np.int64), device=self.device)
        return np.ascontiguousarray(self.columns(idx).cpu().numpy())

    def _stored(self, keep: Sequence[int]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The stored columns (d, m) and int8 scales (1, m) of rows ``keep``."""
        idx = torch.tensor(list(keep), dtype=torch.long, device=self.device)
        scales = self._take(self._scales, idx) if self.dtype == "int8" else None
        return self._take(self._corpus_t, idx), scales

    def compact(self, mapping) -> None:
        """Rebuild densely given the old → new row mapping (-1 = dropped):
        the kept columns move with their stored values (int8: codes and
        scales) exactly, since re-quantizing would perturb near-tie ranks."""
        keep = [i for i, mp in enumerate(mapping) if mp >= 0]
        vals = scales = None
        if self._corpus_t is not None and keep:
            vals, scales = self._stored(keep)
        self.__init__(self.mesh, self.dim, self.tile_n, normalize=self.normalize,
                      dtype=self.dtype)
        if vals is not None:
            self._install(vals, scales)

    def _install(self, vals: torch.Tensor, scales: Optional[torch.Tensor]) -> None:
        """Stored columns (d, m) (and int8 scales (1, m)) as rows 0..m-1."""
        m = vals.shape[1]
        if m == 0:
            return
        self._grow(m)
        self._write(self._corpus_t, 0, vals)
        if scales is not None:
            self._write(self._scales, 0, scales)
        self._write(self._mask, 0, torch.zeros((1, m), device=self.device))
        self.n = m

    def _install_int8(self, codes: np.ndarray, scales: np.ndarray) -> None:
        """Install exact (n, d) int8 codes and (n,) scales (artifact reload)."""
        self._install(torch.from_numpy(np.ascontiguousarray(codes.T, np.int8)),
                      torch.from_numpy(np.asarray(scales, np.float32)[None, :]))

    # -- query --------------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int, search_type: str = "similarity",
               fetch_k: int = 20, mmr_lambda: float = 0.5
               ) -> List[List[Tuple[int, float]]]:
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.n == 0:
            return [[] for _ in range(q.shape[0])]
        if self.normalize:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        kk = min(fetch_k if search_type == "mmr" else k, self.n)
        s, i = sharded_topk(self.mesh, torch.from_numpy(q).to(self.device), self._corpus_t,
                            kk, mask=self._mask, scales=self._scales)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        results: List[List[Tuple[int, float]]] = []
        for r in range(q.shape[0]):
            live = [(int(ix), float(sv)) for ix, sv in zip(i[r], s[r])
                    if sv > NEG_INF / 2]
            if search_type == "mmr" and live:
                chosen = mmr_select(q[r], self.gather_rows([ix for ix, _ in live]),
                                    k, mmr_lambda)
                live = [live[c] for c in chosen]
            results.append(live[:k])
        return results

    # -- persistence: DenseIndex's artifact; it stores vectors, not placement -----

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "vectors.npy"), self.host_vectors())
        if self.dtype == "int8" and self.n:
            # the exact codes and scales: a reload must search identically
            codes, scales = self._stored(range(self.n))
            np.save(os.path.join(directory, "codes_int8.npy"), codes.T.cpu().numpy())
            np.save(os.path.join(directory, "scales.npy"), scales[0].cpu().numpy())
        meta = {"dim": self.dim, "dtype": self.dtype, "tile_n": self.tile_n,
                "n": self.n, "dead": sorted(self.dead), "sharded": True,
                "normalize": self.normalize}
        with open(os.path.join(directory, "dense_meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str, mesh: Mesh) -> "ShardedDenseIndex":
        with open(os.path.join(directory, "dense_meta.json")) as f:
            meta = json.load(f)
        vecs = np.load(os.path.join(directory, "vectors.npy"))
        idx = cls(mesh, meta["dim"], tile_n=meta.get("tile_n", 1024),
                  normalize=False, dtype=meta["dtype"])
        codes_path = os.path.join(directory, "codes_int8.npy")
        if meta["dtype"] == "int8" and os.path.exists(codes_path):
            idx._install_int8(np.load(codes_path),
                              np.load(os.path.join(directory, "scales.npy")))
        elif len(vecs):
            idx.add(vecs.astype(np.float32))
        idx.normalize = bool(meta.get("normalize", True))
        idx.delete_rows(meta.get("dead", []))
        return idx

    @classmethod
    def exists(cls, directory: str) -> bool:
        return os.path.exists(os.path.join(directory, "dense_meta.json"))


# ---------------------------------------------------------------------------
# Corpus-sharded BM25 scoring (the sparse engine's multi-device path)
# ---------------------------------------------------------------------------

def sharded_bm25_topk(mesh: Mesh, qsel, head, docs_cat, con_cat, qid_cat, mask,
                      k: int, nq: int, cap: int, has_head: bool = True,
                      has_tail: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """BM25 top-k with the head matrix (H, cap) and the mask (cap,) split
    over the 'corpus' axis (per-shard lists from ``make_shard_placer``, or
    whole tensors). Inputs are ``_bm25_score_topk``'s; the tail stream
    stays on the host. Each shard scores its column range (head product +
    the tail postings inside it, added in stream order as on one device),
    takes a local top-k with global ids, and the pairs merge by
    (-score, id) on the first device."""
    devs = mesh.axis_devices("corpus")
    n_shards = len(devs)
    if cap % n_shards != 0:
        raise ValueError(f"cap {cap} not divisible by corpus axis {n_shards}")
    shard_cap = cap // n_shards
    docs_cat = np.asarray(docs_cat)
    qsel = torch.as_tensor(qsel)
    outs_s, outs_i = [], []
    for j, dev in enumerate(devs):
        lo = j * shard_cap
        local = docs_cat - lo
        local = np.where((local >= 0) & (local < shard_cap), local, shard_cap)
        s, i = _bm25_score_topk(
            qsel.to(dev), _shard(head, j, shard_cap, dev), local.astype(np.int32),
            con_cat, qid_cat, _shard(mask, j, shard_cap, dev), k=min(k, shard_cap),
            nq=nq, cap=shard_cap, has_head=has_head, has_tail=has_tail)
        outs_s.append(s.to(devs[0]))
        outs_i.append((i + lo).to(devs[0]))
    return merge_sorted(torch.cat(outs_s, 1), torch.cat(outs_i, 1), k)


# ---------------------------------------------------------------------------
# Sharded hybrid search (dense + BM25 + MMR + RRF over the mesh)
# ---------------------------------------------------------------------------

def _sharded_hybrid(mesh: Mesh, qv: torch.Tensor, dense: ShardedDenseIndex,
                    inputs: dict, k: int, nq: int, w_sparse: float, w_dense: float,
                    rrf_c: int, mmr: bool, fetch_k: int, mmr_lambda: float):
    """The multi-device twin of retrieval.hybrid._hybrid_fused: per-shard
    dense top-k (#1 / #2) and per-shard BM25, each merged exactly on the
    first device, then MMR over the merged candidates (their vectors
    gathered from their shards; the f32 query against dequantized int8
    candidates, as on one device) and RRF. Returns (scores, ids) (nq, k)."""
    kd = fetch_k if mmr else k
    ds, di = sharded_topk(mesh, qv, dense._corpus_t, kd, mask=dense._mask,
                          scales=dense._scales)
    valid = ds > NEG_INF / 2
    di = torch.where(valid, di, torch.full_like(di, -1))
    if mmr:
        cand = dense.columns(torch.clamp_min(di, 0))        # (nq, kd, d)
        order = torch.stack([
            mmr_select_device(qv[i], cand[i], valid[i], k, mmr_lambda)
            for i in range(nq)])                            # (nq, k)
        sel = torch.gather(di, 1, torch.clamp_min(order, 0).long())
        di = torch.where(order >= 0, sel, torch.full_like(sel, -1))
    dev = inputs["dev"]
    ss, si = sharded_bm25_topk(
        mesh, torch.from_numpy(inputs["qsel"]), dev["head"], inputs["docs_cat"],
        inputs["con_cat"], inputs["qid_cat"], dev["mask"], k=k, nq=nq,
        cap=inputs["cap"], has_head=inputs["has_head"], has_tail=inputs["has_tail"])
    si = torch.where(ss > 0, si, torch.full_like(si, -1))
    return rrf_fuse_device(si, di, w_sparse, w_dense, rrf_c, k)


def sharded_hybrid_search(mesh: Mesh, dense: ShardedDenseIndex, sparse, queries,
                          qvecs, k, weights=(0.5, 0.5), rrf_c: int = 60,
                          re2_prompt=None, search_type: str = "similarity",
                          fetch_k: int = 20, mmr_lambda: float = 0.5):
    """Multi-device hybrid_fused_search: same contract, corpus sharded over
    the mesh's 'corpus' axis, equal to the single-device result (ties to the
    lowest row id end to end)."""
    nq = len(queries)
    if dense.n == 0 and sparse.n == 0:
        return [[] for _ in range(nq)]
    if dense.n == 0 or sparse.live_count == 0:
        s_hits = sparse.search(queries, k, re2_prompt=re2_prompt) \
            if sparse.live_count else [[] for _ in range(nq)]
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
    fs, fi = _sharded_hybrid(
        mesh, torch.from_numpy(q).to(dense.device), dense, inputs, k=kk, nq=nq,
        w_sparse=weights[0], w_dense=weights[1], rrf_c=rrf_c,
        mmr=search_type == "mmr", fetch_k=min(fetch_k, dense.n),
        mmr_lambda=mmr_lambda)
    fs, fi = fs.cpu().numpy(), fi.cpu().numpy()
    return [[(int(r), float(s)) for r, s in zip(fi[i], fs[i]) if r >= 0]
            for i in range(nq)]


def make_shard_placer(mesh: Mesh):
    """BM25Index.shard_placer for this mesh: splits the head matrix and the
    mask over the 'corpus' axis (a copy a shard) when divisible, else keeps
    the whole array on the mesh's first device. ``place.mesh`` is the mesh
    the sharded BM25 scoring runs on."""
    devs = mesh.axis_devices("corpus")

    def place(name: str, arr: np.ndarray):
        t = torch.from_numpy(arr)
        if t.shape[-1] % len(devs):
            return t.to(devs[0])
        return split_columns(devs, t, 0.0)

    place.mesh = mesh
    return place
