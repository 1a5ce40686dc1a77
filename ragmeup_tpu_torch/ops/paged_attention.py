"""Paged attention over a paged KV cache: the page pool, its writes, and the
decode / chunk-append attention (CUDA kernel and plain versions).

Counterpart of ``ragmeup_tpu/ops/paged_attention.py``:

- ``PagedKVCache``: the page pool (one K and one V tensor per layer) and
  its host bookkeeping, exactly as the JAX package keeps it: free-list
  order, per-sequence page lists, the sha1 chain-digest prefix registry
  with content verification, refcounts and LRU eviction of unreferenced
  registered pages.
- ``paged_update_token`` / ``paged_update_chunk``: K/V writes into the
  pool, in place (torch index writes; the JAX package's are XLA scatters
  outside Pallas).
- ``paged_attention`` (decode: q ``(b, nh, hd)``) and
  ``paged_attention_chunk`` (chunk-append: q ``(b, s, nh, hd)``): CUDA
  tensors launch csrc/paged_attention.cu (kernel #9), CPU tensors take
  ``paged_attention_plain`` / ``paged_attention_chunk_plain``. On bf16
  pools the kernel cuts the keys into splits (``paged_split_plan``, from
  the shapes and the SM count: ``lengths`` never leave the device) and
  merges each row's splits in split order.

Layout: the pool is ``(nkv, P, ps, hd)`` with one token per row at the
model's own head dim; the kernel is built for hd 64, 96, 128 and 256. The
JAX package packs 128/hd tokens into one row or pads hd up to 128
(``pages_tok_per_row``, ``store_hd``) to meet the TPU's 128-lane tiling;
that rule does not exist on the GPU, so here ``tok_per_row`` is always 1
and chunked prefill (which needs one token per row) is always available.
Compare pools with the JAX package's through its ``_unpack_pages`` view.

Mask rule (both modes): with ``q_len`` query positions per sequence and
``lengths`` counting the tokens including them, query position i attends
key positions ``< lengths - q_len + i + 1``, and with ``window > 0`` only
those ``>= that limit - window``. ``softcap > 0`` maps the scaled scores to
``softcap * tanh(s / softcap)`` before the mask. A row that sees no key
outputs 0, as the TPU kernel does.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.devices import resolve_device

KERNEL_HEAD_DIMS = (64, 96, 128, 256)  # the head dims csrc/paged_attention.cu is built for
SPLIT_KEYS = 64            # csrc/paged_attention.cu: keys per tile, the split unit
DECODE_MAX_G = 8           # query heads per kv head the decode kernel takes
CHUNK_ROWS = 64            # query rows per block of the chunk kernel
# the chunk kernel at hd 256 (rk_paged_chunk_wgmma_kernel) takes 128 rows a
# block, two warpgroups of 64
_CHUNK_ROWS = {256: 128}
# the decode kernel at hd 256 (rk_paged_decode_mma_kernel) walks 32-key tiles
_DECODE_SPLIT_KEYS = {256: 32}
# blocks an SM the split plan aims at: decode blocks are light and end early
# on short sequences; a chunk block fills an SM at hd 256 (half of one
# below). Sweeps of 2-16 (tools/attention_times.py --sweep on an H100) found
# 4 best at hd 128 and 256 (Gemma-2-9B's and Gemma-7B's decode), 6 at hd 96
# (Phi-3-mini's 32 kv heads) and 3 at hd 64 (Qwen2.5-0.5B's 2); the chunk's
# sweep of 1-4 found 1 best at hd 256 (each split writes 1 KB of f32 a row
# for the combine kernel to read).
_DECODE_BLOCKS_PER_SM = {64: 3, 96: 6}     # per head dim; 4 at the others
_CHUNK_BLOCKS_PER_SM = 1


def split_unit(hd: int, decode: bool = True) -> int:
    """Keys per tile of the kernel a plan cuts for: a split is whole tiles."""
    return _DECODE_SPLIT_KEYS.get(hd, SPLIT_KEYS) if decode else SPLIT_KEYS


def decode_blocks_per_sm(hd: int) -> int:
    """Decode blocks an SM the split plan aims at, at this head dim."""
    return _DECODE_BLOCKS_PER_SM.get(hd, 4)


def chunk_rows(hd: int) -> int:
    """Query rows a block of the chunk kernel takes at this head dim."""
    return _CHUNK_ROWS.get(hd, CHUNK_ROWS)


class PagedKVCache:
    """Host-managed page pool. Device tensors ``k_pages[layer]`` /
    ``v_pages[layer]`` of shape (nkv, num_pages, page_size, hd).

    With ``mesh`` (a model axis of D shards): the pools are held per shard
    over kv heads, ``k_pages[layer]`` a list of D tensors (nkv / D,
    num_pages, page_size, hd), each on its shard's device. The host
    bookkeeping is unchanged: page ids are global, and every shard keeps
    the same page layout for its own heads."""

    def __init__(self, num_pages: int, page_size: int, num_kv_heads: int,
                 head_dim: int, num_layers: int, dtype=torch.bfloat16,
                 device=None, mesh=None):
        self.num_pages = num_pages
        self.page_size = page_size
        self.nkv = num_kv_heads
        self.hd = head_dim
        self.num_layers = num_layers
        self.mesh = mesh
        if mesh is not None:
            n = mesh.shape["model"]
            if num_kv_heads % n:
                raise ValueError(f"num_kv_heads={num_kv_heads} not divisible by "
                                 f"model axis {n}")
            shape = (num_kv_heads // n, num_pages, page_size, head_dim)

            def pools():
                return [[torch.zeros(shape, dtype=dtype, device=d)
                         for d in mesh.axis_devices("model")] for _ in range(num_layers)]
            self.k_pages, self.v_pages = pools(), pools()
        else:
            dev = resolve_device(device)
            shape = (num_kv_heads, num_pages, page_size, head_dim)
            self.k_pages = [torch.zeros(shape, dtype=dtype, device=dev)
                            for _ in range(num_layers)]
            self.v_pages = [torch.zeros(shape, dtype=dtype, device=dev)
                            for _ in range(num_layers)]
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.seq_pages: dict = {}   # seq_id → [page ids]
        self.seq_len: dict = {}     # seq_id → tokens used
        # prefix cache: a FULL page holding positions [i*ps, (i+1)*ps) of a
        # token stream depends only on the tokens [0, (i+1)*ps), so full
        # pages are keyed by a sha1 chain digest over the whole prefix and
        # reused (refcounted, read-only) by later sequences with the same
        # leading tokens. Registered pages without references stay resident
        # and are evicted LRU when an allocation needs their slots.
        self.refs = np.zeros(num_pages, np.int64)
        self.registry: "OrderedDict[str, int]" = OrderedDict()  # digest → page
        self.page_digest: dict = {}  # page → digest (registered pages)
        # digest → (parent digest | None, block token tuple): a lookup checks
        # both, so a sha1 collision alone never aliases two prefixes
        self.reg_meta: dict = {}
        self.prefix_hits = 0      # pages served from the cache
        self.prefix_lookups = 0   # prefixed allocations attempted

    # -- allocation -------------------------------------------------------------

    def _take(self, need: int) -> List[int]:
        """Pop `need` pages, evicting LRU unreferenced registered pages
        when the free list runs short."""
        if len(self._free) < need:
            for digest in list(self.registry):
                if len(self._free) >= need:
                    break
                page = self.registry[digest]
                if self.refs[page] == 0:
                    self._unregister(digest)
                    self._free.append(page)
        if len(self._free) < need:
            raise MemoryError("KV page pool exhausted")
        return [self._free.pop() for _ in range(need)]

    def _unregister(self, digest: str) -> None:
        page = self.registry.pop(digest)
        self.page_digest.pop(page, None)
        self.reg_meta.pop(digest, None)

    def allocate(self, seq_id, num_tokens: int) -> List[int]:
        """Reserve pages for a new sequence of num_tokens."""
        need = -(-num_tokens // self.page_size)
        pages = self._take(need)
        self.refs[pages] += 1
        self.seq_pages[seq_id] = pages
        self.seq_len[seq_id] = num_tokens
        return pages

    def _chain_digests(self, tokens) -> List[Tuple[str, tuple]]:
        """[(digest, block token tuple)] for each FULL page of `tokens`;
        digest i accumulates blocks 0..i (the whole prefix)."""
        ps = self.page_size
        out = []
        h = hashlib.sha1()
        for i in range(len(tokens) // ps):
            blk = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            h.update(np.asarray(blk, np.int64).tobytes())
            out.append((h.hexdigest(), blk))
        return out

    def match_prefix(self, prompt_ids) -> List[int]:
        """Longest run of leading full pages already resident for this
        prompt, leaving >= 1 token to prefill (the caller needs the last
        prompt token's logits). Each hit is content-verified: digest, parent
        link and block tokens must all match."""
        ps = self.page_size
        n_full = max(0, (len(prompt_ids) - 1) // ps)
        pages: List[int] = []
        parent = None
        for digest, blk in self._chain_digests(list(prompt_ids)[:n_full * ps]):
            page = self.registry.get(digest)
            if page is None:
                break
            meta = self.reg_meta.get(digest)
            if meta is None or meta[0] != parent or meta[1] != blk:
                break  # digest collision / stale entry: content mismatch
            pages.append(page)
            parent = digest
        return pages

    def allocate_prefixed(self, seq_id, prompt_ids) -> int:
        """Allocate a sequence reusing cached prefix pages where their chain
        digests match. Returns the number of prompt tokens whose K/V is
        already resident (a multiple of page_size)."""
        ps = self.page_size
        n = len(prompt_ids)
        self.prefix_lookups += 1
        hit = self.match_prefix(prompt_ids)
        # pin the hits FIRST so _take's eviction can never steal them
        for p in hit:
            self.refs[p] += 1
            self.registry.move_to_end(self.page_digest[p])
        need = -(-n // ps) - len(hit)
        try:
            fresh = self._take(need)
        except MemoryError:
            for p in hit:
                self.refs[p] -= 1
            raise
        self.refs[fresh] += 1
        self.seq_pages[seq_id] = hit + fresh
        self.seq_len[seq_id] = n
        self.prefix_hits += len(hit)
        return len(hit) * ps

    def extend(self, seq_id, extra_tokens: int = 1) -> None:
        """Grow a sequence; grabs a new page when the last one fills."""
        new = self.seq_len[seq_id] + extra_tokens
        have = len(self.seq_pages[seq_id]) * self.page_size
        while new > have:
            page = self._take(1)[0]
            self.refs[page] += 1
            self.seq_pages[seq_id].append(page)
            have += self.page_size
        self.seq_len[seq_id] = new

    def _register_pages(self, pages: List[int], tokens) -> None:
        """Enter `tokens`' full pages into the prefix registry (first writer
        wins; a later identical chain refreshes the LRU position)."""
        parent = None
        for i, (digest, blk) in enumerate(self._chain_digests(tokens)):
            if i >= len(pages):
                break
            if digest not in self.registry and pages[i] not in self.page_digest:
                self.registry[digest] = pages[i]
                self.page_digest[pages[i]] = digest
                self.reg_meta[digest] = (parent, blk)
            if digest in self.registry:
                self.registry.move_to_end(digest)
            parent = digest

    def register_prefix(self, seq_id, tokens) -> None:
        """Register a LIVE sequence's full pages right after prefill: a full
        page is immutable once the chunk writer passes it, so concurrent
        requests and later forwards of the same /chat can reuse it while
        this sequence still generates."""
        pages = self.seq_pages.get(seq_id)
        if pages:
            self._register_pages(pages, tokens)

    def free(self, seq_id, register_tokens=None) -> None:
        """Release a sequence's pages. With ``register_tokens`` (its
        confirmed stream: prompt + generated) its full pages enter the
        prefix registry before the refcounts drop."""
        pages = self.seq_pages.pop(seq_id, [])
        self.seq_len.pop(seq_id, None)
        if register_tokens is not None and pages:
            self._register_pages(pages, register_tokens)
        for p in reversed(pages):
            self.refs[p] -= 1
            if self.refs[p] == 0 and p not in self.page_digest:
                self._free.append(p)

    @property
    def available_pages(self) -> int:
        """Pages an allocation could obtain: free + evictable (registered,
        unreferenced). Admission control uses this, not len(_free)."""
        evictable = sum(1 for p in self.page_digest if self.refs[p] == 0)
        return len(self._free) + evictable

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)


# ---------------------------------------------------------------------------
# writes
# ---------------------------------------------------------------------------

def paged_update_token(pages: torch.Tensor, vals: torch.Tensor,
                       page_ids: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Write one token per sequence into the pool, in place: pages
    (nkv, P, ps, hd); vals (nkv, b, hd); page_ids/slots (b,). Returns
    ``pages``."""
    pages[:, page_ids.long(), slots.long()] = vals.to(pages.dtype)
    return pages


def paged_update_chunk(pages: torch.Tensor, vals: torch.Tensor,
                       page_ids: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Write s tokens for each of b sequences, in place: vals
    (nkv, b, s, hd); page_ids/slots (b, s). Returns ``pages``."""
    nkv, b, s, hd = vals.shape
    return paged_update_token(pages, vals.reshape(nkv, b * s, hd),
                              page_ids.reshape(-1), slots.reshape(-1))


# ---------------------------------------------------------------------------
# attention: plain versions
# ---------------------------------------------------------------------------

def paged_attention_chunk_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, page_indices: torch.Tensor,
                                lengths: torch.Tensor,
                                sm_scale: Optional[float] = None,
                                window: int = 0, softcap: float = 0.0
                                ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (port of
    ``paged_attention_chunk_ref``): gathers every sequence's pages and
    materializes the scores in f32. q (b, s, nh, hd) → (b, s, nh, hd)."""
    b, s, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    g = nh // nkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    idx = page_indices.long()
    mp = idx.shape[1]
    T = mp * ps
    k = k_pages[:, idx].reshape(nkv, b, T, hd).float()
    v = v_pages[:, idx].reshape(nkv, b, T, hd).float()
    qg = q.reshape(b, s, nkv, g, hd).float()
    sc = torch.einsum("bsngd,nbtd->bngst", qg, k) * sm_scale
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    limit = (lengths.long()[:, None] - s + 1
             + torch.arange(s, device=q.device)[None, :])          # (b, s)
    tpos = torch.arange(T, device=q.device)
    valid = tpos[None, None, :] < limit[:, :, None]                  # (b, s, T)
    if window:
        valid = valid & (tpos[None, None, :] >= limit[:, :, None] - window)
    valid = valid[:, None, None]                                     # (b,1,1,s,T)
    seen = valid.any(dim=-1, keepdim=True)
    sc = torch.where(valid, sc, torch.where(seen, -torch.inf, 0.0))
    w = torch.softmax(sc, dim=-1) * valid                            # empty row → 0
    out = torch.einsum("bngst,nbtd->bsngd", w, v)
    return out.reshape(b, s, nh, hd).to(q.dtype)


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_indices: torch.Tensor,
                          lengths: torch.Tensor, sm_scale: Optional[float] = None,
                          window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel (port of
    ``paged_attention_ref``): q (b, nh, hd) → (b, nh, hd)."""
    return paged_attention_chunk_plain(q[:, None], k_pages, v_pages,
                                       page_indices, lengths, sm_scale,
                                       window, softcap)[:, 0]


# ---------------------------------------------------------------------------
# attention: the split plan and the kernel wrappers
# ---------------------------------------------------------------------------

def paged_split_plan(mp: int, ps: int, b: int, nkv: int, sm_count: int,
                     row_tiles: Optional[int] = None, hd: int = 128) -> int:
    """Keys per split of the bf16 kernels: a whole number of the kernel's
    key tiles (``split_unit``: 64 keys, 32 for decode at hd 256).

    ``row_tiles`` None plans the decode kernel (one block per sequence, kv
    head and split); a number plans the chunk kernel with that many row
    tiles (``chunk_rows``: 64 rows, 128 at hd 256) per (sequence, kv head). Reads the page table's width and the
    head dim, never the lengths: the splits cover every key below
    ``mp * ps``, and a split past a sequence's length ends at once. As few
    splits as give the blocks the kernel aims at on every SM, at most one
    per tile, cut evenly into whole tiles (which may round to fewer
    splits)."""
    decode = row_tiles is None
    unit = split_unit(hd, decode)
    tiles = -(-(mp * ps) // unit)
    per_sm = decode_blocks_per_sm(hd) if decode else _CHUNK_BLOCKS_PER_SM
    base = b * nkv * (row_tiles or 1)
    splits = min(tiles, max(1, -(-per_sm * sm_count // base)))
    return -(-tiles // splits) * unit


def paged_splits(mp: int, ps: int, keys_per_split: int) -> int:
    return -(-(mp * ps) // keys_per_split)


def kernel_split(b: int, q_len: int, nh: int, nkv: int, ps: int, mp: int,
                 dtype: torch.dtype, sm_count: int, hd: int = 128) -> int:
    """Keys per split of the launch the wrappers make for these shapes: the
    plan on bf16 (decode kernel for q_len 1 and at most ``DECODE_MAX_G``
    heads per kv head, else the chunk kernel), one split on f32."""
    if dtype != torch.bfloat16:
        return -(-(mp * ps) // SPLIT_KEYS) * SPLIT_KEYS
    g = nh // nkv
    if q_len == 1 and g <= DECODE_MAX_G:
        return paged_split_plan(mp, ps, b, nkv, sm_count, hd=hd)
    return paged_split_plan(mp, ps, b, nkv, sm_count, -(-(q_len * g) // chunk_rows(hd)),
                            hd=hd)


def _paged_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                page_indices: torch.Tensor, lengths: torch.Tensor,
                sm_scale: float, window: int, softcap: float,
                name: str) -> torch.Tensor:
    """Launch csrc/paged_attention.cu on q (b, q_len, nh, hd)."""
    b, q_len, nh, hd = q.shape
    nkv, P, ps, phd = k_pages.shape
    if hd not in KERNEL_HEAD_DIMS or phd != hd:
        raise ValueError(f"{name} kernel takes head_dim {KERNEL_HEAD_DIMS}, "
                         f"got q {hd} and pages {phd}")
    if v_pages.shape != k_pages.shape or nh % nkv:
        raise ValueError(f"{name}: pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit {nh} query heads")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"{name}: q and the pages must share one dtype")
    if page_indices.dim() != 2 or page_indices.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"{name}: page_indices {tuple(page_indices.shape)} "
                         f"and lengths {tuple(lengths.shape)} for batch {b}")
    q = q.contiguous()
    idx = page_indices.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    kernels.require_cuda(name, q, k_pages, v_pages, out)
    if idx.device != q.device or lens.device != q.device:
        raise ValueError(f"{name}: page tables and lengths must be on {q.device}")
    mp = idx.shape[1]
    kps = kernel_split(b, q_len, nh, nkv, ps, mp, q.dtype,
                       kernels.sm_count(q.device.index), hd)
    splits = paged_splits(mp, ps, kps)
    # per (sequence, kv head, row, split): m and l, then the hd sums of o
    ws = torch.empty(b * q_len * nh * splits * (2 + hd) if splits > 1 else 0,
                     dtype=torch.float32, device=q.device)
    err = kernels.lib().rk_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), idx.data_ptr(),
        lens.data_ptr(), b, q_len, nh, nkv, P, ps, mp, hd,
        float(sm_scale), int(window), float(softcap),
        kernels.dtype_code(q.dtype), kps, ws.data_ptr(), out.data_ptr(),
        kernels.stream_handle(q.device))
    kernels.check(err, name)
    kernels.count(name, f"hd={hd} g={nh // nkv}")
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_indices: torch.Tensor,
                    lengths: torch.Tensor, sm_scale: Optional[float] = None,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Decode-step paged attention: q (b, nh, hd); pages (nkv, P, ps, hd);
    page_indices (b, max_pages) int; lengths (b,) int → (b, nh, hd).
    CUDA tensors launch the kernel (hd 64, 96, 128 or 256; another raises);
    CPU tensors take the plain version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _paged_cuda(q[:, None], k_pages, v_pages, page_indices, lengths,
                           sm_scale, window, softcap, "paged_attention")[:, 0]
    return paged_attention_plain(q, k_pages, v_pages, page_indices, lengths,
                                 sm_scale, window, softcap)


def paged_attention_chunk(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_indices: torch.Tensor,
                          lengths: torch.Tensor, sm_scale: Optional[float] = None,
                          window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Chunk-append paged attention (chunked prefill): q (b, s, nh, hd);
    lengths count tokens INCLUDING the chunk → (b, s, nh, hd). CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _paged_cuda(q, k_pages, v_pages, page_indices, lengths,
                           sm_scale, window, softcap, "paged_attention_chunk")
    return paged_attention_chunk_plain(q, k_pages, v_pages, page_indices,
                                       lengths, sm_scale, window, softcap)
