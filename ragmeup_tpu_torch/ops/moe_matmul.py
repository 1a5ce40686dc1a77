"""Expert-gathered and grouped matmuls for sparse-MoE models: the CUDA
kernels and their plain versions.

Counterpart of ``ragmeup_tpu/ops/moe_matmul.py``. For int8 and float
experts, both read the stacked ``(E, k, n)`` expert tensors: int8 with
per-expert per-output-channel scales ``(E, n)``, or float with
``scale=None``. Each weight is cast to x's dtype before the product (the
TPU kernels' ``w.astype(x.dtype)``), products and sums are f32, the scale
multiplies the sum, and the result rounds once to x's dtype.

- ``moe_gather_matmul`` (decode, at most 64 slots): ``out[s] = x[s] @
  (w[ids[s]] · scale[ids[s]])``, reading only the routed experts' bytes
  (csrc/moe_matmul.cu, kernel ``moe_gather``). Shapes that do not tile take
  a gather + einsum that dequantizes in x's dtype first, as the JAX
  fallback does.
- ``moe_grouped_matmul`` (batched decode past the slot gate, prefill under
  ``moe_grouped="on"``): rows sorted by expert, ``gsz[e]`` rows for expert
  e. Groups pad to ``tm``-row tiles so every tile reads one expert's
  weights (``scatter_layout``); long row sets chunk as the JAX package
  chunks them. The JAX package's choice between its per-tile kernel and
  its full-stack kernel is kept and picks the counter: ``moe_grouped``
  (#11, the dedup route) or ``moe_grouped_stack`` (#12). Non-tiling
  shapes and short row sets take a grouped product that dequantizes in x's
  dtype first (the JAX ``ragged_dot`` fallback).

Packed-int4 experts ``w_p (E, k/2, n)`` (``pack_int4`` per expert) with
group scales ``gscale (E, k/group, n)``, each route with the TPU kernels'
two arithmetics: group < tile dequantizes each weight in f32 and rounds it
to x's dtype; group == tile (the output-scaled route) sums x against the
integers per k-tile and adds the tiles times their scales in f32.

- ``moe_gather_matmul_int4`` (decode, at most 64 slots; #13, counted as
  ``moe_gather_int4``, csrc/quant_matmul_int4.cu): the routed slots'
  packed bytes only. Shapes the JAX gate refuses take a gather, unpack and
  dequantize in x's dtype + einsum.
- ``moe_grouped_matmul_int4`` (batched decode, E < S ≤ 4E; #14,
  ``moe_grouped_int4``, csrc/moe_matmul_int4.cu): rows sorted by expert
  in the padded layout, each unique routed expert's packed bytes read once
  a tile; bf16 cuts k into slices of whole packing tiles
  (``grouped_int4_plan``) whose f32 partials are added in slice order.
  Callers gate on ``grouped_int4_viable``: its fallback dequantizes every
  stack in x's dtype.

On a kernel route a CUDA tensor launches the kernel (or raises) and a CPU
tensor takes the kernel's plain version. Nothing on the CUDA routes reads
a device value on the host. The grouped kernel's backward is not ported
(ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.ops.quant_matmul import (_add_in_tile_order, int4_slice_for,
                                                unpack_int4)

GATHER_MAX_SLOTS = 64      # the JAX gate of the gather kernel
_COLS_PER_BLOCK = 512      # csrc/moe_matmul.cu gather: 128 threads x 4 columns
_GROUPED_BN = 128          # csrc/moe_matmul.cu grouped: columns per block
_GROUPED_BK = 64           # csrc/moe_matmul.cu grouped: k per step
_W_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check_weights(name: str, w: torch.Tensor, scale: Optional[torch.Tensor]):
    if w.dtype not in _W_CODES:
        raise TypeError(f"{name}: experts int8, bfloat16 or float32, got {w.dtype}")
    if scale is not None and scale.shape != (w.shape[0], w.shape[2]):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for experts "
                         f"{tuple(w.shape)}")


# ---------------------------------------------------------------------------
# Per-slot expert gather (#10)
# ---------------------------------------------------------------------------

def moe_gather_matmul_plain(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel: f32 products of x with
    the slot's expert cast to x's dtype, an f32 sum, the scale, one
    rounding."""
    idx = ids.long()
    wd = w.index_select(0, idx).to(x.dtype).float()              # (S, k, n)
    acc = torch.bmm(x.float()[:, None, :], wd)[:, 0]
    if scale is not None:
        acc = acc * scale.index_select(0, idx).float()
    return acc.to(x.dtype)


def _gather_fallback(x, w, ids, scale):
    """The route for shapes the kernel does not take: gather the slots'
    experts, dequantize in x's dtype (scale cast first) and multiply."""
    idx = ids.long()
    wd = w.index_select(0, idx).to(x.dtype)
    if scale is not None:
        wd = wd * scale.index_select(0, idx)[:, None, :].to(x.dtype)
    return torch.einsum("sk,skn->sn", x, wd)


def _target_blocks(device_index: int) -> int:
    """Two blocks per SM of the card the kernel launches on."""
    return 2 * kernels.sm_count(device_index)


def gather_slice_for(k: int, n: int, slots: int, target_blocks: int) -> int:
    """Split-K slice of the gather kernel: the longest divisor of k (at most
    256) that still gives ``target_blocks`` blocks over all slots."""
    col_blocks = -(-n // _COLS_PER_BLOCK) * slots
    divisors = [s for s in (256, 128, 64, 32, 16) if k % s == 0]
    if not divisors:
        raise ValueError(f"moe_gather kernel: k={k} not a multiple of 16")
    for s in divisors:
        if col_blocks * (k // s) >= target_blocks:
            return s
    return divisors[-1]


def _gather_cuda(x, w, ids, scale):
    s_slots, k = x.shape
    n = w.shape[2]
    if n % 4:
        raise ValueError(f"moe_gather kernel: n % 4 == 0 (got n={n})")
    x = x.contiguous()
    ids = ids.to(torch.int32).contiguous()
    tensors = [x, w, ids]
    if scale is not None:
        scale = scale.float().contiguous()
        tensors.append(scale)
    kernels.require_cuda("moe_gather", *tensors)
    ks = gather_slice_for(k, n, s_slots, _target_blocks(x.device.index))
    partial = torch.empty((k // ks, s_slots, n), dtype=torch.float32, device=x.device)
    out = torch.empty((s_slots, n), dtype=x.dtype, device=x.device)
    err = kernels.lib().rk_moe_gather(
        x.data_ptr(), w.data_ptr(), scale.data_ptr() if scale is not None else None,
        ids.data_ptr(), s_slots, k, n, ks, kernels.dtype_code(x.dtype),
        _W_CODES[w.dtype], partial.data_ptr(), out.data_ptr(),
        kernels.stream_handle(x.device))
    kernels.check(err, "moe_gather")
    kernels.count("moe_gather")
    return out


def moe_gather_matmul(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                      scale: Optional[torch.Tensor] = None,
                      tile_k: int = 0, tile_n: int = 0) -> torch.Tensor:
    """Per-slot expert matmul ``out[s] = x[s] @ dequant(w[ids[s]])``.

    x (S, k) bf16/f32; w (E, k, n) int8 with scale (E, n), or float with
    scale None; ids (S,) expert per slot. Returns (S, n) in x's dtype.
    The kernel route when k and n tile (512/1024) and S ≤ 64, as in the JAX
    package; the gather fallback otherwise."""
    s_slots, k = x.shape
    e, kw, n = w.shape
    if kw != k or ids.shape != (s_slots,):
        raise ValueError(f"moe_gather_matmul shapes: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, ids {tuple(ids.shape)}")
    _check_weights("moe_gather_matmul", w, scale)
    tile_k = tile_k or (1024 if k % 1024 == 0 else 512 if k % 512 == 0 else 0)
    tile_n = tile_n or (1024 if n % 1024 == 0 else 512 if n % 512 == 0 else 0)
    if tile_k and tile_n and s_slots <= GATHER_MAX_SLOTS:
        if x.is_cuda:
            return _gather_cuda(x, w, ids, scale)
        return moe_gather_matmul_plain(x, w, ids, scale)
    return _gather_fallback(x, w, ids, scale)


# ---------------------------------------------------------------------------
# Grouped GEMM over expert-sorted rows (#11 per tile, #12 full-stack route)
# ---------------------------------------------------------------------------

def grouped_tm(e: int, dtype: torch.dtype) -> int:
    """Largest m-tile whose worst-case per-call padding (E·(tm-1) rows)
    stays within the strip budget; bf16 takes at least 16 rows."""
    floor = 16 if dtype == torch.bfloat16 else 8
    for tm in (128, 64, 32, 16, 8):
        if tm <= floor:
            break
        if e * (tm - 1) <= 1024:
            return tm
    return floor


def stack_tiles(mp: int, e: int, k: int, n: int, wb: int, xb: int
                ) -> Optional[Tuple[int, int]]:
    """The JAX package's (tile_k, tile_n) for its full-stack kernel, or None
    when no tile fits its ~14 MB budget. Here it decides the route (and so
    the counter): full stack where the JAX package would take it."""
    best = None
    for tn in (512, 256, 128):
        if n % tn:
            continue
        for tk in (512, 256, 128):
            if k % tk:
                continue
            est = (2 * mp * tk * xb + 2 * e * tk * tn * wb
                   + 2 * mp * tn * xb + mp * tn * 4
                   + 2 * e * 8 * tn * 4)
            if est <= 14 << 20:
                cand = (tn, tk)
                if best is None or cand > best:
                    best = cand
    return (best[1], best[0]) if best else None


def scatter_layout(xs: torch.Tensor, gsz: torch.Tensor, tm: int, e: int):
    """Pad each expert group to a ``tm``-row multiple and scatter rows into
    the padded layout, so every m-tile reads exactly one expert. Returns
    (padded rows (mp, k), each row's place in them, each tile's expert, the
    number of rows the groups fill as a 1-element tensor). Tiles from that
    row on hold padding only."""
    m, k = xs.shape
    dev = xs.device
    mp = -(-(m + e * (tm - 1)) // tm) * tm
    gsz = gsz.to(device=dev, dtype=torch.int64)
    csum = torch.cumsum(gsz, 0)
    pgs = (gsz + (tm - 1)) // tm * tm
    pcs = torch.cumsum(pgs, 0)
    idx = torch.arange(m, device=dev)
    eid = torch.searchsorted(csum, idx, right=True).clamp_(max=e - 1)
    dst = (pcs - pgs)[eid] + (idx - (csum - gsz)[eid])
    xp = xs.new_zeros((mp, k)).index_copy_(0, dst, xs)
    tid = torch.arange(mp // tm, device=dev) * tm
    texp = torch.searchsorted(pcs, tid, right=True).clamp_(max=e - 1)
    return xp, dst, texp, pcs[-1:]


def grouped_padded_plain(xp: torch.Tensor, w: torch.Tensor,
                         scale: Optional[torch.Tensor], texp: torch.Tensor,
                         tm: int) -> torch.Tensor:
    """Plain PyTorch version of the grouped kernel on the padded layout:
    each m-tile times its expert cast to x's dtype, f32 products and sums,
    the scale, one rounding."""
    mp, k = xp.shape
    tiles = mp // tm
    wt = w.index_select(0, texp.long()).to(xp.dtype).float()      # (tiles, k, n)
    acc = torch.bmm(xp.float().reshape(tiles, tm, k), wt)
    if scale is not None:
        acc = acc * scale.index_select(0, texp.long()).float()[:, None, :]
    return acc.reshape(mp, -1).to(xp.dtype)


def moe_grouped_matmul_plain(xs: torch.Tensor, w: torch.Tensor, gsz: torch.Tensor,
                             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the whole grouped product, with the
    kernel's arithmetic and without the padded layout: each group's rows
    times its expert (the group sizes are read on the host)."""
    out = torch.empty((xs.shape[0], w.shape[2]), dtype=xs.dtype, device=xs.device)
    lo = 0
    for ex, g in enumerate(gsz.tolist()):
        if g:
            acc = xs[lo:lo + g].float() @ w[ex].to(xs.dtype).float()
            if scale is not None:
                acc = acc * scale[ex].float()
            out[lo:lo + g] = acc.to(xs.dtype)
        lo += g
    return out


def _grouped_fallback(xs, w, gsz, scale):
    """The route for shapes the kernel does not take (JAX: ``ragged_dot``
    on experts dequantized in x's dtype): each row times its group's
    expert, rows past the groups zero. Every expert multiplies every row,
    so no group size is read on the host."""
    wd = w.to(xs.dtype)
    if scale is not None:
        wd = wd * scale[:, None, :].to(xs.dtype)
    csum = torch.cumsum(gsz.to(device=xs.device, dtype=torch.int64), 0)
    eid = torch.searchsorted(csum, torch.arange(xs.shape[0], device=xs.device),
                             right=True)[:, None]
    out = xs.new_zeros((xs.shape[0], w.shape[2]))
    for ex in range(w.shape[0]):
        out = torch.where(eid == ex, xs @ wd[ex], out)
    return out


def _grouped_cuda(xp, w, scale, texp, used, tm, stack: bool):
    mp, k = xp.shape
    n = w.shape[2]
    name = "moe_grouped_stack" if stack else "moe_grouped"
    if k % _GROUPED_BK or n % _GROUPED_BN:
        raise ValueError(f"{name} kernel: k % {_GROUPED_BK} and n % {_GROUPED_BN} "
                         f"must be 0 (got k={k}, n={n})")
    if tm not in (8, 16, 32, 64, 128) or (xp.dtype == torch.bfloat16 and tm < 16):
        raise ValueError(f"{name} kernel: tm={tm} for {xp.dtype}")
    texp = texp.to(torch.int32).contiguous()
    used = used.to(torch.int32).contiguous()
    tensors = [xp, w, texp, used]
    if scale is not None:
        scale = scale.float().contiguous()
        tensors.append(scale)
    kernels.require_cuda(name, *tensors)
    out = torch.empty((mp, n), dtype=xp.dtype, device=xp.device)
    err = kernels.lib().rk_moe_grouped(
        xp.data_ptr(), w.data_ptr(), scale.data_ptr() if scale is not None else None,
        texp.data_ptr(), used.data_ptr(), mp, k, n, tm,
        kernels.dtype_code(xp.dtype), _W_CODES[w.dtype], out.data_ptr(),
        kernels.stream_handle(xp.device))
    kernels.check(err, name)
    kernels.count(name)
    return out


def grouped_padded(xp: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                   texp: torch.Tensor, used: torch.Tensor, tm: int,
                   stack: bool) -> torch.Tensor:
    """The grouped kernel on the padded layout: (mp, k) rows, tile i of
    ``tm`` rows times expert ``texp[i]``. ``stack`` marks the JAX package's
    full-stack route (#12, counted as ``moe_grouped_stack``); otherwise the
    per-tile route (#11, ``moe_grouped``). Both launch the same kernel."""
    if xp.is_cuda:
        return _grouped_cuda(xp, w, scale, texp, used, tm, stack)
    return grouped_padded_plain(xp, w, scale, texp, tm)


def _pad_scatter_call(xs, w, scale, gsz, tm, no_stack):
    e, k, n = w.shape
    xp, dst, texp, used = scatter_layout(xs, gsz, tm, e)
    st = None if no_stack else stack_tiles(xp.shape[0], e, k, n, w.element_size(),
                                           xs.element_size())
    yp = grouped_padded(xp, w, scale, texp, used, tm, stack=st is not None)
    return yp.index_select(0, dst)


def _grouped_forward(xs, w, scale, gsz, tm, mp_cap, no_stack):
    """Chunk rows so each call's padded strip stays within ``mp_cap`` rows;
    a chunk's group sizes are each group's overlap with its row window
    (rows stay sorted, so chunks stay grouped)."""
    m = xs.shape[0]
    chunk = max(tm, mp_cap - w.shape[0] * (tm - 1))
    if m <= chunk:
        return _pad_scatter_call(xs, w, scale, gsz, tm, no_stack)
    gsz = gsz.to(device=xs.device, dtype=torch.int64)
    csum = torch.cumsum(gsz, 0)
    outs = []
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        g_hi = torch.clamp(csum, lo, hi)
        g_lo = torch.clamp(csum - gsz, lo, hi)
        outs.append(_pad_scatter_call(xs[lo:hi], w, scale, g_hi - g_lo, tm,
                                      no_stack))
    return torch.cat(outs, dim=0)


def moe_grouped_matmul(xs: torch.Tensor, w: torch.Tensor, gsz: torch.Tensor,
                       scale: Optional[torch.Tensor] = None, tm: int = 0,
                       tile_k: int = 0, tile_n: int = 0,
                       no_stack: bool = False) -> torch.Tensor:
    """Grouped GEMM: rows of ``xs`` sorted by expert, ``gsz[e]`` rows for
    expert e, ``out[i] = xs[i] @ dequant(w[expert_of(i)])``.

    xs (M, k); w (E, k, n) int8 with scale (E, n), or float with scale
    None; gsz (E,) summing to M. Routes as the JAX package does: the
    fallback when k or n does not tile (or ``tile_k``/``tile_n`` say so) or
    M < tm/2; otherwise the kernel over the padded layout, chunked, on the
    full-stack route (#12) unless ``no_stack`` or the JAX stack tiles do not
    fit, else the per-tile route (#11). ``no_stack`` is the batched-decode
    dedup route: only the routed experts' tiles are read."""
    m, k = xs.shape
    e, kw, n = w.shape
    if kw != k or gsz.shape != (e,):
        raise ValueError(f"moe_grouped_matmul shapes: xs {tuple(xs.shape)}, "
                         f"w {tuple(w.shape)}, gsz {tuple(gsz.shape)}")
    _check_weights("moe_grouped_matmul", w, scale)
    tm = tm or grouped_tm(e, xs.dtype)
    tile_k = tile_k or (512 if k % 512 == 0 else 0)
    tile_n = tile_n or (512 if n % 512 == 0 else 0)
    if e * (tm - 1) > 1024:
        # large E: a wider strip so padding does not dominate a chunk, and
        # the JAX package's narrower n tile
        mp_cap, tile_n = 4096, (256 if n % 256 == 0 else 0)
    else:
        mp_cap = 2048
    if not (tile_k and tile_n) or m < tm // 2:
        return _grouped_fallback(xs, w, gsz, scale)
    return _grouped_forward(xs, w, scale, gsz, tm, mp_cap, no_stack)


# ---------------------------------------------------------------------------
# Packed-int4 experts: per-slot gather (#13), dedup-grouped GEMM (#14)
# ---------------------------------------------------------------------------

def _int4_tile_n(n: int) -> int:
    """The JAX package's n tile for the int4 expert kernels (0: none)."""
    return next((t for t in (1024, 512, 256) if n % t == 0), 0)


def _unpack_int4_stack(w_p: torch.Tensor, tile_k: int) -> torch.Tensor:
    """(B, k/2, n) packed experts → (B, k, n) int8 codes."""
    b, k2, n = w_p.shape
    return unpack_int4(w_p.reshape(b * k2, n), tile_k).reshape(b, 2 * k2, n)


def _int4_products(xf: torch.Tensor, q: torch.Tensor, gs: torch.Tensor, tile_k: int,
                   group: int, dtype: torch.dtype) -> torch.Tensor:
    """f32 (B, m, n) products of xf (B, m, k) f32 with the codes q (B, k, n)
    and scales gs (B, k/group, n), with the kernels' arithmetic: group <
    tile_k rounds each f32-dequantized weight to ``dtype`` and sums in f32;
    group == tile_k sums each k-tile against the integers and adds the tiles
    times their scales in tile order."""
    b, m, k = xf.shape
    n = q.shape[2]
    if group == tile_k:
        t = k // tile_k
        part = torch.einsum("bmtk,btkn->tbmn", xf.reshape(b, m, t, tile_k),
                            q.float().reshape(b, t, tile_k, n))
        return _add_in_tile_order(part * gs.float().transpose(0, 1)[:, :, None, :])
    wd = q.float() * gs.float().repeat_interleave(group, dim=1)
    return torch.bmm(xf, wd.to(dtype).float())


def dequant_int4_stack(w_p: torch.Tensor, gscale: torch.Tensor, tile_k: int, group: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """Packed experts (B, k/2, n) with scales (B, k/group, n) → (B, k, n) in
    ``dtype``: codes and scales cast to ``dtype`` first, then multiplied
    there (the JAX package's ``dq4`` and its int4 fallbacks)."""
    return (_unpack_int4_stack(w_p, tile_k).to(dtype)
            * gscale.repeat_interleave(group, dim=1).to(dtype))


def _check_int4(name: str, k: int, w_p: torch.Tensor, gscale: torch.Tensor, group: int):
    e, k2, n = w_p.shape
    if w_p.dtype != torch.int8 or k2 * 2 != k or gscale.shape != (e, k // group, n):
        raise ValueError(f"{name}: packed experts {tuple(w_p.shape)} {w_p.dtype} and "
                         f"scales {tuple(gscale.shape)} for k={k}, group={group}")


def moe_gather_matmul_int4_plain(x: torch.Tensor, w_p: torch.Tensor,
                                 gscale: torch.Tensor, ids: torch.Tensor,
                                 tile_k: int, group: int) -> torch.Tensor:
    """Plain PyTorch version of the int4 gather kernel: each slot's expert
    unpacked, the route's f32 arithmetic (``_int4_products``), one
    rounding to x's dtype."""
    idx = ids.long()
    q = _unpack_int4_stack(w_p.index_select(0, idx), tile_k)
    acc = _int4_products(x.float()[:, None, :], q, gscale.index_select(0, idx),
                         tile_k, group, x.dtype)
    return acc[:, 0].to(x.dtype)


def _gather_int4_fallback(x, w_p, gscale, ids, tile_k, group):
    """The route for shapes the kernel does not take: gather the slots'
    experts, unpack, dequantize in x's dtype and multiply."""
    idx = ids.long()
    wd = dequant_int4_stack(w_p.index_select(0, idx), gscale.index_select(0, idx),
                            tile_k, group, x.dtype)
    return torch.einsum("sk,skn->sn", x, wd)


def _gather_int4_cuda(x, w_p, gscale, ids, tile_k, group):
    s_slots, k = x.shape
    n = w_p.shape[2]
    if n % 256:
        raise ValueError(f"moe_gather_int4 kernel: n % 256 == 0 (got n={n})")
    x = x.contiguous()
    ids = ids.to(torch.int32).contiguous()
    gscale = gscale.float().contiguous()
    kernels.require_cuda("moe_gather_int4", x, w_p, gscale, ids)
    ks = int4_slice_for(k, tile_k, n, s_slots, _target_blocks(x.device.index))
    partial = torch.empty((k // 2 // ks, s_slots, n), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((s_slots, n), dtype=x.dtype, device=x.device)
    err = kernels.lib().rk_moe_gather_int4(
        x.data_ptr(), w_p.data_ptr(), gscale.data_ptr(), ids.data_ptr(), s_slots, k,
        n, tile_k, group, ks, kernels.dtype_code(x.dtype), partial.data_ptr(),
        out.data_ptr(), kernels.stream_handle(x.device))
    kernels.check(err, "moe_gather_int4")
    kernels.count("moe_gather_int4")
    return out


def moe_gather_matmul_int4(x: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor,
                           ids: torch.Tensor, tile_k: int, group: int) -> torch.Tensor:
    """Per-slot matmul over packed-int4 experts:
    ``out[s] = x[s] @ dequant4(w_p[ids[s]], gscale[ids[s]])``.

    x (S, k) bf16/f32; w_p (E, k/2, n) packed per ``tile_k`` rows; gscale
    (E, k/group, n); ids (S,). Returns (S, n) in x's dtype. The kernel route
    under the JAX gate (an n tile of 1024/512/256, k % tile_k == 0, group
    dividing tile_k at most 8 times, S ≤ 64); the gather fallback
    otherwise. (The JAX function's ``tile_n`` argument, which no caller
    sets, is not carried over: the gate takes the default tile and the CUDA
    kernel's strip is fixed.)"""
    s_slots, k = x.shape
    if ids.shape != (s_slots,):
        raise ValueError(f"moe_gather_matmul_int4: ids {tuple(ids.shape)} for "
                         f"x {tuple(x.shape)}")
    _check_int4("moe_gather_matmul_int4", k, w_p, gscale, group)
    ok = (_int4_tile_n(w_p.shape[2]) and k % tile_k == 0 and tile_k % group == 0
          and tile_k // group <= 8 and (tile_k // 2) % 8 == 0)
    if ok and s_slots <= GATHER_MAX_SLOTS:
        if x.is_cuda:
            return _gather_int4_cuda(x, w_p, gscale, ids, tile_k, group)
        return moe_gather_matmul_int4_plain(x, w_p, gscale, ids, tile_k, group)
    return _gather_int4_fallback(x, w_p, gscale, ids, tile_k, group)


def _int4_tm(dtype: torch.dtype) -> int:
    """m-tile of the int4 grouped kernel: 16 rows for bf16, 8 for f32."""
    return 16 if dtype == torch.bfloat16 else 8


def grouped_int4_viable(m: int, e: int, k: int, n: int, pack_tile: int, group: int,
                        dtype: torch.dtype) -> bool:
    """True when ``moe_grouped_matmul_int4`` takes the kernel route (the
    JAX package's gate): callers check it, since the fallback dequantizes
    every expert stack."""
    tm = _int4_tm(dtype)
    gpt = pack_tile // max(group, 1)
    mp = -(-(m + e * (tm - 1)) // tm) * tm
    return bool(_int4_tile_n(n) and k % pack_tile == 0 and pack_tile % group == 0
                and gpt <= 8 and (pack_tile // 2) % 8 == 0
                and e * (tm - 1) <= 1024 and mp <= 512)


def grouped_int4_padded_plain(xp: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor,
                              texp: torch.Tensor, pack_tile: int,
                              group: int) -> torch.Tensor:
    """Plain PyTorch version of the int4 grouped kernel on the padded
    layout: each m-tile times its expert with the route's f32 arithmetic,
    one rounding."""
    mp, k = xp.shape
    tm = _int4_tm(xp.dtype)
    idx = texp.long()
    q = _unpack_int4_stack(w_p.index_select(0, idx), pack_tile)
    acc = _int4_products(xp.float().reshape(mp // tm, tm, k), q,
                         gscale.index_select(0, idx), pack_tile, group, xp.dtype)
    return acc.reshape(mp, -1).to(xp.dtype)


def moe_grouped_matmul_int4_plain(xs: torch.Tensor, w_p: torch.Tensor,
                                  gscale: torch.Tensor, gsz: torch.Tensor,
                                  pack_tile: int, group: int) -> torch.Tensor:
    """Plain PyTorch version of the whole int4 grouped product, with the
    kernel's arithmetic and without the padded layout (the group sizes are
    read on the host)."""
    out = torch.empty((xs.shape[0], w_p.shape[2]), dtype=xs.dtype, device=xs.device)
    lo = 0
    for ex, g in enumerate(gsz.tolist()):
        if g:
            acc = _int4_products(xs[lo:lo + g].float()[None],
                                 _unpack_int4_stack(w_p[ex:ex + 1], pack_tile),
                                 gscale[ex:ex + 1], pack_tile, group, xs.dtype)
            out[lo:lo + g] = acc[0].to(xs.dtype)
        lo += g
    return out


# blocks an SM that the int4 grouped kernel's split-K aims at: two waves of
# the four bf16 blocks an SM holds (csrc/moe_matmul_int4.cu);
# tools/split_k_sweep.py times its neighbours
_INT4_BLOCKS_PER_SM = 8


def grouped_int4_plan(mp: int, k: int, n: int, pack_tile: int, sm_count: int) -> int:
    """Split-K plan of the bf16 int4 grouped kernel: packing tiles per
    k-slice. The fewest slices (each as even as whole packing tiles allow)
    that give ``_INT4_BLOCKS_PER_SM`` blocks to every SM, counting all
    ``mp / 16`` row tiles (the used ones are a device value, never read on
    the host); one slice a packing tile when k has too few tiles."""
    tiles = k // pack_tile
    blocks = (n // _GROUPED_BN) * (mp // 16)
    for slices in range(1, tiles + 1):
        per = -(-tiles // slices)
        if blocks * -(-tiles // per) >= _INT4_BLOCKS_PER_SM * sm_count:
            return per
    return 1


def grouped_int4_slices(k: int, pack_tile: int, tiles_per_slice: int):
    """The plan's k-ranges [k0, k1), in the order their partials are added."""
    step = tiles_per_slice * pack_tile
    return [(k0, min(k0 + step, k)) for k0 in range(0, k, step)]


def _grouped_int4_cuda(xp, w_p, gscale, texp, used, pack_tile, group):
    mp, k = xp.shape
    n = w_p.shape[2]
    if pack_tile % 64 or n % 128:
        raise ValueError(f"moe_grouped_int4 kernel: pack_tile % 64 == 0 and "
                         f"n % 128 == 0 (got pack_tile={pack_tile}, n={n})")
    texp = texp.to(torch.int32).contiguous()
    used = used.to(torch.int32).contiguous()
    gscale = gscale.float().contiguous()
    kernels.require_cuda("moe_grouped_int4", xp, w_p, gscale, texp, used)
    out = torch.empty((mp, n), dtype=xp.dtype, device=xp.device)
    per, partial = 0, None      # f32 activations run over all of k
    if xp.dtype == torch.bfloat16:
        per = grouped_int4_plan(mp, k, n, pack_tile, kernels.sm_count(xp.device.index))
        slices = len(grouped_int4_slices(k, pack_tile, per))
        if slices > 1:
            partial = torch.empty((slices, mp, n), dtype=torch.float32, device=xp.device)
    err = kernels.lib().rk_moe_grouped_int4(
        xp.data_ptr(), w_p.data_ptr(), gscale.data_ptr(), texp.data_ptr(),
        used.data_ptr(), mp, k, n, pack_tile, group, per, kernels.dtype_code(xp.dtype),
        None if partial is None else partial.data_ptr(), out.data_ptr(),
        kernels.stream_handle(xp.device))
    kernels.check(err, "moe_grouped_int4")
    kernels.count("moe_grouped_int4")
    return out


def grouped_int4_padded(xp: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor,
                        texp: torch.Tensor, used: torch.Tensor, pack_tile: int,
                        group: int) -> torch.Tensor:
    """The int4 grouped kernel on the padded layout: (mp, k) rows, tile i of
    ``_int4_tm`` rows times expert ``texp[i]``; rows of tiles from ``used``
    on are padding."""
    if xp.is_cuda:
        return _grouped_int4_cuda(xp, w_p, gscale, texp, used, pack_tile, group)
    return grouped_int4_padded_plain(xp, w_p, gscale, texp, pack_tile, group)


def moe_grouped_matmul_int4(xs: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor,
                            gsz: torch.Tensor, pack_tile: int, group: int) -> torch.Tensor:
    """Dedup-grouped GEMM over packed-int4 experts: rows of ``xs`` sorted by
    expert, ``gsz[e]`` rows for expert e, ``out[i] = xs[i] @
    dequant4(w_p[expert_of(i)])``.

    xs (M, k); w_p (E, k/2, n) packed per ``pack_tile`` rows; gscale
    (E, k/group, n); gsz (E,) summing to M. Where ``grouped_int4_viable``
    holds, the kernel over the padded layout of 16-row tiles (bf16) or
    8-row ones (f32); otherwise every stack dequantized in x's dtype and the
    grouped product, as the JAX package falls back. (The JAX function's
    ``tm`` and ``tile_n`` arguments, which no caller sets, are not carried
    over: the gate assumes the default ``tm`` and the CUDA kernel's strip is
    fixed.)"""
    m, k = xs.shape
    e, _, n = w_p.shape
    if gsz.shape != (e,):
        raise ValueError(f"moe_grouped_matmul_int4: gsz {tuple(gsz.shape)} for "
                         f"{e} experts")
    _check_int4("moe_grouped_matmul_int4", k, w_p, gscale, group)
    if not grouped_int4_viable(m, e, k, n, pack_tile, group, xs.dtype):
        wd = dequant_int4_stack(w_p, gscale, pack_tile, group, xs.dtype)
        return _grouped_fallback(xs, wd, gsz, None)
    xp, dst, texp, used = scatter_layout(xs, gsz, _int4_tm(xs.dtype), e)
    return grouped_int4_padded(xp, w_p, gscale, texp, used, pack_tile,
                               group).index_select(0, dst)
