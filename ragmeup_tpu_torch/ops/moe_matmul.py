"""Expert-gathered and grouped matmuls for sparse-MoE models: the CUDA
kernels and their plain versions.

Counterpart of ``ragmeup_tpu/ops/moe_matmul.py``. For int8 and float
experts, both read the stacked ``(E, k, n)`` expert tensors: int8 with
per-expert per-output-channel scales ``(E, n)``, or float with
``scale=None``. Each weight is cast to x's dtype before the product (the
TPU kernels' ``w.astype(x.dtype)``), products and sums are f32, the scale
multiplies the sum, and the result rounds once to x's dtype.

- ``moe_gather_matmul`` (decode, at most 64 slots; #10, counted as
  ``moe_gather``): ``out[s] = x[s] @ (w[ids[s]] · scale[ids[s]])``, reading
  only the routed experts' bytes (csrc/moe_matmul.cu). bf16 x streams 16
  bytes of a weight row a lane, one slot's expert a block (its id read on
  the device), k cut by ``gather_plan``; the slices' f32 partials are added
  in slice order by the last block of each strip, one launch a call. f32 x
  keeps the first kernel and its reduce launch (``gather_slice_for``).
  Shapes that do not tile take a gather + einsum that dequantizes in x's
  dtype first, as the JAX fallback does.
- ``moe_grouped_matmul`` (batched decode past the slot gate, prefill under
  ``moe_grouped="on"``): rows sorted by expert, ``gsz[e]`` rows for expert
  e; long row sets chunk as the JAX package chunks them. The JAX package's
  choice between its per-tile kernel and its full-stack kernel is kept and
  picks the counter: ``moe_grouped`` (#11, the dedup route) or
  ``moe_grouped_stack`` (#12). bf16 rows run the grouped-rows kernel
  (``grouped_rows``) on the sorted rows as they lie, with the group sizes
  on the device and no padded copy: one block a (strip, k slice, expert)
  walks its group's rows, k cut by ``grouped_rows_plan``, the slices added
  in slice order by the last block of each strip. #12 with bf16 rows in
  128-row tiles over int8, bf16 or f32 experts runs its own kernel
  (csrc/moe_stack.cu), and f32 rows run csrc/moe_matmul.cu's f32 kernel;
  both take the padded layout of ``tm``-row tiles (``scatter_layout``), #12
  each tile's real rows (``tile_rows``). ``grouped_kernel_call`` says which
  kernel takes a call. Non-tiling shapes and short row sets take a grouped
  product that dequantizes in x's dtype first (the JAX ``ragged_dot``
  fallback).

Packed-int4 experts ``w_p (E, k/2, n)`` (``pack_int4`` per expert) with
group scales ``gscale (E, k/group, n)``, each route with the TPU kernels'
two arithmetics: group < tile dequantizes each weight in f32 and rounds it
to x's dtype; group == tile (the output-scaled route) sums x against the
integers per k-tile and adds the tiles times their scales in f32.

- ``moe_gather_matmul_int4`` (decode, at most 64 slots; #13, counted as
  ``moe_gather_int4``, csrc/quant_matmul_int4.cu): the routed slots'
  packed bytes only, one slot a block that reads its expert id on the
  device. Where n % 512 == 0 it runs on the W4A16 decode kernels
  (``int4_gather_plan``: #4's split-K plan with the slots counted as
  blocks): bf16 x on the tensor cores where ``int4_decode_tensor_cores``
  takes the groups, f32 x and the groups it refuses on the scalar kernel.
  Shapes the JAX gate admits and the 512-column strips do not tile (n %
  256 == 0) keep the older 64-thread kernel. Shapes the JAX gate refuses
  take a gather, unpack and dequantize in x's dtype + einsum.
- ``moe_grouped_matmul_int4`` (batched decode, E < S ≤ 4E; #14,
  ``moe_grouped_int4``, csrc/moe_matmul_int4.cu): rows sorted by expert
  in the padded layout, each unique routed expert's packed bytes read once
  a tile; bf16 cuts k into slices of whole packing tiles
  (``grouped_int4_plan``) whose f32 partials are added in slice order.
  Callers gate on ``grouped_int4_viable``: its fallback dequantizes every
  stack in x's dtype.

On a kernel route a CUDA tensor launches the kernel (or raises) and a CPU
tensor takes the kernel's plain version (bf16 over the k slices an H100's
plan gives, ``PLAN_SMS``). Nothing on the CUDA routes reads a device value
on the host.

With float experts and a gradient asked for, the kernel route of
``moe_grouped_matmul`` is an autograd Function (the JAX package's
``_grouped_kernel_path`` custom VJP): the forward is the route above; dx
is the same route run on the stacks' transposed view, which the stack
kernel reads as the stacks lie (its dx orientation; the other kernels take
a contiguous copy); dw, each expert's rows of x against the same rows of
dy summed in f32 and cast to w's dtype, runs csrc/moe_wgrad.cu over the
routed rows only (``grouped_weight_grad``, counted as
``moe_grouped_wgrad``; JAX computes it in XLA as a one-hot product, the
plain version ``grouped_weight_grad_plain``). Every other CUDA route has
no backward: ``kernels.require_cuda`` refuses a launch that autograd would
have to go through.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.ops.quant_matmul import (INT4_TILE_N, _add_in_tile_order,
                                                int4_decode_plan, int4_decode_tensor_cores,
                                                int4_decode_viable, int4_slice_for,
                                                unpack_int4)

GATHER_MAX_SLOTS = 64      # the JAX gate of the gather kernel
_F32_COLS_PER_BLOCK = 512  # csrc/moe_matmul.cu f32 gather: 128 threads x 4 columns
_GATHER_ROW_STEP = 64      # csrc/moe_matmul.cu bf16 gather: 8 warps x two 4-row batches
_GATHER_XS_FLOATS = 12288  # csrc/moe_matmul.cu bf16 gather: x's staged slice
_ROWS_STEP = 16            # csrc/moe_matmul.cu grouped rows: k rows a warp's step
_ROWS_WARPS = 8            # csrc/moe_matmul.cu grouped rows: warps a block
_GROUPED_BN = 128          # csrc/moe_matmul.cu f32 grouped: columns per block
_GROUPED_BK = 64           # csrc/moe_matmul.cu f32 grouped: k a call's rows come in
_STACK_TM = 128            # csrc/moe_stack.cu: rows a tile
_STACK_BN = 128            # csrc/moe_stack.cu: columns a strip
_STACK_BK = 64             # csrc/moe_stack.cu: k a ring stage
_STACK_BLOCKS_PER_SM = 2   # csrc/moe_stack.cu: blocks an SM holds (its persistent grid)
_STACK_BLOCKS_PER_SM_F32 = 1  # csrc/moe_stack.cu: f32 experts' stages fill an SM
_WGRAD_TILE = 128          # csrc/moe_wgrad.cu: dw rows and columns a block
_W_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ESIZE = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}
# blocks an SM that the bf16 gather's and the grouped-rows kernel's split-K
# aim at (tools/split_k_sweep.py times 1-8 and 1-16 at Mixtral's and
# Qwen3-30B-A3B's decode shapes): the gather two, the grouped-rows kernel
# one (a Mixtral layer's down whole measured faster than in slices)
_GATHER_BLOCKS_PER_SM = 2
_GROUPED_BLOCKS_PER_SM = 1
# the SMs a CPU tensor's plain version plans for: an H100's, so the CPU
# route adds the same k slices in the same order as the card
PLAN_SMS = 132
# (device index, stream) -> zeroed ticket words (kernels.ticket_words)
_GATHER_TICKETS: dict = {}
_GROUPED_TICKETS: dict = {}


def _check_weights(name: str, w: torch.Tensor, scale: Optional[torch.Tensor]):
    if w.dtype not in _W_CODES:
        raise TypeError(f"{name}: experts int8, bfloat16 or float32, got {w.dtype}")
    if scale is not None and scale.shape != (w.shape[0], w.shape[2]):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for experts "
                         f"{tuple(w.shape)}")


def _slice_sums(xf: torch.Tensor, wf: torch.Tensor, slices) -> torch.Tensor:
    """f32 products of xf (B, m, k) with wf (B, k, n) summed over each k
    slice, the slices added in order (a kernel's split-K partials)."""
    acc = None
    for k0, k1 in slices:
        part = torch.bmm(xf[:, :, k0:k1], wf[:, k0:k1])
        acc = part if acc is None else acc + part
    return acc


# ---------------------------------------------------------------------------
# Per-slot expert gather (#10)
# ---------------------------------------------------------------------------

def moe_gather_matmul_plain(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                            scale: Optional[torch.Tensor] = None,
                            k_slices=None) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel: f32 products of x with
    the slot's expert cast to x's dtype, an f32 sum (over ``k_slices``
    ``[(k0, k1)]``, added in order, where given), the scale, one rounding."""
    idx = ids.long()
    wd = w.index_select(0, idx).to(x.dtype).float()              # (S, k, n)
    acc = _slice_sums(x.float()[:, None, :], wd, k_slices or [(0, x.shape[1])])[:, 0]
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
    """Split-K slice of the f32-row gather kernel: the longest divisor of k
    (at most 256) that still gives ``target_blocks`` blocks over all
    slots."""
    col_blocks = -(-n // _F32_COLS_PER_BLOCK) * slots
    divisors = [s for s in (256, 128, 64, 32, 16) if k % s == 0]
    if not divisors:
        raise ValueError(f"moe_gather kernel: k={k} not a multiple of 16")
    for s in divisors:
        if col_blocks * (k // s) >= target_blocks:
            return s
    return divisors[-1]


def gather_strip(w_dtype: torch.dtype) -> int:
    """Columns of a bf16-row gather block: 32 lanes x one 16-byte load of
    a weight row (512 int8, 256 bf16 or 128 f32 columns)."""
    return 32 * (16 // _ESIZE[w_dtype])


def gather_plan(slots: int, k: int, n: int, w_dtype: torch.dtype, sm_count: int) -> int:
    """Split-K plan of the bf16-row gather kernel: the k rows of a slice
    (slice i covers ``[i * k_slice, min(k, (i + 1) * k_slice))``). k is cut
    into as few slices as give ``_GATHER_BLOCKS_PER_SM`` blocks on every SM
    over all (strip, slot) pairs, each a whole number of the 8 warps'
    double-buffered iterations of two 4-row batches (which may round to
    fewer slices), and no longer than x's staging buffer."""
    strips = -(-n // gather_strip(w_dtype))
    slices = max(1, -(-_GATHER_BLOCKS_PER_SM * sm_count // (strips * slots)))
    k_slice = -(-k // slices)
    return min(-(-k_slice // _GATHER_ROW_STEP) * _GATHER_ROW_STEP, _GATHER_XS_FLOATS)


def gather_slices(k: int, k_slice: int):
    """[(k0, k1)] of each slice in the order the kernel adds them."""
    return [(k0, min(k, k0 + k_slice)) for k0 in range(0, k, k_slice)]


def _gather_cuda(x, w, ids, scale):
    s_slots, k = x.shape
    n = w.shape[2]
    bf16 = x.dtype == torch.bfloat16
    if n % 16:
        raise ValueError(f"moe_gather kernel: n % 16 == 0 (got n={n})")
    x = x.contiguous()
    ids = ids.to(torch.int32).contiguous()
    tensors = [x, w, ids]
    if scale is not None:
        scale = scale.float().contiguous()
        tensors.append(scale)
    kernels.require_cuda("moe_gather", *tensors)
    out = torch.empty((s_slots, n), dtype=x.dtype, device=x.device)
    tickets = None
    if bf16:
        ks = gather_plan(s_slots, k, n, w.dtype, kernels.sm_count(x.device.index))
        slices = -(-k // ks)
        partial = torch.empty((slices, s_slots, n) if slices > 1 else (0,),
                              dtype=torch.float32, device=x.device)
        if slices > 1:
            tickets = kernels.ticket_words(_GATHER_TICKETS, x.device,
                                           s_slots * -(-n // gather_strip(w.dtype)))
    else:
        ks = gather_slice_for(k, n, s_slots, _target_blocks(x.device.index))
        partial = torch.empty((k // ks, s_slots, n), dtype=torch.float32, device=x.device)
    err = kernels.lib().rk_moe_gather(
        x.data_ptr(), w.data_ptr(), scale.data_ptr() if scale is not None else None,
        ids.data_ptr(), s_slots, k, n, ks, kernels.dtype_code(x.dtype),
        _W_CODES[w.dtype], partial.data_ptr(), None if tickets is None else tickets.data_ptr(),
        out.data_ptr(), kernels.stream_handle(x.device))
    kernels.check(err, "moe_gather")
    kernels.count("moe_gather")
    return out


def moe_gather_matmul(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                      scale: Optional[torch.Tensor] = None,
                      tile_k: int = 0, tile_n: int = 0) -> torch.Tensor:
    """Per-slot expert matmul ``out[s] = x[s] @ dequant(w[ids[s]])``.

    x (S, k) bf16/f32; w (E, k, n) int8 with scale (E, n), or float with
    scale None; ids (S,) expert per slot. Returns (S, n) in x's dtype.
    The kernel route when S ≤ 64 and k and n tile (512/1024), as in the JAX
    package, or are multiples of 128, which the JAX kernel refuses
    (Qwen3-MoE's 768-wide experts); the gather fallback otherwise. On the
    CPU the kernel route is the plain version, bf16 x over the k slices the
    card's plan gives (``gather_plan`` on an H100's SMs)."""
    s_slots, k = x.shape
    e, kw, n = w.shape
    if kw != k or ids.shape != (s_slots,):
        raise ValueError(f"moe_gather_matmul shapes: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, ids {tuple(ids.shape)}")
    _check_weights("moe_gather_matmul", w, scale)
    tile_k = tile_k or (1024 if k % 1024 == 0 else 512 if k % 512 == 0 else 0)
    tile_n = tile_n or (1024 if n % 1024 == 0 else 512 if n % 512 == 0 else 0)
    tiled = (tile_k and tile_n) or (k % 128 == 0 and n % 128 == 0)
    if tiled and s_slots <= GATHER_MAX_SLOTS:
        if x.is_cuda:
            return _gather_cuda(x, w, ids, scale)
        slices = None
        if x.dtype == torch.bfloat16:
            slices = gather_slices(k, gather_plan(s_slots, k, n, w.dtype, PLAN_SMS))
        return moe_gather_matmul_plain(x, w, ids, scale, slices)
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
    mp = _padded_rows(m, e, tm)
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


def _padded_rows(m: int, e: int, tm: int) -> int:
    """scatter_layout's row count: every group padded to whole tiles."""
    return -(-(m + e * (tm - 1)) // tm) * tm


def grouped_padded_plain(xp: torch.Tensor, w: torch.Tensor,
                         scale: Optional[torch.Tensor], texp: torch.Tensor,
                         tm: int) -> torch.Tensor:
    """Plain PyTorch version of the grouped kernels on the padded layout:
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
                             scale: Optional[torch.Tensor] = None,
                             k_slices=None) -> torch.Tensor:
    """Plain PyTorch version of the whole grouped product, with the
    kernel's arithmetic and without the padded layout: each group's rows
    times its expert, the f32 sum over ``k_slices`` added in order where
    given (the group sizes are read on the host)."""
    out = torch.empty((xs.shape[0], w.shape[2]), dtype=xs.dtype, device=xs.device)
    lo = 0
    for ex, g in enumerate(gsz.tolist()):
        if g:
            acc = _slice_sums(xs[None, lo:lo + g].float(), w[ex:ex + 1].to(xs.dtype).float(),
                              k_slices or [(0, xs.shape[1])])[0]
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


def tile_rows(gsz: torch.Tensor, texp: torch.Tensor, tm: int) -> torch.Tensor:
    """Each tile's count of real rows in ``scatter_layout``'s padded layout
    (int32, on texp's device, no host read): its group's size less the rows
    of the group's earlier tiles, clamped to 0..tm. Tiles from the used rows
    on count 0."""
    gsz = gsz.to(device=texp.device, dtype=torch.int64)
    pgs = (gsz + (tm - 1)) // tm * tm
    start = torch.cumsum(pgs, 0) - pgs
    t = texp.long()
    before = torch.arange(texp.shape[0], device=texp.device) * tm - start[t]
    return (gsz[t] - before).clamp_(0, tm).to(torch.int32)


def stack_kernel_takes(tm: int, k: int, n: int, x_dtype: torch.dtype,
                       w_dtype: torch.dtype) -> bool:
    """True when #12's call runs csrc/moe_stack.cu's kernel: bf16 rows in
    128-row tiles, int8, bf16 or f32 experts, k in 64-deep steps, n in
    128-column strips. Other bf16 calls run the grouped-rows kernel, f32
    rows csrc/moe_matmul.cu's f32 kernel on the padded layout."""
    return (tm == _STACK_TM and x_dtype == torch.bfloat16
            and w_dtype in (torch.int8, torch.bfloat16, torch.float32)
            and k % _STACK_BK == 0 and n % _STACK_BN == 0)


def stack_grid(mp: int, n: int, sm_count: int, w_dtype: torch.dtype = torch.int8) -> int:
    """The stack kernel's persistent blocks: as many as the card holds (2 an
    SM, f32 experts 1), and no more than the padded layout has (tile,
    strip) pairs."""
    per_sm = _STACK_BLOCKS_PER_SM_F32 if w_dtype == torch.float32 else _STACK_BLOCKS_PER_SM
    return max(1, min((mp // _STACK_TM) * (n // _STACK_BN), per_sm * sm_count))


def stacks_transposed(w: torch.Tensor) -> bool:
    """True when w (E, k, n) is the transposed view of stacks stored (E, n,
    k), as ``GroupedKernelPath``'s dx passes them: the stack kernel's dx
    orientation reads them as they lie."""
    return not w.is_contiguous() and w.transpose(1, 2).is_contiguous()


def _stack_cuda(xp, w, scale, texp, rows, used):
    mp, k = xp.shape
    n = w.shape[2]
    if rows.shape != texp.shape:
        raise ValueError(f"moe_grouped_stack kernel: one count of real rows a tile "
                         f"(got {tuple(rows.shape)} for {texp.shape[0]} tiles)")
    dx = stacks_transposed(w)
    if dx and (scale is not None or w.dtype == torch.int8):
        raise ValueError("moe_grouped_stack kernel: transposed stacks (dx) take float "
                         "experts with no scale")
    texp = texp.to(torch.int32).contiguous()
    rows = rows.to(torch.int32).contiguous()
    used = used.to(torch.int32).contiguous()
    stored = w.transpose(1, 2) if dx else w
    tensors = [xp, stored, texp, rows, used]
    if scale is not None:
        scale = scale.float().contiguous()
        tensors.append(scale)
    kernels.require_cuda("moe_grouped_stack", *tensors)
    out = torch.empty((mp, n), dtype=xp.dtype, device=xp.device)
    grid = stack_grid(mp, n, kernels.sm_count(xp.device.index), w.dtype)
    if dx:
        err = kernels.lib().rk_moe_grouped_stack_t(
            xp.data_ptr(), stored.data_ptr(), texp.data_ptr(), rows.data_ptr(),
            used.data_ptr(), k, n, _W_CODES[w.dtype], grid, out.data_ptr(),
            kernels.stream_handle(xp.device))
    else:
        err = kernels.lib().rk_moe_grouped_stack(
            xp.data_ptr(), w.data_ptr(), scale.data_ptr() if scale is not None else None,
            texp.data_ptr(), rows.data_ptr(), used.data_ptr(), k, n, _W_CODES[w.dtype],
            grid, out.data_ptr(), kernels.stream_handle(xp.device))
    kernels.check(err, "moe_grouped_stack")
    # f32 stacks (a train step's master weights) and the dx orientation
    # count apart
    variant = "w=f32" if w.dtype == torch.float32 else None
    if dx:
        variant = "dx w=f32" if w.dtype == torch.float32 else "dx w=bf16"
    kernels.count("moe_grouped_stack", variant)
    return out


def _grouped_cuda(xp, w, scale, texp, used, tm, stack: bool, rows):
    mp, k = xp.shape
    n = w.shape[2]
    if stack and stack_kernel_takes(tm, k, n, xp.dtype, w.dtype):
        return _stack_cuda(xp, w, scale, texp, rows, used)
    name = "moe_grouped_stack" if stack else "moe_grouped"
    w = w.contiguous()  # dx's transposed stacks: csrc/moe_matmul.cu reads (E, k, n)
    if xp.dtype != torch.float32:
        raise ValueError(f"{name}: the padded layout's csrc/moe_matmul.cu kernel takes f32 "
                         f"rows (bf16 rows run grouped_rows), got {xp.dtype}")
    if k % _GROUPED_BK or n % _GROUPED_BN:
        raise ValueError(f"{name} kernel: k % {_GROUPED_BK} and n % {_GROUPED_BN} "
                         f"must be 0 (got k={k}, n={n})")
    if tm not in (8, 16, 32, 64, 128):
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
        texp.data_ptr(), used.data_ptr(), mp, k, n, tm, _W_CODES[w.dtype], out.data_ptr(),
        kernels.stream_handle(xp.device))
    kernels.check(err, name)
    kernels.count(name)
    return out


def grouped_padded(xp: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                   texp: torch.Tensor, used: torch.Tensor, tm: int,
                   stack: bool, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The grouped kernels on the padded layout: (mp, k) rows, tile i of
    ``tm`` rows times expert ``texp[i]``. ``stack`` marks the JAX package's
    full-stack route (#12, counted as ``moe_grouped_stack``), which takes
    each tile's count of real rows ``rows`` (``tile_rows``); otherwise the
    per-tile route (#11, ``moe_grouped``). Where ``stack_kernel_takes``
    holds, #12 runs csrc/moe_stack.cu's kernel, which leaves the padding
    rows' outputs unwritten; f32 rows run csrc/moe_matmul.cu's f32 kernel.
    Only real rows may be read back."""
    if stack and rows is None:
        raise ValueError("moe_grouped_stack: the full-stack route takes each tile's "
                         "real rows (tile_rows)")
    if xp.is_cuda:
        return _grouped_cuda(xp, w, scale, texp, used, tm, stack, rows)
    return grouped_padded_plain(xp, w, scale, texp, tm)


def grouped_rows_strip(w_dtype: torch.dtype) -> int:
    """Columns of a grouped-rows block: 8 lane groups x one 16-byte load of
    a weight row (128 int8, 64 bf16 or 32 f32 columns)."""
    return 8 * (16 // _ESIZE[w_dtype])


def grouped_rows_plan(m: int, e: int, k: int, n: int, w_dtype: torch.dtype,
                      sm_count: int) -> int:
    """Split-K plan of the grouped-rows kernel: the 16-row steps of a
    slice. The fewest slices (each as even as whole steps allow, at least a
    step for each of the 8 warps) that give ``_GROUPED_BLOCKS_PER_SM``
    blocks to every SM, counting a block for each (strip, expert) pair the
    rows can fill: min(E, m) groups (the live ones are a device value,
    never read on the host)."""
    steps = k // _ROWS_STEP
    blocks = min(e, m) * (n // grouped_rows_strip(w_dtype))
    most = max(1, steps // _ROWS_WARPS)
    for slices in range(1, most + 1):
        per = -(-steps // slices)
        if blocks * -(-steps // per) >= _GROUPED_BLOCKS_PER_SM * sm_count:
            return per
    return -(-steps // most)


def grouped_rows_slices(k: int, steps_per_slice: int):
    """The plan's k ranges [(k0, k1)], in the order their partials are added."""
    step = steps_per_slice * _ROWS_STEP
    return [(k0, min(k0 + step, k)) for k0 in range(0, k, step)]


def _grouped_rows_cuda(xs, w, scale, gsz, name):
    m, k = xs.shape
    e, _, n = w.shape
    strip = grouped_rows_strip(w.dtype)
    if k % _ROWS_STEP or n % strip:
        raise ValueError(f"{name} kernel: k % {_ROWS_STEP} and n % {strip} must be 0 "
                         f"(got k={k}, n={n})")
    xs = xs.contiguous()
    gsz = gsz.to(device=xs.device, dtype=torch.int64).contiguous()
    tensors = [xs, w, gsz]
    if scale is not None:
        scale = scale.float().contiguous()
        tensors.append(scale)
    kernels.require_cuda(name, *tensors)
    per = grouped_rows_plan(m, e, k, n, w.dtype, kernels.sm_count(xs.device.index))
    slices = -(-(k // _ROWS_STEP) // per)
    partial = tickets = None
    if slices > 1:
        partial = torch.empty((slices, m, n), dtype=torch.float32, device=xs.device)
        tickets = kernels.ticket_words(_GROUPED_TICKETS, xs.device, e * (n // strip))
    out = torch.empty((m, n), dtype=xs.dtype, device=xs.device)
    err = kernels.lib().rk_moe_grouped_rows(
        xs.data_ptr(), w.data_ptr(), scale.data_ptr() if scale is not None else None,
        gsz.data_ptr(), m, e, k, n, per, _W_CODES[w.dtype],
        None if partial is None else partial.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out.data_ptr(),
        kernels.stream_handle(xs.device))
    kernels.check(err, name)
    # bf16 stacks (serving) and f32 stacks (a train step's master weights)
    # count apart from int8 ones
    kernels.count(name, {torch.bfloat16: "w=bf16", torch.float32: "w=f32"}.get(w.dtype))
    return out


def grouped_rows(xs: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                 gsz: torch.Tensor, name: str = "moe_grouped") -> torch.Tensor:
    """The grouped-rows kernel (bf16 rows): xs (m, k) sorted by expert as
    they lie, ``gsz[e]`` rows for expert e (summing to m, on the device),
    no padded copy; counted under ``name``. On the CPU its plain version
    over the plan's k slices on an H100's SMs, added in the same order."""
    if xs.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the grouped-rows kernel takes bf16 rows, got {xs.dtype}")
    if xs.is_cuda:
        return _grouped_rows_cuda(xs, w, scale, gsz, name)
    m, k = xs.shape
    e, _, n = w.shape
    per = grouped_rows_plan(m, e, k, n, w.dtype, PLAN_SMS)
    return moe_grouped_matmul_plain(xs, w, gsz, scale, grouped_rows_slices(k, per))


def rows_kernel_takes(tm: int, k: int, n: int, x_dtype: torch.dtype,
                      w_dtype: torch.dtype, stack: bool) -> bool:
    """True when a kernel-route grouped call runs the grouped-rows kernel:
    bf16 rows, unless the full-stack route's call is csrc/moe_stack.cu's."""
    return x_dtype == torch.bfloat16 and not (
        stack and stack_kernel_takes(tm, k, n, x_dtype, w_dtype))


def grouped_kernel_call(xs: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                        gsz: torch.Tensor, tm: int, stack: bool) -> torch.Tensor:
    """One kernel-route call of the grouped GEMM, counted under ``stack``'s
    route (#12 ``moe_grouped_stack`` or #11 ``moe_grouped``). bf16 rows run
    the grouped-rows kernel on the rows as they lie, unless the full-stack
    route's call is csrc/moe_stack.cu's (``stack_kernel_takes``); that one
    and f32 rows take the padded layout of ``tm``-row tiles
    (``scatter_layout``), the stack kernel each tile's real rows
    (``tile_rows``)."""
    e, k, n = w.shape
    if rows_kernel_takes(tm, k, n, xs.dtype, w.dtype, stack):
        # dx's transposed stacks: the grouped-rows kernel reads (E, k, n)
        return grouped_rows(xs, w.contiguous(), scale, gsz,
                            "moe_grouped_stack" if stack else "moe_grouped")
    xp, dst, texp, used = scatter_layout(xs, gsz, tm, e)
    rows = tile_rows(gsz, texp, tm) if stack else None
    return grouped_padded(xp, w, scale, texp, used, tm, stack=stack,
                          rows=rows).index_select(0, dst)


def _grouped_chunk(xs, w, scale, gsz, tm, no_stack):
    e, k, n = w.shape
    st = None if no_stack else stack_tiles(_padded_rows(xs.shape[0], e, tm), e, k, n,
                                           w.element_size(), xs.element_size())
    return grouped_kernel_call(xs, w, scale, gsz, tm, stack=st is not None)


def _grouped_forward(xs, w, scale, gsz, tm, mp_cap, no_stack):
    """Chunk rows so each call's padded strip stays within ``mp_cap`` rows;
    a chunk's group sizes are each group's overlap with its row window
    (rows stay sorted, so chunks stay grouped)."""
    m = xs.shape[0]
    chunk = max(tm, mp_cap - w.shape[0] * (tm - 1))
    if m <= chunk:
        return _grouped_chunk(xs, w, scale, gsz, tm, no_stack)
    gsz = gsz.to(device=xs.device, dtype=torch.int64)
    csum = torch.cumsum(gsz, 0)
    outs = []
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        g_hi = torch.clamp(csum, lo, hi)
        g_lo = torch.clamp(csum - gsz, lo, hi)
        outs.append(_grouped_chunk(xs[lo:hi], w, scale, g_hi - g_lo, tm, no_stack))
    return torch.cat(outs, dim=0)


def grouped_weight_grad_plain(xs: torch.Tensor, dy: torch.Tensor, gsz: torch.Tensor,
                              e: int) -> torch.Tensor:
    """Plain PyTorch version of dw (the JAX package's XLA einsum):
    ``"me,mk,mn->ekn"`` over each row's one-hot group (rows past the groups
    in none), f32 products and sums → (E, k, n) f32. Every expert
    multiplies every row: E times the routed FLOPs."""
    csum = torch.cumsum(gsz.to(device=xs.device, dtype=torch.int64), 0)
    eid = torch.searchsorted(csum, torch.arange(xs.shape[0], device=xs.device), right=True)
    mask = (eid[:, None] == torch.arange(e, device=xs.device)).float()
    return torch.einsum("me,mk,mn->ekn", mask, xs.float(), dy.float())


def wgrad_kernel_takes(k: int, n: int, x_dtype: torch.dtype) -> bool:
    """True when csrc/moe_wgrad.cu takes dw: bf16 rows and gradients, k and
    n in 128-wide tiles."""
    return x_dtype == torch.bfloat16 and k % _WGRAD_TILE == 0 and n % _WGRAD_TILE == 0


def wgrad_grid(e: int, k: int, n: int) -> Tuple[int, int, int]:
    """The dw kernel's blocks: (n tiles, k tiles, experts), one (128 x 128)
    output tile of one expert each, n tiles fastest."""
    return (n // _WGRAD_TILE, k // _WGRAD_TILE, e)


def _wgrad_cuda(xs, dy, gsz, e):
    m, k = xs.shape
    n = dy.shape[1]
    if not wgrad_kernel_takes(k, n, xs.dtype) or dy.dtype != xs.dtype:
        raise ValueError(f"moe_grouped_wgrad kernel: bf16 rows and gradients, k % "
                         f"{_WGRAD_TILE} and n % {_WGRAD_TILE} == 0 (got {xs.dtype} / "
                         f"{dy.dtype}, k={k}, n={n})")
    xs = xs.contiguous()
    dy = dy.contiguous()
    gsz = gsz.to(device=xs.device, dtype=torch.int32).contiguous()
    kernels.require_cuda("moe_grouped_wgrad", xs, dy, gsz)
    dw = torch.empty((e, k, n), dtype=torch.float32, device=xs.device)
    err = kernels.lib().rk_moe_grouped_wgrad(xs.data_ptr(), dy.data_ptr(), gsz.data_ptr(),
                                              e, k, n, *wgrad_grid(e, k, n), dw.data_ptr(),
                                              kernels.stream_handle(xs.device))
    kernels.check(err, "moe_grouped_wgrad")
    kernels.count("moe_grouped_wgrad")
    return dw


def grouped_weight_grad(xs: torch.Tensor, dy: torch.Tensor, gsz: torch.Tensor,
                        e: int) -> torch.Tensor:
    """dw of the grouped GEMM, (E, k, n) f32: each expert's rows of xs
    against the same rows of dy, f32 sums; rows past the groups in none.
    CUDA tensors launch csrc/moe_wgrad.cu (counted as
    ``moe_grouped_wgrad``: the routed products only, the group sizes read on
    the device), CPU tensors take ``grouped_weight_grad_plain``."""
    if xs.is_cuda:
        return _wgrad_cuda(xs, dy, gsz, e)
    return grouped_weight_grad_plain(xs, dy, gsz, e)


class GroupedKernelPath(torch.autograd.Function):
    """The kernel route of ``moe_grouped_matmul`` over float experts, with
    the JAX package's custom VJP: dx through the same route on the stacks'
    transposed view (the stack kernel's dx orientation reads them as they
    lie; other kernels take a contiguous copy), dw from
    ``grouped_weight_grad`` in w's dtype."""

    @staticmethod
    def forward(ctx, xs, w, gsz, tm: int, mp_cap: int, no_stack: bool):
        ctx.save_for_backward(xs, w, gsz)
        return _grouped_forward(xs, w, None, gsz, tm, mp_cap, no_stack)

    @staticmethod
    def backward(ctx, dy):
        xs, w, gsz = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = moe_grouped_matmul(dy, w.transpose(1, 2), gsz).to(xs.dtype)
        if ctx.needs_input_grad[1]:
            dw = grouped_weight_grad(xs, dy, gsz, w.shape[0]).to(w.dtype)
        return dx, dw, None, None, None, None


def moe_grouped_matmul(xs: torch.Tensor, w: torch.Tensor, gsz: torch.Tensor,
                       scale: Optional[torch.Tensor] = None, tm: int = 0,
                       tile_k: int = 0, tile_n: int = 0,
                       no_stack: bool = False) -> torch.Tensor:
    """Grouped GEMM: rows of ``xs`` sorted by expert, ``gsz[e]`` rows for
    expert e, ``out[i] = xs[i] @ dequant(w[expert_of(i)])``.

    xs (M, k); w (E, k, n) int8 with scale (E, n), or float with scale
    None; gsz (E,) summing to M. Routes as the JAX package does: the
    fallback when k or n does not tile (or ``tile_k``/``tile_n`` say so) or
    M < tm/2; otherwise the kernel, chunked, on the full-stack route (#12)
    unless ``no_stack`` or the JAX stack tiles do not fit, else the
    per-tile route (#11). ``no_stack`` is the batched-decode dedup route:
    only the routed experts' bytes are read (``grouped_kernel_call`` says
    which kernel takes a call). Float experts with a gradient asked for
    take the kernel route through ``GroupedKernelPath``; the fallback is
    plain PyTorch and differentiable as it stands."""
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
    if scale is None and torch.is_grad_enabled() and (xs.requires_grad or w.requires_grad):
        return GroupedKernelPath.apply(xs, w, gsz, tm, mp_cap, no_stack)
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


def int4_gather_plan(slots: int, k: int, n: int, tile_k: int, group: int,
                     sm_count: int) -> int:
    """The gather's split-K slice on the decode kernels, in packed rows:
    ``int4_decode_plan`` for one x row, its strips times the slots counting
    towards its blocks an SM (each slot is a block of its own); each k-tile
    is cut as ``int4_decode_slices`` cuts it."""
    return int4_decode_plan(1, k, n, tile_k, group, sm_count, row_blocks=slots)


def _gather_int4_cuda(x, w_p, gscale, ids, tile_k, group):
    s_slots, k = x.shape
    n = w_p.shape[2]
    if n % 256:
        raise ValueError(f"moe_gather_int4 kernel: n % 256 == 0 (got n={n})")
    x = x.contiguous()
    ids = ids.to(torch.int32).contiguous()
    gscale = gscale.float().contiguous()
    kernels.require_cuda("moe_gather_int4", x, w_p, gscale, ids)
    out = torch.empty((s_slots, n), dtype=x.dtype, device=x.device)
    if n % INT4_TILE_N == 0 and int4_decode_viable(1, tile_k, group):
        ks = int4_gather_plan(s_slots, k, n, tile_k, group, kernels.sm_count(x.device.index))
        slices = k // tile_k * -(-(tile_k // 2) // ks)   # len(int4_decode_slices(...))
        partial = torch.empty((slices, s_slots, n) if slices > 1 else (0,),
                              dtype=torch.float32, device=x.device)
        err = kernels.lib().rk_moe_gather_int4_decode(
            x.data_ptr(), w_p.data_ptr(), gscale.data_ptr(), ids.data_ptr(), s_slots, k, n,
            tile_k, group, ks, kernels.dtype_code(x.dtype),
            int(int4_decode_tensor_cores(tile_k, group, ks, x.dtype)), partial.data_ptr(),
            out.data_ptr(), kernels.stream_handle(x.device))
    else:
        ks = int4_slice_for(k, tile_k, n, s_slots, _target_blocks(x.device.index))
        partial = torch.empty((k // 2 // ks, s_slots, n), dtype=torch.float32,
                              device=x.device)
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
