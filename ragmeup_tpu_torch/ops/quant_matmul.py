"""Weight-quantized matmuls: the CUDA kernels and their plain versions.

Counterpart of ``ragmeup_tpu/ops/quant_matmul.py``.

``int8_matmul``: ``x (m, k) @ (w_q (k, n) int8 · scale (n,)) → (m, n)`` in
x's dtype, f32 accumulation, the per-channel scale applied after the sum. At
decode (m ≤ 8) the product is bound by reading the int8 weights once;
csrc/quant_matmul.cu streams them 16 bytes a lane with a deterministic
split-K (``int8_matmul_plan``).

``int4_matmul``: packed int4 weights ``w_p (k/2, n)`` with group-wise scales
``gscale (k/group, n)`` (the TPU-native counterpart of the reference's 4-bit
nf4). Packing is per k-tile of ``tile_k`` rows (``int4_tiling``): byte j of
a tile holds row j in its low nibble and row j + tile_k/2 in its high
nibble. Routing by shape is the JAX package's, each route with its own
rounding (csrc/quant_matmul_int4.cu):

- W4A8 (``a8`` and group == tile_k): x quantized per row to int8 over all
  of k, int32 dots per k-tile, ``float(p) * x_scale * tile_scale`` summed
  over the tiles in order;
- W4A16 output-scaled (group == tile_k): per k-tile f32 dot of x with the
  unscaled integers, times the tile's scale;
- W4A16 quality (group < tile_k): each weight dequantized in f32 and
  rounded to x's dtype, then an f32 dot;
- shapes that do not tile (n % 512, m > 256): unpack, dequantize in x's
  dtype and ``torch.matmul``, outside any kernel as in the JAX package.

``fused_mlp_int4``: ``x + down(silu(gate(rms(x))) * up(rms(x)))`` over packed
int4 weights for at most 8 rows (csrc/fused_mlp_int4.cu), the JAX package's
fused MLP. Like there, nothing in the port calls it: it is a building block.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.ops.topk import divide_exactly, quantize_int8

MAX_ROWS = 8
# csrc/quant_matmul.cu: 8 warps a block, 16 columns a lane (512 a block), x's
# slice staged as f32 in at most 12288 floats of shared memory
_INT8_COLS_PER_BLOCK = 512
_INT8_ROW_STEP = 64          # 8 warps x one 8-row batch each
_INT8_XS_FLOATS = 12288
_INT8_BLOCKS_PER_SM = 2


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 product, scale, cast."""
    acc = x.float() @ w_q.float()
    return (acc * scale.float()[None, :]).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _target_blocks(device_index: int) -> int:
    """Two blocks per SM of the card the kernel launches on."""
    return 2 * torch.cuda.get_device_properties(device_index).multi_processor_count


def int8_matmul_plan(m: int, k: int, n: int, sm_count: int) -> int:
    """#3's split-K plan: the k rows of one block's slice (slice i covers
    rows ``[i * k_slice, min(k, (i + 1) * k_slice))``). The 512-column
    strips alone give too few blocks at every 8B decode shape, so k is cut
    into as few slices as give ``_INT8_BLOCKS_PER_SM`` blocks on every SM,
    each a whole number of the 8 warps' 8-row batches (which may round to
    fewer slices), and no longer than x's staging buffer holds at m rows
    (rounded up to 1, 2, 4 or 8)."""
    strips = -(-n // _INT8_COLS_PER_BLOCK)
    step = _INT8_ROW_STEP
    x_rows = 1 << (max(m, 1) - 1).bit_length()
    cap = max(step, _INT8_XS_FLOATS // x_rows // step * step)
    slices = max(1, -(-_INT8_BLOCKS_PER_SM * sm_count // strips))
    k_slice = -(-k // slices)
    return min(-(-k_slice // step) * step, cap)


def int8_slices(k: int, k_slice: int):
    """[(k0, k1)] of each slice in slice order, as the kernel cuts k."""
    return [(k0, min(k, k0 + k_slice)) for k0 in range(0, k, k_slice)]


def _int8_matmul_cuda(x, w_q, scale):
    m, k = x.shape
    n = w_q.shape[1]
    if m > MAX_ROWS:
        raise ValueError(f"int8_matmul kernel takes at most {MAX_ROWS} rows, got {m}")
    if w_q.dtype != torch.int8 or n % 16:
        raise ValueError(f"int8_matmul kernel: w_q int8 with n % 16 == 0 "
                         f"(got {w_q.dtype}, n={n})")
    x = x.contiguous()
    scale = scale.float().contiguous()
    kernels.require_cuda("int8_matmul", x, w_q, scale)
    ks = int8_matmul_plan(m, k, n, kernels.sm_count(x.device.index))
    slices = -(-k // ks)
    partial = torch.empty((slices, m, n) if slices > 1 else (0,),
                          dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = kernels.lib().rk_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), m, k, n, ks,
        kernels.dtype_code(x.dtype), partial.data_ptr(), out.data_ptr(),
        kernels.stream_handle(x.device))
    kernels.check(err, "int8_matmul")
    kernels.count("int8_matmul")
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """x (m, k) bf16/f32 @ (w_q (k, n) int8 · scale (n,)) → (m, n) x.dtype.

    CUDA tensors launch the kernel (m ≤ 8); CPU tensors take the plain
    version."""
    if x.shape[1] != w_q.shape[0] or scale.numel() != w_q.shape[1]:
        raise ValueError(f"int8_matmul shapes: x {tuple(x.shape)}, "
                         f"w {tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    if x.is_cuda:
        return _int8_matmul_cuda(x, w_q, scale)
    return int8_matmul_plain(x, w_q, scale)


# ---------------------------------------------------------------------------
# Packed int4 with group-wise scales
# ---------------------------------------------------------------------------

INT4_MAX_ROWS = 256   # the JAX routing bound; csrc loops over 8-row groups
INT4_TILE_N = 512     # n must be a multiple of this for the kernels


def int4_tiling(k: int) -> Tuple[int, int]:
    """(tile_k, default group) for an input dim k; shared by the packer, the
    kernels and the fallback."""
    tile_k = 512 if k % 512 == 0 else k
    group = 128 if tile_k % 128 == 0 else tile_k
    return tile_k, group


def int4_group_for(tile_k: int, requested: int) -> int:
    """Largest scale group <= ``requested`` that divides ``tile_k`` (a 512
    request on a 768-wide tile walks down to 256)."""
    g = min(requested, tile_k)
    while g > 1 and tile_k % g:
        g //= 2
    return max(g, 1)


def pack_int4(q: torch.Tensor, tile_k: int) -> torch.Tensor:
    """(k, n) int8 values in [-8, 7] → (k/2, n) packed int8, per k-tile:
    low nibble row j, high nibble row j + tile_k/2."""
    k, n = q.shape
    if k % tile_k or tile_k % 2:
        raise ValueError(f"pack_int4: k={k}, tile_k={tile_k}")
    t = q.reshape(k // tile_k, tile_k, n).to(torch.int32)
    lo, hi = t[:, :tile_k // 2], t[:, tile_k // 2:]
    packed = ((hi & 0xF) << 4) | (lo & 0xF)           # 0..255
    return packed.to(torch.uint8).view(torch.int8).reshape(k // 2, n)


def unpack_int4(w_p: torch.Tensor, tile_k: int) -> torch.Tensor:
    """Inverse of ``pack_int4`` → (k, n) int8 in [-8, 7]."""
    k2, n = w_p.shape
    k = 2 * k2
    b = w_p.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8                          # sign-extend the nibble
    hi = b >> 4                                       # arithmetic shift
    tiles = k // tile_k
    return torch.cat([lo.reshape(tiles, tile_k // 2, n),
                      hi.reshape(tiles, tile_k // 2, n)], dim=1
                     ).reshape(k, n).to(torch.int8)


def quantize_int4_groupwise(w: torch.Tensor, group: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, n) float → (packed (k/2, n) int8, gscale (k/group, n) f32),
    symmetric int4 per (group of input rows, output column), computed where
    w lives. ``group`` resolves as the decoder's parameter shapes do
    (``int4_group_for``); the default is ``int4_tiling``'s."""
    k, n = w.shape
    tile_k, auto_group = int4_tiling(k)
    group = int4_group_for(tile_k, group or auto_group)
    wg = w.float().reshape(k // group, group, n)
    scale = divide_exactly(torch.clamp_min(wg.abs().amax(dim=1, keepdim=True), 1e-8), 7.0)
    q = torch.clamp(torch.round(wg / scale), -8, 7).to(torch.int8)
    return pack_int4(q.reshape(k, n), tile_k), scale[:, 0, :]


def _int4_tiles(x: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor):
    m, k = x.shape
    tile_k, _ = int4_tiling(k)
    return m, k, w_p.shape[1], tile_k, k // gscale.shape[0]


def _tile_products(xf: torch.Tensor, q: torch.Tensor, tile_k: int) -> torch.Tensor:
    """(tiles, m, n) f32 products of each k-tile of xf (m, k) with the same
    rows of q (k, n)."""
    m, k = xf.shape
    tiles = k // tile_k
    return torch.bmm(xf.reshape(m, tiles, tile_k).transpose(0, 1),
                     q.reshape(tiles, tile_k, q.shape[1]))


def _add_in_tile_order(contrib: torch.Tensor) -> torch.Tensor:
    """acc = 0; acc + contrib[0] + contrib[1] + ..., one f32 rounding per
    tile in order, as the kernels' epilogues add them."""
    acc = torch.zeros_like(contrib[0])
    for part in contrib:
        acc = acc + part
    return acc


def int4_matmul_plain(x: torch.Tensor, w_p: torch.Tensor,
                      gscale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the W4A16 kernel, with its route's rounding:
    output-scaled (group == tile_k) sums x times the unscaled integers per
    k-tile in f32 and adds each tile's partial times its scale, in tile
    order; quality (group < tile_k) rounds each dequantized weight to x's
    dtype and sums in f32."""
    m, k, n, tile_k, group = _int4_tiles(x, w_p, gscale)
    q = unpack_int4(w_p, tile_k).float()
    if group == tile_k:
        part = _tile_products(x.float(), q, tile_k) * gscale.float()[:, None, :]
        return _add_in_tile_order(part).to(x.dtype)
    srep = gscale.float().repeat_interleave(group, dim=0)
    wd = (q * srep).to(x.dtype).float()
    return (x.float() @ wd).to(x.dtype)


def int4_matmul_a8_plain(x: torch.Tensor, w_p: torch.Tensor,
                         gscale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the W4A8 kernel (group == tile_k): x
    quantized per row over all of k (``quantize_int8`` in f32), per k-tile
    p = x_i8 · q (exact in f32: |p| ≤ tile_k · 127 · 8 < 2^24), then
    ``acc + float(p) * x_scale * tile_scale`` over the tiles in order."""
    m, k, n, tile_k, group = _int4_tiles(x, w_p, gscale)
    if group != tile_k:
        raise ValueError(f"W4A8 needs group == tile_k ({group} != {tile_k})")
    xq, xs = quantize_int8(x.float(), axis=1)                # (m, k), (m, 1)
    p = _tile_products(xq.float(), unpack_int4(w_p, tile_k).float(), tile_k)
    return _add_in_tile_order(p * xs[None] * gscale.float()[:, None, :]).to(x.dtype)


def _int4_matmul_dequant(x: torch.Tensor, w_p: torch.Tensor,
                         gscale: torch.Tensor) -> torch.Tensor:
    """The route for shapes no kernel takes: unpack, dequantize in x's dtype
    (scales cast first, as the JAX fallback does) and multiply."""
    m, k, n, tile_k, group = _int4_tiles(x, w_p, gscale)
    w = unpack_int4(w_p, tile_k).to(x.dtype)
    s = gscale.to(x.dtype).repeat_interleave(group, dim=0)
    return x @ (w * s)


def int4_slice_for(k: int, tile_k: int, n: int, row_groups: int,
                   target_blocks: int) -> int:
    """Split-K slice of the int4 kernels in packed rows: a divisor of
    tile_k/2 (a slice never crosses a k-tile, whose scale it applies), the
    longest that still gives ``target_blocks`` blocks, at least 16 where
    tile_k/2 has such a divisor."""
    half = tile_k // 2
    divisors = [s for s in range(min(half, 256), 0, -1) if half % s == 0]
    usable = [s for s in divisors if s >= 16] or divisors[:1]
    col_blocks = -(-n // INT4_TILE_N)
    for s in usable:
        if col_blocks * row_groups * (k // 2 // s) >= target_blocks:
            return s
    return usable[-1]


def _int4_cuda(x, w_p, gscale, a8: bool):
    m, k, n, tile_k, group = _int4_tiles(x, w_p, gscale)
    name = "int4_matmul_a8" if a8 else "int4_matmul"
    if w_p.dtype != torch.int8 or gscale.dtype != torch.float32:
        raise ValueError(f"{name} kernel: w_p int8 and gscale float32 "
                         f"(got {w_p.dtype}, {gscale.dtype})")
    x = x.contiguous()
    kernels.require_cuda(name, x, w_p, gscale)
    row_groups = math.ceil(m / 8)
    ks = int4_slice_for(k, tile_k, n, row_groups, _target_blocks(x.device.index))
    slices = k // 2 // ks
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = kernels.stream_handle(x.device)
    lib = kernels.lib()
    if a8:
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
        xs = torch.empty(m, dtype=torch.float32, device=x.device)
        partial = torch.empty((slices, m, n), dtype=torch.int32, device=x.device)
        err = lib.rk_int4_matmul_a8(
            x.data_ptr(), w_p.data_ptr(), gscale.data_ptr(), m, k, n, tile_k, ks,
            kernels.dtype_code(x.dtype), xq.data_ptr(), xs.data_ptr(),
            partial.data_ptr(), out.data_ptr(), stream)
    else:
        partial = torch.empty((slices, m, n), dtype=torch.float32, device=x.device)
        err = lib.rk_int4_matmul(
            x.data_ptr(), w_p.data_ptr(), gscale.data_ptr(), m, k, n, tile_k,
            group, ks, kernels.dtype_code(x.dtype), partial.data_ptr(),
            out.data_ptr(), stream)
    kernels.check(err, name)
    kernels.count(name)
    return out


def int4_matmul(x: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor,
                a8: bool = False) -> torch.Tensor:
    """x (m, k) bf16/f32 @ dequant(w_p (k/2, n), gscale (k/group, n)) →
    (m, n) in x's dtype; the group is read from gscale's shape.

    Routes by shape as the JAX package does: ``a8`` with group == tile_k,
    n % 512 == 0 and m ≤ 256 → W4A8; else n % 512 == 0, m ≤ 256 and a group
    dividing tile_k → W4A16; else the dequantize fallback. On a kernel
    route CUDA tensors launch the kernel and CPU tensors take its plain
    version."""
    m, k, n, tile_k, group = _int4_tiles(x, w_p, gscale)
    if w_p.shape[0] * 2 != k or gscale.shape[1] != n or k % gscale.shape[0]:
        raise ValueError(f"int4_matmul shapes: x {tuple(x.shape)}, "
                         f"w_p {tuple(w_p.shape)}, gscale {tuple(gscale.shape)}")
    tiles = n % INT4_TILE_N == 0 and m <= INT4_MAX_ROWS   # (k tiles by construction)
    if a8 and group == tile_k and tiles:
        if x.is_cuda:
            return _int4_cuda(x, w_p, gscale, a8=True)
        return int4_matmul_a8_plain(x, w_p, gscale)
    if tiles and tile_k % group == 0:
        if x.is_cuda:
            return _int4_cuda(x, w_p, gscale, a8=False)
        return int4_matmul_plain(x, w_p, gscale)
    return _int4_matmul_dequant(x, w_p, gscale)


# ---------------------------------------------------------------------------
# Fused int4 MLP (#6)
# ---------------------------------------------------------------------------

def _mlp_int4_shapes(x, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d, tile_i):
    """(m, h, inter, tile_k, group_h, group_i): the groups come from
    ``int4_tiling`` alone, as the JAX function takes them."""
    m, h = x.shape
    inter = wg_p.shape[1]
    tile_k, group_h = int4_tiling(h)
    group_i = int4_tiling(inter)[1]
    want = {"wg_p": (h // 2, inter), "wu_p": (h // 2, inter), "wd_p": (inter // 2, h),
            "gs_g": (h // group_h, inter), "gs_u": (h // group_h, inter),
            "gs_d": (inter // group_i, h)}
    got = {"wg_p": wg_p, "wu_p": wu_p, "wd_p": wd_p, "gs_g": gs_g, "gs_u": gs_u,
           "gs_d": gs_d}
    bad = {k: tuple(t.shape) for k, t in got.items() if tuple(t.shape) != want[k]}
    if bad or h % tile_k or inter % tile_i or tile_i % group_i:
        raise ValueError(f"fused_mlp_int4 shapes: x {tuple(x.shape)}, tile_i {tile_i}, "
                         f"expected {want}, got {bad}")
    return m, h, inter, tile_k, group_h, group_i


def fused_mlp_int4_plain(x: torch.Tensor, norm_w: torch.Tensor, wg_p: torch.Tensor,
                         gs_g: torch.Tensor, wu_p: torch.Tensor, gs_u: torch.Tensor,
                         wd_p: torch.Tensor, gs_d: torch.Tensor, rms_eps: float = 1e-5,
                         tile_i: int = 512) -> torch.Tensor:
    """Plain PyTorch version of the fused MLP kernel: RMSNorm in f32 rounded
    to x's dtype; gate and up as f32 sums over weights dequantized in f32
    and rounded to x's dtype (at every group size); ``silu(g) * u`` rounded
    to x's dtype; down as an f32 sum; ``x + down`` in f32, rounded once."""
    m, h, inter, tile_k, group_h, group_i = _mlp_int4_shapes(
        x, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d, tile_i)
    dt = x.dtype

    def dequant(w_p, gs, tile, group):
        w = unpack_int4(w_p, tile).float() * gs.float().repeat_interleave(group, dim=0)
        return w.to(dt).float()
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xn = (xf * torch.rsqrt(var + rms_eps) * norm_w.float()).to(dt).float()
    g = xn @ dequant(wg_p, gs_g, tile_k, group_h)
    u = xn @ dequant(wu_p, gs_u, tile_k, group_h)
    act = (torch.nn.functional.silu(g) * u).to(dt).float()
    return (xf + act @ dequant(wd_p, gs_d, tile_i, group_i)).to(dt)


def _fused_mlp_int4_cuda(x, norm_w, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d, rms_eps, tile_i):
    m, h, inter, tile_k, group_h, group_i = _mlp_int4_shapes(
        x, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d, tile_i)
    if m > MAX_ROWS or h % 64 or inter % 128:
        raise ValueError(f"fused_mlp_int4 kernel: m <= {MAX_ROWS}, h % 64 == 0 and "
                         f"inter % 128 == 0 (got m={m}, h={h}, inter={inter})")
    x = x.contiguous()
    nw = norm_w.float().contiguous()
    scales = [t.float().contiguous() for t in (gs_g, gs_u, gs_d)]
    packed = (wg_p, wu_p, wd_p)
    if any(t.dtype != torch.int8 for t in packed):
        raise ValueError("fused_mlp_int4 kernel: packed weights must be int8")
    kernels.require_cuda("fused_mlp_int4", x, nw, *packed, *scales)
    act = torch.empty((m, inter), dtype=x.dtype, device=x.device)
    out = torch.empty((m, h), dtype=x.dtype, device=x.device)
    err = kernels.lib().rk_fused_mlp_int4(
        x.data_ptr(), nw.data_ptr(), wg_p.data_ptr(), scales[0].data_ptr(),
        wu_p.data_ptr(), scales[1].data_ptr(), wd_p.data_ptr(), scales[2].data_ptr(),
        m, h, inter, tile_k, group_h, tile_i, group_i, rms_eps,
        kernels.dtype_code(x.dtype), act.data_ptr(), out.data_ptr(),
        kernels.stream_handle(x.device))
    kernels.check(err, "fused_mlp_int4")
    kernels.count("fused_mlp_int4")
    return out


def fused_mlp_int4(x: torch.Tensor, norm_w: torch.Tensor, wg_p: torch.Tensor,
                   gs_g: torch.Tensor, wu_p: torch.Tensor, gs_u: torch.Tensor,
                   wd_p: torch.Tensor, gs_d: torch.Tensor, rms_eps: float = 1e-5,
                   tile_i: int = 512) -> torch.Tensor:
    """x (m, h) → ``x + down(silu(gate(rms(x))) * up(rms(x)))`` with packed
    int4 weights: gate/up (h/2, inter) with scales (h/group_h, inter), down
    (inter/2, h) packed per ``tile_i`` rows with scales (inter/group_i, h),
    the groups ``int4_tiling``'s. CUDA tensors launch the kernel (m ≤ 8);
    CPU tensors take its plain version."""
    if x.is_cuda:
        return _fused_mlp_int4_cuda(x, norm_w, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d,
                                    rms_eps, tile_i)
    return fused_mlp_int4_plain(x, norm_w, wg_p, gs_g, wu_p, gs_u, wd_p, gs_d,
                                rms_eps, tile_i)
