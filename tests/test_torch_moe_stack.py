"""The full-stack grouped expert GEMM (#12, csrc/moe_stack.cu
``rk_moe_grouped_stack``), held on the CPU.

The kernel runs only on the card; what surrounds it is held here. The
wrapper's route rule (shapes and dtypes only) sends each call to its C
entry with the right arguments (a stand-in library records them). Each
tile's count of real rows (``tile_rows``, made on the device from the group
sizes) equals the count read off the JAX package's ``_scatter_layout``.
The persistent grid's walk (strips fastest) visits every (tile, strip) pair
below the used rows once. The kernel's int8 -> bf16 conversion (two
LOP3s and one bf16 subtraction a pair, ``s8x2_bf16x2``), emulated bit for
bit, is exact for all 256 bytes; its wgmma A fragments, emulated from
ldmatrix.trans of the staged weight tile, hold the columns its epilogue
writes them to; x's stage tile holds each element where the B descriptor
reads it (128-byte swizzle, emulated). A torch model of the kernel's tiling (the transposed
product a warpgroup per 64 columns, over the tile's real rows rounded up to
32 with x's padding rows read as zeros, 64-deep stages of four 16-deep
products in k order, the f32 scale, one rounding, only real rows stored)
agrees on every real row with ``grouped_padded_plain`` and with JAX's
``_grouped_stack_call`` in interpret mode, int8 and bf16 experts, within
one bf16 ulp of the largest output (each side sums in f32 in its own order
and rounds once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.ops import moe_matmul as jmoe
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.ops import moe_matmul as moe
from test_torch_kernel_plans import H100_SMS, _EntryRecorder
from test_torch_moe_int4 import _close
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

TM, BN, BK = 128, 128, 64
GROUPS = {
    "ragged": [100, 180, 90, 150, 120, 132, 160, 100],
    "edges": [128, 0, 1, 255, 17, 384, 130, 117],
    "one expert": [0, 0, 0, 0, 0, 0, 0, 300],
    "multiples": [128, 256, 0, 128, 384, 0, 0, 128],
    "one row": [0, 0, 0, 1, 0, 0, 0, 0],
}


# ---------------------------------------------------------------------------
# route rule and arguments
# ---------------------------------------------------------------------------

# (x dtype, experts, tm, stack, k, n, C entry, counter)
ROUTES = {
    "int8 stack": (torch.bfloat16, torch.int8, 128, True, 1024, 512,
                   "rk_moe_grouped_stack", "moe_grouped_stack"),
    "bf16 experts stack": (torch.bfloat16, torch.bfloat16, 128, True, 1024, 512,
                           "rk_moe_grouped_stack", "moe_grouped_stack"),
    "int8 stack, k tail": (torch.bfloat16, torch.int8, 128, True, 1152, 256,
                           "rk_moe_grouped_stack", "moe_grouped_stack"),
    "f32 experts stack": (torch.bfloat16, torch.float32, 128, True, 1024, 512,
                          "rk_moe_grouped_stack", "moe_grouped_stack"),
    "f32 rows stack": (torch.float32, torch.int8, 128, True, 1024, 512,
                       "rk_moe_grouped", "moe_grouped_stack"),
    "stack at tm 64": (torch.bfloat16, torch.int8, 64, True, 1024, 512,
                       "rk_moe_grouped_rows", "moe_grouped_stack"),
    "dedup (#11)": (torch.bfloat16, torch.int8, 16, False, 1024, 512,
                    "rk_moe_grouped_rows", "moe_grouped"),
    "dedup at tm 128": (torch.bfloat16, torch.int8, 128, False, 1024, 512,
                        "rk_moe_grouped_rows", "moe_grouped"),
    "f32 rows dedup": (torch.float32, torch.int8, 8, False, 1024, 512,
                       "rk_moe_grouped", "moe_grouped"),
}


@pytest.fixture
def library(monkeypatch):
    rec = _EntryRecorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    monkeypatch.setattr(kernels, "require_cuda", lambda *args: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda index: H100_SMS)
    kernels.reset_counts()
    yield rec
    kernels.reset_counts()


@pytest.mark.parametrize("case", list(ROUTES))
def test_grouped_wrapper_routes_by_shape_and_dtype(case, library):
    """stack with bf16 rows in 128-row tiles over int8, bf16 or f32 experts
    reaches rk_moe_grouped_stack (texp, the tiles' real rows, used, k, n,
    the experts' type, the persistent grid); other bf16 calls (other
    tiles, the dedup route) reach rk_moe_grouped_rows on the
    sorted rows (m, E, k, n, the plan's steps a slice, the experts' type);
    f32 rows reach rk_moe_grouped on the padded layout. Each call counts
    one launch under its route's counter."""
    dtype, wdtype, tm, stack, k, n, entry, counter = ROUTES[case]
    takes = stack and moe.stack_kernel_takes(tm, k, n, dtype, wdtype)
    assert takes == (entry == "rk_moe_grouped_stack")
    on_rows = moe.rows_kernel_takes(tm, k, n, dtype, wdtype, stack)
    assert on_rows == (entry == "rk_moe_grouped_rows")
    gsz = torch.tensor([130, 0, 37, 89])
    x = torch.zeros(int(gsz.sum()), k, dtype=dtype)
    w = torch.zeros(4, k, n, dtype=wdtype)
    scale = torch.ones(4, n) if wdtype == torch.int8 else None
    if on_rows:
        out = moe._grouped_rows_cuda(x, w, scale, gsz, counter)
        assert out.shape == (x.shape[0], n) and out.dtype == dtype
    else:
        xp, _, texp, used = moe.scatter_layout(x, gsz, tm, 4)
        rows = moe.tile_rows(gsz, texp, tm)
        out = moe._grouped_cuda(xp, w, scale, texp, used, tm, stack, rows)
        assert out.shape == (xp.shape[0], n) and out.dtype == dtype
    assert [name for name, _ in library.calls] == [entry]
    counts = kernels.launch_counts()
    assert counts[counter] == 1 and sum(counts.values()) == 1
    args = library.calls[0][1]
    if entry == "rk_moe_grouped_stack":
        mp = xp.shape[0]
        assert args[6:10] == (k, n, moe._W_CODES[wdtype],
                              moe.stack_grid(mp, n, H100_SMS, wdtype))
        assert (args[2] is None) == (scale is None)
    elif entry == "rk_moe_grouped_rows":
        per = moe.grouped_rows_plan(x.shape[0], 4, k, n, wdtype, H100_SMS)
        assert args[4:10] == (x.shape[0], 4, k, n, per, moe._W_CODES[wdtype])
        assert (args[2] is None) == (scale is None)
    else:
        assert args[5:9] == (xp.shape[0], k, n, tm)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_transposed_stacks_reach_the_dx_entry_as_they_lie(wdtype, library):
    """dx's stacks, the transposed view of (E, n, k) as they lie, reach
    rk_moe_grouped_stack_t with the stored tensor's pointer and no copy
    (k the reduction, n the output; the experts' type; the grid), counted
    as moe_grouped_stack "dx w=..."; f32 rows take csrc/moe_matmul.cu's
    kernel on a contiguous copy; int8 or a scale refuse the orientation."""
    gsz = torch.tensor([130, 0, 37, 89])
    k, n = 512, 1024
    stored = torch.zeros(4, n, k, dtype=wdtype)
    w = stored.transpose(1, 2)
    assert moe.stacks_transposed(w) and not moe.stacks_transposed(stored)
    x = torch.zeros(int(gsz.sum()), k, dtype=torch.bfloat16)
    xp, _, texp, used = moe.scatter_layout(x, gsz, TM, 4)
    rows = moe.tile_rows(gsz, texp, TM)
    out = moe._grouped_cuda(xp, w, None, texp, used, TM, True, rows)
    assert out.shape == (xp.shape[0], n)
    (name, args), = library.calls
    assert name == "rk_moe_grouped_stack_t" and args[1] == stored.data_ptr()
    assert args[5:9] == (k, n, moe._W_CODES[wdtype], moe.stack_grid(xp.shape[0], n, H100_SMS,
                                                                     wdtype))
    tag = "f32" if wdtype == torch.float32 else "bf16"
    assert kernels.variant_counts() == {f"moe_grouped_stack dx w={tag}": 1}
    library.calls.clear()
    xf, _, texp, used = moe.scatter_layout(x.float(), gsz, TM, 4)
    moe._grouped_cuda(xf, w, None, texp, used, TM, True, rows)
    (name, args), = library.calls
    assert name == "rk_moe_grouped" and args[1] != stored.data_ptr()
    with pytest.raises(ValueError, match="transposed"):
        moe._grouped_cuda(xp, w, torch.ones(4, n), texp, used, TM, True, rows)
    with pytest.raises(ValueError, match="transposed"):
        moe._grouped_cuda(xp, torch.zeros(4, n, k, dtype=torch.int8).transpose(1, 2), None,
                          texp, used, TM, True, rows)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stack_route_refuses_a_call_without_tile_rows(dtype, library):
    """The full-stack route takes each tile's real rows whichever kernel
    runs it (the stack kernel skips padding by them): a call that does not
    give them raises before any launch or plain product."""
    gsz = torch.tensor([130, 0, 37, 89])
    xp, _, texp, used = moe.scatter_layout(torch.zeros(256, 1024, dtype=dtype), gsz, TM, 4)
    with pytest.raises(ValueError, match="real rows"):
        moe.grouped_padded(xp, torch.zeros(4, 1024, 512, dtype=torch.int8), None, texp, used,
                           TM, stack=True)
    assert library.calls == [] and not any(kernels.launch_counts().values())


@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.int8),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.float32, torch.int8)])
def test_full_stack_call_hands_the_kernel_its_tile_rows(dtype, wdtype, monkeypatch):
    """moe_grouped_matmul on the full-stack route passes grouped_padded each
    tile's real rows, whichever kernel takes the call (csrc/moe_stack.cu's
    for bf16 rows, csrc/moe_matmul.cu's for f32 rows)."""
    seen = []
    real = moe.grouped_padded

    def spy(xp, w, scale, texp, used, tm, stack, rows=None):
        seen.append((stack, rows))
        return real(xp, w, scale, texp, used, tm, stack, rows)
    monkeypatch.setattr(moe, "grouped_padded", spy)
    gsz = torch.tensor([130, 0, 37, 89])
    x = torch.randn(int(gsz.sum()), 512).to(dtype)
    w = torch.randint(-127, 128, (4, 512, 512), dtype=torch.int8).to(wdtype)
    moe.moe_grouped_matmul(x, w, gsz, torch.rand(4, 512) if wdtype == torch.int8 else None)
    assert len(seen) == 1 and seen[0][0]
    _, _, texp, _ = moe.scatter_layout(x, gsz, TM, 4)
    assert torch.equal(seen[0][1], moe.tile_rows(gsz, texp, TM))


# ---------------------------------------------------------------------------
# each tile's real rows, and the persistent walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tm", [128, 16])
@pytest.mark.parametrize("groups", list(GROUPS))
def test_tile_rows_equal_the_counts_of_jax_scatter_layout(groups, tm):
    """tile_rows equals, tile by tile, the real rows JAX's _scatter_layout
    places there (its dst indices counted per tile): ragged groups, empty
    groups, one-row groups and exact multiples of the tile. Every tile
    below the used rows holds at least one real row (the kernel's walk
    covers exactly those), every later tile none."""
    gsz = np.asarray(GROUPS[groups], np.int32)
    xs = np.zeros((int(gsz.sum()), 8), np.float32)
    xp, dst, texp = jmoe._scatter_layout(jnp.asarray(xs), jnp.asarray(gsz), tm, len(gsz))
    tiles = xp.shape[0] // tm
    want = np.bincount(np.asarray(dst) // tm, minlength=tiles)
    got = moe.tile_rows(torch.from_numpy(gsz), torch.from_numpy(np.array(texp)), tm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    _, _, _, used = moe.scatter_layout(torch.from_numpy(xs), torch.from_numpy(gsz), tm,
                                       len(gsz))
    live = -(-int(used) // tm)
    assert (want[:live] > 0).all() and (want[live:] == 0).all()


def _walk(grid: int, tiles: int, strips: int) -> list:
    """The (tile, strip) pairs the kernel's blocks visit, block by block:
    item blockIdx.x, then every gridDim.x-th, strips fastest."""
    seen = []
    for block in range(grid):
        for item in range(block, tiles * strips, grid):
            seen.append((item // strips, item % strips))
    return seen


@pytest.mark.parametrize("sms", [1, 7, H100_SMS])
@pytest.mark.parametrize("mp,n", [(2048, 14336), (2048, 4096), (768, 256)])
def test_stack_walk_visits_every_pair_below_used_once(mp, n, sms):
    """The persistent grid stack_grid gives on an H100 (and on 1 and 7
    SMs) covers each (tile, strip) pair of the used tiles exactly once."""
    strips = n // BN
    grid = moe.stack_grid(mp, n, sms)
    assert 1 <= grid <= min(2 * sms, (mp // TM) * strips)
    for tiles in (1, 5, mp // TM):
        seen = _walk(grid, tiles, strips)
        assert sorted(seen) == [(t, s) for t in range(tiles) for s in range(strips)]


def test_stack_grid_on_an_h100():
    """Two blocks an SM: 264 on Mixtral's chunk (16 tiles x 112 or 32
    strips), fewer where the padded layout has fewer pairs."""
    assert moe.stack_grid(2048, 14336, H100_SMS) == 264
    assert moe.stack_grid(2048, 4096, H100_SMS) == 264
    assert moe.stack_grid(768, 256, H100_SMS) == 12
    assert moe.stack_grid(128, 128, H100_SMS) == 1


def test_stack_grid_f32_stacks_one_block_an_sm():
    """f32 experts' three 49-52 KB stages fill an SM: 132 blocks on an
    H100, bf16 and int8 keep two."""
    assert moe.stack_grid(2048, 14336, H100_SMS, torch.float32) == 132
    assert moe.stack_grid(2048, 4096, H100_SMS, torch.float32) == 132
    assert moe.stack_grid(768, 256, H100_SMS, torch.float32) == 12
    assert moe.stack_grid(2048, 4096, H100_SMS, torch.bfloat16) == 264


def _walk_by_expert(grid: int, texp, tiles: int, strips: int) -> list:
    """The f32 instantiation's walk: item i lies in its expert's run of
    tiles t0 .. t1 - 1 (texp[i // strips]'s), which holds items t0 * strips
    .. t1 * strips - 1 with the expert's tiles fastest."""
    seen = []
    for block in range(grid):
        for item in range(block, tiles * strips, grid):
            t = item // strips
            t0, t1 = t, t + 1
            while t0 > 0 and texp[t0 - 1] == texp[t]:
                t0 -= 1
            while t1 < tiles and texp[t1] == texp[t]:
                t1 += 1
            rel = item - t0 * strips
            seen.append((item, t0 + rel % (t1 - t0), rel // (t1 - t0)))
    return seen


@pytest.mark.parametrize("groups", list(GROUPS))
def test_f32_walk_takes_an_experts_tiles_together(groups):
    """On each group-size set of GROUPS (scatter_layout's texp at 128-row
    tiles, 3 and 112 strips, grids of 1, 7 and 132): every (tile, strip)
    pair below the used rows once, and the items of one strip of one expert
    consecutive, so its tiles read a weight strip together."""
    gsz = torch.tensor(GROUPS[groups])
    _, _, texp, used = moe.scatter_layout(torch.zeros(int(gsz.sum()), 8), gsz, TM, 8)
    tiles = -(-int(used) // TM)
    texp = texp.tolist()
    for strips in (3, 112):
        for grid in (1, 7, H100_SMS):
            seen = _walk_by_expert(grid, texp, tiles, strips)
            assert sorted((t, s) for _, t, s in seen) == [
                (t, s) for t in range(tiles) for s in range(strips)]
            by_item = sorted(seen)
            runs = {}
            for item, t, s in by_item:
                runs.setdefault((texp[t], s), []).append(item)
            for items in runs.values():
                assert items == list(range(items[0], items[0] + len(items)))


# ---------------------------------------------------------------------------
# the int8 -> bf16 conversion and the B fragments
# ---------------------------------------------------------------------------

def _bf16_bits(values: np.ndarray) -> np.ndarray:
    """bf16 bits (uint32) of float32 values, rounded to nearest even."""
    t = torch.from_numpy(np.asarray(values, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _s8x2_bf16x2(t: np.ndarray) -> np.ndarray:
    """csrc/moe_stack.cu s8x2_bf16x2: the bytes at bits 0-7 and 16-23 of t
    as a bf16x2, each half (0x4300 | b & 0x7f) - (0x4300 | b & 0x80) in bf16
    (the subtraction in f32, rounded to bf16 as HADD2.BF16 rounds)."""
    t = np.asarray(t, np.uint32)
    a = (t & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    b = (t & np.uint32(0x00800080)) | np.uint32(0x43004300)
    halves = [_bf16_bits(_bf16_values((a >> s) & 0xFFFF) - _bf16_values((b >> s) & 0xFFFF))
              for s in (0, 16)]
    return halves[0] | (halves[1] << np.uint32(16))


def _s8x4_bf16x2(r: np.ndarray):
    """csrc/moe_stack.cu s8x4_bf16x2: bytes (0, 2) and (1, 3)."""
    r = np.asarray(r, np.uint32)
    return _s8x2_bf16x2(r), _s8x2_bf16x2(r >> np.uint32(8))


def test_int8_to_bf16_pairs_are_exact_for_every_byte():
    """Every int8 value at every byte of a word comes out as its own bf16
    bits: bytes 0 and 2 in the even pair, 1 and 3 in the odd one."""
    values = np.arange(-128, 128, dtype=np.int32)
    want = _bf16_bits(values.astype(np.float32))
    for shift in range(4):
        words = np.roll(values.astype(np.int8), shift).view("<u4")
        even, odd = _s8x4_bf16x2(words)
        got = np.stack([even & 0xFFFF, odd & 0xFFFF, even >> 16, odd >> 16], axis=1)
        np.testing.assert_array_equal(got.reshape(-1), np.roll(want, shift))


def _row_col(row: int, int8: bool) -> int:
    """csrc/moe_stack.cu: the column of a warp's 16 that wgmma A fragment row
    `row` holds (the epilogue's col0 + 2g + q / 2 or g + 8 (q / 2))."""
    return 2 * (row % 8) + row // 8 if int8 else row


def _ldmatrix_trans(tile_bytes: np.ndarray, addrs) -> np.ndarray:
    """ldmatrix.x4.trans: lane l gives the row address addrs[l] (16 bytes) of
    matrix l // 8, row l % 8; lane 4g + c receives, of each matrix, b16
    column g of rows 2c and 2c + 1, as one register."""
    rows16 = [tile_bytes[a:a + 16].view("<u2") for a in addrs]
    regs = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for mi in range(4):
            lo = int(rows16[8 * mi + 2 * c][g])
            hi = int(rows16[8 * mi + 2 * c + 1][g])
            regs[lane, mi] = lo | (hi << 16)
    return regs


def _half(reg, hi: bool) -> float:
    return float(_bf16_values((int(reg) >> 16) if hi else (int(reg) & 0xFFFF)))


@pytest.mark.parametrize("int8", [True, False])
def test_a_fragments_hold_the_columns_the_epilogue_writes(int8):
    """One warp's A fragments for a 64-deep stage (stack_a_frags:
    ldmatrix.trans of the staged tile, rows padded 16 bytes; int8 through
    s8x4_bf16x2), laid out as mma's A (lane 4g + c: rows g, g + 8 x k 2c,
    2c + 1, 2c + 8, 2c + 9), are in each 16-deep slice the weights of the
    column _row_col names for each fragment row, in k order."""
    rng = np.random.default_rng(5)
    col0 = 64 + 32                                    # warpgroup 1, its warp 2
    ld = BN * (1 if int8 else 2) + 16
    if int8:
        w = rng.integers(-128, 128, (BK, BN)).astype(np.int8)
        raw = w.view(np.uint8)
    else:
        w = torch.randn(BK, BN).to(torch.bfloat16)
        raw = w.view(torch.int16).numpy().view(np.uint8).reshape(BK, 2 * BN)
        w = w.float().numpy()
    smem = np.zeros((BK, ld), np.uint8)
    smem[:, :raw.shape[1]] = raw
    smem = smem.reshape(-1)
    a = np.zeros((32, 4, 4), np.uint32)               # lane, slice, register
    if int8:
        for h in range(2):
            regs = _ldmatrix_trans(smem, [(h * 32 + (lane >> 3) * 8 + (lane & 7)) * ld + col0
                                          for lane in range(32)])
            for lane in range(32):
                for mi in range(4):
                    even, odd = _s8x4_bf16x2(regs[lane, mi])
                    j, lo = 2 * h + mi // 2, 2 * (mi % 2)
                    a[lane, j, lo], a[lane, j, lo + 1] = even, odd
    else:
        for j in range(4):
            a[:, j] = _ldmatrix_trans(
                smem, [(j * 16 + (lane >> 4) * 8 + (lane & 7)) * ld
                       + (col0 + ((lane >> 3) & 1) * 8) * 2 for lane in range(32)])
    for j in range(4):
        frag = np.zeros((16, 16), np.float32)         # fragment row, k
        for lane in range(32):
            g, c = lane // 4, lane % 4
            for reg, (row, k0) in enumerate(((g, 2 * c), (g + 8, 2 * c), (g, 2 * c + 8),
                                             (g + 8, 2 * c + 8))):
                frag[row, k0] = _half(a[lane, j, reg], False)
                frag[row, k0 + 1] = _half(a[lane, j, reg], True)
        for row in range(16):
            np.testing.assert_array_equal(
                frag[row], w[16 * j:16 * j + 16, col0 + _row_col(row, int8)])


def _ldmatrix(tile_bytes: np.ndarray, addrs) -> np.ndarray:
    """ldmatrix.x4 (no .trans): lane 4g + c receives, of each matrix, b16
    columns 2c and 2c + 1 of row g, as one register."""
    rows16 = [tile_bytes[a:a + 16].view("<u2") for a in addrs]
    regs = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for mi in range(4):
            row = rows16[8 * mi + g]
            regs[lane, mi] = int(row[2 * c]) | (int(row[2 * c + 1]) << 16)
    return regs


def _f32_pair(lo: float, hi: float) -> int:
    """pack_bf16x2 (cvt.rn.bf16x2.f32): lo in bits 0-15, hi in 16-31."""
    bits = _bf16_bits(np.array([lo, hi], np.float32))
    return int(bits[0]) | (int(bits[1]) << 16)


@pytest.mark.parametrize("kind", ["float32", "dx bfloat16", "dx float32"])
def test_f32_and_dx_fragments_hold_the_columns_the_epilogue_writes(kind):
    """stack_a_frags for f32 stacks as stored (k, n) (one 8-byte read a k row
    holds columns 2g, 2g + 1; rows padded 16 bytes) and for dx's stored
    (n, k) tile, 128 output rows x 64 of k (bf16: ldmatrix without .trans,
    rows padded 16 bytes; f32: 8-byte reads of a row's k pair, rows padded
    32 bytes): in each 16-deep slice, fragment row r holds the weights of
    the column the epilogue writes it to (f32 as stored: col0 + 2 (r % 8) +
    r // 8; dx: col0 + r), in k order, f32 rounded to nearest even bf16."""
    rng = np.random.default_rng(6)
    col0 = 64 + 32                                    # warpgroup 1, its warp 2
    dx, f32 = kind.startswith("dx"), kind.endswith("float32")
    esize = 4 if f32 else 2
    rows_, cols = (BN, BK) if dx else (BK, BN)        # the staged tile as stored
    ld = cols * esize + (32 if dx and f32 else 16)
    w = rng.standard_normal((rows_, cols)).astype(np.float32)
    raw = (w.view(np.uint8) if f32 else
           torch.from_numpy(w).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint8))
    smem = np.zeros((rows_, ld), np.uint8)
    smem[:, :cols * esize] = raw.reshape(rows_, cols * esize)
    smem = smem.reshape(-1)

    def f32_at(row, col):
        return float(smem[row * ld + col * 4:row * ld + col * 4 + 4].view("<f4")[0])
    a = np.zeros((32, 4, 4), np.uint32)               # lane, slice, register
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for j in range(4):
            if dx and f32:
                for i in range(4):
                    r, kk = col0 + g + (i & 1) * 8, j * 16 + 2 * c + (i >> 1) * 8
                    a[lane, j, i] = _f32_pair(f32_at(r, kk), f32_at(r, kk + 1))
            elif f32:
                for h in range(2):
                    kk = j * 16 + 2 * c + h * 8
                    lo = (f32_at(kk, col0 + 2 * g), f32_at(kk, col0 + 2 * g + 1))
                    hi = (f32_at(kk + 1, col0 + 2 * g), f32_at(kk + 1, col0 + 2 * g + 1))
                    a[lane, j, 2 * h] = _f32_pair(lo[0], hi[0])
                    a[lane, j, 2 * h + 1] = _f32_pair(lo[1], hi[1])
    if not f32:
        for j in range(4):
            a[:, j] = _ldmatrix(smem, [(col0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                                       + (j * 16 + (lane >> 4) * 8) * 2 for lane in range(32)])
    want_w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    for j in range(4):
        frag = np.zeros((16, 16), np.float32)         # fragment row, k
        for lane in range(32):
            g, c = lane // 4, lane % 4
            for reg, (row, k0) in enumerate(((g, 2 * c), (g + 8, 2 * c), (g, 2 * c + 8),
                                             (g + 8, 2 * c + 8))):
                frag[row, k0] = _half(a[lane, j, reg], False)
                frag[row, k0 + 1] = _half(a[lane, j, reg], True)
        for row in range(16):
            if dx:
                want = want_w[col0 + row, 16 * j:16 * j + 16]
            else:
                want = want_w[16 * j:16 * j + 16, col0 + _row_col(row, True)]
            np.testing.assert_array_equal(frag[row], want)


def _sw128(row: int, chunk: int) -> int:
    """x's 16-byte chunk `chunk` of row `row` in a stage (csrc/moe_stack.cu
    StackCopies: 128-byte rows, chunks XOR-swizzled by row % 8)."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _descriptor_address(base: int, row: int, k: int) -> int:
    """Where a K-major, 128-byte-swizzled wgmma descriptor (8-row groups
    1024 bytes apart) reads bf16 element k (0-63) of row `row`: the plain
    address, then address bits 4-6 XOR bits 7-9 (base 1024-aligned)."""
    plain = base + (row // 8) * 1024 + (row % 8) * 128 + 2 * k
    return plain ^ (((plain >> 7) & 7) << 4)


def test_x_tile_sits_where_the_descriptor_reads():
    """x's stage tile, written chunk by chunk as the copies write it, holds
    x (row, k) where the B descriptor of 16-deep slice k // 16 (the stage's
    address plus 32 bytes a slice) reads row `row`, element k % 16."""
    x = torch.randn(TM, BK).to(torch.bfloat16)
    xbits = x.view(torch.int16).numpy().view(np.uint8)
    tile = np.zeros(TM * 128, np.uint8)
    for r in range(TM):
        for c in range(8):
            tile[_sw128(r, c):_sw128(r, c) + 16] = xbits[r, 16 * c:16 * c + 16]
    view = tile.view("<u2")
    want = x.view(torch.int16).numpy().view(np.uint16)
    for r in range(TM):
        for kk in range(BK):
            assert view[_descriptor_address(32 * (kk // 16), r, kk % 16) // 2] == want[r, kk]


# ---------------------------------------------------------------------------
# a model of the kernel's tiling
# ---------------------------------------------------------------------------

def _s8_table() -> torch.Tensor:
    """bf16 of each int8 value (index b + 128) by the kernel's conversion."""
    words = np.arange(-128, 128, dtype=np.int32).astype(np.int8).view("<u4")
    even, odd = _s8x4_bf16x2(words)
    bits = np.stack([even & 0xFFFF, odd & 0xFFFF, even >> 16, odd >> 16], axis=1).reshape(-1)
    return torch.from_numpy(_bf16_values(bits)).to(torch.bfloat16)


def _stack_model(xp, w, scale, texp, rows, used):
    """csrc/moe_stack.cu's arithmetic on the padded layout: each (tile,
    strip) pair below the used rows, strips fastest; each warpgroup's 64 columns summed in
    f32 against the tile's real rows rounded up to 32 (x's padding rows read
    as zeros) over 64-deep stages of four 16-deep products in k order; the
    scale in f32, one rounding to bf16; only real rows stored. Unwritten
    outputs are NaN."""
    mp, k = xp.shape
    n = w.shape[2]
    table = _s8_table()
    out = torch.full((mp, n), float("nan"), dtype=torch.bfloat16)
    tiles, strips = -(-int(used) // TM), n // BN
    for item in range(tiles * strips):
        tile, strip = item // strips, item % strips
        real, e = int(rows[tile]), int(texp[tile])
        nlive = min(TM, -(-real // 32) * 32)
        xa = xp[tile * TM:tile * TM + nlive].float()
        xa[real:] = 0                                    # cp.async zero-fill
        for wg in range(2):
            cols = slice(strip * BN + 64 * wg, strip * BN + 64 * wg + 64)
            wt = w[e, :, cols]
            wt = (table[wt.long() + 128] if w.dtype == torch.int8
                  else wt.to(torch.bfloat16)).float()
            acc = torch.zeros(64, nlive)                 # out^T
            for k0 in range(0, k, BK):
                for kk in range(k0, k0 + BK, 16):
                    acc = acc + wt[kk:kk + 16].T @ xa[:, kk:kk + 16].T
            if scale is not None:
                acc = acc * scale[e, cols].float()[:, None]
            out[tile * TM:tile * TM + real, cols] = acc.T[:real].to(torch.bfloat16)
    return out


@pytest.mark.parametrize("groups", [[130, 0, 1, 60], [128, 256, 0, 5]])
@pytest.mark.parametrize("kind", ["int8", "bfloat16", "float32", "dx float32", "dx bfloat16"])
def test_stack_model_matches_plain_and_jax(kind, groups):
    """E 4, k 384 (six 64-deep steps: the 4-stage ring wraps mid-k), n 256
    (two strips): the model on every real row against grouped_padded_plain
    and JAX's _grouped_stack_call (interpret mode) on the same padded
    layout; padding rows are never written. f32 stacks round each weight
    to bf16; dx's stacks are the transposed view of (E, n, k) as they lie
    (JAX: swapaxes)."""
    rng = np.random.default_rng(7)
    e, k, n = 4, 384, 256
    gsz = np.asarray(groups, np.int32)
    x = rng.standard_normal((int(gsz.sum()), k)).astype(np.float32)
    if kind == "int8":
        w = rng.integers(-127, 128, (e, k, n)).astype(np.int8)
        s = ((rng.random((e, n)) + 0.1) * 0.01).astype(np.float32)
        tw, ts = torch.from_numpy(w), torch.from_numpy(s)
        jw, js = jnp.asarray(w), jnp.asarray(s)
    elif kind.startswith("dx"):
        stored = (rng.standard_normal((e, n, k)) * 0.05).astype(np.float32)
        wdt = torch.float32 if kind.endswith("float32") else torch.bfloat16
        tw, ts = torch.from_numpy(stored).to(wdt).transpose(1, 2), None
        jw, js = jnp.swapaxes(jnp.asarray(stored, jnp.float32 if wdt == torch.float32
                                          else jnp.bfloat16), 1, 2), None
        assert moe.stacks_transposed(tw)
    else:
        w = (rng.standard_normal((e, k, n)) * 0.05).astype(np.float32)
        wdt = torch.float32 if kind == "float32" else torch.bfloat16
        tw, ts = torch.from_numpy(w).to(wdt), None
        jw, js = jnp.asarray(w, jnp.float32 if kind == "float32" else jnp.bfloat16), None
    tx = torch.from_numpy(x).to(torch.bfloat16)
    xp, dst, texp, used = moe.scatter_layout(tx, torch.from_numpy(gsz), TM, e)
    assert moe.stack_kernel_takes(TM, k, n, tx.dtype, tw.dtype)
    rows = moe.tile_rows(torch.from_numpy(gsz), texp, TM)
    got = _stack_model(xp, tw, ts, texp, rows, used)
    real = torch.zeros(xp.shape[0], dtype=torch.bool)
    real[dst] = True
    assert not torch.isnan(got[real].float()).any() and torch.isnan(got[~real].float()).all()
    plain = moe.grouped_padded_plain(xp, tw, ts, texp, TM)
    _close(got[dst], plain[dst].float().numpy(), "bfloat16")
    jxp, jdst, jtexp = jmoe._scatter_layout(jnp.asarray(x, jnp.bfloat16), jnp.asarray(gsz),
                                            TM, e)
    tile_k, tile_n = jmoe._stack_tiles(jxp.shape[0], e, k, n, jw.dtype.itemsize, 2)
    want = jmoe._grouped_stack_call(jxp, jw, js, jtexp, TM, tile_k, tile_n, True,
                                    jxp.dtype)
    _close(got[dst], np.asarray(want.astype(jnp.float32))[np.asarray(jdst)], "bfloat16")


SASS_STACK = """
        Function : _ZN4demo25rk_moe_stack_wgmma_kernelIaEEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDSM.16.MT88.4 R4, [R2] ;
        /*0020*/                   LOP3.LUT R8, R4, 0x7f007f, RZ, 0xc0, !PT ;
        /*0030*/                   HADD2.BF16_V2 R8, R8, -R9 ;
        /*0040*/                   HGMMA.64x128x16.F32.BF16 R24, R8, gdesc[UR4], R24 ;
        /*0050*/              @!P0 BRA 0x10 ;
        /*0060*/                   F2FP.BF16.F32.PACK_AB R6, R7, R8 ;
        /*0070*/                   LDSM.16.MT88.4 R4, [R2] ;
        /*0080*/                   HGMMA.64x32x16.F32.BF16 R24, R8, gdesc[UR4], R24 ;
        /*0090*/              @!P0 BRA 0x70 ;
        /*00a0*/              @!P1 BRA 0x10 ;
        /*00b0*/                   EXIT ;
"""


def test_sass_count_reads_the_stack_kernel():
    """#12's kernel: its main loop is the innermost backward branch around
    HGMMAs (the first k loop, not the loop over (tile, strip) pairs around
    all of them); each bf16 HADD2 there converts two int8 weights, and the
    epilogue's bf16 packing falls outside it."""
    from ragmeup_tpu_torch.tools import sass_count
    kernel = sass_count.instructions(SASS_STACK)["_ZN4demo25rk_moe_stack_wgmma_kernelIaEEvv"]
    assert any(name in "_ZN4demo25rk_moe_stack_wgmma_kernelIaEEvv"
               for name in sass_count.STACK_KERNELS)
    assert len(sass_count.main_loop(kernel, sass_count._is_hgmma)) == 10
    loop = sass_count.main_loop(kernel, sass_count._is_hgmma, innermost=True)
    assert [addr for addr, _, _ in loop] == [0x10, 0x20, 0x30, 0x40, 0x50]
    counts = sass_count.summarize(sass_count.opcode_counts(loop), stack=True)
    assert counts["hgmma"] == 1 and counts["bf16_nibble_pairs"] == 1
    assert counts["packed_bytes"] == 2 and counts["conversions"] == {}
    assert counts["lop3"] == 1 and counts["instructions_per_packed_byte"] == 2.5
    whole = sass_count.summarize(sass_count.opcode_counts(kernel), stack=True)
    assert whole["hgmma"] == 2 and whole["conversions"] == {"F2FP.BF16.F32.PACK_AB": 1}
