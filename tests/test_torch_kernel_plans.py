"""Launch plans of the port's CUDA kernels, checked on the CPU.

The int4 grouped expert GEMM (#14, csrc/moe_matmul_int4.cu) cuts k into
slices of whole packing tiles on bf16 rows and adds the slices' f32
partials in slice order. Its plan is chosen on the host from the shapes and
the card's SM count, so it is held here: the slices cover k once, in order,
each a whole number of packing tiles, never none and never more than there
are tiles. The plain version evaluated slice by slice under that plan, the
partials added in slice order, agrees with the whole-k plain version and
with the JAX kernel in interpret mode, on both arithmetic routes, in f32
and bf16 (tolerances as tests/test_torch_moe_int4.py: 2e-5 of the largest
output in f32, one bf16 ulp of it in bf16).

The paged attention kernel (#9, csrc/paged_attention.cu) cuts the keys
below ``mp * ps`` into splits of whole 64-key tiles (``paged_split_plan``)
and merges each row's per-split (m, l, o) in split order; the W8A16 decode
matmul (#3, csrc/quant_matmul.cu) cuts k into slices (``int8_matmul_plan``)
whose f32 partials, each the sum of 8 warps' runs of rows, are added in
slice order; the W4A16 decode matmul (#4 at m <= 8,
csrc/quant_matmul_int4.cu ``rk_int4_decode_kernel``) does the same over
slices of one k-tile's packed rows (``int4_decode_plan``), each packed row
feeding a low- and a high-nibble x column; the int4 expert gather (#13)
runs #4's decode kernels with one slot a block (``int4_gather_plan``: the
slots counted as blocks), its wrapper sending each shape to the entry its
route names; the W4A8 decode matmul (#5 at m <= 8,
``rk_int4_a8_decode_kernel``) sums int8 x codes times 16 q on the integer
tensor cores over slices of whole 16-row k-blocks
(``int4_a8_decode_plan``), exactly, so its model is held bit for bit. The
plans are held to cover
their range once, in order, and an emulation of each kernel's arithmetic
under its plan (plain torch, f32 or bf16) is held to the port's plain
version and to the JAX package (``paged_attention_ref`` / the Pallas
kernels in interpret mode): f32 to 1e-5 absolute (#9, as
tests/test_torch_paged.py) or 2e-5 of the largest output (#3, #4), bf16
within one bf16 ulp of the largest output. The grouped GEMM's dw kernel
(csrc/moe_wgrad.cu, no Pallas counterpart): its grid names each output
tile once, a model of its sums equals the plain one-hot product and the
JAX package's XLA einsum within 1e-5 of the largest value, and its
wrapper hands the group sizes to the kernel on the device.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.ops import moe_matmul as jmoe
from ragmeup_tpu.ops import paged_attention as jpa
from ragmeup_tpu.ops import quant_matmul as jqm
from ragmeup_tpu.ops import topk as jtopk
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.ops import attention as tattn
from ragmeup_tpu_torch.ops import moe_matmul as moe
from ragmeup_tpu_torch.ops import paged_attention as tpa
from ragmeup_tpu_torch.ops import quant_matmul as qm
from ragmeup_tpu_torch.ops.topk import quantize_int8
from test_torch_moe_int4 import DTYPES, _close, _packed_experts
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

H100_SMS = 132
MIXTRAL = {"gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}
TINY = {"grouped": (1024, 512), "mlp gate": (512, 256), "mlp down": (256, 512)}


def _padded_rows(m: int, e: int = 8) -> int:
    """scatter_layout's padded strip for m rows over e experts, 16-row tiles."""
    return -(-(m + e * 15) // 16) * 16


# (k, n, packing tile, scale group, rows, SMs); groups 128 and 512 where
# the group divides the packing tile
PLAN_CASES = {f"{name} group={group} m={m} sms={sms}": (k, n, pack_tile, group, m, sms)
              for name, (k, n) in {**MIXTRAL, **TINY}.items()
              for pack_tile in ([512] if k % 512 == 0 else [k])
              for group in (128, 512) if pack_tile % group == 0
              for m in (1, 16, 392)
              for sms in (1, H100_SMS, 10_000)}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_grouped_int4_plan_covers_k_in_whole_tiles(case):
    k, n, pack_tile, group, m, sms = PLAN_CASES[case]
    assert moe.grouped_int4_viable(m, 8, k, n, pack_tile, group, torch.bfloat16)
    mp = _padded_rows(m)
    tiles = k // pack_tile
    per = moe.grouped_int4_plan(mp, k, n, pack_tile, sms)
    ranges = moe.grouped_int4_slices(k, pack_tile, per)
    assert 1 <= len(ranges) <= tiles
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 < k1 and k0 % pack_tile == 0 and (k1 - k0) % pack_tile == 0
        assert (k1 - k0) // pack_tile <= per
    # the slices are as even as whole tiles allow
    widths = [k1 - k0 for k0, k1 in ranges]
    assert max(widths) - min(widths) <= per * pack_tile
    # the blocks it aims at on every SM, unless k has too few tiles
    target = moe._INT4_BLOCKS_PER_SM * sms
    blocks = (n // 128) * (mp // 16) * len(ranges)
    assert blocks >= target or len(ranges) == tiles
    # the fewest such slices: one fewer would not give the blocks
    if len(ranges) > 1:
        fewer = -(-tiles // (len(ranges) - 1))
        assert (n // 128) * (mp // 16) * -(-tiles // fewer) < target


def test_grouped_int4_plan_splits_mixtral_down_on_an_h100():
    """At Mixtral's batched decode (16 rows over 8 experts: 9 row tiles)
    the down projection (k 14336: 28 packing tiles, 32 column strips) is
    cut in four, gate/up (112 strips) in two."""
    mp = _padded_rows(16)
    slices = {name: len(moe.grouped_int4_slices(
        k, 512, moe.grouped_int4_plan(mp, k, n, 512, H100_SMS)))
        for name, (k, n) in MIXTRAL.items()}
    assert slices == {"gate": 2, "up": 2, "down": 4}


def _split_k_plain(xs, w_p, gs, gsz, pack_tile, group, per):
    """The plain arithmetic of each route over each slice of the plan, the
    f32 partials added in slice order and rounded once."""
    k = xs.shape[1]
    out = torch.empty((xs.shape[0], w_p.shape[2]), dtype=xs.dtype)
    lo = 0
    for ex, g in enumerate(gsz.tolist()):
        if g:
            acc = None
            for k0, k1 in moe.grouped_int4_slices(k, pack_tile, per):
                part = moe._int4_products(
                    xs[lo:lo + g, k0:k1].float()[None],
                    moe._unpack_int4_stack(w_p[ex:ex + 1, k0 // 2:k1 // 2], pack_tile),
                    gs[ex:ex + 1, k0 // group:k1 // group], pack_tile, group, xs.dtype)
                acc = part if acc is None else acc + part
            out[lo:lo + g] = acc[0].to(xs.dtype)
        lo += g
    return out


SPLIT_K = 1536       # three packing tiles of 512
SPLIT_GSZ = (3, 0, 5, 2)


@functools.lru_cache(maxsize=None)
def _split_inputs(group: int, dtype: str):
    """Packed experts (4, 768, 512), rows sorted by expert, and the JAX
    kernel's output on them (interpret mode)."""
    rng = np.random.default_rng(group + len(dtype))
    w_p, gs = _packed_experts(rng, group, k=SPLIT_K)
    gsz = np.asarray(SPLIT_GSZ, np.int32)
    x = rng.standard_normal((int(gsz.sum()), SPLIT_K)).astype(np.float32)
    jdt = DTYPES[dtype][1]
    want = np.asarray(jmoe.moe_grouped_matmul_int4(
        jnp.asarray(x, jdt), jnp.asarray(w_p), jnp.asarray(gs), jnp.asarray(gsz), 512,
        group).astype(jnp.float32))
    return x, w_p, gs, gsz, want


# SM counts that give one, two (2 + 1 tiles: uneven) and three slices
@pytest.mark.parametrize("sms,slices", [(1, 1), (4, 2), (100, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [128, 512])
def test_split_k_plain_matches_plain_and_jax(group, dtype, sms, slices):
    x, w_p, gs, gsz, want = _split_inputs(group, dtype)
    assert moe.grouped_int4_viable(x.shape[0], 4, SPLIT_K, 512, 512, group,
                                   DTYPES[dtype][0])
    per = moe.grouped_int4_plan(_padded_rows(x.shape[0], 4), SPLIT_K, 512, 512, sms)
    assert len(moe.grouped_int4_slices(SPLIT_K, 512, per)) == slices
    tx = torch.from_numpy(x).to(DTYPES[dtype][0])
    args = (torch.from_numpy(w_p), torch.from_numpy(gs), torch.from_numpy(gsz), 512, group)
    got = _split_k_plain(tx, *args, per)
    assert got.dtype == tx.dtype and got.shape == (x.shape[0], 512)
    _close(got, moe.moe_grouped_matmul_int4_plain(tx, *args).float().numpy(), dtype)
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# #9: paged attention's split-KV plan and the merge of its splits
# ---------------------------------------------------------------------------

# (mp, ps, b, nkv, row tiles or None for the decode kernel, head dim): the
# engine's 8B serving shapes (16 pages of 128 tokens, decode at 1-8 rows,
# the 128-token chunk at 1 and 4: 8 row tiles of 64), tiny ones, and hd 256
# (Gemma-2-9B's 8 kv heads, Gemma-7B's 16; decode walks 32-key tiles there,
# the chunk kernel 64-key splits)
PAGED_PLANS = {**{f"8B decode b={b}": (16, 128, b, 8, None, 128) for b in (1, 4, 8)},
               **{f"8B chunk b={b}": (16, 128, b, 8, 8, 128) for b in (1, 4)},
               "16-token pages": (128, 16, 8, 8, None, 128),
               "tiny decode": (3, 16, 2, 2, None, 128),
               "tiny chunk": (5, 16, 3, 2, 1, 128),
               "one page": (1, 16, 1, 1, None, 128),
               **{f"hd=256 decode b={b} nkv={nkv}": (16, 128, b, nkv, None, 256)
                  for b in (1, 8) for nkv in (8, 16)},
               "hd=256 16-token pages": (128, 16, 8, 8, None, 256),
               "hd=256 tiny decode": (3, 16, 2, 2, None, 256),
               "hd=256 one page": (1, 16, 1, 1, None, 256),
               "hd=256 chunk b=4": (16, 128, 4, 8, 2, 256),
               "hd=256 chunk q_len=8 b=4": (16, 128, 4, 8, 1, 256),
               "hd=96 decode b=8": (16, 128, 8, 32, None, 96),
               "hd=64 decode b=8": (16, 128, 8, 2, None, 64),
               "hd=96 16-token pages": (128, 16, 8, 32, None, 96)}


@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("case", list(PAGED_PLANS))
def test_paged_split_plan_covers_every_key_once(case, sms):
    mp, ps, b, nkv, row_tiles, hd = PAGED_PLANS[case]
    kps = tpa.paged_split_plan(mp, ps, b, nkv, sms, row_tiles, hd=hd)
    unit = 32 if hd == 256 and row_tiles is None else 64   # the kernel's key tile
    assert tpa.split_unit(hd, row_tiles is None) == unit
    keys, tiles = mp * ps, -(-(mp * ps) // unit)
    assert kps >= unit and kps % unit == 0
    splits = tpa.paged_splits(mp, ps, kps)
    ranges = [(s * kps, min(keys, (s + 1) * kps)) for s in range(splits)]
    assert 1 <= splits <= tiles
    assert ranges[0][0] == 0 and ranges[-1][1] == keys
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(k0 < k1 for k0, k1 in ranges)
    # the fewest splits that give the blocks it aims at on every SM (at most
    # one a tile), cut evenly into whole tiles (which may round to fewer)
    per_sm = tpa.decode_blocks_per_sm(hd) if row_tiles is None else tpa._CHUNK_BLOCKS_PER_SM
    base = b * nkv * (row_tiles or 1)
    wanted = next(w for w in range(1, tiles + 1) if base * w >= per_sm * sms or w == tiles)
    assert kps // unit == -(-tiles // wanted) and splits <= wanted


def test_paged_split_plan_on_an_h100():
    """The engine's shapes on 132 SMs: decode at 8 rows cuts the 2,048 keys
    in 8 splits of 256, at 1 row in 32 of one tile; the b = 1 chunk (64
    blocks) in 3 of 704 keys, the b = 4 chunk (256 blocks) not at all; f32
    pools take one split."""
    plan = {label: tpa.paged_splits(16, 128, tpa.kernel_split(
        b, q_len, 32, 8, 128, 16, torch.bfloat16, H100_SMS))
        for label, b, q_len in (("decode 8", 8, 1), ("decode 4", 4, 1), ("decode 1", 1, 1),
                                ("chunk 1", 1, 128), ("chunk 4", 4, 128))}
    assert plan == {"decode 8": 8, "decode 4": 16, "decode 1": 32, "chunk 1": 3,
                    "chunk 4": 1}
    assert tpa.paged_splits(16, 128, tpa.kernel_split(
        1, 1, 32, 8, 128, 16, torch.float32, H100_SMS)) == 1


def _split_merge_plain(q, k_pages, v_pages, idx, lens, kps, window=0, softcap=0.0,
                       sm_scale=None):
    """The kernel's arithmetic under its plan, in f32: each split's running
    max m (log2 domain), sum l and unnormalized o over the keys of the split
    each row sees, then the combine kernel's merge in split order (a split
    that saw no key is skipped; a row with no key writes 0)."""
    b, s, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    g = nh // nkv
    mp = idx.shape[1]
    keys = mp * ps
    kk = k_pages[:, idx.long()].reshape(nkv, b, keys, hd).float()
    vv = v_pages[:, idx.long()].reshape(nkv, b, keys, hd).float()
    sc = torch.einsum("bsngd,nbtd->bngst", q.reshape(b, s, nkv, g, hd).float(), kk)
    sc = sc * (sm_scale if sm_scale is not None else 1 / np.sqrt(hd))
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    sc = sc * np.log2(np.e)
    lim = lens.long()[:, None] - s + 1 + torch.arange(s)[None]            # (b, s)
    pos = torch.arange(keys)
    seen = (pos[None, None] < lim[:, :, None]) & (pos < keys)
    if window:
        seen = seen & (pos[None, None] >= lim[:, :, None] - window)
    seen = seen[:, None, None]                                            # (b,1,1,s,T)
    m_all, l_all, o_all = [], [], []
    for k0 in range(0, keys, kps):
        part = torch.zeros(keys, dtype=torch.bool)
        part[k0:k0 + kps] = True
        mask = seen & part
        x = torch.where(mask, sc, -torch.inf)
        m = x.amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp2(x - torch.where(m == -torch.inf, 0.0, m)), 0.0)
        m_all.append(m)
        l_all.append(p.sum(-1, keepdim=True))
        o_all.append(torch.einsum("bngst,nbtd->bngsd", p, vv))
    mx = torch.stack(m_all).amax(0)
    lsum = torch.zeros_like(l_all[0])
    osum = torch.zeros_like(o_all[0])
    for m, l, o in zip(m_all, l_all, o_all):
        f = torch.where(m == -torch.inf, 0.0, torch.exp2(m - torch.where(mx == -torch.inf, 0.0,
                                                                          mx)))
        lsum = lsum + l * f
        osum = osum + o * f
    out = torch.where(lsum == 0, 0.0, osum / torch.where(lsum == 0, 1.0, lsum))
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, nh, hd)


def _paged_pool(rng, b, nkv, hd, ps, P, lengths, mp):
    k_pages = rng.standard_normal((nkv, P, ps, hd)).astype(np.float32)
    v_pages = rng.standard_normal((nkv, P, ps, hd)).astype(np.float32)
    idx = rng.permutation(P)[:b * mp].reshape(b, mp).astype(np.int32)
    return k_pages, v_pages, idx, np.asarray(lengths, np.int32)


# (q_len, ps, window, softcap, lengths): mp * ps keys = 384 for ps 128, 128
# for ps 16; a length-1 row, rows ending mid-tile, a window that leaves whole
# splits out, a sequence of length 0 (no visible key)
PAGED_MERGE = {"decode": (1, 16, 0, 0.0, (1, 37, 128, 70)),
               "decode ps=128": (1, 128, 0, 0.0, (1, 383, 200, 129)),
               "decode window": (1, 16, 20, 0.0, (1, 37, 128, 90)),
               "decode window ps=128": (1, 128, 70, 0.0, (300, 384, 65, 1)),
               "decode softcap": (1, 16, 0, 2.5, (5, 128, 64, 65)),
               "decode no key": (1, 16, 0, 0.0, (0, 128, 1, 66)),
               "chunk": (8, 16, 0, 0.0, (8, 50, 128, 73)),
               "chunk ps=128": (8, 128, 0, 0.0, (8, 384, 200, 130)),
               "chunk window": (8, 16, 12, 0.0, (9, 50, 128, 100)),
               "chunk softcap": (8, 128, 0, 3.0, (20, 384, 65, 8))}


@pytest.mark.parametrize("sms", [1, 3, H100_SMS])
@pytest.mark.parametrize("case", list(PAGED_MERGE))
def test_paged_split_merge_matches_plain_and_jax(case, sms):
    q_len, ps, window, softcap, lengths = PAGED_MERGE[case]
    b, nkv, g, hd = len(lengths), 2, 2, 32
    mp = 384 // ps if ps == 128 else 8
    rng = np.random.default_rng(len(case) + ps)
    k, v, idx, lens = _paged_pool(rng, b, nkv, hd, ps, b * mp + 3, lengths, mp)
    q = rng.standard_normal((b, q_len, nkv * g, hd)).astype(np.float32)
    row_tiles = None if q_len == 1 else -(-(q_len * g) // 64)
    kps = tpa.paged_split_plan(mp, ps, b, nkv, sms, row_tiles)
    tq, tk, tv, ti, tl = (torch.from_numpy(a) for a in (q, k, v, idx, lens))
    got = _split_merge_plain(tq, tk, tv, ti, tl, kps, window, softcap)
    kw = dict(window=window, softcap=softcap)
    if q_len == 1:
        plain = tpa.paged_attention_plain(tq[:, 0], tk, tv, ti, tl, **kw)[:, None]
        jfn, jref = jpa.paged_attention, jpa.paged_attention_ref
        jq = q[:, 0]
    else:
        plain = tpa.paged_attention_chunk_plain(tq, tk, tv, ti, tl, **kw)
        jfn, jref = jpa.paged_attention_chunk, jpa.paged_attention_chunk_ref
        jq = q
    args = [jnp.asarray(a) for a in (jq, k, v, idx, lens)]
    kern = np.asarray(jfn(*args, interpret=True, **kw)).reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), kern, atol=1e-5)
    if min(lengths) > 0:   # the _ref oracle gives a keyless row the mean of V
        ref = np.asarray(jref(*args, **kw)).reshape(got.shape)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    if case == "decode no key":
        assert not got[0].any()


# the checkpoint families' head dims and groups, (hd, g, nkv): hd 64 at g 7
# (Qwen2.5-0.5B), hd 96 (Phi-3-mini), hd 256 at g 2 (Gemma-2-9B), hd 128 at
# g 7 (Qwen2.5-7B); each with a window, a softcap and Gemma-2's 1/16 scale
PAGED_FAMILIES = {"hd=64 g=7": (64, 7, 1), "hd=96": (96, 1, 2), "hd=256 g=2": (256, 2, 1),
                  "hd=128 g=7": (128, 7, 1)}


@pytest.mark.parametrize("mode", ["decode", "chunk"])
@pytest.mark.parametrize("case", list(PAGED_FAMILIES))
def test_paged_split_merge_at_the_families_shapes(case, mode):
    """The split plan's emulation at each family shape against the plain
    version and the JAX kernel (interpret mode; it runs hd 96 on a pool
    zero-padded to 128 columns), decode and chunk (q_len 8: 56 rows of 64
    at g 7), on 3 SMs (decode) or 64 (chunk), so that the keys split."""
    hd, g, nkv = PAGED_FAMILIES[case]
    q_len = 1 if mode == "decode" else 8
    lengths = (37, 128, 1, 90) if q_len == 1 else (50, 128, 9, 100)
    b, ps, mp = len(lengths), 16, 8
    kw = dict(window=20, softcap=2.5, sm_scale=1 / 16)
    rng = np.random.default_rng(hd + g)
    k, v, idx, lens = _paged_pool(rng, b, nkv, hd, ps, b * mp + 3, lengths, mp)
    q = rng.standard_normal((b, q_len, nkv * g, hd)).astype(np.float32)
    row_tiles = None if q_len == 1 and g <= tpa.DECODE_MAX_G else -(-(q_len * g) // 64)
    kps = tpa.paged_split_plan(mp, ps, b, nkv, 3 if q_len == 1 else 64, row_tiles, hd=hd)
    assert tpa.paged_splits(mp, ps, kps) > 1
    tq, tk, tv, ti, tl = (torch.from_numpy(a) for a in (q, k, v, idx, lens))
    got = _split_merge_plain(tq, tk, tv, ti, tl, kps, **kw)
    if q_len == 1:
        plain = tpa.paged_attention_plain(tq[:, 0], tk, tv, ti, tl, **kw)[:, None]
        kern = jpa.paged_attention(*(jnp.asarray(a) for a in (q[:, 0], k, v, idx, lens)),
                                   interpret=True, **kw)
    else:
        plain = tpa.paged_attention_chunk_plain(tq, tk, tv, ti, tl, **kw)
        kern = jpa.paged_attention_chunk(*(jnp.asarray(a) for a in (q, k, v, idx, lens)),
                                         interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern).reshape(got.shape), atol=1e-5)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _decode_mma_model(q, k_pages, v_pages, idx, lens, kps, tile, parts, window=0,
                      softcap=0.0, sm_scale=None):
    """csrc/paged_attention.cu's tensor-core decode kernels in f32: each split
    walks its `tile`-key tiles from the one holding its first visible key;
    the `parts` key slices of a tile (one a warp, or a warp pair) keep their
    own running max m (log2 domain), sum l and o over the split, p entering
    P V as a bf16 high part plus the bf16 of the rest; the slices merge at
    the split's end in order (m = max, each scaled by exp2(m_w - m)), then
    the combine kernel merges the splits in split order. The hd-256 kernel
    (rk_paged_decode_mma_kernel) is tile 32, parts 2; the hd-64/96 kernel
    (rk_paged_decode_narrow_kernel) tile 64, parts 4. q (b, nh, hd) ->
    (b, nh, hd)."""
    b, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    g = nh // nkv
    keys = idx.shape[1] * ps
    width = tile // parts
    kk = k_pages[:, idx.long()].reshape(nkv, b, keys, hd).float()
    vv = v_pages[:, idx.long()].reshape(nkv, b, keys, hd).float()
    sc = torch.einsum("bngd,nbtd->bngt", q.reshape(b, nkv, g, hd).float(), kk)
    sc = sc * (sm_scale if sm_scale is not None else 1 / np.sqrt(hd))
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    sc = sc * np.log2(np.e)
    lo = (lens.long() - window).clamp(min=0) if window else torch.zeros(b, dtype=torch.long)
    pos = torch.arange(keys)
    out_parts = []
    for k0 in range(0, keys, kps):
        a = torch.maximum(torch.full((b,), k0), lo)
        e = torch.minimum(torch.full((b,), min(k0 + kps, keys)), lens.long())
        slices = []
        for w in range(parts):
            m = torch.full((b, nkv, g), -torch.inf)
            l = torch.zeros(b, nkv, g)
            o = torch.zeros(b, nkv, g, hd)
            for t in range(k0 // tile, -(-min(k0 + kps, keys) // tile)):
                cols = pos[tile * t + width * w:tile * t + width * (w + 1)]
                seen = (cols[None] >= a[:, None]) & (cols[None] < e[:, None])   # (b, width)
                x = torch.where(seen[:, None, None], sc[..., cols], -torch.inf)
                mn = torch.maximum(m, x.amax(-1))
                mu = torch.where(mn == -torch.inf, 0.0, mn)
                alpha = torch.exp2(m - mu)
                m = mn
                p = torch.exp2(x - mu[..., None])
                l = l * alpha + p.sum(-1)
                hi = _bf16(p)
                o = o * alpha[..., None] + torch.einsum(
                    "bngt,nbtd->bngd", hi + _bf16(p - hi), vv[:, :, cols])
            slices.append((m, l, o))
        m = torch.stack([m for m, _, _ in slices]).amax(0)
        mu = torch.where(m == -torch.inf, 0.0, m)
        l = torch.zeros_like(slices[0][1])
        o = torch.zeros_like(slices[0][2])
        for m_w, l_w, o_w in slices:
            f = torch.exp2(m_w - mu)
            l = l + l_w * f
            o = o + o_w * f[..., None]
        out_parts.append((torch.where((a < e)[:, None, None], m, -torch.inf), l, o))
    mx = torch.stack([m for m, _, _ in out_parts]).amax(0)
    lsum = torch.zeros_like(out_parts[0][1])
    osum = torch.zeros_like(out_parts[0][2])
    for m, l, o in out_parts:
        f = torch.where(m == -torch.inf, 0.0, torch.exp2(m - torch.where(mx == -torch.inf, 0.0,
                                                                         mx)))
        lsum = lsum + l * f
        osum = osum + o * f[..., None]
    out = torch.where(lsum[..., None] == 0, 0.0,
                      osum / torch.where(lsum == 0, 1.0, lsum)[..., None])
    return out.reshape(b, nh, hd)


def _chunk_wgmma_model(q, k_pages, v_pages, idx, lens, kps, window=0, softcap=0.0,
                       sm_scale=None):
    """csrc/paged_attention.cu's hd-256 chunk kernel (rk_paged_chunk_wgmma_kernel)
    in f32: each split walks its 64-key tiles; every row keeps its running
    max m (log2 domain), sum l and o over the split, masked to its own keys
    (a tile wholly masked for a row leaves it as it was: alpha 1, p 0), p
    entering P V as a bf16 high part plus the bf16 of the rest; the combine
    kernel merges the splits in split order. q (b, s, nh, hd)."""
    b, s, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    g = nh // nkv
    keys = idx.shape[1] * ps
    kk = k_pages[:, idx.long()].reshape(nkv, b, keys, hd).float()
    vv = v_pages[:, idx.long()].reshape(nkv, b, keys, hd).float()
    sc = torch.einsum("bsngd,nbtd->bngst", q.reshape(b, s, nkv, g, hd).float(), kk)
    sc = sc * (sm_scale if sm_scale is not None else 1 / np.sqrt(hd))
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    sc = sc * np.log2(np.e)
    lim = lens.long()[:, None] - s + 1 + torch.arange(s)[None]            # (b, s)
    pos = torch.arange(keys)
    seen = pos[None, None] < lim[:, :, None]
    if window:
        seen = seen & (pos[None, None] >= lim[:, :, None] - window)
    seen = seen[:, None, None]                                            # (b,1,1,s,T)
    parts = []
    for k0 in range(0, keys, kps):
        m = torch.full((b, nkv, g, s), -torch.inf)
        l = torch.zeros(b, nkv, g, s)
        o = torch.zeros(b, nkv, g, s, hd)
        for t0 in range(k0, min(k0 + kps, keys), 64):
            cols = pos[t0:min(t0 + 64, keys)]
            x = torch.where(seen[..., cols], sc[..., cols], -torch.inf)
            mn = torch.maximum(m, x.amax(-1))
            mu = torch.where(mn == -torch.inf, 0.0, mn)
            alpha = torch.exp2(m - mu)
            m = mn
            p = torch.exp2(x - mu[..., None])
            l = l * alpha + p.sum(-1)
            hi = _bf16(p)
            o = o * alpha[..., None] + torch.einsum("bngst,nbtd->bngsd", hi + _bf16(p - hi),
                                                    vv[:, :, cols])
        parts.append((m, l, o))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum = torch.zeros_like(parts[0][1])
    osum = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        f = torch.where(m == -torch.inf, 0.0, torch.exp2(m - torch.where(mx == -torch.inf, 0.0,
                                                                         mx)))
        lsum = lsum + l * f
        osum = osum + o * f[..., None]
    out = torch.where(lsum[..., None] == 0, 0.0,
                      osum / torch.where(lsum == 0, 1.0, lsum)[..., None])
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, nh, hd)


# (kv heads, group, page size): Gemma-2-9B's 16/8 and Gemma-7B's 16/16 at
# hd 256, over the engine's 128-token pages and 16-token ones
DECODE_HD256 = {"g=2 ps=128": (1, 2, 128), "g=1 ps=128": (2, 1, 128),
                "g=2 ps=16": (1, 2, 16), "g=1 ps=16": (2, 1, 16)}


@pytest.mark.parametrize("case", list(DECODE_HD256))
def test_decode_hd256_model_under_its_plan_matches_plain_and_jax(case):
    """#9's hd-256 decode under the hd-256 plan (32-key splits; 3 SMs, so
    the keys split) with window 20, softcap 2.5 and scale 1/16: the kernel's
    model (_decode_mma_model, 32-key tiles in two halves) and the split emulation (_split_merge_plain)
    against the plain version and the JAX kernel (interpret mode). Inputs
    are bf16 values, as the kernel's pool holds. The emulation keeps p in
    f32 (1e-5); the model carries it as two bf16 parts, each p to 2^-17 of
    itself, so within 2^-16 of the largest |v|."""
    nkv, g, ps = DECODE_HD256[case]
    lengths = (37, 128, 1, 90) if ps == 16 else (37, 384, 1, 300)
    b, mp, hd = len(lengths), 128 * 3 // ps if ps == 128 else 8, 256
    kw = dict(window=20, softcap=2.5, sm_scale=1 / 16)
    rng = np.random.default_rng(g + ps)
    k, v, idx, lens = _paged_pool(rng, b, nkv, hd, ps, b * mp + 3, lengths, mp)
    q = rng.standard_normal((b, 1, nkv * g, hd)).astype(np.float32)
    q, k, v = (_bf16(torch.from_numpy(a)).numpy() for a in (q, k, v))
    kps = tpa.paged_split_plan(mp, ps, b, nkv, 3, hd=hd)
    assert kps % 32 == 0 and tpa.paged_splits(mp, ps, kps) > 1
    tq, tk, tv, ti, tl = (torch.from_numpy(a) for a in (q, k, v, idx, lens))
    plain = tpa.paged_attention_plain(tq[:, 0], tk, tv, ti, tl, **kw)
    kern = np.asarray(jpa.paged_attention(*(jnp.asarray(a) for a in (q[:, 0], k, v, idx, lens)),
                                          interpret=True, **kw))
    split = _split_merge_plain(tq, tk, tv, ti, tl, kps, **kw)[:, 0]
    np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(split.numpy(), kern, atol=1e-5)
    model = _decode_mma_model(tq[:, 0], tk, tv, ti, tl, kps, 32, 2, **kw)
    tol = 2.0 ** -16 * np.abs(v).max()
    np.testing.assert_allclose(model.numpy(), plain.numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(model.numpy(), kern, atol=tol, rtol=0)


# (hd, kv heads, group): the hd-64/96 decode kernel at g 1 (Phi-3-mini), 2
# and 7 (Qwen2.5-0.5B)
DECODE_NARROW = {f"hd={hd} g={g}": (hd, nkv, g) for hd in (64, 96)
                 for g, nkv in ((1, 2), (2, 2), (7, 1))}


@pytest.mark.parametrize("case", list(DECODE_NARROW))
def test_decode_narrow_model_under_its_plan_matches_plain_and_jax(case):
    """#9's hd-64/96 decode (rk_paged_decode_narrow_kernel) under its plan
    (64-key splits; 3 SMs, so the keys split) with window 20, softcap 2.5
    and scale 1/16: the kernel's model (_decode_mma_model, 64-key tiles in
    four 16-key quarters) against the plain version, the JAX kernel
    (interpret mode) and paged_attention_ref, within 2^-16 of the largest
    |v| (p as two bf16 parts). Inputs are bf16 values."""
    hd, nkv, g = DECODE_NARROW[case]
    lengths, b, ps, mp = (37, 128, 1, 90), 4, 16, 8
    kw = dict(window=20, softcap=2.5, sm_scale=1 / 16)
    rng = np.random.default_rng(hd + g)
    k, v, idx, lens = _paged_pool(rng, b, nkv, hd, ps, b * mp + 3, lengths, mp)
    q = rng.standard_normal((b, nkv * g, hd)).astype(np.float32)
    q, k, v = (_bf16(torch.from_numpy(a)).numpy() for a in (q, k, v))
    kps = tpa.kernel_split(b, 1, nkv * g, nkv, ps, mp, torch.bfloat16, 3, hd)
    assert tpa.split_unit(hd) == 64 and kps % 64 == 0 and tpa.paged_splits(mp, ps, kps) > 1
    tq, tk, tv, ti, tl = (torch.from_numpy(a) for a in (q, k, v, idx, lens))
    model = _decode_mma_model(tq, tk, tv, ti, tl, kps, 64, 4, **kw)
    args = [jnp.asarray(a) for a in (q, k, v, idx, lens)]
    tol = 2.0 ** -16 * np.abs(v).max()
    for want in (tpa.paged_attention_plain(tq, tk, tv, ti, tl, **kw).numpy(),
                 np.asarray(jpa.paged_attention(*args, interpret=True, **kw)),
                 np.asarray(jpa.paged_attention_ref(*args, **kw))):
        np.testing.assert_allclose(model.numpy(), want, atol=tol, rtol=0)


# (kv heads, group, q_len) at hd 256: 128-row blocks of one or two
# warpgroups' 64-row slices; the spec waves' 8-token chunk; q_len 1 (at g 16
# the wrappers send decode rows here)
CHUNK_WGMMA = {f"g={g} q_len={q_len}": (3 - g, g, q_len) for g in (1, 2)
               for q_len in (1, 8, 128 // g)}
CHUNK_WGMMA["g=16 q_len=1"] = (1, 16, 1)


@pytest.mark.parametrize("case", list(CHUNK_WGMMA))
def test_chunk_wgmma_model_under_its_plan_matches_plain_and_jax(case):
    """#9's hd-256 chunk kernel (rk_paged_chunk_wgmma_kernel) under the
    chunk plan (128-row blocks, 64-key splits; 64 SMs, so the keys split)
    with window 20, softcap 2.5 and scale 1/16: the kernel's model
    (_chunk_wgmma_model) against the plain version, paged_attention_chunk_ref
    and, for chunks of up to 8 tokens, the JAX kernel in interpret mode;
    within 2^-16 of the largest |v| (p as two bf16 parts)."""
    nkv, g, q_len = CHUNK_WGMMA[case]
    b, ps, mp, hd = 4, 16, 16, 256
    lengths = [q_len + extra for extra in (0, 72, 256 - q_len, 3)]
    kw = dict(window=20, softcap=2.5, sm_scale=1 / 16)
    rng = np.random.default_rng(g + q_len)
    k, v, idx, lens = _paged_pool(rng, b, nkv, hd, ps, b * mp + 3, lengths, mp)
    q = rng.standard_normal((b, q_len, nkv * g, hd)).astype(np.float32)
    q, k, v = (_bf16(torch.from_numpy(a)).numpy() for a in (q, k, v))
    rows = -(-(q_len * g) // tpa.chunk_rows(hd))
    kps = tpa.paged_split_plan(mp, ps, b, nkv, 64, rows, hd=hd)
    assert tpa.chunk_rows(hd) == 128 and kps % 64 == 0 and tpa.paged_splits(mp, ps, kps) > 1
    tq, tk, tv, ti, tl = (torch.from_numpy(a) for a in (q, k, v, idx, lens))
    model = _chunk_wgmma_model(tq, tk, tv, ti, tl, kps, **kw)
    args = [jnp.asarray(a) for a in (q, k, v, idx, lens)]
    wants = [tpa.paged_attention_chunk_plain(tq, tk, tv, ti, tl, **kw).numpy(),
             np.asarray(jpa.paged_attention_chunk_ref(*args, **kw))]
    if q_len <= 8:
        wants.append(np.asarray(jpa.paged_attention_chunk(*args, interpret=True, **kw)))
    tol = 2.0 ** -16 * np.abs(v).max()
    for want in wants:
        np.testing.assert_allclose(model.numpy(), want.reshape(model.shape), atol=tol, rtol=0)


@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_chunk_plan_counts_the_kernels_row_blocks(hd):
    """kernel_split plans the chunk kernel with the blocks it launches: 64
    rows a block, 128 at hd 256 (two warpgroups), for chunks and for decode
    rows past DECODE_MAX_G."""
    for b, q_len, nh, nkv in ((4, 128, 16, 8), (4, 8, 16, 8), (8, 1, 16, 1), (1, 100, 28, 4)):
        rows = -(-(q_len * (nh // nkv)) // (128 if hd == 256 else 64))
        for sms in (1, H100_SMS):
            assert tpa.kernel_split(b, q_len, nh, nkv, 128, 16, torch.bfloat16, sms, hd) == \
                tpa.paged_split_plan(16, 128, b, nkv, sms, rows, hd=hd)


def test_paged_split_plan_at_the_families_serving_shapes():
    """The engine's shapes (16 pages of 128 tokens) of the families on 132
    SMs: decode at 8 rows and chunk (128 tokens) at 4; the g = 7 chunk has
    14 row tiles of 64 (896 rows). Gemma's hd-256 decode cuts 32-key
    tiles: Gemma-2-9B's 8 splits of 256 keys as before, Gemma-7B's 5 of
    416 (13 tiles of 32; 448 in 64-key tiles). Gemma's hd-256 chunk counts
    128-row blocks (2 at g 2 and 1 at g 1 a sequence and kv head: 64
    blocks), so it cuts 3 splits of 704 keys. The hd-64/96 decode kernel's
    targets: Phi-3-mini's 256 blocks at 6 an SM cut 4 splits of 512 keys,
    Qwen2.5-0.5B's 16 at 3 an SM 16 of 128."""
    kps = {label: tpa.kernel_split(8, 1, nh, nkv, 128, 16, torch.bfloat16, H100_SMS, 256)
           for label, nh, nkv in (("Gemma-2-9B", 16, 8), ("Gemma-7B", 16, 16))}
    assert kps == {"Gemma-2-9B": 256, "Gemma-7B": 416}
    plan = {}
    for label, nh, nkv, hd in (("Gemma-2-9B", 16, 8, 256), ("Gemma-7B", 16, 16, 256),
                               ("Phi-3-mini", 32, 32, 96), ("Qwen2.5-7B", 28, 4, 128),
                               ("Qwen2.5-0.5B", 14, 2, 64)):
        for mode, b, q_len in (("decode", 8, 1), ("chunk", 4, 128)):
            plan[f"{label} {mode}"] = tpa.paged_splits(16, 128, tpa.kernel_split(
                b, q_len, nh, nkv, 128, 16, torch.bfloat16, H100_SMS, hd))
    assert plan == {"Gemma-2-9B decode": 8, "Gemma-2-9B chunk": 3, "Gemma-7B decode": 5,
                    "Gemma-7B chunk": 3, "Phi-3-mini decode": 4, "Phi-3-mini chunk": 1,
                    "Qwen2.5-7B decode": 16, "Qwen2.5-7B chunk": 1,
                    "Qwen2.5-0.5B decode": 16, "Qwen2.5-0.5B chunk": 2}


# (bkv, g, s, kv_len): Gemma-7B's and Gemma-2-9B's prefill, one Gemma-7B
# sequence, a long prompt of two kv heads, ragged and odd-group shapes
WGMMA_SPLITS = {"Gemma-7B": (16, 1, 1024, 2048), "Gemma-2-9B": (8, 2, 1024, 2048),
                "Gemma-7B b=1": (1, 1, 1024, 2048), "long": (2, 1, 4096, 4096),
                "ragged": (8, 1, 200, 256), "g=3": (4, 3, 136, 192), "g=64": (2, 64, 8, 16)}


@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("case", list(WGMMA_SPLITS))
def test_wgmma_split_plan_halves_the_longest_within_one_wave(case, sms):
    """#8's hd-256 kernel splits the keys of its longest 128-row q-blocks
    over two blocks only where the blocks still fit one wave (one a SM):
    the split q-blocks are a suffix (q-blocks reach more key tiles with
    their positions), each of at least 2 tiles and more than half the
    longest's; fewer blocks than SMs never leave a candidate unsplit."""
    bkv, g, s, kv_len = WGMMA_SPLITS[case]
    bq = 128 // g
    nq = -(-s // bq)
    tiles = [-(-min((qb + 1) * bq, s, kv_len) // 64) for qb in range(nq)]
    split_from = tattn.wgmma_split_from(bkv, g, s, kv_len, sms)
    assert 0 <= split_from <= nq
    split = tiles[split_from:]
    assert all(t >= 2 and t > tiles[-1] // 2 for t in split)
    assert bkv * (nq + len(split)) <= max(sms, bkv * nq)
    candidates = sum(t >= 2 and t > tiles[-1] // 2 for t in tiles)
    assert len(split) == min(candidates, max(0, sms - bkv * nq) // bkv)


def test_wgmma_split_plan_on_an_h100():
    """On 132 SMs Gemma's prefill (128 blocks) splits nothing; one
    Gemma-7B sequence splits its 4 longest q-blocks (12 blocks), two kv
    heads over 4,096 tokens their 16 longest (96 blocks)."""
    plan = {case: -(-shape[2] // (128 // shape[1])) - tattn.wgmma_split_from(*shape, H100_SMS)
            for case, shape in WGMMA_SPLITS.items()}
    assert plan == {"Gemma-7B": 0, "Gemma-2-9B": 0, "Gemma-7B b=1": 4, "long": 16,
                    "ragged": 1, "g=3": 3, "g=64": 0}


@pytest.mark.parametrize("hd,dtype,sms", [(256, torch.bfloat16, H100_SMS),
                                          (256, torch.bfloat16, 1),
                                          (256, torch.float32, H100_SMS),
                                          (128, torch.bfloat16, H100_SMS)])
def test_flash_wrapper_passes_the_split(hd, dtype, sms, monkeypatch):
    """A CUDA-route call of #8 (stand-in library) passes rk_flash_gqa the
    plan's first split q-block, an f32 workspace of 128 x 258 floats a
    split q-block and twice as many zeroed ticket words, for bf16 at hd
    256 (on 1 SM nothing splits: split_from is the q-block count, 8, and
    no buffer goes); f32 and hd 128 pass 0 and no buffer. One flash_gqa
    launch a call."""
    rec = _EntryRecorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    monkeypatch.setattr(kernels, "require_cuda", lambda *args: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda index: sms)
    kernels.reset_counts()
    bkv, g, s, kv_len = 1, 1, 1024, 2048
    q = torch.zeros(bkv, g, s, hd, dtype=dtype)
    k = torch.zeros(bkv, kv_len, hd, dtype=dtype)
    tattn._flash_gqa_cuda(q, k, k, 1 / 16)
    (name, args), = rec.calls
    assert name == "rk_flash_gqa" and args[3:8] == (bkv, g, s, kv_len, hd)
    split_from, ws, tickets = args[10:13]
    if hd == 256 and dtype == torch.bfloat16 and sms > 1:
        assert split_from == tattn.wgmma_split_from(bkv, g, s, kv_len, sms) == 4
        assert ws is not None and tickets is not None
    else:
        assert split_from == (8 if hd == 256 and dtype == torch.bfloat16 else 0)
        assert ws is None and tickets is None
    assert kernels.launch_counts()["flash_gqa"] == 1
    kernels.reset_counts()


def test_paged_split_merge_skips_whole_splits_outside_the_window():
    """A window of 20 over 128 keys in 16-key splits: the splits wholly
    before the window (or past the length) see no key, write (-inf, 0) and
    drop out of the merge; the result equals the one-split result."""
    rng = np.random.default_rng(11)
    k, v, idx, lens = _paged_pool(rng, 1, 1, 16, 16, 9, (128,), 8)
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 16)).astype(np.float32))
    args = [torch.from_numpy(a) for a in (k, v, idx, lens)]
    split = _split_merge_plain(q, *args, 64, window=20)
    whole = _split_merge_plain(q, *args, 128, window=20)
    torch.testing.assert_close(split, whole, atol=1e-6, rtol=0)
    torch.testing.assert_close(
        split[:, 0], tpa.paged_attention_plain(q[:, 0], *args, window=20), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# #3: the W8A16 decode matmul's split-K plan
# ---------------------------------------------------------------------------

LLAMA_8B = {"q": (4096, 4096), "k": (4096, 1024), "gate": (4096, 14336),
            "down": (14336, 4096)}
INT8_TINY = {"tiny": (1536, 512), "narrow": (64, 48), "odd k": (1040, 1024)}


@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("m", [1, 2, 3, 8])
@pytest.mark.parametrize("shape", list({**LLAMA_8B, **INT8_TINY}))
def test_int8_plan_covers_k_and_n(shape, m, sms):
    k, n = {**LLAMA_8B, **INT8_TINY}[shape]
    ks = qm.int8_matmul_plan(m, k, n, sms)
    x_rows = 1 << (m - 1).bit_length()
    assert ks % 64 == 0 and ks * x_rows <= 12288
    ranges = qm.int8_slices(k, ks)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(k0 < k1 for k0, k1 in ranges)
    strips = -(-n // 512)
    assert (strips - 1) * 512 < n <= strips * 512
    # the slices that give two blocks on every SM, each cut to a whole
    # number of 64-row steps (which may round to fewer slices) and no longer
    # than x's staging buffer holds
    wanted = -(-2 * sms // strips)
    cap = 12288 // x_rows // 64 * 64
    assert ks == min(cap, -(-(-(-k // wanted)) // 64) * 64)
    assert len(ranges) <= wanted or ks == cap


def test_int8_plan_on_an_h100():
    """The 8B decode projections at m = 1 on 132 SMs: 256 blocks for q and
    down, 128 for k/v, 280 for gate/up."""
    slices = {name: len(qm.int8_slices(k, qm.int8_matmul_plan(1, k, n, H100_SMS)))
              for name, (k, n) in LLAMA_8B.items()}
    assert slices == {"q": 32, "k": 64, "gate": 10, "down": 32}


def _int8_split_k_plain(x, w_q, scale, k_slice):
    """The kernel's sums: per slice, each of 8 warps' runs of rows in f32,
    the warps added in order, the slices added in order, then the scale and
    one rounding to x's dtype."""
    xf, wf = x.float(), w_q.float()
    acc = None
    for k0, k1 in qm.int8_slices(x.shape[1], k_slice):
        per_warp = -(-(k1 - k0) // 8)
        part = None
        for j0 in range(k0, k1, per_warp):
            j1 = min(k1, j0 + per_warp)
            run = xf[:, j0:j1] @ wf[j0:j1]
            part = run if part is None else part + run
        acc = part if acc is None else acc + part
    return (acc * scale.float()[None]).to(x.dtype)


@pytest.mark.parametrize("sms", [1, 8, H100_SMS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8])
def test_int8_split_k_plain_matches_plain_and_jax(m, dtype, sms):
    k, n = INT8_TINY["tiny"]
    rng = np.random.default_rng(m + sms)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random(n) * 2e-2 + 1e-2).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    want = np.asarray(jqm.int8_matmul(jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(s),
                                      interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt)
    ks = qm.int8_matmul_plan(m, k, n, sms)
    got = _int8_split_k_plain(tx, torch.from_numpy(w), torch.from_numpy(s), ks)
    assert got.dtype == tdt and got.shape == (m, n)
    _close(got, qm.int8_matmul_plain(tx, torch.from_numpy(w), torch.from_numpy(s)).float().numpy(),
           dtype)
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# #4: the W4A16 decode matmul's split-K plan (m <= 8)
# ---------------------------------------------------------------------------

# "short": tile_k = k = 1040, whose 520 packed rows a tile leave a short
# last slice; its quality group 130 crosses the warps' runs
INT4_TINY = {"tiny": (1024, 512), "short": (1040, 512), "wide": (1536, 1024)}


def _int4_groups(k):
    tile_k = qm.int4_tiling(k)[0]
    return [128, tile_k] if tile_k % 128 == 0 else [tile_k // 8, tile_k]


@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("shape", list({**LLAMA_8B, **INT4_TINY}))
def test_int4_decode_plan_covers_every_packed_row(shape, m, sms):
    k, n = {**LLAMA_8B, **INT4_TINY}[shape]
    tile_k = qm.int4_tiling(k)[0]
    half, tiles = tile_k // 2, k // tile_k
    x_rows = 1 << (m - 1).bit_length()
    for group in _int4_groups(k):
        assert qm.int4_decode_viable(m, tile_k, group)
        ks = qm.int4_decode_plan(m, k, n, tile_k, group, sms)
        assert ks % 2 == 0 and 2 <= ks <= half and 2 * ks * x_rows <= 12288
        assert ks % 64 == 0 or ks == half
        ranges = qm.int4_decode_slices(k, tile_k, ks)
        assert ranges[0][0] == 0 and ranges[-1][1] == k // 2
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0
        for p0, p1 in ranges:
            assert p0 < p1 and p0 // half == (p1 - 1) // half     # one k-tile
            assert p1 - p0 == ks or p1 % half == 0                # only a tile's last is short
        assert len(ranges) == tiles * -(-half // ks)
        # as few slices a tile as give the plan's blocks on every SM over
        # the 512-column strips, cut to whole 64-row steps (which may round
        # to fewer slices), within the half tile and x's staging buffer
        wanted = -(-qm._INT4_BLOCKS_PER_SM * sms // -(-n // 512))
        cap = 12288 // (2 * x_rows) // 64 * 64
        assert ks == min(cap, half, -(-(-(-half // -(-wanted // tiles))) // 64) * 64)


def test_int4_decode_plan_on_an_h100():
    """The 8B decode projections at group 128 on 132 SMs, m 1 and 8: 256
    blocks for q and o, 64 for k/v, 448 for gate/up and down (two slices a
    k-tile: one gives 224)."""
    for m in (1, 8):
        slices = {name: len(qm.int4_decode_slices(k, 512, qm.int4_decode_plan(
            m, k, n, 512, 128, H100_SMS))) for name, (k, n) in LLAMA_8B.items()}
        assert slices == {"q": 32, "k": 32, "gate": 16, "down": 56}
    ks = qm.int4_decode_plan(1, 1040, 512, 1040, 130, H100_SMS)
    assert ks == 64 and qm.int4_decode_slices(1040, 1040, ks)[-1] == (512, 520)


@pytest.mark.parametrize("shape,group", [("tiny", 128), ("short", 1040)])
def test_int4_decode_models_agree(shape, group):
    """Both kernels' sums in bf16 (the scalar kernel's model too, though
    the wrapper sends bf16 to the tensor cores here) within one bf16 ulp of
    each other and of the plain version."""
    x, w_p, gs = _int4_decode_case(shape, group, 8)
    k, n = INT4_TINY[shape]
    tile_k = qm.int4_tiling(k)[0]
    tx, tw, ts = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w_p), torch.from_numpy(gs)
    ks = qm.int4_decode_plan(8, k, n, tile_k, group, H100_SMS)
    assert qm.int4_decode_tensor_cores(tile_k, group, ks, torch.bfloat16)
    assert not qm.int4_decode_tensor_cores(tile_k, group, ks, torch.float32)
    mma = _int4_decode_mma_plain(tx, tw, ts, ks)
    _close(mma, _int4_decode_plain(tx, tw, ts, ks).float().numpy(), "bfloat16")
    _close(mma, qm.int4_matmul_plain(tx, tw, ts).float().numpy(), "bfloat16")


def test_int4_decode_refuses_what_it_cannot_pair():
    """Packed rows j and j + 1 share a scale only with an even half tile
    and, on the quality route, an even group."""
    assert not qm.int4_decode_viable(9, 512, 128)
    assert not qm.int4_decode_viable(1, 1030, 1030)
    assert not qm.int4_decode_viable(1, 1040, 65)
    assert qm.int4_decode_viable(1, 1040, 1040) and qm.int4_decode_viable(8, 512, 512)
    # tensor cores: 8-row k-blocks inside one group, bf16 x only
    assert not qm.int4_decode_tensor_cores(1040, 130, 64, torch.bfloat16)
    assert not qm.int4_decode_tensor_cores(1036, 1036, 64, torch.bfloat16)
    assert not qm.int4_decode_tensor_cores(512, 128, 256, torch.float32)
    assert qm.int4_decode_tensor_cores(512, 128, 256, torch.bfloat16)
    with pytest.raises(ValueError):
        qm.int4_decode_plan(1, 1030, 512, 1030, 1030, H100_SMS)


def _int4_decode_plain(x, w_p, gs, k_slice):
    """The decode kernel's sums: weights dequantized by the route (quality:
    f32(q) * scale, rounded to x's dtype; output-scaled: the integers); per
    slice, each of 8 warps' even runs of packed rows (their low- and
    high-nibble x columns) in f32, the warps added in order, the sum times
    the tile's scale on the output-scaled route; the slices added in order,
    then one rounding to x's dtype."""
    m, k = x.shape
    tile_k = qm.int4_tiling(k)[0]
    group, half = k // gs.shape[0], tile_k // 2
    wd = qm.unpack_int4(w_p, tile_k).float()
    if group != tile_k:
        wd = (wd * gs.float().repeat_interleave(group, dim=0)).to(x.dtype).float()
    xf = x.float()
    acc = None
    for p0, p1 in qm.int4_decode_slices(k, tile_k, k_slice):
        t = p0 // half
        lo = t * tile_k + p0 - t * half       # x column of the slice's first low nibble
        per_warp = -(-(p1 - p0) // 8)
        per_warp += per_warp % 2
        part = None
        for j0 in range(0, p1 - p0, per_warp):
            j1 = min(p1 - p0, j0 + per_warp)
            cols = list(range(lo + j0, lo + j1)) + list(range(lo + half + j0, lo + half + j1))
            run = xf[:, cols] @ wd[cols]
            part = run if part is None else part + run
        if group == tile_k:
            part = part * gs.float()[t]
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def _int4_decode_mma_plain(x, w_p, gs, k_slice):
    """The tensor-core kernel's sums: each warp takes its columns over the
    whole slice, adding each 8-row k-block's product (low and high
    nibbles) in f32 in order; then the route's scaling and the slices in
    order, as _int4_decode_plain."""
    m, k = x.shape
    tile_k = qm.int4_tiling(k)[0]
    group, half = k // gs.shape[0], tile_k // 2
    wd = qm.unpack_int4(w_p, tile_k).float()
    if group != tile_k:
        wd = (wd * gs.float().repeat_interleave(group, dim=0)).to(x.dtype).float()
    xf = x.float()
    acc = None
    for p0, p1 in qm.int4_decode_slices(k, tile_k, k_slice):
        t = p0 // half
        lo = t * tile_k + p0 - t * half
        part = None
        for j0 in range(0, p1 - p0, 8):
            cols = list(range(lo + j0, lo + j0 + 8)) + list(range(lo + half + j0,
                                                                  lo + half + j0 + 8))
            run = xf[:, cols] @ wd[cols]
            part = run if part is None else part + run
        if group == tile_k:
            part = part * gs.float()[t]
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def _int4_decode_case(shape, group, m, seed=0):
    k, n = INT4_TINY[shape]
    rng = np.random.default_rng(k + group + m + seed)
    w_p = rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
    gs = (rng.random((k // group, n)) * 2e-2 + 1e-2).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, w_p, gs


@functools.lru_cache(maxsize=None)
def _int4_jax(shape, group, m, dtype):
    x, w_p, gs = _int4_decode_case(shape, group, m)
    jdt = DTYPES[dtype][1]
    return np.asarray(jqm.int4_matmul(jnp.asarray(x, jdt), jnp.asarray(w_p), jnp.asarray(gs),
                                      interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("sms", [1, 8, H100_SMS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("shape,group", [("tiny", 128), ("tiny", 512), ("short", 130),
                                         ("short", 1040)])
def test_int4_decode_plain_matches_plain_and_jax(shape, group, m, dtype, sms):
    """The kernel the wrapper picks (tensor cores for bf16 where
    int4_decode_tensor_cores allows, else the scalar kernel), modelled
    under the plan."""
    x, w_p, gs = _int4_decode_case(shape, group, m)
    k, n = INT4_TINY[shape]
    tile_k = qm.int4_tiling(k)[0]
    tdt = DTYPES[dtype][0]
    tx, tw, ts = torch.from_numpy(x).to(tdt), torch.from_numpy(w_p), torch.from_numpy(gs)
    ks = qm.int4_decode_plan(m, k, n, tile_k, group, sms)
    model = (_int4_decode_mma_plain if qm.int4_decode_tensor_cores(tile_k, group, ks, tdt)
             else _int4_decode_plain)
    got = model(tx, tw, ts, ks)
    assert got.dtype == tdt and got.shape == (m, n)
    _close(got, qm.int4_matmul_plain(tx, tw, ts).float().numpy(), dtype)
    _close(got, _int4_jax(shape, group, m, dtype), dtype)


class _EntryRecorder:
    """Stands in for the kernel library: records each C entry called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("m,k,group,a8,entry", [
    (1, 4096, 128, False, "rk_int4_decode"), (8, 4096, 512, False, "rk_int4_decode"),
    (3, 1040, 130, False, "rk_int4_decode"), (9, 4096, 128, False, "rk_int4_matmul"),
    (256, 4096, 128, False, "rk_int4_matmul"), (1, 1030, 1030, False, "rk_int4_matmul"),
    (1, 4096, 512, True, "rk_int4_a8_decode"), (8, 4096, 512, True, "rk_int4_a8_decode"),
    (3, 2144, 2144, True, "rk_int4_a8_decode"), (20, 4096, 512, True, "rk_int4_matmul_a8"),
    (1, 1040, 1040, True, "rk_int4_matmul_a8")])
def test_int4_wrapper_routes_decode_rows_to_the_decode_kernel(m, k, group, a8, entry,
                                                              monkeypatch):
    """W4A16 at m <= 8 calls rk_int4_decode with the plan's slice, W4A8
    at m <= 8 rk_int4_a8_decode with its own plan's; m > 8, a half tile
    the decode kernels cannot cut and W4A8 at m > 8 keep their entries;
    each call counts one int4 launch."""
    rec = _EntryRecorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    monkeypatch.setattr(kernels, "require_cuda", lambda *args: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(qm, "_target_blocks", lambda index: 2 * H100_SMS)
    kernels.reset_counts()
    n = 512
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    w_p = torch.zeros(k // 2, n, dtype=torch.int8)
    gs = torch.ones(k // group, n)
    out = qm._int4_cuda(x, w_p, gs, a8=a8)
    assert out.shape == (m, n) and [name for name, _ in rec.calls] == [entry]
    counts = kernels.launch_counts()
    assert counts["int4_matmul_a8" if a8 else "int4_matmul"] == 1 and sum(counts.values()) == 1
    if entry == "rk_int4_decode":
        tile_k = qm.int4_tiling(k)[0]
        ks = qm.int4_decode_plan(m, k, n, tile_k, group, H100_SMS)
        # bf16: the tensor cores where the k-blocks fit the groups
        assert rec.calls[0][1][3:11] == (m, k, n, tile_k, group, ks, 1, int(group % 8 == 0))
    if entry == "rk_int4_a8_decode":
        tile_k = qm.int4_tiling(k)[0]
        ks = qm.int4_a8_decode_plan(m, k, n, tile_k, H100_SMS)
        assert rec.calls[0][1][3:9] == (m, k, n, tile_k, ks, 1)
    kernels.reset_counts()


# ---------------------------------------------------------------------------
# #5: W4A8 at m <= 8 on the integer tensor cores
# ---------------------------------------------------------------------------

# "short": tile_k = k = 2144, 67 k-blocks a half tile, so no slice of more
# than one k-block divides it and the last slice of a tile is short
A8_TINY = {"tiny": (1024, 512), "wide": (1536, 1024), "short": (2144, 512)}


def _bytes_as_int8(words: np.ndarray) -> np.ndarray:
    return words.astype("<u4").view(np.int8)


def test_int4_a8_nibbles_are_16q_for_every_byte():
    """t & 0xF0F0F0F0 and (t << 4) & 0xF0F0F0F0, read as four int8, are 16
    times the high and the low signed nibble of each byte of t, for all
    256 byte values at every byte position."""
    values = np.arange(256, dtype=np.uint8)
    q = qm.unpack_int4(torch.from_numpy(values.view(np.int8)).reshape(1, 256), 2).numpy()
    for shift in range(4):
        words = np.roll(values, shift).view("<u4")           # every value at every position
        want = np.roll(q.astype(np.int32) * 16, shift, axis=1)
        np.testing.assert_array_equal(_bytes_as_int8(words & np.uint32(0xF0F0F0F0)), want[1])
        np.testing.assert_array_equal(
            _bytes_as_int8((words << np.uint32(4)) & np.uint32(0xF0F0F0F0)), want[0])


def test_int4_a8_kblock_order_covers_every_packed_row_once():
    """The mma's 32 k positions of a k-block are its 16 packed rows' low
    and high nibbles, each once; lane c's e-th row feeds positions 4c + e
    (low) and 16 + 4c + e (high), and a lane's rows are adjacent (one
    4-byte load stages their x codes); over a slice of k-blocks every
    packed row appears once with each nibble."""
    order = qm.int4_a8_kblock_order()
    assert len(order) == 32 and sorted(order) == [(r, h) for r in range(16) for h in (0, 1)]
    for c in range(4):
        rows = [order[4 * c + e][0] for e in range(4)]
        assert rows == list(range(rows[0], rows[0] + 4))
        assert all(order[4 * c + e] == (rows[e], 0) and order[16 + 4 * c + e] == (rows[e], 1)
                   for e in range(4))
    kblocks = 7
    seen = [(16 * kb + row, h) for kb in range(kblocks) for row, h in order]
    assert sorted(seen) == [(r, h) for r in range(16 * kblocks) for h in (0, 1)]


@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("shape", list({**LLAMA_8B, **A8_TINY}))
def test_int4_a8_decode_plan_covers_every_packed_row(shape, m, sms):
    k, n = {**LLAMA_8B, **A8_TINY}[shape]
    tile_k = qm.int4_tiling(k)[0]
    half, tiles = tile_k // 2, k // tile_k
    assert qm.int4_a8_decode_viable(m, tile_k)
    ks = qm.int4_a8_decode_plan(m, k, n, tile_k, sms)
    assert ks % 16 == 0 and 16 <= ks <= half and 16 * ks <= 48 * 1024
    ranges = qm.int4_decode_slices(k, tile_k, ks)
    assert ranges[0][0] == 0 and ranges[-1][1] == k // 2
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for p0, p1 in ranges:
        assert p0 < p1 and p0 // half == (p1 - 1) // half       # one k-tile
        assert (p1 - p0) % 16 == 0                               # whole k-blocks
        assert p1 - p0 == ks or p1 % half == 0                   # only a tile's last is short
    assert len(ranges) == tiles * -(-half // ks)
    # as few slices a tile as give the plan's blocks on every SM over the
    # 512-column strips, in whole k-blocks, within the half tile
    wanted = -(-qm._INT4_A8_BLOCKS_PER_SM * sms // -(-n // 512))
    assert ks == min(half, -(-(-(-half // -(-wanted // tiles))) // 16) * 16)


def test_int4_a8_decode_plan_on_an_h100():
    """The 8B decode projections on 132 SMs at m 1 and 8: 192 blocks for q
    and o, 128 for k/v, 224 for gate/up, 224 for down; k = 2144 over 14336
    columns leaves a short last slice."""
    for m in (1, 8):
        slices = {name: len(qm.int4_decode_slices(k, 512, qm.int4_a8_decode_plan(
            m, k, n, 512, H100_SMS))) for name, (k, n) in LLAMA_8B.items()}
        assert slices == {"q": 24, "k": 64, "gate": 8, "down": 28}
    ks = qm.int4_a8_decode_plan(1, 2144, 14336, 2144, H100_SMS)
    assert ks == 224 and qm.int4_decode_slices(2144, 2144, ks)[-1] == (896, 1072)


def test_int4_a8_decode_refuses_what_it_cannot_cut():
    assert not qm.int4_a8_decode_viable(9, 512)
    assert not qm.int4_a8_decode_viable(1, 1040)     # 520 packed rows: no whole k-blocks
    assert qm.int4_a8_decode_viable(8, 512) and qm.int4_a8_decode_viable(1, 2144)
    with pytest.raises(ValueError):
        qm.int4_a8_decode_plan(1, 1040, 512, 1040, H100_SMS)


def _int4_a8_decode_model(x, w_p, gs, k_slice):
    """The W4A8 decode kernel's arithmetic: x quantized per row
    (quantize_int8 in f32, as rk_quantize_rows_kernel); per slice, each
    16-row k-block's 32 products of x codes with the weights' nibbles as 16
    q (the masks of the 256-byte test), in int32-range integers, summed
    over the slice and shifted right by 4; each tile's slices added in
    int32, then acc + float(p) * x_scale * tile_scale over the tiles in
    order, one f32 rounding a step, and one rounding to x's dtype."""
    m, k = x.shape
    tile_k = qm.int4_tiling(k)[0]
    half = tile_k // 2
    xq, xs = quantize_int8(x.float(), axis=1)
    xq = xq.long()
    b = w_p.to(torch.int32) & 0xFF
    nib16 = [((b << 4) & 0xF0).to(torch.uint8).view(torch.int8).long(),   # low nibble, 16 q
             (b & 0xF0).to(torch.uint8).view(torch.int8).long()]          # high nibble, 16 q
    order = qm.int4_a8_kblock_order()
    tile_p = {}
    for p0, p1 in qm.int4_decode_slices(k, tile_k, k_slice):
        t = p0 // half
        acc = torch.zeros(m, w_p.shape[1], dtype=torch.long)
        for kb0 in range(p0, p1, 16):
            rows = [kb0 + row for row, _ in order]
            a = torch.stack([nib16[h][r] for r, (_, h) in zip(rows, order)])        # (32, n)
            cols = [t * tile_k + (r - t * half) + h * half for r, (_, h) in zip(rows, order)]
            acc += xq[:, cols] @ a
            assert acc.abs().max() < 2 ** 31
        assert bool((acc % 16 == 0).all())
        tile_p[t] = tile_p.get(t, 0) + (acc >> 4)
    out = torch.zeros(m, w_p.shape[1])
    for t in range(k // tile_k):
        out = out + tile_p[t].to(torch.int32).float() * xs * gs.float()[t]
    return out.to(x.dtype)


def _int4_a8_case(shape, m):
    k, n = A8_TINY[shape]
    rng = np.random.default_rng(k + m + 5)
    w_p = rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
    gs = (rng.random((k // qm.int4_tiling(k)[0], n)) * 2e-2 + 1e-2).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, w_p, gs


@functools.lru_cache(maxsize=None)
def _int4_a8_jax(shape, m, dtype):
    """(JAX's W4A8 definition from its own quantizer and unpacker, its
    interpreted kernel), as f32 numpy."""
    x, w_p, gs = _int4_a8_case(shape, m)
    jdt = DTYPES[dtype][1]
    jx = jnp.asarray(x, jdt)
    tile_k = qm.int4_tiling(x.shape[1])[0]
    xq, xs = (np.asarray(a) for a in jtopk.quantize_int8(jx.astype(jnp.float32), axis=1))
    w = np.asarray(jqm.unpack_int4(jnp.asarray(w_p), tile_k)).astype(np.int64)
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for t in range(x.shape[1] // tile_k):
        p = xq[:, t * tile_k:(t + 1) * tile_k].astype(np.int64) @ w[t * tile_k:(t + 1) * tile_k]
        acc = acc + p.astype(np.float32) * xs * gs[t]
    definition = np.asarray(jnp.asarray(acc).astype(jdt).astype(jnp.float32))
    kernel = np.asarray(jqm.int4_matmul(jx, jnp.asarray(w_p), jnp.asarray(gs), a8=True,
                                        interpret=True).astype(jnp.float32))
    return definition, kernel


@pytest.mark.parametrize("sms", [1, 8, H100_SMS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("shape", list(A8_TINY))
def test_int4_a8_decode_model_matches_plain_and_jax(shape, m, dtype, sms):
    """The kernel's integer sums under its plan and the tile-order reduce
    equal int4_matmul_a8_plain and JAX's W4A8 definition (its quantize_int8
    and unpack_int4, the same epilogue) bit for bit. JAX's interpreted
    Pallas kernel is held within one bf16 ulp (f32: 2e-5) of the largest
    output, as tests/test_torch_ops.py holds the route: its jitted
    epilogue differs by an f32 ulp and its in-kernel quantizer can move a
    code."""
    x, w_p, gs = _int4_a8_case(shape, m)
    k, n = A8_TINY[shape]
    tdt = DTYPES[dtype][0]
    tx, tw, ts = torch.from_numpy(x).to(tdt), torch.from_numpy(w_p), torch.from_numpy(gs)
    ks = qm.int4_a8_decode_plan(m, k, n, qm.int4_tiling(k)[0], sms)
    got = _int4_a8_decode_model(tx, tw, ts, ks)
    assert got.dtype == tdt and got.shape == (m, n)
    assert torch.equal(got, qm.int4_matmul_a8_plain(tx, tw, ts))
    definition, kernel = _int4_a8_jax(shape, m, dtype)
    np.testing.assert_array_equal(got.float().numpy(), definition)
    _close(got, kernel, dtype)


# ---------------------------------------------------------------------------
# #13: the int4 expert gather on #4's decode kernels, one slot a block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("slots", [1, 2, 3, 16, 64])
@pytest.mark.parametrize("shape", list({**MIXTRAL, **INT4_TINY}))
def test_int4_gather_plan_covers_every_packed_row_of_every_slot(shape, slots, sms):
    """The grid (strips, slices, slots) reads every packed row of every
    slot's expert exactly once in each 512-column strip, in slices of one
    k-tile within both kernels' staging buffers (one x row), the slots
    counted as blocks towards the plan's target."""
    k, n = {**MIXTRAL, **INT4_TINY}[shape]
    tile_k = qm.int4_tiling(k)[0]
    half, strips = tile_k // 2, n // 512
    for group in _int4_groups(k):
        ks = moe.int4_gather_plan(slots, k, n, tile_k, group, sms)
        assert ks % 2 == 0 and 2 <= ks <= half and 2 * ks <= 12288 and 32 * ks <= 48 * 1024
        ranges = qm.int4_decode_slices(k, tile_k, ks)
        seen = np.zeros((slots, k // 2), np.int32)
        for _strip in range(strips):
            for p0, p1 in ranges:
                assert p0 // half == (p1 - 1) // half               # one k-tile
                seen[:, p0:p1] += 1                                  # grid.z: every slot
        assert (seen == strips).all()
        # as few slices as give the plan's blocks an SM over strips x slots
        wanted = -(-qm._INT4_BLOCKS_PER_SM * sms // (strips * slots))
        tiles = k // tile_k
        assert ks == min(half, -(-(-(-half // -(-wanted // tiles))) // 64) * 64)


def test_int4_gather_plan_on_an_h100():
    """Mixtral decode on 132 SMs at 2 slots: gate/up 28 strips x 2 slots x
    16 slices (two a k-tile), down 8 x 2 x 56, 896 blocks each against the
    528 the plan aims at; at 64 slots one slice a k-tile, the grid within
    limits and the partial 29.4 MB."""
    for name, (k, n) in MIXTRAL.items():
        tiles = k // 512
        for group in (128, 512):
            ks = moe.int4_gather_plan(2, k, n, 512, group, H100_SMS)
            assert ks == 128 and qm.int4_decode_tensor_cores(512, group, ks, torch.bfloat16)
            slices = len(qm.int4_decode_slices(k, 512, ks))
            assert slices == 2 * tiles and slices == {"gate": 16, "up": 16, "down": 56}[name]
            assert n // 512 * 2 * slices == 896 >= qm._INT4_BLOCKS_PER_SM * H100_SMS
            ks64 = moe.int4_gather_plan(64, k, n, 512, group, H100_SMS)
            slices64 = len(qm.int4_decode_slices(k, 512, ks64))
            assert ks64 == 256 and slices64 == tiles
            assert slices64 * 64 * n * 4 == 29_360_128 and slices64 <= 65535


# (slots, k, n, group, dtype, C entry or None for the fallback, tensor-core flag)
GATHER_ROUTES = {
    "bf16 group 128 gate": (2, 4096, 14336, 128, torch.bfloat16, "rk_moe_gather_int4_decode", 1),
    "bf16 group 512 down": (2, 14336, 4096, 512, torch.bfloat16, "rk_moe_gather_int4_decode", 1),
    "f32 group 128 gate": (2, 4096, 14336, 128, torch.float32, "rk_moe_gather_int4_decode", 0),
    "bf16 group 130": (3, 1040, 512, 130, torch.bfloat16, "rk_moe_gather_int4_decode", 0),
    "bf16 64 slots": (64, 1024, 512, 128, torch.bfloat16, "rk_moe_gather_int4_decode", 1),
    "n 768": (2, 1024, 768, 128, torch.bfloat16, "rk_moe_gather_int4", None),
    "65 slots": (65, 1024, 512, 128, torch.bfloat16, None, None),
}


@pytest.mark.parametrize("case", list(GATHER_ROUTES))
def test_int4_gather_wrapper_routes_to_the_decode_kernels(case, monkeypatch):
    """A stand-in library records the C entry each call reaches: n % 512 ==
    0 the decode kernels' gather entry with the plan's slice and the
    tensor-core flag int4_decode_tensor_cores gives (bf16 at Mixtral's
    shapes: 1; f32 and group 130: 0), n = 768 the older kernel, 65 slots
    the fallback (no entry). Each kernel call counts one moe_gather_int4."""
    slots, k, n, group, dtype, entry, tc = GATHER_ROUTES[case]
    rec = _EntryRecorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    monkeypatch.setattr(kernels, "require_cuda", lambda *args: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(moe, "_target_blocks", lambda index: 2 * H100_SMS)
    fallback = []
    real_fallback = moe._gather_int4_fallback
    monkeypatch.setattr(moe, "_gather_int4_fallback",
                        lambda *a: fallback.append(1) or real_fallback(*a))
    kernels.reset_counts()
    tile_k = qm.int4_tiling(k)[0]
    x = torch.zeros(slots, k, dtype=dtype)
    w_p = torch.zeros(1, k // 2, n, dtype=torch.int8)
    gs = torch.ones(1, k // group, n)
    ids = torch.zeros(slots, dtype=torch.int32)
    if entry is None:
        out = moe.moe_gather_matmul_int4(x, w_p, gs, ids, tile_k, group)
        assert fallback == [1] and rec.calls == []
        assert not any(kernels.launch_counts().values())
    else:
        out = moe._gather_int4_cuda(x, w_p, gs, ids, tile_k, group)
        assert [name for name, _ in rec.calls] == [entry] and fallback == []
        counts = kernels.launch_counts()
        assert counts["moe_gather_int4"] == 1 and sum(counts.values()) == 1
        if tc is not None:
            ks = moe.int4_gather_plan(slots, k, n, tile_k, group, H100_SMS)
            assert rec.calls[0][1][4:12] == (slots, k, n, tile_k, group, ks,
                                             kernels.dtype_code(dtype), tc)
    assert out.shape == (slots, n) and out.dtype == dtype
    kernels.reset_counts()


SASS = """
        Function : _ZN4demo25rk_int4_decode_mma_kernelILb0EEEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;     /* 0x00000a0000017a02 */
        /*0010*/                   F2FP.BF16.F32.PACK_AB R2, R3, R4 ;
        /*0020*/                   HADD2.BF16_V2 R5, R5, -136, -136 ;
        /*0030*/                   F2FP.BF16.F32.PACK_AB R6, R3, R4 ;
        /*0040*/              @!P0 BRA 0x20 ;
        /*0050*/                   EXIT ;
        Function : _ZN4demo6other_kernelEv
        /*0000*/                   EXIT ;
"""


SASS_A8 = """
        Function : _ZN4demo24rk_int4_a8_decode_kernelEv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   PRMT R2, R3, 0x5140, R4 ;
        /*0020*/                   LOP3.LUT R5, R2, 0xf0f0f0f0, RZ, 0xc0, !PT ;
        /*0030*/                   IMMA.16832.S8.S8 R8, R12, R16, R8 ;
        /*0040*/              @!P0 BRA 0x10 ;
        /*0050*/                   I2F.U32.RP R6, R7 ;
        /*0060*/                   EXIT ;
"""


def test_sass_count_reads_the_integer_kernel():
    """W4A8's decode kernel: the main loop is the backward branch around
    the IMMAs, each 8 packed bytes a lane; PRMT, LOP3 and instructions per
    packed byte, and no conversion inside the loop."""
    from ragmeup_tpu_torch.tools import sass_count
    kernel = sass_count.instructions(SASS_A8)["_ZN4demo24rk_int4_a8_decode_kernelEv"]
    loop = sass_count.main_loop(kernel, sass_count._is_imma)
    assert [addr for addr, _, _ in loop] == [0x10, 0x20, 0x30, 0x40]
    counts = sass_count.summarize(sass_count.opcode_counts(loop), integer=True)
    assert counts["imma"] == 1 and counts["packed_bytes"] == 8
    assert counts["prmt"] == 1 and counts["lop3"] == 1 and counts["conversions"] == {}
    assert counts["instructions_per_packed_byte"] == 0.5
    whole = sass_count.summarize(sass_count.opcode_counts(kernel), integer=True)
    assert whole["conversions"] == {"I2F.U32.RP": 1}
    assert whole["conversions_per_packed_byte"] == 1 / 8


def test_sass_count_reads_a_listing():
    """tools/sass_count.py: opcodes by function, the main loop as the
    backward branch around the nibble pairs, conversions per packed byte
    (one bf16 HADD2 a byte) for the kernel and for its loop."""
    from ragmeup_tpu_torch.tools import sass_count
    code = sass_count.instructions(SASS)
    assert list(code) == ["_ZN4demo25rk_int4_decode_mma_kernelILb0EEEvv",
                          "_ZN4demo6other_kernelEv"]
    kernel = code["_ZN4demo25rk_int4_decode_mma_kernelILb0EEEvv"]
    whole = sass_count.summarize(sass_count.opcode_counts(kernel))
    assert whole["instructions"] == 6 and whole["bf16_nibble_pairs"] == 1
    assert whole["conversions"] == {"F2FP.BF16.F32.PACK_AB": 2}
    assert whole["conversions_per_packed_byte"] == 2.0
    loop = sass_count.main_loop(kernel)
    assert [addr for addr, _, _ in loop] == [0x20, 0x30, 0x40]
    assert sass_count.summarize(sass_count.opcode_counts(loop))[
        "conversions_per_packed_byte"] == 1.0


# ---------------------------------------------------------------------------
# #6: the fused int4 MLP on #4's tensor-core stream
# ---------------------------------------------------------------------------

MLP_8B = (4096, 14336)
MLP_TINY = (512, 1024)


def _mlp_plan(m, h, inter, sms, dtype=torch.bfloat16):
    return qm.fused_mlp_int4_plan(m, h, inter, 512, 128, 512, 128, dtype, sms)


@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_mlp_int4_plan_covers_every_packed_row(m, sms):
    """Each phase's slices cover every packed row of its matrix once, in
    order, in whole 8-row k-blocks inside one 512-row packing tile; gate/up
    slices fit the kernel's one staging item a thread (at most 256 rows);
    each phase's blocks (512-column strips x slices) fill one wave of
    resident blocks where a slice a tile allows it; the last block of a
    strip sums it at m = 1, reduce launches above."""
    h, inter = MLP_8B
    plan = _mlp_plan(m, h, inter, sms)
    assert plan.route == ("last_block" if m == 1 else "reduce")
    assert plan.ks_gu <= 256
    for k, n, ks, resident in ((h, inter, plan.ks_gu, qm._MLP4_RESIDENT["gate_up"]),
                               (inter, h, plan.ks_dn, qm._MLP4_RESIDENT["down"])):
        half = 256
        assert ks % 8 == 0 and 64 <= ks <= half
        ranges = qm.int4_decode_slices(k, 512, ks)
        assert ranges[0][0] == 0 and ranges[-1][1] == k // 2
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0
        for p0, p1 in ranges:
            assert p0 // half == (p1 - 1) // half and (p1 - p0) % 8 == 0
            assert p1 - p0 == ks or p1 % half == 0
        blocks = n // 512 * len(ranges)
        per_tile = len(ranges) // (k // 512)
        assert per_tile == 1 or blocks <= resident * sms
        # one more slice a tile would have left the wave, unless the slices
        # are already at their 64-row floor
        more = n // 512 * (k // 512) * (per_tile + 1)
        assert more > resident * sms or ks == 64


def test_mlp_int4_plan_on_an_h100():
    """The 8B MLP on 132 SMs: gate/up in slices of 256 rows (one a k-tile:
    28 x 8 = 224 blocks of 8 warps, two can reside an SM), down in 128 (8 x
    56 = 448 blocks of 4 warps, four an SM); f32 and shapes without whole
    512-column strips take the scalar kernels."""
    for m in (1, 2, 8):
        plan = _mlp_plan(m, *MLP_8B, H100_SMS)
        assert plan == qm.MlpInt4Plan("last_block" if m == 1 else "reduce", 256, 128)
        assert len(qm.int4_decode_slices(4096, 512, plan.ks_gu)) == 8
        assert len(qm.int4_decode_slices(14336, 512, plan.ks_dn)) == 56
    assert _mlp_plan(3, *MLP_8B, H100_SMS, torch.float32).route == "scalar"
    assert qm.fused_mlp_int4_plan(1, 768, 1024, 768, 128, 512, 128, torch.bfloat16,
                                  H100_SMS).route == "scalar"
    assert qm.fused_mlp_int4_plan(9, *MLP_8B, 512, 128, 512, 128, torch.bfloat16,
                                  H100_SMS).route == "scalar"


def _mlp_case(m, seed=0):
    h, inter = MLP_TINY
    rng = np.random.default_rng(100 + m + seed)
    x = rng.standard_normal((m, h)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    ws = []
    for k, n in ((h, inter), (h, inter), (inter, h)):
        ws.append(rng.integers(-128, 128, (k // 2, n)).astype(np.int8))
        ws.append((rng.random((k // 128, n)) * 2e-3 + 1e-3).astype(np.float32))
    return x, nw, ws


@functools.lru_cache(maxsize=None)
def _mlp_jax(m, dtype):
    x, nw, ws = _mlp_case(m)
    jdt = DTYPES[dtype][1]
    out = jqm.fused_mlp_int4(jnp.asarray(x, jdt), jnp.asarray(nw), *map(jnp.asarray, ws),
                             interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _split_sums(x, w_p, gs, ranges):
    """f32 partials of x @ dequant(w_p, gs) (each weight f32(q) * scale
    rounded to x's dtype), one a slice of packed rows (p0, p1), each the sum
    of its 8-row k-blocks in order (low and high nibbles), as the stream
    sums them; the partials in slice order."""
    k = x.shape[1]
    half = 256
    wd = qm.unpack_int4(w_p, 512).float()
    wd = (wd * gs.float().repeat_interleave(k // gs.shape[0], dim=0)).to(x.dtype).float()
    xf = x.float()
    parts = []
    for p0, p1 in ranges:
        t = p0 // half
        lo = t * 512 + p0 - t * half
        part = None
        for j0 in range(0, p1 - p0, 8):
            cols = list(range(lo + j0, lo + j0 + 8)) + list(range(lo + half + j0,
                                                                  lo + half + j0 + 8))
            run = xf[:, cols] @ wd[cols]
            part = run if part is None else part + run
        parts.append(part)
    return parts


def _fused_mlp_model(x, nw, ws, ks_gu, ks_dn):
    """The tensor-core route's order of sums: RMSNorm in f32 rounded to x's
    dtype; gate and up slice by slice over ``ks_gu`` packed rows, their
    partials added in slice order, then silu(g) * u rounded to x's dtype;
    down slice by slice over ``ks_dn``, the partials in slice order, then x
    + down in f32, rounded once (the same whichever block or launch adds
    the partials)."""
    h, inter = x.shape[1], ws[0].shape[1]
    xf = x.float()
    xn = (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-5)
          * nw.float()).to(x.dtype)

    def total(parts):
        acc = None
        for part in parts:
            acc = part if acc is None else acc + part
        return acc
    g = total(_split_sums(xn, ws[0], ws[1], qm.int4_decode_slices(h, 512, ks_gu)))
    u = total(_split_sums(xn, ws[2], ws[3], qm.int4_decode_slices(h, 512, ks_gu)))
    act = (torch.nn.functional.silu(g) * u).to(x.dtype)
    d = total(_split_sums(act, ws[4], ws[5], qm.int4_decode_slices(inter, 512, ks_dn)))
    return (xf + d).to(x.dtype)


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3])
def test_fused_mlp_model_matches_plain_and_jax(m, dtype, sms):
    """The tensor-core route's sums under the plan (bf16's slices; f32 runs
    the same order of sums) against ``fused_mlp_int4_plain`` and the JAX
    kernel in interpret mode, at h 512, I 1024: f32 within 2e-5 of the
    largest output, bf16 within one bf16 ulp of it."""
    x, nw, ws = _mlp_case(m)
    tdt = DTYPES[dtype][0]
    tx, tnw = torch.from_numpy(x).to(tdt), torch.from_numpy(nw)
    tws = list(map(torch.from_numpy, ws))
    plan = _mlp_plan(m, *MLP_TINY, sms)
    got = _fused_mlp_model(tx, tnw, tws, plan.ks_gu, plan.ks_dn)
    assert got.dtype == tdt and got.shape == (m, MLP_TINY[0])
    _close(got, qm.fused_mlp_int4_plain(tx, tnw, *tws).float().numpy(), dtype)
    _close(got, _mlp_jax(m, dtype), dtype)


def test_fused_mlp_staging_is_the_streams_k_order():
    """#6 stages x an item (k-block, row) at a time from two 16-byte loads:
    word 2c' + h of the item packs values c' and c' + 4 of nibble h's load
    (__byte_perm 0x5410 / 0x7632 of words 0 and 2, 1 and 3). That is #4's
    staged order: bf16 index (kb * 8 + r) * 16 + 4c' + 2h + e holds x at
    packed row 8 kb + c' + 4e of nibble h."""
    def byte_perm(a, b, sel):
        src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
        return sum(src[(sel >> (4 * i)) & 0xF] << (8 * i) for i in range(4))

    for hh in (0, 1):
        vals = [1000 * hh + j for j in range(8)]             # bf16 value j of the load
        v = [vals[2 * q] | (vals[2 * q + 1] << 16) for q in range(4)]
        words = {hh: byte_perm(v[0], v[2], 0x5410), 2 + hh: byte_perm(v[0], v[2], 0x7632),
                 4 + hh: byte_perm(v[1], v[3], 0x5410), 6 + hh: byte_perm(v[1], v[3], 0x7632)}
        for w, word in words.items():
            for e, value in enumerate((word & 0xFFFF, word >> 16)):
                index = 2 * w + e                            # bf16 index in the item
                c_, h_, e_ = index // 4, (index // 2) % 2, index % 2
                assert h_ == hh and value == vals[c_ + 4 * e_]


@pytest.mark.parametrize("m,dtype,route", [(1, torch.bfloat16, 1), (3, torch.bfloat16, 2),
                                           (8, torch.bfloat16, 2), (3, torch.float32, 0)])
def test_fused_mlp_wrapper_passes_the_plan(m, dtype, route, monkeypatch):
    """The wrapper calls rk_fused_mlp_int4 once with the plan's route and
    slices, partials sized to the slices, ticket words only on the
    last-block route (zeroed, kept per stream and reused), and counts one
    launch."""
    rec = _EntryRecorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    monkeypatch.setattr(kernels, "require_cuda", lambda *args: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(qm, "_MLP4_TICKETS", {})
    kernels.reset_counts()
    h, inter = MLP_8B
    x = torch.zeros(m, h, dtype=dtype)
    ws = []
    for k, n in ((h, inter), (h, inter), (inter, h)):
        ws += [torch.zeros(k // 2, n, dtype=torch.int8), torch.ones(k // 128, n)]
    for _ in range(2):
        out = qm._fused_mlp_int4_cuda(x, torch.ones(h), *ws, 1e-5, 512)
        assert out.shape == (m, h) and out.dtype == dtype
    assert [name for name, _ in rec.calls] == ["rk_fused_mlp_int4"] * 2
    args = rec.calls[0][1]
    plan = _mlp_plan(m, h, inter, H100_SMS, dtype)
    assert args[8:16] == (m, h, inter, 512, 128, 512, 128, 1e-5)
    assert args[16:20] == (int(dtype == torch.bfloat16), route, plan.ks_gu, plan.ks_dn)
    parts, tickets = args[20:22], args[22]
    assert (parts == (None, None)) == (route == 0)
    assert (tickets is None) == (route != 1)
    if route == 1:
        (held,) = qm._MLP4_TICKETS.values()
        assert len(held) == 1 and held[0].numel() >= (inter + h) // 512
        assert (held[0] == 0).all() and rec.calls[1][1][22] == tickets == held[0].data_ptr()
    assert kernels.launch_counts()["fused_mlp_int4"] == 2
    kernels.reset_counts()


# ---------------------------------------------------------------------------
# #10: the int8 expert gather's stream on bf16 rows (gather_plan)
# ---------------------------------------------------------------------------

QWEN3_MOE = {"gate": (2048, 768), "down": (768, 2048)}
GATHER_TINY = {"tiny": (1024, 512), "narrow": (256, 384)}
W_DTYPES = [torch.int8, torch.bfloat16, torch.float32]


@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("slots", [1, 2, 8, 16, 64])
@pytest.mark.parametrize("wdtype", W_DTYPES)
@pytest.mark.parametrize("shape", list({**MIXTRAL, **QWEN3_MOE, **GATHER_TINY}))
def test_gather_plan_covers_k_in_whole_batches(shape, wdtype, slots, sms):
    """The slices cover k once, in order, each a whole number of the 8
    warps' double-buffered iterations (two 4-row batches) but the last,
    none longer than x's 12,288-float staging buffer; as few as give the
    plan's blocks on every SM (``_GATHER_BLOCKS_PER_SM``) over the (strip,
    slot) pairs, each cut to whole iterations (which may round to
    fewer)."""
    k, n = {**MIXTRAL, **QWEN3_MOE, **GATHER_TINY}[shape]
    ks = moe.gather_plan(slots, k, n, wdtype, sms)
    assert ks % 64 == 0 and 64 <= ks <= 12288
    ranges = moe.gather_slices(k, ks)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    assert all(k1 - k0 == ks for k0, k1 in ranges[:-1]) and 0 < ranges[-1][1] - ranges[-1][0]
    strips = -(-n // moe.gather_strip(wdtype))
    wanted = max(1, -(-moe._GATHER_BLOCKS_PER_SM * sms // (strips * slots)))
    assert ks == min(12288, -(-(-(-k // wanted)) // 64) * 64)
    assert len(ranges) <= wanted or ks == 12288


@pytest.mark.parametrize("wdtype", W_DTYPES)
@pytest.mark.parametrize("n", [768, 512, 2048, 14336, 96])
def test_gather_strips_cover_every_column_once(n, wdtype):
    """The kernel's lanes (strip x, lane l: columns x * strip + l * cols ..
    + cols, idle from n on) cover each column once: at Qwen3-30B-A3B's 768
    the last 512-column strip of int8 experts is ragged, half its lanes
    idle."""
    strip = moe.gather_strip(wdtype)
    cols = strip // 32
    assert cols * {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}[wdtype] == 16
    seen = np.zeros(n, np.int64)
    idle = 0
    for x in range(-(-n // strip)):
        for lane in range(32):
            c0 = x * strip + lane * cols
            if c0 >= n:
                idle += 1
                continue
            seen[c0:c0 + cols] += 1
    assert (seen == 1).all()
    if n == 768 and wdtype == torch.int8:
        assert idle == 16


def test_gather_plan_on_an_h100():
    """Two blocks an SM: a Mixtral decode layer at 2 slots in 5 slices of
    832 rows for gate/up (28 strips), 16 of 896 for down (8 strips); 16
    slots leave gate/up whole; Qwen3-30B-A3B at 8 slots: 16 slices of 128
    rows (2 strips, the second ragged) and 6 for down."""
    def slices(slots, k, n):
        return len(moe.gather_slices(k, moe.gather_plan(slots, k, n, torch.int8, H100_SMS)))
    assert {name: slices(2, k, n) for name, (k, n) in MIXTRAL.items()} == \
        {"gate": 5, "up": 5, "down": 16}
    assert {name: slices(16, k, n) for name, (k, n) in MIXTRAL.items()} == \
        {"gate": 1, "up": 1, "down": 3}
    assert {name: slices(8, k, n) for name, (k, n) in QWEN3_MOE.items()} == \
        {"gate": 16, "down": 6}


def _gather_stream_model(x, w, ids, scale, k_slice):
    """The bf16 gather kernel's sums: per slice, each of 8 warps' runs of
    rows in f32, the warps added in order, the slices added in order (the
    strip's last block), then the scale and one rounding to bf16."""
    wf = w.index_select(0, ids.long()).to(x.dtype).float()
    xf = x.float()
    acc = None
    for k0, k1 in moe.gather_slices(x.shape[1], k_slice):
        per_warp = -(-(k1 - k0) // 8)
        part = None
        for j0 in range(k0, k1, per_warp):
            j1 = min(k1, j0 + per_warp)
            run = torch.einsum("sk,skn->sn", xf[:, j0:j1], wf[:, j0:j1])
            part = run if part is None else part + run
        acc = part if acc is None else acc + part
    if scale is not None:
        acc = acc * scale.index_select(0, ids.long()).float()
    return acc.to(x.dtype)


@pytest.mark.parametrize("sms", [1, 8, H100_SMS])
@pytest.mark.parametrize("kind", ["int8", "bfloat16", "float32"])
def test_gather_stream_model_matches_plain_and_jax(kind, sms):
    """The model of the kernel's sums under the plan, over 5 slots with
    two pairs on one expert each, against the plain version over the same
    slices and JAX's gather (interpret mode), within one bf16 ulp."""
    k, n = GATHER_TINY["tiny"]
    rng = np.random.default_rng(sms)
    if kind == "int8":
        w = rng.integers(-127, 128, (4, k, n)).astype(np.int8)
        s = (rng.random((4, n)) * 2e-2 + 1e-2).astype(np.float32)
    else:
        w, s = (rng.standard_normal((4, k, n)) * 0.02).astype(np.float32), None
    x = rng.standard_normal((5, k)).astype(np.float32)
    ids = np.asarray([3, 1, 3, 1, 0], np.int32)
    tw = torch.from_numpy(w)
    if kind == "bfloat16":
        tw = tw.to(torch.bfloat16)
        w = np.asarray(jnp.asarray(w, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ts = None if s is None else torch.from_numpy(s)
    ks = moe.gather_plan(5, k, n, tw.dtype, sms)
    got = _gather_stream_model(tx, tw, torch.from_numpy(ids), ts, ks)
    plain = moe.moe_gather_matmul_plain(tx, tw, torch.from_numpy(ids), ts,
                                        moe.gather_slices(k, ks))
    want = jmoe.moe_gather_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                  jnp.asarray(ids), None if s is None else jnp.asarray(s))
    _close(got, plain.float().numpy(), "bfloat16")
    _close(got, np.asarray(want.astype(jnp.float32)), "bfloat16")


# ---------------------------------------------------------------------------
# #11: the grouped-rows kernel (grouped_rows_plan, its fragments and sums)
# ---------------------------------------------------------------------------

ROWS_TINY = {"tiny": (1024, 512), "short k": (160, 256)}


@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("m,e", [(9, 8), (16, 8), (32, 8), (3, 8), (512, 128)])
@pytest.mark.parametrize("wdtype", W_DTYPES)
@pytest.mark.parametrize("shape", list({**MIXTRAL, **QWEN3_MOE, **ROWS_TINY}))
def test_grouped_rows_plan_covers_k_in_whole_steps(shape, wdtype, m, e, sms):
    """The slices cover k once, in order, in whole 16-row steps, at least a
    step for each of the 8 warps where k has them; as few as give the
    plan's blocks on every SM (``_GROUPED_BLOCKS_PER_SM``) over the (strip,
    expert) pairs min(E, m) groups can fill, or as many as the warps
    allow."""
    k, n = {**MIXTRAL, **QWEN3_MOE, **ROWS_TINY}[shape]
    strip = moe.grouped_rows_strip(wdtype)
    assert n % strip == 0
    per = moe.grouped_rows_plan(m, e, k, n, wdtype, sms)
    steps = k // 16
    ranges = moe.grouped_rows_slices(k, per)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    assert all((k1 - k0) % 16 == 0 and k1 > k0 for k0, k1 in ranges)
    assert len(ranges) == -(-steps // per)
    assert per >= min(8, steps) or len(ranges) == 1
    blocks = min(e, m) * (n // strip)
    most = max(1, steps // 8)
    if len(ranges) > 1:   # no fewer slices would have met the target
        fewer = len(ranges) - 1
        assert blocks * -(-steps // -(-steps // fewer)) < moe._GROUPED_BLOCKS_PER_SM * sms
    assert (blocks * len(ranges) >= moe._GROUPED_BLOCKS_PER_SM * sms
            or len(ranges) >= -(-steps // -(-steps // most)))


def test_grouped_rows_plan_on_an_h100():
    """One block an SM: a Mixtral layer on the dedup route (9-32 rows, 8
    experts) on 132 SMs whole (8 x 112 blocks for gate and up, 8 x 32 for
    down); 512 columns of down in 5 slices of 180 steps (8 x 4 x 5
    blocks); bf16 experts (64-column strips) whole; Qwen3's up at 512 rows
    whole (128 x 6 blocks)."""
    for m in (9, 16, 32):
        got = {name: len(moe.grouped_rows_slices(k, moe.grouped_rows_plan(
            m, 8, k, n, torch.int8, H100_SMS))) for name, (k, n) in MIXTRAL.items()}
        assert got == {"gate": 1, "up": 1, "down": 1}
    assert moe.grouped_rows_plan(16, 8, 14336, 512, torch.int8, H100_SMS) == 180
    assert {name: len(moe.grouped_rows_slices(k, moe.grouped_rows_plan(
        16, 8, k, n, torch.bfloat16, H100_SMS))) for name, (k, n) in MIXTRAL.items()} == \
        {"gate": 1, "up": 1, "down": 1}
    assert moe.grouped_rows_plan(512, 128, 2048, 768, torch.int8, H100_SMS) == 128


def _byte_perm(x: int, y: int, sel: int) -> int:
    """PRMT (__byte_perm) without the sign-replicating mode."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _bf16_bits(v: float) -> int:
    return int(np.float32(v).view(np.uint32)) >> 16


def _from_bf16(bits: int) -> float:
    return float(np.uint32(bits << 16).view(np.float32))


def _s8x2_pair(t: int):
    """common.cuh s8x2_bf16x2: the bytes at bits 0-7 and 16-23 of t as
    bf16 (low half, high half), by 0x4300 | (b & 0x7f) - 0x4300 | (b & 0x80)."""
    out = []
    for half in (t & 0xFFFF, t >> 16):
        a = _from_bf16((half & 0x7F) | 0x4300)
        b = _from_bf16((half & 0x80) | 0x4300)
        out.append(a - b)
    return out


def _word(row_bytes: np.ndarray, q: int) -> int:
    return int(row_bytes[4 * q:4 * q + 4].view(np.uint32)[0])


def _a_frag(rows, i: int, wdtype):
    """csrc/moe_matmul.cu a_frag: MMA i's four A registers as (low, high)
    bf16 values, from a lane's 4 k rows of 16 bytes each."""
    if wdtype == torch.int8:
        sel = 0x7632 if i % 2 else 0x5410
        t01 = _byte_perm(_word(rows[0], i // 2), _word(rows[1], i // 2), sel)
        t23 = _byte_perm(_word(rows[2], i // 2), _word(rows[3], i // 2), sel)
        return [_s8x2_pair(t01), _s8x2_pair(t01 >> 8), _s8x2_pair(t23), _s8x2_pair(t23 >> 8)]
    if wdtype == torch.bfloat16:
        def pair(x, y, sel):
            t = _byte_perm(x, y, sel)
            return [_from_bf16(t & 0xFFFF), _from_bf16(t >> 16)]
        return [pair(_word(rows[0], i), _word(rows[1], i), 0x5410),
                pair(_word(rows[0], i), _word(rows[1], i), 0x7632),
                pair(_word(rows[2], i), _word(rows[3], i), 0x5410),
                pair(_word(rows[2], i), _word(rows[3], i), 0x7632)]

    def rnd(r, q):
        return float(torch.tensor(float(rows[r][4 * q:4 * q + 4].view(np.float32)[0]))
                     .to(torch.bfloat16).float())
    return [[rnd(0, 2 * i), rnd(1, 2 * i)], [rnd(0, 2 * i + 1), rnd(1, 2 * i + 1)],
            [rnd(2, 2 * i), rnd(3, 2 * i)], [rnd(2, 2 * i + 1), rnd(3, 2 * i + 1)]]


@pytest.mark.parametrize("wdtype", W_DTYPES)
def test_grouped_rows_fragments_hold_the_columns_the_epilogue_writes(wdtype):
    """One 16-deep step of a warp, lane by lane: lane 4g + c loads k rows
    4c .. 4c + 3 at its 16 bytes of columns; a_frag makes each MMA's A
    fragment (mma.sync m16n8k16's layout: rows g and g + 8, k pairs 2c and
    2c + 8), x's B fragment is the row's k values 4c .. 4c + 3 (one 8-byte
    load), and the epilogue writes d0..d3 to rows 2c, 2c + 1 at columns
    2i, 2i + 1 of the lane group's. The result is x @ w (each weight cast
    to bf16) exactly, for small integers."""
    rng = np.random.default_rng(11)
    cols = 16 // {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}[wdtype]
    strip = 8 * cols
    assert strip == moe.grouped_rows_strip(wdtype)
    if wdtype == torch.int8:
        w = rng.integers(-128, 128, (16, strip)).astype(np.int8)
    else:
        w = (rng.integers(-64, 64, (16, strip)) / 8).astype(np.float32)
    wbytes = (w if wdtype != torch.bfloat16 else
              torch.from_numpy(w).to(torch.bfloat16).view(torch.int16).numpy()).view(np.uint8)
    x = rng.integers(-8, 8, (8, 16)).astype(np.float32)
    red = np.full((8, strip), np.nan)
    for i in range(cols // 2):
        a = np.zeros((16, 16))
        b = np.zeros((16, 8))
        lanes = {}
        for lane in range(32):
            g, c = lane // 4, lane % 4
            rows = [wbytes[4 * c + r, g * 16:(g + 1) * 16] for r in range(4)]
            frag = _a_frag(rows, i, wdtype)
            for reg, (r0, k0) in enumerate(((g, 2 * c), (g + 8, 2 * c), (g, 2 * c + 8),
                                            (g + 8, 2 * c + 8))):
                a[r0, k0:k0 + 2] = frag[reg]
            b[[2 * c, 2 * c + 1, 2 * c + 8, 2 * c + 9], g] = x[g, 4 * c:4 * c + 4]
            lanes[lane] = (g, c)
        d = a @ b
        for lane, (g, c) in lanes.items():
            d0, d1, d2, d3 = d[g, 2 * c], d[g, 2 * c + 1], d[g + 8, 2 * c], d[g + 8, 2 * c + 1]
            red[2 * c, g * cols + 2 * i:g * cols + 2 * i + 2] = (d0, d2)
            red[2 * c + 1, g * cols + 2 * i:g * cols + 2 * i + 2] = (d1, d3)
    want = x @ torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(red, want)


def _grouped_rows_model(xs, w, scale, gsz, per):
    """The grouped-rows kernel's control flow and sums: block (slice,
    expert) finds its group's first row from the sizes before it, exits on
    an empty group, walks the group in passes of 16 rows (two 8-row tiles),
    each of 8 warps summing its interleaved 16-row steps in f32, the warps
    added in order; one slice writes the output, more write partials that
    the last block adds in slice order; the scale, one rounding. Every
    output row must be written exactly once."""
    m, k = xs.shape
    e, _, n = w.shape
    steps = k // 16
    slices = -(-steps // per)
    xf, wf = xs.float(), w.to(xs.dtype).float()
    out = torch.full((m, n), float("nan"))
    writes = torch.zeros(m, dtype=torch.int64)
    partial = torch.full((slices, m, n), float("nan"))
    sizes = gsz.tolist()
    for ex in range(e):
        start = sum(sizes[:ex])
        length = min(sizes[ex], m - start)
        if length <= 0:
            continue
        srow = None if scale is None else scale[ex].float()
        for y in range(slices):
            s0, s1 = y * per, min(steps, (y + 1) * per)
            for p0 in range(0, length, 16):
                tiles = min(2, -(-(length - p0) // 8))
                rows = torch.arange(p0, min(length, p0 + 8 * tiles)) + start
                acc = torch.zeros(len(rows), n)
                for warp in range(8):
                    run = torch.zeros(len(rows), n)
                    for s in range(s0 + warp, s1, 8):
                        run += xf[rows, s * 16:(s + 1) * 16] @ wf[ex, s * 16:(s + 1) * 16]
                    acc += run
                if slices == 1:
                    out[rows] = acc * srow if srow is not None else acc
                    writes[rows] += 1
                else:
                    partial[y, rows] = acc
        if slices > 1:
            rows = slice(start, start + length)
            acc = partial[0, rows].clone()
            for y in range(1, slices):
                acc += partial[y, rows]
            out[rows] = acc * srow if srow is not None else acc
            writes[rows] += 1
    assert (writes == 1).all()
    return out.to(xs.dtype)


ROWS_GROUPS = {"16 rows": [3, 2, 0, 4, 1, 2, 3, 1], "32 rows": [3, 2, 0, 17, 1, 2, 3, 4],
               "one group": [0, 0, 0, 0, 0, 0, 32, 0], "9 rows": [1, 1, 1, 1, 1, 1, 1, 2]}


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
@pytest.mark.parametrize("groups", list(ROWS_GROUPS))
def test_grouped_rows_model_matches_plain_and_jax(groups, kind, sms):
    """The model of the kernel under its plan (E 8; an empty group, a group
    of 17 rows over three tiles and two passes, one group of every row)
    against the plain version over the same slices and JAX's
    moe_grouped_matmul on its dedup route (interpret mode), within one bf16
    ulp of the largest output."""
    k, n = ROWS_TINY["tiny"]
    gsz = np.asarray(ROWS_GROUPS[groups], np.int32)
    m = int(gsz.sum())
    rng = np.random.default_rng(m + sms)
    if kind == "int8":
        w = rng.integers(-127, 128, (8, k, n)).astype(np.int8)
        s = (rng.random((8, n)) * 2e-2 + 1e-2).astype(np.float32)
    else:
        w = np.asarray(jnp.asarray(rng.standard_normal((8, k, n)) * 0.02, jnp.bfloat16))
        s = None
    x = rng.standard_normal((m, k)).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w) if kind == "int8" else \
        torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    ts = None if s is None else torch.from_numpy(s)
    tg = torch.from_numpy(gsz)
    per = moe.grouped_rows_plan(m, 8, k, n, tw.dtype, sms)
    got = _grouped_rows_model(tx, tw, ts, tg, per)
    plain = moe.moe_grouped_matmul_plain(tx, tw, tg, ts, moe.grouped_rows_slices(k, per))
    want = jmoe.moe_grouped_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                   jnp.asarray(gsz), None if s is None else jnp.asarray(s),
                                   tm=16, tile_k=1024, tile_n=512, no_stack=True)
    _close(got, plain.float().numpy(), "bfloat16")
    _close(got, np.asarray(want.astype(jnp.float32)), "bfloat16")


# ---------------------------------------------------------------------------
# the grouped GEMM's dw kernel (csrc/moe_wgrad.cu)
# ---------------------------------------------------------------------------

WGRAD_SHAPES = {"mixtral up": (8, 4096, 14336), "mixtral down": (8, 14336, 4096),
                "tiny": (4, 512, 256)}


@pytest.mark.parametrize("shape", list(WGRAD_SHAPES))
def test_wgrad_grid_covers_each_output_tile_once(shape):
    """wgrad_grid's blocks (n tiles fastest, k tiles, experts) name each
    128 x 128 tile of every expert's dw once: (112, 32, 8) blocks at
    Mixtral's up, (32, 112, 8) at down."""
    e, k, n = WGRAD_SHAPES[shape]
    gx, gy, gz = moe.wgrad_grid(e, k, n)
    tiles = sorted((z, y * 128, x * 128) for z in range(gz) for y in range(gy)
                   for x in range(gx))
    assert tiles == [(ex, k0, n0) for ex in range(e) for k0 in range(0, k, 128)
                     for n0 in range(0, n, 128)]
    if shape == "mixtral up":
        assert (gx, gy, gz) == (112, 32, 8)
    assert moe.wgrad_kernel_takes(k, n, torch.bfloat16)
    assert not moe.wgrad_kernel_takes(k, n, torch.float32)
    assert not moe.wgrad_kernel_takes(k + 64, n, torch.bfloat16)


def _wgrad_model(xs, dy, gsz, e):
    """csrc/moe_wgrad.cu's sums: each expert's rows from its first row (the
    earlier groups' sizes summed), 32 a stage with the rows past the group
    zero-filled, each stage two 16-row mma steps added to f32 sums in
    order; an expert with no rows keeps zeros."""
    k, n = xs.shape[1], dy.shape[1]
    out = torch.zeros(e, k, n)
    start = 0
    for ex, count in enumerate(gsz):
        for r0 in range(0, -(-count // 32) * 32, 16):
            a = torch.zeros(16, k)
            b = torch.zeros(16, n)
            live = max(0, min(16, count - r0))
            a[:live] = xs[start + r0:start + r0 + live].float()
            b[:live] = dy[start + r0:start + r0 + live].float()
            out[ex] += a.T @ b
        start += count
    return out


@pytest.mark.parametrize("gsz", [[70, 30, 0, 28], [1, 0, 0, 33], [0, 0, 0, 0], [64, 64, 64, 64]])
def test_wgrad_model_matches_plain_and_jax(gsz):
    """The dw kernel's model on bf16 rows against grouped_weight_grad_plain
    (the one-hot einsum) and the JAX package's XLA einsum of
    _grouped_kp_bwd (one-hot, f32 sums), with more rows than the groups
    hold (the rest in no group): within 1e-5 of the largest value (f32
    sums of the same bf16 products in other orders); empty experts zero."""
    import jax
    rng = np.random.default_rng(9)
    e, k, n = 4, 256, 128
    m = sum(gsz) + 5
    xs = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(torch.bfloat16)
    got = _wgrad_model(xs, dy, gsz, e)
    plain = moe.grouped_weight_grad_plain(xs, dy, torch.tensor(gsz), e)
    assert torch.equal(moe.grouped_weight_grad(xs, dy, torch.tensor(gsz), e), plain)
    csum = np.cumsum(gsz)
    eid = np.searchsorted(csum, np.arange(m), side="right")
    mask = jax.nn.one_hot(jnp.asarray(eid), e, dtype=jnp.bfloat16)
    want = np.asarray(jnp.einsum("me,mk,mn->ekn", mask, jnp.asarray(xs.float().numpy(),
                                                                      jnp.bfloat16),
                                 jnp.asarray(dy.float().numpy(), jnp.bfloat16),
                                 preferred_element_type=jnp.float32))
    big = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * big)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-5 * big)
    for ex, count in enumerate(gsz):
        if count == 0:
            assert not got[ex].any() and not plain[ex].any()


def test_wgrad_wrapper_launches_with_group_sizes_on_the_device(monkeypatch):
    """A CUDA-route call (stand-in library) passes rk_moe_grouped_wgrad the
    rows, the gradients and int32 group sizes (no host read), E, k, n,
    wgrad_grid's blocks and an f32 (E, k, n) output, and counts one
    moe_grouped_wgrad launch; f32 rows raise."""
    rec = _EntryRecorder()
    monkeypatch.setattr(kernels, "lib", lambda: rec)
    monkeypatch.setattr(kernels, "require_cuda", lambda *args: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 0)
    kernels.reset_counts()
    xs = torch.zeros(100, 256, dtype=torch.bfloat16)
    dy = torch.zeros(100, 128, dtype=torch.bfloat16)
    dw = moe._wgrad_cuda(xs, dy, torch.tensor([60, 0, 40]), 3)
    (name, args), = rec.calls
    assert name == "rk_moe_grouped_wgrad" and args[3:9] == (3, 256, 128, 1, 2, 3)
    assert dw.shape == (3, 256, 128) and dw.dtype == torch.float32
    assert kernels.launch_counts()["moe_grouped_wgrad"] == 1
    with pytest.raises(ValueError, match="bf16"):
        moe._wgrad_cuda(xs.float(), dy.float(), torch.tensor([60, 0, 40]), 3)
    kernels.reset_counts()
