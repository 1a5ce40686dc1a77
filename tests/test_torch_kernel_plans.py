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
slice order. Both plans are held to cover their range once, in order, and
an emulation of each kernel's arithmetic under its plan (plain torch, f32
or bf16) is held to the port's plain version and to the JAX package
(``paged_attention_ref`` / the Pallas kernels in interpret mode): f32 to
1e-5 absolute (#9, as tests/test_torch_paged.py) or 2e-5 of the largest
output (#3), bf16 within one bf16 ulp of the largest output.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.ops import moe_matmul as jmoe
from ragmeup_tpu.ops import paged_attention as jpa
from ragmeup_tpu.ops import quant_matmul as jqm
from ragmeup_tpu_torch.ops import moe_matmul as moe
from ragmeup_tpu_torch.ops import paged_attention as tpa
from ragmeup_tpu_torch.ops import quant_matmul as qm
from test_torch_moe_int4 import DTYPES, _close, _packed_experts

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

# (mp, ps, b, nkv, row tiles or None for the decode kernel): the engine's
# 8B serving shapes (16 pages of 128 tokens, decode at 1-8 rows, the
# 128-token chunk at 1 and 4: 8 row tiles of 64) and tiny ones
PAGED_PLANS = {**{f"8B decode b={b}": (16, 128, b, 8, None) for b in (1, 4, 8)},
               **{f"8B chunk b={b}": (16, 128, b, 8, 8) for b in (1, 4)},
               "16-token pages": (128, 16, 8, 8, None),
               "tiny decode": (3, 16, 2, 2, None),
               "tiny chunk": (5, 16, 3, 2, 1),
               "one page": (1, 16, 1, 1, None)}


@pytest.mark.parametrize("sms", [1, H100_SMS, 10_000])
@pytest.mark.parametrize("case", list(PAGED_PLANS))
def test_paged_split_plan_covers_every_key_once(case, sms):
    mp, ps, b, nkv, row_tiles = PAGED_PLANS[case]
    kps = tpa.paged_split_plan(mp, ps, b, nkv, sms, row_tiles)
    keys, tiles = mp * ps, -(-(mp * ps) // 64)
    assert kps >= 64 and kps % 64 == 0
    splits = tpa.paged_splits(mp, ps, kps)
    ranges = [(s * kps, min(keys, (s + 1) * kps)) for s in range(splits)]
    assert 1 <= splits <= tiles
    assert ranges[0][0] == 0 and ranges[-1][1] == keys
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(k0 < k1 for k0, k1 in ranges)
    # the fewest splits that give the blocks it aims at on every SM (at most
    # one a tile), cut evenly into whole tiles (which may round to fewer)
    per_sm = tpa._DECODE_BLOCKS_PER_SM if row_tiles is None else tpa._CHUNK_BLOCKS_PER_SM
    base = b * nkv * (row_tiles or 1)
    wanted = next(w for w in range(1, tiles + 1) if base * w >= per_sm * sms or w == tiles)
    assert kps // 64 == -(-tiles // wanted) and splits <= wanted


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


def _split_merge_plain(q, k_pages, v_pages, idx, lens, kps, window=0, softcap=0.0):
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
    sc = sc / np.sqrt(hd)
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
