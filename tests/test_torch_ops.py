"""The port's ops against the JAX package's on the same numpy-seeded inputs.

On the CPU every wrapper takes its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode, as the JAX tests do. The CUDA kernels
themselves are checked against the same plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ragmeup_tpu.ops import attention as jattn
from ragmeup_tpu.ops import fusion as jfusion
from ragmeup_tpu.ops import quant_matmul as jqm
from ragmeup_tpu.ops import topk as jtopk
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.ops import attention, fusion, quant_matmul, topk


@pytest.fixture
def no_kernel_library(monkeypatch):
    """CPU tensors must never reach the CUDA library or the launch counts."""
    def refuse():
        raise AssertionError("CPU call reached the CUDA kernel library")
    monkeypatch.setattr(kernels, "lib", refuse)
    kernels.reset_counts()
    yield
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def _topk_case(seed, n=2048, d=32, b=3):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c[700:704] = c[5]                               # exact ties
    c[900] = c[6] + 1e-3 * rng.standard_normal(d)   # near-ties
    c[901] = c[6] + 1e-3 * rng.standard_normal(d)
    q[0] = c[5]
    q[1] = c[6]
    dead = rng.choice(n, 100, replace=False)
    mask = np.zeros((1, n), np.float32)
    mask[0, dead] = topk.NEG_INF
    return q, c, mask, dead


@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_topk_matches_jax_and_oracle(k, seed, no_kernel_library):
    q, c, mask, dead = _topk_case(seed)
    js, ji = jtopk.dense_topk(jnp.asarray(q), jnp.asarray(c.T), k,
                              mask=jnp.asarray(mask))
    ts, ti = topk.dense_topk(torch.from_numpy(q), torch.from_numpy(c.T.copy()), k,
                             mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    os_, oi = topk.topk_oracle(q, c, k, dead_rows=dead)
    np.testing.assert_array_equal(ti.numpy(), oi)
    np.testing.assert_allclose(ts.numpy(), os_, rtol=1e-5)


def test_dense_topk_ties_go_to_lowest_index(no_kernel_library):
    q, c, mask, _ = _topk_case(0)
    mask[:] = 0.0
    _, ti = topk.dense_topk(torch.from_numpy(q[:1]), torch.from_numpy(c.T.copy()),
                            5, mask=torch.from_numpy(mask))
    assert ti[0].tolist() == [5, 700, 701, 702, 703]


def test_dense_topk_more_slots_than_live_rows(no_kernel_library):
    """Unfilled slots come out as (NEG_INF, -1), as from the TPU merge."""
    q, c, _, _ = _topk_case(2)
    mask = np.full((1, 2048), topk.NEG_INF, np.float32)
    mask[0, [3, 1500, 77]] = 0.0
    js, ji = jtopk.dense_topk(jnp.asarray(q), jnp.asarray(c.T), 6,
                              mask=jnp.asarray(mask))
    ts, ti = topk.dense_topk(torch.from_numpy(q), torch.from_numpy(c.T.copy()), 6,
                             mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy()[:, 3:], np.asarray(js)[:, 3:])
    assert (ti.numpy()[:, 3:] == -1).all()
    assert sorted(ti.numpy()[0, :3].tolist()) == [3, 77, 1500]


def test_dense_topk_casts_queries_to_the_corpus_dtype(no_kernel_library):
    q, c, mask, _ = _topk_case(3)
    ct = torch.from_numpy(c.T.copy()).to(torch.bfloat16)
    ts, ti = topk.dense_topk(torch.from_numpy(q), ct, 10,
                             mask=torch.from_numpy(mask))
    ref = q.astype(np.float32)
    ref = torch.from_numpy(ref).to(torch.bfloat16).float() @ ct.float()
    ref = ref + torch.from_numpy(mask)
    rs, ri = topk.rank_topk(ref, 10)
    np.testing.assert_array_equal(ti.numpy(), ri.numpy())
    np.testing.assert_array_equal(ts.numpy(), rs.numpy())


def test_dense_topk_rejects_bad_shapes():
    c = torch.zeros(8, 1000)
    with pytest.raises(ValueError):
        topk.dense_topk(torch.zeros(1, 8), c, 5)
    with pytest.raises(ValueError):
        topk.dense_topk(torch.zeros(1, 8), torch.zeros(8, 1024), 129)


def _int8_corpus(c):
    """(d, n) int8 codes and (1, n) scales of the JAX quantizer."""
    ci8, cs = jtopk.quantize_int8(jnp.asarray(c), axis=1)
    return np.asarray(ci8).T.copy(), np.asarray(cs).T.copy()


@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_topk_int8_matches_jax(k, seed, no_kernel_library):
    """Ids exact and scores equal (the int8 dot is exact in f32), with dead
    columns and exact ties."""
    q, c, mask, dead = _topk_case(seed)
    ci8, cs = _int8_corpus(c)
    js, ji = jtopk.dense_topk_int8(jnp.asarray(q), jnp.asarray(ci8), jnp.asarray(cs),
                                   k, mask=jnp.asarray(mask))
    ts, ti = topk.dense_topk_int8(torch.from_numpy(q), torch.from_numpy(ci8),
                                  torch.from_numpy(cs), k, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not set(ti.numpy().ravel().tolist()) & set(dead.tolist())


def test_dense_topk_int8_ties_and_unfilled_slots(no_kernel_library):
    """Exact duplicates rank by lowest index; slots no live column fills
    come out as (NEG_INF, -1), as from the TPU merge."""
    q, c, _, _ = _topk_case(2)
    ci8, cs = _int8_corpus(c)
    mask = np.zeros((1, 2048), np.float32)
    _, ti = topk.dense_topk_int8(torch.from_numpy(c[5:6].copy()),
                                 torch.from_numpy(ci8), torch.from_numpy(cs), 5,
                                 mask=torch.from_numpy(mask))
    assert ti[0, :5].tolist() == [5, 700, 701, 702, 703]
    mask[:] = topk.NEG_INF
    mask[0, [3, 1500, 77]] = 0.0
    js, ji = jtopk.dense_topk_int8(jnp.asarray(q), jnp.asarray(ci8), jnp.asarray(cs),
                                   6, mask=jnp.asarray(mask))
    ts, ti = topk.dense_topk_int8(torch.from_numpy(q), torch.from_numpy(ci8),
                                  torch.from_numpy(cs), 6, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti.numpy()[:, 3:] == -1).all() and (ts.numpy()[:, 3:] == topk.NEG_INF).all()


def test_quantize_int8_matches_jax():
    x = np.random.default_rng(0).standard_normal((6, 40)).astype(np.float32)
    jq, js = jtopk.quantize_int8(jnp.asarray(x), axis=1)
    tq, ts = topk.quantize_int8(torch.from_numpy(x), axis=1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m", [1, 3, 8])
def test_int8_matmul_matches_jax(m, no_kernel_library):
    rng = np.random.default_rng(m)
    k = n = 512
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random(n) * 0.01 + 1e-3).astype(np.float32)
    jy = np.asarray(jqm.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)))
    ty = quant_matmul.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(s)).numpy()
    assert ty.dtype == np.float32 and ty.shape == (m, n)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5 * np.abs(jy).max())


@pytest.mark.parametrize("k,n,group", [(1024, 512, None), (1024, 512, 512),
                                       (1536, 256, 256), (768, 64, 512),
                                       (96, 64, None)])
def test_int4_packing_matches_jax(k, n, group):
    """Packed bytes and group scales byte-identical to the numpy quantizer,
    at groups 128 and 512, a walked-down group (512 on a 768 tile) and
    inputs whose k does not divide by 512 (tile_k = k)."""
    w = np.random.default_rng(k + n).standard_normal((k, n)).astype(np.float32)
    jp, js = jqm.quantize_int4_groupwise(w, group=group)
    tp, ts = quant_matmul.quantize_int4_groupwise(torch.from_numpy(w), group=group)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(ts.numpy(), js)
    tile_k = quant_matmul.int4_tiling(k)[0]
    assert tile_k == jqm.int4_tiling(k)[0]
    np.testing.assert_array_equal(quant_matmul.unpack_int4(tp, tile_k).numpy(),
                                  np.asarray(jqm.unpack_int4(jnp.asarray(jp), tile_k)))
    q = torch.from_numpy(np.random.default_rng(1).integers(-8, 8, (k, n)).astype(np.int8))
    assert torch.equal(quant_matmul.unpack_int4(quant_matmul.pack_int4(q, tile_k), tile_k), q)


INT4_ROUTES = {  # (m, k, n, group, a8): which route int4_matmul takes
    "quality": (3, 1024, 512, None, False),
    "output_scaled": (8, 1024, 1024, 512, False),
    "w4a8": (20, 1024, 512, 512, True),
    "fallback_n": (3, 1024, 640, None, False),
    "fallback_m": (300, 512, 512, None, False),
}


@pytest.mark.parametrize("route", list(INT4_ROUTES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_matches_jax(route, dtype, no_kernel_library):
    """Every route against JAX's (the Pallas kernels in interpret mode):
    f32 to rtol 1e-5 (the sums' order differs), bf16 within one bf16 ulp
    of the largest output (both round once from an f32 sum)."""
    m, k, n, group, a8 = INT4_ROUTES[route]
    rng = np.random.default_rng(m + k + n)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jp, js = jqm.quantize_int4_groupwise(w, group=group)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jy = np.asarray(jqm.int4_matmul(jx, jnp.asarray(jp), jnp.asarray(js), a8=a8),
                    np.float32)
    ty = quant_matmul.int4_matmul(tx, torch.from_numpy(jp), torch.from_numpy(js), a8=a8)
    assert ty.dtype == tx.dtype and ty.shape == (m, n)
    ty = ty.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5 * np.abs(jy).max())
    else:
        assert np.abs(ty - jy).max() <= 2.0 ** -7 * np.abs(jy).max()


def test_int4_matmul_plain_versions_follow_their_rounding():
    """The quality route rounds each dequantized weight to x's dtype before
    the dot; W4A8 equals its integer definition exactly."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 1024)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1024, 512)).astype(np.float32))
    wp, gs = quant_matmul.quantize_int4_groupwise(w)
    xb = x.to(torch.bfloat16)
    wd = (quant_matmul.unpack_int4(wp, 512).float()
          * gs.repeat_interleave(128, 0)).to(torch.bfloat16).float()
    assert torch.equal(quant_matmul.int4_matmul_plain(xb, wp, gs),
                       (xb.float() @ wd).to(torch.bfloat16))
    wp, gs = quant_matmul.quantize_int4_groupwise(w, group=512)
    xq, xs = topk.quantize_int8(x, axis=1)
    q = quant_matmul.unpack_int4(wp, 512).long()
    p = [(xq.long()[:, t * 512:(t + 1) * 512] @ q[t * 512:(t + 1) * 512]).float()
         for t in range(2)]
    want = (p[0] * xs * gs[0]) + (p[1] * xs * gs[1])
    assert torch.equal(quant_matmul.int4_matmul_a8_plain(x, wp, gs), want)


@pytest.mark.parametrize("k,n,m,expect", [(4096, 1024, 1, 16), (4096, 4096, 1, 32),
                                          (4096, 14336, 1, 128), (14336, 4096, 1, 128),
                                          (4096, 4096, 256, 256), (1536, 512, 8, 16),
                                          (96, 512, 1, 16)])
def test_int4_split_k_slices_stay_in_a_tile(k, n, m, expect):
    tile_k = quant_matmul.int4_tiling(k)[0]
    ks = quant_matmul.int4_slice_for(k, tile_k, n, -(-m // 8), target_blocks=264)
    assert ks == expect and (tile_k // 2) % ks == 0


@pytest.mark.parametrize("k,n,expect", [(4096, 4096, 64), (4096, 1024, 16),
                                        (4096, 14336, 256), (14336, 4096, 256),
                                        (512, 512, 16)])
def test_int8_split_k_fills_the_card(k, n, expect):
    ks = quant_matmul.k_slice_for(k, n, target_blocks=264)  # 132-SM H100
    assert ks == expect and k % ks == 0


def _attn_inputs(seed, bkv, g, s=128, kv_len=256, d=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bkv, g, s, d)).astype(np.float32)
    k = rng.standard_normal((bkv, kv_len, d)).astype(np.float32)
    v = rng.standard_normal((bkv, kv_len, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("g", [1, 2])
def test_flash_attention_gqa_matches_jax(g, no_kernel_library):
    q, k, v = _attn_inputs(g, bkv=2, g=g)
    jo = np.asarray(jattn.flash_attention_gqa(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), causal=True))
    to = attention.flash_attention_gqa(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), causal=True).numpy()
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)


def test_flash_attention_matches_jax(no_kernel_library):
    q, k, v = _attn_inputs(7, bkv=3, g=1)
    q = q[:, 0]
    jo = np.asarray(jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=True))
    to = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True).numpy()
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    ref = np.asarray(jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v)))
    np.testing.assert_allclose(to, ref, rtol=1e-5, atol=1e-5)


def test_flash_keys_past_the_sequence_are_never_read(no_kernel_library):
    """kv_len > s is the KV-cache tail: changing it must not change a row."""
    q, k, v = _attn_inputs(3, bkv=1, g=2)
    out1 = attention.flash_attention_gqa(*map(torch.from_numpy, (q, k, v)))
    k[:, 128:] = 1e3
    v[:, 128:] = np.nan
    out2 = attention.flash_attention_gqa(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


def _rrf_case(seed, b=4, ka=10, kb=12):
    rng = np.random.default_rng(seed)
    a = np.stack([rng.permutation(40)[:ka] for _ in range(b)]).astype(np.int32)
    bb = np.stack([rng.permutation(40)[:kb] for _ in range(b)]).astype(np.int32)
    a[1, 6:] = -1
    bb[2, 3:] = -1
    bb[3] = -1
    return a, bb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rrf_fuse_device_matches_jax(seed):
    a, b = _rrf_case(seed)
    js, ji = jfusion.rrf_fuse_device(jnp.asarray(a), jnp.asarray(b), 0.5, 0.5, 60, 10)
    ts, ti = fusion.rrf_fuse_device(torch.from_numpy(a), torch.from_numpy(b),
                                    0.5, 0.5, 60, 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for r in range(a.shape[0]):
        host = fusion.rrf_fuse([[x for x in a[r] if x >= 0],
                                [x for x in b[r] if x >= 0]], [0.5, 0.5], 60, 10)
        assert [int(i) for i in ti[r] if i >= 0] == [int(i) for i, _ in host]


def test_host_fusion_copies_match_jax():
    a, b = _rrf_case(5)
    lists = [[int(x) for x in a[0]], [int(x) for x in b[0]]]
    assert fusion.rrf_fuse(lists, [0.3, 0.7], 60, 8) == \
        jfusion.rrf_fuse(lists, [0.3, 0.7], 60, 8)
    rng = np.random.default_rng(5)
    qv, cands = rng.standard_normal(16), rng.standard_normal((12, 16))
    assert fusion.mmr_select(qv, cands, 6, 0.4) == jfusion.mmr_select(qv, cands, 6, 0.4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mmr_select_device_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m, d = 20, 16
    cand = rng.standard_normal((m, d)).astype(np.float32)
    cand[7] = cand[3]                  # a duplicate: argmax ties
    q = rng.standard_normal(d).astype(np.float32)
    q /= np.linalg.norm(q)
    valid = np.ones(m, bool)
    valid[[2, 11]] = False
    jo = np.asarray(jfusion.mmr_select_device(jnp.asarray(q), jnp.asarray(cand),
                                              jnp.asarray(valid), 10, 0.5))
    to = fusion.mmr_select_device(torch.from_numpy(q), torch.from_numpy(cand),
                                  torch.from_numpy(valid), 10, 0.5).numpy()
    np.testing.assert_array_equal(to, jo)


def test_mmr_select_device_pads_when_too_few_valid():
    cand = torch.eye(4)
    valid = torch.tensor([True, False, True, False])
    out = fusion.mmr_select_device(torch.tensor([1.0, 0, 0, 0]), cand, valid, 4, 0.5)
    assert out.tolist() == [0, 2, -1, -1]
