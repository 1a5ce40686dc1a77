"""The port's packed-int4 sparse-MoE path against the JAX package's.

The same numpy-seeded inputs (or the JAX modules' params, carried across by
``models/convert.py``) go through both packages on the CPU; the JAX side
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions. Each route is held to its own JAX counterpart, since the routes
round differently: below the k-tile the kernels dequantize each weight in
f32 and round it to x's dtype; at group == tile they sum a k-tile against
the integers and scale the sum; the fallbacks dequantize in x's dtype
first. f32 comparisons allow 2e-5 of the largest output (sums in another
order); bf16 ones one bf16 ulp of the largest output (both sides sum in f32
and round once).
"""

import functools
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import hf_loader as jloader
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.ops import moe_matmul as jmoe
from ragmeup_tpu.ops import quant_matmul as jqm
from ragmeup_tpu.pipeline import serving as jserve
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.models import convert, decoder, hf_loader, tokenizer
from ragmeup_tpu_torch.ops import moe_matmul as moe
from ragmeup_tpu_torch.ops import quant_matmul as qm
from ragmeup_tpu_torch.pipeline import serving
from test_torch_moe import _numpy_tree
from test_torch_system import LLM_CFG_INT4, _build_systems, _two_turns_match
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

E, K, N = 4, 1024, 512
TILE = 512
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got: torch.Tensor, want, dtype="float32"):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    big = np.abs(want).max()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * big)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * big)


def _packed_experts(rng, group, e=E, k=K, n=N):
    """Random packed bytes (every byte is a valid pair of nibbles) and
    positive group scales."""
    w_p = rng.integers(-128, 128, (e, k // 2, n)).astype(np.int8)
    gs = (0.01 + 0.1 * rng.random((e, k // group, n))).astype(np.float32)
    return w_p, gs


def _both(x, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


@pytest.fixture
def taken(monkeypatch):
    """Records which int4 kernel each call of the op wrappers would launch
    (CPU tensors take the plain versions, so nothing is counted)."""
    seen = []
    plain, padded = moe.moe_gather_matmul_int4_plain, moe.grouped_int4_padded
    monkeypatch.setattr(moe, "moe_gather_matmul_int4_plain",
                        lambda *a: seen.append("moe_gather_int4") or plain(*a))
    monkeypatch.setattr(moe, "grouped_int4_padded",
                        lambda *a: seen.append("moe_grouped_int4") or padded(*a))
    return seen


# ---------------------------------------------------------------------------
# ops/moe_matmul.py: the int4 gather (#13)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [128, TILE])
@pytest.mark.parametrize("route", ["kernel", "fallback"])
def test_gather_int4_matches_jax(route, group, dtype, taken):
    """Groups of 128 (four a k-tile: weights dequantized and rounded) and
    of the 512-row tile (the output-scaled route); the kernel route (3
    slots, one expert twice) and the fallback (n = 384 has no n tile)."""
    rng = np.random.default_rng(group)
    n = N if route == "kernel" else 384
    w_p, gs = _packed_experts(rng, group, n=n)
    x = rng.standard_normal((3, K)).astype(np.float32)
    ids = np.asarray([2, 0, 2], np.int32)
    tx, jx = _both(x, dtype)
    want = jmoe.moe_gather_matmul_int4(jx, jnp.asarray(w_p), jnp.asarray(gs),
                                       jnp.asarray(ids), TILE, group)
    args = (torch.from_numpy(w_p), torch.from_numpy(gs), torch.from_numpy(ids), TILE, group)
    got = moe.moe_gather_matmul_int4(tx, *args)
    assert got.dtype == tx.dtype and got.shape == (3, n)
    _close(got, want, dtype)
    assert taken == (["moe_gather_int4"] if route == "kernel" else [])
    if route == "kernel":
        _close(moe.moe_gather_matmul_int4_plain(tx, *args), want, dtype)


def test_gather_int4_more_than_64_slots_falls_back(taken):
    rng = np.random.default_rng(5)
    w_p, gs = _packed_experts(rng, 128)
    x = rng.standard_normal((70, K)).astype(np.float32)
    ids = rng.integers(0, E, 70).astype(np.int32)
    want = jmoe.moe_gather_matmul_int4(jnp.asarray(x), jnp.asarray(w_p), jnp.asarray(gs),
                                       jnp.asarray(ids), TILE, 128)
    got = moe.moe_gather_matmul_int4(torch.from_numpy(x), torch.from_numpy(w_p),
                                     torch.from_numpy(gs), torch.from_numpy(ids), TILE, 128)
    _close(got, want)
    assert taken == []


# ---------------------------------------------------------------------------
# ops/moe_matmul.py: the int4 grouped GEMM (#14)
# ---------------------------------------------------------------------------

def test_grouped_int4_viable_matches_jax():
    """The gate decides which kernel runs: equal to the JAX package's over
    a grid of shapes, tiles, groups and dtypes."""
    checked = 0
    for m in (1, 8, 16, 64, 200, 420, 600):
        for e in (4, 8, 64, 128):
            for k, n in ((1024, 512), (4096, 14336), (14336, 4096), (512, 200),
                         (768, 768), (96, 256)):
                for pack_tile in (512, 768, 96, 16):
                    for group in (128, 512, 32, 8):
                        for tdt, jdt in DTYPES.values():
                            got = moe.grouped_int4_viable(m, e, k, n, pack_tile, group, tdt)
                            assert got == jmoe.grouped_int4_viable(
                                m, e, k, n, pack_tile, group, jdt), (m, e, k, n, pack_tile,
                                                                     group, tdt)
                            checked += got
    assert checked > 100


GROUPED = {  # group sizes, scale group, x dtype, expected route
    "gpt4-f32": ([3, 0, 5, 2], 128, "float32", "moe_grouped_int4"),
    "gpt1-f32": ([3, 0, 5, 2], TILE, "float32", "moe_grouped_int4"),
    "gpt4-bf16": ([3, 0, 5, 2], 128, "bfloat16", "moe_grouped_int4"),
    "gpt1-bf16": ([3, 0, 5, 2], TILE, "bfloat16", "moe_grouped_int4"),
    "one-expert": ([0, 0, 16, 0], 128, "float32", "moe_grouped_int4"),
    "fallback": ([300, 0, 160, 140], 128, "float32", None),   # padded strip > 512 rows
}


@pytest.mark.parametrize("case", list(GROUPED))
def test_grouped_int4_matches_jax(case, taken):
    """Rows sorted by expert with an empty group, on both arithmetic
    routes, in f32 and bf16; a row set whose padded strip passes 512 rows
    takes the full-stack dequant fallback in both. The whole-function
    plain version agrees with the kernel route."""
    gsz, group, dtype, route = GROUPED[case]
    rng = np.random.default_rng(len(case))
    gsz = np.asarray(gsz, np.int32)
    w_p, gs = _packed_experts(rng, group)
    x = rng.standard_normal((int(gsz.sum()), K)).astype(np.float32)
    tx, jx = _both(x, dtype)
    want = jmoe.moe_grouped_matmul_int4(jx, jnp.asarray(w_p), jnp.asarray(gs),
                                        jnp.asarray(gsz), TILE, group)
    args = (torch.from_numpy(w_p), torch.from_numpy(gs), torch.from_numpy(gsz), TILE, group)
    got = moe.moe_grouped_matmul_int4(tx, *args)
    assert got.dtype == tx.dtype and got.shape == (x.shape[0], N)
    _close(got, want, dtype)
    assert taken == ([route] if route else [])
    if route:
        _close(moe.moe_grouped_matmul_int4_plain(tx, *args), want, dtype)


# ---------------------------------------------------------------------------
# ops/quant_matmul.py: the fused int4 MLP (#6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_int4_matches_jax(dtype):
    """m = 3, h = 512, I = 1024, weights quantized by the JAX package's
    quantizer (default groups), against its interpreted kernel."""
    rng = np.random.default_rng(11)
    m, h, inter = 3, 512, 1024
    x = rng.standard_normal((m, h)).astype(np.float32)
    nw = (rng.standard_normal(h) * 0.1 + 1.0).astype(np.float32)
    packed = []
    for shape in ((h, inter), (h, inter), (inter, h)):
        packed += jqm.quantize_int4_groupwise(
            (rng.standard_normal(shape) * 0.05).astype(np.float32))
    tx, jx = _both(x, dtype)
    want = jqm.fused_mlp_int4(jx, jnp.asarray(nw), *map(jnp.asarray, packed))
    kernels.reset_counts()
    got = qm.fused_mlp_int4(tx, torch.from_numpy(nw), *map(torch.from_numpy, packed))
    assert got.dtype == tx.dtype and got.shape == (m, h)
    assert not any(kernels.launch_counts().values())
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# models/decoder.py: LlamaMoeMlp over int4 experts
# ---------------------------------------------------------------------------

MLP = dict(vocab_size=64, hidden_size=512, num_layers=1, num_heads=4, num_kv_heads=2,
           intermediate_size=256, num_experts=4, num_experts_per_tok=2, dtype="float32",
           quantization="int4")


@pytest.fixture(scope="module")
def float_mlp():
    """f32 flax params of one MoE MLP (h 512, f 256: every int4 route tiles),
    the router scaled so routing spreads over the experts."""
    import jax
    cfg = jdec.LlamaConfig(**dict(MLP, quantization="none"))
    params = _numpy_tree(jdec.LlamaMoeMlp(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 512)))["params"])
    rng = np.random.default_rng(7)
    for name in ("gate", "up", "down"):
        params[name] = (rng.standard_normal(params[name].shape) * 0.05).astype(np.float32)
    params["router"] = (rng.standard_normal((512, 4)) * 0.3).astype(np.float32)
    return params


# tokens, moe_grouped, expected launches
MLP_ROUTES = {"gather": (1, "auto", ["moe_gather_int4"] * 3),
              "dedup": (4, "auto", ["moe_grouped_int4"] * 3),
              "einsum": (16, "auto", []),
              "on-gather": (4, "on", ["moe_gather_int4"] * 3),
              "on-einsum": (16, "on", [])}


@pytest.mark.parametrize("int4_group", [0, TILE])
@pytest.mark.parametrize("route", list(MLP_ROUTES))
def test_moe_mlp_int4_matches_jax(float_mlp, route, int4_group, taken):
    """Each int4 route of LlamaMoeMlp against the JAX module with the same
    quantized weights (default groups, and 512-row groups: the output-scaled
    arithmetic): t = 1 gathers (#13), t = 4 (S = 8 > E) the dedup grouped
    kernel (#14), t = 16 (S = 32 > 4E) the dequantized einsum; under "on"
    no grouped kernel. Routing ids equal the JAX module's exactly."""
    t, mode, launches = MLP_ROUTES[route]
    params = _numpy_tree(jloader.quantize_decoder_params(
        {"mlp": float_mlp}, bits=4, int4_group=int4_group)["mlp"])
    cfg = dict(MLP, moe_grouped=mode, int4_group=int4_group)
    x = np.random.default_rng(t).standard_normal((1, t, 512)).astype(np.float32)
    want, inter = jdec.LlamaMoeMlp(jdec.LlamaConfig(**cfg)).apply(
        {"params": params}, jnp.asarray(x), mutable=["intermediates"])
    mlp = decoder.LlamaMoeMlp(decoder.LlamaConfig(**cfg))
    mlp.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    kernels.reset_counts()
    with torch.inference_mode():
        got = mlp(torch.from_numpy(x))
        _, topi = mlp.route(torch.from_numpy(x[0]))
    assert not any(kernels.launch_counts().values())
    np.testing.assert_array_equal(topi.numpy(),
                                  np.asarray(inter["intermediates"]["router_topi"][0]))
    assert taken == launches
    _close(got[0], np.asarray(want)[0])


@pytest.mark.parametrize("int4_group", [0, TILE])
def test_moe_int4_quantizer_matches_jax(float_mlp, int4_group):
    """quantize_decoder_params(bits=4) on stacked experts: byte-equal to the
    JAX package's (each expert quantize_int4_groupwise'd), router f32."""
    tree = {"layer_0": {"mlp": float_mlp}, "lm_head": np.ones((4, 4), np.float32)}
    want = convert.flax_to_state_dict(
        jloader.quantize_decoder_params(tree, bits=4, int4_group=int4_group))
    got = hf_loader.quantize_decoder_params(convert.flax_to_state_dict(tree), bits=4,
                                            int4_group=int4_group)
    assert set(got) == set(want)
    assert {"layers.0.mlp.gate_p", "layers.0.mlp.down_gs"} <= set(got)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    assert got["layers.0.mlp.router"].dtype == torch.float32


def test_init_decoder_params_draws_int4_moe_layers():
    cfg = decoder.LlamaConfig.tiny(hidden_size=512, intermediate_size=256, num_heads=4,
                                   num_kv_heads=2, num_experts=4, quantization="int4",
                                   moe_layers=(True, False), int4_group=256)
    params = decoder.init_decoder_params(cfg, torch.Generator().manual_seed(0))
    want = {"gate_p": ((4, 256, 256), torch.int8), "gate_gs": ((4, 2, 256), torch.float32),
            "up_p": ((4, 256, 256), torch.int8), "up_gs": ((4, 2, 256), torch.float32),
            "down_p": ((4, 128, 512), torch.int8), "down_gs": ((4, 1, 512), torch.float32),
            "router": ((512, 4), torch.float32)}
    got = {k.split(".")[-1]: (tuple(v.shape), v.dtype) for k, v in params.items()
           if k.startswith("layers.0.mlp.")}
    assert got == want
    assert "layers.1.mlp.gate_proj.kernel_p" in params
    assert params["layers.0.mlp.gate_p"].ne(0).any()
    llm = decoder.LocalLLM(cfg, tokenizer.SimpleTokenizer(cfg.vocab_size), params=params,
                           device="cpu")
    assert isinstance(llm.model.layers[0].mlp, decoder.LlamaMoeMlp)
    assert len(llm.generate([1, 2, 3], max_new_tokens=4, **GREEDY)) == 4


def test_flax_int4_moe_tree_loads_strict():
    """A flax int4-MoE decoder tree converts to the port's state dict and
    loads with strict=True: every name and shape matches."""
    cfg = dict(TINY, num_layers=1)
    j = jdec.LocalLLM(jdec.LlamaConfig(**cfg), jtok.SimpleTokenizer(512), seed=0)
    sd = convert.flax_to_state_dict(_numpy_tree(j.params))
    assert sd["layers.0.mlp.down_gs"].shape == (4, 2, 512)
    model = decoder.LlamaModel(decoder.LlamaConfig(**cfg))
    model.load_state_dict(sd, strict=True)


# ---------------------------------------------------------------------------
# A tiny int4 MoE decoder, the serving engine and /chat
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=256, max_seq_len=256, rope_theta=10000.0, dtype="float32",
            num_experts=4, num_experts_per_tok=2, quantization="int4")


@pytest.fixture(scope="module")
def tiny_int4():
    """(JAX LocalLLM, port LocalLLM) over the same int4 MoE weights (the JAX
    float decoder's, quantized by the JAX package)."""
    tok = jtok.SimpleTokenizer(TINY["vocab_size"])
    base = jdec.LocalLLM(jdec.LlamaConfig(**dict(TINY, quantization="none")), tok, seed=3)
    params = _numpy_tree(jloader.quantize_decoder_params(_numpy_tree(base.params), bits=4))
    j = jdec.LocalLLM(jdec.LlamaConfig(**TINY), tok, params=params)
    t = decoder.LocalLLM(decoder.LlamaConfig(**TINY),
                         tokenizer.SimpleTokenizer(TINY["vocab_size"]),
                         params=convert.flax_to_state_dict(params), device="cpu")
    return j, t


def test_tiny_int4_moe_decoder_logits_match_jax(tiny_int4):
    j, t = tiny_int4
    ids = list(np.random.default_rng(0).integers(4, 512, 40))
    _close(torch.from_numpy(t.forward_logits(ids)), j.forward_logits(ids))


def test_tiny_int4_moe_decoder_greedy_stream_matches_jax(tiny_int4, taken):
    """Decode steps gather (#13) and prefill dequantizes the stacks, in
    both packages; JAX's plain greedy loop (its speculative decoder changes
    t and so the route)."""
    j, t = tiny_int4
    ids = [int(x) for x in np.random.default_rng(1).integers(4, 512, 60)]
    want = j.generate(ids, max_new_tokens=8, temperature=0.0, speculative="off")
    assert t.generate(ids, max_new_tokens=8, temperature=0.0, speculative="off") == want
    assert set(taken) == {"moe_gather_int4"}


def test_int4_moe_serving_engine_matches_jax(tiny_int4, taken):
    """Waves of three requests (4 rows with the pad row: S = 8 > E) take the
    dedup grouped route (#14) and equal each request's solo generate and
    the JAX engine's waves."""
    j, t = tiny_int4
    prompts = {"a": [5, 17, 101], "b": [9, 8, 7, 6, 5], "c": [200, 300]}
    want = {k: j.generate(v, max_new_tokens=4, speculative="off", **GREEDY)
            for k, v in prompts.items()}
    solo = {k: t.generate(v, max_new_tokens=4, speculative="off", **GREEDY)
            for k, v in prompts.items()}
    kw = dict(num_pages=64, page_size=16, max_pages_per_seq=8)
    got = []
    for eng in (jserve.ServingEngine(j, spec_accept_floor=0.0, **kw),
                serving.ServingEngine(t, **kw)):
        for k, v in prompts.items():
            eng.add_request(k, v, max_new_tokens=4, **GREEDY)
        got.append(eng.run_wave(steps_per_dispatch=2))
    assert got[1] == got[0] == want == solo
    assert "moe_grouped_int4" in taken


def test_int4_moe_chat_matches_jax_over_two_turns(tmp_path):
    """RagSystem with an injected int4 MoE decoder (h 512: the attention
    projections reach the int4 kernel route, the experts #13 and #14):
    replies, documents and histories over two turns equal the JAX
    RagSystem's (its decoder held to the plain greedy loop)."""
    cfg = dict(LLM_CFG_INT4, num_experts=4, num_experts_per_tok=2)
    j_sys, t_sys = _build_systems(tmp_path, cfg, "float32")
    assert isinstance(t_sys.llm.model.layers[0].mlp, decoder.LlamaMoeMlp)
    assert t_sys.llm.model.layers[0].mlp.gate_p.dtype == torch.int8
    j_sys.llm.generate = functools.partial(j_sys.llm.generate, speculative="off")
    _two_turns_match(j_sys, t_sys)


# ---------------------------------------------------------------------------
# kernels/__init__.py
# ---------------------------------------------------------------------------

def test_library_path_hashes_every_csrc_file(tmp_path, monkeypatch):
    """An edited shared header names another library, as an edited source
    does, so a stale build is never loaded; files of other kinds do not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    base = kernels.library_path()
    (csrc / "README.txt").write_text("notes")
    assert kernels.library_path() == base
    header = csrc / "common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    edited = kernels.library_path()
    assert edited != base and os.path.dirname(edited) == os.path.dirname(base)
    (csrc / "extra.h").write_text("#pragma once\n")
    assert kernels.library_path() not in (base, edited)
