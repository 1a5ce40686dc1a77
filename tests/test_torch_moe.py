"""The port's sparse-MoE path against the JAX package's.

The same numpy-seeded inputs (or the JAX modules' params, carried across by
``models/convert.py``) go through both packages on the CPU; the JAX side
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions. Each route is held to its own JAX counterpart, since the routes
round differently: the kernels cast each weight to x's dtype and scale the
f32 sum, the fallbacks dequantize in x's dtype first. f32 comparisons
allow 1e-5 of the largest output (sums in another order); bf16 ones one
bf16 ulp of the largest output (both sides sum in f32 and round once).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import hf_loader as jloader
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.ops import moe_matmul as jmoe
from ragmeup_tpu.pipeline import serving as jserve
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.models import convert, decoder, hf_loader, tokenizer
from ragmeup_tpu_torch.ops import moe_matmul as moe
from ragmeup_tpu_torch.pipeline import serving
from test_torch_system import LLM_CFG, _build_systems, _two_turns_match
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

E, K, N = 4, 1024, 512
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def _experts(rng, kind, e=E, k=K, n=N):
    """(w, scale): int8 codes with per-expert per-column scales, or f32."""
    if kind == "int8":
        return (rng.integers(-127, 128, (e, k, n), dtype=np.int8),
                ((rng.random((e, n)) + 0.1) * 0.01).astype(np.float32))
    return (rng.standard_normal((e, k, n)) * 0.02).astype(np.float32), None


def _pair(x, w, s, dtype):
    """The same inputs for JAX (jnp) and the port (torch); x in ``dtype``."""
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    js = None if s is None else jnp.asarray(s)
    ts = None if s is None else torch.from_numpy(s)
    return (jx, jnp.asarray(w), js), (tx, torch.from_numpy(w), ts)


def _close(got: torch.Tensor, want, dtype="float32"):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    big = np.abs(want).max()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * big)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * big)


@pytest.fixture
def routes(monkeypatch):
    """Records each grouped kernel call's counter name (CPU tensors take the
    plain version, so nothing is counted)."""
    seen = []
    real = moe.grouped_kernel_call

    def spy(xs, w, scale, gsz, tm, stack):
        seen.append("moe_grouped_stack" if stack else "moe_grouped")
        return real(xs, w, scale, gsz, tm, stack)
    monkeypatch.setattr(moe, "grouped_kernel_call", spy)
    return seen


# ---------------------------------------------------------------------------
# ops/moe_matmul.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dtype", [("int8", "float32"), ("float", "float32"),
                                        ("int8", "bfloat16"), ("float", "bfloat16")])
def test_gather_matmul_matches_jax(kind, dtype):
    """The kernel route (k 1024, n 512 tile; 3 slots, one expert twice)."""
    rng = np.random.default_rng(0)
    w, s = _experts(rng, kind)
    x = rng.standard_normal((3, K)).astype(np.float32)
    ids = np.asarray([2, 0, 2], np.int32)
    (jx, jw, js), (tx, tw, ts) = _pair(x, w, s, dtype)
    want = jmoe.moe_gather_matmul(jx, jw, jnp.asarray(ids), js)
    got = moe.moe_gather_matmul(tx, tw, torch.from_numpy(ids), ts)
    assert got.dtype == tx.dtype and got.shape == (3, N)
    _close(got, want, dtype)
    _close(moe.moe_gather_matmul_plain(tx, tw, torch.from_numpy(ids), ts), want, dtype)


@pytest.mark.parametrize("kind", ["int8", "float"])
def test_gather_fallback_matches_jax(kind):
    """k/n that do not tile, and more than 64 slots: the gather + einsum
    route, dequantized in x's dtype before the product, in both."""
    rng = np.random.default_rng(1)
    for (k, n, slots) in ((96, 100, 3), (512, 512, 70)):
        w, s = _experts(rng, kind, k=k, n=n)
        x = rng.standard_normal((slots, k)).astype(np.float32)
        ids = rng.integers(0, E, slots).astype(np.int32)
        (jx, jw, js), (tx, tw, ts) = _pair(x, w, s, "float32")
        want = jmoe.moe_gather_matmul(jx, jw, jnp.asarray(ids), js)
        _close(moe.moe_gather_matmul(tx, tw, torch.from_numpy(ids), ts), want)


@pytest.mark.parametrize("kind", ["int8", "float"])
def test_gather_kernel_route_at_128_multiples(kind, monkeypatch):
    """k and n multiples of 128 but not of 512 (Qwen3-MoE's 768-wide
    experts, here 256 x 384 at 8 slots) take the kernel route in the port
    (its plain version on the CPU), where the JAX package takes its
    fallback: both sum in f32, so they agree at f32."""
    rng = np.random.default_rng(2)
    w, s = _experts(rng, kind, k=256, n=384)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    ids = rng.integers(0, E, 8).astype(np.int32)
    (jx, jw, js), (tx, tw, ts) = _pair(x, w, s, "float32")
    calls = []
    plain = moe.moe_gather_matmul_plain
    monkeypatch.setattr(moe, "moe_gather_matmul_plain",
                        lambda *a: calls.append(1) or plain(*a))
    got = moe.moe_gather_matmul(tx, tw, torch.from_numpy(ids), ts)
    assert calls == [1]
    _close(got, jmoe.moe_gather_matmul(jx, jw, jnp.asarray(ids), js))


def test_grouped_tiles_and_layout_match_jax():
    """The routing helpers decide which kernel launches: grouped_tm,
    stack_tiles and scatter_layout equal the JAX package's."""
    for e in (2, 4, 8, 16, 64, 128):
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            assert moe.grouped_tm(e, tdt) == jmoe._grouped_tm(e, jdt)
    for mp in (40, 144, 640, 1536, 2048, 4096):
        for e, k, n in ((4, 1024, 512), (8, 4096, 14336), (8, 14336, 4096),
                        (128, 2048, 768), (4, 512, 1024)):
            for wb, xb in ((1, 2), (1, 4), (2, 2), (4, 4)):
                assert moe.stack_tiles(mp, e, k, n, wb, xb) == \
                    jmoe._stack_tiles(mp, e, k, n, wb, xb)
    rng = np.random.default_rng(2)
    for gsz, tm in (([5, 0, 3, 8], 8), ([130, 0, 37, 89], 128), ([0, 0, 16, 0], 16)):
        gsz = np.asarray(gsz, np.int32)
        xs = rng.standard_normal((int(gsz.sum()), 64)).astype(np.float32)
        want = jmoe._scatter_layout(jnp.asarray(xs), jnp.asarray(gsz), tm, len(gsz))
        xp, dst, texp, used = moe.scatter_layout(torch.from_numpy(xs),
                                                 torch.from_numpy(gsz), tm, len(gsz))
        for a, b in zip((xp, dst, texp), want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(used) == int((-(-gsz // tm) * tm).sum())


GROUPED = {
    # gsz, experts, x dtype, moe_grouped_matmul keywords, expected counter
    "stack-int8": ([130, 0, 37, 89], "int8", "float32", {}, "moe_grouped_stack"),
    "stack-float": ([130, 0, 37, 89], "float", "float32", {}, "moe_grouped_stack"),
    "stack-int8-bf16": ([130, 0, 37, 89], "int8", "bfloat16", {}, "moe_grouped_stack"),
    "dedup-int8": ([5, 0, 3, 8], "int8", "float32",
                   dict(tm=8, tile_k=1024, tile_n=512, no_stack=True), "moe_grouped"),
    "dedup-float-bf16": ([5, 0, 3, 8], "float", "bfloat16",
                         dict(tm=16, tile_k=1024, tile_n=512, no_stack=True), "moe_grouped"),
    "chunked-float": ([700, 1100, 0, 700], "float", "float32", {}, "moe_grouped_stack"),
    "fallback-short": ([3, 0, 2, 3], "float", "float32", {}, None),
    "fallback-short-int8": ([3, 0, 2, 3], "int8", "float32", {}, None),
}


@pytest.mark.parametrize("case", list(GROUPED))
def test_grouped_matmul_matches_jax(case, routes):
    """Ragged groups with an empty one; the full-stack and the per-tile
    (dedup) routes, the chunked large-m case (a group split across chunks)
    and the short-m fallback, each against the JAX package's same route;
    the whole-function plain version agrees with the kernel route."""
    gsz, kind, dtype, kw, route = GROUPED[case]
    rng = np.random.default_rng(3)
    gsz = np.asarray(gsz, np.int32)
    w, s = _experts(rng, kind)
    x = rng.standard_normal((int(gsz.sum()), K)).astype(np.float32)
    (jx, jw, js), (tx, tw, ts) = _pair(x, w, s, dtype)
    want = jmoe.moe_grouped_matmul(jx, jw, jnp.asarray(gsz), js, **kw)
    got = moe.moe_grouped_matmul(tx, tw, torch.from_numpy(gsz), ts, **kw)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    if route is None:
        assert routes == []
    else:
        assert routes and set(routes) == {route}
        _close(moe.moe_grouped_matmul_plain(tx, tw, torch.from_numpy(gsz), ts), want, dtype)


def test_grouped_fallback_untiled_matches_jax(routes):
    """n that does not tile (int8 experts): the ragged-dot route in both,
    dequantized in x's dtype first."""
    rng = np.random.default_rng(4)
    gsz = np.asarray([40, 30, 0, 58], np.int32)
    w, s = _experts(rng, "int8", k=512, n=200)
    x = rng.standard_normal((128, 512)).astype(np.float32)
    (jx, jw, js), (tx, tw, ts) = _pair(x, w, s, "float32")
    want = jmoe.moe_grouped_matmul(jx, jw, jnp.asarray(gsz), js)
    _close(moe.moe_grouped_matmul(tx, tw, torch.from_numpy(gsz), ts), want)
    assert routes == []


# E 8 on the dedup route: 16 and 32 rows, an empty group, a group longer
# than an 8-row tile (and than a 16-row pass), every row in one group
DEDUP_GROUPS = {"16 rows": [3, 2, 0, 4, 1, 2, 3, 1], "32 rows": [3, 2, 0, 17, 1, 2, 3, 4],
                "one group": [0, 0, 0, 0, 0, 32, 0, 0]}


@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
@pytest.mark.parametrize("groups", list(DEDUP_GROUPS))
def test_grouped_rows_route_matches_jax(groups, kind, routes):
    """The dedup route with bf16 rows takes the grouped-rows kernel on the
    sorted rows (its plain version on the CPU: each group's rows over the
    k slices an H100's plan gives, added in slice order), counted as #11,
    against JAX's moe_grouped_matmul on the same route (interpret mode),
    within one bf16 ulp of the largest output."""
    gsz = np.asarray(DEDUP_GROUPS[groups], np.int32)
    m = int(gsz.sum())
    rng = np.random.default_rng(m)
    w, s = _experts(rng, "int8" if kind == "int8" else "float", e=8)
    if kind == "bfloat16":
        w = np.asarray(jnp.asarray(w, jnp.bfloat16)).astype(np.float32)
    x = rng.standard_normal((m, K)).astype(np.float32)
    (jx, jw, js), (tx, tw, ts) = _pair(x, w, s, "bfloat16")
    if kind == "bfloat16":
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    kw = dict(tm=16, tile_k=1024, tile_n=512, no_stack=True)
    tg = torch.from_numpy(gsz)
    got = moe.moe_grouped_matmul(tx, tw, tg, ts, **kw)
    assert routes == ["moe_grouped"] and got.dtype == torch.bfloat16
    per = moe.grouped_rows_plan(m, 8, K, N, tw.dtype, moe.PLAN_SMS)
    assert len(moe.grouped_rows_slices(K, per)) > 1
    assert torch.equal(got, moe.moe_grouped_matmul_plain(tx, tw, tg, ts,
                                                         moe.grouped_rows_slices(K, per)))
    _close(got, jmoe.moe_grouped_matmul(jx, jw, jnp.asarray(gsz), js, **kw), "bfloat16")


@pytest.mark.parametrize("kind", ["int8", "bfloat16"])
def test_gather_shared_experts_match_jax(kind):
    """bf16 rows over 5 slots, two of them on expert 5 and two on expert 2
    (a slot's block offsets its expert by its id on the device: shared
    experts hide a wrong base): the CPU route (the plain version over the
    k slices an H100's plan gives) against JAX's gather (interpret mode),
    within one bf16 ulp of the largest output."""
    rng = np.random.default_rng(5)
    w, s = _experts(rng, "int8" if kind == "int8" else "float", e=8)
    if kind == "bfloat16":
        w = np.asarray(jnp.asarray(w, jnp.bfloat16)).astype(np.float32)
    x = rng.standard_normal((5, K)).astype(np.float32)
    ids = np.asarray([5, 2, 5, 7, 2], np.int32)
    (jx, jw, js), (tx, tw, ts) = _pair(x, w, s, "bfloat16")
    if kind == "bfloat16":
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    got = moe.moe_gather_matmul(tx, tw, torch.from_numpy(ids), ts)
    ks = moe.gather_plan(5, K, N, tw.dtype, moe.PLAN_SMS)
    assert len(moe.gather_slices(K, ks)) > 1
    assert torch.equal(got, moe.moe_gather_matmul_plain(tx, tw, torch.from_numpy(ids), ts,
                                                        moe.gather_slices(K, ks)))
    _close(got, jmoe.moe_gather_matmul(jx, jw, jnp.asarray(ids), js), "bfloat16")


# ---------------------------------------------------------------------------
# models/decoder.py: LlamaMoeMlp
# ---------------------------------------------------------------------------

MLP = dict(vocab_size=64, hidden_size=512, num_layers=1, num_heads=4, num_kv_heads=2,
           intermediate_size=1024, num_experts=4, num_experts_per_tok=2,
           dtype="float32")


@pytest.fixture(scope="module")
def mlp_params():
    """(f32 flax params, int8 flax params) of one MoE MLP at a tiling width,
    the router scaled so routing spreads over the experts."""
    cfg = jdec.LlamaConfig(**MLP)
    params = _numpy_tree(jdec.LlamaMoeMlp(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 512)))["params"])
    rng = np.random.default_rng(7)
    params = dict(params, router=(rng.standard_normal((512, 4)) * 0.3).astype(np.float32))
    qparams = _numpy_tree(jloader.quantize_decoder_params({"mlp": params}, bits=8)["mlp"])
    return params, qparams


# tokens, moe_grouped, expected calls (gather, grouped counters)
MLP_ROUTES = {"gather": (1, "auto", 3, []),
              "dedup": (3, "auto", 0, ["moe_grouped"] * 3),
              "einsum": (64, "auto", 0, []),
              "grouped": (64, "on", 0, ["moe_grouped_stack"] * 3),
              "ties": (3, "auto", 0, ["moe_grouped"] * 3)}


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("route", list(MLP_ROUTES))
def test_moe_mlp_matches_jax(mlp_params, route, quant, routes, monkeypatch):
    """Each route of LlamaMoeMlp against the JAX module with the same weights:
    t = 1 (gather, #10), t = 3 (dedup, #11), t = 64 under "auto" (einsum)
    and under "on" (full stack, #12), and a zero router, whose ties go to
    experts 0 and 1. Routing ids equal the JAX module's exactly."""
    t, mode, n_gather, grouped = MLP_ROUTES[route]
    params = mlp_params[quant == "int8"]
    if route == "ties":
        params = dict(params, router=np.zeros_like(params["router"]))
    cfg = dict(MLP, quantization=quant, moe_grouped=mode)
    x = np.random.default_rng(t).standard_normal((1, t, 512)).astype(np.float32)
    want, inter = jdec.LlamaMoeMlp(jdec.LlamaConfig(**cfg)).apply(
        {"params": params}, jnp.asarray(x), mutable=["intermediates"])
    mlp = decoder.LlamaMoeMlp(decoder.LlamaConfig(**cfg))
    mlp.load_state_dict(convert.flax_to_state_dict(params))
    gathers = []
    real_gather = decoder.moe_gather_matmul
    monkeypatch.setattr(decoder, "moe_gather_matmul",
                        lambda *a: gathers.append(1) or real_gather(*a))
    kernels.reset_counts()
    with torch.inference_mode():
        got = mlp(torch.from_numpy(x))
        _, topi = mlp.route(torch.from_numpy(x[0]))
    assert not any(kernels.launch_counts().values())
    np.testing.assert_array_equal(topi.numpy(),
                                  np.asarray(inter["intermediates"]["router_topi"][0]))
    if route == "ties":
        assert (topi.numpy() == [0, 1]).all()
    assert (len(gathers), routes) == (n_gather, grouped)
    _close(got[0], np.asarray(want)[0])


def test_moe_quantizer_matches_jax(mlp_params):
    """quantize_decoder_params on stacked experts: byte-equal to the JAX
    package's quant8_stack (per expert, per output channel), router f32."""
    params, qparams = mlp_params
    tree = {"layer_0": {"mlp": params}, "lm_head": np.ones((4, 4), np.float32)}
    want = convert.flax_to_state_dict(jloader.quantize_decoder_params(tree, bits=8))
    got = hf_loader.quantize_decoder_params(convert.flax_to_state_dict(tree))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    assert got["layers.0.mlp.router"].dtype == torch.float32
    q, s = decoder.quantize_experts_int8(torch.from_numpy(params["gate"].copy()))
    assert torch.equal(q, torch.from_numpy(qparams["gate_q"]))
    assert torch.equal(s, torch.from_numpy(qparams["gate_s"]))


MIXTRAL_HF = {  # mistralai/Mixtral-8x7B-v0.1 config.json
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 32768, "model_type": "mixtral",
    "num_attention_heads": 32, "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "num_local_experts": 8, "output_router_logits": False,
    "rms_norm_eps": 1e-05, "rope_theta": 1000000.0, "router_aux_loss_coef": 0.02,
    "sliding_window": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "transformers_version": "4.36.0.dev0", "use_cache": True, "vocab_size": 32000}


def test_mixtral_config_matches_jax_loader(tmp_path):
    """LlamaConfig.mixtral_8x7b is the published config as the JAX loader
    maps it; its int8 experts are 45.1 GB, attention 1.34 GB."""
    (tmp_path / "config.json").write_text(json.dumps(MIXTRAL_HF))
    want = jloader.llama_config_from_hf(str(tmp_path), quantization="int8")
    got = decoder.LlamaConfig.mixtral_8x7b()
    shared = [f.name for f in dataclasses.fields(got) if hasattr(want, f.name)]
    assert len(shared) >= 20
    assert {n: getattr(got, n) for n in shared} == {n: getattr(want, n) for n in shared}
    cfg = hf_loader.select_kernels(got)
    assert cfg.use_flash and cfg.quant_kernel
    with torch.device("meta"):
        model = decoder.LlamaModel(cfg)
    sizes = {}
    for name, b in model.named_buffers():
        part = "experts" if ".mlp." in name else "attention" if ".attention." in name else None
        if part:
            sizes[part] = sizes.get(part, 0) + b.numel() * b.element_size()
    codes = 32 * 8 * 3 * 4096 * 14336
    assert sizes["experts"] == codes + 32 * 8 * 4 * (14336 + 14336 + 4096)
    assert round(codes / 1e9, 1) == 45.1
    assert round(sizes["attention"] / 1e9, 2) == 1.34


def test_init_decoder_params_draws_moe_layers():
    cfg = decoder.LlamaConfig.tiny(num_experts=4, num_experts_per_tok=2,
                                   quantization="int8", moe_layers=(True, False))
    params = decoder.init_decoder_params(cfg, torch.Generator().manual_seed(0))
    assert params["layers.0.mlp.router"].dtype == torch.float32
    assert params["layers.0.mlp.gate_q"].shape == (4, 64, 128)
    assert params["layers.0.mlp.down_s"].shape == (4, 64)
    assert "layers.1.mlp.gate_proj.kernel_q" in params
    llm = decoder.LocalLLM(cfg, tokenizer.SimpleTokenizer(cfg.vocab_size),
                           params=params, device="cpu")
    assert isinstance(llm.model.layers[0].mlp, decoder.LlamaMoeMlp)
    assert isinstance(llm.model.layers[1].mlp, decoder.LlamaMlp)
    assert len(llm.generate([1, 2, 3], max_new_tokens=4, **GREEDY)) == 4


# ---------------------------------------------------------------------------
# A tiny MoE decoder, the serving engine and /chat
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=128, max_seq_len=256, rope_theta=10000.0,
            dtype="float32", num_experts=4, num_experts_per_tok=2)


def _tiny_pair(quant="none", **kw):
    """(JAX LocalLLM, port LocalLLM) with the same tiny MoE weights (h = 64:
    every MoE route takes its fallback in both packages)."""
    tok = jtok.SimpleTokenizer(TINY["vocab_size"])
    base = jdec.LocalLLM(jdec.LlamaConfig(**TINY), tok, seed=3)
    params = _numpy_tree(base.params)
    if quant == "int8":
        params = _numpy_tree(jloader.quantize_decoder_params(params, bits=8))
    cfg = dict(TINY, quantization=quant, **kw)
    j = jdec.LocalLLM(jdec.LlamaConfig(**cfg), tok, params=params)
    t = decoder.LocalLLM(decoder.LlamaConfig(**cfg),
                         tokenizer.SimpleTokenizer(TINY["vocab_size"]),
                         params=convert.flax_to_state_dict(params), device="cpu")
    return j, t


@pytest.fixture(scope="module", params=["none", "int8", "grouped-on"])
def tiny_moe(request):
    if request.param == "grouped-on":
        return _tiny_pair(moe_grouped="on")
    return _tiny_pair(request.param)


def test_tiny_moe_decoder_logits_match_jax(tiny_moe):
    j, t = tiny_moe
    ids = list(np.random.default_rng(0).integers(4, 512, 40))
    np.testing.assert_allclose(t.forward_logits(ids), j.forward_logits(ids),
                               rtol=1e-4, atol=1e-4)


def test_tiny_moe_decoder_greedy_stream_matches_jax(tiny_moe):
    """Against JAX's plain greedy loop: its default speculative decoder
    verifies 8 tokens at once, which changes t and so the MoE route."""
    j, t = tiny_moe
    ids = [int(x) for x in np.random.default_rng(1).integers(4, 512, 60)]
    want = j.generate(ids, max_new_tokens=12, temperature=0.0, speculative="off")
    assert t.generate(ids, max_new_tokens=12, temperature=0.0, speculative="off") == want


def test_moe_serving_engine_matches_jax():
    """Wave decode of concurrent requests (4 rows: t·top_k = 8 crosses the
    gather/dedup gate at E = 4) equals each request's solo generate and the
    JAX engine's waves."""
    j, t = _tiny_pair()
    prompts = {"a": [5, 17, 101], "b": [9, 8, 7, 6, 5], "c": [200, 300]}
    want = {k: j.generate(v, max_new_tokens=5, speculative="off", **GREEDY)
            for k, v in prompts.items()}
    solo = {k: t.generate(v, max_new_tokens=5, speculative="off", **GREEDY)
            for k, v in prompts.items()}
    kw = dict(num_pages=64, page_size=16, max_pages_per_seq=8)
    got = []
    for eng in (jserve.ServingEngine(j, spec_accept_floor=0.0, **kw),
                serving.ServingEngine(t, **kw)):
        for k, v in prompts.items():
            eng.add_request(k, v, max_new_tokens=5, **GREEDY)
        got.append(eng.run_wave(steps_per_dispatch=2))
    assert got[1] == got[0] == want == solo


def test_moe_chat_matches_jax_over_two_turns(tmp_path):
    """RagSystem with an injected tiny MoE decoder: replies, documents and
    histories over two turns equal the JAX RagSystem's (its decoder held to
    the plain greedy loop, as above)."""
    j_sys, t_sys = _build_systems(tmp_path, dict(LLM_CFG, num_experts=4,
                                                 num_experts_per_tok=2), "float32")
    assert isinstance(t_sys.llm.model.layers[0].mlp, decoder.LlamaMoeMlp)
    j_sys.llm.generate = functools.partial(j_sys.llm.generate, speculative="off")
    _two_turns_match(j_sys, t_sys)
