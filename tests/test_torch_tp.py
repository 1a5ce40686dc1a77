"""The port's model axis (tensor-parallel decoder, ring prefill) against the
JAX package's, on the CPU.

The port lays its shards over "cpu" repeated, JAX over the 8 virtual CPU
devices of tests/conftest.py (Pallas in interpret mode). Both run the same
weights (the JAX params carried across by ``models/convert.py``). Held to
the JAX package: the shard specs of every weight (``model_param_shardings``
with ``shard_vocab``, ``_drop_indivisible`` included) for dense, MoE, int8,
int4 and fused trees at model 2 and 4; ``QuantDense`` under the mesh on
each route against JAX's ``_tp_shard_matmul`` (a spy on the plain versions
records the route, which must be JAX's); ``LocalLLM`` at mesh (1, 4, 2)
against JAX's mesh ``LocalLLM`` and the port's one-device decoder (f32,
int8, int4, fused projections); ``ring_attention`` and the ring prefill
(long prompt, batched). Tolerances are JAX's own tests': logits 2e-4, the
ring 1e-4 on the op and 3e-4 through the decoder, token streams identical.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.models.hf_loader import quantize_decoder_params as jquantize
from ragmeup_tpu.ops import attention as jattn
from ragmeup_tpu.ops import quant_matmul as jqm
from ragmeup_tpu.parallel import mesh as jmesh
from ragmeup_tpu.parallel import tp as jtp
from ragmeup_tpu_torch.models import convert, decoder, tokenizer
from ragmeup_tpu_torch.ops import attention, quant_matmul
from ragmeup_tpu_torch.parallel import mesh, tp
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

LOGITS = dict(rtol=2e-4, atol=2e-4)
RING = dict(rtol=3e-4, atol=3e-4)


def _meshes(shape):
    """(JAX mesh, port mesh) of one shape."""
    n = int(np.prod(shape))
    return (jmesh.make_mesh(shape, devices=jax.devices()[:n]),
            mesh.make_mesh(shape, devices=["cpu"] * n))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _flat_specs(tree):
    """A JAX tree of shardings → {state-dict key: spec without trailing Nones}."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, val in node.items():
                key = str(key)
                walk(val, path + [f"layers.{key[6:]}" if key.startswith("layer_") else key])
        else:
            out[".".join(path)] = _strip(tuple(node.spec))
    walk(tree, [])
    return out


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _pair(cfg_kw, seed, shape=(1, 4, 2), quantize=None):
    """(JAX one-device, JAX mesh, port one-device, port mesh) LLMs on the
    same weights; ``quantize`` (bits) quantizes the f32 draw as the JAX
    loader does (the head too under ``head_quantization="int8"``)."""
    jcfg = jdec.LlamaConfig.tiny(**cfg_kw)
    tok = jtok.SimpleTokenizer(jcfg.vocab_size)
    params = _numpy(jdec.LocalLLM(jdec.LlamaConfig.tiny(**dict(
        cfg_kw, quantization="none", head_quantization="none")), tok, seed=seed).params)
    if quantize:
        head_bits = 8 if cfg_kw.get("head_quantization") == "int8" else 0
        params = _numpy(jquantize(params, bits=quantize, head_bits=head_bits))
    jm, tm = _meshes(shape)
    tcfg = decoder.LlamaConfig.tiny(**cfg_kw)
    ttok = tokenizer.SimpleTokenizer(tcfg.vocab_size)
    sd = convert.flax_to_state_dict(params)
    return (jdec.LocalLLM(jcfg, tok, params=params),
            jdec.LocalLLM(jcfg, tok, params=params, mesh=jm),
            decoder.LocalLLM(tcfg, ttok, params=dict(sd), device="cpu"),
            decoder.LocalLLM(tcfg, ttok, params=dict(sd), mesh=tm))


# -- shard specs -------------------------------------------------------------------

SPEC_CFGS = {
    "dense": dict(),
    "moe": dict(num_experts=8, num_experts_per_tok=2),
    "int8": dict(quantization="int8", tie_embeddings=False, head_quantization="int8"),
    "int4": dict(quantization="int4", tie_embeddings=False),
    "int4_moe": dict(quantization="int4", num_experts=8),
    "fused": dict(fused_projections=True, qkv_bias=True, qk_norm=True),
}


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", list(SPEC_CFGS))
def test_shard_specs_match_jax(name, model):
    kw = dict(num_heads=4, num_kv_heads=4, **SPEC_CFGS[name])
    jm, tm = _meshes((1, 8 // model, model))
    want = _flat_specs(jtp.model_param_shardings(
        jdec.LlamaModel(jdec.LlamaConfig.tiny(**kw)), jm, (jnp.zeros((1, 8), jnp.int32),),
        {"positions": jnp.arange(8)}, shard_vocab=True))
    got = tp.model_param_shardings(decoder.LlamaConfig.tiny(**kw), tm, shard_vocab=True)
    assert {k: _strip(v) for k, v in got.items()} == want
    assert got["token_embedding"] == ("model", None)
    if name == "int4" and model == 4:
        # k // group == 1 scale row: replicated, as JAX's _drop_indivisible keeps it
        assert got["layers.0.attention.o_proj.gscale"] == (None, None)
        assert got["layers.0.attention.o_proj.kernel_p"] == ("model", None)


def test_shard_specs_without_vocab_rule():
    jm, tm = _meshes((1, 4, 2))
    want = _flat_specs(jtp.model_param_shardings(
        jdec.LlamaModel(jdec.LlamaConfig.tiny()), jm, (jnp.zeros((1, 8), jnp.int32),),
        {"positions": jnp.arange(8)}))
    got = tp.model_param_shardings(decoder.LlamaConfig.tiny(), tm)
    assert {k: _strip(v) for k, v in got.items()} == want
    assert got["token_embedding"] == (None, None)


def test_tp_shard_model_places_contiguous_shards():
    """Sharded weights are contiguous copies of their slice; replicated ones
    are shared by the shards of one device; a flax tree converts."""
    _, tm = _meshes((1, 1, 2))
    cfg = decoder.LlamaConfig.tiny(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    sd = decoder.init_decoder_params(cfg, gen, "cpu")
    shards = tp.tp_shard_model(sd, cfg, tm)
    q = sd["layers.0.attention.q_proj.kernel"]
    for i, s in enumerate(shards):
        local = s["layers.0.attention.q_proj.kernel"]
        assert local.is_contiguous() and local.untyped_storage().data_ptr() != \
            q.untyped_storage().data_ptr()
        assert torch.equal(local, q[:, i * 32:(i + 1) * 32])
        assert torch.equal(s["token_embedding"], sd["token_embedding"][i * 256:(i + 1) * 256])
    assert shards[0]["final_norm.scale"] is shards[1]["final_norm.scale"]
    with pytest.raises(KeyError, match="no logical names"):
        tp.logical_names("layers.0.attention.rotary")
    consumed = dict(sd)
    again = tp.tp_shard_model(consumed, cfg, tm, consume=True)
    assert not consumed
    # a flax tree (layer_i nesting) shards to the same state dicts
    tree = {}
    for key, val in sd.items():
        node = tree
        parts = key.replace("layers.", "layer_").split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val.numpy()
    for a, b, c in zip(tp.tp_shard_model(tree, cfg, tm), again, shards):
        assert a.keys() == b.keys() == c.keys()
        assert all(torch.equal(a[key], c[key]) and torch.equal(b[key], c[key]) for key in a)


# -- QuantDense under the mesh: each route ---------------------------------------------

# (id, bits, a8, group, k, n, names, rows, bias, shards, route)
ROUTES = [
    ("int8-col", 8, False, 0, 512, 1024, ("embed", "qkv"), 3, False, 2, "int8"),
    ("int8-col-bias", 8, False, 0, 512, 1024, ("embed", "qkv"), 2, True, 2, "int8"),
    ("int8-row", 8, False, 0, 1024, 512, ("qkv", "embed"), 3, False, 2, "int8"),
    ("int8-fallback-narrow", 8, False, 0, 512, 512, ("embed", "kv"), 3, False, 2, "fallback"),
    ("int8-fallback-rows", 8, False, 0, 512, 1024, ("embed", "mlp"), 12, False, 2, "fallback"),
    ("w4a16-col", 4, False, 0, 512, 1024, ("embed", "mlp"), 3, False, 2, "int4"),
    ("w4a16-row", 4, False, 0, 1024, 512, ("mlp", "embed"), 3, False, 2, "int4"),
    ("w4a16-fallback-col", 4, False, 0, 512, 512, ("embed", "kv"), 3, True, 2, "fallback"),
    ("w4a16-fallback-row-cut-tile", 4, False, 0, 256, 512, ("mlp", "embed"), 3, False, 2,
     "fallback"),
    ("w4a16-fallback-row-scales-replicated", 4, False, 0, 256, 512, ("mlp", "embed"), 3,
     False, 4, "fallback"),
    ("w4a8-col", 4, True, 512, 512, 1024, ("embed", "qkv"), 3, False, 2, "int4_a8"),
    ("w4a8-row", 4, True, 512, 1024, 512, ("qkv", "embed"), 3, False, 2, "int4_a8"),
    ("float-col-bias", 0, False, 0, 64, 128, ("embed", "qkv"), 5, True, 2, "fallback"),
    ("float-row", 0, False, 0, 128, 64, ("mlp", "embed"), 5, False, 4, "fallback"),
]


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_quant_dense_under_mesh_matches_jax(case, monkeypatch):
    _, bits, a8, group, k, n, names, rows, bias, shards, route = case
    rng = np.random.default_rng(k + n + rows)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    full = {}
    if bits == 8:
        full["kernel_q"], full["scale"] = decoder.quantize_kernel_int8(w)
    elif bits == 4:
        full["kernel_p"], full["gscale"] = quant_matmul.quantize_int4_groupwise(w, group or None)
    else:
        full["kernel"] = w
    if bias:
        full["bias"] = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    x = rng.standard_normal((rows, k)).astype(np.float32)

    jm, tm = _meshes((1, 1, shards))
    jq = jdec.QuantDense(n, names, bits > 0, jnp.float32, bits or 8, True, q_group=group,
                         a8=a8, use_bias=bias, tp_mesh=jm)
    taken = {"jax": [], "port": []}
    orig8 = jqm.int8_matmul
    monkeypatch.setattr(jqm, "int8_matmul",
                        lambda *a, **kw: (taken["jax"].append("int8"), orig8(*a, **kw))[1])
    orig4 = jqm.int4_matmul
    monkeypatch.setattr(jqm, "int4_matmul", lambda *a, **kw: (
        taken["jax"].append("int4_a8" if kw.get("a8") else "int4"), orig4(*a, **kw))[1])
    want = np.asarray(jq.apply({"params": {key: jnp.asarray(v.numpy())
                                           for key, v in full.items()}}, jnp.asarray(x)))

    for fn, label in (("int8_matmul_plain", "int8"), ("int4_matmul_plain", "int4"),
                      ("int4_matmul_a8_plain", "int4_a8")):
        orig = getattr(quant_matmul, fn)
        monkeypatch.setattr(quant_matmul, fn, lambda *a, _o=orig, _l=label, **kw: (
            taken["port"].append(_l), _o(*a, **kw))[1])
    lnames = {"kernel": names, "kernel_q": names, "kernel_p": names, "gscale": names,
              "scale": (names[1],), "bias": (names[1],)}
    key = "layers.0.mlp.proj."
    specs = tp._drop_indivisible(
        {leaf: tuple(t.shape) for leaf, t in full.items()},
        {leaf: mesh.logical_axes(lnames[leaf]) for leaf in full}, tm)
    outs = []
    for i in range(shards):
        layer = decoder.QuantDense(k, n, bits > 0, torch.float32, True, "cpu", bits or 8,
                                   group, a8, bias, names, decoder.ModelShard(i, shards)
                                   ).requires_grad_(False)
        local = {}
        for leaf, t in full.items():
            spec = specs[leaf]
            local[leaf] = (tp._shard_of(key + leaf, t, spec.index("model"), i, shards, None)
                           if "model" in spec else t)
        layer.load_state_dict(local)
        xi = torch.from_numpy(x)
        if layer.row:
            xi = xi[:, i * (k // shards):(i + 1) * (k // shards)]
        outs.append(layer(xi))
    got = (mesh.psum(outs)[0] if names[1] == "embed" else torch.cat(outs, dim=-1)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    jax_route = taken["jax"][0] if taken["jax"] else "fallback"
    port_routes = set(taken["port"]) or {"fallback"}
    assert jax_route == route and port_routes == {route}, (taken, route)


# -- LocalLLM over the mesh ------------------------------------------------------------

LLM_CASES = {
    "f32": (dict(num_heads=4, num_kv_heads=2, dtype="float32"), None),
    "int8": (dict(num_heads=4, num_kv_heads=2, dtype="float32", quantization="int8"), 8),
    "int4": (dict(num_heads=4, num_kv_heads=2, dtype="float32", quantization="int4",
                  tie_embeddings=False), 4),
    "fused": (dict(num_heads=4, num_kv_heads=2, dtype="float32",
                   fused_projections=True), None),
    # an odd vocabulary: the embedding and the int8 head stay replicated
    "int8-head-odd-vocab": (dict(num_heads=4, num_kv_heads=2, dtype="float32",
                                 quantization="int8", tie_embeddings=False,
                                 head_quantization="int8", vocab_size=511), 8),
}


@pytest.mark.parametrize("name", list(LLM_CASES))
def test_tp_local_llm_matches_jax_and_one_device(name):
    """Mesh (1, 4, 2): the prefill rings over the corpus axis and the layers
    shard over the model axis. Logits within 2e-4 of JAX's mesh LLM and the
    port's one-device LLM; greedy streams (plain and speculative) equal."""
    kw, bits = LLM_CASES[name]
    j1, jt, t1, tt = _pair(kw, seed=3, quantize=bits)
    assert tt.mesh.shape == {"data": 1, "corpus": 4, "model": 2}
    assert len(tt.model.shards) == 2
    assert tt.model.shards[0].layers[0].attention.ring_devices == (torch.device("cpu"),) * 4
    assert tt.model.vocab_sharded == (kw.get("vocab_size", 512) % 2 == 0)
    prompt = [3, 9, 4, 17, 251]
    lg = tt.forward_logits(prompt)
    np.testing.assert_allclose(lg, jt.forward_logits(prompt), **LOGITS)
    np.testing.assert_allclose(lg, t1.forward_logits(prompt), **LOGITS)
    want = j1.generate(prompt, max_new_tokens=10, temperature=0.0, speculative="off")
    assert jt.generate(prompt, max_new_tokens=10, temperature=0.0, speculative="off") == want
    assert tt.generate(prompt, max_new_tokens=10, temperature=0.0, speculative="off") == want
    assert tt.generate(prompt, max_new_tokens=10, temperature=0.0) == want
    assert tt.generate(prompt, max_new_tokens=10, temperature=0.0, fused=False,
                       speculative="off") == want
    # sampled streams are the port's own: the mesh LLM equals the one-device one
    assert (tt.generate(prompt, max_new_tokens=8, temperature=0.7, seed=5)
            == t1.generate(prompt, max_new_tokens=8, temperature=0.7, seed=5))


def test_tp_captures_gather_heads():
    """attention_forward and qk_forward through the shards equal the
    one-device captures (the heads gathered in shard order)."""
    _, _, t1, tt = _pair(dict(num_heads=4, num_kv_heads=2, dtype="float32"), seed=4,
                         shape=(1, 1, 2))
    ids = [5, 17, 101, 42, 7, 9]
    for a, b in zip(tt.attention_forward(ids), t1.attention_forward(ids)):
        assert a.shape == (1, 4, 6, 6)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(tt.qk_forward(ids), t1.qk_forward(ids)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_tp_refuses_indivisible_widths():
    cfg = decoder.LlamaConfig.tiny(num_heads=4, num_kv_heads=4, intermediate_size=126,
                                   dtype="float32")
    _, tm = _meshes((1, 1, 4))
    with pytest.raises(ValueError, match="intermediate_size=126"):
        decoder.LocalLLM(cfg, tokenizer.SimpleTokenizer(cfg.vocab_size), seed=0, mesh=tm)
    with pytest.raises(AssertionError, match="num_kv_heads=2 not divisible"):
        decoder.LocalLLM(decoder.LlamaConfig.tiny(), None, seed=0, mesh=tm)


# -- ring attention ----------------------------------------------------------------------

def _qkv(rng, b, s, d):
    return [rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal,b,s", [(True, 2, 8 * 32), (False, 1, 8 * 16)])
def test_ring_attention_matches_jax(causal, b, s):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, b, s, 16)
    jm, _ = _meshes((1, 8, 1))
    want = np.asarray(jattn.ring_attention(jm, *map(jnp.asarray, (q, k, v)),
                                           axis_name="corpus", causal=causal))
    got = attention.ring_attention(*map(torch.from_numpy, (q, k, v)), ["cpu"] * 8,
                                   causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ref = attention.attention_reference(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4, atol=1e-4)


def test_ring_attention_longer_keys_and_bf16():
    """kv_len > s (a prefill into a longer cache) and bf16 inputs."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, 64, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 128, 16)).astype(np.float32))
            for _ in range(2))
    ref = attention.attention_reference(q, k, v)
    got = attention.ring_attention(q, k, v, ["cpu"] * 4)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = attention.ring_attention(qb, kb, vb, ["cpu"] * 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               attention.attention_reference(qb, kb, vb).float().numpy(),
                               rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="divisible by 3"):
        attention.ring_attention(q, k, v, ["cpu"] * 3)


def test_ring_prefill_long_prompt_matches_jax():
    """A 300-token prompt (a 512-token bucket, four ring blocks)."""
    j1, jt, t1, tt = _pair(dict(num_heads=4, num_kv_heads=2, dtype="float32",
                                max_seq_len=512), seed=7)
    prompt = np.random.default_rng(11).integers(2, 512, 300).tolist()
    lg = tt.forward_logits(prompt)
    np.testing.assert_allclose(lg, jt.forward_logits(prompt), **RING)
    np.testing.assert_allclose(lg, t1.forward_logits(prompt), **RING)
    want = j1.generate(prompt, max_new_tokens=8, temperature=0.0, speculative="off")
    assert tt.generate(prompt, max_new_tokens=8, temperature=0.0, speculative="off") == want


def test_ring_prefill_batched_matches_jax():
    """b = 2 rides the ring (head-major fold); the row right-padded to 40
    tokens matches on its real rows."""
    cfg_kw = dict(num_heads=4, num_kv_heads=2, dtype="float32", max_seq_len=256)
    jcfg = jdec.LlamaConfig.tiny(**cfg_kw)
    jm, tm = _meshes((1, 4, 2))
    L = 64
    rng = np.random.default_rng(3)
    ids = rng.integers(2, jcfg.vocab_size, (2, L)).astype(np.int32)
    lens = [L, 40]
    for r, n in enumerate(lens):
        ids[r, n:] = 0
    bias = jdec.causal_bias(L, L)
    model_1 = jdec.LlamaModel(jcfg)
    params = _numpy(model_1.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1]),
                                 positions=jnp.arange(L), attn_bias=bias)["params"])
    want = np.asarray(jdec.LlamaModel(jcfg, sp_mesh=jm, tp_mesh=jm).apply(
        {"params": params}, jnp.asarray(ids), positions=jnp.arange(L), attn_bias=bias,
        ring=True)["logits"])
    tcfg = decoder.LlamaConfig.tiny(**cfg_kw)
    model = decoder.ShardedLlamaModel(
        tcfg, tm, tp.tp_shard_model(convert.flax_to_state_dict(params), tcfg, tm))
    tids = torch.from_numpy(ids).long()
    got = model(tids, torch.arange(L), attn_bias=decoder.causal_bias(L, L), ring=True).numpy()
    with torch.device("meta"):
        one = decoder.LlamaModel(tcfg)
    one.load_state_dict(convert.flax_to_state_dict(params), assign=True)
    one.inv_freq = model.shards[0].inv_freq
    plain = one.requires_grad_(False)(tids, torch.arange(L), attn_bias=decoder.causal_bias(L, L)).numpy()
    for r, n in enumerate(lens):
        np.testing.assert_allclose(got[r, :n], want[r, :n], **RING)
        np.testing.assert_allclose(got[r, :n], plain[r, :n], **RING)
