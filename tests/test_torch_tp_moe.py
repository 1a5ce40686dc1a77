"""The port's sparse-MoE decoder over the model axis (expert parallelism)
against the JAX package's, on the CPU.

The port lays its shards over "cpu" repeated, JAX over the 8 virtual CPU
devices of tests/conftest.py. Both run the same weights (the JAX params
carried across by ``models/convert.py``). Held to the JAX package
(tests/test_moe.py's mesh tests): TP with EP through greedy generation
(attention heads and the stacked experts both over 'model'), and the
expert-parallel decode gather engaged (S = t·top_k ≤ E / D) for float,
int8 and int4 experts, with a spy recording which shards ran the gather
(#10, or #13 for int4) on their own experts. Logits within 2e-4 (3e-4 for
the quantized stacks), token streams identical.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.models.hf_loader import quantize_decoder_params as jquantize
from ragmeup_tpu.parallel.mesh import make_mesh as jmake_mesh, mesh_shape_for
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.models import convert, decoder, tokenizer
from ragmeup_tpu_torch.parallel import mesh
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

PROMPT = [3, 9, 4, 17, 2]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _llms(cfg_kw, seed, model, bits=None):
    """(JAX one-device, JAX mesh, port one-device, port mesh) LLMs over
    mesh_shape_for(8, model_parallel=model) on the same weights."""
    jcfg = jdec.LlamaConfig.tiny(**cfg_kw)
    tok = jtok.SimpleTokenizer(jcfg.vocab_size)
    params = _numpy(jdec.LocalLLM(dataclasses.replace(jcfg, quantization="none"), tok,
                                  seed=seed).params)
    if bits:
        params = _numpy(jquantize(params, bits=bits, embeddings_bf16=False))
    shape = mesh_shape_for(8, model_parallel=model)
    tcfg = decoder.LlamaConfig.tiny(**cfg_kw)
    ttok = tokenizer.SimpleTokenizer(tcfg.vocab_size)
    sd = convert.flax_to_state_dict(params)
    return (jdec.LocalLLM(jcfg, tok, params=params),
            jdec.LocalLLM(jcfg, tok, params=params, mesh=jmake_mesh(shape)),
            decoder.LocalLLM(tcfg, ttok, params=dict(sd), device="cpu"),
            decoder.LocalLLM(tcfg, ttok, params=dict(sd),
                             mesh=mesh.make_mesh(shape, devices=["cpu"] * 8)))


@pytest.fixture
def gathers(monkeypatch):
    """The model-axis shard (or None) of every expert-gather call, by kernel."""
    seen = {"moe_gather": [], "moe_gather_int4": []}
    for fn, name in (("moe_gather_matmul", "moe_gather"),
                     ("moe_gather_matmul_int4", "moe_gather_int4")):
        orig = getattr(decoder, fn)
        monkeypatch.setattr(decoder, fn, lambda *a, _o=orig, _n=name, **kw: (
            seen[_n].append(getattr(kernels._scope, "shard", None)), _o(*a, **kw))[1])
    return seen


@pytest.mark.parametrize("grouped", ["auto", "on"])
def test_tp_ep_generation_matches_jax(grouped, gathers):
    """E = 4 experts, top-2, on a 2-way model axis (E / D = 2): a one-token
    decode (S = 2) takes the expert-parallel gather, the prefill the
    all-experts einsum on each shard's two experts; the grouped routes
    stay off under the mesh (``moe_grouped="on"`` too), as in JAX."""
    kw = dict(num_heads=4, num_kv_heads=2, dtype="float32", num_experts=4,
              num_experts_per_tok=2, moe_grouped=grouped)
    j1, jt, t1, tt = _llms(kw, seed=11, model=2)
    assert tt.model.shards[0].layers[0].mlp.gate.shape == (2, 64, 128)
    lg = tt.forward_logits(PROMPT)
    np.testing.assert_allclose(lg, jt.forward_logits(PROMPT), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lg, t1.forward_logits(PROMPT), rtol=2e-4, atol=2e-4)
    want = j1.generate(PROMPT, max_new_tokens=6, temperature=0.0, speculative="off")
    assert jt.generate(PROMPT, max_new_tokens=6, temperature=0.0, speculative="off") == want
    gathers["moe_gather"].clear()
    assert tt.generate(PROMPT, max_new_tokens=6, temperature=0.0, speculative="off") == want
    # each decoded token: 2 layers x 3 projections on each of the 2 shards
    assert gathers["moe_gather"].count(0) == gathers["moe_gather"].count(1) == 5 * 2 * 3
    assert tt.generate(PROMPT, max_new_tokens=6, temperature=0.0) == want


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_ep_decode_gather_matches_jax(bits, gathers):
    """E = 16 on a 4-way model axis (4 experts a shard): a one-token decode
    (S = 2 ≤ 4) takes the expert-parallel gather on every shard, float and
    int8 experts through #10's wrapper, int4 through #13's."""
    kw = dict(num_heads=4, num_kv_heads=4, dtype="float32", num_experts=16,
              num_experts_per_tok=2,
              quantization={None: "none", 8: "int8", 4: "int4"}[bits])
    j1, jt, t1, tt = _llms(kw, seed=5, model=4, bits=bits)
    tol = dict(rtol=3e-4, atol=3e-4) if bits else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tt.forward_logits(PROMPT), jt.forward_logits(PROMPT), **tol)
    want = j1.generate(PROMPT, max_new_tokens=6, temperature=0.0, speculative="off")
    assert jt.generate(PROMPT, max_new_tokens=6, temperature=0.0, speculative="off") == want
    assert t1.generate(PROMPT, max_new_tokens=6, temperature=0.0, speculative="off") == want
    for g in gathers.values():
        g.clear()
    assert tt.generate(PROMPT, max_new_tokens=6, temperature=0.0, speculative="off") == want
    name = "moe_gather_int4" if bits == 4 else "moe_gather"
    calls = gathers[name]
    assert sorted(set(calls)) == [0, 1, 2, 3], calls
    assert all(calls.count(i) == 5 * 2 * 3 for i in range(4))
    assert not gathers["moe_gather" if bits == 4 else "moe_gather_int4"]


def test_ep_partial_masks_other_shards_slots():
    """A shard's gather partial holds only the slots routed to its experts;
    the psum of the partials equals the one-device layer."""
    cfg = decoder.LlamaConfig.tiny(num_heads=4, num_kv_heads=4, dtype="float32",
                                   num_experts=8, num_experts_per_tok=2, num_layers=1)
    gen = torch.Generator().manual_seed(2)
    sd = decoder.init_decoder_params(cfg, gen, "cpu", std=0.2)
    tm = mesh.make_mesh((1, 1, 4), devices=["cpu"] * 4)
    tt = decoder.LocalLLM(cfg, tokenizer.SimpleTokenizer(cfg.vocab_size), params=dict(sd),
                          mesh=tm)
    t1 = decoder.LocalLLM(cfg, None, params=dict(sd), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1, 64))
                         .astype(np.float32))
    mlps = [m.layers[0].mlp for m in tt.model.shards]
    logits = mesh.all_gather([m.router_logits(x.reshape(1, 64)) for m in mlps])
    parts = [m.shard_partial(x, lg) for m, lg in zip(mlps, logits)]
    ids = t1.model.layers[0].mlp.route(x.reshape(1, 64))[1].reshape(-1)
    for i, (part, _) in enumerate(parts):
        mine = (ids // 2 == i)
        assert torch.all(part[~mine] == 0) and torch.all(part[mine].abs().sum(dim=1) > 0)
    got = parts[0][1](mesh.psum([p for p, _ in parts])[0])
    np.testing.assert_allclose(got.numpy(), t1.model.layers[0].mlp(x).numpy(),
                               rtol=1e-5, atol=1e-6)
