"""Checkpoint loading of every Llama-layout family against the JAX package's and HF's.

Tiny transformers models of each family the JAX package loads beside Llama
and Mixtral (qwen2, mistral with a window and with an explicit head_dim,
phi3 at head_dim 96 with its packed projections, gemma, gemma2, qwen3,
qwen3_moe) are saved with ``save_pretrained`` and go through the port's
loaders (``ragmeup_tpu_torch/models/hf_loader.py``) and the JAX package's,
as tests/test_hf_parity.py and tests/test_moe.py do for the JAX package
alone. Held here, per family:

- ``llama_config_from_hf`` field by field equal to JAX's;
- ``llama_params_from_hf`` equal to ``convert.flax_to_state_dict`` of JAX's
  tree (Phi-3 after both packages split its packed tensors);
- f32 logits against JAX's and HF's (atol 2e-4; 3e-4 for Qwen3-MoE, the
  tolerance of JAX's own test of it);
- the streaming int8 and int4 loaders byte-equal to the port's generic path
  and within one code of JAX's streaming loaders (their rule, as in
  tests/test_torch_hf_loader.py), biases and norms unquantized;
- ``load_local_llm``'s greedy stream (int8) against JAX's, equal but for a
  first difference at a near-tie (ROADMAP's rule: a margin within one bf16
  ulp of the largest logit).

Also: Gemma-2 through the dense-cache generate loop (window and softcap in
the decode steps) against HF's full forwards; the serving engine's greedy
streams on tiny Gemma-2 and Phi-3 (head_dim 96) against the JAX engine's;
``fused_projections`` equal to the unfused decoder (as JAX's
test_fused_projections_identical); Phi-3's longrope and an unknown
model_type raising JAX's ValueError; the packed tensors split as views.
"""

import dataclasses
import json
import os
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

os.environ.setdefault("USE_TF", "0")  # transformers' torch models only: skip TensorFlow

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from flax import linen as nn

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import hf_loader as jloader
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.pipeline import serving as jserve
from ragmeup_tpu_torch.models import convert, decoder, hf_loader, tokenizer
from ragmeup_tpu_torch.models.safetensors import load_safetensors
from ragmeup_tpu_torch.ops.quant_matmul import int4_tiling, unpack_int4
from ragmeup_tpu_torch.pipeline import serving

IDS = [1, 17, 9, 42, 7, 23, 5, 11, 3, 29, 13, 2]
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
            rope_theta=10000.0, torch_dtype="float32")
FAMILIES = ["qwen2", "mistral", "mistral_hd", "phi3", "gemma", "gemma2", "qwen3", "qwen3_moe"]
ATOL = {"qwen3_moe": 3e-4}


def _model(name):
    """(model_type, a tiny HF model of the family, seeded)."""
    t = transformers
    if name == "qwen2":
        torch.manual_seed(1)
        model = t.Qwen2ForCausalLM(t.Qwen2Config(**TINY, tie_word_embeddings=False))
        # random-init biases are zeros: give them the size a trained model's have
        with torch.no_grad():
            for layer in model.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                             layer.self_attn.v_proj):
                    proj.bias.normal_(0.0, 0.5)
        return "qwen2", model
    if name == "mistral":    # a window that bites at 12 tokens
        torch.manual_seed(2)
        return "mistral", t.MistralForCausalLM(t.MistralConfig(
            **TINY, sliding_window=6, tie_word_embeddings=False,
            attn_implementation="eager"))
    if name == "mistral_hd":  # head_dim other than hidden / heads
        torch.manual_seed(3)
        return "mistral", t.MistralForCausalLM(t.MistralConfig(
            **TINY, head_dim=32, sliding_window=None, tie_word_embeddings=False))
    if name == "phi3":       # head_dim 96, packed qkv_proj and gate_up_proj
        torch.manual_seed(4)
        return "phi3", t.Phi3ForCausalLM(t.Phi3Config(
            **dict(TINY, hidden_size=192, num_attention_heads=2, num_key_value_heads=2),
            sliding_window=None, tie_word_embeddings=False, pad_token_id=0))
    if name == "gemma":
        torch.manual_seed(6)
        return "gemma", t.GemmaForCausalLM(t.GemmaConfig(**TINY, head_dim=16))
    if name == "gemma2":
        # caps at the tiny model's logit scale and q_proj scaled by 40 so
        # that both softcaps bite (JAX's test_gemma2_logits_match_hf)
        torch.manual_seed(9)
        model = t.Gemma2ForCausalLM(t.Gemma2Config(
            **TINY, head_dim=16, sliding_window=6, query_pre_attn_scalar=32,
            attn_logit_softcapping=1.0, final_logit_softcapping=0.5,
            attn_implementation="eager"))
        with torch.no_grad():
            for layer in model.model.layers:
                layer.self_attn.q_proj.weight.mul_(40.0)
        return "gemma2", model
    if name == "qwen3":
        torch.manual_seed(7)
        return "qwen3", t.Qwen3ForCausalLM(t.Qwen3Config(
            **TINY, head_dim=16, tie_word_embeddings=False))
    torch.manual_seed(1)     # qwen3_moe: a dense layer between two MoE layers
    return "qwen3_moe", t.Qwen3MoeForCausalLM(t.Qwen3MoeConfig(
        **dict(TINY, num_hidden_layers=3, intermediate_size=112),
        moe_intermediate_size=96, head_dim=16, num_experts=4, num_experts_per_tok=2,
        decoder_sparse_step=1, mlp_only_layers=[1], norm_topk_prob=True,
        tie_word_embeddings=False))


@pytest.fixture(scope="module")
def fams(tmp_path_factory):
    """name -> (directory, model_type, golden f32 logits of IDS)."""
    root = tmp_path_factory.mktemp("families")
    out = {}
    for name in FAMILIES:
        mt, model = _model(name)
        model = model.eval()
        d = str(root / name)
        model.save_pretrained(d, safe_serialization=True)
        with open(os.path.join(d, "generation_config.json"), "w") as f:
            json.dump({"eos_token_id": 127}, f)
        with torch.no_grad():
            golden = model(torch.tensor([IDS])).logits[0].numpy()
        out[name] = (d, mt, golden)
    return out


def _tensors(d, cfg, load):
    t = load(d)
    if any(k.endswith("self_attn.qkv_proj.weight") for k in t):
        split = hf_loader.split_packed_tensors if load is load_safetensors \
            else jloader._split_packed_tensors
        t = split(t, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    return t


def _generic(d, quantization="none", **kw):
    cfg = hf_loader.llama_config_from_hf(d)
    params = hf_loader.llama_params_from_hf(_tensors(d, cfg, load_safetensors),
                                            cfg.num_layers, cfg.tie_embeddings)
    if quantization != "none":
        params = hf_loader.quantize_decoder_params(
            params, bits=8 if quantization == "int8" else 4, **kw)
    return cfg, params


def _jax_params(d):
    jcfg = jloader.llama_config_from_hf(d)
    return jcfg, jloader.llama_params_from_hf(_tensors(d, jcfg, jloader.load_safetensors),
                                              jcfg.num_layers, jcfg.tie_embeddings)


def _port_logits(cfg, params, ids=IDS):
    llm = decoder.LocalLLM(dataclasses.replace(cfg, dtype="float32"), None, params=params,
                           device="cpu")
    return llm.model(torch.tensor([ids]), torch.arange(len(ids)),
                     attn_bias=decoder.causal_bias(len(ids), len(ids)))[0].numpy()


def _jax_logits(cfg, params, ids=IDS):
    out = jdec.LlamaModel(dataclasses.replace(cfg, dtype="float32")).apply(
        {"params": params}, jnp.asarray([ids], jnp.int32), positions=jnp.arange(len(ids)),
        attn_bias=jdec.causal_bias(len(ids), len(ids)))
    return np.asarray(out["logits"][0], np.float32)


# -- configs, parameters, logits ----------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_config_matches_jax(fams, name):
    d, mt, _ = fams[name]
    got, want = hf_loader.llama_config_from_hf(d), jloader.llama_config_from_hf(d)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.head_dim == want.head_dim
    expect = {"qwen2": dict(qkv_bias=True), "mistral": dict(sliding_window=6),
              "mistral_hd": dict(head_dim_override=32), "phi3": dict(sliding_window=0),
              "gemma": dict(tie_embeddings=True, embed_scale=True, norm_offset=1.0,
                            act_fn="gelu_tanh"),
              "gemma2": dict(post_norms=True, attn_softcap=1.0, final_softcap=0.5,
                             layer_windows=(6, 0), query_scale=32 ** -0.5),
              "qwen3": dict(qk_norm=True, qkv_bias=False),
              "qwen3_moe": dict(moe_layers=(True, False, True), moe_intermediate_size=96,
                                qk_norm=True)}[name]
    assert {k: getattr(got, k) for k in expect} == expect
    if name == "phi3":
        assert got.head_dim == 96


@pytest.mark.parametrize("name", FAMILIES)
def test_params_and_f32_logits_match_jax_and_hf(fams, name):
    d, _, golden = fams[name]
    cfg, got = _generic(d)
    jcfg, jparams = _jax_params(d)
    want = convert.flax_to_state_dict(jparams)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    atol = ATOL.get(name, 2e-4)
    ours = _port_logits(cfg, got)
    np.testing.assert_allclose(ours, golden, atol=atol, rtol=atol)
    np.testing.assert_allclose(ours, _jax_logits(jcfg, jparams), atol=atol, rtol=atol)


def test_each_gemma2_branch_bites(fams):
    """Each of Gemma-2's branches moves the logits when it is knocked out,
    so the parity above holds each of them (JAX's knock-out list, and the
    post-norms)."""
    d, _, golden = fams["gemma2"]
    cfg, params = _generic(d)
    for knock in (dict(attn_softcap=0.0), dict(final_softcap=0.0), dict(query_scale=0.0),
                  dict(layer_windows=(0, 0)), dict(embed_scale=False),
                  dict(norm_offset=0.0)):
        out = _port_logits(dataclasses.replace(cfg, **knock), params)
        assert np.abs(out - golden).max() > 1e-3, knock


# -- quantizers --------------------------------------------------------------------


def _stream(d, quantization, device="cpu"):
    cfg = hf_loader.llama_config_from_hf(d)
    t = _tensors(d, cfg, load_safetensors)
    if quantization == "int8":
        return hf_loader.llama_int8_params_from_hf(t, cfg.num_layers, cfg.tie_embeddings,
                                                   device=device)
    return hf_loader.llama_int4_params_from_hf(t, cfg.num_layers, cfg.tie_embeddings,
                                               device=device)


def _codes(name, t):
    if name.endswith(("kernel_p", "_p")):
        packed = t.reshape(-1, *t.shape[-2:])
        tile_k = int4_tiling(2 * packed.shape[1])[0]
        return torch.stack([unpack_int4(p, tile_k) for p in packed]).to(torch.int16)
    return t.to(torch.int16)


@pytest.mark.parametrize("quantization", ["int8", "int4"])
@pytest.mark.parametrize("name", FAMILIES)
def test_streaming_loaders_match_generic_and_jax(fams, name, quantization):
    """Byte-equal to the generic path; within one code of JAX's streaming
    loaders on under 0.1 % of values, scales within 1e-6 (int8) and 1e-7
    (int4 group scales); biases and norms f32 and equal to the checkpoint's."""
    d = fams[name][0]
    got = _stream(d, quantization)
    _, want = _generic(d, quantization)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    jcfg = jloader.llama_config_from_hf(d)
    t = _tensors(d, jcfg, jloader.load_safetensors)
    fn = (jloader.llama_int8_params_from_hf if quantization == "int8"
          else jloader.llama_int4_params_from_hf)
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(
        fn(t, jcfg.num_layers, jcfg.tie_embeddings)))
    jwant = convert.flax_to_state_dict(tree)
    assert sorted(got) == sorted(jwant)
    extras = [k for k in got if k.endswith((".bias", "q_norm.scale", "k_norm.scale",
                                            "ffw_norm.scale"))]
    assert extras or name in ("mistral", "mistral_hd", "phi3", "gemma")
    for k in jwant:
        g, w = got[k], jwant[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == torch.int8:
            diff = (_codes(k, g) - _codes(k, w)).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3, k
        elif k.endswith(("scale", "_s", "gscale", "_gs")) and "norm" not in k:
            tol = 1e-7 if quantization == "int4" and not k.startswith("lm_head") else 1e-6
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=0, err_msg=k)
        else:
            assert torch.equal(g, w), k
    for k in extras:
        assert got[k].dtype == torch.float32


# -- generation ----------------------------------------------------------------------


def _streams_agree(llm, prompt, got, want):
    """Equal, or equal up to a first difference where the port's own logits
    put the two tokens within one bf16 ulp of the largest logit."""
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        assert len(got) == len(want)
        return
    logits = llm.forward_logits(list(prompt) + list(got[:n]))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(logits).max())) - 7)
    margin = abs(float(logits[got[n]]) - float(logits[want[n]]))
    assert margin <= ulp, (n, got, want, margin, ulp)


@pytest.mark.parametrize("name", FAMILIES)
def test_load_local_llm_greedy_matches_jax(fams, name):
    d = fams[name][0]
    t_llm = hf_loader.load_local_llm(d, device="cpu", quantization="int8")
    j_llm = jloader.load_local_llm(d, quantization="int8")
    for field in dataclasses.fields(t_llm.cfg):
        assert getattr(t_llm.cfg, field.name) == getattr(j_llm.cfg, field.name), field.name
    assert t_llm.eos_ids == j_llm.eos_ids == {127}
    got = t_llm.generate(IDS, max_new_tokens=8, temperature=0.0, repetition_penalty=1.0)
    want = j_llm.generate(IDS, max_new_tokens=8, temperature=0.0, repetition_penalty=1.0)
    assert got
    _streams_agree(t_llm, IDS, got, want)


def test_gemma2_generate_matches_full_forward(tmp_path):
    """Gemma-2 at its published caps (50, 30) with a window of 6 through the
    dense-cache decode loop: every greedy token equals the argmax of HF's
    full forward over the sequence so far (the window and the softcap hold
    step by step, not only in the prefill)."""
    torch.manual_seed(10)
    model = transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        **TINY, head_dim=16, sliding_window=6, query_pre_attn_scalar=32,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        attn_implementation="eager")).eval()
    d = str(tmp_path / "gemma2g")
    model.save_pretrained(d, safe_serialization=True)
    llm = hf_loader.load_local_llm(d, device="cpu")
    llm = decoder.LocalLLM(dataclasses.replace(llm.cfg, dtype="float32"), llm.tokenizer,
                           params=llm.model.state_dict(), device="cpu")
    prompt = [1, 17, 9, 42, 7, 23, 5, 11]
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(6):
            seq.append(int(model(torch.tensor([seq])).logits[0, -1].argmax()))
    for fused in (True, False):
        assert llm.generate(prompt, max_new_tokens=6, temperature=0.0,
                            repetition_penalty=1.0, speculative="off",
                            fused=fused) == seq[len(prompt):]
    assert llm.generate_speculative(prompt, max_new_tokens=6,
                                    repetition_penalty=1.0) == seq[len(prompt):]


@pytest.mark.parametrize("name", ["gemma2", "phi3"])
def test_serving_engine_matches_jax(fams, name):
    """The paged engine (chunked prefill and batched decode through #9's
    plain versions, with Gemma-2's windows, softcap and query scale) against
    the JAX engine on the same f32 weights: greedy streams of two
    concurrent requests identical."""
    d = fams[name][0]
    jcfg, jparams = _jax_params(d)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    cfg = dataclasses.replace(hf_loader.llama_config_from_hf(d), dtype="float32")
    j = jdec.LocalLLM(jcfg, jtok.SimpleTokenizer(jcfg.vocab_size), params=jparams)
    t = decoder.LocalLLM(cfg, tokenizer.SimpleTokenizer(cfg.vocab_size),
                         params=convert.flax_to_state_dict(jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = {"a": [int(x) for x in rng.integers(1, 120, 21)],
               "b": [int(x) for x in rng.integers(1, 120, 9)]}
    kw = dict(num_pages=64, page_size=16, max_pages_per_seq=8)
    streams = []
    for eng in (jserve.ServingEngine(j, spec_accept_floor=0.0, **kw),
                serving.ServingEngine(t, **kw)):
        for rid, p in prompts.items():
            eng.add_request(rid, p, max_new_tokens=6, temperature=0.0,
                            repetition_penalty=1.0)
        streams.append(eng.run())
    want, got = streams
    assert got == want and all(len(v) == 6 for v in got.values())


def test_fused_projections_equal_unfused(fams):
    """One qkv_proj (with Qwen2's biases concatenated) and one gate_up_proj
    give the unfused decoder's logits and greedy stream (f32), in the port
    and in JAX's fused decoder; quantized, they load through the generic
    path."""
    d = fams["qwen2"][0]
    cfg = dataclasses.replace(hf_loader.llama_config_from_hf(d), dtype="float32")
    fcfg = dataclasses.replace(cfg, fused_projections=True)
    t = load_safetensors(d)
    params = hf_loader.llama_params_from_hf(t, cfg.num_layers, cfg.tie_embeddings)
    fparams = hf_loader.llama_params_from_hf(t, cfg.num_layers, cfg.tie_embeddings,
                                             fused_projections=True)
    assert "layers.0.attention.qkv_proj.bias" in fparams
    assert "layers.0.mlp.gate_up_proj.kernel" in fparams
    jf = jloader.llama_params_from_hf(jloader.load_safetensors(d), cfg.num_layers,
                                      cfg.tie_embeddings, fused_projections=True)
    jflat = convert.flax_to_state_dict(jf)
    assert sorted(jflat) == sorted(fparams)
    assert all(torch.equal(fparams[k], jflat[k]) for k in jflat)
    l1 = decoder.LocalLLM(cfg, None, params=params, device="cpu")
    l2 = decoder.LocalLLM(fcfg, None, params=fparams, device="cpu")
    np.testing.assert_allclose(l1.forward_logits(IDS), l2.forward_logits(IDS), atol=1e-5)
    jcfg = dataclasses.replace(jloader.llama_config_from_hf(d), fused_projections=True)
    np.testing.assert_allclose(l2.forward_logits(IDS),
                               _jax_logits(jcfg, jf)[len(IDS) - 1], atol=2e-4)
    kw = dict(max_new_tokens=6, temperature=0.0, repetition_penalty=1.0)
    assert l1.generate(IDS, **kw) == l2.generate(IDS, **kw)
    q = hf_loader.quantize_decoder_params(fparams, bits=8)
    assert q["layers.0.attention.qkv_proj.kernel_q"].dtype == torch.int8
    assert torch.equal(q["layers.0.attention.qkv_proj.bias"], fparams[
        "layers.0.attention.qkv_proj.bias"])
    l3 = decoder.LocalLLM(dataclasses.replace(fcfg, quantization="int8"), None, params=q,
                          device="cpu")
    assert len(l3.generate(IDS, **kw)) == 6


def test_refusals_match_jax(tmp_path):
    """Phi-3's longrope (its 128k variants) and a model_type outside the
    Llama layout raise JAX's ValueError, with its message."""
    base = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=128)
    for name, c in (("phi3lr", dict(model_type="phi3", max_position_embeddings=131072,
                                    rope_scaling={"rope_type": "longrope",
                                                  "long_factor": [1.0] * 8,
                                                  "short_factor": [1.0] * 8})),
                    ("weird", dict(model_type="gpt_bigcode"))):
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps(dict(base, **c)))
        with pytest.raises(ValueError) as got:
            hf_loader.llama_config_from_hf(str(d))
        with pytest.raises(ValueError) as want:
            jloader.llama_config_from_hf(str(d))
        assert str(got.value) == str(want.value)
        assert ("rope_scaling" if name == "phi3lr" else "model_type") in str(got.value)


def test_packed_tensors_split_as_views(fams):
    d = fams["phi3"][0]
    cfg = hf_loader.llama_config_from_hf(d)
    t = load_safetensors(d)
    split = hf_loader.split_packed_tensors(t, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    want = jloader._split_packed_tensors(jloader.load_safetensors(d), cfg.num_heads,
                                         cfg.num_kv_heads, cfg.head_dim)
    assert sorted(split) == sorted(want)
    for k in want:
        assert torch.equal(split[k], convert.to_tensor(want[k])), k
    packed = t["model.layers.0.self_attn.qkv_proj.weight"]
    q = split["model.layers.0.self_attn.q_proj.weight"]
    assert q.untyped_storage().data_ptr() == packed.untyped_storage().data_ptr()
    assert q.shape == (cfg.num_heads * 96, cfg.hidden_size)


def test_synthetic_family_checkpoints_load_in_both_packages(tmp_path, monkeypatch):
    """The synthetic-checkpoint tool's five family layouts at tiny widths
    (same code, other numbers), two layers: both packages' configs and
    generic parameters equal, Gemma's norms written as zeros, and the
    port's int8 load generates; each tokenizer.json is cut to the config's
    vocabulary."""
    from ragmeup_tpu_torch.tools import synthetic_checkpoint as sc
    tiny = dict(vocab_size=800, hidden_size=64, intermediate_size=128)
    models = {"gemma2_9b": (dict(sc.GEMMA2_9B, **tiny, head_dim=32, num_attention_heads=4,
                                 num_key_value_heads=2, sliding_window=8), {"eos_token_id": 1}),
              "gemma_7b": (dict(sc.GEMMA_7B, **tiny, head_dim=32, num_attention_heads=2,
                                num_key_value_heads=2), {"eos_token_id": 1}),
              "phi3_mini_4k": (dict(sc.PHI3_MINI_4K, **dict(tiny, hidden_size=96),
                                    num_attention_heads=1, num_key_value_heads=1,
                                    sliding_window=7), {"eos_token_id": [5, 6]}),
              # 7 query heads a kv head, as Qwen2.5-7B's 28/4
              "qwen25_7b": (dict(sc.QWEN25_7B, **dict(tiny, hidden_size=112),
                                 num_attention_heads=7, num_key_value_heads=1), None),
              "qwen3_30b_a3b": (dict(sc.QWEN3_30B_A3B, **tiny, head_dim=16,
                                     num_attention_heads=4, num_key_value_heads=2,
                                     num_experts=4, num_experts_per_tok=2,
                                     moe_intermediate_size=32), {"eos_token_id": 7})}
    monkeypatch.setattr(sc, "MODELS", models)
    for model in models:
        d = str(tmp_path / model)
        r = sc.write_checkpoint(d, model, layers=2, device="cpu")
        assert r["bytes"] == sc.checkpoint_bytes(model, 2)
        cfg, jcfg = hf_loader.llama_config_from_hf(d), jloader.llama_config_from_hf(d)
        for field in dataclasses.fields(cfg):
            assert getattr(cfg, field.name) == getattr(jcfg, field.name), (model, field.name)
        _, params = _generic(d)
        _, jparams = _jax_params(d)
        want = convert.flax_to_state_dict(jparams)
        assert sorted(params) == sorted(want), model
        assert all(torch.equal(params[k], want[k]) for k in want), model
        if model.startswith("gemma"):
            assert cfg.tie_embeddings and "lm_head" not in params
            assert not params["layers.1.input_norm.scale"].any()
        if model == "gemma2_9b":
            assert cfg.layer_windows == (8, 0) and cfg.query_scale == 256 ** -0.5
            assert "layers.0.pre_ffw_norm.scale" in params
        if model == "qwen25_7b":
            assert cfg.num_heads // cfg.num_kv_heads == 7 and cfg.sliding_window == 0
            assert "layers.1.attention.k_proj.bias" in params
        if model == "qwen3_30b_a3b":
            assert cfg.num_experts == 4 and "layers.0.attention.q_norm.scale" in params
        llm = hf_loader.load_local_llm(d, device="cpu", quantization="int8")
        assert llm.generate([5, 6, 7], max_new_tokens=3, temperature=0.0, speculative="off")
