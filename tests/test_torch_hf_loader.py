"""The port's checkpoint loading against the JAX package's and HF's, on the CPU.

Tiny transformers models saved with ``save_pretrained`` (the HF file
layout: config.json + safetensors) go through the port's loaders
(``ragmeup_tpu_torch/models/{safetensors,hf_loader}.py``) and the JAX
package's (``ragmeup_tpu/models/hf_loader.py``), as
tests/test_hf_parity.py and tests/test_moe.py do for the JAX package
alone. Held here:

- the safetensors reader equal, bit for bit, to JAX's ``load_safetensors``
  (f32, bf16, a sharded save); the writer read back by ``safe_open`` and
  ``safe_open``'s files by the reader; an unlisted dtype raises;
- ``llama_config_from_hf`` field by field equal to JAX's (llama, llama3 rope
  scaling, mixtral, and configs of the other families and features), JAX's
  ValueError for an unknown model_type and an unknown rope scaling;
- ``llama_params_from_hf`` equal to ``convert.flax_to_state_dict`` of JAX's
  tree; f32 logits against JAX's and HF's (atol 2e-4, Mixtral 3e-4, as
  JAX's own tests hold them); the int8 head's logits against JAX's;
- the streaming int8 and int4 loaders byte-equal to the port's generic path
  (``llama_params_from_hf`` + ``quantize_decoder_params``) and within one
  code of JAX's streaming loaders on under 0.1 % of values;
- the BERT encoder's hidden states and the cross-encoder's logit against
  JAX's and HF's;
- ``load_local_llm`` with a checkpoint: its config and EOS ids equal JAX's,
  and its greedy streams JAX's (Llama and Mixtral, int8 and int4) but for
  a first difference at a near-tie (ROADMAP: a margin within about one
  bf16 ulp of the logits);
- ``synthetic_checkpoint.write_checkpoint`` at tiny widths read by both
  packages' loaders;
- one ``/chat`` of a ``RagSystem(cfg, device="cpu")`` with all three models
  set to checkpoint directories and an int8 head, against the JAX
  ``RagSystem`` on the same directories.
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
from safetensors import safe_open
from safetensors.torch import save_file

from ragmeup_tpu.config import RagConfig as JaxRagConfig
from ragmeup_tpu.models import cross_encoder as jce
from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import encoder as jenc
from ragmeup_tpu.models import hf_loader as jloader
from ragmeup_tpu.pipeline.system import RagSystem as JaxRagSystem
from ragmeup_tpu_torch import RagConfig
from ragmeup_tpu_torch.models import convert, cross_encoder, decoder, encoder, hf_loader
from ragmeup_tpu_torch.models.safetensors import Lazy, load_safetensors, save_safetensors
from ragmeup_tpu_torch.ops.quant_matmul import int4_tiling, unpack_int4
from ragmeup_tpu_torch.pipeline.system import RagSystem
from ragmeup_tpu_torch.tools import synthetic_checkpoint

IDS = [1, 17, 9, 42, 7, 23, 5, 11, 3, 29, 13, 2]
# 1,024 positions hold a /chat prompt (about 250 tokens) and its answer: at
# the context's end JAX's speculative greedy clamps its chunk where the port
# narrows it (ROADMAP queue 3), so the streams are held inside the window
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=1024, rope_theta=10000.0,
            tie_word_embeddings=False, torch_dtype="float32")
LLAMA3_ROPE = {"rope_type": "llama3", "factor": 2.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 64}


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def _save(model, path, **kw):
    model.save_pretrained(str(path), safe_serialization=True, **kw)
    return str(path)


def _golden(model):
    with torch.no_grad():
        return model(torch.tensor([IDS])).logits[0].numpy()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Tiny HF checkpoints: name -> (directory, golden f32 logits or None)."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    torch.manual_seed(0)
    llama = transformers.LlamaForCausalLM(
        transformers.LlamaConfig(intermediate_size=128, **TINY)).eval()
    out["llama"] = (_save(llama, root / "llama"), _golden(llama))
    out["llama_bf16"] = (_save(llama.to(torch.bfloat16), root / "llama_bf16"), None)
    out["llama_sharded"] = (_save(llama, root / "llama_sharded", max_shard_size="60KB"), None)
    torch.manual_seed(1)
    llama3 = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        intermediate_size=128, rope_scaling=LLAMA3_ROPE, **TINY)).eval()
    out["llama3"] = (_save(llama3, root / "llama3"), _golden(llama3))
    torch.manual_seed(0)
    mixtral = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        intermediate_size=112, num_local_experts=4, num_experts_per_tok=2, **TINY)).eval()
    out["mixtral"] = (_save(mixtral, root / "mixtral"), _golden(mixtral))
    # head_dim 128: the flash prefill; k = 256 and 512: int4 tiles of 256 and 512
    torch.manual_seed(2)
    wide = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **dict(TINY, hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
               num_hidden_layers=1), intermediate_size=512)).eval()
    out["wide"] = (_save(wide, root / "wide"), None)
    return out


def _bert(root, name, num_labels=None, std=0.02):
    hf_cfg = transformers.BertConfig(
        vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=128, type_vocab_size=2,
        initializer_range=std)
    torch.manual_seed(1)
    if num_labels is None:
        model = transformers.BertModel(hf_cfg).eval()
    else:
        hf_cfg.num_labels = num_labels
        model = transformers.BertForSequenceClassification(hf_cfg).eval()
    return _save(model, root / name), model


@pytest.fixture(scope="module")
def berts(tmp_path_factory):
    root = tmp_path_factory.mktemp("bert")
    return {"encoder": _bert(root, "encoder"), "cross": _bert(root, "cross", num_labels=1),
            # HF's init (std 0.02) scores every pair within 1e-4 of 0.504, so
            # their order is bf16 noise; at std 0.2 the scores spread by >0.015
            "chat_encoder": _bert(root, "chat_encoder", std=0.2),
            "chat_cross": _bert(root, "chat_cross", num_labels=1, std=0.2)}


# -- safetensors -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama", "llama_bf16", "llama_sharded", "mixtral"])
def test_reader_matches_jax_load_safetensors(ckpts, name):
    d = ckpts[name][0]
    if name == "llama_sharded":
        assert len([f for f in os.listdir(d) if f.endswith(".safetensors")]) > 2
    got, want = load_safetensors(d), jloader.load_safetensors(d)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == convert.to_tensor(v).dtype, k
        assert torch.equal(got[k], convert.to_tensor(v)), k


def _varied():
    gen = torch.Generator().manual_seed(3)
    return {"f32": torch.randn(3, 5, generator=gen),
            "bf16": torch.randn(7, generator=gen).to(torch.bfloat16),
            "f16": torch.randn(2, 2, generator=gen).to(torch.float16),
            "f64": torch.randn(3, generator=gen).double(),
            "i8": torch.arange(-4, 5, dtype=torch.int8), "u8": torch.arange(6, dtype=torch.uint8),
            "i16": torch.arange(3, dtype=torch.int16), "i32": torch.arange(4, dtype=torch.int32),
            "i64": torch.arange(5, dtype=torch.int64), "bool": torch.tensor([True, False, True]),
            "empty": torch.zeros(0, 4), "scalar": torch.tensor(2.5)}


def test_writer_and_reader_round_trip_with_safetensors(tmp_path):
    tensors = _varied()
    ours = str(tmp_path / "ours.safetensors")
    save_safetensors(dict(tensors, lazy=Lazy((2, 3), torch.bfloat16,
                                             lambda: torch.full((2, 3), 1.5, dtype=torch.bfloat16))),
                     ours, metadata={"format": "pt"})
    with safe_open(ours, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(list(tensors) + ["lazy"])
        for k, v in tensors.items():
            assert torch.equal(f.get_tensor(k), v) and f.get_tensor(k).dtype == v.dtype, k
        assert torch.equal(f.get_tensor("lazy"), torch.full((2, 3), 1.5, dtype=torch.bfloat16))
    theirs = str(tmp_path / "theirs.safetensors")
    save_file(tensors, theirs)
    back = load_safetensors(theirs)
    for k, v in tensors.items():
        assert torch.equal(back[k], v) and back[k].dtype == v.dtype, k
    # a tensor made in another shape than the one declared is refused
    with pytest.raises(ValueError, match="not as declared"):
        save_safetensors({"x": Lazy((2,), torch.float32, lambda: torch.zeros(3))},
                         str(tmp_path / "bad.safetensors"))


def test_reader_maps_the_file_and_aligns(tmp_path):
    """Tensors view a copy-on-write map (no warning about a read-only
    buffer); a tensor whose bytes are misaligned for its dtype is copied."""
    path = str(tmp_path / "odd.safetensors")
    save_file({"b": torch.arange(3, dtype=torch.int8),
               "f": torch.arange(4, dtype=torch.float32)}, path)
    header, start = __import__("ragmeup_tpu_torch.models.safetensors",
                               fromlist=["read_header"]).read_header(path)
    # rewrite the header with f's bytes one past an aligned offset
    raw = open(path, "rb").read()
    data = raw[start:]
    b0, b1 = header["b"]["data_offsets"]
    f0, f1 = header["f"]["data_offsets"]
    new = data[b0:b1] + data[f0:f1]
    header = {"b": dict(header["b"], data_offsets=[0, 3]),
              "f": dict(header["f"], data_offsets=[3, 19])}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob + new)
    with __import__("warnings").catch_warnings():
        __import__("warnings").simplefilter("error")
        got = load_safetensors(path)
    assert torch.equal(got["f"], torch.arange(4, dtype=torch.float32))
    assert torch.equal(got["b"], torch.arange(3, dtype=torch.int8))


def test_unlisted_dtype_raises(tmp_path):
    path = str(tmp_path / "fp8.safetensors")
    save_file({"w": torch.zeros(4).to(torch.float8_e4m3fn)}, path)
    with pytest.raises(ValueError, match="F8_E4M3"):
        load_safetensors(path)


# -- configs -----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama", "llama3", "mixtral", "wide"])
@pytest.mark.parametrize("quantization, max_seq_len", [("none", 0), ("int8", 100)])
def test_llama_config_matches_jax(ckpts, name, quantization, max_seq_len):
    d = ckpts[name][0]
    got = hf_loader.llama_config_from_hf(d, quantization, max_seq_len=max_seq_len)
    want = jloader.llama_config_from_hf(d, quantization, max_seq_len=max_seq_len)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.head_dim == want.head_dim
    if name == "llama3":
        assert got.rope_scaling_type == "llama3" and got.rope_scaling_factor == 2.0
    if name == "mixtral":
        assert (got.num_experts, got.num_experts_per_tok) == (4, 2)


def _config_dir(tmp_path, name, **c):
    d = tmp_path / name
    d.mkdir()
    base = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
                max_position_embeddings=256)
    (d / "config.json").write_text(json.dumps(dict(base, **c)))
    return str(d)


def test_config_refusals_match_jax(tmp_path):
    bad = _config_dir(tmp_path, "bert", model_type="bert")
    with pytest.raises(ValueError) as got:
        hf_loader.llama_config_from_hf(bad)
    with pytest.raises(ValueError) as want:
        jloader.llama_config_from_hf(bad)
    assert str(got.value) == str(want.value)
    rope = _config_dir(tmp_path, "yarn", model_type="llama", rope_scaling={"rope_type": "yarn"})
    with pytest.raises(ValueError, match="yarn"):
        hf_loader.llama_config_from_hf(rope)
    # the families and features the port once refused load as JAX loads them
    for name, c in (("qwen2", dict(model_type="qwen2")),
                    ("gemma", dict(model_type="gemma", head_dim=16)),
                    ("bias", dict(model_type="llama", attention_bias=True)),
                    ("head_dim", dict(model_type="llama", head_dim=32)),
                    ("window", dict(model_type="mixtral", sliding_window=4096,
                                    num_local_experts=4, num_experts_per_tok=2)),
                    ("gelu", dict(model_type="llama", hidden_act="gelu"))):
        d = _config_dir(tmp_path, name, **c)
        got, want = hf_loader.llama_config_from_hf(d), jloader.llama_config_from_hf(d)
        for field in dataclasses.fields(got):
            assert getattr(got, field.name) == getattr(want, field.name), (name, field.name)
        assert got.head_dim == want.head_dim, name


# -- parameters and logits ---------------------------------------------------------


def _generic(d, quantization="none", **kw):
    cfg = hf_loader.llama_config_from_hf(d)
    params = hf_loader.llama_params_from_hf(load_safetensors(d), cfg.num_layers,
                                            cfg.tie_embeddings)
    if quantization != "none":
        params = hf_loader.quantize_decoder_params(
            params, bits=8 if quantization == "int8" else 4, **kw)
    return cfg, params


@pytest.mark.parametrize("name", ["llama", "mixtral"])
def test_llama_params_match_jax(ckpts, name):
    d = ckpts[name][0]
    cfg, got = _generic(d)
    want = convert.flax_to_state_dict(jloader.llama_params_from_hf(
        jloader.load_safetensors(d), cfg.num_layers, cfg.tie_embeddings))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    part = hf_loader.llama_params_from_hf(load_safetensors(d), cfg.num_layers,
                                          cfg.tie_embeddings, layers=[1])
    assert not any(k.startswith("layers.0.") for k in part)
    assert all(torch.equal(part[k], got[k]) for k in part)


def _port_logits(cfg, params):
    llm = decoder.LocalLLM(cfg, None, params=params, device="cpu")
    out = llm.model(torch.tensor([IDS]), torch.arange(len(IDS)),
                    attn_bias=decoder.causal_bias(len(IDS), len(IDS)))
    return out[0].numpy()


def _jax_logits(cfg, params):
    out = jdec.LlamaModel(cfg).apply({"params": params}, jnp.asarray([IDS], jnp.int32),
                                     positions=jnp.arange(len(IDS)),
                                     attn_bias=jdec.causal_bias(len(IDS), len(IDS)))
    return np.asarray(out["logits"][0], np.float32)


@pytest.mark.parametrize("name, atol", [("llama", 2e-4), ("llama3", 2e-4), ("mixtral", 3e-4)])
def test_f32_logits_match_jax_and_hf(ckpts, name, atol):
    d, golden = ckpts[name]
    cfg, params = _generic(d)
    got = _port_logits(dataclasses.replace(cfg, dtype="float32"), params)
    jcfg = dataclasses.replace(jloader.llama_config_from_hf(d), dtype="float32")
    want = _jax_logits(jcfg, jloader.llama_params_from_hf(
        jloader.load_safetensors(d), jcfg.num_layers, jcfg.tie_embeddings))
    np.testing.assert_allclose(got, golden, atol=atol, rtol=atol)
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)


def test_int8_head_logits_match_jax(ckpts):
    """int8 weights and the int8 lm_head at f32: the same codes in both
    packages (``quantize_decoder_params(head_bits=8)``) and logits within
    f32 rounding of JAX's (each head weight hq * hs, then f32 sums)."""
    d = ckpts["llama"][0]
    cfg, params = _generic(d, "int8", head_bits=8, embeddings_bf16=False)
    assert "lm_head" not in params and params["lm_head_q"].dtype == torch.int8
    cfg = dataclasses.replace(cfg, dtype="float32", quantization="int8",
                              head_quantization="int8")
    jcfg = dataclasses.replace(jloader.llama_config_from_hf(d), dtype="float32",
                               quantization="int8", head_quantization="int8")
    jparams = jloader.quantize_decoder_params(jloader.llama_params_from_hf(
        jloader.load_safetensors(d), jcfg.num_layers, jcfg.tie_embeddings),
        bits=8, head_bits=8, embeddings_bf16=False)
    flat = convert.flax_to_state_dict(jparams)
    for k in ("lm_head_q", "lm_head_scale"):
        assert torch.equal(params[k], flat[k]), k
    got, want = _port_logits(cfg, params), _jax_logits(jcfg, jparams)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the strips of dequantized head weights cover the vocabulary once
    llm = decoder.LocalLLM(cfg, None, params=params, device="cpu")
    x = torch.randn(3, cfg.hidden_size, generator=torch.Generator().manual_seed(0))
    whole = llm.model.logits(x)
    old = decoder.HEAD_STRIP_BYTES
    try:
        decoder.HEAD_STRIP_BYTES = 4 * cfg.hidden_size * 5  # 5 columns a strip
        assert torch.equal(llm.model.logits(x), whole)
    finally:
        decoder.HEAD_STRIP_BYTES = old


def test_init_decoder_params_draws_the_int8_head():
    """``head_quantization="int8"`` stores the drawn head per vocab column in
    int8; every other tensor is drawn as without it."""
    cfg = decoder.LlamaConfig.tiny(tie_embeddings=False, quantization="int8",
                                   head_quantization="int8")
    params = decoder.init_decoder_params(cfg, torch.Generator().manual_seed(0))
    plain = decoder.init_decoder_params(dataclasses.replace(cfg, head_quantization="none"),
                                        torch.Generator().manual_seed(0))
    assert params["lm_head_q"].shape == (cfg.hidden_size, cfg.vocab_size)
    assert params["lm_head_scale"].shape == (cfg.vocab_size,) and "lm_head" not in params
    assert (params["lm_head_q"].abs().amax(dim=0) == 127).all()
    assert sorted(set(params) - {"lm_head_q", "lm_head_scale"}) == sorted(set(plain) - {"lm_head"})
    assert all(torch.equal(params[k], plain[k]) for k in plain if k != "lm_head")
    deq = params["lm_head_q"].float() * params["lm_head_scale"]
    assert (deq - plain["lm_head"].float()).abs().max() < 0.01
    llm = decoder.LocalLLM(cfg, None, params=params, device="cpu")
    assert llm.generate([1, 2, 3], max_new_tokens=3, temperature=0.0)


# -- streaming quantizers ----------------------------------------------------------


STREAMS = [("llama", "int8", 0), ("llama", "int4", 0), ("mixtral", "int8", 0),
           ("mixtral", "int4", 0), ("wide", "int4", 512)]


def _stream(d, quantization, group):
    cfg = hf_loader.llama_config_from_hf(d)
    t = load_safetensors(d)
    if quantization == "int8":
        return hf_loader.llama_int8_params_from_hf(t, cfg.num_layers, cfg.tie_embeddings,
                                                   head_bits=8, device="cpu")
    return hf_loader.llama_int4_params_from_hf(t, cfg.num_layers, cfg.tie_embeddings,
                                               int4_group=group, head_bits=8, device="cpu")


@pytest.mark.parametrize("name, quantization, group", STREAMS)
def test_streaming_loaders_equal_the_generic_path(ckpts, name, quantization, group):
    d = ckpts[name][0]
    got = _stream(d, quantization, group)
    _, want = _generic(d, quantization, head_bits=8, int4_group=group)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        assert got[k].is_contiguous(), k
    if name == "wide" and quantization == "int4":
        # k = 256 walks the 512 request down to 256; k = 512 keeps it
        assert got["layers.0.attention.q_proj.gscale"].shape == (1, 256)
        assert got["layers.0.mlp.down_proj.gscale"].shape == (1, 256)


def _codes(name, t):
    if name.endswith(("kernel_p", "_p")):
        packed = t.reshape(-1, *t.shape[-2:])
        tile_k = int4_tiling(2 * packed.shape[1])[0]
        return torch.stack([unpack_int4(p, tile_k) for p in packed]).to(torch.int16)
    return t.to(torch.int16)


@pytest.mark.parametrize("name, quantization, group", STREAMS)
def test_streaming_loaders_within_one_code_of_jax(ckpts, name, quantization, group):
    """JAX's streaming loaders quantize with XLA, whose rounding of the scale
    division may move a code by one on a tail of values (its own tests'
    rule, test_hf_parity.py:211, :245); scales within 1e-6 (int8) and 1e-7
    (int4 group scales)."""
    d = ckpts[name][0]
    got = _stream(d, quantization, group)
    cfg = jloader.llama_config_from_hf(d)
    t = jloader.load_safetensors(d)
    if quantization == "int8":
        tree = jloader.llama_int8_params_from_hf(t, cfg.num_layers, cfg.tie_embeddings,
                                                 head_bits=8)
    else:
        tree = jloader.llama_int4_params_from_hf(t, cfg.num_layers, cfg.tie_embeddings,
                                                 int4_group=group, head_bits=8)
    want = convert.flax_to_state_dict(_tree(tree))
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == torch.int8:
            diff = (_codes(k, g) - _codes(k, w)).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3, k
        elif k.endswith(("scale", "_s", "gscale", "_gs")) and k != "final_norm.scale" \
                and "norm" not in k:
            tol = 1e-7 if quantization == "int4" and not k.startswith("lm_head") else 1e-6
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=0, err_msg=k)
        else:
            assert torch.equal(g, w), k


# -- BERT ------------------------------------------------------------------------


def test_bert_matches_jax_and_hf(berts):
    d, model = berts["encoder"]
    ids = [[2, 5, 9, 3, 7, 11], [4, 8, 0, 0, 0, 0]]
    mask = [[1, 1, 1, 1, 1, 1], [1, 1, 0, 0, 0, 0]]
    with torch.no_grad():
        golden = model(torch.tensor(ids), attention_mask=torch.tensor(mask)
                       ).last_hidden_state.numpy()
    jcfg = jloader.bert_config_from_hf(d)
    assert dataclasses.asdict(hf_loader.bert_config_from_hf(d)) == dataclasses.asdict(jcfg)
    cfg = dataclasses.replace(hf_loader.bert_config_from_hf(d), dtype="float32")
    params = hf_loader.bert_params_from_hf(load_safetensors(d), cfg.num_layers)
    jparams = jloader.bert_params_from_hf(jloader.load_safetensors(d), cfg.num_layers)
    flat = convert.flax_to_state_dict(jparams)
    assert sorted(params) == sorted(flat)
    assert all(torch.equal(params[k], flat[k]) for k in flat)
    model_t = encoder.BertEncoder(cfg)
    model_t.load_state_dict(params, strict=True)
    with torch.no_grad():
        got = model_t(torch.tensor(ids), torch.tensor(mask)).numpy()
    want = np.asarray(jenc.BertEncoder(dataclasses.replace(jcfg, dtype="float32")).apply(
        {"params": jparams}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)),
        np.float32)
    m = np.asarray(mask, bool)
    np.testing.assert_allclose(got[m], golden[m], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got[m], want[m], atol=2e-4, rtol=2e-4)
    # the factory: the checkpoint's config and weights, its embeddings
    # against the JAX factory's (both bf16)
    enc_t = hf_loader.load_sentence_encoder(d, device="cpu", batch_size=7)
    enc_j = jloader.load_sentence_encoder(d, batch_size=7)
    assert enc_t.cfg == encoder.BertConfig(**dataclasses.asdict(jcfg)) and enc_t.batch_size == 7
    texts = ["the fox jumps", "a train leaves at ten", "qubits"]
    np.testing.assert_allclose(enc_t.encode(texts), np.asarray(enc_j.encode(texts)),
                               atol=2e-2)


def test_cross_encoder_matches_jax_and_hf(berts):
    d, model = berts["cross"]
    ids, mask, types = [[2, 5, 9, 3, 7, 11]], [[1] * 6], [[0, 0, 0, 1, 1, 1]]
    with torch.no_grad():
        golden = model(torch.tensor(ids), attention_mask=torch.tensor(mask),
                       token_type_ids=torch.tensor(types)).logits.numpy().reshape(-1)
    cfg = dataclasses.replace(hf_loader.bert_config_from_hf(d), dtype="float32")
    params = hf_loader.cross_encoder_params_from_hf(load_safetensors(d), cfg.num_layers)
    jparams = jloader.cross_encoder_params_from_hf(jloader.load_safetensors(d),
                                                   cfg.num_layers)
    flat = convert.flax_to_state_dict(jparams)
    assert sorted(params) == sorted(flat)
    model_t = cross_encoder.CrossEncoderModel(cfg)
    model_t.load_state_dict(params, strict=True)
    with torch.no_grad():
        got = model_t(*(torch.tensor(a) for a in (ids, mask, types))).numpy()
    jcfg = dataclasses.replace(jloader.bert_config_from_hf(d), dtype="float32")
    want = np.asarray(jce.CrossEncoderModel(jcfg).apply(
        {"params": jparams}, *(jnp.asarray(a, jnp.int32) for a in (ids, mask, types))))
    np.testing.assert_allclose(got, golden, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, want.reshape(-1), atol=2e-4, rtol=2e-4)
    # the factory: FlashRank-class settings; a checkpoint without a head
    # (a plain BertModel) takes the port's own init from the seed
    ce = hf_loader.load_cross_encoder(d, kind="flashrank", device="cpu")
    assert (ce.batch_size, ce.max_len) == (128, 128)
    assert torch.equal(ce.model.classifier_kernel, params["classifier_kernel"])
    headless = berts["encoder"][0]
    a = hf_loader.load_cross_encoder(headless, seed=5, device="cpu")
    b = hf_loader.load_cross_encoder(headless, seed=5, device="cpu")
    init = cross_encoder.CrossEncoderModel(a.cfg)
    init.init_weights(torch.Generator().manual_seed(5))
    for k in ("classifier_kernel", "classifier_bias"):
        assert torch.equal(getattr(a.model, k), getattr(init, k)), k
        assert torch.equal(getattr(a.model, k), getattr(b.model, k)), k
    assert torch.equal(a.model.pooler_kernel, hf_loader.cross_encoder_params_from_hf(
        load_safetensors(headless), a.cfg.num_layers)["pooler_kernel"])
    assert a.batch_size == 64 and a.max_len == 128  # the position table caps pairs


# -- load_local_llm ----------------------------------------------------------------


LOADS = [dict(), dict(quantization="int8"), dict(quantization="int4"),
         dict(quantization="int4", int4_group=256), dict(quantization="int4", int4_w4a8=True),
         dict(quantization="int8", head_quantization="int8", max_seq_len=64)]


@pytest.mark.parametrize("kw", LOADS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items())
                         or "none")
def test_load_local_llm_config_matches_jax(ckpts, kw):
    d = ckpts["wide"][0]
    got = hf_loader.load_local_llm(d, device="cpu", **kw).cfg
    want = jloader.load_local_llm(d, **kw).cfg
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.use_flash
    if kw.get("int4_w4a8"):
        assert (got.int4_w4a8, got.int4_group) == (True, 512)


@pytest.mark.parametrize("eos", [7, [5, 9]])
def test_eos_ids_from_generation_config(ckpts, tmp_path, eos):
    src = ckpts["llama"][0]
    d = tmp_path / "ckpt"
    d.mkdir()
    for f in os.listdir(src):
        if f != "generation_config.json":
            os.symlink(os.path.join(src, f), d / f)
    assert hf_loader.load_local_llm(str(d), device="cpu").eos_ids == set()
    (d / "generation_config.json").write_text(json.dumps({"eos_token_id": eos}))
    got = hf_loader.load_local_llm(str(d), device="cpu").eos_ids
    assert got == jloader.load_local_llm(str(d)).eos_ids == set(np.atleast_1d(eos).tolist())


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


@pytest.mark.parametrize("name", ["llama", "mixtral"])
@pytest.mark.parametrize("quantization", ["int8", "int4"])
def test_greedy_streams_match_jax(ckpts, name, quantization):
    d = ckpts[name][0]
    t_llm = hf_loader.load_local_llm(d, device="cpu", quantization=quantization)
    j_llm = jloader.load_local_llm(d, quantization=quantization)
    got = t_llm.generate(IDS, max_new_tokens=8, temperature=0.0, repetition_penalty=1.0)
    want = j_llm.generate(IDS, max_new_tokens=8, temperature=0.0, repetition_penalty=1.0)
    assert len(got) == 8
    _streams_agree(t_llm, IDS, got, want)


# -- the tool and the system -------------------------------------------------------


def test_synthetic_checkpoint_loads_in_both_packages(tmp_path, monkeypatch):
    """The tool's layouts at tiny widths (same code, other numbers): a
    Llama-3.1 config, a Mixtral one and the two BERTs, written in several
    shards with a tokenizer.json cut to the config's vocabulary, read by
    both packages' loaders with equal results."""
    tiny = dict(vocab_size=640, hidden_size=64, intermediate_size=128,
                num_attention_heads=4, num_key_value_heads=2)
    bert = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_attention_heads=2)
    models = {"llama31_8b": (dict(synthetic_checkpoint.LLAMA31_8B, **tiny), {"eos_token_id": [3, 4]}),
              "mixtral_8x7b": (dict(synthetic_checkpoint.MIXTRAL_8X7B, **tiny,
                                    num_local_experts=4), {"eos_token_id": 2}),
              "gist_small": (dict(synthetic_checkpoint.GIST_SMALL, **bert), None),
              "minilm_l6_cross": (dict(synthetic_checkpoint.MINILM_L6_CROSS, **bert), None)}
    monkeypatch.setattr(synthetic_checkpoint, "MODELS", models)
    for model in models:
        d = str(tmp_path / model)
        r = synthetic_checkpoint.write_checkpoint(d, model, layers=2, device="cpu",
                                                  shard_gb=60e3 / 1e9)
        assert r["bytes"] == synthetic_checkpoint.checkpoint_bytes(model, 2)
        files = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
        assert len(files) > 1 and os.path.exists(os.path.join(d, "model.safetensors.index.json"))
        index = json.load(open(os.path.join(d, "model.safetensors.index.json")))
        got, want = load_safetensors(d), jloader.load_safetensors(d)
        assert sorted(got) == sorted(want) == sorted(index["weight_map"])
        assert all(g.dtype == torch.bfloat16 for g in got.values())
        for k in want:
            assert torch.equal(got[k], convert.to_tensor(want[k])), k
        if model in ("llama31_8b", "mixtral_8x7b"):
            cfg = hf_loader.llama_config_from_hf(d)
            assert cfg.num_layers == 2 and cfg.vocab_size == 640
            llm = hf_loader.load_local_llm(d, device="cpu", quantization="int8")
            jllm = jloader.load_local_llm(d, quantization="int8")
            assert llm.eos_ids == jllm.eos_ids
            text = "What do the notes say about kalomi?"
            assert llm.tokenizer.encode(text) == jllm.tokenizer.encode(text)
            assert llm.generate([5, 6, 7], max_new_tokens=3, temperature=0.0,
                                speculative="off")
            if model == "llama31_8b":
                assert cfg.rope_scaling_type == "llama3" and cfg.max_seq_len == 32768
            else:
                assert cfg.num_experts == 4 and cfg.rope_theta == 1e6
        else:
            load = (hf_loader.load_sentence_encoder if model == "gist_small"
                    else hf_loader.load_cross_encoder)
            assert load(d, device="cpu").cfg.hidden_size == 32


TOPICS = {
    "foxes.txt": "The quick brown fox jumps over the lazy dog near the river bank.",
    "markets.txt": "The stock market rallied on tech earnings; investors bought chips.",
    "quantum.txt": "Quantum computers use qubits instead of classical bits for search.",
    "trains.txt": "The night train to the city leaves at ten from platform four.",
}


def test_chat_from_checkpoints_matches_jax(ckpts, berts, tmp_path):
    """One /chat on the default pipeline with every model loaded from a
    checkpoint directory by RagSystem itself (int8 weights by the streaming
    loaders, an int8 head), in both packages on the same directories."""
    data = tmp_path / "data"
    data.mkdir()
    for name, text in TOPICS.items():
        (data / name).write_text((text + " ") * 4)
    systems = []
    for cls, sys_cls, kw in ((RagConfig, RagSystem, dict(device="cpu")),
                             (JaxRagConfig, JaxRagSystem, {})):
        cfg = cls()
        cfg.data.data_directory = str(data)
        cfg.data.index_directory = str(tmp_path / f"index_{cls.__module__.split('.')[0]}")
        cfg.data.chunk_size = 96
        cfg.retrieval.dense_dtype = "float32"
        cfg.retrieval.vector_store_k = 4
        cfg.generation.temperature = 0.0
        cfg.generation.max_new_tokens = 6
        cfg.model.embedding_dim = 64  # the index's width: the checkpoint encoder's
        cfg.model.llm_checkpoint = ckpts["llama"][0]
        cfg.model.embedding_checkpoint = berts["chat_encoder"][0]
        cfg.model.cross_encoder_checkpoint = berts["chat_cross"][0]
        cfg.model.head_quantization = "int8"
        systems.append(sys_cls(cfg, **kw))
    t_sys, j_sys = systems
    assert t_sys.llm.cfg.head_quantization == "int8" and t_sys.llm.cfg.quantization == "int8"
    assert "lm_head_q" in dict(t_sys.llm.model.named_buffers())
    assert t_sys.encoder.cfg.hidden_size == 64 and t_sys.dense.n == j_sys.dense.n > 0
    ot = t_sys.chat("Where does the fox jump?")
    oj = j_sys.chat("Where does the fox jump?")
    assert [d["pk"] for d in ot["documents"]] == [d["pk"] for d in oj["documents"]]
    assert (ot["question"], ot["rewritten"], ot["fetched_new_documents"]) == \
        (oj["question"], oj["rewritten"], oj["fetched_new_documents"])
    assert ot["reply"] == oj["reply"]
    for dt, dj in zip(ot["documents"], oj["documents"]):
        assert dt["provenance"] == pytest.approx(dj["provenance"], rel=2e-2)
