"""The port's models against the JAX package's, with the same weights.

The JAX models initialize from ``jax.random``; ``models/convert.py`` hands
their flax params to the port. f32 throughout (the point is the algorithm);
the decoder tests run int8 and int4 (W4A16, W4A8) weights with the flash
prefill and the quantized matmul kernels switched on, so the JAX side really
takes its Pallas kernels (interpret mode) and the port their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ragmeup_tpu.models import cross_encoder as jce
from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import encoder as jenc
from ragmeup_tpu.models import hf_loader as jloader
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.ops import quant_matmul as jqm
from ragmeup_tpu.ops import topk as jtopk
from ragmeup_tpu_torch.models import convert, cross_encoder, decoder, encoder
from ragmeup_tpu_torch.models import hf_loader, tokenizer
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

TEXTS = ["the quick brown fox jumps over the lazy dog",
         "quantum computing uses qubits instead of classical bits",
         "a",
         "earnings season lifts markets as tech stocks rally " * 6,
         "Ünïcödé text, with punctuation!?"]


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def test_tokenizers_match_jax():
    for t_tok, j_tok in ((tokenizer.SimpleTokenizer(30522), jtok.SimpleTokenizer(30522)),
                         (tokenizer.WordPieceTokenizer.build_from_corpus(TEXTS),
                          jtok.WordPieceTokenizer.build_from_corpus(TEXTS))):
        for t in TEXTS:
            assert t_tok.encode(t) == j_tok.encode(t)
            assert t_tok.encode_pair(t, TEXTS[0], max_len=24) == \
                j_tok.encode_pair(t, TEXTS[0], max_len=24)


def test_sentence_encoder_matches_jax():
    cfg = dict(dataclasses.asdict(jenc.BertConfig.tiny()), dtype="float32")
    jcfg, tcfg = jenc.BertConfig(**cfg), encoder.BertConfig(**cfg)
    tok = tokenizer.SimpleTokenizer(jcfg.vocab_size)
    j = jenc.SentenceEncoder(jcfg, jtok.SimpleTokenizer(jcfg.vocab_size), seed=3)
    t = encoder.SentenceEncoder(
        tcfg, tok, model=convert.encoder_from_flax(tcfg, _numpy_tree(j.params)))
    jv, tv = j.encode(TEXTS), t.encode(TEXTS)
    assert tv.shape == (len(TEXTS), 64)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), 1.0, rtol=1e-5)


def test_cross_encoder_matches_jax():
    cfg = dict(dataclasses.asdict(jenc.BertConfig.tiny()), dtype="float32")
    jcfg, tcfg = jenc.BertConfig(**cfg), encoder.BertConfig(**cfg)
    j = jce.CrossEncoder(jcfg, jtok.SimpleTokenizer(jcfg.vocab_size), seed=4)
    t = cross_encoder.CrossEncoder(
        tcfg, tokenizer.SimpleTokenizer(tcfg.vocab_size),
        model=convert.cross_encoder_from_flax(tcfg, _numpy_tree(j.params)))
    pairs = [("fox dog", x) for x in TEXTS]
    np.testing.assert_allclose(t.score(pairs), j.score(pairs), rtol=1e-5, atol=1e-6)
    from ragmeup_tpu.data import documents as jdocs
    from ragmeup_tpu_torch.data import documents

    def chunks(pkg):
        return [pkg.Chunk(content=x, metadata={"source": str(i)})
                for i, x in enumerate(TEXTS)]
    got = t.rerank("fox dog", chunks(documents), top_n=3)
    want = j.rerank("fox dog", chunks(jdocs), top_n=3)
    assert [c.content for c in got] == [c.content for c in want]
    assert got[0].metadata["relevance_score"] == pytest.approx(
        want[0].metadata["relevance_score"], rel=1e-5)


DEC = dict(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=1024, max_seq_len=512,
           rope_theta=10000.0, dtype="float32", tie_embeddings=False,
           rope_scaling_type="llama3", rope_scaling_factor=8.0,
           rope_scaling_original_max_position=64)


@pytest.fixture(scope="module")
def decoders():
    """(JAX LocalLLM, port LocalLLM) with the same int8 weights, flash
    prefill and the int8 decode kernel on (hd = 128, dims % 512 == 0)."""
    tok = jtok.SimpleTokenizer(DEC["vocab_size"])
    base = jdec.LocalLLM(jdec.LlamaConfig(**DEC), tok, seed=5)
    qparams = jloader.quantize_decoder_params(_numpy_tree(base.params), bits=8)
    flags = dict(DEC, quantization="int8", use_flash=True, quant_kernel=True)
    j = jdec.LocalLLM(jdec.LlamaConfig(**flags), tok, params=qparams)
    tcfg = hf_loader.select_kernels(decoder.LlamaConfig(**dict(DEC, quantization="int8")))
    assert tcfg.use_flash and tcfg.quant_kernel
    t = decoder.LocalLLM(tcfg, tokenizer.SimpleTokenizer(DEC["vocab_size"]),
                         params=convert.flax_to_state_dict(qparams), device="cpu")
    return j, t, base, qparams


def test_decoder_prefill_logits_match_jax(decoders):
    j, t, _, _ = decoders
    ids = list(np.random.default_rng(0).integers(4, 512, 40))
    np.testing.assert_allclose(t.forward_logits(ids), j.forward_logits(ids),
                               rtol=1e-4, atol=1e-4)


def test_decoder_greedy_stream_matches_jax(decoders):
    j, t, _, _ = decoders
    ids = [int(x) for x in np.random.default_rng(1).integers(4, 512, 60)]
    want = j.generate(ids, max_new_tokens=12, temperature=0.0)
    assert t.generate(ids, max_new_tokens=12, temperature=0.0) == want


def test_decoder_sampling_is_seeded(decoders):
    _, t, _, _ = decoders
    ids = [5, 6, 7, 8]
    a = t.generate(ids, max_new_tokens=6, temperature=0.8, seed=11)
    assert a == t.generate(ids, max_new_tokens=6, temperature=0.8, seed=11)
    assert len(a) == 6 and all(0 <= x < DEC["vocab_size"] for x in a)


def test_quantize_decoder_params_matches_jax(decoders):
    _, _, base, qparams = decoders
    sd = convert.flax_to_state_dict(_numpy_tree(base.params))
    q = hf_loader.quantize_decoder_params(sd)
    want = convert.flax_to_state_dict(qparams)
    assert set(q) == set(want)
    for name, w in want.items():
        assert q[name].dtype == w.dtype, name
        assert torch.equal(q[name], w), name


@pytest.fixture(scope="module", params=["w4a16", "w4a8"])
def int4_decoders(request):
    """(JAX LocalLLM, port LocalLLM, base flax params, int4 flax params) with
    the same int4 weights. hidden 512 and intermediate 1024 tile by 512, so
    both packages reach the int4 kernels (W4A8: group 512)."""
    a8 = request.param == "w4a8"
    group = 512 if a8 else 0
    tok = jtok.SimpleTokenizer(DEC["vocab_size"])
    base = jdec.LocalLLM(jdec.LlamaConfig(**DEC), tok, seed=6)
    qparams = jloader.quantize_decoder_params(_numpy_tree(base.params), bits=4,
                                              int4_group=group)
    flags = dict(DEC, quantization="int4", use_flash=True, int4_w4a8=a8,
                 int4_group=group)
    j = jdec.LocalLLM(jdec.LlamaConfig(**flags), tok, params=qparams)
    tcfg = hf_loader.select_kernels(decoder.LlamaConfig(
        **dict(DEC, quantization="int4", int4_w4a8=a8)))
    assert tcfg.use_flash and tcfg.int4_group == group
    t = decoder.LocalLLM(tcfg, tokenizer.SimpleTokenizer(DEC["vocab_size"]),
                         params=convert.flax_to_state_dict(qparams), device="cpu")
    return j, t, base, qparams, group


def _w4a8_reference(x, w_p, gscale):
    """W4A8 as the JAX package defines it (``_kernel4_a8``), from its own
    quantizer and unpacker: int8 codes of x per row, exact integer dots per
    512-row tile, then acc + float(p) * x_scale * tile_scale in tile order."""
    xq, xs = (np.asarray(a) for a in jtopk.quantize_int8(jnp.asarray(x), axis=1))
    w = np.asarray(jqm.unpack_int4(jnp.asarray(w_p), 512)).astype(np.int64)
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for t in range(w.shape[0] // 512):
        p = xq[:, t * 512:(t + 1) * 512].astype(np.int64) @ w[t * 512:(t + 1) * 512]
        acc = acc + p.astype(np.float32) * xs * gscale[t]
    return acc


def test_int4_decoder_prefill_logits_match_jax(int4_decoders):
    """W4A16: logits to 1e-4. W4A8 quantizes each activation row to int8,
    so a one-ulp difference upstream (RMSNorm, rope and attention sum in
    another order in the two packages) can move one code, and one moved
    code moves these logits by ~1e-2; JAX's interpreted W4A8 kernel itself
    differs from its own quantizer's codes by one step in a few rows. So
    W4A8 is held where neither can happen: every projection of the port's
    prefill, on the activations it actually saw, equals the JAX package's
    W4A8 definition on them (rtol 1e-5), and the logits stay within the
    activation-quantization noise the JAX package's own W4A8 test allows
    (rel 0.1)."""
    j, t, _, _, group = int4_decoders
    ids = list(np.random.default_rng(2).integers(4, 512, 40))
    if not group:
        np.testing.assert_allclose(t.forward_logits(ids), j.forward_logits(ids),
                                   rtol=1e-4, atol=1e-4)
        return
    seen = []
    hooks = [mod.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0], out)))
        for mod in t.model.modules() if isinstance(mod, decoder.QuantDense)]
    try:
        got = t.forward_logits(ids)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == 7 * DEC["num_layers"]
    for mod, x, out in seen:
        x, w_p, gs = x.reshape(-1, x.shape[-1]).numpy(), mod.kernel_p.numpy(), mod.gscale.numpy()
        if mod.features % 512:  # k/v (n = 256): the dequantize fallback in both
            want = np.asarray(jqm.int4_matmul(jnp.asarray(x), jnp.asarray(w_p),
                                              jnp.asarray(gs), a8=True))
        else:
            want = _w4a8_reference(x, w_p, gs)
        np.testing.assert_allclose(out.reshape(want.shape).numpy(), want,
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max())
    want = j.forward_logits(ids)
    assert np.abs(got - want).max() <= 0.1 * np.abs(want).max()


def test_int4_decoder_greedy_stream_matches_jax(int4_decoders):
    j, t, _, _, _ = int4_decoders
    ids = [int(x) for x in np.random.default_rng(3).integers(4, 512, 60)]
    want = j.generate(ids, max_new_tokens=12, temperature=0.0)
    assert t.generate(ids, max_new_tokens=12, temperature=0.0) == want


def test_int4_quantize_decoder_params_matches_jax(int4_decoders):
    _, t, base, qparams, group = int4_decoders
    sd = convert.flax_to_state_dict(_numpy_tree(base.params))
    q = hf_loader.quantize_decoder_params(sd, bits=4, int4_group=group)
    want = convert.flax_to_state_dict(qparams)
    assert set(q) == set(want) == set(t.model.state_dict())
    for name, w in want.items():
        assert q[name].dtype == w.dtype, name
        assert torch.equal(q[name], w), name


def test_rope_and_decode_path_against_jax():
    cfg = jdec.LlamaConfig(**DEC)
    np.testing.assert_array_equal(decoder.rope_inv_freq(128, 10000.0, cfg),
                                  jdec.rope_inv_freq(128, 10000.0, cfg))


@pytest.mark.parametrize("quant,kernel", [("int8", "kernel_q"), ("int4", "kernel_p")])
def test_init_decoder_params_quantizes_and_loads(quant, kernel):
    cfg = decoder.LlamaConfig.tiny(quantization=quant, tie_embeddings=False)
    gen = torch.Generator().manual_seed(0)
    params = decoder.init_decoder_params(cfg, gen)
    assert params[f"layers.0.attention.q_proj.{kernel}"].dtype == torch.int8
    assert params["lm_head"].dtype == torch.bfloat16
    llm = decoder.LocalLLM(cfg, tokenizer.SimpleTokenizer(cfg.vocab_size), params=params,
                           device="cpu")
    out = llm.generate([1, 2, 3], max_new_tokens=4, temperature=0.0)
    assert len(out) == 4
    with pytest.raises(RuntimeError):
        decoder.LocalLLM(cfg, None, params={k: v for k, v in params.items()
                                            if k != "lm_head"}, device="cpu")


def test_init_decoder_params_int4_groups():
    """Drawn int4 weights take the configured scale group (W4A8: 512), the
    shapes QuantDense expects."""
    cfg = hf_loader.select_kernels(decoder.LlamaConfig(
        **dict(DEC, num_layers=1, quantization="int4", int4_w4a8=True)))
    params = decoder.init_decoder_params(cfg, torch.Generator().manual_seed(1))
    assert params["layers.0.mlp.gate_proj.kernel_p"].shape == (256, 1024)
    assert params["layers.0.mlp.gate_proj.gscale"].shape == (1, 1024)
    assert params["layers.0.mlp.down_proj.gscale"].shape == (2, 512)
    decoder.LocalLLM(cfg, None, params=params, device="cpu")


def test_loaders_without_checkpoint(tmp_path):
    enc = hf_loader.load_sentence_encoder(None, dim=64, device="cpu")
    assert enc.encode(["hello"]).shape == (1, 64)
    ce = hf_loader.load_cross_encoder(None, kind="flashrank", device="cpu")
    assert ce.cfg.hidden_size == 128 and ce.score([("a", "b")]).shape == (1,)
    llm = hf_loader.load_local_llm(None, device="cpu")
    assert llm.cfg == decoder.LlamaConfig.tiny()
    assert hf_loader.load_local_llm(None, quantization="int4", int4_w4a8=True,
                                    max_seq_len=999, device="cpu").cfg == decoder.LlamaConfig.tiny()
    with pytest.raises(FileNotFoundError, match="config.json"):  # a directory: a checkpoint
        hf_loader.load_local_llm(str(tmp_path), device="cpu")
    assert decoder.LlamaConfig(quantization="int4").int4_group == 0
    with pytest.raises(ValueError):
        decoder.LlamaConfig(quantization="nf4")
