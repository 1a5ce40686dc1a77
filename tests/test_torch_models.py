"""The port's models against the JAX package's, with the same weights.

The JAX models initialize from ``jax.random``; ``models/convert.py`` hands
their flax params to the port. f32 throughout (the point is the algorithm);
the decoder test runs int8 weights with the flash prefill and the int8
decode kernel switched on, so the JAX side really takes its Pallas kernels
(interpret mode) and the port their plain versions.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from ragmeup_tpu.models import cross_encoder as jce
from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import encoder as jenc
from ragmeup_tpu.models import hf_loader as jloader
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu_torch.models import convert, cross_encoder, decoder, encoder
from ragmeup_tpu_torch.models import hf_loader, tokenizer

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
    from ragmeup_tpu.data.documents import Chunk
    chunks = [Chunk(content=x, metadata={"source": str(i)}) for i, x in enumerate(TEXTS)]
    got = t.rerank("fox dog", chunks, top_n=3)
    want = j.rerank("fox dog", chunks, top_n=3)
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
                         params=convert.flax_to_state_dict(qparams))
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


def test_rope_and_decode_path_against_jax():
    cfg = jdec.LlamaConfig(**DEC)
    np.testing.assert_array_equal(decoder.rope_inv_freq(128, 10000.0, cfg),
                                  jdec.rope_inv_freq(128, 10000.0, cfg))


def test_init_decoder_params_quantizes_and_loads():
    cfg = decoder.LlamaConfig.tiny(quantization="int8", tie_embeddings=False)
    gen = torch.Generator().manual_seed(0)
    params = decoder.init_decoder_params(cfg, gen)
    assert params["layers.0.attention.q_proj.kernel_q"].dtype == torch.int8
    assert params["lm_head"].dtype == torch.bfloat16
    llm = decoder.LocalLLM(cfg, tokenizer.SimpleTokenizer(cfg.vocab_size), params=params)
    out = llm.generate([1, 2, 3], max_new_tokens=4, temperature=0.0)
    assert len(out) == 4
    with pytest.raises(RuntimeError):
        decoder.LocalLLM(cfg, None, params={k: v for k, v in params.items()
                                            if k != "lm_head"})


def test_loaders_without_checkpoint(tmp_path):
    enc = hf_loader.load_sentence_encoder(None, dim=64)
    assert enc.encode(["hello"]).shape == (1, 64)
    ce = hf_loader.load_cross_encoder(None, kind="flashrank")
    assert ce.cfg.hidden_size == 128 and ce.score([("a", "b")]).shape == (1,)
    llm = hf_loader.load_local_llm(None)
    assert llm.cfg == decoder.LlamaConfig.tiny()
    with pytest.raises(NotImplementedError):
        hf_loader.load_local_llm(str(tmp_path))
    with pytest.raises(NotImplementedError):
        decoder.LlamaConfig(quantization="int4")
