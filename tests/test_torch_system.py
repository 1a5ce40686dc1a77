"""The port's RagSystem against the JAX package's, end to end on the CPU.

Both systems ingest the same data directory with the same weights (the
JAX models' params converted into the port's modules) and greedy decoding,
on the default pipeline (hybrid search with MMR, cross-encoder rerank,
rewrite loop, Re2, rerank provenance); their chat() results must agree
over two turns, on a float32 index with a float32 decoder and on an int8
index with an int4 (W4A16) decoder whose projections reach the int4
kernels. Also: the package imports with jax and flax blocked, and
chip_smoke.py refuses to run without a GPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from flax import linen as nn

from ragmeup_tpu.config import RagConfig
from ragmeup_tpu.models import cross_encoder as jce
from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import encoder as jenc
from ragmeup_tpu.models import hf_loader as jloader
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.pipeline.system import RagSystem as JaxRagSystem
from ragmeup_tpu_torch.models import (convert, cross_encoder, decoder, encoder,
                                      hf_loader, tokenizer)
from ragmeup_tpu_torch.ops import quant_matmul
from ragmeup_tpu_torch.pipeline.system import RagSystem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOPICS = {
    "foxes.txt": "The quick brown fox jumps over the lazy dog near the river bank.",
    "markets.txt": "The stock market rallied on tech earnings; investors bought chips.",
    "quantum.txt": "Quantum computers use qubits instead of classical bits for search.",
    "trains.txt": "The night train to the city leaves at ten from platform four.",
    "music.txt": "The band released a new album with songs about the sea and rain.",
    "cooking.txt": "Bake the bread at two hundred degrees until the crust is brown.",
}


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def _config(data_dir, index_dir):
    cfg = RagConfig()
    cfg.data.data_directory = data_dir
    cfg.data.index_directory = index_dir
    cfg.data.chunk_size = 96
    cfg.model.embedding_dim = 64
    cfg.retrieval.dense_dtype = "float32"
    cfg.retrieval.vector_store_k = 6
    cfg.generation.temperature = 0.0
    cfg.generation.max_new_tokens = 6
    return cfg


# max_seq_len leaves room past the prompts: at T = 0 the JAX package
# decodes speculatively in 8-token chunks, which diverge from plain greedy
# once prompt + max_new_tokens + 8 passes max_seq_len
LLM_CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=128, max_seq_len=4096,
               rope_theta=10000.0, dtype="float32")
# int4 decoder: hidden 512 and intermediate 1024 tile by 512, so the
# projections reach the int4 kernels (head_dim 128: the flash prefill too)
LLM_CFG_INT4 = dict(LLM_CFG, hidden_size=512, intermediate_size=1024,
                    quantization="int4")


def _build_systems(root, llm_cfg, dense_dtype):
    """(JAX RagSystem, port RagSystem) over one data directory with the same
    weights; ``llm_cfg`` with quantization="int4" quantizes the JAX
    decoder's weights and hands the same int4 tree to both."""
    data = root / "data"
    data.mkdir()
    for name, text in TOPICS.items():
        (data / name).write_text((text + " ") * 4)
    bcfg = dict(dataclasses.asdict(jenc.BertConfig.tiny()), dtype="float32")
    base_cfg = {k: v for k, v in llm_cfg.items() if k != "quantization"}
    j_enc = jenc.SentenceEncoder(jenc.BertConfig(**bcfg),
                                 jtok.SimpleTokenizer(bcfg["vocab_size"]), seed=0)
    j_ce = jce.CrossEncoder(jenc.BertConfig(**bcfg),
                            jtok.SimpleTokenizer(bcfg["vocab_size"]), seed=1)
    j_llm = jdec.LocalLLM(jdec.LlamaConfig(**base_cfg),
                          jtok.SimpleTokenizer(llm_cfg["vocab_size"]), seed=2)
    params = _numpy_tree(j_llm.params)
    t_cfg = decoder.LlamaConfig(**llm_cfg)
    if llm_cfg.get("quantization") == "int4":
        params = jloader.quantize_decoder_params(params, bits=4)
        j_llm = jdec.LocalLLM(jdec.LlamaConfig(**llm_cfg, use_flash=True),
                              jtok.SimpleTokenizer(llm_cfg["vocab_size"]),
                              params=params)
        t_cfg = hf_loader.select_kernels(t_cfg)
    j_cfg = _config(str(data), str(root / "index_jax"))
    j_cfg.retrieval.dense_dtype = dense_dtype
    j_sys = JaxRagSystem(j_cfg, encoder=j_enc, cross_encoder=j_ce, llm=j_llm)

    tb = encoder.BertConfig(**bcfg)
    t_enc = encoder.SentenceEncoder(
        tb, tokenizer.SimpleTokenizer(tb.vocab_size),
        model=convert.encoder_from_flax(tb, _numpy_tree(j_enc.params)))
    t_ce = cross_encoder.CrossEncoder(
        tb, tokenizer.SimpleTokenizer(tb.vocab_size),
        model=convert.cross_encoder_from_flax(tb, _numpy_tree(j_ce.params)))
    t_llm = decoder.LocalLLM(t_cfg, tokenizer.SimpleTokenizer(llm_cfg["vocab_size"]),
                             params=convert.flax_to_state_dict(params))
    t_cfg = _config(str(data), str(root / "index_torch"))
    t_cfg.retrieval.dense_dtype = dense_dtype
    t_sys = RagSystem(t_cfg, encoder=t_enc, cross_encoder=t_ce, llm=t_llm,
                      device="cpu")
    return j_sys, t_sys


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    root = tmp_path_factory.mktemp("rag")
    return (*_build_systems(root, LLM_CFG, "float32"), root)


@pytest.fixture(scope="module")
def quantized_systems(tmp_path_factory):
    return _build_systems(tmp_path_factory.mktemp("rag_q"), LLM_CFG_INT4, "int8")


def _summary(out):
    return (out["reply"], [d["pk"] for d in out["documents"]], out["rewritten"],
            out["fetched_new_documents"], out["question"])


def _two_turns_match(j_sys, t_sys):
    assert t_sys.dense.n == j_sys.dense.n > 0
    hj, ht = [], []
    for prompt in ("Where does the fox jump?", "And what about the train?"):
        oj = j_sys.chat(prompt, hj)
        ot = t_sys.chat(prompt, ht)
        assert _summary(ot) == _summary(oj), prompt
        for dt, dj in zip(ot["documents"], oj["documents"]):
            assert dt["provenance"] == pytest.approx(dj["provenance"], rel=1e-4)
        hj, ht = oj["history"], ot["history"]
    assert ht == hj


def test_chat_matches_jax_over_two_turns(systems):
    j_sys, t_sys, _ = systems
    _two_turns_match(j_sys, t_sys)


def test_quantized_chat_matches_jax_over_two_turns(quantized_systems, monkeypatch):
    """int8 dense index (same codes in both) and int4 W4A16 decoder; the
    port's projections take the W4A16 kernel route (its plain version on
    the CPU)."""
    j_sys, t_sys = quantized_systems
    assert t_sys.dense.dtype == j_sys.dense.dtype == "int8"
    np.testing.assert_array_equal(t_sys.dense._corpus_t.numpy(),
                                  np.asarray(j_sys.dense._corpus_t))
    assert t_sys.llm.cfg.quantization == "int4"
    calls = []
    plain = quant_matmul.int4_matmul_plain
    monkeypatch.setattr(quant_matmul, "int4_matmul_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    _two_turns_match(j_sys, t_sys)
    assert (1, 512) in calls


def test_index_artifact_reloads_and_crud(systems, tmp_path):
    _, t_sys, root = systems
    cfg = t_sys.cfg
    again = RagSystem(cfg, encoder=t_sys.encoder, cross_encoder=t_sys.cross_encoder,
                      llm=t_sys.llm, device="cpu")
    assert again.dense.n == t_sys.dense.n and again.sparse.n == t_sys.sparse.n
    extra = tmp_path / "volcano.txt"
    extra.write_text("Volcanoes erupt molten lava and ash into the sky. " * 3)
    added = again.add_document(str(extra))
    assert added > 0
    rows = again.retriever.retrieve_rows("volcanoes lava ash")
    assert again.store[rows[0][0]].source == str(extra)
    assert again.delete_document(str(extra)) == added
    rows = again.retriever.retrieve_rows("volcanoes lava ash")
    assert all(again.store[r].source != str(extra) for r, _ in rows)


def test_refuses_unported_deployments(systems):
    _, t_sys, _ = systems
    cfg = t_sys.cfg
    for section, field, value in (("parallel", "corpus_axis", 2),
                                  ("server", "batched_llm", True),
                                  ("graph", "enabled", True)):
        bad = _config(cfg.data.data_directory, cfg.data.index_directory)
        setattr(getattr(bad, section), field, value)
        with pytest.raises(NotImplementedError):
            RagSystem(bad, encoder=t_sys.encoder, cross_encoder=t_sys.cross_encoder,
                      device="cpu", eager_load=False)


def test_model_settings_reach_the_loader(systems, monkeypatch):
    """Without an injected LLM, RagSystem hands cfg.model's checkpoint
    settings to load_local_llm, as the JAX package does."""
    _, t_sys, _ = systems
    from ragmeup_tpu_torch.pipeline import system as system_mod
    seen = {}
    real = system_mod.load_local_llm
    monkeypatch.setattr(system_mod, "load_local_llm",
                        lambda *a, **kw: seen.update(kw) or real(*a, **kw))
    cfg = _config(t_sys.cfg.data.data_directory, t_sys.cfg.data.index_directory)
    cfg.model.quantization, cfg.model.int4_w4a8 = "int4", True
    cfg.model.int4_group, cfg.model.llm_max_seq_len = 256, 2048
    sys_ = RagSystem(cfg, encoder=t_sys.encoder, cross_encoder=t_sys.cross_encoder,
                     device="cpu", eager_load=False)
    assert {k: seen[k] for k in ("quantization", "int4_w4a8", "int4_group",
                                 "max_seq_len")} == dict(
        quantization="int4", int4_w4a8=True, int4_group=256, max_seq_len=2048)
    assert sys_.llm.cfg == decoder.LlamaConfig.tiny()  # no checkpoint: ignored


BLOCK_JAX = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, _Block())
import ragmeup_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ragmeup_tpu_torch.__path__,
                                               "ragmeup_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")]
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", BLOCK_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_chip_smoke_refuses_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
