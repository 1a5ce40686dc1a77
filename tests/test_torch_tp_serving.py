"""The port's serving engine and RagSystem over the model axis, on the CPU.

The port lays its shards over "cpu" repeated, JAX over the 8 virtual CPU
devices of tests/conftest.py. Held to the JAX package's mesh tests
(tests/test_serving.py's mesh engine, tests/test_parallel.py's system
knobs): the engine's page pools held per shard over kv heads; its greedy
streams (``step``, waves, speculative waves, batched chunked prefill, the
concurrent chat backend) identical to the one-device engines' of both
packages and to JAX's mesh engine; ``RagSystem`` with
``parallel.model_axis = 2`` (beside ``corpus_axis = 4``: the ring prefill)
serving /chat with the one-device system's replies; a model-only mesh
keeping single-device retrieval with the plain system's rows. The mesh
decoders' first greedy step from the same checkpoint against JAX's at fixed
prompts of many lengths: both prefill on the ring, and where the two pick
apart the port's pick leads by at most one bf16 ulp on the logits the pick
is made on (with the repetition penalty, the penalized ones).
"""

import threading

import jax
import numpy as np
import pytest
from flax import linen as nn

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.parallel.mesh import make_mesh as jmake_mesh
from ragmeup_tpu.pipeline import serving as jserve
from ragmeup_tpu_torch.config import RagConfig
from ragmeup_tpu_torch.models import convert, decoder, tokenizer
from ragmeup_tpu_torch.parallel import mesh
from ragmeup_tpu_torch.pipeline import serving
from ragmeup_tpu_torch.pipeline.llm_backends import StaticChatBackend
from ragmeup_tpu_torch.pipeline.system import RagSystem
from ragmeup_tpu_torch.retrieval.dense import DenseIndex
from ragmeup_tpu_torch.retrieval.sparse import analyze
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

PROMPTS = {"a": [5, 17, 101, 42], "b": [9, 8, 7, 6, 5]}
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)
ENGINE = dict(num_pages=64, page_size=16, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def llms():
    """(JAX one-device, JAX mesh, port one-device, port mesh (1, 4, 2))."""
    cfg = dict(num_heads=4, num_kv_heads=2, dtype="float32")
    tok = jtok.SimpleTokenizer(512)
    j1 = jdec.LocalLLM(jdec.LlamaConfig.tiny(**cfg), tok, seed=3)
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(j1.params))
    sd = convert.flax_to_state_dict(params)
    tcfg = decoder.LlamaConfig.tiny(**cfg)
    ttok = tokenizer.SimpleTokenizer(512)
    return (j1, jdec.LocalLLM(jdec.LlamaConfig.tiny(**cfg), tok, params=params,
                              mesh=jmake_mesh((1, 4, 2))),
            decoder.LocalLLM(tcfg, ttok, params=dict(sd), device="cpu"),
            decoder.LocalLLM(tcfg, ttok, params=dict(sd),
                             mesh=mesh.make_mesh((1, 4, 2), devices=["cpu"] * 8)))


def _engine(llm, **kw):
    kw = dict(ENGINE, **kw)
    if isinstance(llm, jdec.LocalLLM):
        return jserve.ServingEngine(llm, spec_accept_floor=0.0, **kw)
    return serving.ServingEngine(llm, spec_accept_floor=0.0, **kw)


def _submit(eng):
    for k, v in PROMPTS.items():
        eng.add_request(k, v, max_new_tokens=6, **GREEDY)
    return eng


def test_mesh_engine_pools_sharded(llms):
    tp = llms[3]
    eng = _engine(tp)
    assert eng.mesh is tp.mesh
    k0 = eng.cache.k_pages[0]
    assert isinstance(k0, list) and len(k0) == 2
    assert all(t.shape == (1, 64, 16, 16) for t in k0 + eng.cache.v_pages[0])
    assert k0[0].data_ptr() != k0[1].data_ptr()


RUNNERS = {
    "step": lambda e: e.run(),
    "wave": lambda e: e.run_wave(steps_per_dispatch=4),
    "spec": lambda e: e.run_spec(iters=2, draft=4),
}


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_mesh_engine_matches_one_device_engines(llms, runner):
    j1, jt, t1, tt = llms
    want = _submit(_engine(j1)).run()
    assert _submit(_engine(t1)).run() == want
    assert RUNNERS[runner](_submit(_engine(tt))) == want
    if runner == "step":
        assert _submit(_engine(jt)).run() == want


def test_mesh_engine_batched_prefill_matches(llms):
    j1, _, _, tt = llms
    want = _submit(_engine(j1)).run()
    eng = _engine(tt, prefill_chunk=32)
    eng.add_requests([{"id": k, "prompt_ids": v, "max_new": 6, "temperature": 0.0,
                       "rp": 1.0} for k, v in PROMPTS.items()])
    assert eng.run() == want
    # a long prompt prefills in several chunks into the per-shard pools
    rng = np.random.default_rng(0)
    long = [int(t) for t in rng.integers(1, 400, 90)]
    a, b = (_engine(llm, prefill_chunk=32) for llm in (j1, tt))
    for eng in (a, b):
        eng.add_request("long", long, max_new_tokens=5, **GREEDY)
    assert b.run() == a.run()


def test_mesh_batched_backend_concurrent(llms):
    """Three concurrent greedy chats through the port's mesh backend equal
    JAX's mesh backend's replies and the port's one-device backend's."""
    _, jt, t1, tt = llms
    outs = {}
    backends = {name: serving.BatchedChatBackend(llm, wave_steps=4, spec_draft=4, **ENGINE)
                for name, llm in (("one", t1), ("mesh", tt))}
    backends["jax mesh"] = jserve.BatchedChatBackend(jt, wave_steps=4, spec_draft=4, **ENGINE)
    try:
        def ask(name, i):
            outs[name, i] = backends[name].chat(
                [{"role": "user", "content": f"question {i}"}], max_new_tokens=5,
                **GREEDY)
        threads = [threading.Thread(target=ask, args=(name, i))
                   for name in backends for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for be in backends.values():
            be.stop()
    assert len(outs) == 9
    assert all(outs["mesh", i] == outs["jax mesh", i] == outs["one", i] for i in range(3))


def _hash_embed(texts, d=64):
    out = np.zeros((len(texts), d), np.float32)
    for i, t in enumerate(texts):
        for tok in analyze(t):
            out[i, sum(map(ord, tok)) % d] += 1.0
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


class _Enc:
    encode = staticmethod(_hash_embed)


def _data(tmp_path):
    data = tmp_path / "docs"
    if not data.exists():
        data.mkdir()
        (data / "a.txt").write_text("alpha beta gamma delta")
        for i in range(8):
            (data / f"d{i}.txt").write_text(f"w{i} w{i + 1} special{i} theme{i % 3} topic")
    return str(data)


def _systems(tmp_path, tag, backend=None, dense_dtype="bfloat16", data=None, **parallel):
    """JAX's RagSystem and the port's over one data directory (``data``, or
    tmp_path's docs), both with
    ``parallel`` set (the port's mesh over "cpu" repeated, JAX's over the
    virtual CPU devices) and each loading its own LLM, over the mesh when
    the model axis is > 1, from the same tiny Llama checkpoint; or both
    with a static ``backend`` reply; ``dense_dtype`` the indexes'."""
    from ragmeup_tpu.config import RagConfig as JaxRagConfig
    from ragmeup_tpu.pipeline.llm_backends import StaticChatBackend as JaxStatic
    from ragmeup_tpu.pipeline.system import RagSystem as JaxRagSystem
    out = []
    for pkg, cls in (("jax", JaxRagConfig), ("torch", RagConfig)):
        cfg = cls()
        cfg.data.data_directory = data or _data(tmp_path)
        cfg.data.index_directory = str(tmp_path / f"idx_{tag}_{pkg}")
        cfg.model.embedding_dim = 64
        cfg.model.llm_checkpoint = _checkpoint(tmp_path)
        cfg.model.quantization = "none"  # f32 weights: the same in both packages
        cfg.retrieval.dense_dtype = dense_dtype
        cfg.retrieval.rerank = False
        cfg.pipeline.use_provenance = False
        cfg.pipeline.use_rewrite_loop = False
        cfg.generation.temperature = 0.0
        cfg.generation.max_new_tokens = 6
        cfg.server.batched_llm = False
        for field, value in parallel.items():
            setattr(cfg.parallel, field, value)
        if pkg == "jax":
            kw = dict(backend=JaxStatic(default=backend)) if backend else {}
            out.append(JaxRagSystem(cfg, encoder=_Enc(), **kw))
        else:
            n = parallel.get("corpus_axis", 1) * parallel.get("model_axis", 1)
            kw = dict(backend=StaticChatBackend(default=backend)) if backend else {}
            out.append(RagSystem(cfg, encoder=_Enc(), device="cpu",
                                 devices=["cpu"] * n if n > 1 else None, **kw))
    return out


def _checkpoint(tmp_path):
    """A tiny Llama checkpoint (HF layout, f32 safetensors) that both
    packages' load_local_llm read: weights N(0, 0.1) drawn with numpy,
    norms 1."""
    import torch
    import transformers
    path = tmp_path / "llama"
    if not path.exists():
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=1024,
            rope_theta=10000.0, tie_word_embeddings=False, torch_dtype="float32"))
        rng = np.random.default_rng(0)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.ones(p.shape) if "norm" in name else torch.from_numpy(
                    rng.normal(0.0, 0.1, tuple(p.shape)).astype(np.float32)))
        model.save_pretrained(str(path), safe_serialization=True)
    return str(path)


def _spy_generate(monkeypatch, llm, calls):
    """Record each generate call's (prompt ids, tokens)."""
    gen = llm.generate

    def spy(ids, *args, **kw):
        out = gen(ids, *args, **kw)
        calls.append(([int(t) for t in ids], [int(t) for t in out]))
        return out
    monkeypatch.setattr(llm, "generate", spy)


def test_ragsystem_model_axis_serves_chat(tmp_path, monkeypatch):
    """parallel.model_axis = 2 beside corpus_axis = 4 in both packages: each
    system loads the checkpoint's LLM over its mesh (q_proj's columns
    halved, the vocabulary sharded, the ring prefill over 'corpus'), the
    indexes shard over 'corpus', and /chat retrieves JAX's documents and
    asks its question. Loaded from a checkpoint both decoders compute in
    bf16, so the answers' greedy streams (same prompt ids) are equal, or
    equal up to a first difference within one bf16 ulp of the largest
    logit (tests/test_torch_hf_loader.py's rule); equal streams give
    equal replies. The data directory is the relative "docs" under
    tmp_path, so the documents' sources in the prompt, and the prompt, do
    not change with pytest's directory: over absolute tmp paths about one
    run in fifteen met a near-tie under the repetition penalty, where this
    rule on the raw logits reads the penalty's 10 %
    (test_mesh_first_step_matches_jax_at_fixed_prompts holds those)."""
    _data(tmp_path)
    monkeypatch.chdir(tmp_path)
    j, t = _systems(tmp_path, "mesh", data="docs", corpus_axis=4, model_axis=2)
    assert t.mesh.shape == dict(j.mesh.shape) == {"data": 1, "corpus": 4, "model": 2}
    assert t.llm.mesh is t.mesh and j.llm.mesh is j.mesh
    shard = t.llm.model.shards[0]
    assert shard.layers[0].attention.q_proj.kernel.shape == (64, 32)
    assert shard.token_embedding.shape == (64, 64)
    assert shard.layers[0].attention.ring_devices  # corpus 4: the ring prefill
    calls = {"jax": [], "torch": []}
    for name, system in (("jax", j), ("torch", t)):
        _spy_generate(monkeypatch, system.llm, calls[name])
    for q in ("alpha beta", "special3 topic"):
        out, want = t.chat(q), j.chat(q)
        assert [d["pk"] for d in out["documents"]] == [d["pk"] for d in want["documents"]]
        assert (out["question"], out["fetched_new_documents"]) == \
            (want["question"], want["fetched_new_documents"])
        (ids, got), (ids_j, want_ids) = calls["torch"][-1], calls["jax"][-1]
        assert ids == ids_j and len(got) == 6, q
        n = next((i for i, (a, b) in enumerate(zip(got, want_ids)) if a != b), None)
        if n is None:
            assert got == want_ids and out["reply"] == want["reply"], q
            continue
        logits = t.llm.forward_logits(ids + got[:n])
        ulp = 2.0 ** (np.floor(np.log2(np.abs(logits).max())) - 7)
        assert abs(float(logits[got[n]]) - float(logits[want_ids[n]])) <= ulp, (q, n)
    assert len(calls["torch"]) == len(calls["jax"]) == 2


@pytest.fixture(scope="module")
def mesh_llms(tmp_path_factory):
    """(JAX, port) LocalLLMs of the tiny Llama checkpoint over the mesh
    (1, 4, 2): TP over 'model', the ring prefill over 'corpus'; bf16."""
    from ragmeup_tpu.models import hf_loader as jhf
    from ragmeup_tpu_torch.models import hf_loader as thf
    ck = _checkpoint(tmp_path_factory.mktemp("mesh_llms"))
    return (jhf.load_local_llm(ck, mesh=jmake_mesh((1, 4, 2))),
            thf.load_local_llm(ck, device="cpu",
                               mesh=mesh.make_mesh((1, 4, 2), devices=["cpu"] * 8)))


def _penalized(logits: np.ndarray, seen, rp: float) -> np.ndarray:
    """The logits greedy decoding picks from: each seen token's divided by
    rp where positive, multiplied where not (both packages' rule)."""
    out = logits.astype(np.float64)
    idx = np.unique(np.asarray(list(seen)))
    out[idx] = np.where(out[idx] > 0, out[idx] / rp, out[idx] * rp)
    return out


# (numpy seed, prompt length): lengths that are multiples of the 4 corpus
# shards and lengths that are not; seeds 22 and 36 at 300 tokens are
# near-ties under the repetition penalty (the two packages pick apart, by
# 0.003 and 0.0006 of the penalized logits, while the raw logits of the two
# picks part by 0.16 and 0.19)
MESH_PROMPTS = [(0, 4), (1, 8), (2, 128), (3, 256), (4, 5), (5, 13), (6, 130), (7, 300),
                (22, 300), (36, 300)]


@pytest.mark.parametrize("seed,length", MESH_PROMPTS)
def test_mesh_first_step_matches_jax_at_fixed_prompts(mesh_llms, seed, length, monkeypatch):
    """Fixed numpy-seeded prompts through both packages' mesh decoders
    (model_axis 2, corpus_axis 4, the checkpoint in bf16). Each prompt pads
    to a prefill bucket (a multiple of 4), so both prefills ring at every
    length; the port's ring must run. The first step's logits agree
    within 4 bf16 ulps of the largest logit (bf16 rounds at other places in
    the two frameworks; 300 seeded prompts measured at most 2.8); at
    repetition penalties 1.0 and 1.1 the greedy picks are equal, or the
    port's pick leads JAX's by at most one bf16 ulp on the penalized
    logits (test_ragsystem_model_axis_serves_chat's rule, read on the
    logits the pick is made on)."""
    jllm, tllm = mesh_llms
    rings = []
    real = decoder.ring_attention
    monkeypatch.setattr(decoder, "ring_attention", lambda *a, **kw: rings.append(1) or
                        real(*a, **kw))
    ids = [int(v) for v in np.random.default_rng(seed).integers(1, 128, length)]
    got = np.asarray(tllm.forward_logits(ids), np.float32)
    want = np.asarray(jllm.forward_logits(ids), np.float32)
    assert len(rings) == tllm.cfg.num_layers * tllm.mesh.shape["model"]  # a ring a shard
    ulp = 2.0 ** (np.floor(np.log2(np.abs(got).max())) - 7)
    assert np.abs(got - want).max() <= 4 * ulp
    for rp in (1.0, 1.1):
        pg, pw = _penalized(got, ids, rp), _penalized(want, ids, rp)
        a, b = int(np.argmax(pg)), int(np.argmax(pw))
        assert a == b or pg[a] - pg[b] <= ulp, (rp, a, b, pg[a] - pg[b])


def test_tp_only_mesh_keeps_single_device_retrieval(tmp_path):
    """model_axis = 2 with corpus_axis = 1 in both packages: the mesh is
    JAX's, the indexes stay on the single-device program, and the rows
    equal JAX's TP-only system's and the port's plain system's."""
    j, t = _systems(tmp_path, "tp", backend="a.", dense_dtype="int8", model_axis=2,
                    corpus_axis=1)
    _, plain = _systems(tmp_path, "plain", backend="a.", dense_dtype="int8")
    assert t.mesh.shape == dict(j.mesh.shape) == {"data": 1, "corpus": 1, "model": 2}
    assert isinstance(t.dense, DenseIndex) and t.retriever.mesh is None
    assert j.retriever.mesh is None
    for q in ("special3 topic", "w5 theme2"):
        got = [r for r, _ in t.retriever.retrieve_rows(q, k=4)]
        assert got == [r for r, _ in j.retriever.retrieve_rows(q, k=4)], q
        assert got == [r for r, _ in plain.retriever.retrieve_rows(q, k=4)], q
