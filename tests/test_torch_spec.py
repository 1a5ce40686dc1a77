"""Speculative decoding, the fused generate loop and the attention captures
of the port against the JAX package's.

Both sides run the same f32 weights (the tiny decoder of
test_torch_serving.py, carried across by ``models/convert.py``; the JAX
paged kernel runs in interpret mode). Solo: ``generate_speculative`` equals
JAX's and the port's plain greedy, with the penalty, EOS, the forced
acceptance of a constant model and the context edge (where only the port's
plain greedy is the reference: JAX clamps its chunk writes there);
``generate`` routes as JAX's does, and its fused and host loops give the
same tokens for a seed. Engine: speculative waves and the adaptive gate
against the JAX engine at the same ``spec_accept_floor``, and the chat
backend serving concurrent greedy chats. Captures: ``attention_forward``,
``qk_forward``, ``span_attention_mass`` and attention provenance on both
of its branches, also through ``/chat``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ragmeup_tpu.data.documents import Chunk as JChunk
from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.ops.attention import span_attention_mass as jax_span_mass
from ragmeup_tpu.pipeline import llm_backends as jbackends
from ragmeup_tpu.pipeline import provenance as jprov
from ragmeup_tpu.pipeline import serving as jserve
from ragmeup_tpu_torch.data.documents import Chunk
from ragmeup_tpu_torch.models import convert, decoder, tokenizer
from ragmeup_tpu_torch.ops.attention import span_attention_mass
from ragmeup_tpu_torch.pipeline import llm_backends, provenance, serving
from test_torch_system import LLM_CFG, _build_systems
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=256,
            rope_theta=10000.0, dtype="float32")
PROMPTS = [[5, 17, 101, 42], [9, 8, 7, 6, 5, 4, 3, 2],
           [200, 300, 200, 300, 200, 300]]
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)


def _pair(cfg, seed, params=None):
    j = jdec.LocalLLM(jdec.LlamaConfig(**cfg), jtok.SimpleTokenizer(cfg["vocab_size"]),
                      seed=seed, params=params)
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(j.params))
    t = decoder.LocalLLM(decoder.LlamaConfig(**cfg),
                         tokenizer.SimpleTokenizer(cfg["vocab_size"]),
                         params=convert.flax_to_state_dict(tree), device="cpu")
    return j, t


@pytest.fixture(scope="module")
def llms():
    return _pair(TINY, 0)


class _eos:
    """Both decoders stop at ``ids`` inside the block."""

    def __init__(self, pair, ids):
        self.pair, self.ids = pair, set(ids)

    def __enter__(self):
        self.old = [m.eos_ids for m in self.pair]
        for m in self.pair:
            m.eos_ids = self.ids

    def __exit__(self, *exc):
        for m, old in zip(self.pair, self.old):
            m.eos_ids = old


# -- solo speculative decoding -------------------------------------------------

@pytest.mark.parametrize("draft", [4, 8])
@pytest.mark.parametrize("rp", [1.0, 1.1])
def test_speculative_matches_jax_and_plain_greedy(llms, rp, draft):
    j, t = llms
    for p in PROMPTS:
        want = j.generate_speculative(p, max_new_tokens=10, repetition_penalty=rp,
                                      draft_len=draft)
        got = t.generate_speculative(p, max_new_tokens=10, repetition_penalty=rp,
                                     draft_len=draft)
        plain = t.generate(p, max_new_tokens=10, temperature=0.0,
                           repetition_penalty=rp, speculative="off")
        assert got == want == plain and len(got) == 10, (rp, p)


def test_speculative_eos_matches_jax(llms):
    """EOS inside an accepted draft or a bonus token stops the stream where
    plain greedy stops; both generate loops mask the steps after it."""
    j, t = llms
    free = t.generate([5, 6], max_new_tokens=8, speculative="off", **GREEDY)
    with _eos(llms, [free[3]]):
        want = j.generate_speculative([5, 6], max_new_tokens=8,
                                      repetition_penalty=1.0, draft_len=4)
        got = t.generate_speculative([5, 6], max_new_tokens=8,
                                     repetition_penalty=1.0, draft_len=4)
        loops = [t.generate([5, 6], max_new_tokens=8, speculative="off",
                            fused=fused, **GREEDY) for fused in (True, False)]
    assert got == want == loops[0] == loops[1] == free[:3]


def test_speculative_accepts_on_repetition_as_jax():
    """A zero-weight model's argmax is always token 0, so every 2-gram
    draft of a run of zeros is right: 16 tokens in two verify forwards,
    with JAX's iters and accepted."""
    j0 = jdec.LocalLLM(jdec.LlamaConfig(**TINY), jtok.SimpleTokenizer(512), seed=0)
    zeros = jax.tree_util.tree_map(lambda a: a * 0, j0.params)
    j, t = _pair(TINY, 0, params=zeros)
    kw = dict(max_new_tokens=16, repetition_penalty=1.0, draft_len=8,
              return_stats=True)
    want = j.generate_speculative([0] * 8, **kw)
    got = t.generate_speculative([0] * 8, **kw)
    assert got == want
    assert got[0] == [0] * 16 and got[1]["iters"] <= 3


@pytest.mark.parametrize("max_new", [200, 129])
def test_speculative_context_edge_matches_plain(llms, max_new):
    """Where the window ends inside the generation the chunk narrows and
    the stream stops where plain greedy stops (the cache is 256 tokens, the
    prompt its last 128)."""
    _, t = llms
    prompt = [int(x) for x in np.random.default_rng(5).integers(1, 500, 200)]
    want = t.generate(prompt, max_new_tokens=max_new, speculative="off",
                      fused=False, **GREEDY)
    got, stats = t.generate_speculative(prompt, max_new_tokens=max_new,
                                        repetition_penalty=1.0, return_stats=True)
    assert got == want and len(got) == 128 and stats["iters"] < 128


def test_generate_routes_as_jax(llms, monkeypatch):
    """At T = 0, "auto" with fused takes generate_speculative and every
    route gives JAX's greedy stream; sampled streams are the same from the
    fused and the host loop for one seed."""
    j, t = llms
    p = PROMPTS[1]
    calls = []
    spec = t.generate_speculative
    monkeypatch.setattr(t, "generate_speculative",
                        lambda *a, **k: calls.append(1) or spec(*a, **k))
    want = j.generate(p, max_new_tokens=12, temperature=0.0)
    got = {(fused, mode): t.generate(p, max_new_tokens=12, temperature=0.0,
                                     fused=fused, speculative=mode)
           for fused in (True, False) for mode in ("auto", "off")}
    assert len(calls) == 1
    assert all(g == want for g in got.values())
    sampled = [t.generate(p, max_new_tokens=12, temperature=0.8, seed=7, fused=f)
               for f in (True, False)]
    assert sampled[0] == sampled[1] and len(sampled[0]) == 12
    assert len(calls) == 1


# -- speculative waves ----------------------------------------------------------

def _engines(pair, floor=0.0, **kw):
    kw = dict(dict(num_pages=64, page_size=16, max_pages_per_seq=8), **kw)
    return (jserve.ServingEngine(pair[0], spec_accept_floor=floor, **kw),
            serving.ServingEngine(pair[1], spec_accept_floor=floor, **kw))


def _both(pair, drive, floor=0.0, **kw):
    return tuple(drive(eng) for eng in _engines(pair, floor, **kw))


def test_spec_wave_matches_jax_and_greedy(llms):
    j, t = llms
    prompts = {"a": [5, 17, 101, 42, 5, 17], "b": [9, 8, 7, 6, 5],
               "c": [200, 300, 200, 300]}
    plain = {k: t.generate(v, max_new_tokens=12, temperature=0.0,
                           repetition_penalty=1.1, speculative="off")
             for k, v in prompts.items()}

    def drive(eng):
        assert eng.spec_supported
        for k, v in prompts.items():
            eng.add_request(k, v, max_new_tokens=12, temperature=0.0,
                            repetition_penalty=1.1)
        return eng.run_spec(iters=3, draft=4), eng._spec_accept
    want, got = _both(llms, drive)
    assert got == want and got[0] == plain


def test_spec_wave_mixed_temperature_batch(llms):
    """Greedy rows stay exact while a temperature row samples in the same
    spec waves (one token a forward)."""
    def drive(eng):
        eng.add_request("g", [5, 17, 101, 42], max_new_tokens=8, **GREEDY)
        eng.add_request("t", [9, 8, 7], max_new_tokens=8, temperature=0.8,
                        repetition_penalty=1.1)
        return eng.run_spec(iters=2, draft=4)
    want, got = _both(llms, drive)
    assert got["g"] == want["g"] == llms[1].generate(
        [5, 17, 101, 42], max_new_tokens=8, speculative="off", **GREEDY)
    assert 0 < len(got["t"]) <= 8
    assert drive(_engines(llms)[1]) == got  # the sampled row is reproducible


def test_spec_wave_continuous_join(llms):
    """A request joining between spec waves rebuilds the carry; earlier rows
    keep their streams."""
    def drive(eng):
        eng.add_request("a", [5, 17, 101], max_new_tokens=10, **GREEDY)
        eng.spec_wave_once(iters=1, draft=4)
        eng.add_request("b", [200, 300, 200], max_new_tokens=6, **GREEDY)
        while eng.spec_wave_once(iters=2, draft=4) > 0:
            pass
        return eng.results()
    want, got = _both(llms, drive)
    assert got == want
    assert got["b"] == llms[1].generate([200, 300, 200], max_new_tokens=6,
                                        speculative="off", **GREEDY)


def test_spec_wave_eos_and_page_limits(llms):
    """Spec rows respect the page limit (2 pages of 16) and EOS as the
    plain engine does."""
    prompt = [5, 17, 101, 42] * 5

    def drive(eng):
        eng.add_request("a", prompt, max_new_tokens=50, **GREEDY)
        return eng.run_spec(iters=3, draft=4)
    want, got = _both(llms, drive, max_pages_per_seq=2)
    steps = _engines(llms, max_pages_per_seq=2)[1]
    steps.add_request("a", prompt, max_new_tokens=50, **GREEDY)
    assert got == want == steps.run()
    eos = got["a"][4]
    with _eos(llms, [eos]):
        def drive2(eng):
            eng.add_request("a", prompt, max_new_tokens=50, **GREEDY)
            eng.add_request("b", [9, 8, 7], max_new_tokens=9, **GREEDY)
            return eng.run_spec(iters=2, draft=4)
        want2, got2 = _both(llms, drive2, max_pages_per_seq=2)
    assert got2 == want2 and got2["a"] == got["a"][:got["a"].index(eos)]


def _gate_script(eng, log):
    """The JAX package's gate state machine, its decisions logged."""
    log.append(eng._spec_gate())                 # fresh: optimistic spec
    eng._spec_accept, eng._spec_waves = 1.0, 2   # two waves below the floor
    log += [eng._spec_gate(), eng._spec_mode]
    log += [eng._spec_gate(), eng._spec_gate()]  # the countdown
    log += [eng._spec_gate(), eng._spec_accept, eng._spec_mode]  # re-probe
    eng._spec_accept, eng._spec_waves = 0.5, 1   # one wave is not enough
    log.append(eng._spec_gate())
    eng._spec_accept, eng._spec_waves = 3.0, 10
    log.append(eng._spec_gate())
    eng._spec_mode, eng._spec_accept, eng._spec_waves = "plain", 0.1, 9
    eng.add_request("r", [5, 17, 101], max_new_tokens=2, **GREEDY)
    log += [eng._spec_mode, eng._spec_accept]
    return log


def test_spec_gate_state_machine_as_jax(llms):
    want, got = _both(llms, lambda e: _gate_script(e, []), floor=1.35,
                      spec_reprobe_every=3)
    assert got == want
    assert got[:9] == [True, False, "plain", False, False, True, None, "spec", True]
    off = _engines(llms)[1]  # floor 0: always spec
    off._spec_accept, off._spec_waves = 0.0, 99
    assert off._spec_gate() is True


def test_spec_gate_tail_guard_counts_waves_in_flight(llms):
    """The re-probe tail guard subtracts the advance of the waves in flight
    from a row's budget: with 8 tokens left and 4 in flight the port keeps
    plain waves where JAX's guard (which reads the budget alone) re-probes;
    with nothing in flight both re-probe."""
    def drive(in_flight):
        def go(eng):
            eng.add_request("a", [5, 17, 101], max_new_tokens=8, **GREEDY)
            eng._spec_mode, eng._spec_probe_left = "plain", 1
            eng._spec_gate_iters = 2
            eng._infl_steps = {"a": in_flight}
            return eng._spec_gate(), eng._spec_mode, eng._spec_probe_left
        return go
    want, got = _both(llms, drive(4), floor=1.35, spec_reprobe_every=5)
    assert want == (True, "spec", 0)
    assert got == (False, "plain", 5)
    want, got = _both(llms, drive(0), floor=1.35, spec_reprobe_every=5)
    assert got == want == (True, "spec", 0)


def _counting(eng, name):
    calls = []
    orig = getattr(eng, name)
    setattr(eng, name, lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def test_adaptive_spec_falls_back_as_jax(llms):
    """With the gate armed, the random model's low acceptance sends the run
    to plain waves mid-way; streams and the number of plain dispatches equal
    the JAX engine's."""
    prompts = {"a": [5, 17, 101, 42, 5, 17], "b": [9, 8, 7, 6, 5]}

    def drive(eng):
        waves = _counting(eng, "_wave_dispatch")
        for k, v in prompts.items():
            eng.add_request(k, v, max_new_tokens=24, temperature=0.0,
                            repetition_penalty=1.1)
        return eng.run_spec(iters=2, draft=4), len(waves)
    want, got = _both(llms, drive, floor=1.35, spec_reprobe_every=64)
    assert got == want and got[1] > 0


def test_adaptive_spec_reprobes_as_jax(llms):
    """After the fallback the gate re-probes every spec_reprobe_every
    decisions: spec dispatches appear again, streams stay exact."""
    def drive(eng):
        specs = _counting(eng, "_spec_dispatch")
        eng.add_request("a", [5, 17, 101, 42], max_new_tokens=40, **GREEDY)
        return eng.run_spec(iters=1, draft=4), len(specs)
    want, got = _both(llms, drive, floor=10.0, spec_reprobe_every=2,
                      num_pages=128, max_pages_per_seq=16)
    assert got == want and got[1] >= 3
    assert got[0]["a"] == llms[1].generate([5, 17, 101, 42], max_new_tokens=40,
                                           speculative="off", **GREEDY)


def test_backend_spec_concurrent_greedy_equals_solo(llms):
    """Concurrent greedy chats through speculative waves equal the solo
    backend's replies and the JAX batched backend's."""
    j, t = llms
    messages = [[{"role": "user", "content": text}] for text in
                ("hello there", "tell me about foxes please", "what is a tpu")]
    kw = dict(max_new_tokens=6, **GREEDY)
    solo = [llm_backends.LocalChatBackend(t).chat(m, **kw) for m in messages]
    ekw = dict(num_pages=64, page_size=16, max_pages_per_seq=8, spec_draft=4,
               wave_steps=2)
    out = []
    for be in (jserve.BatchedChatBackend(j, **ekw), serving.BatchedChatBackend(t, **ekw)):
        got = [None] * len(messages)

        def run(i, be=be, got=got):
            got[i] = be.chat(messages[i], **kw)
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(messages))]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
        finally:
            be.stop()
        out.append(got)
    assert out[1] == out[0] == solo
    assert solo == [jbackends.LocalChatBackend(j).chat(m, **kw) for m in messages]


# -- attention captures -----------------------------------------------------------

def test_captures_match_jax(llms):
    j, t = llms
    ids = [int(x) for x in np.random.default_rng(2).integers(1, 500, 40)]
    want = j.attention_forward(ids)
    got = t.attention_forward(ids)
    assert len(got) == len(want) == TINY["num_layers"]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 4, 40, 40) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for g, w in zip(t.qk_forward(ids), j.qk_forward(ids)):
        assert g.shape == w.shape == (1, 40, 4, 16)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["uneven", "future"])
def test_span_attention_mass_matches_jax_and_full_matrix(case):
    rng = np.random.default_rng(4)
    if case == "uneven":  # 300 keys in blocks of 64: the last block is short
        L, d, a, q_off, spans, block = 300, 32, 20, 280, [(0, 100), (100, 200)], 64
    else:  # a span wholly after the queries gets no mass
        L, d, a, q_off, spans, block = 128, 16, 8, 32, [(0, 32), (64, 128)], 32
    k = rng.standard_normal((L, d)).astype(np.float32)
    q = rng.standard_normal((a, d)).astype(np.float32)
    got = span_attention_mass(torch.from_numpy(q), torch.from_numpy(k), spans,
                              q_offset=q_off, block_k=block)
    want = jax_span_mass(jnp.asarray(q), jnp.asarray(k), spans, q_offset=q_off,
                         block_k=block)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    s = q.astype(np.float64) @ k.astype(np.float64).T / np.sqrt(d)
    s = np.where(np.arange(L)[None, :] <= (q_off + np.arange(a))[:, None], s, -np.inf)
    w = np.exp(s - s.max(1, keepdims=True))
    w /= w.sum(1, keepdims=True)
    full = np.array([w[:, lo:hi].sum() / (a * (hi - lo)) for lo, hi in spans])
    np.testing.assert_allclose(got, full, rtol=1e-4, atol=1e-7)
    if case == "future":
        assert got[1] < 1e-9 < got[0]


@pytest.mark.parametrize("include_query", [False, True])
@pytest.mark.parametrize("blockwise", [False, True])
def test_attention_provenance_matches_jax(llms, blockwise, include_query):
    j, t = llms
    docs = ["the fox document text about rivers", "market earnings text",
            "trains leave at ten"]
    args = ("what about the fox", "the fox jumps over the river")
    want = jprov.compute_attention_provenance(
        j, *args, [JChunk(content=c) for c in docs],
        include_query=include_query, blockwise=blockwise)
    got = provenance.compute_attention_provenance(
        t, *args, [Chunk(content=c) for c in docs], include_query=include_query,
        blockwise=blockwise)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert sum(got) == pytest.approx(1.0, abs=1e-6)


def test_blockwise_provenance_equals_full_matrix(llms):
    """Blockwise over heads and the full last-layer matrix normalize to the
    same scores, the query span included."""
    _, t = llms
    chunks = [Chunk(content=c) for c in ("alpha beta gamma", "delta epsilon")]
    for inc in (False, True):
        full, block = (provenance.compute_attention_provenance(
            t, "which letter", "alpha delta", chunks, include_query=inc,
            blockwise=b) for b in (False, True))
        np.testing.assert_allclose(block, full, rtol=1e-4)


def test_chat_attaches_attention_provenance_as_jax(tmp_path):
    """/chat with provenance_method="attention": the port attaches JAX's
    scores (before this port its LocalLLM had no attention_forward and the
    pipeline dropped the scores)."""
    j_sys, t_sys = _build_systems(tmp_path, LLM_CFG, "float32")
    for sys_ in (j_sys, t_sys):
        sys_.cfg.pipeline.provenance_method = "attention"
    oj = j_sys.chat("Where does the fox jump?")
    ot = t_sys.chat("Where does the fox jump?")
    assert ot["reply"] == oj["reply"] and ot["documents"]
    got = [d["provenance"] for d in ot["documents"]]
    want = [d["provenance"] for d in oj["documents"]]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert sum(got) == pytest.approx(1.0, abs=1e-6)
