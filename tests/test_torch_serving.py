"""The port's paged serving engine against the JAX package's.

Both engines run the same f32 weights (the JAX decoder's params carried
across by ``models/convert.py``): the tiny config (head_dim 16, the JAX
side's Pallas paged kernel in interpret mode) and a head_dim 128 config
(the shape class of the 8B decoder). Greedy token streams must be
identical for a single request, concurrent requests, a mid-flight join,
page recycling, ``step`` against waves, pipelined against unpipelined
waves, batched against sequential prefill and prefix reuse; the chat
backends must agree under page pressure. The port's sampled streams only
have to be reproducible (they are its own). Speculative waves are held to
the JAX engine in test_torch_spec.py.
"""

import threading

import jax
import numpy as np
import pytest
from flax import linen as nn

from ragmeup_tpu.models import decoder as jdec
from ragmeup_tpu.models import tokenizer as jtok
from ragmeup_tpu.pipeline import serving as jserve
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.models import convert, decoder, tokenizer
from ragmeup_tpu_torch.pipeline import serving
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=256,
            rope_theta=10000.0, dtype="float32")
HD128 = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
             num_kv_heads=1, intermediate_size=256, max_seq_len=512,
             rope_theta=10000.0, dtype="float32")
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)


def _pair(cfg, seed):
    j = jdec.LocalLLM(jdec.LlamaConfig(**cfg), jtok.SimpleTokenizer(cfg["vocab_size"]),
                      seed=seed)
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(j.params))
    t = decoder.LocalLLM(decoder.LlamaConfig(**cfg),
                         tokenizer.SimpleTokenizer(cfg["vocab_size"]),
                         params=convert.flax_to_state_dict(params), device="cpu")
    return j, t


@pytest.fixture(scope="module")
def llms():
    return _pair(TINY, 0)


@pytest.fixture(scope="module")
def llms128():
    return _pair(HD128, 1)


def _engines(pair, **kw):
    kw = dict(dict(num_pages=64, page_size=16, max_pages_per_seq=8), **kw)
    return (jserve.ServingEngine(pair[0], spec_accept_floor=0.0, **kw),
            serving.ServingEngine(pair[1], **kw))


def _both(pair, drive, **kw):
    """drive(engine) on the JAX engine and on the port's; returns both."""
    return tuple(drive(eng) for eng in _engines(pair, **kw))


def _rand_prompt(rng, n):
    return [int(x) for x in rng.integers(1, 400, n)]


@pytest.mark.parametrize("which", ["tiny", "hd128"])
def test_single_request_matches_jax(llms, llms128, which):
    pair = llms if which == "tiny" else llms128

    def drive(eng):
        eng.add_request("a", [5, 17, 101, 42], max_new_tokens=6, **GREEDY)
        return eng.run()["a"]
    want, got = _both(pair, drive)
    assert got == want and len(got) == 6


def test_concurrent_requests_match_jax(llms):
    prompts = {"a": [5, 17, 101], "b": [9, 8, 7, 6, 5], "c": [200, 300]}

    def drive(eng):
        for k, v in prompts.items():
            eng.add_request(k, v, max_new_tokens=5, **GREEDY)
        return eng.run()
    want, got = _both(llms, drive)
    assert got == want


def test_mid_flight_join_and_penalty_match_jax(llms):
    def drive(eng):
        eng.add_request("a", [5, 17, 101], max_new_tokens=6, temperature=0.0,
                        repetition_penalty=5.0)
        eng.step()
        eng.step()
        eng.add_request("b", [9, 8, 7], max_new_tokens=4, **GREEDY)
        return eng.run()
    want, got = _both(llms, drive)
    assert got == want


def test_page_recycling_matches_jax(llms):
    """A retired sequence's pages return to the pool in the JAX package's
    order and are reused by the next request."""
    def drive(eng):
        eng.add_request("a", list(range(3, 40)), max_new_tokens=3, **GREEDY)
        eng.run()
        used = eng.cache.pages_in_use
        out = [eng.retire("a")]
        freed = used - eng.cache.pages_in_use
        eng.add_request("b", [1, 2, 3], max_new_tokens=2, **GREEDY)
        out.append(eng.run()["b"])
        return out, freed, list(eng.cache._free), eng.cache.seq_pages["b"]
    want, got = _both(llms, drive)
    assert got == want and got[1] > 0


@pytest.mark.parametrize("which", ["tiny", "hd128"])
def test_waves_match_steps_and_jax(llms, llms128, which):
    """Waves of 3 steps (pipelined) equal single steps, and both equal the
    JAX package's waves; rows rotate through max_batch 2."""
    pair = llms if which == "tiny" else llms128
    prompts = {"a": [5, 17, 101], "b": [9, 8, 7, 6], "c": [200, 300, 40]}

    def drive(runner):
        def go(eng):
            for k, v in prompts.items():
                eng.add_request(k, v, max_new_tokens=7, temperature=0.0,
                                repetition_penalty=1.1)
            return runner(eng)
        return go
    want, got = _both(pair, drive(lambda e: e.run_wave(steps_per_dispatch=3)),
                      max_batch=2)
    steps = _engines(pair, max_batch=2)[1]
    assert got == want == drive(lambda e: e.run())(steps)


def test_waves_pipelined_match_unpipelined(llms):
    """Pipelined waves give the unpipelined streams: greedy equal to the
    JAX package's, sampled (the port's own stream) reproducible, with
    staggered lengths and one synchronous wave before the pipelined run."""
    def build(eng, temperature):
        eng.add_request("a", [5, 17, 101], max_new_tokens=7,
                        temperature=temperature, repetition_penalty=1.1, seed=3)
        eng.add_request("b", [9, 8, 7, 6], max_new_tokens=3,
                        temperature=temperature, repetition_penalty=1.1, seed=3)
        return eng

    def greedy(pipeline):
        def go(eng):
            build(eng, 0.0).wave_once(steps=2)
            first = dict(eng.results())
            return first, eng.run_wave(steps_per_dispatch=2, pipeline=pipeline)
        return go
    want, got = _both(llms, greedy(True))
    assert got == want
    assert greedy(False)(_engines(llms)[1]) == got
    sampled = [build(_engines(llms)[1], 0.7).run_wave(steps_per_dispatch=2,
                                                      pipeline=p)
               for p in (False, True)]
    assert sampled[0] == sampled[1]
    assert len(sampled[0]["a"]) == 7 and len(sampled[0]["b"]) == 3


def test_eos_ends_a_wave_row_as_in_jax(llms):
    """A row that samples EOS stops inside a wave (its later writes go to
    the trash page) while the other row decodes on."""
    j, t = llms
    probe = _engines(llms)[1]
    probe.add_request("a", [5, 17, 101], max_new_tokens=8, **GREEDY)
    eos = probe.run()["a"][3]
    old = j.eos_ids, t.eos_ids
    j.eos_ids = t.eos_ids = {eos}
    try:
        def drive(eng):
            eng.add_request("a", [5, 17, 101], max_new_tokens=8, **GREEDY)
            eng.add_request("b", [9, 8, 7, 6], max_new_tokens=8, **GREEDY)
            return eng.run_wave(steps_per_dispatch=4)
        want, got = _both(llms, drive)
    finally:
        j.eos_ids, t.eos_ids = old
    assert got == want and len(got["a"]) < 8


@pytest.mark.parametrize("which", ["tiny", "hd128"])
def test_batched_prefill_matches_sequential_and_jax(llms, llms128, which):
    """add_requests prefills the group together, chunk by chunk (16-token
    chunks: the 38-token prompt spans three); streams equal sequential
    admission's and the JAX package's."""
    pair = llms if which == "tiny" else llms128
    prompts = {"a": [5, 17, 101, 42, 5], "b": [9, 8, 7], "c": list(range(2, 40))}

    def batched(eng):
        eng.add_requests([{"id": k, "prompt_ids": v, "max_new": 8,
                           "temperature": 0.0, "rp": 1.1} for k, v in prompts.items()])
        return eng.run_wave(steps_per_dispatch=4)
    want, got = _both(pair, batched, prefill_chunk=16)
    seq = _engines(pair, prefill_chunk=16)[1]
    for k, v in prompts.items():
        seq.add_request(k, v, max_new_tokens=8, temperature=0.0,
                        repetition_penalty=1.1)
    assert got == want == seq.run_wave(steps_per_dispatch=4)


def test_batched_prefill_failure_releases_pages(llms):
    eng = _engines(llms, num_pages=6, max_pages_per_seq=4)[1]
    free_before = list(eng.cache._free)
    with pytest.raises(MemoryError):
        eng.add_requests([{"id": f"s{i}", "prompt_ids": list(range(2, 34)),
                           "max_new": 30, "temperature": 0.0, "rp": 1.0}
                          for i in range(6)])
    assert sorted(eng.cache._free) == sorted(free_before)
    assert not eng.seqs


def test_prefix_reuse_matches_jax(llms):
    """A repeat prompt reuses the retired request's full pages, a later
    turn reuses pages of the generated span too, a live sequence's pages
    are reused at prefill time; hits and streams equal the JAX package's."""
    rng = np.random.default_rng(11)
    prompt = _rand_prompt(rng, 40)
    extra = _rand_prompt(rng, 10)

    def drive(eng):
        out = []
        for sid in ("a", "b"):
            eng.add_request(sid, prompt, max_new_tokens=6, **GREEDY)
            eng.run()
            out.append((eng.retire(sid), eng.cache.prefix_hits))
        eng.add_request("c", prompt + out[0][0] + extra, max_new_tokens=6, **GREEDY)
        eng.add_request("d", prompt, max_new_tokens=6, **GREEDY)
        res = eng.run_wave(steps_per_dispatch=4)
        out.append((res["c"], res["d"], eng.cache.prefix_hits,
                    list(eng.cache.registry.values())))
        return out
    want, got = _both(llms, drive, prefill_chunk=32)
    assert got == want
    assert got[0][1] == 0 and got[1][1] == 2 and got[2][2] > 4


def _chat_all(backend, messages, **kw):
    got = [None] * len(messages)

    def run(i):
        got[i] = backend.chat(messages[i], **kw)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(messages))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    return got


def test_backends_match_jax_under_page_pressure(llms):
    """Four concurrent greedy chats into a pool that holds about two at a
    time: the worker queues the excess (FIFO under the lifetime-page
    invariant) and every reply equals the JAX backend's."""
    messages = [[{"role": "user", "content": text}] for text in
                ("hello there", "tell me about foxes please", "what is a tpu",
                 "list three animals")]
    kw = dict(num_pages=9, page_size=16, max_pages_per_seq=8, wave_steps=3,
              spec_draft=0)
    j_be = jserve.BatchedChatBackend(llms[0], **kw)
    t_be = serving.BatchedChatBackend(llms[1], **kw)
    try:
        want = _chat_all(j_be, messages, max_new_tokens=12, **GREEDY)
        got = _chat_all(t_be, messages, max_new_tokens=12, **GREEDY)
        assert t_be._worker.is_alive()
        assert t_be.latency_stats()["completed"] == 4
    finally:
        j_be.stop()
        t_be.stop()
    assert got == want and all(isinstance(r, str) for r in got)


def test_backend_oversized_request_and_spec_refusal(llms):
    """A request that can never fit the pool fails in chat() and the worker
    serves on; a greedy chat on the default spec_draft=8 takes speculative
    waves and equals the JAX backend's reply; a sampled one is served."""
    be = serving.BatchedChatBackend(llms[1], num_pages=8, page_size=16,
                                    max_pages_per_seq=64, wave_steps=2)
    j_be = jserve.BatchedChatBackend(llms[0], num_pages=8, page_size=16,
                                     max_pages_per_seq=64, wave_steps=2)
    msgs = [{"role": "user", "content": "hi"}]
    try:
        with pytest.raises(RuntimeError) as err:
            be.chat(msgs, max_new_tokens=1000, temperature=0.5)
        assert isinstance(err.value.__cause__, MemoryError)
        assert be.spec_draft == 8
        spec_waves = []
        dispatch = be.engine._spec_dispatch
        be.engine._spec_dispatch = lambda *a, **k: spec_waves.append(1) or dispatch(*a, **k)
        greedy = be.chat(msgs, max_new_tokens=4, temperature=0.0)
        assert greedy == j_be.chat(msgs, max_new_tokens=4, temperature=0.0)
        assert spec_waves
        assert be._worker.is_alive()
        assert isinstance(be.chat(msgs, max_new_tokens=4, temperature=0.3), str)
        be.stop()
        pages = be.engine.cache
        held = {p for plist in pages.seq_pages.values() for p in plist}
        assert held == {be.engine._trash}
        assert len(pages._free) + len(pages.page_digest) == pages.num_pages - 1
    finally:
        be.stop()
        j_be.stop()


def test_engine_counts_no_kernel_launch_on_cpu(llms):
    kernels.reset_counts()
    eng = _engines(llms)[1]
    eng.add_request("a", [1, 2, 3], max_new_tokens=2, **GREEDY)
    eng.run_wave(steps_per_dispatch=2)
    assert not any(kernels.launch_counts().values())


def test_backend_rates_decode_as_jax(llms):
    """latency_stats' tok/s is the JAX backend's: tokens over the span from
    the first token fetch to retirement, clamped to 1e-9 s. A request whose
    tokens all arrive in one wave fetch records the same rate in both."""
    kw = dict(num_pages=16, page_size=16, max_pages_per_seq=8, wave_steps=4,
              spec_draft=0)
    msgs = [{"role": "user", "content": "hi"}]
    stats, replies = [], []
    for be in (jserve.BatchedChatBackend(llms[0], **kw),
               serving.BatchedChatBackend(llms[1], **kw)):
        try:
            replies.append(be.chat(msgs, max_new_tokens=4, **GREEDY))
            s = be.latency_stats()
            stats.append({k: v for k, v in s.items() if not k.startswith("ttft")})
        finally:
            be.stop()
    assert replies[0] == replies[1] and stats[0] == stats[1]
    assert stats[1]["completed"] == 1 and stats[1]["tok_s_p50"] > 0
