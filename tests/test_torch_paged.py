"""The port's paged KV pool and paged attention against the JAX package's.

The same numpy-seeded inputs go through the JAX functions (the Pallas
kernel in interpret mode, as tests/test_paged.py runs it, and the XLA
``_ref`` oracles) and through the port's plain versions, which CPU tensors
take. f32 throughout; tolerance 1e-5 absolute (both sides sum in f32, only
the order differs). The pool bookkeeping (free list, page lists, prefix
registry, refcounts, LRU eviction, hits) is driven by one operation
sequence in both packages and must agree exactly; pool writes must equal
the JAX package's through its ``_unpack_pages`` view.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.ops import paged_attention as jpa
from ragmeup_tpu_torch import kernels
from ragmeup_tpu_torch.ops import paged_attention as tpa
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

ATOL = 1e-5


def _pool(rng, b, nh, nkv, hd, ps, P, lengths):
    """Random pool and disjoint page tables covering each length."""
    mp = -(-max(lengths) // ps) + 1  # one spare column: padded page tables
    k_pages = rng.standard_normal((nkv, P, ps, hd)).astype(np.float32)
    v_pages = rng.standard_normal((nkv, P, ps, hd)).astype(np.float32)
    page_idx = np.zeros((b, mp), np.int32)
    perm = rng.permutation(P)
    at = 0
    for i, n in enumerate(lengths):
        need = -(-n // ps)
        page_idx[i, :need] = perm[at:at + need]
        at += need
    return k_pages, v_pages, page_idx, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (20, 0.0), (0, 2.5), (9, 1.5)])
def test_decode_plain_matches_jax(window, softcap):
    """Decode (q_len 1), g = 2, page tables wider than the lengths and not a
    multiple of the kernel's 4-page block (the JAX side pads them)."""
    rng = np.random.default_rng(0)
    lengths = (37, 1, 64, 50)
    k, v, idx, lens = _pool(rng, 4, 4, 2, 32, 16, 24, lengths)
    q = rng.standard_normal((4, 4, 32)).astype(np.float32)
    got = tpa.paged_attention(*_t(q, k, v, idx, lens), window=window,
                              softcap=softcap).numpy()
    kern = np.asarray(jpa.paged_attention(*_j(q, k, v, idx, lens), window=window,
                                          softcap=softcap, interpret=True))
    ref = np.asarray(jpa.paged_attention_ref(*_j(q, k, v, idx, lens),
                                             window=window, softcap=softcap))
    np.testing.assert_allclose(got, kern, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("b,window,softcap", [(1, 0, 0.0), (3, 0, 0.0), (3, 12, 0.0),
                                              (2, 0, 3.0)])
def test_chunk_plain_matches_jax(b, window, softcap):
    """Chunk-append (q_len 8, g = 2) over prefixes of 0 to 40 tokens: batch
    1 (the single-sequence writer's path) and batched."""
    rng = np.random.default_rng(1)
    s = 8
    lengths = tuple(s + p for p in (40, 0, 17)[:b])
    k, v, idx, lens = _pool(rng, b, 4, 2, 32, 16, 24, lengths)
    q = rng.standard_normal((b, s, 4, 32)).astype(np.float32)
    got = tpa.paged_attention_chunk(*_t(q, k, v, idx, lens), window=window,
                                    softcap=softcap).numpy()
    kern = np.asarray(jpa.paged_attention_chunk(
        *_j(q, k, v, idx, lens), window=window, softcap=softcap, interpret=True))
    ref = np.asarray(jpa.paged_attention_chunk_ref(
        *_j(q, k, v, idx, lens), window=window, softcap=softcap))
    np.testing.assert_allclose(got, kern, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


# the checkpoint families' (hd, nh, nkv): hd 64 at g 7 (Qwen2.5-0.5B), hd 96
# (Phi-3-mini), hd 256 at g 2 (Gemma-2-9B), hd 128 at g 7 (Qwen2.5-7B)
FAMILY_SHAPES = [(64, 7, 1), (96, 2, 2), (256, 2, 1), (128, 7, 1)]


@pytest.mark.parametrize("mode", ["decode", "chunk"])
@pytest.mark.parametrize("hd,nh,nkv", FAMILY_SHAPES)
def test_family_head_dims_match_jax(hd, nh, nkv, mode):
    """The plain versions at the head dims and groups the kernel is built
    for beyond hd 128 and power-of-two groups, with Gemma-2's window,
    softcap and 1/16 scale, against the JAX kernel (interpret mode) and its
    _ref oracle."""
    rng = np.random.default_rng(hd + nh)
    s = 1 if mode == "decode" else 8
    lengths = tuple(s + p for p in (40, 3, 17))
    k, v, idx, lens = _pool(rng, 3, nh, nkv, hd, 16, 12, lengths)
    q = rng.standard_normal((3, s, nh, hd)).astype(np.float32)
    kw = dict(window=9, softcap=2.5, sm_scale=1 / 16)
    if mode == "decode":
        got = tpa.paged_attention(*_t(q[:, 0], k, v, idx, lens), **kw).numpy()
        args = _j(q[:, 0], k, v, idx, lens)
        kern = jpa.paged_attention(*args, interpret=True, **kw)
        ref = jpa.paged_attention_ref(*args, **kw)
    else:
        got = tpa.paged_attention_chunk(*_t(q, k, v, idx, lens), **kw).numpy()
        args = _j(q, k, v, idx, lens)
        kern = jpa.paged_attention_chunk(*args, interpret=True, **kw)
        ref = jpa.paged_attention_chunk_ref(*args, **kw)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


def test_chunk_of_one_equals_decode():
    rng = np.random.default_rng(2)
    k, v, idx, lens = _pool(rng, 2, 8, 2, 16, 8, 16, (21, 9))
    q = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    one = tpa.paged_attention_chunk(q[:, None], *_t(k, v, idx, lens))[:, 0]
    torch.testing.assert_close(one, tpa.paged_attention(q, *_t(k, v, idx, lens)),
                               atol=0, rtol=0)


def test_row_without_keys_is_zero_as_in_the_kernel():
    """A sequence of length 0 sees no key: the TPU kernel emits 0 (l == 0),
    and so do the plain versions."""
    rng = np.random.default_rng(3)
    k, v, idx, lens = _pool(rng, 2, 4, 2, 32, 16, 8, (20, 16))
    lens[1] = 0
    q = rng.standard_normal((2, 4, 32)).astype(np.float32)
    got = tpa.paged_attention(*_t(q, k, v, idx, lens)).numpy()
    kern = np.asarray(jpa.paged_attention(*_j(q, k, v, idx, lens), interpret=True))
    assert not got[1].any()
    np.testing.assert_allclose(got, kern, atol=ATOL)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    rng = np.random.default_rng(4)
    k, v, idx, lens = _pool(rng, 1, 2, 1, 16, 8, 4, (5,))
    calls = []
    plain = tpa.paged_attention_chunk_plain
    monkeypatch.setattr(tpa, "paged_attention_chunk_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    kernels.reset_counts()
    tpa.paged_attention(torch.zeros(1, 2, 16), *_t(k, v, idx, lens))
    tpa.paged_attention_chunk(torch.zeros(1, 3, 2, 16), *_t(k, v, idx, lens + 2))
    assert len(calls) == 2
    counts = kernels.launch_counts()
    assert counts["paged_attention"] == counts["paged_attention_chunk"] == 0


@pytest.mark.parametrize("hd,ps", [(16, 64), (32, 16)])
def test_token_writes_match_jax(hd, ps):
    """One token per sequence; hd 16 with 64-token pages is a PACKED pool in
    the JAX package (8 tokens per row), compared through _unpack_pages."""
    rng = np.random.default_rng(5)
    nkv, P, b = 2, 6, 5
    assert jpa.pages_tok_per_row(hd, ps) == (8 if hd == 16 else 1)
    c = jpa.pages_tok_per_row(hd, ps)
    base = rng.standard_normal((nkv, P, ps, hd)).astype(np.float32)
    vals = rng.standard_normal((nkv, b, hd)).astype(np.float32)
    page_ids = rng.choice(P, b).astype(np.int32)
    slots = rng.permutation(ps)[:b].astype(np.int32)
    want = jpa.paged_update_token(jnp.asarray(base.reshape(nkv, P, ps // c, hd * c)),
                                  *_j(vals, page_ids, slots), hd)
    got = tpa.paged_update_token(*_t(base.copy(), vals, page_ids, slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpa._unpack_pages(want, hd)))


def test_chunk_writes_match_jax():
    rng = np.random.default_rng(6)
    nkv, P, ps, hd, b, s = 2, 8, 16, 32, 3, 5
    base = rng.standard_normal((nkv, P, ps, hd)).astype(np.float32)
    vals = rng.standard_normal((nkv, b, s, hd)).astype(np.float32)
    flat = rng.permutation(P * ps)[:b * s]
    page_ids = (flat // ps).reshape(b, s).astype(np.int32)
    slots = (flat % ps).reshape(b, s).astype(np.int32)
    want = jpa.paged_update_chunk(*_j(base, vals, page_ids, slots), hd)
    got = tpa.paged_update_chunk(*_t(base.copy(), vals, page_ids, slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpa._unpack_pages(want, hd)))


def _state(cache):
    return {"free": list(cache._free), "pages": dict(cache.seq_pages),
            "len": dict(cache.seq_len), "registry": list(cache.registry.items()),
            "meta": dict(cache.reg_meta), "refs": list(map(int, cache.refs)),
            "hits": cache.prefix_hits, "lookups": cache.prefix_lookups,
            "available": cache.available_pages, "in_use": cache.pages_in_use}


def test_cache_bookkeeping_matches_jax():
    """One operation sequence on both pools: allocation, prefixed
    allocation with hits, prefill-time and retire-time registration, page
    growth, LRU eviction under pressure, the pin-before-take order, pool
    exhaustion and the content check against a forged digest."""
    ps = 4
    caches = (jpa.PagedKVCache(12, ps, 1, 8, 1, dtype=jnp.float32),
              tpa.PagedKVCache(12, ps, 1, 8, 1, dtype=torch.float32, device="cpu"))
    rng = np.random.default_rng(7)
    a = [int(x) for x in rng.integers(1, 50, 13)]
    b = [int(x) for x in rng.integers(1, 50, 9)]
    c = [int(x) for x in rng.integers(1, 50, 17)]
    forged = hashlib.sha1(np.asarray(c[:ps], np.int64).tobytes()).hexdigest()

    def run(cache):
        log = []
        cache.allocate("__pad__", 1)
        log.append(cache.allocate_prefixed("a", a))
        cache.register_prefix("a", a)
        log.append(cache.allocate_prefixed("a2", a))     # hits a's live pages
        cache.extend("a2", 6)
        cache.free("a2", register_tokens=a + [7] * 6)
        cache.free("a", register_tokens=a)
        log.append(cache.allocate_prefixed("b", b))
        cache.free("b", register_tokens=b)
        log.append(cache.available_pages)
        # forge c's first digest onto a's first page with a's meta: the
        # lookup must reject it by content
        first = next(iter(cache.registry))
        cache.registry[forged] = cache.registry[first]
        cache.reg_meta[forged] = cache.reg_meta[first]
        log.append(len(cache.match_prefix(c)))
        cache.registry.pop(forged)
        cache.reg_meta.pop(forged)
        log.append(cache.allocate_prefixed("a3", a + [9, 9]))  # evicts LRU pages
        log.append(cache.allocate_prefixed("c", c))
        with pytest.raises(MemoryError):
            cache.allocate("big", 40)
        with pytest.raises(MemoryError):
            cache.allocate_prefixed("a4", a + [1] * 30)   # pinned hits released
        log.append(_state(cache))
        return log

    jax_log, port_log = (run(cache) for cache in caches)
    assert port_log == jax_log
    assert port_log[1] == 12 and port_log[-1]["hits"] > 3
