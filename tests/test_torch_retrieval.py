"""The port's retrieval engines against the JAX package's and the oracles.

Dense indexes are float32 or int8 in both packages here: the point is the
algorithm, and bf16 rounds at other places in the two frameworks. int8
codes and scores are exact in both, so int8 results must be equal. Vectors
come from seeded numpy tables, never from Python's per-process ``hash``.
"""

import numpy as np
import pytest

from ragmeup_tpu.retrieval import dense as jdense
from ragmeup_tpu.retrieval import hybrid as jhybrid
from ragmeup_tpu.retrieval import sparse as jsparse
from ragmeup_tpu_torch.data.documents import Chunk
from ragmeup_tpu_torch.data.store import ChunkStore
from ragmeup_tpu_torch.retrieval import dense, hybrid, sparse
from ragmeup_tpu_torch.retrieval.sparse import _tail_layers
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

WORDS = ("fox dog cat bird market stock earnings tech rally quantum bits "
         "qubits classical door sleepy canine auburn quick brown lazy river "
         "bank money loan rate city train ticket music song album").split()


def _corpus(seed, n=80):
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n):
        words = rng.choice(WORDS, int(rng.integers(4, 14)))
        texts.append(" ".join(["the"] * int(rng.integers(0, 3)) + list(words)))
    texts[10] = texts[3]  # identical term statistics: an exact score tie
    return texts


def _vectors(seed, n, d=32):
    rng = np.random.default_rng(seed + 100)
    v = rng.standard_normal((n, d)).astype(np.float32)
    if n > 20:
        v[20] = v[4]  # an exact score tie
    return v


QUERIES = ["the fox dog", "tech earnings rally", "quantum bits qubits",
           "sleepy canine by the door", "music album song train"]


@pytest.mark.parametrize("head", [False, True])
def test_bm25_matches_oracle(head):
    corpus = _corpus(0)
    kw = dict(dense_min_df=3, dense_df_ratio=0.0) if head else {}
    idx = sparse.BM25Index(**kw, device="cpu")
    idx.add(corpus)
    idx.delete_rows([7, 30])
    assert (len(idx._flush()["head_terms"]) > 0) == head
    for query in QUERIES:
        hits = idx.search([query], k=len(corpus))[0]
        oracle = sparse.bm25_oracle(corpus, query, dead_rows={7, 30})
        want = [int(i) for i in np.argsort(-oracle, kind="stable") if oracle[i] > 1e-9]
        assert [r for r, _ in hits] == want, query
        for r, s in hits:
            assert s == pytest.approx(oracle[r], rel=1e-5), (query, r)


@pytest.mark.parametrize("head", [False, True])
def test_bm25_matches_jax_bitwise(head):
    corpus = _corpus(1)
    kw = dict(dense_min_df=3, dense_df_ratio=0.0) if head else {}
    t, j = sparse.BM25Index(**kw, device="cpu"), jsparse.BM25Index(**kw)
    for ix in (t, j):
        ix.add(corpus[:50])
        ix.add(corpus[50:])
        ix.delete_rows([2])
    assert t.search(QUERIES, k=12) == j.search(QUERIES, k=12)


def test_bm25_ties_share_one_score():
    corpus = _corpus(2)
    idx = sparse.BM25Index(device="cpu")
    idx.add(corpus)
    scores = dict(idx.search([corpus[3]], k=len(corpus))[0])
    assert scores[3] == scores[10]


def test_tail_layers_never_repeat_a_slot():
    flat = np.array([5, 3, 5, 9, 3, 5, 1])
    layers = _tail_layers(flat)
    assert [list(x) for x in layers] == [[0, 1, 3, 6], [2, 4], [5]]
    for layer in layers:
        assert len(set(flat[layer])) == len(layer)


def test_bm25_save_load_across_packages(tmp_path):
    corpus = _corpus(3)
    j = jsparse.BM25Index()
    j.add(corpus)
    j.delete_rows([4])
    j.save(str(tmp_path))
    t = sparse.BM25Index.load(str(tmp_path), device="cpu")
    assert t.search(QUERIES, k=8) == j.search(QUERIES, k=8)


def _load_dense(writer, path):
    """The other package's DenseIndex loaded from ``writer``'s artifact."""
    if writer == "jax":
        return dense.DenseIndex.load(str(path), device="cpu")
    return jdense.DenseIndex.load(str(path))


def _dense_pair(seed, n=300, dtype="float32"):
    v = _vectors(seed, n)
    t = dense.DenseIndex(32, dtype=dtype, device="cpu")
    j = jdense.DenseIndex(32, dtype=dtype)
    for ix in (t, j):
        ix.add(v[:200])
        ix.add(v[200:])
        ix.delete_rows([1, 50, 299])
    return t, j, v


@pytest.mark.parametrize("search_type", ["similarity", "mmr"])
def test_dense_index_search_matches_jax(search_type):
    t, j, v = _dense_pair(0)
    q = _vectors(9, 4)
    q[0] = v[4]
    rt = t.search(q, 10, search_type=search_type, fetch_k=20)
    rj = j.search(q, 10, search_type=search_type, fetch_k=20)
    assert [[r for r, _ in hits] for hits in rt] == [[r for r, _ in hits] for hits in rj]
    for ht, hj in zip(rt, rj):
        np.testing.assert_allclose([s for _, s in ht], [s for _, s in hj], rtol=1e-6)
    assert rt[0][0][0] == 4  # exact tie with row 20 → the lower row first


def test_dense_index_compact_matches_jax():
    t, j, _ = _dense_pair(1)
    mapping = [-1 if i in (1, 50, 299) else i - sum(i > d for d in (1, 50)) for i in range(300)]
    t.compact(mapping)
    j.compact(mapping)
    assert t.n == j.n == 297
    q = _vectors(8, 3)
    for ht, hj in zip(t.search(q, 7), j.search(q, 7)):
        assert [r for r, _ in ht] == [r for r, _ in hj]
        np.testing.assert_allclose([s for _, s in ht], [s for _, s in hj], rtol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_dense_index_artifact_loads_in_the_other_package(tmp_path, writer):
    t, j, _ = _dense_pair(2)
    (j if writer == "jax" else t).save(str(tmp_path))
    other = _load_dense(writer, tmp_path)
    src = j if writer == "jax" else t
    assert other.n == src.n and other.dead == src.dead
    q = _vectors(7, 3)
    got = [[r for r, _ in h] for h in other.search(q, 10)]
    want = [[r for r, _ in h] for h in src.search(q, 10)]
    assert got == want


def _hybrid_pair(seed, dtype="float32"):
    corpus = _corpus(seed, n=120)
    vecs = _vectors(seed, len(corpus))
    t_d, j_d = dense.DenseIndex(32, dtype=dtype, device="cpu"), jdense.DenseIndex(32, dtype=dtype)
    t_s, j_s = sparse.BM25Index(device="cpu"), jsparse.BM25Index()
    for d_, s_ in ((t_d, t_s), (j_d, j_s)):
        d_.add(vecs)
        s_.add(corpus)
        d_.delete_rows([5, 6])
        s_.delete_rows([5, 6])
    return (t_d, t_s), (j_d, j_s), vecs


@pytest.mark.parametrize("search_type", ["similarity", "mmr"])
@pytest.mark.parametrize("seed", [0, 1])
def test_hybrid_fused_search_matches_jax(search_type, seed):
    (t_d, t_s), (j_d, j_s), vecs = _hybrid_pair(seed)
    qv = _vectors(seed + 50, len(QUERIES))
    if search_type == "similarity":
        # a stored vector with an exact duplicate: the tie goes to the lower
        # row. (Not under MMR: once the query itself is selected, every
        # candidate scores 0.5 * rel - 0.5 * rel, so the next pick is f32
        # rounding noise with no cross-package contract.)
        qv[1] = vecs[4]
    kw = dict(weights=(0.5, 0.5), rrf_c=60, re2_prompt="Read the question again: ",
              search_type=search_type, fetch_k=20, mmr_lambda=0.5)
    rt = hybrid.hybrid_fused_search(t_d, t_s, QUERIES, qv, 10, **kw)
    rj = jhybrid.hybrid_fused_search(j_d, j_s, QUERIES, qv, 10, **kw)
    assert [[r for r, _ in h] for h in rt] == [[r for r, _ in h] for h in rj]
    for ht, hj in zip(rt, rj):
        np.testing.assert_allclose([s for _, s in ht], [s for _, s in hj], rtol=1e-6)


def _int8_state(ix):
    """(codes, scales) of the live columns of a port or JAX int8 index."""
    return (np.asarray(ix._corpus_t)[:, :ix.n], np.asarray(ix._scales)[:, :ix.n])


@pytest.mark.parametrize("search_type", ["similarity", "mmr"])
def test_int8_dense_index_matches_jax(search_type):
    """Same codes and scales after add/delete, the same search (ids and
    scores equal), and after compact the same codes, rows and searches."""
    t, j, v = _dense_pair(3, dtype="int8")
    for a, b in zip(_int8_state(t), _int8_state(j)):
        np.testing.assert_array_equal(a, b)
    q = _vectors(9, 4)
    q[0] = v[4]
    kw = dict(search_type=search_type, fetch_k=20)
    assert t.search(q, 10, **kw) == j.search(q, 10, **kw)
    np.testing.assert_array_equal(t.gather_rows([0, 4, 123]), j.gather_rows([0, 4, 123]))
    mapping = [-1 if i in (1, 50, 299) else i - sum(i > d for d in (1, 50)) for i in range(300)]
    t.compact(mapping)
    j.compact(mapping)
    assert t.n == j.n == 297
    for a, b in zip(_int8_state(t), _int8_state(j)):
        np.testing.assert_array_equal(a, b)
    assert t.search(q, 7, **kw) == j.search(q, 7, **kw)
    np.testing.assert_array_equal(t.host_vectors(), j.host_vectors())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_int8_artifact_loads_in_the_other_package(tmp_path, writer):
    """The exact codes and scales travel (no re-quantization): the other
    package's index holds the same state and searches identically."""
    t, j, _ = _dense_pair(4, dtype="int8")
    src = j if writer == "jax" else t
    src.save(str(tmp_path))
    assert (tmp_path / "codes_int8.npy").exists() and (tmp_path / "scales.npy").exists()
    other = _load_dense(writer, tmp_path)
    assert other.dtype == "int8" and other.n == src.n and other.dead == src.dead
    for a, b in zip(_int8_state(other), _int8_state(src)):
        np.testing.assert_array_equal(a, b)
    q = _vectors(7, 3)
    for st in ("similarity", "mmr"):
        assert other.search(q, 10, search_type=st) == src.search(q, 10, search_type=st)


@pytest.mark.parametrize("search_type", ["similarity", "mmr"])
@pytest.mark.parametrize("seed", [0, 1])
def test_int8_hybrid_fused_search_matches_jax(search_type, seed):
    """The quantized branch of the fused hybrid search: query quantized on
    the device, int8 top-k, MMR over candidates dequantized with their
    stored scales. Ids and fused scores equal."""
    (t_d, t_s), (j_d, j_s), _ = _hybrid_pair(seed, dtype="int8")
    qv = _vectors(seed + 50, len(QUERIES))
    kw = dict(weights=(0.5, 0.5), rrf_c=60, re2_prompt="Read the question again: ",
              search_type=search_type, fetch_k=20, mmr_lambda=0.5)
    rt = hybrid.hybrid_fused_search(t_d, t_s, QUERIES, qv, 10, **kw)
    rj = jhybrid.hybrid_fused_search(j_d, j_s, QUERIES, qv, 10, **kw)
    assert rt == rj and all(rt)


def test_hybrid_fused_search_unknown_terms_falls_back_to_dense():
    (t_d, t_s), (j_d, j_s), _ = _hybrid_pair(0)
    qv = _vectors(3, 1)
    q = ["zzzgibberish"]
    rt = hybrid.hybrid_fused_search(t_d, t_s, q, qv, 5, search_type="mmr")[0]
    rj = jhybrid.hybrid_fused_search(j_d, j_s, q, qv, 5, search_type="mmr")[0]
    assert [r for r, _ in rt] == [r for r, _ in rj] and len(rt) == 5
    np.testing.assert_allclose([s for _, s in rt], [s for _, s in rj], rtol=1e-6)


def test_hybrid_retriever_refuses_unported_engines():
    """An engine neither package has raises JAX's ValueError (IVF is
    ported: test_torch_ivf.py)."""
    store = ChunkStore()
    with pytest.raises(ValueError, match="exact|ivf"):
        hybrid.HybridRetriever(store, dense.DenseIndex(8, device="cpu"), sparse.BM25Index(device="cpu"),
                               lambda t: np.zeros((len(t), 8)), ann="hnsw")
    with pytest.raises(ValueError):
        dense.DenseIndex(8, dtype="float16", device="cpu")


def test_hybrid_retriever_reranks(tmp_path):
    corpus = _corpus(4, n=40)
    store = ChunkStore(str(tmp_path))
    store.add([Chunk(content=t, metadata={"source": f"d{i}.txt"})
               for i, t in enumerate(corpus)])
    vecs = _vectors(4, len(corpus))
    d_ = dense.DenseIndex(32, dtype="float32", device="cpu")
    d_.add(vecs)
    s_ = sparse.BM25Index(device="cpu")
    s_.add(corpus)

    class LengthReranker:
        def rerank(self, query, chunks, top_n):
            order = sorted(chunks, key=lambda c: -len(c.content))
            return order[:top_n]

    r = hybrid.HybridRetriever(store, d_, s_, lambda t: vecs[:len(t)], k=6,
                               reranker=LengthReranker(), rerank_k=2)
    out = r.retrieve("fox dog")
    assert len(out) == 2 and all("pk" in c.metadata for c in out)
    assert len(out[0].content) >= len(out[1].content)
