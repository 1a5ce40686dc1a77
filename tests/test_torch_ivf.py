"""The port's IVF engine and streamed hybrid search against the JAX package.

IVF (retrieval/ivf.py): k-means from JAX's own init draw gives JAX's
assignments and centroids; the search over one cluster layout gives JAX's
ids; a full probe is exact against the oracle; recall on clustered data;
the empty index and ``memory_bytes``; ``retrieval.ann="ivf"`` through
RagSystem after add and delete, with MMR, against the JAX system; a bad
engine name raises. The streamed hybrid search equals the per-batch search
and JAX's stream over float32, bf16 and int8 indexes. Layouts that both
packages search are float32 (bf16 rounds at other places in the two
frameworks); the IVF system test runs the JAX default, bf16 buckets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.ops.topk import topk_oracle
from ragmeup_tpu.retrieval import dense as jdense
from ragmeup_tpu.retrieval import hybrid as jhybrid
from ragmeup_tpu.retrieval import ivf as jivf
from ragmeup_tpu.retrieval import sparse as jsparse
from ragmeup_tpu_torch.retrieval import dense, hybrid, ivf, sparse
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

WORDS = ("fox dog cat bird market stock earnings tech rally quantum bits "
         "qubits classical door sleepy canine auburn quick brown lazy river "
         "bank money loan rate city train ticket music song album").split()


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _blobs(seed, n_blobs=16, per=64, d=32, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = _unit(rng.standard_normal((n_blobs, d)))
    pts = np.concatenate([c + spread * rng.standard_normal((per, d)) for c in centers])
    return _unit(pts)


def _jax_init(n, k, seed=0):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False))


def test_kmeans_from_jax_init_matches_jax():
    """Well-separated blobs, JAX's init rows: the same assignments, and
    centroids within 1e-5 (segment sums in another order)."""
    v = _blobs(0, spread=0.05)
    init = _jax_init(len(v), 16)
    jc, ja = jivf._kmeans(jnp.asarray(v), jax.random.PRNGKey(0), 16, 10)
    tc, ta = ivf._kmeans(torch.from_numpy(v), torch.tensor(init).long(), 10)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_fit_and_search_match_jax(nprobe):
    """fit(init=JAX's draw) builds JAX's bucket layout (row ids, validity,
    vectors), and the search over it returns JAX's ids and scores."""
    v = _blobs(1)
    j = jivf.IVFIndex(n_clusters=16, iters=10)
    j.fit(v, dtype=jnp.float32)
    t = ivf.IVFIndex(n_clusters=16, iters=10, device="cpu")
    t.fit(v, dtype=torch.float32, init=_jax_init(len(v), 16))
    np.testing.assert_array_equal(t.row_ids.numpy(), np.asarray(j.row_ids))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(t.buckets.numpy(), np.asarray(j.buckets), atol=1e-6)
    assert t.memory_bytes == j.memory_bytes
    q = v[np.random.default_rng(2).choice(len(v), 8, replace=False)] + 0.05
    got, want = t.search(q, k=10, nprobe=nprobe), j.search(q, k=10, nprobe=nprobe)
    assert [[r for r, _ in h] for h in got] == [[r for r, _ in h] for h in want]
    for gh, wh in zip(got, want):
        np.testing.assert_allclose([s for _, s in gh], [s for _, s in wh], rtol=1e-6)


def test_ivf_search_on_jax_layout_matches_jax():
    """``_ivf_search`` on JAX's own centroids and buckets: JAX's ids, with
    the two-key (-score, row) order on planted duplicate rows."""
    v = _blobs(3)
    v[100] = v[5]  # an exact tie, rows in one cluster
    j = jivf.IVFIndex(n_clusters=12, iters=5)
    j.fit(v, dtype=jnp.float32)
    q = np.concatenate([v[5:6], _unit(np.random.default_rng(4).standard_normal((5, 32)))])
    tensors = [torch.from_numpy(np.array(x)) for x in
               (j.centroids, j.buckets, j.row_ids, j.valid)]
    for nprobe in (2, 12):
        ts, tr = ivf._ivf_search(torch.from_numpy(q), *tensors, k=12, nprobe=nprobe)
        js, jr = jivf._ivf_search(jnp.asarray(q), j.centroids, j.buckets, j.row_ids,
                                  j.valid, k=12, nprobe=nprobe)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert tr[0, :2].tolist() == [5, 100]


def test_full_probe_is_exact():
    rng = np.random.default_rng(5)
    corpus = _unit(rng.standard_normal((256, 32)))
    idx = ivf.IVFIndex(n_clusters=8, iters=5, device="cpu")
    idx.fit(corpus, dtype=torch.float32)
    q = _unit(rng.standard_normal((4, 32)))
    got = idx.search(q, k=5, nprobe=8)
    _, oracle = topk_oracle(q, corpus, 5)
    assert [[r for r, _ in h] for h in got] == oracle.tolist()


def test_recall_on_clustered_data():
    corpus = _blobs(6, per=128, d=64)
    idx = ivf.IVFIndex(n_clusters=16, iters=10, device="cpu")
    idx.fit(corpus, dtype=torch.float32)
    q = corpus[np.random.default_rng(7).choice(len(corpus), 16, replace=False)]
    got = idx.search(q, k=10, nprobe=4)
    _, oracle = topk_oracle(q, corpus, 10)
    recall = np.mean([len({r for r, _ in got[i]} & set(oracle[i].tolist())) / 10
                      for i in range(len(q))])
    assert recall >= 0.9, recall


def test_empty_index_and_memory():
    idx = ivf.IVFIndex(device="cpu")
    assert idx.search(np.zeros((1, 8), np.float32), k=3) == [[]]
    assert idx.memory_bytes == 0 == jivf.IVFIndex().memory_bytes
    idx.fit(_blobs(8, n_blobs=4, per=10, d=8), dtype=torch.bfloat16)
    K, C, d = idx.buckets.shape
    assert (K, d) == (6, 8)  # K = sqrt(40) by default, as in JAX
    assert idx.memory_bytes == K * C * d * 2 + K * d * 2 + K * C * 4 + K * C


def test_bad_ann_raises():
    store_none = dict(embed_query_fn=None, ann="hnsw")
    with pytest.raises(ValueError):
        jhybrid.HybridRetriever(None, None, None, **store_none)
    with pytest.raises(ValueError, match="exact|ivf"):
        hybrid.HybridRetriever(None, None, None, **store_none)


def _hash_embed(texts, d=64):
    out = np.zeros((len(texts), d), np.float32)
    for i, t in enumerate(texts):
        for tok in sparse.analyze(t):
            out[i, hash(tok) % d] += 1.0
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


class _Enc:
    encode = staticmethod(_hash_embed)


def _ivf_systems(tmp_path, search_type):
    """JAX's and the port's RagSystem with retrieval.ann="ivf" (full probe:
    nprobe 64 over 4 clusters) on one data directory."""
    from ragmeup_tpu.config import RagConfig as JaxRagConfig
    from ragmeup_tpu.pipeline.llm_backends import StaticChatBackend as JaxStatic
    from ragmeup_tpu.pipeline.system import RagSystem as JaxRagSystem
    from ragmeup_tpu_torch import RagConfig, RagSystem
    from ragmeup_tpu_torch.pipeline.llm_backends import StaticChatBackend

    data = tmp_path / "docs"
    data.mkdir()
    for i in range(24):
        (data / f"d{i}.txt").write_text(f"token{i} token{i+1} blob{i % 4} shared words")

    def cfg(cls, tag):
        c = cls()
        c.data.data_directory = str(data)
        c.data.index_directory = str(tmp_path / f"idx_{tag}")
        c.model.embedding_dim = 64
        c.retrieval.ann = "ivf"
        c.retrieval.ivf_nprobe = 64
        c.retrieval.ivf_clusters = 4
        c.retrieval.rerank = False
        c.retrieval.search_type = search_type
        c.pipeline.use_provenance = False
        c.pipeline.use_rewrite_loop = False
        return c

    j = JaxRagSystem(cfg(JaxRagConfig, "j"), encoder=_Enc(),
                     backend=JaxStatic(default="a."))
    t = RagSystem(cfg(RagConfig, "t"), encoder=_Enc(), backend=StaticChatBackend(default="a."),
                  device="cpu")
    return j, t, data


@pytest.mark.parametrize("search_type", ["similarity", "mmr"])
def test_ivf_system_matches_jax_after_add_and_delete(tmp_path, search_type):
    j, t, data = _ivf_systems(tmp_path, search_type)
    assert isinstance(t.retriever._ivf_view, ivf.IVFDenseView)
    queries = ("token3 shared", "blob2 words", "token11 blob3")
    for q in queries:
        assert t.retriever.retrieve_rows(q, k=5) == j.retriever.retrieve_rows(q, k=5), q
    new = data / "new.txt"
    new.write_text("zebra quagga unique tokens appear here")
    assert t.add_document(str(new)) == j.add_document(str(new)) > 0
    for q in queries + ("zebra quagga unique",):
        assert t.retriever.retrieve_rows(q, k=5) == j.retriever.retrieve_rows(q, k=5), q
    gone = str(data / "d3.txt")
    assert t.delete_document(gone) == j.delete_document(gone) > 0
    for q in queries:
        got = t.retriever.retrieve_rows(q, k=5)
        assert got == j.retriever.retrieve_rows(q, k=5), q
        assert all(t.store[r].source != gone for r, _ in got)
    out_t, out_j = t.chat("token3 shared"), j.chat("token3 shared")
    assert [d["pk"] for d in out_t["documents"]] == [d["pk"] for d in out_j["documents"]]
    assert out_t["reply"] == out_j["reply"]


def _corpus(seed, n=120):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(4, 14)))) for _ in range(n)]


def _hybrid_pair(seed, dtype):
    corpus = _corpus(seed)
    vecs = np.random.default_rng(seed + 100).standard_normal((len(corpus), 32)).astype(np.float32)
    t_d, j_d = dense.DenseIndex(32, dtype=dtype, device="cpu"), jdense.DenseIndex(32, dtype=dtype)
    t_s, j_s = sparse.BM25Index(device="cpu"), jsparse.BM25Index()
    for d_, s_ in ((t_d, t_s), (j_d, j_s)):
        d_.add(vecs)
        s_.add(corpus)
        d_.delete_rows([5, 6])
        s_.delete_rows([5, 6])
    return (t_d, t_s), (j_d, j_s)


QUERIES = ["the fox dog", "tech earnings rally", "quantum bits qubits",
           "sleepy canine by the door", "music album song train", "zzzgibberish",
           "bank loan rate", "city train ticket"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("search_type", ["similarity", "mmr"])
def test_stream_matches_per_batch_and_jax(dtype, search_type):
    """Batches of 3, 1 (a query with no known term) and 4 queries: the
    stream yields, in order, what hybrid_fused_search returns for each
    batch, and what JAX's stream yields (float32 and int8; bf16 holds the
    stream to the port's own per-batch search)."""
    (t_d, t_s), (j_d, j_s) = _hybrid_pair(1, dtype)
    rng = np.random.default_rng(11)
    batches = [(QUERIES[:3], rng.standard_normal((3, 32)).astype(np.float32)),
               (QUERIES[5:6], rng.standard_normal((1, 32)).astype(np.float32)),
               (QUERIES[:2] + QUERIES[6:], rng.standard_normal((4, 32)).astype(np.float32))]
    kw = dict(search_type=search_type, fetch_k=12)
    streamed = list(hybrid.hybrid_fused_search_stream(t_d, t_s, batches, 6, **kw))
    assert len(streamed) == 3 and streamed[1] == [[]]
    for (qs, qv), got in zip(batches[::2], streamed[::2]):
        assert got == hybrid.hybrid_fused_search(t_d, t_s, qs, qv, 6, **kw) and all(got)
    if dtype != "bfloat16":
        want = list(jhybrid.hybrid_fused_search_stream(j_d, j_s, batches, 6, **kw))
        for got, exp in zip(streamed, want):
            assert [[r for r, _ in h] for h in got] == [[r for r, _ in h] for h in exp]
            for gh, eh in zip(got, exp):
                np.testing.assert_allclose([s for _, s in gh], [s for _, s in eh], rtol=1e-6)
