"""The port's corpus-sharded retrieval against the JAX package's, on the CPU.

The port's mesh lays its shards over "cpu" repeated, JAX's over the 8
virtual CPU devices of tests/conftest.py. Held against the JAX package on
the same numpy-seeded inputs: the mesh's shape rules; ``sharded_topk``
(ties across shards, a mask, int8 with the JAX program's scale order, the
int8 near-tie corpus); ``ShardedDenseIndex`` CRUD, incremental adds, the
normalize flag and compact; index artifacts written by either package and
loaded by the other; sharded BM25; the sharded hybrid search (similarity
and MMR, float32 and int8); sharded IVF. (The system:
test_torch_parallel_system.py.) Float corpora are float32 where both
packages' scores are compared: the port's shards run #1, which casts a
query to a bf16 corpus's dtype, while JAX's sharded program scores the f32
query. Ids and orders exact, f32 scores within a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragmeup_tpu.ops.topk import topk_oracle
from ragmeup_tpu.parallel import mesh as jmesh
from ragmeup_tpu.parallel import sharded_index as jsi
from ragmeup_tpu.parallel import sharded_ivf as jsivf
from ragmeup_tpu.retrieval import sparse as jsparse
from ragmeup_tpu_torch.parallel import mesh, sharded_index as tsi, sharded_ivf as tsivf
from ragmeup_tpu_torch.retrieval import dense, hybrid, ivf, sparse
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _corpus(rng, n, d):
    return _unit(rng.standard_normal((n, d)))


def _meshes(shape=(1, 8, 1)):
    """(JAX mesh, port mesh) of one shape."""
    n = int(np.prod(shape))
    return (jmesh.make_mesh(shape, devices=jax.devices()[:n]),
            mesh.make_mesh(shape, devices=["cpu"] * n))


def _ids(hits):
    return [[r for r, _ in h] for h in hits]


def _same_hits(got, want, rtol=1e-6):
    assert _ids(got) == _ids(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=rtol)


# -- mesh ------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(8,), (8, 2), (8, 2, 2), (6,), (4, None, 4), (16, 4)])
def test_mesh_shape_for_matches_jax(args):
    assert mesh.mesh_shape_for(*args) == jmesh.mesh_shape_for(*args)


def test_make_mesh_shapes_and_devices():
    jm, tm = _meshes((1, 4, 2))
    assert tm.shape == jm.shape == {"data": 1, "corpus": 4, "model": 2}
    assert tm.axis_devices("corpus") == [torch.device("cpu")] * 4
    assert len(tm.axis_devices("model")) == 2
    assert mesh.make_mesh(devices=["cpu"] * 8).shape == jmesh.make_mesh().shape
    with pytest.raises(ValueError, match=r"mesh shape \(1, 3, 1\) != 4 devices"):
        mesh.make_mesh((1, 3, 1), devices=["cpu"] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh((1, 2, 1))  # default devices: the cards


# -- sharded_topk ----------------------------------------------------------------

def test_sharded_topk_matches_jax_and_oracle():
    rng = np.random.default_rng(0)
    jm, tm = _meshes()
    corpus, q = _corpus(rng, 4096, 64), _corpus(rng, 5, 64)
    ts, ti = tsi.sharded_topk(tm, torch.from_numpy(q), torch.from_numpy(corpus.T.copy()), 10)
    js, ji = jsi.sharded_topk(jm, jnp.asarray(q), jnp.asarray(corpus.T), 10)
    _, oi = topk_oracle(q, corpus, 10)
    np.testing.assert_array_equal(ti.numpy(), oi)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_sharded_topk_ties_across_shards_go_to_the_lowest_id():
    jm, tm = _meshes()
    d, n = 64, 4096
    v = np.ones((1, d), np.float32) / np.sqrt(d)
    corpus = _corpus(np.random.default_rng(3), n, d) * 0.5
    planted = [100, 3 * 512 + 7, 7 * 512 + 400]
    for row in planted[::-1]:
        corpus[row] = v[0]
    _, ti = tsi.sharded_topk(tm, torch.from_numpy(v), torch.from_numpy(corpus.T.copy()), 3)
    _, ji = jsi.sharded_topk(jm, v, jnp.asarray(corpus.T), 3)
    assert ti[0].tolist() == np.asarray(ji)[0].tolist() == planted


def test_sharded_topk_mask_and_uneven_columns():
    rng = np.random.default_rng(1)
    jm, tm = _meshes()
    corpus, q = _corpus(rng, 2048, 64), _corpus(rng, 2, 64)
    _, oi = topk_oracle(q, corpus, 5)
    dead = sorted({int(oi[0, 0]), int(oi[1, 1])})
    mask = np.zeros((1, 2048), np.float32)
    mask[0, dead] = -1e30
    _, ti = tsi.sharded_topk(tm, torch.from_numpy(q), torch.from_numpy(corpus.T.copy()), 5,
                             mask=torch.from_numpy(mask))
    _, ji = jsi.sharded_topk(jm, jnp.asarray(q), jnp.asarray(corpus.T), 5,
                             mask=jnp.asarray(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), topk_oracle(q, corpus, 5, dead_rows=dead)[1])
    with pytest.raises(ValueError, match="not divisible by corpus axis 8"):
        tsi.sharded_topk(tm, torch.from_numpy(q), torch.zeros((64, 2044)), 5)


def _host_q8(x, axis):
    amax = np.max(np.abs(x), axis=axis, keepdims=True)
    scale = np.maximum(amax, 1e-8) / 127.0
    return np.clip(np.round(x / scale), -127, 127).astype(np.float32), scale.astype(np.float32)


def _near_tie_corpus_and_queries():
    """JAX's test corpus whose float-query and W8A8 top-5 ranks diverge."""
    rng = np.random.default_rng(0)
    n, d = 256, 64
    v = _unit(rng.standard_normal((n, d)))
    for j in range(0, 32, 2):
        v[j + 1] = v[j] + rng.standard_normal(d).astype(np.float32) * 1e-4
        v[j + 1] /= np.linalg.norm(v[j + 1])
    return v, _unit(rng.standard_normal((3, d)))


@pytest.mark.parametrize("corpus_kind", ["random", "near_tie"])
def test_sharded_topk_int8_matches_jax(corpus_kind):
    """The port's shards quantize the f32 query inside #2's plain version;
    JAX's program takes the codes and q_scale. Same (acc * q_scale) *
    c_scale + mask order: equal ids and scores."""
    jm, tm = _meshes()
    if corpus_kind == "random":
        rng = np.random.default_rng(2)
        v, q = _corpus(rng, 1024, 64), _corpus(rng, 4, 64)
    else:
        v, q = _near_tie_corpus_and_queries()
    codes, c_scale = _host_q8(v, axis=1)
    q8, q_scale = _host_q8(q, axis=1)
    ts, ti = tsi.sharded_topk(tm, torch.from_numpy(q), torch.from_numpy(codes.T.astype(np.int8)),
                              5, scales=torch.from_numpy(c_scale.T.copy()))
    js, ji = jsi.sharded_topk(jm, jnp.asarray(q8), jnp.asarray(codes.T.astype(np.int8)), 5,
                              scales=jnp.asarray(c_scale.T), q_scale=jnp.asarray(q_scale))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -- ShardedDenseIndex -------------------------------------------------------------

def _index_pair(jm, tm, d, **kw):
    return tsi.ShardedDenseIndex(tm, d, **kw), jsi.ShardedDenseIndex(jm, d, **kw)


def test_sharded_index_crud_matches_jax():
    rng = np.random.default_rng(4)
    jm, tm = _meshes()
    t, j = _index_pair(jm, tm, 64, tile_n=64, dtype="float32")
    corpus, more = _corpus(rng, 300, 64), _corpus(rng, 100, 64)
    assert t.add(corpus) == j.add(corpus) == list(range(300))
    q = np.concatenate([corpus[123:124], _corpus(rng, 3, 64)])
    _same_hits(t.search(q, 5), j.search(q, 5))
    assert t.search(corpus[123:124], 3)[0][0][0] == 123
    t.delete_rows([123, 7])
    j.delete_rows([123, 7])
    _same_hits(t.search(q, 5), j.search(q, 5))
    assert t.add(more) == j.add(more) == list(range(300, 400))
    _same_hits(t.search(more[7:8], 1), j.search(more[7:8], 1))
    assert t.search(more[7:8], 1)[0][0][0] == 307
    for st in ("similarity", "mmr"):
        _same_hits(t.search(q, 5, search_type=st, fetch_k=16),
                   j.search(q, 5, search_type=st, fetch_k=16))
    np.testing.assert_array_equal(t.gather_rows([0, 299, 350]), j.gather_rows([0, 299, 350]))
    np.testing.assert_array_equal(t.host_vectors(), j.host_vectors())


def test_sharded_index_matches_single_device_and_incremental_adds():
    """Adds in place, across a growth, equal one add and the port's
    single-device DenseIndex (bf16 included: both run #1's cast)."""
    rng = np.random.default_rng(5)
    tm = _meshes((1, 2, 1))[1]  # shards of 1024 columns: 2600 rows grow it
    c = _corpus(rng, 2600, 16)
    q = _corpus(rng, 3, 16)
    for dtype in ("float32", "bfloat16"):
        inc = tsi.ShardedDenseIndex(tm, 16, tile_n=32, dtype=dtype)
        inc.add(c[:100])
        inc.add(c[100:130])
        cap = inc.capacity
        inc.add(c[130:])  # grows: each shard lands whole in a wider one
        assert inc.capacity == 2 * cap
        ref = tsi.ShardedDenseIndex(tm, 16, tile_n=32, dtype=dtype)
        ref.add(c)
        single = dense.DenseIndex(16, dtype=dtype, device="cpu")
        single.add(c)
        assert inc.search(q, 7) == ref.search(q, 7) == single.search(q, 7)
        for st in ("similarity", "mmr"):
            assert inc.search(q, 5, search_type=st, fetch_k=16) == \
                single.search(q, 5, search_type=st, fetch_k=16)
        assert len({a.data_ptr() for a in inc._corpus_t}) == len(inc._corpus_t)
        if dtype == "float32":
            np.testing.assert_array_equal(_ids(inc.search(q, 7)), topk_oracle(q, c, 7)[1])


def test_sharded_index_normalize_flag_and_compact_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    jm, tm = _meshes()
    t, j = _index_pair(jm, tm, 16, normalize=False, dtype="float32")
    vecs = rng.standard_normal((40, 16)).astype(np.float32) * 3.0
    t.add(vecs)
    j.add(vecs)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    want = t.search(q, 3)
    _same_hits(want, j.search(q, 3))
    t.save(str(tmp_path / "t"))
    loaded = tsi.ShardedDenseIndex.load(str(tmp_path / "t"), tm)
    assert loaded.normalize is False
    assert _ids(loaded.search(q, 3)) == _ids(want)
    mapping = [-1 if i in (0, 9) else i - (i > 0) - (i > 9) for i in range(40)]
    for ix in (t, j):
        ix.delete_rows([0, 9])
        ix.compact(mapping)
    assert t.normalize is False and t.n == j.n == 38
    _same_hits(t.search(q, 5), j.search(q, 5))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sharded_artifacts_load_in_the_other_package(tmp_path, writer, dtype):
    """A sharded artifact written by either package loads in the other (and
    in the port's single-device DenseIndex), with the same rows, dead rows,
    codes and searches."""
    rng = np.random.default_rng(7)
    jm, tm = _meshes((1, 4, 1))
    t, j = _index_pair(jm, tm, 32, dtype=dtype)
    v = _corpus(rng, 500, 32)
    for ix in (t, j):
        ix.add(v)
        ix.delete_rows([3, 400])
    src = j if writer == "jax" else t
    src.save(str(tmp_path))
    loaded = (tsi.ShardedDenseIndex.load(str(tmp_path), tm),
              jsi.ShardedDenseIndex.load(str(tmp_path), jm))
    assert all(ix.n == 500 and ix.dead == {3, 400} for ix in loaded)
    q = _corpus(rng, 3, 32)
    for st in ("similarity", "mmr"):
        # float32 reloads from the artifact's f16 vectors: equal to each other
        _same_hits(*(ix.search(q, 8, search_type=st) for ix in loaded))
        if dtype == "int8":  # the exact codes travel: equal to the writer too
            _same_hits(loaded[0].search(q, 8, search_type=st),
                       src.search(q, 8, search_type=st))
    if dtype == "int8":
        codes = np.load(tmp_path / "codes_int8.npy")
        np.testing.assert_array_equal(codes, _host_q8(v, 1)[0].astype(np.int8))
    single = dense.DenseIndex.load(str(tmp_path), device="cpu")
    assert single.search(q, 8) == loaded[0].search(q, 8)


def test_sharded_int8_index_matches_single_device_and_jax():
    """int8 on the near-tie corpus: the sharded index equals the
    single-device one (ranks and scores) in the port and JAX's sharded
    index; dead rows stay dead when k passes the live rows."""
    v, q = _near_tie_corpus_and_queries()
    jm, tm = _meshes()
    t, j = _index_pair(jm, tm, 64, dtype="int8")
    single = dense.DenseIndex(64, dtype="int8", device="cpu")
    for ix in (t, j, single):
        ix.add(v)
    assert t.search(q, 5) == single.search(q, 5)
    _same_hits(t.search(q, 5), j.search(q, 5))
    small = tsi.ShardedDenseIndex(tm, 64, dtype="int8")
    small.add(v[:16])
    small.delete_rows(range(10))
    rows = _ids(small.search(q[:1], 10))[0]
    assert len(rows) == 6 and all(r >= 10 for r in rows)


# -- sharded BM25 and hybrid -----------------------------------------------------------

BM25_CORPUS = ["the quick brown fox jumps over the lazy dog",
               "a fast auburn fox leaped over a sleepy canine",
               "the stock market rallied on tech earnings today",
               "quantum computing uses qubits instead of classical bits",
               "the dog sat by the door waiting for the fox",
               "earnings season lifts markets as tech stocks rally"] * 10 + [
               "a lone zebra by the fox", "rare qubits and rare bits"]
BM25_QUERIES = ["fox dog the zebra", "tech earnings rally", "quantum bits rare"]


def test_sharded_bm25_matches_jax_and_single_device():
    jm, tm = _meshes()
    t = sparse.BM25Index(tile_n=64, dense_min_df=4, dense_df_ratio=0.0, device="cpu")
    j = jsparse.BM25Index(tile_n=64, dense_min_df=4, dense_df_ratio=0.0)
    t.add(BM25_CORPUS)
    j.add(BM25_CORPUS)
    t.delete_rows([4])
    j.delete_rows([4])
    ti, ji = t.build_query_inputs(BM25_QUERIES), j.build_query_inputs(BM25_QUERIES)
    assert ti["has_head"] and ti["has_tail"]
    k, nq, cap = 8, len(BM25_QUERIES), ti["cap"]
    ts, tr = tsi.sharded_bm25_topk(
        tm, torch.from_numpy(ti["qsel"]), ti["dev"]["head"], ti["docs_cat"], ti["con_cat"],
        ti["qid_cat"], ti["dev"]["mask"], k=k, nq=nq, cap=cap)
    js, jr = jsi.sharded_bm25_topk(
        jm, jnp.asarray(ji["qsel"]), ji["dev"]["head"], jnp.asarray(ji["docs_cat"]),
        jnp.asarray(ji["con_cat"]), jnp.asarray(ji["qid_cat"]), ji["dev"]["mask"],
        k=k, nq=nq, cap=cap)
    ss, sr = t.score_topk(ti, k, nq)
    np.testing.assert_array_equal(tr.numpy(), sr.numpy())
    np.testing.assert_array_equal(ts.numpy(), ss.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert [(round(float(s), 5), int(i)) for s, i in zip(ts.numpy().ravel(), tr.numpy().ravel())] \
        == [(round(float(s), 5), int(i)) for s, i in zip(np.asarray(js).ravel(), np.asarray(jr).ravel())]
    # the placer splits the head and mask a copy a shard; search goes sharded
    placed = sparse.BM25Index(tile_n=64, dense_min_df=4, dense_df_ratio=0.0, device="cpu")
    placed.shard_placer = tsi.make_shard_placer(tm)
    placed.add(BM25_CORPUS)
    placed.delete_rows([4])
    dev = placed._flush()
    assert isinstance(dev["head"], list) and len(dev["head"]) == 8
    assert dev["head"][0].shape[1] == dev["cap"] // 8
    assert placed.search(BM25_QUERIES, k) == t.search(BM25_QUERIES, k)


def _hybrid_inputs(seed, dtype, n=256, d=64):
    rng = np.random.default_rng(seed)
    v = _corpus(rng, n, d) if dtype != "near_tie" else _near_tie_corpus_and_queries()[0]
    texts = [f"doc{i} filler common term{i % 9}" for i in range(n)]
    return v, texts


@pytest.mark.parametrize("dtype", ["float32", "int8", "near_tie"])
@pytest.mark.parametrize("search_type", ["similarity", "mmr"])
def test_sharded_hybrid_search_matches_jax_and_single_device(dtype, search_type):
    """The sharded hybrid search equals the port's single-device fused
    search and JAX's sharded program (fused rows and scores), with BM25
    live so the whole program runs, dead rows in both indexes, and the
    BM25 head placed per shard."""
    v, texts = _hybrid_inputs(8, dtype)
    store = "int8" if dtype != "float32" else "float32"
    queries = ["common term3 doc5", "term7 filler", "doc11 common", "zzz unknown"]
    qv = _corpus(np.random.default_rng(9), len(queries), 64)
    jm, tm = _meshes()
    t_sh, j_sh = _index_pair(jm, tm, 64, dtype=store)
    t_1 = dense.DenseIndex(64, dtype=store, device="cpu")
    t_sp = sparse.BM25Index(tile_n=64, device="cpu")
    t_sp.shard_placer = tsi.make_shard_placer(tm)
    t_sp1 = sparse.BM25Index(tile_n=64, device="cpu")
    j_sp = jsparse.BM25Index(tile_n=64)
    for ix in (t_sh, j_sh, t_1):
        ix.add(v)
        ix.delete_rows([5, 40])
    for sp in (t_sp, t_sp1, j_sp):
        sp.add(texts)
        sp.delete_rows([5, 40])
    kw = dict(search_type=search_type, fetch_k=12)
    got = tsi.sharded_hybrid_search(tm, t_sh, t_sp, queries, qv, 5, **kw)
    assert got == hybrid.hybrid_fused_search(t_1, t_sp1, queries, qv, 5, **kw)
    _same_hits(got, jsi.sharded_hybrid_search(jm, j_sh, j_sp, queries, qv, 5, **kw))
    assert all(got) and all(r not in (5, 40) for h in got for r, _ in h)


# -- sharded IVF -------------------------------------------------------------------------

def _assert_valid_topk(got_rows, qi, corpus, k, atol=1e-5):
    """Every returned row's f64 score clears the oracle's k-th score (the
    IVF views hold bf16-rounded vectors)."""
    assert len(got_rows) == len(set(got_rows)) == k, got_rows
    scores = corpus.astype(np.float64) @ qi.astype(np.float64)
    cut = np.sort(scores)[::-1][k - 1] - atol
    assert all(scores[r] >= cut for r in got_rows), (got_rows, cut)


def test_sharded_ivf_search_on_jax_layout_matches_jax():
    """The port's per-shard probe and merge on JAX's sharded cluster layout
    (K = 10 over 4 shards: padded clusters) returns JAX's rows and scores."""
    rng = np.random.default_rng(10)
    jm, tm = _meshes((1, 4, 2))
    corpus = _corpus(rng, 256, 32)
    jidx = jsi.ShardedDenseIndex(jm, 32, tile_n=32, dtype="float32")
    jidx.add(corpus)
    view = jsivf.ShardedIVFView(jidx, jm, nprobe=2, n_clusters=10)
    view._refresh()
    per_shard = [[torch.from_numpy(np.array(a))[i * 3:(i + 1) * 3] for i in range(4)]
                 for a in (view._centroids, view._buckets, view._row_ids, view._valid)]
    cmask = [torch.from_numpy(np.asarray(view._cmask)[i * 3:(i + 1) * 3, 0] > 0)
             for i in range(4)]
    q = _corpus(rng, 4, 32)
    for nprobe, k in ((2, 8), (3, 12), (1, 40)):
        ts, tr = tsivf._sharded_ivf_search(tm, torch.from_numpy(q), per_shard[0], cmask,
                                           *per_shard[1:], k=k, nprobe=nprobe)
        js, jr = jsivf._sharded_ivf_search(jm, jnp.asarray(q), view._centroids, view._cmask,
                                           view._buckets, view._row_ids, view._valid,
                                           k=k, nprobe=nprobe)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_sharded_ivf_full_probe_is_exact():
    rng = np.random.default_rng(0)
    tm = _meshes((1, 4, 2))[1]
    corpus = _corpus(rng, 256, 32)
    idx = tsi.ShardedDenseIndex(tm, 32, tile_n=32, dtype="float32")
    idx.add(corpus)
    view = tsivf.ShardedIVFView(idx, tm, nprobe=8, n_clusters=8)
    q = _corpus(rng, 4, 32)
    for i, hits in enumerate(view.search(q, k=5)):
        _assert_valid_topk([r for r, _ in hits], q[i], corpus, 5)


def test_sharded_ivf_recall_ge_single_device():
    rng = np.random.default_rng(1)
    tm = _meshes((1, 4, 2))[1]
    centers = _corpus(rng, 16, 64)
    corpus = _unit(np.concatenate(
        [c + 0.15 * rng.standard_normal((64, 64)) for c in centers]))
    idx = tsi.ShardedDenseIndex(tm, 64, tile_n=64, dtype="float32")
    idx.add(corpus)
    single = dense.DenseIndex(64, dtype="float32", device="cpu")
    single.add(corpus)
    sharded_view = tsivf.ShardedIVFView(idx, tm, nprobe=4, n_clusters=16)
    single_view = ivf.IVFDenseView(single, nprobe=4, n_clusters=16)
    q = corpus[rng.choice(len(corpus), 16, replace=False)]
    _, oracle = topk_oracle(q, corpus, 10)

    def recall(got):
        return np.mean([len({r for r, _ in got[i]} & set(oracle[i].tolist())) / 10
                        for i in range(len(q))])

    r_sh, r_1 = recall(sharded_view.search(q, k=10)), recall(single_view.search(q, k=10))
    assert r_sh >= 0.9, r_sh
    # the same layout, each shard probing its local top 4: a superset of the
    # single view's probes (k-boundary near-ties may flip two of 160 cells)
    assert r_sh >= r_1 - 2.0 / 160 - 1e-9, (r_sh, r_1)


def test_sharded_ivf_refresh_mmr_and_retriever():
    """The view refreshes on mutation (global row ids stay the index's),
    runs MMR over its candidates, and serves HybridRetriever(ann="ivf")
    under a mesh, equal to the exact sharded retriever at full probe."""
    from ragmeup_tpu_torch.data.documents import Chunk
    from ragmeup_tpu_torch.data.store import ChunkStore
    rng = np.random.default_rng(2)
    tm = _meshes((1, 4, 2))[1]
    corpus = _corpus(rng, 128, 32)
    idx = tsi.ShardedDenseIndex(tm, 32, tile_n=32, dtype="float32")
    idx.add(corpus[:96])
    view = tsivf.ShardedIVFView(idx, tm, nprobe=8, n_clusters=8)
    q = _corpus(rng, 2, 32)
    assert all(len(row) == 5 for row in view.search(q, k=5))
    idx.add(corpus[96:])
    for i, hits in enumerate(view.search(q, k=5)):
        _assert_valid_topk([r for r, _ in hits], q[i], corpus, 5)
    idx.delete_rows([int(view.search(q, k=1)[0][0][0])])
    top = view.search(q[:1], k=5)[0]
    assert len(top) == 5 and all(r not in idx.dead for r, _ in top)
    mmr = view.search(q, k=3, search_type="mmr", fetch_k=8)
    assert all(len(row) == 3 for row in mmr)
    assert all(r in {rr for rr, _ in full} for row, full in
               zip(mmr, view.search(q, k=8)) for r, _ in row)
    texts = [f"word{i % 11} word{i % 5} text" for i in range(128)]
    store = ChunkStore()
    store.add([Chunk(content=t, metadata={"source": f"d{i}"}) for i, t in enumerate(texts)])
    sp = sparse.BM25Index(device="cpu")
    sp.shard_placer = tsi.make_shard_placer(tm)
    sp.add(texts)
    emb = {t: corpus[i] for i, t in enumerate(texts)}
    kw = dict(embed_query_fn=lambda ts: np.stack([emb.get(t, corpus[7]) for t in ts]),
              k=4, search_type="similarity", mesh=tm)
    r_ivf = hybrid.HybridRetriever(store, idx, sp, ann="ivf", ivf_nprobe=64, **kw)
    r_exact = hybrid.HybridRetriever(store, idx, sp, **kw)
    assert isinstance(r_ivf._ivf_view, tsivf.ShardedIVFView)
    for text in texts[:6]:
        assert _ids([r_ivf.retrieve_rows(text)]) == _ids([r_exact.retrieve_rows(text)])
