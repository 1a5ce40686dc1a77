"""The port's corpus-sharded RagSystem against the JAX package's, on the CPU.

parallel.corpus_axis = 4 (the port's mesh over "cpu" repeated, JAX's over
the virtual CPU devices of tests/conftest.py): retrieval equal to JAX's
mesh-backed system and to the port's single-device one through add,
delete, compact and an artifact reload (bf16 and int8 indexes, hash
embeddings); a tiny real decoder's two /chat turns equal JAX's (replies,
documents, provenance, history), also with parallel.model_axis = 2 beside
the corpus axis (each decoder over its package's mesh); and with
parallel.data_axis = 2 alone both serve on one device with no mesh.
corpus_axis 3 and a device list too short raise as in JAX; the model
axis builds JAX's mesh. A file of its own beside test_torch_parallel.py,
so that neither is a parallel run's long pole.
"""

import os

import numpy as np
import pytest

from ragmeup_tpu_torch.parallel import sharded_index as tsi
from ragmeup_tpu_torch.retrieval import sparse
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)
# the tiny decoder systems of test_torch_system.py, with cfg.parallel set
from test_torch_system import LLM_CFG, _build_systems, _two_turns_match


def _ids(hits):
    return [[r for r, _ in h] for h in hits]


def _mk_hash_systems(tmp_path, tag, corpus_axis, dense_dtype):
    """JAX's and the port's RagSystem with static replies and hash
    embeddings (JAX's test_parallel.py product corpus)."""
    from ragmeup_tpu.config import RagConfig as JaxRagConfig
    from ragmeup_tpu.pipeline.llm_backends import StaticChatBackend as JaxStatic
    from ragmeup_tpu.pipeline.system import RagSystem as JaxRagSystem
    from ragmeup_tpu_torch import RagConfig, RagSystem
    from ragmeup_tpu_torch.pipeline.llm_backends import StaticChatBackend

    data = tmp_path / "data"
    if not data.exists():
        data.mkdir()
        rng = np.random.default_rng(7)
        words = [f"w{i}" for i in range(120)]
        for i in range(40):
            (data / f"doc{i}.txt").write_text(
                " ".join(rng.choice(words, size=30)) + f" special{i % 7}")

    def hash_embed(texts, d=64):
        out = np.zeros((len(texts), d), np.float32)
        for i, t in enumerate(texts):
            for tok in sparse.analyze(t):
                out[i, hash(tok) % d] += 1.0
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)

    class Enc:
        encode = staticmethod(hash_embed)

    def cfg(cls, pkg):
        c = cls()
        c.data.data_directory = str(data)
        c.data.index_directory = str(tmp_path / f"index_{tag}_{pkg}")
        c.model.embedding_dim = 64
        c.retrieval.dense_dtype = dense_dtype
        c.retrieval.rerank = False
        c.pipeline.use_provenance = False
        c.pipeline.use_rewrite_loop = False
        c.parallel.corpus_axis = corpus_axis
        return c

    j = JaxRagSystem(cfg(JaxRagConfig, "jax"), encoder=Enc(),
                     backend=JaxStatic(default="answer."))
    t = RagSystem(cfg(RagConfig, "torch"), encoder=Enc(),
                  backend=StaticChatBackend(default="answer."), device="cpu",
                  devices=["cpu"] * corpus_axis)
    return j, t


HASH_QUERIES = ["w3 w17 special2", "special5 w40", "w1 w2 w3 w4", "zzz w9"]


@pytest.mark.parametrize("dense_dtype", ["bfloat16", "int8"])
def test_corpus_sharded_system_crud_and_reload_match_jax(tmp_path, dense_dtype):
    """corpus_axis 4: retrieve_rows equal to JAX's mesh-backed system and to
    the port's single-device one, after add_document and delete_document,
    after compact, and from the reloaded artifact."""
    j, t = _mk_hash_systems(tmp_path, "m", 4, dense_dtype)
    _, single = _mk_hash_systems(tmp_path, "s", 1, dense_dtype)
    assert isinstance(t.dense, tsi.ShardedDenseIndex) and t.retriever.mesh is t.mesh
    assert t.dense.dtype == dense_dtype and len(t.dense._corpus_t) == 4
    assert isinstance(t.sparse._flush()["head"], list) or t.sparse._flush()["head"].shape[0] == 0

    def same():
        for q in HASH_QUERIES:
            got = t.retriever.retrieve_rows(q, k=5)
            assert _ids([got]) == _ids([j.retriever.retrieve_rows(q, k=5)]), q
            assert got == single.retriever.retrieve_rows(q, k=5), q

    same()
    new = os.path.join(t.cfg.data.data_directory, "extra.txt")
    with open(new, "w") as f:
        f.write("zebra quokka axolotl special3 w9")
    assert t.add_document(new) == j.add_document(new) == single.add_document(new) > 0
    same()
    assert t.delete_document(new) == j.delete_document(new) == single.delete_document(new)
    same()
    for s in (t, j, single):
        s.compact()
    same()
    _, again = _mk_hash_systems(tmp_path, "m", 4, dense_dtype)
    assert again.dense.n == t.dense.n and isinstance(again.dense, tsi.ShardedDenseIndex)
    for q in HASH_QUERIES:
        assert again.retriever.retrieve_rows(q, k=5) == t.retriever.retrieve_rows(q, k=5)
    out_t, out_j = t.chat(HASH_QUERIES[0]), j.chat(HASH_QUERIES[0])
    assert [d["pk"] for d in out_t["documents"]] == [d["pk"] for d in out_j["documents"]]


def test_corpus_axis_rules_match_jax(tmp_path):
    """corpus_axis 3 and a device list too short raise JAX's ValueErrors;
    the model axis builds JAX's mesh (its LLM: test_torch_tp*.py)."""
    from ragmeup_tpu_torch import RagConfig, RagSystem
    from ragmeup_tpu_torch.pipeline.llm_backends import StaticChatBackend
    from ragmeup_tpu.config import RagConfig as JaxRagConfig
    from ragmeup_tpu.pipeline.system import RagSystem as JaxRagSystem

    def build(pkg, devices=None, **axes):
        cfg = (RagConfig if pkg == "torch" else JaxRagConfig)()
        cfg.data.index_directory = str(tmp_path / "idx")
        for name, value in axes.items():
            setattr(cfg.parallel, name, value)
        kw = dict(encoder=object(), backend=StaticChatBackend(), eager_load=False)
        if pkg == "torch":
            return RagSystem(cfg, device="cpu", devices=devices, **kw)
        return JaxRagSystem(cfg, **kw)

    for pkg in ("torch", "jax"):
        with pytest.raises(ValueError, match="must be a power of two.*got 3"):
            build(pkg, ["cpu"] * 3, corpus_axis=3)
    with pytest.raises(ValueError, match=r"needs 4 devices \(data=1 corpus=4 model=1\); have 2"):
        build("torch", ["cpu"] * 2, corpus_axis=4)
    with pytest.raises(ValueError, match=r"needs 16 devices .*have 8"):
        build("jax", corpus_axis=16)
    assert (build("torch", ["cpu"] * 2, model_axis=2).mesh.shape
            == build("jax", model_axis=2).mesh.shape == {"data": 1, "corpus": 1, "model": 2})
    s = build("torch", ["cpu"] * 8, corpus_axis=4, data_axis=2)
    assert s.mesh.shape == {"data": 2, "corpus": 4, "model": 1}


@pytest.mark.parametrize("axes", [dict(corpus_axis=4), dict(data_axis=2),
                                  dict(corpus_axis=4, model_axis=2)],
                         ids=["corpus_axis=4", "data_axis=2", "corpus_axis=4,model_axis=2"])
def test_chat_matches_jax_over_two_turns(tmp_path, axes):
    """A tiny real decoder behind both systems: with the corpus axis at 4
    (JAX's mesh-backed system against the port's sharded one), with the
    data axis alone at 2 (both serve on one device, no mesh), and with
    the model axis at 2 beside the corpus axis (each decoder over its
    package's (1, 4, 2) mesh: tensor-parallel, the ring prefill), two
    /chat turns agree: replies, documents, provenance and history."""
    j_sys, t_sys = _build_systems(tmp_path, LLM_CFG, "float32", **axes)
    if "corpus_axis" in axes:
        assert isinstance(t_sys.dense, tsi.ShardedDenseIndex) and j_sys.mesh is not None
    else:
        assert t_sys.mesh is None and j_sys.mesh is None
    if "model_axis" in axes:
        assert t_sys.mesh.shape == dict(j_sys.mesh.shape) == {"data": 1, "corpus": 4,
                                                              "model": 2}
        assert len(t_sys.llm.model.shards) == 2 and j_sys.llm.mesh is not None
    _two_turns_match(j_sys, t_sys)
