"""The port's GraphRAG against the JAX package's: ``PropertyGraph`` (rows,
schema and saved JSON on the statements of ``test_graph.py``),
``GraphRetriever``, ``csv_to_graph`` and ``text_to_graph_llm``, the sidecar
(a subprocess of ``python -m ragmeup_tpu_torch.graph.sidecar``) answering
the port's urllib client and the JAX package's requests client alike, and a
``graph.enabled`` /chat through both ``RagSystem``s."""

import json
import socket
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

from ragmeup_tpu.config import PromptLibrary as JaxPrompts
from ragmeup_tpu.config import RagConfig as JaxRagConfig
from ragmeup_tpu.graph import client as jclient
from ragmeup_tpu.graph import retriever as jretriever
from ragmeup_tpu.graph import store as jstore
from ragmeup_tpu.pipeline.llm_backends import StaticChatBackend as JaxStatic
from ragmeup_tpu.pipeline.system import RagSystem as JaxRagSystem
from ragmeup_tpu_torch.config import PromptLibrary, RagConfig
from ragmeup_tpu_torch.graph import client, retriever, store
from ragmeup_tpu_torch.pipeline.llm_backends import StaticChatBackend
from ragmeup_tpu_torch.pipeline.system import RagSystem
from ragmeup_tpu_torch.retrieval.sparse import analyze
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

REPO = __file__.rsplit("/tests/", 1)[0]

# (statement, parameters) sequences of test_graph.py, each run on a fresh
# graph; a statement whose result is the string "raises" must raise
# CypherError in both packages
SCRIPTS = {
    "create_match": [("CREATE (n:Topic {name: 'physics'})", None),
                     ("CREATE (n:Topic {name: 'biology'})", None),
                     ("MATCH (t:Topic) RETURN t.name", None)],
    "merge": [("MERGE (t:Topic {name: $name})", {"name": "physics"})] * 3
    + [("MATCH (t:Topic) RETURN t", None)],
    "merge_relationship": [
        ("MERGE (q:Quote {text: $quoteText}) MERGE (t:Topic {name: $topicName}) "
         "MERGE (q)-[:IS_PART_OF]->(t)",
         {"quoteText": "Pitch Toolkit", "topicName": "Needed tools"}),
        ("MERGE (q:Quote {text: $quoteText}) MERGE (t:Topic {name: $topicName}) "
         "MERGE (q)-[:IS_PART_OF]->(t)",
         {"quoteText": "MVP", "topicName": "Needed tools"}),
        ("MATCH (q:Quote)-[:IS_PART_OF]->(t:Topic) RETURN q.text, t.name", None)],
    "where": [("CREATE (p:Person {name: 'ada', age: 36})", None),
              ("CREATE (p:Person {name: 'grace', age: 85})", None),
              ("MATCH (p:Person) WHERE p.age > 50 RETURN p.name", None),
              ("MATCH (p:Person) WHERE p.age > 10 AND p.name = 'ada' RETURN p.name",
               None)],
    "direction": [("MERGE (a:P {n: 'a'}) MERGE (b:P {n: 'b'}) MERGE (a)-[:LIKES]->(b)",
                   None),
                  ("MATCH (x:P)-[:LIKES]->(y:P) RETURN x.n, y.n", None),
                  ("MATCH (x:P)<-[:LIKES]-(y:P) RETURN x.n, y.n", None)],
    "distinct_limit_count": [("CREATE (t:Tag {name: $n})", {"n": n})
                             for n in ("x", "x", "y")]
    + [("MATCH (t:Tag) RETURN DISTINCT t.name", None),
       ("MATCH (t:Tag) RETURN t.name LIMIT 2", None),
       ("MATCH (t:Tag) RETURN count(t) AS n", None)],
    "labels": [("CREATE (t:Topic {name: 'physics'})", None),
               ("MATCH (t:Topic) RETURN t", None),
               ("MATCH (t:Topic) RETURN labels(t) AS l", None)],
    "order_by_or": [("CREATE (p:Person {name: $n, age: $a})", {"n": n, "a": a})
                    for n, a in [("ada", 36), ("grace", 85), ("alan", 41)]]
    + [("MATCH (p:Person) WHERE p.age < 40 OR p.name = 'grace' RETURN p.name", None),
       ("MATCH (p:Person) RETURN p.name, p.age ORDER BY p.age DESC", None),
       ("MATCH (p:Person) RETURN p.name ORDER BY p.name LIMIT 2", None)],
    "unsupported": [("FOREACH (x IN [1,2] | CREATE (:N))", None),
                    ("MATCH (n:X {p: $missing}) RETURN n", None),
                    ("BOGUS SYNTAX", None)],
}


def _run_script(graph_cls, error_cls, script):
    g = graph_cls()
    out = []
    for stmt, params in script:
        try:
            out.append(g.run(stmt, params))
        except error_cls as e:
            out.append(("raises", str(e)))
    return g, out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_property_graph_matches_jax(name, tmp_path):
    g, got = _run_script(store.PropertyGraph, store.CypherError, SCRIPTS[name])
    jg, want = _run_script(jstore.PropertyGraph, jstore.CypherError, SCRIPTS[name])
    assert got == want
    if name == "unsupported":
        assert all(isinstance(r, tuple) and r[0] == "raises" for r in got)
    assert g.schema() == jg.schema()
    assert (len(g.nodes), len(g.rels)) == (len(jg.nodes), len(jg.rels))
    g.save(str(tmp_path / "port.json"))
    jg.save(str(tmp_path / "jax.json"))
    saved = json.loads((tmp_path / "port.json").read_text())
    assert saved == json.loads((tmp_path / "jax.json").read_text())
    again = store.PropertyGraph(str(tmp_path / "port.json"))
    assert again.schema() == g.schema()


def _topics(graph_cls):
    g = graph_cls()
    g.run("CREATE (t:Topic {name: 'quantum computing'})")
    g.run("CREATE (t:Topic {name: 'biology'})")
    return g


@pytest.mark.parametrize("reply", ["MATCH (t:Topic) RETURN t.name",
                                   "```cypher\nMATCH (t:Topic) RETURN t\n```",
                                   "None", "TOTALLY (not) cypher!!"])
def test_graph_retriever_matches_jax(reply):
    backend, jbackend = StaticChatBackend(default=reply), JaxStatic(default=reply)
    got = retriever.GraphRetriever(_topics(store.PropertyGraph), backend,
                                   PromptLibrary()).retrieve("what topics exist?")
    want = jretriever.GraphRetriever(_topics(jstore.PropertyGraph), jbackend,
                                     JaxPrompts()).retrieve("what topics exist?")
    assert [(c.content, c.metadata) for c in got] == \
        [(c.content, c.metadata) for c in want]
    assert backend.calls == jbackend.calls
    schema = _topics(store.PropertyGraph).schema()
    assert retriever.format_schema(schema) == jretriever.format_schema(schema)
    assert retriever.few_shot_from_schema(schema) == jretriever.few_shot_from_schema(schema)
    assert retriever.extract_cypher(reply) == jretriever.extract_cypher(reply)


def test_csv_and_llm_ingestion_match_jax(tmp_path):
    p = tmp_path / "rows.csv"
    p.write_text("name,role,2nd col\nada,engineer,x\ngrace,admiral,\nada,engineer,x\n,,\n")
    g, jg = store.PropertyGraph(), jstore.PropertyGraph()
    assert retriever.csv_to_graph(g, str(p), label="Person") == \
        jretriever.csv_to_graph(jg, str(p), label="Person") == 3
    q = "MATCH (p:Person) RETURN p.name, p.role, p.c_2nd_col ORDER BY p.name"
    assert g.run(q) == jg.run(q) and len(g.run(q)) == 2
    reply = json.dumps([
        {"query": "MERGE (q:Quote {text: $t}) MERGE (c:Topic {name: $n}) "
                  "MERGE (q)-[:IS_PART_OF]->(c)", "parameters": {"t": "a quote", "n": "tools"}},
        {"query": "MERGE (c:Topic {name: $n})", "parameters": {"n": "tools"}},
        "not an instance"] + [{"query": f"CREATE (n:N {{i: {i}}})"} for i in range(12)])
    for text in (f"Here you go:\n{reply}", "None", "not json at all", "[1, 2"):
        for dynamic in (False, True):
            g, jg = store.PropertyGraph(), jstore.PropertyGraph()
            b, jb = StaticChatBackend(default=text), JaxStatic(default=text)
            n = retriever.text_to_graph_llm(g, b, PromptLibrary(), "doc text",
                                            dynamic_schema=dynamic)
            assert n == jretriever.text_to_graph_llm(jg, jb, JaxPrompts(), "doc text",
                                                     dynamic_schema=dynamic)
            assert b.calls == jb.calls and g.schema() == jg.schema()
            assert len(g.nodes) == len(jg.nodes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sidecar_answers_both_clients(tmp_path):
    """The port's sidecar in a subprocess; the port's urllib client and the
    JAX package's requests client get the same bodies, errors included."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ragmeup_tpu_torch.graph.sidecar", "--port", str(port),
         "--host", "127.0.0.1", "--db", str(tmp_path / "g.json")],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    ours, theirs = client.RemoteGraphClient(url), jclient.RemoteGraphClient(url)
    try:
        for _ in range(300):
            try:
                ours.schema()
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                time.sleep(0.1)
        inst = [{"query": "MERGE (t:Topic {name: $n})", "parameters": {"n": "physics"}}]
        assert ours.add_instances(inst) == theirs.add_instances(inst) == 1
        assert ours.schema() == theirs.schema()
        assert ours.schema()["node_labels"][0]["label"] == "Topic"
        q = "MATCH (t:Topic) RETURN t.name"
        assert ours.run(q) == theirs.run(q) == [{"t.name": "physics"}]
        rows = [{"name": "a", "val": "1"}, {"name": "b", "val": ""}]
        assert ours.add_csv(rows) == theirs.add_csv(rows) == 2
        assert ours.run("MATCH (r:Row) RETURN r ORDER BY r.name") == \
            theirs.run("MATCH (r:Row) RETURN r ORDER BY r.name")
        import requests
        import urllib.error
        with pytest.raises(urllib.error.HTTPError) as err:
            ours.run("BOGUS SYNTAX")
        with pytest.raises(requests.HTTPError) as jerr:
            theirs.run("BOGUS SYNTAX")
        assert err.value.code == jerr.value.response.status_code == 400
        assert json.loads(err.value.read()) == jerr.value.response.json()
        # an unknown route: the sidecar's catch-all 500, werkzeug's text
        r = requests.get(url + "/nope", timeout=10)
        assert r.status_code == 500 and r.json()["error"].startswith("404 Not Found: ")
        ours.close()
        theirs.close()
        assert json.loads((tmp_path / "g.json").read_text())["nodes"]
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    client.RemoteGraphClient(url, timeout=1).close()  # swallows the refused call


def _embed(texts, d=64):
    out = np.zeros((len(texts), d), np.float32)
    for i, t in enumerate(texts):
        for tok in analyze(t):
            out[i, zlib.crc32(tok.encode()) % d] += 1.0
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


class _Enc:
    def encode(self, texts):
        return _embed(texts)


def _graph_system(root, config_cls, system_cls, backend, **kw):
    cfg = config_cls()
    cfg.data.data_directory = str(root / "data")
    cfg.data.index_directory = str(root / "index")
    cfg.model.embedding_dim = 64
    cfg.retrieval.dense_dtype = "float32"
    cfg.retrieval.rerank = False
    cfg.pipeline.use_provenance = False
    cfg.pipeline.use_rewrite_loop = False
    cfg.graph.enabled = True
    return system_cls(cfg, encoder=_Enc(), backend=backend, **kw)


def test_graph_enabled_chat_matches_jax(tmp_path):
    """graph.enabled on the native store: a CSV upload becomes Row nodes,
    and /chat's graph retriever runs the backend's Cypher; its chunk comes
    first, as in JAX's RagSystem."""
    rules = [("graph database query assistant", "MATCH (r:Row) RETURN r.name, r.role")]
    outs = []
    for side, config_cls, system_cls, static, kw in (
            ("jax", JaxRagConfig, JaxRagSystem, JaxStatic, {}),
            ("torch", RagConfig, RagSystem, StaticChatBackend, {"device": "cpu"})):
        root = tmp_path / side
        (root / "data").mkdir(parents=True)
        (root / "data" / "fox.txt").write_text("The quick brown fox jumps over the dog.")
        backend = static(rules=rules, default="The fox jumps.")
        system = _graph_system(root, config_cls, system_cls, backend, **kw)
        csv = root / "data" / "people.csv"
        csv.write_text("name,role\nada,engineer\ngrace,admiral\n")
        added = system.add_document(str(csv))
        rows = system.graph.run("MATCH (r:Row) RETURN r.name ORDER BY r.name")
        out = system.chat("Who are the engineers?")
        del out["timings"]  # host clocks
        outs.append(json.loads(json.dumps(
            (added, rows, out, backend.calls, system.graph.schema())).replace(
                str(root), "ROOT")))
    (added, rows, out, calls, schema), want = outs[1], outs[0]
    assert added > 0
    assert rows == [{"r.name": "ada"}, {"r.name": "grace"}]
    assert out["documents"][0]["s"] == "graph_db"
    assert "engineer" in out["documents"][0]["c"]
    assert [added, rows, out, calls, schema] == want
