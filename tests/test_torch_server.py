"""The port's HTTP layer against the JAX package's.

The same tiny system is built twice, once as the JAX package's
``RagSystem`` + ``RagServer`` and once as the port's (on the CPU), each over
its own copy of one data directory; werkzeug's test client sends both the
same requests, and every route must answer with the same status and JSON
(the clocks masked), the UI pages byte for byte. Each app runs with the
working directory set to its own root and relative data paths, so that
document sources read alike. Embeddings come from a stable hash
(``zlib.crc32``), so replies and documents do not move between runs. Also:
the standard-library layer (``server/wsgi.py``) against werkzeug's
``secure_filename``, multipart parser and ``get_json``; concurrent /chat
requests on the threaded ``wsgi.serve``; ``compact`` and
``list_documents``; the batched backend's /stats.
"""

import io
import json
import os
import sqlite3
import threading
import urllib.request
import zlib

import numpy as np
import pytest
from werkzeug.test import Client, EnvironBuilder
from werkzeug.utils import secure_filename as wz_secure_filename
from werkzeug.wrappers import Request as WzRequest

from ragmeup_tpu.config import RagConfig as JaxRagConfig
from ragmeup_tpu.pipeline.llm_backends import StaticChatBackend as JaxStatic
from ragmeup_tpu.pipeline.system import RagSystem as JaxRagSystem
from ragmeup_tpu.server.app import RagServer as JaxRagServer
from ragmeup_tpu_torch.config import RagConfig
from ragmeup_tpu_torch.pipeline.llm_backends import StaticChatBackend
from ragmeup_tpu_torch.pipeline.system import RagSystem
from ragmeup_tpu_torch.retrieval.sparse import analyze
from ragmeup_tpu_torch.server import wsgi
from ragmeup_tpu_torch.server.app import RagServer
import torch_cpu  # noqa: F401  (torch on one thread: tests/torch_cpu.py)

CORPUS = [
    ("fox.txt", "The quick brown fox jumps over the lazy dog."),
    ("tpu.txt", "TPU chips use a systolic array called the MXU for matmuls."),
    ("fin.txt", "Stock markets rallied on strong tech earnings."),
]
RULES = [("Generate a question", "What does the fox do?"),
         ("Answer the following question", "The fox jumps over the dog.")]
MASKED = ("uptime_s", "started_at", "chat_latency_ms_sum", "chat_latency_ms_avg")


def _embed(texts, d=64):
    out = np.zeros((len(texts), d), np.float32)
    for i, t in enumerate(texts):
        for tok in analyze(t):
            out[i, zlib.crc32(tok.encode()) % d] += 1.0
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


class _Enc:
    def encode(self, texts):
        return _embed(texts)


def _config(config_cls):
    cfg = config_cls()
    cfg.data.data_directory = "data"
    cfg.data.index_directory = "index"
    cfg.model.embedding_dim = 64
    cfg.retrieval.dense_dtype = "float32"
    cfg.retrieval.rerank = False
    cfg.pipeline.use_provenance = False
    cfg.pipeline.use_rewrite_loop = False
    return cfg


def _masked(value):
    if isinstance(value, dict):
        return {k: ("masked" if k in MASKED else _masked(v)) for k, v in value.items()}
    if isinstance(value, list):
        return [_masked(v) for v in value]
    if isinstance(value, float):
        return round(value, 5)
    return value


class Pair:
    """The JAX app and the port's, each in its own root directory."""

    def __init__(self, tmp_path, monkeypatch):
        self.monkeypatch = monkeypatch
        self.roots, self.systems, self.clients = {}, {}, {}
        for side, config_cls, system_cls, server_cls, static, kw in (
                ("jax", JaxRagConfig, JaxRagSystem, JaxRagServer, JaxStatic, {}),
                ("torch", RagConfig, RagSystem, RagServer, StaticChatBackend,
                 {"device": "cpu"})):
            root = tmp_path / side
            (root / "data").mkdir(parents=True)
            for name, text in CORPUS:
                (root / "data" / name).write_text(text)
            self.roots[side] = root
            self.at(side)
            backend = static(rules=RULES, default="The fox jumps over the lazy dog.")
            system = system_cls(_config(config_cls), encoder=_Enc(), backend=backend, **kw)
            self.systems[side] = system
            self.clients[side] = Client(server_cls(system))

    def at(self, side):
        self.monkeypatch.chdir(self.roots[side])

    def write(self, rel, text):
        for root in self.roots.values():
            os.makedirs(os.path.dirname(root / rel), exist_ok=True)
            (root / rel).write_text(text)

    def both(self, method, path, status=None, **kw):
        """The same request to both apps; their statuses and bodies must
        agree. Returns the port's response."""
        out = {}
        for side in ("jax", "torch"):
            self.at(side)
            args = {k: (v() if callable(v) else v) for k, v in kw.items()}
            out[side] = getattr(self.clients[side], method)(path, **args)
        rj, rt = out["jax"], out["torch"]
        assert rt.status_code == rj.status_code, (path, rt.data, rj.data)
        if status is not None:
            assert rt.status_code == status, (path, rt.data)
        assert rt.headers.get("Content-Type") == rj.headers.get("Content-Type")
        assert rt.headers.get("Content-Disposition") == rj.headers.get("Content-Disposition")
        if method == "head":
            assert rt.data == rj.data == b""
        elif rj.headers.get("Content-Type") == "application/json":
            assert _masked(rt.get_json()) == _masked(rj.get_json()), path
        else:
            assert rt.data == rj.data, path
        return rt


@pytest.fixture
def pair(tmp_path, monkeypatch):
    return Pair(tmp_path, monkeypatch)


def test_chat_two_turns_and_docs_passthrough(pair):
    first = pair.both("post", "/chat", 200, json={"prompt": "what does the fox do?"}).get_json()
    assert first["fetched_new_documents"] is True
    assert first["documents"][0]["s"] == "data/fox.txt"
    second = pair.both("post", "/chat", 200, json={
        "prompt": "and the markets?", "history": first["history"],
        "docs": first["documents"]}).get_json()
    assert second["history"][-1]["role"] == "assistant"
    client_docs = [{"s": "held.txt", "c": "client-held"}]
    third = pair.both("post", "/chat", 200, json={
        "prompt": "more", "history": second["history"], "docs": client_docs}).get_json()
    assert third["fetched_new_documents"] is False and third["documents"] == client_docs


def test_chat_refuses_missing_and_malformed_prompts(pair):
    pair.both("post", "/chat", 400, json={})
    pair.both("post", "/chat", 400, data="not json", content_type="text/plain")
    pair.both("post", "/chat", 400, data=b"\xff\xfe{", content_type="application/json")
    pair.both("post", "/chat", 400, json={"prompt": ""})
    pair.both("post", "/search", 400, json={})


def test_get_documents_in_subdirectories(pair):
    pair.write("data/nested/deep.txt", "Coral reefs shelter a quarter of marine species.")
    pair.write("data/skip.bin", "binary")
    for side, system in pair.systems.items():
        pair.at(side)
        system.add_document(os.path.join("data", "nested", "deep.txt"))
    names = pair.both("get", "/get_documents", 200).get_json()
    assert names == ["fin.txt", "fox.txt", "nested/deep.txt", "tpu.txt"]
    r = pair.both("post", "/get_document", 200, json={"filename": "nested/deep.txt"})
    assert b"Coral reefs" in r.data
    assert r.headers["Content-Disposition"] == 'attachment; filename="deep.txt"'
    assert pair.both("post", "/delete", 200,
                     json={"filename": "nested/deep.txt"}).get_json()["count"] > 0
    pair.both("get", "/get_documents", 200)


def test_get_document_found_missing_and_sanitized(pair):
    r = pair.both("post", "/get_document", 200, json={"filename": "fox.txt"})
    assert b"quick brown fox" in r.data
    pair.both("post", "/get_document", 404, json={"filename": "nope.txt"})
    pair.write('data/we"ird ü.txt', "odd name")
    r = pair.both("post", "/get_document", 200, json={"filename": 'we"ird ü.txt'})
    assert r.headers["Content-Disposition"] == 'attachment; filename="weird_u.txt"'


def test_path_traversal_rejected(pair):
    pair.write("secret.txt", "do not serve")
    for name in ("../secret.txt", "..%2Fsecret.txt", "/etc/passwd",
                 "nested/../../secret.txt", "", "data/../../secret.txt"):
        pair.both("post", "/get_document", 404, json={"filename": name})
        pair.both("post", "/delete", 404, json={"filename": name})


def _upload(name, text):
    return lambda: {"file": (io.BytesIO(text.encode()), name)}


def test_add_then_delete_document(pair):
    r = pair.both("post", "/add_document", 200,
                  data=_upload("../quan tum.txt", "Quantum qubits enable superposition."))
    assert r.get_json()["filename"] == "quan_tum.txt" and r.get_json()["chunks"] > 0
    assert "quan_tum.txt" in pair.both("get", "/get_documents", 200).get_json()
    docs = pair.both("post", "/chat", 200,
                     json={"prompt": "quantum qubits superposition"}).get_json()["documents"]
    assert any(d["s"].endswith("quan_tum.txt") for d in docs)
    assert pair.both("post", "/delete", 200,
                     json={"filename": "quan_tum.txt"}).get_json()["count"] > 0
    pair.both("post", "/chat", 200, json={"prompt": "quantum qubits superposition"})
    pair.both("post", "/delete", 404, json={"filename": "quan_tum.txt"})
    pair.both("post", "/delete", 404, json={"filename": "ghost.txt"})
    err = pair.both("post", "/add_document", 400, data=_upload("", "x")).get_json()
    assert err == {"error": "No file selected"}
    err = pair.both("post", "/add_document", 400, data={"other": "v"}).get_json()
    assert err == {"error": "No file part in the request"}
    pair.both("post", "/add_document", 400, json={"file": "x"})


def test_unknown_route_and_wrong_method(pair):
    assert pair.both("get", "/nope", 404).get_json() == {"error": "not found"}
    pair.both("post", "/chat/", 404)
    err = pair.both("get", "/chat", 405).get_json()
    assert err == {"error": "The method is not allowed for the requested URL."}
    pair.both("post", "/health", 405)
    pair.both("delete", "/feedback", 405)
    pair.both("put", "/", 405)
    pair.both("head", "/health", 200)


def test_deepeval_route(pair):
    body = pair.both("post", "/deepeval_evaluate", 200,
                     json={"sample_size": 3, "qa_pairs": 2}).get_json()
    res = body["evaluation_results"]
    assert len(res["pairs"]) == 2 and "answer_relevancy" in res["summary"]
    pair.both("post", "/deepeval_evaluate", 200, json={"sample_size": 2, "qa_pairs": 1,
                                                        "seed": 5})


def test_ui_pages_search_and_feedback(pair):
    r = pair.both("get", "/", 200)
    assert b"chathistory" in r.data
    assert r.headers["Content-Type"] == "text/html; charset=utf-8"
    assert b"Upload" in pair.both("get", "/add", 200).data
    body = pair.both("post", "/search", 200, json={
        "query": "what does the fox do?", "history": [], "docs": [],
        "session_id": "sess-1"}).get_json()
    assert body["reply"] and body["documents"]
    pair.both("post", "/search", 200, json={"prompt": "fox?", "session_id": "sess-2"})
    assert pair.both("post", "/feedback", 200, json={
        "chat_id": "sess-1", "message_offset": 1, "feedback": 1}).get_json() == {"status": "ok"}
    pair.both("post", "/feedback", 200, json={"chat_id": "sess-2", "feedback": -1})
    assert pair.both("get", "/feedback?chat_id=sess-1", 200).get_json() == \
        [{"chat_id": "sess-1", "message_offset": 1, "feedback": 1}]
    assert len(pair.both("get", "/feedback", 200).get_json()) == 2
    pair.both("get", "/feedback?chat_id=", 200)
    assert pair.both("post", "/feedback", 200, json={}).get_json() == {}
    rows = {}
    for side in pair.systems:
        pair.at(side)
        with sqlite3.connect(os.path.join("index", "ui.db")) as c:
            rows[side] = c.execute("SELECT id, message_offset, text, role, reply, documents, "
                                   "rewritten, question, fetched_new_documents "
                                   "FROM chat_logs ORDER BY id").fetchall()
            schema = c.execute("SELECT sql FROM sqlite_master ORDER BY name").fetchall()
            rows[side + " schema"] = schema
    assert rows["torch"] == rows["jax"] and len(rows["torch"]) == 2
    assert rows["torch schema"] == rows["jax schema"]


def test_health_and_stats(pair):
    health = pair.both("get", "/health", 200).get_json()
    assert health["chunks"] == 3
    pair.both("post", "/chat", 200, json={"prompt": "fox?"})
    pair.both("get", "/nope", 404)
    stats = pair.both("get", "/stats", 200).get_json()
    assert stats["chat_requests"] == 1 and stats["requests"] == 4
    assert "chat_latency_ms_avg" in stats and "generation" not in stats


def test_ui_pages_byte_equal():
    from ragmeup_tpu.server import ui as jui
    from ragmeup_tpu_torch.server import ui
    assert ui.chat_page() == jui.chat_page() and ui.add_page() == jui.add_page()
    assert ui._SCHEMA == jui._SCHEMA


def test_compact_and_list_documents_match_jax(pair):
    pair.write("data/volcano.txt", "Volcanoes erupt molten lava and ash into the sky.")
    out = {}
    for side, system in pair.systems.items():
        pair.at(side)
        added = system.add_document(os.path.join("data", "volcano.txt"))
        deleted = system.delete_document(os.path.join("data", "fin.txt"))
        before = system.list_documents()
        system.compact()
        docs = system.chat("volcanoes lava")["documents"]
        out[side] = (added, deleted, before, system.list_documents(), len(system.store),
                     system.dense.n, system.sparse.n, [(d["s"], d["pk"]) for d in docs])
    assert out["torch"] == out["jax"]
    assert out["torch"][5] == 3 and out["torch"][7][0][0] == "data/volcano.txt"


# -- the standard-library layer against werkzeug ---------------------------------

@pytest.mark.parametrize("name", [
    "My cool movie.mov", "../../../etc/passwd", "i contain cool \xfcml\xe4uts.txt",
    "CON", "con.txt", " .hidden", "..", "", "__init__.py_", "a\\b/c d\te.tar.gz",
    "ｆｕｌｌｗｉｄｔｈ.txt", "日本語.txt", 'we"ird.txt', "-dash-.txt"])
def test_secure_filename_matches_werkzeug(name):
    assert wsgi.secure_filename(name) == wz_secure_filename(name)


@pytest.mark.parametrize("filename", ["x.txt", "tést ü.txt", "", "../../etc/passwd"])
def test_multipart_and_json_parse_as_werkzeug(filename):
    payload = b"a\r\nb\x00\xff\r\n--x\r\n" + bytes(range(256))
    env = EnvironBuilder(path="/add_document", method="POST", query_string="a=1&a=2&b=",
                         data={"file": (io.BytesIO(payload), filename),
                               "other": "v"}).get_environ()
    body = env["wsgi.input"].read()
    ours = wsgi.Request(dict(env, **{"wsgi.input": io.BytesIO(body)}))
    theirs = WzRequest(dict(env, **{"wsgi.input": io.BytesIO(body)}))
    assert sorted(ours.files) == sorted(theirs.files) == ["file"]
    assert ours.files["file"].filename == theirs.files["file"].filename
    assert ours.files["file"].data == theirs.files["file"].read() == payload
    assert ours.args == dict(theirs.args) and ours.path == theirs.path
    assert (ours.method, ours.get_json()) == ("POST", None)
    for data, ctype in ((b'{"a": [1, 2]}', "text/plain"), (b"not json", "application/json"),
                        (b"", "application/json"), ("é".encode("latin-1"), "text/plain"),
                        (b"null", "application/json")):
        env = EnvironBuilder(method="POST", data=data, content_type=ctype).get_environ()
        body = env["wsgi.input"].read()
        ours = wsgi.Request(dict(env, **{"wsgi.input": io.BytesIO(body)}))
        theirs = WzRequest(dict(env, **{"wsgi.input": io.BytesIO(body)}))
        assert ours.get_json(force=True, silent=True) == \
            theirs.get_json(force=True, silent=True)
        assert ours.files == {}


def _tiny_llm_system(root):
    """The port's RagSystem on the CPU with a tiny random decoder (sampled:
    its greedy stream repeats a special id, which decodes to no text)."""
    from ragmeup_tpu_torch.models.decoder import LlamaConfig, LocalLLM
    from ragmeup_tpu_torch.models.tokenizer import SimpleTokenizer
    (root / "data").mkdir(parents=True)
    for name, text in CORPUS:
        (root / "data" / name).write_text(text)
    cfg = _config(RagConfig)
    cfg.data.data_directory = str(root / "data")
    cfg.data.index_directory = str(root / "index")
    cfg.generation.temperature = 1.0
    cfg.generation.max_new_tokens = 6
    lcfg = LlamaConfig.tiny(dtype="float32")
    llm = LocalLLM(lcfg, SimpleTokenizer(lcfg.vocab_size), seed=0, device="cpu")
    return RagSystem(cfg, encoder=_Enc(), llm=llm, device="cpu")


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_threaded_server_answers_concurrent_chats_as_sequential(tmp_path):
    """Two /chat requests at once on wsgi.serve, over the dense decode loop
    of one LocalLLM, get the replies two requests one after the other get."""
    server = wsgi.serve(RagServer(_tiny_llm_system(tmp_path)), "127.0.0.1", 0)
    worker = threading.Thread(target=server.serve_forever, daemon=True)
    worker.start()
    url = f"http://127.0.0.1:{server.server_port}/chat"
    prompts = ["what does the fox do?", "what do markets do?"]
    try:
        sequential = [_post(url, {"prompt": p}) for p in prompts]
        concurrent = [None, None]

        def one(i):
            concurrent[i] = _post(url, {"prompt": prompts[i]})
        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_port}/stats") as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    assert all(status == 200 and body["reply"] for status, body in sequential)
    assert concurrent == sequential
    assert stats["chat_requests"] == 4 and stats["requests"] == 5


def test_batched_server_stats_match_jax(tmp_path, monkeypatch):
    """test_server_with_batched_llm_backend's setup on both packages (tiny
    f32 decoder, 64 pages of 16 tokens, 8 pages a sequence), greedy and
    plain waves: the port's /chat replies equal JAX's, three of them sent
    at once get the same, and /stats carries the same keys, generation
    percentiles and prefix-cache counters included."""
    from ragmeup_tpu.models import decoder as jdec
    from ragmeup_tpu.models import tokenizer as jtok
    from ragmeup_tpu.pipeline.serving import BatchedChatBackend as JaxBatched
    from ragmeup_tpu_torch.models import convert, decoder, tokenizer
    from ragmeup_tpu_torch.pipeline.serving import BatchedChatBackend
    import jax
    from flax import linen as nn
    kw = dict(num_pages=64, page_size=16, max_pages_per_seq=8, spec_draft=0)
    jcfg = jdec.LlamaConfig.tiny(dtype="float32")
    jllm = jdec.LocalLLM(jcfg, jtok.SimpleTokenizer(jcfg.vocab_size), seed=0)
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jllm.params))
    tcfg = decoder.LlamaConfig.tiny(dtype="float32")
    tllm = decoder.LocalLLM(tcfg, tokenizer.SimpleTokenizer(tcfg.vocab_size),
                            params=convert.flax_to_state_dict(params), device="cpu")
    bodies, backends = {}, []
    for side, config_cls, system_cls, server_cls, backend in (
            ("jax", JaxRagConfig, JaxRagSystem, JaxRagServer, JaxBatched(jllm, **kw)),
            ("torch", RagConfig, RagSystem, RagServer, BatchedChatBackend(tllm, **kw))):
        backends.append(backend)
        cfg = _config(config_cls)  # relative paths: the prompts quote sources
        root = tmp_path / side
        (root / "data").mkdir(parents=True)
        for name, text in CORPUS:
            (root / "data" / name).write_text(text)
        monkeypatch.chdir(root)
        cfg.generation.max_new_tokens = 4
        cfg.generation.temperature = 0.0
        extra = {} if side == "jax" else {"device": "cpu"}
        c = Client(server_cls(system_cls(cfg, encoder=_Enc(), backend=backend, **extra)))
        prompts = [f"question number {i} about foxes" for i in range(3)]
        replies = [c.post("/chat", json={"prompt": p}).get_json()["reply"] for p in prompts]
        bodies[side] = {"replies": replies, "stats": c.get("/stats").get_json()}
        if side == "torch":
            together = [None] * 3

            def hit(i):
                together[i] = c.post("/chat", json={"prompt": prompts[i]}).get_json()
            threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
            assert [r["reply"] for r in together] == replies
            assert all(r["documents"] for r in together)
    for backend in backends:
        backend.stop()
    assert bodies["torch"]["replies"] == bodies["jax"]["replies"]
    s, js = bodies["torch"]["stats"], bodies["jax"]["stats"]
    assert set(s) == set(js) and set(s["generation"]) == set(js["generation"])
    assert s["prefix_cache"] == js["prefix_cache"] and s["prefix_cache"]["lookups"] >= 3
    assert s["generation"]["completed"] == js["generation"]["completed"] >= 3
