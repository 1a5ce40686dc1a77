"""HTTP API server on the standard-library WSGI layer (``server/wsgi.py``).

The port's counterpart of ``ragmeup_tpu/server/app.py``: the same routes,
JSON bodies, status codes and UI pages, over the port's ``RagSystem``.
Endpoint surface (a superset of the reference's ``server/server.py:149-394``):

- ``POST /chat``            — main inference; request ``{prompt, history,
  docs}`` → response ``{reply, history, documents, rewritten, question,
  fetched_new_documents}`` (server.py:238-303). Client-held docs round-trip
  when no new fetch happens (the UI owns RAG state — SURVEY.md §2.2 #13).
- ``POST /add_document``    — multipart upload → data dir → incremental
  index (server.py:149-180).
- ``GET  /get_documents``   — data-dir listing filtered by file_types
  (server.py:306-324).
- ``POST /get_document``    — file download (server.py:327-350).
- ``POST /delete``          — delete by filename from indexes + disk
  (server.py:353-385: tombstone + persist).
- ``POST /deepeval_evaluate`` — generative eval harness (server.py:183-235).
- ``GET  /health``, ``GET /stats`` — liveness + per-stage counters.
- ``GET /``, ``GET /add``, ``POST /search``, ``POST|GET /feedback`` — the
  web UI (``server/ui.py``).

``python -m ragmeup_tpu_torch.server --env-file .env --port 5000`` serves it
on the card (``--device cpu`` without one). The server is threaded, so
concurrent /chat requests reach ``RagSystem.chat`` at once: the retrieval
path only reads, the dense decode loop keeps its state per call, and the
batched backend (``server.batched_llm``) queues them into its waves.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Optional

from ragmeup_tpu_torch.eval.generative import evaluate_pairs, generate_qa_pairs
from ragmeup_tpu_torch.pipeline.system import RagSystem
from ragmeup_tpu_torch.server import ui
from ragmeup_tpu_torch.server.wsgi import (HTTPError, NotFound, Request, Response,
                                           Routes, secure_filename, serve)

logger = logging.getLogger("ragmeup_tpu_torch.server")


def _json(data, status: int = 200) -> Response:
    return Response(json.dumps(data), status=status,
                    content_type="application/json")


class RagServer:
    def __init__(self, system: RagSystem, ui_db: Optional[str] = None):
        self.system = system
        self.feedback = ui.FeedbackStore(
            ui_db or os.path.join(system.cfg.data.index_directory, "ui.db"))
        self.stats = {"requests": 0, "chat_requests": 0, "errors": 0,
                      "chat_latency_ms_sum": 0.0, "started_at": time.time()}
        self._stats_lock = threading.Lock()  # the server is threaded
        self.routes = Routes([
            ("/chat", "chat", ["POST"]),
            ("/add_document", "add_document", ["POST"]),
            ("/get_documents", "get_documents", ["GET"]),
            ("/get_document", "get_document", ["POST"]),
            ("/delete", "delete", ["POST"]),
            ("/deepeval_evaluate", "deepeval_evaluate", ["POST"]),
            ("/health", "health", ["GET"]),
            ("/stats", "stats", ["GET"]),
            # UI surface (Scala Play UI parity, SURVEY.md §2.2)
            ("/", "index", ["GET"]),
            ("/add", "add_page", ["GET"]),
            ("/search", "search", ["POST"]),
            ("/feedback", "feedback", ["POST", "GET"]),
        ])

    def _count(self, **inc) -> None:
        with self._stats_lock:
            for key, value in inc.items():
                self.stats[key] += value

    # -- endpoints ---------------------------------------------------------------

    def ep_chat(self, request: Request) -> Response:
        data = request.get_json(force=True, silent=True) or {}
        prompt = data.get("prompt")
        if not prompt:
            return _json({"error": "prompt is required"}, 400)
        history = data.get("history", []) or []
        original_docs = data.get("docs", []) or []
        t0 = time.perf_counter()
        out = self.system.chat(prompt, history)
        latency = (time.perf_counter() - t0) * 1e3
        self._count(chat_requests=1, chat_latency_ms_sum=latency)
        documents = out["documents"] if out["fetched_new_documents"] else original_docs
        return _json({
            "reply": out["reply"],
            "history": out["history"],
            "documents": documents,
            "rewritten": out["rewritten"],
            "question": out["question"],
            "fetched_new_documents": out["fetched_new_documents"],
        })

    def ep_add_document(self, request: Request) -> Response:
        if "file" not in request.files:
            return _json({"error": "No file part in the request"}, 400)
        file = request.files["file"]
        if not file.filename:
            return _json({"error": "No file selected"}, 400)
        filename = secure_filename(file.filename)
        data_dir = self.system.cfg.data.data_directory
        os.makedirs(data_dir, exist_ok=True)
        location = os.path.join(data_dir, filename)
        file.save(location)
        n = self.system.add_document(location)
        return _json({"filename": filename, "chunks": n})

    @staticmethod
    def _resolve_in_dir(data_dir: str, filename: str) -> str | None:
        """Resolve a client-supplied relative path inside data_dir.
        Ingestion walks subdirectories, so listings return relative paths;
        this accepts them while refusing any path that escapes the data
        directory (absolute paths, '..', symlink-free normalization)."""
        if not filename:
            return None
        rel = filename.replace("\\", "/").lstrip("/")
        base = os.path.abspath(data_dir)
        resolved = os.path.abspath(os.path.normpath(os.path.join(base, rel)))
        if resolved != base and not resolved.startswith(base + os.sep):
            return None
        # the path in data_dir's original (possibly relative) form: chunk
        # sources are recorded that way at ingest, and delete_source
        # matches by exact string
        return os.path.normpath(os.path.join(data_dir, rel))

    def ep_get_documents(self, request: Request) -> Response:
        d = self.system.cfg.data
        exts = {t.lower().lstrip(".") for t in d.file_types}
        files = []
        if os.path.isdir(d.data_directory):
            # recursive, matching ingestion's walk (data/loaders.py)
            for root, _dirs, names in os.walk(d.data_directory):
                for f in names:
                    if os.path.splitext(f)[1][1:].lower() in exts:
                        files.append(os.path.relpath(
                            os.path.join(root, f), d.data_directory))
        return _json(sorted(files))

    def ep_get_document(self, request: Request) -> Response:
        data = request.get_json(force=True, silent=True) or {}
        filename = data.get("filename", "")
        data_dir = self.system.cfg.data.data_directory
        path = self._resolve_in_dir(data_dir, filename)
        if path is None or not os.path.isfile(path):
            return _json({"error": "File not found"}, 404)
        with open(path, "rb") as f:
            body = f.read()
        # header built from the sanitized basename actually served: the
        # raw client string could carry quotes and corrupt the header
        safe_name = secure_filename(os.path.basename(path)) or "document"
        return Response(body, content_type="application/octet-stream",
                        headers={"Content-Disposition":
                                 f'attachment; filename="{safe_name}"'})

    def ep_delete(self, request: Request) -> Response:
        data = request.get_json(force=True, silent=True) or {}
        filename = data.get("filename", "")
        data_dir = self.system.cfg.data.data_directory
        path = self._resolve_in_dir(data_dir, filename)
        if path is None or not os.path.isfile(path):
            return _json({"error": "File not found"}, 404)
        count = self.system.delete_document(path)
        os.remove(path)
        return _json({"count": count})

    def ep_deepeval_evaluate(self, request: Request) -> Response:
        data = request.get_json(force=True, silent=True) or {}
        sample_size = int(data.get("sample_size", self.system.cfg.eval.sample_size))
        qa_count = int(data.get("qa_pairs", self.system.cfg.eval.qa_pairs))
        pairs = generate_qa_pairs(self.system, sample_size, qa_count,
                                  seed=int(data.get("seed", 0)))
        results = evaluate_pairs(self.system, pairs)
        return _json({"evaluation_results": results})

    # -- UI endpoints -------------------------------------------------------------

    def ep_index(self, request: Request) -> Response:
        return Response(ui.chat_page(), content_type="text/html; charset=utf-8")

    def ep_add_page(self, request: Request) -> Response:
        return Response(ui.add_page(), content_type="text/html; charset=utf-8")

    def ep_search(self, request: Request) -> Response:
        """UI-style chat: {query, history, docs, session_id} → same contract
        as /chat (HomeController.search forwards query→prompt,
        HomeController.scala:41-58), with chat logging."""
        data = request.get_json(force=True, silent=True) or {}
        query = data.get("query") or data.get("prompt")
        if not query:
            return _json({"error": "query is required"}, 400)
        history = data.get("history", []) or []
        original_docs = data.get("docs", []) or []
        out = self.system.chat(query, history)
        documents = out["documents"] if out["fetched_new_documents"] else original_docs
        session_id = data.get("session_id", "")
        if session_id:
            try:
                self.feedback.log_chat(
                    session_id, len(out["history"]) - 1, query, "user",
                    out["reply"], documents, out["rewritten"],
                    out["question"], out["fetched_new_documents"])
            except Exception:
                logger.exception("chat log failed")
        return _json({
            "reply": out["reply"], "history": out["history"],
            "documents": documents, "rewritten": out["rewritten"],
            "question": out["question"],
            "fetched_new_documents": out["fetched_new_documents"],
        })

    def ep_feedback(self, request: Request) -> Response:
        """Persist thumbs feedback (the reference stubs this:
        HomeController.scala:155-157 returns {})."""
        if request.method == "GET":
            return _json(self.feedback.get_feedback(
                request.args.get("chat_id")))
        data = request.get_json(force=True, silent=True) or {}
        chat_id = data.get("chat_id")
        if not chat_id:
            return _json({})  # reference-compatible empty reply
        self.feedback.add_feedback(chat_id,
                                   int(data.get("message_offset", 0)),
                                   int(data.get("feedback", 0)))
        return _json({"status": "ok"})

    def ep_health(self, request: Request) -> Response:
        return _json({"status": "ok", "chunks": len(self.system.store),
                      "uptime_s": time.time() - self.stats["started_at"]})

    def ep_stats(self, request: Request) -> Response:
        with self._stats_lock:
            s = dict(self.stats)
        if s["chat_requests"]:
            s["chat_latency_ms_avg"] = s["chat_latency_ms_sum"] / s["chat_requests"]
        # per-request TTFT / decode tok/s percentiles from the batched
        # serving backend
        be = getattr(self.system, "backend", None)
        if be is not None and hasattr(be, "latency_stats"):
            s["generation"] = be.latency_stats()
        # prefix-cache effectiveness (hash-block KV reuse)
        eng = getattr(be, "engine", None)
        if eng is not None and getattr(eng, "prefix_cache", False):
            s["prefix_cache"] = {
                "lookups": eng.cache.prefix_lookups,
                "page_hits": eng.cache.prefix_hits,
                "registered_pages": len(eng.cache.registry)}
        return _json(s)

    # -- wsgi --------------------------------------------------------------------

    def __call__(self, environ, start_response):
        request = Request(environ)
        self._count(requests=1)
        try:
            endpoint = self.routes.match(request)
            response = getattr(self, f"ep_{endpoint}")(request)
        except NotFound:
            response = _json({"error": "not found"}, 404)
        except HTTPError as e:
            response = _json({"error": e.description}, e.code)
        except Exception as e:  # noqa: BLE001
            logger.exception("request failed")
            self._count(errors=1)
            response = _json({"error": str(e)}, 500)
        return response(environ, start_response)


def create_wsgi_app(cfg=None, system: Optional[RagSystem] = None,
                    device=None) -> RagServer:
    """A RagServer over ``system``, or over a RagSystem built from ``cfg``
    (``.env`` when neither is given) on ``device`` (the card by default)."""
    if system is None:
        from ragmeup_tpu_torch.config import load_config
        cfg = cfg or load_config(env_file=".env")
        system = RagSystem(cfg, device=device)
    return RagServer(system)


def main(argv=None):
    import argparse
    from ragmeup_tpu_torch.config import load_config
    from ragmeup_tpu_torch.devices import resolve_device
    parser = argparse.ArgumentParser(description="ragmeup_tpu_torch server")
    parser.add_argument("--env-file", default=".env")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' without a card)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"ragmeup_tpu_torch.server: {e}")
    if device.type == "cuda":
        import torch
        from ragmeup_tpu_torch import kernels
        logger.info("device: %s", torch.cuda.get_device_name(device))
        # build the kernels before serving, so the first /chat does not
        # wait for nvcc
        t0 = time.perf_counter()
        kernels.lib()
        logger.info("kernels ready in %.1f s (%s)", time.perf_counter() - t0,
                    kernels.library_path())
    else:
        logger.info("device: %s", device)
    cfg = load_config(env_file=args.env_file)
    if args.host:
        cfg.server.host = args.host
    if args.port:
        cfg.server.port = args.port
    app = create_wsgi_app(cfg, device=device)
    server = serve(app, cfg.server.host, cfg.server.port)
    logger.info("serving on http://%s:%d", cfg.server.host, server.server_port)
    # SIGTERM stops the serve loop (shutdown waits for it, so from another
    # thread) and the process exits 0 after closing the socket
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=server.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
