"""Standalone graph sidecar server (reference ``neo4j/server.py`` parity).

Serves the native PropertyGraph over the same HTTP contract the reference's
Neo4j sidecar exposes, so deployments that ran the sidecar as a separate
process (UI + cloud helper pointing at ``neo4j_location``) can switch
backends without touching the clients:

- ``GET  /schema``                     (neo4j/server.py:162-170)
- ``POST /run_query {query, parameters}``        (:172-184)
- ``POST /add_instances {instances: [...]}``     (:131-140)
- ``POST /add_csv {rows: [...], label?}``        (:143-152)
- ``GET  /close_db``                              (:154-160)

The port's copy of ``ragmeup_tpu/graph/sidecar.py`` on the standard-library
WSGI layer (``server/wsgi.py``). Run: ``python -m
ragmeup_tpu_torch.graph.sidecar --port 4000 --db graph.json``.
"""

from __future__ import annotations

import json
from typing import Optional

from ragmeup_tpu_torch.graph.retriever import _ident
from ragmeup_tpu_torch.graph.store import CypherError, PropertyGraph
from ragmeup_tpu_torch.server.wsgi import Request, Response, Routes, serve


def _json(data, status: int = 200) -> Response:
    return Response(json.dumps(data, default=str), status=status,
                    content_type="application/json")


class GraphSidecar:
    def __init__(self, graph: Optional[PropertyGraph] = None):
        self.graph = graph or PropertyGraph()
        self.routes = Routes([
            ("/schema", "schema", ["GET"]),
            ("/run_query", "run_query", ["POST"]),
            ("/add_instances", "add_instances", ["POST"]),
            ("/add_csv", "add_csv", ["POST"]),
            ("/close_db", "close_db", ["GET"]),
        ])

    def ep_schema(self, request):
        return _json(self.graph.schema())

    def ep_run_query(self, request):
        data = request.get_json(force=True, silent=True) or {}
        try:
            rows = self.graph.run(data.get("query", ""),
                                  data.get("parameters"))
            return _json({"result": rows})
        except CypherError as e:
            return _json({"error": str(e)}, 400)

    def ep_add_instances(self, request):
        data = request.get_json(force=True, silent=True) or {}
        instances = data.get("instances", [])
        try:
            n = self.graph.add_instances(instances)
            return _json({"count": n})
        except CypherError as e:
            return _json({"error": str(e)}, 400)

    def ep_add_csv(self, request):
        data = request.get_json(force=True, silent=True) or {}
        rows = data.get("rows", [])
        label = data.get("label", "Row")
        instances = []
        for row in rows:
            props = {k: v for k, v in row.items() if v not in (None, "")}
            if not props:
                continue
            pattern = ", ".join(f"{_ident(k)}: ${_ident(k)}" for k in props)
            instances.append({"query": f"MERGE (r:{label} {{{pattern}}})",
                              "parameters": {_ident(k): v for k, v in props.items()}})
        n = self.graph.add_instances(instances)
        return _json({"count": n})

    def ep_close_db(self, request):
        self.graph.save()
        return _json({"status": "closed"})

    def __call__(self, environ, start_response):
        request = Request(environ)
        try:
            endpoint = self.routes.match(request)
            response = getattr(self, f"ep_{endpoint}")(request)
        except Exception as e:  # noqa: BLE001
            response = _json({"error": str(e)}, 500)
        return response(environ, start_response)


def main():
    import argparse
    parser = argparse.ArgumentParser(description="graph sidecar")
    parser.add_argument("--port", type=int, default=4000)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--db", default="graph.json")
    args = parser.parse_args()
    app = GraphSidecar(PropertyGraph(args.db))
    serve(app, args.host, args.port).serve_forever()


if __name__ == "__main__":
    main()
