"""HTTP client for a remote graph sidecar, on ``urllib.request``.

Speaks the reference sidecar's contract (``neo4j/server.py:131-185``):
``GET /schema``, ``POST /run_query {query, parameters}``,
``POST /add_instances {instances: [{query, parameters}]}``,
``POST /add_csv``, ``GET /close_db`` — so an existing Neo4j deployment keeps
working while the native ``PropertyGraph`` is the in-process default.
Exposes the same .schema()/.run()/.add_instances() surface as
PropertyGraph, so GraphRetriever is backend-agnostic. The routes, bodies,
timeout and return values are those of ``ragmeup_tpu/graph/client.py``;
a status of 400 or above raises ``urllib.error.HTTPError``.
"""

from __future__ import annotations

import json
import urllib.request
from typing import List, Optional, Sequence


class RemoteGraphClient:
    def __init__(self, base_url: str, timeout: int = 30):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _call(self, route: str, body: Optional[dict] = None):
        """GET ``route`` (POST with a JSON body when one is given) → the
        decoded JSON reply; raises HTTPError on a status >= 400."""
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base_url + route, data=data,
            headers={} if data is None else {"Content-Type": "application/json"},
            method="GET" if data is None else "POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def schema(self) -> dict:
        return self._call("/schema")

    def run(self, query: str, parameters: Optional[dict] = None) -> List[dict]:
        body = self._call("/run_query",
                          {"query": query, "parameters": parameters or {}})
        return body.get("result", body if isinstance(body, list) else [])

    def add_instances(self, instances: Sequence[dict]) -> int:
        self._call("/add_instances", {"instances": list(instances)})
        return len(instances)

    def add_csv(self, rows: Sequence[dict]) -> int:
        self._call("/add_csv", {"rows": list(rows)})
        return len(rows)

    def close(self) -> None:
        try:
            self._call("/close_db")
        except Exception:
            pass
