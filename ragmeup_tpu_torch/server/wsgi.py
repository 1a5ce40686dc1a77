"""The WSGI layer the port's HTTP apps stand on, on the standard library.

The JAX package's server and graph sidecar are written against werkzeug
(``Request``, ``Response``, ``Map``/``Rule``, ``secure_filename``,
``run_simple``). This module gives the port exactly the parts of that
surface those apps call, with werkzeug's observable behaviour:

- ``Request``: ``method``, ``path``, ``args`` (the query string's first
  values), ``get_json(force=True, silent=True)`` (the body parsed whatever
  its content type; ``None`` when it is not JSON) and ``files`` (the parts
  of a ``multipart/form-data`` body that carry a filename, parsed with
  ``email``'s HTTP policy), each with ``.filename`` and ``.save(path)``;
- ``Response(body, status, content_type, headers)``, a WSGI response
  (a HEAD request gets the headers and no body);
- ``Routes``: (path, methods) -> endpoint; an unknown path raises
  ``NotFound`` and a known one asked with another method
  ``MethodNotAllowed``, each with werkzeug's code and description (a GET
  route also answers HEAD);
- ``secure_filename``: werkzeug's rules;
- ``serve``: a threaded server (``ThreadingMixIn`` over ``wsgiref``'s
  ``WSGIServer``) that logs no request lines.
"""

from __future__ import annotations

import email.parser
import email.policy
import json
import os
import re
import socketserver
import unicodedata
from http import HTTPStatus
from typing import Dict, Iterable, Optional, Tuple
from urllib.parse import parse_qsl
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server


class HTTPError(Exception):
    code = 500
    description = "The server encountered an internal error."

    def __str__(self) -> str:
        return f"{self.code} {HTTPStatus(self.code).phrase}: {self.description}"


class NotFound(HTTPError):
    code = 404
    description = ("The requested URL was not found on the server. If you entered "
                   "the URL manually please check your spelling and try again.")


class MethodNotAllowed(HTTPError):
    code = 405
    description = "The method is not allowed for the requested URL."


class UploadedFile:
    """One file part of a multipart body."""

    def __init__(self, filename: str, data: bytes):
        self.filename = filename
        self.data = data

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.data)


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        # PEP 3333 carries the path as latin-1 code points of its bytes
        raw = environ.get("PATH_INFO", "").encode("latin-1").decode("utf-8", "replace")
        self.path = "/" + raw.lstrip("/")
        self.args: Dict[str, str] = {}
        for key, value in parse_qsl(environ.get("QUERY_STRING", ""),
                                    keep_blank_values=True):
            self.args.setdefault(key, value)
        self._data: Optional[bytes] = None
        self._files: Optional[Dict[str, UploadedFile]] = None

    def get_data(self) -> bytes:
        if self._data is None:
            try:
                n = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                n = 0
            self._data = self.environ["wsgi.input"].read(n) if n > 0 else b""
        return self._data

    def get_json(self, force: bool = True, silent: bool = True):
        """The body as JSON, whatever its content type; ``None`` when it
        does not parse (the only mode the apps use)."""
        try:
            return json.loads(self.get_data())
        except ValueError:
            return None

    @property
    def files(self) -> Dict[str, UploadedFile]:
        """Form field name -> the first file part of that name."""
        if self._files is None:
            self._files = {}
            ctype = self.environ.get("CONTENT_TYPE", "")
            if ctype.lower().startswith("multipart/form-data"):
                head = b"Content-Type: " + ctype.encode("latin-1") + b"\r\n\r\n"
                msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
                    head + self.get_data())
                if msg.is_multipart():
                    for part in msg.iter_parts():
                        filename = part.get_filename()
                        name = part.get_param("name", header="content-disposition")
                        if filename is not None and name is not None:
                            self._files.setdefault(str(name), UploadedFile(
                                filename, part.get_payload(decode=True) or b""))
        return self._files


class Response:
    def __init__(self, body=b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body.encode("utf-8") if isinstance(body, str) else bytes(body)
        self.status = status
        self.headers = [("Content-Type", content_type)]
        self.headers += list((headers or {}).items())
        self.headers.append(("Content-Length", str(len(self.body))))

    def __call__(self, environ: dict, start_response) -> Iterable[bytes]:
        start_response(f"{self.status} {HTTPStatus(self.status).phrase}", self.headers)
        if environ.get("REQUEST_METHOD", "GET").upper() == "HEAD":
            return []
        return [self.body]


class Routes:
    """Exact paths to endpoints, each with its methods (GET brings HEAD)."""

    def __init__(self, rules: Iterable[Tuple[str, str, Iterable[str]]]):
        self._rules: Dict[str, Tuple[str, set]] = {}
        for path, endpoint, methods in rules:
            allowed = {m.upper() for m in methods}
            if "GET" in allowed:
                allowed.add("HEAD")
            self._rules[path] = (endpoint, allowed)

    def match(self, request: Request) -> str:
        if request.path not in self._rules:
            raise NotFound()
        endpoint, allowed = self._rules[request.path]
        if request.method not in allowed:
            raise MethodNotAllowed()
        return endpoint


_FILENAME_STRIP = re.compile(r"[^A-Za-z0-9_.-]")
_WINDOWS_DEVICE_FILES = {"AUX", "CON", "CONIN$", "CONOUT$", "NUL", "PRN",
                         *(f"COM{c}" for c in "123456789¹²³"),
                         *(f"LPT{c}" for c in "123456789¹²³")}


def secure_filename(filename: str) -> str:
    """An ASCII-only name that is safe to join to a directory: NFKD to
    ASCII, path separators to spaces, whitespace runs to ``_``, every
    character but ``[A-Za-z0-9_.-]`` dropped, ``.`` and ``_`` stripped at
    both ends; on Windows a device name gets a leading ``_``. May be empty."""
    filename = unicodedata.normalize("NFKD", filename)
    filename = filename.encode("ascii", "ignore").decode("ascii")
    for sep in os.sep, os.path.altsep:
        if sep:
            filename = filename.replace(sep, " ")
    filename = _FILENAME_STRIP.sub("", "_".join(filename.split())).strip("._")
    if (os.name == "nt" and filename
            and filename.split(".")[0].upper() in _WINDOWS_DEVICE_FILES):
        filename = f"_{filename}"
    return filename


class _ThreadingServer(socketserver.ThreadingMixIn, WSGIServer):
    daemon_threads = True


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 (the base's name)
        pass


def serve(app, host: str, port: int) -> WSGIServer:
    """A threaded WSGI server for ``app`` bound to (host, port); port 0
    takes a free one (``server.server_port``). The caller runs
    ``serve_forever()`` (in a thread, if it goes on) and ``shutdown()``
    plus ``server_close()`` to stop it."""
    return make_server(host, port, app, server_class=_ThreadingServer,
                       handler_class=_QuietHandler)
