"""JSON-over-HTTP handler plumbing for the port's serve main (its own copy
of the part of the JAX package's utils/httpjson.py that the serve surface
uses).

Contract: route functions take a parsed-JSON dict and return a JSON-able
dict, or an ITERATOR of dicts for an NDJSON stream (one flushed line each;
the closed connection ends the body, and a client disconnect close()s the
iterator so a generator route can clean up in its finally). KeyError,
ValueError, TypeError and AttributeError map to 400 with
{"status": "error", "error": ...}; `StatusError` picks its own code (429,
503, ...) and optional Retry-After; unknown paths are 404. GET routes get
the parsed query string. Every route's dict carries the request's headers
under the reserved "_headers" key (lower-cased names), written after the
body is parsed, so a client cannot forge them through the JSON body; the
serve main reads `traceparent` there. With a bearer token
(`resolve_auth_token`) every route but /health answers 401 to a request
without it.

The handler holds its routes as an instance attribute handed in by the
server (`make_json_handler` returns a partial of one module-level class),
so no class object closes over the routes: a server that is dropped frees
the service behind its routes without waiting for the cycle collector.
"""

from __future__ import annotations

import functools
import hmac
import json
import os
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, NamedTuple, Optional
from urllib.parse import parse_qs, urlsplit

Route = Callable[[Dict[str, Any]], Any]

_BAD_REQUEST = (KeyError, ValueError, TypeError, AttributeError)
MAX_BODY_BYTES = 16 * 1024 * 1024


class StatusError(Exception):
    """Raise from a route to reply with a specific HTTP status code;
    `retry_after` (seconds) adds a Retry-After header and `reason` a
    machine-readable cause in the error body."""

    def __init__(self, code: int, message: str,
                 retry_after: Optional[float] = None,
                 reason: Optional[str] = None):
        super().__init__(message)
        self.code = int(code)
        self.retry_after = retry_after
        self.reason = reason


def resolve_auth_token(cli_value: str = "") -> str:
    """The shared bearer token: --auth-token, else $KTWE_AUTH_TOKEN, else
    the contents of the file at $KTWE_AUTH_TOKEN_FILE (a mounted Secret).
    Empty means auth is off. A token file that is set but unreadable
    raises, so the service does not start without the auth it was given."""
    if cli_value:
        return cli_value
    env = os.environ.get("KTWE_AUTH_TOKEN", "")
    if env:
        return env
    path = os.environ.get("KTWE_AUTH_TOKEN_FILE", "")
    if path:
        with open(path) as f:
            return f.read().strip()
    return ""


class Routes(NamedTuple):
    post: Dict[str, Route]
    get: Dict[str, Route]
    auth_token: str


def make_json_handler(post_routes: Dict[str, Route],
                      get_routes: Optional[Dict[str, Route]] = None,
                      auth_token: str = ""):
    """Request handler factory serving the given routes (pass it to an
    HTTP server as its handler class). /health is served unless given,
    and stays open when `auth_token` asks every other request for
    `Authorization: Bearer <token>`."""
    gets = dict(get_routes or {})
    gets.setdefault("/health", lambda _req: {"status": "ok"})
    return functools.partial(
        JsonHandler, routes=Routes(dict(post_routes), gets, auth_token))


class JsonHandler(BaseHTTPRequestHandler):
    """Serves the `Routes` it is built with (see `make_json_handler`)."""

    def __init__(self, request, client_address, server, *, routes: Routes):
        self.routes = routes   # before super(): it handles the request
        super().__init__(request, client_address, server)

    def _reply(self, code: int, body: Dict[str, Any],
               extra_headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _stream(self, items) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        try:
            for item in items:
                self.wfile.write((json.dumps(item) + "\n").encode())
                self.wfile.flush()
        except (BrokenPipeError, ConnectionError):
            pass                    # client went away
        except Exception as e:      # noqa: BLE001 — status already sent;
            # the contract is a final error LINE, so a truncated stream
            # is distinguishable from a completed one.
            try:
                self.wfile.write((json.dumps(
                    {"status": "error", "error": str(e)}) + "\n").encode())
                self.wfile.flush()
            except (BrokenPipeError, ConnectionError):
                pass
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()
        self.close_connection = True

    def _run(self, fn: Route, req: Dict[str, Any]) -> None:
        try:
            out = fn(req)
            if isinstance(out, dict):
                self._reply(200, out)
                return
        except StatusError as e:
            hdrs = {}
            if e.retry_after is not None:
                hdrs["Retry-After"] = str(int(e.retry_after))
            body = {"status": "error", "error": str(e)}
            if e.reason is not None:
                body["reason"] = e.reason
            self._reply(e.code, body, extra_headers=hdrs)
            return
        except _BAD_REQUEST as e:
            self._reply(400, {"status": "error", "error": str(e)})
            return
        self._stream(out)

    def _split(self) -> tuple:
        parts = urlsplit(self.path)
        path = parts.path.rstrip("/") or "/"
        query = {k: v[-1] for k, v in parse_qs(parts.query).items()}
        return path, query

    def _refuse_unauthorized(self, path: str) -> bool:
        """Answer 401 and return True when a token is set, the path is not
        /health and the request lacks `Authorization: Bearer <token>`."""
        token = self.routes.auth_token
        if not token or path == "/health":
            return False
        got = self.headers.get("Authorization", "")
        # Bytes, as compare_digest raises on non-ASCII str (http.server
        # decodes headers as latin-1).
        if hmac.compare_digest(got.encode("latin-1", "replace"),
                               f"Bearer {token}".encode("latin-1", "replace")):
            return False
        self._reply(401, {"status": "error",
                          "error": "missing or bad bearer token"})
        return True

    def do_POST(self):
        path, _query = self._split()
        if self._refuse_unauthorized(path):
            return
        fn = self.routes.post.get(path)
        if fn is None:
            self.send_error(404)
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            if not 0 <= n <= MAX_BODY_BYTES:
                raise ValueError(f"bad Content-Length {n}")
            req = json.loads(self.rfile.read(n) or b"{}")
        except _BAD_REQUEST as e:
            self._reply(400, {"status": "error", "error": str(e)})
            return
        if isinstance(req, dict):
            req["_headers"] = self._header_dict()
        self._run(fn, req)

    def _header_dict(self) -> Dict[str, str]:
        return {k.lower(): v for k, v in self.headers.items()}

    def do_GET(self):
        path, query = self._split()
        if self._refuse_unauthorized(path):
            return
        fn = self.routes.get.get(path)
        if fn is None:
            self.send_error(404)
            return
        query["_headers"] = self._header_dict()
        self._run(fn, query)

    def log_message(self, *a):  # quiet: the service logs its own events
        pass

