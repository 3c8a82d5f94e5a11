"""A small JSON web layer on the standard library.

Counterpart of ``learningorchestra_tpu/utils/web.py`` (which is built on
werkzeug): route registration with ``<name>`` path parameters, JSON
request bodies, ``(payload, status)`` handler results, the 429 +
``Retry-After`` admission answer, a threaded server
(:class:`ServerThread`, on ``http.server.ThreadingHTTPServer``) and an
in-process :meth:`WebApp.test_client`. Status codes and JSON bodies match
the reference's: an unknown route answers 404 ``{"result": "not_found"}``
and an exception in a handler answers 500 with ``"<Type>: <message>"``.
Only the standard library is used, so the port serves wherever torch runs.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import unquote, urlsplit

_PARAM_RE = re.compile(r"<([A-Za-z_][A-Za-z0-9_]*)>")
_dumps = json.dumps  # TestClient.post takes a parameter named json


def _compile_rule(rule: str) -> "re.Pattern":
    """``/models/<name>`` -> a regex whose groups are the parameters; a
    parameter matches one path segment."""
    pattern, position = "", 0
    for match in _PARAM_RE.finditer(rule):
        pattern += re.escape(rule[position : match.start()])
        pattern += f"(?P<{match.group(1)}>[^/]+)"
        position = match.end()
    return re.compile("^" + pattern + re.escape(rule[position:]) + "$")


class Request:
    """One HTTP request as a handler sees it."""

    def __init__(self, method: str, target: str, headers=None, body: bytes = b""):
        self.method = method.upper()
        # matched decoded, as werkzeug does: %2F is a separator, not a name
        self.path = unquote(urlsplit(target).path)
        self.headers = {key.lower(): value for key, value in (headers or {}).items()}
        self.data = body

    @property
    def mimetype(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip().lower()

    @property
    def is_json(self) -> bool:
        mimetype = self.mimetype
        return mimetype == "application/json" or (
            mimetype.startswith("application/") and mimetype.endswith("+json")
        )

    def get_json(self, silent: bool = False) -> Any:
        """The body parsed as JSON. With ``silent``, a body that is not
        declared JSON or does not parse gives None (werkzeug's contract)."""
        if not self.is_json:
            if silent:
                return None
            raise ValueError("request body is not declared as application/json")
        try:
            return json.loads(self.data)
        except ValueError:
            if silent:
                return None
            raise


class Response:
    def __init__(
        self,
        body: "bytes | str" = b"",
        status: int = 200,
        content_type: str = "application/json",
        headers: Optional[dict] = None,
    ):
        self.data = body.encode() if isinstance(body, str) else body
        self.status_code = status
        self.headers = {"Content-Type": content_type, **(headers or {})}

    def get_json(self) -> Any:
        return json.loads(self.data)


def json_response(payload: Any, status: int = 200) -> Response:
    return Response(json.dumps(payload), status=status)


def too_many_requests(error) -> Response:
    """HTTP 429 for a ``QueueFullError``; ``Retry-After`` carries the
    backlog-drain estimate."""
    return Response(
        json.dumps(
            {
                "result": "queue_full",
                "job_class": error.job_class,
                "retry_after_s": error.retry_after_s,
            }
        ),
        status=429,
        headers={"Retry-After": str(error.retry_after_s)},
    )


class WebApp:
    """Routes to handlers. A handler takes the :class:`Request` and the
    rule's path parameters, and returns a :class:`Response` or a
    ``(payload, status)`` tuple whose payload is JSON-serialised."""

    def __init__(self, name: str):
        self.name = name
        # (compiled rule, methods, handler)
        self._routes: list = []

    def route(self, rule: str, methods: tuple = ("GET",)):
        pattern = _compile_rule(rule)

        def decorator(handler: Callable) -> Callable:
            self._routes.append((pattern, tuple(m.upper() for m in methods), handler))
            return handler

        return decorator

    def handle(self, request: Request) -> Response:
        allowed: list = []
        for pattern, methods, handler in self._routes:
            match = pattern.match(request.path)
            if match is None:
                continue
            if request.method not in methods:
                allowed.extend(methods)
                continue
            try:
                result = handler(request, **match.groupdict())
            except Exception as error:  # noqa: BLE001 — the route's 500 body
                return Response(
                    f"{type(error).__name__}: {error}", status=500, content_type="text/plain"
                )
            if isinstance(result, Response):
                return result
            if isinstance(result, tuple):
                payload, status = result
                if isinstance(payload, Response):
                    payload.status_code = status
                    return payload
                return json_response(payload, status)
            return json_response(result)
        if allowed:
            return Response(
                json.dumps({"result": "method_not_allowed"}),
                status=405,
                headers={"Allow": ", ".join(sorted(set(allowed)))},
            )
        return json_response({"result": "not_found"}, 404)

    def test_client(self) -> "TestClient":
        return TestClient(self)


class TestClient:
    """Calls an app in-process, without a socket."""

    __test__ = False  # not a pytest test class

    def __init__(self, app: WebApp):
        self.app = app

    def get(self, path: str) -> Response:
        return self.app.handle(Request("GET", path))

    def post(self, path: str, json: Any = None) -> Response:
        """POST ``json`` as an ``application/json`` body."""
        body = b"" if json is None else _dumps(json).encode()
        return self.app.handle(
            Request("POST", path, {"Content-Type": "application/json"}, body)
        )


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _serve(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        request = Request(self.command, self.path, dict(self.headers.items()), body)
        response = self.server.app.handle(request)
        self.send_response(response.status_code)
        for key, value in response.headers.items():
            self.send_header(key, value)
        self.send_header("Content-Length", str(len(response.data)))
        self.end_headers()
        self.wfile.write(response.data)

    do_GET = do_POST = _serve

    def log_message(self, format, *args) -> None:
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # werkzeug's listen backlog (LISTEN_QUEUE), which the reference's
    # server has; socketserver's default of 5 resets clients that arrive
    # together (8 concurrent single-row predicts already can)
    request_queue_size = 128

    def __init__(self, address, app: WebApp):
        super().__init__(address, _Handler)
        self.app = app


class ServerThread:
    """Serve an app on a background thread; ``port=0`` takes a free port,
    which ``.port`` then holds."""

    def __init__(self, app: WebApp, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self._server = _Server((host, port), app)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name=f"{app.name}-server"
        )

    def start(self) -> "ServerThread":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)

