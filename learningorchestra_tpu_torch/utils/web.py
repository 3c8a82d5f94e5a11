"""A small JSON web layer on the standard library.

Counterpart of ``learningorchestra_tpu/utils/web.py`` (which is built on
werkzeug): route registration with ``<name>`` path parameters, JSON
request bodies, ``(payload, status)`` handler results, files answered
by :func:`send_file`, the 429 +
``Retry-After`` admission answer, a server on a background thread
(:class:`ServerThread`) and an in-process :meth:`WebApp.test_client`.
Answers match the reference's werkzeug stack byte for byte: an unknown route answers 404
``{"result": "not_found"}``; a GET rule also answers HEAD (the GET's
status and headers, no body); a method that a path's rules lack answers
405 with ``Allow``; an :class:`HTTPError` in a handler answers its own
status (400 for a body that does not parse as JSON, 415 for one not
declared JSON, as werkzeug's ``get_json`` raises them). 405, 400 and 415
come as werkzeug's HTML error page. Any other exception answers 500 with
``"<Type>: <message>"``.

Every app serves ``GET /metrics`` (the process registry, with the
request counters this layer keeps and the flight recorder's byte-flow
families, declared from boot), ``GET /debug/profile`` (the sampling
profiler), ``GET /debug/spans`` (this process's span export buffer) and
``GET /traces/<cid>`` (one Chrome trace stitched across the plane
members of ``LO_PLANE_MEMBERS``), and runs each request under a trace
whose correlation ID (``X-Correlation-Id``, the caller's or a new one)
echoes on the answer and rides into the jobs the request submits.
:meth:`WebApp.register_observability` adds the store-backed routes
(``/metrics/history``, ``/metrics/ingest``, ``/debug/slo``) and arms
``/health``'s ``degraded``. :meth:`WebApp.register_job_routes` adds the
job surface (``/jobs``, ``/jobs/<name>``, its long-poll ``/wait``,
``/trace`` and ``/profile``, ``DELETE``) and ``/health``.

A handler may return a :class:`Waiter` (an answer that is not ready:
``/jobs/<name>/wait``, framed as SSE under ``Accept:
text/event-stream``, and the store's ``/wal`` long-poll) or an
:class:`Upstream` (an answer that lives on another server: the fleet
router's predict). :class:`ServerThread` serves on the event loop of
``utils/webloop.py`` unless ``LO_WEB_ASYNC=0``: the loop parks the
connection, not a thread, and proxies an ``Upstream`` without one; on
the threaded ``http.server`` (``LO_WEB_ASYNC=0``) and in
:class:`TestClient` the handler's thread resolves them blocking, with
the same bytes. :meth:`ServerThread.stop` closes the connections it
holds open, so a stopped server answers nothing more, kept-alive
clients included. Only the standard library is used, so the port
serves wherever torch runs.
"""

from __future__ import annotations

import html
import json
import re
import socket
import sys
import threading
import time
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import parse_qsl, unquote, urlsplit

from learningorchestra_tpu_torch.telemetry import metrics as _metrics
from learningorchestra_tpu_torch.telemetry import tracing as _tracing
from learningorchestra_tpu_torch.utils import webloop as _webloop
from learningorchestra_tpu_torch.utils.webloop import (  # noqa: F401 — re-export
    Upstream,
    Waiter,
)

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


def _rule_order(rule: str) -> tuple:
    """The order in which werkzeug's matcher visits the rules of one path:
    segment by segment, a static segment before a parameter (rules of
    equal key keep the order they were added in)."""
    return tuple(bool(_PARAM_RE.search(part)) for part in rule.split("/"))


def _rule_methods(methods) -> set:
    """A rule's methods as werkzeug's ``Rule`` holds them: a set, HEAD
    added to GET."""
    methods = {method.upper() for method in methods}
    if "GET" in methods:
        methods.add("HEAD")
    return methods


def _error_page(status: int, description: str) -> "Response":
    """werkzeug's HTML page for an HTTP error: its title and heading the
    status's name, the description escaped as markupsafe does (quotes as
    ``&#34;`` and ``&#39;``, newlines as ``<br>``)."""
    name = HTTPStatus(status).phrase
    text = html.escape(description, quote=False).replace('"', "&#34;").replace("'", "&#39;")
    text = text.replace("\n", "<br>")
    body = (
        "<!doctype html>\n<html lang=en>\n"
        f"<title>{status} {name}</title>\n<h1>{name}</h1>\n<p>{text}</p>\n"
    )
    return Response(body, status=status, content_type="text/html; charset=utf-8")


class HTTPError(Exception):
    """An error that answers with its own status code, as werkzeug's
    ``HTTPException`` does, instead of the 500 of any other exception."""

    def __init__(self, status: int, description: str):
        super().__init__(description)
        self.status = status
        self.description = description


class BadRequest(HTTPError):
    def __init__(self, description: str):
        super().__init__(400, description)


class UnsupportedMediaType(HTTPError):
    def __init__(self, description: str):
        super().__init__(415, description)


class Headers(dict):
    """Request headers, looked up without regard to case (their names
    are kept in lower case)."""

    def __init__(self, items=()):
        super().__init__((key.lower(), value) for key, value in dict(items).items())

    def __getitem__(self, key):
        return super().__getitem__(key.lower())

    def get(self, key, default=None):
        return super().get(key.lower(), default)


class Request:
    """One HTTP request as a handler sees it."""

    def __init__(self, method: str, target: str, headers=None, body: bytes = b""):
        self.method = method.upper()
        parts = urlsplit(target)
        # matched decoded, as werkzeug does: %2F is a separator, not a name
        self.path = unquote(parts.path)
        # the query string; a repeated key keeps its first value, as
        # werkzeug's MultiDict.get does
        self.args: dict = {}
        for key, value in parse_qsl(parts.query, keep_blank_values=True):
            self.args.setdefault(key, value)
        self.headers = Headers(headers or {})
        self.data = body
        # set by the event loop (utils/webloop.py): a Waiter or Upstream
        # the handler returns goes back to the loop unresolved
        self.on_loop = False

    def get_data(self) -> bytes:
        return self.data

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
        """The body parsed as JSON (werkzeug's contract): a body not
        declared JSON raises :class:`UnsupportedMediaType` (415), one that
        does not parse :class:`BadRequest` (400); with ``silent`` either
        gives None."""
        if not self.is_json:
            if silent:
                return None
            raise UnsupportedMediaType(
                "Did not attempt to load JSON data because the request "
                "Content-Type was not 'application/json'."
            )
        try:
            return json.loads(self.data)
        except ValueError as error:
            if silent:
                return None
            raise BadRequest(f"Failed to decode JSON object: {error}") from None


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

    @property
    def content_type(self) -> str:
        return self.headers.get("Content-Type", "")

    def get_json(self) -> Any:
        return json.loads(self.data)

    def get_data(self, as_text: bool = False) -> "bytes | str":
        return self.data.decode() if as_text else self.data


def json_response(payload: Any, status: int = 200) -> Response:
    return Response(json.dumps(payload), status=status)


def send_file(path: str, mimetype: str) -> Response:
    """The file's bytes as a 200 answer of type ``mimetype``."""
    with open(path, "rb") as handle:
        data = handle.read()
    return Response(data, status=200, content_type=mimetype)


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

    def __init__(self, name: str, registry=None):
        self.name = name
        # (werkzeug's visiting key, compiled rule, methods, handler, rule)
        self._routes: list = []
        # every app reports into the process registry (families labelled
        # by service) and serves it at GET /metrics, as the reference's
        self.registry = registry or _metrics.global_registry()
        self._requests_total = self.registry.counter(
            "lo_http_requests_total",
            "HTTP requests handled",
            labels=("service", "route", "method", "status"),
        )
        self._request_seconds = self.registry.histogram(
            "lo_http_request_duration_seconds",
            "Wall-clock per request",
            labels=("service", "route", "method"),
        )
        self._in_flight = self.registry.gauge(
            "lo_http_requests_in_flight",
            "Requests currently being handled",
            labels=("service",),
        )

        # set by register_observability(): the store whose __lo_metrics__
        # ring backs /metrics/history, /debug/slo and /health's degraded
        self._obs_store = None
        # the flight recorder's byte-flow families are declared eagerly,
        # so every service's /metrics shows them from boot
        from learningorchestra_tpu_torch.telemetry import profile as _profile

        _profile._flow_metrics()

        @self.route("/metrics")
        def serve_metrics(request):
            return Response(self.registry.render(), content_type=_metrics.CONTENT_TYPE)

        @self.route("/debug/profile")
        def debug_profile(request):
            """Sample every thread's stack for ``?seconds=N`` (default 5,
            clamped to ``LO_PROF_WINDOW_S``) and answer folded flamegraph
            stacks as text, or with ``?format=json`` the stacks with their
            sample count and rate. 403 when ``LO_PROF_HZ=0``; a malformed
            ``LO_PROF_*`` answers a JSON 500."""
            try:
                seconds = float(request.args.get("seconds", "5"))
            except ValueError:
                return {"result": "bad_seconds"}, 400
            if not seconds > 0 or seconds != seconds:  # NaN included
                return {"result": "bad_seconds"}, 400
            try:
                stacks, samples = _profile.sample_stacks(seconds)
            except RuntimeError:
                return {"result": "profiler_disabled"}, 403
            except ValueError as error:
                return {"result": "invalid_prof_config", "error": str(error)}, 500
            if request.args.get("format") == "json":
                return {
                    "result": {"stacks": stacks, "samples": samples, "hz": _profile.prof_hz()}
                }, 200
            return Response(
                _profile.folded_text(stacks), content_type="text/plain; charset=utf-8"
            )

        @self.route("/debug/spans")
        def debug_spans(request):
            """This process's span export buffer, the stitcher's feed:
            ``?cid=`` filters to one correlation ID, ``?since=`` to
            entries updated after an epoch timestamp."""
            cid = request.args.get("cid")
            since = request.args.get("since")
            if since is not None:
                try:
                    since = float(since)
                except ValueError:
                    return {"result": "bad_since"}, 400
            return {"result": _tracing.exported_spans(cid, since)}, 200

        @self.route("/traces/<cid>")
        def read_stitched_trace(request, cid):
            """One Chrome trace for one correlation ID, stitched across
            every member of ``LO_PLANE_MEMBERS`` (a process row per
            ``service@pid``); 404 when no member holds spans for it."""
            from learningorchestra_tpu_torch.telemetry import stitch as _stitch

            trace = _stitch.stitched_trace(cid)
            if not trace["otherData"]["processes"]:
                return {"result": "not_found"}, 404
            return trace, 200

    def route(self, rule: str, methods: tuple = ("GET",)):
        pattern = _compile_rule(rule)

        def decorator(handler: Callable) -> Callable:
            self._routes.append(
                (_rule_order(rule), pattern, _rule_methods(methods), handler, rule)
            )
            self._routes.sort(key=lambda route: route[0])  # stable: ties keep their order
            return handler

        return decorator

    def register_observability(self, store) -> None:
        """The store-backed half of the observability plane (reference
        ``utils/web.py:188-279``):

        - ``GET /metrics/history?family=…`` — the ``__lo_metrics__``
          ring's fold-forward series and windowed rollups per instance
          (telemetry/tsdb.py);
        - ``POST /metrics/ingest`` — Prometheus exposition text in, one
          retention tick out;
        - ``GET /debug/slo`` — ok/burning per SLO rule with the offending
          instance (telemetry/slo.py); it also arms ``/health``'s
          ``degraded``."""
        from learningorchestra_tpu_torch.telemetry import slo as _slo
        from learningorchestra_tpu_torch.telemetry import tsdb as _tsdb

        self._obs_store = store
        ingest_tsdb = _tsdb.TSDB(store)

        @self.route("/metrics/history")
        def metrics_history(request):
            family = request.args.get("family")
            if not family:
                return {"result": "bad_family"}, 400
            try:
                since = float(request.args["since"]) if "since" in request.args else None
                window_s = float(request.args.get("window", _slo.slo_window_s()))
            except ValueError:
                return {"result": "bad_window"}, 400
            instance = request.args.get("instance")
            series = _tsdb.history(store, family, instance=instance)
            return {
                "result": {
                    "family": family,
                    "series": {
                        inst: [[ts, value] for ts, value in points if since is None or ts >= since]
                        for inst, points in series.items()
                    },
                    "rollup": _tsdb.window_rollups(store, family, window_s=window_s, instance=instance),
                    "services": _tsdb.services_of(store),
                }
            }, 200

        @self.route("/metrics/ingest", methods=("POST",))
        def metrics_ingest(request):
            body = request.get_json()
            instance = body.get("instance")
            text = body.get("text")
            if not instance or not isinstance(text, str):
                return {"result": "bad_ingest"}, 400
            try:
                vals = _tsdb.parse_samples(text)
            except ValueError as error:
                # a member scraped mid-restart: its tick is dropped
                return {"result": "unparseable", "error": str(error)}, 400
            ingest_tsdb.append(instance, body.get("service") or "unknown", vals, ts=body.get("ts"))
            return {"result": "ok", "families": len(vals)}, 200

        @self.route("/debug/slo")
        def debug_slo(request):
            try:
                return {"result": _slo.status(store)}, 200
            except Exception as error:  # noqa: BLE001 — a store mid-failover
                # answers a diagnosable payload, not a traceback
                return {
                    "result": "slo_unavailable",
                    "error": f"{type(error).__name__}: {error}",
                }, 503

    def slo_degraded(self) -> bool:
        """``/health``'s SLO verdict: True when any rule burns; False
        without a registered store or on any evaluation error, so that
        health answers while the plane itself is sick."""
        if self._obs_store is None:
            return False
        try:
            from learningorchestra_tpu_torch.telemetry import slo as _slo

            return bool(_slo.status(self._obs_store)["degraded"])
        except Exception:  # noqa: BLE001
            return False

    def register_job_traces(self, jobs) -> None:
        """``GET /jobs/<name>/trace`` (the record and its span tree) and
        ``GET /jobs/<name>/profile``: the job's timeline as Chrome
        trace-event JSON (a row per thread, byte counter tracks), or with
        ``?format=summary`` the per-phase seconds, bytes and rows per
        second with the job's record."""

        @self.route("/jobs/<job_name>/trace")
        def read_job_trace(request, job_name):
            record = jobs.get(job_name)
            if record is None:
                return {"result": "not_found"}, 404
            return {"result": record.trace_dict()}, 200

        @self.route("/jobs/<job_name>/profile")
        def read_job_profile(request, job_name):
            from learningorchestra_tpu_torch.telemetry import profile as _profile

            record = jobs.get(job_name)
            if record is None:
                return {"result": "not_found"}, 404
            if record.trace is None:
                return {"result": "no_trace"}, 404
            if request.args.get("format") == "summary":
                summary = _profile.trace_summary(record.trace)
                summary["job"] = record.as_dict()
                return {"result": summary}, 200
            return _profile.chrome_trace(record.trace), 200

    def register_job_routes(self, jobs) -> None:
        """The job surface of a service holding a ``JobManager``
        (reference ``utils/web.py:291-422``):

        - ``GET /jobs`` — every tracked job's record;
        - ``GET /jobs/<name>`` — one record (404 unknown);
        - ``GET /jobs/<name>/trace`` and ``/profile`` — its span tree,
          and its timeline as a Chrome trace (:meth:`register_job_traces`);
        - ``GET /jobs/<name>/wait?timeout=S`` — long-poll (or SSE with
          ``Accept: text/event-stream``) until the job ends (a
          :class:`Waiter` notified by its done callback) or ``S``
          seconds pass (default 25, capped at ``LO_WEB_WAIT_CAP_S``):
          the terminal record, or ``{"result": "timeout", ...}``, a
          re-poll hint; a bare dataset name resolves to the newest job
          materialising it;
        - ``DELETE /jobs/<name>`` — cooperative cancellation: 202 while
          it propagates, 409 once the job is terminal, 404 unknown;
        - ``GET /health`` — liveness, the ``job_wait`` feature probe and
          ``degraded``, the SLO verdict (:meth:`slo_degraded`)."""
        from learningorchestra_tpu_torch.core.jobs import TERMINAL_STATES

        self.register_job_traces(jobs)

        @self.route("/jobs")
        def read_jobs(request):
            return {"result": jobs.all_jobs()}, 200

        @self.route("/jobs/<job_name>", methods=("DELETE",))
        def cancel_job(request, job_name):
            outcome = jobs.cancel(job_name)
            if outcome == "unknown":
                return {"result": "not_found"}, 404
            if outcome == "terminal":
                return {"result": "already_terminal"}, 409
            return {"result": "cancelling"}, 202

        @self.route("/jobs/<job_name>", methods=("GET",))
        def read_job(request, job_name):
            record = jobs.get(job_name)
            if record is None:
                return {"result": "not_found"}, 404
            return {"result": record.as_dict()}, 200

        @self.route("/jobs/<job_name>/wait", methods=("GET",))
        def wait_job(request, job_name):
            try:
                timeout_s = float(request.args.get("timeout", "25"))
            except ValueError:
                return {"result": "bad_timeout"}, 400
            if timeout_s != timeout_s or timeout_s < 0:  # NaN included
                return {"result": "bad_timeout"}, 400
            timeout_s = min(timeout_s, _webloop.wait_cap_s())
            record = jobs.resolve_wait(job_name)
            if record is None:
                return {"result": "not_found"}, 404
            sse = "text/event-stream" in (request.headers.get("Accept") or "")

            def poll(_record=record):
                # a notify for a same-name successor finds this record
                # still running: spurious, the waiter stays parked
                if _record.state in TERMINAL_STATES:
                    return {"result": _record.as_dict()}, 200
                return None

            def on_timeout(_record=record):
                return {"result": "timeout", "job": _record.name, "state": _record.state}, 200

            waiter = Waiter(poll, timeout_s, on_timeout, sse=sse)
            jobs.add_done_callback(record.name, waiter.notify)
            return waiter

        if not any(route[4] == "/health" for route in self._routes):

            @self.route("/health")
            def health(request):
                return {
                    "result": "ok",
                    "service": self.name,
                    "job_wait": True,
                    "degraded": self.slo_degraded(),
                }, 200

    def handle(self, request: Request) -> "Response | Waiter | Upstream":
        """The answer to ``request``, under a trace whose correlation ID
        echoes on it; a HEAD's keeps the GET's headers and
        ``Content-Length`` but no body.

        A handler's :class:`Waiter` or :class:`Upstream` goes back as it
        is when the event loop serves the request (``request.on_loop``):
        the loop parks or proxies it, and its ``on_complete`` books the
        request counters at resolution. Otherwise this thread resolves
        it blocking into a :class:`Response`."""
        correlation_id = (
            request.headers.get(_tracing.CORRELATION_HEADER.lower())
            or _tracing.mint_correlation_id()
        )
        trace = _tracing.Trace(correlation_id, name=f"{request.method} {request.path}")
        self._in_flight.labels(self.name).inc()
        started = time.perf_counter()
        try:
            with _tracing.activate(trace), _tracing.span(
                f"http:{request.method} {request.path}"
            ):
                response, rule = self._dispatch(request)
        finally:
            self._in_flight.labels(self.name).dec()
        _tracing.export_trace(trace, service=self.name)
        method = request.method

        def book(status: int) -> None:
            self._requests_total.labels(self.name, rule, method, status).inc()
            self._request_seconds.labels(self.name, rule, method).observe(
                time.perf_counter() - started
            )

        if isinstance(response, Upstream):
            response.correlation_id = correlation_id
            if request.on_loop:
                # the loop proxies on its own thread; a route-set
                # on_complete (the router's families) runs first
                route_complete = response.on_complete

                def complete(status, _route_complete=route_complete):
                    if _route_complete is not None:
                        _route_complete(status)
                    book(status)

                response.on_complete = complete
                return response
            status, headers, body = response.resolve_blocking()
            response = Response(body, status=status, headers=dict(headers))
        if isinstance(response, Waiter):
            response.correlation_id = correlation_id
            if request.on_loop:
                # the loop parks the connection: a long-poll's latency
                # is its parked time
                response.on_complete = book
                return response
            result, kind = response.resolve_blocking()
            body, status, content_type = _webloop.waiter_body(response, result, kind)
            if content_type.startswith("text/"):
                content_type += "; charset=utf-8"  # werkzeug's mimetype rule
            response = Response(body, status=status, content_type=content_type)
        book(response.status_code)
        response.headers[_tracing.CORRELATION_HEADER] = correlation_id
        if request.method == "HEAD":
            response.headers["Content-Length"] = str(len(response.data))
            response.data = b""
        return response

    def _dispatch(self, request: Request) -> tuple["Response | Waiter | Upstream", str]:
        """The answer and the matched rule (``<unmatched>`` if none): the
        rule, not the path, labels the request counters."""
        matched = []
        for _, pattern, methods, handler, rule in self._routes:
            match = pattern.match(request.path)
            if match is None:
                continue
            if request.method in methods:
                break
            matched.append(methods)
        else:
            if not matched:
                return json_response({"result": "not_found"}, 404), "<unmatched>"
            # werkzeug's Allow: the methods of the path's rules, gathered
            # into a set in its matcher's order, twice (its second pass
            # with slashes merged); the header lists the set as it iterates.
            # The second pass adds no method, but set.update sizes the
            # table for the incoming set first and may rebuild it, which
            # reorders it; string hashes differ from process to process,
            # so only the same steps give werkzeug's order
            allowed: set = set()
            for _ in range(2):
                for methods in matched:
                    allowed.update(methods)
            response = _error_page(405, "The method is not allowed for the requested URL.")
            response.headers["Allow"] = ", ".join(allowed)
            return response, "<unmatched>"
        return self._answer(handler, request, match), rule

    @staticmethod
    def _answer(handler, request: Request, match) -> "Response | Waiter | Upstream":
        try:
            result = handler(request, **match.groupdict())
        except HTTPError as error:
            # e.g. BadRequest from request.get_json() on a malformed
            # body: its own status code, not a 500
            return _error_page(error.status, error.description)
        except Exception as error:  # noqa: BLE001 — the route's 500 body
            # werkzeug's mimetype "text/plain" gains the charset
            return Response(
                f"{type(error).__name__}: {error}", status=500,
                content_type="text/plain; charset=utf-8",
            )
        if isinstance(result, (Waiter, Upstream, Response)):
            return result
        if isinstance(result, tuple):
            payload, status = result
            if isinstance(payload, Response):
                payload.status_code = status
                return payload
            return json_response(payload, status)
        return json_response(result)

    def test_client(self) -> "TestClient":
        return TestClient(self)


class TestClient:
    """Calls an app in-process, without a socket."""

    __test__ = False  # not a pytest test class

    def __init__(self, app: WebApp):
        self.app = app

    def get(self, path: str, headers=None) -> Response:
        return self.app.handle(Request("GET", path, headers))

    def post(self, path: str, json: Any = None, data: bytes = None, headers=None) -> Response:
        """POST ``json`` as an ``application/json`` body, or the bytes
        ``data`` as they are; ``headers`` are added to the request's."""
        return self._send("POST", path, json, data, headers)

    def patch(self, path: str, json: Any = None) -> Response:
        """PATCH ``json`` as an ``application/json`` body."""
        return self._send("PATCH", path, json)

    def _send(self, method: str, path: str, json: Any, data: bytes = None, headers=None) -> Response:
        if data is None:
            data = b"" if json is None else _dumps(json).encode()
            headers = {"Content-Type": "application/json", **(headers or {})}
        return self.app.handle(Request(method, path, headers, data))

    def delete(self, path: str) -> Response:
        return self.app.handle(Request("DELETE", path))

    def open(self, path: str, method: str, headers=None, data: bytes = b"") -> Response:
        """Any method, as werkzeug's ``Client.open``."""
        return self.app.handle(Request(method, path, headers, data))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _serve(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        request = Request(self.command, self.path, dict(self.headers.items()), body)
        response = self.server.app.handle(request)
        self.send_response(response.status_code)
        headers = {"Content-Length": str(len(response.data)), **response.headers}
        for key, value in headers.items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(response.data)

    def __getattr__(self, name: str):
        """``do_<METHOD>`` for every method: the app answers each (405
        where a path's rules lack it), not ``http.server``'s 501."""
        if name.startswith("do_"):
            return self._serve
        raise AttributeError(name)

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
        self._open: set = set()   # the connections being served
        self._open_lock = threading.Lock()

    def process_request(self, request, client_address) -> None:
        with self._open_lock:
            self._open.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request) -> None:
        with self._open_lock:
            self._open.discard(request)
        super().shutdown_request(request)

    def handle_error(self, request, client_address) -> None:
        """A client gone mid-answer (a connection this server closed
        itself on stop, or one its client dropped) is no error of the
        server's."""
        if isinstance(sys.exc_info()[1], ConnectionError):
            return
        super().handle_error(request, client_address)

    def close_connections(self) -> None:
        """End every connection still open: a kept-alive client's next
        request then finds the connection closed, as it would find a
        server that is gone."""
        with self._open_lock:
            open_now = list(self._open)
        for connection in open_now:
            try:
                connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class ServerThread:
    """Serve an app on a background thread; ``port=0`` takes a free port,
    which ``.port`` then holds.

    ``LO_WEB_ASYNC=1`` (the default) serves on the event loop
    (``utils/webloop.LoopServer``, exposed as ``._loop``): one selectors
    loop owns every socket and a bounded handler pool runs the routes.
    ``LO_WEB_ASYNC=0`` serves on the threaded ``http.server`` (a thread
    a connection; ``._loop`` is None): the same routes and bytes, a
    ``/wait`` blocking its thread."""

    def __init__(self, app: WebApp, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        if _webloop.web_async_enabled():
            self._server = None
            self._loop = _webloop.LoopServer(app, host, port)
            self.port = self._loop.port
            self._thread = self._loop._thread
        else:
            self._loop = None
            self._server = _Server((host, port), app)
            self.port = self._server.server_address[1]
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True, name=f"{app.name}-server"
            )

    def start(self) -> "ServerThread":
        if self._loop is not None:
            self._loop.start()
        else:
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving and close every connection still open."""
        if self._loop is not None:
            self._loop.stop()
        else:
            if self._thread.is_alive():
                self._server.shutdown()
            self._server.server_close()
            self._server.close_connections()
        if self._thread.ident is not None:
            self._thread.join(timeout=5)


def run_app(app: WebApp, host: str, port: int) -> None:
    """Serve ``app`` in the foreground until the process ends."""
    if _webloop.web_async_enabled():
        _webloop.LoopServer(app, host, port).serve_forever()
        return
    _Server((host, port), app).serve_forever()
