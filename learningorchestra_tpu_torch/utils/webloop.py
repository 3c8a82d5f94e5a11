"""Event-driven serving core: one ``selectors`` loop, a bounded pool.

Counterpart of ``learningorchestra_tpu/utils/webloop.py``, module and
public names kept. A thread-per-request server parks a whole thread on
every idle waiter; this module serves instead from a reactor (stdlib
only):

- one acceptor/reader loop owns every socket: it parses requests,
  holds idle keep-alive connections at near-zero marginal RSS, and
  streams responses back under write-readiness registration;
- a small bounded handler pool (``LO_WEB_HANDLERS``) runs the app's
  route functions (``WebApp.handle``) unchanged — they block on store
  and device work, so they cannot run on the loop thread;
- a route that cannot answer yet returns a :class:`Waiter` instead of
  a response; the loop parks the CONNECTION (no thread) until the
  waiter is notified, times out, or its poll interval finds the
  answer. ``GET /jobs/<name>/wait`` and ``GET /wal?wait=`` both ride
  this;
- a route whose answer lives on ANOTHER server returns an
  :class:`Upstream`: the loop connects out non-blocking in the same
  selector, relays the request, and streams the reply back through the
  ordinary write-readiness machinery, failing over target by target on
  connection death or 5xx. The fleet router (serve/router.py) rides
  this.

The app is the port's ``utils/web.WebApp``, not a WSGI callable: the
loop builds a ``Request`` marked ``on_loop`` and hands it to
``app.handle``, which gives back a ``Response``, or the parked
``Waiter`` or ``Upstream`` itself. ``LO_WEB_ASYNC=0`` serves on the
threaded ``http.server`` instead (``utils/web.ServerThread``).

Knob table:

====================  =======  ====================================
env var               default  meaning
====================  =======  ====================================
``LO_WEB_ASYNC``      1        1 = event-loop core, 0 = threaded
                               ``http.server``
``LO_WEB_HANDLERS``   8        handler-pool width (blocking route
                               functions in flight at once)
``LO_WEB_MAX_CONNS``  10000    open-connection cap; past it new
                               connections get 503 + close
``LO_WEB_WAIT_CAP_S`` 60       ceiling on a ``/wait`` long-poll's
                               requested timeout
====================  =======  ====================================
"""

from __future__ import annotations

import collections
import json
import os
import selectors
import socket
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.client import responses as _http_reasons
from typing import Any, Callable, Optional

from learningorchestra_tpu_torch.sched.config import _float_env, _int_env
from learningorchestra_tpu_torch.telemetry import metrics as _metrics
from learningorchestra_tpu_torch.telemetry import tracing as _tracing

# ---------------------------------------------------------------------------
# Configuration


def web_async_enabled() -> bool:
    raw = os.environ.get("LO_WEB_ASYNC", "").strip()
    if raw not in ("", "0", "1"):
        raise ValueError(f"LO_WEB_ASYNC must be 0 or 1, got {raw!r}")
    return raw != "0"


def handler_pool_size() -> int:
    return _int_env("LO_WEB_HANDLERS", 8)


def max_connections() -> int:
    return _int_env("LO_WEB_MAX_CONNS", 10_000)


def wait_cap_s() -> float:
    cap = _float_env("LO_WEB_WAIT_CAP_S", 60.0)
    if not cap > 0:
        raise ValueError(f"LO_WEB_WAIT_CAP_S must be > 0, got {cap}")
    return cap


def validate_env() -> dict:
    """Read every web knob (raising on malformed values) and return the
    resolved configuration (the runner's ``web config:`` boot line)."""
    return {
        "LO_WEB_ASYNC": 1 if web_async_enabled() else 0,
        "LO_WEB_HANDLERS": handler_pool_size(),
        "LO_WEB_MAX_CONNS": max_connections(),
        "LO_WEB_WAIT_CAP_S": wait_cap_s(),
    }


# ---------------------------------------------------------------------------
# Waiter: a response that is not ready yet


class Waiter:
    """A parked response. A route handler returns one INSTEAD of a
    ``(payload, status)`` result when the answer is not ready:

    - ``poll()`` returns the handler-style ``(payload, status)`` once
      ready, else ``None``; it must be cheap — the event loop calls it
      on the loop thread;
    - ``notify()`` (thread-safe, idempotent — e.g. from a job's
      finalizer) marks the waiter possibly-ready and wakes whichever
      server holds it; a notify whose poll still answers ``None`` is
      spurious and the waiter stays parked;
    - after ``timeout_s`` with no result ``on_timeout()`` produces the
      response — a clean re-poll hint, never a hang;
    - ``interval_s`` re-polls sources with no push hook (the WAL feed)
      on that period;
    - ``sse=True`` frames the resolution as ``text/event-stream``.

    The threaded server resolves a waiter by blocking its request
    thread (reference-parity behaviour). The event loop parks the
    CONNECTION instead: no thread is held while the waiter pends.
    """

    __slots__ = (
        "poll", "timeout_s", "on_timeout", "interval_s", "sse",
        "notified_at", "on_complete", "correlation_id", "_event", "_wake",
    )

    def __init__(
        self,
        poll: Callable[[], Optional[tuple]],
        timeout_s: float,
        on_timeout: Callable[[], tuple],
        interval_s: Optional[float] = None,
        sse: bool = False,
    ):
        self.poll = poll
        self.timeout_s = max(float(timeout_s), 0.0)
        self.on_timeout = on_timeout
        self.interval_s = interval_s
        self.sse = bool(sse)
        # monotonic instant of the first (non-spurious) notify — the
        # start of the lo_web_notify_seconds measurement
        self.notified_at: Optional[float] = None
        # set by WebApp.handle on the loop's path: records the
        # request's metrics at resolution time
        self.on_complete: Optional[Callable[[int], None]] = None
        self.correlation_id: Optional[str] = None
        self._event = threading.Event()
        self._wake: Optional[Callable[[], None]] = None

    def notify(self) -> None:
        if self.notified_at is None:
            self.notified_at = time.monotonic()
        self._event.set()
        wake = self._wake
        if wake is not None:
            wake()

    def resolve_blocking(self) -> tuple[tuple, str]:
        """Threaded-server path: block THIS thread until ready or
        timeout. Returns ``(result, kind)``, kind in ``ready``/
        ``timeout``."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            result = self.poll()
            if result is not None:
                return result, "ready"
            self.notified_at = None  # that notify (if any) was spurious
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return self.on_timeout(), "timeout"
            step = (
                remaining
                if self.interval_s is None
                else min(remaining, self.interval_s)
            )
            self._event.wait(step)
            self._event.clear()


# ---------------------------------------------------------------------------
# Upstream: a response that lives on another server

# end-to-end framing the proxy owns; everything else relays verbatim
_HOP_HEADERS = ("connection", "keep-alive", "content-length", "transfer-encoding")


def _relay_headers(headers: list) -> list:
    return [
        (key, value)
        for key, value in headers
        if key.lower() not in _HOP_HEADERS
    ]


def _parse_http_response(buf, eof: bool) -> Optional[tuple]:
    """One upstream HTTP/1.1 response out of ``buf``: ``None`` while
    incomplete, else ``(status, reason, headers, body)``. Raises
    ``ValueError`` on a reply the proxy cannot frame (bad status line,
    chunked body) — callers treat that as attempt failure. With no
    Content-Length the body is EOF-terminated (the proxy sends
    ``Connection: close``, so the peer's FIN frames it)."""
    head_end = buf.find(b"\r\n\r\n")
    if head_end < 0:
        if len(buf) > _MAX_HEADER_BYTES:
            raise ValueError("upstream response head too large")
        return None
    lines = bytes(buf[:head_end]).split(b"\r\n")
    parts = lines[0].split(None, 2)
    if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
        raise ValueError("bad upstream status line")
    status = int(parts[1])
    reason = parts[2].decode("latin-1") if len(parts) > 2 else ""
    headers = []
    length = None
    for line in lines[1:]:
        key, sep, value = line.partition(b":")
        if not sep:
            raise ValueError("bad upstream header")
        name = key.strip().decode("latin-1")
        text = value.strip().decode("latin-1")
        headers.append((name, text))
        lower = name.lower()
        if lower == "content-length":
            length = int(text)
        elif lower == "transfer-encoding" and "chunked" in text.lower():
            raise ValueError("chunked upstream body unsupported")
    body_start = head_end + 4
    if length is None:
        if not eof:
            return None
        body = bytes(buf[body_start:])
    else:
        if len(buf) - body_start < length:
            return None
        body = bytes(buf[body_start:body_start + length])
    return status, reason, headers, body


class Upstream:
    """A proxied response. A route handler returns one INSTEAD of a
    ``(payload, status)`` result when the answer lives on another
    server (the fleet router's predict path, serve/router.py):

    - ``targets`` is the ordered ``(host, port)`` failover list;
      ``raw_request`` the pre-serialized HTTP request to relay (built
      with ``Connection: close`` so the peer's FIN frames a
      length-less body);
    - a connection failure, torn/unparseable reply, per-attempt
      ``timeout_s``, or 5xx answer advances to the next target; the
      first non-5xx reply relays verbatim minus hop-by-hop headers;
    - with every target down the last 5xx seen relays (the real error
      beats a synthetic one), else ``on_exhausted()`` supplies the
      ``(payload, status)`` for a clean JSON 502;
    - ``on_attempt(index, target)`` observes every attempt start (the
      router counts ``index > 0`` as retries — it runs on the loop
      thread, keep it cheap); ``on_complete(status)`` is set by
      ``WebApp.handle`` and records request metrics at relay time,
      exactly like :class:`Waiter`.

    The event loop drives the whole exchange on the loop thread — no
    proxy thread per request. The threaded server (and the test
    client) resolves with :meth:`resolve_blocking` instead.
    """

    __slots__ = (
        "targets", "raw_request", "timeout_s", "on_attempt",
        "on_exhausted", "on_complete", "correlation_id",
    )

    def __init__(
        self,
        targets,
        raw_request: bytes,
        timeout_s: float = 30.0,
        on_attempt: Optional[Callable[[int, tuple], None]] = None,
        on_exhausted: Optional[Callable[[], tuple]] = None,
    ):
        if not targets:
            raise ValueError("Upstream needs at least one target")
        self.targets = [(host, int(port)) for host, port in targets]
        self.raw_request = bytes(raw_request)
        self.timeout_s = float(timeout_s)
        self.on_attempt = on_attempt
        self.on_exhausted = on_exhausted or (
            lambda: ({"result": "bad_gateway"}, 502)
        )
        self.on_complete: Optional[Callable[[int], None]] = None
        self.correlation_id: Optional[str] = None

    def resolve_blocking(self) -> tuple[int, list, bytes]:
        """Threaded-server path: walk the targets with blocking sockets
        on THIS thread. Returns ``(status, headers, body)`` with
        hop-by-hop headers already stripped."""
        last_5xx = None
        for index, target in enumerate(self.targets):
            if self.on_attempt is not None:
                try:
                    self.on_attempt(index, target)
                except Exception:  # noqa: BLE001 — observer must not kill
                    traceback.print_exc()
            try:
                parsed = self._attempt_blocking(target)
            except (OSError, ValueError):
                continue
            status = parsed[0]
            if status >= 500:
                last_5xx = parsed
                continue
            break
        else:
            if last_5xx is None:
                payload, status = self.on_exhausted()
                body = json.dumps(payload).encode("utf-8")
                self._completed(status)
                return status, [("Content-Type", "application/json")], body
            parsed = last_5xx
        status, _reason, headers, body = parsed
        self._completed(status)
        return status, _relay_headers(headers), body

    def _completed(self, status: int) -> None:
        # parity with the loop path's relay-time callback (_proxy_relay)
        if self.on_complete is not None:
            try:
                self.on_complete(status)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    def _attempt_blocking(self, target) -> tuple:
        deadline = time.monotonic() + self.timeout_s
        with socket.create_connection(target, timeout=self.timeout_s) as sock:
            sock.sendall(self.raw_request)
            buf = bytearray()
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("upstream attempt timed out")
                sock.settimeout(remaining)
                chunk = sock.recv(_READ_CHUNK)
                if not chunk:
                    parsed = _parse_http_response(buf, eof=True)
                    if parsed is None:
                        raise ConnectionError("upstream closed mid-response")
                    return parsed
                buf += chunk
                parsed = _parse_http_response(buf, eof=False)
                if parsed is not None:
                    return parsed


SSE_RETRY_MS = 3000
SSE_PREAMBLE = f"retry: {SSE_RETRY_MS}\n\n".encode("ascii")


def sse_frame(event: str, payload: Any) -> bytes:
    """One ``text/event-stream`` frame. Golden-tested: both servers must
    emit byte-identical framing."""
    return f"event: {event}\ndata: {json.dumps(payload)}\n\n".encode("utf-8")


def waiter_body(waiter: Waiter, result: tuple, kind: str) -> tuple[bytes, int, str]:
    """``(body, status, content_type)`` for a resolved waiter — shared
    by both servers so long-poll JSON and SSE framing match exactly."""
    payload, status = result
    if waiter.sse:
        event = "done" if kind == "ready" else "timeout"
        return SSE_PREAMBLE + sse_frame(event, payload), 200, "text/event-stream"
    return (
        json.dumps(payload).encode("utf-8"),
        status,
        "application/json",
    )


# ---------------------------------------------------------------------------
# The event loop server

_MAX_HEADER_BYTES = 65536
# pipelined bytes a client may buffer while its previous request is
# still being handled; past this the connection is abusive
_MAX_BUFFERED_BYTES = 64 * 1024 * 1024
_READ_CHUNK = 262144

_BUSY_BODY = json.dumps({"result": "server_busy"}).encode("utf-8")
_BUSY_RESPONSE = (
    b"HTTP/1.1 503 Service Unavailable\r\n"
    b"Content-Type: application/json\r\n"
    b"Content-Length: " + str(len(_BUSY_BODY)).encode("ascii") + b"\r\n"
    b"Retry-After: 1\r\nConnection: close\r\n\r\n" + _BUSY_BODY
)

# notify latency lives in the millisecond range DEFAULT_BUCKETS cannot
# resolve (same rationale as serve/batcher.LATENCY_BUCKETS)
_NOTIFY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0,
)

# connection states. IDLE/PARKED cost no thread and count as "idle" in
# lo_web_connections; READING/HANDLING/WRITING are "active".
_IDLE = "idle"
_READING = "reading"
_HANDLING = "handling"
_WRITING = "writing"
_PARKED = "parked"
_IDLE_STATES = (_IDLE, _PARKED)


class _Conn:
    __slots__ = (
        "sock", "fd", "addr", "rbuf", "wbuf", "state", "keep_alive",
        "last_activity", "waiter", "deadline", "next_poll",
        "sse_streaming", "notify_pending_at", "mask", "close_after_write",
        "upstream",
    )

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.fd = sock.fileno()
        self.addr = addr
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.state = _IDLE
        self.keep_alive = True
        self.last_activity = time.monotonic()
        self.waiter: Optional[Waiter] = None
        self.deadline: Optional[float] = None
        self.next_poll: Optional[float] = None
        self.sse_streaming = False
        self.notify_pending_at: Optional[float] = None
        self.mask = 0
        self.close_after_write = False
        self.upstream: Optional["_UpstreamConn"] = None


class _UpstreamConn:
    """Loop-side state of one in-flight proxied request: the upstream
    socket currently being tried plus the client connection awaiting
    the relay. One instance survives failover — ``sock`` is replaced
    per attempt, ``index`` walks ``upstream.targets``."""

    __slots__ = (
        "client", "upstream", "index", "sock", "fd", "rbuf", "wbuf",
        "connected", "deadline", "mask", "last_5xx",
    )

    def __init__(self, client: _Conn, upstream: Upstream):
        self.client = client
        self.upstream = upstream
        self.index = 0
        self.sock: Optional[socket.socket] = None
        self.fd = -1
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.connected = False
        self.deadline: Optional[float] = None
        self.mask = 0
        self.last_5xx: Optional[tuple] = None


def _raw_response(status_line: str, headers, body: bytes, keep_alive: bool) -> bytes:
    """Serialize a (status line, headers, body) answer to HTTP/1.1."""
    out = [f"HTTP/1.1 {status_line}\r\n".encode("latin-1")]
    saw_length = False
    for key, value in headers:
        lower = key.lower()
        if lower == "connection":
            continue  # the loop owns connection lifecycle
        if lower == "content-length":
            saw_length = True
        out.append(f"{key}: {value}\r\n".encode("latin-1"))
    if not saw_length:
        out.append(f"Content-Length: {len(body)}\r\n".encode("latin-1"))
    out.append(
        b"Connection: keep-alive\r\n" if keep_alive else b"Connection: close\r\n"
    )
    out.append(b"\r\n")
    out.append(body)
    return b"".join(out)


def _status_line(status: int) -> str:
    return f"{status} {_http_reasons.get(status, 'Unknown')}"


class LoopServer:
    """Serve a ``WebApp`` from one ``selectors`` loop plus a bounded
    handler pool. Constructor binds immediately (``port=0`` picks a
    free port, exposed as ``.port`` — ServerThread parity)."""

    def __init__(
        self,
        app,
        host: str,
        port: int,
        handlers: Optional[int] = None,
        max_conns: Optional[int] = None,
        header_timeout_s: float = 15.0,
        idle_timeout_s: Optional[float] = None,
    ):
        self._app = app
        self.host = host
        self._name = getattr(app, "name", "web")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1024)
        self._listener.setblocking(False)
        self.port = self._listener.getsockname()[1]
        self._max_conns = max_conns if max_conns is not None else max_connections()
        self._header_timeout_s = header_timeout_s
        self._idle_timeout_s = idle_timeout_s
        width = handlers if handlers is not None else handler_pool_size()
        self._pool = ThreadPoolExecutor(
            max_workers=width, thread_name_prefix=f"{self._name}-web-handler"
        )
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        # cross-thread command inbox; deque append/popleft are atomic
        # under the GIL, so no lock guards it by design
        self._commands: collections.deque = collections.deque()
        self._conns: dict[int, _Conn] = {}
        self._parked: set[_Conn] = set()
        self._upstreams: set[_UpstreamConn] = set()
        self._stopping = False
        self._stop_deadline = 0.0
        self._last_sweep = time.monotonic()
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"{self._name}-webloop"
        )
        registry = getattr(app, "registry", None) or _metrics.global_registry()
        self._g_conns = registry.gauge(
            "lo_web_connections",
            "Open HTTP connections (idle = keep-alive or parked waiter)",
            labels=("service", "state"),
        )
        self._g_waiters = registry.gauge(
            "lo_web_waiters",
            "Long-poll/SSE waiters parked on the event loop",
            labels=("service",),
        )
        self._h_notify = registry.histogram(
            "lo_web_notify_seconds",
            "Waiter wake latency: done-event set to response bytes on wire",
            labels=("service",),
            buckets=_NOTIFY_BUCKETS,
        )
        self._refresh_gauges()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "LoopServer":
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.start()
        self._thread.join()

    def stop(self) -> None:
        if self._thread.ident is None:
            # never started: no loop to drain, only the sockets to close
            for sock in (self._listener, self._wake_r, self._wake_w):
                sock.close()
            self._stopped.set()
        self._post(("stop", None))
        self._stopped.wait(timeout=5)
        self._pool.shutdown(wait=False)

    @property
    def waiter_count(self) -> int:
        return len(self._parked)

    # -- cross-thread commands --------------------------------------------

    def _post(self, command) -> None:
        self._commands.append(command)
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass  # buffer full (loop already waking) or shut down

    # -- the loop ----------------------------------------------------------

    def _run(self) -> None:
        self._sel.register(self._listener, selectors.EVENT_READ, "listener")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while True:
                for key, mask in self._sel.select(self._next_timeout()):
                    if key.data == "listener":
                        self._accept()
                    elif key.data == "wake":
                        self._drain_wake()
                    elif isinstance(key.data, _UpstreamConn):
                        ups = key.data
                        if mask & selectors.EVENT_WRITE:
                            self._upstream_writable(ups)
                        if (
                            ups in self._upstreams
                            and mask & selectors.EVENT_READ
                        ):
                            self._upstream_readable(ups)
                    else:
                        conn = key.data
                        if mask & selectors.EVENT_READ:
                            self._on_readable(conn)
                        if (
                            self._conns.get(conn.fd) is conn
                            and mask & selectors.EVENT_WRITE
                        ):
                            self._on_writable(conn)
                self._drain_commands()
                self._service_timers()
                if self._stopping and self._drained():
                    break
        except Exception:  # noqa: BLE001 — the loop must not die silently
            traceback.print_exc()
        finally:
            for conn in list(self._conns.values()):
                self._close(conn)
            for sock in (self._listener, self._wake_r, self._wake_w):
                try:
                    sock.close()
                except OSError:
                    pass
            self._stopped.set()

    def _next_timeout(self) -> float:
        timeout = 0.05 if self._stopping else 1.0
        now = time.monotonic()
        for conn in self._parked:
            if conn.deadline is not None:
                timeout = min(timeout, max(conn.deadline - now, 0.0))
            if conn.next_poll is not None:
                timeout = min(timeout, max(conn.next_poll - now, 0.0))
        for ups in self._upstreams:
            if ups.deadline is not None:
                timeout = min(timeout, max(ups.deadline - now, 0.0))
        return timeout

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except OSError:
            pass  # BlockingIOError: drained

    def _drain_commands(self) -> None:
        while True:
            try:
                kind, payload = self._commands.popleft()
            except IndexError:
                return
            if kind == "stop":
                self._begin_stop()
            elif kind == "respond":
                conn, raw = payload
                if self._alive(conn):
                    conn.state = _WRITING
                    self._queue_write(conn, raw, close=not conn.keep_alive)
            elif kind == "park":
                conn, waiter = payload
                if self._alive(conn):
                    self._park(conn, waiter)
                else:
                    waiter._wake = None
            elif kind == "proxy":
                conn, upstream = payload
                if self._alive(conn):
                    self._proxy_start(conn, upstream)
            elif kind == "wake":
                conn = payload
                if self._alive(conn) and conn.state == _PARKED:
                    self._try_resolve(conn)

    def _alive(self, conn: _Conn) -> bool:
        return self._conns.get(conn.fd) is conn

    # -- accept / read / write --------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            if len(self._conns) >= self._max_conns or self._stopping:
                try:
                    sock.send(_BUSY_RESPONSE)  # best-effort: tiny, fresh buffer
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, addr)
            self._conns[conn.fd] = conn
            conn.mask = selectors.EVENT_READ
            self._sel.register(sock, conn.mask, conn)
            self._refresh_gauges()

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_READ_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            # peer hung up — a parked waiter dies with its connection
            self._close(conn)
            return
        conn.last_activity = time.monotonic()
        conn.rbuf += data
        if conn.state == _IDLE:
            conn.state = _READING
            self._refresh_gauges()
        if conn.state == _READING:
            self._advance_read(conn)
        elif len(conn.rbuf) > _MAX_BUFFERED_BYTES:
            self._close(conn)  # pipelining abuse while a request runs

    def _advance_read(self, conn: _Conn) -> None:
        head_end = conn.rbuf.find(b"\r\n\r\n")
        if head_end < 0:
            if len(conn.rbuf) > _MAX_HEADER_BYTES:
                self._respond_error(conn, 431, "header_too_large")
            return
        head = bytes(conn.rbuf[:head_end])
        lines = head.split(b"\r\n")
        parts = lines[0].split()
        if len(parts) != 3:
            self._respond_error(conn, 400, "bad_request_line")
            return
        method, target, version = parts
        headers: dict[bytes, bytes] = {}
        for line in lines[1:]:
            key, sep, value = line.partition(b":")
            if not sep:
                self._respond_error(conn, 400, "bad_header")
                return
            headers[key.strip().lower()] = value.strip()
        if b"chunked" in headers.get(b"transfer-encoding", b"").lower():
            self._respond_error(conn, 501, "chunked_request_unsupported")
            return
        try:
            length = int(headers.get(b"content-length", b"0") or b"0")
        except ValueError:
            self._respond_error(conn, 400, "bad_content_length")
            return
        body_start = head_end + 4
        if len(conn.rbuf) - body_start < length:
            if len(conn.rbuf) > _MAX_BUFFERED_BYTES:
                self._close(conn)
            return  # body still arriving
        body = bytes(conn.rbuf[body_start:body_start + length])
        del conn.rbuf[:body_start + length]
        connection = headers.get(b"connection", b"").lower()
        conn.keep_alive = (
            connection == b"keep-alive"
            if version == b"HTTP/1.0"
            else connection != b"close"
        )
        request = self._build_request(method, target, headers, body)
        conn.state = _HANDLING
        self._refresh_gauges()
        self._pool.submit(self._handle, conn, request)

    def _build_request(
        self,
        method: bytes,
        target: bytes,
        headers: dict[bytes, bytes],
        body: bytes,
    ):
        """The port's ``Request`` for one parsed request, marked
        ``on_loop``: ``WebApp.handle`` then gives a returned ``Waiter``
        or ``Upstream`` back instead of blocking this (pooled) thread."""
        from learningorchestra_tpu_torch.utils.web import Request

        request = Request(
            method.decode("latin-1"),
            target.decode("latin-1"),
            {
                key.decode("latin-1"): value.decode("latin-1")
                for key, value in headers.items()
            },
            body,
        )
        request.on_loop = True
        return request

    def _handle(self, conn: _Conn, request) -> None:
        """Pool thread: run the app, then hand the outcome back to the
        loop — a serialized response, a waiter to park or an upstream to
        proxy."""
        try:
            answer = self._app.handle(request)
            if isinstance(answer, Waiter):
                self._post(("park", (conn, answer)))
                return
            if isinstance(answer, Upstream):
                self._post(("proxy", (conn, answer)))
                return
            raw = _raw_response(
                _status_line(answer.status_code),
                list(answer.headers.items()),
                answer.data,
                conn.keep_alive,
            )
        except Exception:  # noqa: BLE001 — the web layer itself failed
            traceback.print_exc()
            body = json.dumps({"result": "internal_error"}).encode("utf-8")
            raw = _raw_response(
                "500 Internal Server Error",
                [("Content-Type", "application/json")],
                body,
                False,
            )
            conn.keep_alive = False
        self._post(("respond", (conn, raw)))

    def _queue_write(self, conn: _Conn, raw: bytes, close: bool) -> None:
        conn.wbuf += raw
        conn.close_after_write = conn.close_after_write or close
        self._refresh_gauges()
        self._on_writable(conn)  # opportunistic synchronous flush

    def _on_writable(self, conn: _Conn) -> None:
        sent_total = 0
        error = False
        if conn.wbuf:
            view = memoryview(conn.wbuf)
            try:
                while sent_total < len(view):
                    try:
                        sent = conn.sock.send(view[sent_total:])
                    except (BlockingIOError, InterruptedError):
                        break
                    except OSError:
                        error = True
                        break
                    if sent <= 0:
                        break
                    sent_total += sent
            finally:
                view.release()
            del conn.wbuf[:sent_total]
        if error:
            self._close(conn)
            return
        self._update_mask(conn)
        if conn.wbuf:
            return
        if conn.notify_pending_at is not None:
            self._h_notify.labels(self._name).observe(
                time.monotonic() - conn.notify_pending_at
            )
            conn.notify_pending_at = None
        if conn.close_after_write:
            self._close(conn)
            return
        if conn.state == _WRITING:
            conn.state = _IDLE
            conn.last_activity = time.monotonic()
            self._refresh_gauges()
            if conn.rbuf:
                # pipelined request already buffered: parse it now
                conn.state = _READING
                self._advance_read(conn)

    def _update_mask(self, conn: _Conn) -> None:
        mask = selectors.EVENT_READ
        if conn.wbuf:
            mask |= selectors.EVENT_WRITE
        if mask != conn.mask and self._alive(conn):
            conn.mask = mask
            try:
                self._sel.modify(conn.sock, mask, conn)
            except (KeyError, ValueError, OSError):
                pass

    def _respond_error(self, conn: _Conn, status: int, slug: str) -> None:
        body = json.dumps({"result": slug}).encode("utf-8")
        raw = _raw_response(
            _status_line(status),
            [("Content-Type", "application/json")],
            body,
            False,
        )
        conn.rbuf.clear()
        conn.state = _WRITING
        self._queue_write(conn, raw, close=True)

    # -- upstream proxying -------------------------------------------------

    def _proxy_start(self, conn: _Conn, upstream: Upstream) -> None:
        if conn.upstream is not None:  # defensive: one proxy per request
            self._abort_upstream(conn.upstream)
        ups = _UpstreamConn(conn, upstream)
        conn.upstream = ups
        self._upstreams.add(ups)
        self._proxy_attempt(ups)

    def _proxy_attempt(self, ups: _UpstreamConn) -> None:
        """Open a non-blocking connection to the current target and
        register it in the loop's selector; immediate failures advance
        the index without recursing."""
        while True:
            if ups.index >= len(ups.upstream.targets):
                self._proxy_exhausted(ups)
                return
            target = ups.upstream.targets[ups.index]
            if ups.upstream.on_attempt is not None:
                try:
                    ups.upstream.on_attempt(ups.index, target)
                except Exception:  # noqa: BLE001 — observer must not kill
                    traceback.print_exc()
            try:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                sock.setblocking(False)
                sock.connect_ex(target)  # EINPROGRESS reports via SO_ERROR
            except OSError:
                ups.index += 1
                continue
            ups.sock = sock
            ups.fd = sock.fileno()
            ups.rbuf = bytearray()
            ups.wbuf = bytearray(ups.upstream.raw_request)
            ups.connected = False
            ups.deadline = time.monotonic() + ups.upstream.timeout_s
            ups.mask = selectors.EVENT_WRITE
            try:
                self._sel.register(sock, ups.mask, ups)
            except (KeyError, ValueError, OSError):
                try:
                    sock.close()
                except OSError:
                    pass
                ups.index += 1
                continue
            return

    def _upstream_writable(self, ups: _UpstreamConn) -> None:
        if ups.sock is None or ups not in self._upstreams:
            return
        if not ups.connected:
            try:
                error = ups.sock.getsockopt(
                    socket.SOL_SOCKET, socket.SO_ERROR
                )
            except OSError:
                error = 1
            if error:
                self._proxy_retry(ups)
                return
            ups.connected = True
        sent_total = 0
        failed = False
        if ups.wbuf:
            view = memoryview(ups.wbuf)
            try:
                while sent_total < len(view):
                    try:
                        sent = ups.sock.send(view[sent_total:])
                    except (BlockingIOError, InterruptedError):
                        break
                    except OSError:
                        failed = True
                        break
                    if sent <= 0:
                        break
                    sent_total += sent
            finally:
                view.release()
            del ups.wbuf[:sent_total]
        if failed:
            self._proxy_retry(ups)
            return
        mask = selectors.EVENT_READ
        if ups.wbuf:
            mask |= selectors.EVENT_WRITE
        if mask != ups.mask:
            ups.mask = mask
            try:
                self._sel.modify(ups.sock, mask, ups)
            except (KeyError, ValueError, OSError):
                pass

    def _upstream_readable(self, ups: _UpstreamConn) -> None:
        if ups.sock is None or not ups.connected:
            # stale event for a socket a failover just replaced
            return
        try:
            data = ups.sock.recv(_READ_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._proxy_retry(ups)
            return
        eof = not data
        if data:
            ups.rbuf += data
        try:
            parsed = _parse_http_response(ups.rbuf, eof=eof)
        except ValueError:
            self._proxy_retry(ups)
            return
        if parsed is None:
            if eof or len(ups.rbuf) > _MAX_BUFFERED_BYTES:
                self._proxy_retry(ups)  # torn or abusive reply
            return
        if parsed[0] >= 500:
            ups.last_5xx = parsed
            self._proxy_retry(ups)
            return
        self._proxy_relay(ups, parsed)

    def _proxy_retry(self, ups: _UpstreamConn) -> None:
        self._drop_upstream_socket(ups)
        ups.index += 1
        if not self._alive(ups.client):
            self._abort_upstream(ups)  # client left: nothing to answer
            return
        self._proxy_attempt(ups)

    def _proxy_exhausted(self, ups: _UpstreamConn) -> None:
        if ups.last_5xx is not None:
            # the real upstream error beats a synthetic 502
            self._proxy_relay(ups, ups.last_5xx)
            return
        payload, status = ups.upstream.on_exhausted()
        body = json.dumps(payload).encode("utf-8")
        self._proxy_relay(
            ups,
            (
                status,
                _http_reasons.get(status, "Unknown"),
                [("Content-Type", "application/json")],
                body,
            ),
        )

    def _proxy_relay(self, ups: _UpstreamConn, parsed: tuple) -> None:
        self._drop_upstream_socket(ups)
        self._upstreams.discard(ups)
        conn = ups.client
        if conn.upstream is ups:
            conn.upstream = None
        if not self._alive(conn):
            return
        status, reason, headers, body = parsed
        upstream = ups.upstream
        if upstream.on_complete is not None:
            try:
                upstream.on_complete(status)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        header_list = _relay_headers(headers)
        if upstream.correlation_id and not any(
            key.lower() == "x-correlation-id" for key, _ in header_list
        ):
            header_list.append(
                (_tracing.CORRELATION_HEADER, upstream.correlation_id)
            )
        raw = _raw_response(
            f"{status} {reason or _http_reasons.get(status, 'Unknown')}",
            header_list,
            body,
            conn.keep_alive,
        )
        conn.state = _WRITING
        self._queue_write(conn, raw, close=not conn.keep_alive)

    def _drop_upstream_socket(self, ups: _UpstreamConn) -> None:
        if ups.sock is None:
            return
        try:
            self._sel.unregister(ups.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            ups.sock.close()
        except OSError:
            pass
        ups.sock = None
        ups.connected = False
        ups.deadline = None

    def _abort_upstream(self, ups: _UpstreamConn) -> None:
        self._drop_upstream_socket(ups)
        self._upstreams.discard(ups)
        if ups.client is not None and ups.client.upstream is ups:
            ups.client.upstream = None

    # -- waiters -----------------------------------------------------------

    def _park(self, conn: _Conn, waiter: Waiter) -> None:
        # already-ready (e.g. already-terminal job): answer immediately,
        # never park
        result = waiter.poll()
        if result is not None:
            self._finish_waiter(conn, waiter, result, "ready")
            return
        now = time.monotonic()
        conn.waiter = waiter
        conn.deadline = now + waiter.timeout_s
        conn.next_poll = (
            now + waiter.interval_s if waiter.interval_s else None
        )
        waiter._wake = lambda: self._post(("wake", conn))
        conn.state = _PARKED
        self._parked.add(conn)
        self._refresh_gauges()
        if waiter.sse:
            self._queue_sse_head(conn, waiter)
        if waiter._event.is_set():
            # notify() fired between the handler's poll and this park
            self._try_resolve(conn)

    def _queue_sse_head(self, conn: _Conn, waiter: Waiter) -> None:
        """SSE parks with its headers + retry preamble already on the
        wire, so the client knows the stream is live."""
        headers = [
            b"HTTP/1.1 200 OK\r\n",
            b"Content-Type: text/event-stream\r\n",
            b"Cache-Control: no-cache\r\n",
            b"Connection: close\r\n",
        ]
        if waiter.correlation_id:
            headers.append(
                f"{_tracing.CORRELATION_HEADER}: {waiter.correlation_id}\r\n".encode(
                    "latin-1"
                )
            )
        headers.append(b"\r\n")
        conn.sse_streaming = True
        self._queue_write(conn, b"".join(headers) + SSE_PREAMBLE, close=False)

    def _try_resolve(self, conn: _Conn) -> None:
        waiter = conn.waiter
        if waiter is None:
            return
        waiter._event.clear()
        result = waiter.poll()
        if result is None:
            waiter.notified_at = None  # spurious notify: stay parked
            return
        self._finish_waiter(conn, waiter, result, "ready")

    def _finish_waiter(
        self, conn: _Conn, waiter: Waiter, result: tuple, kind: str
    ) -> None:
        waiter._wake = None
        if waiter.notified_at is not None:
            conn.notify_pending_at = waiter.notified_at
        self._parked.discard(conn)
        conn.waiter = None
        conn.deadline = None
        conn.next_poll = None
        if waiter.sse:
            status = 200
        else:
            status = result[1]
        if waiter.on_complete is not None:
            try:
                waiter.on_complete(status)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        if conn.sse_streaming:
            # headers + preamble already sent at park: final frame only
            conn.sse_streaming = False
            event = "done" if kind == "ready" else "timeout"
            conn.state = _WRITING
            self._queue_write(conn, sse_frame(event, result[0]), close=True)
            return
        body, status, content_type = waiter_body(waiter, result, kind)
        header_list = [("Content-Type", content_type)]
        if waiter.correlation_id:
            header_list.append((_tracing.CORRELATION_HEADER, waiter.correlation_id))
        close = waiter.sse or not conn.keep_alive
        raw = _raw_response(_status_line(status), header_list, body, not close)
        conn.state = _WRITING
        self._queue_write(conn, raw, close=close)

    # -- timers ------------------------------------------------------------

    def _service_timers(self) -> None:
        now = time.monotonic()
        if now - self._last_sweep >= 1.0:
            self._last_sweep = now
            for conn in list(self._conns.values()):
                stalled = now - conn.last_activity
                if (
                    conn.state == _READING
                    and stalled > self._header_timeout_s
                ):
                    # slow-loris: a partial request may not hold its
                    # buffer open indefinitely
                    self._respond_error(conn, 408, "request_timeout")
                elif (
                    conn.state == _IDLE
                    and self._idle_timeout_s is not None
                    and stalled > self._idle_timeout_s
                ):
                    self._close(conn)
        for conn in list(self._parked):
            waiter = conn.waiter
            if waiter is None:
                continue
            if conn.deadline is not None and now >= conn.deadline:
                self._finish_waiter(conn, waiter, waiter.on_timeout(), "timeout")
            elif conn.next_poll is not None and now >= conn.next_poll:
                conn.next_poll = now + (waiter.interval_s or 1.0)
                self._try_resolve(conn)
        for ups in list(self._upstreams):
            if ups.deadline is not None and now >= ups.deadline:
                self._proxy_retry(ups)  # stalled attempt: next target

    # -- shutdown ----------------------------------------------------------

    def _begin_stop(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        self._stop_deadline = time.monotonic() + 2.0
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # graceful drain: every parked waiter resolves with its timeout
        # response — no client is left hanging on a dead socket
        for conn in list(self._parked):
            waiter = conn.waiter
            if waiter is not None:
                self._finish_waiter(
                    conn, waiter, waiter.on_timeout(), "timeout"
                )

    def _drained(self) -> bool:
        if time.monotonic() >= self._stop_deadline:
            return True
        return not any(
            conn.wbuf or conn.state == _HANDLING
            for conn in self._conns.values()
        )

    # -- bookkeeping -------------------------------------------------------

    def _close(self, conn: _Conn) -> None:
        if self._conns.get(conn.fd) is not conn:
            return
        del self._conns[conn.fd]
        self._parked.discard(conn)
        if conn.waiter is not None:
            conn.waiter._wake = None
            conn.waiter = None
        if conn.upstream is not None:
            self._abort_upstream(conn.upstream)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        idle = active = 0
        for conn in self._conns.values():
            if conn.state in _IDLE_STATES:
                idle += 1
            else:
                active += 1
        self._g_conns.labels(self._name, "idle").set(idle)
        self._g_conns.labels(self._name, "active").set(active)
        self._g_waiters.labels(self._name).set(len(self._parked))
