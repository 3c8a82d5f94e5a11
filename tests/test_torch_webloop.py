"""The JAX package's event-loop tests (``tests/test_web_async.py``), run on
the port's ``utils/webloop.py`` and ``utils/web.py``.

Their source is read and run here with every module path pointed at the
port's: the ``/wait`` contract (immediate answer, timeout hint, 404
parity, cancel wake), the SSE goldens and the loop's framing against the
blocking body, keep-alive pipelining, slow-loris eviction, the graceful
drain, the connection cap, 30 parked waiters on a pool of 4, the
``lo_web_*`` families, ``LO_WEB_ASYNC=0``'s byte parity (through
``ServerThread._loop``), the knobs and the ``Waiter`` unit. No line of
the source is edited: the port keeps the module and public names, its
``ServerThread`` exposes ``_loop`` as the reference's does, and its
``Response`` has the ``content_type`` the SSE golden reads. The
reference's client (``learningorchestra_tpu.client``, plain HTTP) stays
the client of ``TestClientPush``, now against the port's loop.

Below them, the port against the JAX package and the port's own
framing:

- ``sse_frame`` and ``waiter_body`` give the same bytes for the same
  payloads, SSE and JSON, ready and timed out;
- a HEAD on the loop carries one ``Content-Length`` (the GET's) and no
  body, and the loop owns ``Connection``;
- ``ServerThread`` serves on the loop unless ``LO_WEB_ASYNC=0``, and a
  stopped loop closes its kept-alive connections;
- a ``Waiter`` notified for a job's same-name successor stays parked;
- a request past the loop's 64 MB buffer cap is dropped, not served,
  and the store client cuts its large uploads into frames under it.
"""

import json
import pathlib
import re
import socket
import threading
import time

import pytest

from learningorchestra_tpu.utils import webloop as jax_webloop
from learningorchestra_tpu_torch.utils import web as port_web
from learningorchestra_tpu_torch.utils import webloop as port_webloop

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_web_async.py")

_source = REFERENCE_TESTS.read_text()
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_tests_run_on_the_port():
    """The tests above build the port's apps, job manager and servers."""
    from learningorchestra_tpu_torch.core.jobs import JobManager as PortJobManager

    assert webloop is port_webloop  # noqa: F821
    assert ServerThread is port_web.ServerThread  # noqa: F821
    assert WebApp is port_web.WebApp  # noqa: F821
    assert JobManager is PortJobManager  # noqa: F821
    assert re.findall(r"learningorchestra_tpu\.\w+", _source) == []
    tests = [name for name in list(globals()) if name.startswith("Test")]
    assert len(tests) >= 7


# --- the port against the JAX package ---------------------------------------

PAYLOADS = [
    {"result": "timeout", "job": "j", "state": "running"},
    {"result": {"name": "build:x", "state": "finished", "error": None, "n": 3}},
    {"unicode": "café ✓", "nested": [1, 2.5, None, True]},
    [],
    "plain",
]


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("event", ["done", "timeout"])
def test_sse_frames_are_the_references(event, payload):
    assert port_webloop.sse_frame(event, payload) == jax_webloop.sse_frame(event, payload)
    assert port_webloop.SSE_PREAMBLE == jax_webloop.SSE_PREAMBLE


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("sse", [False, True])
@pytest.mark.parametrize("kind,status", [("ready", 200), ("timeout", 200), ("ready", 404)])
def test_waiter_bodies_are_the_references(payload, sse, kind, status):
    def waiter_of(module):
        return module.Waiter(lambda: None, 1.0, lambda: (payload, status), sse=sse)

    ours = port_webloop.waiter_body(waiter_of(port_webloop), (payload, status), kind)
    theirs = jax_webloop.waiter_body(waiter_of(jax_webloop), (payload, status), kind)
    assert ours == theirs


# --- the port's loop ---------------------------------------------------------


def _raw_exchange(port: int, request: bytes) -> bytes:
    sock = socket.create_connection(("127.0.0.1", port), 10)
    sock.settimeout(10)
    try:
        sock.sendall(request)
        return _read_until_close(sock)  # noqa: F821
    finally:
        sock.close()


def test_head_on_the_loop_has_one_content_length():
    app, _ = make_app()  # noqa: F821
    server = port_webloop.LoopServer(app, "127.0.0.1", 0).start()
    try:
        get = _raw_exchange(server.port, b"GET /health HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
        head = _raw_exchange(server.port, b"HEAD /health HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
    finally:
        server.stop()
    get_head, _, get_body = get.partition(b"\r\n\r\n")
    head_head, _, head_body = head.partition(b"\r\n\r\n")
    assert head_body == b""
    lengths = [line for line in head_head.split(b"\r\n") if line.lower().startswith(b"content-length:")]
    assert lengths == [b"Content-Length: %d" % len(get_body)]
    assert head_head.count(b"Connection:") == 1 and b"Connection: close" in head_head


@pytest.mark.parametrize("flag", ["", "1", "0"])
def test_server_thread_serves_on_the_loop_by_default(monkeypatch, flag):
    if flag:
        monkeypatch.setenv("LO_WEB_ASYNC", flag)
    else:
        monkeypatch.delenv("LO_WEB_ASYNC", raising=False)
    app, _ = make_app()  # noqa: F821
    server = ServerThread(app).start()  # noqa: F821
    try:
        assert (server._loop is not None) == (flag != "0")
        sock = socket.create_connection(("127.0.0.1", server.port), 10)
        sock.settimeout(10)
        sock.sendall(b"GET /health HTTP/1.1\r\nHost: t\r\n\r\n")
        head, body, _ = _read_response(sock)  # noqa: F821
        assert json.loads(body)["job_wait"] is True
    finally:
        server.stop()
    # the stopped server closed the kept-alive connection
    try:
        sock.sendall(b"GET /health HTTP/1.1\r\nHost: t\r\n\r\n")
        assert sock.recv(65536) == b""
    except OSError:
        pass
    finally:
        sock.close()


def test_a_malformed_flag_refuses_the_server(monkeypatch):
    monkeypatch.setenv("LO_WEB_ASYNC", "yes")
    app, _ = make_app()  # noqa: F821
    with pytest.raises(ValueError, match="LO_WEB_ASYNC"):
        ServerThread(app)  # noqa: F821


def test_a_successor_notify_is_spurious(monkeypatch):
    """A notify whose poll still answers None leaves the waiter parked:
    the loop answers only when the watched record is terminal."""
    state = {"ready": False}
    waiter = port_webloop.Waiter(
        lambda: ({"result": "done"}, 200) if state["ready"] else None, 5.0, lambda: ({"result": "timeout"}, 200),
    )
    app = port_web.WebApp("spurious")

    @app.route("/park")
    def park(request):
        return waiter

    server = port_webloop.LoopServer(app, "127.0.0.1", 0).start()
    try:
        sock = socket.create_connection(("127.0.0.1", server.port), 10)
        sock.settimeout(10)
        sock.sendall(b"GET /park HTTP/1.1\r\nHost: t\r\n\r\n")
        deadline = time.monotonic() + 10
        while server.waiter_count < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        waiter.notify()
        time.sleep(0.2)
        assert server.waiter_count == 1
        state["ready"] = True
        waiter.notify()
        _, body, _ = _read_response(sock)  # noqa: F821
        sock.close()
        assert json.loads(body) == {"result": "done"}
        assert server.waiter_count == 0
    finally:
        server.stop()


def test_a_request_past_the_buffer_cap_is_dropped(monkeypatch):
    monkeypatch.setattr(port_webloop, "_MAX_BUFFERED_BYTES", 1 << 16)
    app = port_web.WebApp("capped")
    seen = []

    @app.route("/upload", methods=("POST",))
    def upload(request):
        seen.append(len(request.data))
        return {"result": "ok"}, 200

    server = port_webloop.LoopServer(app, "127.0.0.1", 0).start()
    try:
        body = b"x" * (1 << 17)
        sock = socket.create_connection(("127.0.0.1", server.port), 10)
        sock.settimeout(10)
        try:
            sock.sendall(b"POST /upload HTTP/1.1\r\nHost: t\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
            assert sock.recv(65536) == b""
        except OSError:
            pass
        finally:
            sock.close()
        small = b"y" * 1000
        raw = _raw_exchange(
            server.port,
            b"POST /upload HTTP/1.1\r\nHost: t\r\nConnection: close\r\nContent-Length: %d\r\n\r\n" % len(small) + small,
        )
        assert b"200 OK" in raw.split(b"\r\n", 1)[0]
        assert seen == [1000]
    finally:
        server.stop()


def test_an_upstream_relays_on_the_loop_and_blocking(monkeypatch):
    """One ``Upstream`` with a dead first target: the loop and the
    blocking walk both fail over and relay the live target's answer."""
    backend = port_web.WebApp("backend")

    @backend.route("/echo", methods=("POST",))
    def echo(request):
        return {"result": json.loads(request.data)}, 200

    live = port_webloop.LoopServer(backend, "127.0.0.1", 0).start()
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()
    attempts = []
    front = port_web.WebApp("front")

    @front.route("/relay", methods=("POST",))
    def relay(request):
        body = request.get_data()
        raw = (
            b"POST /echo HTTP/1.1\r\nHost: b\r\nContent-Type: application/json\r\n"
            b"Content-Length: %d\r\nConnection: close\r\n\r\n" % len(body)
        ) + body
        return port_webloop.Upstream(
            [("127.0.0.1", dead_port), ("127.0.0.1", live.port)], raw, timeout_s=5.0,
            on_attempt=lambda index, target: attempts.append(index),
        )

    server = port_webloop.LoopServer(front, "127.0.0.1", 0).start()
    try:
        payload = json.dumps({"n": 7}).encode()
        raw = _raw_exchange(
            server.port,
            b"POST /relay HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\nConnection: close\r\n"
            b"Content-Length: %d\r\n\r\n" % len(payload) + payload,
        )
        head, _, body = raw.partition(b"\r\n\r\n")
        assert b"200 OK" in head.split(b"\r\n", 1)[0]
        assert json.loads(body) == {"result": {"n": 7}}
        blocking = front.test_client().post("/relay", json={"n": 7})
        assert blocking.status_code == 200 and blocking.get_json() == {"result": {"n": 7}}
        assert attempts == [0, 1, 0, 1]
    finally:
        server.stop()
        live.stop()


def test_loop_waiters_book_the_request_counters_at_resolution():
    app, jobs = make_app()  # noqa: F821
    release = threading.Event()
    jobs.submit("booked", _blocked, release)  # noqa: F821
    server = port_webloop.LoopServer(app, "127.0.0.1", 0).start()
    counter = app._requests_total
    before = counter.value("waitsvc", "/jobs/<job_name>/wait", "GET", 200)
    try:
        sock = socket.create_connection(("127.0.0.1", server.port), 10)
        sock.settimeout(10)
        sock.sendall(b"GET /jobs/booked/wait?timeout=20 HTTP/1.1\r\nHost: t\r\n\r\n")
        deadline = time.monotonic() + 10
        while server.waiter_count < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert counter.value("waitsvc", "/jobs/<job_name>/wait", "GET", 200) == before
        release.set()
        _read_response(sock)  # noqa: F821
        sock.close()
        assert counter.value("waitsvc", "/jobs/<job_name>/wait", "GET", 200) == before + 1
    finally:
        release.set()
        server.stop()


def test_the_store_client_keeps_its_uploads_under_the_loops_cap(tmp_path, monkeypatch):
    """The loop drops a request past its buffer cap, so the store
    client cuts a large columnar upload (``insert_columns``,
    ``set_column``) into frames of at most ``_UPLOAD_FRAME_BYTES``;
    here both caps are cut down, and 3.2 MB of columns land whole
    through frames under the 1 MB cap."""
    import numpy as np

    from learningorchestra_tpu_torch.core import store_service
    from learningorchestra_tpu_torch.core.store import InMemoryStore

    monkeypatch.setattr(port_webloop, "_MAX_BUFFERED_BYTES", 1 << 20)
    monkeypatch.setattr(store_service, "_UPLOAD_FRAME_BYTES", 1 << 18)
    server = port_web.ServerThread(store_service.create_store_app(InMemoryStore())).start()
    client = store_service.RemoteStore(f"http://127.0.0.1:{server.port}")
    frames = []
    post_frame = client._post_frame

    def recorded(path, frame, **kwargs):
        frames.append(len(frame))
        return post_frame(path, frame, **kwargs)

    client._post_frame = recorded
    try:
        rows = 100_000
        values = np.random.default_rng(0).normal(size=(4, rows))
        client.insert_columns("big", {f"c{i}": values[i] for i in range(4)})
        client.set_column("big", "c0", values[3])
        read = client.read_column_arrays("big", ["c0", "c1"])
        np.testing.assert_array_equal(read["c0"].to_float64(), values[3])
        np.testing.assert_array_equal(read["c1"].to_float64(), values[1])
        assert len(frames) > 10 and max(frames) < (1 << 20)
    finally:
        client.close()
        server.stop()
