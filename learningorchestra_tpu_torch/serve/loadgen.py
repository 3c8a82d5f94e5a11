"""Closed-loop load generator for the serving path.

Counterpart of ``learningorchestra_tpu/serve/loadgen.py``, module and
public names kept. Closed-loop (each client issues its next request
only after the previous one answered) is the honest shape for latency
measurement: an open-loop generator overruns a saturated server and
measures its own queue. :func:`run_closed_loop` reports p50/p99
latency and requests/s; :func:`http_predict_sender` drives it against
real sockets (stdlib ``http.client``), either spread across replica
targets or aimed at the router (one target).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Callable, Optional, Sequence
from urllib.parse import urlsplit

import numpy as np


def run_closed_loop(
    send: Callable,
    clients: int,
    requests_per_client: int,
    rows_per_request: int = 1,
    session_factory: Optional[Callable[[int], object]] = None,
) -> dict:
    """Run ``clients`` threads, each issuing ``requests_per_client``
    back-to-back calls to ``send(client_index)`` (which must perform one
    predict round-trip and raise on failure). Returns latency/throughput
    stats; any client error is re-raised after the loop drains.

    With ``session_factory``, each client builds its own session inside
    its thread, ``send(client_index, session)`` carries it, and the
    session is closed in ``finally`` — error paths included, so a
    failing client never leaks its connection. A client that dies
    before the start barrier aborts it rather than deadlocking the
    main thread.
    """
    latencies: list[list[float]] = [[] for _ in range(clients)]
    errors: list[Optional[BaseException]] = [None] * clients
    barrier = threading.Barrier(clients + 1)

    def client(index: int) -> None:
        mine = latencies[index]
        session = None
        try:
            if session_factory is not None:
                session = session_factory(index)
            barrier.wait()
            for _ in range(requests_per_client):
                started = time.perf_counter()
                if session_factory is not None:
                    send(index, session)
                else:
                    send(index)
                mine.append(time.perf_counter() - started)
        except BaseException as error:  # noqa: BLE001 — reported below
            errors[index] = error
            barrier.abort()
        finally:
            close = getattr(session, "close", None)
            if close is not None:
                close()

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True)
        for i in range(clients)
    ]
    for thread in threads:
        thread.start()
    try:
        barrier.wait()  # all clients release together: a real burst
    except threading.BrokenBarrierError:
        pass  # a client died during setup; its error re-raises below
    started = time.perf_counter()
    for thread in threads:
        thread.join()
    wall_s = time.perf_counter() - started
    for error in errors:
        # a setup failure breaks the barrier for every OTHER client too;
        # surface the root cause, not the collateral barrier errors
        if error is not None and not isinstance(
            error, threading.BrokenBarrierError
        ):
            raise error
    for error in errors:
        if error is not None:
            raise error
    flat = np.array([value for per in latencies for value in per])
    requests = int(flat.size)
    return {
        "clients": clients,
        "requests": requests,
        "wall_s": round(wall_s, 3),
        "p50_ms": round(float(np.percentile(flat, 50)) * 1000, 3),
        "p99_ms": round(float(np.percentile(flat, 99)) * 1000, 3),
        "mean_ms": round(float(flat.mean()) * 1000, 3),
        "requests_per_s": round(requests / wall_s, 1),
        "predictions_per_s": round(
            requests * rows_per_request / wall_s, 1
        ),
    }


def _host_port(target: str) -> tuple[str, int]:
    """``host:port`` from a target that may or may not carry a scheme."""
    parts = urlsplit(target if "//" in target else f"http://{target}")
    if parts.hostname is None or parts.port is None:
        raise ValueError(f"target needs host:port, got {target!r}")
    return parts.hostname, parts.port


class HttpSession:
    """One persistent HTTP connection to one target — the per-client
    session :func:`http_predict_sender` hands to the closed loop."""

    def __init__(self, target: str, timeout_s: float = 30.0):
        self.target = target
        host, port = _host_port(target)
        self._conn = http.client.HTTPConnection(host, port, timeout=timeout_s)

    def post_json(self, path: str, payload: dict) -> tuple[int, dict]:
        body = json.dumps(payload).encode()
        try:
            self._conn.request(
                "POST",
                path,
                body=body,
                headers={"Content-Type": "application/json"},
            )
            response = self._conn.getresponse()
            raw = response.read()
        except (http.client.HTTPException, OSError):
            # stale keep-alive (server closed between requests): one
            # reconnect, then let the caller see the failure
            self._conn.close()
            self._conn.request(
                "POST",
                path,
                body=body,
                headers={"Content-Type": "application/json"},
            )
            response = self._conn.getresponse()
            raw = response.read()
        try:
            decoded = json.loads(raw) if raw else {}
        except ValueError:
            decoded = {"raw": raw.decode(errors="replace")}
        return response.status, decoded

    def close(self) -> None:
        self._conn.close()


def http_predict_sender(
    targets: Sequence[str],
    model_name: str,
    rows,
    timeout_s: float = 30.0,
    on_response: Optional[Callable[[int, dict], None]] = None,
) -> tuple[Callable, Callable[[int], HttpSession]]:
    """``(send, session_factory)`` for :func:`run_closed_loop` against
    real sockets. Client ``i`` connects to ``targets[i % len(targets)]``
    — one target is router mode, several spread clients across replicas.
    ``on_response(status, body)`` observes every answer (chaos drills
    assert on it); without it any non-200 raises."""
    if not targets:
        raise ValueError("http_predict_sender needs at least one target")
    targets = list(targets)
    payload = {"rows": rows}
    path = f"/models/{model_name}/predict"

    def session_factory(index: int) -> HttpSession:
        return HttpSession(targets[index % len(targets)], timeout_s)

    def send(index: int, session: HttpSession) -> None:
        status, body = session.post_json(path, payload)
        if on_response is not None:
            on_response(status, body)
        elif status != 200:
            raise RuntimeError(
                f"predict via {session.target} failed: HTTP {status} {body}"
            )

    return send, session_factory
