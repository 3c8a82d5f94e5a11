"""SPMD job dispatch: the coordinator receives a job, every rank runs it.

Counterpart of ``learningorchestra_tpu/parallel/spmd.py``. A fit over a
mesh of several ranks (parallel/mesh.py) must be entered by EVERY rank:
one process cannot run it alone, since its first collective waits for
the others. The coordinator (rank 0) serves REST. The other ranks run
:meth:`SpmdDispatcher.run_worker_loop`, parked in a broadcast. Each job
the coordinator accepts is serialized to JSON and broadcast over the
``torch.distributed`` world group (:func:`_broadcast_json`: a length,
then the bytes), and every rank then runs the same handler with the same
payload. The collectives inside the handlers line up because every rank
enters the same handlers in the same order: the dispatcher's lock orders
the jobs, and the broadcast itself is the barrier between them.

Host-side effects (store writes, PNG rendering) stay with the
coordinator: the handlers (services/runner.make_dispatcher) pass
``write_outputs`` / ``render`` only there.

A process with no process group (or a world of one) skips all of this:
``submit`` calls the handler directly.

**The idle broadcast and the group's timeout.** A worker waiting for a
job is inside a live broadcast, and a collective that waits longer than
the process group's timeout fails: ``multihost.initialize_from_env``
sets it to ``DEFAULT_TIMEOUT_S`` (300 s). Under gloo the worker's
broadcast then raises and the worker exits; under NCCL the watchdog
aborts the process. So the coordinator's heartbeat
(:meth:`SpmdDispatcher.start_heartbeat`, ``LO_SPMD_HEARTBEAT_S``,
default 10 s) broadcasts a no-op ping while it is idle, thirty times
inside that timeout. Pings also probe the workers: a dead worker fails
the ping, and the dispatcher poisons itself before the next real job.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from typing import Any, Callable, Optional

import torch

from learningorchestra_tpu_torch.parallel.mesh import _world
from learningorchestra_tpu_torch.telemetry import metrics as _metrics
from learningorchestra_tpu_torch.telemetry import tracing as _tracing

_SHUTDOWN_OP = "__shutdown__"
_PING_OP = "__ping__"

_METRICS_CACHE: Optional[dict] = None


def _registry_metrics() -> dict:
    """Declared once and cached: ``_broadcast_json`` runs on every job and
    every heartbeat ping, and must not take the registry's lock for five
    declarations each time."""
    global _METRICS_CACHE
    if _METRICS_CACHE is None:
        _METRICS_CACHE = _build_metrics(_metrics.global_registry())
    return _METRICS_CACHE


def _build_metrics(registry) -> dict:
    return {
        "jobs": registry.counter(
            "lo_spmd_jobs_total",
            "SPMD jobs dispatched, by op and outcome",
            labels=("op", "outcome"),
        ),
        "seconds": registry.histogram(
            "lo_spmd_job_duration_seconds",
            "Coordinator-observed SPMD job wall-clock",
            labels=("op",),
        ),
        "broadcast_bytes": registry.counter(
            "lo_spmd_broadcast_bytes_total",
            "Payload bytes broadcast from the coordinator",
        ),
        "watchdog_trips": registry.counter(
            "lo_spmd_watchdog_trips_total",
            "Jobs killed by the dispatch watchdog",
        ),
        "poisoned": registry.gauge(
            "lo_spmd_poisoned",
            "1 once the collective stream is desynchronized",
        ),
    }


class SpmdJobError(RuntimeError):
    """A job over several ranks failed."""


class SpmdTimeoutError(SpmdJobError):
    """The job did not end within the watchdog's window. The usual cause
    is a worker dying mid-job, which leaves the coordinator waiting in a
    collective that can never complete."""


class SpmdRuntimePoisonedError(SpmdJobError):
    """An earlier job timed out or failed mid-collective: the ranks'
    collective streams are out of step and no further job can run
    safely. Recovery is restarting the processes."""


def process_count() -> int:
    """The world's size when a process group is up, else 1."""
    return _world()[0]


def process_index() -> int:
    """This process's rank when a process group is up, else 0."""
    return _world()[1]


def _broadcast_device(device=None) -> torch.device:
    """Where the broadcast's tensors live: this rank's card under NCCL
    (``device``, else the current one), the host under gloo."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        if device is not None and torch.device(device).type == "cuda":
            return torch.device(device)
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast_json(obj: Any = None, device=None) -> Any:
    """Broadcast a JSON-serializable object from rank 0 to every rank of
    the world group.

    Every rank calls this at the same point; rank 0 passes the object, the
    rest pass nothing and receive it. Two broadcasts: the payload's length
    as one int64, then its UTF-8 bytes as a uint8 tensor of that length.
    ``device``: the card of an NCCL rank (see :func:`_broadcast_device`).
    """
    import torch.distributed as dist

    where = _broadcast_device(device)
    coordinator = dist.get_rank() == 0
    payload = b""
    if coordinator:
        payload = json.dumps(obj).encode()
        _registry_metrics()["broadcast_bytes"].inc(len(payload))
    length = torch.tensor([len(payload)], dtype=torch.int64, device=where)
    dist.broadcast(length, src=0)
    if coordinator:
        buffer = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(where)
    else:
        buffer = torch.empty(int(length.item()), dtype=torch.uint8, device=where)
    dist.broadcast(buffer, src=0)   # JSON text is never empty
    return json.loads(bytes(buffer.cpu().numpy()).decode())


class SpmdDispatcher:
    """Routes jobs to every rank of the process group.

    ``device``: the card whose stream the broadcasts use under NCCL (the
    rank's own; None: the card current on the thread that makes the
    dispatcher). Gloo broadcasts through the host and ignores it."""

    def __init__(self, device=None) -> None:
        self._handlers: dict[str, Callable[[dict], Any]] = {_PING_OP: lambda payload: None}
        self._lock = threading.Lock()
        self._poisoned: Optional[str] = None  # the reason, once broken
        self._stop_heartbeat = threading.Event()
        self._metrics = _registry_metrics()
        if device is None and torch.cuda.is_available() and torch.cuda.is_initialized():
            device = torch.device("cuda", torch.cuda.current_device())
        self._device = device

    def _broadcast(self, obj: Any = None) -> Any:
        return _broadcast_json(obj, self._device)

    def _poison_locked(self, reason: str) -> None:
        # every caller holds self._lock (submit's ordering of jobs)
        self._poisoned = reason
        self._metrics["poisoned"].set(1)

    def _observe(self, op: str, outcome: str, started: float) -> None:
        if op == _PING_OP:  # keepalives would swamp the job series
            return
        self._metrics["jobs"].labels(op, outcome).inc()
        self._metrics["seconds"].labels(op).observe(time.perf_counter() - started)

    def start_heartbeat(self, interval: Optional[float] = None) -> None:
        """The coordinator's idle keepalive (module docstring): a no-op
        ping broadcast every ``interval`` seconds (``LO_SPMD_HEARTBEAT_S``,
        default 10), well inside the group's collective timeout that
        would otherwise end an idle worker's broadcast. A ping that fails
        poisons the dispatcher and stops the beat: recovery is a restart."""
        if process_count() == 1 or process_index() != 0:
            return
        if interval is None:
            interval = float(os.environ.get("LO_SPMD_HEARTBEAT_S", "10"))

        def beat() -> None:
            while not self._stop_heartbeat.wait(interval):
                if self._poisoned:
                    return
                try:
                    self.submit(_PING_OP, {}, timeout=max(interval * 4, 60))
                except Exception:  # noqa: BLE001 — submit poisoned the dispatcher
                    return

        threading.Thread(target=beat, name="spmd-heartbeat", daemon=True).start()

    def register(self, op: str, handler: Callable[[dict], Any]) -> None:
        self._handlers[op] = handler

    def submit(self, op: str, payload: dict, timeout: Optional[float] = None) -> Any:
        """Run ``op`` on every rank; returns the coordinator's result.

        Only the coordinator calls this (workers sit in
        :meth:`run_worker_loop`). The lock orders the jobs, so that the
        broadcasts, and with them the collectives inside the handlers,
        come in the same order on every rank.

        The failure model (the worker's half is in ``run_worker_loop``):
        the job runs under a watchdog (``timeout``, default
        ``LO_SPMD_TIMEOUT_S``, 3600 s; 0 turns it off). If a worker dies
        mid-job, the coordinator waits in a collective that can never
        complete (NCCL), or the collective raises (gloo): the watchdog
        turns the first into :class:`SpmdTimeoutError`, the second
        re-raises, and either way the REST request fails with an error
        instead of hanging. After a timeout or an error in the job the
        dispatcher is POISONED: the ranks' collective streams are out of
        step, later submits fail at once with
        :class:`SpmdRuntimePoisonedError`, and recovery is restarting the
        processes. No job is retried, and no rank carries on alone."""
        handler = self._handlers[op]
        # the request's correlation id rides the envelope, read once here
        # on the coordinator, so every rank's spans carry the same one
        envelope = {"op": op, "payload": payload, "cid": _tracing.current_correlation_id()}
        started = time.perf_counter()
        if process_count() == 1:
            with _tracing.span(f"spmd:{op}"):
                try:
                    result = handler(payload)
                except BaseException:
                    self._observe(op, "error", started)
                    raise
            self._observe(op, "ok", started)
            return result
        if timeout is None:
            timeout = float(os.environ.get("LO_SPMD_TIMEOUT_S", "3600") or 0)
        # a lock-free fast path: the latch only goes from None to a
        # reason, so a stale read only defers the failure to the check
        # under the lock, and taking the lock here would park this
        # request behind the job that is poisoning the stream
        if self._poisoned:
            raise SpmdRuntimePoisonedError(self._poisoned)
        with self._lock:
            if self._poisoned:
                raise SpmdRuntimePoisonedError(self._poisoned)
            if not timeout:
                with _tracing.span(f"spmd:{op}"):
                    try:
                        self._broadcast(envelope)
                        result = handler(payload)
                    except BaseException as error:
                        # the workers die on an error in the job: the
                        # stream is broken, as after a timeout
                        self._poison_locked(f"SPMD job {op!r} failed mid-collective: {error}")
                        self._observe(op, "error", started)
                        raise
                self._observe(op, "ok", started)
                return result
            box: dict[str, Any] = {}
            done = threading.Event()
            context = _tracing.capture()

            def run() -> None:
                try:
                    # the broadcast is inside the watchdog too: with a
                    # dead worker it can wait as the collectives do
                    with _tracing.attach(context), _tracing.span(f"spmd:{op}"):
                        self._broadcast(envelope)
                        box["result"] = handler(payload)
                except BaseException as error:  # noqa: BLE001 — re-raised below
                    box["error"] = error
                finally:
                    done.set()

            thread = threading.Thread(target=run, name=f"spmd-{op}", daemon=True)
            thread.start()
            if not done.wait(timeout):
                self._metrics["watchdog_trips"].inc()
                self._poison_locked(
                    f"SPMD job {op!r} timed out after {timeout:.0f}s — a "
                    "worker likely died mid-job; the runtime must be "
                    "restarted (supervisor restart policy)"
                )
                self._observe(op, "timeout", started)
                raise SpmdTimeoutError(self._poisoned)
            if "error" in box:
                self._poison_locked(f"SPMD job {op!r} failed mid-collective: {box['error']}")
                self._observe(op, "error", started)
                raise box["error"]
            self._observe(op, "ok", started)
            return box["result"]

    def run_worker_loop(self) -> None:
        """A worker's main loop: run the broadcast jobs until the shutdown.
        A failed job ends the worker (it re-raises): it may have stopped
        between two collectives, and rejoining the loop with its stream
        out of step would hang or corrupt every later job. Its exit fails
        the coordinator's collectives, so the coordinator's request ends
        in an error; restarting the processes brings the worker back."""
        rank = process_index()
        while True:
            job = self._broadcast()
            if job["op"] == _SHUTDOWN_OP:
                return
            # the worker's spans carry the COORDINATOR's correlation id:
            # one request, one id, over every rank
            trace = _tracing.Trace(job.get("cid"), name=f"spmd:{job['op']}")
            if job["op"] != _PING_OP:
                print(f"[spmd worker {rank}] job {job['op']!r} (cid {trace.correlation_id})", flush=True)
            try:
                with _tracing.activate(trace), _tracing.span(f"spmd:{job['op']}", process=rank):
                    self._handlers[job["op"]](job["payload"])
            except Exception:
                print(
                    f"[spmd worker {rank}] job {job['op']!r} "
                    f"(cid {trace.correlation_id}) failed:\n{traceback.format_exc()}",
                    flush=True,
                )
                raise
            finally:
                if job["op"] != _PING_OP:
                    _tracing.remember_trace(trace)
                    _tracing.export_trace(trace, service="spmd")

    def shutdown_workers(self) -> None:
        """Stop the heartbeat, and on the coordinator of several ranks
        broadcast the shutdown that ends every worker's loop (their half
        of this broadcast is the one they are parked in)."""
        self._stop_heartbeat.set()
        if process_count() > 1 and process_index() == 0:
            with self._lock:
                if not self._poisoned:
                    self._broadcast({"op": _SHUTDOWN_OP})
