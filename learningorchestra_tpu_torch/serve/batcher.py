"""Request micro-batching: many waiting clients, one forward dispatch.

Counterpart of ``learningorchestra_tpu/serve/batcher.py:63-380``. One
worker thread drains a bounded inbox: requests that arrive within
``LO_SERVE_BATCH_WINDOW_MS`` are joined into one forward per model, padded
to ``grid_size(total, max_batch)`` rows (the reference's dispatch shapes),
and the results are sliced back to the waiting request threads.

Admission: the inbox is bounded (``LO_SERVE_QUEUE_CAP``); past the cap
:meth:`MicroBatcher.submit` raises :class:`QueueFullError` with a
drain-rate Retry-After estimate, which the REST layer answers as 429.

Flight recorder: one dispatch in ``trace_every`` (default
:data:`TRACE_EVERY`) runs under a trace of its own, remembered in the
trace ring and the stitcher's export buffer, whose ``serve:forward``
span carries the batch's rows, bytes and dtype (reference
``serve/batcher.py:262-315``). The ``serve.forward`` fault point fires
before each group's forward.
"""

from __future__ import annotations

import contextlib
import math
import queue
import threading
import time
import traceback
from typing import Optional

import numpy as np

from learningorchestra_tpu_torch.sched.scheduler import QueueFullError
from learningorchestra_tpu_torch.telemetry import tracing as _tracing
from learningorchestra_tpu_torch.testing import faults as _faults
from learningorchestra_tpu_torch.utils.shapegrid import grid_size, pad_axis0

SERVE_CLASS = "serve"
TRACE_EVERY = 16  # one dispatch in this many runs under a trace of its own

# serving latencies live in the millisecond range: the buckets of
# lo_serve_request_seconds, which the serve_p99 SLO reads
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0,
)

_CLOSE = object()  # inbox sentinel


class PredictRequest:
    """One waiting client: rows in, ``(labels, probs)`` or an exception
    out, handed across threads through the done event."""

    __slots__ = (
        "path", "rows", "labels", "probs", "error", "abandoned", "_done",
    )

    def __init__(self, path: str, rows: np.ndarray):
        self.path = path
        self.rows = rows
        self.labels: Optional[np.ndarray] = None
        self.probs: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.abandoned = False
        self._done = threading.Event()

    def finish(self) -> None:
        self._done.set()

    def abandon(self) -> None:
        """The client gave up (route timeout, 503): the batcher drops the
        request at dispatch instead of computing a result nobody reads."""
        self.abandoned = True

    def wait(self, timeout: float) -> bool:
        return self._done.wait(timeout)


class MicroBatcher:
    """One daemon worker draining a bounded inbox into batched forwards.

    One worker by design: one dispatch in flight per process, and while a
    forward runs the next burst piles into the inbox, which is what makes
    the next dispatch a batch."""

    def __init__(
        self,
        registry,
        window_s: Optional[float] = None,
        max_batch: Optional[int] = None,
        inbox_cap: Optional[int] = None,
        trace_every: int = TRACE_EVERY,
    ):
        from learningorchestra_tpu_torch.serve import config

        self.registry = registry
        # 0: no dispatch is traced; 1: every one
        self.trace_every = trace_every
        # the worker thread's own dispatch count (no lock: only it reads it)
        self._dispatches = 0
        self.window_s = config.batch_window_s() if window_s is None else window_s
        self.max_batch = config.max_batch() if max_batch is None else max_batch
        cap = config.queue_cap() if inbox_cap is None else inbox_cap
        self._inbox: "queue.Queue" = queue.Queue(maxsize=cap)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # EWMA of batch service seconds, seeding Retry-After estimates
        self.avg_batch_s = 0.05
        self.batches = 0
        self.batched_requests = 0
        self.rejected = 0

    # --- submission (request threads) ----------------------------------------
    def submit(self, path: str, rows: np.ndarray) -> PredictRequest:
        """Enqueue one request. Raises :class:`QueueFullError` at the inbox
        cap and ``ValueError`` for malformed rows — on the caller's thread,
        so a bad submission never reaches the shared worker."""
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[0] == 0:
            raise ValueError(
                f"rows must be a non-empty 2-D array, got shape {rows.shape}"
            )
        request = PredictRequest(path, rows)
        with self._lock:
            if self._closed:
                raise RuntimeError("serving batcher is closed")
            try:
                self._inbox.put_nowait(request)
            except queue.Full:
                self.rejected += 1
                depth = self._inbox.qsize()
                retry_after = max(
                    1,
                    min(60, math.ceil(self.avg_batch_s * depth / max(1, self.max_batch))),
                )
                raise QueueFullError(SERVE_CLASS, depth, retry_after) from None
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="lo-serve-batcher"
                )
                self._thread.start()
        return request

    # --- the batching loop (worker thread) ------------------------------------
    def _loop(self) -> None:
        while True:
            first = self._inbox.get()
            if first is _CLOSE:
                return
            batch = [first]
            # _forward owns per-group errors; this guard keeps the only
            # serving thread alive through a fault anywhere else, and
            # fails this batch's waiters instead
            try:
                closed = self._collect(batch) == "closed"
                self._run_batches(batch)
                if closed:
                    return
            except BaseException as error:  # noqa: BLE001
                traceback.print_exc()
                for request in batch:
                    if not request._done.is_set():
                        request.error = error
                        request.finish()

    def _collect(self, batch: list) -> Optional[str]:
        """Fill ``batch`` until the window closes or ``max_batch`` requests
        or rows are reached; returns "closed" on shutdown."""
        rows_total = len(batch[0].rows)
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch and rows_total < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                # remaining <= 0 still drains a waiting backlog
                item = (
                    self._inbox.get_nowait()
                    if remaining <= 0
                    else self._inbox.get(timeout=remaining)
                )
            except queue.Empty:
                break
            if item is _CLOSE:
                return "closed"
            batch.append(item)
            rows_total += len(item.rows)
        return None

    def _run_batches(self, batch: list) -> None:
        started = time.monotonic()
        # one dispatch per (model, feature width): a request whose width
        # does not fit its model fails alone, not its batch-mates
        groups: "dict[tuple, list]" = {}
        for request in batch:
            if request.abandoned:
                request.error = TimeoutError("request abandoned by client")
                request.finish()
                continue
            groups.setdefault((request.path, request.rows.shape[1]), []).append(request)
        for group in groups.values():
            self._forward(group)
        with self._lock:
            self.avg_batch_s = 0.8 * self.avg_batch_s + 0.2 * (time.monotonic() - started)

    def _forward(self, group: list) -> None:
        # the worker runs outside any request's trace: one dispatch in
        # trace_every gets a trace of its own
        trace = None
        if self.trace_every and self._dispatches % self.trace_every == 0:
            trace = _tracing.Trace(name=f"serve:{group[0].path}")
        self._dispatches += 1
        context = _tracing.activate(trace) if trace is not None else contextlib.nullcontext()
        try:
            with context:
                self._forward_traced(group)
        finally:
            if trace is not None:
                _tracing.remember_trace(trace)
                _tracing.export_trace(trace, service="serve")

    def _forward_traced(self, group: list) -> None:
        try:
            # an error injected here becomes every request's error
            _faults.fire("serve.forward", path=group[0].path, requests=len(group))
            # the span covers the registry lookup, so a load lands in it
            with _tracing.span("serve:forward", requests=len(group)):
                model = self.registry.get(group[0].path)
                rows = np.concatenate([request.rows for request in group])
                total = len(rows)
                # the reference's dispatch shape: small batches pad to
                # max_batch rows, larger totals to the quarter-octave
                # grid; padding rows are sliced off below
                rows = pad_axis0(rows, grid_size(total, self.max_batch))
                _tracing.annotate(rows=total, bytes=int(rows.nbytes), dtype=str(rows.dtype))
                labels, probs = model.predict_both(rows)
        except BaseException as error:  # noqa: BLE001 — delivered to every
            # waiting request of the group; the route maps it to an HTTP error
            for request in group:
                request.error = error
                request.finish()
            return
        with self._lock:
            self.batches += 1
            self.batched_requests += len(group)
        offset = 0
        for request in group:
            n = len(request.rows)
            request.labels = labels[offset : offset + n]
            request.probs = probs[offset : offset + n]
            offset += n
            request.finish()

    # --- lifecycle / stats -----------------------------------------------------
    def close(self) -> None:
        """Stop the worker and fail anything still queued."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread = self._thread
        if thread is not None:
            self._inbox.put(_CLOSE)
            thread.join(timeout=10)
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                break
            if item is not _CLOSE:
                item.error = RuntimeError("serving batcher closed")
                item.finish()

    def depth(self) -> int:
        """Requests waiting in the inbox (the fleet heartbeat's
        ``inflight``)."""
        return self._inbox.qsize()

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": self._inbox.qsize(),
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "rejected": self.rejected,
                "mean_batch_size": (
                    round(self.batched_requests / self.batches, 3)
                    if self.batches
                    else None
                ),
            }
