"""Span-based tracing with request correlation IDs.

One :class:`Trace` is the whole story of one request: the REST
middleware (utils/web.py) mints a correlation ID, the job manager binds
the job's work to a trace carrying that ID, the SPMD dispatcher rides it
on the broadcast envelope so worker-side spans are attributable, and
``PhaseTimer`` phases land as spans — so ``GET /jobs/<name>/trace``
answers "where did this request's time go" across every layer.

Context propagation is ``contextvars``-based: span nesting follows the
thread of execution; fan-out threads (the builder's per-classifier pool)
re-attach with :func:`capture`/:func:`attach` because ``contextvars`` do
not cross ``ThreadPoolExecutor`` boundaries. :func:`span` is a cheap
no-op when no trace is active, so instrumented library code costs
nothing outside a request.

The port's copy of ``learningorchestra_tpu/telemetry/tracing.py``, its
lazy import of ``sched.config`` pointed at the port.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
import uuid
from typing import Iterator, Optional

_TRACE: contextvars.ContextVar[Optional["Trace"]] = contextvars.ContextVar(
    "lo_trace", default=None
)
_SPAN: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "lo_span", default=None
)

CORRELATION_HEADER = "X-Correlation-Id"


def mint_correlation_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed operation; children nest within the parent's window.

    Flight-recorder fields (telemetry/profile.py): ``start_ts`` is the
    epoch anchor, ``duration_s`` comes from the monotonic clock (so two
    spans on different threads order correctly within a process), and
    ``tid`` is the OS thread id — the Chrome trace-event exporter lays
    spans out one row per thread from exactly these three fields. Typed
    attributes (bytes moved, rows, dtype, compile hit/miss) ride
    ``meta``."""

    __slots__ = (
        "name", "start_ts", "duration_s", "meta", "children", "tid",
        "_t0", "_trace",
    )

    def __init__(self, name: str, trace: "Trace", meta: Optional[dict] = None):
        self.name = name
        self.start_ts = time.time()
        self.duration_s: Optional[float] = None
        self.meta = meta or {}
        self.children: list[Span] = []
        self.tid = threading.get_native_id()
        self._t0 = time.perf_counter()
        self._trace = trace

    def finish(self) -> None:
        self.duration_s = time.perf_counter() - self._t0

    @property
    def end_ts(self) -> Optional[float]:
        """Epoch end: the start anchor plus the monotonic duration."""
        if self.duration_s is None:
            return None
        return self.start_ts + self.duration_s

    def as_dict(self) -> dict:
        out = {
            "name": self.name,
            "start_ts": round(self.start_ts, 6),
            "duration_s": (
                None if self.duration_s is None else round(self.duration_s, 6)
            ),
            "tid": self.tid,
            "children": [child.as_dict() for child in self.children],
        }
        if self.meta:
            out["meta"] = self.meta
        return out


class Trace:
    """A correlation ID plus its span tree. Thread-safe: fan-out threads
    attach spans concurrently (ml/builder.py's classifier pool)."""

    def __init__(self, correlation_id: Optional[str] = None, name: str = ""):
        self.correlation_id = correlation_id or mint_correlation_id()
        self.name = name
        self.spans: list[Span] = []
        self._lock = threading.Lock()

    def _add(self, span_obj: Span, parent: Optional[Span]) -> None:
        with self._lock:
            if parent is not None:
                parent.children.append(span_obj)
            else:
                self.spans.append(span_obj)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "correlation_id": self.correlation_id,
                "name": self.name,
                "spans": [span_obj.as_dict() for span_obj in self.spans],
            }


def current_trace() -> Optional[Trace]:
    return _TRACE.get()


def current_correlation_id() -> Optional[str]:
    trace = _TRACE.get()
    return trace.correlation_id if trace is not None else None


@contextlib.contextmanager
def activate(trace: Trace) -> Iterator[Trace]:
    """Make ``trace`` the ambient trace; new spans root at its top."""
    trace_token = _TRACE.set(trace)
    span_token = _SPAN.set(None)
    try:
        yield trace
    finally:
        _SPAN.reset(span_token)
        _TRACE.reset(trace_token)


def capture() -> tuple[Optional[Trace], Optional[Span]]:
    """Snapshot the ambient (trace, span) for hand-off to a pool thread."""
    return _TRACE.get(), _SPAN.get()


@contextlib.contextmanager
def attach(
    context: tuple[Optional[Trace], Optional[Span]]
) -> Iterator[None]:
    """Adopt a captured context in another thread: spans opened inside
    become children of the captured span, in the captured trace."""
    trace, parent = context
    trace_token = _TRACE.set(trace)
    span_token = _SPAN.set(parent)
    try:
        yield
    finally:
        _SPAN.reset(span_token)
        _TRACE.reset(trace_token)


@contextlib.contextmanager
def span(name: str, **meta) -> Iterator[Optional[Span]]:
    """Record a timed span under the ambient trace; no-op without one."""
    trace = _TRACE.get()
    if trace is None:
        yield None
        return
    parent = _SPAN.get()
    span_obj = Span(name, trace, meta=meta or None)
    trace._add(span_obj, parent)
    token = _SPAN.set(span_obj)
    try:
        yield span_obj
    finally:
        span_obj.finish()
        _SPAN.reset(token)


def annotate(**attrs) -> None:
    """Set typed attributes on the CURRENT span (no-op without one) —
    for instrumentation sites that learn a fact (registry hit/miss,
    decoded byte count) inside a span someone else opened."""
    span_obj = _SPAN.get()
    if span_obj is not None:
        span_obj.meta.update(attrs)


def add_attr(name: str, amount: float) -> None:
    """Accumulate a numeric attribute on the current span (no-op
    without one): ``bytes``-style totals built up across a chunk loop
    land on the one surrounding span instead of needing a span per
    chunk."""
    span_obj = _SPAN.get()
    if span_obj is not None:
        span_obj.meta[name] = span_obj.meta.get(name, 0) + amount


def record_span(name: str, duration_s: float, **meta) -> Optional[Span]:
    """Append an already-finished span ending NOW to the active trace
    (no-op without one). For events whose timing arrives as a duration
    after the fact — jax.monitoring hands compile times to
    utils/jitcache.py this way — so the timeline still shows WHEN the
    compiler ran and for how long."""
    trace = _TRACE.get()
    if trace is None:
        return None
    span_obj = Span(name, trace, meta=meta or None)
    span_obj.start_ts = time.time() - duration_s
    span_obj.duration_s = duration_s
    trace._add(span_obj, _SPAN.get())
    return span_obj


# --- worker-side trace retention -------------------------------------------
# SPMD worker processes have no REST surface; their traces (attributed by
# the broadcast correlation ID) park in a bounded ring an operator can
# dump (parallel/spmd.py logs the correlation id per job, and tests
# assert attribution through here).
_RECENT: "dict[str, Trace]" = {}
_RECENT_ORDER: list[str] = []
_RECENT_LOCK = threading.Lock()


def trace_ring() -> int:
    """Entries kept in the remembered-trace ring AND the per-cid span
    export buffer (``LO_TRACE_RING``, strictly integral >= 1 — was a
    hardcoded 256). Size it to the scrape interval: the stitcher
    (telemetry/stitch.py) can only merge spans that have not been
    evicted by newer requests before it fans out."""
    from learningorchestra_tpu_torch.sched.config import _int_env

    return _int_env("LO_TRACE_RING", 256)


def remember_trace(trace: Trace) -> None:
    with _RECENT_LOCK:
        if trace.correlation_id not in _RECENT:
            _RECENT_ORDER.append(trace.correlation_id)
        _RECENT[trace.correlation_id] = trace
        limit = trace_ring()
        while len(_RECENT_ORDER) > limit:
            _RECENT.pop(_RECENT_ORDER.pop(0), None)


def recall_trace(correlation_id: str) -> Optional[Trace]:
    with _RECENT_LOCK:
        return _RECENT.get(correlation_id)


# --- cross-process span export ---------------------------------------------
# The Dapper shape: every process keeps a bounded per-cid buffer of its
# finished spans, drained over HTTP (``GET /debug/spans?cid=…`` —
# utils/web.py registers it on every app) and merged fleet-wide by the
# stitcher (telemetry/stitch.py). Groups are keyed "service@pid" so a
# multi-service process contributes one row per service and a fan-out
# that reaches the same process twice (a member list naming ourselves)
# dedupes instead of duplicating.
_EXPORT: dict[str, dict] = {}
_EXPORT_ORDER: list[str] = []
_EXPORT_LOCK = threading.Lock()


def export_trace(trace: Trace, service: Optional[str] = None) -> None:
    """Snapshot a trace's finished spans into the export buffer. Cheap
    and safe to call per request (the REST middleware does) — empty
    traces are skipped, and both the cid ring and each group's span
    list are bounded by :func:`trace_ring`."""
    snapshot = trace.as_dict()
    spans = snapshot.get("spans") or []
    if not spans:
        return
    label = service or "proc"
    pid = os.getpid()
    proc = f"{label}@{pid}"
    with _EXPORT_LOCK:
        entry = _EXPORT.get(trace.correlation_id)
        if entry is None:
            entry = {"ts": 0.0, "groups": {}}
            _EXPORT[trace.correlation_id] = entry
            _EXPORT_ORDER.append(trace.correlation_id)
        group = entry["groups"].setdefault(
            proc, {"service": label, "pid": pid, "spans": []}
        )
        group["spans"].extend(spans)
        limit = trace_ring()
        del group["spans"][:-limit]
        entry["ts"] = time.time()
        while len(_EXPORT_ORDER) > limit:
            _EXPORT.pop(_EXPORT_ORDER.pop(0), None)


def exported_spans(
    correlation_id: Optional[str] = None, since: Optional[float] = None
) -> dict:
    """Read the export buffer: ``{cid: {"ts": last_update, "groups":
    {"service@pid": {"service", "pid", "spans": [...]}}}}``, filtered
    to one cid and/or to entries updated after ``since``. Reads do not
    consume — eviction is the ring's job — so a stitcher retry sees
    the same spans."""
    with _EXPORT_LOCK:
        cids = (
            [correlation_id]
            if correlation_id is not None
            else list(_EXPORT_ORDER)
        )
        out = {}
        for cid in cids:
            entry = _EXPORT.get(cid)
            if entry is None:
                continue
            if since is not None and entry["ts"] <= since:
                continue
            out[cid] = {
                "ts": entry["ts"],
                "groups": {
                    proc: {
                        "service": group["service"],
                        "pid": group["pid"],
                        "spans": list(group["spans"]),
                    }
                    for proc, group in entry["groups"].items()
                },
            }
        return out
