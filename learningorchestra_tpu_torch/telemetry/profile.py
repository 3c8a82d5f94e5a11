"""Flight recorder: performance attribution on top of the span tree.

The port's copy of ``learningorchestra_tpu/telemetry/profile.py``.
Three instruments, all stdlib:

- **Byte-flow accounting** (:func:`account_wire` / :func:`account_h2d` /
  :func:`account_d2h` / :func:`account_decode` / :func:`account_shm` /
  :func:`account_compile`): the store wire, the host-to-device funnel
  (``ml/base.shard_matrix``), the device-to-host copies of forwards and
  embeddings, the frame decoder, and the kernel libraries' builds report
  bytes and seconds into process counters (``lo_wire_bytes_total``,
  ``lo_h2d_bytes_total``, ``lo_d2h_bytes_total``,
  ``lo_decode_seconds_total``, ``lo_shm_bytes_total``,
  ``lo_compile_events_total``/``lo_compile_seconds_total``); the same
  sites stamp the active span, so one instrumentation pass feeds both
  ``/metrics`` and the per-job timeline.
- **Chrome trace-event export** (:func:`chrome_trace`): a job's span
  tree as Chrome/Perfetto trace JSON: one row per thread, ``X``
  complete events with microsecond ``ts``/``dur``, and ``C`` counter
  tracks accumulating wire/H2D/D2H bytes along the timeline. Served at
  ``GET /jobs/<name>/profile`` (utils/web.py); ``?format=summary``
  returns the per-phase seconds/bytes/rows-per-second rollup
  (:func:`trace_summary`) instead.
- **Sampling profiler** (:func:`sample_stacks`): a wall-clock
  ``sys._current_frames()`` sampler serving folded flamegraph stacks at
  ``GET /debug/profile?seconds=N`` on every service. No background
  thread until a request asks; ``LO_PROF_HZ=0`` disables the endpoint.
  Concurrent requests share one sampling thread (each returns its own
  window's delta). A thread inside a kernel's ctypes call or a stream
  synchronisation shows as the Python frame that made the call.

Kernel launches are asynchronous: a span around them closes before the
card finishes, and the device time lands in the first span that waits
on it (a ``d2h:*`` copy, or a ``.cpu()``), as the reference's spans see
jax's asynchronous dispatch.

Import cost: stdlib only; the metrics registry is imported lazily.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from collections import Counter
from typing import Optional

from learningorchestra_tpu_torch.telemetry import tracing as _tracing

# --- knobs -------------------------------------------------------------------

DEFAULT_HZ = 47  # prime: avoids aliasing with periodic work
DEFAULT_WINDOW_S = 60.0


def prof_hz() -> int:
    """``LO_PROF_HZ``: sampling-profiler rate in samples/second.
    ``0`` disables ``GET /debug/profile``; the default (47 Hz) keeps the
    endpoint available while costing nothing until a request samples."""
    from learningorchestra_tpu_torch.sched.config import _int_env

    return _int_env("LO_PROF_HZ", DEFAULT_HZ, minimum=0)


def prof_window_s() -> float:
    """``LO_PROF_WINDOW_S``: the longest window one ``/debug/profile``
    request may sample for (its ``?seconds=`` is clamped to this)."""
    from learningorchestra_tpu_torch.sched.config import _float_env

    value = _float_env("LO_PROF_WINDOW_S", DEFAULT_WINDOW_S, minimum=0.0)
    if value <= 0:  # the shared helper's minimum is inclusive
        raise ValueError(f"LO_PROF_WINDOW_S must be > 0, got {value}")
    return value


def validate_env() -> None:
    """Fail fast on malformed ``LO_PROF_*`` knobs: a typo refuses
    bring-up instead of silently serving an unprofiled stack."""
    prof_hz()
    prof_window_s()


# --- byte-flow metrics -------------------------------------------------------

_METRICS: Optional[dict] = None
_METRICS_LOCK = threading.Lock()


def _flow_metrics() -> dict:
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            from learningorchestra_tpu_torch.telemetry.metrics import global_registry

            registry = global_registry()
            _METRICS = {
                "wire": registry.counter(
                    "lo_wire_bytes_total",
                    "Store-wire payload bytes moved (pre-compression)",
                    labels=("direction", "collection"),
                ),
                "h2d": registry.counter(
                    "lo_h2d_bytes_total",
                    "Bytes transferred host to device",
                ),
                "d2h": registry.counter(
                    "lo_d2h_bytes_total",
                    "Bytes transferred device to host",
                ),
                "decode": registry.counter(
                    "lo_decode_seconds_total",
                    "Seconds decoding wire frames into host columns",
                    labels=("collection",),
                ),
                "shm": registry.counter(
                    "lo_shm_bytes_total",
                    "Frame bytes served through the shared-memory ring "
                    "instead of the HTTP body",
                    labels=("collection",),
                ),
                "compile_events": registry.counter(
                    "lo_compile_events_total",
                    "Kernel-library loads observed (miss: built by nvcc, hit: already built)",
                    labels=("result", "source"),
                ),
                "compile_seconds": registry.counter(
                    "lo_compile_seconds_total",
                    "Seconds inside nvcc building kernel libraries",
                ),
            }
        return _METRICS


def account_wire(direction: str, collection: str, nbytes: int) -> None:
    """One wire payload moved (``direction`` = read|write). Counts into
    ``lo_wire_bytes_total`` and accumulates ``wire_bytes`` on the
    current span, so the job timeline and the Prometheus totals agree
    by construction."""
    _flow_metrics()["wire"].labels(direction, collection).inc(nbytes)
    _tracing.add_attr("wire_bytes", int(nbytes))


def account_h2d(nbytes: int) -> None:
    _flow_metrics()["h2d"].inc(nbytes)
    _tracing.add_attr("h2d_bytes", int(nbytes))


def account_d2h(nbytes: int) -> None:
    _flow_metrics()["d2h"].inc(nbytes)
    _tracing.add_attr("d2h_bytes", int(nbytes))


def account_decode(collection: str, seconds: float) -> None:
    _flow_metrics()["decode"].labels(collection).inc(seconds)
    _tracing.add_attr("decode_s", round(seconds, 6))


def account_shm(collection: str, nbytes: int) -> None:
    """One frame served through the shared-memory ring (core/shmring.py)
    — these bytes never rode the HTTP body, so they count here instead
    of ``lo_wire_bytes_total``."""
    _flow_metrics()["shm"].labels(collection).inc(nbytes)
    _tracing.add_attr("shm_bytes", int(nbytes))


def flow_totals() -> dict:
    """Current byte-flow totals summed over label sets: the snapshot a
    caller diffs around a measured section."""
    metrics = _flow_metrics()
    out = {
        "wire_read_bytes": 0.0,
        "wire_write_bytes": 0.0,
        "shm_bytes": 0.0,
        "decode_s": 0.0,
        "h2d_bytes": 0.0,
        "d2h_bytes": 0.0,
    }
    wire = metrics["wire"]
    with wire._lock:
        for key, child in wire._children.items():
            out_key = f"wire_{key[0]}_bytes"
            out[out_key] = out.get(out_key, 0.0) + child.value
    for out_key, name in (
        ("shm_bytes", "shm"),
        ("decode_s", "decode"),
    ):
        metric = metrics[name]
        with metric._lock:
            out[out_key] = sum(
                child.value for child in metric._children.values()
            )
    for out_key, name in (("h2d_bytes", "h2d"), ("d2h_bytes", "d2h")):
        metric = metrics[name]
        with metric._lock:
            out[out_key] = sum(
                child.value for child in metric._children.values()
            )
    return out


# the lane that loads kernel libraries on this thread (compile_source)
_COMPILE_SOURCE = threading.local()


@contextlib.contextmanager
def compile_source(source: str, key: Optional[str] = None):
    """Book the kernel-library loads on this thread under ``source``
    (``lo_compile_events_total``'s label) while the block runs, then
    restore the previous lane: the publish-time warmup runs its forward
    under ``"aot"`` (reference ``utils/jitcache.compile_source``).
    ``key`` names the work, as the reference's manifest key does."""
    previous = getattr(_COMPILE_SOURCE, "value", None)
    _COMPILE_SOURCE.value = (source, key)
    try:
        yield
    finally:
        _COMPILE_SOURCE.value = previous


def current_compile_source() -> str:
    """This thread's lane: ``jit`` (the request path) outside any
    :func:`compile_source` block."""
    scoped = getattr(_COMPILE_SOURCE, "value", None)
    return "jit" if scoped is None else scoped[0]


def account_compile(
    result: Optional[str] = None,
    seconds: Optional[float] = None,
    source: Optional[str] = None,
) -> None:
    """A kernel library's load (``result`` = hit|miss) and/or its build
    seconds: ``kernels.library(name)`` feeds this the first time a
    process loads a library (``miss`` with nvcc's seconds when it ran
    nvcc, ``hit`` when the library was already built). ``source`` says
    which lane triggered the load, as the reference labels its compiles:
    by default this thread's (:func:`current_compile_source`), ``jit``
    for the request path's first use, ``aot`` inside a warmup."""
    if source is None:
        source = current_compile_source()
    metrics = _flow_metrics()
    if result is not None:
        metrics["compile_events"].labels(result, source).inc()
    if seconds is not None:
        metrics["compile_seconds"].inc(seconds)


def compile_events() -> dict:
    """This process's ``lo_compile_events_total`` samples as
    ``{"<result>/<source>": count}`` (a label set with no event yet is
    absent): the compile plane's pass reports them when it ends."""
    metric = _flow_metrics()["compile_events"]
    with metric._lock:
        return {"/".join(key): child.value for key, child in sorted(metric._children.items())}


# --- Chrome trace-event export ----------------------------------------------

# meta keys the exporter treats as byte flows (span attr -> counter track)
_BYTE_ATTRS = ("wire_bytes", "h2d_bytes", "d2h_bytes")


def _walk(span_dict: dict, depth: int = 0):
    yield span_dict, depth
    for child in span_dict.get("children", ()):
        yield from _walk(child, depth + 1)


def _iter_spans(trace_dict: dict):
    for root in trace_dict.get("spans", ()):
        yield from _walk(root)


def span_events(span_roots, pid: int, t0: float) -> list[dict]:
    """Span dict trees → Chrome ``ph: "X"`` complete events laid out
    one row per OS thread, plus per-thread ``M`` name/sort metadata.
    Shared by :func:`chrome_trace` (one process) and the fleet stitcher
    (telemetry/stitch.py — one ``pid`` row per plane member, all
    anchored to a common ``t0``)."""
    spans = [
        (span_dict, depth)
        for root in span_roots
        for span_dict, depth in _walk(root)
        if span_dict.get("start_ts") is not None
    ]
    events: list[dict] = []
    tids = []
    for span_dict, _depth in spans:
        tid = span_dict.get("tid") or 0
        if tid not in tids:
            tids.append(tid)
        ts_us = round((span_dict["start_ts"] - t0) * 1e6, 1)
        duration = span_dict.get("duration_s")
        event = {
            "name": span_dict["name"],
            "ph": "X",
            "ts": ts_us,
            "dur": (
                0.0 if duration is None else round(duration * 1e6, 1)
            ),
            "pid": pid,
            "tid": tid,
            "cat": span_dict["name"].split(":", 1)[0],
        }
        meta = span_dict.get("meta")
        if meta:
            event["args"] = meta
        events.append(event)
    # thread rows get names so Perfetto's left rail reads as a legend
    for index, tid in enumerate(sorted(tids)):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": f"thread-{tid}"},
            }
        )
        events.append(
            {
                "name": "thread_sort_index",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"sort_index": index},
            }
        )
    return events


def chrome_trace(trace) -> dict:
    """A trace (``Trace`` or its ``as_dict()``) as Chrome trace-event
    JSON — load it in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.

    Spans become ``ph: "X"`` complete events laid out one row per OS
    thread; ``ts`` is microseconds relative to the earliest span (the
    absolute epoch anchor rides ``otherData``); byte-carrying spans
    additionally feed cumulative ``ph: "C"`` counter tracks (one series
    per flow: wire/h2d/d2h), so Perfetto draws bytes-moved-so-far under
    the timeline."""
    if hasattr(trace, "as_dict"):
        trace = trace.as_dict()
    spans = [
        (span_dict, depth)
        for span_dict, depth in _iter_spans(trace)
        if span_dict.get("start_ts") is not None
    ]
    t0 = min(
        (span_dict["start_ts"] for span_dict, _ in spans), default=0.0
    )
    pid = os.getpid()
    events = span_events(trace.get("spans", ()), pid, t0)
    # cumulative byte counters along the timeline, stamped at each
    # contributing span's END (when the bytes have actually moved)
    totals = dict.fromkeys(_BYTE_ATTRS, 0)
    flows = []
    for span_dict, _depth in spans:
        meta = span_dict.get("meta") or {}
        if any(meta.get(attr) for attr in _BYTE_ATTRS):
            end = span_dict["start_ts"] + (span_dict.get("duration_s") or 0.0)
            flows.append((end, meta))
    for end, meta in sorted(flows, key=lambda item: item[0]):
        for attr in _BYTE_ATTRS:
            totals[attr] += int(meta.get(attr) or 0)
        events.append(
            {
                "name": "bytes moved",
                "ph": "C",
                "ts": round((end - t0) * 1e6, 1),
                "pid": pid,
                "tid": 0,
                "args": {
                    attr.removesuffix("_bytes"): totals[attr]
                    for attr in _BYTE_ATTRS
                },
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "correlation_id": trace.get("correlation_id"),
            "name": trace.get("name"),
            "trace_start_ts": t0,
            "bytes_total": totals,
        },
    }


def trace_summary(trace) -> dict:
    """Per-phase rollup of a trace: for every span name, occurrence
    count, total seconds, bytes by flow, rows, and rows/second — the
    plain-JSON answer to "which phase moved"."""
    if hasattr(trace, "as_dict"):
        trace = trace.as_dict()
    phases: dict[str, dict] = {}
    wall_start, wall_end = None, None
    for span_dict, _depth in _iter_spans(trace):
        start = span_dict.get("start_ts")
        duration = span_dict.get("duration_s") or 0.0
        if start is not None:
            wall_start = start if wall_start is None else min(wall_start, start)
            wall_end = (
                start + duration
                if wall_end is None
                else max(wall_end, start + duration)
            )
        entry = phases.setdefault(
            span_dict["name"],
            {"count": 0, "seconds": 0.0, "rows": 0, "bytes": {}},
        )
        entry["count"] += 1
        entry["seconds"] += duration
        meta = span_dict.get("meta") or {}
        if isinstance(meta.get("rows"), (int, float)):
            entry["rows"] += int(meta["rows"])
        for attr in _BYTE_ATTRS:
            value = meta.get(attr)
            if value:
                entry["bytes"][attr.removesuffix("_bytes")] = (
                    entry["bytes"].get(attr.removesuffix("_bytes"), 0)
                    + int(value)
                )
        # a span's own payload size (write phases, serve forwards)
        if isinstance(meta.get("bytes"), (int, float)):
            entry["bytes"]["payload"] = entry["bytes"].get(
                "payload", 0
            ) + int(meta["bytes"])
    for entry in phases.values():
        entry["seconds"] = round(entry["seconds"], 6)
        if entry["rows"] and entry["seconds"] > 0:
            entry["rows_per_s"] = round(entry["rows"] / entry["seconds"], 1)
        if not entry["bytes"]:
            del entry["bytes"]
        if not entry["rows"]:
            del entry["rows"]
    return {
        "correlation_id": trace.get("correlation_id"),
        "name": trace.get("name"),
        "wall_s": (
            round(wall_end - wall_start, 6)
            if wall_start is not None
            else None
        ),
        "phases": phases,
    }


# --- sampling profiler -------------------------------------------------------


class _SamplerCore:
    """The process's ONE sampling thread, reference-counted.

    Requests ``acquire()`` a window; the first acquisition starts the
    thread, the last ``release()`` stops it. Each request reads the
    cumulative stack counts before and after its window and returns the
    delta, so concurrent ``/debug/profile`` requests share one thread's
    overhead instead of multiplying it — sampling cost is O(hz), never
    O(hz x clients)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Counter = Counter()
        self._samples = 0
        self._users = 0
        self._thread: Optional[threading.Thread] = None
        self._hz = DEFAULT_HZ

    def acquire(self, hz: int) -> None:
        with self._lock:
            self._users += 1
            if self._thread is None:
                self._hz = hz
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="lo-prof-sampler"
                )
                self._thread.start()

    def release(self) -> None:
        with self._lock:
            self._users -= 1
            if self._users <= 0:
                # every window's delta has been read by now (requests
                # snapshot BEFORE releasing) — drop the accumulated
                # stacks so repeated profiling of a long-lived threaded
                # server (one folded key per Thread-N handler name)
                # cannot grow this Counter for the life of the process
                self._counts.clear()
                self._samples = 0

    def snapshot(self) -> tuple[Counter, int]:
        with self._lock:
            return Counter(self._counts), self._samples

    def _run(self) -> None:
        # _hz is written under the lock in acquire(); snapshot it under
        # the same lock (LO203) instead of racing a concurrent first
        # acquirer's assignment
        with self._lock:
            interval = 1.0 / max(self._hz, 1)
        me = threading.get_ident()
        while True:
            with self._lock:
                if self._users <= 0:
                    self._thread = None
                    return
            names = {
                thread.ident: thread.name for thread in threading.enumerate()
            }
            sampled = Counter()
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                stack = []
                depth = 0
                while frame is not None and depth < 64:
                    code = frame.f_code
                    module = os.path.splitext(
                        os.path.basename(code.co_filename)
                    )[0]
                    stack.append(f"{module}.{code.co_name}")
                    frame = frame.f_back
                    depth += 1
                stack.append(names.get(ident, f"tid-{ident}"))
                sampled[";".join(reversed(stack))] += 1
            with self._lock:
                self._counts.update(sampled)
                self._samples += 1
            time.sleep(interval)


_SAMPLER = _SamplerCore()


def sample_stacks(
    seconds: float, hz: Optional[int] = None
) -> tuple[dict[str, int], int]:
    """Sample every thread's Python stack for ``seconds`` and return
    ``(folded_stacks, samples)``: keys are semicolon-joined frames
    rooted at the thread name (flamegraph.pl / speedscope folded
    format), values are sample counts. Raises ``RuntimeError`` when
    profiling is disabled (``LO_PROF_HZ=0``)."""
    hz = prof_hz() if hz is None else hz
    if hz <= 0:
        raise RuntimeError("sampling profiler disabled (LO_PROF_HZ=0)")
    seconds = min(max(seconds, 1.0 / hz), prof_window_s())
    _SAMPLER.acquire(hz)
    try:
        before, samples_before = _SAMPLER.snapshot()
        time.sleep(seconds)
        after, samples_after = _SAMPLER.snapshot()
    finally:
        _SAMPLER.release()
    delta = after - before
    return dict(delta), samples_after - samples_before


def folded_text(stacks: dict[str, int]) -> str:
    """Folded stacks as text, heaviest first — pipe straight into
    flamegraph.pl or paste into speedscope.app."""
    lines = [
        f"{stack} {count}"
        for stack, count in sorted(
            stacks.items(), key=lambda item: (-item[1], item[0])
        )
    ]
    return "\n".join(lines) + ("\n" if lines else "")
