"""In-store time-series retention for fleet metrics.

The port's copy of ``learningorchestra_tpu/telemetry/tsdb.py``.

Every process serves ``GET /metrics`` (telemetry/metrics.py); this
module keeps its samples: a collector parses
each member's Prometheus exposition into per-family values and appends
one delta-compressed document per ``(instance, tick)`` into the bounded
ring collection ``__lo_metrics__`` — rev-bumped like every other
collection, capped by ``LO_TSDB_POINTS`` ticks per instance, labelled
``{instance, service}`` — so ``GET /metrics/history`` (utils/web.py)
can answer "p99 of ``lo_serve_request_seconds`` over the last 10
minutes, per replica" as one HTTP call with the rollup computed
server-side.

Retention format (one document per instance per scrape tick)::

    {"instance": "10.0.0.7:5002", "service": "model_builder",
     "ts": 1754000000.0, "vals": {family: value, ...}}

``vals`` is delta-compressed: a family appears only when its value
changed since the instance's previous tick (readers fold forward).
Scalar families (counters summed across label sets, gauges) store a
float; histogram families store ``{"buckets": {le: cumulative_count},
"sum": s, "count": n}`` so windowed percentiles come from bucket-count
deltas, Prometheus ``histogram_quantile`` style.

Stdlib-only, like the rest of ``telemetry/``.
"""

from __future__ import annotations

import re
import threading
import time
import traceback
from typing import Any, Optional

from learningorchestra_tpu_torch.sched.config import _float_env, _int_env

COLLECTION = "__lo_metrics__"

# Derived while parsing: lo_http_requests_total samples whose status
# label is 5xx, summed separately — the label-collapsed family total
# can't distinguish a 500 storm from healthy traffic, and the SLO 5xx
# rule needs exactly that split.
DERIVED_5XX = "lo_http_requests_5xx_total"

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$"
)
_STATUS_RE = re.compile(r'status="([^"]*)"')
_LE_RE = re.compile(r'le="([^"]*)"')


# --- knobs -------------------------------------------------------------------

def tsdb_points() -> int:
    """Ring cap: scrape ticks retained per instance in
    ``__lo_metrics__`` (``LO_TSDB_POINTS``, strictly integral >= 1).
    At the default 60s interval, 512 points is ~8.5 hours of history
    per member."""
    return _int_env("LO_TSDB_POINTS", 512)


def metrics_interval_s() -> float:
    """Seconds between scrape ticks (``LO_METRICS_INTERVAL_S`` — the
    same knob a central scraper's loop reads, so the in-store history
    and its summary advance together)."""
    return _float_env("LO_METRICS_INTERVAL_S", 60.0)


def _flag01_env(name: str, default: bool) -> bool:
    """Strict 0/1 flag (sched/config.py's ``resume_enabled`` pattern):
    ``yes`` silently meaning "off" is exactly what the preflight
    refuses."""
    import os

    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    if raw not in ("0", "1"):
        raise ValueError(f"{name} must be 0 or 1, got {raw!r}")
    return raw == "1"


def collect_enabled() -> bool:
    """The single-process fallback collector (services/runner.py).
    Strict 0/1: ``LO_TSDB_COLLECT=0`` where a central collector owns the
    scrape — a runner-side collector double-appending the same registry
    would halve the effective retention window."""
    return _flag01_env("LO_TSDB_COLLECT", True)


# --- exposition parsing ------------------------------------------------------

def parse_samples(text: str) -> dict[str, Any]:
    """Prometheus exposition text → per-family values.

    Counters/gauges sum across label sets to one float; histogram
    families (``_bucket``/``_sum``/``_count`` suffixes) merge into one
    bucket snapshot. Raises ``ValueError`` on a malformed or truncated
    body — callers treat that as a per-member skip, never a crash
    (the ingest route)."""
    scalars: dict[str, float] = {}
    hists: dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        match = _SAMPLE_RE.match(line)
        if match is None:
            raise ValueError(f"malformed sample line: {line!r}")
        name, labels, raw = match.groups()
        value = float(raw)  # ValueError on a torn value token
        if name.endswith("_bucket"):
            family = name[: -len("_bucket")]
            le = _LE_RE.search(labels or "")
            if le is None:
                raise ValueError(f"bucket sample without le: {line!r}")
            hist = hists.setdefault(
                family, {"buckets": {}, "sum": 0.0, "count": 0.0}
            )
            buckets = hist["buckets"]
            buckets[le.group(1)] = buckets.get(le.group(1), 0.0) + value
        elif name.endswith("_sum") or name.endswith("_count"):
            family, part = name.rsplit("_", 1)
            hist = hists.setdefault(
                family, {"buckets": {}, "sum": 0.0, "count": 0.0}
            )
            hist[part] += value
        else:
            scalars[name] = scalars.get(name, 0.0) + value
            if name == "lo_http_requests_total":
                scalars.setdefault(DERIVED_5XX, 0.0)
                status = _STATUS_RE.search(labels or "")
                if status is not None and status.group(1).startswith("5"):
                    scalars[DERIVED_5XX] += value
    out: dict[str, Any] = dict(scalars)
    out.update(hists)
    return out


# --- retention ---------------------------------------------------------------

class TSDB:
    """Appender for ``__lo_metrics__`` over any :class:`DocumentStore`.

    Delta compression state is per-process; a fresh instance (collector
    restart) reseeds each instance's last-known values from the store
    before its first append, so history stays fold-forward-continuous
    across restarts and revs keep advancing from the store's own
    sequence (no rev aliasing — core/store.py's per-boot random base)."""

    def __init__(self, store, points: Optional[int] = None):
        self._store = store
        self._points = int(points) if points is not None else tsdb_points()
        self._lock = threading.Lock()
        self._last: dict[str, dict] = {}

    def _reseed_locked(self, instance: str) -> dict:
        vals: dict = {}
        try:
            for doc in self._store.find(COLLECTION, {"instance": instance}):
                vals.update(doc.get("vals") or {})
        except Exception:  # noqa: BLE001 — an empty seed only costs
            return {}  # one uncompressed tick, never the append
        return vals

    def append(
        self,
        instance: str,
        service: str,
        vals: dict[str, Any],
        ts: Optional[float] = None,
    ) -> dict:
        """Append one tick for ``instance``; returns the stored doc."""
        ts = time.time() if ts is None else float(ts)
        with self._lock:
            if instance not in self._last:
                self._last[instance] = self._reseed_locked(instance)
            last = self._last[instance]
            changed = {
                family: value
                for family, value in vals.items()
                if last.get(family) != value
            }
            self._last[instance] = dict(vals)
            document = {
                "instance": instance,
                "service": service,
                "ts": round(ts, 3),
                "vals": changed,
            }
            self._store.insert_one(COLLECTION, document)
            # Ring discipline: the budget scales with the instances this
            # appender has seen, so an N-member plane keeps ~points
            # ticks per member (every member lands each tick).
            budget = self._points * max(1, len(self._last))
            try:
                self._store.trim_collection(COLLECTION, budget)
            except NotImplementedError:
                pass  # a backend without the primitive grows unbounded
        return document


# --- history + rollups -------------------------------------------------------

def history(
    store,
    family: str,
    instance: Optional[str] = None,
) -> dict[str, list]:
    """Fold-forward read: ``{instance: [(ts, value), ...]}`` for one
    family, delta compression undone (ticks where the family did not
    change repeat the carried value, so windowed rollups always have a
    baseline)."""
    series: dict[str, list] = {}
    carry: dict[str, Any] = {}
    for doc in store.find(COLLECTION):
        inst = doc.get("instance")
        if inst is None or (instance is not None and inst != instance):
            continue
        vals = doc.get("vals") or {}
        if family in vals:
            carry[inst] = vals[family]
        if inst not in carry or doc.get("ts") is None:
            continue
        series.setdefault(inst, []).append((doc["ts"], carry[inst]))
    return series


def services_of(store) -> dict[str, str]:
    """``{instance: service}`` labels currently present in the ring."""
    labels: dict[str, str] = {}
    for doc in store.find(COLLECTION):
        inst = doc.get("instance")
        if inst is not None and doc.get("service"):
            labels[inst] = doc["service"]
    return labels


def _quantile(deltas: dict[str, float], q: float) -> Optional[float]:
    """Prometheus ``histogram_quantile``: linear interpolation within
    the bucket where the rank falls; the open ``+Inf`` bucket reports
    its lower bound."""
    items = sorted(
        (float("inf") if le in ("+Inf", "inf", "Inf") else float(le), c)
        for le, c in deltas.items()
    )
    if not items:
        return None
    total = items[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_c = 0.0, 0.0
    for le, cumulative in items:
        if cumulative >= rank:
            if le == float("inf"):
                return prev_le
            if cumulative == prev_c:
                return le
            return prev_le + (le - prev_le) * (rank - prev_c) / (
                cumulative - prev_c
            )
        prev_le, prev_c = le, cumulative
    return items[-1][0]


def rollup(
    family: str,
    points: list,
    window_s: float = 600.0,
    now: Optional[float] = None,
) -> Optional[dict]:
    """Windowed rollup over one instance's ``(ts, value)`` points.

    Counters (``*_total``) → ``rate`` per second; histograms → windowed
    ``p50``/``p99``/``mean`` + ``count_rate`` from bucket-count deltas
    (baseline = last snapshot at or before the window start, so samples
    observed before the window never pollute it); gauges →
    ``last``/``avg``/``min``/``max``. A counter reset inside the window
    (member restart) falls back to the post-restart totals."""
    if not points:
        return None
    now = points[-1][0] if now is None else float(now)
    since = now - window_s
    baseline = None
    window = []
    for ts, value in points:
        if ts <= since:
            baseline = (ts, value)
        elif ts <= now:
            window.append((ts, value))
    if not window:
        return None
    last_ts, last = window[-1]
    base_ts = baseline[0] if baseline is not None else since
    span = max(last_ts - base_ts, 1e-9)
    out: dict[str, Any] = {
        "samples": len(window),
        "window_s": window_s,
        "from": round(base_ts, 3),
        "to": round(last_ts, 3),
    }
    if isinstance(last, dict):
        base = {"buckets": {}, "sum": 0.0, "count": 0.0}
        if baseline is not None and isinstance(baseline[1], dict):
            base = baseline[1]
        last_buckets = last.get("buckets") or {}
        base_buckets = base.get("buckets") or {}
        deltas = {
            le: count - base_buckets.get(le, 0.0)
            for le, count in last_buckets.items()
        }
        count_delta = (last.get("count") or 0.0) - (base.get("count") or 0.0)
        sum_delta = (last.get("sum") or 0.0) - (base.get("sum") or 0.0)
        if count_delta < 0 or any(d < 0 for d in deltas.values()):
            deltas = dict(last_buckets)  # reset: counts since restart
            count_delta = last.get("count") or 0.0
            sum_delta = last.get("sum") or 0.0
        out["count"] = count_delta
        out["count_rate"] = round(count_delta / span, 6)
        if count_delta > 0:
            out["mean"] = round(sum_delta / count_delta, 6)
        for name, q in (("p50", 0.5), ("p99", 0.99)):
            value = _quantile(deltas, q)
            if value is not None:
                out[name] = round(value, 6)
        return out
    if family.endswith("_total"):
        base_value = baseline[1] if baseline is not None else 0.0
        if not isinstance(base_value, (int, float)):
            base_value = 0.0
        delta = last - base_value
        if delta < 0:
            delta = last  # counter reset inside the window
        out["delta"] = delta
        out["rate"] = round(delta / span, 6)
        return out
    values = [value for _, value in window if isinstance(value, (int, float))]
    if not values:
        return None
    out["last"] = values[-1]
    out["avg"] = round(sum(values) / len(values), 6)
    out["min"] = min(values)
    out["max"] = max(values)
    return out


def window_rollups(
    store,
    family: str,
    window_s: float = 600.0,
    now: Optional[float] = None,
    instance: Optional[str] = None,
) -> dict[str, dict]:
    """Per-instance rollups for one family — the server-side half of
    ``GET /metrics/history``."""
    out = {}
    for inst, points in history(store, family, instance=instance).items():
        rolled = rollup(family, points, window_s=window_s, now=now)
        if rolled is not None:
            out[inst] = rolled
    return out


# --- collector ---------------------------------------------------------------

class Collector:
    """Per-process collector: snapshot the local registry each tick and
    append it as ``instance`` (a central scraper may instead post every
    member's samples into a store head's ``POST /metrics/ingest``).
    Ticks also republish the SLO gauges (telemetry/slo.py) so
    ``lo_slo_burning{rule}`` moves with the data it judges."""

    def __init__(
        self,
        store,
        registry,
        instance: str = "local",
        service: str = "runner",
        interval_s: Optional[float] = None,
        points: Optional[int] = None,
    ):
        self._store = store
        self._registry = registry
        self._instance = instance
        self._service = service
        self._interval = (
            metrics_interval_s() if interval_s is None else float(interval_s)
        )
        self._tsdb = TSDB(store, points=points)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        self.errors = 0

    def collect_once(self, ts: Optional[float] = None) -> None:
        """One scrape tick; failures are counted and swallowed — the
        observability plane must never take down what it observes."""
        try:
            vals = parse_samples(self._registry.render())
            self._tsdb.append(self._instance, self._service, vals, ts=ts)
            self.ticks += 1
        except Exception:  # noqa: BLE001 — best-effort, like the journal
            self.errors += 1
            traceback.print_exc()
            return
        try:
            from learningorchestra_tpu_torch.telemetry import slo as _slo

            _slo.publish(self._store, now=ts)
        except Exception:  # noqa: BLE001
            self.errors += 1
            traceback.print_exc()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.collect_once()

    def start(self) -> "Collector":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="lo-tsdb-collector"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
