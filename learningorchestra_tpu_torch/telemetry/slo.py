"""Declarative SLO rules evaluated against the in-store TSDB.

The port's copy of ``learningorchestra_tpu/telemetry/slo.py``.

Each rule names a metric family, a windowed statistic (``p99``,
``rate``, ``last``), a comparison, and a threshold; evaluation walks
``__lo_metrics__`` (telemetry/tsdb.py) per instance and reports the
worst offender. Results surface three ways:

- ``GET /debug/slo`` (utils/web.py) — ok/burning per rule with the
  offending instance and observed value;
- a ``degraded`` field on ``/health`` — any burning rule flips it;
- ``lo_slo_burning{rule}`` gauges on ``/metrics`` — republished each
  scrape tick by the collector, so alerting closes the loop: the chaos
  drills (testing/faults.py) can assert a fault is *visible*, not just
  survived.

Thresholds are knobs (``LO_SLO_*``, validated at the runner's boot);
evaluation is cached per ``__lo_metrics__`` rev so a polled ``/health``
costs one rev probe, not a re-evaluation, until new samples land.
"""

from __future__ import annotations

import threading
from typing import Optional

from learningorchestra_tpu_torch.sched.config import _float_env, _int_env
from learningorchestra_tpu_torch.telemetry import metrics as _metrics
from learningorchestra_tpu_torch.telemetry import tsdb as _tsdb


# --- knobs -------------------------------------------------------------------

def slo_window_s() -> float:
    """Evaluation window in seconds (``LO_SLO_WINDOW_S``, > 0)."""
    value = _float_env("LO_SLO_WINDOW_S", 600.0)
    if value <= 0:
        raise ValueError(f"LO_SLO_WINDOW_S must be > 0, got {value}")
    return value


def slo_serve_p99_s() -> float:
    """Serving latency objective: burning when the windowed p99 of
    ``lo_serve_request_seconds`` exceeds this (``LO_SLO_SERVE_P99_S``
    seconds, >= 0)."""
    return _float_env("LO_SLO_SERVE_P99_S", 1.0)


def slo_5xx_rate() -> float:
    """Error-rate objective: burning when 5xx responses per second
    (windowed, summed across routes) exceed this
    (``LO_SLO_5XX_RATE``, >= 0)."""
    return _float_env("LO_SLO_5XX_RATE", 0.5)


def slo_queue_depth() -> int:
    """Backlog objective: burning when ``lo_sched_queue_depth`` last
    sampled above this (``LO_SLO_QUEUE_DEPTH``, integral >= 1 — the
    default tracks ``LO_SCHED_QUEUE_CAP``'s default, so burning means
    admission control is about to 429)."""
    return _int_env("LO_SLO_QUEUE_DEPTH", 64)


def slo_replication_lag() -> int:
    """Durability objective: burning when a follower's
    ``lo_store_replication_lag`` last sampled above this many WAL
    records (``LO_SLO_REPL_LAG``, integral >= 1)."""
    return _int_env("LO_SLO_REPL_LAG", 1000)


def validate_env() -> None:
    """Boot hook (services/runner.py): force every SLO knob
    through its parser so a malformed value fails the boot, not the
    first evaluation tick."""
    slo_window_s()
    slo_serve_p99_s()
    slo_5xx_rate()
    slo_queue_depth()
    slo_replication_lag()


# --- rules -------------------------------------------------------------------

class Rule:
    """One objective: ``stat`` of ``family`` over ``window_s`` compared
    against ``threshold`` (burning when ``value <op> threshold``)."""

    __slots__ = ("name", "family", "stat", "op", "threshold", "window_s")

    def __init__(self, name, family, stat, op, threshold, window_s):
        self.name = name
        self.family = family
        self.stat = stat
        self.op = op
        self.threshold = threshold
        self.window_s = window_s

    def breached(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" else (
            value < self.threshold
        )

    def as_dict(self) -> dict:
        return {
            "rule": self.name,
            "family": self.family,
            "stat": self.stat,
            "op": self.op,
            "threshold": self.threshold,
            "window_s": self.window_s,
        }


def default_rules() -> list[Rule]:
    window = slo_window_s()
    return [
        Rule(
            "serve_p99", "lo_serve_request_seconds", "p99", ">",
            slo_serve_p99_s(), window,
        ),
        Rule(
            "http_5xx_rate", _tsdb.DERIVED_5XX, "rate", ">",
            slo_5xx_rate(), window,
        ),
        Rule(
            "sched_queue_depth", "lo_sched_queue_depth", "last", ">",
            float(slo_queue_depth()), window,
        ),
        Rule(
            "store_replication_lag", "lo_store_replication_lag", "last",
            ">", float(slo_replication_lag()), window,
        ),
    ]


# --- evaluation --------------------------------------------------------------

def evaluate(
    store,
    rules: Optional[list[Rule]] = None,
    now: Optional[float] = None,
) -> dict:
    """All rules against the store's TSDB: per-rule ok/burning with the
    offending instance and observed value, plus the rolled-up
    ``degraded`` verdict ``/health`` reports."""
    rules = default_rules() if rules is None else rules
    out_rules = []
    burning = []
    for rule in rules:
        worst = None
        worst_instance = None
        for instance, points in _tsdb.history(store, rule.family).items():
            rolled = _tsdb.rollup(
                rule.family, points, window_s=rule.window_s, now=now
            )
            value = (rolled or {}).get(rule.stat)
            if value is None:
                continue
            if worst is None or (
                value > worst if rule.op == ">" else value < worst
            ):
                worst, worst_instance = value, instance
        entry = rule.as_dict()
        entry["value"] = worst
        entry["instance"] = worst_instance
        entry["burning"] = worst is not None and rule.breached(worst)
        if entry["burning"]:
            burning.append(rule.name)
        out_rules.append(entry)
    return {"rules": out_rules, "burning": burning, "degraded": bool(burning)}


_GAUGE = None
_GAUGE_LOCK = threading.Lock()


def _burning_gauge():
    global _GAUGE
    with _GAUGE_LOCK:
        if _GAUGE is None:
            _GAUGE = _metrics.global_registry().gauge(
                "lo_slo_burning",
                "1 while the SLO rule is breached, 0 otherwise",
                labels=("rule",),
            )
        return _GAUGE


def publish(
    store,
    rules: Optional[list[Rule]] = None,
    now: Optional[float] = None,
) -> dict:
    """Evaluate and republish the ``lo_slo_burning{rule}`` gauges —
    called each collector tick, and by the cached :func:`status`."""
    result = evaluate(store, rules=rules, now=now)
    gauge = _burning_gauge()
    for entry in result["rules"]:
        gauge.labels(entry["rule"]).set(1.0 if entry["burning"] else 0.0)
    return result


# One cached evaluation per store, keyed by the ring collection's rev:
# a polled /health re-evaluates only after new samples land, never per
# request. Keyed by id(store) — stores are process-lifetime objects and
# the cache is advisory (a stale hit after id reuse re-keys on the next
# rev mismatch).
_STATUS_CACHE: dict[int, tuple[int, dict]] = {}
_STATUS_LOCK = threading.Lock()


def status(store, now: Optional[float] = None) -> dict:
    rev = store.collection_rev(_tsdb.COLLECTION)
    with _STATUS_LOCK:
        cached = _STATUS_CACHE.get(id(store))
        if cached is not None and cached[0] == rev and now is None:
            return cached[1]
    result = publish(store, now=now)
    with _STATUS_LOCK:
        _STATUS_CACHE[id(store)] = (rev, result)
    return result
