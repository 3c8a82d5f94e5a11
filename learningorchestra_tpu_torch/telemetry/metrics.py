"""Thread-safe process metrics rendered in Prometheus text exposition.

One :class:`MetricsRegistry` per process (``global_registry``); services,
the job manager, the SPMD dispatcher and the store all declare their
metrics against it, and every ``WebApp`` serves its ``render()`` at
``GET /metrics`` (text format version 0.0.4, the format every Prometheus
scraper and ``promtool`` accepts). Declarations are get-or-create so
seven services sharing one process share one ``lo_http_requests_total``
family; a re-declaration with a different kind or label set is a
programming error and raises.

The port's copy of ``learningorchestra_tpu/telemetry/metrics.py``, less
the XLA compile-cache collector (the port compiles no XLA programs).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

# Prometheus' default buckets stop at 10 s; model builds run minutes, so
# the tail extends to 10 min before +Inf.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _format_value(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value)


def _labels_text(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    pairs = ",".join(
        f'{name}="{_escape_label(value)}"'
        for name, value in zip(names, values)
    )
    return "{" + pairs + "}"


class _Child:
    """One labelset's value cell — what ``.labels(...)`` hands back."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock: threading.Lock, buckets: tuple[float, ...]):
        self._lock = lock
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            # per-bucket counts, cumulated at render time
            for index, bound in enumerate(self.buckets):
                if value <= bound:
                    self.counts[index] += 1
                    break


class Metric:
    """A family: name + help + kind + labelled children."""

    def __init__(
        self,
        name: str,
        help_text: str,
        kind: str,
        label_names: tuple[str, ...],
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
        fn: Optional[Callable[[], float]] = None,
    ):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.label_names = label_names
        self.buckets = tuple(sorted(buckets))
        self.fn = fn
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def labels(self, *values: object) -> object:
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} expects labels {self.label_names}, "
                f"got {values!r}"
            )
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.kind == "histogram":
                    child = _HistogramChild(self._lock, self.buckets)
                else:
                    child = _Child(self._lock)
                self._children[key] = child
        return child

    # label-less convenience: metric.inc() / .set() / .observe()
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def value(self, *label_values: object) -> float:
        child = self.labels(*label_values)
        return child.value

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        if self.fn is not None:
            lines.append(f"{self.name} {_format_value(float(self.fn()))}")
            return lines
        with self._lock:
            children = list(self._children.items())
        if not children and not self.label_names:
            # a declared scalar counter/gauge always renders (0), so
            # dashboards see the family before its first increment
            if self.kind in ("counter", "gauge"):
                lines.append(f"{self.name} 0")
            return lines
        for key, child in sorted(children):
            labels = _labels_text(self.label_names, key)
            if self.kind == "histogram":
                cumulative = 0
                for bound, count in zip(child.buckets, child.counts):
                    cumulative += count
                    bucket_labels = _labels_text(
                        self.label_names + ("le",),
                        key + (_format_value(bound),),
                    )
                    lines.append(
                        f"{self.name}_bucket{bucket_labels} {cumulative}"
                    )
                inf_labels = _labels_text(
                    self.label_names + ("le",), key + ("+Inf",)
                )
                lines.append(f"{self.name}_bucket{inf_labels} {child.count}")
                lines.append(
                    f"{self.name}_sum{labels} {_format_value(child.sum)}"
                )
                lines.append(f"{self.name}_count{labels} {child.count}")
            else:
                lines.append(
                    f"{self.name}{labels} {_format_value(child.value)}"
                )
        return lines


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []

    def _declare(
        self,
        name: str,
        help_text: str,
        kind: str,
        labels: Sequence[str],
        **kwargs,
    ) -> Metric:
        label_names = tuple(labels)
        with self._lock:
            metric = self._metrics.get(name)
            if metric is not None:
                if metric.kind != kind or metric.label_names != label_names:
                    raise ValueError(
                        f"metric {name!r} re-declared as {kind}"
                        f"{label_names} (was {metric.kind}"
                        f"{metric.label_names})"
                    )
                return metric
            metric = Metric(name, help_text, kind, label_names, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help_text: str, labels: Sequence[str] = ()
    ) -> Metric:
        return self._declare(name, help_text, "counter", labels)

    def gauge(
        self,
        name: str,
        help_text: str,
        labels: Sequence[str] = (),
        fn: Optional[Callable[[], float]] = None,
    ) -> Metric:
        return self._declare(name, help_text, "gauge", labels, fn=fn)

    def histogram(
        self,
        name: str,
        help_text: str,
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Metric:
        return self._declare(
            name, help_text, "histogram", labels, buckets=tuple(buckets)
        )

    def declared_families(self) -> dict[str, str]:
        """Snapshot of ``{family name: kind}`` for every declared
        metric — the introspection surface the deployment-contract
        analyzer (analysis/contracts.py, LO303) and its anti-rot test
        compare against ``docs/observability.md``'s catalog."""
        with self._lock:
            return {
                name: metric.kind for name, metric in self._metrics.items()
            }

    def register_collector(
        self, collector: Callable[["MetricsRegistry"], None]
    ) -> None:
        """``collector(registry)`` runs at every render — the hook for
        gauges whose truth lives elsewhere (store occupancy, jitcache
        counters) and is cheaper to read at scrape time than to push on
        every mutation."""
        with self._lock:
            self._collectors.append(collector)

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        for collector in collectors:
            try:
                collector(self)
            except Exception:  # noqa: BLE001 — scraping must not 500
                # a failing collector (e.g. a store mid-shutdown) loses
                # its gauges for this scrape, never the whole endpoint
                continue
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return "\n".join(
            line for metric in metrics for line in metric.render()
        ) + "\n"


_GLOBAL: Optional[MetricsRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def global_registry() -> MetricsRegistry:
    """The process-wide registry every component reports into. (The
    reference also wires its XLA compile-cache collector here; the port
    compiles no XLA programs.)"""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MetricsRegistry()
        return _GLOBAL


# store id() → its "store" label value. The collector closure keeps a
# registered store alive for the life of the process (its gauges must
# keep answering), so ids never recycle here. Typical processes register
# exactly one store; the label exists so an atypical one (store server
# co-habiting with services, tests) reports each store distinctly
# instead of the collectors silently overwriting one shared gauge.
_REGISTERED_STORES: "dict[int, str]" = {}


def register_store(
    store: object,
    registry: Optional[MetricsRegistry] = None,
    role: Optional[dict] = None,
) -> None:
    """Expose a store's occupancy gauges (collection count, WAL bytes,
    spill bytes) on ``/metrics``, labelled by registration order.
    Idempotent per store instance; a store without ``telemetry_stats``
    (e.g. the remote-store client — the store SERVER scrapes its own)
    is a no-op.

    ``role`` (the store SERVER's HA role dict) additionally exports the
    replication health the failover story is judged by
    (docs/replication.md): ``lo_store_replication_lag`` (follower:
    acknowledged records not yet applied locally),
    ``lo_store_loss_window`` (what this server's last takeover
    measurably cost, in records), and ``lo_store_unreplicated_acks``
    (sync-repl mode: writes acknowledged after the replication wait
    timed out)."""
    if hasattr(store, "shard_occupancy"):
        # a sharded client fronting N groups: per-shard gauges instead
        # of the single-store family (every service create_app calls
        # this entry point — the sharded fleet reports without any
        # call-site changes)
        register_sharded_store(store, registry=registry)
        return
    stats_fn = getattr(store, "telemetry_stats", None)
    if stats_fn is None:
        return
    registry = registry or global_registry()
    key = id(store)
    with _GLOBAL_LOCK:
        if key in _REGISTERED_STORES:
            return
        label = str(len(_REGISTERED_STORES))
        _REGISTERED_STORES[key] = label
    collections = registry.gauge(
        "lo_store_collections",
        "Collections resident in the store",
        labels=("store",),
    )
    wal_bytes = registry.gauge(
        "lo_store_wal_bytes",
        "Bytes in the store's on-disk WAL",
        labels=("store",),
    )
    spill_bytes = registry.gauge(
        "lo_store_spill_bytes",
        "Bytes of column payloads spilled to disk-backed mappings",
        labels=("store",),
    )
    if role is not None:
        replication_lag = registry.gauge(
            "lo_store_replication_lag",
            "Acknowledged WAL records this follower has not applied yet",
            labels=("store",),
        )
        loss_window = registry.gauge(
            "lo_store_loss_window",
            "Records in the measured loss window of the last takeover",
            labels=("store",),
        )
        unreplicated_acks = registry.gauge(
            "lo_store_unreplicated_acks",
            "Writes acknowledged after the sync-replication wait timed out",
            labels=("store",),
        )

    def collect(_registry: MetricsRegistry) -> None:
        stats = stats_fn()
        collections.labels(label).set(stats["collections"])
        wal_bytes.labels(label).set(stats["wal_bytes"])
        spill_bytes.labels(label).set(stats["spill_bytes"])
        if role is not None:
            poller = role.get("poller")
            replication_lag.labels(label).set(
                poller.lag if poller is not None else 0
            )
            loss = role.get("loss_window") or {}
            loss_window.labels(label).set(loss.get("records", 0) or 0)
            unreplicated_acks.labels(label).set(
                role.get("unreplicated_acks", 0)
            )

    registry.register_collector(collect)


def register_sharded_store(
    store: object, registry: Optional[MetricsRegistry] = None
) -> None:
    """Expose a sharded client's fleet view on ``/metrics``
    (docs/observability.md, docs/dataplane.md): per-shard occupancy
    gauges (``lo_store_shard_collections`` / ``_wal_bytes`` /
    ``_spill_bytes``, labelled by shard index with the meta group at
    ``0``), the last observed shard-map rev
    (``lo_store_shardmap_rev``), and the scatter-gather fan-out
    histogram (``lo_store_shard_fanout`` — how many groups each routed
    call actually touched; a fleet whose reads keep fanning out to one
    group is mis-striped). Occupancy is polled from each group's
    ``/health`` at scrape time; a group mid-failover loses its gauges
    for that scrape, never the endpoint. Idempotent per store
    instance."""
    registry = registry or global_registry()
    key = id(store)
    with _GLOBAL_LOCK:
        if key in _REGISTERED_STORES:
            return
        _REGISTERED_STORES[key] = f"shard-fleet-{len(_REGISTERED_STORES)}"
    shard_collections = registry.gauge(
        "lo_store_shard_collections",
        "Collections resident on the shard group",
        labels=("shard",),
    )
    shard_wal_bytes = registry.gauge(
        "lo_store_shard_wal_bytes",
        "Bytes in the shard group's on-disk WAL",
        labels=("shard",),
    )
    shard_spill_bytes = registry.gauge(
        "lo_store_shard_spill_bytes",
        "Bytes of column payloads the shard group spilled to disk",
        labels=("shard",),
    )
    shardmap_rev = registry.gauge(
        "lo_store_shardmap_rev",
        "Last observed rev of the shard-map collection on the meta group",
    )
    fanout = registry.histogram(
        "lo_store_shard_fanout",
        "Shard groups touched per scatter-gather store call",
        buckets=(1, 2, 4, 8, 16, 32),
    )
    # the client-side hook shardstore.ShardedStore calls with each
    # routed call's width
    store.on_fanout = fanout.observe

    def collect(_registry: MetricsRegistry) -> None:
        for shard, stats in enumerate(store.shard_occupancy()):
            if not stats:
                continue  # group unreachable this scrape
            label = str(shard)
            shard_collections.labels(label).set(stats.get("collections", 0))
            shard_wal_bytes.labels(label).set(stats.get("wal_bytes", 0))
            shard_spill_bytes.labels(label).set(stats.get("spill_bytes", 0))
        shardmap_rev.set(store.shardmap_rev())

    registry.register_collector(collect)
