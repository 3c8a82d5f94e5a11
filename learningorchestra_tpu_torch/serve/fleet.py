"""Replicated serving fleet: placement, residency gossip, replica agent.

Counterpart of ``learningorchestra_tpu/serve/fleet.py``, module and
public names kept. The control plane that lets N serving replicas (one
model_builder process a card or a process) act as one fleet:

- **Placement** — models are placed on replicas by consistent hash of
  the MODEL NAME on the shard map's 64-vnode blake2b ring
  (``core/shardmap._ring_hash``), with ``LO_FLEET_RF`` distinct owners
  per model. The ``(replicas, rf)`` geometry is one document in the
  ``__lo_placement__`` collection on the meta store — seeded through
  the atomic ``create_collection`` claim and cached client-side with
  TTL + rev revalidation, like ``__lo_shardmap__``: the map is
  authoritative, so a router and its replicas never disagree on
  geometry.
- **Residency gossip** — each replica heartbeats one rev-bumped row in
  ``__lo_fleet__`` (its url, pinned models, pinned bytes, batcher
  inflight). The router's :class:`FleetView` reads the whole
  collection the same TTL + rev way; a replica whose heartbeat is
  older than ``LO_FLEET_DOWN_S`` is routed AROUND before a TCP timeout
  would notice it died.
- **The replica agent** — each serving replica runs one
  :class:`ReplicaAgent`: every tick it resolves the placement map,
  pins exactly its assigned checkpoints inside its ``LO_SERVE_BYTES``
  budget, warms NEW assignments at the serve shape
  (``compile/warmup.py``; a tree checkpoint, whose width the agent
  does not know, is only pinned), releases models it no longer owns,
  and writes its heartbeat.

Knob table (the runner's ``fleet config:`` boot line):

=======================  =======  ====================================
env var                  default  meaning
=======================  =======  ====================================
``LO_FLEET_REPLICAS``    1        serving replicas in the fleet
``LO_FLEET_RF``          1        owners per model (replication
                                  factor, clamped to the replica
                                  count)
``LO_FLEET_MODEL_QPS``   0        per-model admission quota at the
                                  router (token bucket, requests/s;
                                  ``0`` = off)
``LO_FLEET_DOWN_S``      3.0      heartbeat age past which the router
                                  routes around a replica
``LO_FLEET_REPLICA``     unset    THIS process's replica index (set by
                                  whoever starts the process; arms
                                  the replica agent)
=======================  =======  ====================================
"""

from __future__ import annotations

import bisect
import os
import threading
import time
import traceback
from typing import Optional
from urllib.parse import urlsplit

from learningorchestra_tpu_torch.core.shardmap import _ring_hash

PLACEMENT_COLLECTION = "__lo_placement__"
PLACEMENT_DOC_ID = 1
HEARTBEAT_COLLECTION = "__lo_fleet__"

DEFAULT_REPLICAS = 1
DEFAULT_RF = 1
DEFAULT_MODEL_QPS = 0.0
DEFAULT_DOWN_S = 3.0
# placement/heartbeat client cache windows: rev revalidation makes a
# short TTL cheap (one collection_rev probe), and failover recovery is
# bounded by one placement refresh — keep it snappy
DEFAULT_PLACEMENT_TTL_S = 2.0
DEFAULT_VIEW_TTL_S = 0.5
_RING_VNODES = 64


# ---------------------------------------------------------------------------
# Knobs


def replicas() -> int:
    """``LO_FLEET_REPLICAS`` validated: serving replicas in the fleet, strictly integral >= 1. Only the
    SEEDING process's value matters — every later client adopts the
    placement document's geometry."""
    raw = os.environ.get("LO_FLEET_REPLICAS", "").strip()
    if not raw:
        return DEFAULT_REPLICAS
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"LO_FLEET_REPLICAS must be an integer, got {raw!r}"
        ) from None
    if value < 1:
        raise ValueError(f"LO_FLEET_REPLICAS must be >= 1, got {value}")
    return value


def replication_factor() -> int:
    """``LO_FLEET_RF`` validated: how many distinct replicas own each model, strictly integral >= 1. A
    value past the replica count is clamped at placement time — every
    replica owning every model is the degenerate maximum."""
    raw = os.environ.get("LO_FLEET_RF", "").strip()
    if not raw:
        return DEFAULT_RF
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"LO_FLEET_RF must be an integer, got {raw!r}"
        ) from None
    if value < 1:
        raise ValueError(f"LO_FLEET_RF must be >= 1, got {value}")
    return value


def model_qps() -> float:
    """``LO_FLEET_MODEL_QPS`` validated: per-model admission quota at the router in requests/s
    (token bucket, burst of one second's worth); ``0`` disables the
    quota entirely."""
    raw = os.environ.get("LO_FLEET_MODEL_QPS", "").strip()
    if not raw:
        return DEFAULT_MODEL_QPS
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"LO_FLEET_MODEL_QPS must be requests/s >= 0, got {raw!r}"
        ) from None
    if value < 0 or value != value:  # NaN included
        raise ValueError(
            f"LO_FLEET_MODEL_QPS must be >= 0, got {value}"
        )
    return value


def down_after_s() -> float:
    """``LO_FLEET_DOWN_S`` validated: heartbeat age in seconds past which the router treats a replica as
    down and routes around it. Strictly > 0 — the gossip clock needs a
    real window."""
    raw = os.environ.get("LO_FLEET_DOWN_S", "").strip()
    if not raw:
        return DEFAULT_DOWN_S
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"LO_FLEET_DOWN_S must be seconds > 0, got {raw!r}"
        ) from None
    if not value > 0:
        raise ValueError(f"LO_FLEET_DOWN_S must be > 0, got {value}")
    return value


def replica_index() -> Optional[int]:
    """``LO_FLEET_REPLICA`` validated: THIS process's replica index,
    set per process by whoever starts it, never by operators. ``None`` when unset — the process is not a fleet
    member and runs no replica agent."""
    raw = os.environ.get("LO_FLEET_REPLICA", "").strip()
    if not raw:
        return None
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"LO_FLEET_REPLICA must be an integer, got {raw!r}"
        ) from None
    if value < 0:
        raise ValueError(f"LO_FLEET_REPLICA must be >= 0, got {value}")
    return value


def validate_env() -> dict:
    """Read every fleet knob (raising on malformed values) and return
    the resolved configuration (the runner's ``fleet config:`` boot
    line). A replica index outside the fleet refuses bring-up: the
    process was mis-wired."""
    config = {
        "LO_FLEET_REPLICAS": replicas(),
        "LO_FLEET_RF": replication_factor(),
        "LO_FLEET_MODEL_QPS": model_qps(),
        "LO_FLEET_DOWN_S": down_after_s(),
        "LO_FLEET_REPLICA": replica_index(),
    }
    index = config["LO_FLEET_REPLICA"]
    if index is not None and index >= config["LO_FLEET_REPLICAS"]:
        raise ValueError(
            f"LO_FLEET_REPLICA {index} is outside the fleet "
            f"(LO_FLEET_REPLICAS={config['LO_FLEET_REPLICAS']})"
        )
    return config


# accessor aliases for call sites whose natural parameter name shadows
# the module-level function
_env_replicas = replicas
_env_rf = replication_factor


# ---------------------------------------------------------------------------
# Placement: model name -> owning replicas


class PlacementRing:
    """Consistent-hash placement of model names on replicas: the
    shardmap's 64-vnode blake2b ring, keyed by MODEL NAME (not stripe
    index). :meth:`owners` walks the ring clockwise collecting ``rf``
    DISTINCT replicas, so losing one replica moves only its models and
    adding a replication factor never reshuffles the primary."""

    def __init__(self, replicas: int):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.replicas = replicas
        points = []
        for replica in range(replicas):
            for vnode in range(_RING_VNODES):
                points.append(
                    (_ring_hash(f"replica:{replica}:{vnode}"), replica)
                )
        points.sort()
        self._ring_points = [point for point, _ in points]
        self._ring_replicas = [replica for _, replica in points]

    def owners(self, model_name: str, rf: int = 1) -> list[int]:
        """The ``min(rf, replicas)`` distinct replicas owning
        ``model_name``, primary first, in ring order — the router's
        failover order."""
        rf = max(1, min(rf, self.replicas))
        if self.replicas == 1:
            return [0]
        point = _ring_hash(f"model:{model_name}")
        index = bisect.bisect_right(self._ring_points, point)
        owners: list[int] = []
        for step in range(len(self._ring_replicas)):
            replica = self._ring_replicas[
                (index + step) % len(self._ring_replicas)
            ]
            if replica not in owners:
                owners.append(replica)
                if len(owners) == rf:
                    break
        return owners


class PlacementClient:
    """The client half of the placement service: one document on the
    meta store, seeded through the atomic collection claim, cached with
    TTL + rev revalidation — ``__lo_shardmap__``'s exact contract
    (core/shardmap.ShardMapClient), so the fleet can never run two
    geometries."""

    def __init__(
        self,
        meta_store,
        replicas: Optional[int] = None,
        rf: Optional[int] = None,
        ttl_s: float = DEFAULT_PLACEMENT_TTL_S,
    ):
        self._meta = meta_store
        self._replicas = _env_replicas() if replicas is None else replicas
        self._rf = _env_rf() if rf is None else rf
        self._ttl_s = ttl_s
        self._lock = threading.Lock()
        self._doc: Optional[dict] = None
        self._doc_rev = -1
        self._checked_at = 0.0
        self._ring: Optional[PlacementRing] = None

    @property
    def rev(self) -> int:
        """The placement collection's last observed rev (the
        ``lo_fleet_placement_rev`` gauge's source)."""
        with self._lock:
            return self._doc_rev

    def document(self) -> dict:
        """The live placement document, seeding it on first contact."""
        now = time.monotonic()
        with self._lock:
            if (
                self._doc is not None
                and now - self._checked_at < self._ttl_s
            ):
                return self._doc
            live_rev = self._meta.collection_rev(PLACEMENT_COLLECTION)
            if self._doc is not None and live_rev == self._doc_rev:
                self._checked_at = now
                return self._doc
            doc = self._meta.find_one(
                PLACEMENT_COLLECTION, {"_id": PLACEMENT_DOC_ID}
            )
            if doc is None:
                # first contact: claim-then-seed; a lost claim means a
                # concurrent seeder won — read their document instead
                if self._meta.create_collection(PLACEMENT_COLLECTION):
                    doc = {
                        "_id": PLACEMENT_DOC_ID,
                        "replicas": self._replicas,
                        "rf": self._rf,
                    }
                    self._meta.insert_one(PLACEMENT_COLLECTION, doc)
                else:
                    doc = self._meta.find_one(
                        PLACEMENT_COLLECTION, {"_id": PLACEMENT_DOC_ID}
                    )
                    if doc is None:  # claimed but not yet seeded: ours
                        doc = {
                            "_id": PLACEMENT_DOC_ID,
                            "replicas": self._replicas,
                            "rf": self._rf,
                        }
                        self._meta.insert_one(PLACEMENT_COLLECTION, doc)
            if doc["replicas"] != self._replicas:
                raise ValueError(
                    f"placement map says {doc['replicas']} replicas but "
                    f"this process is wired to {self._replicas} — "
                    "LO_FLEET_REPLICAS does not match the deployed fleet"
                )
            self._doc = doc
            self._doc_rev = self._meta.collection_rev(PLACEMENT_COLLECTION)
            self._checked_at = now
            _fleet_metrics()["placement_rev"].set(self._doc_rev)
            return doc

    def ring(self) -> PlacementRing:
        doc = self.document()
        with self._lock:
            if self._ring is None or self._ring.replicas != doc["replicas"]:
                self._ring = PlacementRing(doc["replicas"])
            return self._ring

    def owners(self, model_name: str) -> list[int]:
        """The model's owning replicas, primary first (the router's
        failover order, the agent's assignment test)."""
        doc = self.document()
        return self.ring().owners(model_name, doc["rf"])


# ---------------------------------------------------------------------------
# Residency gossip


def _parse_url(url: str) -> Optional[tuple[str, int]]:
    try:
        parts = urlsplit(url if "//" in url else f"http://{url}")
        if parts.hostname is None or parts.port is None:
            return None
        return parts.hostname, parts.port
    except ValueError:
        return None


class Heartbeat:
    """One replica's rev-bumped residency row in ``__lo_fleet__``: the
    write half of the gossip (:class:`FleetView` is the read half).
    Row ids are ``replica + 1`` (store ids start at 1)."""

    def __init__(self, store, index: int, url: str):
        self._store = store
        self.index = index
        self.url = url
        self._seeded = False

    def write(self, models: list[str], pinned_bytes: int, inflight: int) -> dict:
        row = {
            "replica": self.index,
            "url": self.url,
            "models": sorted(models),
            "pinned_bytes": int(pinned_bytes),
            "inflight": int(inflight),
            # wall clock, not monotonic: the router is another process
            # (gossip assumes fleet hosts share NTP discipline)
            "stamp": time.time(),
        }
        if not self._seeded:
            self._store.create_collection(HEARTBEAT_COLLECTION)
            existing = self._store.find_one(
                HEARTBEAT_COLLECTION, {"_id": self.index + 1}
            )
            if existing is None:
                self._store.insert_one(
                    HEARTBEAT_COLLECTION, {"_id": self.index + 1, **row}
                )
                self._seeded = True
                return row
            self._seeded = True
        # update_one bumps the collection rev, so every FleetView's
        # next TTL expiry sees the fresh stamp with one rev probe
        self._store.update_one(
            HEARTBEAT_COLLECTION, {"_id": self.index + 1}, row
        )
        return row


class FleetView:
    """The router's health/residency view: every ``__lo_fleet__`` row,
    cached TTL + rev like the placement map. A replica is HEALTHY when
    its heartbeat is younger than ``LO_FLEET_DOWN_S`` — the router
    orders owners healthy-first, so a dead replica is routed around
    before its TCP timeouts would surface."""

    def __init__(
        self,
        store,
        ttl_s: float = DEFAULT_VIEW_TTL_S,
        down_s: Optional[float] = None,
    ):
        self._store = store
        self._ttl_s = ttl_s
        self.down_s = down_after_s() if down_s is None else down_s
        self._lock = threading.Lock()
        self._rows: dict[int, dict] = {}
        self._rev = -1
        self._checked_at = 0.0

    def rows(self) -> dict[int, dict]:
        """Replica index -> latest heartbeat row."""
        now = time.monotonic()
        with self._lock:
            if self._rows and now - self._checked_at < self._ttl_s:
                return self._rows
            live_rev = self._store.collection_rev(HEARTBEAT_COLLECTION)
            if self._rev == live_rev:
                self._checked_at = now
                return self._rows
            rows = {}
            for row in self._store.find(HEARTBEAT_COLLECTION, {}):
                if "replica" in row:
                    rows[int(row["replica"])] = row
            self._rows = rows
            self._rev = live_rev
            self._checked_at = now
            return rows

    def healthy(self, index: int) -> bool:
        row = self.rows().get(index)
        return (
            row is not None
            and time.time() - row.get("stamp", 0.0) < self.down_s
        )

    def target(self, index: int) -> Optional[tuple[str, int]]:
        row = self.rows().get(index)
        if row is None:
            return None
        return _parse_url(row.get("url", ""))

    def residency(self) -> dict:
        """The ``GET /models/<name>`` "fleet" payload's replica half:
        per-replica url / pinned models / bytes / inflight / health."""
        now = time.time()
        out = {}
        for index, row in sorted(self.rows().items()):
            age_s = max(now - row.get("stamp", 0.0), 0.0)
            out[str(index)] = {
                "url": row.get("url", ""),
                "models": row.get("models", []),
                "pinned_bytes": row.get("pinned_bytes", 0),
                "inflight": row.get("inflight", 0),
                "age_s": round(age_s, 3),
                "healthy": age_s < self.down_s,
            }
        return out


# ---------------------------------------------------------------------------
# The replica agent


class ReplicaAgent:
    """One per serving replica: every tick, converge residency on the
    placement map and gossip a heartbeat.

    - newly-assigned models are pinned through the serve plane's
      registry AND warmed at the serve shape (compile/warmup.py) so a
      placement change never costs a first-request compile;
    - models this replica no longer owns are released (the byte budget
      belongs to the assignment);
    - the heartbeat row carries what the router needs: url, pinned
      models, pinned bytes, batcher inflight.

    ``refresh()`` is one synchronous tick (tests drive it directly);
    :meth:`start` runs it on a daemon thread every ``interval_s``
    (default: a third of the down window, so a healthy replica can
    miss two ticks before the router routes around it).
    """

    def __init__(
        self,
        store,
        models_dir: str,
        serve,
        index: Optional[int] = None,
        url: str = "",
        total: Optional[int] = None,
        rf: Optional[int] = None,
        interval_s: Optional[float] = None,
        placement_ttl_s: float = DEFAULT_PLACEMENT_TTL_S,
        warm: bool = True,
    ):
        resolved = replica_index() if index is None else index
        if resolved is None:
            raise ValueError(
                "ReplicaAgent needs a replica index "
                "(LO_FLEET_REPLICA or index=)"
            )
        self.index = resolved
        self.models_dir = models_dir
        self.serve = serve
        self.url = url
        self._warm = warm
        down_s = down_after_s()
        self.interval_s = (
            max(down_s / 3.0, 0.2) if interval_s is None else interval_s
        )
        self.placement = PlacementClient(
            store, replicas=total, rf=rf, ttl_s=placement_ttl_s
        )
        self.heartbeat = Heartbeat(store, self.index, url)
        self._assigned: set[str] = set()
        self._warmed: set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _checkpoint_names(self) -> list[str]:
        from learningorchestra_tpu_torch.ml.checkpoint import CHECKPOINT_SUFFIX

        if not self.models_dir or not os.path.isdir(self.models_dir):
            return []
        return sorted(
            name[: -len(CHECKPOINT_SUFFIX)]
            for name in os.listdir(self.models_dir)
            if name.endswith(CHECKPOINT_SUFFIX)
        )

    def assigned_models(self) -> list[str]:
        """The checkpoints on disk this replica owns under the live
        placement map."""
        return [
            name
            for name in self._checkpoint_names()
            if self.index in self.placement.owners(name)
        ]

    def refresh(self) -> dict:
        """One tick: converge pins on the assignment, then heartbeat.
        Per-model failures are contained — one unloadable checkpoint
        must not take the whole replica out of the gossip."""
        from learningorchestra_tpu_torch.ml.checkpoint import checkpoint_path

        assigned = set(self.assigned_models())
        pinned: list[str] = []
        warmed = 0
        errors = 0
        registry = self.serve.registry
        for name in sorted(assigned):
            path = checkpoint_path(self.models_dir, name)
            try:
                if self._warm and name not in self._warmed:
                    from learningorchestra_tpu_torch.compile.warmup import (
                        warm_artifact,
                    )

                    # warm_artifact pins through the registry, then runs
                    # the serve-shaped forward where the model records
                    # its width (lr, nb); a tree model is only pinned
                    warm_artifact(path, serve=self.serve)
                    self._warmed.add(name)
                    warmed += 1
                else:
                    registry.get(path)
                pinned.append(name)
            except Exception:  # noqa: BLE001 — keep gossiping
                errors += 1
        for name in sorted(self._assigned - assigned):
            # assignment moved away: the byte budget follows it
            registry.release(checkpoint_path(self.models_dir, name))
            self._warmed.discard(name)
        self._assigned = assigned
        stats = registry.stats()
        metrics = _fleet_metrics()
        metrics["replicas"].set(self.placement.document()["replicas"])
        metrics["pinned_bytes"].set(stats["bytes"])
        self.heartbeat.write(
            pinned, stats["bytes"], self.serve.batcher.depth()
        )
        return {
            "replica": self.index,
            "assigned": sorted(assigned),
            "pinned": pinned,
            "warmed": warmed,
            "errors": errors,
            "pinned_bytes": stats["bytes"],
        }

    def start(self) -> "ReplicaAgent":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run,
                daemon=True,
                name=f"fleet-replica-{self.index}",
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 — the loop must survive a
                # store hiccup (the missed heartbeat IS the health
                # signal), but the operator still gets the traceback
                traceback.print_exc()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# Telemetry

_METRICS: Optional[dict] = None
_METRICS_LOCK = threading.Lock()


def _fleet_metrics() -> dict:
    """Fleet gauges, declared once per process."""
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            from learningorchestra_tpu_torch.telemetry import global_registry

            registry = global_registry()
            _METRICS = {
                "replicas": registry.gauge(
                    "lo_fleet_replicas",
                    "Serving replicas in the placement geometry",
                ),
                "pinned_bytes": registry.gauge(
                    "lo_fleet_pinned_bytes",
                    "This replica's pinned model parameter bytes",
                ),
                "placement_rev": registry.gauge(
                    "lo_fleet_placement_rev",
                    "Last observed __lo_placement__ collection rev",
                ),
            }
        return _METRICS
