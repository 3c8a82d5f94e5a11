"""Horizontal sharding: the hash ring, stripe arithmetic, and the
shard-map service contract (docs/dataplane.md "Horizontal sharding").

The reference's data plane stops at one MongoDB replica set; ours
stopped at one replicated store group. ``LO_SHARDS=N`` partitions every
collection's columnar block across N shard GROUPS (each group is the
existing primary+follower+arbiter unit — all of the failover machinery
is reused untouched, per group):

- **Stripes, not rows.** Row ``_id``s are striped in runs of
  ``LO_SHARD_STRIPE_ROWS`` (stripe ``k`` covers global ids
  ``k*S+1 .. (k+1)*S``) and each stripe is placed by a consistent hash
  of its index on a 64-vnode ring. Striping keeps per-request fan-out
  bounded (one contiguous run per shard per call) where per-row hashing
  would shatter every wire frame.
- **Local contiguity.** A shard stores its stripes as ONE dense local
  block: stripe ``k``'s local position is determined by how many
  earlier stripes hashed to the same shard (a prefix count), so the
  per-shard store never sees a gap and the block-append contiguity
  contract (core/store.py) holds unchanged. Global↔local id translation
  is pure arithmetic over the memoized ring walk — no lookup table is
  ever shipped.
- **The meta group (shard 0)** additionally owns every row-DOCUMENT:
  the ``_id: 0`` metadata document, out-of-band inserts, ring
  collections, and the scheduler journal. Document ids stay global —
  only block rows are translated — so document collections behave
  byte-identically to the unsharded store.
- **The shard map** is one document in the ``__lo_shardmap__``
  collection on the meta group, seeded by the first writer through the
  store's atomic ``create_collection`` claim and cached client-side
  rev-style like the devcache: cached values serve for
  ``LO_SHARDMAP_TTL_S`` seconds, then the collection's rev is probed
  and a mismatch re-reads the document. The map is authoritative for
  the stripe width — a client configured differently adopts the map's
  values, so one fleet can never run two geometries.

Rebalancing is a declared NON-goal: the ring is fixed at the map's
shard count for the life of the deployment (drain and re-ingest to
re-shard; the scheduler journal's topology-suffixed scopes make old
entries foreign on a changed topology, sched/journal.py).

The port's copy of ``learningorchestra_tpu/core/shardmap.py``, module
and public names kept: placement is the reference's bit for bit, so a
store that either package sharded reads back the same through the other.
"""

from __future__ import annotations

import bisect
import hashlib
import os
import threading
import time
from typing import Optional

SHARDMAP_COLLECTION = "__lo_shardmap__"
SHARDMAP_DOC_ID = 1

DEFAULT_STRIPE_ROWS = 8192
DEFAULT_MAP_TTL_S = 5.0
_RING_VNODES = 64


def stripe_rows() -> int:
    """``LO_SHARD_STRIPE_ROWS`` validated (deploy/run.sh preflights
    this): rows per placement stripe, strictly integral >= 1. Only the
    SEEDING writer's value matters — every later client adopts the
    shard map's stripe width."""
    # lo: allow[LO305] this IS the validated accessor preflight calls
    raw = os.environ.get("LO_SHARD_STRIPE_ROWS", "").strip()
    if not raw:
        return DEFAULT_STRIPE_ROWS
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"LO_SHARD_STRIPE_ROWS must be an integer, got {raw!r}"
        ) from None
    if value < 1:
        raise ValueError(
            f"LO_SHARD_STRIPE_ROWS must be >= 1, got {value}"
        )
    return value


def map_ttl_s() -> float:
    """``LO_SHARDMAP_TTL_S`` validated (deploy/run.sh preflights this):
    seconds a cached shard map serves before its rev is revalidated.
    ``0`` revalidates on every routed call."""
    # lo: allow[LO305] this IS the validated accessor preflight calls
    raw = os.environ.get("LO_SHARDMAP_TTL_S", "").strip()
    if not raw:
        return DEFAULT_MAP_TTL_S
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"LO_SHARDMAP_TTL_S must be seconds >= 0, got {raw!r}"
        ) from None
    if value < 0:
        raise ValueError(f"LO_SHARDMAP_TTL_S must be >= 0, got {value}")
    return value


def validate_env() -> None:
    """Entry-point preflight (deploy/run.sh): a typo'd shard knob must
    refuse bring-up, never silently run an unintended geometry."""
    stripe_rows()
    map_ttl_s()


def _ring_hash(key: str) -> int:
    # blake2b over md5: no usedforsecurity gymnastics on FIPS builds,
    # and 8 bytes of digest is plenty of ring resolution
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big"
    )


class ShardLayout:
    """Stripe→shard placement plus global↔local id arithmetic.

    The ring walk is memoized per instance: ``_stripe_shard[k]`` is
    stripe ``k``'s shard, ``_local_index[k]`` its prefix count within
    that shard (how many earlier stripes share it), and
    ``_stripes_of[s]`` the ordered global stripes of shard ``s`` — the
    inverse map local→global translation needs. All three grow together
    under one lock; every public method is thread-safe.
    """

    def __init__(self, shards: int, stripe_rows: int):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if stripe_rows < 1:
            raise ValueError(
                f"stripe_rows must be >= 1, got {stripe_rows}"
            )
        self.shards = shards
        self.stripe_rows = stripe_rows
        points = []
        for shard in range(shards):
            for vnode in range(_RING_VNODES):
                points.append((_ring_hash(f"shard:{shard}:{vnode}"), shard))
        points.sort()
        self._ring_points = [point for point, _ in points]
        self._ring_shards = [shard for _, shard in points]
        self._stripe_shard: list[int] = []
        self._local_index: list[int] = []
        self._stripes_of: list[list[int]] = [[] for _ in range(shards)]
        self._lock = threading.Lock()

    def shard_of_stripe(self, stripe: int) -> int:
        return self._placement(stripe)[0]

    def stripe_of(self, gid: int) -> int:
        if gid < 1:
            raise ValueError(f"block row ids start at 1, got {gid}")
        return (gid - 1) // self.stripe_rows

    def shard_of_id(self, gid: int) -> int:
        return self.shard_of_stripe(self.stripe_of(gid))

    def _grow_one(self) -> None:
        # caller holds self._lock (both call sites enter it first)
        k = len(self._stripe_shard)  # lo: allow[LO203]
        if self.shards == 1:
            shard = 0
        else:
            point = _ring_hash(f"stripe:{k}")
            index = bisect.bisect_right(self._ring_points, point)
            shard = self._ring_shards[index % len(self._ring_shards)]
        self._stripe_shard.append(shard)
        self._local_index.append(len(self._stripes_of[shard]))  # lo: allow[LO203]
        self._stripes_of[shard].append(k)

    def _placement(self, stripe: int) -> tuple[int, int]:
        """``(shard, prefix_index)`` of a stripe: the memoized ring walk
        grows AND is read under the one lock, so callers never touch the
        grow-lists themselves."""
        with self._lock:
            while len(self._stripe_shard) <= stripe:
                self._grow_one()
            return self._stripe_shard[stripe], self._local_index[stripe]

    def global_to_local(self, gid: int) -> tuple[int, int]:
        """``(shard, local_id)`` for global block row ``gid``."""
        shard, prefix = self._placement(self.stripe_of(gid))
        local = (
            prefix * self.stripe_rows + (gid - 1) % self.stripe_rows + 1
        )
        return shard, local

    def local_to_global(self, shard: int, local_id: int) -> int:
        """Inverse translation for rows a shard reports with LOCAL ids
        (find results, group keys). Grows the ring walk until the
        shard's stripe list covers the local stripe."""
        if local_id < 1:
            raise ValueError(f"block row ids start at 1, got {local_id}")
        m = (local_id - 1) // self.stripe_rows
        with self._lock:
            while len(self._stripes_of[shard]) <= m:
                self._grow_one()
            stripe = self._stripes_of[shard][m]
        return stripe * self.stripe_rows + (local_id - 1) % self.stripe_rows + 1

    def decompose(self, start_gid: int, rows: int) -> list[dict]:
        """A contiguous global id range as one run per shard.

        Because the range is contiguous, the stripes that land on a
        given shard are consecutive in that shard's local order, so the
        whole per-shard slice is ONE locally-contiguous write/read:
        ``[{"shard", "local_start", "segments": [(offset, count), ...],
        "rows"}]`` where each segment's ``offset`` is relative to
        ``start_gid`` (the caller's slice coordinates), emitted in
        global order.
        """
        if rows <= 0:
            return []
        runs: dict[int, dict] = {}
        stop_gid = start_gid + rows
        stripe = self.stripe_of(start_gid)
        gid = start_gid
        while gid < stop_gid:
            stripe_stop = (stripe + 1) * self.stripe_rows + 1
            seg_stop = min(stop_gid, stripe_stop)
            shard = self.shard_of_stripe(stripe)
            run = runs.get(shard)
            if run is None:
                run = {
                    "shard": shard,
                    "local_start": self.global_to_local(gid)[1],
                    "segments": [],
                    "rows": 0,
                }
                runs[shard] = run
            run["segments"].append((gid - start_gid, seg_stop - gid))
            run["rows"] += seg_stop - gid
            gid = seg_stop
            stripe += 1
        return sorted(runs.values(), key=lambda run: run["shard"])


class ShardMapClient:
    """The client half of the shard-map service: one document on the
    meta group, seeded through the atomic collection claim, cached with
    TTL + rev revalidation (the devcache's pull-invalidation contract —
    a store server cannot call into every client)."""

    def __init__(
        self,
        meta_store,
        shards: int,
        stripe_rows: int,
        ttl_s: Optional[float] = None,
    ):
        self._meta = meta_store
        self._shards = shards
        self._stripe_rows = stripe_rows
        self._ttl_s = map_ttl_s() if ttl_s is None else ttl_s
        self._lock = threading.Lock()
        self._doc: Optional[dict] = None
        self._doc_rev = -1
        self._checked_at = 0.0

    @property
    def rev(self) -> int:
        """The map collection's last observed rev (telemetry surface)."""
        with self._lock:
            return self._doc_rev

    def document(self) -> dict:
        """The live map document, seeding it on first contact."""
        now = time.monotonic()
        with self._lock:
            if (
                self._doc is not None
                and now - self._checked_at < self._ttl_s
            ):
                return self._doc
            live_rev = self._meta.collection_rev(SHARDMAP_COLLECTION)
            if self._doc is not None and live_rev == self._doc_rev:
                self._checked_at = now
                return self._doc
            doc = self._meta.find_one(
                SHARDMAP_COLLECTION, {"_id": SHARDMAP_DOC_ID}
            )
            if doc is None:
                # first contact: claim-then-seed; a lost claim means a
                # concurrent seeder won — read their document instead
                if self._meta.create_collection(SHARDMAP_COLLECTION):
                    doc = {
                        "_id": SHARDMAP_DOC_ID,
                        "shards": self._shards,
                        "stripe_rows": self._stripe_rows,
                    }
                    self._meta.insert_one(SHARDMAP_COLLECTION, doc)
                else:
                    doc = self._meta.find_one(
                        SHARDMAP_COLLECTION, {"_id": SHARDMAP_DOC_ID}
                    )
                    if doc is None:  # claimed but not yet seeded: ours
                        doc = {
                            "_id": SHARDMAP_DOC_ID,
                            "shards": self._shards,
                            "stripe_rows": self._stripe_rows,
                        }
                        self._meta.insert_one(SHARDMAP_COLLECTION, doc)
            if doc["shards"] != self._shards:
                raise ValueError(
                    f"shard map says {doc['shards']} shard groups but "
                    f"this client is wired to {self._shards} — "
                    "LO_STORE_URL does not match the deployed topology"
                )
            self._doc = doc
            self._doc_rev = self._meta.collection_rev(SHARDMAP_COLLECTION)
            self._checked_at = now
            return doc

    def layout(self) -> ShardLayout:
        doc = self.document()
        layout = getattr(self, "_layout", None)
        if (
            layout is None
            or layout.stripe_rows != doc["stripe_rows"]
        ):
            layout = ShardLayout(doc["shards"], doc["stripe_rows"])
            self._layout = layout
        return layout
