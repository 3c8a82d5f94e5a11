"""The store as a network service: HTTP wire protocol + client backend.

The reference's only data plane is a MongoDB replica set every service
container points at via ``DATABASE_URL`` (reference:
docker-compose.yml:27-91 replica set, :188-192 per-service env). This
module is that role for the TPU framework: a store server process
exposing the full :class:`DocumentStore` interface over HTTP, and
:class:`RemoteStore`, the client backend the seven services use to run
as independent processes/containers against one shared store.

Wire protocol (JSON bodies; both ends are this module, so it is an
internal contract, versioned by the framework):

- ``GET  /collections``                         → ``{"collections": [...]}``
- ``POST /collections/<name>``                  → ``{"created": bool}`` (atomic claim)
- ``DELETE /collections/<name>``                → ``{}``
- ``POST /c/<name>/insert_one``     ``{"document": {...}}``
- ``POST /c/<name>/insert_many``    ``{"documents": [...]}``
- ``POST /c/<name>/insert_columns`` ``{"columns": {...}, "start_id": n|null}``
- ``POST /c/<name>/update_one``     ``{"query": {...}, "new_values": {...}}``
- ``POST /c/<name>/set_field_values`` ``{"field": f, "values": [[id, v], ...]}``
  (id/value pairs, not an object — JSON objects would stringify int ids)
- ``POST /c/<name>/set_column``     ``{"field": f, "values": [...], "start_id": n}``
- ``POST /c/<name>/find``           ``{"query", "skip", "limit"}`` → ``{"documents"}``
- ``POST /c/<name>/read_columns``   ``{"fields": [...]|null}`` → ``{"columns"}``
- ``POST /c/<name>/aggregate``      ``{"pipeline": [...]}`` → ``{"results"}``
- ``GET  /c/<name>/count``                      → ``{"count": n}``
- ``GET  /health``                              → ``{"ok": true, "writable": bool}``
- ``GET  /wal?epoch&offset&limit``              → WAL feed for followers
- ``POST /promote``                             → follower becomes writable

Binary columnar verbs (typed buffers, ``core/wire.py`` framing — the
data plane large datasets actually ride; the JSON forms above remain
for small bodies and debuggability):

- ``POST /c/<name>/read_columns_bin``  JSON ``{"fields","start","limit"}``
  → ``application/x-lo-columns`` frame; the frame's ``extra`` carries
  ``rev`` (collection mutation counter) so paged readers can detect a
  write landing between chunks and retry instead of returning a torn
  result.
- ``POST /c/<name>/insert_columns_bin``  frame with ``extra.start_id``
- ``POST /c/<name>/set_column_bin``      frame with ``extra.field`` /
  ``extra.start_id``

Error mapping: ``KeyError`` (duplicate ids/collections) → 409;
``UnsupportedQueryError`` → 400 with ``kind: unsupported_query``; other
``ValueError`` → 400; mutation on a follower → 503. :class:`RemoteStore`
re-raises the same exception types, so service code behaves identically
on a local or remote store.

Durability/replication posture: the server runs one WAL-backed
:class:`InMemoryStore`; the WAL is the durability story and the primary
is the single writer. HA mirrors the reference's Mongo replica set
(docker-compose.yml:27-91) with WAL shipping: a primary started with
``LO_REPLICATE=1`` feeds ``GET /wal``; followers started with
``LO_PRIMARY_URL`` tail it (:class:`ReplicationClient`, the oplog-tailing
secondary role), serve reads, reject writes with 503, and take over on
``POST /promote``.

Failover is automatic when configured (the replica-set election the
reference gets from its Mongo arbiter, docker-compose.yml:49-91):

- ``LO_AUTO_PROMOTE_S=<seconds>`` — a follower whose primary has been
  unreachable for that long promotes ITSELF (no operator ``POST
  /promote`` needed). Two-node semantics, stated honestly: with exactly
  one follower there is no quorum to consult, so a network partition
  between the pair can open a write-accepting server on each side; the
  term fence below heals it in favor of the newest promotion when they
  reconnect.
- ``LO_ARBITERS=<url,...>`` — QUORUM mode (docs/replication.md): the
  vote-only arbiter (core/arbiter.py — the reference's
  ``mongodbarbiter``) joins the voting population, and failover becomes
  *prevented* rather than healed: a follower auto-promotes only after
  winning a majority of votes for an explicit term, and a primary that
  cannot reach a majority of voters SUSPENDS writes (503 +
  ``Retry-After``; reads keep serving) until quorum returns — the
  minority side of a partition degrades gracefully instead of opening
  a second primary.
- ``LO_STORE_SYNC_REPL=1`` — acknowledge mutations only once a
  follower's WAL cursor has passed them (bounded by
  ``LO_STORE_ACK_TIMEOUT_S``): the majority-write-concern analogue
  that makes "zero lost acknowledged writes" hold across a primary
  kill. Off by default; without it the loss window of a takeover is
  *measured and reported* (promotion response, ``/health``,
  ``lo_store_loss_window``) rather than zero.
- Promotions bump a **term** (primary starts at 1; each takeover is
  ``max(seen primary term, own) + 1``), reported by ``/health``.
- ``LO_PEERS=<url,url>`` — fencing: at startup AND every few seconds, a
  writable server probes its peers; seeing a writable peer with a
  HIGHER term means it was superseded while dead/partitioned, and it
  demotes itself to a follower of that peer (full resync replaces any
  diverged local writes). A revived old primary therefore rejoins as a
  follower instead of silently accepting writes.
- :class:`RemoteStore` accepts a comma-separated URL list
  (``LO_STORE_URL=http://a,http://b``) and re-points itself at whichever
  server is writable when a write fails — client writes resume after a
  failover without reconfiguration.

The port's copy of ``learningorchestra_tpu/core/store_service.py``. Its
server is the port's stdlib web layer (``utils/web.py``: ``/wal``'s
long-poll parks its connection on the event loop as a ``Waiter``,
re-polled every 50 ms), and its client rides ``utils/httpclient.py``
(``http.client``, one persistent connection a host and thread) where
the reference rides ``requests``. The client cuts a binary upload into
frames of at most ``_UPLOAD_FRAME_BYTES`` of columns (the reference's
strides are rows alone), so that no request passes the event loop's
64 MB cap.
Its frames are the reference's byte for byte (``core/wire.py``), so
each package's client reads the other's server. The client feeds the
flight recorder (``telemetry/profile.py``): payload bytes written and
read over the wire, frames read through the shared-memory ring and the
seconds decoding them; the server answers the observability routes
(``register_observability``), whose SLO verdict ``/health``'s
``degraded`` reads. Shard groups (a ``;``-separated ``LO_STORE_URL``)
make :func:`connect` build a ``ShardedStore`` (``core/shardstore.py``).

Run a server: ``python -m learningorchestra_tpu_torch.core.store_service``
(``LO_HOST``, ``LO_STORE_PORT``, ``LO_DATA_DIR``, ``LO_REPLICATE``,
``LO_PRIMARY_URL``, ``LO_PEERS``, ``LO_ARBITERS``, ``LO_AUTO_PROMOTE_S``,
``LO_STORE_SYNC_REPL``, ``LO_NODE_ID``; ``LO_SHM_BYTES`` for the ring).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterator, Optional

import numpy as np

from learningorchestra_tpu_torch.core.arbiter import grant_vote
from learningorchestra_tpu_torch.core.columns import Column
from learningorchestra_tpu_torch.core.store import (
    ROW_ID,
    DocumentStore,
    InMemoryStore,
    UnsupportedQueryError,
)
from learningorchestra_tpu_torch.telemetry import profile as _profile
from learningorchestra_tpu_torch.telemetry import tracing as _tracing
from learningorchestra_tpu_torch.testing import faults
from learningorchestra_tpu_torch.core import shmring
from learningorchestra_tpu_torch.core.wire import (
    ACCEPT_HEADER,
    COMPRESS_MIN_BYTES,
    CONTENT_TYPE as BIN_CONTENT_TYPE,
    ENCODING_HEADER,
    WIRE_COMPRESSION,
    WIRE_V2,
    accept_tokens,
    compress_frame,
    decode_body,
    decode_frame,
    encode_frame,
)
from learningorchestra_tpu_torch.utils import httpclient
from learningorchestra_tpu_torch.utils.web import (
    Response,
    ServerThread,
    Waiter,
    WebApp,
)

DEFAULT_STORE_PORT = 27027
# the most bytes of columns one binary upload frame carries: a quarter of
# the event loop's request cap (utils/webloop._MAX_BUFFERED_BYTES, 64 MB),
# past which the server drops the request (a row's bytes are estimated)
_UPLOAD_FRAME_BYTES = 16 << 20


# Deployment-knob readers (sched/config.py pattern): every LO_* env
# read in this module funnels through these so the knob surface stays
# greppable and the contract analyzer (LO305) can verify the
# read-once discipline. The deploy/run.sh preflight validates the
# numeric domains before any service boots; an unset/empty value
# means "use the default" at every call site below.


def _str_env(name: str, default: str | None = None) -> str | None:
    return os.environ.get(name, default)


def _int_env(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError as error:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from error


def _float_env(name: str, default: float | None) -> float | None:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError as error:
        raise ValueError(f"{name} must be a number, got {raw!r}") from error


def _flag_env(name: str, default: bool = False) -> bool:
    """Strict 0/1 flags (the domain deploy/run.sh's preflight
    enforces): unset/empty -> ``default``, else ``raw == "1"``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    return raw == "1"


class StoreUnavailableError(PermissionError):
    """The store rejected or cannot currently accept a write — a
    read-only follower's 503, a quorum-suspended primary's 503 +
    Retry-After, or no writable server within the failover window.
    Subclasses :class:`PermissionError` for existing handlers;
    classified TRANSIENT by the scheduler's retry policy
    (sched/policy.py) so jobs ride out a failover window with backoff
    instead of failing terminally."""


def _values_match(stored, sent) -> bool:
    """Loose equality for landed-write verification: JSON round-trips
    preserve Python scalar equality, but NaN != NaN needs handling."""
    if stored == sent:
        return True
    try:
        import math

        return math.isnan(stored) and math.isnan(sent)
    except TypeError:
        return False


def create_store_app(
    store: DocumentStore,
    role: Optional[dict] = None,
    shm: Optional[bool] = None,
) -> WebApp:
    """``role`` (mutable, shared with the caller) carries the HA state:
    ``{"writable": bool, "poller": ReplicationClient | None}``. A
    follower serves every read with ``writable: False`` and answers
    mutations with 503 until ``POST /promote`` flips it — the failover
    the reference delegates to Mongo's replica-set election
    (docker-compose.yml:27-91). ``shm`` overrides the env-derived
    shared-memory-transport enablement (tests, bench)."""
    app = WebApp("store")
    # Shared-memory ring transport (core/shmring.py): enabled when this
    # server's LO_SHM_BYTES > 0 — the runner/stack exports one value to
    # the whole co-located process tree, so client and server agree.
    # Read at app creation (not import) so tests can toggle the env.
    shm_enabled = shmring.shm_bytes() > 0 if shm is None else bool(shm)
    rings = shmring.ServerRings()
    # the store SERVER scrapes its own occupancy (collections, WAL
    # bytes, spill bytes) at GET /metrics; remote-store CLIENTS don't
    from learningorchestra_tpu_torch.telemetry import register_store

    role = role if role is not None else {"writable": True, "poller": None}
    role.setdefault("term", 1 if role.get("writable", True) else 0)
    # serializes promote/demote transitions (HTTP promote vs the
    # auto-promote monitor vs the fencing probe)
    role.setdefault("lock", threading.Lock())
    # quorum-mode degradation: a primary that lost its voter majority
    # suspends writes (503 + Retry-After) while reads keep serving
    role.setdefault("suspended", False)
    # one-vote-per-term election ledger (grant_vote; docs/replication.md)
    role.setdefault("voted_term", 0)
    role.setdefault("voted_for", None)
    # sync-replication ack ledger: highest (epoch, offset) any follower
    # has requested the WAL from — a follower requests from its APPLIED
    # position, so this is what a replica durably holds
    role.setdefault("shipped", (-1, -1))
    role.setdefault("repl_cv", threading.Condition())
    role.setdefault("unreplicated_acks", 0)
    register_store(store, role=role)

    def guarded(handler):
        def wrapped(request, **kwargs):
            try:
                return handler(request, **kwargs)
            except KeyError as error:
                return {"error": str(error)}, 409
            except UnsupportedQueryError as error:
                return {"error": str(error), "kind": "unsupported_query"}, 400
            except ValueError as error:
                return {"error": str(error)}, 400

        wrapped.__name__ = handler.__name__
        return wrapped

    def mutating(handler):
        def wrapped(request, **kwargs):
            if not role.get("writable", True):
                return {"error": "read-only follower; POST /promote"}, 503
            if role.get("suspended"):
                # quorum lost: this (possibly minority-side) primary
                # refuses writes instead of risking a second primary;
                # Retry-After tells well-behaved clients (and the
                # scheduler's transient-retry policy) to come back
                response = Response(
                    json.dumps(
                        {
                            "error": (
                                "writes suspended: quorum lost "
                                "(reads keep serving)"
                            ),
                            "kind": "writes_suspended",
                        }
                    ),
                    content_type="application/json",
                    status=503,
                )
                response.headers["Retry-After"] = "1"
                return response
            faults.fire("store.wire.mutate", route=handler.__name__)
            result = handler(request, **kwargs)
            faults.fire("store.wire.mutate.applied", route=handler.__name__)
            if (
                role.get("sync_repl")
                and getattr(store, "replicating", False)
                and isinstance(result, tuple)
                and result[1] == 200
                and isinstance(result[0], dict)
            ):
                if not _await_replicated(role, store):
                    # the wait timed out (follower down/lagging): the
                    # write IS applied and logged locally — flag the ack
                    # so callers and operators can see the degraded
                    # durability instead of silently assuming majority
                    with role["lock"]:
                        role["unreplicated_acks"] += 1
                    result = ({**result[0], "replicated": False}, 200)
            return result

        wrapped.__name__ = handler.__name__
        return wrapped

    @app.route("/health", methods=("GET",))
    def health(request):
        payload = {
            "ok": True,
            "writable": role.get("writable", True),
            "suspended": role.get("suspended", False),
            "term": role.get("term", 0),
            # election evidence for the supersession check: a voter
            # that granted a higher term exposes it here (the arbiter
            # does the same) so a quorum-holding primary partitioned
            # from the WINNER still hears about the election through
            # any voter it can reach — store voters included, not just
            # arbiters
            "voted_term": role.get("voted_term", 0),
            "boot": role.get("boot", ""),  # equal-term fence tiebreak
            # wire capability advertisement: bin2 = this server decodes
            # AND (when asked via X-Lo-Columns-Accept: v2) emits the
            # aligned zero-copy frame layout; clients probe it once to
            # decide their upload encoding (reads negotiate per request)
            "columns_wire": "bin2",
            "shm": shm_enabled,
        }
        stats = getattr(store, "telemetry_stats", None)
        if stats is not None:
            # occupancy surface for the sharded fleet: the client-side
            # shard gauges (telemetry/metrics.py register_sharded_store)
            # read each group's collection/WAL/spill occupancy here
            try:
                payload["occupancy"] = stats()
            except Exception:  # noqa: BLE001 — health must still answer
                pass
        poller = role.get("poller")
        if poller is not None:
            payload["replication"] = {
                "lag": poller.lag,
                "caught_up": poller.caught_up,
                "last_error": poller.last_error,
            }
        if role.get("loss_window") is not None:
            # what this server's last takeover cost (docs/replication.md
            # loss-window semantics); also exported as
            # lo_store_loss_window on /metrics
            payload["loss_window"] = role["loss_window"]
        # the SLO verdict over the in-store TSDB (telemetry/slo.py)
        payload["degraded"] = app.slo_degraded()
        return payload, 200

    @app.route("/vote", methods=("POST",))
    def vote(request):
        """One quorum-election vote (core/arbiter.py semantics): every
        store server is also a voter. A live, unsuspended primary
        vetoes — an election is only legitimate once the primary is
        actually unreachable or degraded."""
        body = request.get_json()
        try:
            term = int(body["term"])
            candidate = str(body["candidate"])
        except (KeyError, TypeError, ValueError):
            return {"error": "vote needs integer term + candidate"}, 400
        with role["lock"]:
            if role.get("writable") and not role.get("suspended"):
                return {
                    "granted": False,
                    "term": role.get("term", 0),
                    "writable": True,
                }, 200
            return grant_vote(role, term, candidate), 200

    @app.route("/wal", methods=("GET",))
    def wal(request):
        try:
            epoch = int(request.args.get("epoch", -1))
            offset = int(request.args.get("offset", 0))
            limit = int(request.args.get("limit", 10000))
            wait_s = float(request.args.get("wait", 0))
        except ValueError:
            return {"error": "epoch/offset/limit/wait must be numbers"}, 400
        faults.fire("store.wal.feed")
        try:
            feed = store.wal_feed(epoch, offset, limit=limit)
        except (AttributeError, ValueError):
            return {"error": "replication not enabled (LO_REPLICATE=1)"}, 404

        def ship_ack(resync: bool) -> None:
            # Sync-repl ack ledger: a follower requests from its APPLIED
            # position, so this request's (epoch, offset) is what a
            # replica durably holds — wake writers in _await_replicated.
            cv = role.get("repl_cv")
            if cv is not None and not resync:
                with cv:
                    if (epoch, offset) > tuple(role.get("shipped", (-1, -1))):
                        role["shipped"] = (epoch, offset)
                        cv.notify_all()

        if wait_s > 0 and not feed["records"] and not feed["resync"]:
            # LONG-POLL on a Waiter (utils/web.py): a caught-up follower
            # parks here until a record lands or the wait expires — this
            # is what keeps sync-repl ack latency at ~tens of
            # milliseconds rather than one poll period per acknowledged
            # mutation. The event loop parks the connection (the threaded
            # server, its request thread). The ack ledger updates before parking:
            # it reflects the request's applied position, not the
            # response. Old followers that send no `wait` keep the
            # plain immediate-answer behavior.
            ship_ack(False)

            def wal_ready():
                current_epoch, current_length = store.wal_position
                if current_epoch != epoch or current_length > offset:
                    fresh = store.wal_feed(epoch, offset, limit=limit)
                    fresh["term"] = role.get("term", 0)
                    return fresh, 200
                return None

            def wal_timeout():
                stale = dict(feed)
                stale["term"] = role.get("term", 0)
                return stale, 200

            return Waiter(
                wal_ready,
                min(wait_s, 30.0),
                wal_timeout,
                interval_s=0.05,  # the WAL has no push hook; re-poll
            )
        feed["term"] = role.get("term", 0)  # followers track it for takeover
        ship_ack(bool(feed["resync"]))
        return feed, 200

    @app.route("/compact", methods=("POST",))
    def compact(request):
        if not hasattr(store, "compact"):
            return {"error": "store does not support compaction"}, 404
        # compacted: false = skipped (another compaction in flight) or
        # superseded by a replication resync — the caller must NOT
        # assume the on-disk log is a fresh snapshot
        compacted = bool(store.compact())
        return {"compacted": compacted}, 200

    @app.route("/promote", methods=("POST",))
    def promote(request):
        """Flip this follower writable (also invoked internally by the
        auto-promote monitor). The response reports the last WAL
        position applied from the old primary and whether the follower
        had drained the feed, so the operator can see the acknowledged
        replication lag (records the dead primary accepted but never
        shipped are LOST — durability follows the new primary from
        here). The term bump is what fences a revived old primary: it
        comes back with a lower term, sees this server's higher one via
        LO_PEERS, and rejoins as a follower."""
        return promote_role(role), 200

    @app.route("/collections", methods=("GET",))
    def list_collections(request):
        return {"collections": store.list_collections()}, 200

    @app.route("/collections/<name>", methods=("POST",))
    @mutating
    def create_collection(request, name):
        return {"created": store.create_collection(name)}, 200

    @app.route("/collections/<name>", methods=("DELETE",))
    @mutating
    def drop(request, name):
        store.drop(name)
        return {}, 200

    @app.route("/c/<name>/insert_one", methods=("POST",))
    @guarded
    @mutating
    def insert_one(request, name):
        store.insert_one(name, request.get_json()["document"])
        return {}, 200

    @app.route("/c/<name>/insert_many", methods=("POST",))
    @guarded
    @mutating
    def insert_many(request, name):
        store.insert_many(name, request.get_json()["documents"])
        return {}, 200

    @app.route("/c/<name>/insert_columns", methods=("POST",))
    @guarded
    @mutating
    def insert_columns(request, name):
        body = request.get_json()
        store.insert_columns(name, body["columns"], start_id=body.get("start_id"))
        return {}, 200

    @app.route("/c/<name>/update_one", methods=("POST",))
    @guarded
    @mutating
    def update_one(request, name):
        body = request.get_json()
        store.update_one(name, body["query"], body["new_values"])
        return {}, 200

    @app.route("/c/<name>/set_field_values", methods=("POST",))
    @guarded
    @mutating
    def set_field_values(request, name):
        body = request.get_json()
        store.set_field_values(name, body["field"], dict(body["values"]))
        return {}, 200

    @app.route("/c/<name>/set_column", methods=("POST",))
    @guarded
    @mutating
    def set_column(request, name):
        body = request.get_json()
        store.set_column(
            name, body["field"], body["values"], start_id=body.get("start_id", 1)
        )
        return {}, 200

    @app.route("/c/<name>/find", methods=("POST",))
    @guarded
    def find(request, name):
        body = request.get_json()
        documents = list(
            store.find(
                name,
                body.get("query") or {},
                skip=body.get("skip", 0),
                limit=body.get("limit"),
            )
        )
        return {"documents": documents}, 200

    @app.route("/c/<name>/read_columns", methods=("POST",))
    @guarded
    def read_columns(request, name):
        body = request.get_json()
        columns = store.read_columns(
            name,
            body.get("fields"),
            start=body.get("start", 0),
            limit=body.get("limit"),
        )
        return {"columns": columns}, 200

    def frame_body(request) -> bytes:
        """The request's frame bytes, wire compression undone (a client
        stamps ENCODING_HEADER on compressed uploads)."""
        return decode_body(
            request.get_data(), request.headers.get(ENCODING_HEADER)
        )

    @app.route("/c/<name>/rev", methods=("GET",))
    def collection_rev(request, name):
        """The collection's mutation counter — what remote device caches
        probe to validate an entry (core/devcache.py). Same counter the
        binary read frames carry per chunk. Every DocumentStore has the
        method (the base class answers -1 = unknown). ``block_rows``
        rides along (same base-class contract) so the sharded client
        (core/shardstore.py) places appends and splits positional reads
        with the one probe it already makes."""
        return {
            "rev": store.collection_rev(name),
            "block_rows": store.collection_block_rows(name),
        }, 200

    @app.route("/c/<name>/read_columns_bin", methods=("POST",))
    @guarded
    def read_columns_bin(request, name):
        body = request.get_json()
        if hasattr(store, "read_column_arrays_rev"):
            # rev captured under the same lock as the read — equal revs
            # across chunks prove no write interleaved
            columns, rev = store.read_column_arrays_rev(
                name,
                body.get("fields"),
                start=body.get("start", 0),
                limit=body.get("limit"),
            )
        else:
            columns = store.read_column_arrays(
                name,
                body.get("fields"),
                start=body.get("start", 0),
                limit=body.get("limit"),
            )
            rev = -1
        accepts = accept_tokens(request.headers.get(ACCEPT_HEADER))
        # frame-version negotiation: emit the aligned zero-copy layout
        # only to a client that advertised it — old clients keep
        # receiving v1 frames, and decode_frame dispatches on the magic
        # either way
        version = 2 if WIRE_V2 in accepts else 1
        frame = encode_frame(columns, extra={"rev": rev}, version=version)
        if faults.torn("store.wire.read_chunk"):
            frame = frame[: max(1, len(frame) // 2)]  # truncated mid-buffer
        segment = request.headers.get(shmring.SEGMENT_HEADER)
        if shm_enabled and segment:
            # co-located fast path: the frame goes into the client's
            # shared-memory ring and the response carries only the slot
            # coordinates — no HTTP body, no compression. An attach
            # failure (not co-located, segment gone) or an oversized
            # frame falls through to the body transparently.
            try:
                seg_bytes = int(request.headers.get(shmring.BYTES_HEADER, 0))
            except ValueError:
                seg_bytes = 0
            placed = rings.place(segment, seg_bytes, frame)
            if placed is not None:
                offset, length, generation = placed
                return Response(
                    b"{}",
                    content_type="application/json",
                    status=200,
                    headers={
                        shmring.OFFSET_HEADER: str(offset),
                        shmring.LENGTH_HEADER: str(length),
                        shmring.GENERATION_HEADER: str(generation),
                    },
                )
        headers = {}
        if WIRE_COMPRESSION in accepts and len(frame) >= COMPRESS_MIN_BYTES:
            frame = compress_frame(frame)
            headers[ENCODING_HEADER] = WIRE_COMPRESSION
        return Response(
            frame, content_type=BIN_CONTENT_TYPE, status=200, headers=headers
        )

    @app.route("/c/<name>/insert_columns_bin", methods=("POST",))
    @guarded
    @mutating
    def insert_columns_bin(request, name):
        columns, extra = decode_frame(frame_body(request))
        store.insert_column_arrays(
            name, columns, start_id=extra.get("start_id")
        )
        return {}, 200

    @app.route("/c/<name>/set_column_bin", methods=("POST",))
    @guarded
    @mutating
    def set_column_bin(request, name):
        columns, extra = decode_frame(frame_body(request))
        field = extra["field"]
        store.set_column(
            name, field, columns[field], start_id=extra.get("start_id", 1)
        )
        return {}, 200

    @app.route("/c/<name>/aggregate", methods=("POST",))
    @guarded
    def aggregate(request, name):
        try:
            results = store.aggregate(name, request.get_json()["pipeline"])
        except NotImplementedError as error:
            return {"error": str(error)}, 400
        return {"results": results}, 200

    @app.route("/c/<name>/count", methods=("GET",))
    def count(request, name):
        return {"count": store.count(name)}, 200

    @app.route("/c/<name>/trim", methods=("POST",))
    @guarded
    @mutating
    def trim_collection(request, name):
        removed = store.trim_collection(
            name, request.get_json()["max_docs"]
        )
        return {"removed": removed}, 200

    # the observability plane: /metrics/history, /metrics/ingest,
    # /debug/slo (a central collector posts scraped samples here)
    app.register_observability(store)
    return app


def _await_replicated(role: dict, store) -> bool:
    """Block until a follower's WAL cursor has passed everything in the
    log right now, or the ack timeout expires (sync-replication mode,
    ``LO_STORE_SYNC_REPL=1``). Epoch-aware: a compaction mid-wait bumps
    the epoch, and the snapshot carries the write — a follower draining
    the NEW epoch's log satisfies the wait."""
    import time

    target_epoch, target_offset = store.wal_position
    cv = role["repl_cv"]
    deadline = time.monotonic() + float(role.get("ack_timeout_s", 2.0))
    with cv:
        while True:
            shipped_epoch, shipped_offset = role.get("shipped", (-1, -1))
            if shipped_epoch == target_epoch and shipped_offset >= target_offset:
                return True
            if shipped_epoch > target_epoch:
                # compaction moved the feed mid-wait: the snapshot
                # carries the write, so a follower draining the NEW
                # epoch's log covers it
                current_epoch, current_length = store.wal_position
                if (
                    shipped_epoch >= current_epoch
                    and shipped_offset >= current_length
                ):
                    return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            cv.wait(remaining)


def promote_role(role: dict, term: Optional[int] = None) -> dict:
    """Promote the server owning ``role`` to writable primary: stop the
    WAL poller, bump the term past every term this follower has seen
    (or to the explicit quorum-granted ``term`` when the election voted
    one), and record the measured loss window — last-replicated vs the
    primary's last-acknowledged WAL position. Idempotent; shared by
    ``POST /promote`` and the auto-promote monitor."""
    faults.fire("store.promote")
    with role["lock"]:
        poller = role.get("poller")
        applied = None
        caught_up = None
        loss = None
        if poller is not None:
            # halt, not stop (LO202): the fence — no further records
            # can apply — is what promotion needs under the lock; the
            # thread JOIN waits on a poller that may be parked in a
            # 60 s long-poll, and holding role["lock"] through that
            # would block every /vote (elections) and sync-repl ack
            # accounting for the duration. The join runs below, after
            # the lock is released.
            poller.halt()
            applied = {"epoch": poller.epoch, "offset": poller.offset}
            caught_up = poller.caught_up
            # what this takeover COST: acknowledged-but-unshipped records
            # as of the last successful poll (writes the dead primary
            # accepted after that are unknowable from here — stated in
            # docs/replication.md)
            loss = poller.loss_window()
            # floor of 1: a follower that never completed a poll (primary
            # already dead at its start) must still promote PAST the
            # primary's term 1, or the strictly-greater fence would never
            # demote a partitioned-but-alive old primary
            role["term"] = max(
                max(role.get("term", 0), poller.primary_term, 1) + 1,
                term or 0,
            )
            role["poller"] = None
        elif not role.get("writable", True):
            role["term"] = max(
                max(role.get("term", 0), 1) + 1, term or 0
            )
        role["writable"] = True
        role["suspended"] = False
        if loss is not None:
            role["loss_window"] = loss
        payload = {
            "promoted": True,
            "term": role["term"],
            "applied_through": applied,
            # False = the last poll before the primary vanished still had
            # records in flight: acknowledged-but-unshipped writes are lost
            "caught_up": caught_up,
            "loss_window": loss,
        }
    if poller is not None:
        # thread hygiene outside the lock: halt() above already fenced
        # applies, this just reaps the poller thread (stop re-halts,
        # which is idempotent)
        poller.stop()
    return payload


class RemoteStore(DocumentStore):
    """A :class:`DocumentStore` over the store server's wire protocol.

    Drop-in for :class:`InMemoryStore` in every service — this is what
    turns the single-process runner into the reference's seven
    independent containers sharing one database (reference:
    docker-compose.yml:173-330)."""

    def __init__(
        self,
        base_url: str,
        timeout: float = 600.0,
        wire_rows: Optional[int] = None,
        failover_timeout: Optional[float] = None,
        compress: Optional[bool] = None,
        wire_v2: Optional[bool] = None,
        shm_bytes: Optional[int] = None,
    ):
        # A comma-separated ``base_url`` names the replica pair; the
        # client talks to one server at a time and re-points itself at
        # whichever peer answers /health writable when that server dies
        # or answers 503 (follower) — how service writes resume after an
        # auto-promotion without any reconfiguration.
        self.urls = [u.rstrip("/") for u in base_url.split(",") if u.strip()]
        self.base_url = self.urls[0]
        self.failover_timeout = (
            failover_timeout
            if failover_timeout is not None
            else _float_env("LO_FAILOVER_TIMEOUT_S", 30.0)
        )
        self.timeout = timeout
        # Rows per read_columns wire chunk (LO_WIRE_ROWS): bounds every
        # JSON body the data plane ships, mirroring the write batching
        # in core/table.py insert_columns_batched.
        self.wire_rows = max(
            1, wire_rows or _int_env("LO_WIRE_ROWS", 100000)
        )
        # Rows per binary-frame chunk: typed buffers are ~10× denser
        # than JSON, so the binary plane pages in much larger strides.
        self.wire_rows_bin = max(
            1, _int_env("LO_WIRE_ROWS_BIN", 2000000)
        )
        # LO_STORE_COMPRESS=1: zlib the binary frames both ways (the
        # client advertises on reads, stamps its uploads) — worth it on
        # narrow links (tunneled chips, cross-zone stores), off by
        # default where the store is co-located and CPU is the scarcer
        # resource.
        self.compress = (
            _flag_env("LO_STORE_COMPRESS")
            if compress is None
            else compress
        )
        # Retries for ONE failed chunk of a paged binary read before the
        # whole read surfaces the error (the stream resumes at the
        # failed chunk, never from chunk 0).
        self.chunk_retries = max(
            0, _int_env("LO_CHUNK_RETRIES", 2)
        )
        # LO_WIRE_V2=0 is the escape hatch back to v1 frames (the
        # default advertises v2 on reads and, once /health confirms a
        # bin2 server, uploads v2 too — old servers just keep talking
        # v1, negotiated per request through X-Lo-Columns-Accept).
        self.wire_v2 = (
            _flag_env("LO_WIRE_V2", default=True)
            if wire_v2 is None
            else wire_v2
        )
        # upload frame version, decided lazily by one /health probe
        # (None = not probed yet); reads negotiate per request instead
        self._upload_version_cache: Optional[int] = None
        # Shared-memory ring (core/shmring.py): LO_SHM_BYTES > 0 makes
        # this client create a segment and advertise it on binary
        # reads; a server that can attach it answers with ring slots
        # instead of HTTP bodies. Lazy — the segment exists only once a
        # binary read happens; creation failure disables the ring for
        # this client (body transport is always correct).
        self.shm_bytes = (
            shmring.shm_bytes() if shm_bytes is None else int(shm_bytes)
        )
        self._shm_ring = None
        self._shm_failed = False
        self._shm_lock = threading.Lock()
        self._local = threading.local()
        # collection → monotonic time of the last AMBIGUOUS write
        # failure (connection death / timeout / 5xx mid-request) this
        # client saw against it. A later duplicate-id 409 on an
        # explicit-id write to a marked collection is verified by
        # reading the rows back: a higher-level retry (the scheduler
        # re-running an ingest op after a failover window) replays
        # writes that DID land, and used to abort a fully durable
        # ingest with a KeyError.
        self._ambiguous_marks: dict[str, float] = {}
        self.landed_ok_window_s = _float_env("LO_LANDED_OK_WINDOW_S", 600.0)
        # Lazily-built read-ahead pool: chunk N+1's network fetch
        # overlaps chunk N's decode (+ inflate). Per-STORE and
        # persistent so the helper threads' sessions survive
        # across reads (connection reuse — a per-read thread would pay
        # a TCP handshake per read-ahead); width 4 so several
        # concurrent paged readers overlap instead of serializing
        # through one thread (each read keeps at most one prefetch in
        # flight).
        self._prefetch_pool = None
        self._prefetch_lock = threading.Lock()

    @property
    def _prefetch(self):
        # always read under the lock (LO203): the double-checked bare
        # fast path saved one uncontended acquire per paged read —
        # nanoseconds against a wire chunk — at the price of publishing
        # the pool through a race
        with self._prefetch_lock:
            if self._prefetch_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._prefetch_pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="lo-read-ahead"
                )
            return self._prefetch_pool

    # one session per thread: a Session keeps one persistent connection
    # a host and serves one thread at a time
    @property
    def _session(self) -> httpclient.Session:
        session = getattr(self._local, "session", None)
        if session is None:
            session = httpclient.Session()
            self._local.session = session
        return session

    def _raise_for(self, response) -> None:
        if response.status_code == 409:
            raise KeyError(response.json().get("error", "duplicate"))
        if response.status_code == 400:
            payload = response.json()
            if payload.get("kind") == "unsupported_query":
                raise UnsupportedQueryError(payload.get("error", "bad query"))
            raise ValueError(payload.get("error", "bad request"))
        if response.status_code == 503:
            raise StoreUnavailableError(
                response.json().get("error", "read-only follower")
            )
        response.raise_for_status()

    def _mark_ambiguous(self, collection: Optional[str]) -> None:
        """Remember that a write against ``collection`` failed
        ambiguously — it may have landed. A later 409 on an explicit-id
        write to the collection (within ``LO_LANDED_OK_WINDOW_S``) is
        then verified by read instead of raised as a duplicate."""
        if collection:
            import time

            self._ambiguous_marks[collection] = time.monotonic()

    def _recently_ambiguous(self, collection: Optional[str]) -> bool:
        if not collection:
            return False
        import time

        marked = self._ambiguous_marks.get(collection)
        return (
            marked is not None
            and time.monotonic() - marked <= self.landed_ok_window_s
        )

    @staticmethod
    def _as_http_error(response) -> Exception:
        try:
            response.raise_for_status()
        except httpclient.HTTPError as error:
            return error
        return httpclient.HTTPError(
            f"unexpected status {response.status_code}", response=response
        )

    def _finish(
        self, response, ambiguous, landed_ok, collection, verify
    ):
        if response.status_code == 409 and landed_ok:
            if ambiguous:
                # the ids we just re-sent are already present: the
                # pre-failover attempt landed — success
                return response
            if (
                self._recently_ambiguous(collection)
                and verify is not None
                and verify()
            ):
                # a higher-level retry (scheduler re-running the op
                # after an earlier ambiguous failure) replayed a write
                # that DID land: the stored rows match what we just
                # sent byte for byte, so this is idempotent success,
                # not a duplicate
                return response
        self._raise_for(response)
        return response

    def _send(
        self,
        send,
        retry: bool = True,
        landed_ok: bool = False,
        collection: Optional[str] = None,
        verify=None,
    ):
        """Issue ``send(base_url)``, re-pointing at the writable peer on
        connection failure, a follower's/suspended primary's 503, or an
        ambiguous 5xx.

        ``retry=False`` marks non-idempotent calls (inserts whose ids
        the SERVER assigns): replaying one after a mid-write primary
        death could duplicate rows, so those surface the original error
        instead. Everything else is the store's idempotent contract
        surface (inserts at explicit ids, set_column at a start_id,
        reads). The probe loop rides out the auto-promote window
        (LO_FAILOVER_TIMEOUT_S).

        ``landed_ok=True`` marks explicit-id writes, and means: a
        duplicate-id 409 on an attempt that FOLLOWS an ambiguous
        failure (connection death / timeout / 5xx mid-request) is the
        write we just sent having already landed before the old primary
        died — treat it as success instead of raising ``KeyError``, so
        a long chunked ingest survives a failover mid-batch. A 409 on a
        clean first attempt is a genuine duplicate and still raises —
        UNLESS this client recently saw an ambiguous failure on the
        same ``collection`` and ``verify()`` confirms the stored rows
        equal what was just sent (the cross-call replay of a landed
        write, e.g. the scheduler retrying a whole ingest op)."""
        import time

        ambiguous = False  # a send died mid-request: it may have landed
        last_error: Optional[Exception] = None
        # 5xx RESPONSES get a small retry budget, not the whole failover
        # window: a handler that 500s deterministically (a bug, not a
        # dying server) must fail in a few attempts instead of hammering
        # every replica for LO_FAILOVER_TIMEOUT_S. Connection-level
        # failures keep the full window — those mean a server is gone
        # and riding out the takeover is the point.
        server_error_budget = max(2, self.chunk_retries)
        server_errors = 0
        try:
            response = send(self.base_url)
        # Timeout included: a partitioned/hung primary raises ReadTimeout
        # (not a ConnectionError subclass) and must also re-point —
        # explicit-id retries stay safe either way (duplicate-id 409 if
        # the write had landed, swallowed under landed_ok)
        except (httpclient.ConnectionError, httpclient.Timeout) as error:
            if landed_ok:
                self._mark_ambiguous(collection)
            if len(self.urls) == 1 or not retry:
                raise
            ambiguous = True
            last_error = error
        else:
            failed_5xx = (
                response.status_code >= 500 and response.status_code != 503
            )
            if failed_5xx and landed_ok:
                # a 5xx mid-request is as ambiguous as a dropped
                # connection: the handler may have applied before dying.
                # Marked on EVERY such response — single-URL clients
                # included — so a scheduler-level replay of the op can
                # verify its clean-attempt 409 instead of aborting a
                # durable ingest (the connection-death path above marks
                # before raising for the same reason).
                self._mark_ambiguous(collection)
            if response.status_code == 503 and len(self.urls) > 1:
                # a 503 is a CLEAN rejection (nothing was applied), so
                # even non-retryable auto-id inserts may safely re-point
                # and retry — the retry flag only guards AMBIGUOUS
                # failures
                pass
            elif failed_5xx and retry and len(self.urls) > 1:
                ambiguous = True
                server_errors = 1
                last_error = self._as_http_error(response)
            else:
                return self._finish(
                    response, False, landed_ok, collection, verify
                )
        deadline = time.monotonic() + self.failover_timeout
        while True:
            alive = []
            for url in self.urls:
                health = probe_health(url)
                if health:
                    alive.append((not health.get("writable"), url))
            # writable server first; else any live one (serves reads now,
            # answers writes 503 until its auto-promotion fires)
            for _, url in sorted(alive):
                try:
                    response = send(url)
                except (httpclient.ConnectionError, httpclient.Timeout) as error:
                    if landed_ok:
                        self._mark_ambiguous(collection)
                    if not retry:
                        # entered via a clean 503, but THIS attempt died
                        # ambiguously mid-request: a non-idempotent call
                        # must not be replayed again
                        raise
                    ambiguous = True
                    last_error = error
                    continue  # just died too; try the next
                if response.status_code == 503:
                    continue
                if response.status_code >= 500 and retry:
                    if landed_ok:
                        self._mark_ambiguous(collection)
                    ambiguous = True
                    server_errors += 1
                    last_error = self._as_http_error(response)
                    if server_errors > server_error_budget:
                        raise last_error
                    continue
                if url != self.base_url:
                    self.base_url = url
                    # the peer we failed over to may speak a different
                    # frame version (rolling upgrade: a bin2 primary
                    # dying onto a v1-only follower) — re-probe before
                    # the next upload instead of shipping frames the
                    # new server cannot decode
                    self._upload_version_cache = None
                return self._finish(
                    response, ambiguous, landed_ok, collection, verify
                )
            if time.monotonic() > deadline:
                if last_error is not None:
                    raise last_error
                raise StoreUnavailableError(
                    "no writable store server among "
                    + ",".join(self.urls)
                )
            time.sleep(0.3)

    def _post(
        self,
        path: str,
        body: dict,
        retry: bool = True,
        landed_ok: bool = False,
        collection: Optional[str] = None,
        verify=None,
    ) -> dict:
        data = json.dumps(body)
        return self._send(
            lambda base: self._session.post(
                f"{base}{path}",
                data=data,
                headers={"Content-Type": "application/json"},
                timeout=self.timeout,
            ),
            retry=retry,
            landed_ok=landed_ok,
            collection=collection,
            verify=verify,
        ).json()

    def _post_frame(
        self,
        path: str,
        frame: bytes,
        landed_ok: bool = False,
        collection: Optional[str] = None,
        verify=None,
    ) -> dict:
        headers = {"Content-Type": BIN_CONTENT_TYPE}
        if collection is not None:
            # the payload's bytes before compression (what a reader will
            # decode) into lo_wire_bytes_total and the active span
            _profile.account_wire("write", collection, len(frame))
        if self.compress and len(frame) >= COMPRESS_MIN_BYTES:
            frame = compress_frame(frame)
            headers[ENCODING_HEADER] = WIRE_COMPRESSION
        return self._send(
            lambda base: self._session.post(
                f"{base}{path}",
                data=frame,
                headers=headers,
                timeout=self.timeout,
            ),
            landed_ok=landed_ok,
            collection=collection,
            verify=verify,
        ).json()

    def _upload_version(self) -> int:
        """Frame version for uploads: 2 once one lazy ``/health`` probe
        confirms a bin2-capable server, else 1. Reads need no probe
        (they negotiate per request via the Accept header); uploads do,
        because the client speaks first. A failed probe means v1 — the
        version every server understands. Benignly racy: two threads
        probing concurrently cache the same answer."""
        if not self.wire_v2:
            return 1
        version = self._upload_version_cache
        if version is None:
            health = probe_health(self.base_url)
            version = (
                2 if health and health.get("columns_wire") == "bin2" else 1
            )
            self._upload_version_cache = version
        return version

    def _documents_landed(
        self, collection: str, documents: list[dict]
    ) -> bool:
        """True when every sent document is stored with equal content —
        the read-back verification behind the cross-call landed-ok path
        (a genuine duplicate with DIFFERENT content still raises)."""
        try:
            for sent in documents:
                stored = self.find_one(collection, {ROW_ID: sent[ROW_ID]})
                if stored is None:
                    return False
                for key, value in sent.items():
                    if not _values_match(stored.get(key), value):
                        return False
            return True
        except Exception:
            return False  # verification must never mask the original 409

    def _ring(self):
        """The client's shared-memory ring, created on first use; None
        when disabled or unavailable (no /dev/shm, creation failed)."""
        if self.shm_bytes <= 0:
            return None
        with self._shm_lock:
            if self._shm_ring is None and not self._shm_failed:
                try:
                    self._shm_ring = shmring.ClientRing(self.shm_bytes)
                except Exception:  # noqa: BLE001 — body transport works
                    self._shm_failed = True
            return self._shm_ring

    def _accept_value(self) -> str:
        tokens = []
        if self.wire_v2:
            tokens.append("v2")
        if self.compress:
            tokens.append(WIRE_COMPRESSION)
        return ",".join(tokens)

    def close(self) -> None:
        """Release the client's shared-memory segment (also runs at
        garbage collection via the ring's finalizer)."""
        with self._shm_lock:
            if self._shm_ring is not None:
                self._shm_ring.close()
                self._shm_ring = None
                self._shm_failed = True

    def shm_stats(self) -> Optional[dict]:
        """Ring traffic counters, or None before/without a ring."""
        with self._shm_lock:
            ring = self._shm_ring
        return None if ring is None else ring.stats()

    def _fetch_frame_bytes(self, path: str, body: dict, allow_shm: bool = True):
        """POST JSON, receive one frame — as raw bytes (wire compression
        undone) over the HTTP body, or as an aligned numpy buffer copied
        out of the shared-memory ring when the server placed it there.

        Kept separate from the decode so the double-buffered read loop
        can run the network fetch on a helper thread while the main
        thread decodes the previous chunk."""
        data = json.dumps(body)
        headers = {"Content-Type": "application/json"}
        accept = self._accept_value()
        if accept:
            headers[ACCEPT_HEADER] = accept
        ring = self._ring() if allow_shm else None
        if ring is not None:
            headers[shmring.SEGMENT_HEADER] = ring.name
            headers[shmring.BYTES_HEADER] = str(ring.nbytes)
        response = self._send(
            lambda base: self._session.post(
                f"{base}{path}",
                data=data,
                headers=headers,
                timeout=self.timeout,
            )
        )
        slot_offset = response.headers.get(shmring.OFFSET_HEADER)
        if ring is not None and slot_offset is not None:
            try:
                return ring.read(
                    int(slot_offset),
                    int(response.headers.get(shmring.LENGTH_HEADER, -1)),
                    int(response.headers.get(shmring.GENERATION_HEADER, -1)),
                )
            except shmring.ShmTornError:
                # the server lapped the ring while we copied (deep
                # prefetch against a small segment): re-fetch THIS
                # chunk over the plain body — correctness never
                # depends on the ring
                return self._fetch_frame_bytes(path, body, allow_shm=False)
        return decode_body(
            response.content, response.headers.get(ENCODING_HEADER)
        )

    def _post_for_frame(self, path: str, body: dict):
        """POST JSON, receive a binary columnar frame."""
        return decode_frame(self._fetch_frame_bytes(path, body))

    def _get(self, path: str) -> dict:
        return self._send(
            lambda base: self._session.get(
                f"{base}{path}", timeout=self.timeout
            )
        ).json()

    def _delete(self, path: str) -> dict:
        return self._send(
            lambda base: self._session.delete(
                f"{base}{path}", timeout=self.timeout
            )
        ).json()

    # --- DocumentStore implementation -----------------------------------------
    def list_collections(self) -> list[str]:
        return self._get("/collections")["collections"]

    def create_collection(self, collection: str) -> bool:
        return self._post(f"/collections/{collection}", {})["created"]

    def drop(self, collection: str) -> None:
        self._delete(f"/collections/{collection}")

    def insert_one(self, collection: str, document: dict) -> None:
        # retry across failover only with an explicit _id: a replayed
        # auto-id insert would duplicate the row instead of raising the
        # duplicate-id KeyError that makes explicit-id retries safe
        explicit = "_id" in document
        self._post(
            f"/c/{collection}/insert_one",
            {"document": document},
            retry=explicit,
            landed_ok=explicit,
            collection=collection,
            verify=(
                (lambda: self._documents_landed(collection, [document]))
                if explicit
                else None
            ),
        )

    def insert_many(self, collection: str, documents: list[dict]) -> None:
        explicit = all("_id" in document for document in documents)
        self._post(
            f"/c/{collection}/insert_many",
            {"documents": documents},
            retry=explicit,
            landed_ok=explicit,
            collection=collection,
            verify=(
                (lambda: self._documents_landed(collection, documents))
                if explicit
                else None
            ),
        )

    def insert_columns(
        self,
        collection: str,
        columns: dict,
        start_id: Optional[int] = None,
    ) -> None:
        from learningorchestra_tpu_torch.core.store import as_column

        self.insert_column_arrays(
            collection,
            {name: as_column(values) for name, values in columns.items()},
            start_id=start_id,
        )

    def insert_column_arrays(
        self,
        collection: str,
        columns: dict[str, Column],
        start_id: Optional[int] = None,
    ) -> None:
        """Typed columns ride the binary wire, paged in
        ``wire_rows_bin`` strides so one call never builds an unbounded
        frame. Client-side ragged validation keeps the error local."""
        lengths = {len(column) for column in columns.values()}
        if len(lengths) > 1:
            raise ValueError("ragged columns")
        num_rows = lengths.pop() if lengths else 0
        if not columns:
            return
        with _tracing.span("wire:write", collection=collection, rows=num_rows):
            self._insert_column_arrays(collection, columns, num_rows, start_id)

    def _insert_column_arrays(
        self,
        collection: str,
        columns: dict[str, Column],
        num_rows: int,
        start_id: Optional[int],
    ) -> None:
        stride = self._upload_stride(columns.values(), num_rows)
        for offset in range(0, max(num_rows, 1), stride):
            stop = min(offset + stride, num_rows)
            chunk = {
                name: column.slice(offset, stop)
                for name, column in columns.items()
            }
            extra = {
                "start_id": None if start_id is None else start_id + offset
            }
            verify = None
            if start_id is not None and stop > offset:
                chunk_start_id = start_id + offset
                endpoints = [
                    self._chunk_row(chunk, 0, chunk_start_id),
                    self._chunk_row(
                        chunk, stop - offset - 1, start_id + stop - 1
                    ),
                ]
                # block appends are atomic server-side, so matching
                # endpoint rows prove the whole chunk landed
                verify = lambda docs=endpoints: self._documents_landed(  # noqa: E731
                    collection, docs
                )
            self._post_frame(
                f"/c/{collection}/insert_columns_bin",
                encode_frame(chunk, extra=extra, version=self._upload_version()),
                # chunks at an explicit start_id: a duplicate rejection
                # on the post-failover replay means the chunk landed
                landed_ok=start_id is not None,
                collection=collection,
                verify=verify,
            )
            if stop >= num_rows:
                break

    def _upload_stride(self, columns, num_rows: int) -> int:
        """Rows one upload frame carries: ``wire_rows_bin``, fewer where
        the columns' bytes a row would take the frame past
        ``_UPLOAD_FRAME_BYTES``."""
        if num_rows <= 0:
            return self.wire_rows_bin
        row_bytes = max(sum(column.nbytes() for column in columns) / num_rows, 1.0)
        return max(1, min(self.wire_rows_bin, int(_UPLOAD_FRAME_BYTES // row_bytes)))

    @staticmethod
    def _chunk_row(chunk: dict[str, Column], index: int, doc_id) -> dict:
        """Synthesize the document a chunk row will be stored as."""
        from learningorchestra_tpu_torch.core.columns import MISSING

        document = {ROW_ID: doc_id}
        for name, column in chunk.items():
            value = column.get(index)
            if value is not MISSING:
                document[name] = value
        return document

    def update_one(self, collection: str, query: dict, new_values: dict) -> None:
        self._post(
            f"/c/{collection}/update_one",
            {"query": query, "new_values": new_values},
        )

    def trim_collection(self, collection: str, max_docs: int) -> int:
        payload = self._post(
            f"/c/{collection}/trim", {"max_docs": max_docs}
        )
        return int(payload.get("removed", 0))

    def set_field_values(
        self, collection: str, field: str, values_by_id: dict
    ) -> None:
        self._post(
            f"/c/{collection}/set_field_values",
            {"field": field, "values": list(values_by_id.items())},
        )

    def set_column(
        self, collection: str, field: str, values, start_id: int = 1
    ) -> None:
        from learningorchestra_tpu_torch.core.store import as_column

        column = as_column(values)
        # Page large replaces in strides; each stride is itself a
        # contiguous set_column at the shifted start_id.
        stride = self._upload_stride([column], len(column))
        for offset in range(0, max(len(column), 1), stride):
            stop = min(offset + stride, len(column))
            self._post_frame(
                f"/c/{collection}/set_column_bin",
                encode_frame(
                    {field: column.slice(offset, stop)},
                    extra={"field": field, "start_id": start_id + offset},
                    version=self._upload_version(),
                ),
                collection=collection,
            )
            if stop >= len(column):
                break

    def find(
        self,
        collection: str,
        query: Optional[dict] = None,
        skip: int = 0,
        limit: Optional[int] = None,
    ) -> Iterator[dict]:
        payload = self._post(
            f"/c/{collection}/find",
            {"query": query or {}, "skip": skip, "limit": limit},
        )
        return iter(payload["documents"])

    def read_columns(
        self,
        collection: str,
        fields: Optional[list[str]] = None,
        start: int = 0,
        limit: Optional[int] = None,
    ) -> dict[str, list]:
        """Paged on the wire: rows travel in ``wire_rows`` chunks (the
        read half of ``insert_columns_batched``'s write batching), so a
        10M-row dataset never rides one giant JSON body. The chunk loop
        stops at a short chunk; an explicit ``limit`` caps the total."""
        out: dict[str, list] = {}
        fetched = 0
        while True:
            chunk_limit = self.wire_rows
            if limit is not None:
                chunk_limit = min(chunk_limit, limit - fetched)
                if chunk_limit <= 0:
                    break
            chunk = self._post(
                f"/c/{collection}/read_columns",
                {
                    "fields": fields,
                    "start": start + fetched,
                    "limit": chunk_limit,
                },
            )["columns"]
            if not out:
                out = {name: list(values) for name, values in chunk.items()}
            else:
                for name, values in chunk.items():
                    out[name].extend(values)
            chunk_rows = max((len(v) for v in chunk.values()), default=0)
            fetched += chunk_rows
            # Short chunk = exhausted; empty chunk breaks unconditionally
            # so a degenerate chunk_limit can never spin forever.
            if chunk_rows < chunk_limit or chunk_rows == 0:
                break
        return out

    def read_column_arrays(
        self,
        collection: str,
        fields: Optional[list[str]] = None,
        start: int = 0,
        limit: Optional[int] = None,
    ) -> dict[str, Column]:
        """Typed columns over the binary wire, paged in
        ``wire_rows_bin`` strides. Multi-chunk reads are NOT one atomic
        store snapshot; the server echoes the collection's mutation
        counter per chunk, and a mismatch (a write landed between
        chunks) restarts the read — after ``LO_READ_RETRIES`` (default
        3) torn attempts the last result is returned best-effort, which
        matches the reference's own read semantics (Mongo cursors don't
        snapshot either)."""
        retries = _int_env("LO_READ_RETRIES", 3)
        for _ in range(max(retries, 1)):
            out, torn = self._read_column_arrays_once(
                collection, fields, start, limit, check_rev=True
            )
            if not torn:
                return out
        # Still torn after retries: read to completion WITHOUT the rev
        # check — complete but non-snapshot, the Mongo-cursor semantics
        # (never a silently truncated result).
        out, _ = self._read_column_arrays_once(
            collection, fields, start, limit, check_rev=False
        )
        return out

    def _fetch_chunk(
        self, collection: str, fields, chunk_start: int, chunk_limit: int
    ) -> bytes:
        """One chunk's frame bytes, retried IN PLACE on TRANSIENT
        failure (connection death, timeout, 5xx): a mid-stream fault
        purges any partially-populated device-cache entry for the
        collection (a torn entry must never outlive the read that was
        filling it) and re-requests THIS chunk — never chunk 0; earlier
        chunks' bytes are already decoded and the rev check still
        proves consistency of the final result. Deterministic errors
        (4xx mappings, a follower's 503→PermissionError) propagate
        immediately — retrying them would only add sleeps and evict
        perfectly valid cache entries."""
        attempt = 0
        while True:
            try:
                return self._fetch_frame_bytes(
                    f"/c/{collection}/read_columns_bin",
                    {
                        "fields": fields,
                        "start": chunk_start,
                        "limit": chunk_limit,
                    },
                )
            except (
                httpclient.ConnectionError,
                httpclient.Timeout,
                httpclient.HTTPError,
            ) as error:
                response = getattr(error, "response", None)
                if response is not None and response.status_code < 500:
                    raise  # deterministic client error: not retryable
                from learningorchestra_tpu_torch.core import devcache

                devcache.invalidate_collection(collection, store=self)
                if attempt >= self.chunk_retries:
                    raise
                attempt += 1
                time.sleep(min(0.2 * attempt, 1.0))

    def _decode_chunk(
        self, collection: str, fields, chunk_start: int, chunk_limit: int, raw: bytes
    ):
        """Decode one chunk's frame, re-fetching THIS chunk in place on
        a corrupt frame — a torn/truncated body that slipped past HTTP
        framing (a server falling over mid-response). Same budget and
        cache hygiene as the transport-level chunk retries: the
        partially-filled device-cache entry is purged, and earlier
        chunks' decoded bytes are kept."""
        import struct

        attempt = 0
        while True:
            try:
                return decode_frame(raw)
            except (ValueError, KeyError, IndexError, struct.error):
                from learningorchestra_tpu_torch.core import devcache

                devcache.invalidate_collection(collection, store=self)
                if attempt >= self.chunk_retries:
                    raise
                attempt += 1
                raw = self._fetch_chunk(
                    collection, fields, chunk_start, chunk_limit
                )

    def _read_column_arrays_once(
        self,
        collection: str,
        fields: Optional[list[str]],
        start: int,
        limit: Optional[int],
        check_rev: bool = True,
    ) -> tuple[dict[str, Column], bool]:
        # wire:read wraps the whole paged read: account_wire/
        # account_decode inside the chunk loop accumulate wire_bytes +
        # decode_s onto THIS span (fetches run on helper threads, but
        # the bytes are counted where they are consumed — here), so the
        # job timeline carries the read's full byte-and-decode bill.
        with _tracing.span("wire:read", collection=collection) as span_obj:
            out, torn = self._paged_read(
                collection, fields, start, limit, check_rev
            )
            if span_obj is not None:
                span_obj.meta["rows"] = max(
                    (len(c) for c in out.values()), default=0
                )
        return out, torn

    def _paged_read(
        self,
        collection: str,
        fields: Optional[list[str]],
        start: int,
        limit: Optional[int],
        check_rev: bool,
    ) -> tuple[dict[str, Column], bool]:
        out: dict[str, Column] = {}
        fetched = 0
        rev: Optional[int] = None
        pending = None  # (future, predicted_start, predicted_limit)
        try:
            while True:
                chunk_limit = self.wire_rows_bin
                if limit is not None:
                    chunk_limit = min(chunk_limit, limit - fetched)
                    if chunk_limit <= 0:
                        break
                chunk_start = start + fetched
                if (
                    pending is not None
                    and pending[1] == chunk_start
                    and pending[2] == chunk_limit
                ):
                    future = pending[0]
                    pending = None
                    try:
                        raw = future.result()
                    except Exception:
                        # the read-ahead died terminally (its own
                        # in-place retries exhausted): one more
                        # synchronous attempt before the read as a
                        # whole fails
                        raw = self._fetch_chunk(
                            collection, fields, chunk_start, chunk_limit
                        )
                else:
                    pending = self._discard_prefetch(pending)
                    raw = self._fetch_chunk(
                        collection, fields, chunk_start, chunk_limit
                    )
                # Double buffering: assume this chunk comes back full
                # and start fetching the next stride NOW, overlapping
                # the decode below. A short chunk ends the stream and
                # the speculative fetch is discarded (it reads rows
                # past the end — an empty frame, one wasted round trip
                # at most).
                next_start = chunk_start + chunk_limit
                next_limit = self.wire_rows_bin
                if limit is not None:
                    next_limit = min(next_limit, start + limit - next_start)
                if next_limit > 0 and chunk_limit > 1:
                    pending = (
                        self._prefetch.submit(
                            self._fetch_chunk,
                            collection,
                            fields,
                            next_start,
                            next_limit,
                        ),
                        next_start,
                        next_limit,
                    )
                if isinstance(raw, np.ndarray):
                    # the frame rode the shared-memory ring, not the
                    # HTTP body: shm traffic, not wire traffic
                    _profile.account_shm(collection, len(raw))
                else:
                    _profile.account_wire("read", collection, len(raw))
                decode_started = time.perf_counter()
                columns, extra = self._decode_chunk(
                    collection, fields, chunk_start, chunk_limit, raw
                )
                _profile.account_decode(collection, time.perf_counter() - decode_started)
                chunk_rev = extra.get("rev", -1)
                if rev is None:
                    rev = chunk_rev
                elif check_rev and rev != -1 and chunk_rev != rev:
                    return out, True  # a write interleaved: torn read
                elif chunk_rev != rev:
                    rev = chunk_rev  # unchecked mode: follow the rev
                if not out:
                    out = columns
                else:
                    for name, column in columns.items():
                        existing = out.get(name)
                        if existing is None:
                            # field appeared mid-read (unchecked mode):
                            # earlier rows lack it → pad prefix
                            existing = Column.pads(fetched)
                        out[name] = existing.append_column(column)
                chunk_rows = max(
                    (len(c) for c in columns.values()), default=0
                )
                fetched += chunk_rows
                if chunk_rows < chunk_limit or chunk_rows == 0:
                    break
            return out, False
        finally:
            # Every exit — short chunk, torn-read return, decode error —
            # must consume the speculative fetch (never an unretrieved
            # exception, never an orphaned request blocking a retry).
            self._discard_prefetch(pending)

    @staticmethod
    def _discard_prefetch(pending):
        """Drop a speculative fetch whose prediction didn't pan out
        (short/terminal chunk). Its failure, if any, is irrelevant —
        swallow it so a dead read-ahead never fails a finished read."""
        if pending is not None:
            future = pending[0]
            if not future.cancel():
                future.add_done_callback(lambda f: f.exception())
        return None

    def collection_rev(self, collection: str) -> int:
        return self._get(f"/c/{collection}/rev")["rev"]

    def collection_block_rows(self, collection: str) -> int:
        # older servers don't ship the field: -1 = unknown, same as the
        # base-class contract
        return self._get(f"/c/{collection}/rev").get("block_rows", -1)

    def occupancy_stats(self) -> dict:
        """The server's collection/WAL/spill occupancy (/health's
        ``occupancy`` block, absent on older servers) — the per-group
        probe behind the ``lo_store_shard_*`` gauges. Deliberately NOT
        named ``telemetry_stats``: register_store keys off that name,
        and a remote store must not be mistaken for a local one."""
        health = self._get("/health")
        occupancy = health.get("occupancy")
        return occupancy if isinstance(occupancy, dict) else {}

    def aggregate(self, collection: str, pipeline: list[dict]) -> list[dict]:
        return self._post(f"/c/{collection}/aggregate", {"pipeline": pipeline})[
            "results"
        ]

    def count(self, collection: str) -> int:
        return self._get(f"/c/{collection}/count")["count"]


def connect(url: Optional[str] = None) -> DocumentStore:
    """The services' store factory: a :class:`RemoteStore` when a store
    URL is configured (``LO_STORE_URL`` — the analogue of the reference's
    ``DATABASE_URL``; a comma-separated list names the replica pair and
    enables client-side failover), else a process-local WAL-backed
    store.

    ``;`` separates SHARD GROUPS (``primary,follower;primary,follower``
    — each group keeps its own comma replica list and failover): two or
    more groups build a scatter-gather
    :class:`~learningorchestra_tpu_torch.core.shardstore.ShardedStore` whose
    first group is the meta group. One group — the default — stays a
    plain ``RemoteStore``, so the unsharded wire path is untouched by
    construction, not by configuration."""
    url = url if url is not None else _str_env("LO_STORE_URL")
    if url:
        group_urls = [part.strip() for part in url.split(";") if part.strip()]
        if len(group_urls) > 1:
            from learningorchestra_tpu_torch.core.shardstore import ShardedStore

            return ShardedStore([RemoteStore(part) for part in group_urls])
        return RemoteStore(group_urls[0] if group_urls else url)
    data_dir = _str_env("LO_DATA_DIR")
    return InMemoryStore(data_dir=data_dir)


class ReplicationClient:
    """Follower-side WAL shipper: polls the primary's ``GET /wal`` and
    applies new records to the local store — the role Mongo's secondary
    oplog tailing plays in the reference's replica set
    (docker-compose.yml:27-91). On a stale epoch (the primary
    compacted) the local store resets and re-pulls from record 0, where
    the compacted snapshot now lives. ``stop()`` (or ``POST /promote``
    on the follower's server) halts shipping for failover."""

    def __init__(
        self,
        store: InMemoryStore,
        primary_url: str,
        interval: Optional[float] = None,
        batch: int = 10000,
        node_id: Optional[str] = None,
    ):
        self.store = store
        self.primary_url = primary_url.rstrip("/")
        self.interval = (
            interval
            if interval is not None
            else _float_env("LO_REPL_INTERVAL_S", 0.5)
        )
        self.batch = batch
        # identifies this node at the store.net fault point so chaos
        # tests can partition ONE side's server-to-server traffic
        self.node_id = node_id
        self.epoch = -1
        self.offset = 0
        # Takeover bookkeeping: the primary's term (from the /wal feed),
        # whether the last successful poll had drained the feed, the
        # primary's total feed length (loss-window accounting:
        # primary_length - offset = acknowledged records not yet applied
        # here), and how long the primary has been continuously
        # unreachable (None = healthy) — what auto-promotion and the
        # promote response report.
        self.primary_term = 0
        self.caught_up = False
        self.primary_length = 0
        self.last_poll_monotonic: Optional[float] = None
        self.failing_since: Optional[float] = None
        # A resync signal only marks intent; local state is replaced
        # atomically when the replacement records are actually in hand
        # (resync_apply) — never truncated on the signal alone, so a
        # primary that dies mid-resync cannot leave the follower empty.
        self._pending_resync = True
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        # Serializes apply against stop(): once stop() returns, no
        # further records can land (promote must not race an in-flight
        # poll into applying the old primary's records after new writes).
        self._apply_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def lag(self) -> int:
        """Acknowledged WAL records the primary holds that this
        follower has not applied, as of the last successful poll —
        exported as ``lo_store_replication_lag``. Snapshotted under the
        apply lock (LO203): the poller thread writes primary_length and
        offset under it, and a bare read here could pair the new length
        with the pre-apply offset and report a phantom lag spike."""
        with self._apply_lock:
            return max(0, self.primary_length - self.offset)

    def loss_window(self) -> dict:
        """What a takeover right now would cost (docs/replication.md):
        records the primary acknowledged but never shipped, plus how
        stale that measurement is. Writes the primary accepted AFTER
        the last successful poll are unknowable from here — the window
        is a floor, bounded above by ``last_poll_age_s`` of traffic.
        One apply-lock snapshot (LO203): the whole dict must describe
        ONE poll's state, not a mid-apply mixture."""
        import time

        with self._apply_lock:
            primary_length = self.primary_length
            offset = self.offset
            epoch = self.epoch
            last_poll = self.last_poll_monotonic
        age = (
            None
            if last_poll is None
            else round(time.monotonic() - last_poll, 3)
        )
        return {
            "records": max(0, primary_length - offset),
            "primary_wal_length": primary_length,
            "applied_offset": offset,
            "applied_epoch": epoch,
            "last_poll_age_s": age,
        }

    def poll_once(self, wait: bool = False) -> int:
        """One fetch+apply round; returns the number of records
        applied. ``wait=True`` (the background loop) long-polls the
        primary: a caught-up feed parks server-side until a record
        lands, so replication — and with it sync-repl write acks —
        reacts in tens of milliseconds instead of a poll interval.
        Hand-driven pollers (tests, operators) default to the
        immediate answer."""
        import time

        faults.fire(
            "store.net", me=self.node_id, url=self.primary_url, kind="wal"
        )
        # cursor snapshot under the apply lock (LO203): epoch/offset
        # are rewritten under it (apply, resync, self-heal), and a
        # request built from a torn pair would fetch the wrong window
        with self._apply_lock:
            params = {
                "epoch": self.epoch,
                "offset": self.offset,
                "limit": self.batch,
            }
        if wait:
            params["wait"] = round(min(max(self.interval, 0.1), 25.0), 3)
        response = httpclient.get(
            f"{self.primary_url}/wal",
            params=params,
            timeout=60,
        )
        response.raise_for_status()
        feed = response.json()
        with self._apply_lock:
            if self._stop.is_set():
                return 0
            self.primary_term = max(self.primary_term, feed.get("term", 0))
            self.caught_up = len(feed["records"]) < self.batch
            self.primary_length = feed.get("length", feed.get("next", 0))
            self.last_poll_monotonic = time.monotonic()
            if feed["resync"]:
                self.epoch = feed["epoch"]
                self.offset = 0
                self._pending_resync = True
                return 0
            try:
                if self._pending_resync and feed["offset"] == 0:
                    self.store.resync_apply(feed["records"])
                    self._pending_resync = False
                else:
                    self.store.apply_replicated(feed["records"])
            except Exception:
                # A mid-batch failure (divergence, duplicate id) leaves
                # an ambiguous prefix applied; re-pulling the same batch
                # would fail forever. Self-heal: force a full resync.
                self.epoch = -1
                self.offset = 0
                self._pending_resync = True
                raise
            self.offset = feed["next"]
            return len(feed["records"])

    def run(self) -> None:
        import time

        while not self._stop.is_set():
            started = time.monotonic()
            try:
                applied = self.poll_once(wait=True)
                self.last_error = None
                self.failing_since = None
            except Exception as error:  # primary down: keep serving reads
                self.last_error = str(error)
                if self.failing_since is None:
                    self.failing_since = time.monotonic()
                applied = 0
            if applied == 0 and time.monotonic() - started < self.interval:
                # only sleep when the empty answer came back FAST: a
                # primary honoring the long-poll already waited the
                # interval server-side (sleeping again would re-add the
                # ack latency the long-poll removes); a dead primary or
                # an old one ignoring `wait` returns/fails immediately
                # and must not be hammered
                self._stop.wait(self.interval)

    def start(self) -> "ReplicationClient":
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def halt(self) -> None:
        """The correctness fence WITHOUT the thread join: on return, no
        further records will be applied — the stop flag is checked
        under the apply lock, so an in-flight poll either finished
        applying before this or discards its response. Bounded by one
        in-flight apply batch, so it is safe to call while holding the
        role lock; the poller thread itself exits on its next wakeup
        (its long-poll request can park for up to 60 s — which is why
        :meth:`stop`'s join must never run under a lock, LO202)."""
        self._stop.set()
        with self._apply_lock:
            pass

    def stop(self) -> None:
        """halt() plus the thread join (bounded, 10 s). Call this only
        OUTSIDE any lock a request handler can take: the join waits on
        a thread that may be mid-long-poll."""
        self.halt()
        if self._thread is not None:
            self._thread.join(timeout=10)


def probe_health(
    url: str, timeout: float = 2.0, origin: Optional[str] = None
) -> Optional[dict]:
    """``/health`` of a peer store, or None when unreachable.
    ``origin`` identifies a SERVER-side caller (monitor, fence) at the
    ``store.net`` fault point so chaos tests can partition one node's
    backend traffic; client-side probes pass no origin and stay
    unaffected — a backend partition does not sever client reach."""
    try:
        if origin is not None:
            faults.fire(
                "store.net", me=origin, url=url.rstrip("/"), kind="health"
            )
        response = httpclient.get(f"{url.rstrip('/')}/health", timeout=timeout)
        response.raise_for_status()
        return response.json()
    except Exception:
        return None


def request_votes(
    voters: list[str],
    term: int,
    candidate: str,
    origin: Optional[str] = None,
    timeout: float = 2.0,
) -> tuple[int, list[dict]]:
    """Campaign for ``term``: POST /vote to every voter (store peers +
    arbiters). Returns ``(granted_including_self, responses)`` — the
    candidate's own vote is counted here, the caller must have recorded
    it in its ledger first (one vote per term applies to self too)."""
    granted = 1  # self
    responses: list[dict] = []
    for voter in voters:
        url = voter.rstrip("/")
        try:
            if origin is not None:
                faults.fire("store.net", me=origin, url=url, kind="vote")
            response = httpclient.post(
                f"{url}/vote",
                json={"term": term, "candidate": candidate},
                timeout=timeout,
            )
            payload = response.json()
        except Exception:
            continue
        responses.append(payload)
        if payload.get("granted"):
            granted += 1
    return granted, responses


def serve(
    host: str = "127.0.0.1",
    port: int = DEFAULT_STORE_PORT,
    data_dir: Optional[str] = None,
    replicate: bool = False,
    primary_url: Optional[str] = None,
    peers: Optional[list[str]] = None,
    auto_promote_s: Optional[float] = None,
    arbiters: Optional[list[str]] = None,
    node_id: Optional[str] = None,
    monitor_tick_s: Optional[float] = None,
    quorum_grace_s: Optional[float] = None,
    sync_repl: Optional[bool] = None,
    ack_timeout_s: Optional[float] = None,
) -> ServerThread:
    """Start a store server thread; returns it (caller stops).

    ``replicate=True`` keeps the in-memory WAL buffer so followers can
    ship the log; ``primary_url`` starts THIS server as a follower of
    that primary (read-only until promoted). The server's ``role`` dict
    and poller are attached to the returned thread as ``.store_role`` /
    ``.replication`` for operators and tests.

    ``peers`` (LO_PEERS) enables term fencing: at startup a
    would-be-writable server that finds ANY writable peer joins it as a
    follower (the revived old primary of a completed failover; also
    makes sequential bootstrap of a fresh pair converge on one
    primary); while running, a writable server demotes itself only to
    a writable peer with a strictly higher term. ``auto_promote_s``
    (LO_AUTO_PROMOTE_S) makes a follower promote itself once its
    primary has been unreachable for that long.

    ``arbiters`` (LO_ARBITERS) switches failover to QUORUM mode
    (docs/replication.md): auto-promotion requires a majority of votes
    from the voting population (this server + peers + arbiters), and a
    writable server that cannot reach a majority of voters for
    ``quorum_grace_s`` (LO_QUORUM_GRACE_S) suspends writes — 503 +
    Retry-After, reads keep serving — until quorum returns and no
    superseding primary is visible. ``sync_repl``
    (LO_STORE_SYNC_REPL=1) withholds mutation acks until a follower's
    WAL cursor passes them (bounded by ``ack_timeout_s`` /
    LO_STORE_ACK_TIMEOUT_S) — the zero-lost-acknowledged-writes mode.
    """
    import time

    store = InMemoryStore(
        data_dir=data_dir,
        replicate=replicate or primary_url is not None or bool(peers),
    )
    arbiters = [a.rstrip("/") for a in (arbiters or []) if a]
    writable = primary_url is None
    if writable and peers:
        # Startup fence: a server coming up writable must make sure no
        # peer has taken over while it was down (>= catches the revived
        # old primary of a same-term promote race; a genuinely fresh
        # pair starts follower-less, so no peer answers writable).
        for peer in peers:
            health = probe_health(peer, origin=node_id)
            if health and health.get("writable"):
                writable = False
                primary_url = peer
                break
    import secrets

    if sync_repl is None:
        sync_repl = _flag_env("LO_STORE_SYNC_REPL")
    if ack_timeout_s is None:
        ack_timeout_s = _float_env("LO_STORE_ACK_TIMEOUT_S", 2.0)
    role = {
        "writable": writable,
        "poller": None,
        "term": 1 if writable else 0,
        # equal-term tiebreak for the fence: two fresh servers that
        # both bootstrapped writable (simultaneous start, neither's
        # probe saw the other) deterministically converge on the higher
        # boot id instead of split-braining at term 1 == term 1
        "boot": secrets.token_hex(8),
        "sync_repl": bool(sync_repl),
        "ack_timeout_s": ack_timeout_s,
    }
    me = node_id or role["boot"]
    if primary_url is not None and not writable:
        role["poller"] = ReplicationClient(
            store, primary_url, node_id=me
        ).start()
    server = ServerThread(create_store_app(store, role), host, port).start()
    server.store = store
    server.store_role = role
    server.replication = role["poller"]

    def demote_to(peer: str) -> None:
        """Superseded while writable: rejoin as a follower of ``peer``.
        The fresh poller's epoch mismatch forces a full resync, which
        atomically replaces any diverged local writes."""
        with role["lock"]:
            if not role.get("writable"):
                return
            role["writable"] = False
            role["suspended"] = False
            role["poller"] = ReplicationClient(
                store, peer, node_id=me
            ).start()
            server.replication = role["poller"]
        print(f"store: fenced — rejoining as follower of {peer}", flush=True)

    def refollow(peer: str) -> None:
        """A follower whose primary pointer went stale (its primary
        died and a QUORUM election elsewhere produced a new one)
        re-points its WAL poller at the visible writable peer."""
        with role["lock"]:
            if role.get("writable"):
                return
            old_poller = role.get("poller")
            if (
                old_poller is not None
                and old_poller.primary_url == peer.rstrip("/")
            ):
                return
            if old_poller is not None:
                # fence only (LO202): the join happens outside the
                # lock below — see promote_role
                old_poller.halt()
            role["poller"] = ReplicationClient(
                store, peer, node_id=me
            ).start()
            server.replication = role["poller"]
        if old_poller is not None:
            old_poller.stop()
        print(f"store: re-following new primary {peer}", flush=True)

    quorum = bool(arbiters)
    voters = list(peers or []) + arbiters
    population = 1 + len(voters)
    tick = (
        monitor_tick_s
        if monitor_tick_s is not None
        else _float_env("LO_STORE_MONITOR_TICK_S", 1.0)
    )
    if quorum_grace_s is None:
        quorum_grace_s = _float_env("LO_QUORUM_GRACE_S", None)
        if quorum_grace_s is None:
            # a primary must suspend BEFORE the majority side can have
            # promoted, or a short dual-primary window opens: default
            # the grace under the takeover timer
            quorum_grace_s = (
                min(2.0, auto_promote_s / 2) if auto_promote_s else 2.0
            )

    if peers or auto_promote_s or arbiters:
        monitor_stop = threading.Event()

        def try_takeover(poller) -> None:
            """The follower's promotion decision, quorum-gated when
            arbiters are configured."""
            if not quorum:
                result = promote_role(role)
                server.replication = None
                print(
                    "store: primary gone/unwritable for "
                    f"{auto_promote_s:g}s — self-promoted "
                    f"(term {result['term']}, caught_up="
                    f"{result['caught_up']})",
                    flush=True,
                )
                return
            # the primary may not be GONE — a completed election
            # elsewhere means refollow the winner, not campaign
            for peer in peers or []:
                health = probe_health(peer, origin=me)
                if (
                    health
                    and health.get("writable")
                    and not health.get("suspended")
                ):
                    refollow(peer)
                    return
            with role["lock"]:
                if role.get("writable"):
                    return
                # candidate term AND the self-vote ledger write happen
                # under ONE lock acquisition: computing the term outside
                # would race a concurrent POST /vote granting a higher
                # term, and overwriting voted_term downward would let
                # this node vote twice in that term (two majorities)
                candidate_term = (
                    max(
                        role.get("term", 0),
                        poller.primary_term,
                        role.get("voted_term", 0),
                        1,
                    )
                    + 1
                )
                role["voted_term"] = candidate_term
                role["voted_for"] = me
            granted, _ = request_votes(
                voters, candidate_term, me, origin=me
            )
            if granted * 2 > population:
                result = promote_role(role, term=candidate_term)
                server.replication = None
                print(
                    f"store: quorum takeover ({granted}/{population} "
                    f"votes) — promoted (term {result['term']}, "
                    f"caught_up={result['caught_up']}, "
                    f"loss_window={result['loss_window']})",
                    flush=True,
                )
            else:
                counters["denied"] += 1
                if counters["denied"] % 10 == 1:
                    print(
                        f"store: promotion blocked — {granted} of "
                        f"{population} votes; staying a read-only "
                        "follower",
                        flush=True,
                    )

        counters = {"denied": 0}

        def monitor():
            unwritable_since: Optional[float] = None
            no_quorum_since: Optional[float] = None
            while not monitor_stop.wait(tick):
                poller = role.get("poller")
                if auto_promote_s and poller is not None:
                    # A reachable-but-UNWRITABLE primary counts as down
                    # too: after a failover, a supervisor restart of the
                    # promoted server (original env) can leave both
                    # nodes followers of each other — the /wal polls
                    # succeed, so failing_since alone never fires. Both
                    # sides then self-promote and the term/boot fence
                    # converges on one writer within a few ticks.
                    if poller.failing_since is None:
                        health = probe_health(poller.primary_url, origin=me)
                        if health is not None and not health.get("writable"):
                            if unwritable_since is None:
                                unwritable_since = time.monotonic()
                        else:
                            unwritable_since = None
                    down_since = (
                        poller.failing_since
                        if poller.failing_since is not None
                        else unwritable_since
                    )
                    if (
                        down_since is not None
                        and time.monotonic() - down_since >= auto_promote_s
                    ):
                        try_takeover(poller)
                        if role.get("writable"):
                            unwritable_since = None
                peer_healths: dict[str, Optional[dict]] = {}
                if role.get("writable"):
                    for peer in peers or []:
                        peer_healths[peer] = probe_health(peer, origin=me)
                if quorum and role.get("writable"):
                    # quorum custody: a primary that cannot reach a
                    # majority of voters suspends writes (the minority
                    # side of a partition degrades to read-only instead
                    # of diverging); resumes only once quorum is back
                    # AND no superseding primary is visible
                    reachable = 1
                    superior = False
                    my_term = role.get("term", 0)
                    my_boot = role.get("boot", "")
                    for voter in voters:
                        health = (
                            peer_healths[voter]
                            if voter in peer_healths
                            else probe_health(voter, origin=me)
                        )
                        if not health:
                            continue
                        reachable += 1
                        # ANY voter reporting a higher term — the
                        # arbiter included (its /health carries the
                        # highest term it has voted) — is proof an
                        # election superseded this primary. Counting
                        # only writable peers here would let an
                        # asymmetric partition (primary↔follower link
                        # down, both still reach the arbiter) keep TWO
                        # writers: the follower wins self+arbiter, the
                        # old primary still counts quorum via the
                        # arbiter and never hears about the new term.
                        peer_term = max(
                            health.get("term", 0),
                            health.get("voted_term", 0),
                        )
                        if peer_term > my_term or (
                            health.get("writable")
                            and peer_term == my_term
                            and health.get("boot", "") > my_boot
                        ):
                            superior = True
                    if superior and not role.get("suspended"):
                        # definitive supersession evidence: suspend NOW
                        # (no grace — the other side may already be
                        # accepting writes); the fence below demotes to
                        # the new primary once it becomes visible
                        with role["lock"]:
                            role["suspended"] = True
                        print(
                            "store: a voter reports a higher term — "
                            "superseded; suspending writes until the "
                            "new primary is visible",
                            flush=True,
                        )
                    if reachable * 2 <= population:
                        if no_quorum_since is None:
                            no_quorum_since = time.monotonic()
                        if (
                            time.monotonic() - no_quorum_since
                            >= quorum_grace_s
                            and not role.get("suspended")
                        ):
                            with role["lock"]:
                                role["suspended"] = True
                            print(
                                "store: quorum lost "
                                f"({reachable}/{population} voters "
                                "reachable) — suspending writes, reads "
                                "keep serving",
                                flush=True,
                            )
                    else:
                        no_quorum_since = None
                        if role.get("suspended") and not superior:
                            with role["lock"]:
                                role["suspended"] = False
                            print(
                                "store: quorum restored — resuming "
                                "writes",
                                flush=True,
                            )
                if peers and role.get("writable"):
                    my_term = role.get("term", 0)
                    my_boot = role.get("boot", "")
                    for peer in peers:
                        health = peer_healths.get(peer)
                        if not health or not health.get("writable"):
                            continue
                        peer_term = health.get("term", 0)
                        if peer_term > my_term or (
                            peer_term == my_term
                            and health.get("boot", "") > my_boot
                        ):
                            demote_to(peer)
                            break

        monitor_thread = threading.Thread(target=monitor, daemon=True)
        monitor_thread.start()
        server.monitor_stop = monitor_stop
        # server.stop() must halt the monitor too, or every
        # serve()-and-stop cycle leaks a thread that keeps probing peers
        # (and could promote/demote a stopped server's role)
        original_stop = server.stop

        def stop_with_monitor(*args, **kwargs):
            monitor_stop.set()
            poller = role.get("poller")
            if poller is not None:
                poller.stop()
            return original_stop(*args, **kwargs)

        server.stop = stop_with_monitor
    if replicate or primary_url is not None or peers:
        # The replication feed duplicates the write history in RAM —
        # on the primary AND on every follower (a follower re-logs each
        # applied record so it is promotable with full durability).
        # Compact when it grows past LO_COMPACT_RECORDS: the snapshot
        # replaces the history; on the primary the epoch bump resyncs
        # followers, on a follower compaction is purely local (the
        # poller's cursor tracks the PRIMARY's epoch, not the local
        # one), and a follower promoted later keeps compacting.
        threshold = _int_env("LO_COMPACT_RECORDS", 200000)
        stop = threading.Event()

        def maintain():
            while not stop.wait(10.0):
                if store.wal_length > threshold:
                    store.compact()

        thread = threading.Thread(target=maintain, daemon=True)
        thread.start()
        server.compaction_stop = stop
    return server


def main() -> None:
    try:
        # a typo'd chaos knob must refuse bring-up, not silently not fire
        faults.validate_env()
    except ValueError as error:
        raise SystemExit(f"LO_FAULT_* validation failed: {error}")
    host = _str_env("LO_HOST", "127.0.0.1")
    port = _int_env("LO_STORE_PORT", DEFAULT_STORE_PORT)
    data_dir = _str_env("LO_DATA_DIR")
    replicate = _flag_env("LO_REPLICATE")
    # free-form topology strings (URLs, host lists, node ids): nothing
    # for the run.sh preflight to range-check
    primary_url = _str_env("LO_PRIMARY_URL")  # lo: allow[LO301]
    peers_env = _str_env("LO_PEERS", "")  # lo: allow[LO301]
    peers = [p.strip() for p in peers_env.split(",") if p.strip()] or None
    arbiters_env = _str_env("LO_ARBITERS", "")  # lo: allow[LO301]
    arbiters = [
        a.strip() for a in arbiters_env.split(",") if a.strip()
    ] or None
    auto_promote_s = _float_env("LO_AUTO_PROMOTE_S", None)
    server = serve(
        host,
        port,
        data_dir,
        replicate,
        primary_url,
        peers,
        auto_promote_s,
        arbiters=arbiters,
        node_id=_str_env("LO_NODE_ID"),  # lo: allow[LO301] free-form
    )
    mode = (
        f"follower of {primary_url}"
        if primary_url
        else ("primary (replicating)" if replicate else "standalone")
    )
    if arbiters:
        mode += f", quorum via {len(arbiters)} arbiter(s)"
    print(
        f"store server on {host}:{server.port} (data_dir={data_dir}, {mode})",
        flush=True,
    )
    server._thread.join()


if __name__ == "__main__":
    main()
