"""Document store: the framework's storage contract.

The reference uses a MongoDB replica set as its only data plane; every
dataset is a collection whose row ``_id: 0`` is a metadata document with a
``finished`` flag, and rows are documents ``_id: 1..N`` (reference:
microservices/database_api_image/database.py:14-15,199-216). This module
keeps that contract but makes the store a first-class, pluggable part of
the framework:

- :class:`DocumentStore` — the interface every backend implements. It is
  a superset of the hand-rolled ``DatabaseInterface`` ABCs scattered
  through the reference services (e.g. reference:
  microservices/model_builder_image/model_builder.py:33-43).
- :class:`InMemoryStore` — thread-safe in-process backend with an
  optional JSONL write-ahead log for durability. Used directly by tests
  and by the storage service (``services/storage.py``).
- Columnar reads (:meth:`DocumentStore.read_columns` /
  :meth:`DocumentStore.read_column_arrays`) are the data plane between
  storage and the TPU: compute never does row-at-a-time RPCs the way
  the reference does (reference:
  microservices/model_builder_image/model_builder.py:237-247).

Dataset bodies live in **typed columnar blocks** (core/columns.py):
numpy buffers for numbers/bools, Arrow-style byte buffers for strings —
~8 bytes/cell instead of the ~60-100 bytes a boxed Python object costs,
which is what makes 10M+-row datasets fit where the reference leans on
Mongo owning disk (reference: docker-compose.yml:335-340). A
row-document overlay holds the ``_id: 0`` metadata document and any
out-of-band inserts, preserving full document semantics.

Queries are Mongo-style subset-equality matches, which is the full extent
of what the reference services use.
"""

from __future__ import annotations

import ast
import itertools
import json
import os
import re
import threading
from typing import Any, Iterator, Optional, Union

import numpy as np

from learningorchestra_tpu_torch.core.columns import MISSING as _MISSING
from learningorchestra_tpu_torch.core.columns import Column

ROW_ID = "_id"
METADATA_ID = 0

# Metadata keys a dataset's `_id: 0` document may carry (reference:
# microservices/model_builder_image/model_builder.py:103-111).
METADATA_FIELDS = (
    "_id",
    "fields",
    "filename",
    "finished",
    "time_created",
    "url",
    "parent_filename",
)

ColumnInput = Union[Column, list, np.ndarray]


def parse_query(raw: Optional[str]) -> dict:
    """Parse a query string sent over REST.

    The reference client serialises queries with ``str(dict)`` (reference:
    learning_orchestra_client/__init__.py:75) which produces Python repr,
    while the server parses with ``json.loads`` (reference:
    microservices/database_api_image/database.py:40) — so any non-trivial
    query crashes it. We accept both encodings.
    """
    if not raw:
        return {}
    try:
        query = json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        query = ast.literal_eval(raw)  # ValueError/SyntaxError to caller
    if not isinstance(query, dict):
        raise ValueError(f"query must be a dict, got {type(query).__name__}")
    return query


class UnsupportedQueryError(ValueError):
    """A query uses an operator this engine doesn't implement, or a
    malformed operand. The REST layer maps it to a 400 rather than
    letting it surface as a 500."""


def _membership_list(op: str, operand: Any) -> Any:
    if not isinstance(operand, (list, tuple, set)):
        raise UnsupportedQueryError(f"{op} operand must be a list")
    return operand


def _compare(op: str, value: Any, operand: Any) -> bool:
    if op == "$in":
        operand = _membership_list(op, operand)
    try:
        if op == "$eq":
            return value == operand
        if op == "$gt":
            return value > operand
        if op == "$gte":
            return value >= operand
        if op == "$lt":
            return value < operand
        if op == "$lte":
            return value <= operand
        if op == "$in":
            return value in operand
    except TypeError:  # e.g. None vs number — Mongo treats as no match
        return False
    raise UnsupportedQueryError(f"unsupported query operator {op!r}")


def _match_operators(document: dict, key: str, ops: dict) -> bool:
    """Operator document on one field, with Mongo's missing-field
    semantics: ``$ne``/``$nin`` match documents lacking the field, the
    comparisons don't."""
    present = key in document
    value = document.get(key)
    for op, operand in ops.items():
        if op == "$exists":
            if present != bool(operand):
                return False
        elif op == "$ne":
            if present and value == operand:
                return False
        elif op == "$nin":
            operand = _membership_list(op, operand)  # validate even if absent
            if present and value in operand:
                return False
        elif op == "$regex":
            try:
                pattern = re.compile(operand)
            except (re.error, TypeError) as error:
                raise UnsupportedQueryError(
                    f"invalid $regex operand {operand!r}"
                ) from error
            if not present or not isinstance(value, str) or not pattern.search(value):
                return False
        elif op == "$not":
            if not isinstance(operand, dict):
                raise UnsupportedQueryError("$not operand must be an operator dict")
            if _match_operators(document, key, operand):
                return False
        else:
            if op not in ("$eq", "$gt", "$gte", "$lt", "$lte", "$in"):
                raise UnsupportedQueryError(f"unsupported query operator {op!r}")
            if op == "$in":
                operand = _membership_list(op, operand)  # validate even if absent
            if not present or not _compare(op, value, operand):
                return False
    return True


def matches(document: dict, query: dict) -> bool:
    """Mongo-style match — the operator surface the reference exposes by
    forwarding client queries straight to pymongo ``find`` (reference:
    microservices/database_api_image/database.py:36-44): subset equality,
    ``$eq/$ne/$gt/$gte/$lt/$lte/$in/$nin/$exists/$regex/$not``, and the
    top-level logicals ``$or/$and/$nor``. Anything else raises
    :class:`UnsupportedQueryError` (→ REST 400) instead of silently
    matching nothing."""
    for key, condition in query.items():
        if key in ("$or", "$and", "$nor"):
            if not isinstance(condition, (list, tuple)) or not all(
                isinstance(sub, dict) for sub in condition
            ):
                raise UnsupportedQueryError(f"{key} operand must be a list of dicts")
            branches = [matches(document, sub) for sub in condition]
            if key == "$or" and not any(branches):
                return False
            if key == "$and" and not all(branches):
                return False
            if key == "$nor" and any(branches):
                return False
        elif key.startswith("$"):
            raise UnsupportedQueryError(f"unsupported query operator {key!r}")
        elif isinstance(condition, dict) and any(
            k.startswith("$") for k in condition
        ):
            if not _match_operators(document, key, condition):
                return False
        elif key not in document or document[key] != condition:
            return False
    return True


def as_column(values: ColumnInput) -> Column:
    """Normalize any accepted columnar input to a :class:`Column`."""
    if isinstance(values, Column):
        return values
    if isinstance(values, np.ndarray):
        return Column.from_numpy(values)
    return Column.from_values(values)


class DocumentStore:
    """Interface for collection-of-documents backends."""

    # --- collection lifecycle -------------------------------------------------
    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def create_collection(self, collection: str) -> bool:
        """Atomically claim ``collection``; False if it already exists.

        The duplicate-output-name gate for create routes. The reference
        validates with a check-then-act list scan
        (reference: microservices/projection_image/projection.py:151-155)
        — a race SURVEY §5 flags; this primitive makes the claim atomic
        so concurrent duplicate creates get exactly one winner.
        """
        raise NotImplementedError

    def drop(self, collection: str) -> None:
        raise NotImplementedError

    def trim_collection(self, collection: str, max_docs: int) -> int:
        """Ring-collection cap discipline: drop the OLDEST overlay
        documents (ascending int ``_id``, metadata excluded) until at
        most ``max_docs`` remain; returns how many were removed. The
        bounded-retention primitive behind ``__lo_metrics__``
        (telemetry/tsdb.py) — rev-bumping like every other mutation, so
        paged readers and caches see the eviction. Columnar block rows
        are out of scope: rings are row-document collections."""
        raise NotImplementedError

    # --- writes ---------------------------------------------------------------
    def insert_one(self, collection: str, document: dict) -> None:
        raise NotImplementedError

    def insert_many(self, collection: str, documents: list[dict]) -> None:
        for document in documents:
            self.insert_one(collection, document)

    def insert_columns(
        self,
        collection: str,
        columns: dict[str, ColumnInput],
        start_id: Optional[int] = None,
    ) -> None:
        """Bulk column-major append: rows ``start_id..start_id+n-1`` with
        ``{field: values[i]}``. The storage→compute data plane's write
        half — backends keep this columnar end to end so dataset bodies
        never pay per-row Python dict costs. Values may be plain lists,
        numpy arrays, or :class:`Column` objects. Default implementation
        degrades to ``insert_many`` for row-oriented backends.
        """
        columns = {name: as_column(values) for name, values in columns.items()}
        lengths = {len(values) for values in columns.values()}
        if len(lengths) > 1:
            raise ValueError("ragged columns")
        num_rows = lengths.pop() if lengths else 0
        value_lists = {
            name: column.tolist(pad_as_none=False)
            for name, column in columns.items()
        }
        documents = []
        for i in range(num_rows):
            document = {
                name: values[i]
                for name, values in value_lists.items()
                if values[i] is not _MISSING
            }
            if start_id is not None:
                document[ROW_ID] = start_id + i
            documents.append(document)
        self.insert_many(collection, documents)

    def insert_column_arrays(
        self,
        collection: str,
        columns: dict[str, Column],
        start_id: Optional[int] = None,
    ) -> None:
        """Typed-column append — the zero-conversion write half of the
        data plane. Same semantics as :meth:`insert_columns`."""
        self.insert_columns(collection, columns, start_id=start_id)

    def update_one(self, collection: str, query: dict, new_values: dict) -> None:
        """Set ``new_values`` on the first document matching ``query``
        (Mongo ``update_one(filter, {"$set": ...})`` semantics)."""
        raise NotImplementedError

    def set_field_values(
        self, collection: str, field: str, values_by_id: dict
    ) -> None:
        """Bulk-write one field across many rows: ``{_id: new_value}``.

        The columnar write path. The reference updates converted values one
        ``update_one`` RPC per document (reference:
        microservices/data_type_handler_image/data_type_handler.py:47-77);
        backends implement this as a single batched mutation instead.
        """
        for doc_id, value in values_by_id.items():
            self.update_one(collection, {ROW_ID: doc_id}, {field: value})

    def set_column(
        self,
        collection: str,
        field: str,
        values: ColumnInput,
        start_id: int = 1,
    ) -> None:
        """Replace ``field`` for the contiguous rows ``start_id..`` with
        ``values`` — the column-major write the fieldtypes conversion
        uses (one bulk call per field; the reference issues 2 RPCs per
        row per field, reference data_type_handler.py:47-77). Default
        implementation degrades to ``set_field_values``."""
        values = as_column(values).tolist(pad_as_none=False)
        self.set_field_values(
            collection,
            field,
            {start_id + i: value for i, value in enumerate(values)},
        )

    # --- reads ----------------------------------------------------------------
    def find(
        self,
        collection: str,
        query: Optional[dict] = None,
        skip: int = 0,
        limit: Optional[int] = None,
    ) -> Iterator[dict]:
        """Documents matching ``query``, ordered by ``_id`` ascending."""
        raise NotImplementedError

    def find_one(self, collection: str, query: dict) -> Optional[dict]:
        for document in self.find(collection, query, limit=1):
            return document
        return None

    def count(self, collection: str) -> int:
        return sum(1 for _ in self.find(collection))

    def aggregate(self, collection: str, pipeline: list[dict]) -> list[dict]:
        """The ``$group``/``$sum: 1`` value-count pipeline the histogram
        service pushes down (reference:
        microservices/histogram_image/histogram.py:63-69)."""
        raise NotImplementedError

    # --- columnar data plane --------------------------------------------------
    def read_columns(
        self,
        collection: str,
        fields: Optional[list[str]] = None,
        start: int = 0,
        limit: Optional[int] = None,
    ) -> dict[str, list]:
        """Column-major read of non-metadata rows, ordered by ``_id``.

        Returns ``{field: [values...]}``. This is the storage→device path:
        one bulk call instead of the reference's per-row RPCs.
        ``start``/``limit`` slice the row range (after metadata exclusion)
        so wire backends can page large datasets in bounded chunks;
        field-name discovery under ``fields=None`` always scans every row
        (a chunk must not change the column set).
        """
        rows = [
            document
            for document in self.find(collection)
            if document.get(ROW_ID) != METADATA_ID
        ]
        if fields is None:
            names: list[str] = []
            for row in rows:
                for key in row:
                    if key not in names and key != ROW_ID:
                        names.append(key)
            fields = names
        stop = None if limit is None else start + limit
        rows = rows[start:stop]
        return {
            field: [row.get(field) for row in rows] for field in fields
        }

    def read_column_arrays(
        self,
        collection: str,
        fields: Optional[list[str]] = None,
        start: int = 0,
        limit: Optional[int] = None,
    ) -> dict[str, Column]:
        """Typed-column read — the zero-conversion half of the data
        plane. Same row semantics as :meth:`read_columns`. Default
        implementation wraps the list read."""
        return {
            name: Column.from_values(values)
            for name, values in self.read_columns(
                collection, fields, start=start, limit=limit
            ).items()
        }

    def collection_rev(self, collection: str) -> int:
        """Mutation counter for torn-read detection and device-cache
        invalidation (core/devcache.py). -1 = unknown/missing: backends
        that cannot report one opt every cached reader out, never into
        staleness."""
        return -1

    def collection_block_rows(self, collection: str) -> int:
        """Rows in the collection's columnar block (excluding overlay
        documents), -1 when the collection is missing. The sharded
        client (core/shardstore.py) sums these across groups to place
        appends and split positional reads; row-oriented backends that
        cannot tell block from overlay report -1 too."""
        return -1

    # --- dataset metadata contract -------------------------------------------
    def metadata(self, collection: str) -> Optional[dict]:
        return self.find_one(collection, {ROW_ID: METADATA_ID})

    def is_finished(self, collection: str) -> bool:
        meta = self.metadata(collection)
        return bool(meta and meta.get("finished"))


def _group_count(documents: Iterator[dict], field: str) -> list[dict]:
    # Keys carry a bool tag: True hashes equal to 1, and a plain dict
    # would merge the two groups (Mongo keeps true and 1 distinct).
    counts: dict[Any, int] = {}
    for document in documents:
        if document.get(ROW_ID) == METADATA_ID:
            continue
        value = document.get(field)
        key = (isinstance(value, bool), value)
        counts[key] = counts.get(key, 0) + 1
    return [{"_id": key[1], "count": count} for key, count in counts.items()]


def _is_int_id(doc_id: Any) -> bool:
    return isinstance(doc_id, int) and not isinstance(doc_id, bool)


# Columns below this size are never worth a file + mapping.
_SPILL_MIN_COLUMN_BYTES = 16 * 1024 * 1024

# Distinguishes multiple stores in ONE process under a shared
# LO_SPILL_DIR (e.g. a primary + follower pair in tests).
_SPILL_DIR_SEQ = itertools.count()

# Seconds between advise_cold sweeps: every sweep evicts resident mapped
# pages a concurrent scan may just have faulted in, so it is
# rate-limited rather than run per insert batch.
_ADVISE_INTERVAL_S = 5.0


def _path_safe(name: str) -> str:
    """Collection/field names as filesystem-safe path components."""
    return "".join(
        ch if ch.isalnum() or ch in "._-" else "_" for ch in name
    ) or "_"


class _Collection:
    """One collection's storage: a contiguous column-major block for the
    dataset body plus a row-document overlay for everything else.

    The block holds rows ``block_start..block_start+n-1`` as typed
    :class:`Column` buffers (core/columns.py), one per field — ~8
    bytes/cell, zero boxed objects — the shape bulk ingest/projection
    write and ``read_columns`` returns. The overlay holds the ``_id: 0``
    metadata document and any out-of-band inserts. Ids never overlap
    between the two.
    """

    __slots__ = ("block_fields", "block_columns", "block_start", "rows", "rev")

    def __init__(self):
        self.block_fields: list[str] = []
        self.block_columns: dict[str, Column] = {}
        self.block_start = 1
        self.rows: dict[Any, dict] = {}
        # Mutation counter: paged wire readers compare it across chunks
        # to detect (and retry) a torn multi-request read, and the
        # device cache keys entries by it. Values are drawn from the
        # STORE's monotonic sequence (never per-collection counting) so
        # a dropped-and-recreated collection can't reissue a rev a cache
        # somewhere still holds.
        self.rev = 0

    def snapshot(self) -> "_Collection":
        """A consistent read view: columns are copy-on-write snapshots
        (O(1) per column), overlay documents shallow-copied — so
        ``find`` can yield outside the store lock without seeing
        concurrent mutations tear a document mid-iteration. Must be
        called while holding the store lock."""
        clone = _Collection()
        clone.block_fields = list(self.block_fields)
        clone.block_columns = {
            name: column.snapshot()
            for name, column in self.block_columns.items()
        }
        clone.block_start = self.block_start
        clone.rows = {doc_id: dict(row) for doc_id, row in self.rows.items()}
        clone.rev = self.rev
        return clone

    # --- block geometry -------------------------------------------------------
    @property
    def block_rows(self) -> int:
        if not self.block_columns:
            return 0
        return len(next(iter(self.block_columns.values())))

    @property
    def block_stop(self) -> int:
        """One past the last block id."""
        return self.block_start + self.block_rows

    def in_block(self, doc_id: Any) -> bool:
        return _is_int_id(doc_id) and self.block_start <= doc_id < self.block_stop

    def has_id(self, doc_id: Any) -> bool:
        return self.in_block(doc_id) or doc_id in self.rows

    def next_id(self) -> int:
        top = self.block_stop - 1 if self.block_columns else 0
        for doc_id in self.rows:
            if _is_int_id(doc_id) and doc_id > top:
                top = doc_id
        return top + 1

    # --- row synthesis --------------------------------------------------------
    def block_document(self, doc_id: int) -> dict:
        i = doc_id - self.block_start
        document = {}
        for name in self.block_fields:
            value = self.block_columns[name].get(i)
            if value is not _MISSING:
                document[name] = value
        document[ROW_ID] = doc_id
        return document

    def document(self, doc_id: Any) -> dict:
        if self.in_block(doc_id):
            return self.block_document(doc_id)
        return dict(self.rows[doc_id])

    def iter_ids(self) -> Iterator:
        """All ids: ints ascending (overlay and block merged), then
        non-int ids in string order."""
        import heapq

        overlay_ints = sorted(i for i in self.rows if _is_int_id(i))
        yield from heapq.merge(
            overlay_ints, range(self.block_start, self.block_stop)
        )
        yield from sorted(
            (i for i in self.rows if not _is_int_id(i)), key=str
        )

    def overlay_data_ids(self) -> list:
        """Overlay ids other than the metadata document."""
        return [i for i in self.rows if i != METADATA_ID]

    # --- block mutation -------------------------------------------------------
    def ensure_block_field(self, field: str) -> Column:
        if field == ROW_ID:
            raise KeyError("_id is not a block field")
        column = self.block_columns.get(field)
        if column is None:
            column = Column.pads(self.block_rows)
            self.block_columns[field] = column
            self.block_fields.append(field)
        return column

    def set_block_values(self, doc_id: int, new_values: dict) -> None:
        i = doc_id - self.block_start
        for field, value in new_values.items():
            if field == ROW_ID:
                continue
            column = self.ensure_block_field(field)
            self.block_columns[field] = column.set(i, value)

    def append_columns(
        self, columns: dict[str, Column], start_id: int
    ) -> None:
        num_new = len(next(iter(columns.values()))) if columns else 0
        if self.block_columns:
            if start_id != self.block_stop:
                if self.block_start <= start_id < self.block_stop:
                    # overlapping append: the chunk's ids already exist —
                    # a DUPLICATE-id condition (KeyError → wire 409), not
                    # a malformed request; the client's landed-ok retry
                    # machinery relies on the distinction to recognize a
                    # replayed chunk that already landed
                    raise KeyError(
                        f"duplicate _id {start_id!r} (block rows "
                        f"{self.block_start}..{self.block_stop - 1} exist)"
                    )
                raise ValueError(
                    f"columnar append must start at id {self.block_stop}, "
                    f"got {start_id}"
                )
        else:
            self.block_start = start_id
        for doc_id in range(start_id, start_id + num_new):
            if doc_id in self.rows:
                raise KeyError(f"duplicate _id {doc_id!r}")
        for field in columns:
            self.ensure_block_field(field)
        for field in list(self.block_columns):
            column = self.block_columns[field]
            incoming = columns.get(field)
            if incoming is not None:
                self.block_columns[field] = column.append_column(incoming)
            else:
                self.block_columns[field] = column.append_pads(num_new)


class InMemoryStore(DocumentStore):
    """Thread-safe in-process store with optional JSONL write-ahead log.

    Durability model: every mutation appends one JSON line to
    ``<data_dir>/wal.jsonl``; opening a store with the same ``data_dir``
    replays the log. ``compact()`` rewrites the log as a snapshot.
    Columnar payloads ride the WAL as base64-encoded typed buffers
    (``Column.to_json_record``), not per-value JSON.
    """

    def __init__(self, data_dir: Optional[str] = None, replicate: bool = False):
        self._lock = threading.RLock()
        self._collections: dict[str, _Collection] = {}
        # Store-wide rev sequence (see _Collection.rev), started at a
        # random per-boot base: revs are in-memory only, so a restarted
        # store would otherwise count from 1 again and could reissue a
        # rev that a client's device cache (core/devcache.py) still
        # holds for DIFFERENT pre-restart content. 48 random bits keep
        # collisions negligible while staying far under 2^53 (revs ride
        # JSON frames).
        import secrets

        self._rev_seq = itertools.count(secrets.randbits(48) + 1)
        self._wal = None
        # Replication: when enabled, every WAL record (as its serialized
        # JSON line) is also kept in an in-memory buffer so followers can
        # fetch the log over the wire (``wal_feed``). ``_wal_epoch``
        # bumps on every compaction — a follower whose offset belongs to
        # a previous epoch must resync from record 0 (the compacted
        # snapshot IS the new log prefix).
        self._wal_buffer: Optional[list[str]] = [] if replicate else None
        self._wal_epoch = 0
        # During a compaction, mutations are additionally captured here
        # so the snapshot being written can be completed with the
        # records that landed while it was serialized (see compact()).
        self._compact_side: Optional[list[str]] = None
        # Bumped by resync_apply: an in-flight compaction whose
        # generation no longer matches must ABANDON — its snapshot
        # predates the resync and publishing it would revert the log.
        self._compact_gen = 0
        # Out-of-core: RAM budget for column payloads (LO_SPILL_BYTES,
        # 0 disables); past it, cold blocks move to disk-backed
        # mappings under LO_SPILL_DIR (default <data_dir>/spill, or a
        # temp dir for pure in-memory stores). See _maybe_spill_locked.
        # lo: allow[LO305] per-store state, frozen at construction
        self._spill_budget = float(os.environ.get("LO_SPILL_BYTES", "8e9") or 0)
        # lo: allow[LO301,LO305] free-form path knob, no numeric domain
        explicit_spill_dir = os.environ.get("LO_SPILL_DIR")
        if explicit_spill_dir:
            # an operator-chosen directory may be shared between stores
            # (or hold unrelated files): take a per-STORE subdirectory
            # (pid + in-process sequence — a primary and follower in one
            # process must not overwrite each other's mapped files)
            # instead of claiming — and never cleaning — the root.
            # Stale subdirs from dead processes linger until the
            # operator clears them (spill files are process-lifetime
            # artifacts; the WAL is the durability story).
            self._spill_dir = os.path.join(
                explicit_spill_dir,
                f"store-{os.getpid()}-{next(_SPILL_DIR_SEQ)}",
            )
        else:
            self._spill_dir = (
                os.path.join(data_dir, "spill") if data_dir else None
            )
            if (
                self._spill_budget > 0
                and self._spill_dir
                and os.path.isdir(self._spill_dir)
            ):
                # OUR data_dir's spill folder: a previous process's
                # files there are garbage — reclaim at startup
                import shutil

                shutil.rmtree(self._spill_dir, ignore_errors=True)
        self._spill_seq = 0
        # collection → its unique spill folder (collision-proof even for
        # names that sanitize identically); dropped with the collection
        self._spill_folders: dict[str, str] = {}
        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            wal_path = os.path.join(data_dir, "wal.jsonl")
            # construction is single-threaded, but the replay runs the
            # same _locked helpers the live mutators use — hold the
            # (reentrant) lock so their caller-holds-the-lock contract
            # is true at every call site
            with self._lock:
                if os.path.exists(wal_path):
                    self._replay_locked(wal_path)
                self._wal = open(wal_path, "a", encoding="utf-8")

    # --- WAL ------------------------------------------------------------------
    def _wal_enabled_locked(self) -> bool:
        return self._wal is not None or self._wal_buffer is not None

    def _log_locked(self, record: dict) -> None:
        if self._wal is None and self._wal_buffer is None:
            return
        line = json.dumps(record)
        if self._wal is not None:
            self._wal.write(line + "\n")
            self._wal.flush()
        if self._wal_buffer is not None:
            self._wal_buffer.append(line)
        if self._compact_side is not None:
            self._compact_side.append(line)

    def _replay_locked(self, wal_path: str) -> None:
        with open(wal_path, encoding="utf-8") as handle:
            for line in handle:
                line = line.strip()
                if not line:
                    continue
                self._apply_record_locked(json.loads(line))
                if self._wal_buffer is not None:
                    self._wal_buffer.append(line)

    def _apply_record_locked(self, record: dict) -> None:
        """Apply one WAL record (caller holds the lock; no logging) —
        the single switch shared by startup replay and follower
        replication."""
        op = record["op"]
        if op == "insert":
            self._apply_insert_locked(record["c"], record["d"])
        elif op == "insert_many":
            for document in record["d"]:
                self._apply_insert_locked(record["c"], document)
        elif op == "insert_cols_b":
            self._apply_insert_columns_locked(
                record["c"],
                {
                    field: Column.from_json_record(col)
                    for field, col in record["cols"].items()
                },
                record["s"],
            )
        elif op == "insert_cols":
            # legacy list form (pre-typed-block WALs)
            self._apply_insert_columns_locked(
                record["c"],
                _legacy_columns(record["d"], record.get("m")),
                record["s"],
            )
        elif op == "update":
            self._apply_update_locked(record["c"], record["q"], record["v"])
        elif op == "set_field":
            # Logged as [id, value] pairs so JSON preserves the
            # id's type (dict keys would stringify int ids).
            self._apply_set_field_locked(record["c"], record["f"], dict(record["d"]))
        elif op == "set_col_b":
            self._apply_set_column_locked(
                record["c"],
                record["f"],
                Column.from_json_record(record["col"]),
                record["s"],
            )
        elif op == "set_col":
            self._apply_set_column_locked(
                record["c"],
                record["f"],
                Column.from_values(record["d"]),
                record["s"],
            )
        elif op == "trim":
            self._apply_trim_locked(record["c"], record["n"])
        elif op == "create":
            self._collections.setdefault(record["c"], _Collection())
        elif op == "drop":
            self._collections.pop(record["c"], None)
            # replicated/replayed drops must reclaim spill files too:
            # a follower applying a primary's drop through this switch
            # used to strand the folder AND mis-route a recreated
            # same-name collection into it (stale mapping via
            # _maybe_spill_locked's setdefault) — the drop() entry point below
            # cleaned up, this one didn't (ADVICE r5 class)
            self._drop_spill_folder_locked(record["c"])
        elif op == "epoch":
            # Epoch is part of the log so it survives restarts: a
            # follower cursor is only valid against the SAME log, and a
            # primary that compacted then rebooted must not hand out its
            # pre-compaction epoch (stale cursors would silently apply
            # the wrong suffix).
            self._wal_epoch = record["e"]

    # --- replication ----------------------------------------------------------
    @property
    def wal_length(self) -> int:
        """Records in the replication feed (0 when replication is off)."""
        with self._lock:
            return len(self._wal_buffer or ())

    @property
    def wal_epoch(self) -> int:
        """Current feed epoch (bumps on compaction)."""
        with self._lock:
            return self._wal_epoch

    @property
    def wal_position(self) -> tuple[int, int]:
        """``(epoch, length)`` under ONE lock acquisition — the
        sync-repl ack wait must capture both atomically or a compaction
        between two reads pairs a stale epoch with the new epoch's tiny
        length and falsely satisfies the wait."""
        with self._lock:
            return self._wal_epoch, len(self._wal_buffer or ())

    @property
    def replicating(self) -> bool:
        """True when this store keeps the in-memory feed followers tail.
        Lock-free on purpose: _wal_buffer is bound once in __init__ (or
        swapped whole under the lock) and this is an identity check, so
        a torn read is impossible."""
        return self._wal_buffer is not None  # lo: allow[LO203]

    def wal_feed(self, epoch: int, offset: int, limit: int = 10000) -> dict:
        """Serialized WAL records from ``(epoch, offset)`` onward.

        Returns ``{"epoch", "offset", "next", "records", "resync"}`` with
        ``records`` as raw JSON lines. A stale epoch (the primary
        compacted since) or an impossible offset answers ``resync: True``
        with the current epoch — the follower clears and pulls from 0,
        where the compacted snapshot now lives.
        """
        with self._lock:
            if self._wal_buffer is None:
                raise ValueError("replication not enabled on this store")
            if epoch != self._wal_epoch or offset > len(self._wal_buffer):
                return {
                    "epoch": self._wal_epoch,
                    "offset": 0,
                    "next": 0,
                    "length": len(self._wal_buffer),
                    "records": [],
                    "resync": True,
                }
            records = self._wal_buffer[offset : offset + limit]
            return {
                "epoch": self._wal_epoch,
                "offset": offset,
                "next": offset + len(records),
                # total feed length: followers compute replication lag
                # (and the loss window of a takeover) from it
                "length": len(self._wal_buffer),
                "records": records,
                "resync": False,
            }

    def apply_replicated(self, lines: list[str]) -> None:
        """Follower-side ingestion: apply raw WAL lines from the primary
        and re-log them locally (the follower's own WAL/buffer make it
        promotable to primary with full durability)."""
        with self._lock:
            for line in lines:
                record = json.loads(line)
                self._apply_record_locked(record)
                self._log_locked(record)

    def resync_apply(self, lines: list[str]) -> None:
        """Replace ALL state with the given WAL lines (stale-epoch
        resync): the new log is written to a temp file and
        ``os.replace``d over the local WAL FIRST, then memory is rebuilt
        from it — the durable copy is never empty, so a crash at any
        point leaves either the old replica state or the new snapshot,
        never nothing."""
        with self._lock:
            # Invalidate any in-flight compaction: its snapshot views
            # predate this resync and MUST NOT be published over the
            # resynced log (compact() checks the generation before its
            # buffer/file swaps and abandons).
            self._compact_gen += 1
            self._compact_side = None
            if self._wal is not None:
                path = self._wal.name
                tmp_path = path + ".resync.tmp"
                with open(tmp_path, "w", encoding="utf-8") as handle:
                    handle.write("\n".join(lines) + ("\n" if lines else ""))
                    handle.flush()
                    os.fsync(handle.fileno())
                self._wal.close()
                try:
                    os.replace(tmp_path, path)
                finally:
                    self._wal = open(path, "a", encoding="utf-8")
            self._collections.clear()
            # The cleared collections' spill files are dead weight after
            # a resync (the rebuilt columns are resident); leaving the
            # folder mappings would also mis-route a NEW collection of
            # the same name into a folder full of stale files. rmtree
            # and forget them — every follower resync used to leak both.
            if self._spill_folders:
                import shutil

                for folder in self._spill_folders.values():
                    shutil.rmtree(folder, ignore_errors=True)
                self._spill_folders.clear()
            if self._wal_buffer is not None:
                self._wal_buffer[:] = list(lines)
            for line in lines:
                self._apply_record_locked(json.loads(line))

    def compact(self) -> bool:
        """Rewrite the WAL as a snapshot — WITHOUT stalling the world.
        Returns True when THIS call durably published a snapshot; False
        when it was skipped (another compaction in flight) or abandoned
        (a replication resync superseded the snapshot mid-write) —
        callers that need an on-return durability guarantee must check.

        The expensive work (serializing every block to base64 lines,
        writing + fsyncing the snapshot file) happens OUTSIDE the store
        lock against copy-on-write column snapshots; concurrent
        mutations keep flowing and are captured on a side log
        (``_compact_side``) that completes the snapshot before the
        atomic rename. The lock is held only for O(collections)
        snapshotting and list swaps — at 100M rows the old
        serialize-under-lock design was a multi-second outage for every
        reader and writer.

        Crash-safe: the snapshot is written to a temp file and
        ``os.replace``d over ``wal.jsonl`` only after its suffix is
        fsynced, so a failure at any point leaves the old log intact.
        Typed blocks serialize as base64 buffer records — null masks and
        missing-pad masks ride along explicitly (JSON has no
        missing/null distinction to round-trip).
        """
        # Phase A (locked, O(collections)): consistent snapshot views +
        # start capturing concurrent mutations.
        with self._lock:
            if self._wal is None and self._wal_buffer is None:
                return False
            if self._compact_side is not None:
                return False  # a compaction is already in flight
            views = {
                name: col.snapshot()
                for name, col in self._collections.items()
            }
            self._compact_side = []
            gen = self._compact_gen

        # Phase B (unlocked): the expensive serialization.
        try:
            body = [
                json.dumps(record)
                for record in self._snapshot_records_of(views)
            ]
        except BaseException:
            # Deliberate split-phase mutation of _compact_side: the
            # whole method is the generation-guarded compaction
            # protocol (phases A–E documented above), and every
            # re-acquisition re-checks _compact_gen before touching it.
            with self._lock:  # lo: allow[LO205]
                self._compact_side = None
            raise

        # Phase C (locked, O(1)-ish): freeze the new log identity. The
        # epoch record + body + captured suffix ARE the new log; the
        # in-memory feed switches now (followers on the old epoch
        # resync via wal_feed), while capture continues for the records
        # that land during the file write.
        with self._lock:
            if self._compact_gen != gen:
                return False  # a resync superseded this snapshot
            new_epoch = self._wal_epoch + 1
            lines = [json.dumps({"op": "epoch", "e": new_epoch})]
            lines.extend(body)
            lines.extend(self._compact_side)
            self._compact_side = []
            if self._wal_buffer is not None:
                self._wal_buffer[:] = lines
            self._wal_epoch = new_epoch
            if self._wal is None:
                self._compact_side = None
                return True
            path = self._wal.name

        # Phase D (unlocked): write + fsync the snapshot file.
        tmp_path = path + ".compact.tmp"
        try:
            with open(tmp_path, "w", encoding="utf-8") as handle:
                for line in lines:
                    handle.write(line + "\n")
                handle.flush()
                os.fsync(handle.fileno())  # data durable before rename

            # Phase E (locked): drain the last captured suffix into the
            # snapshot file, then atomically publish it.
            with self._lock:
                if self._compact_gen != gen:
                    # resync landed during the file write: ITS log is
                    # the truth now — discard this snapshot entirely
                    try:
                        os.remove(tmp_path)
                    except OSError:
                        pass
                    return False
                side = self._compact_side or []
                self._compact_side = None
                if side:
                    with open(tmp_path, "a", encoding="utf-8") as handle:
                        for line in side:
                            handle.write(line + "\n")
                        handle.flush()
                        os.fsync(handle.fileno())
                self._wal.close()
                try:
                    os.replace(tmp_path, path)
                    directory_fd = os.open(
                        os.path.dirname(path) or ".", os.O_RDONLY
                    )
                    try:
                        os.fsync(directory_fd)  # make the rename durable
                    finally:
                        os.close(directory_fd)
                finally:
                    # Reopen whichever file now lives at `path` so later
                    # writes never hit a closed handle.
                    self._wal = open(path, "a", encoding="utf-8")
        except BaseException:
            with self._lock:
                self._compact_side = None
            try:
                os.remove(tmp_path)
            except OSError:
                pass
            raise
        return True

    def _snapshot_records_of(
        self, collections: dict[str, "_Collection"]
    ) -> Iterator[dict]:
        """State as a minimal WAL record sequence — the body of a
        compacted log (and, under replication, of a new epoch)."""
        for name, col in collections.items():
            yield {"op": "create", "c": name}
            if col.block_columns:
                yield {
                    "op": "insert_cols_b",
                    "c": name,
                    "s": col.block_start,
                    "cols": {
                        field: column.to_json_record()
                        for field, column in col.block_columns.items()
                    },
                }
            if col.rows:
                yield {"op": "insert_many", "c": name, "d": list(col.rows.values())}

    # --- primitive ops (caller holds the lock; no logging) --------------------
    # The _locked suffix is the analyzer-checked contract (LO203,
    # docs/analysis.md): these touch guarded state and must only be
    # called with self._lock held.
    def _apply_insert_locked(self, collection: str, document: dict) -> None:
        col = self._collections.setdefault(collection, _Collection())
        doc_id = document.get(ROW_ID)
        if doc_id is None:
            doc_id = col.next_id()
            document = dict(document)
            document[ROW_ID] = doc_id
        if col.has_id(doc_id):
            raise KeyError(f"duplicate _id {doc_id!r} in {collection!r}")
        col.rows[doc_id] = dict(document)
        col.rev = next(self._rev_seq)

    def _apply_insert_columns_locked(
        self,
        collection: str,
        columns: dict[str, Column],
        start_id: int,
    ) -> None:
        col = self._collections.setdefault(collection, _Collection())
        col.append_columns(columns, start_id)
        col.rev = next(self._rev_seq)
        try:
            self._maybe_spill_locked()
        except OSError as error:
            self._disable_spill_locked(error)

    def _disable_spill_locked(self, error: OSError) -> None:
        """Spilling is an optimization; an unwritable/full spill disk
        must not fail the mutation that triggered it (the rows ARE
        applied, and the caller still writes the WAL record — aborting
        would leave memory ahead of the log). Disabled loudly so an
        operator can see why LO_SPILL_BYTES stopped being honored."""
        import sys

        print(
            f"store: spill failed, staying in RAM from here on: {error}",
            file=sys.stderr,
            flush=True,
        )
        self._spill_budget = 0.0  # stop retrying every batch

    # --- out-of-core spill ----------------------------------------------------
    def _ensure_spill_dir(self) -> str:
        if self._spill_dir is None:
            import atexit
            import shutil
            import tempfile

            self._spill_dir = tempfile.mkdtemp(prefix="lo_spill_")
            # a pure in-memory store's spill files have no meaning past
            # the process (durability is the WAL's job when configured)
            atexit.register(
                shutil.rmtree, self._spill_dir, ignore_errors=True
            )
        return self._spill_dir

    def _maybe_spill_locked(self) -> None:
        """Under the store lock: when anonymous-RAM column bytes exceed
        ``LO_SPILL_BYTES``, move the largest column payloads to
        disk-backed mappings (``Column.spill_to``) — the Mongo-owns-disk
        property (reference docker-compose.yml:335-340): the store's
        ceiling becomes disk, with RAM as a bounded working set. Spilled
        columns keep streaming appends straight to their files, so bulk
        ingestion past the budget never re-materializes them; point
        mutations copy back to RAM and the stale file is reclaimed when
        the collection drops.

        Runs on the writer's thread under the store lock: concurrent
        readers wait out the spill write like any other mutation
        (bounded by one pass over the columns being spilled; a
        copy-then-swap outside the lock, like compaction's, is the
        escalation path if that stall ever matters)."""
        if self._spill_budget <= 0:
            return
        import time

        candidates = []
        spilled_columns = []
        resident = 0
        for name, col in self._collections.items():
            for field, column in col.block_columns.items():
                bytes_here = column.resident_nbytes()
                resident += bytes_here
                if column.is_spilled():
                    spilled_columns.append(column)
                elif bytes_here >= _SPILL_MIN_COLUMN_BYTES:
                    candidates.append((bytes_here, name, field, column))
        # release already-spilled columns' resident mapped pages (they
        # stay in the page cache) so RSS tracks the budget, not the
        # bytes the last scan happened to touch — rate-limited: each
        # sweep evicts pages concurrent scans just faulted in
        now = time.monotonic()
        if spilled_columns and (
            now - getattr(self, "_last_advise", 0.0) >= _ADVISE_INTERVAL_S
        ):
            self._last_advise = now
            for column in spilled_columns:
                column.advise_cold()
        if resident <= self._spill_budget:
            return
        candidates.sort(key=lambda entry: -entry[0])
        for bytes_here, name, field, column in candidates:
            self._spill_seq += 1
            folder = self._spill_folders.setdefault(
                name,
                os.path.join(
                    self._ensure_spill_dir(),
                    f"{_path_safe(name)}.{len(self._spill_folders)}",
                ),
            )
            released = column.spill_to(
                folder, f"{_path_safe(field)}.{self._spill_seq}"
            )
            resident -= released
            # hysteresis: stop well under budget so the next batch does
            # not immediately re-trigger a scan-and-spill
            if resident <= self._spill_budget * 0.75:
                break

    def _apply_update_locked(self, collection: str, query: dict, new_values: dict) -> None:
        col = self._collections.get(collection)
        if col is None:
            return
        col.rev = next(self._rev_seq)
        if list(query.keys()) == [ROW_ID] and (
            _is_int_id(query[ROW_ID]) or isinstance(query[ROW_ID], str)
        ):  # the dominant fast path: literal-id lookup
            doc_id = query[ROW_ID]
            if col.in_block(doc_id):
                col.set_block_values(doc_id, new_values)
            elif doc_id in col.rows:
                col.rows[doc_id].update(new_values)
            return
        for doc_id in col.iter_ids():
            if matches(col.document(doc_id), query):
                if col.in_block(doc_id):
                    col.set_block_values(doc_id, new_values)
                else:
                    col.rows[doc_id].update(new_values)
                return

    def _apply_set_field_locked(
        self, collection: str, field: str, values_by_id: dict
    ) -> None:
        col = self._collections.get(collection)
        if col is None:
            return
        col.rev = next(self._rev_seq)
        ensured = False
        for doc_id, value in values_by_id.items():
            if col.in_block(doc_id):
                if not ensured:
                    col.ensure_block_field(field)
                    ensured = True
                column = col.block_columns[field]
                col.block_columns[field] = column.set(
                    doc_id - col.block_start, value
                )
            elif doc_id in col.rows:
                col.rows[doc_id][field] = value

    def _apply_set_column_locked(
        self, collection: str, field: str, values: Column, start_id: int
    ) -> None:
        col = self._collections.get(collection)
        if col is None:
            return
        col.rev = next(self._rev_seq)
        # Whole-block replace: one column swap, no per-id work.
        if (
            col.block_columns
            and start_id == col.block_start
            and len(values) == col.block_rows
        ):
            col.ensure_block_field(field)
            col.block_columns[field] = values
            try:
                # bulk casts land whole replacement columns: give the
                # spill budget a chance (and advise cold mappings) so a
                # 100M-row fieldtypes pass doesn't accumulate every
                # converted column in RAM
                self._maybe_spill_locked()
            except OSError as error:
                self._disable_spill_locked(error)
            return
        self._apply_set_field_locked(
            collection,
            field,
            {
                start_id + i: value
                for i, value in enumerate(values.tolist(pad_as_none=False))
            },
        )

    # --- DocumentStore implementation -----------------------------------------
    def telemetry_stats(self) -> dict:
        """Occupancy for /metrics (telemetry.register_store): collection
        count, on-disk WAL bytes, and bytes currently spilled to
        disk-backed mappings. File sizes are read at scrape time — cheap
        next to a scrape interval, and always truthful after compaction
        or resync rewrites."""
        with self._lock:
            collections = len(self._collections)
            wal = self._wal
            folders = list(self._spill_folders.values())
        wal_bytes = 0
        if wal is not None:
            try:
                wal_bytes = os.fstat(wal.fileno()).st_size
            except (OSError, ValueError):  # closed mid-resync
                pass
        spill_bytes = 0
        for folder in folders:
            try:
                with os.scandir(folder) as entries:
                    for entry in entries:
                        try:
                            spill_bytes += entry.stat().st_size
                        except OSError:
                            continue
            except OSError:
                continue
        return {
            "collections": collections,
            "wal_bytes": wal_bytes,
            "spill_bytes": spill_bytes,
        }

    def list_collections(self) -> list[str]:
        with self._lock:
            return list(self._collections.keys())

    def create_collection(self, collection: str) -> bool:
        with self._lock:
            if collection in self._collections:
                return False
            self._collections[collection] = _Collection()
            self._log_locked({"op": "create", "c": collection})
            return True

    def _drop_spill_folder_locked(self, collection: str) -> None:
        """Reclaim a collection's spill files; memmaps still held by
        snapshots keep reads valid (POSIX unlink semantics) until the
        last reference dies."""
        folder = self._spill_folders.pop(collection, None)
        if folder is not None:
            import shutil

            shutil.rmtree(folder, ignore_errors=True)

    def drop(self, collection: str) -> None:
        with self._lock:
            self._collections.pop(collection, None)
            self._log_locked({"op": "drop", "c": collection})
            self._drop_spill_folder_locked(collection)

    def _apply_trim_locked(self, collection: str, max_docs: int) -> int:
        col = self._collections.get(collection)
        if col is None:
            return 0
        data_ids = sorted(
            doc_id
            for doc_id in col.rows
            if doc_id != METADATA_ID and _is_int_id(doc_id)
        )
        excess = len(data_ids) - max_docs
        if excess <= 0:
            return 0
        for doc_id in data_ids[:excess]:
            del col.rows[doc_id]
        col.rev = next(self._rev_seq)
        return excess

    def trim_collection(self, collection: str, max_docs: int) -> int:
        if isinstance(max_docs, bool) or not isinstance(max_docs, int):
            raise ValueError(f"max_docs must be an integer, got {max_docs!r}")
        if max_docs < 0:
            raise ValueError(f"max_docs must be >= 0, got {max_docs}")
        with self._lock:
            removed = self._apply_trim_locked(collection, max_docs)
            if removed:
                # The WAL logs the CAP, not the removed ids: replay and
                # follower replication re-derive the same eviction from
                # the same state (oldest-first is deterministic).
                self._log_locked(
                    {"op": "trim", "c": collection, "n": max_docs}
                )
            return removed

    def insert_one(self, collection: str, document: dict) -> None:
        with self._lock:
            self._apply_insert_locked(collection, document)
            self._log_locked({"op": "insert", "c": collection, "d": document})

    def insert_many(self, collection: str, documents: list[dict]) -> None:
        with self._lock:
            # Validate the whole batch before applying anything so a
            # duplicate-_id failure can't leave the in-memory state and
            # the WAL divergent (all-or-nothing).
            col = self._collections.get(collection) or _Collection()
            seen: set = set()
            for document in documents:
                doc_id = document.get(ROW_ID)
                if doc_id is None:
                    continue  # auto-assigned at apply time, cannot collide
                if col.has_id(doc_id) or doc_id in seen:
                    raise KeyError(f"duplicate _id {doc_id!r} in {collection!r}")
                seen.add(doc_id)
            for document in documents:
                self._apply_insert_locked(collection, document)
            self._log_locked({"op": "insert_many", "c": collection, "d": documents})

    def insert_columns(
        self,
        collection: str,
        columns: dict[str, ColumnInput],
        start_id: Optional[int] = None,
    ) -> None:
        if ROW_ID in columns:
            raise ValueError("_id is implicit in insert_columns (start_id..)")
        typed = {name: as_column(values) for name, values in columns.items()}
        lengths = {len(values) for values in typed.values()}
        if len(lengths) > 1:
            raise ValueError("ragged columns")
        with self._lock:
            col = self._collections.get(collection) or _Collection()
            if start_id is None:
                start_id = col.block_stop if col.block_columns else 1
            # append_columns validates contiguity + overlay collisions
            self._apply_insert_columns_locked(collection, typed, start_id)
            if self._wal_enabled_locked():  # base64 encode only when a log exists
                self._log_locked(
                    {
                        "op": "insert_cols_b",
                        "c": collection,
                        "s": start_id,
                        "cols": {
                            field: column.to_json_record()
                            for field, column in typed.items()
                        },
                    }
                )

    def insert_column_arrays(
        self,
        collection: str,
        columns: dict[str, Column],
        start_id: Optional[int] = None,
    ) -> None:
        self.insert_columns(collection, columns, start_id=start_id)

    def update_one(self, collection: str, query: dict, new_values: dict) -> None:
        with self._lock:
            self._apply_update_locked(collection, query, new_values)
            self._log_locked({"op": "update", "c": collection, "q": query, "v": new_values})

    def set_field_values(
        self, collection: str, field: str, values_by_id: dict
    ) -> None:
        with self._lock:
            self._apply_set_field_locked(collection, field, values_by_id)
            self._log_locked(
                {
                    "op": "set_field",
                    "c": collection,
                    "f": field,
                    "d": list(values_by_id.items()),
                }
            )

    def set_column(
        self,
        collection: str,
        field: str,
        values: ColumnInput,
        start_id: int = 1,
    ) -> None:
        typed = as_column(values)
        with self._lock:
            self._apply_set_column_locked(collection, field, typed, start_id)
            if self._wal_enabled_locked():
                self._log_locked(
                    {
                        "op": "set_col_b",
                        "c": collection,
                        "f": field,
                        "s": start_id,
                        "col": typed.to_json_record(),
                    }
                )

    def find(
        self,
        collection: str,
        query: Optional[dict] = None,
        skip: int = 0,
        limit: Optional[int] = None,
    ) -> Iterator[dict]:
        query = query or {}
        with self._lock:
            col = self._collections.get(collection)
            if col is None:
                return iter(())
            # Literal-id point lookup (the poll loop's shape: metadata
            # reads every few seconds) — synthesize ONE document under
            # the lock, no snapshot of the whole collection.
            if (
                list(query.keys()) == [ROW_ID]
                and not isinstance(query[ROW_ID], dict)
                and skip == 0
            ):
                doc_id = query[ROW_ID]
                if col.has_id(doc_id):
                    document = col.document(doc_id)
                    return iter(() if limit == 0 else (document,))
                return iter(())
            # Snapshot under the lock (cheap: copy-on-write columns,
            # copied overlay dicts), synthesize row dicts outside it —
            # an unlimited find over a large block never holds the store
            # lock for O(rows) dict building.
            view = col.snapshot()

        def generate() -> Iterator[dict]:
            produced = 0
            skipped = 0
            for doc_id in view.iter_ids():
                document = view.document(doc_id)
                if not matches(document, query):
                    continue
                if skipped < skip:
                    skipped += 1
                    continue
                if limit is not None and produced >= limit:
                    return
                produced += 1
                yield document

        return generate()

    def count(self, collection: str) -> int:
        with self._lock:
            col = self._collections.get(collection)
            if col is None:
                return 0
            return col.block_rows + len(col.rows)

    def collection_rev(self, collection: str) -> int:
        """Mutation counter for torn-read detection on paged wire reads."""
        with self._lock:
            col = self._collections.get(collection)
            return -1 if col is None else col.rev

    def collection_block_rows(self, collection: str) -> int:
        with self._lock:
            col = self._collections.get(collection)
            return -1 if col is None else col.block_rows

    def aggregate(self, collection: str, pipeline: list[dict]) -> list[dict]:
        # Columnar fast path: the histogram's value-count $group runs
        # straight over the typed block column — np.unique / Counter in
        # C, no row synthesis (the on-store analogue of the reference's
        # Mongo-server $group pushdown, histogram.py:63-69).
        with self._lock:
            col = self._collections.get(collection)
            if (
                col is not None
                and len(pipeline) == 1
                and "$group" in pipeline[0]
                and not col.overlay_data_ids()
            ):
                key_expr = pipeline[0]["$group"].get("_id")
                if isinstance(key_expr, str) and key_expr.startswith("$"):
                    field = key_expr[1:]
                    if field == ROW_ID:
                        return [
                            {"_id": doc_id, "count": 1}
                            for doc_id in range(col.block_start, col.block_stop)
                        ]
                    column = col.block_columns.get(field)
                    if column is None:
                        return (
                            [{"_id": None, "count": col.block_rows}]
                            if col.block_rows
                            else []
                        )
                    column = column.snapshot()
                else:
                    column = None
            else:
                column = None
        if column is not None:
            return column.unique_counts()
        results: list[dict] = list(self.find(collection))
        for stage in pipeline:
            if "$match" in stage:
                results = [doc for doc in results if matches(doc, stage["$match"])]
            elif "$group" in stage:
                group = stage["$group"]
                key_expr = group.get("_id")
                if not (isinstance(key_expr, str) and key_expr.startswith("$")):
                    raise NotImplementedError(f"unsupported $group key {key_expr!r}")
                results = _group_count(iter(results), key_expr[1:])
            else:
                raise NotImplementedError(f"unsupported pipeline stage {stage}")
        return results

    def read_columns(
        self,
        collection: str,
        fields: Optional[list[str]] = None,
        start: int = 0,
        limit: Optional[int] = None,
    ) -> dict[str, list]:
        arrays = self.read_column_arrays(collection, fields, start, limit)
        return {name: column.tolist() for name, column in arrays.items()}

    def read_column_arrays(
        self,
        collection: str,
        fields: Optional[list[str]] = None,
        start: int = 0,
        limit: Optional[int] = None,
    ) -> dict[str, Column]:
        return self.read_column_arrays_rev(collection, fields, start, limit)[0]

    def read_column_arrays_rev(
        self,
        collection: str,
        fields: Optional[list[str]] = None,
        start: int = 0,
        limit: Optional[int] = None,
    ) -> tuple[dict[str, Column], int]:
        """``(columns, rev)`` with the rev captured under the SAME lock
        acquisition as the read — a write can never land between the
        data and its reported rev, so equal revs across paged chunks
        prove no tear."""
        with self._lock:
            col = self._collections.get(collection)
            if col is None:
                return (
                    {field: Column() for field in fields} if fields else {}
                ), -1
            rev = col.rev
            if not col.overlay_data_ids():
                # Pure-block dataset: hand back copy-on-write column
                # slices directly — a paged read costs O(chunk) for
                # strings and O(1) for numeric kinds, never O(rows).
                stop = (
                    col.block_rows
                    if limit is None
                    else min(start + limit, col.block_rows)
                )
                names = fields if fields is not None else list(col.block_fields)
                out: dict[str, Column] = {}
                for name in names:
                    if name == ROW_ID:
                        out[name] = Column.from_numpy(
                            np.arange(
                                col.block_start + start,
                                col.block_start + stop,
                                dtype=np.int64,
                            )
                        )
                    elif name in col.block_columns:
                        out[name] = col.block_columns[name].slice(start, stop)
                    else:
                        pads = Column(
                            "empty"
                        )
                        pads.size = max(stop - start, 0)
                        pads.data = np.zeros(pads.size, dtype=np.uint8)
                        if pads.size:
                            pads.none = np.ones(pads.size, dtype=bool)
                        out[name] = pads
                return out, rev
            # Mixed block + overlay rows: page over the merged id order,
            # synthesizing row dicts ONLY for the requested slice — a
            # paged read costs O(ids + chunk), never O(rows) dict
            # synthesis per chunk (the wire loop would otherwise go
            # quadratic on a block dataset with one stray overlay row).
            view = col.snapshot()
        data_ids = [
            doc_id for doc_id in view.iter_ids() if doc_id != METADATA_ID
        ]
        if fields is None:
            names = [f for f in view.block_fields if f != ROW_ID]
            seen = set(names)
            for doc_id in data_ids:
                if doc_id in view.rows:
                    for key in view.rows[doc_id]:
                        if key != ROW_ID and key not in seen:
                            seen.add(key)
                            names.append(key)
            fields = names
        stop_index = None if limit is None else start + limit
        lists: dict[str, list] = {field: [] for field in fields}
        for doc_id in data_ids[start:stop_index]:
            document = view.document(doc_id)
            for field in fields:
                lists[field].append(document.get(field))
        return {
            field: Column.from_values(values) for field, values in lists.items()
        }, rev


def _legacy_columns(
    raw: dict[str, list], missing: Optional[dict]
) -> dict[str, Column]:
    """Decode a legacy list-form ``insert_cols`` WAL record (with its
    optional missing-index mask) into typed columns."""
    out: dict[str, Column] = {}
    for field, values in raw.items():
        indices = set((missing or {}).get(field, ()))
        if indices:
            values = [
                _MISSING if i in indices else v for i, v in enumerate(values)
            ]
        out[field] = Column.from_values(values)
    return out


_GLOBAL_STORE: Optional[InMemoryStore] = None
_GLOBAL_LOCK = threading.Lock()


def global_store() -> InMemoryStore:
    """Process-wide shared store (single-process deployments and tests)."""
    global _GLOBAL_STORE
    with _GLOBAL_LOCK:
        if _GLOBAL_STORE is None:
            _GLOBAL_STORE = InMemoryStore()
        return _GLOBAL_STORE


def reset_global_store() -> None:
    global _GLOBAL_STORE
    with _GLOBAL_LOCK:
        _GLOBAL_STORE = None
