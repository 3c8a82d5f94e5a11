"""``ShardedStore``: one DocumentStore over N shard groups.

The client half of horizontal sharding (core/shardmap.py holds the
placement math and the shard-map service contract; docs/dataplane.md
the operator story). Each child store is one shard GROUP — in
production a :class:`~learningorchestra_tpu_torch.core.store_service.
RemoteStore` whose URL list names the group's primary and follower, so
every group keeps the replicated-failover machinery untouched; in
tests the children can be plain :class:`~learningorchestra_tpu_torch.core.
store.InMemoryStore` instances.

Routing contract:

- **Columnar block rows** are striped across ALL groups by the
  consistent-hash layout; ids are translated global↔local so each
  group's block stays dense from local id 1 (the block-append
  contiguity invariant holds per group — which is also why sharded
  blocks must start at global id 1, the only start the system writes).
- **Row documents** (the ``_id: 0`` metadata document, out-of-band
  inserts, ring collections, the scheduler journal) all live on the
  META group (group 0) with their GLOBAL ids — document collections
  behave byte-identically to the unsharded store.
- **Reads scatter-gather**: a positional columnar read decomposes into
  ONE contiguous per-group run, fetched concurrently (each group's
  RemoteStore brings its own paged prefetch, zero-copy wire-v2 decode,
  and shm ring), then reassembled stripe-by-stripe in global order.
  Cross-group reads are not atomic — the same cursor guarantee the
  unsharded paged read already gives under concurrent writes.
- **Ordering**: block rows sort before overlay documents. Overlay int
  ids are always past the block (the block-append duplicate guard
  enforces it), so the merged stream matches the unsharded ``_id``
  order for every collection the system writes.

``connect()`` (core/store_service.py) builds one of these when
``LO_STORE_URL`` lists shard groups separated by ``;`` — a single
group degenerates to a plain ``RemoteStore``, keeping the default
wire path byte-identical to the unsharded deployment.

The port's copy of ``learningorchestra_tpu/core/shardstore.py``: the
same code over the port's store, columns and shard map.
"""

from __future__ import annotations

import heapq
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional

import numpy as np

from learningorchestra_tpu_torch.core import shardmap as _shardmap
from learningorchestra_tpu_torch.core.columns import Column
from learningorchestra_tpu_torch.core.shardmap import ShardMapClient
from learningorchestra_tpu_torch.core.store import (
    METADATA_ID,
    ROW_ID,
    ColumnInput,
    DocumentStore,
    _group_count,
    _is_int_id,
    as_column,
    matches,
)


def _query_mentions_id(query: dict) -> bool:
    """True when the query constrains ``_id`` anywhere — such a query
    cannot be pushed down to a shard, whose block ids are local."""
    for key, condition in query.items():
        if key == ROW_ID:
            return True
        if key in ("$or", "$and", "$nor") and isinstance(
            condition, (list, tuple)
        ):
            if any(
                isinstance(sub, dict) and _query_mentions_id(sub)
                for sub in condition
            ):
                return True
    return False


def _id_sort_key(doc_id: Any) -> tuple:
    """The unsharded store's id order: ints ascending, then everything
    else by string."""
    if _is_int_id(doc_id):
        return (0, doc_id, "")
    return (1, 0, str(doc_id))


def _slice_concat(column: Column, segments: list[tuple[int, int]]) -> Column:
    """Concatenate ``column``'s ``[offset, offset+count)`` slices — the
    per-shard payload of a decomposed global range (slices of numeric
    kinds are O(1) views, so this never copies the source block)."""
    offset, count = segments[0]
    out = column.slice(offset, offset + count)
    for offset, count in segments[1:]:
        out = out.append_column(column.slice(offset, offset + count))
    return out


def _occupancy_of(group) -> dict:
    """A group's occupancy dict, whichever store kind it is: remote
    groups expose ``occupancy_stats`` (the /health surface), local ones
    ``telemetry_stats``."""
    for accessor in ("occupancy_stats", "telemetry_stats"):
        probe = getattr(group, accessor, None)
        if probe is not None:
            try:
                stats = probe()
            except Exception:
                return {}
            return stats if isinstance(stats, dict) else {}
    return {}


class ShardedStore(DocumentStore):
    """Scatter-gather DocumentStore over shard groups (group 0 = meta)."""

    def __init__(
        self,
        groups: list,
        stripe_rows: Optional[int] = None,
        map_ttl_s: Optional[float] = None,
    ):
        if not groups:
            raise ValueError("ShardedStore needs at least one group")
        self.groups = list(groups)
        self.shards = len(self.groups)
        configured_stripe = (
            _shardmap.stripe_rows() if stripe_rows is None else stripe_rows
        )
        self._map = ShardMapClient(
            self.groups[0], self.shards, configured_stripe, ttl_s=map_ttl_s
        )
        # devcache scope dimension: a topology change must invalidate
        # every cached entry (core/devcache.py store_token)
        self.shard_signature = f"sh{self.shards}x{configured_stripe}"
        # scatter-gather fan-out observer; telemetry/metrics.py
        # register_sharded_store points this at its histogram
        self.on_fanout = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()

    # --- plumbing -------------------------------------------------------------
    @property
    def _meta(self):
        return self.groups[0]

    def layout(self) -> _shardmap.ShardLayout:
        layout = self._map.layout()
        self.shard_signature = f"sh{layout.shards}x{layout.stripe_rows}"
        return layout

    def shardmap_rev(self) -> int:
        """Last observed shard-map collection rev (telemetry surface)."""
        return self._map.rev

    def shard_occupancy(self) -> list[dict]:
        """Per-group occupancy dicts, meta group first (telemetry)."""
        return self._scatter(
            [(lambda g=group: _occupancy_of(g)) for group in self.groups]
        )

    def _executor(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.shards, thread_name_prefix="lo-shard"
                )
            return self._pool

    def _scatter(self, calls: list) -> list:
        """Run thunks concurrently (one per group at most); a single
        call runs inline with no pool round-trip."""
        if len(calls) == 1:
            return [calls[0]()]
        futures = [self._executor().submit(call) for call in calls]
        results: list = []
        first_error: Optional[BaseException] = None
        for future in futures:
            try:
                results.append(future.result())
            except BaseException as error:  # noqa: BLE001 — re-raised
                results.append(None)
                if first_error is None:
                    first_error = error
        if first_error is not None:
            raise first_error
        return results

    def _observe_fanout(self, width: int) -> None:
        hook = self.on_fanout
        if hook is not None:
            hook(width)

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            # outside the lock: shutdown joins no threads (wait=False)
            # but even the teardown handshake must not park a
            # concurrent _executor() caller on the lock
            pool.shutdown(wait=False)
        for group in self.groups:
            close = getattr(group, "close", None)
            if close is not None:
                close()

    @staticmethod
    def _block_rows_of(group, collection: str) -> int:
        probe = getattr(group, "collection_block_rows", None)
        if probe is None:
            return 0
        return max(0, probe(collection))

    def _group_block_rows(self, collection: str) -> list[int]:
        """Per-group block row counts (one concurrent probe sweep)."""
        return self._scatter(
            [
                (lambda g=group: self._block_rows_of(g, collection))
                for group in self.groups
            ]
        )

    # --- collection lifecycle -------------------------------------------------
    def list_collections(self) -> list[str]:
        names: list[str] = []
        for listed in self._scatter(
            [group.list_collections for group in self.groups]
        ):
            for name in listed:
                if name not in names:
                    names.append(name)
        return names

    def create_collection(self, collection: str) -> bool:
        # the meta group is the claim authority (atomic winner); data
        # groups follow idempotently — a lost race there just means a
        # concurrent creator already materialized the shard
        won = self._meta.create_collection(collection)
        if won:
            for group in self.groups[1:]:
                group.create_collection(collection)
        return won

    def drop(self, collection: str) -> None:
        self._scatter(
            [(lambda g=group: g.drop(collection)) for group in self.groups]
        )

    def trim_collection(self, collection: str, max_docs: int) -> int:
        # rings are row-document collections: meta-group only
        return self._meta.trim_collection(collection, max_docs)

    # --- writes ---------------------------------------------------------------
    def insert_one(self, collection: str, document: dict) -> None:
        self._meta.insert_one(collection, document)

    def insert_many(self, collection: str, documents: list[dict]) -> None:
        self._meta.insert_many(collection, documents)

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
        self.insert_column_arrays(collection, typed, start_id=start_id)

    def insert_column_arrays(
        self,
        collection: str,
        columns: dict[str, Column],
        start_id: Optional[int] = None,
    ) -> None:
        if self.shards == 1:
            self._meta.insert_column_arrays(collection, columns, start_id)
            return
        layout = self.layout()
        rows = len(next(iter(columns.values()))) if columns else 0
        if start_id is None:
            # the global append position: one past the striped block
            start_id = 1 + sum(self._group_block_rows(collection))
        if rows == 0:
            self._meta.insert_column_arrays(collection, columns, start_id)
            return
        runs = layout.decompose(start_id, rows)
        self._observe_fanout(len(runs))

        def write(run: dict) -> None:
            payload = {
                name: _slice_concat(column, run["segments"])
                for name, column in columns.items()
            }
            self.groups[run["shard"]].insert_column_arrays(
                collection, payload, start_id=run["local_start"]
            )

        self._scatter([(lambda r=run: write(r)) for run in runs])

    def set_column(
        self,
        collection: str,
        field: str,
        values: ColumnInput,
        start_id: int = 1,
    ) -> None:
        if self.shards == 1:
            self._meta.set_column(collection, field, values, start_id)
            return
        typed = as_column(values)
        runs = self.layout().decompose(start_id, len(typed))
        if not runs:
            return
        self._observe_fanout(len(runs))

        def write(run: dict) -> None:
            self.groups[run["shard"]].set_column(
                collection,
                field,
                _slice_concat(typed, run["segments"]),
                start_id=run["local_start"],
            )

        self._scatter([(lambda r=run: write(r)) for run in runs])

    def set_field_values(
        self, collection: str, field: str, values_by_id: dict
    ) -> None:
        if self.shards == 1:
            self._meta.set_field_values(collection, field, values_by_id)
            return
        layout = self.layout()
        block_stop = 1 + sum(self._group_block_rows(collection))
        per_target: dict[int, dict] = {}
        for doc_id, value in values_by_id.items():
            if _is_int_id(doc_id) and 1 <= doc_id < block_stop:
                shard, local = layout.global_to_local(doc_id)
                per_target.setdefault(shard, {})[local] = value
            else:  # metadata / overlay / non-int ids live on meta
                per_target.setdefault(-1, {})[doc_id] = value
        if not per_target:
            return
        self._observe_fanout(len(per_target))

        def write(shard: int, batch: dict) -> None:
            target = self._meta if shard == -1 else self.groups[shard]
            target.set_field_values(collection, field, batch)

        self._scatter(
            [
                (lambda s=shard, b=batch: write(s, b))
                for shard, batch in per_target.items()
            ]
        )

    def update_one(
        self, collection: str, query: dict, new_values: dict
    ) -> None:
        if self.shards == 1:
            self._meta.update_one(collection, query, new_values)
            return
        if list(query.keys()) == [ROW_ID] and not isinstance(
            query[ROW_ID], dict
        ):
            doc_id = query[ROW_ID]
        else:
            found = self.find_one(collection, query)
            if found is None:
                return
            doc_id = found.get(ROW_ID)
        if _is_int_id(doc_id) and doc_id >= 1:
            block_stop = 1 + sum(self._group_block_rows(collection))
            if doc_id < block_stop:
                shard, local = self.layout().global_to_local(doc_id)
                self.groups[shard].update_one(
                    collection, {ROW_ID: local}, new_values
                )
                return
        self._meta.update_one(collection, {ROW_ID: doc_id}, new_values)

    # --- reads ----------------------------------------------------------------
    def _find_literal(
        self, collection: str, doc_id: Any, limit: Optional[int]
    ) -> Iterator[dict]:
        """Point lookup by literal id — 2 RPCs, no scatter.

        A global id beyond the block could translate onto a local id a
        shard DOES hold (for a different global row), so existence is
        decided against the meta group's block size: group 0's block
        occupies local ids ``1..meta_block`` and overlay ids are always
        past the whole global block (> meta_block), which makes every
        branch below unambiguous.
        """
        if limit == 0:
            return iter(())
        if _is_int_id(doc_id) and doc_id >= 1:
            layout = self.layout()
            meta_block = self._block_rows_of(self._meta, collection)
            shard, local = layout.global_to_local(doc_id)
            if shard == 0:
                if local <= meta_block:
                    found = self._meta.find_one(collection, {ROW_ID: local})
                    if found is None:
                        return iter(())
                    found = dict(found)
                    found[ROW_ID] = doc_id
                    return iter((found,))
            else:
                found = self.groups[shard].find_one(
                    collection, {ROW_ID: local}
                )
                if found is not None:
                    found = dict(found)
                    found[ROW_ID] = doc_id
                    return iter((found,))
            if doc_id <= meta_block:
                # would collide with a meta block row's local id; an
                # overlay doc can never sit this low
                return iter(())
        found = self._meta.find_one(collection, {ROW_ID: doc_id})
        return iter(()) if found is None else iter((found,))

    def find(
        self,
        collection: str,
        query: Optional[dict] = None,
        skip: int = 0,
        limit: Optional[int] = None,
    ) -> Iterator[dict]:
        query = query or {}
        if self.shards == 1:
            return self._meta.find(collection, query, skip=skip, limit=limit)
        if (
            list(query.keys()) == [ROW_ID]
            and not isinstance(query[ROW_ID], dict)
            and skip == 0
        ):
            return self._find_literal(collection, query[ROW_ID], limit)
        layout = self.layout()
        meta_block = self._block_rows_of(self._meta, collection)
        # an id-constrained query cannot push down (shard ids are
        # local): scatter unfiltered and re-filter on translated docs
        push_down = not _query_mentions_id(query)
        shard_query = query if push_down else {}

        def data_stream(shard: int) -> Iterator[tuple]:
            for doc in self.groups[shard].find(collection, shard_query):
                doc_id = doc.get(ROW_ID)
                if not _is_int_id(doc_id) or doc_id == METADATA_ID:
                    continue  # data groups hold block rows only
                doc = dict(doc)
                doc[ROW_ID] = layout.local_to_global(shard, doc_id)
                if push_down or matches(doc, query):
                    yield (_id_sort_key(doc[ROW_ID]), doc)

        def meta_stream() -> Iterator[tuple]:
            # group 0 plays both roles: its block rows carry LOCAL ids
            # (<= meta_block), its overlay documents global ones
            for doc in self._meta.find(collection, shard_query):
                doc_id = doc.get(ROW_ID)
                if _is_int_id(doc_id) and 1 <= doc_id <= meta_block:
                    doc = dict(doc)
                    doc[ROW_ID] = layout.local_to_global(0, doc_id)
                if push_down or matches(doc, query):
                    yield (_id_sort_key(doc.get(ROW_ID)), doc)

        streams = [meta_stream()] + [
            data_stream(shard) for shard in range(1, self.shards)
        ]
        self._observe_fanout(len(streams))

        def generate() -> Iterator[dict]:
            produced = 0
            skipped = 0
            for _, doc in heapq.merge(*streams, key=lambda item: item[0]):
                if skipped < skip:
                    skipped += 1
                    continue
                if limit is not None and produced >= limit:
                    return
                produced += 1
                yield doc

        return generate()

    def count(self, collection: str) -> int:
        return sum(
            self._scatter(
                [
                    (lambda g=group: g.count(collection))
                    for group in self.groups
                ]
            )
        )

    def collection_rev(self, collection: str) -> int:
        revs = self._scatter(
            [
                (lambda g=group: g.collection_rev(collection))
                for group in self.groups
            ]
        )
        live = [rev for rev in revs if rev >= 0]
        if not live:
            return -1  # missing everywhere IS missing
        if len(live) < len(revs):
            return -1  # any group unable to report opts cached readers out
        return sum(live)

    def collection_block_rows(self, collection: str) -> int:
        return sum(self._group_block_rows(collection))

    def aggregate(self, collection: str, pipeline: list[dict]) -> list[dict]:
        if self.shards == 1:
            return self._meta.aggregate(collection, pipeline)
        if any(
            "$match" in stage and _query_mentions_id(stage["$match"])
            for stage in pipeline
        ):
            # id-constrained $match cannot push down: run the pipeline
            # client-side over the translated merged stream
            results: list[dict] = [
                doc
                for doc in self.find(collection)
                if doc.get(ROW_ID) != METADATA_ID
            ]
            for stage in pipeline:
                if "$match" in stage:
                    results = [
                        doc
                        for doc in results
                        if matches(doc, stage["$match"])
                    ]
                elif "$group" in stage:
                    key_expr = stage["$group"].get("_id")
                    if not (
                        isinstance(key_expr, str) and key_expr.startswith("$")
                    ):
                        raise NotImplementedError(
                            f"unsupported $group key {key_expr!r}"
                        )
                    results = _group_count(iter(results), key_expr[1:])
                else:
                    raise NotImplementedError(
                        f"unsupported pipeline stage {stage}"
                    )
            return results
        group_field = None
        for stage in pipeline:
            if "$group" in stage:
                key_expr = stage["$group"].get("_id")
                if isinstance(key_expr, str) and key_expr.startswith("$"):
                    group_field = key_expr[1:]
        layout = self.layout()
        meta_block = self._block_rows_of(self._meta, collection)
        partials = self._scatter(
            [
                (lambda g=group: g.aggregate(collection, pipeline))
                for group in self.groups
            ]
        )
        self._observe_fanout(len(partials))
        merged: dict[tuple, int] = {}
        for shard, results in enumerate(partials):
            for entry in results:
                key = entry["_id"]
                if group_field == ROW_ID and _is_int_id(key):
                    # data-shard keys are always local block ids; on
                    # meta only ids within its block are (overlay keys
                    # are global already, past the whole block)
                    if shard > 0 or 1 <= key <= meta_block:
                        key = layout.local_to_global(shard, key)
                tagged = (isinstance(key, bool), key)
                merged[tagged] = merged.get(tagged, 0) + entry["count"]
        entries = [
            {"_id": key, "count": count}
            for (_, key), count in merged.items()
        ]
        if group_field == ROW_ID:
            entries.sort(key=lambda entry: _id_sort_key(entry["_id"]))
        return entries

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
        if self.shards == 1:
            return self._meta.read_column_arrays(
                collection, fields, start=start, limit=limit
            )
        layout = self.layout()
        group_rows = self._group_block_rows(collection)
        block_total = sum(group_rows)
        data_fields = (
            None
            if fields is None
            else [name for name in fields if name != ROW_ID]
        )
        # positional row space: the block occupies [0, block_total),
        # the meta group's overlay tail follows (matching the unsharded
        # merged-id page order)
        stop = None if limit is None else start + limit
        block_lo = min(max(start, 0), block_total)
        block_hi = block_total if stop is None else min(max(stop, 0), block_total)
        runs: list[dict] = []
        fetched: dict[int, dict[str, Column]] = {}
        if block_hi > block_lo:
            runs = layout.decompose(block_lo + 1, block_hi - block_lo)

            def fetch(run: dict) -> dict[str, Column]:
                return self.groups[run["shard"]].read_column_arrays(
                    collection,
                    data_fields,
                    start=run["local_start"] - 1,
                    limit=run["rows"],
                )

            for run, result in zip(
                runs,
                self._scatter([(lambda r=run: fetch(r)) for run in runs]),
            ):
                fetched[run["shard"]] = result
        overlay: dict[str, Column] = {}
        if stop is None or stop > block_total:
            # the overlay tail sits on meta AFTER its own block rows,
            # so its positional window starts past them
            overlay_start = group_rows[0] + max(start - block_total, 0)
            overlay_limit = (
                None if stop is None else stop - max(start, block_total)
            )
            overlay = self._meta.read_column_arrays(
                collection, fields, start=overlay_start, limit=overlay_limit
            )
            if not any(len(column) for column in overlay.values()):
                overlay = {}
        self._observe_fanout(len(runs) + (1 if overlay else 0))
        if fields is not None:
            names = list(fields)
        else:
            names = []
            for run in runs:
                for name in fetched[run["shard"]]:
                    if name not in names:
                        names.append(name)
            for name in overlay:
                if name not in names:
                    names.append(name)
        # reassemble in global stripe order: each shard's fetched run
        # is consumed sequentially while segments interleave by offset
        interleaved: list[tuple[int, int, int]] = []
        for run in runs:
            for offset, count in run["segments"]:
                interleaved.append((offset, count, run["shard"]))
        interleaved.sort()
        out: dict[str, Column] = {}
        for name in names:
            if name == ROW_ID:
                # never shipped from a shard — synthesized from the
                # global range, then the overlay's real ids appended
                column = Column.from_numpy(
                    np.arange(block_lo + 1, block_hi + 1, dtype=np.int64)
                )
                if name in overlay:
                    column = column.append_column(overlay[name])
                out[name] = column
                continue
            parts: list[Column] = []
            taken = {run["shard"]: 0 for run in runs}
            for _, count, shard in interleaved:
                source = fetched[shard].get(name)
                position = taken[shard]
                taken[shard] = position + count
                if source is None:
                    parts.append(Column.pads(count))
                else:
                    parts.append(source.slice(position, position + count))
            if name in overlay:
                parts.append(overlay[name])
            if not parts:
                out[name] = Column.pads(0)
                continue
            column = parts[0]
            for part in parts[1:]:
                column = column.append_column(part)
            out[name] = column
        return out
