"""Device-resident data plane: a rev-keyed cache of prepared inputs.

The port's copy of ``learningorchestra_tpu/core/devcache.py``. A dataset
crosses each boundary once per revision:

- One process-wide :class:`DeviceCache` (``global_devcache``), a
  capacity-bounded (``LO_DEVCACHE_BYTES``, default 2 GB) LRU over both
  host entries (decoded :class:`~learningorchestra_tpu_torch.core.table.
  ColumnTable` columns: no store read, no frame decode) and device
  entries (feature matrices and labels already on the card: no
  host-to-device copy).
- Dataset entries are keyed by ``(store scope, collection, subkey)`` and
  stamped with the collection's mutation rev (``store.collection_rev``).
  A lookup probes the live rev first; a mismatch evicts the stale entry
  and reloads. That holds for a ``RemoteStore`` too (``GET
  /c/<name>/rev``): every mutating verb bumps the collection's rev on the
  server, so a write through any client evicts every cached reader at
  its next lookup, and a paged read that fails mid-stream purges the
  collection's entries (``invalidate_collection``). A store that reports
  no rev never caches (every read is uncached).
- Preprocessed frames, whose bytes come from arbitrary
  ``preprocessor_code``, are cached by content instead
  (:func:`content_device_matrix`): the key is a BLAKE2 digest of the host
  buffer with the device's signature and the dtype policy, so an entry
  can never be stale; it only LRU-evicts. A second build, or a batch
  predict, over an unchanged collection so skips every host-to-device
  copy of its test and eval matrices.

A device entry is a tensor on one card, freed when its last reference
goes: an evicted matrix still held by a running fit stays allocated
until the fit lets it go. Entries are shared across requests and
threads, so nothing writes into a cached tensor or table in place (the
frame verbs copy on write; fits and forwards read their X).

Imports numpy, torch and the stdlib only.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.core.table import ColumnTable
from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.utils.dtypepolicy import dtype_policy

# Content-addressed entries live under this pseudo-collection: their key
# embeds a digest of the bytes, so they cannot go stale and are never
# rev-invalidated, only LRU-evicted.
CONTENT = "__content__"

DEFAULT_CAPACITY_BYTES = 2_000_000_000


def capacity_bytes() -> int:
    """``LO_DEVCACHE_BYTES`` validated: total bytes of cached payloads,
    host and device entries against one budget. ``0`` disables caching."""
    raw = os.environ.get("LO_DEVCACHE_BYTES", "").strip()
    if not raw:
        return DEFAULT_CAPACITY_BYTES
    try:
        value = int(float(raw))
    except ValueError:
        raise ValueError(
            f"LO_DEVCACHE_BYTES must be a number of bytes, got {raw!r}"
        ) from None
    if value < 0:
        raise ValueError(f"LO_DEVCACHE_BYTES must be >= 0, got {value}")
    return value


def store_rev(store, collection: str) -> int:
    """The collection's mutation counter, or -1 when the backend cannot
    report one (unknown backends never cache)."""
    rev_fn = getattr(store, "collection_rev", None)
    if rev_fn is None:
        return -1
    return rev_fn(collection)


_STORE_TOKENS = itertools.count(1)
_TOKEN_LOCK = threading.Lock()


def store_token(store) -> str:
    """A per-store-instance cache scope, minted once and pinned on the
    instance. Revs are monotonic only within one store, so two stores
    holding a same-named collection at an equal rev must never alias;
    unlike ``id()`` the token never recycles after garbage collection.
    Minting is locked, so that two threads racing the first lookup agree
    on one scope."""
    token = getattr(store, "_lo_devcache_token", None)
    if token is None:
        with _TOKEN_LOCK:
            token = getattr(store, "_lo_devcache_token", None)
            if token is None:
                token = f"s{next(_STORE_TOKENS)}"
                try:
                    store._lo_devcache_token = token
                except AttributeError:  # __slots__ backend: no cache
                    return ""
    # a sharded store's rev is a sum over its groups: scoping by the shard
    # signature invalidates every entry on a topology change
    return token + getattr(store, "shard_signature", "")


def device_signature(device: torch.device) -> tuple:
    """A hashable identity of the device an entry lives on (the
    reference's ``mesh_signature``): its type, its index and, on CUDA,
    the card's name, so that an entry made for one card never serves
    another."""
    if device.type == "cuda":
        return ("cuda", device.index, torch.cuda.get_device_name(device))
    return (device.type, device.index)


class _Entry:
    __slots__ = ("value", "nbytes", "rev")

    def __init__(self, value: Any, nbytes: int, rev: int):
        self.value = value
        self.nbytes = nbytes
        self.rev = rev


class DeviceCache:
    """Capacity-bounded LRU keyed by ``(scope, collection, subkey)``,
    ``scope`` the store instance's token (revs compare within one store).

    Staleness is checked at lookup against the caller-probed rev: a
    mismatched entry is dropped (counted as an invalidation) and the
    lookup misses, so one key never holds two revisions and a mutating
    store operation needs no push channel into this process."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.capacity = capacity_bytes() if capacity is None else capacity
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, scope: str, collection: str, subkey: tuple, rev: int) -> Optional[Any]:
        key = (scope, collection, subkey)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and rev >= 0 and entry.rev == rev:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry.value
            if entry is not None:
                # stale (a write moved the rev, or the collection is gone
                # and the probe answered -1): evict now
                self._drop_locked(key)
                self.invalidations += 1
            self.misses += 1
            return None

    def put(
        self, scope: str, collection: str, subkey: tuple, rev: int, value: Any, nbytes: int
    ) -> Any:
        nbytes = max(int(nbytes), 0)
        if self.capacity <= 0 or rev < 0 or not scope or nbytes > self.capacity:
            return value  # uncacheable: hand the value through
        key = (scope, collection, subkey)
        with self._lock:
            if key in self._entries:
                self._drop_locked(key)
            while self.bytes + nbytes > self.capacity and self._entries:
                self._drop_locked(next(iter(self._entries)))
                self.evictions += 1
            self._entries[key] = _Entry(value, nbytes, rev)
            self.bytes += nbytes
        return value

    def _drop_locked(self, key: tuple) -> None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self.bytes -= entry.nbytes

    def invalidate(self, collection: Optional[str] = None, scope: Optional[str] = None) -> int:
        """Drop every entry of ``collection`` (all collections when None),
        within one store ``scope`` when given. Returns the drop count."""
        with self._lock:
            keys = [
                key
                for key in self._entries
                if (collection is None or key[1] == collection)
                and (scope is None or key[0] == scope)
            ]
            for key in keys:
                self._drop_locked(key)
            self.invalidations += len(keys)
            return len(keys)

    def get_or_load(
        self,
        store,
        collection: str,
        subkey: tuple,
        loader: Callable[[], Any],
        nbytes_fn: Callable[[Any], int],
    ) -> Any:
        """Rev-probed lookup; on a miss run ``loader`` and cache its result,
        but only when the rev is unchanged after the load (a write landing
        mid-read must not be cached under the rev from before it)."""
        scope = store_token(store)
        rev = store_rev(store, collection)
        cached = self.get(scope, collection, subkey, rev)
        if cached is not None:
            return cached
        value = loader()
        if rev >= 0 and store_rev(store, collection) == rev:
            self.put(scope, collection, subkey, rev, value, nbytes_fn(value))
        return value

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "bytes": self.bytes,
                "entries": len(self._entries),
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes = 0


_GLOBAL: Optional[DeviceCache] = None
_GLOBAL_LOCK = threading.Lock()


def global_devcache() -> DeviceCache:
    """The process-wide cache every data-plane reader shares. The first
    call registers the ``lo_devcache_*`` gauges on the process metrics
    registry."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = DeviceCache()
            _register_metrics(_GLOBAL)
        return _GLOBAL


def reset_global_devcache() -> None:
    """Tests only: drop the global cache's entries and counters, in place
    (the metrics collector holds the instance)."""
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.clear()
            _GLOBAL.hits = _GLOBAL.misses = 0
            _GLOBAL.evictions = _GLOBAL.invalidations = 0


def invalidate_collection(collection: str, store: Optional[object] = None) -> None:
    """Invalidation hook for writers: a no-op before the global cache
    exists. ``store`` (when given) restricts the purge to its scope."""
    with _GLOBAL_LOCK:
        cache = _GLOBAL
    if cache is not None:
        scope = store_token(store) if store is not None else None
        cache.invalidate(collection, scope=scope or None)


def _register_metrics(cache: DeviceCache) -> None:
    from learningorchestra_tpu_torch.telemetry import global_registry

    registry = global_registry()
    gauges = {
        name: registry.gauge(f"lo_devcache_{name}", help_text)
        for name, help_text in (
            ("hits", "Device-cache lookups served without a reload"),
            ("misses", "Device-cache lookups that ran the loader"),
            ("evictions", "Entries dropped by the LRU capacity bound"),
            (
                "invalidations",
                "Entries dropped because the collection rev moved "
                "(or a mid-stream read failure forced a purge)",
            ),
            ("bytes", "Bytes of cached payloads (host + device)"),
            ("entries", "Entries resident in the device cache"),
        )
    }

    def collect(_registry) -> None:
        stats = cache.stats()
        for name, gauge in gauges.items():
            gauge.set(stats[name])

    registry.register_collector(collect)


# --- dataset helpers (collection + rev keyed) -------------------------------


def _fields_key(fields) -> tuple:
    return ("*",) if fields is None else tuple(fields)


def _tensor_nbytes(tensor: torch.Tensor) -> int:
    return tensor.numel() * tensor.element_size()


def _table_nbytes(table: ColumnTable) -> int:
    total = 0
    for column in table.columns.values():
        total += column.nbytes
        if column.dtype == object:
            # nbytes counts pointers only; charge a rough boxed-object
            # footprint so that string-heavy tables do not dodge the budget
            total += 48 * len(column)
    return total


def dataset_table(
    store: DocumentStore, collection: str, fields=None, cache: Optional[DeviceCache] = None
) -> ColumnTable:
    """The collection as a :class:`ColumnTable` (one bulk columnar read),
    cached by rev: a warm hit skips the store read and the decode.
    Callers share the returned table's arrays and treat them as
    immutable (the frame verbs copy on write)."""
    from learningorchestra_tpu_torch.telemetry import span

    cache = cache or global_devcache()

    def load():
        with span("store:read", collection=collection) as span_obj:
            table = ColumnTable.from_store(store, collection, fields)
            if span_obj is not None:
                span_obj.meta["rows"] = table.num_rows
                span_obj.meta["bytes"] = _table_nbytes(table)
            return table

    return cache.get_or_load(
        store, collection, ("table", _fields_key(fields)), load, _table_nbytes
    )


def dataset_embedding_inputs(
    store: DocumentStore,
    collection: str,
    device: DeviceLike = None,
    cache: Optional[DeviceCache] = None,
) -> tuple:
    """``(encoded_table, vocabularies, X)``, the PCA and t-SNE image
    pipeline's inputs, as one cache entry, so that the hue labels and the
    matrix never come from different revisions: the table less its rows
    with a missing value, its string columns label-encoded in
    sorted-vocabulary order, and ``X``, the whole encoded table (label
    column included, as in the reference) as a ``(rows, fields)`` tensor
    on the device in the policy's dtype."""
    from learningorchestra_tpu_torch.ml.base import shard_matrix
    from learningorchestra_tpu_torch.telemetry import span

    device = resolve_device(device)
    cache = cache or global_devcache()

    def load():
        table = dataset_table(store, collection, cache=cache).dropna()
        encoded, vocabularies = table.encoded()
        X = encoded.matrix()
        with span("h2d:dataset", collection=collection, rows=len(X), dtype=dtype_policy()):
            return encoded, vocabularies, shard_matrix(X, device)

    return cache.get_or_load(
        store,
        collection,
        ("embed_inputs", device_signature(device), dtype_policy()),
        load,
        lambda value: _table_nbytes(value[0]) + _tensor_nbytes(value[2]),
    )


# --- content-addressed helpers (preprocessed frames) ------------------------


def _content_digest(array: np.ndarray) -> tuple:
    array = np.ascontiguousarray(array)
    digest = hashlib.blake2b(array.view(np.uint8), digest_size=16)
    return (str(array.dtype), array.shape, digest.hexdigest())


def content_device_matrix(X: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """``X`` on the device in the policy's dtype, cached by a digest of
    its bytes with the device's signature and the policy: a rebuilt frame
    from an unchanged collection and preprocessor hashes the same, hits,
    and skips the copy. The digest is one pass over the host bytes."""
    from learningorchestra_tpu_torch.ml.base import shard_matrix
    from learningorchestra_tpu_torch.telemetry import span

    device = resolve_device(device)
    cache = global_devcache()
    subkey = ("devmat", _content_digest(X), device_signature(device), dtype_policy())
    cached = cache.get(CONTENT, CONTENT, subkey, rev=0)
    if cached is not None:
        return cached
    with span("h2d:matrix", rows=len(X), dtype=dtype_policy()):
        matrix = shard_matrix(X, device)
    return cache.put(CONTENT, CONTENT, subkey, 0, matrix, _tensor_nbytes(matrix))


def content_device_labels(y: np.ndarray, device: DeviceLike = None):
    """The label-vector counterpart of :func:`content_device_matrix`: a
    :class:`~learningorchestra_tpu_torch.ml.base.DeviceLabels`."""
    from learningorchestra_tpu_torch.ml.base import shard_labels
    from learningorchestra_tpu_torch.telemetry import span

    device = resolve_device(device)
    cache = global_devcache()
    subkey = ("devlab", _content_digest(y), device_signature(device), "i64")
    cached = cache.get(CONTENT, CONTENT, subkey, rev=0)
    if cached is not None:
        return cached
    with span("h2d:labels", rows=len(y), dtype="i64"):
        labels = shard_labels(y, device)
    return cache.put(CONTENT, CONTENT, subkey, 0, labels, _tensor_nbytes(labels.data))
