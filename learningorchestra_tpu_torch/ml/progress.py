"""Fit-progress artifacts: segment-granular crash resume.

The fit loops are already segmented (L-BFGS segments in ml/logistic.py,
boosting-round chunks in ml/trees.py) so a process that dies mid-fit has
well-defined resume points — this module persists them. After each
segment the fit saves a compact artifact (params + optimizer state +
segment index) next to the model checkpoints, written with the same
atomic temp-file + ``os.replace`` discipline as ml/checkpoint.py, and
stamped with a devcache-style validation key (input-collection content
fingerprints, dtype policy, the device — fingerprints, not revs: revs
reseed per boot and must survive a restart here). A restarted
build loads the artifact,
validates the key — ANY mismatch deletes it and restarts the fit from
scratch, never a silently-wrong model — and re-enters the segment loop
at the saved index. The segment programs re-seed their derived state
(value/grad, margins' f0) at entry, so a resumed sequence is
bit-identical to an uninterrupted one, on the CPU's plain versions and
on the card's kernels alike (their sums have a fixed order).

The sink rides a contextvar: ml/builder.py binds one per classifier
around ``classifier.fit`` and the fit loops pick it up with
:func:`current_sink` — zero signature churn through the model classes,
and library callers without a sink pay one contextvar read.

Persistence is best-effort: a full disk loses resume granularity, not
the fit. Telemetry: ``lo_build_segments_saved_total`` (artifact writes)
and ``lo_build_segments_skipped_total`` (segments NOT re-run thanks to
a restored artifact — the chaos drill's "resumed run performed only the
remaining work" evidence).

The port's copy of ``learningorchestra_tpu/ml/progress.py`` (its
``collection_fingerprint`` digests columns, not documents): the same
artifact format (the ``__progress__.json`` header, the leaves as npz
members ``a0``, ``a1``, ... in the reference's order), so an artifact
either package writes the other reads. :func:`device_restore` gives
torch tensors on the template's device.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import traceback
import zipfile
from typing import Any, Callable, Iterator, Optional

import numpy as np

from learningorchestra_tpu_torch.testing import faults as _faults

_HEADER = "__progress__.json"

# One artifact per in-flight fit: <progress_dir>/<output_name>.progress
PROGRESS_SUFFIX = ".progress"

_SINK: contextvars.ContextVar[Optional["ProgressSink"]] = (
    contextvars.ContextVar("lo_progress_sink", default=None)
)


def progress_path(progress_dir: str, name: str) -> str:
    return os.path.join(progress_dir, name + PROGRESS_SUFFIX)


def _counter(name: str, help_text: str):
    from learningorchestra_tpu_torch.telemetry import metrics as _metrics

    return _metrics.global_registry().counter(name, help_text)


def _saved_counter():
    return _counter(
        "lo_build_segments_saved_total",
        "Fit-progress artifacts persisted at segment boundaries",
    )


def _skipped_counter():
    return _counter(
        "lo_build_segments_skipped_total",
        "Fit segments skipped by resuming from a progress artifact",
    )


def collection_fingerprint(store, collection: str) -> str:
    """Restart-stable content identity for an input collection, for the
    artifact validation key. The store's in-memory collection revs
    (core/devcache.py) reseed from a random base every boot, so an
    artifact stamped with a rev could never validate on a restarted
    process — which is exactly the process that needs it. Hashing the
    content itself survives the WAL round trip: same content, same key.

    The reference hashes a JSON dump of every document; the port digests
    the collection column by column from one columnar read (each field
    by name, numeric columns as their float64 bytes with nulls as NaN,
    the others as the JSON of their values; then the row ids and the
    metadata document). Same contract, another digest: a 100,000-row
    collection costs a columnar read instead of 100,000 synthesized
    documents and JSON dumps (seconds a build)."""
    import hashlib

    from learningorchestra_tpu_torch.core.store import METADATA_ID, ROW_ID

    digest = hashlib.sha256()
    columns = dict(store.read_column_arrays(collection))
    if ROW_ID not in columns:
        columns.update(store.read_column_arrays(collection, [ROW_ID]))
    for name in sorted(columns):
        column = columns[name]
        digest.update(name.encode() + b"\x00")
        try:
            values = column.to_float64()
        except TypeError:  # not a numeric column
            digest.update(json.dumps(column.tolist(), default=repr).encode())
        else:
            digest.update(b"f8" + np.ascontiguousarray(values).tobytes())
        digest.update(b"\x00")
    metadata = store.find_one(collection, {ROW_ID: METADATA_ID})
    digest.update(json.dumps(metadata, sort_keys=True, default=repr).encode())
    return digest.hexdigest()[:16]


def segments_skipped(count: int) -> None:
    """Record ``count`` segments restored-not-recomputed. Called by the
    fit loops AFTER they accept a restored artifact (the sink cannot
    count at load time — the loop still validates segmentation/shape
    compatibility and may reject)."""
    if count > 0:
        _skipped_counter().inc(count)


@contextlib.contextmanager
def bind_sink(sink: Optional["ProgressSink"]):
    """Bind ``sink`` (or None) as the ambient progress sink for the
    fit running on this thread."""
    token = _SINK.set(sink)
    try:
        yield sink
    finally:
        _SINK.reset(token)


def current_sink() -> Optional["ProgressSink"]:
    return _SINK.get()


class ProgressSink:
    """One in-flight fit's progress artifact.

    ``meta`` is the validation key (JSON-safe dict: input content
    fingerprints, dtype policy, the device — whatever makes a stale
    artifact detectable); :meth:`load` returns None unless the on-disk header
    matches it exactly. ``every`` throttles saves to every Nth segment
    (``LO_RESUME_EVERY_SEGMENTS``). ``on_segment`` fires after each
    durable save — the builder journals a ``progress`` event there.
    """

    def __init__(
        self,
        path: str,
        meta: dict,
        every: int = 1,
        on_segment: Optional[Callable[[int], None]] = None,
    ):
        self.path = path
        self.meta = meta
        self.every = max(1, int(every))
        self.on_segment = on_segment

    def load(self, kind: str) -> Optional[tuple[int, list, dict]]:
        """→ ``(segment, host_arrays, scalars)`` or None. A corrupt,
        wrong-kind, or stale-key artifact is DELETED and ignored: the
        fit restarts clean rather than resuming against data that
        changed underneath it."""
        if not os.path.isfile(self.path):
            return None
        try:
            with zipfile.ZipFile(self.path) as archive:
                header = json.loads(archive.read(_HEADER))
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            self.discard()
            return None
        if header.get("kind") != kind or header.get("meta") != self.meta:
            self.discard()
            return None
        try:
            data = np.load(self.path)
            arrays = [data[f"a{i}"] for i in range(int(header["leaves"]))]
            segment = int(header["segment"])
            scalars = dict(header.get("scalars") or {})
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            self.discard()
            return None
        return segment, arrays, scalars


    def save(
        self, kind: str, segment: int, arrays: list, scalars: dict
    ) -> None:
        """Persist segment state atomically (temp + ``os.replace``, the
        ml/checkpoint.py discipline: a reader never sees a partial
        archive, a crash mid-save never corrupts the published path).
        Segments not on the ``every`` grid are skipped. Best-effort: a
        failed write costs resume granularity, never the fit."""
        if segment % self.every != 0:
            return
        try:
            header = json.dumps(
                {
                    "kind": kind,
                    "meta": self.meta,
                    "segment": int(segment),
                    "leaves": len(arrays),
                    "scalars": scalars,
                }
            )
            tmp_path = self.path + ".tmp"
            # through a file object: np.savez given a NAME appends .npz
            with open(tmp_path, "wb") as handle:
                np.savez(
                    handle,
                    **{
                        f"a{i}": np.asarray(array)
                        for i, array in enumerate(arrays)
                    },
                )
            with zipfile.ZipFile(tmp_path, "a") as archive:
                archive.writestr(_HEADER, header)
            os.replace(tmp_path, self.path)
        except OSError:
            traceback.print_exc()
            return
        _saved_counter().inc()
        if self.on_segment is not None:
            try:
                self.on_segment(int(segment))
            except Exception:  # noqa: BLE001 — journaling is best-effort
                traceback.print_exc()
        # chaos point: an error here stops the fit right after a durable
        # save, as a crash would (the in-process resume drill)
        _faults.fire("fit.segment", kind=kind, segment=int(segment))

    def discard(self) -> None:
        """Remove the artifact (fit finished, or validation failed)."""
        try:
            os.remove(self.path)
        except OSError:
            pass


def tree_leaves(template: Any) -> list:
    """A template's tensors in ``jax.tree.leaves`` order: dict values by
    sorted key, list and tuple items in order."""
    if isinstance(template, dict):
        return [leaf for key in sorted(template) for leaf in tree_leaves(template[key])]
    if isinstance(template, (list, tuple)):
        return [leaf for item in template for leaf in tree_leaves(item)]
    return [template]


def _unflatten(template: Any, leaves: Iterator) -> Any:
    if isinstance(template, dict):
        rebuilt = {key: _unflatten(template[key], leaves) for key in sorted(template)}
        return {key: rebuilt[key] for key in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(item, leaves) for item in template)
    return next(leaves)


def device_restore(template: Any, host_arrays: list) -> Optional[Any]:
    """Rebuild a structure of tensors (a tensor, or dicts, lists and
    tuples of them) from saved host arrays: each leaf lands on the
    corresponding TEMPLATE leaf's device, so a restored fit continues
    where the fresh init would have put it. Returns None on any
    count/shape/dtype mismatch (the caller restarts clean)."""
    import torch

    leaves = tree_leaves(template)
    if len(leaves) != len(host_arrays):
        return None
    restored = []
    for leaf, host in zip(leaves, host_arrays):
        host = np.asarray(host)
        try:
            dtype = torch.from_numpy(np.empty((0,), host.dtype)).dtype
        except TypeError:  # a dtype torch has no tensor for
            return None
        if tuple(host.shape) != tuple(leaf.shape) or dtype != leaf.dtype:
            return None
        restored.append(torch.tensor(host, device=leaf.device))
    return _unflatten(template, iter(restored))
