"""Device-resident model registry: fitted parameters pinned on the card.

Counterpart of ``learningorchestra_tpu/serve/registry.py:38-222``. Models
are kept in a byte-budgeted LRU keyed by the checkpoint's absolute path:

- Each entry is stamped with the artifact's rev,
  ``(st_ino, st_mtime_ns, st_size)``. ``write_checkpoint`` publishes with
  ``os.replace`` (a new inode), so a rebuild always moves the rev and the
  next lookup reloads: a rebuilt model is never served stale.
- The budget (``LO_SERVE_BYTES``) counts ``numel * element_size`` of the
  models' ``device_state()`` tensors; past it the least recently used
  model is dropped. A model bigger than the whole budget (or a budget of
  0) is loaded for its request and handed over without being pinned.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device


class ModelNotFoundError(KeyError):
    """No checkpoint artifact at the requested path (never built, or
    deleted between the route's existence check and the dispatch)."""


Rev = tuple  # (st_ino, st_mtime_ns, st_size)


def artifact_rev(path: str) -> Optional[Rev]:
    """The artifact's identity on disk, or None when it does not exist."""
    try:
        stat = os.stat(path)
    except OSError:
        return None
    return (stat.st_ino, stat.st_mtime_ns, stat.st_size)


def model_nbytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.device_state())


class _Entry:
    __slots__ = ("model", "rev", "nbytes", "kind")

    def __init__(self, model, rev: Rev, nbytes: int, kind: str):
        self.model = model
        self.rev = rev
        self.nbytes = nbytes
        self.kind = kind


class ModelRegistry:
    """Byte-budgeted LRU of predict-ready models keyed by artifact path.

    The lock guards the map only: checkpoint loads (unzip and host-to-
    device copy) run outside it, so a stats probe never waits on a load.
    If two callers race to load one path, the second insert replaces the
    first — wasted work, never a wrong answer or a leaked byte count.
    """

    def __init__(self, capacity: Optional[int] = None, device: DeviceLike = None):
        from learningorchestra_tpu_torch.serve import config

        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.capacity = config.serve_bytes() if capacity is None else capacity
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def _load(self, path: str):
        from learningorchestra_tpu_torch.ml.checkpoint import load_model

        return load_model(path, device=self.device)

    def get(self, path: str):
        """The predict-ready model for ``path``; loads (and pins, budget
        permitting) on a miss, reloads when the artifact's rev moved.
        Raises :class:`ModelNotFoundError` when no artifact exists."""
        path = os.path.abspath(path)
        rev = artifact_rev(path)
        if rev is None:
            with self._lock:
                self._drop_locked(path, invalidation=True)
            raise ModelNotFoundError(path)
        with self._lock:
            entry = self._entries.get(path)
            if entry is not None and entry.rev == rev:
                self._entries.move_to_end(path)
                self.hits += 1
                return entry.model
            if entry is not None:
                # a rebuild moved the artifact: never serve stale parameters
                self._drop_locked(path, invalidation=True)
            self.misses += 1
        try:
            model = self._load(path)
        except FileNotFoundError:
            # deleted between artifact_rev() and the open: a late 404
            raise ModelNotFoundError(path) from None
        nbytes = model_nbytes(model)
        if 0 < nbytes <= self.capacity:
            with self._lock:
                if path in self._entries:  # a racing loader beat us
                    self._drop_locked(path)
                while self.bytes + nbytes > self.capacity and self._entries:
                    self._drop_locked(next(iter(self._entries)))
                    self.evictions += 1
                self._entries[path] = _Entry(model, rev, nbytes, type(model).__name__)
                self.bytes += nbytes
        # over budget (or capacity 0): hand the model over without pinning
        return model

    def _drop_locked(self, path: str, invalidation: bool = False) -> None:
        entry = self._entries.pop(path, None)
        if entry is not None:
            self.bytes -= entry.nbytes
            if invalidation:
                self.invalidations += 1

    def status(self, path: str) -> dict:
        """Residency info for ``GET /models/<name>``; never loads."""
        path = os.path.abspath(path)
        with self._lock:
            entry = self._entries.get(path)
            if entry is None:
                return {"resident": False}
            return {
                "resident": entry.rev == artifact_rev(path),
                "bytes": entry.nbytes,
                "kind": entry.kind,
            }

    def stats(self) -> dict:
        with self._lock:
            return {
                "models": len(self._entries),
                "bytes": self.bytes,
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }
