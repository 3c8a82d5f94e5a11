"""Online serving: device-resident model registry + request micro-batching.

Counterpart of ``learningorchestra_tpu/serve/__init__.py:43-86``:
:class:`ServePlane` owns one :class:`ModelRegistry` and one
:class:`MicroBatcher`, the unit the model-builder app wires behind
``POST /models/<name>/predict``.
"""

from __future__ import annotations

import threading
from typing import Optional

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.serve.batcher import (
    SERVE_CLASS,
    MicroBatcher,
    QueueFullError,
)
from learningorchestra_tpu_torch.serve.registry import (
    ModelNotFoundError,
    ModelRegistry,
    artifact_rev,
)


class ServePlane:
    """Registry + batcher, constructed together so their knobs resolve
    at the same instant and tests can swap the whole plane."""

    def __init__(
        self,
        capacity: Optional[int] = None,
        window_s: Optional[float] = None,
        max_batch: Optional[int] = None,
        inbox_cap: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.registry = ModelRegistry(capacity=capacity, device=device)
        self.device = self.registry.device
        self.batcher = MicroBatcher(
            self.registry,
            window_s=window_s,
            max_batch=max_batch,
            inbox_cap=inbox_cap,
        )

    def submit(self, path: str, rows):
        return self.batcher.submit(path, rows)

    def stats(self) -> dict:
        return {"registry": self.registry.stats(), **self.batcher.stats()}

    def close(self) -> None:
        self.batcher.close()


_GLOBAL: dict = {}
_GLOBAL_LOCK = threading.Lock()


def global_serve_plane(device: DeviceLike = None) -> ServePlane:
    """The process-wide plane for ``device`` that every app shares
    (registry entries key on absolute checkpoint paths, so apps over
    different model volumes coexist)."""
    device = resolve_device(device)
    with _GLOBAL_LOCK:
        if device not in _GLOBAL:
            _GLOBAL[device] = ServePlane(device=device)
        return _GLOBAL[device]


__all__ = [
    "MicroBatcher",
    "ModelNotFoundError",
    "ModelRegistry",
    "QueueFullError",
    "SERVE_CLASS",
    "ServePlane",
    "artifact_rev",
    "global_serve_plane",
]
