"""The publish hook of the compile plane.

Counterpart of ``learningorchestra_tpu/compile/__init__.py:43-71``:
checkpoint writers (``ml/builder.py``, ``ml/sweep.py``) call
:func:`checkpoint_published` after their atomic ``os.replace``; a
service that can warm the serve path (``services/model_builder.py``)
registers the handler, which runs :mod:`.warmup` as a low-priority
device job. The default is a no-op: library callers, tests and scripts
publish checkpoints without the serve plane.

The reference's XLA precompile plane (``compile/aot.py``,
``fleetcache.py``, ``manifest.py``, ``config.py``) has no counterpart:
the port's kernels are nvcc libraries built at first use into
``kernels/_build/``, not XLA executables.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

_HANDLER: Optional[Callable[[str, Optional[int]], None]] = None
_HANDLER_LOCK = threading.Lock()


def set_publish_handler(
    handler: Optional[Callable[[str, Optional[int]], None]],
):
    """Install the process-wide checkpoint-publication handler
    (``handler(path, features)``); returns the previous one. The latest
    registration wins: registry entries key on absolute checkpoint
    paths, so any live serve plane can warm any artifact."""
    global _HANDLER
    with _HANDLER_LOCK:
        previous, _HANDLER = _HANDLER, handler
    return previous


def checkpoint_published(path: str, features: Optional[int] = None) -> None:
    """Tell the compile plane that ``path`` just became (or replaced) a
    published checkpoint. Never raises into the publishing build: warmup
    is an optimization, a failed hook must not fail the fit."""
    with _HANDLER_LOCK:
        handler = _HANDLER
    if handler is None:
        return
    try:
        handler(path, features)
    except Exception:  # noqa: BLE001 — publication outlives the hook
        pass
