"""The compile plane.

Counterpart of ``learningorchestra_tpu/compile/__init__.py``. Four
pieces, one goal: a fleet member never pays for an nvcc build another
member (or its own boot) already paid for.

- :mod:`.manifest` lists the kernel libraries, the ones the published
  checkpoints need first;
- :mod:`.aot` builds them at boot (on a daemon thread, off the device
  queue) into the build folder (``kernels.build_dir()``), under
  ``LO_AOT`` (:mod:`.config` has the knobs);
- :mod:`.fleetcache` moves the built libraries through the
  ``__lo_executables__`` store collection, trusted only under a
  matching fingerprint;
- :mod:`.warmup` runs the serve path's fixed dispatch shape when a
  checkpoint publishes.

This module owns the process-wide **publish hook**: checkpoint writers
(``ml/builder.py``, ``ml/sweep.py``) call :func:`checkpoint_published`
after their atomic ``os.replace``; a service that can warm the serve
path (``services/model_builder.py``) registers the handler, which runs
:mod:`.warmup` as a low-priority device job. The default is a no-op:
library callers, tests and scripts publish checkpoints without the
serve plane.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from learningorchestra_tpu_torch.compile.aot import (  # noqa: F401
    AotPlane,
    backend_fingerprint,
    boot_compile_plane,
    compile_spec,
)
from learningorchestra_tpu_torch.compile.manifest import (  # noqa: F401
    ProgramSpec,
    enumerate_programs,
    specs_for_artifact,
)

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
