"""Tracing and per-phase timing.

The port's copy of ``learningorchestra_tpu/utils/profiling.py``: a
:class:`PhaseTimer` accumulates named phase durations that jobs attach
to their result metadata, and :func:`trace` records a block under
``torch.profiler`` (the reference's runs the JAX profiler) and writes it
as a Chrome trace, loadable in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

from learningorchestra_tpu_torch.telemetry import tracing as _tracing

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Accumulates ``{phase: seconds}``; reentrant per phase.

    Each phase ENTRY lands as its own timestamped span in the active
    trace (a no-op outside one) and as its own row in ``occurrences``;
    ``as_metadata()`` keeps one total per phase name. ``**attrs`` become
    typed span attributes (rows, bytes, dtype) on that occurrence's
    span."""

    def __init__(self):
        self.timings: dict[str, float] = {}
        # one row per phase ENTRY: (name, epoch start, seconds)
        self.occurrences: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str, **attrs) -> Iterator[None]:
        start = time.perf_counter()
        started_at = time.time()
        try:
            with _tracing.span(f"phase:{name}", **attrs):
                yield
        finally:
            elapsed = time.perf_counter() - start
            self.timings[name] = self.timings.get(name, 0.0) + elapsed
            self.occurrences.append((name, started_at, elapsed))

    def as_metadata(self) -> dict[str, float]:
        """Rounded copy for inclusion in stored job metadata."""
        return {name: round(seconds, 6) for name, seconds in self.timings.items()}


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the block (host ops, and the card's
    kernels when CUDA is available) written to ``log_dir/trace.json``;
    a no-op when ``log_dir`` is None. The profiler is process-wide: the
    caller makes sure one trace runs at a time."""
    if log_dir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as profiler:
        yield
    profiler.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
