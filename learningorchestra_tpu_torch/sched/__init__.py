"""Job scheduling: cancellation tokens, knobs and the job coalescer.

Counterpart of ``learningorchestra_tpu/sched/``. Ported so far, as
copies of the reference's modules with their imports pointed at the
port:

- :mod:`~learningorchestra_tpu_torch.sched.config` — the env knobs
  (``LO_COALESCE_WINDOW_MS``, ``LO_COALESCE_MAX_JOBS`` among them);
- :mod:`~learningorchestra_tpu_torch.sched.cancel` — cooperative
  cancellation tokens with per-job deadlines;
- :class:`~learningorchestra_tpu_torch.sched.coalesce.Coalescer` — the
  coalescing stage: shape-compatible device jobs arriving within the
  window fuse into one dispatch over a job axis (ml/sweep.py), each
  member keeping its own result, error or cancellation.

The scheduler, its journal, retry policy and crash recovery come with
the builder (``core/jobs.py``).
"""

from learningorchestra_tpu_torch.sched.cancel import (
    CancelToken,
    JobCancelledError,
    JobTimeoutError,
    check_cancelled,
    current_token,
)
from learningorchestra_tpu_torch.sched.coalesce import Coalescer, global_coalescer

__all__ = [
    "CancelToken",
    "Coalescer",
    "JobCancelledError",
    "JobTimeoutError",
    "check_cancelled",
    "current_token",
    "global_coalescer",
]
