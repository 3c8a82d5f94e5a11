"""Job scheduling: admission, priorities, retries, cancellation and the
job coalescer.

Counterpart of ``learningorchestra_tpu/sched/``. Ported so far, as
copies of the reference's modules with their imports pointed at the
port:

- :class:`~learningorchestra_tpu_torch.sched.scheduler.Scheduler` — a
  priority queue per concurrency class: device-bound jobs (model builds,
  PCA and t-SNE images) run at ``LO_SCHED_DEVICE_WIDTH`` (default 1),
  host-bound jobs at ``LO_JOB_WORKERS``; a full queue
  (``LO_SCHED_QUEUE_CAP``) raises :class:`QueueFullError`, which the REST
  layer answers as 429 + ``Retry-After``;
- :mod:`~learningorchestra_tpu_torch.sched.policy` — transient-failure
  classification and exponential backoff with seeded jitter;
- :mod:`~learningorchestra_tpu_torch.sched.config` — the env knobs;
- :mod:`~learningorchestra_tpu_torch.sched.cancel` — cooperative
  cancellation tokens with per-job deadlines;
- :class:`~learningorchestra_tpu_torch.sched.coalesce.Coalescer` — the
  coalescing stage: shape-compatible device jobs arriving within the
  window fuse into one dispatch over a job axis (ml/sweep.py), each
  member keeping its own result, error or cancellation.

- :class:`~learningorchestra_tpu_torch.sched.journal.JobJournal` — one
  document a submit in the store's ``__lo_jobs__`` collection, state
  transitions and ``progress`` events appended, so a restarted process
  replays it (:func:`~learningorchestra_tpu_torch.sched.recovery.recover_jobs`):
  never-started jobs re-enqueue, orphaned running builds resume from
  their progress artifacts, the rest end FAILED with ``finished: true``
  so pollers stop.

``core/jobs.py`` executes what the scheduler admits.
"""

from learningorchestra_tpu_torch.sched.cancel import (
    CancelToken,
    JobCancelledError,
    JobTimeoutError,
    check_cancelled,
    current_token,
)
from learningorchestra_tpu_torch.sched.coalesce import Coalescer, global_coalescer
from learningorchestra_tpu_torch.sched.journal import (
    JOURNAL_COLLECTION,
    JobJournal,
    shard_scope,
)
from learningorchestra_tpu_torch.sched.policy import (
    TransientJobError,
    backoff_delay,
    is_transient,
)
from learningorchestra_tpu_torch.sched.recovery import recover_jobs
from learningorchestra_tpu_torch.sched.scheduler import (
    DEVICE_CLASS,
    HOST_CLASS,
    QueueFullError,
    Scheduler,
    Task,
)

__all__ = [
    "CancelToken",
    "Coalescer",
    "DEVICE_CLASS",
    "HOST_CLASS",
    "JOURNAL_COLLECTION",
    "JobCancelledError",
    "JobJournal",
    "JobTimeoutError",
    "QueueFullError",
    "Scheduler",
    "Task",
    "TransientJobError",
    "backoff_delay",
    "check_cancelled",
    "current_token",
    "global_coalescer",
    "is_transient",
    "recover_jobs",
    "shard_scope",
]
