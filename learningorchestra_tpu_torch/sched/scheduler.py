"""Priority queues with concurrency classes — the admission layer.

Two classes, two queues, two worker pools:

- ``device`` — jobs that own the accelerator (model builds, t-SNE/PCA
  embeddings, checkpoint predictions). Width defaults to 1 so two SPMD
  dispatches never contend for the mesh: on a multi-host runtime a
  second concurrent dispatch would interleave collectives and deadlock
  (the invariant the analyzer's LO101 guards statically; this queue
  guards it dynamically).
- ``host`` — everything CPU/store-bound (ingests, projections,
  histograms, field-type scans), width ``LO_JOB_WORKERS``.

Each queue is a max-priority heap (larger ``priority`` first, FIFO
within a priority) with a depth cap: past it :meth:`Scheduler.enqueue`
raises :class:`QueueFullError` carrying a ``Retry-After`` estimate, and
the REST layer turns that into HTTP 429 (utils/web.py) — bounded
admission instead of the reference's unbounded daemon-thread spawn.
Retries re-enter through the same heap after their backoff timer but
bypass the cap (the work was already admitted once).

The scheduler runs opaque :class:`Task` objects; all job bookkeeping
(records, traces, journal events, retry classification) lives in the
``run`` closure the :class:`~learningorchestra_tpu_torch.core.jobs.JobManager`
builds, so this module stays importable without jax, the store, or the
job manager.

The port's copy of ``learningorchestra_tpu/sched/scheduler.py``,
unchanged; the runner hands it a ``JobJournal`` (services/runner.py).
"""

from __future__ import annotations

import heapq
import itertools
import math
import threading
import time
from typing import Callable, Optional

from learningorchestra_tpu_torch.sched import config
from learningorchestra_tpu_torch.sched.cancel import CancelToken
from learningorchestra_tpu_torch.telemetry import metrics as _metrics

DEVICE_CLASS = "device"
HOST_CLASS = "host"


class QueueFullError(RuntimeError):
    """Admission refused: the class's queue is at its depth cap.

    Deliberately NOT a ValueError: service handlers catch ValueError
    for duplicate-job 409s and must not mistake backpressure for a
    duplicate. ``retry_after_s`` is the depth-and-throughput-derived
    hint the REST layer sends as ``Retry-After``.
    """

    def __init__(self, job_class: str, depth: int, retry_after_s: int):
        super().__init__(
            f"{job_class} queue full ({depth} queued); "
            f"retry in ~{retry_after_s}s"
        )
        self.job_class = job_class
        self.depth = depth
        self.retry_after_s = retry_after_s


class Task:
    """One schedulable unit. ``run`` executes the job and returns
    ``None`` when the job reached a terminal state, or a delay in
    seconds to re-enqueue after (a transient failure within budget).
    ``wait_s`` is stamped by the worker at dequeue so ``run`` can
    record queue time."""

    __slots__ = (
        "name",
        "job_class",
        "priority",
        "token",
        "run",
        "attempt",
        "enqueued_at",
        "wait_s",
    )

    def __init__(
        self,
        name: str,
        job_class: str,
        priority: int,
        run: Callable[["Task"], Optional[float]],
        token: Optional[CancelToken] = None,
    ):
        self.name = name
        self.job_class = job_class
        self.priority = priority
        self.run = run
        self.token = token or CancelToken()
        self.attempt = 1
        self.enqueued_at = 0.0
        self.wait_s = 0.0


class _ClassQueue:
    """One concurrency class: heap + worker pool + throughput EWMA."""

    def __init__(self, name: str, width: int, cap: int):
        self.name = name
        self.width = width
        self.cap = cap
        self.cond = threading.Condition()
        self.heap: list[tuple[int, int, Task]] = []
        self.seq = itertools.count()
        self.workers = 0
        self.idle = 0
        self.running = 0
        # EWMA of execution seconds, seeding Retry-After estimates
        # before any job has completed
        self.avg_run_s = 1.0


class Scheduler:
    """Admission + ordering + workers for both concurrency classes.

    Worker threads spawn lazily per class up to its width (a scheduler
    constructed for a test that never submits costs zero threads) and
    are daemons; :meth:`close` exists so tests can park them.
    """

    def __init__(
        self,
        host_width: Optional[int] = None,
        device_width: Optional[int] = None,
        queue_cap: Optional[int] = None,
        journal=None,
    ):
        cap = config.queue_cap() if queue_cap is None else queue_cap
        self.journal = journal
        self._classes = {
            HOST_CLASS: _ClassQueue(
                HOST_CLASS,
                config.host_width() if host_width is None else host_width,
                cap,
            ),
            DEVICE_CLASS: _ClassQueue(
                DEVICE_CLASS,
                config.device_width() if device_width is None else device_width,
                cap,
            ),
        }
        self._closed = False
        registry = _metrics.global_registry()
        self._depth_gauge = registry.gauge(
            "lo_sched_queue_depth",
            "Jobs queued (admitted, not yet running) per class",
            labels=("job_class",),
        )
        self._running_gauge = registry.gauge(
            "lo_sched_running",
            "Jobs executing per class",
            labels=("job_class",),
        )
        self._wait_seconds = registry.histogram(
            "lo_sched_queue_wait_seconds",
            "Seconds between admission and execution start",
            labels=("job_class",),
        )
        self._rejected_total = registry.counter(
            "lo_sched_rejected_total",
            "Submissions refused at the queue cap (HTTP 429)",
            labels=("job_class",),
        )
        self._retries_total = registry.counter(
            "lo_sched_retries_total",
            "Transient failures re-enqueued with backoff",
            labels=("job_class",),
        )

    def class_width(self, job_class: str) -> int:
        return self._classes[job_class].width

    def check_admission(self, job_class: str) -> None:
        """Raise :class:`QueueFullError` if ``job_class`` is at its cap
        right now. A best-effort pre-check for submit paths that would
        otherwise do durable work (journal writes, name claims) before
        :meth:`enqueue` rejects — exactly when the system is overloaded
        and every spare store round-trip hurts. The admit/reject race
        this leaves open is still closed authoritatively by enqueue."""
        cls = self._classes[job_class]
        with cls.cond:
            depth = len(cls.heap)
            if depth >= cls.cap:
                self._rejected_total.labels(cls.name).inc()
                raise QueueFullError(
                    cls.name, depth, self._retry_after_locked(cls)
                )

    def enqueue(self, task: Task, requeue: bool = False) -> None:
        """Admit ``task``. Raises :class:`QueueFullError` at the cap
        (unless ``requeue`` — a backoff re-entry of admitted work) and
        ``KeyError`` for an unknown class."""
        cls = self._classes[task.job_class]
        with cls.cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            depth = len(cls.heap)
            if not requeue and depth >= cls.cap:
                self._rejected_total.labels(cls.name).inc()
                raise QueueFullError(
                    cls.name, depth, self._retry_after_locked(cls)
                )
            task.enqueued_at = time.monotonic()
            # max-heap on priority, FIFO within: heapq is a min-heap,
            # so negate priority and tie-break on the admission seq
            heapq.heappush(
                cls.heap, (-task.priority, next(cls.seq), task)
            )
            self._depth_gauge.labels(cls.name).set(len(cls.heap))
            # lazy spawn up to the width, but only when the backlog
            # exceeds the workers already waiting for it — a burst of N
            # submits grows the pool, a trickle reuses the idle worker
            if cls.workers < cls.width and len(cls.heap) > cls.idle:
                cls.workers += 1
                threading.Thread(
                    target=self._worker,
                    args=(cls,),
                    daemon=True,
                    name=f"lo-sched-{cls.name}-{cls.workers}",
                ).start()
            cls.cond.notify()

    def _retry_after_locked(self, cls: _ClassQueue) -> int:
        """Deterministic Retry-After: the backlog drained at the
        class's observed (EWMA) per-job seconds across its width,
        clamped to [1, 60]."""
        estimate = cls.avg_run_s * (len(cls.heap) + 1) / max(1, cls.width)
        return max(1, min(60, math.ceil(estimate)))

    def _worker(self, cls: _ClassQueue) -> None:
        while True:
            with cls.cond:
                while not cls.heap and not self._closed:
                    cls.idle += 1
                    # timed wait (LO204): a lost notify — close() racing
                    # the wait, a worker dying mid-critical-section —
                    # degrades to a 1 s predicate re-check, not a
                    # parked-forever worker
                    cls.cond.wait(1.0)
                    cls.idle -= 1
                if self._closed:
                    cls.workers -= 1
                    return
                _, _, task = heapq.heappop(cls.heap)
                self._depth_gauge.labels(cls.name).set(len(cls.heap))
                cls.running += 1
                self._running_gauge.labels(cls.name).set(cls.running)
            task.wait_s = time.monotonic() - task.enqueued_at
            self._wait_seconds.labels(cls.name).observe(task.wait_s)
            started = time.monotonic()
            try:
                retry_delay = task.run(task)
            except Exception:  # noqa: BLE001 — run() owns job errors;
                # anything escaping is a scheduler bug and must not
                # kill the worker thread
                import traceback

                traceback.print_exc()
                retry_delay = None
            finally:
                with cls.cond:
                    cls.running -= 1
                    self._running_gauge.labels(cls.name).set(cls.running)
                    cls.avg_run_s = (
                        0.8 * cls.avg_run_s
                        + 0.2 * (time.monotonic() - started)
                    )
            if retry_delay is not None:
                self._retries_total.labels(cls.name).inc()
                self._schedule_requeue(task, retry_delay)

    def _schedule_requeue(self, task: Task, delay: float) -> None:
        task.attempt += 1

        def requeue() -> None:
            try:
                self.enqueue(task, requeue=True)
            except RuntimeError:
                # closed mid-backoff (test teardown / shutdown): the
                # journal's non-terminal tail makes the next process
                # re-enqueue it (recovery), so dropping here is safe
                pass

        timer = threading.Timer(delay, requeue)
        timer.daemon = True
        timer.start()

    def close(self) -> None:
        """Stop workers after the current job (tests; production
        relies on daemon threads dying with the process). Tasks still
        queued are NOT silently stranded: each is cancelled and run
        once — the cancelled token short-circuits execution into the
        job's terminal bookkeeping, so run_sync/wait callers wake with
        a CANCELLED record instead of blocking forever."""
        stranded: list[Task] = []
        for cls in self._classes.values():
            with cls.cond:
                # set under EACH class's lock (LO203): enqueue and the
                # workers read _closed under their class lock, so the
                # flag must be published under the same locks — after
                # this loop every class has observed it
                self._closed = True
                while cls.heap:
                    _, _, task = heapq.heappop(cls.heap)
                    stranded.append(task)
                self._depth_gauge.labels(cls.name).set(0)
                cls.cond.notify_all()
        for task in stranded:
            task.token.cancel("scheduler closed")
            try:
                task.run(task)
            except Exception:  # noqa: BLE001 — drain must not abort
                import traceback

                traceback.print_exc()
