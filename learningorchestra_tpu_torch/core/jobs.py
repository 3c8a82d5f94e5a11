"""Asynchronous job management with explicit states.

The reference's only job abstraction is the ``finished`` boolean on a
dataset's metadata document: a service writes ``finished: false``, does
work on daemon threads, and flips it to ``true``; a crashed job leaves
``finished: false`` forever and clients poll indefinitely (reference:
microservices/database_api_image/database.py:199-216,
learning_orchestra_client/__init__.py:24-32).

This JobManager keeps that wire contract (so unchanged clients still
poll ``finished``) but adds real states — PENDING/RUNNING/FINISHED/
FAILED/CANCELLED with an error payload and timings — and, on terminal
failure, *still* flips ``finished`` on the tracked dataset so pollers
terminate, while recording the error in the metadata document.

The manager owns no thread pool: :meth:`JobManager.submit` admits work
into the scheduler's class-aware priority queue (device-bound jobs run
one at a time on the card; host-bound jobs at ``LO_JOB_WORKERS``) and
this module executes what the scheduler admits, with transient-failure
retries under seeded backoff, per-job deadlines, cooperative
cancellation (``DELETE /jobs/<name>``) and a durable journal
(``sched/journal.py``) the next process replays after a crash
(``sched/recovery.py``).

The port's copy of ``learningorchestra_tpu/core/jobs.py``.
"""

from __future__ import annotations

import contextvars
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

from learningorchestra_tpu_torch.core.store import METADATA_ID, ROW_ID, DocumentStore
from learningorchestra_tpu_torch.sched import cancel as _cancel
from learningorchestra_tpu_torch.sched import config as _config
from learningorchestra_tpu_torch.sched import policy as _policy
from learningorchestra_tpu_torch.sched.cancel import (
    CancelToken,
    JobCancelledError,
    JobTimeoutError,
)
from learningorchestra_tpu_torch.sched.scheduler import (
    HOST_CLASS,
    QueueFullError,
    Scheduler,
    Task,
)
from learningorchestra_tpu_torch.telemetry import metrics as _metrics
from learningorchestra_tpu_torch.telemetry import tracing as _tracing

PENDING = "pending"
RUNNING = "running"
FINISHED = "finished"
FAILED = "failed"
CANCELLED = "cancelled"

TERMINAL_STATES = (FINISHED, FAILED, CANCELLED)


class DuplicateJobError(ValueError):
    """The job name is already PENDING/RUNNING. A ValueError subclass so
    existing ``except ValueError`` duplicate handling keeps working —
    but catchable specifically, which matters for callers whose job
    function can itself raise ValueError (the sync model build must not
    mistake a failed build for "already active" and run it twice)."""


@dataclass
class JobRecord:
    name: str
    state: str = PENDING
    error: Optional[str] = None
    submitted_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    ended_at: Optional[float] = None
    job_class: str = HOST_CLASS
    priority: int = 0
    # attempts completed or underway; 0 until first execution starts
    attempts: int = 0
    # The request's correlation ID and span tree: submit() binds the
    # job to a Trace carrying the submitting request's ID, the worker
    # opens the root span, and everything the work emits (PhaseTimer
    # phases, SPMD dispatch spans) nests under it — served by
    # GET /jobs/<name>/trace (utils/web.register_job_routes).
    trace: Optional[_tracing.Trace] = None
    # the terminal exception object, re-raised by run_sync so the
    # synchronous REST surface keeps reference-parity 500 bodies
    exception: Optional[BaseException] = field(default=None, repr=False)
    # journal this job's lifecycle? Ephemeral synchronous work (no
    # replay op, no tracked collection, a waiter who sees the failure
    # directly) skips the journal: 3+ store writes per request with
    # zero recovery value would grow __lo_jobs__ for nothing.
    journaled: bool = field(default=True, repr=False)
    # the dataset this job materialises (the filename clients know).
    # GET /jobs/<name>/wait resolves a bare filename through this, so
    # a client that only knows "titanic" finds "ingest:titanic".
    collection: Optional[str] = None
    # structured per-job detail the work itself attaches while running
    # (JobHandle.annotate) — e.g. a multi-classifier build's per-name
    # outcome map when one member fails (``finished_partial``). Rides
    # as_dict, so GET /jobs/<name> and the /wait terminal body surface
    # it without route changes.
    detail: Optional[dict] = None

    @property
    def correlation_id(self) -> Optional[str]:
        return self.trace.correlation_id if self.trace is not None else None

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "state": self.state,
            "error": self.error,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "ended_at": self.ended_at,
            "job_class": self.job_class,
            "priority": self.priority,
            "attempts": self.attempts,
            "correlation_id": self.correlation_id,
            "collection": self.collection,
            "detail": self.detail,
        }

    def trace_dict(self) -> dict:
        out = self.as_dict()
        out["trace"] = self.trace.as_dict() if self.trace is not None else None
        return out


class JobHandle:
    """The running job's back-channel to its own record and journal.

    Bound by the worker around ``fn`` (:func:`current_job_handle`), so
    deep work — the model builder, several layers below the JobManager —
    can attach structured detail and journal ``progress`` events without
    threading the manager through every signature. NOTE: contextvars do
    not cross thread-pool boundaries; work that fans out (the builder's
    per-classifier pool) must capture the handle once at entry and pass
    it explicitly.
    """

    def __init__(self, manager: "JobManager", record: JobRecord):
        self._manager = manager
        self._record = record

    @property
    def name(self) -> str:
        return self._record.name

    def annotate(self, **detail) -> None:
        """Merge fields into the record's ``detail`` dict (whole-dict
        replace, so a concurrent as_dict never sees a half-written
        map)."""
        merged = dict(self._record.detail or {})
        merged.update(detail)
        self._record.detail = merged

    def progress(self, **fields) -> None:
        """Append a durable ``progress`` event to the job journal —
        best-effort, like every journal write; recovery folds these
        into the resume payload for an orphaned RUNNING job."""
        self._manager._journal_event(self._record, "progress", **fields)


_JOB_HANDLE: contextvars.ContextVar[Optional[JobHandle]] = (
    contextvars.ContextVar("lo_job_handle", default=None)
)


def current_job_handle() -> Optional[JobHandle]:
    """The JobHandle of the job running on this thread, or None for
    work executed outside the JobManager (library use, tests)."""
    return _JOB_HANDLE.get()


class JobManager:
    """Tracked execution of what the scheduler admits.

    ``scheduler`` may be shared across services (the runner shares one
    so the device class serializes process-wide); by default each
    manager owns a private one sized from the env knobs.
    ``max_workers`` keeps the old constructor signature working and
    overrides the host-class width.
    """

    def __init__(
        self,
        max_workers: Optional[int] = None,
        scheduler: Optional[Scheduler] = None,
    ):
        self._scheduler = scheduler or Scheduler(host_width=max_workers)
        self._jobs: dict[str, JobRecord] = {}
        self._lock = threading.Lock()
        self._events: dict[str, threading.Event] = {}
        self._tasks: dict[str, Task] = {}
        # push-notification hooks: GET /jobs/<name>/wait parks a waiter
        # and registers its notify here; _finalize fires them after the
        # record goes terminal (utils/webloop.Waiter)
        self._done_callbacks: dict[str, list[Callable[[], None]]] = {}
        self._max_history = _config.job_history()
        self._ttl_s = _config.job_ttl_s()
        self._retry_budget = _config.retry_budget()
        self._default_timeout_s = _config.default_timeout_s()
        registry = _metrics.global_registry()
        self._jobs_total = registry.counter(
            "lo_jobs_total",
            "Jobs reaching a terminal state",
            labels=("state",),
        )
        self._jobs_running = registry.gauge(
            "lo_jobs_running", "Jobs currently executing"
        )
        self._job_seconds = registry.histogram(
            "lo_job_duration_seconds", "Job wall-clock, submit to done"
        )
        self._cancelled_total = registry.counter(
            "lo_sched_cancelled_total",
            "Jobs cancelled via DELETE /jobs/<name>",
        )

    @property
    def scheduler(self) -> Scheduler:
        return self._scheduler

    @property
    def journal(self):
        return self._scheduler.journal

    def submit(
        self,
        name: str,
        fn: Callable,
        *args,
        store: Optional[DocumentStore] = None,
        collection: Optional[str] = None,
        job_class: str = HOST_CLASS,
        priority: int = 0,
        timeout: Optional[float] = None,
        replay: Optional[tuple[str, dict]] = None,
        token: Optional[CancelToken] = None,
        **kwargs,
    ) -> JobRecord:
        """Admit ``fn`` into ``job_class``'s queue. If ``store``/
        ``collection`` are given, a terminal failure marks that
        dataset's metadata ``finished: true`` with an ``error`` field so
        pollers terminate instead of hanging. ``replay=(op, payload)``
        journals enough lineage for a restarted process to re-enqueue
        the job if it never started (sched/recovery.py). ``token``
        injects a caller-held :class:`CancelToken` — the coalescing
        stage needs the token visible on the member BEFORE the task
        exists, so a leader can mask a cancelled member out of its
        fused dispatch (sched/coalesce.py).

        Raises :class:`DuplicateJobError` if ``name`` is active and
        :class:`QueueFullError` (→ HTTP 429) at the class's queue cap.
        """
        record, _ = self._submit(
            name,
            fn,
            args,
            kwargs,
            store,
            collection,
            job_class,
            priority,
            timeout,
            replay,
            token=token,
        )
        return record

    def _submit(
        self,
        name: str,
        fn: Callable,
        args: tuple,
        kwargs: dict,
        store: Optional[DocumentStore],
        collection: Optional[str],
        job_class: str,
        priority: int,
        timeout: Optional[float],
        replay: Optional[tuple[str, dict]],
        keep_exception: bool = False,
        journaled: bool = True,
        token: Optional[CancelToken] = None,
    ) -> tuple[JobRecord, threading.Event]:
        # Cheap rejection first: a flood past the cap must not pay the
        # journal's store writes per rejected request (enqueue below
        # still closes the admit race authoritatively).
        self._scheduler.check_admission(job_class)
        if timeout is None:
            timeout = self._default_timeout_s
        if token is None:
            token = CancelToken(
                deadline=time.monotonic() + timeout if timeout else None
            )
        elif token.deadline is None and timeout:
            token.deadline = time.monotonic() + timeout
        op, payload = replay if replay is not None else (None, None)
        record = JobRecord(
            name=name,
            job_class=job_class,
            priority=priority,
            journaled=journaled,
            collection=collection,
            trace=_tracing.Trace(
                # a job submitted from a REST handler inherits the
                # request's correlation ID; elsewhere a fresh one
                _tracing.current_correlation_id(),
                name=name,
            ),
        )
        done = threading.Event()

        def run(task: Task) -> Optional[float]:
            return self._execute(
                task,
                record,
                done,
                fn,
                args,
                kwargs,
                store,
                collection,
                keep_exception,
            )

        task = Task(name, job_class, priority, run, token=token)
        # record, event, and task publish atomically: a cancel() that
        # sees the record must also see the task, or its 202 would
        # acknowledge a cancellation that never flips the token
        with self._lock:
            existing = self._jobs.get(name)
            if existing is not None and existing.state not in TERMINAL_STATES:
                raise DuplicateJobError(
                    f"job {name!r} is already {existing.state}"
                )
            self._evict_locked()
            self._jobs[name] = record
            self._events[name] = done
            self._tasks[name] = task
        self._journal_event(
            record,
            "submitted",
            job_class=job_class,
            priority=priority,
            op=op,
            payload=payload,
            collection=collection,
            cid=record.correlation_id,
        )
        try:
            self._scheduler.enqueue(task)
        except QueueFullError:
            self._journal_event(record, "rejected")
            # Deliberate two-phase publish (register → enqueue →
            # rollback on rejection): the identity check makes the
            # rollback surgical, and the worst interleaving is a
            # cancel() 202-ing a job that was never admitted — the
            # journal's "rejected" event is the durable truth.
            with self._lock:  # lo: allow[LO205]
                if self._jobs.get(name) is record:
                    del self._jobs[name]
                    self._events.pop(name, None)
                    self._tasks.pop(name, None)
                    # waiters that raced in hit their timeout and re-poll
                    self._done_callbacks.pop(name, None)
            raise
        return record, done

    def run_sync(
        self,
        name: str,
        fn: Callable,
        *args,
        store: Optional[DocumentStore] = None,
        collection: Optional[str] = None,
        job_class: str = HOST_CLASS,
        priority: int = 0,
        timeout: Optional[float] = None,
        replay: Optional[tuple[str, dict]] = None,
        token: Optional[CancelToken] = None,
        **kwargs,
    ) -> JobRecord:
        """Submit and block until terminal; re-raise the job's own
        exception. The synchronous REST routes (projection, histogram,
        fieldtypes, embeddings, the reference-parity sync model build)
        run through this so they get admission control and device-class
        serialization while keeping their blocking contract — the
        request thread waits, a scheduler worker executes."""
        record, done = self._submit(
            name,
            fn,
            args,
            kwargs,
            store,
            collection,
            job_class,
            priority,
            timeout,
            replay,
            keep_exception=True,
            token=token,
            # the caller waits and sees the failure directly; without a
            # replay op or a polled collection the journal could only
            # ever mark this 'orphaned' at restart — skip the writes
            journaled=replay is not None or collection is not None,
        )
        # the event captured at registration, NOT re-read by name: a
        # terminal job's name is reusable, and a lookup could pair this
        # record with a successor's still-unset event
        done.wait()
        if record.state != FINISHED:
            # detach before re-raising: the record outlives this
            # request by up to LO_JOB_TTL_S, and the traceback would
            # pin every frame of the failed job (feature matrices,
            # device buffers) for that whole window
            error = record.exception
            record.exception = None
            if error is not None:
                raise error
            raise RuntimeError(record.error or f"job {name!r} {record.state}")
        return record

    def _evict_locked(self) -> None:
        """Bound the record map: terminal records expire by TTL and by
        max-count (oldest-ended first). Terminal-state counters are
        monotonic regardless (they incremented at finalize), and
        ``/jobs`` simply stops listing evicted history. Active jobs are
        never evicted."""
        now = time.time()
        expired = [
            name
            for name, record in self._jobs.items()
            if record.state in TERMINAL_STATES
            and record.ended_at is not None
            and now - record.ended_at > self._ttl_s
        ]
        overflow = len(self._jobs) - len(expired) + 1 - self._max_history
        if overflow > 0:
            survivors = sorted(
                (
                    (record.ended_at or 0.0, name)
                    for name, record in self._jobs.items()
                    if record.state in TERMINAL_STATES and name not in expired
                ),
            )
            expired.extend(name for _, name in survivors[:overflow])
        for name in expired:
            del self._jobs[name]
            self._events.pop(name, None)
            self._tasks.pop(name, None)
            self._done_callbacks.pop(name, None)

    def _journal_event(self, record: JobRecord, event: str, **fields) -> None:
        journal = self._scheduler.journal
        if journal is not None and record.journaled:
            journal.append(record.name, event, **fields)

    def _execute(
        self,
        task: Task,
        record: JobRecord,
        done: threading.Event,
        fn: Callable,
        args: tuple,
        kwargs: dict,
        store: Optional[DocumentStore],
        collection: Optional[str],
        keep_exception: bool = False,
    ) -> Optional[float]:
        """Run one admitted attempt on the scheduler worker. Returns a
        backoff delay to retry a transient failure, or None when the
        record reached a terminal state. ``keep_exception`` parks the
        terminal exception on the record for run_sync to re-raise;
        async jobs skip it so a failed build cannot pin its frames
        (feature matrices, device buffers) until record eviction."""
        def finalize_interrupted(error: JobCancelledError) -> None:
            """One terminal path for deadline/cancel, before OR during
            execution: timeout → FAILED (the job did not do what was
            asked), explicit cancel → CANCELLED."""
            if isinstance(error, JobTimeoutError):
                self._finalize(
                    record,
                    done,
                    FAILED,
                    f"JobTimeoutError: {error}",
                    error,
                    store,
                    collection,
                    keep_exception,
                    task=task,
                )
            else:
                self._finalize(
                    record,
                    done,
                    CANCELLED,
                    f"JobCancelledError: {error}",
                    error,
                    store,
                    collection,
                    keep_exception,
                    task=task,
                )
                self._cancelled_total.inc()

        try:
            # expired or cancelled while QUEUED: terminal without ever
            # journaling "started" or counting an attempt
            task.token.check()
        except JobCancelledError as interruption:  # incl. JobTimeoutError
            finalize_interrupted(interruption)
            return None
        record.state = RUNNING
        record.started_at = record.started_at or time.time()
        record.attempts = task.attempt
        self._jobs_running.inc()
        self._journal_event(record, "started", attempt=task.attempt)
        error: Optional[BaseException] = None
        handle_token = _JOB_HANDLE.set(JobHandle(self, record))
        try:
            with _cancel.bind(task.token), _tracing.activate(
                record.trace
            ), _tracing.span(
                f"job:{record.name}",
                job_class=task.job_class,
                attempt=task.attempt,
                queue_wait_s=round(task.wait_s, 6),
            ):
                fn(*args, **kwargs)
        except BaseException as caught:  # noqa: BLE001 — classified below
            error = caught
        finally:
            _JOB_HANDLE.reset(handle_token)
            self._jobs_running.dec()
        if error is None:
            self._finalize(
                record, done, FINISHED, None, None, store, collection, False,
                task=task,
            )
            return None
        if isinstance(error, JobCancelledError):  # incl. JobTimeoutError
            finalize_interrupted(error)
            return None
        if (
            _policy.is_transient(error)
            and task.attempt < self._retry_budget
            and not task.token.cancelled
        ):
            delay = _policy.backoff_delay(record.name, task.attempt)
            record.state = PENDING
            record.error = (
                f"{type(error).__name__}: {error} "
                f"(attempt {task.attempt}/{self._retry_budget}, "
                f"retrying in {delay:.2f}s)"
            )
            self._journal_event(
                record,
                "retry",
                attempt=task.attempt,
                delay_s=round(delay, 3),
                error=record.error,
            )
            return delay
        traceback.print_exception(type(error), error, error.__traceback__)
        self._finalize(
            record,
            done,
            FAILED,
            f"{type(error).__name__}: {error}",
            error,
            store,
            collection,
            keep_exception,
            task=task,
        )
        return None

    def _finalize(
        self,
        record: JobRecord,
        done: threading.Event,
        state: str,
        error: Optional[str],
        exception: Optional[BaseException],
        store: Optional[DocumentStore],
        collection: Optional[str],
        keep_exception: bool = False,
        task: "Optional[Task]" = None,
    ) -> None:
        try:
            record.state = state
            record.error = error
            record.exception = exception if keep_exception else None
            record.ended_at = time.time()
            started = record.started_at or record.submitted_at
            self._jobs_total.labels(state).inc()
            self._job_seconds.observe(record.ended_at - started)
            if (
                state in (FAILED, CANCELLED)
                and store is not None
                and collection is not None
            ):
                # the reference's hang: a dead job leaving finished:
                # false forever — every terminal non-success flips the
                # flag. Best-effort: a store that is down mid-failover
                # must not stop the record from finalizing.
                try:
                    store.update_one(
                        collection,
                        {ROW_ID: METADATA_ID},
                        {"finished": True, "error": error},
                    )
                except Exception:  # noqa: BLE001
                    traceback.print_exc()
            self._journal_event(record, state, error=error)
            if record.trace is not None:
                # cross-process stitching: the job's span tree (cid
                # inherited from the submitting request) joins the
                # export buffer at terminal state, where it is complete
                _tracing.export_trace(record.trace, service="jobs")
            with self._lock:
                # identity check: after record.state went terminal a
                # same-name successor may have registered its own task,
                # and popping THAT would turn its DELETE into a no-op
                if task is not None and self._tasks.get(record.name) is task:
                    self._tasks.pop(record.name)
        finally:
            # waiters MUST wake no matter what failed above — a hung
            # done event is this subsystem's cardinal sin
            done.set()
            # Push hooks fire AFTER the terminal state is visible. Pop
            # under the lock: add_done_callback also holds it, so a
            # registration either lands before this pop (fired here) or
            # observes the terminal state and fires immediately — no
            # callback is ever lost. A same-name successor registered
            # after this record went terminal can at worst receive a
            # spurious notify; waiters re-poll and re-park on those.
            with self._lock:
                callbacks = self._done_callbacks.pop(record.name, [])
            for callback in callbacks:
                try:
                    callback()
                except Exception:  # noqa: BLE001 — a waiter's bug
                    traceback.print_exc()  # must not mask others' wake

    def cancel(self, name: str) -> str:
        """Request cancellation: ``"unknown"`` (→404), ``"terminal"``
        (→409, already done), or ``"cancelling"`` (→202). Cooperative:
        a queued job terminates when a worker drains to it; a running
        one at its next ``check_cancelled()``."""
        with self._lock:
            record = self._jobs.get(name)
            task = self._tasks.get(name)
        if record is None:
            return "unknown"
        if record.state in TERMINAL_STATES:
            return "terminal"
        if task is not None:
            task.token.cancel(f"job {name!r} cancelled by request")
        return "cancelling"

    def add_done_callback(self, name: str, callback: Callable[[], None]) -> str:
        """Register ``callback`` to fire once job ``name`` reaches a
        terminal state — the push half of ``GET /jobs/<name>/wait``.
        Returns ``"unknown"`` (no such job), ``"terminal"`` (already
        done — the callback fired before returning), or
        ``"registered"``. Callbacks must be cheap and thread-safe:
        they run on the finalizing scheduler worker."""
        with self._lock:
            record = self._jobs.get(name)
            if record is None:
                return "unknown"
            if record.state in TERMINAL_STATES:
                fire_now = True
            else:
                self._done_callbacks.setdefault(name, []).append(callback)
                fire_now = False
        if fire_now:
            callback()
            return "terminal"
        return "registered"

    def resolve_wait(self, name: str) -> Optional[JobRecord]:
        """The record ``GET /jobs/<name>/wait`` should watch: an exact
        job-name match first, else the newest job materialising ``name``
        as its collection — clients know dataset filenames ("titanic"),
        while jobs carry prefixed names ("ingest:titanic")."""
        with self._lock:
            record = self._jobs.get(name)
            if record is not None:
                return record
            best: Optional[JobRecord] = None
            for candidate in self._jobs.values():
                if candidate.collection != name:
                    continue
                if best is None or candidate.submitted_at >= best.submitted_at:
                    best = candidate
            return best

    def get(self, name: str) -> Optional[JobRecord]:
        with self._lock:
            return self._jobs.get(name)

    def wait(self, name: str, timeout: Optional[float] = None) -> JobRecord:
        # snapshot under the lock: a concurrent _register for the same
        # name swaps BOTH maps, and the unlocked `self._jobs[name]`
        # this used to do could pair the old event with the new record
        with self._lock:
            record = self._jobs.get(name)
            event = self._events.get(name)
        if event is None or record is None:
            raise KeyError(f"unknown job {name!r}")
        if not event.wait(timeout):
            raise TimeoutError(f"job {name!r} still {record.state}")
        return record

    def all_jobs(self) -> list[dict]:
        with self._lock:
            return [record.as_dict() for record in self._jobs.values()]


_MANAGER: Optional[JobManager] = None
_MANAGER_LOCK = threading.Lock()


def global_job_manager() -> JobManager:
    global _MANAGER
    with _MANAGER_LOCK:
        if _MANAGER is None:
            _MANAGER = JobManager()
        return _MANAGER
