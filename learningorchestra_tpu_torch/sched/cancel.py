"""Cooperative cancellation tokens with per-job deadlines.

A scheduler worker cannot preempt a thread mid-fit; cancellation is
cooperative, like Ray's ``ray.cancel`` on actor tasks: the token flips,
and the job notices at its next :func:`check_cancelled` — the builder's
phase loop checks between classifier fits and phases (ml/builder.py).
Deadlines ride the same token: a queued job past its deadline fails at
dequeue without ever starting; a running one fails at its next check.

The ambient token is a ``contextvars`` binding (like telemetry tracing),
so library code calls :func:`check_cancelled` unconditionally — it is a
no-op outside a scheduled job, and on SPMD *worker* processes, which
never carry a token; only the coordinator's job raises. Note the
consequence on a multi-host mesh: cancelling a RUNNING device job aborts
the coordinator mid-collective-stream, which poisons the dispatcher
exactly like any other mid-job failure (parallel/spmd.py) and hands
recovery to the supervisor's restart policy. Cancelling a QUEUED device
job is always clean.

The port's copy of ``learningorchestra_tpu/sched/cancel.py``, unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, Optional


class JobCancelledError(Exception):
    """The job was cancelled (``DELETE /jobs/<name>``)."""


class JobTimeoutError(JobCancelledError):
    """The job exceeded its deadline. A :class:`JobCancelledError`
    subclass so one ``check()`` call covers both; the manager maps it
    to FAILED (the job did not do what was asked) while an explicit
    cancel maps to CANCELLED."""


class CancelToken:
    """One job's cancellation state. ``cancel()`` may be called from
    any thread; ``check()`` raises on the job's own thread."""

    __slots__ = ("deadline", "_reason")

    def __init__(self, deadline: Optional[float] = None):
        # monotonic-clock deadline; None = no deadline
        self.deadline = deadline
        self._reason: Optional[str] = None

    @property
    def cancelled(self) -> bool:
        return self._reason is not None

    def cancel(self, reason: str = "cancelled") -> None:
        self._reason = reason

    def check(self) -> None:
        if self._reason is not None:
            raise JobCancelledError(self._reason)
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise JobTimeoutError("job deadline exceeded")


_TOKEN: contextvars.ContextVar[Optional[CancelToken]] = (
    contextvars.ContextVar("lo_cancel_token", default=None)
)


def current_token() -> Optional[CancelToken]:
    return _TOKEN.get()


@contextlib.contextmanager
def bind(token: Optional[CancelToken]) -> Iterator[None]:
    """Make ``token`` the ambient token for the executing job."""
    reset = _TOKEN.set(token)
    try:
        yield
    finally:
        _TOKEN.reset(reset)


def check_cancelled() -> None:
    """Raise if the ambient job was cancelled or passed its deadline;
    no-op without a token (library code outside a scheduled job, SPMD
    worker processes)."""
    token = _TOKEN.get()
    if token is not None:
        token.check()
