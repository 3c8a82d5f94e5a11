"""Scheduler knobs, env-configurable with validation.

Every knob is read at Scheduler/JobManager construction (not import), so
tests monkeypatch the environment and deployments restart to change
them. A malformed value raises immediately with the offending text —
a scheduler silently running at a default width after a typo'd
``LO_JOB_WORKERS=eight`` is exactly the misconfiguration that only
shows up as mystery queueing under load.

Knob table (documented in docs/scheduler.md):

===========================  =======  =====================================
env var                      default  meaning
===========================  =======  =====================================
``LO_JOB_WORKERS``           8        host-class concurrency width
``LO_SCHED_DEVICE_WIDTH``    1        device-class concurrency width
``LO_SCHED_QUEUE_CAP``       64       per-class queued-job cap (429 past it)
``LO_SCHED_RETRIES``         3        max attempts for transient failures
``LO_SCHED_BACKOFF_S``       0.5      backoff base (doubles per attempt)
``LO_SCHED_BACKOFF_CAP_S``   60       backoff ceiling before jitter
``LO_SCHED_SEED``            0        jitter seed (deterministic replay)
``LO_SCHED_TIMEOUT_S``       0        default per-job deadline (0 = none)
``LO_JOB_HISTORY``           512      terminal job records kept in memory
``LO_JOB_TTL_S``             3600     terminal record retention seconds
``LO_COALESCE_WINDOW_MS``    2.0      job-coalescing collection window in
                                      milliseconds (``0`` = passthrough:
                                      every device job dispatches alone)
``LO_COALESCE_MAX_JOBS``     32       max member jobs fused into one
                                      vmap-across-jobs dispatch
``LO_RESUME``                1        crash resume: orphaned RUNNING jobs
                                      with a resumable op re-enqueue with
                                      their journaled progress instead of
                                      going FAILED (strict 0/1)
``LO_RESUME_EVERY_SEGMENTS`` 1        persist a fit-progress artifact every
                                      N segments (integral >= 1; higher =
                                      less checkpoint I/O, more recompute
                                      after a crash)
===========================  =======  =====================================

The port's copy of ``learningorchestra_tpu/sched/config.py``, unchanged.
"""

from __future__ import annotations

import os


def _int_env(name: str, default: int, minimum: int = 1) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer, got {raw!r}"
        ) from None
    if value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return value


def _float_env(name: str, default: float, minimum: float = 0.0) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None
    if value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return value


def host_width() -> int:
    """Concurrency width for host-bound jobs — replaces the hardcoded
    ``ThreadPoolExecutor(max_workers=8)`` the JobManager used to own."""
    return _int_env("LO_JOB_WORKERS", 8)


def device_width() -> int:
    """Concurrency width for device-bound jobs. Default 1: two SPMD
    dispatches must never contend for the mesh."""
    return _int_env("LO_SCHED_DEVICE_WIDTH", 1)


def queue_cap() -> int:
    """Max queued (not yet running) jobs per class before admission
    control rejects with 429 + Retry-After."""
    return _int_env("LO_SCHED_QUEUE_CAP", 64)


def retry_budget() -> int:
    """Max attempts (first run + retries) for transient failures."""
    return _int_env("LO_SCHED_RETRIES", 3)


def backoff_base_s() -> float:
    return _float_env("LO_SCHED_BACKOFF_S", 0.5)


def backoff_cap_s() -> float:
    return _float_env("LO_SCHED_BACKOFF_CAP_S", 60.0)


def jitter_seed() -> int:
    return _int_env("LO_SCHED_SEED", 0, minimum=-(2**62))


def default_timeout_s() -> float:
    """Default per-job deadline; 0 disables."""
    return _float_env("LO_SCHED_TIMEOUT_S", 0.0)


def job_history() -> int:
    """Terminal JobRecords kept in the manager's in-memory map."""
    return _int_env("LO_JOB_HISTORY", 512)


def job_ttl_s() -> float:
    """Terminal JobRecord retention before TTL eviction."""
    return _float_env("LO_JOB_TTL_S", 3600.0)


def coalesce_window_s() -> float:
    """The job-coalescing collection window, converted to seconds.
    ``0`` disables coalescing entirely (passthrough: every coalescible
    device job runs as its own dispatch)."""
    return _float_env("LO_COALESCE_WINDOW_MS", 2.0, 0.0) / 1000.0


def resume_enabled() -> bool:
    """Crash resume for device jobs (docs/robustness.md). Strict 0/1:
    ``LO_RESUME=yes`` silently meaning "off" (or "on") is exactly the
    ambiguity the deploy preflight exists to refuse."""
    raw = os.environ.get("LO_RESUME", "").strip()
    if not raw:
        return True
    if raw not in ("0", "1"):
        raise ValueError(f"LO_RESUME must be 0 or 1, got {raw!r}")
    return raw == "1"


def resume_every_segments() -> int:
    """Persist a fit-progress artifact every N segments. Strictly
    integral >= 1 — ``1.5`` silently truncating would double the
    recompute window an operator thought they configured."""
    return _int_env("LO_RESUME_EVERY_SEGMENTS", 1)


def coalesce_max_jobs() -> int:
    """Max member jobs fused into one vmap-across-jobs dispatch.
    Strictly integral (``1.5`` must not silently truncate) and >= 1;
    also bounds the fused dispatch's device working set — the job axis
    multiplies every member's arrays."""
    return _int_env("LO_COALESCE_MAX_JOBS", 32)
