"""Retry policy: transient-failure classification and seeded backoff.

Transient failures re-enqueue with exponential backoff plus
deterministic jitter up to a budget; terminal failures keep the
``finished: true`` + error contract (core/jobs.py). Determinism
matters twice: the jitter sequence is golden-testable, and a journal
replay after a crash re-derives the same delays the crashed process
would have used.

The port's copy of ``learningorchestra_tpu/sched/policy.py``, unchanged.
"""

from __future__ import annotations

import random

from learningorchestra_tpu_torch.sched import config


class TransientJobError(RuntimeError):
    """Raise from job code for failures worth retrying — a store
    failover window, a flaky download, a briefly-contended device
    runtime. Anything else (bad input, a bug) is terminal and keeps
    today's ``finished: true`` + error contract."""


# Exception type names (checked by name so this module never imports
# jax or the store client: parallel/spmd.py defines SpmdTimeoutError
# and core/store_service.py defines StoreUnavailableError, but
# importing either pulls heavy deps into every client process) that
# classify as transient alongside TransientJobError subclasses.
_TRANSIENT_TYPE_NAMES = frozenset(
    {"SpmdTimeoutError", "StoreUnavailableError"}
)


def is_transient(error: BaseException) -> bool:
    """Should this failure re-enqueue (budget permitting)?

    ``TransientJobError`` by contract; ``SpmdTimeoutError`` because the
    watchdog fires for worker-death *and* for overlong collectives —
    after the supervisor restarts the runtime the same job usually
    succeeds, so the retry rides out the restart window; the store
    client's ``StoreUnavailableError`` because a 503 is the replicated
    store's *transient* degraded state by contract — a read-only
    follower mid-takeover or a quorum-suspended minority primary
    answering 503 + Retry-After (docs/replication.md) — and the job
    usually succeeds once failover completes or the partition heals.
    Subclass checks are by type name to keep the heavy imports out of
    the graph.
    """
    if isinstance(error, TransientJobError):
        return True
    return any(
        cls.__name__ in _TRANSIENT_TYPE_NAMES
        for cls in type(error).__mro__
    )


def backoff_delay(
    name: str,
    attempt: int,
    base_s: float | None = None,
    cap_s: float | None = None,
    seed: int | None = None,
) -> float:
    """Delay before re-enqueueing ``name``'s attempt ``attempt`` (1 is
    the first retry): ``min(cap, base * 2**(attempt-1))`` scaled by a
    deterministic jitter in [0.75, 1.25] derived from (seed, name,
    attempt) — the same job retries on the same schedule on every
    process and every replay, while distinct jobs decorrelate instead
    of thundering back in lockstep."""
    if attempt < 1:
        raise ValueError(f"attempt must be >= 1, got {attempt}")
    base_s = config.backoff_base_s() if base_s is None else base_s
    cap_s = config.backoff_cap_s() if cap_s is None else cap_s
    seed = config.jitter_seed() if seed is None else seed
    raw = min(cap_s, base_s * (2.0 ** (attempt - 1)))
    jitter = random.Random(f"{seed}:{name}:{attempt}").uniform(0.75, 1.25)
    return raw * jitter
