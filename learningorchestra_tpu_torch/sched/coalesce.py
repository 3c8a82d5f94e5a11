"""Job coalescing: many shape-compatible device jobs, one fused dispatch.

The device class is deliberately width-1 (two SPMD dispatches must never
contend for the mesh), which turns a flood of small builds from many
users into a serial queue: one dispatch per job, the accelerator mostly
idle between them. The serving lane already proved the fix for
predictions (serve/batcher.py: 64 concurrent clients → mean batch 35.6,
ONE padded forward). This module lifts that pattern to whole device
JOBS: shape-compatible jobs arriving within ``LO_COALESCE_WINDOW_MS``
fuse into ONE dispatch over a job axis, with the job axis padded to
the shared quarter-octave shape grid (utils/shapegrid.py) so coalesced
batch sizes share compiled programs instead of causing a compile storm.

How it rides the existing scheduler — no second queue, no second worker
pool:

1. A coalescible job registers a :class:`Member` (its prepared payload +
   compatibility key) and then submits through the JobManager into the
   DEVICE class exactly like any other job — its own
   ``JobRecord`` (``core/jobs.py``), journal entry,
   cancellation token, 429 admission, everything.
2. The first member task to reach a device worker claims LEADERSHIP of
   its key: it collects every registered-but-not-yet-executed compatible
   member (waiting up to the window for stragglers, exactly like the
   MicroBatcher — and while a fused dispatch runs, the next burst piles
   into the pending set, which is what makes the next dispatch a batch),
   masks out cancelled members, and runs the group's batched runner
   ONCE.
3. When a collected member's own task later drains from the queue, its
   result is already delivered: the task consumes it instantly —
   returning the member's own result, raising the member's OWN error
   (a mid-batch failure never touches its neighbors; per-member host
   prep failures are isolated by the runner contract below), or raising
   its cancellation. Per-member record/journal/trace semantics from the
   scheduler subsystem are therefore completely unchanged.

Keying reuses the devcache discipline (core/devcache.py): a key is a
hashable tuple covering everything that must match for two jobs to share
one compiled program — job kind, feature width, padded row counts (the
quarter-octave row grid makes nearby dataset sizes land on one padded
shape, so compatibility is common, not lucky), class count, dtype
policy, hyperparameter schedule, and the mesh signature.

Runner contract: ``runner(payloads) -> [outcome, ...]`` (same order),
where each outcome is ``("ok", result)`` or ``("error", exception)`` —
one per payload, so a member whose data fails host-side validation
fails ALONE while its batch-mates proceed. A runner that raises
wholesale fails every live member of that batch with the same error
(the fused program itself died — there is no per-member verdict to
give). Results may carry a ``"_attribution"`` dict (rows/bytes); the
consuming member task re-emits it as a span on its OWN job trace, so
the flight recorder splits the fused dispatch back into per-job
rows/bytes accounting.

The port's copy of ``learningorchestra_tpu/sched/coalesce.py``: the same
stage, its imports pointed at the port. The fused dispatch is the port's
job-axis programs (ml/sweep.py: hand-written CUDA kernels with a job
axis, not a ``vmap``). The JobManager and scheduler come with the
builder; until then a caller runs ``run_member`` on its own thread.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from learningorchestra_tpu_torch.sched import config
from learningorchestra_tpu_torch.sched.cancel import CancelToken, JobCancelledError
from learningorchestra_tpu_torch.telemetry import tracing as _tracing
from learningorchestra_tpu_torch.testing import faults as _faults

# Member lifecycle (all transitions under the coalescer's condition
# lock). PENDING → LEADER when the member's own task reaches a worker
# first; PENDING → CLAIMED when another leader collects it into a fused
# batch; PENDING → ABANDONED when its submission failed after
# registration (queue cap, duplicate name) and no task will ever run.
PENDING = "pending"
LEADER = "leader"
CLAIMED = "claimed"
ABANDONED = "abandoned"

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class Member:
    """One coalescible job's slot in the stage: payload in, exactly one
    of result / error / skipped out, handed across threads via the done
    event (delivery writes happen-before the event set; only ``state``
    needs the lock)."""

    __slots__ = (
        "key", "payload", "runner", "token", "name",
        "state", "result", "error", "skipped", "_done",
    )

    def __init__(
        self,
        key: tuple,
        payload: Any,
        runner: Callable,
        token: Optional[CancelToken],
        name: str,
    ):
        self.key = key
        self.payload = payload
        self.runner = runner
        self.token = token
        self.name = name
        self.state = PENDING
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.skipped = False
        self._done = threading.Event()

    def deliver(self) -> None:
        self._done.set()

    @property
    def delivered(self) -> bool:
        return self._done.is_set()


class Coalescer:
    """The coalescing stage in front of the device class.

    Holds no threads of its own: leaders are whichever scheduler worker
    reaches a member task first, so the device class's width discipline
    (and its admission control) is untouched. ``window_s == 0`` is pure
    passthrough — members skip the pending set entirely and every task
    runs its own single-job dispatch through the same runner, which
    keeps the passthrough and fused paths on identical code (and, with
    the job axis padded to one grid value, identical numerics).
    """

    def __init__(
        self,
        window_s: Optional[float] = None,
        max_jobs: Optional[int] = None,
    ):
        self.window_s = (
            config.coalesce_window_s() if window_s is None else window_s
        )
        self.max_jobs = (
            config.coalesce_max_jobs() if max_jobs is None else max_jobs
        )
        self._cond = threading.Condition()
        self._pending: dict[tuple, list[Member]] = {}
        # instance counters for stats(); the process-wide prometheus
        # families are module-level (one registry entry per process)
        self._fused = 0
        self._members = 0
        self._masked = 0
        self._metrics = _coalesce_metrics()

    # --- registration (request/submit threads) -------------------------------
    def register(
        self,
        key: tuple,
        payload: Any,
        runner: Callable,
        token: Optional[CancelToken] = None,
        name: str = "",
    ) -> Member:
        """Make a member visible to leaders. Call BEFORE submitting its
        job (prep must precede the device queue: a leader can only stack
        payloads that already exist), then hand ``run_member`` to the
        JobManager as the job function with the SAME token."""
        member = Member(key, payload, runner, token, name)
        if self.window_s > 0 and self.max_jobs > 1:
            with self._cond:
                self._pending.setdefault(key, []).append(member)
                self._cond.notify_all()
        return member

    def abandon(self, member: Member) -> None:
        """The member's submission failed after registration (queue cap
        429, duplicate 409): drop it so no leader stacks work nobody
        will consume. Harmless if a leader already claimed it — the
        delivered result is simply never read."""
        with self._cond:
            if member.state == PENDING:
                member.state = ABANDONED
                peers = self._pending.get(member.key)
                if peers is not None:
                    try:
                        peers.remove(member)
                    except ValueError:
                        pass
                    if not peers:
                        del self._pending[member.key]

    # --- execution (scheduler device workers) --------------------------------
    def run_member(self, member: Member) -> Any:
        """THE job function for a coalescible job. Exactly one of three
        paths: lead a fused dispatch, consume a result a leader already
        delivered, or (cancelled and masked) surface the cancellation
        through the scheduler's standard terminal path."""
        with self._cond:
            if member.state == PENDING:
                member.state = LEADER
                peers = self._pending.get(member.key)
                if peers is not None:
                    try:
                        peers.remove(member)
                    except ValueError:
                        pass
                    if not peers:
                        del self._pending[member.key]
                lead = True
            else:
                lead = False
        if lead:
            self._dispatch(self._collect(member))
        else:
            # a follower's result is normally delivered before its task
            # even dequeues (width-1 serializes leader before follower);
            # the timeout loop is defensive — the leader's finally
            # guarantees delivery, so this only spins on a genuine bug
            # instead of wedging a device worker forever
            while not member._done.wait(timeout=1.0):
                if member.token is not None:
                    member.token.check()
        return self._consume(member)

    def _collect(self, leader: Member) -> list[Member]:
        """Fill the batch from the pending set until the window closes
        or ``max_jobs`` is reached (the MicroBatcher's collection loop,
        at job granularity). Registration notifies the condition, so a
        burst arriving mid-window is picked up without polling."""
        batch = [leader]
        if self.window_s <= 0 or self.max_jobs <= 1:
            return batch
        deadline = time.monotonic() + self.window_s
        with self._cond:
            while True:
                peers = self._pending.get(leader.key)
                while peers and len(batch) < self.max_jobs:
                    peer = peers.pop(0)
                    peer.state = CLAIMED
                    batch.append(peer)
                if peers is not None and not peers:
                    del self._pending[leader.key]
                if len(batch) >= self.max_jobs:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # predicate loop with timeout (LO204): a missed notify
                # degrades to closing the window, never a parked worker
                self._cond.wait(remaining)
        return batch

    def _dispatch(self, batch: list[Member]) -> None:
        """Run the fused dispatch for ``batch`` on the calling (device
        worker) thread and deliver every member's outcome. Cancelled
        members are masked OUT of the fused batch — a cancellation is
        never a reason to abort its neighbors."""
        live: list[Member] = []
        masked = 0
        for member in batch:
            if member.token is not None and member.token.cancelled:
                member.skipped = True
                member.deliver()
                masked += 1
            else:
                live.append(member)
        if masked:
            self._metrics["masked"].inc(masked)
        with self._cond:
            self._masked += masked
        if not live:  # every member cancelled before the window closed
            return  # counted as masked members, never as a dispatch
        self._metrics["batch_size"].observe(len(batch))
        self._metrics["fused"].inc()
        self._metrics["members"].inc(len(batch))
        with self._cond:
            self._fused += 1
            self._members += len(batch)
        try:
            # chaos point: an injected error here must land as
            # per-member failures through the delivery path below, never
            # a wedged batch (testing/faults.py)
            _faults.fire("coalesce.dispatch", jobs=len(live))
            with _tracing.span(
                "coalesce:dispatch", jobs=len(live), masked=masked
            ):
                outcomes = live[0].runner([m.payload for m in live])
            if len(outcomes) != len(live):
                raise RuntimeError(
                    f"coalesce runner returned {len(outcomes)} outcomes "
                    f"for {len(live)} members"
                )
            for member, outcome in zip(live, outcomes):
                status, value = outcome
                if status == "ok":
                    member.result = value
                else:
                    member.error = value
                    self._metrics["failed_members"].inc()
                member.deliver()
        except BaseException as error:  # noqa: BLE001 — the fused program
            # (or a malformed runner outcome mid-delivery) died: every
            # live member not already delivered fails, each through its
            # OWN record. An undelivered member would otherwise park its
            # follower task forever — on the width-1 device class that
            # wedges the mesh's only dispatch lane.
            for member in live:
                if member.delivered:
                    continue
                member.error = _per_member_error(error)
                member.deliver()

    def _consume(self, member: Member) -> Any:
        """Surface this member's delivered outcome on its own task (its
        own record, trace, and journal): result, error, or
        cancellation."""
        if member.skipped:
            # masked out of the fused batch; the standard CANCELLED
            # terminal path takes it from here
            if member.token is not None:
                member.token.check()  # raises with the cancel reason
            raise JobCancelledError("coalesced member cancelled")
        if member.error is not None:
            raise member.error
        attribution = {}
        if isinstance(member.result, dict):
            attribution = member.result.get("_attribution") or {}
        # per-job flight-recorder attribution: the member's share of the
        # fused dispatch (rows/bytes) lands on ITS job trace, so
        # /jobs/<name>/trace and /profile split the fused span per job
        with _tracing.span("coalesce:member", **attribution):
            pass
        return member.result

    # --- introspection ---------------------------------------------------------
    def depth(self) -> int:
        with self._cond:
            return sum(len(peers) for peers in self._pending.values())

    def stats(self) -> dict:
        with self._cond:
            return {
                "pending": sum(
                    len(peers) for peers in self._pending.values()
                ),
                "fused_dispatches": self._fused,
                "members": self._members,
                "masked": self._masked,
                "mean_batch_size": (
                    round(self._members / self._fused, 3)
                    if self._fused
                    else None
                ),
            }


def _per_member_error(error: BaseException) -> BaseException:
    """A fresh exception instance per member for a batch-wide failure:
    up to max_jobs threads re-raise their member's error concurrently,
    and raising ONE shared instance from many threads interleaves the
    mutations of its ``__traceback__`` — garbling exactly the
    diagnostics needed to debug the fused-program death."""
    try:
        clone = type(error)(*error.args)
        clone.__cause__ = error
        return clone
    except BaseException:  # noqa: BLE001 — exotic constructor signature:
        # fall back to sharing the instance rather than masking the error
        return error


_COALESCER: Optional[Coalescer] = None
_COALESCER_LOCK = threading.Lock()


def global_coalescer() -> Coalescer:
    """The process-wide stage (knobs read once at first use); services
    share it like they share the runner's scheduler, so jobs submitted
    through different apps in one process still coalesce."""
    global _COALESCER
    with _COALESCER_LOCK:
        if _COALESCER is None:
            _COALESCER = Coalescer()
        return _COALESCER


_METRICS: Optional[dict] = None
_METRICS_LOCK = threading.Lock()


def _coalesce_metrics() -> dict:
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            from learningorchestra_tpu_torch.telemetry import global_registry

            registry = global_registry()
            _METRICS = {
                "batch_size": registry.histogram(
                    "lo_sched_coalesce_batch_size",
                    "Member jobs per fused device dispatch",
                    buckets=_BATCH_BUCKETS,
                ),
                "fused": registry.counter(
                    "lo_sched_coalesce_fused_total",
                    "Fused job-axis dispatches run",
                ),
                "members": registry.counter(
                    "lo_sched_coalesce_members_total",
                    "Member jobs riding fused dispatches",
                ),
                "masked": registry.counter(
                    "lo_sched_coalesce_masked_total",
                    "Cancelled members masked out of fused dispatches",
                ),
                "failed_members": registry.counter(
                    "lo_sched_coalesce_failed_members_total",
                    "Members failing alone inside a fused dispatch",
                ),
            }
        return _METRICS
