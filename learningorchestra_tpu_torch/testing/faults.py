"""Fault injection: named fault points for chaos-testing the data plane.

The replicated store's failover claims (docs/replication.md) are only
worth what can be demonstrated under faults, so the fault points are
first-class and live in the production code paths they test: the store
wire, the WAL feed, the promotion path, and the server-to-server
network calls (peer probes, WAL polls, quorum votes). Each point is a
named call to :func:`fire` (or :func:`torn` for sites that corrupt
bytes themselves); with no faults installed a point costs one list
read — nothing on the data-plane scale.

Two ways to arm a fault:

- **Environment knobs** (``LO_FAULT_<POINT>``, dots as underscores,
  upper-cased — e.g. ``LO_FAULT_STORE_WIRE_MUTATE="kill:5"``): for
  subprocess chaos, where the faulted process is a real store server
  that must actually die mid write burst. Validated by
  ``deploy/run.sh``'s preflight via :func:`validate_env` so a typo'd
  point or spec fails bring-up instead of silently not firing.
- **Programmatic installs** (:func:`install`): for in-process tests,
  where a ``where={...}`` match narrows the fault to one side of a
  simulated partition (ctx keys like ``me``/``url`` must all match).

Spec grammar — ``ACTION[:ARG][@N]``:

- ``kill[:nth]``      ``os._exit(137)`` on the *nth* hit (default 1) —
  the kill-primary-mid-write-burst fault.
- ``delay:seconds[@n]``  sleep before proceeding, on the first *n* hits
  (default: every hit) — delayed WAL shipping.
- ``error[@n]``       raise :class:`FaultInjected` on the first *n*
  hits (default: every hit) — partitions and transient wire failures.
- ``torn[@n]``        site-owned corruption (a truncated wire frame) on
  the first *n* hits (default 1); :func:`fire` never raises for it —
  the instrumented site asks :func:`torn` and mangles its own bytes.

The port's copy of ``learningorchestra_tpu/testing/faults.py``, with one
point of its own, ``fit.segment`` (ml/progress.py).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

# Every known fault point, with where it is threaded. validate_env and
# install() reject anything else — a chaos run that names a point that
# no longer exists must fail loudly, not silently test nothing.
FAULT_POINTS = {
    "store.wire.mutate": (
        "store server, before a mutation handler applies (a kill here "
        "loses an unacknowledged, unapplied write)"
    ),
    "store.wire.mutate.applied": (
        "store server, after a mutation applied but before it is "
        "acknowledged (a kill here loses the ack, not the write — the "
        "landed-ok retry path)"
    ),
    "store.wire.read_chunk": (
        "store server, binary read chunk about to be returned "
        "(supports torn: the frame is truncated mid-buffer)"
    ),
    "store.wal.feed": "store server, GET /wal handler (WAL shipping)",
    "store.promote": "inside promote_role, before the role flips",
    "store.net": (
        "server-to-server call: peer health probe, follower WAL poll, "
        "quorum vote request (ctx: me, url, kind)"
    ),
    # Compute-plane points (the crash-resume chaos harness,
    # docs/robustness.md): where a kill proves segment checkpointing
    # and resume-aware recovery, and an error proves the partial-results
    # and per-member delivery contracts.
    "builder.phase": (
        "model builder, at a phase boundary of one classifier's "
        "train (ctx: phase=load_data|preprocess|fit|checkpoint|"
        "evaluate|write, classificator when per-classifier — a kill "
        "here orphans the build mid-flight; an error fails one member)"
    ),
    "fit.segment": (
        "progress sink, after a fit's segment artifact was durably "
        "saved (ctx: kind=logistic|gbt, segment — an error here stops "
        "the fit with its artifact in place, the in-process resume drill)"
    ),
    "sched.journal.append": (
        "job journal, before a lifecycle/progress document is inserted "
        "(ctx: job, event — journal writes are best-effort, so an "
        "error here loses an audit line, never the job)"
    ),
    "coalesce.dispatch": (
        "job coalescer, before a fused batch dispatches (ctx: jobs — "
        "an error here must become per-member failures, not a wedge)"
    ),
    "serve.forward": (
        "serving batcher, before a request group's forward pass "
        "(ctx: path, requests — an error here must become per-request "
        "errors, not a dropped group)"
    ),
    "serve.route": (
        "fleet router, after admission but before the predict proxies "
        "upstream (ctx: model — an error here must answer a clean JSON "
        "503, never take the router down; a delay holds the routing "
        "decision open while a replica dies, the in-flight-failover "
        "chaos drill)"
    ),
}

_ACTIONS = ("kill", "delay", "error", "torn")


class FaultInjected(ConnectionError):
    """An ``error`` fault fired. Subclasses :class:`ConnectionError` so
    server-to-server callers (peer probes, WAL polls) treat an injected
    partition exactly like a real unreachable peer."""


class _Fault:
    __slots__ = ("point", "action", "arg", "count", "where", "hits")

    def __init__(self, point, action, arg, count, where):
        self.point = point
        self.action = action
        self.arg = arg  # delay seconds, or kill's nth hit
        self.count = count  # first-N budget (None = unlimited)
        self.where = where or {}
        self.hits = 0

    def matches(self, ctx: dict) -> bool:
        return all(ctx.get(key) == value for key, value in self.where.items())


_LOCK = threading.Lock()
_FAULTS: list[_Fault] = []
_ENV_LOADED = False


def _point_env_name(point: str) -> str:
    return "LO_FAULT_" + point.upper().replace(".", "_")


_ENV_NAMES = {_point_env_name(point): point for point in FAULT_POINTS}


def parse_spec(point: str, spec: str) -> _Fault:
    """One ``ACTION[:ARG][@N]`` spec → a :class:`_Fault`; raises
    ``ValueError`` with an actionable message on anything malformed."""
    if point not in FAULT_POINTS:
        raise ValueError(
            f"unknown fault point {point!r} (have: "
            f"{', '.join(sorted(FAULT_POINTS))})"
        )
    text = spec.strip()
    count: Optional[int] = None
    if "@" in text:
        text, _, count_text = text.partition("@")
        try:
            count = int(count_text)
        except ValueError:
            count = -1
        if count < 1:
            raise ValueError(
                f"{point}: '@{count_text}' must be a positive hit count"
            )
    action, _, arg_text = text.partition(":")
    action = action.strip()
    if action not in _ACTIONS:
        raise ValueError(
            f"{point}: unknown action {action!r} "
            f"(have: {', '.join(_ACTIONS)})"
        )
    arg: Optional[float] = None
    if action == "kill":
        arg = 1.0
        if arg_text:
            try:
                arg = float(int(arg_text))
            except ValueError:
                arg = 0.0
            if arg < 1:
                raise ValueError(f"{point}: kill:<nth> must be >= 1")
        if count is not None:
            raise ValueError(f"{point}: kill takes ':nth', not '@n'")
    elif action == "delay":
        try:
            arg = float(arg_text)
        except ValueError:
            arg = -1.0
        if arg <= 0:
            raise ValueError(f"{point}: delay needs ':<seconds>' > 0")
    elif arg_text:
        raise ValueError(f"{point}: {action} takes no ':' argument")
    if action == "torn" and count is None:
        count = 1  # a torn stream that never heals would defeat retries
    return _Fault(point, action, arg, count, None)


def validate_env(environ=None) -> dict[str, str]:
    """Parse every ``LO_FAULT_*`` variable, raising ``ValueError`` on an
    unknown point or malformed spec; returns ``{point: spec}``. The
    deploy preflight calls this so a chaos knob typo fails bring-up."""
    environ = os.environ if environ is None else environ
    out: dict[str, str] = {}
    problems: list[str] = []
    for name, value in sorted(environ.items()):
        if not name.startswith("LO_FAULT_") or not value.strip():
            continue
        point = _ENV_NAMES.get(name)
        if point is None:
            problems.append(
                f"{name}: no such fault point (have: "
                + ", ".join(sorted(_ENV_NAMES))
                + ")"
            )
            continue
        try:
            parse_spec(point, value)
        except ValueError as error:
            problems.append(f"{name}: {error}")
            continue
        out[point] = value.strip()
    if problems:
        raise ValueError("; ".join(problems))
    return out


def _ensure_env_loaded() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    with _LOCK:
        if _ENV_LOADED:
            return
        try:
            armed = validate_env()
        except ValueError as error:
            # fire() runs inside production request handlers: raising
            # here would turn a typo'd knob into an error on EVERY
            # mutation (and spurious failovers from failing WAL polls).
            # Process ENTRY points (store_service/arbiter/stack main,
            # run.sh preflight) call validate_env() and refuse to come
            # up; a library embedder just gets one loud warning and no
            # armed faults.
            import sys

            print(
                f"faults: ignoring invalid LO_FAULT_* config: {error}",
                file=sys.stderr,
                flush=True,
            )
            armed = {}
        for point, spec in armed.items():
            _FAULTS.append(parse_spec(point, spec))
        _ENV_LOADED = True


def install(point: str, spec: str, where: Optional[dict] = None) -> _Fault:
    """Arm a fault programmatically (tests). ``where`` narrows it to
    fire() calls whose ctx carries equal values for every given key —
    how an in-process test partitions ONE node's server-to-server
    traffic while the others keep talking."""
    fault = parse_spec(point, spec)
    fault.where = dict(where or {})
    with _LOCK:
        _FAULTS.append(fault)
    return fault


def reset() -> None:
    """Disarm everything (programmatic installs AND env-derived faults;
    the env is re-read on the next fire). Test fixtures call this."""
    global _ENV_LOADED
    with _LOCK:
        _FAULTS.clear()
        _ENV_LOADED = False


def _consume(fault: _Fault) -> int:
    with _LOCK:
        fault.hits += 1
        return fault.hits


def fire(point: str, **ctx) -> None:
    """Hit a fault point. No-op unless a matching fault is armed; then
    kills the process, sleeps, or raises :class:`FaultInjected`
    according to the armed spec. ``torn`` faults never act here — the
    site corrupts its own bytes via :func:`torn`."""
    _ensure_env_loaded()
    if not _FAULTS:
        return
    for fault in list(_FAULTS):
        if fault.point != point or not fault.matches(ctx):
            continue
        if fault.action == "torn":
            continue
        hit = _consume(fault)
        if fault.action == "kill":
            if hit == int(fault.arg):
                os._exit(137)
        elif fault.count is not None and hit > fault.count:
            continue
        elif fault.action == "delay":
            time.sleep(fault.arg)
        elif fault.action == "error":
            raise FaultInjected(f"injected fault at {point}")


def torn(point: str, **ctx) -> bool:
    """True when a ``torn`` fault is armed at ``point`` with budget
    left — the instrumented site then corrupts its own output (e.g.
    truncates the wire frame). Consumes one hit of the budget."""
    _ensure_env_loaded()
    for fault in list(_FAULTS):
        if (
            fault.point == point
            and fault.action == "torn"
            and fault.matches(ctx)
        ):
            if _consume(fault) <= (fault.count or 1):
                return True
    return False
