"""Crash recovery: replay the journal, re-enqueue or terminate.

The reference's failure mode — the exact one this exists to close — is
a worker that dies with ``finished: false`` on a dataset's metadata,
leaving every client polling forever (reference database.py:199-216,
client __init__.py:24-32). On restart, :func:`recover_jobs`:

1. **Re-enqueues jobs that never started** (last journal event
   ``submitted``/``retry``) whose operation is in the replay registry —
   the submit document carries the op name and payload, so the work
   reconstructs without the original closure (the lineage idea from
   Ray, reduced to named idempotent operations).
2. **Resumes orphaned RUNNING jobs whose op is resumable** (last event
   ``started``, op in the resume registry, ``LO_RESUME`` enabled):
   re-enqueues the work under the same name with the journaled
   ``progress`` events — per-classifier completions, fit-segment saves
   — so the resumed run performs only the remaining work. Parked
   waiters never noticed: same name, same record map, the push hook
   fires when the resumed run finishes.
3. **Marks the rest of the orphaned RUNNING jobs FAILED**: appends a
   terminal ``orphaned`` event and flips the tracked dataset's
   metadata to ``finished: true`` with an error, so pollers terminate.
   Never-started jobs with no replay handler get the same terminal
   treatment — no journal entry is ever left able to hang a client.

Replayable ops are registered by name. ``ingest`` ships built in: it is
idempotent-by-construction here because only never-STARTED ingests
replay (a started one may have written partial rows; it is orphaned
instead). ``build_model`` registers as BOTH replayable and resumable —
its outputs are whole-collection drops + atomic checkpoint/progress
artifacts, so a half-dead build re-runs safely at any point. Register
more with :func:`register_replay` / :func:`register_resumable`.

The port's copy of ``learningorchestra_tpu/sched/recovery.py``, less the
multi-process guard of the build replay (JAX's ``process_count``; one
process drives one card here).
"""

from __future__ import annotations

import functools
from typing import Callable

from learningorchestra_tpu_torch.core.store import METADATA_ID, ROW_ID
from learningorchestra_tpu_torch.sched import config as _config
from learningorchestra_tpu_torch.sched.journal import JobJournal
from learningorchestra_tpu_torch.sched.scheduler import QueueFullError
from learningorchestra_tpu_torch.telemetry import metrics as _metrics

ORPHAN_ERROR = "orphaned by service restart"

# op name -> handler(store, payload). Handlers re-run the work from the
# journaled payload alone.
_REPLAY_REGISTRY: dict[str, Callable] = {}

# op name -> handler(store, payload, progress). Handlers re-run the
# work from the journaled payload plus the run's ``progress`` events —
# ops here declare that a STARTED run is safe to re-execute (atomic
# outputs, journaled completions).
_RESUME_REGISTRY: dict[str, Callable] = {}


def register_replay(op: str, handler: Callable) -> None:
    _REPLAY_REGISTRY[op] = handler


def register_resumable(op: str, handler: Callable) -> None:
    _RESUME_REGISTRY[op] = handler


def _replay_ingest(store, payload: dict) -> None:
    from learningorchestra_tpu_torch.core.ingest import ingest_csv

    ingest_csv(store, payload["filename"], payload["url"])


register_replay("ingest", _replay_ingest)


def _build_model_replay(store, payload: dict, progress=None, device=None) -> None:
    """Re-run (or resume) a model build from its journaled submit
    payload. Registered at module import — recovery runs BEFORE the
    web app exists, so this cannot live in a create_app closure.
    ``device=None`` is the CUDA card; the runner registers the handler
    again with its own device bound (:func:`register_build_model`). The
    journaled payload names no device, so a journal written on one
    machine replays on another.

    Single-process only, as the reference's: a resume on one rank of
    several would enter collectives the other ranks never join (a hang,
    not a recovery), so a build over ranks is restarted by its client."""
    from learningorchestra_tpu_torch.parallel.spmd import process_count

    if process_count() > 1:
        raise RuntimeError(
            "build_model replay is single-host only "
            f"(process_count={process_count()})"
        )
    from learningorchestra_tpu_torch.ml.builder import build_model

    build_model(
        store,
        payload["training_filename"],
        payload["test_filename"],
        payload["preprocessor_code"],
        list(payload["classificators_list"]),
        device=device,
        models_dir=payload.get("models_dir"),
        resume=list(progress or []),
    )


def register_build_model(device=None) -> None:
    """Register the build replay and resume handlers with ``device``
    bound (None: the CUDA card)."""
    handler = _build_model_replay
    if device is not None:
        handler = functools.partial(_build_model_replay, device=device)
    register_replay("build_model", handler)
    register_resumable("build_model", handler)


register_build_model()


def _recovered_counter():
    return _metrics.global_registry().counter(
        "lo_sched_recovered_total",
        "Journal-replay outcomes at service restart",
        labels=("outcome",),
    )


def _resumed_counter():
    return _metrics.global_registry().counter(
        "lo_sched_resumed_total",
        "Orphaned RUNNING jobs re-enqueued with journaled progress",
    )


def _terminate_poller(store, collection: str, error: str) -> None:
    """Flip the tracked dataset's metadata so clients polling
    ``finished`` stop — the crash the reference hangs on."""
    try:
        store.update_one(
            collection,
            {ROW_ID: METADATA_ID},
            {"finished": True, "error": error},
        )
    except Exception:  # noqa: BLE001 — collection may be gone
        pass


def recover_jobs(store, jobs, journal: JobJournal | None = None) -> dict:
    """Replay ``journal`` (default: ``jobs``'s own, else a fresh
    scope-"all" one over ``store``) and reconcile every non-terminal
    entry. Returns ``{"requeued": [names], "orphaned": [names]}``.

    Call once at process start, before the REST surface accepts
    traffic and after the store has replayed its WAL. ``jobs`` is the
    process's JobManager: requeued work becomes ordinary tracked jobs
    (records, traces, fresh journal entries).
    """
    journal = journal or getattr(jobs, "journal", None) or JobJournal(store)
    histories = journal.replay()
    counter = _recovered_counter()
    requeued: list[str] = []
    orphaned: list[str] = []
    live = [h for h in histories.values() if not h.terminal]
    if not live:
        # Nothing to reconcile. If replay also proved the journal holds
        # no other scope's events, the whole collection is dead weight:
        # drop it — this clean-restart compaction is what bounds
        # journal growth across restart cycles.
        if not journal.saw_foreign_scope:
            journal.compact()
        return {"requeued": requeued, "orphaned": orphaned}
    # Live histories exist: recovery stays strictly APPEND-ONLY.
    # Compacting first would open a window where a crash between the
    # drop and the re-submits loses every pending job — the exact
    # hung-poller bug this subsystem exists to close. The extra
    # documents cost a little store space until the next clean restart
    # compacts them.

    def orphan(name: str, collection, outcome: str) -> None:
        """Terminate one unrecoverable history: journal the terminal
        event and flip the tracked dataset so pollers stop."""
        orphaned.append(name)
        counter.labels(outcome).inc()
        journal.append(name, "orphaned", error=ORPHAN_ERROR)
        if collection:
            _terminate_poller(store, collection, ORPHAN_ERROR)

    for name, history in histories.items():
        if history.terminal:
            continue
        submit = history.submit
        collection = submit.get("collection")
        if history.started:
            # Orphaned RUNNING job: the process died mid-flight. An op
            # in the resume registry declared a started run safe to
            # re-execute (atomic outputs, journaled completions) — it
            # re-enqueues under the SAME name with its progress events,
            # so the resumed run performs only the remaining work and
            # parked waiters resolve on its completion. Everything else
            # may have half-written output: it fails, visibly, and its
            # pollers terminate.
            resume_handler = _RESUME_REGISTRY.get(submit.get("op"))
            if resume_handler is not None and _config.resume_enabled():
                payload = submit.get("payload") or {}
                try:
                    jobs.submit(
                        name,
                        resume_handler,
                        store,
                        payload,
                        list(history.progress),
                        store=store if collection else None,
                        collection=collection,
                        job_class=submit.get("job_class") or "host",
                        priority=int(submit.get("priority") or 0),
                        replay=(submit["op"], payload),
                    )
                except QueueFullError:
                    orphan(name, collection, "dropped")
                    continue
                requeued.append(name)
                counter.labels("resumed").inc()
                _resumed_counter().inc()
                continue
            orphan(name, collection, "orphaned")
            continue
        handler = _REPLAY_REGISTRY.get(submit.get("op"))
        if handler is None:
            # Admitted but never started, and not replayable: terminal,
            # for the same no-hung-pollers reason.
            orphan(name, collection, "unreplayable")
            continue
        payload = submit.get("payload") or {}
        try:
            jobs.submit(
                name,
                handler,
                store,
                payload,
                store=store if collection else None,
                collection=collection,
                job_class=submit.get("job_class") or "host",
                priority=int(submit.get("priority") or 0),
                replay=(submit["op"], payload),
            )
        except QueueFullError:
            # a backlog larger than the queue cap must not crash the
            # restart: past the cap, the remainder terminates like
            # unreplayable work (clients resubmit) instead of wedging
            # bring-up
            orphan(name, collection, "dropped")
            continue
        requeued.append(name)
        counter.labels("requeued").inc()
    return {"requeued": requeued, "orphaned": orphaned}
