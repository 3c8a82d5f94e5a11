"""Durable job journal: one submit document, transitions appended.

Every scheduler admission writes a ``submitted`` document into the
``__lo_jobs__`` collection of the :class:`DocumentStore`; every state
transition (``started``, ``retry``, ``finished``, ``failed``,
``cancelled``, ``rejected``, ``orphaned``) appends another. Running
work may additionally append ``progress`` documents (JobHandle.progress
— per-classifier completions, fit-segment saves); these are NOT state
transitions, they are the resume payload recovery hands back to a
resumable op after a crash (docs/robustness.md). The store's
WAL makes the journal survive a crash, which is what recovery
(sched/recovery.py) replays — task lineage in the Ray sense, scoped to
what this system needs: enough to re-enqueue work that never started
and to terminate pollers of work that died mid-flight.

Append-only by design: transitions are separate documents, not in-place
updates, so a crash can never leave a half-written state and replay is
a pure fold over ``_id`` order. ``scope`` labels which process owns a
job ("all" for the single-process runner, the service name in the
one-process-per-service topology) so each restarted process recovers
only its own jobs from the shared store.

Journal writes are best-effort: a store hiccup loses an audit line, not
the job — availability over perfect lineage, the same call Ray makes
for its event log.
"""

from __future__ import annotations

import time
import traceback
from typing import Iterator, Optional

from learningorchestra_tpu_torch.testing import faults as _faults

JOURNAL_COLLECTION = "__lo_jobs__"

TERMINAL_EVENTS = frozenset(
    {"finished", "failed", "cancelled", "rejected", "orphaned"}
)


def shard_scope(scope: str, store) -> str:
    """The journal scope suffixed with the store's shard topology
    (``all`` → ``all#sh4x8192`` on a four-group fleet) so recovery
    replays stay shard-local in two senses: the journal lives whole on
    the META group (``insert_one`` routes there — no cross-group fold),
    and a RE-SHARDED fleet sees its old entries as foreign scopes
    instead of replaying job lineage whose block ids meant a different
    placement. Resharding in place is a declared non-goal
    (docs/dataplane.md): drain, then re-ingest. Unsharded stores carry
    no signature and keep their scopes byte-identical."""
    signature = getattr(store, "shard_signature", "")
    return f"{scope}#{signature}" if signature else scope


class JobHistory:
    """One job's folded journal: its submit document, the last event
    seen, and any ``progress`` events the run appended — all recovery
    needs."""

    __slots__ = ("name", "submit", "last_event", "last_error", "progress")

    def __init__(self, name: str, submit: dict):
        self.name = name
        self.submit = submit
        self.last_event = "submitted"
        self.last_error: Optional[str] = None
        # ``progress`` event documents in append order (per-classifier
        # completions, segment saves) — the resume payload for an
        # orphaned RUNNING job. Not a state transition: folding one
        # must NOT touch last_event, or a started job would stop
        # looking started.
        self.progress: list[dict] = []

    @property
    def terminal(self) -> bool:
        return self.last_event in TERMINAL_EVENTS

    @property
    def started(self) -> bool:
        return self.last_event == "started"


class JobJournal:
    def __init__(self, store, scope: str = "all"):
        self.store = store
        self.scope = scope
        # set by replay(): did the journal hold events of OTHER scopes?
        # Compaction drops the whole collection, so it is only safe
        # when this journal provably owns everything in it.
        self.saw_foreign_scope = False

    def append(self, job: str, event: str, **fields) -> None:
        document = {"job": job, "event": event, "scope": self.scope,
                    "ts": time.time()}
        document.update(
            {key: value for key, value in fields.items() if value is not None}
        )
        try:
            # chaos point: an injected error here must cost an audit
            # line, never the job — the same contract as a real store
            # hiccup (testing/faults.py)
            _faults.fire("sched.journal.append", job=job, event=event)
            self.store.insert_one(JOURNAL_COLLECTION, document)
        except Exception:  # noqa: BLE001 — journaling must not fail jobs
            traceback.print_exc()

    def _events(self) -> Iterator[dict]:
        try:
            yield from self.store.find(JOURNAL_COLLECTION)
        except Exception:  # noqa: BLE001 — no journal yet / store down
            return

    def replay(self) -> dict[str, JobHistory]:
        """Fold the journal (``_id`` order = append order) into one
        history per job name in this scope. A resubmit of a name whose
        previous run reached a terminal state starts a fresh history —
        the newest submit wins, like JobManager's record map."""
        histories: dict[str, JobHistory] = {}
        self.saw_foreign_scope = False
        for event in self._events():
            if event.get("scope") != self.scope:
                self.saw_foreign_scope = True
                continue
            name = event.get("job")
            kind = event.get("event")
            if name is None or kind is None:
                continue
            history = histories.get(name)
            if kind == "submitted":
                histories[name] = JobHistory(name, event)
                continue
            if history is None:
                # transition without a submit (partial WAL): synthesize
                # an op-less submit so recovery can still terminate it
                history = histories[name] = JobHistory(name, event)
            if kind == "progress":
                history.progress.append(event)
                continue
            history.last_event = kind
            history.last_error = event.get("error", history.last_error)
        return histories

    def compact(self) -> None:
        """Drop the journal wholesale — called by recovery ONLY when
        replay proved every entry belongs to this scope AND every
        history is terminal (nothing live to lose if the process dies
        right here). Consequence: in the one-process-per-service
        topology, once TWO scopes have written into the shared
        collection neither ever satisfies the ownership proof, so the
        journal grows until a maintenance pass with the store quiesced
        (or a store-level delete-by-query primitive, which the
        DocumentStore API does not have yet) reclaims it — the
        documented trade-off for crash-safe, coordination-free
        recovery; docs/scheduler.md covers the operational angle."""
        try:
            self.store.drop(JOURNAL_COLLECTION)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
