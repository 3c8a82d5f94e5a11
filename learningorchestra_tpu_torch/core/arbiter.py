"""Quorum arbiter: the vote-only replica-set member.

The port's copy of ``learningorchestra_tpu/core/arbiter.py``, on the
port's stdlib web layer (``utils/web.py``).

The reference's Mongo replica set deploys a dedicated arbiter container
precisely so a two-data-node set has a majority to elect with
(reference docker-compose.yml:49-91: ``mongodbarbiter`` joins the set
with ``--replSet`` and holds a vote but no data). This module is that
role for the framework's store pair: a tiny stdlib HTTP
process that holds ONE vote and no data, so

- a follower whose primary vanished can assemble a 2-of-3 majority
  (itself + the arbiter) and promote *with quorum* instead of on a
  blind timer, and
- the partitioned minority side can *see* that it lost quorum and
  suspend writes (503 + Retry-After) instead of opening a second
  primary.

Vote semantics (the slice of Raft's election rules this topology
needs, shared with the store servers via :func:`grant_vote`):

- a candidate campaigns for an explicit ``term``;
- a voter grants at most one vote per term (first candidate wins the
  term; re-asking with the same term and candidate is idempotent —
  retried requests must not burn the vote);
- stale candidacies (``term`` ≤ the highest term the voter has
  observed) are denied.

Vote state is in-memory: an arbiter restart inside one election window
could in principle double-vote, the same trade Mongo documents for
priority-0 members — the window is seconds and the term fence
(store_service fencing probe) still converges on one writer.

Run it: ``python -m learningorchestra_tpu_torch.core.arbiter`` (knobs:
``LO_HOST``, ``LO_ARBITER_PORT``). Point the store servers at it with
``LO_ARBITERS=http://host:port``.
"""

from __future__ import annotations

import os
import secrets
import threading
from typing import Optional

from learningorchestra_tpu_torch.utils.web import ServerThread, WebApp

DEFAULT_ARBITER_PORT = 27029


def grant_vote(state: dict, term: int, candidate: str) -> dict:
    """Apply one vote request against ``state`` (mutated in place;
    caller holds the node's lock). ``state`` carries ``term`` (highest
    observed), ``voted_term``/``voted_for`` (the one-vote-per-term
    ledger). Returns the wire payload."""
    voted_term = state.get("voted_term", 0)
    voted_for = state.get("voted_for")
    if term == voted_term:
        # idempotent re-ask FIRST: a candidate whose grant response was
        # lost to a timeout retries the identical request, and the
        # arbiter's observed term has meanwhile been bumped to the
        # granted term — the staleness check below must not burn the
        # vote the retry is trying to read back
        granted = candidate == voted_for
    elif term <= state.get("term", 0) or term < voted_term:
        granted = False
    else:
        granted = True
        state["voted_term"] = term
        state["voted_for"] = candidate
    return {
        "granted": granted,
        "term": state.get("term", 0),
        "voted_term": state.get("voted_term", 0),
        "voted_for": state.get("voted_for"),
    }


def create_arbiter_app(state: Optional[dict] = None) -> WebApp:
    """``state`` (mutable, shared with the caller/tests) mirrors the
    store server's role dict shape where it matters: ``term`` is the
    highest term this arbiter has observed, ``boot`` identifies the
    incarnation."""
    app = WebApp("arbiter")
    state = state if state is not None else {}
    state.setdefault("term", 0)
    state.setdefault("voted_term", 0)
    state.setdefault("voted_for", None)
    state.setdefault("boot", secrets.token_hex(8))
    state.setdefault("lock", threading.Lock())

    @app.route("/health", methods=("GET",))
    def health(request):
        with state["lock"]:
            return {
                "ok": True,
                "arbiter": True,
                "writable": False,  # never holds data, never promotes
                "term": state["term"],
                "voted_term": state["voted_term"],
                "boot": state["boot"],
            }, 200

    @app.route("/vote", methods=("POST",))
    def vote(request):
        body = request.get_json()
        try:
            term = int(body["term"])
            candidate = str(body["candidate"])
        except (KeyError, TypeError, ValueError):
            return {"error": "vote needs integer term + candidate"}, 400
        with state["lock"]:
            payload = grant_vote(state, term, candidate)
            # an election in flight moves the observed term forward even
            # when this vote is denied — later stale candidacies at the
            # same term must also be denied
            state["term"] = max(state["term"], payload["voted_term"])
        return payload, 200

    return app


def serve(host: str = "127.0.0.1", port: int = DEFAULT_ARBITER_PORT) -> ServerThread:
    state: dict = {}
    server = ServerThread(create_arbiter_app(state), host, port).start()
    server.arbiter_state = state
    return server


def main() -> None:
    from learningorchestra_tpu_torch.testing import faults

    try:
        faults.validate_env()  # refuse bring-up on a typo'd chaos knob
    except ValueError as error:
        raise SystemExit(f"LO_FAULT_* validation failed: {error}")
    # lo: allow[LO305] boot main(): the arbiter's own launcher wiring
    host = os.environ.get("LO_HOST", "127.0.0.1")
    # lo: allow[LO305] boot main(): the arbiter's own launcher wiring
    port = int(os.environ.get("LO_ARBITER_PORT", DEFAULT_ARBITER_PORT))
    server = serve(host, port)
    print(f"store arbiter on {host}:{server.port}", flush=True)
    server._thread.join()


if __name__ == "__main__":
    main()
