"""Cross-process trace stitching: one Chrome trace for one cid.

The port's copy of ``learningorchestra_tpu/telemetry/stitch.py``.

The Dapper reconstruction step: every process keeps a per-cid span
export buffer (telemetry/tracing.py) drained by ``GET /debug/spans``;
this module fans out to the plane members named in ``LO_PLANE_MEMBERS``
(the service URLs of the plane, set in every member's environment),
merges each member's span groups with the
local buffer, and lays the result out as ONE Chrome trace-event JSON:
one process row per ``service@pid`` group (``M`` ``process_name``
metadata events), threads within it, all anchored to a common ``t0``.
``GET /traces/<cid>`` on every service (utils/web.py) serves exactly
this — a client-driven projection→histogram→build→predict pipeline
renders as a single timeline.

Groups are keyed ``service@pid``, so fanning out to a member list that
includes the serving process itself dedupes (the HTTP copy replaces
the identical local group) instead of duplicating rows. Members that
are down or mid-restart are skipped — a partial stitch beats a 502.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Optional

from learningorchestra_tpu_torch.telemetry import profile as _profile
from learningorchestra_tpu_torch.telemetry import tracing as _tracing

FETCH_TIMEOUT_S = 2.0


def plane_members() -> list[str]:
    """Base URLs of the fleet's span sources, from the comma-separated
    ``LO_PLANE_MEMBERS`` (empty = local-only: single-process runners
    stitch from their own buffer)."""
    # lo: allow[LO301,LO305] free-form URL list, no domain to preflight
    raw = os.environ.get("LO_PLANE_MEMBERS", "")
    return [url.strip().rstrip("/") for url in raw.split(",") if url.strip()]


def fetch_member_spans(
    base_url: str, correlation_id: str, since: Optional[float] = None
) -> dict:
    """One member's span groups for one cid; ``{}`` on any failure —
    stitching is best-effort per member."""
    url = f"{base_url}/debug/spans?cid={correlation_id}"
    if since is not None:
        url += f"&since={since}"
    try:
        with urllib.request.urlopen(url, timeout=FETCH_TIMEOUT_S) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
    except Exception:  # noqa: BLE001 — down/mid-restart member = skip
        return {}
    entry = (payload.get("result") or {}).get(correlation_id) or {}
    groups = entry.get("groups")
    return groups if isinstance(groups, dict) else {}


def collect_groups(
    correlation_id: str,
    members: Optional[list[str]] = None,
    since: Optional[float] = None,
) -> dict[str, dict]:
    """Local buffer + every reachable member, merged by group key."""
    local = _tracing.exported_spans(correlation_id, since=since)
    groups = dict((local.get(correlation_id) or {}).get("groups") or {})
    for member in plane_members() if members is None else members:
        for proc, group in fetch_member_spans(
            member, correlation_id, since=since
        ).items():
            if isinstance(group, dict) and group.get("spans"):
                groups[proc] = group
    return groups


def stitched_trace(
    correlation_id: str,
    members: Optional[list[str]] = None,
    since: Optional[float] = None,
) -> dict:
    """The merged multi-process Chrome trace for one cid. Process rows
    (``pid``) are the sorted group keys, so the layout is deterministic
    regardless of which member answered first; ``otherData.processes``
    maps the synthetic pids back to ``service@pid`` identities."""
    groups = collect_groups(correlation_id, members=members, since=since)
    starts = [
        span["start_ts"]
        for group in groups.values()
        for span in group.get("spans", ())
        if span.get("start_ts") is not None
    ]
    t0 = min(starts, default=0.0)
    events: list[dict] = []
    processes: dict[int, str] = {}
    for index, proc in enumerate(sorted(groups)):
        group = groups[proc]
        events.extend(
            _profile.span_events(group.get("spans", ()), index, t0)
        )
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": index,
                "args": {"name": proc},
            }
        )
        events.append(
            {
                "name": "process_sort_index",
                "ph": "M",
                "pid": index,
                "args": {"sort_index": index},
            }
        )
        processes[index] = proc
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "correlation_id": correlation_id,
            "trace_start_ts": t0,
            "processes": processes,
        },
    }
