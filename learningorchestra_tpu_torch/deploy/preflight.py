"""Refuse a deployment whose knobs are malformed, before anything boots.

Counterpart of the preflight heredoc of ``deploy/run.sh:173-328``, knob
for knob, against the port's modules (its copies of the reference's
knob readers), plus the port's two boot knobs: ``LO_DEVICE`` (``cuda`` |
``cpu``) and ``LO_DIST_BACKEND`` (``nccl`` | ``gloo``), which stand in
for ``JAX_PLATFORMS`` and for jax.distributed's own choice of
transport. A knob that would silently run at a default (a typo'd width,
a flag that is neither 0 nor 1, a fractional count) raises here and the
process exits non-zero; a valid deployment exits 0.

    python -m learningorchestra_tpu_torch.deploy.preflight
"""

from __future__ import annotations

import os
import sys

# strict 0/1 flags
FLAGS = ("LO_STORE_COMPRESS", "LO_WRITE_OVERLAP", "LO_REPLICATION",
         "LO_STORE_SYNC_REPL", "LO_WIRE_V2", "LO_SHAPE_BUCKETS",
         "LO_EPHEMERAL", "LO_REPLICATE", "LO_STACK_EXIT_ON_STDIN_EOF",
         "LO_TSDB_COLLECT")
# ports of fixed servers: 1-65535
FIXED_PORTS = ("LO_FOLLOWER_PORT", "LO_ARBITER_PORT")
# service, store and coordinator ports: 0 = OS-assigned
PORTS = ("LO_PORT", "LO_STORE_PORT", "LO_COORD_PORT")
# seconds > 0
POSITIVE_SECONDS = ("LO_AUTO_PROMOTE_S", "LO_QUORUM_GRACE_S",
                    "LO_STORE_ACK_TIMEOUT_S", "LO_FAILOVER_TIMEOUT_S",
                    "LO_LANDED_OK_WINDOW_S", "LO_REPL_INTERVAL_S",
                    "LO_STORE_MONITOR_TICK_S", "LO_SPMD_HEARTBEAT_S",
                    "LO_METRICS_INTERVAL_S")
# seconds >= 0: 0 is no SPMD deadline / an immediate supervisor restart
SECONDS = ("LO_SPMD_TIMEOUT_S", "LO_RESTART_DELAY")
# wire, build and process-topology counts: strictly integral, with a floor
COUNTS = (("LO_WIRE_ROWS", 1), ("LO_WIRE_ROWS_BIN", 1),
          ("LO_COMPACT_RECORDS", 1), ("LO_BUILD_WORKERS", 1),
          ("LO_CHUNK_RETRIES", 0), ("LO_READ_RETRIES", 0),
          ("LO_WORKERS", 0), ("LO_TOTAL_PROCESSES", 0),
          ("LO_PROCESS_BASE", 0), ("LO_MAX_RESTARTS", 0),
          ("LO_TRACE_RING", 1), ("LO_TSDB_POINTS", 1),
          ("LO_SHARDS", 1))
# byte budgets in run.sh's 1e9 notation; 0 disables the feature
BYTES = ("LO_INGEST_SLAB_BYTES", "LO_SPILL_BYTES")


def _value(knob: str) -> str:
    return os.environ.get(knob, "").strip()


def check_env() -> dict:
    """Validate every knob; raises (``ValueError`` from a module's reader,
    ``SystemExit`` with the knob's message) on the first malformed one.
    Returns the armed fault points (empty: none)."""
    from learningorchestra_tpu_torch.sched import config
    config.host_width(); config.device_width(); config.queue_cap()
    # the rest of the scheduler table
    config.retry_budget(); config.backoff_base_s(); config.backoff_cap_s()
    config.jitter_seed(); config.default_timeout_s()
    config.job_history(); config.job_ttl_s()
    # coalescing: window >= 0 (0 = passthrough), max_jobs an integer >= 1
    config.coalesce_window_s(); config.coalesce_max_jobs()
    from learningorchestra_tpu_torch.core import devcache
    devcache.capacity_bytes()
    # the wire: shm ring size >= 0, the dtype policy f32|bf16 (part of
    # every devcache key and of SPMD dispatch shapes: one on every host)
    from learningorchestra_tpu_torch.core import shmring
    shmring.shm_bytes()
    from learningorchestra_tpu_torch.utils import dtypepolicy
    dtypepolicy.validate_env()
    from learningorchestra_tpu_torch.serve import config as serve_config
    serve_config.validate_all()
    # the serving fleet: counts integral >= 1, quota >= 0, down window > 0,
    # the replica index (set by the stack) integral and below the count
    from learningorchestra_tpu_torch.serve import fleet as serve_fleet
    serve_fleet.validate_env()
    # profiling: HZ >= 0 (0: /debug/profile off), window > 0
    from learningorchestra_tpu_torch.telemetry import profile as lo_profile
    lo_profile.validate_env()
    # web serving: LO_WEB_ASYNC 0/1, pool width and connection cap >= 1,
    # the wait cap > 0
    from learningorchestra_tpu_torch.utils import webloop
    webloop.validate_env()
    # the compile plane: LO_AOT / LO_AOT_PUBLISH 0/1, the cap an integer
    # >= 0; a typo'd LO_AOT never silently boots cold
    from learningorchestra_tpu_torch.compile import config as compile_config
    compile_config.validate_env()
    # the port's boot knobs: the device and the group's backend
    from learningorchestra_tpu_torch.services import runner
    runner.device_from_env(); runner.backend_from_env()
    for knob in FLAGS:
        value = _value(knob)
        if value and value not in ("0", "1"):
            raise SystemExit(f"{knob} must be 0 or 1, got {value!r}")
    for knob in FIXED_PORTS:
        value = _value(knob)
        if value:
            try:
                port = int(value)
            except ValueError:
                port = -1
            if not 1 <= port <= 65535:
                raise SystemExit(f"{knob} must be a port number, got {value!r}")
    for knob in PORTS:
        value = _value(knob)
        if value:
            try:
                port = int(value)
            except ValueError:
                port = -1
            if not 0 <= port <= 65535:
                raise SystemExit(f"{knob} must be a port number, got {value!r}")
    for knob in POSITIVE_SECONDS:
        value = _value(knob)
        if value:
            try:
                seconds = float(value)
            except ValueError:
                seconds = -1.0
            if seconds <= 0:
                raise SystemExit(f"{knob} must be seconds > 0, got {value!r}")
    for knob in SECONDS:
        value = _value(knob)
        if value:
            try:
                seconds = float(value)
            except ValueError:
                seconds = -1.0
            if seconds < 0:
                raise SystemExit(f"{knob} must be seconds >= 0, got {value!r}")
    for knob, floor in COUNTS:
        value = _value(knob)
        if value:
            try:
                count = int(value)
            except ValueError:
                count = floor - 1
            if count < floor:
                raise SystemExit(f"{knob} must be an integer >= {floor}, got {value!r}")
    for knob in BYTES:
        value = _value(knob)
        if value:
            try:
                amount = int(float(value))
            except ValueError:
                amount = -1
            if amount < 0:
                raise SystemExit(f"{knob} must be bytes >= 0 (1e9 notation ok), got {value!r}")
    value = _value("LO_PROGRAM_ROW_STEPS")
    if value:
        try:
            scale = float(value)
        except ValueError:
            scale = -1.0
        if scale <= 0:
            raise SystemExit(f"LO_PROGRAM_ROW_STEPS must be a scale > 0, got {value!r}")
    # sharding: stripe rows integral >= 1, the shard-map TTL >= 0
    from learningorchestra_tpu_torch.core import shardmap
    shardmap.validate_env()
    # crash resume: LO_RESUME 0/1, the cadence an integer >= 1
    config.resume_enabled(); config.resume_every_segments()
    from learningorchestra_tpu_torch.telemetry import slo as lo_slo
    lo_slo.validate_env()
    # chaos fault points: a typo'd LO_FAULT_* fails bring-up loudly
    from learningorchestra_tpu_torch.testing import faults
    try:
        return faults.validate_env()
    except ValueError as error:
        raise SystemExit(f"LO_FAULT_* validation failed: {error}") from None


def main() -> int:
    armed = check_env()
    if armed:
        print(f"preflight: FAULT INJECTION ARMED: {armed} (chaos drill?)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
