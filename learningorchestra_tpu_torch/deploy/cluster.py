"""One-command multi-MACHINE bring-up: the reference's ``run.sh`` +
``docker stack deploy`` + worker scaling (reference run.sh:8-32,
docker-compose.yml:1-340, README.md:94 ``docker service scale
microservice_sparkworker=N``) as a manifest-driven cluster driver.

Counterpart of the repository's ``deploy/cluster.py``, whole, for the
port: the manifest's schema is the reference's, and a manifest that runs
the JAX package runs the port once its ``env`` names ``LO_DEVICE`` in
place of ``JAX_PLATFORMS`` where it asks for the CPU (``LO_DIST_BACKEND``
picks the group's backend, ``gloo`` for ranks that share a card). The
``compile`` section sets the compile plane's knobs on every machine
(compile/config.py): with ``aot`` 1 each runner builds the kernel
libraries at boot or fetches them from the head store's
``__lo_executables__``, so a machine that joins with an empty build
folder runs no nvcc. One addition: ``head`` and each ``workers`` entry
may carry an ``env`` of their own (strings), laid over the shared
``env`` for that machine alone (a worker's own ``LO_JIT_CACHE``, say).

Every machine runs the same per-machine supervisor
(``learningorchestra_tpu_torch.deploy.stack``); this driver computes the
cross-machine wiring (store URL, the group's rendezvous address,
per-machine process-id ranges), launches one stack
per machine, health-gates bring-up, and — because a lost member poisons
the whole collective runtime — relaunches EVERY machine's runtime group
when any machine reports a death (the role swarm restart policies +
``dockerize -wait`` play in the reference, docker-compose.yml:14-15,145).

Usage::

    python -m learningorchestra_tpu_torch.deploy.cluster up <manifest.json>
    python -m learningorchestra_tpu_torch.deploy.cluster render <manifest.json>

Manifest (JSON)::

    {
      "repo": "/opt/learningorchestra_tpu",  # checkout path on every machine
                                   # (the folder that holds the package)
      "python": "python3",
      "transport": "ssh",          # "ssh" (default) or "local" (all
                                   # "machines" are processes on this one —
                                   # CI and single-box smoke)
      "head": {
        "host": "10.0.0.1",        # address workers + clients reach it at
        "bind": "0.0.0.0",         # LO_HOST on the head (see deploy/README.md
                                   # before exposing model_builder)
        "ssh": "user@10.0.0.1",
        "data_dir": "/var/lo_data",
        "workers": 0,              # SPMD worker processes ON the head machine
        "env": {}                  # optional: this machine's own env
      },
      "workers": [                 # one entry per worker machine
        {"host": "10.0.0.2", "ssh": "user@10.0.0.2",
         "data_dir": "/var/lo_data", "processes": 1,
         "env": {"LO_JIT_CACHE": "/var/lo_kernels"}}  # optional, its own
      ],
      "models_dir": "/shared/models",  # volume mounted by ALL machines
      "store_port": 27027,
      "coord_port": 12355,
      "env": {},                   # extra env for every machine
      "sched": {                   # optional scheduler knobs, validated
        "job_workers": 8,          #   LO_JOB_WORKERS (host-class width)
        "device_width": 1,         #   LO_SCHED_DEVICE_WIDTH
        "queue_cap": 64            #   LO_SCHED_QUEUE_CAP (429 past it)
      },
      "dataplane": {               # optional data-plane knobs, validated
        "devcache_bytes": 2000000000,  # LO_DEVCACHE_BYTES (0 disables)
        "store_compress": 0,       #   LO_STORE_COMPRESS (1 = zlib wire)
        "write_overlap": 1         #   LO_WRITE_OVERLAP (0 = sync writes)
      },
      "wire": {                    # optional zero-copy wire knobs
        "shm_bytes": 0,            #   LO_SHM_BYTES (ring size; 0 = off)
        "dtype_policy": "f32"      #   LO_DTYPE_POLICY (f32 | bf16)
      },
      "coalescing": {              # optional job-coalescing knobs
        "window_ms": 2,            #   LO_COALESCE_WINDOW_MS (>= 0;
        "max_jobs": 32             #   0 = passthrough) / LO_COALESCE_
      },                           #   MAX_JOBS (integer >= 1)
      "serving": {                 # optional online-serving knobs
        "serve_bytes": 1000000000, #   LO_SERVE_BYTES (0 = host fallback)
        "batch_window_ms": 1,      #   LO_SERVE_BATCH_WINDOW_MS (>= 0)
        "max_batch": 64,           #   LO_SERVE_MAX_BATCH (>= 1)
        "max_rows": 4096,          #   LO_SERVE_MAX_ROWS (413 past it)
        "queue_cap": 256,          #   LO_SERVE_QUEUE_CAP (429 past it)
        "timeout_s": 30            #   LO_SERVE_TIMEOUT_S (> 0)
      },
      "fleet": {                   # optional replicated serving fleet
        "replicas": 2,             #   LO_FLEET_REPLICAS (N replica
        "rf": 1,                   #   model_builders + router, single-
        "model_qps": 0,            #   host stacks only) / LO_FLEET_RF /
        "down_s": 3                #   LO_FLEET_MODEL_QPS (0 = off) /
      },                           #   LO_FLEET_DOWN_S (docs/serving.md)
      "profiling": {               # optional flight-recorder knobs
        "prof_hz": 47,             #   LO_PROF_HZ (0 disables /debug/
        "prof_window_s": 60        #   profile); LO_PROF_WINDOW_S (> 0)
      },
      "web": {                     # optional web-serving knobs
        "async": 1,                #   LO_WEB_ASYNC (0 = threaded
        "handlers": 8,             #   escape hatch); LO_WEB_HANDLERS
        "max_conns": 10000,        #   (>= 1); LO_WEB_MAX_CONNS (503
        "wait_cap_s": 60           #   past it); LO_WEB_WAIT_CAP_S (> 0)
      },
      "resume": {                  # optional crash-resume knobs
        "enabled": 1,              #   LO_RESUME (0 = orphaned RUNNING
        "every_segments": 1        #   jobs fail on restart) / LO_RESUME_
      },                           #   EVERY_SEGMENTS (integer >= 1)
      "compile": {                 # optional compile plane knobs
        "aot": 1,                  #   LO_AOT (1 = build the kernel
        "max_programs": 64,        #   libraries at boot) / LO_AOT_MAX_
        "publish": 1               #   PROGRAMS (integer >= 0) /
      },                           #   LO_AOT_PUBLISH (compile/config.py)
      "replication": {             # optional replicated store plane
        "enabled": true,           #   (docs/replication.md): the head
        "follower_port": 27028,    #   runs primary + WAL-shipping
        "arbiter_port": 27029,     #   follower + quorum arbiter; every
        "auto_promote_s": 5,       #   machine's LO_STORE_URL names both
        "sync_repl": 0             #   stores. sync_repl=1 withholds acks
      },                           #   until a follower holds the write
      "sharding": {                # optional horizontal store sharding
        "shards": 4,               #   LO_SHARDS: store groups on the
        "stripe_rows": 8192,       #   head (port stride 10; composes
        "map_ttl_s": 5             #   with replication per group) /
      },                           #   LO_SHARD_STRIPE_ROWS /
                                   #   LO_SHARDMAP_TTL_S (docs/dataplane.md)
      "restart_delay": 5,
      "max_cluster_restarts": null # null = retry forever
    }

``render`` prints the exact per-machine command lines (env + the stack)
so an operator can run or inspect them by hand; ``up`` is those commands
plus supervision. ssh transport sets ``LO_STACK_EXIT_ON_STDIN_EOF=1``
so the remote stack shuts itself down when the ssh channel closes —
``ssh -o BatchMode=yes`` allocates no pty, so a dying driver would
otherwise never HUP the remote process group and the stale stack would
linger holding the store/coordinator ports; ``Machine.stop`` ALSO
issues an explicit remote ``pkill`` before every whole-cluster
relaunch, so a relaunch never collides with a surviving old group.
"""

from __future__ import annotations

import http.client
import json
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
import urllib.request

DEPLOY_DIR = os.path.dirname(os.path.abspath(__file__))
# the folder that holds the package: the local stacks' PYTHONPATH and cwd
REPO_ROOT = os.path.dirname(os.path.dirname(DEPLOY_DIR))
STACK_MODULE = "learningorchestra_tpu_torch.deploy.stack"

HEAD_READY_MARKERS = ("[stack] runtime up", "[stack] all services up")
WORKER_READY_MARKER = "[stack] worker group up"


def load_manifest(path: str) -> dict:
    with open(path) as handle:
        manifest = json.load(handle)
    manifest.setdefault("python", "python3")
    manifest.setdefault("transport", "ssh")
    manifest.setdefault("store_port", 27027)
    manifest.setdefault("coord_port", 12355)
    manifest.setdefault("env", {})
    manifest.setdefault("workers", [])
    manifest.setdefault("restart_delay", 5)
    head = manifest.get("head")
    if not head or "host" not in head:
        raise SystemExit("manifest needs head.host")
    head.setdefault("bind", "127.0.0.1")
    head.setdefault("workers", 0)
    head.setdefault("data_dir", "lo_data")
    for worker in manifest["workers"]:
        worker.setdefault("processes", 1)
        worker.setdefault("data_dir", "lo_data")
    for machine in [head, *manifest["workers"]]:
        own = machine.get("env", {})
        if not isinstance(own, dict) or not all(
            isinstance(key, str) and isinstance(value, str)
            for key, value in own.items()
        ):
            raise SystemExit("a machine's env must map names to strings")
    if manifest["transport"] not in ("ssh", "local"):
        raise SystemExit(f"unknown transport {manifest['transport']!r}")
    sched = manifest.setdefault("sched", {})
    for key in sched:
        if key not in _SCHED_KNOBS:
            raise SystemExit(
                f"unknown sched knob {key!r} (have: "
                f"{', '.join(sorted(_SCHED_KNOBS))})"
            )
        # bool is an int subclass: `"device_width": true` must fail
        # here at manifest load, not crash-loop every machine later
        if (
            not isinstance(sched[key], int)
            or isinstance(sched[key], bool)
            or sched[key] < 1
        ):
            raise SystemExit(f"sched.{key} must be a positive integer")
    dataplane = manifest.setdefault("dataplane", {})
    for key in dataplane:
        if key not in _DATAPLANE_KNOBS:
            raise SystemExit(
                f"unknown dataplane knob {key!r} (have: "
                f"{', '.join(sorted(_DATAPLANE_KNOBS))})"
            )
        value = dataplane[key]
        # same bool-is-int trap as the sched knobs
        if not isinstance(value, int) or isinstance(value, bool):
            raise SystemExit(f"dataplane.{key} must be an integer")
        if key == "devcache_bytes":
            if value < 0:
                raise SystemExit("dataplane.devcache_bytes must be >= 0")
        elif value not in (0, 1):
            raise SystemExit(f"dataplane.{key} must be 0 or 1")
    wire = manifest.setdefault("wire", {})
    for key in wire:
        if key not in _WIRE_KNOBS:
            raise SystemExit(
                f"unknown wire knob {key!r} (have: "
                f"{', '.join(sorted(_WIRE_KNOBS))})"
            )
        value = wire[key]
        if key == "shm_bytes":
            # same bool-is-int trap as the sched knobs: JSON true would
            # stringify to "True" and fail every preflight downstream
            if not isinstance(value, int) or isinstance(value, bool):
                raise SystemExit("wire.shm_bytes must be an integer")
            if value < 0:  # 0 = shared-memory transport off, valid
                raise SystemExit("wire.shm_bytes must be >= 0")
        elif key == "dtype_policy":
            if not isinstance(value, str) or value not in ("f32", "bf16"):
                raise SystemExit("wire.dtype_policy must be f32 or bf16")
    coalescing = manifest.setdefault("coalescing", {})
    for key in coalescing:
        if key not in _COALESCING_KNOBS:
            raise SystemExit(
                f"unknown coalescing knob {key!r} (have: "
                f"{', '.join(sorted(_COALESCING_KNOBS))})"
            )
        value = coalescing[key]
        # same bool-is-int trap as the sched/serving knobs: JSON true
        # would stringify to "True" and fail every preflight downstream
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SystemExit(f"coalescing.{key} must be a number")
        if key == "max_jobs":
            if not isinstance(value, int) or value < 1:
                raise SystemExit(
                    "coalescing.max_jobs must be an integer >= 1"
                )
        elif value < 0:  # window_ms: 0 = passthrough, still valid
            raise SystemExit("coalescing.window_ms must be >= 0")
    serving = manifest.setdefault("serving", {})
    for key in serving:
        if key not in _SERVING_KNOBS:
            raise SystemExit(
                f"unknown serving knob {key!r} (have: "
                f"{', '.join(sorted(_SERVING_KNOBS))})"
            )
        value = serving[key]
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SystemExit(f"serving.{key} must be a number")
        if key in ("serve_bytes", "max_batch", "max_rows", "queue_cap") and (
            not isinstance(value, int)
        ):
            raise SystemExit(f"serving.{key} must be an integer")
        if key == "serve_bytes":
            if value < 0:  # 0 = host-only fallback, still valid
                raise SystemExit("serving.serve_bytes must be >= 0")
        elif key == "batch_window_ms":
            if value < 0:
                raise SystemExit("serving.batch_window_ms must be >= 0")
        elif key == "timeout_s":
            if value <= 0:
                raise SystemExit("serving.timeout_s must be > 0")
        elif value < 1:
            raise SystemExit(f"serving.{key} must be >= 1")
    fleet = manifest.setdefault("fleet", {})
    for key in fleet:
        if key not in _FLEET_KNOBS:
            raise SystemExit(
                f"unknown fleet knob {key!r} (have: "
                f"{', '.join(sorted(_FLEET_KNOBS))})"
            )
        value = fleet[key]
        # same bool-is-int trap as the sched knobs: `"replicas": true`
        # would stringify to "True" and fail every preflight downstream
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SystemExit(f"fleet.{key} must be a number")
        if key in ("replicas", "rf"):
            if not isinstance(value, int) or value < 1:
                raise SystemExit(f"fleet.{key} must be an integer >= 1")
        elif key == "model_qps":
            if value < 0:  # 0 = per-model quota off, still valid
                raise SystemExit("fleet.model_qps must be >= 0")
        elif value <= 0:  # down_s
            raise SystemExit("fleet.down_s must be > 0")
    profiling = manifest.setdefault("profiling", {})
    for key in profiling:
        if key not in _PROFILING_KNOBS:
            raise SystemExit(
                f"unknown profiling knob {key!r} (have: "
                f"{', '.join(sorted(_PROFILING_KNOBS))})"
            )
        value = profiling[key]
        # same bool-is-int trap as the sched knobs
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SystemExit(f"profiling.{key} must be a number")
        if key == "prof_hz":
            if not isinstance(value, int) or value < 0:
                raise SystemExit(
                    "profiling.prof_hz must be an integer >= 0 "
                    "(0 disables /debug/profile)"
                )
        elif key == "prof_window_s" and value <= 0:
            raise SystemExit("profiling.prof_window_s must be > 0")
    web = manifest.setdefault("web", {})
    for key in web:
        if key not in _WEB_KNOBS:
            raise SystemExit(
                f"unknown web knob {key!r} (have: "
                f"{', '.join(sorted(_WEB_KNOBS))})"
            )
        value = web[key]
        # same bool-is-int trap as the sched knobs: `"async": true`
        # would stringify to "True" and fail every preflight downstream
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SystemExit(f"web.{key} must be a number")
        if key == "async":
            if value not in (0, 1):
                raise SystemExit("web.async must be 0 or 1")
        elif key == "wait_cap_s":
            if value <= 0:
                raise SystemExit("web.wait_cap_s must be > 0")
        elif not isinstance(value, int) or value < 1:
            raise SystemExit(f"web.{key} must be an integer >= 1")
    resume = manifest.setdefault("resume", {})
    for key in resume:
        if key not in _RESUME_KNOBS:
            raise SystemExit(
                f"unknown resume knob {key!r} (have: "
                f"{', '.join(sorted(_RESUME_KNOBS))})"
            )
        value = resume[key]
        # same bool-is-int trap as the sched knobs: `"enabled": true`
        # would stringify to "True" and fail run.sh's strict-0/1
        # LO_RESUME preflight on every machine
        if isinstance(value, bool) or not isinstance(value, int):
            raise SystemExit(f"resume.{key} must be an integer")
        if key == "enabled":
            if value not in (0, 1):
                raise SystemExit("resume.enabled must be 0 or 1")
        elif value < 1:  # every_segments
            raise SystemExit("resume.every_segments must be >= 1")
    compile_knobs = manifest.setdefault("compile", {})
    for key in compile_knobs:
        if key not in _COMPILE_KNOBS:
            raise SystemExit(
                f"unknown compile knob {key!r} (have: "
                f"{', '.join(sorted(_COMPILE_KNOBS))})"
            )
        value = compile_knobs[key]
        # same bool-is-int trap as the sched knobs: `"aot": true`
        # would stringify to "True" and fail run.sh's strict-0/1
        # LO_AOT preflight on every machine
        if isinstance(value, bool) or not isinstance(value, int):
            raise SystemExit(f"compile.{key} must be an integer")
        if key in ("aot", "publish"):
            if value not in (0, 1):
                raise SystemExit(f"compile.{key} must be 0 or 1")
        elif value < 0:  # max_programs: 0 = enumerate-and-drop-all
            raise SystemExit("compile.max_programs must be >= 0")
    tsdb = manifest.setdefault("tsdb", {})
    for key in tsdb:
        if key not in _TSDB_KNOBS:
            raise SystemExit(
                f"unknown tsdb knob {key!r} (have: "
                f"{', '.join(sorted(_TSDB_KNOBS))})"
            )
        value = tsdb[key]
        if key == "interval_s":
            if (
                isinstance(value, bool)
                or not isinstance(value, (int, float))
                or value <= 0
            ):
                raise SystemExit("tsdb.interval_s must be > 0")
        # bool-is-int trap, same as the sched knobs: `"points": true`
        # would stringify to "True" and fail every preflight downstream
        elif isinstance(value, bool) or not isinstance(value, int) or value < 1:
            raise SystemExit(f"tsdb.{key} must be an integer >= 1")
    slo = manifest.setdefault("slo", {})
    for key in slo:
        if key not in _SLO_KNOBS:
            raise SystemExit(
                f"unknown slo knob {key!r} (have: "
                f"{', '.join(sorted(_SLO_KNOBS))})"
            )
        value = slo[key]
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SystemExit(f"slo.{key} must be a number")
        if key in ("queue_depth", "replication_lag"):
            if not isinstance(value, int) or value < 1:
                raise SystemExit(f"slo.{key} must be an integer >= 1")
        elif key == "window_s":
            if value <= 0:
                raise SystemExit("slo.window_s must be > 0")
        elif value < 0:  # serve_p99_s / http_5xx_rate: 0 = alert always
            raise SystemExit(f"slo.{key} must be >= 0")
    replication = manifest.setdefault("replication", {})
    for key in replication:
        if key not in _REPLICATION_KNOBS:
            raise SystemExit(
                f"unknown replication knob {key!r} (have: "
                f"{', '.join(sorted(_REPLICATION_KNOBS))})"
            )
    if replication:
        enabled = replication.get("enabled", True)
        if not isinstance(enabled, bool):
            raise SystemExit("replication.enabled must be true/false")
        replication["enabled"] = enabled
        for key in ("follower_port", "arbiter_port"):
            value = replication.setdefault(
                key, 27028 if key == "follower_port" else 27029
            )
            if (
                not isinstance(value, int)
                or isinstance(value, bool)
                or not 1 <= value <= 65535
            ):
                raise SystemExit(f"replication.{key} must be a port number")
        ports = {
            manifest["store_port"],
            replication["follower_port"],
            replication["arbiter_port"],
        }
        if enabled and len(ports) != 3:
            raise SystemExit(
                "replication needs three DISTINCT ports (store_port, "
                "follower_port, arbiter_port)"
            )
        auto = replication.setdefault("auto_promote_s", 5)
        if isinstance(auto, bool) or not isinstance(auto, (int, float)) or auto <= 0:
            raise SystemExit("replication.auto_promote_s must be > 0")
        sync = replication.setdefault("sync_repl", 0)
        if isinstance(sync, bool) or sync not in (0, 1):
            raise SystemExit("replication.sync_repl must be 0 or 1")
    sharding = manifest.setdefault("sharding", {})
    for key in sharding:
        if key not in _SHARDING_KNOBS:
            raise SystemExit(
                f"unknown sharding knob {key!r} (have: "
                f"{', '.join(sorted(_SHARDING_KNOBS))})"
            )
        value = sharding[key]
        if key == "map_ttl_s":
            if (
                isinstance(value, bool)
                or not isinstance(value, (int, float))
                or value < 0
            ):
                raise SystemExit(
                    "sharding.map_ttl_s must be >= 0 (0 = revalidate "
                    "the shard map on every read)"
                )
        # bool-is-int trap, same as the sched knobs: `"shards": true`
        # would stringify to "True" and fail every preflight downstream
        elif (
            isinstance(value, bool)
            or not isinstance(value, int)
            or value < 1
        ):
            raise SystemExit(f"sharding.{key} must be an integer >= 1")
    shards = sharding.get("shards", 1)
    if shards > 1 and _replication_enabled(manifest):
        # each extra group claims store_port + 10*i (+1 follower,
        # +2 arbiter): the meta group's configured pair must not land
        # inside any group's stride window
        group_ports = set()
        for index in range(1, shards):
            base = manifest["store_port"] + 10 * index
            group_ports.update((base, base + 1, base + 2))
        replication = manifest["replication"]
        for key in ("follower_port", "arbiter_port"):
            if replication[key] in group_ports:
                raise SystemExit(
                    f"replication.{key} collides with a shard group "
                    "port (groups claim store_port + 10*i .. +2)"
                )
    return manifest


# manifest sched.<knob> -> the env var every machine receives
_SCHED_KNOBS = {
    "job_workers": "LO_JOB_WORKERS",
    "device_width": "LO_SCHED_DEVICE_WIDTH",
    "queue_cap": "LO_SCHED_QUEUE_CAP",
}

# manifest dataplane.<knob> -> the env var every machine receives
# (docs/dataplane.md). Cluster-wide like the sched knobs: a device
# cache sized differently per host would skew per-host HBM headroom.
_DATAPLANE_KNOBS = {
    "devcache_bytes": "LO_DEVCACHE_BYTES",
    "store_compress": "LO_STORE_COMPRESS",
    "write_overlap": "LO_WRITE_OVERLAP",
}

# manifest wire.<knob> -> the env var every machine receives
# (docs/dataplane.md). Cluster-wide NON-NEGOTIABLY for dtype_policy:
# it is part of every devcache key and of SPMD dispatch shapes, so a
# per-host skew would desynchronize multi-host dispatch. shm_bytes
# rides along for symmetric co-located topologies.
_WIRE_KNOBS = {
    "shm_bytes": "LO_SHM_BYTES",
    "dtype_policy": "LO_DTYPE_POLICY",
}

# manifest coalescing.<knob> -> the env var every machine receives
# (docs/scheduler.md). Cluster-wide: coalescing keys include the mesh
# signature, and a per-host window skew would make "the same flood"
# fuse on one machine and serialize on another.
_COALESCING_KNOBS = {
    "window_ms": "LO_COALESCE_WINDOW_MS",
    "max_jobs": "LO_COALESCE_MAX_JOBS",
}

# manifest serving.<knob> -> the env var every machine receives
# (docs/serving.md). Only the head serves REST today, but the knobs go
# cluster-wide like the others: a failover promotion or a future
# per-host serving lane must not inherit silently different budgets.
_SERVING_KNOBS = {
    "serve_bytes": "LO_SERVE_BYTES",
    "batch_window_ms": "LO_SERVE_BATCH_WINDOW_MS",
    "max_batch": "LO_SERVE_MAX_BATCH",
    "max_rows": "LO_SERVE_MAX_ROWS",
    "queue_cap": "LO_SERVE_QUEUE_CAP",
    "timeout_s": "LO_SERVE_TIMEOUT_S",
}

# manifest fleet.<knob> -> the env var every machine receives
# (docs/serving.md "Fleet"). Plumbed cluster-wide like the serving
# knobs so a promoted head inherits the same fleet shape, but only a
# single-host stack ACTS on LO_FLEET_REPLICAS — the stack's multi-host
# topology logs it as ignored (the coordinator serves predicts itself).
_FLEET_KNOBS = {
    "replicas": "LO_FLEET_REPLICAS",
    "rf": "LO_FLEET_RF",
    "model_qps": "LO_FLEET_MODEL_QPS",
    "down_s": "LO_FLEET_DOWN_S",
}

# manifest profiling.<knob> -> the env var every machine receives
# (docs/profiling.md). Cluster-wide: a stall diagnosis must be able to
# hit /debug/profile on ANY member, so no machine may silently run with
# the profiler knocked out or a different window cap.
_PROFILING_KNOBS = {
    "prof_hz": "LO_PROF_HZ",
    "prof_window_s": "LO_PROF_WINDOW_S",
}

# manifest web.<knob> -> the env var every machine receives
# (docs/web.md). Cluster-wide like the serving knobs: a failover
# promotion must not flip a machine between the event-loop core and
# the threaded escape hatch, or change how many waiters it can hold.
_WEB_KNOBS = {
    "async": "LO_WEB_ASYNC",
    "handlers": "LO_WEB_HANDLERS",
    "max_conns": "LO_WEB_MAX_CONNS",
    "wait_cap_s": "LO_WEB_WAIT_CAP_S",
}

# manifest resume.<knob> -> the env var every machine receives
# (docs/robustness.md). Cluster-wide: recovery decisions must be
# uniform — a machine with resume off would fail the very jobs its
# peers checkpoint for, and a skewed cadence skews the re-done-work
# bound the chaos drill asserts on.
_RESUME_KNOBS = {
    "enabled": "LO_RESUME",
    "every_segments": "LO_RESUME_EVERY_SEGMENTS",
}

# manifest compile.<knob> -> the env var every machine receives
# (compile/config.py). Cluster-wide: the fleet's shared libraries only
# pay off when every member enumerates the SAME manifest — a member
# with a different cap would publish a different set and peers would
# run nvcc on libraries they expected to fetch.
_COMPILE_KNOBS = {
    "aot": "LO_AOT",
    "max_programs": "LO_AOT_MAX_PROGRAMS",
    "publish": "LO_AOT_PUBLISH",
}

# manifest tsdb.<knob> -> the env var every machine receives
# (docs/observability.md). Cluster-wide: the retention cap and scrape
# cadence shape ONE shared ring in the head store, and trace_ring
# bounds every member's span export buffer the stitcher drains —
# a member with a smaller ring would silently drop the oldest spans
# out of stitched traces.
_TSDB_KNOBS = {
    "points": "LO_TSDB_POINTS",
    "interval_s": "LO_METRICS_INTERVAL_S",
    "trace_ring": "LO_TRACE_RING",
}

# manifest slo.<knob> -> the env var every machine receives
# (docs/observability.md). Cluster-wide: burn verdicts must come from
# ONE threshold set no matter which member's /debug/slo is asked.
_SLO_KNOBS = {
    "window_s": "LO_SLO_WINDOW_S",
    "serve_p99_s": "LO_SLO_SERVE_P99_S",
    "http_5xx_rate": "LO_SLO_5XX_RATE",
    "queue_depth": "LO_SLO_QUEUE_DEPTH",
    "replication_lag": "LO_SLO_REPL_LAG",
}

# manifest sharding.<knob> -> the env var every machine receives
# (docs/dataplane.md). Cluster-wide NON-NEGOTIABLY: shards and
# stripe_rows define the hash-ring placement every client computes
# locally, so a per-host skew would route the same _id to different
# groups; the shard-map doc pins them and clients refuse a mismatch.
_SHARDING_KNOBS = {
    "shards": "LO_SHARDS",
    "stripe_rows": "LO_SHARD_STRIPE_ROWS",
    "map_ttl_s": "LO_SHARDMAP_TTL_S",
}

# manifest replication.<knob> (docs/replication.md); the head machine
# runs the whole store plane, every machine's LO_STORE_URL names the
# primary AND the follower for client-side failover
_REPLICATION_KNOBS = (
    "enabled",
    "follower_port",
    "arbiter_port",
    "auto_promote_s",
    "sync_repl",
)


def _replication_enabled(manifest: dict) -> bool:
    replication = manifest.get("replication") or {}
    return bool(replication) and replication.get("enabled", True)


def total_processes(manifest: dict) -> int:
    return (
        1
        + manifest["head"]["workers"]
        + sum(w["processes"] for w in manifest["workers"])
    )


def machine_plans(manifest: dict) -> list[dict]:
    """Per-machine launch plans: name, env, ssh target, data_dir."""
    head = manifest["head"]
    total = total_processes(manifest)
    store_url = f"http://{head['host']}:{manifest['store_port']}"
    replication = manifest.get("replication") or {}
    if _replication_enabled(manifest):
        # workers and clients fail over between the pair client-side
        store_url += (
            f",http://{head['host']}:{replication['follower_port']}"
        )
    shards = manifest.get("sharding", {}).get("shards", 1)
    if shards > 1:
        # one `;`-separated segment per store group (core/shardmap.py):
        # group i lives at store_port + 10*i, its follower one above —
        # the exact ports the stack's sharded store plane binds
        groups = [store_url]
        for index in range(1, shards):
            base = manifest["store_port"] + 10 * index
            group = f"http://{head['host']}:{base}"
            if _replication_enabled(manifest):
                group += f",http://{head['host']}:{base + 1}"
            groups.append(group)
        store_url = ";".join(groups)
    coordinator = f"{head['host']}:{manifest['coord_port']}"
    shared = dict(manifest["env"])
    shared["LO_TOTAL_PROCESSES"] = str(total)
    if manifest["transport"] == "ssh":
        # the ssh channel is the launcher's lifeline: EOF on it tells
        # the remote stack its driver is gone (see plan_command)
        shared["LO_STACK_EXIT_ON_STDIN_EOF"] = "1"
    # scheduler knobs apply cluster-wide: every machine's services
    # admit through the same widths/caps (docs/scheduler.md). .get():
    # callers may hand-build plans without load_manifest's defaults.
    for knob, env_var in _SCHED_KNOBS.items():
        if knob in manifest.get("sched", {}):
            shared[env_var] = str(manifest["sched"][knob])
    for knob, env_var in _DATAPLANE_KNOBS.items():
        if knob in manifest.get("dataplane", {}):
            shared[env_var] = str(manifest["dataplane"][knob])
    for knob, env_var in _WIRE_KNOBS.items():
        if knob in manifest.get("wire", {}):
            shared[env_var] = str(manifest["wire"][knob])
    for knob, env_var in _COALESCING_KNOBS.items():
        if knob in manifest.get("coalescing", {}):
            shared[env_var] = str(manifest["coalescing"][knob])
    for knob, env_var in _SERVING_KNOBS.items():
        if knob in manifest.get("serving", {}):
            shared[env_var] = str(manifest["serving"][knob])
    for knob, env_var in _FLEET_KNOBS.items():
        if knob in manifest.get("fleet", {}):
            shared[env_var] = str(manifest["fleet"][knob])
    for knob, env_var in _PROFILING_KNOBS.items():
        if knob in manifest.get("profiling", {}):
            shared[env_var] = str(manifest["profiling"][knob])
    for knob, env_var in _WEB_KNOBS.items():
        if knob in manifest.get("web", {}):
            shared[env_var] = str(manifest["web"][knob])
    for knob, env_var in _RESUME_KNOBS.items():
        if knob in manifest.get("resume", {}):
            shared[env_var] = str(manifest["resume"][knob])
    for knob, env_var in _COMPILE_KNOBS.items():
        if knob in manifest.get("compile", {}):
            shared[env_var] = str(manifest["compile"][knob])
    for knob, env_var in _TSDB_KNOBS.items():
        if knob in manifest.get("tsdb", {}):
            shared[env_var] = str(manifest["tsdb"][knob])
    for knob, env_var in _SLO_KNOBS.items():
        if knob in manifest.get("slo", {}):
            shared[env_var] = str(manifest["slo"][knob])
    for knob, env_var in _SHARDING_KNOBS.items():
        if knob in manifest.get("sharding", {}):
            shared[env_var] = str(manifest["sharding"][knob])
    # the driver scrapes every member centrally (up()'s scrape loop)
    # and pushes into the head store's TSDB ring, so the per-process
    # fallback collectors stay off; an explicit manifest env wins
    shared.setdefault("LO_TSDB_COLLECT", "0")
    # the fan-out list GET /traces/<cid> stitches across: the head
    # store plus the head's seven services (worker machines have no
    # REST surface to drain)
    plane = [f"http://{head['host']}:{manifest['store_port']}"] + [
        f"http://{head['host']}:{port}" for port in SERVICE_PORTS
    ]
    shared.setdefault("LO_PLANE_MEMBERS", ",".join(plane))
    if "models_dir" in manifest:
        shared["LO_MODELS_DIR"] = manifest["models_dir"]

    head_env = dict(shared)
    head_env.update(head.get("env", {}))
    head_env.update(
        {
            "LO_HOST": head["bind"],
            "LO_STORE_PORT": str(manifest["store_port"]),
            "LO_COORD_PORT": str(manifest["coord_port"]),
            "LO_WORKERS": str(head["workers"]),
            "LO_DATA_DIR": head["data_dir"],
        }
    )
    if _replication_enabled(manifest):
        head_env.update(
            {
                "LO_REPLICATION": "1",
                "LO_FOLLOWER_PORT": str(replication["follower_port"]),
                "LO_ARBITER_PORT": str(replication["arbiter_port"]),
                "LO_AUTO_PROMOTE_S": str(replication["auto_promote_s"]),
            }
        )
        if replication.get("sync_repl"):
            head_env["LO_STORE_SYNC_REPL"] = "1"
    plans = [
        {
            "name": "head",
            "ssh": head.get("ssh"),
            "host": head["host"],
            "env": head_env,
            "ready_markers": HEAD_READY_MARKERS,
        }
    ]
    next_process_id = 1 + head["workers"]
    for index, worker in enumerate(manifest["workers"]):
        env = dict(shared)
        env.update(worker.get("env", {}))
        env.update(
            {
                "LO_PROCESS_BASE": str(next_process_id),
                "LO_WORKERS": str(worker["processes"]),
                "LO_COORDINATOR": coordinator,
                "LO_STORE_URL": store_url,
                "LO_DATA_DIR": worker["data_dir"],
            }
        )
        plans.append(
            {
                "name": f"machine{index + 1}",
                "ssh": worker.get("ssh"),
                "host": worker["host"],
                "env": env,
                "ready_markers": (WORKER_READY_MARKER,),
            }
        )
        next_process_id += worker["processes"]
    return plans


def plan_command(manifest: dict, plan: dict) -> list[str]:
    """argv for one machine's stack, through the configured transport."""
    if manifest["transport"] == "local":
        return [sys.executable, "-m", STACK_MODULE]
    repo = manifest.get("repo", REPO_ROOT)
    env_prefix = " ".join(
        f"{key}={shlex.quote(value)}" for key, value in plan["env"].items()
    )
    remote = (
        f"cd {shlex.quote(repo)} && exec env {env_prefix} "
        f"{manifest['python']} -m {STACK_MODULE}"
    )
    # fall back to the machine's manifest host (the bind address in env
    # is 0.0.0.0/absent for workers — not an ssh target)
    target = plan["ssh"] or plan["host"]
    return ["ssh", "-o", "BatchMode=yes", target, remote]


class Machine:
    """One machine's supervised stack process (local or over ssh)."""

    def __init__(self, manifest: dict, plan: dict, log):
        self.manifest = manifest
        self.plan = plan
        self.log = log
        self.proc: subprocess.Popen | None = None
        self.ready = threading.Event()

    def start(self) -> None:
        self.ready.clear()
        env = None
        if self.manifest["transport"] == "local":
            env = dict(os.environ)
            env.update(self.plan["env"])
            env["PYTHONPATH"] = (
                REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
            )
            env["PYTHONUNBUFFERED"] = "1"
        # stdin is a PIPE the driver holds open for the machine's
        # lifetime: the remote stack watches the ssh channel's stdin for
        # EOF (LO_STACK_EXIT_ON_STDIN_EOF) — an inherited stdin would
        # hand it /dev/null's immediate EOF under nohup/systemd/CI and
        # tear every stack down at bring-up (or let several ssh clients
        # race for the operator's terminal keystrokes).
        self.proc = subprocess.Popen(
            plan_command(self.manifest, self.plan),
            env=env,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=REPO_ROOT,
        )
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        proc = self.proc
        for line in proc.stdout:
            if any(marker in line for marker in self.plan["ready_markers"]):
                self.ready.set()
            self.log(f"[{self.plan['name']}] {line.rstrip()}")

    def poll(self):
        return self.proc.poll() if self.proc else None

    def terminate(self) -> None:
        if self.proc and self.proc.poll() is None:
            self.proc.terminate()

    def _remote_kill(self) -> None:
        """Kill the REMOTE stack process group explicitly: terminating
        the local ``ssh -o BatchMode=yes`` client does NOT signal the
        remote side (no tty → no SIGHUP), so without this every cluster
        restart stranded the previous stack — and its whole runtime
        group — on the worker machine."""
        if self.manifest["transport"] != "ssh":
            return
        target = self.plan["ssh"] or self.plan["host"]
        try:
            subprocess.run(
                [
                    "ssh", "-o", "BatchMode=yes",
                    "-o", "ConnectTimeout=5",
                    target,
                    # the launched command is `exec ... python -m <STACK_MODULE>`
                    # (plan_command); match it, not every python on the box
                    f"pkill -f {STACK_MODULE} || true",
                ],
                timeout=15,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                check=False,
            )
        except (OSError, subprocess.TimeoutExpired):
            pass  # machine unreachable: nothing left to kill from here

    def stop(self, timeout: float = 15.0) -> None:
        # closing stdin FIRST is the graceful path: the remote stack's
        # stdin-EOF watchdog shuts the whole process tree down cleanly;
        # terminate + the explicit remote pkill remain the backstop
        if self.proc is not None and self.proc.stdin is not None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
        self.terminate()
        self._remote_kill()
        if self.proc is not None:
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()


# services on their reference ports (learningorchestra_tpu_torch/services);
# the driver imports nothing of the package but this module, so it
# starts in a fraction of a second and touches no card. The names label the TSDB
# samples the driver pushes into the store (POST /metrics/ingest).
SERVICE_NAMES = {
    5000: "database_api",
    5001: "projection",
    5002: "model_builder",
    5003: "data_type_handler",
    5004: "histogram",
    5005: "tsne",
    5006: "pca",
}
SERVICE_PORTS = tuple(sorted(SERVICE_NAMES))

# the families the cluster summary line aggregates across members
SUMMARY_FAMILIES = (
    "lo_http_requests_total",
    "lo_http_requests_in_flight",
    "lo_jobs_running",
    "lo_jobs_total",
    "lo_spmd_jobs_total",
    "lo_spmd_watchdog_trips_total",
    "lo_store_collections",
    "lo_store_wal_bytes",
    "lo_store_spill_bytes",
    "lo_compile_events_total",
    "lo_aot_programs_fetched_total",
)


def parse_prometheus(text: str, strict: bool = False) -> dict:
    """Family → summed sample value (labels collapsed; histogram bucket
    samples skipped — the driver's summary wants totals, not shape).

    ``strict=True`` raises ValueError on a non-comment line that is not
    a parseable sample: the per-member scrape uses it so a truncated or
    corrupted body surfaces as a counted skip, never as silently-wrong
    totals folded into the cluster summary."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value_part = line.rsplit(" ", 1)
            value = float(value_part)
        except ValueError as error:
            if strict:
                raise ValueError(
                    f"unparseable sample line {line!r}"
                ) from error
            continue
        family = name_part.split("{", 1)[0]
        if family.endswith("_bucket"):
            continue
        out[family] = out.get(family, 0.0) + value
    return out


def scrape_member_metrics(urls: list[str]) -> tuple[dict, dict]:
    """Scrape each member's ``/metrics``; unreachable members (worker
    machines have no REST surface, loopback-bound services aren't
    visible from the driver) are skipped, not errors. A member that
    answers with a malformed or truncated body (mid-restart, a proxy
    error page, a cut connection) is ALSO a per-member skip — counted
    in ``_malformed`` for the summary line, never a scrape-thread
    crash. Returns ``(totals, texts)``: the summed families plus each
    healthy member's raw exposition text keyed by URL, for the central
    TSDB ingest push."""
    totals: dict[str, float] = {}
    texts: dict[str, str] = {}
    reachable = 0
    malformed = 0
    for url in urls:
        try:
            with urllib.request.urlopen(url + "/metrics", timeout=3) as resp:
                raw = resp.read()
        except (OSError, http.client.HTTPException):
            # http.client.HTTPException covers IncompleteRead: a member
            # dying mid-response truncates the body during read()
            continue
        try:
            text = raw.decode()
            families = parse_prometheus(text, strict=True)
        except (UnicodeDecodeError, ValueError):
            malformed += 1
            continue
        reachable += 1
        texts[url] = text
        for family, value in families.items():
            totals[family] = totals.get(family, 0.0) + value
    totals["_members"] = reachable
    totals["_malformed"] = malformed
    return totals, texts


def push_member_metrics(store_url: str, texts: dict, log=print) -> int:
    """Push each scraped member's raw exposition text into the head
    store's TSDB ring (``POST /metrics/ingest``) — the cluster-mode
    replacement for every runner's in-process fallback collector
    (which the driver disables via LO_TSDB_COLLECT=0). The store side
    parses and delta-compresses; the driver stays import-free."""
    pushed = 0
    for url, text in texts.items():
        instance = url.split("//", 1)[-1]
        port = instance.rsplit(":", 1)[-1]
        service = SERVICE_NAMES.get(
            int(port) if port.isdigit() else -1, "store"
        )
        body = json.dumps(
            {"instance": instance, "service": service, "text": text}
        ).encode()
        request = urllib.request.Request(
            store_url + "/metrics/ingest",
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(request, timeout=3) as resp:
                if resp.status == 200:
                    pushed += 1
        except (OSError, http.client.HTTPException) as error:
            log(f"[cluster] metrics ingest push failed for {instance}: "
                f"{error}")
    return pushed


def metrics_summary_line(totals: dict) -> str:
    parts = [f"members={int(totals.get('_members', 0))}"]
    if totals.get("_malformed"):
        parts.append(f"malformed={int(totals['_malformed'])}")
    for family in SUMMARY_FAMILIES:
        if family in totals:
            value = totals[family]
            short = family[len("lo_"):]
            parts.append(
                f"{short}={int(value) if value == int(value) else value}"
            )
    return "[cluster] metrics: " + " ".join(parts)


def wait_store_health(url: str, timeout: float, alive=None) -> None:
    """Until the store at ``url`` answers ``/health``; raises past
    ``timeout``, or at once when ``alive()`` says its machine is gone."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if alive is not None and not alive():
            raise RuntimeError(f"the head exited before its store at {url} was healthy")
        try:
            with urllib.request.urlopen(url + "/health", timeout=2) as resp:
                if resp.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.3)
    raise TimeoutError(f"store not healthy at {url} within {timeout}s")


def up(manifest: dict, log=print) -> int:
    plans = machine_plans(manifest)
    machines = [Machine(manifest, plan, log) for plan in plans]
    head = machines[0]
    store_url = (
        f"http://{manifest['head']['host']}:{manifest['store_port']}"
    )
    stopping = threading.Event()
    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, lambda *_: stopping.set())

    max_restarts = manifest.get("max_cluster_restarts")
    restart_delay = manifest["restart_delay"]
    restarts = 0

    def launch_all() -> None:
        head.start()
        # the dockerize -wait gate: workers join only once the head's
        # store answers (their stacks would otherwise crash-loop on a
        # half-up head)
        wait_store_health(store_url, 180, alive=lambda: head.poll() is None)
        log(f"[cluster] store healthy at {store_url}")
        for machine in machines[1:]:
            machine.start()
        deadline = time.time() + 600
        for machine in machines:
            while not machine.ready.wait(0.5):
                # a machine that exited will never be ready: say so now
                # (a port taken, a crash at boot), not at the deadline
                dead = [m.plan["name"] for m in machines if m.poll() is not None]
                if dead:
                    raise RuntimeError(f"{dead} exited before the cluster was up")
                if time.time() > deadline:
                    raise TimeoutError(
                        f"{machine.plan['name']} not ready within budget"
                    )
        state = {
            "head": manifest["head"]["host"],
            "store_url": store_url,
            "total_processes": total_processes(manifest),
            "machines": [m.plan["name"] for m in machines],
        }
        with open("cluster_state.json", "w") as handle:
            json.dump(state, handle)
        log(
            f"[cluster] up: {len(machines)} machine(s), "
            f"{total_processes(manifest)} runtime process(es)"
        )

    def stop_all() -> None:
        for machine in machines:
            machine.terminate()
        for machine in machines:
            machine.stop()

    # the head's scrape surface: store server + the seven services (the
    # latter answer only when LO_HOST exposes them beyond loopback — the
    # scraper skips silently otherwise). On its OWN thread: a member
    # dropping packets makes each URL eat the full connect timeout, and
    # ~24 s of scrape stall inside the supervision loop would delay
    # dead-machine detection — and the whole-cluster relaunch — by that
    # much every interval.
    scrape_urls = [store_url] + [
        f"http://{manifest['head']['host']}:{port}" for port in SERVICE_PORTS
    ]
    scrape_interval = float(os.environ.get("LO_METRICS_INTERVAL_S", "60"))

    def scrape_loop() -> None:
        while not stopping.wait(scrape_interval):
            totals, texts = scrape_member_metrics(scrape_urls)
            if totals.get("_members") or totals.get("_malformed"):
                log(metrics_summary_line(totals))
            if texts:
                # retention lives IN the store: each healthy member's
                # raw text lands in the head store's __lo_metrics__
                # ring, where /metrics/history and the SLO engine read
                push_member_metrics(store_url, texts, log)

    if scrape_interval > 0:
        threading.Thread(
            target=scrape_loop, name="metrics-scrape", daemon=True
        ).start()

    exit_code = 0
    try:
        launch_all()
        while not stopping.is_set():
            time.sleep(0.5)
            dead = [m for m in machines if m.poll() is not None]
            if not dead:
                continue
            if max_restarts is not None and restarts >= max_restarts:
                log(
                    f"[cluster] {[m.plan['name'] for m in dead]} exited "
                    f"after {restarts} cluster restarts; giving up"
                )
                exit_code = 1
                break
            restarts += 1
            log(
                f"[cluster] {[m.plan['name'] for m in dead]} exited — "
                "restarting the whole cluster (a lost member poisons "
                f"the collective runtime), #{restarts} in {restart_delay}s"
            )
            stop_all()
            time.sleep(restart_delay)
            try:
                launch_all()
            except Exception as error:  # noqa: BLE001
                # a slow recovery (long WAL replay, stalled member) is a
                # restartable condition, not the end of supervision: the
                # loop sees the dead members next tick and retries under
                # the same max_restarts budget
                log(f"[cluster] relaunch failed ({error}); will retry")
    finally:
        log("[cluster] shutting down")
        stop_all()
    return exit_code


def render(manifest: dict) -> None:
    for plan in machine_plans(manifest):
        print(f"# {plan['name']}")
        if manifest["transport"] == "local":
            env = " ".join(
                f"{k}={shlex.quote(v)}" for k, v in plan["env"].items()
            )
            print(f"env {env} {sys.executable} -m {STACK_MODULE}")
        else:
            print(" ".join(shlex.quote(a) for a in plan_command(manifest, plan)))
        print()


def main() -> int:
    if len(sys.argv) != 3 or sys.argv[1] not in ("up", "render"):
        print(__doc__)
        return 2
    manifest = load_manifest(sys.argv[2])
    if sys.argv[1] == "render":
        render(manifest)
        return 0
    return up(manifest)


if __name__ == "__main__":
    sys.exit(main())
