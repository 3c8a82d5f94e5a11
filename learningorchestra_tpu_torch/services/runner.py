"""Serve the service stack: all seven in one process, or one per process.

Counterpart of ``learningorchestra_tpu/services/runner.py``. Both of its
topologies run on the CUDA card (the runner raises without one):

- **single process** (default): seven servers over one store (the
  in-process WAL-backed one, or a store server's through
  ``LO_STORE_URL``), one scheduler with a job journal for all of them,
  and recovery of the journal before the first request —
  ``python -m learningorchestra_tpu_torch.services.runner``;
- **one service per process** (the reference's seven containers): start
  a store server (``python -m
  learningorchestra_tpu_torch.core.store_service``), then one runner a
  service with ``LO_SERVICE=<name>`` and ``LO_STORE_URL`` set; each
  process journals its own jobs (the journal's scope is the service)
  and recovers only those. Each device service (model_builder, tsne,
  pca) holds its own CUDA context, device cache (``LO_DEVCACHE_BYTES``)
  and serve registry (``LO_SERVE_BYTES``).

- **several processes, one a rank** (the reference's multi-host mode):
  with ``LO_COORDINATOR``, ``LO_NUM_PROCESSES`` and ``LO_PROCESS_ID``
  set, every process joins one ``torch.distributed`` group
  (parallel/multihost.py); rank 0 serves REST and submits the compute
  jobs (model builds, batch predictions, PCA and t-SNE images) through
  the SPMD dispatcher (parallel/spmd.py), and every other rank runs its
  worker loop, with no REST surface. Every rank then runs the job over
  the all-ranks data mesh; only rank 0 writes to the store and the
  images folder. It needs ``LO_STORE_URL`` (one store server for every
  rank) and ``LO_MODELS_DIR`` (a folder every rank reads). Sweeps are
  not dispatched: ``POST /models/sweep`` runs on rank 0's card.

Tests start the stack with ``start_all(..., device="cpu")`` or
``main(device="cpu")``; ranks that share one card, or the CPU, join over
gloo with ``main(device=..., backend="gloo")``.

Environment:
- ``LO_SERVICE`` — serve only this service (``database_api``,
  ``projection``, ``model_builder``, ``data_type_handler``,
  ``histogram``, ``tsne``, ``pca``, or ``router``: the fleet router,
  serve/router.py, never one of the all-in-one seven); unset: all seven
- ``LO_PORT`` — the bind port of the one service (default: its
  reference port, 5007 for the router; ``0``: OS-assigned); the
  ``service <name> on <host>:<port>`` boot line names the bind
- ``LO_FLEET_REPLICAS`` / ``LO_FLEET_RF`` / ``LO_FLEET_MODEL_QPS`` /
  ``LO_FLEET_DOWN_S`` — the replicated serving fleet (serve/fleet.py):
  the placement geometry, the router's per-model quota and the
  heartbeat age past which the router routes around a replica. A
  ``model_builder`` process with ``LO_FLEET_REPLICA=<index>`` runs a
  ``ReplicaAgent`` on its serve plane, which pins the checkpoints the
  placement assigns it and heartbeats its URL; the ``fleet config:``
  boot line states them, and a malformed value refuses bring-up
- ``LO_WEB_ASYNC`` (1: the event loop, utils/webloop.py; 0: the threaded
  ``http.server``), ``LO_WEB_HANDLERS``, ``LO_WEB_MAX_CONNS``,
  ``LO_WEB_WAIT_CAP_S`` — the ``web config:`` boot line states them
- ``LO_STORE_URL`` — a store server; a comma-separated list names a
  replica set the client fails over within; ``;`` separates shard
  groups, which a ``ShardedStore`` stripes rows over. Unset: the
  in-process store on its WAL
- ``LO_SHARD_STRIPE_ROWS``, ``LO_SHARDMAP_TTL_S`` — the sharded store's
  stripe width and shard-map cache; the ``shard config:`` boot line
  states them, and a bad value refuses bring-up
- ``LO_DATA_DIR`` — store WAL directory (default ``./lo_data``)
- ``LO_IMAGES_DIR`` — PNG volume root (default ``<data>/images``)
- ``LO_MODELS_DIR`` — model checkpoint and progress-artifact volume
  (default ``<data>/models``; empty string disables checkpointing, and
  with it crash resume); shared by every process of the topology
- ``LO_COORDINATOR`` (host:port of rank 0's rendezvous),
  ``LO_NUM_PROCESSES``, ``LO_PROCESS_ID`` — the multi-host mode above:
  all three set joins the group (NCCL on a CUDA card, gloo on the CPU);
  ``LO_SPMD_TIMEOUT_S`` (default 3600; 0: off) is a job's watchdog and
  ``LO_SPMD_HEARTBEAT_S`` (default 10) the coordinator's idle ping
- ``LO_DEVICE`` (``cuda`` or ``cpu``) and ``LO_DIST_BACKEND`` (``nccl`` or
  ``gloo``) — read by the module entry only (``python -m
  learningorchestra_tpu_torch.services.runner``), where the reference
  reads ``JAX_PLATFORMS`` and lets jax.distributed pick its transport:
  unset is ``cuda`` (raises without a card) and NCCL on a card, gloo on
  the CPU; any other value refuses to boot, and only the knob set to
  ``cpu`` or ``gloo`` picks them
- ``LO_AOT``, ``LO_AOT_MAX_PROGRAMS``, ``LO_AOT_PUBLISH`` — the compile
  plane (compile/config.py): with ``LO_AOT=1`` the runner fetches the
  kernel libraries the fleet published into its build folder at boot
  (``LO_JIT_CACHE``, else ``kernels/_build/``), then builds the rest on a
  daemon thread and publishes them (compile/aot.py). In the multi-host
  mode a rank past 0 fetches once rank 0's pass has ended, so the
  libraries rank 0 holds come over the store; the ``compile config:``
  boot line states the knobs, and a malformed value refuses bring-up
- ``LO_HOST`` — bind host (default ``127.0.0.1``: the model builder runs
  request-supplied preprocessor code, so exposing the stack must be an
  explicit opt-in)
- ``LO_EPHEMERAL=1`` — all seven in one process on OS-assigned ports
  instead of 5000-5006
- the observability plane's knobs: ``LO_TSDB_COLLECT`` (0 turns off this
  process's collector into the store's ``__lo_metrics__`` ring),
  ``LO_METRICS_INTERVAL_S``, ``LO_TSDB_POINTS``, ``LO_TRACE_RING``,
  ``LO_SLO_*`` (telemetry/slo.py), ``LO_PROF_HZ``, ``LO_PROF_WINDOW_S``
  (the sampling profiler) and ``LO_PLANE_MEMBERS`` (the service URLs
  ``GET /traces/<cid>`` stitches across)
- the scheduler, coalescing, resume and serving knobs of
  ``sched/config.py`` and ``serve/config.py`` (``LO_JOB_WORKERS``,
  ``LO_SCHED_DEVICE_WIDTH``, ``LO_SCHED_QUEUE_CAP``, ``LO_RESUME``,
  ``LO_RESUME_EVERY_SEGMENTS``, ``LO_COALESCE_WINDOW_MS``,
  ``LO_SERVE_*``, ...), ``LO_BUILD_WORKERS`` (ml/builder.py) and
  ``LO_PROGRAM_ROW_STEPS`` (ml/base.py).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from learningorchestra_tpu_torch.core.jobs import JobManager
from learningorchestra_tpu_torch.core.store import DocumentStore, InMemoryStore
from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.sched import (
    JobJournal,
    Scheduler,
    recover_jobs,
    shard_scope,
)
from learningorchestra_tpu_torch.services import (
    DATA_TYPE_HANDLER_PORT,
    DATABASE_API_PORT,
    HISTOGRAM_PORT,
    MODEL_BUILDER_PORT,
    PCA_PORT,
    PROJECTION_PORT,
    ROUTER_PORT,
    TSNE_PORT,
)
from learningorchestra_tpu_torch.services import (
    data_type_handler,
    database_api,
    histogram,
    images,
    model_builder,
    projection,
)
from learningorchestra_tpu_torch.utils.web import ServerThread

SERVICES: dict[str, int] = {
    "database_api": DATABASE_API_PORT,
    "projection": PROJECTION_PORT,
    "model_builder": MODEL_BUILDER_PORT,
    "data_type_handler": DATA_TYPE_HANDLER_PORT,
    "histogram": HISTOGRAM_PORT,
    "tsne": TSNE_PORT,
    "pca": PCA_PORT,
}


DEVICES = ("cuda", "cpu")
DIST_BACKENDS = ("nccl", "gloo")


def _choice_env(name: str, choices: tuple) -> Optional[str]:
    """A knob that names one of ``choices``; unset or empty: None."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    if raw not in choices:
        raise ValueError(f"{name} must be one of {'|'.join(choices)}, got {raw!r}")
    return raw


def device_from_env() -> Optional[str]:
    """``LO_DEVICE``: the device the module entry boots on, where the
    reference reads ``JAX_PLATFORMS``. Unset: None, the CUDA card."""
    return _choice_env("LO_DEVICE", DEVICES)


def backend_from_env() -> Optional[str]:
    """``LO_DIST_BACKEND``: the multi-host group's backend, where the
    reference lets jax.distributed pick its transport. Unset: None, NCCL
    on a card and gloo on the CPU (``parallel/multihost.py``)."""
    return _choice_env("LO_DIST_BACKEND", DIST_BACKENDS)


def _compile_rendezvous(rank: int, timeout_s: float = 900.0):
    """``(before_fetch, after_run)`` of a rank's compile-plane pass in the
    multi-host mode: rank 0 marks its pass's end in the group's
    rendezvous store, and a rank past 0 waits for that mark before it
    fetches, so what rank 0 built or fetched reaches it over the store
    instead of through its own nvcc. The mark is polled (``check``), so
    the wait never holds the store's client against the group's own use
    of it; past ``timeout_s`` the rank fetches what is there."""
    from torch.distributed import distributed_c10d

    try:
        group_store = distributed_c10d._get_default_store()
    except (AttributeError, RuntimeError, ValueError):   # no rendezvous store to mark
        return None, None
    key = "lo_aot_pass_done"
    if rank == 0:
        return None, lambda stats: group_store.set(key, "1")

    def wait() -> None:
        deadline = time.monotonic() + timeout_s
        while not group_store.check([key]) and time.monotonic() < deadline:
            time.sleep(0.2)

    return wait, None


def make_dispatcher(store: DocumentStore, images_dir: str, device: DeviceLike = None):
    """The SPMD dispatcher of the compute jobs (reference
    ``services/runner.py:180-233``): the coordinator's REST handlers
    submit, every rank runs the job over the all-ranks data mesh on
    ``device`` (None: the CUDA card), and only the coordinator writes to
    the store and the images folder. A worker logs each job's kernel
    launches and collectives when it ends (``spmd worker <rank>: job
    <op> done {...}``)."""
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.ml.builder import build_model, predict_with_model
    from learningorchestra_tpu_torch.ops.images import create_embedding_image
    from learningorchestra_tpu_torch.parallel import multihost
    from learningorchestra_tpu_torch.parallel.mesh import default_mesh
    from learningorchestra_tpu_torch.parallel.spmd import SpmdDispatcher, process_index
    from learningorchestra_tpu_torch.telemetry.profile import compile_events

    device = resolve_device(device)
    rank = process_index()
    coordinator = rank == 0
    # the reference's default mesh spans every process; the port's
    # mesh=None is one device, so the handlers pass the all-ranks mesh
    mesh = default_mesh(device)
    dispatcher = SpmdDispatcher(device if device.type == "cuda" else None)

    def handle_build_model(payload: dict) -> None:
        # models_dir comes from the BROADCAST payload on every rank, never
        # from this host's environment
        build_model(
            store,
            payload["training_filename"],
            payload["test_filename"],
            payload["preprocessor_code"],
            payload["classificators_list"],
            mesh=mesh,
            write_outputs=coordinator,
            models_dir=payload.get("models_dir"),
        )

    def handle_predict_model(payload: dict) -> None:
        predict_with_model(
            store,
            payload["checkpoint_path"],
            payload["training_filename"],
            payload["test_filename"],
            payload["preprocessor_code"],
            payload["prediction_filename"],
            mesh=mesh,
            write_outputs=coordinator,
        )

    def handle_embedding_image(payload: dict) -> None:
        create_embedding_image(
            store,
            payload["parent_filename"],
            payload["label_name"],
            payload["output_filename"],
            os.path.join(images_dir, payload["method"]),
            payload["method"],
            render=coordinator,
            mesh=mesh,
        )

    def logged(op: str, handler):
        if coordinator:
            return handler

        def run(payload: dict) -> None:
            kernels.reset_launches()
            multihost.reset_collective_stats()
            started = time.perf_counter()
            handler(payload)
            if device.type == "cuda":
                import torch

                torch.cuda.synchronize(device)
            counts = {
                "wall_s": time.perf_counter() - started,
                "launches": {name: n for name, n in kernels.launches().items() if n},
                "collectives": multihost.collective_stats()["collectives"],
                "compile_events": compile_events(),
            }
            print(f"spmd worker {rank}: job {op!r} done {json.dumps(counts)}", flush=True)

        return run

    dispatcher.register("build_model", logged("build_model", handle_build_model))
    dispatcher.register("predict_model", logged("predict_model", handle_predict_model))
    dispatcher.register("embedding_image", logged("embedding_image", handle_embedding_image))
    return dispatcher


def make_job_manager(store: DocumentStore, scope: str = "all") -> JobManager:
    """One JobManager for the whole process: every service submits
    through a single scheduler, so the DEVICE class serializes builds,
    sweeps and embeddings against each other on the card, and every
    submit is journaled in the store for crash recovery, under ``scope``
    (the service's name in the one-process-per-service topology)."""
    return JobManager(
        scheduler=Scheduler(journal=JobJournal(store, scope=shard_scope(scope, store)))
    )


def build_app(
    name: str,
    store: DocumentStore,
    images_dir: str,
    models_dir: str = "",
    jobs: Optional[JobManager] = None,
    device: DeviceLike = None,
    dispatcher=None,
):
    """One service's app. With a ``dispatcher`` (the multi-host mode),
    model_builder's build and batch predictions and the images' creates
    are submitted through it (the reference's wiring)."""
    if name == "database_api":
        return database_api.create_app(store, jobs or JobManager())
    if name == "projection":
        return projection.create_app(store, jobs)
    if name == "model_builder":
        # opt-in (LO_MODELS_DIR / models_dir): library and test callers of
        # start_all don't silently grow a checkpoint directory
        models_dir = models_dir or os.environ.get("LO_MODELS_DIR", "")
        build = predict = None
        if dispatcher is not None:
            from learningorchestra_tpu_torch.ml.checkpoint import checkpoint_path

            def build(body: dict) -> None:
                payload = {
                    key: body[key]
                    for key in (
                        "training_filename",
                        "test_filename",
                        "preprocessor_code",
                        "classificators_list",
                    )
                }
                payload["models_dir"] = models_dir
                dispatcher.submit("build_model", payload)

            def predict(model_name: str, body: dict) -> None:
                dispatcher.submit(
                    "predict_model",
                    {
                        "checkpoint_path": checkpoint_path(models_dir, model_name),
                        "training_filename": body["training_filename"],
                        "test_filename": body["test_filename"],
                        "preprocessor_code": body["preprocessor_code"],
                        "prediction_filename": body["prediction_filename"],
                    },
                )

        return model_builder.create_app(
            store, build=build, models_dir=models_dir, jobs=jobs, device=device, predict=predict
        )
    if name == "data_type_handler":
        return data_type_handler.create_app(store, jobs)
    if name == "histogram":
        return histogram.create_app(store, jobs)
    if name in ("tsne", "pca"):
        create = None
        if dispatcher is not None:

            def create(parent_filename, label_name, output_filename):
                dispatcher.submit(
                    "embedding_image",
                    {
                        "parent_filename": parent_filename,
                        "label_name": label_name,
                        "output_filename": output_filename,
                        "method": name,
                    },
                )

        return images.create_app(
            store, os.path.join(images_dir, name), name, create=create, device=device, jobs=jobs
        )
    if name == "router":
        # the fleet router, its own LO_SERVICE only: a router in front
        # of zero replicas routes nothing
        from learningorchestra_tpu_torch.serve import router as _router

        return _router.create_app(store)
    raise KeyError(f"unknown service {name!r}")


def build_apps(
    store: DocumentStore,
    images_dir: str,
    models_dir: str = "",
    jobs: Optional[JobManager] = None,
    device: DeviceLike = None,
    dispatcher=None,
) -> dict[int, object]:
    # one shared JobManager unless the caller brings its own: the seven
    # services must share a scheduler, or the device class cannot
    # serialize builds against embeddings
    jobs = jobs or make_job_manager(store)
    device = resolve_device(device)
    return {
        port: build_app(name, store, images_dir, models_dir, jobs, device, dispatcher)
        for name, port in SERVICES.items()
    }


# One collector a (process, store): main() starts it before start_all, and
# start_all starts it for embedded callers; whoever comes first wins.
_COLLECTORS: dict[int, object] = {}
_COLLECTORS_LOCK = threading.Lock()


def maybe_start_collector(store: DocumentStore, instance: str = "runner", service: str = "runner"):
    """Start the TSDB collector for ``store`` (telemetry/tsdb.py: this
    process's registry into the ``__lo_metrics__`` ring each
    ``LO_METRICS_INTERVAL_S``) unless one runs already, collection is off
    (``LO_TSDB_COLLECT=0``) or the interval is zero. Returns it, or None."""
    from learningorchestra_tpu_torch.telemetry import metrics as _metrics
    from learningorchestra_tpu_torch.telemetry import tsdb as _tsdb

    if not (_tsdb.collect_enabled() and _tsdb.metrics_interval_s() > 0):
        return None
    with _COLLECTORS_LOCK:
        collector = _COLLECTORS.get(id(store))
        if collector is None:
            collector = _tsdb.Collector(
                store, _metrics.global_registry(), instance=instance, service=service
            ).start()
            _COLLECTORS[id(store)] = collector
    return collector


def start_all(
    store: Optional[DocumentStore] = None,
    images_dir: Optional[str] = None,
    host: str = "127.0.0.1",
    ephemeral: bool = False,
    models_dir: str = "",
    jobs: Optional[JobManager] = None,
    device: DeviceLike = None,
    dispatcher=None,
) -> tuple[DocumentStore, list[ServerThread]]:
    """Start all seven services on their reference ports; returns the
    shared store and the server threads (callers stop() them).
    ``device=None`` is the CUDA card (raises without one); ``dispatcher``
    (the multi-host mode's) carries the compute jobs to every rank.

    ``ephemeral=True`` binds OS-assigned ports instead (tests can't
    assume 5000-5006 are free); each server's ``canonical_port`` records
    which reference port it stands in for, its ``port`` the actual bind.
    """
    store = store if store is not None else InMemoryStore()
    images_dir = images_dir or os.path.join(os.getcwd(), "lo_images")
    maybe_start_collector(store)
    servers = []
    apps = build_apps(store, images_dir, models_dir, jobs, device, dispatcher)
    for port, app in apps.items():
        server = ServerThread(app, host, 0 if ephemeral else port)
        server.canonical_port = port
        servers.append(server.start())
    return store, servers


def main(device: DeviceLike = None, backend: Optional[str] = None) -> None:
    """Boot the stack, or the one service ``LO_SERVICE`` names: join the
    ranks' process group when ``LO_COORDINATOR``, ``LO_NUM_PROCESSES``
    and ``LO_PROCESS_ID`` ask for one (a rank past 0 then runs the SPMD
    worker loop and serves nothing), open the store, replay the job
    journal (this service's, or every service's: never-started jobs
    re-enqueue, orphaned builds resume from their progress artifacts),
    start the TSDB collector, then serve. ``device=None`` is the CUDA
    card; ``backend`` the group's (None: NCCL on a card, gloo on the
    CPU; ``"gloo"`` for ranks that share one card)."""
    from learningorchestra_tpu_torch.sched import config as sched_config
    from learningorchestra_tpu_torch.sched import recovery
    from learningorchestra_tpu_torch.serve import config as serve_config

    service = os.environ.get("LO_SERVICE", "").strip() or None
    if service is not None and service not in SERVICES and service != "router":
        raise SystemExit(
            f"LO_SERVICE must be one of {sorted([*SERVICES, 'router'])}, got {service!r}"
        )
    port_env = os.environ.get("LO_PORT", "").strip()
    try:
        port = int(port_env) if port_env else None
    except ValueError:
        raise SystemExit(f"LO_PORT must be an integer, got {port_env!r}") from None
    device = resolve_device(device)
    print(
        f"runner starting: LO_SERVICE={service!r} device={device} "
        f"LO_COORDINATOR={os.environ.get('LO_COORDINATOR')!r} "
        f"LO_PROCESS_ID={os.environ.get('LO_PROCESS_ID')!r}",
        flush=True,
    )
    # join the ranks' group first when the deployment asks for one: the
    # compute jobs then run over every rank (the reference's "add spark
    # workers" knob as an environment setting)
    from learningorchestra_tpu_torch.parallel.multihost import initialize_from_env

    multi_host = initialize_from_env(backend=backend, device=device)
    # fail fast on malformed knobs, and state them at boot
    from learningorchestra_tpu_torch.core.devcache import capacity_bytes
    from learningorchestra_tpu_torch.utils.dtypepolicy import dtype_policy

    print(f"devcache capacity: {capacity_bytes()} bytes", flush=True)
    print(f"serving config: {serve_config.validate_all()}", flush=True)
    # whether this process is a fleet replica (and which index) or a
    # plain serving plane; a typo'd LO_FLEET_RF refuses bring-up
    from learningorchestra_tpu_torch.serve import fleet as serve_fleet

    print(f"fleet config: {serve_fleet.validate_env()}", flush=True)
    print(
        "coalescing config: "
        f"window_s={sched_config.coalesce_window_s()} "
        f"max_jobs={sched_config.coalesce_max_jobs()}",
        flush=True,
    )
    print(
        "resume config: "
        f"enabled={sched_config.resume_enabled()} "
        f"every_segments={sched_config.resume_every_segments()}",
        flush=True,
    )
    from learningorchestra_tpu_torch.core import shmring
    from learningorchestra_tpu_torch.core.store_service import _flag_env, connect

    print(
        f"wire config: shm_bytes={shmring.shm_bytes()} "
        f"dtype_policy={dtype_policy()} "
        f"v2={_flag_env('LO_WIRE_V2', default=True)}",
        flush=True,
    )
    # the sharding knobs: how many shard groups this process routes
    # across (the ';' groups of LO_STORE_URL; 1 is the unsharded wire
    # path) and which stripe geometry a first write would seed; a typo'd
    # LO_SHARD_STRIPE_ROWS refuses bring-up, never seeding an unintended
    # placement into the fleet's shard map
    from learningorchestra_tpu_torch.core import shardmap

    shard_groups = len([g for g in os.environ.get("LO_STORE_URL", "").split(";") if g.strip()]) or 1
    print(
        f"shard config: groups={shard_groups} "
        f"stripe_rows={shardmap.stripe_rows()} "
        f"map_ttl_s={shardmap.map_ttl_s()}",
        flush=True,
    )
    # which serving core is live (LO_WEB_ASYNC=0: the threaded server);
    # a typo'd LO_WEB_HANDLERS refuses bring-up
    from learningorchestra_tpu_torch.utils import webloop

    print(f"web config: {webloop.validate_env()}", flush=True)
    # the compile plane's knobs: whether the boot pass runs, how much of
    # the manifest it covers and whether it publishes to the fleet; a
    # typo'd LO_AOT refuses bring-up, never silently boots cold
    from learningorchestra_tpu_torch.compile import boot_compile_plane
    from learningorchestra_tpu_torch.compile import config as compile_config

    print(f"compile config: {compile_config.validate_env()}", flush=True)
    from learningorchestra_tpu_torch.telemetry import profile as _profile
    from learningorchestra_tpu_torch.telemetry import slo as _slo
    from learningorchestra_tpu_torch.telemetry import tracing as _tracing
    from learningorchestra_tpu_torch.telemetry import tsdb as _tsdb

    _profile.validate_env()
    print(
        "observability config: "
        f"collect={_tsdb.collect_enabled()} "
        f"interval_s={_tsdb.metrics_interval_s()} "
        f"points={_tsdb.tsdb_points()} "
        f"trace_ring={_tracing.trace_ring()} "
        f"slo={_slo.validate_env()}",
        flush=True,
    )
    data_dir = os.environ.get("LO_DATA_DIR", os.path.join(os.getcwd(), "lo_data"))
    images_dir = os.environ.get("LO_IMAGES_DIR", os.path.join(data_dir, "images"))
    models_dir = os.environ.get("LO_MODELS_DIR", os.path.join(data_dir, "models"))
    host = os.environ.get("LO_HOST", "127.0.0.1")
    ephemeral = os.environ.get("LO_EPHEMERAL", "").strip() == "1"
    # a store server's URL (LO_STORE_URL: a comma-separated replica list
    # fails over between its servers), else the WAL-backed local store
    store_url = os.environ.get("LO_STORE_URL", "").strip()
    if multi_host and not store_url:
        # every rank must read the same datasets: a store a process
        # would leave the workers reading an empty one
        raise SystemExit(
            "multi-host mode requires LO_STORE_URL: all processes "
            "must share one store server "
            "(python -m learningorchestra_tpu_torch.core.store_service)"
        )
    if multi_host and os.environ.get("LO_MODELS_DIR") is None:
        # a batch prediction broadcasts the checkpoint's path to every
        # rank: the folder must be one that every rank reads
        raise SystemExit(
            "multi-host mode requires LO_MODELS_DIR pointing at a "
            "volume shared by all hosts (set it to '' to disable "
            "checkpointing)"
        )
    store = connect(store_url) if store_url else InMemoryStore(data_dir=data_dir)
    dispatcher = None
    after_run = None   # rank 0's mark of its pass's end (the multi-host mode)
    if multi_host:
        import torch.distributed as dist

        from learningorchestra_tpu_torch.parallel.multihost import stage_if_refused

        rank, world = dist.get_rank(), dist.get_world_size()
        print(
            f"multi-host runtime: process {rank}/{world}, {world} global devices "
            f"(backend {dist.get_backend()}, device {device})",
            flush=True,
        )
        # a gloo that refuses CUDA tensors: every collective through the host
        refused = stage_if_refused(device)
        if refused is not None:
            print(f"multi-host runtime: collectives staged through the host ({refused})", flush=True)
        dispatcher = make_dispatcher(store, images_dir, device)
        # keeps an idle worker's broadcast inside the group's timeout
        dispatcher.start_heartbeat()
        before_fetch, after_run = _compile_rendezvous(rank)
        if rank > 0:
            # the kernel libraries rank 0 holds, over the store, once its
            # pass has ended: this rank's jobs then run no nvcc
            if boot_compile_plane(store=store, models_dir=models_dir or "", before_fetch=before_fetch):
                print("aot compile plane: fetching once rank 0's pass has ended", flush=True)
            # no REST surface here: run the jobs the coordinator broadcasts
            print("spmd worker: waiting for jobs", flush=True)
            dispatcher.run_worker_loop()
            print(f"spmd worker {rank}: loop exited", flush=True)
            return
    maybe_start_collector(store, instance=service or "runner", service=service or "runner")

    # the compile plane: the fleet's kernel libraries fetched into the
    # build folder now, the rest built (and published) on a daemon thread,
    # never in a device-class slot; a restarted runner pulls what it
    # published before and runs no nvcc
    if boot_compile_plane(store=store, models_dir=models_dir or "", after_run=after_run):
        print("aot compile plane: precompiling in background", flush=True)

    # Recovery runs BEFORE the REST surface accepts traffic, with the
    # build handlers bound to this process's device (the journal names
    # none): never-started jobs re-enqueue, orphaned RUNNING builds
    # resume, everything else goes FAILED with finished:true so pollers
    # terminate. One process a service journals and recovers its own.
    recovery.register_build_model(device)
    jobs = make_job_manager(store, scope=service or "all")
    recovered = recover_jobs(store, jobs)
    if recovered["requeued"] or recovered["orphaned"]:
        print(
            "job recovery: "
            f"{len(recovered['requeued'])} re-enqueued, "
            f"{len(recovered['orphaned'])} orphaned jobs marked failed",
            flush=True,
        )
    if service is not None:
        app = build_app(service, store, images_dir, models_dir, jobs, device, dispatcher)
        default_port = ROUTER_PORT if service == "router" else SERVICES[service]
        server = ServerThread(app, host, default_port if port is None else port).start()
        print(f"service {service} on {host}:{server.port}", flush=True)
        servers = [server]
        if service == "model_builder" and serve_fleet.replica_index() is not None:
            # a fleet replica: the agent pins this replica's assigned
            # checkpoints on the process-wide plane the app serves from,
            # and heartbeats residency into the store the router reads
            from learningorchestra_tpu_torch.serve import global_serve_plane

            agent = serve_fleet.ReplicaAgent(
                store,
                models_dir or "",
                global_serve_plane(device),
                url=f"http://{host}:{server.port}",
            ).start()
            print(f"fleet replica {agent.index}: agent started (interval {agent.interval_s}s)", flush=True)
    else:
        _, servers = start_all(
            store, images_dir, host, ephemeral=ephemeral, models_dir=models_dir, jobs=jobs, device=device,
            dispatcher=dispatcher,
        )
        port_names = {port: name for name, port in SERVICES.items()}
        for server in servers:
            print(f"service {port_names[server.canonical_port]} on {host}:{server.port}", flush=True)
        print(
            f"learningorchestra_tpu_torch serving all services (host {host}); "
            f"data in {store_url or data_dir}",
            flush=True,
        )
    try:
        for server in servers:
            server._thread.join()
    except KeyboardInterrupt:
        for server in servers:
            server.stop()


if __name__ == "__main__":
    try:
        device_choice, backend_choice = device_from_env(), backend_from_env()
    except ValueError as error:
        raise SystemExit(f"runner: {error}") from None
    main(device=device_choice, backend=backend_choice)
