"""Supervise the microservice topology: store server + seven services.

Counterpart of the repository's ``deploy/stack.py``, whole: every
topology and knob below is the reference's, and every child is a
process of the port (``python -m learningorchestra_tpu_torch.core.
store_service``, ``...core.arbiter``, ``...services.runner``), on the
CUDA card unless ``LO_DEVICE=cpu`` asks for the CPU. Ports that must be
known before their child binds and that the environment leaves to the
system (``LO_COORD_PORT=0``) are picked here, and picked again when a
member found one taken.

The reference deploys this shape as a Docker-swarm stack: service
containers with ``restart_policy: condition: on-failure, delay: 5s``
(reference docker-compose.yml:14-15) that gate their start on their
dependencies being reachable (``dockerize -wait``, docker-compose.yml:145).
This supervisor is that stack without the swarm:

- starts the store server, then blocks until its ``GET /health``
  answers (the dockerize gate);
- starts one ``LO_SERVICE=<name>`` runner process per service, all
  pointed at the store via ``LO_STORE_URL``;
- restarts any child that exits non-zero after a delay (the
  restart_policy), indefinitely by default;
- writes ``<data_dir>/stack_ports.json`` (``{"ports": {service: port},
  "pids": {service: pid}}``, refreshed on restart) so clients, tests
  and operators can discover the stack regardless of ephemeral-port
  mode;
- forwards SIGTERM/SIGINT to the children and exits cleanly.

Usage::

    python -m learningorchestra_tpu_torch.deploy.stack [data_dir]

Environment (all optional):

- ``LO_DATA_DIR``       store WAL dir (default ./lo_data or argv[1])
- ``LO_HOST``           bind host (default 127.0.0.1 — model_builder
                        executes request-supplied code; see deploy/README.md)
- ``LO_DEVICE`` / ``LO_DIST_BACKEND``  the children's device and group
                        backend (services/runner.py); unset: the card,
                        NCCL
- ``LO_STORE_PORT``     store port (default 27027; 0 = OS-assigned)
- ``LO_EPHEMERAL``      "1" = every service binds an OS-assigned port
                        (tests); default: reference ports 5000-5006
- ``LO_RESTART_DELAY``  seconds between failure and restart (default 5)
- ``LO_MAX_RESTARTS``   per-child cap (default: unlimited)
- ``LO_WORKERS``        N > 0 switches to the MULTI-HOST topology:
                        store + an all-services coordinator + N SPMD
                        worker processes in one torch.distributed
                        group (``LO_DIST_BACKEND``: gloo for ranks that
                        share a card); any runtime member dying
                        restarts the whole group (see
                        _supervise_multihost)
- ``LO_COORD_PORT``     the group's rendezvous port (default 12355; 0 =
                        a free one picked here, again at every launch)
- ``LO_REPLICATION``    "1" = replicated store plane (docs/replication.md):
                        primary store + WAL-shipping follower + quorum
                        arbiter (the reference's Mongo replica set +
                        ``mongodbarbiter``, docker-compose.yml:27-91);
                        services get both store URLs and fail over
                        client-side. Requires fixed store ports.
- ``LO_FOLLOWER_PORT``  follower store port (default 27028)
- ``LO_ARBITER_PORT``   arbiter port (default 27029)
- ``LO_AUTO_PROMOTE_S`` follower takeover timer, quorum-gated (default 5)
- ``LO_FLEET_REPLICAS`` N >= 1 additionally launches the serving fleet
                        (docs/serving.md "Fleet"): N replica
                        model_builder processes (``LO_FLEET_REPLICA=i``,
                        ports 5010+i — NOT 5002+i, which would collide
                        with the reference ports) behind one
                        ``LO_SERVICE=router`` process on 5007; unset =
                        no fleet children. Single-host topology only.
- ``LO_STACK_EXIT_ON_STDIN_EOF``  "1" = shut the stack down when stdin
                        hits EOF. Set by the cluster driver's ssh
                        transport: killing the ssh CLIENT never signals
                        the remote side (BatchMode allocates no pty, so
                        no SIGHUP) — watching the ssh channel's stdin is
                        what keeps a dead driver from stranding the old
                        stack and its runtime group on every machine.

Cross-MACHINE topologies run one stack per machine (driven by
``python -m learningorchestra_tpu_torch.deploy.cluster up <manifest>``,
the reference's ``run.sh`` + ``docker stack deploy`` analogue,
run.sh:8-32):

- ``LO_TOTAL_PROCESSES``  total runtime processes across ALL machines
                          (default: local workers + 1). When it exceeds
                          the local member count, a runtime member dying
                          EXITS the stack (rc=1) instead of restarting
                          locally — members on other machines are
                          poisoned too, so only the cluster driver can
                          restart the runtime coherently.
- ``LO_PROCESS_BASE``     first process id on this machine. > 0
                          means a WORKER-ONLY machine: no store, no
                          coordinator; requires ``LO_COORDINATOR`` and
                          ``LO_STORE_URL`` pointing at the head machine.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

# the folder that holds the package: the children's PYTHONPATH and cwd
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STORE_COMMAND = [sys.executable, "-m", "learningorchestra_tpu_torch.core.store_service"]
ARBITER_COMMAND = [sys.executable, "-m", "learningorchestra_tpu_torch.core.arbiter"]
RUNNER_COMMAND = [sys.executable, "-m", "learningorchestra_tpu_torch.services.runner"]

SERVICE_NAMES = (
    "database_api",
    "projection",
    "model_builder",
    "data_type_handler",
    "histogram",
    "tsne",
    "pca",
)

# The replicated serving fleet (docs/serving.md "Fleet"), opt-in via
# LO_FLEET_REPLICAS: N extra model_builder processes carrying
# LO_FLEET_REPLICA=<i> (each runs a ReplicaAgent pinning its
# placement-assigned models) behind one LO_SERVICE=router process. The
# replicas bind FLEET_PORT_BASE+i — a separate base, NOT 5002+i, which
# would collide with the reference ports 5003-5006.
ROUTER_PORT = 5007
FLEET_PORT_BASE = 5010

# "service <name> on <host>:<port>" (services/runner.py),
# "store server on <host>:<port>" (core/store_service.py) and
# "store arbiter on <host>:<port>" (core/arbiter.py)
_PORT_LINE = re.compile(r"on [\w.\-]+:(\d+)")
_SERVICE_PORT_LINE = re.compile(r"service (\w+) on [\w.\-]+:(\d+)")
_WORKER_READY_LINE = "spmd worker: waiting for jobs"
_PORT_TAKEN = "address already in use"


def free_port(host: str = "127.0.0.1") -> int:
    """A port free now on ``host``: for a port every member must know
    before its owner binds it (the group's rendezvous). Another process
    may take it first; the group's launch then picks another."""
    import socket

    with socket.socket() as probe:
        probe.bind((host, 0))
        return probe.getsockname()[1]


class Child:
    """One supervised process with an on-failure restart policy."""

    def __init__(self, name: str, argv: list[str], env: dict, log):
        self.name = name
        self.argv = argv
        self.env = env
        self.log = log
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None
        # all-in-one runners announce one port per service
        self.service_ports: dict[str, int] = {}
        self.restarts = 0
        self._port_event = threading.Event()
        self._ready_event = threading.Event()  # spmd worker readiness
        self.port_taken = False  # it logged that its port was taken

    def start(self) -> None:
        self.proc = subprocess.Popen(
            self.argv,
            env=self.env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=REPO_ROOT,
        )
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        proc = self.proc
        for line in proc.stdout:
            match = _SERVICE_PORT_LINE.search(line)
            if match:
                # per-service announcement: recorded by NAME only —
                # self.port stays unset so an all-in-one runner never
                # publishes an arbitrary service port under its own name
                self.service_ports[match.group(1)] = int(match.group(2))
                self._port_event.set()
            else:
                match = _PORT_LINE.search(line)
                if match:
                    self.port = int(match.group(1))
                    self._port_event.set()
            if _WORKER_READY_LINE in line:
                self._ready_event.set()
            if _PORT_TAKEN in line.lower():
                self.port_taken = True
            self.log(f"[{self.name}] {line.rstrip()}")

    def _wait(self, event: threading.Event, timeout: float, what: str) -> None:
        """Until ``event``; raises TimeoutError past ``timeout``, or at
        once when the child exited first (its port taken, a crash)."""
        deadline = time.time() + timeout
        while not event.wait(0.1):
            if self.poll() is not None and not event.is_set():
                taken = " (its port was taken)" if self.port_taken else ""
                raise TimeoutError(f"{self.name}: exited (rc={self.poll()}) before {what}{taken}")
            if time.time() > deadline:
                raise TimeoutError(f"{self.name}: {what} not within {timeout}s")

    def wait_ready(self, timeout: float) -> None:
        self._wait(self._ready_event, timeout, "ready")

    def wait_port(self, timeout: float) -> int:
        self._wait(self._port_event, timeout, "a port line")
        return self.port

    def terminate(self) -> None:
        if self.proc and self.proc.poll() is None:
            self.proc.terminate()

    def poll(self):
        return self.proc.poll() if self.proc else None


def start_stdin_watchdog(stopping, log, stream=None):
    """Launcher-death watchdog (LO_STACK_EXIT_ON_STDIN_EOF=1): EOF on
    stdin means the ssh channel — and with it the cluster driver — is
    gone; set ``stopping`` so the stack shuts down instead of lingering
    to collide with the driver's relaunch (stale store/coordinator
    ports, briefly two writable stores). ``ssh -o BatchMode=yes``
    allocates no pty, so a dying driver never HUPs the remote process
    group — watching the channel's stdin is the reliable signal.
    Returns the watcher thread, or None when the knob is off."""
    if os.environ.get("LO_STACK_EXIT_ON_STDIN_EOF") != "1":
        return None
    if stream is None:
        stream = sys.stdin.buffer

    def _stdin_watch() -> None:
        try:
            while stream.read(65536):
                pass
        except Exception:
            pass
        if not stopping.is_set():
            log("[stack] stdin closed (launcher gone); shutting down")
            stopping.set()

    thread = threading.Thread(
        target=_stdin_watch, name="stdin-eof-watchdog", daemon=True
    )
    thread.start()
    return thread


def wait_health(url: str, timeout: float) -> None:
    """The dockerize -wait analogue: block until the store answers."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url + "/health", timeout=2) as resp:
                if resp.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.2)
    raise TimeoutError(f"store not healthy at {url} within {timeout}s")


def _start_store_plane(children, store, host, log) -> str:
    """Start the store child — plus the follower and arbiter when the
    replicated plane is configured (LO_REPLICATION=1), plus every
    additional shard group when LO_SHARDS>1 — and return the
    ``LO_STORE_URL`` services should use: per group a comma list naming
    the primary AND the follower (client-side failover,
    core/store_service.py), groups joined by ``;`` (the sharded
    scatter-gather client, core/shardstore.py). Group 0 (the plain
    ``store`` child) is the meta group."""
    store.start()
    store_live_port = store.wait_port(60)
    store_url = f"http://{host}:{store_live_port}"
    wait_health(store_url, 60)
    log(f"[stack] store healthy at {store_url}")
    urls = [store_url]
    for name in ("store-follower", "store-arbiter"):
        child = children.get(name)
        if child is None:
            continue
        child.start()
        child_port = child.wait_port(60)
        if name == "store-follower":
            urls.append(f"http://{host}:{child_port}")
    if len(urls) > 1:
        log(f"[stack] replicated store plane up: {','.join(urls)} + arbiter")
    group_urls = [",".join(urls)]
    index = 1
    while f"store-s{index}" in children:
        primary = children[f"store-s{index}"]
        primary.start()
        primary_port = primary.wait_port(60)
        primary_url = f"http://{host}:{primary_port}"
        wait_health(primary_url, 60)
        shard_urls = [primary_url]
        for suffix in ("follower", "arbiter"):
            child = children.get(f"store-s{index}-{suffix}")
            if child is None:
                continue
            child.start()
            child_port = child.wait_port(60)
            if suffix == "follower":
                shard_urls.append(f"http://{host}:{child_port}")
        group_urls.append(",".join(shard_urls))
        index += 1
    if len(group_urls) > 1:
        log(
            f"[stack] sharded store plane up: {len(group_urls)} groups "
            f"({';'.join(group_urls)})"
        )
    return ";".join(group_urls)


def main() -> int:
    # chaos-knob preflight (deploy/run.py's does the same): a typo'd
    # LO_FAULT_* must refuse bring-up here too — the cluster driver
    # launches the stack directly, never through deploy/run.py
    from learningorchestra_tpu_torch.testing import faults

    try:
        faults.validate_env()
    except ValueError as error:
        print(f"[stack] LO_FAULT_* validation failed: {error}")
        return 2
    data_dir = os.path.abspath(
        sys.argv[1]
        if len(sys.argv) > 1
        # lo: allow[LO301] free-form path knob, no domain to preflight
        else os.environ.get("LO_DATA_DIR", os.path.join(os.getcwd(), "lo_data"))
    )
    # lo: allow[LO301] free-form bind address, no domain to preflight
    host = os.environ.get("LO_HOST", "127.0.0.1")
    store_port = os.environ.get("LO_STORE_PORT", "27027")
    ephemeral = os.environ.get("LO_EPHEMERAL") == "1"
    restart_delay = float(os.environ.get("LO_RESTART_DELAY", "5"))
    max_restarts = os.environ.get("LO_MAX_RESTARTS")
    max_restarts = int(max_restarts) if max_restarts else None
    os.makedirs(data_dir, exist_ok=True)
    ports_path = os.path.join(data_dir, "stack_ports.json")

    log_lock = threading.Lock()

    def log(line: str) -> None:
        with log_lock:
            print(line, flush=True)

    base_env = dict(os.environ)
    base_env["PYTHONPATH"] = REPO_ROOT + os.pathsep + base_env.get("PYTHONPATH", "")
    base_env["PYTHONUNBUFFERED"] = "1"
    base_env["LO_DATA_DIR"] = data_dir
    base_env["LO_HOST"] = host

    replication = os.environ.get("LO_REPLICATION") == "1"
    process_base_early = int(os.environ.get("LO_PROCESS_BASE", "0") or 0)
    store_env = dict(base_env)
    store_env["LO_STORE_PORT"] = store_port
    store = Child(
        "store",
        STORE_COMMAND,
        store_env,
        log,
    )

    children: dict[str, Child] = {"store": store}

    if replication and process_base_early == 0:
        # Replicated store plane: primary + WAL-shipping follower +
        # quorum arbiter, wired by fixed ports (peer/arbiter URLs must
        # be known before any of the three starts).
        if store_port == "0":
            log("[stack] LO_REPLICATION=1 needs a fixed LO_STORE_PORT")
            return 2
        follower_port = os.environ.get("LO_FOLLOWER_PORT", "27028")
        arbiter_port = os.environ.get("LO_ARBITER_PORT", "27029")
        auto_promote_s = os.environ.get("LO_AUTO_PROMOTE_S", "5")
        primary_url = f"http://{host}:{store_port}"
        follower_url = f"http://{host}:{follower_port}"
        arbiter_url = f"http://{host}:{arbiter_port}"
        store_env.update(
            {
                "LO_REPLICATE": "1",
                "LO_PEERS": follower_url,
                "LO_ARBITERS": arbiter_url,
                "LO_NODE_ID": "store-primary",
            }
        )
        follower_env = dict(base_env)
        follower_env.update(
            {
                "LO_STORE_PORT": follower_port,
                # its own WAL dir — two stores must never share a log
                "LO_DATA_DIR": os.path.join(data_dir, "follower"),
                "LO_PRIMARY_URL": primary_url,
                "LO_PEERS": primary_url,
                "LO_ARBITERS": arbiter_url,
                "LO_AUTO_PROMOTE_S": auto_promote_s,
                "LO_NODE_ID": "store-follower",
            }
        )
        arbiter_env = dict(base_env)
        arbiter_env["LO_ARBITER_PORT"] = arbiter_port
        children["store-follower"] = Child(
            "store-follower",
            STORE_COMMAND,
            follower_env,
            log,
        )
        children["store-arbiter"] = Child(
            "store-arbiter",
            ARBITER_COMMAND,
            arbiter_env,
            log,
        )

    # Horizontal sharding (docs/dataplane.md): LO_SHARDS=N launches N-1
    # EXTRA store groups beyond the meta group above, each on a port
    # stride of 10 from LO_STORE_PORT (primary base+10i, its follower
    # +1, its arbiter +2 when LO_REPLICATION=1) with its own data dir —
    # N WALs is the whole point. run.sh preflights the knob; this parse
    # re-checks because cluster.py launches stack.py directly.
    shards_raw = os.environ.get("LO_SHARDS", "").strip() or "1"
    try:
        shards = int(shards_raw)
        if shards < 1:
            raise ValueError(shards_raw)
    except ValueError:
        log(f"[stack] LO_SHARDS must be an integer >= 1, got {shards_raw!r}")
        return 2
    # Replicated serving fleet (docs/serving.md "Fleet"): opt-in via
    # LO_FLEET_REPLICAS=N — N replica model_builder processes (each a
    # ReplicaAgent pinning its placement-assigned models) behind one
    # router. run.sh preflights the knob; this parse re-checks because
    # cluster.py launches stack.py directly.
    fleet_raw = os.environ.get("LO_FLEET_REPLICAS", "").strip()
    fleet_replicas = 0
    if fleet_raw:
        try:
            fleet_replicas = int(fleet_raw)
            if fleet_replicas < 1:
                raise ValueError(fleet_raw)
        except ValueError:
            log(
                "[stack] LO_FLEET_REPLICAS must be an integer >= 1, "
                f"got {fleet_raw!r}"
            )
            return 2
    if shards > 1 and process_base_early == 0:
        if store_port == "0":
            log("[stack] LO_SHARDS>1 needs a fixed LO_STORE_PORT")
            return 2
        shard_base_port = int(store_port)
        for index in range(1, shards):
            group_port = shard_base_port + 10 * index
            group_name = f"store-s{index}"
            group_dir = os.path.join(data_dir, f"shard{index}")
            group_env = dict(base_env)
            group_env["LO_STORE_PORT"] = str(group_port)
            group_env["LO_DATA_DIR"] = group_dir
            if replication:
                group_primary = f"http://{host}:{group_port}"
                group_follower = f"http://{host}:{group_port + 1}"
                group_arbiter = f"http://{host}:{group_port + 2}"
                group_env.update(
                    {
                        "LO_REPLICATE": "1",
                        "LO_PEERS": group_follower,
                        "LO_ARBITERS": group_arbiter,
                        "LO_NODE_ID": f"{group_name}-primary",
                    }
                )
                follower_env = dict(base_env)
                follower_env.update(
                    {
                        "LO_STORE_PORT": str(group_port + 1),
                        # its own WAL dir — two stores never share a log
                        "LO_DATA_DIR": os.path.join(group_dir, "follower"),
                        "LO_PRIMARY_URL": group_primary,
                        "LO_PEERS": group_primary,
                        "LO_ARBITERS": group_arbiter,
                        "LO_AUTO_PROMOTE_S": os.environ.get(
                            "LO_AUTO_PROMOTE_S", "5"
                        ),
                        "LO_NODE_ID": f"{group_name}-follower",
                    }
                )
                arbiter_env = dict(base_env)
                arbiter_env["LO_ARBITER_PORT"] = str(group_port + 2)
                children[f"{group_name}-follower"] = Child(
                    f"{group_name}-follower",
                    STORE_COMMAND,
                    follower_env,
                    log,
                )
                children[f"{group_name}-arbiter"] = Child(
                    f"{group_name}-arbiter",
                    ARBITER_COMMAND,
                    arbiter_env,
                    log,
                )
            children[group_name] = Child(
                group_name,
                STORE_COMMAND,
                group_env,
                log,
            )

    def write_ports() -> None:
        ports = {
            name: child.port
            for name, child in children.items()
            if child.port is not None
        }
        for name, child in children.items():  # all-in-one: per-service
            if name.startswith("replica") and child.service_ports:
                # fleet replicas all announce "service model_builder";
                # publish under replica<i> so they don't clobber the
                # reference model_builder's port (or each other's)
                ports[name] = next(iter(child.service_ports.values()))
            else:
                ports.update(child.service_ports)
        state = {
            "ports": ports,
            "pids": {
                name: child.proc.pid
                for name, child in children.items()
                if child.proc is not None and child.poll() is None
            },
        }
        tmp = ports_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, ports_path)

    # Handlers installed before the first child starts: a SIGTERM during
    # the multi-minute bring-up must still tear everything down (the
    # try/finally below owns cleanup for bring-up failures too).
    stopping = threading.Event()

    def shutdown(signum, frame):
        stopping.set()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)

    start_stdin_watchdog(stopping, log)

    workers = int(os.environ.get("LO_WORKERS", "0") or 0)
    process_base = int(os.environ.get("LO_PROCESS_BASE", "0") or 0)
    total_processes = int(os.environ.get("LO_TOTAL_PROCESSES", "0") or 0)
    try:
        if process_base > 0:
            exit_code = _supervise_workers_only(
                children,
                base_env,
                restart_delay,
                write_ports,
                stopping,
                log,
                workers,
                process_base,
                data_dir,
            )
        elif workers > 0 or total_processes > 1:
            # total > 1 with no local workers = the head machine of a
            # cross-machine runtime whose workers all live elsewhere
            if fleet_replicas:
                log(
                    "[stack] LO_FLEET_REPLICAS ignored in the multi-host "
                    "topology (the coordinator serves predicts itself)"
                )
            exit_code = _supervise_multihost(
                children,
                store,
                base_env,
                host,
                ephemeral,
                restart_delay,
                max_restarts,
                write_ports,
                ports_path,
                stopping,
                log,
                workers,
                data_dir,
            )
        else:
            exit_code = _supervise(
                children,
                store,
                base_env,
                host,
                ephemeral,
                restart_delay,
                max_restarts,
                write_ports,
                ports_path,
                stopping,
                log,
                fleet_replicas=fleet_replicas,
            )
    finally:
        log("[stack] shutting down")
        for child in children.values():
            child.terminate()
        deadline = time.time() + 10
        for child in children.values():
            if child.proc:
                try:
                    child.proc.wait(max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    child.proc.kill()
    return exit_code


def _supervise(
    children,
    store,
    base_env,
    host,
    ephemeral,
    restart_delay,
    max_restarts,
    write_ports,
    ports_path,
    stopping,
    log,
    fleet_replicas: int = 0,
) -> int:
    service_store_url = _start_store_plane(children, store, host, log)
    # the META group's primary (first ';' group, first ',' replica) —
    # the url the store-restart re-point logic below tracks
    store_url = service_store_url.split(";")[0].split(",")[0]

    launch_names = list(SERVICE_NAMES)
    fleet_names = []
    if fleet_replicas:
        # the fleet children ride the same supervision loop as the
        # seven: named replica<i>/router in children, restarted on
        # failure, ports published in stack_ports.json
        fleet_names = [f"replica{i}" for i in range(fleet_replicas)]
        fleet_names.append("router")
        launch_names += fleet_names
    for name in launch_names:
        env = dict(base_env)
        env["LO_STORE_URL"] = service_store_url
        if name.startswith("replica"):
            index = int(name[len("replica"):])
            env["LO_SERVICE"] = "model_builder"
            env["LO_FLEET_REPLICA"] = str(index)
            env["LO_PORT"] = "0" if ephemeral else str(FLEET_PORT_BASE + index)
        elif name == "router":
            env["LO_SERVICE"] = "router"
            env["LO_PORT"] = "0" if ephemeral else str(ROUTER_PORT)
            env.pop("LO_FLEET_REPLICA", None)
        else:
            env["LO_SERVICE"] = name
            # replica membership is per-process: never inherited from
            # the supervisor's own environment
            env.pop("LO_FLEET_REPLICA", None)
            if ephemeral:
                env["LO_PORT"] = "0"
        child = Child(
            name,
            RUNNER_COMMAND,
            env,
            log,
        )
        children[name] = child
        child.start()
    for name in launch_names:
        children[name].wait_port(120)
    write_ports()
    if fleet_names:
        log(
            f"[stack] serving fleet up: {fleet_replicas} replica(s) + "
            "router"
        )
    log(f"[stack] all services up; ports in {ports_path}")

    retired: set = set()
    exit_code = 0
    while not stopping.is_set():
        time.sleep(0.5)
        for name, child in children.items():
            code = child.poll()
            if code is None or name in retired or stopping.is_set():
                continue
            if code == 0:
                log(f"[stack] {name} exited cleanly; not restarting")
                retired.add(name)
                child.port = None
                child.service_ports.clear()
                write_ports()
                continue
            if max_restarts is not None and child.restarts >= max_restarts:
                log(
                    f"[stack] {name} failed (rc={code}) after "
                    f"{child.restarts} restarts; giving up"
                )
                stopping.set()
                exit_code = 1
                break
            child.restarts += 1
            log(
                f"[stack] {name} failed (rc={code}); restart "
                f"#{child.restarts} in {restart_delay}s"
            )
            time.sleep(restart_delay)
            child._port_event.clear()
            child.port = None
            child.service_ports.clear()
            if name == "store":
                child.start()
                new_port = child.wait_port(60)
                new_url = f"http://{host}:{new_port}"
                wait_health(new_url, 60)
                # Ephemeral store ports can move across restarts; the
                # services' LO_STORE_URL is fixed at their spawn, so
                # only restart-in-place topologies (fixed store port)
                # keep the wiring valid — the default.
                if new_url != store_url:
                    log(
                        "[stack] store moved to "
                        f"{new_url}; restarting services to rewire"
                    )
                    store_url = new_url
                    for svc_name in launch_names:
                        svc = children[svc_name]
                        svc.terminate()
                        svc.env["LO_STORE_URL"] = store_url
            else:
                child.start()
                try:
                    child.wait_port(120)
                except TimeoutError as error:
                    if name.startswith("store-") and name.endswith(
                        ("-follower", "-arbiter")
                    ):
                        # a redundancy component that cannot come back
                        # (port held by a lingering socket, crash loop)
                        # must not take down the healthy primary and
                        # services; leave it dead, retry next cycle
                        log(f"[stack] {name} restart stalled: {error}")
                        continue
                    raise
            write_ports()

    return exit_code


def _supervise_workers_only(
    children,
    base_env,
    restart_delay,
    write_ports,
    stopping,
    log,
    workers: int,
    process_base: int,
    data_dir: str,
) -> int:
    """A worker-only machine of a cross-machine runtime
    (``LO_PROCESS_BASE`` > 0): supervise ``LO_WORKERS`` SPMD worker
    processes with process ids ``base..base+N-1``, joined to the
    head machine's coordinator (``LO_COORDINATOR``) and store
    (``LO_STORE_URL``). The reference analogue is a machine running only
    ``sparkworker`` replicas (docker-compose.yml:133-163). Any member
    dying exits the stack (rc=1): the cross-machine collective cannot
    heal locally, the cluster driver relaunches every machine's group.
    """
    workers = workers or 1
    total = int(base_env.get("LO_TOTAL_PROCESSES", "0") or 0)
    missing = [
        knob
        for knob in ("LO_COORDINATOR", "LO_STORE_URL")
        if not base_env.get(knob)
    ]
    if missing or total <= 0:
        missing += ["LO_TOTAL_PROCESSES"] if total <= 0 else []
        log(f"[stack] worker-only mode requires {', '.join(missing)}")
        return 2

    def worker_env(process_id: int) -> dict:
        env = dict(base_env)
        env["LO_NUM_PROCESSES"] = str(total)
        env["LO_PROCESS_ID"] = str(process_id)
        env.setdefault("LO_MODELS_DIR", os.path.join(data_dir, "models"))
        env.pop("LO_SERVICE", None)
        return env

    names = [f"worker{process_base + i}" for i in range(workers)]
    for index, name in enumerate(names):
        child = Child(
            name,
            RUNNER_COMMAND,
            worker_env(process_base + index),
            log,
        )
        children[name] = child
        child.start()
    for name in names:
        children[name].wait_ready(300)
    write_ports()
    log(
        f"[stack] worker group up: processes "
        f"{process_base}..{process_base + workers - 1} of {total}"
    )
    while not stopping.is_set():
        time.sleep(0.5)
        dead = [name for name in names if children[name].poll() is not None]
        if dead:
            log(
                f"[stack] runtime member(s) {dead} died in a "
                "cross-machine runtime; exiting for the cluster driver"
            )
            return 1
    return 0


def _supervise_multihost(
    children,
    store,
    base_env,
    host,
    ephemeral,
    restart_delay,
    max_restarts,
    write_ports,
    ports_path,
    stopping,
    log,
    workers: int,
    data_dir: str,
) -> int:
    """The multi-host topology (``LO_WORKERS=N``): store server +
    coordinator (all seven services, REST, SPMD dispatch) + N worker
    processes joined into ONE torch.distributed group — the reference's
    sparkmaster + N sparkworker overlay (docker-compose.yml:123-163) as
    process supervision.

    Restart semantics differ from the single-host loop on purpose: the
    collective runtime cannot heal per-process (a lost member poisons
    the collective stream — parallel/spmd.py), so ANY runtime-member
    death tears down and relaunches the WHOLE group, exactly like Spark
    restarting an application that lost executors. The store survives
    group restarts (it is outside the runtime).

    Cross-machine deployments run this same supervisor per machine:
    the coordinator machine with ``LO_WORKERS=0`` workers here and
    remote workers joining via ``LO_COORDINATOR``/``LO_PROCESS_ID`` —
    see deploy/README.md.
    """
    service_store_url = _start_store_plane(children, store, host, log)
    store_url = service_store_url.split(";")[0].split(",")[0]

    # LO_COORD_PORT=0: a free port picked at every launch of the group
    coord = {"port": os.environ.get("LO_COORD_PORT", "12355").strip() or "12355"}
    pick_port = coord["port"] == "0"
    num_processes = int(
        base_env.get("LO_TOTAL_PROCESSES", "0") or 0
    ) or (workers + 1)
    # more processes than this machine hosts = a cross-machine runtime:
    # a local group restart cannot heal it (remote members are poisoned
    # too), so member death exits the stack for the cluster driver
    cross_machine = num_processes > workers + 1

    def runtime_env(process_id: int) -> dict:
        env = dict(base_env)
        env["LO_STORE_URL"] = service_store_url
        env["LO_COORDINATOR"] = f"{host}:{coord['port']}"
        env["LO_NUM_PROCESSES"] = str(num_processes)
        env["LO_PROCESS_ID"] = str(process_id)
        # checkpoints must land on a path every host shares; on one
        # machine the data dir IS that shared volume
        env.setdefault("LO_MODELS_DIR", os.path.join(data_dir, "models"))
        if ephemeral:
            env["LO_EPHEMERAL"] = "1"
        env.pop("LO_SERVICE", None)  # coordinator runs all-in-one
        return env

    # LOCAL members only: with LO_TOTAL_PROCESSES set, processes beyond
    # workers+1 live on other machines (their stacks run LO_PROCESS_BASE)
    group_names = ["coordinator"] + [f"worker{i}" for i in range(1, workers + 1)]
    group_restarts = 0

    def launch_group() -> None:
        # A bring-up can stall (e.g. a member hitting a stale
        # coordination socket); retry the whole group like any other
        # restart instead of giving up the stack.
        for attempt in range(3):
            if pick_port:
                coord["port"] = str(free_port(host))
            for index, name in enumerate(group_names):
                child = Child(
                    name,
                    RUNNER_COMMAND,
                    runtime_env(index),
                    log,
                )
                children[name] = child
                child.start()
            try:
                children["coordinator"].wait_port(180)
                # the all-in-one coordinator announces one port PER
                # service; wait for the full set before publishing
                deadline = time.time() + 60
                while (
                    len(children["coordinator"].service_ports) < len(SERVICE_NAMES)
                    and time.time() < deadline
                ):
                    time.sleep(0.2)
                if len(children["coordinator"].service_ports) < len(SERVICE_NAMES):
                    raise TimeoutError(
                        "coordinator announced only "
                        f"{sorted(children['coordinator'].service_ports)}"
                    )
                for name in group_names[1:]:
                    children[name].wait_ready(180)
            except TimeoutError as error:
                if attempt == 2:
                    raise
                log(f"[stack] group bring-up stalled ({error}); relaunching")
                stop_group()
                time.sleep(restart_delay)
                continue
            break
        write_ports()
        log(
            f"[stack] runtime up: coordinator + {workers} worker(s), "
            f"ports in {ports_path}"
        )

    def stop_group() -> None:
        for name in group_names:
            child = children.get(name)
            if child is None:
                continue
            child.terminate()
            if child.proc is not None:
                try:
                    child.proc.wait(10)
                except subprocess.TimeoutExpired:
                    child.proc.kill()

    launch_group()

    exit_code = 0
    retired: set = set()
    while not stopping.is_set():
        time.sleep(0.5)
        store_code = store.poll()
        if (
            store_code is not None
            and store_code != 0
            and "store" not in retired
            and not stopping.is_set()
        ):
            if max_restarts is not None and store.restarts >= max_restarts:
                log(
                    f"[stack] store failed (rc={store_code}) after "
                    f"{store.restarts} restarts; giving up"
                )
                exit_code = 1
                break
            store.restarts += 1
            log(f"[stack] store failed (rc={store_code}); restarting")
            time.sleep(restart_delay)
            store._port_event.clear()
            store.start()
            new_port = store.wait_port(60)
            new_url = f"http://{host}:{new_port}"
            wait_health(new_url, 60)
            if new_url != store_url:
                # ephemeral store port moved: the group's LO_STORE_URL
                # is stale — rewire by restarting the runtime group
                log(f"[stack] store moved to {new_url}; restarting group")
                store_url = new_url
                stop_group()
                launch_group()
            write_ports()
        elif store_code == 0 and "store" not in retired:
            log("[stack] store exited cleanly; not restarting")
            retired.add("store")
            store.port = None
            write_ports()
        # replicated-plane members restart independently (their fixed
        # ports keep the wiring valid; the primary's term fence handles
        # a follower coming back after a completed takeover)
        for plane_name in ("store-follower", "store-arbiter"):
            child = children.get(plane_name)
            if (
                child is None
                or child.poll() is None
                or plane_name in retired
                or stopping.is_set()
            ):
                continue
            if child.poll() == 0:
                log(f"[stack] {plane_name} exited cleanly; not restarting")
                retired.add(plane_name)
                continue
            child.restarts += 1
            log(
                f"[stack] {plane_name} failed (rc={child.poll()}); "
                f"restart #{child.restarts} in {restart_delay}s"
            )
            time.sleep(restart_delay)
            child._port_event.clear()
            child.port = None
            child.start()
            try:
                child.wait_port(60)
            except TimeoutError as error:
                # a redundancy component failing to come back (port
                # still held by a lingering socket, crash-looping)
                # must NOT take down the healthy primary + services +
                # runtime group: leave it dead, the next cycle retries
                log(f"[stack] {plane_name} restart stalled: {error}")
                continue
            write_ports()
        dead = [
            name
            for name in group_names
            if children[name].poll() is not None
        ]
        if dead and not stopping.is_set():
            if cross_machine:
                log(
                    f"[stack] runtime member(s) {dead} died in a "
                    "cross-machine runtime; exiting for the cluster "
                    "driver to relaunch every machine's group"
                )
                return 1
            if max_restarts is not None and group_restarts >= max_restarts:
                log(
                    f"[stack] runtime member(s) {dead} died after "
                    f"{group_restarts} group restarts; giving up"
                )
                exit_code = 1
                break
            group_restarts += 1
            log(
                f"[stack] runtime member(s) {dead} died — a lost member "
                "poisons the collective stream; restarting the WHOLE "
                f"group (#{group_restarts}) in {restart_delay}s"
            )
            stop_group()
            time.sleep(restart_delay)
            launch_group()

    return exit_code


if __name__ == "__main__":
    sys.exit(main())
