"""The JAX package's fleet tests (``tests/test_fleet.py``), run on the
port's ``serve/fleet.py``, ``serve/router.py`` and ``serve/loadgen.py``.

Their source is read and run here with every module path pointed at the
port's: the placement ring and client, the knobs, the residency gossip,
the replica agent (pins, warmup once a new assignment, release, a torn
checkpoint), the router over real sockets (proxy, residency, 429 quota,
the ``serve.route`` fault, no heartbeats), the reference's client riding
the port's router off its ``/health`` probe, and the kill-one-replica
drills. The subprocess drill stays ``slow``, as in the reference. The
edits, each listed in ``EDITS``:

- ``make_classifier("lr")``, the ``ServePlane`` and
  ``model_builder.create_app`` calls gain ``device="cpu"`` (the port's
  entry points default to the CUDA card);
- the subprocess drill's replica and router runners start as
  ``python -c "...runner import main; main(device='cpu')"`` instead of
  ``python -m ...runner``, for the same reason.

The reference's client (``learningorchestra_tpu.client``, plain HTTP)
stays the client of ``TestSdkRouter``.

Below them, the port against the JAX package on the CPU:

- ``PlacementRing.owners`` is identical for 1,000 model names at
  (replicas, rf) in {(1,1), (2,1), (2,2), (3,2), (5,3)};
- five checkpoints written by the JAX package (dt, rf, gb, lr, nb),
  served through each package's in-process two-replica fleet and router
  over sockets, give the same labels and probabilities within
  ``tests/test_torch_serve.py``'s tolerances;
- the runner prints the ``fleet config:`` and ``web config:`` boot
  lines, starts a replica's agent, serves the router, and refuses
  ``LO_FLEET_RF=0`` and ``LO_WEB_HANDLERS=x``.
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time
import urllib.request
from queue import Empty, Queue

import numpy as np
import pytest

from learningorchestra_tpu.core.store import InMemoryStore as JaxStore
from learningorchestra_tpu.ml.checkpoint import checkpoint_path as jax_checkpoint_path
from learningorchestra_tpu.ml.checkpoint import save_model as jax_save_model
from learningorchestra_tpu.ml.logistic import LogisticRegression as JaxLogisticRegression
from learningorchestra_tpu.ml.naive_bayes import NaiveBayes as JaxNaiveBayes
from learningorchestra_tpu.ml.trees import (
    DecisionTreeClassifier as JaxDecisionTree,
    GBTClassifier as JaxGBT,
    RandomForestClassifier as JaxRandomForest,
)
from learningorchestra_tpu.serve import ServePlane as JaxServePlane
from learningorchestra_tpu.serve import fleet as jax_fleet
from learningorchestra_tpu.serve import router as jax_router
from learningorchestra_tpu.services import model_builder as jax_model_builder
from learningorchestra_tpu.utils.web import ServerThread as JaxServerThread
from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore
from learningorchestra_tpu_torch.serve import ServePlane as PortServePlane
from learningorchestra_tpu_torch.serve import fleet as port_fleet
from learningorchestra_tpu_torch.serve import router as port_router
from learningorchestra_tpu_torch.services import model_builder as port_model_builder
from learningorchestra_tpu_torch.utils.web import ServerThread as PortServerThread

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_fleet.py")
_CPU_MAIN = "\"-c\", \"from learningorchestra_tpu_torch.services.runner import main; main(device='cpu')\""
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ('make_classifier("lr")', 1, 'make_classifier("lr", device="cpu")'),
    (
        "        return ServePlane(\n            capacity=10**9, window_s=0.0, max_batch=8, inbox_cap=32\n        )",
        1,
        "        return ServePlane(\n            capacity=10**9, window_s=0.0, max_batch=8, inbox_cap=32, device=\"cpu\"\n        )",
    ),
    (
        "            plane = ServePlane(\n                capacity=10**9, window_s=0.0, max_batch=16, inbox_cap=128\n            )",
        1,
        "            plane = ServePlane(\n                capacity=10**9, window_s=0.0, max_batch=16, inbox_cap=128, device=\"cpu\"\n            )",
    ),
    (
        "        plane = ServePlane(\n            capacity=10**9, window_s=0.0, max_batch=8, inbox_cap=32\n        )",
        1,
        "        plane = ServePlane(\n            capacity=10**9, window_s=0.0, max_batch=8, inbox_cap=32, device=\"cpu\"\n        )",
    ),
    (
        "            app = model_builder.create_app(\n                self.store, models_dir=str(models_dir), serve=plane\n            )",
        1,
        "            app = model_builder.create_app(\n                self.store, models_dir=str(models_dir), serve=plane, device=\"cpu\"\n            )",
    ),
    (
        "        app = model_builder.create_app(\n            InMemoryStore(), models_dir=str(tmp_path), serve=plane\n        )",
        1,
        "        app = model_builder.create_app(\n            InMemoryStore(), models_dir=str(tmp_path), serve=plane, device=\"cpu\"\n        )",
    ),
    (
        "                    [\n                        sys.executable,\n                        \"-m\",\n"
        "                        \"learningorchestra_tpu.services.runner\",\n                    ],",
        1,
        f"                    [sys.executable, {_CPU_MAIN}],",
    ),
    (
        '            [sys.executable, "-m", "learningorchestra_tpu.services.runner"],',
        1,
        f"            [sys.executable, {_CPU_MAIN}],",
    ),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's fleet, router, load generator,
    serve plane and server, and its slow drill starts the port's store
    server and runners."""
    assert fleet is port_fleet  # noqa: F821
    assert fleet_router is port_router  # noqa: F821
    assert ServePlane is PortServePlane  # noqa: F821
    assert ServerThread is PortServerThread  # noqa: F821
    assert model_builder is port_model_builder  # noqa: F821
    assert re.findall(r"learningorchestra_tpu\.\w+", _source) == []
    assert '"learningorchestra_tpu_torch.core.store_service"' in _source
    assert _source.count("main(device='cpu')") == 2
    drill = test_subprocess_drill_sigkill_one_replica  # noqa: F821
    assert {mark.name for mark in drill.pytestmark} >= {"slow"}
    tests = [name for name in list(globals()) if name.startswith("Test")]
    assert len(tests) >= 8


# --- the port against the JAX package ---------------------------------------


@pytest.mark.parametrize("replicas,rf", [(1, 1), (2, 1), (2, 2), (3, 2), (5, 3)])
def test_placement_is_the_references(replicas, rf):
    ours = port_fleet.PlacementRing(replicas)
    theirs = jax_fleet.PlacementRing(replicas)
    names = [f"model_{i}_prediction_{kind}" for i in range(200) for kind in ("dt", "rf", "gb", "lr", "nb")]
    assert len(names) == 1000
    assert [ours.owners(name, rf) for name in names] == [theirs.owners(name, rf) for name in names]


FEATURES = 6
NAMES = ("dt", "rf", "gb", "lr", "nb")
TOLERANCES = {
    "dt": dict(rtol=0, atol=1e-6),
    "rf": dict(rtol=0, atol=1e-6),
    "gb": dict(rtol=0, atol=1e-6),
    "lr": dict(rtol=1e-5, atol=1e-5),
    "nb": dict(rtol=1e-5, atol=1e-5),
}


def make_rows(seed, rows):
    return np.random.default_rng(seed).normal(size=(rows, FEATURES)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_models_dir(tmp_path_factory):
    """dt, rf, gb, lr and nb fitted by the JAX package at a small size and
    saved as ``.model`` checkpoints (``tests/test_torch_serve.py``'s)."""
    directory = tmp_path_factory.mktemp("fleet_models")
    X = make_rows(0, 320)
    y = ((X[:, 0] - X[:, 1]) > 0).astype(np.int32)
    estimators = {
        "dt": JaxDecisionTree(max_depth=3),
        "rf": JaxRandomForest(num_trees=4, max_depth=3),
        "gb": JaxGBT(rounds=4, max_depth=3),
        "lr": JaxLogisticRegression(max_iter=20),
        "nb": JaxNaiveBayes(),
    }
    for name, estimator in estimators.items():
        model = estimator.fit(np.abs(X) if name == "nb" else X, y)
        jax_save_model(model, jax_checkpoint_path(str(directory), name))
    return str(directory)


class _Fleet:
    """Two replicas (rf 2) and a router of one package, in process, on
    ephemeral ports."""

    def __init__(self, package, models_dir):
        port = package == "port"
        store_cls = PortStore if port else JaxStore
        fleet_module = port_fleet if port else jax_fleet
        router_module = port_router if port else jax_router
        builder = port_model_builder if port else jax_model_builder
        server_cls = PortServerThread if port else JaxServerThread
        device = {"device": "cpu"} if port else {}
        self.store = store_cls()
        self.planes, self.servers, self.agents = [], [], []
        for index in range(2):
            plane_cls = PortServePlane if port else JaxServePlane
            plane = plane_cls(capacity=10**9, window_s=0.0, max_batch=16, inbox_cap=128, **device)
            app = builder.create_app(self.store, models_dir=models_dir, serve=plane, **device)
            server = server_cls(app, "127.0.0.1", 0).start()
            agent = fleet_module.ReplicaAgent(
                self.store, models_dir, plane, index=index, url=f"http://127.0.0.1:{server.port}",
                total=2, rf=2, interval_s=0.15, placement_ttl_s=0.05, warm=False,
            )
            agent.refresh()
            self.planes.append(plane)
            self.servers.append(server)
            self.agents.append(agent)
        app = router_module.create_app(
            self.store,
            placement=fleet_module.PlacementClient(self.store, replicas=2, rf=2, ttl_s=0.05),
            view=fleet_module.FleetView(self.store, ttl_s=0.1, down_s=30.0),
            timeout_s=10.0,
        )
        self.router = server_cls(app, "127.0.0.1", 0).start()

    def predict(self, name, rows):
        request = urllib.request.Request(
            f"http://127.0.0.1:{self.router.port}/models/{name}/predict",
            data=json.dumps({"rows": rows.tolist()}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(request, timeout=30) as response:
            return response.status, json.loads(response.read())

    def close(self):
        for server in [self.router, *self.servers]:
            server.stop()
        for plane in self.planes:
            plane.close()


@pytest.fixture(scope="module")
def fleets(jax_models_dir):
    built = {package: _Fleet(package, jax_models_dir) for package in ("jax", "port")}
    yield built
    for fleet_of in built.values():
        fleet_of.close()


@pytest.mark.parametrize("rows", [1, 64])
@pytest.mark.parametrize("name", NAMES)
def test_routed_predictions_are_the_references(fleets, name, rows):
    X = make_rows(11 + rows, rows)
    if name == "nb":
        X = np.abs(X)
    (jax_status, expected), (port_status, got) = (fleets[package].predict(name, X) for package in ("jax", "port"))
    assert jax_status == port_status == 200
    expected, got = expected["result"], got["result"]
    assert got["model"] == expected["model"] == name
    assert got["predictions"] == expected["predictions"]
    np.testing.assert_allclose(got["probabilities"], expected["probabilities"], **TOLERANCES[name])


def test_the_fleet_pictures_agree(fleets):
    """Both routers place each model on both replicas (rf 2 of 2), in the
    same owner order, and both replicas hold all five."""
    pictures = {}
    for package in ("jax", "port"):
        url = f"http://127.0.0.1:{fleets[package].router.port}/models"
        pictures[package] = {}
        for name in NAMES:
            with urllib.request.urlopen(f"{url}/{name}", timeout=30) as response:
                pictures[package][name] = json.loads(response.read())["result"]["fleet"]
    for name in NAMES:
        ours, theirs = pictures["port"][name], pictures["jax"][name]
        assert ours["owners"] == theirs["owners"] and ours["rf"] == theirs["rf"] == 2
        for picture in (ours, theirs):
            assert set(picture["replicas"]) == {"0", "1"}
            assert all(set(NAMES) <= set(row["models"]) for row in picture["replicas"].values())


# --- the runner --------------------------------------------------------------

_REPO = str(pathlib.Path(__file__).resolve().parent.parent)
_RUNNER = "from learningorchestra_tpu_torch.services.runner import main; main(device='cpu')"


def _runner_env(tmp_path, extra):
    env = dict(os.environ, PYTHONUNBUFFERED="1", LO_DATA_DIR=str(tmp_path / "lo_data"), LO_PORT="0",
               LO_HOST="127.0.0.1", LO_TSDB_COLLECT="0")
    for stale in ("LO_STORE_URL", "LO_SERVICE", "LO_FLEET_REPLICA", "LO_FLEET_REPLICAS", "LO_FLEET_RF",
                  "LO_WEB_ASYNC", "LO_WEB_HANDLERS"):
        env.pop(stale, None)
    env.update(extra)
    return env


def _boot(tmp_path, extra, until, timeout_s=120):
    """Start a runner child; its output up to the line matching ``until``
    (or its end), then stop it."""
    process = subprocess.Popen(
        [sys.executable, "-c", _RUNNER], cwd=_REPO, env=_runner_env(tmp_path, extra),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines, queue = [], Queue()
    threading.Thread(target=lambda: [queue.put(line) for line in process.stdout] + [queue.put(None)],
                     daemon=True).start()
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            try:
                line = queue.get(timeout=max(0.01, deadline - time.monotonic()))
            except Empty:
                break
            if line is None:
                break
            lines.append(line)
            if re.search(until, line):
                break
    finally:
        if process.poll() is None:
            process.terminate()
        try:
            process.wait(timeout=30)
        except subprocess.TimeoutExpired:
            process.kill()
            process.wait(timeout=30)
    return "".join(lines), process.returncode


@pytest.mark.parametrize(
    "extra,until",
    [
        ({"LO_SERVICE": "router"}, r"service router on [\d.]+:\d+"),
        (
            {"LO_SERVICE": "model_builder", "LO_FLEET_REPLICA": "1", "LO_FLEET_REPLICAS": "2", "LO_FLEET_RF": "2"},
            r"fleet replica 1: agent started",
        ),
    ],
    ids=["router", "replica"],
)
def test_the_runner_states_the_fleet_and_web_config(tmp_path, extra, until):
    output, _ = _boot(tmp_path, extra, until)
    assert re.search(until, output), output
    fleet_line = re.search(r"^fleet config: (\{.*\})$", output, re.M)
    web_line = re.search(r"^web config: (\{.*\})$", output, re.M)
    assert fleet_line and web_line, output
    assert "'LO_WEB_ASYNC': 1" in web_line.group(1) and "'LO_WEB_HANDLERS': 8" in web_line.group(1)
    replica = extra.get("LO_FLEET_REPLICA")
    assert f"'LO_FLEET_REPLICA': {replica}" in fleet_line.group(1)


@pytest.mark.parametrize("knob,value", [("LO_FLEET_RF", "0"), ("LO_WEB_HANDLERS", "x")])
def test_the_runner_refuses_a_malformed_knob(tmp_path, knob, value):
    output, code = _boot(tmp_path, {"LO_SERVICE": "router", knob: value}, r"service router on")
    assert code not in (0, None) and knob in output, output
    assert "service router on" not in output
