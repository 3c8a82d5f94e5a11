"""The batch predictions lane, ``POST /models/<name>/predictions``, held
against the JAX package's on the CPU.

- The JAX package's ``TestCheckpointWiring`` (``tests/test_checkpoint.py``)
  runs here on the port: a build persists its ``.model``, a new app over
  the same store and volume lists and describes it, and the batch route
  reproduces the build's predictions from the artifact alone, with no
  refit.
- The route's answers (406 missing fields, or a body that is not JSON,
  404 unknown model, 405 on GET, 406 unknown training or test collection
  and unsafe name, 409 taken name, 429 full device queue, the ``#dup``
  rerun of a concurrent duplicate, 201) equal the reference's app's on
  status, ``Content-Type`` and body, in process and over a socket. Both
  apps get a gated ``predict`` so that a job can be held.
- The lane itself: every classifier is built once by the port, and its
  ``.model`` predicts the same collections through the port's and the
  reference's ``predict_with_model``: labels identical, probabilities
  within the checkpoint tolerances (``tests/test_torch_checkpoint.py``:
  1e-6 for trees, the same float32 operations in the same order; 1e-5
  for lr and nb, the GEMM sums in another order).
"""

import csv
import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learningorchestra_tpu.core import ingest as jax_ingest  # noqa: E402
from learningorchestra_tpu.core.jobs import JobManager as JaxJobManager  # noqa: E402
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore  # noqa: E402
from learningorchestra_tpu.ml import builder as jax_builder  # noqa: E402
from learningorchestra_tpu.ops import dtype as jax_dtype  # noqa: E402
from learningorchestra_tpu.sched import Scheduler as JaxScheduler  # noqa: E402
from learningorchestra_tpu.services import model_builder as jax_model_builder  # noqa: E402
from learningorchestra_tpu.utils.web import ServerThread as JaxServerThread  # noqa: E402
from learningorchestra_tpu_torch.core import devcache, ingest  # noqa: E402
from learningorchestra_tpu_torch.core.jobs import JobManager  # noqa: E402
from learningorchestra_tpu_torch.core.store import METADATA_ID, ROW_ID, InMemoryStore  # noqa: E402
from learningorchestra_tpu_torch.ml import builder  # noqa: E402
from learningorchestra_tpu_torch.ops import dtype  # noqa: E402
from learningorchestra_tpu_torch.sched import Scheduler  # noqa: E402
from learningorchestra_tpu_torch.services import model_builder  # noqa: E402
from learningorchestra_tpu_torch.utils.web import ServerThread  # noqa: E402
from tests.test_frame import DOCUMENTED_PREPROCESSOR  # noqa: E402

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_checkpoint.py")
DATA = pathlib.Path(__file__).with_name("data")
FIELDS = ("PassengerId", "Survived", "Pclass", "Name", "Sex", "Age", "SibSp", "Parch", "Embarked")
NUMBERS = ("Age", "Parch", "PassengerId", "Pclass", "SibSp")   # and the training set's Survived
NAMES = ("lr", "dt", "rf", "gb", "nb")
PROB_TOL = {"dt": 1e-6, "rf": 1e-6, "gb": 1e-6, "lr": 1e-5, "nb": 1e-5}

# --- the reference's TestCheckpointWiring, on the port ------------------------

_source = REFERENCE_TESTS.read_text()
_source = _source[_source.index("class TestCheckpointWiring"):]
_source = _source[: _source.index("\nclass ", 1)]
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
for _old, _count in (("models_dir=models_dir", 2), ("models_dir=str(tmp_path)", 1)):
    assert _source.count(_old) == _count, _old   # the apps the class makes
    _source = _source.replace(_old, _old + ', device="cpu"')
exec(compile("import os\n" + _source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture()
def store():
    """The port's store, for the reference's tests above."""
    return InMemoryStore()


@pytest.fixture(autouse=True)
def clean_global_devcache():
    devcache.reset_global_devcache()
    yield
    devcache.reset_global_devcache()


@pytest.fixture(autouse=True, scope="module")
def reference_registry_in_step():
    """After this module, the JAX package's process-wide metrics registry
    holds the families that the port's code here registers in the port's
    (the device cache's gauges, the fits' segment counters), as the
    reference's own code registers them when it does the same work:
    tests/test_torch_builder_routes.py holds the port's families to be
    among the reference's in one worker process."""
    yield
    from learningorchestra_tpu.core import devcache as reference_devcache
    from learningorchestra_tpu.ml import progress as reference_progress

    reference_devcache.global_devcache()
    reference_progress._saved_counter()
    reference_progress._skipped_counter()


def test_the_reference_wiring_runs_on_the_port():
    assert "learningorchestra_tpu." not in _source
    assert TestCheckpointWiring.__module__ == __name__  # noqa: F821


# --- the route's answers ------------------------------------------------------


class GatedPredict:
    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.ran = []

    def __call__(self, model_name, body):
        self.gate.wait(10)
        self.ran.append((model_name, body["prediction_filename"]))


def app_of(package, models_dir, queue_cap=1):
    predict = GatedPredict()
    if package == "jax":
        store = JaxStore()
        jobs = JaxJobManager(scheduler=JaxScheduler(device_width=1, queue_cap=queue_cap))
        app = jax_model_builder.create_app(
            store, models_dir=str(models_dir), jobs=jobs, predict=predict
        )
    else:
        store = InMemoryStore()
        jobs = JobManager(scheduler=Scheduler(device_width=1, queue_cap=queue_cap))
        app = model_builder.create_app(
            store, models_dir=str(models_dir), jobs=jobs, predict=predict, device="cpu"
        )
    for name in ("train", "test"):
        store.insert_one(name, {ROW_ID: METADATA_ID, "filename": name, "finished": True})
    (models_dir / "m.model").write_bytes(b"")
    return app, store, jobs, predict


def body(**changes):
    request = {
        "training_filename": "train",
        "test_filename": "test",
        "preprocessor_code": "",
        "prediction_filename": "out",
    }
    request.update(changes)
    return {k: v for k, v in request.items() if v is not None}


def wait_for(condition):
    deadline = time.time() + 10
    while not condition():
        assert time.time() < deadline
        time.sleep(0.005)


def scenario(package, folder):
    """The route's answers, one request at a time:
    ``(status, Content-Type, body, Allow, Retry-After)`` each."""
    folder.mkdir()
    app, _, jobs, predict = app_of(package, folder)
    client = app.test_client()
    answers = []

    def record(response):
        answers.append((
            response.status_code, response.headers.get("Content-Type"), response.get_data(),
            response.headers.get("Allow"), response.headers.get("Retry-After"),
        ))

    record(client.post("/models/m/predictions", json={}))
    record(client.post("/models/m/predictions", json=body(preprocessor_code=None)))
    record(client.post("/models/nope/predictions", json=body()))
    record(client.get("/models/m/predictions"))
    record(client.post("/models/m/predictions", json=body(training_filename="missing")))
    record(client.post("/models/m/predictions", json=body(test_filename="missing")))
    record(client.post("/models/m/predictions", json=body(prediction_filename="../up")))
    record(client.post("/models/m/predictions", json=body(prediction_filename="train")))
    record(client.post("/models/m/predictions", json=body()))
    # a held device job and a queued one: the queue is full
    gate = threading.Event()
    jobs.submit("hold", gate.wait, job_class="device")
    wait_for(lambda: jobs.get("hold") is not None and jobs.get("hold").state == "running")
    jobs.submit("queued", lambda: None, job_class="device")
    record(client.post("/models/m/predictions", json=body(prediction_filename="later")))
    gate.set()
    jobs.wait("queued", timeout=10)
    assert predict.ran == [("m", "out")]
    return answers


def test_route_answers_as_the_reference(tmp_path):
    ours, theirs = scenario("port", tmp_path / "port"), scenario("jax", tmp_path / "jax")
    assert ours == theirs
    assert [answer[0] for answer in ours] == [406, 406, 404, 405, 406, 406, 406, 409, 201, 429]


def test_concurrent_duplicate_runs_again_as_the_reference(tmp_path):
    """A second request for a prediction name whose job is still queued
    runs too, under ``predict:<name>#dup1``."""
    outcomes = {}
    for package in ("port", "jax"):
        folder = tmp_path / package
        folder.mkdir()
        app, _, jobs, predict = app_of(package, folder, queue_cap=4)
        client = app.test_client()
        gate = threading.Event()
        jobs.submit("hold", gate.wait, job_class="device")
        wait_for(lambda: jobs.get("hold") is not None and jobs.get("hold").state == "running")
        results = []

        def post():
            response = client.post("/models/m/predictions", json=body())
            results.append((response.status_code, json.loads(response.get_data())))

        first = threading.Thread(target=post)
        first.start()
        wait_for(lambda: jobs.get("predict:out") is not None)
        second = threading.Thread(target=post)
        second.start()
        wait_for(lambda: jobs.get("predict:out#dup1") is not None)
        gate.set()
        first.join(10)
        second.join(10)
        outcomes[package] = (results, predict.ran, jobs.get("predict:out#dup1").state)
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == [(201, {"result": "created_file"})] * 2


def _over_socket(server_cls, app, requests):
    server = server_cls(app, "127.0.0.1", 0).start()
    answers = []
    try:
        for method, path, payload in requests:
            data = None if payload is None else payload.encode()
            request = urllib.request.Request(
                f"http://127.0.0.1:{server.port}{path}", data=data, method=method,
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(request, timeout=10) as response:
                    answers.append((response.status, response.headers.get("Content-Type"), response.read()))
            except urllib.error.HTTPError as error:
                answers.append((error.code, error.headers.get("Content-Type"), error.read()))
    finally:
        server.stop()
    return answers


def test_route_answers_over_a_socket_as_the_reference(tmp_path):
    requests = [
        ("POST", "/models/m/predictions", "{}"),
        ("POST", "/models/m/predictions", "not json"),
        ("POST", "/models/nope/predictions", json.dumps(body())),
        ("GET", "/models/m/predictions", None),
        ("POST", "/models/m/predictions", json.dumps(body(test_filename="missing"))),
        ("POST", "/models/m/predictions", json.dumps(body(prediction_filename="test"))),
        ("POST", "/models/m/predictions", json.dumps(body())),
    ]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = _over_socket(ServerThread, app_of("port", tmp_path / "port")[0], requests)
    theirs = _over_socket(JaxServerThread, app_of("jax", tmp_path / "jax")[0], requests)
    assert ours == theirs
    assert [status for status, _, _ in ours] == [406, 406, 404, 405, 406, 409, 201]


# --- the lane against the reference's ----------------------------------------


def _projected(folder) -> dict:
    """The Titanic CSVs cut to the fields the documented preprocessor
    reads (the projection ``tests/test_torch_titanic.py`` makes)."""
    paths = {}
    for name in ("titanic_train", "titanic_test"):
        with open(DATA / f"{name}.csv", newline="") as source:
            rows = list(csv.DictReader(source))
        fields = [f for f in FIELDS if f in rows[0]]
        paths[name] = str(folder / f"{name}.csv")
        with open(paths[name], "w", newline="") as target:
            writer = csv.DictWriter(target, fields, extrasaction="ignore")
            writer.writeheader()
            writer.writerows(rows)
    return paths


def _ingest(store, ingest_module, dtype_module, paths):
    for name, path in paths.items():
        ingest_module.write_ingest_metadata(store, name, path)
        ingest_module.ingest_csv(store, name, path)
        numbers = NUMBERS + (("Survived",) if name == "titanic_train" else ())
        dtype_module.convert_field_types(store, name, {field: "number" for field in numbers})
    return store


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The five classifiers built once by the port on the CPU, with their
    ``.model`` files, and a reference store holding the same data."""
    models_dir = str(tmp_path_factory.mktemp("models"))
    paths = _projected(tmp_path_factory.mktemp("csv"))
    store = _ingest(InMemoryStore(), ingest, dtype, paths)
    builder.build_model(
        store, "titanic_train", "titanic_test", DOCUMENTED_PREPROCESSOR, list(NAMES),
        device="cpu", models_dir=models_dir,
    )
    return store, _ingest(JaxStore(), jax_ingest, jax_dtype, paths), models_dir


def _written(store, name):
    columns = store.read_columns(name, ["prediction", "probability"])
    return np.asarray(columns["prediction"]), np.asarray(columns["probability"], np.float64)


@pytest.mark.parametrize("name", NAMES)
def test_batch_lane_matches_the_reference(built, name):
    store, jax_store, models_dir = built
    model = f"titanic_test_prediction_{name}"
    path = f"{models_dir}/{model}.model"
    metadata = builder.predict_with_model(
        store, path, "titanic_train", "titanic_test", DOCUMENTED_PREPROCESSOR, f"again_{name}",
        device="cpu",
    )
    jax_builder.predict_with_model(
        jax_store, path, "titanic_train", "titanic_test", DOCUMENTED_PREPROCESSOR, f"again_{name}"
    )
    labels, probs = _written(store, f"again_{name}")
    theirs_labels, theirs_probs = _written(jax_store, f"again_{name}")
    np.testing.assert_array_equal(labels, theirs_labels)
    np.testing.assert_allclose(probs, theirs_probs, rtol=0, atol=PROB_TOL[name])
    # the build's own predictions, reproduced without a refit
    np.testing.assert_array_equal(labels, _written(store, model)[0])
    stored = store.find_one(f"again_{name}", {ROW_ID: 0})
    assert stored["model_checkpoint"] == path and "fit" not in stored["timings"]
    assert set(metadata["timings"]) == {"load_data", "preprocess", "h2d", "predict", "write"}


def test_second_request_reads_and_copies_nothing_again(built):
    """The host tier serves both collections and the content tier the test
    matrix: the second request over unchanged collections adds cache hits,
    no misses and no host-to-device bytes. A write to the test collection
    moves its rev, and the next request reads it again."""
    from learningorchestra_tpu_torch.ml import base

    store, _, models_dir = built
    path = f"{models_dir}/titanic_test_prediction_dt.model"

    def request(out):
        builder.predict_with_model(
            store, path, "titanic_train", "titanic_test", DOCUMENTED_PREPROCESSOR, out, device="cpu"
        )

    request("warm_1")
    stats, copied = devcache.global_devcache().stats(), base.h2d_bytes()
    request("warm_2")
    after = devcache.global_devcache().stats()
    assert after["misses"] == stats["misses"] and after["hits"] >= stats["hits"] + 3
    assert base.h2d_bytes() == copied   # the CPU copies nothing either way: the count is the card's
    document = dict(store.find_one("titanic_test", {"PassengerId": 892.0}))
    document.pop(ROW_ID)
    store.insert_one("titanic_test", document)
    request("warm_3")
    moved = devcache.global_devcache().stats()
    assert moved["invalidations"] == after["invalidations"] + 1
    assert moved["misses"] > after["misses"]
    assert store.count("warm_3") == store.count("warm_2") + 1
