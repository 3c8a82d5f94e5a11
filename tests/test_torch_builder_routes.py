"""The port's ``POST /models`` and job routes held against the JAX
package's app, in process, on the CPU.

Both apps get the same requests in the same order, each over its own
store and its own ``JobManager`` (device width 1, queue cap 1), with a
build that waits on a gate (so a job can be held running) and checks
for cancellation while it waits. Answers must match exactly on status
and body: sync and async 201, the three 406s, the async duplicate's 409,
the full device queue's 429 (and its ``Retry-After``), ``GET /jobs`` and
``/jobs/<name>``, ``/wait`` (finished, timed out, bad timeout, unknown),
``DELETE /jobs/<name>`` (202, 409, 404) and ``/health``. A job record's
times and correlation ID differ by nature: they are compared by type.
``/metrics`` answers 200 with the same content type, and the port's
families are a subset of the reference's.

The port's app also builds all five classifiers for real on the CPU
through ``POST /models``, sync and async (waited on through ``/wait``).
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from learningorchestra_tpu.core.jobs import JobManager as JaxJobManager  # noqa: E402
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore  # noqa: E402
from learningorchestra_tpu.sched import Scheduler as JaxScheduler  # noqa: E402
from learningorchestra_tpu.sched.cancel import check_cancelled as jax_check_cancelled  # noqa: E402
from learningorchestra_tpu.services import model_builder as jax_model_builder  # noqa: E402
from learningorchestra_tpu_torch.core import ingest  # noqa: E402
from learningorchestra_tpu_torch.core.jobs import JobManager  # noqa: E402
from learningorchestra_tpu_torch.core.store import METADATA_ID, ROW_ID, InMemoryStore  # noqa: E402
from learningorchestra_tpu_torch.ops import dtype  # noqa: E402
from learningorchestra_tpu_torch.sched import Scheduler  # noqa: E402
from learningorchestra_tpu_torch.sched.cancel import check_cancelled  # noqa: E402
from learningorchestra_tpu_torch.services import model_builder  # noqa: E402
from tests.conftest import TITANIC_LIKE_CSV  # noqa: E402
from tests.test_frame import DOCUMENTED_PREPROCESSOR  # noqa: E402

VOLATILE = ("submitted_at", "started_at", "ended_at", "correlation_id")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def with_collections(store, names=("train", "test")):
    for name in names:
        store.insert_one(name, {ROW_ID: METADATA_ID, "filename": name, "finished": True})
    return store


class GatedBuild:
    """A build that blocks until its gate opens (or the job is cancelled)
    and records the bodies it ran."""

    def __init__(self, check):
        self.gate = threading.Event()
        self.check = check
        self.ran = []

    def __call__(self, body):
        while not self.gate.wait(0.005):
            self.check()
        self.ran.append(body["test_filename"])


def app_of(package):
    if package == "jax":
        build = GatedBuild(jax_check_cancelled)
        jobs = JaxJobManager(scheduler=JaxScheduler(device_width=1, queue_cap=1))
        app = jax_model_builder.create_app(
            with_collections(JaxStore()), build=build, models_dir="", jobs=jobs
        )
    else:
        build = GatedBuild(check_cancelled)
        jobs = JobManager(scheduler=Scheduler(device_width=1, queue_cap=1))
        app = model_builder.create_app(
            with_collections(InMemoryStore()), build=build, models_dir="", jobs=jobs, device="cpu"
        )
    return app.test_client(), build, jobs


def request_body(test="test", classifiers=("nb",), run_async=False, training="train"):
    body = {
        "training_filename": training,
        "test_filename": test,
        "preprocessor_code": "",
        "classificators_list": list(classifiers),
    }
    if run_async:
        body["async"] = True
    return body


def answer(response):
    return response.status_code, json.loads(response.get_data())


def masked(record):
    """A job record with its times and correlation ID as their types."""
    if not isinstance(record, dict) or "state" not in record:
        return record
    return {
        key: (type(value).__name__ if key in VOLATILE else value)
        for key, value in record.items()
    }


def masked_answer(response):
    status, body = answer(response)
    result = body.get("result")
    if isinstance(result, list):
        body["result"] = sorted((masked(record) for record in result), key=lambda r: r["name"])
    else:
        body["result"] = masked(result)
    return status, body


def wait_running(jobs, name):
    deadline = time.time() + 10
    while jobs.get(name) is None or jobs.get(name).state != "running":
        assert time.time() < deadline
        time.sleep(0.005)


def scenario(package):
    """Every route of the job surface, one request at a time; returns the
    answers in order."""
    client, build, jobs = app_of(package)
    answers = []

    def record(response, **extra):
        answers.append((masked_answer(response), extra))

    # 406s, before any job
    record(client.post("/models", json=request_body(training="missing")))
    record(client.post("/models", json=request_body(test="missing")))
    record(client.post("/models", json=request_body(classifiers=("nb", "svm"))))
    # async 201, then held running
    record(client.post("/models", json=request_body(run_async=True)))
    wait_running(jobs, "build:test:nb")
    # the same async build while it runs: 409
    record(client.post("/models", json=request_body(run_async=True)))
    # the queue: one more device job fills its cap of 1, the next is 429
    record(client.post("/models", json=request_body(classifiers=("dt",), run_async=True)))
    full = client.post("/models", json=request_body(classifiers=("lr",), run_async=True))
    record(full, retry_after=full.headers.get("Retry-After"))
    full = client.post("/models", json=request_body(classifiers=("lr",)))  # sync: 429 too
    record(full, retry_after=full.headers.get("Retry-After"))
    # a wait that times out on the running job, and the bad ones
    record(client.get("/jobs/build:test:nb/wait?timeout=0.05"))
    record(client.get("/jobs/build:test:nb/wait?timeout=soon"))
    record(client.get("/jobs/build:test:nb/wait?timeout=-1"))
    record(client.get("/jobs/nothing/wait"))
    record(client.get("/jobs/build:test:nb"))
    record(client.get("/jobs/nothing"))
    # cancel the queued job, then let the held one finish
    record(client.delete("/jobs/build:test:dt"))
    record(client.delete("/jobs/nothing"))
    build.gate.set()
    record(client.get("/jobs/build:test:nb/wait?timeout=10"))
    record(client.get("/jobs/build:test:dt/wait?timeout=10"))
    record(client.delete("/jobs/build:test:nb"))
    # sync 201 once the queue is free, then the listing
    record(client.post("/models", json=request_body(classifiers=("gb", "rf"))))
    record(client.get("/jobs"))
    record(client.get("/health"))
    assert build.ran == ["test", "test"]
    return answers


def test_job_surface_answers_as_the_reference():
    ours, theirs = scenario("port"), scenario("jax")
    assert len(ours) == len(theirs)
    for index, (got, want) in enumerate(zip(ours, theirs)):
        assert got == want, index
    statuses = [status for (status, _), _ in ours]
    assert statuses == [
        406, 406, 406, 201, 409, 201, 429, 429, 200, 400, 400, 404, 200, 404,
        202, 404, 200, 200, 409, 201, 200, 200,
    ]


# Both apps' /metrics from a fresh process: each package's registry is
# process-wide and registers some families lazily (the device cache's at
# its first use, a fit's segment counters at its first save), so in the
# test process they would depend on what ran before in the same worker.
_METRICS_PROBE = """
import json
from tests.test_torch_builder_routes import app_of
ours, _, _ = app_of("port")
theirs, _, _ = app_of("jax")
# /health reads the SLO verdict, which publishes the lo_slo_burning gauges
ours.get("/health")
theirs.get("/health")
print(json.dumps({
    side: {"status": r.status_code, "type": r.headers["Content-Type"], "body": r.get_data().decode()}
    for side, r in (("ours", ours.get("/metrics")), ("theirs", theirs.get("/metrics")))
}))
"""


def test_metrics_are_served_as_the_reference():
    result = subprocess.run(
        [sys.executable, "-c", _METRICS_PROBE], capture_output=True, text=True,
        cwd=REPO_ROOT, timeout=240, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert result.returncode == 0, result.stderr
    answers = json.loads(result.stdout.strip().splitlines()[-1])
    got, want = answers["ours"], answers["theirs"]
    assert got["status"] == want["status"] == 200
    assert got["type"] == want["type"]

    def families(response):
        return {
            line.split()[2] for line in response["body"].splitlines()
            if line.startswith("# TYPE ")
        }

    ours_families = families(got)
    assert ours_families <= families(want)
    for family in (
        "lo_http_requests_total", "lo_http_request_duration_seconds", "lo_jobs_total",
        "lo_sched_queue_depth", "lo_sched_rejected_total", "lo_store_collections",
    ):
        assert family in ours_families
    assert 'lo_http_requests_total{service="model_builder",route="/health",method="GET",status="200"}' in (
        got["body"]
    )


@pytest.fixture()
def titanic_app(tmp_path):
    path = tmp_path / "titanic.csv"
    path.write_text(TITANIC_LIKE_CSV)
    store = InMemoryStore()
    for name in ("titanic_train", "titanic_test"):
        ingest.write_ingest_metadata(store, name, str(path))
        ingest.ingest_csv(store, name, str(path))
        dtype.convert_field_types(store, name, {
            field: "number"
            for field in ("PassengerId", "Survived", "Pclass", "Age", "SibSp", "Parch", "Fare")
        })
    models_dir = tmp_path / "models"
    app = model_builder.create_app(store, models_dir=str(models_dir), device="cpu")
    return app.test_client(), store, models_dir


@pytest.mark.parametrize("run_async", [False, True], ids=["sync", "async"])
def test_post_models_builds_all_five_classifiers(titanic_app, run_async):
    client, store, models_dir = titanic_app
    names = ["lr", "dt", "rf", "gb", "nb"]
    body = {
        "training_filename": "titanic_train",
        "test_filename": "titanic_test",
        "preprocessor_code": DOCUMENTED_PREPROCESSOR,
        "classificators_list": names,
    }
    job = "build:titanic_test:lr+dt+rf+gb+nb"
    if run_async:
        body["async"] = True
    assert answer(client.post("/models", json=body)) == (
        201, {"result": "created_file", **({"job": job} if run_async else {})}
    )
    status, waited = answer(client.get(f"/jobs/{job}/wait?timeout=60"))
    assert status == 200 and waited["result"]["state"] == "finished"
    assert waited["result"]["job_class"] == "device"
    for name in names:
        collection = f"titanic_test_prediction_{name}"
        metadata = store.find_one(collection, {ROW_ID: 0})
        assert metadata["classificator"] == name
        assert isinstance(metadata["F1"], str) and isinstance(metadata["fit_time"], float)
        assert len([doc for doc in store.find(collection) if doc[ROW_ID] != 0]) == 8
        assert (models_dir / f"{collection}.model").is_file()
    assert answer(client.get("/models"))[1]["result"] == sorted(
        f"titanic_test_prediction_{name}" for name in names
    )


def test_image_create_answers_429_as_the_reference(tmp_path):
    """An image create runs in the DEVICE class: behind a held device job
    and a full queue it answers the reference's 429, and leaves no claim
    behind."""
    from learningorchestra_tpu.services import images as jax_images
    from learningorchestra_tpu_torch.services import images
    from tests.test_torch_images import stores

    jax_store, port_store = stores()
    answers = {}
    for package, store, create_app, manager, scheduler in (
        ("jax", jax_store, jax_images.create_app, JaxJobManager, JaxScheduler),
        ("port", port_store, images.create_app, JobManager, Scheduler),
    ):
        jobs = manager(scheduler=scheduler(device_width=1, queue_cap=1))
        folder = tmp_path / package
        extra = {"device": "cpu"} if package == "port" else {}
        client = create_app(store, str(folder), "pca", jobs=jobs, **extra).test_client()
        gate = threading.Event()
        jobs.submit("hold", gate.wait, job_class="device")
        wait_running(jobs, "hold")
        jobs.submit("queued", lambda: None, job_class="device")
        response = client.post("/images/numbers", json={"pca_filename": "img", "label_name": None})
        answers[package] = (*answer(response), response.headers.get("Retry-After"), sorted(
            path.name for path in folder.iterdir()
        ))
        gate.set()
        jobs.wait("queued", timeout=10)
    assert answers["port"] == answers["jax"]
    assert answers["port"][:2] == (429, {"result": "queue_full", "job_class": "device", "retry_after_s": 2})
    assert answers["port"][3] == []
