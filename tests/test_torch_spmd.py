"""The port's SPMD dispatcher (``parallel/spmd.py``) and the runner's
multi-host mode, on gloo ranks on the CPU.

- *One process*: the fast path and its metrics; the one-way poisoned
  latch after an error in a job and after a watchdog timeout (the
  broadcast stubbed, the world faked at two); the envelope's correlation
  id on both sides; the heartbeat and the shutdown with no group.
- *Two processes* (``tests/torch_rank_child.py``, one pair a job):
  ``_broadcast_json`` of ``{}``, unicode and a payload over 1 MB; the
  store stack, the counterpart of the reference's
  ``tests/test_multihost.py::test_spmd_dispatch_through_store_stack``
  with ``tests/spmd_worker.py``: a store server and two ranks of
  ``runner.make_dispatcher``, the coordinator submitting a build of lr
  and dt, a batch prediction from the lr checkpoint and a PCA image.
  Each collection holds 120 rows plus its metadata, written by the
  coordinator alone (the worker makes no store write and no PNG); the
  predictions equal the same build in one process, and the same job on
  the JAX package's dispatcher (one process: its fast path) at
  ``tests/test_torch_builder.py``'s tolerances (labels equal; dt
  probabilities 1e-6, lr 1e-4); the worker's log names each job's op
  and correlation id. The death drill, the counterpart of
  ``test_worker_death_fails_cleanly_then_recovers`` with
  ``tests/spmd_death.py``: the worker exits mid-job, the job errors (a
  timeout or gloo's error for the dead peer), the next submit is
  refused as poisoned, and a fresh pair serves the job.
- *The runner*: ``main`` refuses the multi-host mode without
  ``LO_STORE_URL`` or ``LO_MODELS_DIR`` with the reference's messages;
  the build replay refuses several processes; with a dispatcher,
  model_builder's build and batch predictions and the images' creates
  are submitted through it.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_rank_child as child  # noqa: E402
from learningorchestra_tpu_torch.parallel import spmd  # noqa: E402
from learningorchestra_tpu_torch.telemetry import tracing  # noqa: E402

ROWS = 120
STACK_CID = "spmd-stack"


# --------------------------------------------------------------------------
# One process
# --------------------------------------------------------------------------

def job_count(op: str, outcome: str) -> float:
    return spmd._registry_metrics()["jobs"].value(op, outcome)


@pytest.fixture()
def two_ranks(monkeypatch):
    """The coordinator of a faked world of two, its broadcasts recorded."""
    monkeypatch.setattr(spmd, "process_count", lambda: 2)
    monkeypatch.setattr(spmd, "process_index", lambda: 0)
    sent = []
    monkeypatch.setattr(spmd.SpmdDispatcher, "_broadcast", lambda self, obj=None: sent.append(obj))
    return sent


def test_one_process_runs_the_handler_directly_and_counts_it(monkeypatch):
    monkeypatch.setattr(spmd, "_broadcast_json", lambda *a, **k: pytest.fail("broadcast in one process"))
    dispatcher = spmd.SpmdDispatcher()
    seen = []
    dispatcher.register("add", lambda payload: seen.append(payload) or payload["a"] + 1)
    dispatcher.register("fail", lambda payload: 1 / 0)
    ok, error = job_count("add", "ok"), job_count("fail", "error")
    histogram = spmd._registry_metrics()["seconds"].labels("add")
    observed = histogram.count
    trace = tracing.Trace("one-cid")
    with tracing.activate(trace):
        assert dispatcher.submit("add", {"a": 41}) == 42
    assert seen == [{"a": 41}] and [span.name for span in trace.spans] == ["spmd:add"]
    assert job_count("add", "ok") == ok + 1 and histogram.count == observed + 1
    with pytest.raises(ZeroDivisionError):
        dispatcher.submit("fail", {})
    assert job_count("fail", "error") == error + 1
    # no latch in one process: there is no stream to fall out of step
    assert dispatcher.submit("add", {"a": 1}) == 2
    dispatcher.start_heartbeat(0.01)
    dispatcher.shutdown_workers()


@pytest.mark.parametrize("timeout", [0, 30])
def test_an_error_in_a_job_poisons_the_dispatcher(two_ranks, timeout):
    dispatcher = spmd.SpmdDispatcher()
    dispatcher.register("fail", lambda payload: (_ for _ in ()).throw(ValueError("mid-collective")))
    dispatcher.register("ok", lambda payload: "fine")
    with pytest.raises(ValueError, match="mid-collective"):
        dispatcher.submit("fail", {}, timeout=timeout)
    assert spmd._registry_metrics()["poisoned"].value() == 1
    with pytest.raises(spmd.SpmdRuntimePoisonedError, match="'fail' failed mid-collective"):
        dispatcher.submit("ok", {}, timeout=timeout)
    assert [envelope["op"] for envelope in two_ranks] == ["fail"]   # the refused job broadcast nothing
    dispatcher.shutdown_workers()   # a poisoned stream gets no shutdown broadcast
    assert len(two_ranks) == 1


def test_a_watchdog_timeout_poisons_the_dispatcher(two_ranks):
    release = threading.Event()
    dispatcher = spmd.SpmdDispatcher()
    dispatcher.register("hang", lambda payload: release.wait(30))
    dispatcher.register("ok", lambda payload: "fine")
    trips = spmd._registry_metrics()["watchdog_trips"].value()
    timeouts = job_count("hang", "timeout")
    try:
        with pytest.raises(spmd.SpmdTimeoutError, match="timed out"):
            dispatcher.submit("hang", {}, timeout=0.2)
        assert spmd._registry_metrics()["watchdog_trips"].value() == trips + 1
        assert job_count("hang", "timeout") == timeouts + 1
        with pytest.raises(spmd.SpmdRuntimePoisonedError):
            dispatcher.submit("ok", {})
    finally:
        release.set()
    from learningorchestra_tpu_torch.sched.policy import is_transient

    assert is_transient(spmd.SpmdTimeoutError("x")) and not is_transient(spmd.SpmdRuntimePoisonedError("x"))


def test_the_envelope_carries_the_coordinators_correlation_id(two_ranks, monkeypatch):
    dispatcher = spmd.SpmdDispatcher()
    dispatcher.register("ok", lambda payload: payload["n"])
    with tracing.activate(tracing.Trace("coordinator-cid")):
        assert dispatcher.submit("ok", {"n": 3}) == 3
    assert two_ranks == [{"op": "ok", "payload": {"n": 3}, "cid": "coordinator-cid"}]
    dispatcher.shutdown_workers()
    assert two_ranks[-1] == {"op": spmd._SHUTDOWN_OP}

    # the worker's half: its spans carry the coordinator's id
    monkeypatch.setattr(spmd, "process_index", lambda: 1)
    jobs = iter([two_ranks[0], {"op": spmd._PING_OP, "payload": {}, "cid": None}, {"op": spmd._SHUTDOWN_OP}])
    worker = spmd.SpmdDispatcher()
    monkeypatch.setattr(spmd.SpmdDispatcher, "_broadcast", lambda self, obj=None: next(jobs))
    seen = []
    worker.register("ok", lambda payload: seen.append((tracing.current_correlation_id(), payload)))
    worker.run_worker_loop()
    assert seen == [("coordinator-cid", {"n": 3})]
    trace = tracing.recall_trace("coordinator-cid")
    assert trace is not None and trace.spans[0].name == "spmd:ok"


def test_a_failed_job_ends_the_worker(monkeypatch):
    monkeypatch.setattr(spmd, "process_index", lambda: 1)
    jobs = iter([{"op": "boom", "payload": {}, "cid": "c"}, {"op": spmd._SHUTDOWN_OP}])
    monkeypatch.setattr(spmd.SpmdDispatcher, "_broadcast", lambda self, obj=None: next(jobs))
    worker = spmd.SpmdDispatcher()
    worker.register("boom", lambda payload: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        worker.run_worker_loop()


def test_the_names_are_exported():
    from learningorchestra_tpu_torch import parallel

    for name in ("SpmdDispatcher", "SpmdJobError", "SpmdTimeoutError", "SpmdRuntimePoisonedError"):
        assert getattr(parallel, name) is getattr(spmd, name)
    assert issubclass(spmd.SpmdTimeoutError, spmd.SpmdJobError)
    assert issubclass(spmd.SpmdRuntimePoisonedError, spmd.SpmdJobError)
    assert issubclass(spmd.SpmdJobError, RuntimeError)
    assert (spmd.process_count(), spmd.process_index()) == (1, 0)


# --------------------------------------------------------------------------
# Two processes
# --------------------------------------------------------------------------

def test_broadcast_json_round_trips_over_two_ranks(tmp_path):
    results, _ = child.run_ranks("broadcast", 2, tmp_path, timeout_s=60)
    assert [result["received"] for result in results] == [child.BROADCAST_PAYLOADS] * 2


def _spmd_csv(folder) -> str:
    """The reference test's 120 rows: two features and a label."""
    path = os.path.join(str(folder), "spmd_train.csv")
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 2, ROWS)
    with open(path, "w") as handle:
        handle.write("f1,f2,label\n")
        for label in labels:
            handle.write(f"{label * 2 + rng.randn():.4f},{-label + rng.randn():.4f},{label}\n")
    return "file://" + path


def _ingested(store, url, package):
    ingest = __import__(f"{package}.core.ingest", fromlist=["ingest_csv"])
    dtype = __import__(f"{package}.ops.dtype", fromlist=["convert_field_types"])
    ingest.write_ingest_metadata(store, "spmd_train", url)
    ingest.ingest_csv(store, "spmd_train", url)
    dtype.convert_field_types(store, "spmd_train", {"f1": "number", "f2": "number", "label": "number"})
    return store


def _predictions(store, name) -> tuple:
    documents = sorted(
        (doc for doc in store.find(name, {}) if doc.get("_id") != 0), key=lambda doc: doc["_id"])
    return (np.array([doc["prediction"] for doc in documents]),
            np.array([doc["probability"] for doc in documents], dtype=np.float64))


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """The store stack over two ranks, and the same jobs in one process
    (the port's, and the JAX package's dispatcher)."""
    from learningorchestra_tpu_torch.core.store import InMemoryStore
    from learningorchestra_tpu_torch.core.store_service import RemoteStore, create_store_app
    from learningorchestra_tpu_torch.utils.web import ServerThread

    folder = tmp_path_factory.mktemp("spmd_stack")
    url = _spmd_csv(folder)
    server = ServerThread(create_store_app(InMemoryStore()), "127.0.0.1", 0).start()
    try:
        store_url = f"http://127.0.0.1:{server.port}"
        remote = _ingested(RemoteStore(store_url), url, "learningorchestra_tpu_torch")
        models_dir = os.path.join(str(folder), "models")
        results, logs = child.run_ranks("stack", 2, folder, store_url, models_dir,
                                        os.path.join(str(folder), "images"), STACK_CID, timeout_s=240)
        stored = {
            name: (remote.count(name), remote.find_one(name, {"_id": 0}), _predictions(remote, name))
            for name in ("spmd_train_prediction_lr", "spmd_train_prediction_dt", "spmd_predicted")
        }
    finally:
        server.stop()
    return {"results": results, "logs": logs, "stored": stored, "folder": folder, "url": url,
            "models_dir": models_dir}


def _one_process_build(stack, package: str) -> dict:
    """The same build of lr and dt in one process, on the package's own
    dispatcher (one process: the handler runs directly)."""
    runner = __import__(f"{package}.services.runner", fromlist=["make_dispatcher"])
    store_module = __import__(f"{package}.core.store", fromlist=["InMemoryStore"])
    store = _ingested(store_module.InMemoryStore(), stack["url"], package)
    folder = os.path.join(str(stack["folder"]), f"one_{package}")
    extra = {"device": "cpu"} if package.endswith("_torch") else {}
    dispatcher = runner.make_dispatcher(store, os.path.join(folder, "images"), **extra)
    dispatcher.submit("build_model", {
        "training_filename": "spmd_train", "test_filename": "spmd_train",
        "preprocessor_code": child.PREPROCESSOR, "classificators_list": ["lr", "dt"],
        "models_dir": os.path.join(folder, "models"),
    })
    return {name: _predictions(store, f"spmd_train_prediction_{name}") for name in ("lr", "dt")}


def test_the_build_is_written_once_by_the_coordinator(stack):
    for name in ("lr", "dt"):
        count, meta, _ = stack["stored"][f"spmd_train_prediction_{name}"]
        assert count == ROWS + 1   # 120 predictions + 1 metadata, written once
        assert meta["classificator"] == name and float(meta["accuracy"]) > 0.8
        assert meta["model_checkpoint"] == os.path.join(stack["models_dir"], f"spmd_train_prediction_{name}.model")
    coordinator, worker = stack["results"]
    assert worker["writes"] == {} and worker["images"] == []
    assert coordinator["writes"]["insert_one"] == 3   # the three metadata documents
    assert sorted(os.listdir(stack["models_dir"])) == ["spmd_train_prediction_dt.model",
                                                       "spmd_train_prediction_lr.model"]


def test_the_batch_prediction_and_the_image_are_written_once(stack):
    count, meta, (labels, probs) = stack["stored"]["spmd_predicted"]
    assert count == ROWS + 1 and meta["model_checkpoint"].endswith("spmd_train_prediction_lr.model")
    built_labels, built_probs = stack["stored"]["spmd_train_prediction_lr"][2]
    np.testing.assert_array_equal(labels, built_labels)
    np.testing.assert_array_equal(probs, built_probs)
    assert stack["results"][0]["images"] == [os.path.join("pca", "spmd_pca.png")]
    png = os.path.join(str(stack["folder"]), "images", "rank0", "pca", "spmd_pca.png")
    with open(png, "rb") as handle:
        assert handle.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("package", ["learningorchestra_tpu_torch", "learningorchestra_tpu"])
def test_the_build_over_ranks_equals_one_process(stack, package):
    one = _one_process_build(stack, package)
    tolerance = {"dt": 1e-6, "lr": 1e-4}
    for name in ("lr", "dt"):
        labels, probs = stack["stored"][f"spmd_train_prediction_{name}"][2]
        want_labels, want_probs = one[name]
        np.testing.assert_array_equal(labels, want_labels)
        if package.endswith("_torch") and name == "dt":
            np.testing.assert_array_equal(probs, want_probs)
        else:
            np.testing.assert_allclose(probs, want_probs, rtol=0, atol=tolerance[name])


def test_the_workers_log_names_each_jobs_op_and_correlation_id(stack):
    log = stack["logs"][1]
    for op in ("build_model", "predict_model", "embedding_image"):
        assert f"[spmd worker 1] job {op!r} (cid {STACK_CID}-{op})" in log
        assert f"spmd worker 1: job {op!r} done" in log


def _death(tmp_path, phase: str) -> dict:
    results, logs = child.run_ranks("death", 2, tmp_path / phase, phase, timeout_s=60, checked=[0])
    assert results[0] is not None, logs[0]
    return results[0]


def test_a_worker_death_fails_the_job_then_a_fresh_pair_recovers(tmp_path):
    drill = _death(tmp_path, "drill")
    assert drill["fit_before"] == 3   # a healthy collective: 1 + 2
    assert drill["death_job"] != "no-error", drill
    assert drill["after_death"] == "poisoned", drill
    assert _death(tmp_path, "recover")["fit_before"] == 3


# --------------------------------------------------------------------------
# The runner
# --------------------------------------------------------------------------

@pytest.fixture()
def multi_host(monkeypatch, tmp_path):
    """``main`` as it runs when ``initialize_from_env`` found a group."""
    from learningorchestra_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "initialize_from_env", lambda **kwargs: True)
    for name in ("LO_STORE_URL", "LO_MODELS_DIR", "LO_SERVICE", "LO_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("LO_DATA_DIR", str(tmp_path / "lo_data"))


def test_the_multi_host_mode_refuses_to_start_without_a_store_server(multi_host):
    from learningorchestra_tpu_torch.services.runner import main

    with pytest.raises(SystemExit) as refused:
        main(device="cpu")
    assert str(refused.value) == (
        "multi-host mode requires LO_STORE_URL: all processes must share one store server "
        "(python -m learningorchestra_tpu_torch.core.store_service)"
    )


def test_the_multi_host_mode_refuses_to_start_without_a_models_dir(multi_host, monkeypatch):
    from learningorchestra_tpu_torch.services.runner import main

    monkeypatch.setenv("LO_STORE_URL", "http://127.0.0.1:1")
    with pytest.raises(SystemExit) as refused:
        main(device="cpu")
    assert str(refused.value) == (
        "multi-host mode requires LO_MODELS_DIR pointing at a volume shared by all hosts "
        "(set it to '' to disable checkpointing)"
    )


def test_the_build_replay_refuses_several_processes(monkeypatch):
    from learningorchestra_tpu_torch.sched import recovery

    monkeypatch.setattr(spmd, "process_count", lambda: 2)
    with pytest.raises(RuntimeError, match=r"^build_model replay is single-host only \(process_count=2\)$"):
        recovery._build_model_replay(None, {"training_filename": "t"}, device="cpu")


class RecordingDispatcher:
    def __init__(self):
        self.submitted = []

    def submit(self, op, payload, timeout=None):
        self.submitted.append((op, payload))


def test_the_apps_submit_their_jobs_through_the_dispatcher(tmp_path):
    from learningorchestra_tpu_torch.core.jobs import JobManager
    from learningorchestra_tpu_torch.core.store import InMemoryStore
    from learningorchestra_tpu_torch.ml.checkpoint import checkpoint_path
    from learningorchestra_tpu_torch.services.runner import build_app

    store = InMemoryStore()
    for name in ("train", "test"):
        store.insert_one(name, {"_id": 0, "filename": name, "finished": True, "fields": ["f1", "label"]})
        store.insert_one(name, {"_id": 1, "f1": 1.0, "label": 0.0})
    models_dir = str(tmp_path / "models")
    os.makedirs(models_dir)
    with open(checkpoint_path(models_dir, "built"), "wb"):
        pass
    dispatcher, jobs = RecordingDispatcher(), JobManager()
    builder = build_app("model_builder", store, str(tmp_path / "images"), models_dir, jobs, "cpu",
                        dispatcher).test_client()
    body = {"training_filename": "train", "test_filename": "test", "preprocessor_code": "x = 1",
            "classificators_list": ["lr"]}
    assert builder.post("/models", json=body).status_code == 201
    answer = builder.post("/models/built/predictions", json={
        "training_filename": "train", "test_filename": "test", "preprocessor_code": "x = 1",
        "prediction_filename": "out"})
    assert answer.status_code == 201, answer.data
    for method in ("tsne", "pca"):
        app = build_app(method, store, str(tmp_path / "images"), models_dir, jobs, "cpu", dispatcher)
        answer = app.test_client().post("/images/train", json={f"{method}_filename": f"{method}_out",
                                                               "label_name": "label"})
        assert answer.status_code == 201, answer.data
    assert dispatcher.submitted[0] == ("build_model", {**body, "models_dir": models_dir})
    assert dispatcher.submitted[1] == ("predict_model", {
        "checkpoint_path": checkpoint_path(models_dir, "built"), "training_filename": "train",
        "test_filename": "test", "preprocessor_code": "x = 1", "prediction_filename": "out"})
    assert dispatcher.submitted[2:] == [
        ("embedding_image", {"parent_filename": "train", "label_name": "label",
                             "output_filename": f"{method}_out", "method": method})
        for method in ("tsne", "pca")
    ]
