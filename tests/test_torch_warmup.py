"""The publish-time serve warmup and the publish hook on the port
(``compile/__init__.py``, ``compile/warmup.py``).

The JAX package's ``TestWarmup`` and ``TestPublishHook``
(``tests/test_compile.py``) are read out of its source and run here on
the port's modules. The rest of that file tests the XLA precompile plane,
which the port does not have. Edits: ``make_classifier(...)`` and
``warm_artifact(path)`` gain ``device="cpu"`` (the port's entry points
default to the CUDA card).

Then the port's own wiring, on the CPU:

- the width: lr's ``w`` and nb's ``theta`` give it, a tree model with no
  width is pinned and answers False, a given width runs the forward at
  ``grid_size(1, max_batch)`` rows;
- ``compile_source``: a kernel library loaded inside a warmup books
  ``lo_compile_events_total{source="aot"}``, elsewhere ``"jit"``, and the
  lane is the thread's own;
- the model_builder app's handler: a ``warmup:<file>`` DEVICE job at
  priority -5 for a checkpoint published into its ``models_dir`` (none
  for one elsewhere), which pins the model so the first predict is a
  registry hit; a duplicate publication is swallowed;
- a build publishes each checkpoint with its training width, as the JAX
  package's build does, and the app then warms all five.
"""

import os
import pathlib
import threading
import time

import numpy as np
import pytest

from learningorchestra_tpu import compile as jax_compile
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore
from learningorchestra_tpu.ml import builder as jax_builder
from learningorchestra_tpu_torch import compile as lo_compile
from learningorchestra_tpu_torch.compile import warmup
from learningorchestra_tpu_torch.core import ingest
from learningorchestra_tpu_torch.core.jobs import JobManager
from learningorchestra_tpu_torch.core.store import ROW_ID, InMemoryStore
from learningorchestra_tpu_torch.ml import builder as port_builder
from learningorchestra_tpu_torch.ml.base import make_classifier
from learningorchestra_tpu_torch.ml.checkpoint import checkpoint_path, save_model
from learningorchestra_tpu_torch.ops import dtype
from learningorchestra_tpu_torch.serve import ServePlane
from learningorchestra_tpu_torch.services import model_builder
from learningorchestra_tpu_torch.telemetry import profile
from learningorchestra_tpu_torch.utils.shapegrid import grid_size
from tests.conftest import TITANIC_LIKE_CSV
from tests.test_frame import DOCUMENTED_PREPROCESSOR

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_compile.py")
EDITS = (
    ('save_model(make_classifier("lr").fit(X, y), path)', 1, 'save_model(make_classifier("lr", device="cpu").fit(X, y), path)'),
    ('save_model(make_classifier("dt").fit(X, y), path)', 1, 'save_model(make_classifier("dt", device="cpu").fit(X, y), path)'),
    ("assert warm_artifact(path) is", 2, 'assert warm_artifact(path, device="cpu") is'),
)

_full = REFERENCE_TESTS.read_text()
_source = _full[_full.index("class TestWarmup:"):_full.index("_DRILL_CHILD = ")]
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_tests_run_on_the_port():
    assert "learningorchestra_tpu." not in _source
    assert "class TestPublishHook" in _source and "class TestWarmup" in _source
    assert TestWarmup and TestPublishHook  # noqa: F821


@pytest.fixture()
def restore_handler():
    previous = lo_compile.set_publish_handler(None)
    lo_compile.set_publish_handler(previous)
    yield
    lo_compile.set_publish_handler(previous)


def _cpu_plane():
    return ServePlane(capacity=10**9, window_s=0.0, max_batch=8, inbox_cap=32, device="cpu")


def _fitted(kind, tmp_path, features=5):
    rng = np.random.default_rng(3)
    X = rng.random((48, features)).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.int64)
    path = str(tmp_path / f"{kind}.model")
    save_model(make_classifier(kind, device="cpu").fit(X, y), path)
    return path


class _Recorder:
    """Wraps a model's ``predict_both`` to record the rows it saw and the
    compile lane it ran under."""

    def __init__(self, plane, path):
        self.model = plane.registry.get(path)
        self.calls = []
        original = self.model.predict_both

        def recorded(rows):
            self.calls.append((np.asarray(rows).shape, profile.current_compile_source()))
            return original(rows)

        self.model.predict_both = recorded


@pytest.mark.parametrize("kind,width", [("lr", True), ("nb", True), ("dt", False), ("rf", False), ("gb", False)])
def test_the_width_comes_from_the_parameters_where_they_hold_it(tmp_path, kind, width):
    path = _fitted(kind, tmp_path)
    plane = _cpu_plane()
    try:
        recorder = _Recorder(plane, path)
        assert warmup.warm_artifact(path, serve=plane, max_batch=8) is width
        assert recorder.calls == ([((grid_size(1, 8), 5), "aot")] if width else [])
        assert plane.registry.stats()["models"] == 1   # pinned either way
        assert warmup.warm_artifact(path, features=5, serve=plane, max_batch=32) is True
        assert recorder.calls[-1] == ((grid_size(1, 32), 5), "aot")
    finally:
        plane.close()


def test_a_library_loaded_in_a_warmup_books_aot():
    metric = profile._flow_metrics()["compile_events"]
    before = {source: metric.value("hit", source) for source in ("aot", "jit")}
    seen = {}

    def other_thread():
        seen["source"] = profile.current_compile_source()

    with profile.compile_source("aot", "warmup:x.model"):
        profile.account_compile("hit")
        thread = threading.Thread(target=other_thread)
        thread.start()
        thread.join(timeout=10)
        with profile.compile_source("jit"):
            assert profile.current_compile_source() == "jit"
        assert profile.current_compile_source() == "aot"
    profile.account_compile("hit")
    assert profile.current_compile_source() == "jit" and seen == {"source": "jit"}
    assert metric.value("hit", "aot") == before["aot"] + 1
    assert metric.value("hit", "jit") == before["jit"] + 1


def _wait_terminal(jobs, name, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        record = jobs.get(name)
        if record is not None and record.state in ("finished", "failed", "cancelled"):
            return record
        time.sleep(0.02)
    raise AssertionError(f"{name} never ended: {jobs.get(name)}")


def test_the_app_warms_what_it_publishes(tmp_path, restore_handler):
    models_dir = tmp_path / "models"
    models_dir.mkdir()
    path = _fitted("lr", models_dir)
    elsewhere = _fitted("nb", tmp_path)
    plane = _cpu_plane()
    try:
        jobs = JobManager()
        app = model_builder.create_app(
            InMemoryStore(), models_dir=str(models_dir), serve=plane, device="cpu", jobs=jobs
        )
        lo_compile.checkpoint_published(path, 5)
        record = _wait_terminal(jobs, "warmup:lr.model")
        assert record.state == "finished" and record.job_class == "device" and record.priority == -5
        assert plane.registry.stats()["models"] == 1
        misses = plane.registry.misses
        answer = app.test_client().post("/models/lr/predict", json={"rows": [[0.5] * 5]})
        assert answer.status_code == 200
        assert plane.registry.misses == misses and plane.registry.hits >= 1
        lo_compile.checkpoint_published(elsewhere, 5)
        assert jobs.get("warmup:nb.model") is None
    finally:
        plane.close()


def test_a_duplicate_publication_is_swallowed(tmp_path, restore_handler):
    models_dir = tmp_path / "models"
    models_dir.mkdir()
    path = _fitted("lr", models_dir)
    gate = threading.Event()
    plane = _cpu_plane()
    try:
        jobs = JobManager()
        model_builder.create_app(InMemoryStore(), models_dir=str(models_dir), serve=plane, device="cpu", jobs=jobs)
        # hold the device class so the first warmup stays queued
        jobs.submit("hold", gate.wait, 30, job_class="device")
        lo_compile.checkpoint_published(path, 5)
        lo_compile.checkpoint_published(path, 5)   # DuplicateJobError, swallowed
        assert jobs.get("warmup:lr.model").state == "pending"
        gate.set()
        assert _wait_terminal(jobs, "warmup:lr.model").state == "finished"
    finally:
        gate.set()
        plane.close()


def _titanic(store_cls, tmp_path, convert, ingest_one):
    path = tmp_path / "titanic.csv"
    path.write_text(TITANIC_LIKE_CSV)
    store = store_cls()
    for name in ("titanic_train", "titanic_test"):
        ingest_one(store, name, str(path))
        convert(store, name, {
            field: "number" for field in ("PassengerId", "Survived", "Pclass", "Age", "SibSp", "Parch", "Fare")
        })
    return store


def test_a_build_publishes_as_the_references(tmp_path, restore_handler):
    """Each package's build publishes each classifier's checkpoint once,
    with the training width; the port's app then warms all five."""
    from learningorchestra_tpu.core import ingest as jax_ingest
    from learningorchestra_tpu.ops import dtype as jax_dtype

    def port_ingest(store, name, path):
        ingest.write_ingest_metadata(store, name, path)
        ingest.ingest_csv(store, name, path)

    def jax_ingest_one(store, name, path):
        jax_ingest.write_ingest_metadata(store, name, path)
        jax_ingest.ingest_csv(store, name, path)

    names = ["lr", "dt", "rf", "gb", "nb"]
    published = {"port": [], "jax": []}
    previous_jax = jax_compile.set_publish_handler(
        lambda path, features: published["jax"].append((os.path.basename(path), features))
    )
    try:
        (tmp_path / "jax").mkdir()
        jax_store = _titanic(JaxStore, tmp_path / "jax", jax_dtype.convert_field_types, jax_ingest_one)
        jax_builder.build_model(
            jax_store, "titanic_train", "titanic_test", DOCUMENTED_PREPROCESSOR, names,
            models_dir=str(tmp_path / "jax_models"),
        )
    finally:
        jax_compile.set_publish_handler(previous_jax)
    (tmp_path / "port").mkdir()
    store = _titanic(InMemoryStore, tmp_path / "port", dtype.convert_field_types, port_ingest)
    lo_compile.set_publish_handler(lambda path, features: published["port"].append((os.path.basename(path), features)))
    port_builder.build_model(
        store, "titanic_train", "titanic_test", DOCUMENTED_PREPROCESSOR, names,
        device="cpu", models_dir=str(tmp_path / "port_models"),
    )
    assert sorted(published["port"]) == sorted(published["jax"])
    assert len(published["port"]) == 5 and {features for _, features in published["port"]} != {None}

    # the app's handler warms every checkpoint of a build through its route
    plane = _cpu_plane()
    models_dir = tmp_path / "served"
    try:
        jobs = JobManager()
        app = model_builder.create_app(store, models_dir=str(models_dir), serve=plane, device="cpu", jobs=jobs)
        client = app.test_client()
        answer = client.post("/models", json={
            "training_filename": "titanic_train", "test_filename": "titanic_test",
            "preprocessor_code": DOCUMENTED_PREPROCESSOR, "classificators_list": names,
        })
        assert answer.status_code == 201
        for name in names:
            artifact = f"titanic_test_prediction_{name}.model"
            assert _wait_terminal(jobs, f"warmup:{artifact}").state == "finished"
        assert plane.registry.stats()["models"] == 5
        assert store.find_one("titanic_test_prediction_lr", {ROW_ID: 0})["classificator"] == "lr"
    finally:
        plane.close()
