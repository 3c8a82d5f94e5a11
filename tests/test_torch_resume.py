"""Crash resume on the port: the JAX package's ``tests/test_resume.py``,
every class, run on the port's modules, and the resume paths the
reference's file does not reach.

The reference's source is read and run here with its module paths
pointed at the port (``learningorchestra_tpu_torch/ml/progress.py``,
``sched/journal.py``, ``sched/recovery.py``, ``ml/builder.py``): the
progress sink (round trip, the ``every`` grid, kind, stale-key and
corrupt-artifact deletion), the restart-stable collection fingerprint,
``device_restore`` (torch tensors for the reference's jnp template),
the lr fit killed at segment 2 and resumed bit-identical to an
uninterrupted one, the stale artifact that restarts clean, the journal's
``progress`` fold, recovery's resume and orphan paths, partial results,
the resumed build's skips and the knobs. Builds and fits run on the CPU
(``device="cpu"``).

Added here: the artifact format is the reference's in both directions
(an artifact either package's sink writes, the other's reads to the
same arrays and scalars); the gb fit resumed from a mid-fit artifact is
bit-identical to an uninterrupted one and skips the saved chunks, a
foreign key restarts it clean; an artifact from another device (the
key's layout component) restarts a build's fits clean; the
``fit.segment`` fault point stops a fit right after a durable save.
"""

import os
import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learningorchestra_tpu.ml import progress as jax_progress  # noqa: E402
from learningorchestra_tpu_torch.core.store import InMemoryStore as _PortStore  # noqa: E402
from learningorchestra_tpu_torch.ml import base as port_base  # noqa: E402
from learningorchestra_tpu_torch.ml import progress as port_progress  # noqa: E402

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_resume.py")

_source = REFERENCE_TESTS.read_text().replace(
    "learningorchestra_tpu.", "learningorchestra_tpu_torch."
)
for _old, _new in (
    # the template: torch tensors where the reference builds jnp arrays
    (
        "        import jax.numpy as jnp\n\n"
        "        return (jnp.zeros((2, 3), jnp.float32), jnp.zeros((3,), jnp.float32))",
        "        return (torch.zeros((2, 3), dtype=torch.float32), torch.zeros((3,), dtype=torch.float32))",
    ),
    # the fits and builds run on the CPU
    ("LogisticRegression(max_iter=100, tol=tol)", 'LogisticRegression(max_iter=100, tol=tol, device="cpu")'),
    ("LogisticRegression(max_iter=50, tol=1e-12)", 'LogisticRegression(max_iter=50, tol=1e-12, device="cpu")'),
    ("        classifiers,\n        **kwargs,\n", '        classifiers,\n        device="cpu",\n        **kwargs,\n'),
    # a port model's parameters are its w and b tensors
    ("jax.tree.leaves(fitted.params)", "_params(fitted)"),
    ("jax.tree.leaves(control.params)", "_params(control)"),
    ("jax.tree.leaves(refit.params)", "_params(refit)"),
    ("        import jax\n\n", ""),
):
    assert _old in _source, _old
    _source = _source.replace(_old, _new)
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def _params(model):
    """A port lr model's parameters in the reference's leaf order."""
    return [model.b, model.w]


@pytest.fixture()
def store():
    return _PortStore()


def test_the_reference_tests_run_on_the_port():
    """The classes above use the port's modules, and none of them is
    lost in the rewrite."""
    from learningorchestra_tpu_torch.ml import progress

    assert ProgressSink is progress.ProgressSink  # noqa: F821
    assert "learningorchestra_tpu." not in _source and "jax" not in _source
    classes = [name for name in globals() if name.startswith("Test")]
    assert len(classes) == 9, classes


ARRAYS = [
    np.arange(6.0).reshape(2, 3),
    np.array([1, 2], np.int32),
    np.linspace(0, 1, 5, dtype=np.float32),
]
SCALARS = {"iters": 25, "max_iter": 100, "l2": 0.0, "history": [0.5, 0.25]}


@pytest.mark.parametrize(
    "writer, reader",
    [(jax_progress, port_progress), (port_progress, jax_progress)],
    ids=["reference-to-port", "port-to-reference"],
)
def test_artifact_format_is_the_references(tmp_path, writer, reader):
    """An artifact one package's sink writes, the other's reads to the
    same arrays (values and dtypes), segment and scalars."""
    path = str(tmp_path / "m.progress")
    writer.ProgressSink(path, dict(META)).save("logistic", 3, ARRAYS, SCALARS)  # noqa: F821
    segment, arrays, scalars = reader.ProgressSink(path, dict(META)).load("logistic")  # noqa: F821
    assert segment == 3 and scalars == SCALARS
    assert len(arrays) == len(ARRAYS)
    for got, want in zip(arrays, ARRAYS):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_lr_artifact_leaves_are_the_references_order(tmp_path):
    """A saved lr segment holds ``(params, opt_state)`` in
    ``checkpoint.LBFGS_LEAVES`` order, then the losses, so
    ``lbfgs_state_from_arrays`` reads it back to the resumed state."""
    from learningorchestra_tpu_torch.ml.checkpoint import LBFGS_LEAVES, lbfgs_state_from_arrays
    from learningorchestra_tpu_torch.ml.logistic import LogisticRegression

    rng = np.random.default_rng(5)
    X = rng.random((64, 3))
    y = (X[:, 0] > 0.5).astype(np.int64)
    path = str(tmp_path / "m.progress")
    with port_progress.bind_sink(port_progress.ProgressSink(path, dict(META))):  # noqa: F821
        model = LogisticRegression(max_iter=50, tol=1e-12, device="cpu").fit(X, y)
    segment, arrays, scalars = port_progress.ProgressSink(path, dict(META)).load("logistic")  # noqa: F821
    assert len(arrays) == len(LBFGS_LEAVES) + 1
    W, b, state = lbfgs_state_from_arrays(arrays[:-1], device="cpu")
    torch.testing.assert_close(W, model.w, rtol=0, atol=0)
    torch.testing.assert_close(b, model.b, rtol=0, atol=0)
    assert state["head"].dtype == torch.int32 and state["filled"].dtype == torch.int32
    assert arrays[-1].shape == (segment * scalars["iters"],)


def _gb_data(seed=3, rows=200, features=4):
    rng = np.random.default_rng(seed)
    X = rng.random((rows, features))
    y = (X[:, 0] + 0.3 * rng.random(rows) > 0.65).astype(np.int64)
    return X, y


def _gb_fit(X, y):
    from learningorchestra_tpu_torch.ml.trees import GBTClassifier

    return GBTClassifier(rounds=6, max_depth=3, device="cpu").fit(X, y)


def _gb_tensors(model):
    return [model.features_heap, model.thresholds_heap, model.leaf_values]


@pytest.fixture()
def gb_chunks(monkeypatch):
    """The per-segment budget cut so a 6-round gb fit of 200 rows runs in
    three chunks of two rounds (``LO_PROGRAM_ROW_STEPS`` scaled down)."""
    monkeypatch.setattr(port_base, "_PROGRAM_BUDGET_SCALE", 2.5e-6)
    assert port_base.segment_steps(6, 200, 40e6, 4) == 2


def test_gb_resumed_fit_matches_uninterrupted(tmp_path, gb_chunks):
    """Kill at chunk 1 of 3: the resumed fit skips one chunk and lands on
    the uninterrupted fit's heaps and leaf values, bit for bit."""
    X, y = _gb_data()
    control = _gb_fit(X, y)
    path = str(tmp_path / "gb.progress")
    aside = str(tmp_path / "chunk1.progress")
    segments = []

    def record(segment):
        segments.append(segment)
        if segment == 1:
            shutil.copyfile(path, aside)

    with port_progress.bind_sink(port_progress.ProgressSink(path, dict(META), on_segment=record)):  # noqa: F821
        uninterrupted = _gb_fit(X, y)
    assert segments == [1, 2, 3]
    shutil.copyfile(aside, path)
    skipped = _counter_value("lo_build_segments_skipped_total")  # noqa: F821
    saved = _counter_value("lo_build_segments_saved_total")  # noqa: F821
    with port_progress.bind_sink(port_progress.ProgressSink(path, dict(META))):  # noqa: F821
        resumed = _gb_fit(X, y)
    assert _counter_value("lo_build_segments_skipped_total") - skipped == 1  # noqa: F821
    assert _counter_value("lo_build_segments_saved_total") - saved == 2  # noqa: F821
    for fitted in (uninterrupted, resumed):
        assert fitted.f0 == control.f0
        for got, want in zip(_gb_tensors(fitted), _gb_tensors(control)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("change", ["meta", "rounds"])
def test_gb_foreign_artifact_restarts_clean(tmp_path, gb_chunks, change):
    """A gb artifact under another key (the sink's, or the fit's own
    hyperparameters) is deleted and the fit restarts from round 0."""
    from learningorchestra_tpu_torch.ml.trees import GBTClassifier

    X, y = _gb_data(seed=4)
    control = _gb_fit(X, y)
    path = str(tmp_path / "gb.progress")
    with port_progress.bind_sink(port_progress.ProgressSink(path, dict(META))):  # noqa: F821
        if change == "rounds":
            GBTClassifier(rounds=4, max_depth=3, device="cpu").fit(X, y)
        else:
            _gb_fit(X, y)
    assert os.path.exists(path)
    meta = dict(META, test_fp="d" * 16) if change == "meta" else dict(META)  # noqa: F821
    skipped = _counter_value("lo_build_segments_skipped_total")  # noqa: F821
    with port_progress.bind_sink(port_progress.ProgressSink(path, meta)):
        refit = _gb_fit(X, y)
    assert _counter_value("lo_build_segments_skipped_total") == skipped  # noqa: F821
    for got, want in zip(_gb_tensors(refit), _gb_tensors(control)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fit_segment_fault_stops_after_a_durable_save(tmp_path):
    """The ``fit.segment`` point: an error there ends the fit right after
    its first artifact landed; the same sink then resumes it to the
    uninterrupted model."""
    from learningorchestra_tpu_torch.ml.logistic import LogisticRegression

    rng = np.random.default_rng(13)
    X = rng.random((64, 4))
    y = (X[:, 2] > 0.5).astype(np.int64)
    control = LogisticRegression(max_iter=100, tol=1e-12, device="cpu").fit(X, y)
    sink = port_progress.ProgressSink(str(tmp_path / "m.progress"), dict(META))  # noqa: F821
    faults.install("fit.segment", "error@1", where={"kind": "logistic"})  # noqa: F821
    with port_progress.bind_sink(sink), pytest.raises(faults.FaultInjected):  # noqa: F821
        LogisticRegression(max_iter=100, tol=1e-12, device="cpu").fit(X, y)
    assert sink.load("logistic")[0] == 1
    skipped = _counter_value("lo_build_segments_skipped_total")  # noqa: F821
    with port_progress.bind_sink(sink):
        resumed = LogisticRegression(max_iter=100, tol=1e-12, device="cpu").fit(X, y)
    assert _counter_value("lo_build_segments_skipped_total") - skipped == 1  # noqa: F821
    for got, want in zip(_params(resumed), _params(control)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_build_refuses_an_artifact_of_another_device(titanic_store, tmp_path, monkeypatch):  # noqa: F811
    """The key's layout component names the device: an artifact a build
    saved on one device is deleted, not resumed, by a build on another,
    which refits from scratch to the same metrics."""
    from learningorchestra_tpu_torch.ml import builder

    models_dir = str(tmp_path / "models")
    first = _build(titanic_store, ["lr"], models_dir=models_dir)  # noqa: F821
    artifact = port_progress.progress_path(models_dir, "titanic_test_prediction_lr")
    assert not os.path.exists(artifact)  # a finished member discards its artifact
    # a mid-fit artifact left by a build on another device
    meta = {
        "training_fp": port_progress.collection_fingerprint(titanic_store, "titanic_train"),
        "test_fp": port_progress.collection_fingerprint(titanic_store, "titanic_test"),
        "dtype_policy": "f32",
        "mesh": "cuda:NVIDIA H100 80GB HBM3",
    }
    port_progress.ProgressSink(artifact, meta).save("logistic", 1, [np.zeros(2)], {})
    keys = []
    real = port_progress.ProgressSink.load

    def load(sink, kind):
        keys.append(sink.meta["mesh"])
        return real(sink, kind)

    monkeypatch.setattr(port_progress.ProgressSink, "load", load)
    skipped = _counter_value("lo_build_segments_skipped_total")  # noqa: F821
    titanic_store.drop("titanic_test_prediction_lr")
    second = _build(titanic_store, ["lr"], models_dir=models_dir)  # noqa: F821
    assert keys and set(keys) == {builder._device_key(torch.device("cpu"))} == {"cpu"}
    assert _counter_value("lo_build_segments_skipped_total") == skipped  # noqa: F821
    assert not os.path.exists(artifact)
    assert second[0]["accuracy"] == first[0]["accuracy"]
    assert second[0]["F1"] == first[0]["F1"]


@pytest.mark.parametrize(
    "mutation",
    ["number", "string", "new row", "metadata"],
)
def test_fingerprint_covers_every_part_of_a_collection(mutation):
    """The port's columnar digest changes with any value of a data row
    (numeric or string), with the rows themselves and with the metadata
    document, and not without a change."""
    store = _PortStore()
    store.insert_one("drill", {"_id": 0, "filename": "drill", "finished": True})
    store.insert_many("drill", [{"_id": i, "f1": i * 0.5, "s": f"v{i}"} for i in range(1, 6)])
    before = port_progress.collection_fingerprint(store, "drill")
    assert port_progress.collection_fingerprint(store, "drill") == before
    if mutation == "number":
        store.update_one("drill", {"_id": 3}, {"f1": 1.5000001})
    elif mutation == "string":
        store.update_one("drill", {"_id": 3}, {"s": "w3"})
    elif mutation == "new row":
        store.insert_one("drill", {"_id": 6, "f1": 3.0, "s": "v6"})
    else:
        store.update_one("drill", {"_id": 0}, {"finished": False})
    assert port_progress.collection_fingerprint(store, "drill") != before
