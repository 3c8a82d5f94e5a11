"""The port's model build held against the JAX package's on the CPU.

The reference's ``tests/test_builder.py`` flow (``ingest_csv``, then
``convert_field_types``, then ``build_model``) runs through both
packages on the same CSV files, each into its own store, all five
classifiers. Two data sets:

- *titanic*: the Titanic-like CSV of ``tests/conftest.py`` (8 rows)
  with the documented preprocessor verbatim (``tests/test_frame.py``);
- *synthetic*: 1,024 training and 512 test rows of 6 uniform features
  and a noisy threshold label (``bench.py``'s shape, narrower), through
  ``bench.py``'s VectorAssembler preprocessor, the eval frame equal to
  the test frame (so the builder aliases them).

The classifiers are cut to a small size in both packages alike (the
builders' ``make_classifier`` patched): dt and rf depth 3, rf 4 trees,
gb 5 rounds of depth 3, lr 30 iterations; nb as it is.

Checked: the assembled feature matrices and label vectors are
bit-equal; the metadata documents and prediction rows have the
reference's fields and types (F1 and accuracy strings, ``fit_time`` a
float, the probability a list, no ``features``); labels are identical
and the metrics equal within 1e-6; the ``.model`` files each package
writes load in the other and predict the same labels; two concurrent
port builds complete and agree.

Probability tolerances are those of ``tests/test_torch_fit.py`` and
``tests/test_torch_linear.py``, and why:
- dt: 1e-6 (one float32 division of exact counts);
- rf: 1e-6, on the reference's draws: the port draws its bootstrap and
  feature scores from a ``torch.Generator``, so its ``fit`` is handed
  the reference's threefry draws here, as ``tests/test_torch_forest.py``
  does;
- gb: 1e-5 (float64 histogram sums in the port, float32 matmuls in the
  reference; sigmoid and log differ in their last bits);
- nb: 1e-5 absolute and relative, as ``tests/test_torch_serve.py`` and
  ``tests/test_torch_checkpoint.py`` hold nb (``tests/test_torch_linear.py``
  takes 1e-5 absolute alone): the reference's float32 joint
  log-likelihood rounds at its magnitude; on the synthetic test rows its
  probabilities lie up to 1.07e-5 from the float64 posterior of the same
  parameters, the port's (which centres theta) 2.3e-7;
- lr: 1e-4 (the tolerance the reference is held to against sklearn).
gb and lr are held to these on the synthetic set only. The titanic set
leaks its label into the features (the documented preprocessor
assembles every column) and has 7 training rows: its gb gains tie to
within float32 rounding at some roots (tree 8 splits on another
feature in each package) and its lr weights grow without bound until
the fit stops, so there the two packages' probabilities part by up to
3e-2 and 1e-3 while their labels agree.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learningorchestra_tpu.core import ingest as jax_ingest  # noqa: E402
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore  # noqa: E402
from learningorchestra_tpu.frame.pyspark_compat import run_preprocessor as jax_run_preprocessor  # noqa: E402
from learningorchestra_tpu.ml import base as jax_base  # noqa: E402
from learningorchestra_tpu.ml import builder as jax_builder  # noqa: E402
from learningorchestra_tpu.ml import checkpoint as jax_checkpoint  # noqa: E402
from learningorchestra_tpu.ops import dtype as jax_dtype  # noqa: E402
from learningorchestra_tpu_torch.core import ingest  # noqa: E402
from learningorchestra_tpu_torch.core.store import ROW_ID, InMemoryStore  # noqa: E402
from learningorchestra_tpu_torch.frame.dataframe import DataFrame  # noqa: E402
from learningorchestra_tpu_torch.frame.pyspark_compat import run_preprocessor  # noqa: E402
from learningorchestra_tpu_torch.ml import builder, checkpoint, trees  # noqa: E402
from learningorchestra_tpu_torch.ops import dtype  # noqa: E402
from tests.conftest import TITANIC_LIKE_CSV  # noqa: E402
from tests.test_frame import DOCUMENTED_PREPROCESSOR  # noqa: E402
from tests.test_torch_forest import reference_draws  # noqa: E402

NAMES = ["lr", "dt", "rf", "gb", "nb"]
TITANIC_NUMBERS = ("PassengerId", "Survived", "Pclass", "Age", "SibSp", "Parch", "Fare")
FEATURES, TRAIN_ROWS, TEST_ROWS = 6, 1_024, 512
SYNTHETIC_FIELDS = tuple(f"f{i}" for i in range(FEATURES)) + ("label",)
ASSEMBLER = (
    "from pyspark.ml.feature import VectorAssembler\n"
    "feature_cols = [c for c in training_df.schema.names if c != 'label']\n"
    "assembler = VectorAssembler(inputCols=feature_cols, outputCol='features')\n"
    "features_training = assembler.transform(training_df)\n"
    "features_testing = assembler.transform(testing_df)\n"
    "features_evaluation = assembler.transform(testing_df)\n"
)
PROB_TOL = {
    "dt": dict(rtol=0, atol=1e-6),
    "rf": dict(rtol=0, atol=1e-6),
    "gb": dict(rtol=0, atol=1e-5),
    "nb": dict(rtol=1e-5, atol=1e-5),
    "lr": dict(rtol=0, atol=1e-4),
}
TITANIC_PROBS = ("dt", "rf", "nb")   # the classifiers whose probabilities it holds
SIZES = {
    "dt": dict(max_depth=3),
    "rf": dict(num_trees=4, max_depth=3),
    "gb": dict(rounds=5, max_depth=3),
    "lr": dict(max_iter=30),
    "nb": {},
}
METRIC_TOL = 1e-6

PACKAGES = {
    "jax": dict(
        store=JaxStore, ingest=jax_ingest, convert=jax_dtype.convert_field_types,
        build=jax_builder.build_model, load=jax_checkpoint.load_model, extra={},
        preprocess=jax_run_preprocessor, frames=jax_builder.load_dataframe,
    ),
    "port": dict(
        store=InMemoryStore, ingest=ingest, convert=dtype.convert_field_types,
        build=builder.build_model,
        load=lambda path: checkpoint.load_model(path, device="cpu"), extra={"device": "cpu"},
        preprocess=run_preprocessor, frames=builder.load_dataframe,
    ),
}


def small(make_classifier):
    """A builder's ``make_classifier`` at the test's sizes; ``where`` is
    the reference's ``mesh`` or the port's ``device``."""
    def make(name, **where):
        return type(make_classifier(name, **where))(**SIZES[name], **where)
    return make


def rf_on_reference_draws(estimator, X, y):
    """The port's rf fit handed the reference's draws for these rows (the
    reference pads them to its mesh; the padded rows weigh 0)."""
    rows, num_features = np.shape(X)
    padded = jax_base.prepare_xy(X, y, jax_base.resolve_mesh(None))[0].shape[0]
    draws = reference_draws(estimator.seed, estimator.num_trees, padded, estimator.max_depth, num_features)
    return estimator._fit_with_draws(
        X, y, trees.ForestDraws(draws.bootstrap[:, :rows], draws.subset_scores)
    )


def synthetic_csv(path, rows, seed):
    rng = np.random.default_rng(seed)
    X = rng.random((rows, FEATURES)) * 20.0
    y = ((X[:, 0] + X[:, 1] * 0.5 + rng.random(rows) * 8) > 22).astype(int)
    lines = [",".join(SYNTHETIC_FIELDS)]
    lines += [",".join(f"{v:.6f}" for v in row) + f",{label}" for row, label in zip(X, y)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def build(package, files, numbers, code, models_dir=None):
    """Ingest ``files`` (collection -> CSV), cast ``numbers`` to numbers
    and build all five classifiers; returns the store, the metadata
    documents by classifier and the prediction rows by classifier."""
    api = PACKAGES[package]
    store = api["store"]()
    for name, path in files.items():
        api["ingest"].write_ingest_metadata(store, name, path)
        api["ingest"].ingest_csv(store, name, path)
        api["convert"](store, name, {field: "number" for field in numbers})
    results = api["build"](store, "train", "test", code, NAMES, models_dir=models_dir, **api["extra"])
    metadata = {result["classificator"]: result for result in results}
    rows = {
        name: [doc for doc in store.find(result["filename"]) if doc[ROW_ID] != 0]
        for name, result in metadata.items()
    }
    return store, metadata, rows


def titanic_store(tmp_path):
    """The Titanic-like CSV ingested and cast in the port's store, as
    ``train`` and ``test``."""
    path = tmp_path / "titanic.csv"
    path.write_text(TITANIC_LIKE_CSV)
    store = InMemoryStore()
    for name in ("train", "test"):
        ingest.write_ingest_metadata(store, name, str(path))
        ingest.ingest_csv(store, name, str(path))
        dtype.convert_field_types(store, name, {field: "number" for field in TITANIC_NUMBERS})
    return store


def assembled(package, store, code):
    """The frames ``code`` makes of the store's ``train`` and ``test``."""
    api = PACKAGES[package]
    return api["preprocess"](code, api["frames"](store, "train"), api["frames"](store, "test"))


class Builds(dict):
    """``[data, package] -> (store, metadata, rows)``, each data set
    built in both packages when a test first asks for it."""

    def __init__(self, folder):
        super().__init__()
        self.folder = folder

    def __missing__(self, key):
        data, _ = key
        folder = self.folder / data
        folder.mkdir()
        if data == "titanic":
            path = folder / "titanic.csv"
            path.write_text(TITANIC_LIKE_CSV)
            files, numbers, code = {"train": str(path), "test": str(path)}, TITANIC_NUMBERS, DOCUMENTED_PREPROCESSOR
        else:
            files = {
                "train": synthetic_csv(folder / "train.csv", TRAIN_ROWS, 0),
                "test": synthetic_csv(folder / "test.csv", TEST_ROWS, 1),
            }
            numbers, code = SYNTHETIC_FIELDS, ASSEMBLER
        for package in PACKAGES:
            models_dir = str(folder / f"models_{package}") if data == "synthetic" else None
            self[data, package] = build(package, files, numbers, code, models_dir=models_dir)
        return self[key]


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(trees.RandomForestClassifier, "fit", rf_on_reference_draws)
        patch.setattr(jax_builder, "make_classifier", small(jax_builder.make_classifier))
        patch.setattr(builder, "make_classifier", small(builder.make_classifier))
        yield Builds(tmp_path_factory.mktemp("builds"))


CASES = [("titanic", DOCUMENTED_PREPROCESSOR), ("synthetic", ASSEMBLER)]


@pytest.mark.parametrize("data, code", CASES, ids=[case[0] for case in CASES])
def test_assembled_matrices_are_bit_equal(builds, data, code):
    ours = assembled("port", builds[data, "port"][0], code)
    theirs = assembled("jax", builds[data, "jax"][0], code)
    for key in ("features_training", "features_testing", "features_evaluation"):
        np.testing.assert_array_equal(ours[key].feature_matrix(), theirs[key].feature_matrix())
        np.testing.assert_array_equal(ours[key].label_vector(), theirs[key].label_vector())
        assert ours[key].columns == theirs[key].columns


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("data", ["titanic", "synthetic"])
def test_metadata_documents_have_the_reference_fields_and_types(builds, data, name):
    ours = builds[data, "port"][1][name]
    theirs = builds[data, "jax"][1][name]
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert type(ours[key]) is type(value), key
    assert isinstance(ours["F1"], str) and isinstance(ours["accuracy"], str)
    assert isinstance(ours["fit_time"], float) and ours["fit_time"] > 0
    phases = ["checkpoint"] * (data == "synthetic") + ["evaluate", "fit", "write"]
    assert sorted(ours["timings"]) == sorted(theirs["timings"]) == phases
    assert {key: ours[key] for key in ("filename", "classificator", ROW_ID)} == {
        key: theirs[key] for key in ("filename", "classificator", ROW_ID)
    }
    np.testing.assert_allclose(
        [float(ours["accuracy"]), float(ours["F1"])],
        [float(theirs["accuracy"]), float(theirs["F1"])],
        rtol=0, atol=METRIC_TOL,
    )


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("data", ["titanic", "synthetic"])
def test_predictions_agree_with_the_reference(builds, data, name):
    ours = builds[data, "port"][2][name]
    theirs = builds[data, "jax"][2][name]
    expected_rows = TEST_ROWS if data == "synthetic" else 8
    assert len(ours) == len(theirs) == expected_rows
    for mine, reference in zip(ours, theirs):
        assert sorted(mine) == sorted(reference)
        assert "features" not in mine
        assert isinstance(mine["probability"], list)
        for key, value in reference.items():
            assert type(mine[key]) is type(value), key
            if key != "probability":
                assert mine[key] == value, key
    if data == "synthetic" or name in TITANIC_PROBS:
        np.testing.assert_allclose(
            np.array([row["probability"] for row in ours]),
            np.array([row["probability"] for row in theirs]),
            **PROB_TOL[name],
        )


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_load_across_the_two_packages(builds, name):
    """A ``.model`` either package's build wrote predicts, in the other
    package, the labels its build stored."""
    store = builds["synthetic", "port"][0]
    X_test = assembled("port", store, ASSEMBLER)["features_testing"].feature_matrix()
    for writer, reader in (("port", "jax"), ("jax", "port")):
        metadata = builds["synthetic", writer][1][name]
        stored = [row["prediction"] for row in builds["synthetic", writer][2][name]]
        model = PACKAGES[reader]["load"](metadata["model_checkpoint"])
        np.testing.assert_array_equal(np.asarray(model.predict(X_test), np.float64), stored)


def test_two_builds_complete_concurrently_and_agree(tmp_path):
    """Two port builds over one store at once (the reference's
    ``test_two_warm_builds_complete_concurrently``): both finish and give
    the same metrics."""
    store = titanic_store(tmp_path)
    results: dict = {}

    def run(slot):
        try:
            results[slot] = builder.build_model(
                store, "train", "test", DOCUMENTED_PREPROCESSOR, NAMES, device="cpu"
            )
        except BaseException as error:  # noqa: BLE001 — asserted below
            results[slot] = error

    threads = [threading.Thread(target=run, args=(slot,), daemon=True) for slot in "ab"]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
    assert not any(thread.is_alive() for thread in threads)
    metrics = {}
    for slot in "ab":
        assert not isinstance(results[slot], BaseException), results[slot]
        metrics[slot] = {
            result["classificator"]: (result["accuracy"], result["F1"]) for result in results[slot]
        }
    assert sorted(metrics["a"]) == sorted(NAMES)
    assert metrics["a"] == metrics["b"]


def test_build_model_needs_cuda_by_default(tmp_path):
    """``device=None`` means the CUDA card: without one the build raises
    before it reads anything, and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    store = InMemoryStore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        builder.build_model(store, "train", "test", ASSEMBLER, ["nb"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataFrame({"x": np.zeros(2)}).device_labels("x")


def test_trace_dir_gets_one_chrome_trace_a_build(tmp_path, monkeypatch):
    """``LO_TRACE_DIR``: each build writes a torch.profiler Chrome trace
    into a directory of its own; a build that finds the profiler busy
    runs untraced."""
    import json

    store = titanic_store(tmp_path)
    traces = tmp_path / "traces"
    traces.mkdir()
    monkeypatch.setenv("LO_TRACE_DIR", str(traces))
    builder.build_model(store, "train", "test", DOCUMENTED_PREPROCESSOR, ["nb"], device="cpu")
    (folder,) = traces.iterdir()
    assert folder.name.startswith("build_test_")
    with open(folder / "trace.json") as handle:
        assert json.load(handle)["traceEvents"]
    with builder._TRACE_LOCK:
        builder.build_model(store, "train", "test", DOCUMENTED_PREPROCESSOR, ["nb"], device="cpu")
    assert len(list(traces.iterdir())) == 1


@pytest.mark.parametrize("cap, workers", [("1", 1), ("3", 3), ("9", 5), ("0", 1)])
def test_build_workers_cap_the_fan_out(tmp_path, monkeypatch, cap, workers):
    """``LO_BUILD_WORKERS`` caps the classifier threads (at least one, at
    most one a classifier); a value that is not an integer raises."""
    store = titanic_store(tmp_path)
    seen = []
    pool = builder.ThreadPoolExecutor

    def classifier_pool(max_workers, **kwargs):
        if not kwargs:  # not the writer's pool, which names its thread
            seen.append(max_workers)
        return pool(max_workers, **kwargs)

    monkeypatch.setattr(builder, "ThreadPoolExecutor", classifier_pool)
    monkeypatch.setenv("LO_BUILD_WORKERS", cap)
    results = builder.build_model(store, "train", "test", DOCUMENTED_PREPROCESSOR, NAMES, device="cpu")
    assert seen == [workers]
    assert sorted(result["classificator"] for result in results) == sorted(NAMES)
    monkeypatch.setenv("LO_BUILD_WORKERS", "many")
    with pytest.raises(ValueError, match="LO_BUILD_WORKERS"):
        builder.build_model(store, "train", "test", DOCUMENTED_PREPROCESSOR, NAMES, device="cpu")
