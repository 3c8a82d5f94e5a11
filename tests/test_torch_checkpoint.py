"""The weight carrier and the ``.model`` format, across both packages.

Models of all four checkpoint kinds are fitted by the JAX package at a
small size. A ``.model`` written by the JAX package must load and predict
the same in the port (on the CPU), and one written by the port must do the
same in the JAX package. Labels are identical; tree probabilities agree
within 1e-6 (the same float32 operations in the same order), lr and nb
within 1e-5 (the GEMM sums in another order).
"""

import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu.ml import checkpoint as jax_checkpoint  # noqa: E402
from learningorchestra_tpu.ml.logistic import LogisticRegression  # noqa: E402
from learningorchestra_tpu.ml.naive_bayes import NaiveBayes  # noqa: E402
from learningorchestra_tpu.ml.trees import (  # noqa: E402
    DecisionTreeClassifier,
    GBTClassifier,
    RandomForestClassifier,
)
from learningorchestra_tpu_torch.ml import checkpoint  # noqa: E402
from learningorchestra_tpu_torch.serve.registry import model_nbytes  # noqa: E402

ROWS, FEATURES, DEPTH, TREES = 384, 6, 3, 4
TOLERANCES = {
    "dt": dict(rtol=0, atol=1e-6),
    "rf": dict(rtol=0, atol=1e-6),
    "gb": dict(rtol=0, atol=1e-6),
    "lr": dict(rtol=1e-5, atol=1e-5),
    "nb": dict(rtol=1e-5, atol=1e-5),
}
KINDS = {
    "dt": "tree_ensemble",
    "rf": "tree_ensemble",
    "gb": "gbt",
    "lr": "logistic",
    "nb": "naive_bayes",
}


def make_data(seed, rows):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.5, size=rows)) > 0).astype(np.int32)
    return X, y


@pytest.fixture(scope="module")
def fitted():
    X, y = make_data(0, ROWS)
    estimators = {
        "dt": DecisionTreeClassifier(max_depth=DEPTH),
        "rf": RandomForestClassifier(num_trees=TREES, max_depth=DEPTH),
        "gb": GBTClassifier(rounds=TREES, max_depth=DEPTH),
        "lr": LogisticRegression(max_iter=20),
        "nb": NaiveBayes(),
    }
    return {
        name: estimator.fit(np.abs(X) if name == "nb" else X, y)
        for name, estimator in estimators.items()
    }


@pytest.fixture(scope="module")
def rows():
    X, _ = make_data(1, 200)
    return X


def rows_for(name, X):
    return np.abs(X) if name == "nb" else X


@pytest.mark.parametrize("name", sorted(KINDS))
def test_jax_checkpoint_predicts_the_same_in_the_port(name, fitted, rows, tmp_path):
    path = str(tmp_path / f"{name}.model")
    jax_checkpoint.save_model(fitted[name], path)
    X = rows_for(name, rows)
    model = checkpoint.load_model(path, device="cpu")
    labels, probs = model.predict_both(X)
    ref_labels, ref_probs = fitted[name].predict_both(X)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, **TOLERANCES[name])
    assert len(np.unique(ref_labels)) == 2  # both classes predicted


@pytest.mark.parametrize("name", sorted(KINDS))
def test_port_checkpoint_predicts_the_same_in_jax(name, fitted, rows, tmp_path):
    jax_path = str(tmp_path / "from_jax.model")
    jax_checkpoint.save_model(fitted[name], jax_path)
    model = checkpoint.load_model(jax_path, device="cpu")
    port_path = str(tmp_path / "from_port.model")
    checkpoint.save_model(model, port_path)
    with zipfile.ZipFile(port_path) as archive:
        assert json.loads(archive.read("__model__.json"))["kind"] == KINDS[name]
    X = rows_for(name, rows)
    ref_labels, ref_probs = jax_checkpoint.load_model(port_path).predict_both(X)
    labels, probs = model.predict_both(X)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, **TOLERANCES[name])


@pytest.mark.parametrize("name", sorted(KINDS))
def test_chip_smoke_parameters_load_in_both_packages(name, rows, tmp_path):
    """The seeded parameters chip_smoke.py serves on the card, at a small
    size, written by the port and predicted by both packages."""
    gathered = chip_smoke.synthetic_checkpoints(
        seed=3, features=FEATURES, depth=DEPTH, num_trees=TREES
    )[name]
    assert gathered[0] == KINDS[name]
    path = checkpoint.checkpoint_path(str(tmp_path), name)
    checkpoint.write_checkpoint(gathered, path)
    X = np.abs(rows) * 5  # the synthetic thresholds live on bench.py's [0, 20) range
    X[::7, 2] = np.nan if name in ("dt", "rf", "gb") else 0.0
    ref_labels, ref_probs = jax_checkpoint.load_model(path).predict_both(X)
    labels, probs = checkpoint.load_model(path, device="cpu").predict_both(X)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, **TOLERANCES[name])


def test_model_from_arrays_carries_the_reference_layout(fitted):
    kind, arrays, scalars = jax_checkpoint.gather_model(fitted["rf"])
    model = checkpoint.model_from_arrays(kind, arrays, scalars, device="cpu")
    assert model.features_heap.dtype == torch.int32
    assert tuple(model.leaf_probs.shape) == (TREES, 2**DEPTH, 2)
    assert model_nbytes(model) == sum(
        np.asarray(a, dtype).nbytes
        for a, dtype in zip(arrays.values(), checkpoint.ARRAY_DTYPES[kind].values())
    )
    round_trip = checkpoint.gather_model(model)
    assert round_trip[0] == kind and round_trip[2] == scalars
    for key, value in arrays.items():
        np.testing.assert_array_equal(round_trip[1][key], value)
    with pytest.raises(ValueError, match="unknown checkpoint kind"):
        checkpoint.model_from_arrays("svm", arrays, scalars, device="cpu")


def test_load_model_without_a_device_needs_cuda(fitted, tmp_path):
    path = str(tmp_path / "dt.model")
    jax_checkpoint.save_model(fitted["dt"], path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_model(path)


def test_nb_forward_keeps_float32_rounding_small_at_full_width():
    """At bench.py's width and range (16 features in [0, 20)) the joint
    log-likelihood reaches hundreds; the port's forward still lands within
    2e-6 of the same formula evaluated in float64."""
    kind, arrays, scalars = chip_smoke.synthetic_checkpoints(seed=0)["nb"]
    X = chip_smoke.bench_rows(np.random.default_rng(7), 2048)
    probs = checkpoint.model_from_arrays(kind, arrays, scalars, device="cpu").predict_proba(X)
    joint = X.astype(np.float64) @ arrays["theta"].astype(np.float64).T + arrays["prior"]
    assert np.abs(joint).max() > 300
    exact = np.exp(joint - joint.max(axis=1, keepdims=True))
    exact /= exact.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(probs, exact, rtol=0, atol=2e-6)
