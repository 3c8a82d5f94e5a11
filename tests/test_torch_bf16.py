"""``LO_DTYPE_POLICY=bf16`` on the port, held against the JAX package run
under the same policy, on the CPU.

Every test that sets the policy goes through the ``bf16`` fixture, which
empties both packages' read-once caches (``utils.dtypepolicy._POLICY``)
and restores them, with the environment, when the test ends: no other
test on the worker sees ``bf16``.

What is held, and to what:
- the policy is read once a process, by one reader: a change of the
  environment after the first read moves neither ``dtype_policy`` nor
  ``device.policy_dtype``, as the reference's reader does not move;
- the host-to-device cast: the port's bfloat16 matrix is the reference's,
  value for value (both round float64 through float32);
- the plain twins of K1, K6 and K7 on bfloat16 X give the same bits as on
  that X widened to float32 (a bfloat16 value widens exactly);
- bins identical to the reference's ``apply_bins`` on its bfloat16 X;
- dt, rf (on the reference's draws) and gb: heaps identical; leaf
  probabilities within 1e-6 and gb's leaf values within 1e-5, the float32
  tolerances of tests/test_torch_fit.py and test_torch_forest.py, since
  bfloat16 changes only the bins; labels identical;
- lr: the reference standardizes on the host and ships bfloat16, as the
  port does; probabilities within 1e-4 and labels identical but at near
  ties (a probability gap under 2e-4), the float32 test's tolerances
  (tests/test_torch_linear.py); nb: theta and prior within 1e-5 (its
  float32 tolerance there), labels identical;
- the batch lane: a ``.model`` predicts the same collections through both
  packages' ``predict_with_model`` under ``bf16``: labels identical,
  probabilities within the checkpoint tolerances; the test matrix sits on
  the device as bfloat16, half the float32 bytes;
- the image requests: PCA answers the reference's 500 and body (its
  ``eigh`` refuses bfloat16), t-SNE answers 201 in both;
- a sweep's points are bit-equal under ``f32`` and ``bf16``: its payload
  is float32 whatever the policy.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from learningorchestra_tpu.core import devcache as jax_devcache  # noqa: E402
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore  # noqa: E402
from learningorchestra_tpu.ml import base as jax_base  # noqa: E402
from learningorchestra_tpu.ml import binning as jax_binning  # noqa: E402
from learningorchestra_tpu.ml import builder as jax_builder  # noqa: E402
from learningorchestra_tpu.ml import logistic as jax_logistic  # noqa: E402
from learningorchestra_tpu.ml import naive_bayes as jax_naive_bayes  # noqa: E402
from learningorchestra_tpu.ml import trees as jax_trees  # noqa: E402
from learningorchestra_tpu.services import images as jax_images  # noqa: E402
from learningorchestra_tpu.utils import dtypepolicy as jax_dtypepolicy  # noqa: E402
from learningorchestra_tpu_torch import device as port_device  # noqa: E402
from learningorchestra_tpu_torch.core import devcache, ingest  # noqa: E402
from learningorchestra_tpu_torch.core.store import ROW_ID, InMemoryStore  # noqa: E402
from learningorchestra_tpu_torch.ml import base, binning, builder, logistic, sweep, trees  # noqa: E402
from learningorchestra_tpu_torch.ml.logistic import LogisticRegression  # noqa: E402
from learningorchestra_tpu_torch.ml.naive_bayes import NaiveBayes  # noqa: E402
from learningorchestra_tpu_torch.ops import dtype  # noqa: E402
from learningorchestra_tpu_torch.services import images  # noqa: E402
from learningorchestra_tpu_torch.utils import dtypepolicy  # noqa: E402
from tests.test_frame import DOCUMENTED_PREPROCESSOR  # noqa: E402
from tests.test_torch_forest import reference_draws  # noqa: E402

ROWS, FEATURES, DEPTH, TREES = 1500, 6, 3, 4
TREE_PROB_TOL = dict(rtol=0, atol=1e-6)
GB_TOL = dict(rtol=0, atol=1e-5)
LINEAR_PROB_TOL = dict(rtol=0, atol=1e-4)
NEAR_TIE = 2e-4
NB_TOL = dict(rtol=1e-5, atol=1e-5)
CHECKPOINT_TOL = {"dt": 1e-6, "rf": 1e-6, "gb": 1e-6, "lr": 1e-5, "nb": 1e-5}


def _read_once(monkeypatch, policy):
    monkeypatch.setenv("LO_DTYPE_POLICY", policy)
    monkeypatch.setattr(jax_dtypepolicy, "_POLICY", [])
    monkeypatch.setattr(dtypepolicy, "_POLICY", [])
    devcache.reset_global_devcache()
    jax_devcache.reset_global_devcache()


@pytest.fixture()
def bf16(monkeypatch):
    """Both packages under ``LO_DTYPE_POLICY=bf16`` for one test."""
    _read_once(monkeypatch, "bf16")
    assert dtypepolicy.dtype_policy() == jax_dtypepolicy.dtype_policy() == "bf16"
    yield
    devcache.reset_global_devcache()
    jax_devcache.reset_global_devcache()


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


def make_data(seed=0, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, FEATURES))
    X[:, 3] = np.round(X[:, 3] * 2)     # few distinct values: empty bins, tied gains
    score = X[:, 0] + 0.5 * X[:, 1] + 0.7 * X[:, 3] + rng.normal(scale=0.5, size=ROWS)
    y = (score > 0).astype(np.int32) if classes == 2 else np.digitize(score, [-0.8, 0.8]).astype(np.int32)
    return X, y


def widened(tensor):
    return tensor.to(torch.float32)


# --------------------------------------------------------------------------
# The policy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("first,then", [("f32", "bf16"), ("bf16", "f32")])
def test_the_policy_is_read_once_by_one_reader(monkeypatch, first, then):
    _read_once(monkeypatch, first)
    want = torch.bfloat16 if first == "bf16" else torch.float32
    assert dtypepolicy.dtype_policy() == jax_dtypepolicy.dtype_policy() == first
    assert port_device.policy_dtype() == want
    monkeypatch.setenv("LO_DTYPE_POLICY", then)
    assert dtypepolicy.dtype_policy() == jax_dtypepolicy.dtype_policy() == first
    assert port_device.policy_dtype() == want
    assert base.shard_matrix(np.ones((2, 3)), "cpu").dtype == want


def test_a_malformed_policy_is_refused_as_the_reference(monkeypatch):
    _read_once(monkeypatch, "fp8")
    with pytest.raises(ValueError) as ours:
        dtypepolicy.dtype_policy()
    with pytest.raises(ValueError) as theirs:
        jax_dtypepolicy.dtype_policy()
    assert str(ours.value) == str(theirs.value)


def test_the_cast_is_the_references(bf16):
    """float64 to bfloat16 through float32, value for value; integers and
    labels untouched."""
    X = np.random.default_rng(1).normal(size=(4096, 8)) * 1e3
    ours = base.shard_matrix(X, "cpu")
    theirs = jax_base.shard_matrix(X).data[: len(X)]
    assert ours.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
    np.testing.assert_array_equal(widened(ours).numpy(), np.asarray(theirs, np.float32))
    assert base.shard_labels(np.array([0, 1, 1]), "cpu").data.dtype == torch.int64


# --------------------------------------------------------------------------
# The plain twins of K1, K6 and K7 on bfloat16 X
# --------------------------------------------------------------------------

def bf16_rows(seed=2, rows=777, features=FEATURES):
    X = torch.from_numpy(np.random.default_rng(seed).normal(size=(rows, features)).astype(np.float32))
    X[::37, 1] = float("nan")
    return X.to(torch.bfloat16)


def test_k1_twin_reads_bf16_as_its_widened_float32():
    X = bf16_rows()
    thresholds = torch.from_numpy(binning.make_thresholds(widened(X).numpy()).astype(np.float32))
    assert torch.equal(binning.apply_bins(X, thresholds), binning.apply_bins(widened(X), thresholds))
    assert torch.equal(binning._apply_bins(X, thresholds), binning._apply_bins(widened(X), thresholds))


def _forest(seed, trees_count, depth, classes, features=FEATURES):
    rng = np.random.default_rng(seed)
    nodes = 2**depth - 1
    features_heap = torch.from_numpy(rng.integers(-1, features, size=(trees_count, nodes)).astype(np.int32))
    thresholds_heap = torch.from_numpy(rng.normal(size=(trees_count, nodes)).astype(np.float32))
    probs = rng.random((trees_count, 2**depth, classes)).astype(np.float32)
    probs = torch.from_numpy(probs / probs.sum(axis=2, keepdims=True))
    values = torch.from_numpy(rng.normal(size=(trees_count, 2**depth)).astype(np.float32))
    return features_heap, thresholds_heap, probs, values


def test_k6_twins_read_bf16_as_their_widened_float32():
    X = bf16_rows()
    fh, th, probs, values = _forest(3, TREES, DEPTH, 3)
    assert torch.equal(
        trees.ensemble_forward(X, fh, th, probs, DEPTH), trees.ensemble_forward(widened(X), fh, th, probs, DEPTH)
    )
    assert torch.equal(
        trees.gbt_forward(X, -0.2, fh, th, values, 0.1, DEPTH),
        trees.gbt_forward(widened(X), -0.2, fh, th, values, 0.1, DEPTH),
    )
    with pytest.raises(TypeError):   # a sweep's job form stays float32
        trees.job_ensemble_forward(X, fh[None], th[None], probs[None], DEPTH)


@pytest.mark.parametrize("classes", [2, 3])
def test_k7_twins_read_bf16_as_their_widened_float32(classes):
    X = bf16_rows(features=5)
    y = torch.from_numpy(np.random.default_rng(4).integers(0, classes, size=X.shape[0]).astype(np.int32))
    rng = np.random.default_rng(5)
    W = torch.from_numpy(rng.normal(size=(5, classes)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=classes).astype(np.float32))
    W4 = torch.stack([W * s for s in (1.0, 0.5, 0.25, 0.125)])
    b4 = torch.stack([b * s for s in (1.0, 0.5, 0.25, 0.125)])
    X = torch.where(X.isnan(), 0.0, X.float()).to(torch.bfloat16)
    for got, want in zip(logistic.loss_and_grad(W, b, X, y, 0.1), logistic.loss_and_grad(W, b, widened(X), y, 0.1)):
        assert torch.equal(got, want)
    assert torch.equal(logistic.trial_losses(W4, b4, X, y, 0.1), logistic.trial_losses(W4, b4, widened(X), y, 0.1))
    l2s = torch.zeros(1)
    with pytest.raises(TypeError):   # the job form stays float32
        logistic.job_loss_and_grad(W[None], b[None], X, y, None, l2s)


# --------------------------------------------------------------------------
# The fits and forwards against the reference under bf16
# --------------------------------------------------------------------------

def test_bins_are_the_references(bf16):
    X, _ = make_data()
    thresholds = binning.make_thresholds(X).astype(np.float32)
    ours = binning.apply_bins(base.shard_matrix(X, "cpu"), torch.from_numpy(thresholds))
    X_dev = jax_base.shard_matrix(X).data
    assert X_dev.dtype == jnp.bfloat16
    theirs = np.asarray(jax_binning.apply_bins(X_dev, jnp.asarray(thresholds)))[: len(X)]
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # and bfloat16 moved some bins: the policy is really in force
    assert (ours.numpy() != np.asarray(jax_binning.apply_bins(jnp.asarray(X, jnp.float32), thresholds))).any()


def _labels_probs(model, X):
    labels, probs = model.predict_both(X)
    return np.asarray(labels), np.asarray(probs)


@pytest.mark.parametrize("name", ["dt", "gb"])
def test_tree_fits_are_the_references(bf16, name):
    X, y = make_data()
    if name == "dt":
        ours = trees.DecisionTreeClassifier(max_depth=DEPTH, device="cpu").fit(X, y)
        theirs = jax_trees.DecisionTreeClassifier(max_depth=DEPTH).fit(X, y)
        leaves, their_leaves, tolerance = ours.leaf_probs, theirs.leaf_probs, TREE_PROB_TOL
    else:
        ours = trees.GBTClassifier(rounds=5, max_depth=DEPTH, device="cpu").fit(X, y)
        theirs = jax_trees.GBTClassifier(rounds=5, max_depth=DEPTH).fit(X, y)
        leaves, their_leaves, tolerance = ours.leaf_values, theirs.leaf_values, GB_TOL
    np.testing.assert_array_equal(ours.features_heap.numpy(), np.asarray(theirs.features_heap))
    np.testing.assert_array_equal(ours.thresholds_heap.numpy(), np.asarray(theirs.thresholds_heap))
    np.testing.assert_allclose(leaves.numpy(), np.asarray(their_leaves), **tolerance)
    labels, probs = _labels_probs(ours, X)
    their_labels, their_probs = _labels_probs(theirs, X)
    np.testing.assert_array_equal(labels, their_labels)
    np.testing.assert_allclose(probs, their_probs, **(TREE_PROB_TOL if name == "dt" else GB_TOL))


def test_rf_fit_is_the_references(bf16):
    X, y = make_data(classes=3)
    seed = 11
    theirs = jax_trees.RandomForestClassifier(num_trees=TREES, max_depth=DEPTH, seed=seed).fit(X, y)
    padded = jax_base.prepare_xy(X, y, jax_base.resolve_mesh(None))[0].shape[0]
    draws = reference_draws(seed, TREES, padded, max_depth=DEPTH, num_features=FEATURES)
    estimator = trees.RandomForestClassifier(num_trees=TREES, max_depth=DEPTH, seed=seed, device="cpu")
    ours = estimator._fit_with_draws(X, y, trees.ForestDraws(draws.bootstrap[:, :ROWS], draws.subset_scores))
    np.testing.assert_array_equal(ours.features_heap.numpy(), np.asarray(theirs.features_heap))
    np.testing.assert_array_equal(ours.thresholds_heap.numpy(), np.asarray(theirs.thresholds_heap))
    np.testing.assert_allclose(ours.leaf_probs.numpy(), np.asarray(theirs.leaf_probs), **TREE_PROB_TOL)
    labels, probs = _labels_probs(ours, X)
    their_labels, their_probs = _labels_probs(theirs, X)
    np.testing.assert_array_equal(labels, their_labels)
    np.testing.assert_allclose(probs, their_probs, **TREE_PROB_TOL)


def _same_labels_but_near_ties(labels, their_labels, their_probs):
    differ = labels != their_labels
    top = np.sort(their_probs[differ], axis=1)
    assert not differ.any() or (top[:, -1] - top[:, -2]).max() < NEAR_TIE


@pytest.mark.parametrize("classes", [2, 3])
def test_lr_fit_is_the_references(bf16, classes):
    X, y = make_data(seed=6, classes=classes)
    ours = LogisticRegression(device="cpu").fit(X, y)
    theirs = jax_logistic.LogisticRegression().fit(X, y)
    labels, probs = _labels_probs(ours, X)
    their_labels, their_probs = _labels_probs(theirs, X)
    np.testing.assert_allclose(probs, their_probs, **LINEAR_PROB_TOL)
    _same_labels_but_near_ties(labels, their_labels, their_probs)
    np.testing.assert_array_equal(ours.mean.numpy(), np.asarray(theirs.mean))


def test_nb_fit_is_the_references(bf16):
    X, y = make_data(seed=8, classes=3)
    X = np.abs(X)
    ours = NaiveBayes(device="cpu").fit(X, y)
    theirs = jax_naive_bayes.NaiveBayes().fit(X, y)
    np.testing.assert_allclose(ours.theta.numpy(), np.asarray(theirs.theta), **NB_TOL)
    np.testing.assert_allclose(ours.prior.numpy(), np.asarray(theirs.prior), **NB_TOL)
    labels, _ = _labels_probs(ours, X)
    np.testing.assert_array_equal(labels, _labels_probs(theirs, X)[0])


# --------------------------------------------------------------------------
# The batch lane, the image requests and the sweeps under bf16
# --------------------------------------------------------------------------

NAMES = ("lr", "dt", "rf", "gb", "nb")


def test_batch_lane_is_the_references(bf16, tmp_path):
    from learningorchestra_tpu.core import ingest as jax_ingest
    from learningorchestra_tpu.ops import dtype as jax_dtype
    from tests.test_torch_batch import _ingest, _projected

    paths = _projected(tmp_path)
    store = _ingest(InMemoryStore(), ingest, dtype, paths)
    jax_store = _ingest(JaxStore(), jax_ingest, jax_dtype, paths)
    models_dir = str(tmp_path / "models")
    builder.build_model(
        store, "titanic_train", "titanic_test", DOCUMENTED_PREPROCESSOR, list(NAMES),
        device="cpu", models_dir=models_dir,
    )
    for name in NAMES:
        path = f"{models_dir}/titanic_test_prediction_{name}.model"
        builder.predict_with_model(
            store, path, "titanic_train", "titanic_test", DOCUMENTED_PREPROCESSOR, f"b_{name}", device="cpu"
        )
        jax_builder.predict_with_model(
            jax_store, path, "titanic_train", "titanic_test", DOCUMENTED_PREPROCESSOR, f"b_{name}"
        )
        ours = store.read_columns(f"b_{name}", ["prediction", "probability"])
        theirs = jax_store.read_columns(f"b_{name}", ["prediction", "probability"])
        np.testing.assert_array_equal(ours["prediction"], theirs["prediction"])
        np.testing.assert_allclose(
            np.asarray(ours["probability"]), np.asarray(theirs["probability"]), rtol=0, atol=CHECKPOINT_TOL[name]
        )
        assert store.find_one(f"b_{name}", {ROW_ID: 0})["model_checkpoint"] == path
    # the test matrix on the device: bfloat16, half the float32 bytes
    matrices = [
        entry.value for key, entry in devcache.global_devcache()._entries.items()
        if key[2][0] == "devmat"
    ]
    assert matrices and all(matrix.dtype == torch.bfloat16 for matrix in matrices)
    assert all(entry_bytes == matrix.numel() * 2 for matrix, entry_bytes in (
        (entry.value, entry.nbytes) for key, entry in devcache.global_devcache()._entries.items()
        if key[2][0] == "devmat"
    ))


def test_image_requests_answer_as_the_reference(bf16, tmp_path):
    from tests.test_torch_images import stores

    jax_store, port_store = stores()
    encoded, _, X = devcache.dataset_embedding_inputs(port_store, "numbers", "cpu")
    _, _, theirs = jax_devcache.dataset_embedding_inputs(jax_store, "numbers", cache=jax_devcache.DeviceCache(0))
    assert X.dtype == torch.bfloat16
    np.testing.assert_array_equal(widened(X).numpy(), np.asarray(theirs.data[: len(X)], np.float32))
    for method in ("pca", "tsne"):
        request = {f"{method}_filename": f"{method}_img", "label_name": None}
        ours = images.create_app(port_store, str(tmp_path / "port"), method, device="cpu").test_client()
        reference = jax_images.create_app(jax_store, str(tmp_path / "jax"), method).test_client()
        got, want = ours.post("/images/numbers", json=request), reference.post("/images/numbers", json=request)
        assert got.status_code == want.status_code == (500 if method == "pca" else 201)
        assert got.headers["Content-Type"] == want.headers["Content-Type"]
        assert got.get_data() == want.get_data()
    assert json.loads(got.get_data()) == {"result": "created_file"}


def test_sweep_points_are_the_same_bits_under_f32_and_bf16(monkeypatch):
    rng = np.random.default_rng(9)
    X, y = make_data(seed=9)
    Xe, ye = X[:300] + rng.normal(scale=0.1, size=(300, FEATURES)), y[:300]
    results = {}
    for policy in ("f32", "bf16"):
        _read_once(monkeypatch, policy)
        for kind, grid in (("lr", [{"reg_param": 0.0}, {"reg_param": 0.5}]),
                           ("dt", [{"max_depth": 2}, {"max_depth": 3}])):
            _, payload = sweep.prepare_member(kind, X, y, Xe, ye, grid, device="cpu", max_iter=5)
            assert payload["X"].dtype == np.float32
            (status, result), = sweep.run_group([payload], "cpu")
            assert status == "ok"
            results[policy, kind] = result["points"]
    for kind in ("lr", "dt"):
        assert results["f32", kind] == results["bf16", kind]


def test_ml_dtypes_rounds_as_the_port():
    """The reference's host cast (numpy's bfloat16 from ml_dtypes) and
    torch's round float64 through float32 alike, ties included."""
    x = np.concatenate([np.random.default_rng(10).normal(size=100_000), [1.0 + 2.0**-8 + 2.0**-30]])
    theirs = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    ours = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(ours, theirs)
