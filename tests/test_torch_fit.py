"""The port's tree fits held against the JAX reference on the CPU.

The port (learningorchestra_tpu_torch/ml/binning.py, trees.py, base.py,
evaluation.py) and the JAX package (learningorchestra_tpu/ml/...) get the
same seeded numpy inputs: 2,000 rows x 6 features with NaN in some values
and one feature that is NaN throughout, one feature of few distinct values
(empty bins, so exact ties between split gains), 3 classes for dt, 2 for
gb, depth 3 and 5 boosting rounds.

Tolerances, and why:
- bins, class counts, splits, routes and dt heaps: identical. Counts are
  exact integers and the gain expressions round in the reference's order.
- gb histogram and leaf sums: rtol 1e-5 with an absolute floor of 1e-5.
  The port sums in float64 and rounds once; the reference's float32
  matmul carries ~1e-7 of the cell's magnitude (sums of |g|, h <= 1 over
  up to 2,000 rows), and a cell whose g sum cancels toward 0 keeps only
  that absolute error.
- dt leaf probabilities: 1e-6 (one float32 division of exact counts).
- gb: f0, leaf values and probabilities 1e-5 (sigmoid and log differ in
  the last bits between the two libraries, the reference's margin update
  is a fused multiply-add on the CPU, and the histograms above).
- metrics: 1e-7.

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py (phases fit-kernels and fit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from learningorchestra_tpu.ml import base as jax_base  # noqa: E402
from learningorchestra_tpu.ml import binning as jax_binning  # noqa: E402
from learningorchestra_tpu.ml import checkpoint as jax_checkpoint  # noqa: E402
from learningorchestra_tpu.ml import evaluation as jax_evaluation  # noqa: E402
from learningorchestra_tpu.ml import trees as jax_trees  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import (  # noqa: E402
    CLASSIFIER_NAMES,
    accuracy_score,
    base,
    binning,
    checkpoint,
    evaluation,
    f1_score,
    logistic,
    make_classifier,
    naive_bayes,
    trees,
)

ROWS, FEATURES, DEPTH, ROUNDS, CLASSES, BINS = 2000, 6, 3, 5, 3, 32
STEP = 0.1
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
GB_TOL = dict(rtol=0, atol=1e-5)

jax_histograms = jax.jit(jax_trees._level_histograms, static_argnums=(3, 4))
jax_leaf_sums = jax.jit(jax_trees._leaf_sums, static_argnums=(2,))


def t(array):
    return torch.from_numpy(np.array(array))


def make_data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, FEATURES)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:, 3] = np.round(X[:, 3] * 2)     # few distinct values: empty bins, tied gains
    X[:, 5] = np.nan                    # NaN throughout: inf thresholds, never split
    score = (
        np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) + 0.7 * np.nan_to_num(X[:, 3])
        + rng.normal(scale=0.5, size=ROWS)
    )
    y2 = (score > 0).astype(np.int32)
    y3 = np.digitize(score, [-0.8, 0.8]).astype(np.int32)
    return X, y2, y3


@pytest.fixture(scope="module")
def data():
    X, y2, y3 = make_data()
    thresholds = jax_binning.make_thresholds(X)
    thresholds32 = thresholds.astype(np.float32)
    bins = np.asarray(jax_binning.apply_bins(jnp.asarray(X), jnp.asarray(thresholds32)))
    weights = np.ones(ROWS, np.float32)
    weights[-40:] = 0.0   # rows that count for nothing, as padding does
    return {
        "X": X, "y2": y2, "y3": y3, "thresholds": thresholds,
        "thresholds32": thresholds32, "bins": bins, "weights": weights,
    }


def channels_for(kind, y, weights, seed):
    """dt: weighted class one-hots; gb: the (g, h) of a boosting round at
    seeded margins."""
    if kind == "one_hot":
        one_hot = np.eye(CLASSES, dtype=np.float32)[y]
        return one_hot * weights[:, None]
    rng = np.random.default_rng(seed)
    p = 1 / (1 + np.exp(-rng.normal(size=len(y)))).astype(np.float32)
    g = ((p - (y > 0)) * weights).astype(np.float32)
    h = (np.maximum(p * (1 - p), 1e-6) * weights).astype(np.float32)
    return np.stack([g, h], axis=1)


# --------------------------------------------------------------------------
# Binning (K1)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("max_bins", [32, 8])
def test_make_thresholds_identical(data, max_bins):
    expected = jax_binning.make_thresholds(data["X"], max_bins)
    got = binning.make_thresholds(data["X"], max_bins)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, expected)
    assert np.isinf(got[5]).all()   # the all-NaN feature


def test_apply_bins_identical(data):
    got = binning.apply_bins(t(data["X"]), t(data["thresholds32"]))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), data["bins"])
    assert (data["bins"][:, 5] == BINS - 1).all()


def test_apply_bins_edge_values():
    """NaN goes past every threshold (inf ones too), +inf to the first inf
    threshold, -inf and -0.0 to bin 0, a threshold's own value to its bin."""
    thresholds = np.array([[0.0, 1.0, 2.0, np.inf, np.inf]], np.float32)
    X = np.array([[np.nan], [np.inf], [-np.inf], [-0.0], [0.0], [2.0], [0.5], [3.0]], np.float32)
    expected = np.asarray(jax_binning.apply_bins(jnp.asarray(X), jnp.asarray(thresholds)))
    np.testing.assert_array_equal(expected[:, 0], [5, 3, 0, 0, 0, 2, 1, 3])
    np.testing.assert_array_equal(binning.apply_bins(t(X), t(thresholds)).numpy(), expected)


def test_apply_bins_past_int8_takes_int32(data):
    thresholds = jax_binning.make_thresholds(data["X"], 200).astype(np.float32)
    expected = np.asarray(jax_binning.apply_bins(jnp.asarray(data["X"]), jnp.asarray(thresholds)))
    got = binning._apply_bins(t(data["X"]), t(thresholds))
    assert expected.dtype == np.int32 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expected)


# --------------------------------------------------------------------------
# Level programs (K2-K5)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["one_hot", "newton"])
@pytest.mark.parametrize("level", [0, 2, 5])   # 2^5 nodes x 3 classes: the reference's scatter
def test_level_histograms_match_reference(data, kind, level):
    rng = np.random.default_rng(level)
    n_nodes = 2**level
    node = rng.integers(0, n_nodes, ROWS).astype(np.int32)
    channels = channels_for(kind, data["y3"], data["weights"], seed=level)
    expected = np.asarray(
        jax_histograms(jnp.asarray(data["bins"]), jnp.asarray(node), jnp.asarray(channels), n_nodes, BINS)
    )
    got = trees.level_histograms(t(data["bins"]), t(node), t(channels), n_nodes, BINS).numpy()
    assert got.shape == expected.shape == (n_nodes, FEATURES, BINS, channels.shape[1])
    if kind == "one_hot":
        np.testing.assert_array_equal(got, expected)
    else:
        np.testing.assert_allclose(got, expected, **SUM_TOL)


@pytest.mark.parametrize("kind", ["one_hot", "newton"])
@pytest.mark.parametrize("n_leaves", [8, 128])  # the reference's matmul and scatter
def test_leaf_sums_match_reference(data, kind, n_leaves):
    leaf = np.random.default_rng(n_leaves).integers(0, n_leaves, ROWS).astype(np.int32)
    channels = channels_for(kind, data["y3"], data["weights"], seed=n_leaves)
    expected = np.asarray(jax_leaf_sums(jnp.asarray(leaf), jnp.asarray(channels), n_leaves))
    got = trees.leaf_sums(t(leaf), t(channels), n_leaves).numpy()
    if kind == "one_hot":
        np.testing.assert_array_equal(got, expected)
    else:
        np.testing.assert_allclose(got, expected, **SUM_TOL)


def reference_split(hist, mode, subset_scores=None, subset_k=None):
    gain = (jax_trees._gini_gain if mode == "gini" else jax_trees._newton_gain)(jnp.asarray(hist))
    if subset_scores is None:
        feature, bin_index = jax_trees._select_splits(gain, None, None)
    else:
        feature, bin_index = jax_trees._select_splits(gain, subset_scores, subset_k)
    return np.asarray(gain), np.asarray(feature), np.asarray(bin_index)


@pytest.mark.parametrize("mode", ["gini", "newton"])
def test_splits_on_the_reference_histograms_are_identical(data, mode):
    """Gains and splits from the reference's own histograms of a level-2
    node assignment where node 1 holds only zero-weight rows (every
    candidate invalid), on data whose gains tie exactly."""
    node = np.random.default_rng(7).integers(0, 4, ROWS).astype(np.int32)
    weights = np.where(node == 1, 0.0, data["weights"]).astype(np.float32)
    kind = "one_hot" if mode == "gini" else "newton"
    channels = channels_for(kind, data["y3"] if mode == "gini" else data["y2"], weights, seed=3)
    hist = np.asarray(jax_histograms(jnp.asarray(data["bins"]), jnp.asarray(node), jnp.asarray(channels), 4, BINS))
    gain, feature, bin_index = reference_split(hist, mode)
    assert feature[1] == -1 and bin_index[1] == 0 and np.isneginf(gain[1]).all()
    flat = gain.reshape(4, -1)
    best = flat.max(axis=1)
    assert any((flat[n] == best[n]).sum() > 1 for n in range(4) if np.isfinite(best[n]))
    # The reference's cumulative sum over bins rounds in blocks of 16 on
    # the CPU (XLA's reduce-window rewrite), the port's bin after bin: the
    # valid candidates are the same, and each gain agrees to an ulp of the
    # scores it is the difference of, within 1e-6 of the node's largest gain.
    got_gain = trees._GAINS[mode](t(hist)).numpy()
    np.testing.assert_array_equal(np.isneginf(got_gain), np.isneginf(gain))
    finite = np.isfinite(gain)
    scale = np.abs(np.where(finite, gain, 0)).reshape(4, -1).max(axis=1)[:, None, None]
    difference = np.where(finite, got_gain, 0) - np.where(finite, gain, 0)
    assert (np.abs(difference) <= 1e-6 * scale).all()
    for select in (trees._select_plain, trees.select_splits):
        got_feature, got_bin = select(t(hist), mode)
        np.testing.assert_array_equal(got_feature.numpy(), feature)
        np.testing.assert_array_equal(got_bin.numpy(), bin_index)


@pytest.mark.parametrize("mode", ["gini", "newton"])
def test_splits_on_made_histograms_are_identical(mode):
    """Ties across features go to the first; an empty node is a leaf at
    bin 0. A NaN count makes its feature's candidates invalid under gini;
    a NaN gradient sum leaves NaN gains under newton, where NaN counts as
    the maximum and makes its node a leaf."""
    rng = np.random.default_rng(11)
    hist = rng.integers(0, 5, size=(4, 3, 6, 2)).astype(np.float32)
    hist[0] = 0.0                          # no rows: every candidate invalid
    hist[1, 2] = hist[1, 0]                # feature 2 ties feature 0 exactly
    hist[2, 1, 3, 0] = np.nan              # a NaN gain
    gain, feature, bin_index = reference_split(hist, mode)
    assert feature[0] == -1 and bin_index[0] == 0
    if mode == "gini":
        assert np.isneginf(gain[2, 1]).all()
    else:
        assert np.isnan(gain[2]).any() and feature[2] == -1
    for select in (trees._select_plain, trees.select_splits):
        got_feature, got_bin = select(t(hist), mode)
        np.testing.assert_array_equal(got_feature.numpy(), feature)
        np.testing.assert_array_equal(got_bin.numpy(), bin_index)


def test_feature_subsets_match_reference(data):
    """Random-forest feature subsets: the reference draws the scores from
    a key; handed the same scores, the port selects the same splits."""
    node = np.random.default_rng(5).integers(0, 4, ROWS).astype(np.int32)
    channels = channels_for("one_hot", data["y3"], data["weights"], seed=5)
    hist = np.asarray(jax_histograms(jnp.asarray(data["bins"]), jnp.asarray(node), jnp.asarray(channels), 4, BINS))
    key = jax.random.key(3)
    scores = np.asarray(jax.random.uniform(key, (4, FEATURES)))
    _, feature, bin_index = reference_split(hist, "gini", key, 2)
    got_feature, got_bin = trees._select_splits(trees._gini_gain(t(hist)), t(scores), 2)
    np.testing.assert_array_equal(got_feature.numpy(), feature)
    np.testing.assert_array_equal(got_bin.numpy(), bin_index)


@pytest.mark.parametrize("level", [0, 2, 4])
def test_route_identical(data, level):
    rng = np.random.default_rng(level)
    n_nodes = 2**level
    node = rng.integers(0, n_nodes, ROWS).astype(np.int32)
    feature = rng.integers(-1, FEATURES, n_nodes).astype(np.int32)
    bin_index = rng.integers(0, BINS, n_nodes).astype(np.int32)
    expected = np.asarray(
        jax_trees._route(jnp.asarray(data["bins"]), jnp.asarray(node), jnp.asarray(feature), jnp.asarray(bin_index))
    )
    got = trees.route(t(data["bins"]), t(node), t(feature), t(bin_index))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expected)


# --------------------------------------------------------------------------
# Metrics (K9)
# --------------------------------------------------------------------------

def test_metrics_match_reference():
    rng = np.random.default_rng(2)
    y_true = rng.integers(0, 3, 500).astype(np.int32)
    y_pred = np.where(rng.random(500) < 0.7, y_true, rng.integers(0, 2, 500)).astype(np.int32)
    weights = (rng.random(500) < 0.9).astype(np.float32)
    expected = jax_evaluation.masked_metrics(
        jnp.asarray(y_true), jnp.asarray(y_pred), jnp.asarray(weights), num_classes=4
    )
    got = evaluation.masked_metrics(t(y_true), t(y_pred), t(weights), 4)
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in expected], rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        evaluation.evaluate_both(y_true, y_pred, device="cpu"),
        jax_evaluation.evaluate_both(y_true, y_pred),
        rtol=0, atol=1e-7,
    )
    assert abs(accuracy_score(y_true, y_pred, device="cpu") - jax_evaluation.accuracy_score(y_true, y_pred)) <= 1e-7
    assert abs(f1_score(y_true, y_pred, device="cpu") - jax_evaluation.f1_score(y_true, y_pred)) <= 1e-7
    np.testing.assert_array_equal(
        evaluation.confusion_matrix(t(y_true), t(y_pred), 4).numpy(),
        np.asarray(jax_evaluation.confusion_matrix(jnp.asarray(y_true), jnp.asarray(y_pred), num_classes=4)),
    )


# --------------------------------------------------------------------------
# Whole fits
# --------------------------------------------------------------------------

def test_dt_fit_identical(data):
    expected = jax_trees._dt_fit(
        jnp.asarray(data["bins"]), jnp.asarray(data["y3"]), jnp.asarray(data["weights"]),
        num_classes=CLASSES, max_depth=DEPTH, max_bins=BINS,
    )
    got = trees._dt_fit(
        t(data["bins"]), t(data["y3"].astype(np.int64)), t(data["weights"]), CLASSES, DEPTH, BINS
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(expected[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(expected[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(expected[2]), rtol=0, atol=1e-6)
    assert (got[0].numpy() >= 0).sum() >= 4   # the tree really splits


def test_dt_estimator_identical(data):
    X, y = data["X"], data["y3"]
    expected = jax_trees.DecisionTreeClassifier(max_depth=DEPTH).fit(X, y)
    got = trees.DecisionTreeClassifier(max_depth=DEPTH, device="cpu").fit(X, y)
    np.testing.assert_array_equal(got.features_heap.numpy(), np.asarray(expected.features_heap))
    np.testing.assert_array_equal(got.thresholds_heap.numpy(), np.asarray(expected.thresholds_heap))
    np.testing.assert_allclose(got.leaf_probs.numpy(), np.asarray(expected.leaf_probs), rtol=0, atol=1e-6)
    accuracy, weighted_f1, labels, probs = got.evaluate_predict(X, y, X)
    ref_accuracy, ref_f1, ref_labels, ref_probs = expected.evaluate_predict(X, y, X)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-6)
    np.testing.assert_allclose([accuracy, weighted_f1], [ref_accuracy, ref_f1], rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.evaluate(X, y), expected.evaluate(X, y), rtol=0, atol=1e-7)


def test_gbt_fit_identical(data):
    expected = jax_trees._gbt_fit(
        jnp.asarray(data["bins"]), jnp.asarray(data["y2"]), jnp.asarray(data["weights"]),
        DEPTH, BINS, ROUNDS, jnp.float32(STEP),
    )
    f0, features_heap, bins_heap, leaf_values, margins = trees._gbt_fit(
        t(data["bins"]), t(data["y2"].astype(np.int64)), t(data["weights"]), DEPTH, BINS, ROUNDS, STEP
    )
    np.testing.assert_array_equal(features_heap.numpy(), np.asarray(expected[1]))
    np.testing.assert_array_equal(bins_heap.numpy(), np.asarray(expected[2]))
    np.testing.assert_allclose(float(f0), float(expected[0]), **GB_TOL)
    np.testing.assert_allclose(leaf_values.numpy(), np.asarray(expected[3]), **GB_TOL)
    assert margins.shape == (ROWS,) and (features_heap.numpy() >= 0).sum() >= 4 * ROUNDS


def test_gbt_estimator_matches_reference(data):
    X, y = data["X"], data["y2"]
    expected = jax_trees.GBTClassifier(rounds=ROUNDS, max_depth=DEPTH).fit(X, y)
    got = trees.GBTClassifier(rounds=ROUNDS, max_depth=DEPTH, device="cpu").fit(X, y)
    np.testing.assert_array_equal(got.features_heap.numpy(), np.asarray(expected.features_heap))
    np.testing.assert_array_equal(got.thresholds_heap.numpy(), np.asarray(expected.thresholds_heap))
    np.testing.assert_allclose(got.f0, float(expected.f0), **GB_TOL)
    labels, probs = got.predict_both(X)
    ref_labels, ref_probs = expected.predict_both(X)
    np.testing.assert_allclose(probs, ref_probs, **GB_TOL)
    # a label may only differ where the reference's probability is a tie
    assert (labels != ref_labels).sum() == 0 or np.abs(ref_probs[labels != ref_labels, 1] - 0.5).max() < 1e-5


def test_gbt_zero_rounds_is_the_base_rate(data):
    expected = jax_trees._gbt_fit(
        jnp.asarray(data["bins"]), jnp.asarray(data["y2"]), jnp.asarray(data["weights"]),
        DEPTH, BINS, 0, jnp.float32(STEP),
    )
    got = trees._gbt_fit(
        t(data["bins"]), t(data["y2"].astype(np.int64)), t(data["weights"]), DEPTH, BINS, 0, STEP
    )
    for array, reference in zip(got[1:4], expected[1:4]):
        assert tuple(array.shape) == np.asarray(reference).shape
    np.testing.assert_allclose(float(got[0]), float(expected[0]), **GB_TOL)


def test_gbt_refuses_more_than_two_classes(data):
    with pytest.raises(ValueError, match="binary labels only"):
        trees.GBTClassifier(device="cpu").fit(data["X"], data["y3"])


@pytest.mark.parametrize("name", ["dt", "gb"])
def test_fit_checkpoints_cross_over(data, name, tmp_path):
    """A port-fit model saved by the port loads and predicts the same in
    the JAX package, and a JAX-fit one the other way; the two fits' heaps
    are the same."""
    X, y = data["X"], data["y2"]
    rows = make_data(seed=9)[0][:300]
    port_model = make_classifier(name, device="cpu")
    port_model.max_depth = DEPTH
    if name == "gb":
        port_model.rounds = ROUNDS
    port_model = port_model.fit(X, y)
    port_path = str(tmp_path / "port.model")
    checkpoint.save_model(port_model, port_path)
    jax_labels, jax_probs = jax_checkpoint.load_model(port_path).predict_both(rows)
    labels, probs = port_model.predict_both(rows)
    np.testing.assert_array_equal(jax_labels, labels)
    np.testing.assert_allclose(jax_probs, probs, rtol=0, atol=1e-6)

    jax_estimator = jax_trees.DecisionTreeClassifier(max_depth=DEPTH) if name == "dt" else (
        jax_trees.GBTClassifier(rounds=ROUNDS, max_depth=DEPTH)
    )
    jax_model = jax_estimator.fit(X, y)
    jax_path = str(tmp_path / "jax.model")
    jax_checkpoint.save_model(jax_model, jax_path)
    ported = checkpoint.load_model(jax_path, device="cpu")
    labels, probs = ported.predict_both(rows)
    ref_labels, ref_probs = jax_model.predict_both(rows)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-6)
    port_arrays = checkpoint.read_checkpoint(port_path)[1]
    jax_arrays = checkpoint.read_checkpoint(jax_path)[1]
    for key in ("features_heap", "thresholds_heap"):
        np.testing.assert_array_equal(port_arrays[key], jax_arrays[key])


# --------------------------------------------------------------------------
# base: segmentation and the classifier switcher
# --------------------------------------------------------------------------

def test_segment_steps_matches_reference():
    for total in (0, 1, 2, 5, 20, 37, 100):
        for rows in (0, 1, 1000, 10**6, 10**7):
            for budget in (40e6, 1e3, 1e9):
                for features in (1, 16, 64):
                    assert base.segment_steps(total, rows, budget, features) == (
                        jax_base.segment_steps(total, rows, budget, features)
                    ), (total, rows, budget, features)
    for total in (1, 12, 20, 97):
        for cap in (0, 1, 5, 50):
            for multiple_of in (1, 2):
                if total % multiple_of == 0:
                    assert base.largest_divisor(total, cap, multiple_of) == (
                        jax_base.largest_divisor(total, cap, multiple_of)
                    )


def test_make_classifier():
    assert CLASSIFIER_NAMES == jax_base.CLASSIFIER_NAMES
    assert isinstance(make_classifier("dt", device="cpu"), trees.DecisionTreeClassifier)
    assert isinstance(make_classifier("gb", device="cpu"), trees.GBTClassifier)
    assert isinstance(make_classifier("lr", device="cpu"), logistic.LogisticRegression)
    assert isinstance(make_classifier("nb", device="cpu"), naive_bayes.NaiveBayes)
    assert isinstance(make_classifier("rf", device="cpu"), trees.RandomForestClassifier)
    with pytest.raises(KeyError):
        make_classifier("svm", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_classifier("dt")


# --------------------------------------------------------------------------
# Wrappers: the plain version on the CPU, operands checked
# --------------------------------------------------------------------------

def test_fit_wrappers_take_the_plain_path_on_cpu(data):
    bins, thresholds = t(data["bins"]), t(data["thresholds32"])
    node = t(np.random.default_rng(1).integers(0, 4, ROWS).astype(np.int32))
    channels = t(channels_for("newton", data["y2"], data["weights"], seed=1))
    kernels.reset_launches()
    assert torch.equal(binning.apply_bins(t(data["X"]), thresholds), binning._apply_bins(t(data["X"]), thresholds))
    hist = trees.level_histograms(bins, node, channels, 4, BINS)
    assert torch.equal(hist, trees._level_histograms(bins, node, channels, 4, BINS))
    feature, bin_index = trees.select_splits(hist, "newton")
    plain = trees._select_splits(trees._newton_gain(hist))
    assert torch.equal(feature, plain[0]) and torch.equal(bin_index, plain[1])
    routed = trees.route(bins, node, feature, bin_index)
    assert torch.equal(routed, trees._route(bins, node, feature, bin_index))
    assert torch.equal(trees.leaf_sums(routed, channels, 8), trees._leaf_sums(routed, channels, 8))
    assert set(kernels.launches().values()) == {0}


def test_fit_wrappers_refuse_what_the_kernels_do_not_take(data):
    X, bins, thresholds = t(data["X"]), t(data["bins"]), t(data["thresholds32"])
    node = torch.zeros(ROWS, dtype=torch.int32)
    channels = t(channels_for("one_hot", data["y3"], data["weights"], seed=0))
    with pytest.raises(TypeError):
        binning.apply_bins(X.double(), thresholds)
    with pytest.raises(ValueError):
        binning.apply_bins(X[:, :3], thresholds)
    with pytest.raises(TypeError):
        trees.level_histograms(bins.float(), node, channels, 1, BINS)
    with pytest.raises(TypeError):
        trees.level_histograms(bins, node.long(), channels, 1, BINS)
    with pytest.raises(TypeError):
        trees.level_histograms(bins, node, channels.double(), 1, BINS)
    with pytest.raises(ValueError):
        trees.level_histograms(bins, node, channels[:10], 1, BINS)
    hist = trees.level_histograms(bins, node, channels, 1, BINS)
    with pytest.raises(TypeError):
        trees.select_splits(hist.double(), "gini")
    with pytest.raises(ValueError):
        trees.select_splits(hist, "entropy")
    with pytest.raises(ValueError):   # newton takes (g, h): K = 2
        trees.select_splits(hist, "newton")
    feature, bin_index = trees.select_splits(hist, "gini")
    with pytest.raises(TypeError):
        trees.route(bins, node, feature.long(), bin_index)
    with pytest.raises(ValueError):
        trees.route(bins, node, feature, bin_index[:0])
    with pytest.raises(TypeError):
        trees.leaf_sums(node.long(), channels, 2)
    with pytest.raises(ValueError):
        trees.leaf_sums(node[:5], channels, 2)
    with pytest.raises(ValueError):   # a CPU tensor is no kernel operand
        kernels.check_operands(bins)


# --------------------------------------------------------------------------
# Any bin count and any level width (the kernels' size limits)
# --------------------------------------------------------------------------

def _covered_once(windows, total):
    counts = np.zeros(total, np.int64)
    for begin, count in windows:
        counts[begin : begin + count] += 1
    return bool((counts == 1).all())


@pytest.mark.parametrize(
    "n_nodes,max_bins,channels,bin_bytes",
    [(2048, 32, 10, 1), (2048, 32, 2, 1), (448, 32, 2, 1), (2048, 255, 10, 4),
     (64, 255, 200, 4), (4, 30000, 2, 4), (16, 32, 2, 1)],
)
def test_level_tiling_covers_every_cell_once(n_nodes, max_bins, channels, bin_bytes):
    """K2's sums path covers every node, bin and channel exactly once with
    its windows, and a block's shared memory (a float64 copy of its
    window's cells for each of its warps, beside each warp's staged rows)
    fits a block; every feature of a node shares a block, in one pass,
    when their copies fit one."""
    tiling = trees._block_features(16, n_nodes, max_bins, channels, bin_bytes)
    assert _covered_once(trees._windows(n_nodes, tiling.nodes), n_nodes)
    assert _covered_once(trees._windows(max_bins, tiling.bins), max_bins)
    assert _covered_once(trees._windows(channels, tiling.channels), channels)
    shared = trees._sum_shared_bytes(tiling, bin_bytes)
    assert 1 <= tiling.block_features <= 16 and shared <= kernels.SHARED_BYTES
    whole = trees._sum_shared_bytes(trees.HistogramTiling(1, max_bins, channels, 16), bin_bytes)
    one_pass = tiling.block_features == 16 and tiling[1:3] == (max_bins, channels)
    assert one_pass == (whole <= kernels.SHARED_BYTES)


@pytest.mark.parametrize("n_leaves,channels", [(4096, 10), (32, 2), (4096, 2), (8, 40000)])
def test_leaf_tiling_covers_every_leaf_once(n_leaves, channels):
    tiling = trees._leaf_warps(n_leaves, channels)
    assert _covered_once(trees._windows(n_leaves, tiling.leaves), n_leaves)
    assert _covered_once(trees._windows(channels, tiling.channels), channels)
    assert tiling.leaves * tiling.channels * 8 * tiling.warps <= kernels.SHARED_BYTES


def test_dt_fit_at_255_bins_identical(data):
    """int32 bins past 127: binning, histograms and routes all take them."""
    X, y = data["X"], data["y3"]
    expected = jax_trees.DecisionTreeClassifier(max_depth=DEPTH, max_bins=255).fit(X, y)
    got = trees.DecisionTreeClassifier(max_depth=DEPTH, max_bins=255, device="cpu").fit(X, y)
    np.testing.assert_array_equal(got.features_heap.numpy(), np.asarray(expected.features_heap))
    np.testing.assert_array_equal(got.thresholds_heap.numpy(), np.asarray(expected.thresholds_heap))
    np.testing.assert_allclose(got.leaf_probs.numpy(), np.asarray(expected.leaf_probs), rtol=0, atol=1e-6)
    thresholds = binning.make_thresholds(X, 255).astype(np.float32)
    bins = binning.apply_bins(t(X), t(thresholds))
    assert bins.dtype == torch.int32 and int(bins.max()) > 127


def test_dt_fit_at_depth_12_identical(data):
    """A level of 2,048 nodes (past one block's shared memory at any K)."""
    expected = jax_trees._dt_fit(
        jnp.asarray(data["bins"]), jnp.asarray(data["y3"]), jnp.asarray(data["weights"]),
        num_classes=CLASSES, max_depth=12, max_bins=BINS,
    )
    got = trees._dt_fit(
        t(data["bins"]), t(data["y3"].astype(np.int64)), t(data["weights"]), CLASSES, 12, BINS
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(expected[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(expected[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(expected[2]), rtol=0, atol=1e-6)
    assert (got[0].numpy()[2**11 - 1 :] >= 0).any()   # the last level still splits
