"""The port's random-forest fit held against the JAX reference on the CPU.

The port (learningorchestra_tpu_torch/ml/trees.py) and the JAX package
(learningorchestra_tpu/ml/trees.py) get the same seeded numpy inputs:
2,003 rows x 6 features with NaN in some values and one feature that is
NaN throughout, one feature of few distinct values (tied gains), 3
classes, 4 trees of depth 3 and feature subsets of 3 (``ceil(sqrt(6))``).

The reference draws each tree's Poisson(1) bootstrap and each node's
feature scores from threefry keys; the port takes its draws as inputs.
The tests rebuild the reference's draws with ``jax.random`` exactly as
``_rf_chunk`` and ``_select_splits`` make them (``keys = split(key(seed),
T)``; per tree ``bootstrap_key, subset_key = split(key)``; ``poisson(
bootstrap_key, 1.0, (rows,))`` and ``uniform(fold_in(subset_key, level),
(2^level, F))``) and hand them to the port. The reference draws its scores
in float64 here (the tests run JAX with x64); the port's are float32, and
the tests check that the cast makes no two scores of a node equal, so
each node's subset is the same.

Tolerances, and why:
- heaps (features, split bins, thresholds), routes, class counts and
  splits: identical. The bootstrap weights are small integers, so every
  sum is an exact integer in either package, and the gains round in the
  reference's order.
- leaf probabilities: 1e-6 (one float32 division of exact counts).
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
from learningorchestra_tpu.ml import trees as jax_trees  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import checkpoint, make_classifier, trees  # noqa: E402

ROWS, FEATURES, DEPTH, TREES, CLASSES, BINS = 2003, 6, 3, 4, 3, 32
SUBSET_K = 3
PROB_TOL = dict(rtol=0, atol=1e-6)


def t(array):
    return torch.from_numpy(np.array(array))


def make_data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, FEATURES)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:, 3] = np.round(X[:, 3] * 2)     # few distinct values: empty bins, tied gains
    X[:, 5] = np.nan                    # NaN throughout: never split
    score = (
        np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) + 0.7 * np.nan_to_num(X[:, 3])
        + rng.normal(scale=0.5, size=ROWS)
    )
    return X, np.digitize(score, [-0.8, 0.8]).astype(np.int32)


@pytest.fixture(scope="module")
def data():
    X, y = make_data()
    thresholds = jax_binning.make_thresholds(X).astype(np.float32)
    bins = np.asarray(jax_binning.apply_bins(jnp.asarray(X), jnp.asarray(thresholds)))
    weights = np.ones(ROWS, np.float32)
    weights[-40:] = 0.0   # rows that count for nothing, as padding does
    return {"X": X, "y": y, "bins": bins, "weights": weights}


def reference_draws(seed, num_trees, rows, max_depth=DEPTH, num_features=FEATURES):
    """The reference's draws of ``_rf_fit(..., key(seed), ...)``, rebuilt
    with ``jax.random`` and cast to the port's float32."""
    bootstrap, scores = [], []
    for tree_key in jax.random.split(jax.random.key(seed), num_trees):
        bootstrap_key, subset_key = jax.random.split(tree_key)
        bootstrap.append(np.asarray(jax.random.poisson(bootstrap_key, 1.0, (rows,))))
        scores.append(np.concatenate([
            np.asarray(jax.random.uniform(jax.random.fold_in(subset_key, level), (2**level, num_features)))
            for level in range(max_depth)
        ]))
    bootstrap = np.stack(bootstrap).astype(np.float32)
    scores = np.stack(scores).reshape(num_trees, 2**max_depth - 1, num_features)
    scores32 = scores.astype(np.float32)
    # the cast keeps every node's order, and makes no two scores equal
    assert (np.diff(np.sort(scores32, axis=-1), axis=-1) > 0).all()
    return trees.ForestDraws(t(bootstrap), t(scores32))


def assert_same_forest(got, expected):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(expected[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(expected[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(expected[2]), **PROB_TOL)


def port_rf_fit(data, draws, num_trees=TREES, subset_k=SUBSET_K, max_depth=DEPTH):
    return trees._rf_fit(
        t(data["bins"]), t(data["y"].astype(np.int64)), t(data["weights"]), draws,
        CLASSES, max_depth, BINS, num_trees, subset_k,
    )


def reference_rf_fit(data, seed, num_trees=TREES, subset_k=SUBSET_K, max_depth=DEPTH):
    return jax_trees._rf_fit(
        jnp.asarray(data["bins"]), jnp.asarray(data["y"]), jnp.asarray(data["weights"]),
        jax.random.key(seed), CLASSES, max_depth, BINS, num_trees, subset_k, mesh=None,
    )


# --------------------------------------------------------------------------
# The whole fit, fed the reference's draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,subset_k", [(0, SUBSET_K), (7, SUBSET_K), (3, 1), (5, FEATURES)])
def test_rf_fit_identical_to_reference(data, seed, subset_k):
    """subset_k 1: one feature a node; 6 = F: no subsets at all."""
    expected = reference_rf_fit(data, seed, subset_k=subset_k)
    got = port_rf_fit(data, reference_draws(seed, TREES, ROWS), subset_k=subset_k)
    assert_same_forest(got, expected)
    assert got[0].shape == (TREES, 2**DEPTH - 1) and got[2].shape == (TREES, 2**DEPTH, CLASSES)
    assert (got[0].numpy() >= 0).sum() >= 2 * TREES   # the trees really split


def test_rf_estimator_identical_to_reference(data):
    """The reference pads its rows to the mesh and draws a bootstrap for
    every padded row; the padded rows weigh 0, so the port takes the
    draws of the real rows."""
    X, y = data["X"], data["y"]
    seed = 11
    expected = jax_trees.RandomForestClassifier(num_trees=TREES, max_depth=DEPTH, seed=seed).fit(X, y)
    padded = jax_base.prepare_xy(X, y, jax_base.resolve_mesh(None))[0].shape[0]
    assert padded > ROWS
    draws = reference_draws(seed, TREES, padded)
    estimator = trees.RandomForestClassifier(num_trees=TREES, max_depth=DEPTH, seed=seed, device="cpu")
    got = estimator._fit_with_draws(X, y, trees.ForestDraws(draws.bootstrap[:, :ROWS], draws.subset_scores))
    np.testing.assert_array_equal(got.features_heap.numpy(), np.asarray(expected.features_heap))
    np.testing.assert_array_equal(got.thresholds_heap.numpy(), np.asarray(expected.thresholds_heap))
    np.testing.assert_allclose(got.leaf_probs.numpy(), np.asarray(expected.leaf_probs), **PROB_TOL)
    accuracy, weighted_f1, labels, probs = got.evaluate_predict(X, y, X)
    ref_accuracy, ref_f1, ref_labels, ref_probs = expected.evaluate_predict(X, y, X)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, **PROB_TOL)
    np.testing.assert_allclose([accuracy, weighted_f1], [ref_accuracy, ref_f1], rtol=0, atol=1e-7)
    assert accuracy > 0.5


@pytest.mark.parametrize("cap", ["budget", "memory"])
def test_rf_chunked_equals_unchunked(data, cap, monkeypatch):
    """Chunks of trees, by the watchdog budget or by the memory cap, grow
    the same forest as one chunk."""
    draws = reference_draws(0, TREES, ROWS)
    whole = port_rf_fit(data, draws)
    calls = []
    chunk = trees._rf_chunk
    monkeypatch.setattr(trees, "_rf_chunk", lambda *args: calls.append(1) or chunk(*args))
    if cap == "budget":
        # two trees a chunk: segment_steps costs a row at F / 16
        monkeypatch.setattr(trees, "_RF_ROW_TREES_BUDGET", 2.5 * ROWS * FEATURES / 16)
    else:
        per_tree = trees._rf_tree_bytes(t(data["bins"]), CLASSES, DEPTH, BINS)
        monkeypatch.setattr(trees, "_RF_CHUNK_BYTES", 1.5 * per_tree)
    chunked = port_rf_fit(data, draws)
    assert len(calls) == (2 if cap == "budget" else TREES)
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)


def test_rf_memory_cap_counts_rows_and_partials():
    """The cap at the default forest: 24 B a row-tree (node, routed node,
    bootstrap, weighted bootstrap, two class channels) and the depth-4
    level's float32 histogram (16 x 16 x 32 x 2 cells), which K2's counts
    path fills in place: it keeps no partials; the 20 default trees run as
    one chunk."""
    bins = torch.empty((1_000_000, 16), dtype=torch.int8, device="meta")
    per_tree = trees._rf_tree_bytes(bins, 2, 5, 32)
    assert per_tree == 1_000_000 * 24 + 16 * 16 * 32 * 2 * 4
    assert int(trees._RF_CHUNK_BYTES // per_tree) >= trees.NUM_TREES


def test_rf_empty_forest(data):
    expected = reference_rf_fit(data, 0, num_trees=0)
    got = port_rf_fit(data, trees.ForestDraws(
        torch.zeros((0, ROWS)), torch.zeros((0, 2**DEPTH - 1, FEATURES))
    ), num_trees=0)
    for array, reference in zip(got, expected):
        assert tuple(array.shape) == np.asarray(reference).shape
        assert array.dtype == {np.dtype("int32"): torch.int32, np.dtype("float32"): torch.float32}[
            np.asarray(reference).dtype
        ]
    model = trees._TreeEnsembleModel(got[0], got[1].float(), got[2], DEPTH)
    np.testing.assert_allclose(model.predict_proba(data["X"][:5]), 1.0 / CLASSES)


def test_rf_fit_refuses_draws_of_another_shape(data):
    draws = reference_draws(0, TREES, ROWS)
    with pytest.raises(ValueError, match="draws"):
        port_rf_fit(data, trees.ForestDraws(draws.bootstrap[:, :10], draws.subset_scores))
    with pytest.raises(ValueError, match="draws"):
        port_rf_fit(data, draws, max_depth=DEPTH + 1)


# --------------------------------------------------------------------------
# The level programs with a tree axis
# --------------------------------------------------------------------------

def forest_inputs(data, n_nodes, seed):
    rng = np.random.default_rng(seed)
    node = rng.integers(0, n_nodes, (TREES, ROWS)).astype(np.int32)
    bootstrap = rng.poisson(1.0, (TREES, ROWS)).astype(np.float32)
    one_hot = np.eye(CLASSES, dtype=np.float32)[data["y"]]
    channels = one_hot[None] * (data["weights"][None] * bootstrap)[:, :, None]
    feature = rng.integers(-1, FEATURES, (TREES, n_nodes)).astype(np.int32)
    bin_index = rng.integers(0, BINS, (TREES, n_nodes)).astype(np.int32)
    return node, channels, feature, bin_index


@pytest.mark.parametrize("level", [0, 2, 5])   # 2^5 nodes x 3 classes: the reference's scatter
def test_forest_level_programs_match_the_reference_vmap(data, level):
    """K2, K4 and K5 over a tree axis against the reference's functions
    under ``jax.vmap`` over trees, as ``_rf_chunk`` runs them."""
    n_nodes = 2**level
    node, channels, feature, bin_index = forest_inputs(data, n_nodes, seed=level)
    bins = jnp.asarray(data["bins"])
    expected = jax.vmap(lambda n, c: jax_trees._level_histograms(bins, n, c, n_nodes, BINS))(
        jnp.asarray(node), jnp.asarray(channels)
    )
    got = trees.level_histograms(t(data["bins"]), t(node), t(channels), n_nodes, BINS)
    assert got.shape == (TREES, n_nodes, FEATURES, BINS, CLASSES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    expected = jax.vmap(lambda n, f, b: jax_trees._route(bins, n, f, b))(
        jnp.asarray(node), jnp.asarray(feature), jnp.asarray(bin_index)
    )
    got = trees.route(t(data["bins"]), t(node), t(feature), t(bin_index))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    n_leaves = 2 * n_nodes
    leaf = np.asarray(expected)
    expected = jax.vmap(lambda n, c: jax_trees._leaf_sums(n, c, n_leaves))(
        jnp.asarray(leaf), jnp.asarray(channels)
    )
    got = trees.leaf_sums(t(leaf), t(channels), n_leaves)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


@pytest.mark.parametrize("program", ["level_histograms", "select_splits", "route", "leaf_sums"])
def test_forest_twins_equal_a_loop_of_one_tree_twins(data, program):
    """Each plain twin over (T, ...) is the one-tree twin tree by tree."""
    n_nodes = 4
    node, channels, feature, bin_index = (t(a) for a in forest_inputs(data, n_nodes, seed=21))
    bins = t(data["bins"])
    if program == "level_histograms":
        got = trees._level_histograms(bins, node, channels, n_nodes, BINS)
        each = [trees._level_histograms(bins, node[i], channels[i], n_nodes, BINS) for i in range(TREES)]
    elif program == "select_splits":
        hist = trees._level_histograms(bins, node, channels, n_nodes, BINS)
        scores = torch.rand((TREES, n_nodes, FEATURES), generator=torch.Generator().manual_seed(2))
        got = torch.stack(trees._select_plain(hist, "gini", scores, SUBSET_K))
        each = [
            torch.stack(trees._select_plain(hist[i], "gini", scores[i], SUBSET_K))
            for i in range(TREES)
        ]
        got = got.transpose(0, 1)
    elif program == "route":
        got = trees._route(bins, node, feature, bin_index)
        each = [trees._route(bins, node[i], feature[i], bin_index[i]) for i in range(TREES)]
    else:
        got = trees._leaf_sums(node, channels, n_nodes)
        each = [trees._leaf_sums(node[i], channels[i], n_nodes) for i in range(TREES)]
    assert torch.equal(got, torch.stack(each))


@pytest.mark.parametrize("mode", ["gini", "newton"])
@pytest.mark.parametrize("subset_k", [1, 2, 5])
def test_select_splits_with_subsets_match_reference(data, mode, subset_k):
    """Splits of a level-2 forest histogram, each node restricted to the
    reference's own subset; in tree 0, node 1's allowed features hold no
    rows (every allowed gain -inf: a leaf at bin 0), and under newton a
    NaN sits in a feature outside node 2's subset (-inf there, not NaN)."""
    n_nodes = 4
    node, channels, _, _ = forest_inputs(data, n_nodes, seed=subset_k)
    if mode == "newton":
        rng = np.random.default_rng(subset_k)
        p = (1 / (1 + np.exp(-rng.normal(size=(TREES, ROWS))))).astype(np.float32)
        channels = np.stack([p - (data["y"] > 0), np.maximum(p * (1 - p), 1e-6)], axis=-1).astype(np.float32)
    hist = np.asarray(trees._level_histograms(t(data["bins"]), t(node), t(channels), n_nodes, BINS))
    key = jax.random.key(subset_k)
    scores = np.asarray(jax.random.uniform(key, (TREES * n_nodes, FEATURES)))
    kth = np.sort(scores, axis=1)[:, subset_k - 1 : subset_k]
    allowed = (scores <= kth).reshape(TREES, n_nodes, FEATURES)
    hist[0, 1][allowed[0, 1]] = 0.0
    if mode == "newton":
        hist[0, 2, np.flatnonzero(~allowed[0, 2])[0], 3, 0] = np.nan
    flat = jnp.asarray(hist.reshape(TREES * n_nodes, FEATURES, BINS, -1))
    gain = (jax_trees._gini_gain if mode == "gini" else jax_trees._newton_gain)(flat)
    feature, bin_index = jax_trees._select_splits(gain, key, subset_k)
    feature = np.asarray(feature).reshape(TREES, n_nodes)
    bin_index = np.asarray(bin_index).reshape(TREES, n_nodes)
    assert feature[0, 1] == -1 and bin_index[0, 1] == 0
    scores32 = t(scores.astype(np.float32)).reshape(TREES, n_nodes, FEATURES)
    for select in (trees._select_plain, trees.select_splits):
        got_feature, got_bin = select(t(hist), mode, scores32, subset_k)
        np.testing.assert_array_equal(got_feature.numpy(), feature)
        np.testing.assert_array_equal(got_bin.numpy(), bin_index)
        allowed_feature = got_feature.numpy() >= 0
        chosen = np.take_along_axis(allowed, np.maximum(got_feature.numpy(), 0)[..., None], -1)[..., 0]
        assert chosen[allowed_feature].all()


def test_forest_wrappers_take_the_plain_path_on_cpu(data):
    node, channels, feature, bin_index = (t(a) for a in forest_inputs(data, 4, seed=3))
    bins = t(data["bins"])
    scores = torch.rand((TREES, 4, FEATURES), generator=torch.Generator().manual_seed(0))
    kernels.reset_launches()
    hist = trees.level_histograms(bins, node, channels, 4, BINS)
    assert torch.equal(hist, trees._level_histograms(bins, node, channels, 4, BINS))
    split = trees.select_splits(hist, "gini", scores, SUBSET_K)
    plain = trees._select_plain(hist, "gini", scores, SUBSET_K)
    assert all(torch.equal(a, b) for a, b in zip(split, plain)) and split[0].shape == (TREES, 4)
    routed = trees.route(bins, node, *split)
    assert torch.equal(routed, trees._route(bins, node, *split))
    assert torch.equal(trees.leaf_sums(routed, channels, 8), trees._leaf_sums(routed, channels, 8))
    assert set(kernels.launches().values()) == {0}


def test_forest_wrappers_refuse_what_the_kernels_do_not_take(data):
    node, channels, feature, bin_index = (t(a) for a in forest_inputs(data, 4, seed=3))
    bins = t(data["bins"])
    with pytest.raises(TypeError):     # a forest's channels for one tree's nodes
        trees.level_histograms(bins, node[0], channels, 4, BINS)
    with pytest.raises(ValueError):    # channels of another tree count
        trees.level_histograms(bins, node, channels[:2], 4, BINS)
    hist = trees.level_histograms(bins, node, channels, 4, BINS)
    scores = torch.rand((TREES, 4, FEATURES))
    with pytest.raises(ValueError):    # scores of another shape
        trees.select_splits(hist, "gini", scores[:, :2], SUBSET_K)
    with pytest.raises(ValueError):    # scores of another type
        trees.select_splits(hist, "gini", scores.double(), SUBSET_K)
    with pytest.raises(ValueError):    # no subset size
        trees.select_splits(hist, "gini", scores, 0)
    with pytest.raises(ValueError):    # splits of another tree count
        trees.route(bins, node, feature[:2], bin_index[:2])
    with pytest.raises(ValueError):
        trees.leaf_sums(node, channels[:2], 8)


# --------------------------------------------------------------------------
# The estimator, its draws, the switcher and checkpoints
# --------------------------------------------------------------------------

def test_forest_draws_repeat_from_a_seed():
    def draws(seed):
        return trees._forest_draws(5, 300, 4, 7, torch.Generator().manual_seed(seed), "cpu")

    first, again, other = draws(3), draws(3), draws(4)
    assert first.bootstrap.shape == (5, 300) and first.subset_scores.shape == (5, 15, 7)
    assert first.bootstrap.dtype == first.subset_scores.dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first.bootstrap, other.bootstrap)
    assert torch.equal(first.bootstrap, first.bootstrap.round()) and (first.bootstrap >= 0).all()
    assert abs(float(first.bootstrap.mean()) - 1.0) < 0.15
    assert ((first.subset_scores >= 0) & (first.subset_scores < 1)).all()


def test_rf_estimator_fits_and_refits_bit_for_bit(data):
    X, y = data["X"], data["y"]
    estimator = make_classifier("rf", device="cpu")
    assert isinstance(estimator, trees.RandomForestClassifier)
    assert (estimator.num_trees, estimator.max_depth, estimator.max_bins, estimator.seed) == (20, 5, 32, 0)
    estimator.num_trees, estimator.max_depth = TREES, DEPTH
    model = estimator.fit(X, y)
    again = estimator.fit(X, y)
    for name in ("features_heap", "thresholds_heap", "leaf_probs"):
        assert torch.equal(getattr(model, name), getattr(again, name))
    assert model.features_heap.shape == (TREES, 2**DEPTH - 1)
    accuracy, weighted_f1 = model.evaluate(X, y)
    assert 0.5 < accuracy <= 1.0 and 0 < weighted_f1 <= 1.0
    estimator.seed = 1
    assert not torch.equal(estimator.fit(X, y).leaf_probs, model.leaf_probs)


def test_rf_checkpoint_loads_in_the_jax_package(data, tmp_path):
    """An rf fitted by the port, saved as ``tree_ensemble``, predicts the
    same in the JAX package."""
    X, y = data["X"], data["y"]
    model = trees.RandomForestClassifier(num_trees=TREES, max_depth=DEPTH, device="cpu").fit(X, y)
    path = str(tmp_path / "rf.model")
    checkpoint.save_model(model, path)
    assert checkpoint.read_checkpoint(path)[0] == "tree_ensemble"
    rows = make_data(seed=9)[0][:300]
    jax_labels, jax_probs = jax_checkpoint.load_model(path).predict_both(rows)
    labels, probs = model.predict_both(rows)
    np.testing.assert_array_equal(jax_labels, labels)
    np.testing.assert_allclose(jax_probs, probs, **PROB_TOL)
