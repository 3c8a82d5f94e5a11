"""The arithmetic of the redesigned binning (K1) and split search (K3),
held on the CPU.

The CUDA kernels (learningorchestra_tpu_torch/kernels/csrc/tree_fit.cu)
run only on the card, where chip_smoke.py holds them against their plain
versions. Here numpy models of what each kernel computes, in the order it
computes it, are held against the port's plain version and the JAX
package's function on seeded inputs:

- K1: each feature's thresholds padded with +inf to a power of two and
  searched in ``log2`` branch-free steps (``searchsorted(side="left")``,
  NaN to the last bin), over the jobs of each group of
  ``binning._k1_geometry``. Equal bit for bit to ``binning._apply_bins``
  and to the reference's ``apply_bins``, at 32 bins (int8) and 255
  (int32), on NaN, +-inf, values equal to a threshold, duplicate
  thresholds and an all-inf threshold row; over a job axis in each form.
- K3: float32 with one rounding an operation (numpy's float32 arithmetic,
  no fused multiply-add): each (feature, channel)'s sequential cumulative
  sum, each cell's gain, the first maximum by each thread over its cells
  (bin-major), then warp shuffles and the node's warps in order under the
  kernel's ``better``; feature windows from ``trees._k3_geometry``. Splits
  equal to ``trees._select_plain`` on any float32 histograms, and to the
  reference's ``_select_splits`` of its ``_gini_gain`` or ``_newton_gain``
  on histograms whose cumulative sums are exact in any order (integer
  counts, or (g, h) in 1/64ths): the reference's cumulative sum rounds in
  blocks on the CPU, the kernels and the plain version bin after bin
  (tests/test_torch_fit.py says so too).
- The geometries: every block's shared memory within 232,448 bytes; job
  groups and feature windows covering each job and feature once.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from learningorchestra_tpu.ml import binning as jax_binning  # noqa: E402
from learningorchestra_tpu.ml import trees as jax_trees  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import binning, trees  # noqa: E402

f32 = np.float32
EPS = f32(trees.EPS)
INDEX_SENTINEL = 2**31 - 1
ROWS, FEATURES = 1_500, 6


def t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------

def model_bins(X, thresholds, steps):
    """One job's bins as K1 searches them: the feature's thresholds padded
    with +inf to ``2**steps`` entries, ``steps`` branch-free bisection steps
    (probe ``pos + 2**s - 1``, add ``2**s`` when it is below the value),
    NaN to the last bin."""
    rows, F = X.shape
    n = thresholds.shape[1]
    table = np.full((F, 1 << steps), np.inf, f32)
    table[:, :n] = thresholds
    pos = np.zeros((rows, F), np.int64)
    features = np.arange(F)[None, :]
    for s in reversed(range(steps)):
        probe = table[features, pos + (1 << s) - 1]
        pos += np.where(probe < X, 1 << s, 0)
    pos = np.where(np.isnan(X), n, pos)
    return pos.astype(np.int8 if n + 1 <= binning.INT8_MAX_BINS else np.int32)


def model_job_bins(X, thresholds, share=binning._BIN_SHARE):
    """A job axis as K1 covers it: block groups of ``_k1_geometry``, each
    job of a group searched against its own thresholds, a shared X (2-D)
    read for the whole group, windows of features one after the other."""
    jobs = X.shape[0] if X.ndim == 3 else thresholds.shape[0]
    rows, F = X.shape[-2:]
    n = thresholds.shape[-1]
    bin_bytes = 1 if n + 1 <= binning.INT8_MAX_BINS else 4
    geometry = binning._k1_geometry(F, n, jobs, X.ndim == 2, bin_bytes, share)
    out = np.empty((jobs, rows, F), np.int8 if bin_bytes == 1 else np.int32)
    seen = []
    for first in range(0, jobs, geometry.group):
        for job in range(first, min(jobs, first + geometry.group)):
            seen.append(job)
            rows_x = X if X.ndim == 2 else X[job]
            own = thresholds if thresholds.ndim == 2 else thresholds[job]
            for f0 in range(0, F, geometry.window_features):
                f1 = min(F, f0 + geometry.window_features)
                out[job, :, f0:f1] = model_bins(rows_x[:, f0:f1], own[f0:f1], geometry.steps)
    assert sorted(seen) == list(range(jobs))
    return out


def edge_inputs(max_bins, rows=ROWS, features=FEATURES, seed=0):
    """Seeded rows with NaN, +-inf, values equal to thresholds; thresholds
    of ``max_bins`` bins with duplicates (a feature of few distinct values),
    inf tails and one all-inf row (an all-NaN feature)."""
    rng = np.random.default_rng(seed)
    X = (rng.random((rows, features)) * 20).astype(f32)
    X[:, 1] = rng.integers(0, 4, rows)                    # few distinct values
    X[:, features - 1] = np.nan                           # all NaN: thresholds all inf
    X[rng.random((rows, features)) < 0.03] = np.nan
    with warnings.catch_warnings():   # nanquantile of the all-NaN feature
        warnings.simplefilter("ignore", RuntimeWarning)
        thresholds = binning.make_thresholds(X, max_bins).astype(f32)
    thresholds[2, -3:] = np.inf                           # an inf tail
    X[:7, 0] = [np.inf, -np.inf, -0.0, 0.0, np.nan, thresholds[0, 0], thresholds[0, -1]]
    X[7:10, 2] = [thresholds[2, 4], thresholds[2, 5], np.inf]
    X[10:12, 1] = thresholds[1, :2]                        # ties on duplicate thresholds
    return X, thresholds


@pytest.mark.parametrize("max_bins", [32, 255])
def test_k1_model_matches_the_plain_version_and_the_reference(max_bins):
    X, thresholds = edge_inputs(max_bins)
    assert np.isinf(thresholds[FEATURES - 1]).all()
    assert (np.diff(thresholds[1]) == 0).any()
    steps = binning._k1_geometry(FEATURES, max_bins - 1, 1, True, 1 if max_bins <= 127 else 4).steps
    assert 1 << steps == (32 if max_bins == 32 else 256)
    got = model_bins(X, thresholds, steps)
    assert got.dtype == (np.int8 if max_bins == 32 else np.int32)
    np.testing.assert_array_equal(got, binning._apply_bins(t(X), t(thresholds)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_binning.apply_bins(jnp.asarray(X), jnp.asarray(thresholds))))
    # the wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(binning.apply_bins(t(X), t(thresholds)).numpy(), got)
    assert (got[:, FEATURES - 1] == max_bins - 1).all()


def test_k1_search_at_its_edges():
    """NaN past every threshold (inf ones too), +inf to the first inf
    threshold, -inf and -0.0 to bin 0, a threshold's own value to its bin,
    duplicates to the first of them; padded to 8 entries, 3 steps."""
    thresholds = np.array([[0.0, 1.0, 1.0, 2.0, np.inf, np.inf]], f32)
    X = np.array([[np.nan], [np.inf], [-np.inf], [-0.0], [0.0], [1.0], [2.0], [0.5], [3.0], [1.5]], f32)
    got = model_bins(X, thresholds, 3)
    np.testing.assert_array_equal(got[:, 0], [6, 4, 0, 0, 0, 1, 3, 1, 4, 3])
    np.testing.assert_array_equal(got, binning._apply_bins(t(X), t(thresholds)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_binning.apply_bins(jnp.asarray(X), jnp.asarray(thresholds))))


def _job_inputs(form, jobs, max_bins=32, seed=3):
    X, thresholds = edge_inputs(max_bins, rows=200, seed=seed)
    scale = (1.0 + 1e-3 * np.arange(jobs, dtype=f32))[:, None, None]
    stacked_thresholds = (thresholds[None] * scale).astype(f32)
    stacked_X = np.stack([np.roll(X, 7 * j, axis=0) for j in range(jobs)])
    return {
        "x_shared": (X, stacked_thresholds),
        "thresholds_shared": (stacked_X, thresholds),
        "both_stacked": (stacked_X, stacked_thresholds),
    }[form]


@pytest.mark.parametrize("jobs", [1, 8, 113])
@pytest.mark.parametrize("form", ["x_shared", "thresholds_shared", "both_stacked"])
def test_k1_model_over_a_job_axis(form, jobs):
    """Each job form at 1, 8 and 113 jobs (the 113 of a shared X in three
    groups): equal to the plain twin and to the reference's apply_bins
    vmapped over the jobs."""
    X, thresholds = _job_inputs(form, jobs)
    got = model_job_bins(X, thresholds)
    np.testing.assert_array_equal(got, binning._job_apply_bins(t(X), t(thresholds)).numpy())
    np.testing.assert_array_equal(binning.job_apply_bins(t(X), t(thresholds)).numpy(), got)
    in_axes = (0 if X.ndim == 3 else None, 0 if thresholds.ndim == 3 else None)
    expected = jax.vmap(jax_binning.apply_bins, in_axes=in_axes)(jnp.asarray(X), jnp.asarray(thresholds))
    np.testing.assert_array_equal(got, np.asarray(expected))
    if form == "x_shared" and jobs == 113:
        assert binning._k1_geometry(FEATURES, 31, 113, True, 1).group == 113
        assert binning._k1_geometry(16, 31, 113, True, 1).group == 38   # the sweep's width: three groups


@pytest.mark.parametrize("share", [1024, 384, 64])
def test_k1_windows_and_the_global_table_give_the_same_bins(share):
    """A smaller share takes one job a block (1,024 bytes: the 6 features'
    768), the features in windows (384: 3 at a time, bin by bin) or leaves
    the padded table in global memory (64: not one feature's 128-byte
    row): the bins do not change."""
    X, thresholds = _job_inputs("x_shared", 5)
    geometry = binning._k1_geometry(FEATURES, 31, 5, True, 1, share)
    assert geometry.staged == (share >= 128)
    assert geometry.window_features == {1024: 6, 384: 3, 64: 6}[share]
    assert geometry.group == {1024: 1, 384: 1, 64: 5}[share]
    np.testing.assert_array_equal(model_job_bins(X, thresholds, share), model_job_bins(X, thresholds))
    single, = model_job_bins(X, thresholds[:1], share)
    np.testing.assert_array_equal(single, binning._apply_bins(t(X), t(thresholds[0])).numpy())


K1_SHAPES = [
    (F, n, jobs, x_shared)
    for F in (1, 5, 16, 17, 200)
    for n in (0, 1, 31, 126, 254, 4095, 20_000)
    for jobs in (1, 8, 113)
    for x_shared in (True, False)
]


@pytest.mark.parametrize("bin_bytes", [1, 4])
def test_k1_geometry_covers_every_job_and_feature_once_within_shared_memory(bin_bytes):
    for F, n, jobs, x_shared in K1_SHAPES:
        if bin_bytes == 1 and n + 1 > binning.INT8_MAX_BINS:
            continue
        g = binning._k1_geometry(F, n, jobs, x_shared, bin_bytes)
        assert (1 << g.steps) > n and (g.steps == 0 or (1 << (g.steps - 1)) <= n)
        assert 1 <= g.group <= jobs and (x_shared or g.group == 1)
        groups = [range(first, min(jobs, first + g.group)) for first in range(0, jobs, g.group)]
        assert sorted(j for group in groups for j in group) == list(range(jobs))
        assert all(len(group) > 0 for group in groups)
        if g.staged and g.window_features == F and x_shared:   # as few groups as the share allows
            assert len(groups) == -(-jobs // min(jobs, binning._BIN_SHARE // (F * (4 << g.steps))))
        windows = list(range(0, F, g.window_features))
        assert sorted(f for f0 in windows for f in range(f0, min(F, f0 + g.window_features))) == list(range(F))
        if g.staged:
            assert g.shared_bytes == g.group * g.window_features * (4 << g.steps)
            assert g.shared_bytes <= binning._BIN_SHARE <= kernels.SHARED_BYTES
            if len(windows) > 1 and g.window_features > 16 // bin_bytes:
                assert g.window_features % (16 // bin_bytes) == 0
        else:
            assert g.shared_bytes == 0 and (4 << g.steps) > binning._BIN_SHARE and g.window_features == F
    # the sweep's slots: eight jobs of a shared X, one group, 16 KB
    assert binning._k1_geometry(16, 31, 8, True, 1) == binning.BinGeometry(5, 8, 16, True, 16_384)
    assert binning._k1_geometry(16, 254, 8, True, 4).group == 4


# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------

def better(value_a, index_a, value_b, index_b):
    """tree_fit.cu ``better``: is (value_b, index_b) the better candidate?"""
    nan_a, nan_b = np.isnan(value_a), np.isnan(value_b)
    if nan_a or nan_b:
        return bool(nan_b and (not nan_a or index_b < index_a))
    if value_b != value_a:
        return bool(value_b > value_a)
    return index_b < index_a


def floor_eps(n):
    return np.where(np.isnan(n) | (n > EPS), n, EPS).astype(f32)


def in_subset(scores, subset_k, f):
    return int((scores < scores[f]).sum()) < subset_k


def model_gains(stage, candidate, mode):
    """The window's cell gains ``(B, wf)`` from its staged histogram
    ``(B, wf, K)`` in float32, one rounding an operation: the cumulative
    sums bin after bin, the parents from the totals, each cell's gain with
    its channels from 0 to K - 1, -inf where a side is empty or the feature
    is not a candidate."""
    stage = stage.copy()
    B, wf, K = stage.shape
    for b in range(1, B):
        stage[b] = stage[b - 1] + stage[b]
    total = stage[B - 1]
    left, right = stage, total[None] - stage
    zero = np.zeros((B, wf), f32)
    if mode == "gini":
        n, squares = np.zeros(wf, f32), np.zeros(wf, f32)
        n_left, n_right, sq_left, sq_right = zero.copy(), zero.copy(), zero.copy(), zero.copy()
        for k in range(K):
            n = n + total[:, k]
            squares = squares + total[:, k] * total[:, k]
            n_left = n_left + left[..., k]
            n_right = n_right + right[..., k]
            sq_left = sq_left + left[..., k] * left[..., k]
            sq_right = sq_right + right[..., k] * right[..., k]
        parent = squares / floor_eps(n)
        valid = (n_left > 0) & (n_right > 0)
        gain = (sq_left / floor_eps(n_left) + sq_right / floor_eps(n_right)) - parent[None]
    else:
        one = f32(1.0)
        parent = total[:, 0] * total[:, 0] / (total[:, 1] + one)
        g_left, h_left = left[..., 0], left[..., 1]
        g_right, h_right = right[..., 0], right[..., 1]
        valid = (h_left > EPS) & (h_right > EPS)
        gain = (g_left * g_left / (h_left + one) + g_right * g_right / (h_right + one)) - parent[None]
    gain = np.where(valid & candidate[None], gain, -np.inf).astype(f32)
    return gain


def model_splits(hist, mode, scores=None, subset_k=None, share=kernels.SHARED_BYTES):
    """K3 on ``hist (nodes, F, B, K)``: each node's windows of features
    (``_k3_geometry``) staged bin-major, each thread's first maximum over
    its cells (cell c = b * wf + f of a window to thread c % threads, index
    f * B + b), warp shuffles down by 16, 8, 4, 2, 1, the node's warps in
    order; the leaf rule."""
    nodes, F, B, K = hist.shape
    geometry = trees._k3_geometry(F, B, K, share)
    threads = geometry.node_threads
    features, bins = [], []
    with np.errstate(all="ignore"):
        for node in range(nodes):
            best = [(-np.inf, INDEX_SENTINEL)] * threads
            for f0 in range(0, F, geometry.window_features):
                wf = min(geometry.window_features, F - f0)
                stage = np.ascontiguousarray(hist[node, f0:f0 + wf].transpose(1, 0, 2))
                candidate = np.array([
                    scores is None or in_subset(scores[node], subset_k, f0 + f) for f in range(wf)
                ])
                gain = model_gains(stage, candidate, mode)
                for cell in range(wf * B):
                    b, f = divmod(cell, wf)
                    thread = cell % threads
                    if better(*best[thread], gain[b, f], (f0 + f) * B + b):
                        best[thread] = (gain[b, f], (f0 + f) * B + b)
            warps = []
            for w in range(threads // 32):
                lanes = best[32 * w:32 * (w + 1)]
                for offset in (16, 8, 4, 2, 1):
                    lanes = [
                        lanes[i + offset] if i + offset < 32 and better(*lanes[i], *lanes[i + offset]) else lanes[i]
                        for i in range(32)
                    ]
                warps.append(lanes[0])
            value, index = warps[0]
            for other in warps[1:]:
                if better(value, index, *other):
                    value, index = other
            leaf = not value > 0 or np.isinf(value)
            features.append(-1 if leaf else index // B)
            bins.append(index % B)
    return np.array(features, np.int32), np.array(bins, np.int32)


def reference_splits(hist, mode, scores=None, subset_k=None):
    gain = (jax_trees._gini_gain if mode == "gini" else jax_trees._newton_gain)(jnp.asarray(hist))
    if scores is None:
        feature, bin_index = jax_trees._select_splits(gain, None, None)
        return np.asarray(feature), np.asarray(bin_index)
    kth = np.sort(scores, axis=1)[:, subset_k - 1]
    allowed = scores <= kth[:, None]
    feature, bin_index = jax_trees._select_splits(jnp.where(allowed[:, :, None], gain, -jnp.inf), None, None)
    return np.asarray(feature), np.asarray(bin_index)


def plain_splits(hist, mode, scores=None, subset_k=None):
    feature, bin_index = trees._select_plain(t(hist), mode, None if scores is None else t(scores), subset_k)
    return feature.numpy(), bin_index.numpy()


def split_inputs(mode, nodes, F, B, K, seed, exact=True):
    """Seeded histograms: gini class counts (Poisson, a few empty bins),
    or newton (g, h) sums; ``exact``: in 1/64ths, so that every cumulative
    sum is exact in float32 in any order."""
    rng = np.random.default_rng(seed)
    if mode == "gini":
        hist = rng.poisson(2.0, size=(nodes, F, B, K)).astype(f32)
        hist[:, :, rng.random(B) < 0.1] = 0.0
        return hist
    g = rng.integers(-64, 65, size=(nodes, F, B)) / 64.0
    h = rng.integers(1, 17, size=(nodes, F, B)) / 64.0
    hist = np.stack([g, h], axis=-1).astype(f32)
    if not exact:
        hist = hist + rng.normal(scale=1e-3, size=hist.shape).astype(f32)
    return hist


def assert_same_splits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("max_bins", [32, 255])
@pytest.mark.parametrize("mode,K", [("gini", 2), ("gini", 10), ("newton", 2)])
def test_k3_model_matches_the_plain_version_and_the_reference(mode, K, max_bins):
    nodes = 4 if max_bins == 32 else 2
    hist = split_inputs(mode, nodes, FEATURES, max_bins, K, seed=K + max_bins)
    got = model_splits(hist, mode)
    assert_same_splits(got, plain_splits(hist, mode))
    assert_same_splits(got, reference_splits(hist, mode))
    assert_same_splits(got, tuple(x.numpy() for x in trees.select_splits(t(hist), mode)))
    # float sums that round: the model keeps the plain version's bits
    if mode == "newton":
        rough = split_inputs(mode, nodes, FEATURES, max_bins, K, seed=1, exact=False)
        assert_same_splits(model_splits(rough, mode), plain_splits(rough, mode))


def test_k3_nan_gain_empty_node_and_ties():
    """A NaN gain wins (its node a leaf), the first NaN first; a node with
    no rows is a leaf at bin 0; exactly tied gains go to the first
    (feature, bin), here a feature that repeats an earlier one."""
    rng = np.random.default_rng(11)
    hist = rng.integers(0, 5, size=(4, 5, 32, 2)).astype(f32)
    hist[0] = 0.0
    hist[1, 3] = hist[1, 1]
    newton = split_inputs("newton", 4, 5, 32, 2, seed=2)
    newton[0] = 0.0
    newton[2, 3, 6, 0] = np.nan
    newton[2, 4, 1, 0] = np.nan
    for values, mode in ((hist, "gini"), (newton, "newton")):
        got = model_splits(values, mode)
        assert_same_splits(got, plain_splits(values, mode))
        assert_same_splits(got, reference_splits(values, mode))
        assert (got[0][0], got[1][0]) == (-1, 0)
    gains = model_gains(np.ascontiguousarray(hist[1].transpose(1, 0, 2)), np.ones(5, bool), "gini")
    assert (gains[:, 1] == gains[:, 3]).all() and model_splits(hist, "gini")[0][1] != 3
    assert np.isnan(model_gains(np.ascontiguousarray(newton[2].transpose(1, 0, 2)), np.ones(5, bool), "newton")).any()
    assert model_splits(newton, "newton")[0][2] == -1


@pytest.mark.parametrize("subset_k", [1, 2, 3])
def test_k3_subsets_with_tied_scores(subset_k):
    """Feature subsets (the forest's) whose scores tie in steps of 1/4:
    a feature is a candidate when fewer than subset_k scores lie below its
    own, the reference's ``scores <= kth``."""
    rng = np.random.default_rng(subset_k)
    hist = split_inputs("gini", 6, FEATURES, 32, 2, seed=subset_k)
    scores = (np.floor(rng.random((6, FEATURES)) * 4) / 4).astype(f32)
    got = model_splits(hist, "gini", scores, subset_k)
    assert_same_splits(got, plain_splits(hist, "gini", scores, subset_k))
    assert_same_splits(got, reference_splits(hist, "gini", scores, subset_k))
    assert (scores[:, :, None] == scores[:, None, :]).sum() > scores.size


@pytest.mark.parametrize("share", [65_536, 20_000, 4_096])
def test_k3_feature_windows_give_the_split_of_one_window(share):
    """16 features x 255 bins x 10 classes in one window (164 KB) and in
    windows: of 6 features (64 KB), 1 feature (20,000 bytes), or the stage
    in global scratch (4,096 bytes: not one feature's bins)."""
    hist = split_inputs("gini", 2, 16, 255, 10, seed=5)
    one = trees._k3_geometry(16, 255, 10)
    assert one.window_features == 16 and one.in_shared
    geometry = trees._k3_geometry(16, 255, 10, share)
    assert geometry.in_shared == (share != 4_096)
    assert geometry.window_features == {65_536: 6, 20_000: 1, 4_096: 16}[share]
    got = model_splits(hist, "gini", share=share)
    assert_same_splits(got, model_splits(hist, "gini"))
    assert_same_splits(got, plain_splits(hist, "gini"))


def test_k3_argmax_does_not_depend_on_the_reduction_order(monkeypatch):
    """``better`` is a total order: the model's split is the same at 32,
    64, 128 and 512 threads a node (another split of cells over threads,
    shuffles and warps)."""
    hist = split_inputs("gini", 3, FEATURES, 32, 3, seed=8)
    hist[:, 2] = hist[:, 0]                           # exact ties
    want = model_splits(hist, "gini")
    geometry = trees._k3_geometry
    for threads in (32, 64, 128):
        monkeypatch.setattr(trees, "_k3_geometry",
                            lambda *args, _n=threads: geometry(*args)._replace(node_threads=_n))
        assert_same_splits(model_splits(hist, "gini"), want)


K3_SHAPES = [(F, B, K) for F in (1, 2, 4, 5, 16, 17, 100) for B in (2, 7, 32, 255) for K in (2, 3, 10)]


def test_k3_geometry_within_shared_memory_and_covering_every_feature_once():
    for F, B, K in K3_SHAPES + [(16, 255, 10), (16, 32, 10)]:
        for share in (kernels.SHARED_BYTES, 65_536, 4_096):
            g = trees._k3_geometry(F, B, K, share)
            assert g.node_threads % 32 == 0 and g.node_threads <= trees._SPLIT_THREADS
            assert g.node_threads * g.block_nodes <= trees._SPLIT_THREADS
            assert g.block_nodes == 1 or F * B <= trees._SPLIT_FEW_CELLS
            assert g.shared_bytes == trees._split_shared_bytes(
                g.node_threads, g.block_nodes, g.window_features, F, B, K, g.in_shared)
            assert g.shared_bytes <= share <= kernels.SHARED_BYTES
            windows = range(0, F, g.window_features)
            assert sorted(f for f0 in windows for f in range(f0, min(F, f0 + g.window_features))) == list(range(F))
            if g.in_shared:
                assert g.shared_bytes >= 4 * trees._split_stage_floats(g.window_features, B, K)
    # the fits' shapes, up to 16 x 255 x 10, in one window of shared memory
    for B in (32, 255):
        for K in (2, 10):
            g = trees._k3_geometry(16, B, K)
            assert g.in_shared and g.window_features == 16 and g.shared_bytes <= kernels.SHARED_BYTES
    assert trees._k3_geometry(16, 32, 2).node_threads == 512
    assert trees._k3_geometry(4, 32, 2).block_nodes == 2
