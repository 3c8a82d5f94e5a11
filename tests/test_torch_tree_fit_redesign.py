"""The arithmetic of the redesigned level histogram (K2), held on the CPU.

The CUDA kernels (learningorchestra_tpu_torch/kernels/csrc/tree_fit.cu)
run only on the card, where chip_smoke.py holds them against their plain
version. Here numpy models of what each of K2's two paths computes, in
the order it computes it, are held against the port's plain version
(``ml/trees._level_histograms``) and the JAX package's
``_level_histograms`` on seeded inputs:

- The counts path (channels that the caller states are integers: dt's,
  the forest's and a sweep's class one-hots times integer weights): each
  cell's channels added as integers, in any order, rounded once to
  float32. Equal to both bit for bit.
- The sums path (gb's Newton (g, h)): a cell's partial of a chunk is the
  row-order float64 sum of each warp's part of its block's rows (the
  chunk's, or its node window's when the level is partitioned by window),
  the warps' added in warp order; the chunks' in chunk order; rounded once.
  Within chip_smoke's GB_SUM_RTOL (1e-5) of each cell of the plain version
  (float64 sums in another order: here ~1e-16), and of the reference's
  float32 product within 1e-5, as tests/test_torch_fit.py holds it.
- The geometry: the chunking is a function of the level's shape alone;
  a tree's sums are bit-equal whatever the tree axis; every block's shared
  memory within 232,448 bytes; the windows cover every cell once.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from learningorchestra_tpu.ml import trees as jax_trees  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import trees  # noqa: E402

f32, f64 = np.float32, np.float64
ROWS, FEATURES, BINS = 3_000, 6, 32
TREES = 20
jax_histograms = jax.jit(jax_trees._level_histograms, static_argnums=(3, 4))


def t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


# --------------------------------------------------------------------------
# The models
# --------------------------------------------------------------------------

def model_counts(bins, node, channels, n_nodes, max_bins):
    """The counts path of one tree: each (node, feature, bin, channel)
    cell's channels as integers (an exact sum, whatever the order), then
    rounded once to float32."""
    rows, F = bins.shape
    K = channels.shape[1]
    counts = np.zeros((n_nodes, F, max_bins, K), np.int64)
    values = channels.astype(np.int64)
    for f in range(F):
        for k in range(K):
            np.add.at(counts, (node, f, bins[:, f].astype(np.int64), k), values[:, k])
    return counts.astype(f32)


def model_sums(bins, node, channels, n_nodes, max_bins):
    """The sums path of one tree: the rows in ``trees._sum_chunks`` chunks;
    the cells of each node window (``trees._block_features``) from its
    block's list of rows: the chunk's rows of that window in row order
    when the level is partitioned (``trees._partitioned``), else all of
    the chunk's rows, those of other windows skipped. The list is split in
    ``_SUM_WARPS`` contiguous parts (a warp's); a cell's part sum is its
    rows' channels added in row order in float64 from 0, the parts added
    in warp order, the chunks in chunk order; rounded once. (Feature
    blocks and passes of bins and channels only choose which cells a
    block holds.)"""
    rows, F = bins.shape
    K = channels.shape[1]
    tiling = trees._block_features(F, n_nodes, max_bins, K, bins.itemsize)
    windows = -(-n_nodes // tiling.nodes)
    partitioned = trees._partitioned(windows)
    chunks, per_chunk = trees._sum_chunks(rows, n_nodes, max_bins)
    total = np.zeros((n_nodes, F, max_bins, K), f64)
    for chunk in range(chunks):
        begin, end = chunk * per_chunk, min(rows, (chunk + 1) * per_chunk)
        partial = np.zeros_like(total)
        for window in range(windows):
            first, last = window * tiling.nodes, min(n_nodes, (window + 1) * tiling.nodes)
            listed = [r for r in range(begin, end)
                      if not partitioned or first <= node[r] < last]
            per_warp = -(-len(listed) // trees._SUM_WARPS)
            for warp in range(trees._SUM_WARPS):
                part = np.zeros_like(total)
                for r in listed[warp * per_warp : (warp + 1) * per_warp]:
                    if not first <= node[r] < last:
                        continue
                    for f in range(F):
                        cell = part[node[r], f, bins[r, f]]
                        cell += channels[r].astype(f64)   # in row order, from 0
                partial[first:last] = partial[first:last] + part[first:last]
        total = total + partial
    return total.astype(f32)


def inputs(kind, rows=ROWS, n_nodes=4, max_bins=BINS, bin_dtype=np.int8, seed=0, trees_=None):
    """Seeded bins, nodes and channels: ``gini`` one-hots of 3 classes
    times Poisson(1) counts (the forest's), or ``newton`` (g, h)."""
    rng = np.random.default_rng(seed)
    shape = (rows,) if trees_ is None else (trees_, rows)
    bins = rng.integers(0, max_bins, size=(rows, FEATURES)).astype(bin_dtype)
    node = rng.integers(0, n_nodes, size=shape).astype(np.int32)
    if kind == "gini":
        y = rng.integers(0, 3, size=rows)
        weight = rng.poisson(1.0, size=shape).astype(f32)
        channels = (np.eye(3, dtype=f32)[y] * weight[..., None]).astype(f32)
    else:
        p = 1.0 / (1.0 + np.exp(-rng.normal(size=shape)))
        g, h = p - rng.integers(0, 2, size=shape), np.maximum(p * (1 - p), 1e-6)
        channels = np.stack([g, h], axis=-1).astype(f32)
    return bins, node, channels


def reference(bins, node, channels, n_nodes, max_bins):
    """The JAX package's level histogram: one tree, or vmapped over trees
    (and over a job axis of bins)."""
    if node.ndim == 1:
        return np.asarray(jax_histograms(jnp.asarray(bins), jnp.asarray(node), jnp.asarray(channels),
                                         n_nodes, max_bins))
    if bins.ndim == 3:
        return np.asarray(jax.vmap(lambda b, n, c: jax_trees._level_histograms(b, n, c, n_nodes, max_bins))(
            jnp.asarray(bins), jnp.asarray(node), jnp.asarray(channels)))
    return np.asarray(jax.vmap(lambda n, c: jax_trees._level_histograms(jnp.asarray(bins), n, c, n_nodes,
                                                                        max_bins))(
        jnp.asarray(node), jnp.asarray(channels)))


def plain(bins, node, channels, n_nodes, max_bins):
    return trees._level_histograms(t(bins), t(node), t(channels), n_nodes, max_bins).numpy()


# --------------------------------------------------------------------------
# The counts path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bin_dtype,max_bins", [(np.int8, 32), (np.int32, 255)])
@pytest.mark.parametrize("level", [0, 3])
def test_counts_model_matches_the_plain_version_and_the_reference(bin_dtype, max_bins, level):
    n_nodes = 2**level
    bins, node, channels = inputs("gini", n_nodes=n_nodes, max_bins=max_bins, bin_dtype=bin_dtype, seed=level)
    got = model_counts(bins, node, channels, n_nodes, max_bins)
    np.testing.assert_array_equal(got, plain(bins, node, channels, n_nodes, max_bins))
    np.testing.assert_array_equal(got, reference(bins, node, channels, n_nodes, max_bins))
    # the wrapper takes the plain version on the CPU, the claim checked
    via_wrapper = trees.level_histograms(t(bins), t(node), t(channels), n_nodes, max_bins, integer=True)
    np.testing.assert_array_equal(via_wrapper.numpy(), got)


def test_counts_model_over_twenty_trees_matches_each_tree_alone():
    """A forest's 20 trees over one bins matrix: each tree's counts are
    its launch alone's, and the plain version's and the reference's."""
    bins, node, channels = inputs("gini", n_nodes=8, trees_=TREES, seed=5)
    forest = np.stack([model_counts(bins, node[i], channels[i], 8, BINS) for i in range(TREES)])
    np.testing.assert_array_equal(forest, plain(bins, node, channels, 8, BINS))
    np.testing.assert_array_equal(forest, reference(bins, node, channels, 8, BINS))
    for tree in (0, TREES - 1):
        np.testing.assert_array_equal(forest[tree], model_counts(bins, node[tree], channels[tree], 8, BINS))


def test_counts_model_over_a_job_axis_of_bins():
    """A sweep's jobs, each over its own bins (J, rows, F) and 0/1 masks."""
    rng = np.random.default_rng(9)
    jobs = 3
    bins = rng.integers(0, BINS, size=(jobs, ROWS, FEATURES)).astype(np.int8)
    node = rng.integers(0, 4, size=(jobs, ROWS)).astype(np.int32)
    masks = (np.arange(ROWS)[None] < np.array([ROWS, ROWS - 17, ROWS - 1000])[:, None]).astype(f32)
    channels = (np.eye(2, dtype=f32)[rng.integers(0, 2, size=(jobs, ROWS))] * masks[..., None]).astype(f32)
    got = np.stack([model_counts(bins[j], node[j], channels[j], 4, BINS) for j in range(jobs)])
    np.testing.assert_array_equal(got, plain(bins, node, channels, 4, BINS))
    np.testing.assert_array_equal(got, reference(bins, node, channels, 4, BINS))


@pytest.mark.parametrize("value", [0.5, -1.0, 65536.0, float("nan")])
def test_a_false_integer_claim_raises(value):
    bins, node, channels = inputs("gini", rows=50)
    channels[7, 1] = value
    with pytest.raises(ValueError):
        trees.level_histograms(t(bins), t(node), t(channels), 4, BINS, integer=True)
    # the sums path takes any channels
    trees.level_histograms(t(bins), t(node), t(channels), 4, BINS)


def test_the_gini_fits_state_their_channels_are_integers(monkeypatch):
    """dt, the forest and a sweep's dt program call K2's counts path."""
    from learningorchestra_tpu_torch.ml import sweep

    claims = []
    wrapper = trees.level_histograms
    monkeypatch.setattr(trees, "level_histograms",
                        lambda *args, integer=False: claims.append(integer) or wrapper(*args, integer=integer))
    X = np.random.default_rng(3).random((200, FEATURES)).astype(f32)
    y = (X[:, 0] > 0.5).astype(np.int32)
    trees.DecisionTreeClassifier(max_depth=2, device="cpu").fit(X, y)
    assert claims and all(claims)
    claims.clear()
    bins, node, channels = inputs("gini", rows=200, trees_=2)
    trees._rf_chunk(t(bins), t(y.astype(np.int64)), torch.ones(200), t(channels[..., 0]),
                    torch.rand((2, 3, FEATURES)), 2, 2, BINS, 2)
    assert claims and all(claims)
    assert "integer=True" in inspect.getsource(sweep._dt_fused)


# --------------------------------------------------------------------------
# The sums path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bin_dtype,max_bins", [(np.int8, 32), (np.int32, 255)])
@pytest.mark.parametrize("kind", ["newton", "gini"])
def test_sums_model_matches_the_plain_version_and_the_reference(bin_dtype, max_bins, kind):
    n_nodes = 4
    bins, node, channels = inputs(kind, n_nodes=n_nodes, max_bins=max_bins, bin_dtype=bin_dtype, seed=2)
    got = model_sums(bins, node, channels, n_nodes, max_bins)
    want = plain(bins, node, channels, n_nodes, max_bins)
    scale = np.maximum(np.abs(want), 1e-30)
    assert (np.abs(got - want) / scale).max() <= chip_smoke.GB_SUM_RTOL
    np.testing.assert_allclose(got, reference(bins, node, channels, n_nodes, max_bins), rtol=1e-5, atol=1e-5)
    if kind == "gini":   # integer channels: exact in any order
        np.testing.assert_array_equal(got, want)


def test_sums_model_of_a_tree_is_its_bits_whatever_the_tree_axis():
    """The model of a forest of 3 trees gives each tree the bits of the
    model of that tree alone: the chunks, warps and order are the level's
    shape's, not the tree axis's."""
    bins, node, channels = inputs("newton", n_nodes=2, trees_=3, seed=4)
    alone = [model_sums(bins, node[i], channels[i], 2, BINS) for i in range(3)]
    assert trees._sum_chunks(ROWS, 2, BINS) == trees._sum_chunks(ROWS, 2, BINS)
    for i in range(3):
        np.testing.assert_array_equal(alone[i], model_sums(bins, node[i], channels[i], 2, BINS))
    forest = plain(bins, node, channels, 2, BINS)
    for i in range(3):
        assert (np.abs(alone[i] - forest[i]) / np.maximum(np.abs(forest[i]), 1e-30)).max() \
            <= chip_smoke.GB_SUM_RTOL


def test_a_partitioned_level_sums_each_window_from_its_rows_alone():
    """At a level of several node windows (64 nodes: windows of one node,
    the rows partitioned by window), each window's cells are summed from
    that window's rows alone: new channels on the rows of the other
    windows leave them bit for bit, and the level stays within
    GB_SUM_RTOL of the plain version."""
    n_nodes, rows = 64, 1_200
    tiling = trees._block_features(FEATURES, n_nodes, BINS, 2, 1)
    windows = -(-n_nodes // tiling.nodes)
    assert trees._partitioned(windows) and not trees._partitioned(1)
    bins, node, channels = inputs("newton", rows=rows, n_nodes=n_nodes, seed=6)
    got = model_sums(bins, node, channels, n_nodes, BINS)
    want = plain(bins, node, channels, n_nodes, BINS)
    assert (np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max() <= chip_smoke.GB_SUM_RTOL
    first, last = 0, tiling.nodes
    others = (node < first) | (node >= last)
    changed = channels.copy()
    changed[others] = (changed[others] * f32(1.5) + f32(0.25)).astype(f32)
    again = model_sums(bins, node, changed, n_nodes, BINS)
    np.testing.assert_array_equal(again[first:last], got[first:last])
    assert not np.array_equal(again[last:], got[last:])


# --------------------------------------------------------------------------
# The geometry
# --------------------------------------------------------------------------

def test_the_chunking_is_a_function_of_the_levels_shape_alone():
    for helper in (trees._sum_chunks, trees._count_tiling):
        parameters = set(inspect.signature(helper).parameters)
        assert not parameters & {"trees", "jobs", "T", "group"}
    assert set(inspect.signature(trees._sum_chunks).parameters) == {"rows", "n_nodes", "max_bins"}
    for rows in (1, 1_023, 1_000_000):
        for n_nodes in (1, 16, 2_048):
            chunks, per_chunk = trees._sum_chunks(rows, n_nodes, BINS)
            assert chunks * per_chunk >= rows > (chunks - 1) * per_chunk
            counts = trees._count_tiling(rows, 16, n_nodes, BINS, 2, 1)
            assert counts.chunks * counts.rows_per_chunk >= rows
            assert counts.rows_per_chunk <= trees.COUNT_LIMIT or not counts.in_shared


SHAPES = [
    (16, 1, 32, 2, 1), (16, 16, 32, 2, 1), (16, 128, 32, 2, 1), (16, 2048, 32, 10, 1),
    (16, 2048, 255, 10, 4), (16, 8, 255, 2, 4), (64, 255, 200, 4, 4), (1000, 4, 32, 2, 4),
    (16, 4, 30000, 2, 4), (17, 16, 32, 3, 1),
]


@pytest.mark.parametrize("F,n_nodes,max_bins,K,bin_bytes", SHAPES)
def test_every_block_fits_its_shared_memory(F, n_nodes, max_bins, K, bin_bytes):
    """Both paths' blocks stay within an H100 block's 232,448 bytes, and
    the counts path counts in shared memory exactly when one feature's
    counts fit its share."""
    sums = trees._block_features(F, n_nodes, max_bins, K, bin_bytes)
    assert trees._sum_shared_bytes(sums, bin_bytes) <= kernels.SHARED_BYTES == 232_448
    counts = trees._count_tiling(1_000_000, F, n_nodes, max_bins, K, bin_bytes)
    per_feature = n_nodes * max_bins * K * 4
    assert counts.in_shared == (per_feature <= trees._COUNT_SHARE)
    if counts.in_shared:
        assert counts.block_features * per_feature <= kernels.SHARED_BYTES
        assert counts.rows_per_chunk * (trees.COUNT_LIMIT - 1) < 2**32
    else:
        assert counts.block_features == F
    assert 1 <= sums.block_features <= F and 1 <= counts.block_features <= F


def test_the_default_levels_take_every_feature_in_one_block():
    """At the default fit (16 features, 32 bins, depth 5) every level's
    counts block holds all 16 features, and the sums path a node of all
    16 features a window: no row's bins are read twice for a feature."""
    for level in range(5):
        counts = trees._count_tiling(1_000_000, 16, 2**level, 32, 2, 1)
        sums = trees._block_features(16, 2**level, 32, 2, 1)
        assert counts.in_shared and counts.block_features == 16
        assert sums.block_features == 16 and sums[1:3] == (32, 2)
