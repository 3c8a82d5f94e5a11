"""The arithmetic of the redesigned tree forward (K6), held on the CPU.

The CUDA kernel (learningorchestra_tpu_torch/kernels/csrc/tree_forward.cu)
runs only on the card, where chip_smoke.py holds it against the plain
versions. Here a numpy model of what it computes, in the order it computes
it, is held against the port's plain twins bit for bit and against the
JAX package's ``_ensemble_forward`` and ``_gbt_forward`` within their own
tolerance (1e-6, as tests/test_torch_trees.py holds the twins), on seeded
inputs:

- The geometry (``trees._forward_geometry``): job groups (jobs that share
  X walked together), tiles of rows, passes of trees, staged in shared
  memory or read from global memory.
- A tile's rows staged at an odd row stride with a zero at entry F, so a
  feature index at or past F reads 0; walk ``i`` of a pass is (row i //
  trees, tree i % trees), each walk's leaf index kept.
- The sums: each (job, row, class) adds its trees' leaf values in tree
  order from 0 in float32 (carried between passes), then divides by T; gb
  adds step * value in round order from f0, each product rounded first.

The edge cases: 1, 63, 64, 65 and 257 rows; 0, 1, 3, 20 and 21 trees;
depths 0, 1, 5, 10 and 12; 2, 10 and 20 classes; NaN in selected and
unselected columns, feature -1 nodes, features past F, inf thresholds;
1 and 8 jobs with X shared and stacked; every size tier forced by a small
share. A job's output equals a launch of that job alone.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learningorchestra_tpu.ml import trees as jax_trees  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import trees  # noqa: E402

f32 = np.float32
FEATURES = 6
ATOL = 1e-6   # the twins against the reference (tests/test_torch_trees.py)


def t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


def make_rows(seed, rows, features=FEATURES, jobs=None):
    rng = np.random.default_rng(seed)
    shape = (rows, features) if jobs is None else (jobs, rows, features)
    X = rng.normal(size=shape).astype(f32)
    X[rng.random(shape) < 0.1] = np.nan
    X[..., 2] = np.nan   # a whole column: selected by some nodes, not by others
    return X


def make_heaps(seed, count, depth, classes, features=FEATURES, jobs=None):
    """Heaps with early leaves (feature -1), features past F and inf
    thresholds, leaf class distributions and gb's values."""
    rng = np.random.default_rng(seed)
    lead = (count,) if jobs is None else (jobs, count)
    nodes, leaves = 2**depth - 1, 2**depth
    features_heap = rng.integers(-1, features + 2, size=lead + (nodes,)).astype(np.int32)
    thresholds_heap = rng.normal(size=lead + (nodes,)).astype(f32)
    thresholds_heap[rng.random(lead + (nodes,)) < 0.2] = np.inf
    leaf_probs = rng.dirichlet(np.ones(classes), size=lead + (leaves,)).astype(f32)
    leaf_values = rng.normal(size=lead + (leaves,)).astype(f32)
    return features_heap, thresholds_heap, leaf_probs, leaf_values


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------

def model_forward(X, features_heap, thresholds_heap, values, depth, f0=None, step=0.0, share=None):
    """K6 as the kernel computes it. X ``(rows, F)`` shared by the jobs or
    ``(J, rows, F)``; heaps ``(J, T, nodes)``; values ``(J, T, leaves, C)``
    (the ensemble) or, given ``f0``, gb's ``(1, T, leaves, 1)``. Returns the
    ensemble's ``(J, rows, C)`` probabilities (gb's ``(rows,)`` margins)
    and every walk's leaf index ``(J, T, rows)``."""
    J, T = features_heap.shape[:2]
    rows, F = X.shape[-2:]
    C = values.shape[-1]
    gbt = f0 is not None
    g = trees._forward_geometry(rows, F, T, depth, C, J, X.ndim == 2, share)
    R, P = g.tile_rows, g.pass_trees
    nodes, leaves = 2**depth - 1, 2**depth
    out = np.full((1, rows) if gbt else (J, rows, C), np.nan, f32)
    leaf_of = np.full((J, T, rows), -1, np.int64)
    for j0 in range(0, J, g.group_jobs):
        jobs_here = min(g.group_jobs, J - j0)
        W = jobs_here * T
        passes = -(-W // P) if W > P else 1
        assert passes == 1 or jobs_here == 1
        X_group = X if X.ndim == 2 else X[j0]
        flat_values = values[j0 : j0 + jobs_here].reshape(-1)
        for tile in range(-(-rows // R)):
            row0 = tile * R
            n = min(R, rows - row0)
            staged = np.zeros((F + 1, R), f32)   # by feature column; column F stays 0
            staged[:F, :n] = X_group[row0 : row0 + n].T
            carried = None
            for p in range(passes):
                t0, last = p * P, p == passes - 1
                np_ = min(P, W - t0)
                item = np.arange(np_ * R)
                tree_of, r = item // R, item % R   # a warp: 32 rows of one tree
                live = r < n
                tree_of, r = tree_of[live], r[live]
                group_tree = t0 + tree_of
                job, tree = j0 + group_tree // max(T, 1), group_tree % max(T, 1)
                pos = np.zeros(len(r), np.int64)
                for _ in range(depth):
                    feature = features_heap[job, tree, pos].astype(np.int64)
                    threshold = np.where(feature < 0, f32(np.inf), thresholds_heap[job, tree, pos])
                    column = np.where(feature < 0, F, np.minimum(feature, F))
                    with np.errstate(invalid="ignore"):
                        right = ~(staged[column, r] <= threshold)
                    pos = 2 * pos + 1 + right
                leaf = pos - nodes
                leaf_of[job, tree, row0 + r] = leaf
                # the pass's leaf offsets (a thread a row keeps its own
                # walk's offset in registers: the same values, the same
                # order of the sums)
                offset = np.zeros((np_, R), np.int64)
                offset[tree_of, r] = (tree_of * leaves + leaf) * C
                base = t0 * leaves * C   # the pass's values
                if gbt:
                    margin = np.full(n, f32(f0), f32) if p == 0 else carried
                    for k in range(np_):
                        value = flat_values[base + offset[k, :n]]
                        margin = (margin + (f32(step) * value).astype(f32)).astype(f32)
                    if last:
                        out[0, row0 : row0 + n] = margin
                    carried = margin
                    continue
                acc = np.zeros((jobs_here, n, C), f32) if p == 0 else carried
                for jl in range(jobs_here):
                    first, count = (jl * T, T) if passes == 1 else (0, np_)
                    for k in range(count):
                        at = base + offset[first + k, :n]
                        v = flat_values[at[:, None] + np.arange(C)]
                        acc[jl] = (acc[jl] + v).astype(f32)
                if last:
                    out[j0 : j0 + jobs_here, row0 : row0 + n] = (acc / f32(T)).astype(f32)
                carried = acc
    return (out[0] if gbt else out), leaf_of


def model_ensemble(X, fh, th, lp, depth, share=None):
    out, leaf_of = model_forward(X, fh[None], th[None], lp[None], depth, share=share)
    return out[0], leaf_of[0]


def model_gbt(X, f0, fh, th, lv, step, depth, share=None):
    margins, leaf_of = model_forward(X, fh[None], th[None], lv[None, ..., None], depth, f0, step, share)
    p = torch.sigmoid(t(margins))   # the plain twin's sigmoid, on the model's margins
    return torch.stack([1 - p, p], dim=1).numpy(), leaf_of[0]


def reference_ensemble(X, fh, th, lp, depth):
    return np.asarray(jax_trees._ensemble_forward(
        jnp.asarray(X), jnp.asarray(fh), jnp.asarray(th), jnp.asarray(lp), max_depth=depth))


def reference_gbt(X, f0, fh, th, lv, step, depth):
    return np.asarray(jax_trees._gbt_forward(
        jnp.asarray(X), jnp.float32(f0), jnp.asarray(fh), jnp.asarray(th), jnp.asarray(lv),
        jnp.float32(step), max_depth=depth))


def held(X, fh, th, lp, lv, depth, share=None):
    """The model of both forms against the plain twins (bit for bit, each
    walk's leaf against ``_descend``) and the reference (1e-6)."""
    got, leaf_of = model_ensemble(X, fh, th, lp, depth, share)
    plain = trees._ensemble_forward(t(X), t(fh), t(th), t(lp), depth).numpy()
    np.testing.assert_array_equal(got, plain)
    for tree in range(fh.shape[0]):
        np.testing.assert_array_equal(leaf_of[tree], trees._descend(t(X), t(fh[tree]), t(th[tree]), depth).numpy())
    if fh.shape[0]:
        np.testing.assert_allclose(got, reference_ensemble(X, fh, th, lp, depth), rtol=0, atol=ATOL)
    boosted, _ = model_gbt(X, -0.37, fh, th, lv, 0.1, depth, share)
    plain = trees._gbt_forward(t(X), -0.37, t(fh), t(th), t(lv), 0.1, depth).numpy()
    np.testing.assert_array_equal(boosted, plain)
    np.testing.assert_allclose(boosted, reference_gbt(X, -0.37, fh, th, lv, 0.1, depth), rtol=0, atol=ATOL)


# --------------------------------------------------------------------------
# The model against the plain twins and the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 63, 64, 65, 257])
@pytest.mark.parametrize("count", [1, 3, 20, 21])
def test_model_matches_the_plain_twins_and_the_reference(rows, count):
    X = make_rows(rows, rows)
    fh, th, lp, lv = make_heaps(count, count, 5, 2)
    held(X, fh, th, lp, lv, 5)


@pytest.mark.parametrize("depth", [0, 1, 5, 10, 12])
@pytest.mark.parametrize("classes", [2, 10, 20])
def test_model_at_every_depth_and_class_count(depth, classes):
    X = make_rows(depth + 100 * classes, 65)
    fh, th, lp, lv = make_heaps(depth, 3, depth, classes)
    held(X, fh, th, lp, lv, depth)


def test_no_trees():
    """No trees: the wrapper's uniform 1/C without a launch for the
    ensemble; gb's margin is f0 alone, which the kernel computes."""
    X = make_rows(3, 64)
    fh, th, lp, lv = make_heaps(4, 0, 5, 2)
    got = trees.ensemble_forward(t(X), t(fh), t(th), t(lp), 5).numpy()
    np.testing.assert_allclose(got, reference_ensemble(X, fh, th, lp, 5), rtol=0, atol=ATOL)
    boosted, _ = model_gbt(X, -0.37, fh, th, lv, 0.1, 5)
    np.testing.assert_array_equal(boosted, trees._gbt_forward(t(X), -0.37, t(fh), t(th), t(lv), 0.1, 5).numpy())
    np.testing.assert_allclose(boosted, reference_gbt(X, -0.37, fh, th, lv, 0.1, 5), rtol=0, atol=ATOL)


# --------------------------------------------------------------------------
# Jobs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("jobs", [1, 8])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("count,depth", [(1, 8), (3, 5)])
def test_job_groups_give_each_job_its_launch_alone(jobs, shared, count, depth):
    X = make_rows(jobs, 257, jobs=None if shared else jobs)
    fh, th, lp, _ = make_heaps(jobs + 1, count, depth, 2, jobs=jobs)
    got, leaf_of = model_forward(X, fh, th, lp, depth)
    plain = trees._job_ensemble_forward(t(X), t(fh), t(th), t(lp), depth).numpy()
    np.testing.assert_array_equal(got, plain)
    for j in range(jobs):
        X_j = X if shared else X[j : j + 1]
        alone, alone_leaf = model_forward(X_j, fh[j : j + 1], th[j : j + 1], lp[j : j + 1], depth)
        np.testing.assert_array_equal(got[j], alone[0])
        np.testing.assert_array_equal(leaf_of[j], alone_leaf[0])
        np.testing.assert_allclose(
            got[j], reference_ensemble(X if shared else X[j], fh[j], th[j], lp[j], depth), rtol=0, atol=ATOL)
    geometry = trees._forward_geometry(257, FEATURES, count, depth, 2, jobs, shared)
    assert geometry.group_jobs == (jobs if shared else 1)


def test_the_sweeps_jobs_read_their_shared_rows_once():
    """The depth sweep's depth-8 program: 8 one-tree jobs over 200,000
    shared eval rows walk as one group (one read of each tile)."""
    geometry = trees._forward_geometry(200_000, 16, 1, 8, 2, 8, True)
    assert geometry.group_jobs == 8 and geometry.staged and geometry.x_staged
    assert geometry.shared_bytes <= trees._FORWARD_SHARE
    stacked = trees._forward_geometry(200_000, 16, 1, 8, 2, 8, False)
    assert stacked.group_jobs == 1


# --------------------------------------------------------------------------
# Size tiers, forced by a small share
# --------------------------------------------------------------------------

def tier(geometry, trees_count):
    if not geometry.staged:
        return "global"
    return "staged" if geometry.pass_trees >= trees_count else "passes"


@pytest.mark.parametrize("share,expected", [
    (None, "staged"),            # 20 trees of 10 classes at depth 5: 31 KB
    (20_000, "passes"),          # passes of 6 trees over 64-row tiles
    (4_000, "passes"),           # passes of one tree over 32-row tiles
    (3_500, "global"),           # one tree past half the share: one pass
    (2_000, "global"),           # a tile's leaf offsets of every tree past it: passes
    (300, "global"),             # and the rows from global memory
])
def test_every_size_tier_gives_the_plain_bits(share, expected):
    X = make_rows(11, 257)
    fh, th, lp, lv = make_heaps(12, 20, 5, 10)
    geometry = trees._forward_geometry(257, FEATURES, 20, 5, 10, 1, True, share)
    assert tier(geometry, 20) == expected
    assert geometry.shared_bytes <= (trees._FORWARD_SHARE if share is None else share)
    if expected == "passes":
        assert geometry.acc_shared
    held(X, fh, th, lp, lv, 5, share)


def test_the_sums_carried_between_passes_in_the_output_past_their_share():
    """20 classes of a long tile pass the sums' shared-memory share: they
    wait in the output between passes, and the bits stay."""
    X = make_rows(13, 1_500)
    fh, th, lp, lv = make_heaps(14, 6, 7, 20)
    share = 60_000
    geometry = trees._forward_geometry(1_500, FEATURES, 6, 7, 20, 1, True, share)
    assert tier(geometry, 6) == "passes" and geometry.acc_shared
    saved = trees._FORWARD_ACC_SHARE
    try:
        trees._FORWARD_ACC_SHARE = 1_024
        trees._forward_geometry_at.cache_clear()
        geometry = trees._forward_geometry(1_500, FEATURES, 6, 7, 20, 1, True, share)
        assert tier(geometry, 6) == "passes" and not geometry.acc_shared
        held(X, fh, th, lp, lv, 7, share)
    finally:
        trees._FORWARD_ACC_SHARE = saved
        trees._forward_geometry_at.cache_clear()


def test_rows_past_the_share_are_read_from_global_memory():
    X = make_rows(15, 65, features=300)
    fh, th, lp, lv = make_heaps(16, 3, 5, 2, features=300)
    geometry = trees._forward_geometry(65, 300, 3, 5, 2, 1, True, 4_000)
    assert not geometry.x_staged
    held(X, fh, th, lp, lv, 5, 4_000)


# --------------------------------------------------------------------------
# The geometry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows,F,count,depth,classes,jobs,shared", [
    (64, 16, 20, 5, 2, 1, True),
    (4_096, 16, 20, 5, 2, 1, True),
    (1_048_576, 16, 20, 5, 2, 1, True),
    (1_048_576, 16, 20, 5, 1, 1, True),
    (1_000_000, 16, 20, 10, 2, 1, True),
    (1_000_000, 16, 1, 12, 20, 1, True),
    (200_000, 16, 1, 8, 2, 8, True),
    (200_000, 16, 1, 8, 2, 8, False),
    (1, 5, 0, 3, 1, 1, True),
    (3, 100_000, 2, 2, 2, 1, True),
])
def test_geometry_fits_a_block_and_covers_every_row_tree_and_job(rows, F, count, depth, classes, jobs, shared):
    g = trees._forward_geometry(rows, F, count, depth, classes, jobs, shared)
    assert g.shared_bytes <= trees._FORWARD_SHARE
    # a power of two of at least a warp's rows: every tile begins on 16 bytes
    assert g.tile_rows >= 32 and g.tile_rows & (g.tile_rows - 1) == 0
    tree_bytes = (2**depth - 1) * 8 + 2**depth * classes * 4
    assert g.shared_bytes == trees._forward_shared_bytes(
        g.tile_rows, g.pass_trees, g.staged, g.x_staged, g.row_threads, g.acc_shared, F, tree_bytes, classes)
    assert not g.row_threads or classes <= trees._FORWARD_REG_CLASSES
    assert g.pass_trees * 2**depth * classes < 2**31   # the leaf offsets are int32
    groups = -(-jobs // g.group_jobs)
    assert sorted(j for j0 in range(0, jobs, g.group_jobs) for j in range(j0, min(jobs, j0 + g.group_jobs))) \
        == list(range(jobs)) and groups * g.group_jobs - jobs < g.group_jobs
    W = g.group_jobs * count
    passes = -(-W // g.pass_trees) if W > g.pass_trees else 1
    assert passes == 1 or g.group_jobs == 1
    covered = [tr for p in range(passes) for tr in range(p * g.pass_trees, min(W, (p + 1) * g.pass_trees))]
    assert covered == list(range(W))


@pytest.mark.parametrize("share", [None, 20_000, 3_500])
@pytest.mark.parametrize("gbt", [False, True])
def test_a_thread_a_row_gives_the_same_bits(share, gbt, monkeypatch):
    """The batch lane's form (a thread walks its row through every tree,
    summing in registers), forced at a small row count, in one pass, in
    passes and from global memory: the plain bits."""
    monkeypatch.setattr(trees, "_FORWARD_ROW_ROWS", 1)
    trees._forward_geometry_at.cache_clear()
    try:
        X = make_rows(17, 300)
        fh, th, lp, lv = make_heaps(18, 20, 5, 3)
        classes = 1 if gbt else 3
        geometry = trees._forward_geometry(300, FEATURES, 20, 5, classes, 1, True, share)
        assert geometry.row_threads
        held(X, fh, th, lp, lv, 5, share)
    finally:
        monkeypatch.undo()
        trees._forward_geometry_at.cache_clear()


def test_geometry_at_the_main_paths_shapes():
    """The serve lane's 64 rows in two tiles of a warp's 32 rows; 4,096
    rows over 128 blocks; 1,048,576 rows a row a thread, the ensemble's
    and gb's; the sweep's jobs in tree lanes; the depth-10
    forest in passes over long tiles; the depth-12 tree of 20 classes from
    global memory."""
    serve = trees._forward_geometry(64, 16, 20, 5, 2)
    assert serve.staged and serve.pass_trees == 20 and serve.tile_rows == 32
    assert -(-4_096 // trees._forward_geometry(4_096, 16, 20, 5, 2).tile_rows) == 128
    assert not serve.row_threads
    batch = trees._forward_geometry(1_048_576, 16, 20, 5, 2)
    assert batch.row_threads and batch.tile_rows == 256   # a row a thread
    assert trees._forward_geometry(1_048_576, 16, 20, 5, 1).row_threads   # gb
    assert not trees._forward_geometry(1_048_576, 16, 20, 5, 10).row_threads   # past the registers
    sweep = trees._forward_geometry(200_000, 16, 1, 8, 2, 8, True)
    assert not sweep.row_threads and sweep.tile_rows == 256   # 8 walks a row: tree lanes
    deep = trees._forward_geometry(1_000_000, 16, 20, 10, 2)
    assert deep.staged and deep.pass_trees < 20 and deep.tile_rows >= 1_000
    wide = trees._forward_geometry(1_000_000, 16, 1, 12, 20)
    assert not wide.staged


# --------------------------------------------------------------------------
# A thread a row: the tile's rows against the block's threads
# --------------------------------------------------------------------------

def restaging_threads(tile_rows, num_features):
    """Threads of a block that store an item of the next tile into a row
    that another thread walks in this one. A thread a row: thread r walks
    row r of a tile (r < tile_rows <= the block's threads); thread t stores
    items t, t + threads, ..., item i into row i % tile_rows (a 16-byte
    word of it where a row is whole words, else a float)."""
    threads = trees._FORWARD_THREADS
    items = (num_features // 4 if num_features % 4 == 0 else num_features) * tile_rows
    return sorted({
        t for t in range(threads) for item in range(t, items, threads) if item % tile_rows != t
    })


@pytest.mark.parametrize("F", [16, 17, 32, 64])
@pytest.mark.parametrize("classes", [2, 1])
def test_a_thread_a_row_tile_is_a_row_a_thread(F, classes):
    """At the batch lane's row counts, the row form's tile holds a row for
    each of the block's threads, however wide the rows: no thread idles
    through the walks, and each stores only its own row's items."""
    g = trees._forward_geometry(1_048_576, F, 20, 5, classes)
    assert g.row_threads and g.tile_rows == trees._FORWARD_THREADS
    assert restaging_threads(g.tile_rows, F) == []


@pytest.mark.parametrize("rows,F,share", [
    (33_792, 16, None),        # the least row count of the form: tiles of 128 rows fill the card
    (1_048_576, 32, 30_000),   # a block's share too small for 256 rows of 33 floats
])
def test_a_thread_a_row_restages_a_tile_only_after_its_walks(rows, F, share):
    """Where a row form's tile holds fewer rows than the block has threads,
    the threads past them stage the next tile's items into rows that the
    others still walk: the kernel waits for every walk of a tile before the
    next tile's items are stored."""
    g = trees._forward_geometry(rows, F, 20, 5, 2, share=share)
    assert g.row_threads and g.tile_rows < trees._FORWARD_THREADS
    assert restaging_threads(g.tile_rows, F) != []
    with open(kernels.SOURCES["tree_forward"]) as handle:
        source = handle.read()
    tile_loop = source[source.index("for (int tile = blockIdx.x;"):source.index("template <bool kStaged, bool kXStaged, bool kRowThreads>")]
    # the last statement of the pass loop: a barrier in every pass of the row form
    assert "if (passes > 1 || kRowThreads) __syncthreads();" in tile_loop
