"""The arithmetic of the redesigned routing (K4) and leaf sums (K5), held
on the CPU.

The CUDA kernels (learningorchestra_tpu_torch/kernels/csrc/tree_fit.cu)
run only on the card, where chip_smoke.py holds them against their plain
versions. Here numpy models of what each kernel computes, in the order it
computes it, are held against the port's plain version and the JAX
package's function on seeded inputs:

- K4: trees in the groups of ``trees._route_geometry``; a thread reads its
  row's bins once for its whole group (as 16-byte words, the bin picked
  from them by ``bin_at``'s shifts, or a bin gathered for each tree that
  splits the row), each tree's node and its (feature, split bin) pair.
  Equal to ``trees._route`` and to the reference's ``_route``
  for int8 (32 bins) and int32 (255) bins, one tree, 20 trees over shared
  bins, jobs with their own bins, nodes with feature -1, 2,048 nodes,
  windows of trees and splits read from global memory.
- K5, counts: each chunk's 32-bit counts, flushed into the call's counts,
  rounded once. Equal to ``trees._leaf_sums`` and to the reference's
  ``_leaf_sums`` (its matmul path at 64 leaves or fewer, its scatter path
  at 4,096).
- K5, sums: float64 in the kernel's order (chunks of
  ``kernels.row_chunks``, each warp's part of a chunk 32 rows at a time,
  the rows of one leaf in lane order, the warps' copies in warp order,
  the chunks in the last block's segments or in chunk order), within
  1e-6 of both, and the same bits for a tree alone and within a tree axis
  (the geometry is a function of one tree's shape).
- ``leaf_sums(..., integer=True)`` refuses a non-integer channel.
- The geometries: every block's shared memory within 232,448 bytes; tree
  groups, row chunks, leaf windows and segments covering each tree, row,
  leaf and chunk once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from learningorchestra_tpu.ml import trees as jax_trees  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import trees  # noqa: E402

ROWS, FEATURES = 1_500, 16
KERNEL_WARPS = 32            # tree_fit.cu kLeafWarps
COUNT_THREADS, COUNT_STEPS = 512, 4   # tree_fit.cu kLeafCountThreads, kLeafCountSteps


def t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------

def row_words(bins):
    """Each row's bytes as the kernel holds them: 32-bit words, four to a
    16-byte word (little-endian), or None where a row is not 16-byte
    words of at most 64 bytes."""
    row_bytes = bins.shape[-1] * bins.itemsize
    if row_bytes % 16 or row_bytes > 64:
        return None
    return np.ascontiguousarray(bins).view(np.uint32).reshape(*bins.shape[:-1], row_bytes // 4)


def word_bin(words, f, itemsize):
    """``bin_at``: bin ``f`` of each row from its 32-bit words, an int8
    sign-extended from its byte."""
    rows = np.arange(words.shape[0])
    if itemsize == 4:
        return words[rows, f].view(np.int32).astype(np.int64)
    part = words[rows, f // 4] >> (8 * (f % 4)).astype(np.uint32)
    return (part & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)


def model_route(bins, node, feature, split, share=None):
    """K4 as the kernel computes it: trees in ``_route_geometry``'s groups,
    each row's 16-byte words read once a group with its nodes, or a bin
    gathered for each tree that splits the row. Returns the nodes and the
    count of reads (a row's words, or one gathered bin)."""
    node = node if node.ndim == 2 else node[None]
    feature = feature if feature.ndim == 2 else feature[None]
    split = split if split.ndim == 2 else split[None]
    T, rows = node.shape
    n_nodes, F = feature.shape[1], bins.shape[-1]
    geometry = trees._route_geometry(T, n_nodes, bins.ndim == 2, share)
    out = np.empty_like(node)
    bin_reads = 0
    for t0 in range(0, T, geometry.group):
        group = range(t0, min(T, t0 + geometry.group))
        matrix = bins if bins.ndim == 2 else bins[t0]
        words = row_words(matrix)
        for tree in group:
            nd = node[tree].astype(np.int64)
            valid = (nd >= 0) & (nd < n_nodes)
            f = np.where(valid, feature[tree][np.clip(nd, 0, n_nodes - 1)], -1).astype(np.int64)
            s = np.where(valid, split[tree][np.clip(nd, 0, n_nodes - 1)], 0).astype(np.int64)
            need = (f >= 0) & (f < F)
            bin_reads += 0 if words is not None else int(need.sum())
            clipped = np.clip(f, 0, F - 1)
            picked = (
                word_bin(words, clipped, matrix.itemsize) if words is not None
                else matrix[np.arange(rows), clipped].astype(np.int64)
            )
            x_bin = np.where(need, picked, 0)
            out[tree] = 2 * nd + ((x_bin > s) & (f >= 0))
        bin_reads += rows if words is not None else 0
    return out, bin_reads


def route_inputs(T, n_nodes, bin_dtype, max_bin, own_bins=False, leaf_rate=0.2, seed=0, F=FEATURES, rows=ROWS):
    rng = np.random.default_rng(seed)
    shape = (T, rows, F) if own_bins else (rows, F)
    bins = rng.integers(0, max_bin, shape).astype(bin_dtype)
    node = rng.integers(0, n_nodes, (T, rows)).astype(np.int32)
    feature = rng.integers(0, F, (T, n_nodes)).astype(np.int32)
    feature[rng.random((T, n_nodes)) < leaf_rate] = -1
    split = rng.integers(0, max_bin, (T, n_nodes)).astype(np.int32)
    return bins, node, feature, split


def reference_route(bins, node, feature, split):
    if bins.ndim == 3:
        return np.asarray(jax.vmap(jax_trees._route)(
            jnp.asarray(bins), jnp.asarray(node), jnp.asarray(feature), jnp.asarray(split)))
    return np.asarray(jax.vmap(lambda n, f, s: jax_trees._route(jnp.asarray(bins), n, f, s))(
        jnp.asarray(node), jnp.asarray(feature), jnp.asarray(split)))


@pytest.mark.parametrize("bin_dtype,max_bin", [(np.int8, 32), (np.int32, 255)])
@pytest.mark.parametrize(
    "T,n_nodes,own_bins",
    [(1, 1, False), (1, 16, False), (20, 16, False), (8, 16, True), (1, 2048, False), (3, 2048, False)],
)
def test_k4_model_matches_the_plain_version_and_the_reference(bin_dtype, max_bin, T, n_nodes, own_bins):
    bins, node, feature, split = route_inputs(T, n_nodes, bin_dtype, max_bin, own_bins, seed=T + n_nodes)
    got, _ = model_route(bins, node, feature, split)
    plain = trees._route(t(bins), t(node), t(feature), t(split)).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, reference_route(bins, node, feature, split))


@pytest.mark.parametrize("F,bin_dtype", [(5, np.int8), (17, np.int8), (4, np.int32), (48, np.int8), (64, np.int8), (20, np.int32)])
def test_k4_words_and_gathers_at_every_row_width(F, bin_dtype):
    """Rows of 16, 32, 48 or 64 bytes are read as words, others gathered:
    the same nodes either way, on a row count that is no multiple of a
    warp or a word."""
    bins, node, feature, split = route_inputs(3, 8, bin_dtype, 32, seed=F, F=F, rows=1001)
    assert (row_words(bins) is not None) == (F * bins.itemsize in (16, 32, 48, 64))
    got, _ = model_route(bins, node, feature, split)
    np.testing.assert_array_equal(got, trees._route(t(bins), t(node), t(feature), t(split)).numpy())


def test_k4_rows_no_tree_splits_read_no_bins():
    """Gathered bins (17 int8 features, no 16-byte words): on a level where
    most nodes stop, a row whose node stops in every tree reads no bins,
    and a row reads one bin for each tree that splits it. Rows of 16-byte
    words (16 int8 features) read theirs once a group, with their nodes,
    whether a tree splits them or not."""
    for F in (17, 16):
        bins, node, feature, split = route_inputs(20, 16, np.int8, 32, seed=7, leaf_rate=0.0, F=F)
        feature[:, :12] = -1                       # nodes 0-11 stop in every tree
        node[:, :500] = np.arange(500)[None, :] % 12   # rows 0-499 sit in such nodes everywhere
        got, reads = model_route(bins, node, feature, split)
        np.testing.assert_array_equal(got[:, :500], 2 * node[:, :500])
        np.testing.assert_array_equal(got, trees._route(t(bins), t(node), t(feature), t(split)).numpy())
        if F == 17:
            assert reads == int((node[:, 500:] >= 12).sum())
        else:
            assert reads == ROWS * len(range(0, 20, trees._route_geometry(20, 16, True).group))


@pytest.mark.parametrize("share", [16 * 8 * 3, 64])
def test_k4_tree_windows_and_global_splits_give_the_same_nodes(share):
    """Splits past the share: windows of three trees (each row's bins read
    once a window), or every tree in one group with its splits in global
    memory."""
    bins, node, feature, split = route_inputs(20, 16, np.int8, 32, seed=3)
    geometry = trees._route_geometry(20, 16, True, share)
    assert geometry == ((3, True, share) if share > 64 else (20, False, 0))
    got, _ = model_route(bins, node, feature, split, share)
    np.testing.assert_array_equal(got, trees._route(t(bins), t(node), t(feature), t(split)).numpy())


@pytest.mark.parametrize(
    "T,n_nodes,shared", [(1, 1, True), (20, 16, True), (20, 2048, True), (70_000, 16, True),
                         (8, 16, False), (1, 2**19, True), (20, 2**19, True), (8, 2**19, False)],
)
def test_k4_geometry_covers_every_tree_once_within_shared_memory(T, n_nodes, shared):
    geometry = trees._route_geometry(T, n_nodes, shared)
    assert geometry.shared_bytes <= kernels.SHARED_BYTES
    assert geometry.shared_bytes == (geometry.group * n_nodes * 8 if geometry.staged else 0)
    covered = np.zeros(T, np.int64)
    for t0 in range(0, T, geometry.group):
        covered[t0 : t0 + geometry.group] += 1
    assert (covered == 1).all()
    assert shared or geometry.group == 1        # own bins: a group of one
    assert geometry.staged == (n_nodes * 8 <= trees._ROUTE_SHARE)


# --------------------------------------------------------------------------
# K5
# --------------------------------------------------------------------------

def leaf_inputs(T, n_leaves, K, kind, rows=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    leaf = rng.integers(0, n_leaves, (T, rows)).astype(np.int32)
    if kind == "counts":      # one-hots times Poisson weights, as the forest's
        labels = rng.integers(0, K, (T, rows))
        channels = np.eye(K, dtype=np.float32)[labels] * rng.poisson(1.0, (T, rows, 1)).astype(np.float32)
    else:                     # gb's (g, h)
        p = 1 / (1 + np.exp(-rng.normal(size=(T, rows))))
        y = rng.integers(0, 2, (T, rows))
        channels = np.stack([p - y, np.maximum(p * (1 - p), 1e-6)], axis=-1).astype(np.float32)
    return leaf, channels


def model_counts(leaf, channels, n_leaves):
    """The counts path: each chunk's block counts its rows (four steps of
    a thread's rows in flight) in 32-bit counts, flushes each touched cell
    into the call's counts, and the last block rounds them to float32."""
    T, rows = leaf.shape
    K = channels.shape[-1]
    tiling = trees._leaf_count_tiling(rows, n_leaves, K)
    out = np.empty((T, n_leaves, K), np.float32)
    for tree in range(T):
        counts = np.zeros(n_leaves * K, np.uint64)
        for chunk in range(tiling.chunks):
            begin = chunk * tiling.rows_per_chunk
            end = min(rows, begin + tiling.rows_per_chunk)
            block = np.zeros(n_leaves * K, np.uint64)
            for base in range(begin, end, COUNT_STEPS * COUNT_THREADS):
                r = np.arange(base, min(end, base + COUNT_STEPS * COUNT_THREADS))
                for k in range(K):
                    value = channels[tree, r, k]
                    assert ((value >= 0) & (value < trees.COUNT_LIMIT) & (value == np.trunc(value))).all()
                    l = leaf[tree, r].astype(np.int64)
                    keep = (l >= 0) & (l < n_leaves) & (value != 0)
                    np.add.at(block, l[keep] * K + k, value[keep].astype(np.uint64))
            assert block.max(initial=0) < 2**32      # a block's 32-bit count cannot wrap
            counts += block
        assert counts.max(initial=0) < 2**32
        out[tree] = counts.astype(np.float32).reshape(n_leaves, K)
    return out


def model_sums(leaf, channels, n_leaves):
    """The sums path, float64 in the kernel's order."""
    T, rows = leaf.shape
    K = channels.shape[-1]
    tiling = trees._leaf_warps(n_leaves, K)
    chunks, per_chunk = kernels.row_chunks(rows)
    fused = trees._leaf_fused(chunks, tiling, n_leaves, K)
    out = np.empty((T, n_leaves, K), np.float32)
    for tree in range(T):
        for l0 in range(0, n_leaves, tiling.leaves):
            for k0 in range(0, K, tiling.channels):
                wl, wk = min(tiling.leaves, n_leaves - l0), min(tiling.channels, K - k0)
                partials = np.zeros((chunks, wl * wk))
                for chunk in range(chunks):
                    begin, end = chunk * per_chunk, min(rows, (chunk + 1) * per_chunk)
                    per_warp = -(-(end - begin) // tiling.warps)
                    copies = np.zeros((tiling.warps, wl * wk))
                    for warp in range(tiling.warps):
                        warp_begin = begin + warp * per_warp
                        warp_end = min(end, warp_begin + per_warp)
                        for base in range(warp_begin, warp_end, 32):
                            lanes = range(base, min(warp_end, base + 32))
                            keys = [int(leaf[tree, r]) - l0 for r in lanes]
                            for key in sorted({k for k in keys if 0 <= k < wl}):
                                members = [r for r, k in zip(lanes, keys) if k == key]   # lane order
                                for k in range(wk):
                                    total = 0.0
                                    for r in members:
                                        total += float(channels[tree, r, k0 + k])
                                    copies[warp, key * wk + k] += total
                    partial = copies[0].copy()
                    for warp in range(1, tiling.warps):
                        partial += copies[warp]
                    partials[chunk] = partial
                if fused:   # the last block: segments of chunks, then the segments in order
                    cells = wl * wk
                    per_segment = -(-chunks // max(1, min(tiling.warps, chunks, (32 * tiling.warps) // cells)))
                    segments = -(-chunks // per_segment)
                    sums = np.zeros((segments, cells))
                    for s in range(segments):
                        for c in range(s * per_segment, min(chunks, (s + 1) * per_segment)):
                            sums[s] += partials[c]
                    total = sums[0].copy()
                    for s in range(1, segments):
                        total += sums[s]
                else:        # sum_partials_kernel: chunk order
                    total = partials[0].copy()
                    for c in range(1, chunks):
                        total += partials[c]
                out[tree, l0 : l0 + wl, k0 : k0 + wk] = total.reshape(wl, wk)
    return out


def reference_leaf_sums(leaf, channels, n_leaves):
    return np.asarray(jax.vmap(lambda l, c: jax_trees._leaf_sums(l, c, n_leaves))(
        jnp.asarray(leaf), jnp.asarray(channels)))


@pytest.mark.parametrize("n_leaves,K,T", [(32, 2, 1), (64, 3, 20), (32, 2, 8), (4096, 10, 1)])
def test_k5_counts_model_matches_the_plain_version_and_the_reference(n_leaves, K, T):
    """Counts exact: the reference's matmul path (64 leaves or fewer) and
    its scatter path (4,096 leaves)."""
    leaf, channels = leaf_inputs(T, n_leaves, K, "counts", rows=5_000 if n_leaves > 64 else ROWS, seed=n_leaves)
    got = model_counts(leaf, channels, n_leaves)
    np.testing.assert_array_equal(got, trees._leaf_sums(t(leaf), t(channels), n_leaves).numpy())
    np.testing.assert_array_equal(got, reference_leaf_sums(leaf, channels, n_leaves))
    np.testing.assert_array_equal(
        trees.leaf_sums(t(leaf), t(channels), n_leaves, integer=True).numpy(), got
    )


@pytest.mark.parametrize("n_leaves,rows", [(32, ROWS), (8, 70_001), (4096, 5_000)])
def test_k5_sums_model_within_1e6_of_the_plain_version_and_the_reference(n_leaves, rows):
    """gb's (g, h) in float64 in the kernel's order, each cell rounded
    once: within 1e-6 of the plain version's float64 sums and of the
    reference's float32 matmul (8 and 32 leaves) or scatter (4,096). At
    70,001 rows the last block adds 69 chunks in segments; at 4,096
    leaves the chunks' partials pass it and a second kernel adds them in
    chunk order. The reference sums in float32: at ~9,000 rows a leaf its
    own rounding reaches ~2e-6, so there it is held within 1e-5."""
    leaf, channels = leaf_inputs(1, n_leaves, 2, "sums", rows=rows, seed=rows)
    tiling = trees._leaf_warps(n_leaves, 2)
    assert trees._leaf_fused(kernels.row_chunks(rows)[0], tiling, n_leaves, 2) == (n_leaves < 4096)
    got = model_sums(leaf, channels, n_leaves)
    tolerance = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, trees._leaf_sums(t(leaf), t(channels), n_leaves).numpy(), **tolerance)
    reference_tolerance = tolerance if rows / n_leaves <= 1_000 else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, reference_leaf_sums(leaf, channels, n_leaves), **reference_tolerance)


def test_k5_sums_of_a_tree_alone_equal_its_sums_within_a_tree_axis():
    """The geometry is a function of one tree's shape, so tree t's sums in
    an axis of three are those of the launch of tree t alone, bit for
    bit."""
    leaf, channels = leaf_inputs(3, 32, 2, "sums", seed=5)
    together = model_sums(leaf, channels, 32)
    for tree in range(3):
        alone = model_sums(leaf[tree : tree + 1], channels[tree : tree + 1], 32)
        assert np.array_equal(alone[0].view(np.uint32), together[tree].view(np.uint32))


def test_k5_integer_claim_refused_on_a_non_integer_channel():
    leaf, channels = leaf_inputs(1, 32, 2, "counts", seed=1)
    for bad in (0.5, -1.0, float(trees.COUNT_LIMIT), float("nan")):
        wrong = channels.copy()
        wrong[0, 7, 1] = bad
        with pytest.raises(ValueError, match="integer"):
            trees.leaf_sums(t(leaf[0]), t(wrong[0]), 32, integer=True)
    # gb's float channels take the sums path: no claim, no error
    trees.leaf_sums(t(leaf[0]), t(leaf_inputs(1, 32, 2, "sums")[1][0]), 32)


@pytest.mark.parametrize(
    "rows,n_leaves,K",
    [(1, 32, 2), (1_000_000, 32, 2), (1_048_576, 32, 2), (1_000_000, 4096, 10), (1_000_000, 2**20, 20),
     (70_001, 8, 2), (1_000_000, 4096, 2), (5, 8, 40_000), (1_000, 16_384, 2), (1_000, 14_528, 4)],
)
def test_k5_geometry_covers_every_row_and_leaf_once_within_shared_memory(rows, n_leaves, K):
    counts = trees._leaf_count_tiling(rows, n_leaves, K)
    assert (counts.chunks - 1) * counts.rows_per_chunk < rows <= counts.chunks * counts.rows_per_chunk
    if counts.in_shared:    # a block's 32-bit counts fit, and cannot wrap
        assert n_leaves * K * 4 <= trees._LEAF_SHARE and counts.rows_per_chunk <= trees.COUNT_LIMIT
    else:                   # counting in global memory: every block of row_chunks' split busy
        assert (counts.chunks, counts.rows_per_chunk) == kernels.row_chunks(rows)


@pytest.mark.parametrize(
    "rows,n_leaves,K,in_shared",
    [(1_000_000, 32, 2, True), (1_048_576, 256, 2, True), (50_000, 32, 2, True), (1_000_000, 4096, 10, False)],
)
def test_k5_counts_in_shared_memory_while_they_leave_the_card_enough_chunks(rows, n_leaves, K, in_shared):
    """dt's, the forest's and the sweep's leaves count in shared memory;
    4,096 leaves x 10 classes, whose 160 KB of counts a chunk would leave
    16 chunks of 65,536 rows, count in global memory over 264 blocks."""
    counts = trees._leaf_count_tiling(rows, n_leaves, K)
    assert counts.in_shared == in_shared
    assert counts.chunks >= min(kernels.row_chunks(rows)[0], trees._LEAF_COUNT_MIN_CHUNKS)
    sums = trees._leaf_warps(n_leaves, K)
    assert 1 <= sums.warps <= KERNEL_WARPS == trees._LEAF_WARPS
    # room left for the kernels' static words
    assert sums.warps * sums.leaves * sums.channels * 8 <= trees._LEAF_SHARE < kernels.SHARED_BYTES
    covered = np.zeros((n_leaves, K), np.int64) if n_leaves * K <= 2**22 else None
    if covered is not None:
        for l0 in range(0, n_leaves, sums.leaves):
            for k0 in range(0, K, sums.channels):
                covered[l0 : l0 + sums.leaves, k0 : k0 + sums.channels] += 1
        assert (covered == 1).all()
    chunks, per_chunk = kernels.row_chunks(rows)
    if trees._leaf_fused(chunks, sums, n_leaves, K):
        cells = n_leaves * K
        assert (sums.leaves, sums.channels) == (n_leaves, K) and chunks * cells <= trees._LEAF_FUSE_VALUES
        per_segment = -(-chunks // max(1, min(sums.warps, chunks, (32 * sums.warps) // cells)))
        segments = -(-chunks // per_segment)
        assert segments * cells <= sums.warps * cells      # the segments' sums fit the copies' memory
        assert (segments - 1) * per_segment < chunks <= segments * per_segment
