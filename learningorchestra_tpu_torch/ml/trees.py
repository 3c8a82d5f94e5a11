"""Histogram-binned decision trees and gradient boosting: fits and forwards.

Counterpart of ``learningorchestra_tpu/ml/trees.py``:

- the fit's level programs (:66-246): ``_level_histograms`` (K2),
  ``_leaf_sums`` (K5), ``_gini_gain`` / ``_newton_gain`` /
  ``_select_splits`` (K3) and ``_route`` (K4);
- the fits (:253-296, :389-500, :503-644): ``_grow``,
  ``_fit_classification_tree``, ``_fit_newton_tree``, ``_dt_fit``,
  ``_rf_chunk``, ``_rf_fit``, ``_gbt_init``, ``_gbt_rounds_impl``,
  ``_gbt_fit``, and the estimators ``DecisionTreeClassifier``,
  ``RandomForestClassifier`` and ``GBTClassifier`` (:669-814);
- prediction (:303-386, :647-666): ``_descend`` (K6),
  ``_ensemble_forward`` (dt and rf), ``_gbt_forward`` (gb),
  ``_TreeEnsembleModel`` and ``GBTModel``.

The random forest grows its trees together, as the reference's vmap over
trees does: the level programs take a leading tree axis (one launch a
level for a chunk of trees), and the split search takes each node's
feature subset. A sweep's dt program (``ml/sweep.py``) grows one tree a
job on the same axis, each job with its own bins ``(J, rows, F)`` (K2 and
K4 take the bins' stride along the axis), and :func:`job_ensemble_forward`
runs each job's tree on the job's own rows (K6 over a job axis). The
forest's random draws are inputs (``ForestDraws``), made by the
estimator from a ``torch.Generator``; see ``RandomForestClassifier``.

A fitted tree is a static heap: ``features_heap (T, 2^D - 1)`` int32
(``-1`` marks a node that stopped splitting), ``thresholds_heap`` float32
of the same shape, and per-leaf ``leaf_probs (T, 2^D, C)`` or boosted
``leaf_values (T, 2^D)``. A fit grows one tree level by level: rows carry
a node index, each level builds a ``(node, feature, bin, channel)``
histogram, picks each node's best split and routes the rows one level
down. Channels are weighted class one-hots (gini splits, dt) or Newton
``(g, h)`` pairs (gb).

Two versions of each device program live here:

- the plain PyTorch functions (``_level_histograms``, ``_select_splits``,
  ``_route``, ``_leaf_sums``, ``_descend``, ...), which repeat the
  reference's arithmetic in the reference's order (the tests hold them
  against the JAX functions, and the chip smoke holds the kernels against
  them);
- the wrappers (``level_histograms``, ``select_splits``, ``route``,
  ``leaf_sums``, ``ensemble_forward``, ``gbt_forward``), which the fits and
  the models call. On a CPU tensor a wrapper runs the plain function; on a
  CUDA tensor it launches the hand-written kernel (``kernels/csrc/
  tree_fit.cu``, ``tree_forward.cu``) or raises. Nothing falls back.

K2 and K5 have two paths each on the card: the gini fits state that
their channels are integers (``integer=True``: dt's, the forest's and a
sweep's class one-hots times integer weights) and the kernels count them
as integers, exact in any order; gb's float (g, h) go through float64
sums in an order fixed by the rows. Both give each cell's float64 sum
rounded once to float32. K4 reads a bins matrix that trees share once
for a group of trees.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.device import FEATURE_DTYPES, DeviceLike, resolve_device
from learningorchestra_tpu_torch.ml import progress as _progress
from learningorchestra_tpu_torch.ml.base import (
    FittedModel,
    infer_num_classes,
    largest_divisor,
    segment_steps,
    shard_matrix,
    to_host,
)
from learningorchestra_tpu_torch.ml.binning import MAX_BINS, apply_bins, make_thresholds

MAX_DEPTH = 5          # MLlib default maxDepth
NUM_TREES = 20         # MLlib default numTrees (RF)
GBT_ROUNDS = 20        # MLlib default maxIter (GBT)
GBT_STEP = 0.1         # MLlib default stepSize
EPS = 1e-12

# 2^MAX_SUPPORTED_DEPTH leaves per tree; deeper heaps are refused
MAX_SUPPORTED_DEPTH = 20
_INT32_LIMIT = 2**31 - 1


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _descend(X, features_heap, thresholds_heap, max_depth):
    """Leaf index of every row in one tree's heap.

    Raw value ``<= threshold`` goes left; ``~(x <= t)`` rather than
    ``x > t`` so NaN goes right. Only a node with ``feature >= 0`` may send
    a row right. The value is ``X[row, max(feature, 0)]``, and a feature
    index at or past the row width reads 0, as the reference's one-hot
    select does."""
    rows, width = X.shape
    # a zero column at index `width` stands for every out-of-range feature
    padded = torch.cat([X, X.new_zeros((rows, 1))], dim=1)
    node = torch.zeros(rows, dtype=torch.int64, device=X.device)
    for level in range(max_depth):
        heap_pos = (2**level - 1) + node
        feature = features_heap[heap_pos].long()
        threshold = thresholds_heap[heap_pos]
        column = feature.clamp(min=0).clamp(max=width)
        x = padded.gather(1, column[:, None])[:, 0]
        go_right = ~(x <= threshold) & (feature >= 0)
        node = node * 2 + go_right.long()
    return node


def _ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth):
    """Mean class distribution over trees: summed over trees in order
    0..T-1, then divided by T (the reference's scan order). No trees give
    the uniform ``1/C``."""
    X = X.to(torch.float32)   # bfloat16 widens exactly
    rows = X.shape[0]
    trees, _, num_classes = leaf_probs.shape
    if trees == 0:
        return _uniform(rows, num_classes, X.device)
    acc = torch.zeros((rows, num_classes), dtype=torch.float32, device=X.device)
    for tree in range(trees):
        leaf = _descend(X, features_heap[tree], thresholds_heap[tree], max_depth)
        acc = acc + leaf_probs[tree][leaf]
    # a tensor divisor: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, one rounding away from acc / T
    return acc / torch.tensor(float(trees), device=X.device)


def _gbt_forward(X, f0, features_heap, thresholds_heap, leaf_values, step, max_depth):
    """Boosted margins ``f0 + sum(step * leaf)`` over rounds in order,
    each product rounded to float32 before its add, through a sigmoid;
    returns ``[1 - p, p]``."""
    X = X.to(torch.float32)   # bfloat16 widens exactly
    step = torch.tensor(step, dtype=torch.float32, device=X.device)
    margins = torch.full(
        (X.shape[0],), float(f0), dtype=torch.float32, device=X.device
    )
    for tree in range(features_heap.shape[0]):
        leaf = _descend(X, features_heap[tree], thresholds_heap[tree], max_depth)
        margins = margins + step * leaf_values[tree][leaf]
    p = torch.sigmoid(margins)
    return torch.stack([1 - p, p], dim=1)


def _uniform(rows: int, num_classes: int, device) -> torch.Tensor:
    return torch.full(
        (rows, num_classes), 1.0 / num_classes, dtype=torch.float32, device=device
    )


# --------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# --------------------------------------------------------------------------

def _check_heaps(X, features_heap, thresholds_heap, leaves, leaf_ndim, max_depth):
    """Raise on what the forward does not take: types, shapes, devices.
    X is float32, or bfloat16 (``LO_DTYPE_POLICY=bf16``): the forward
    widens each value exactly to float32 before its compare."""
    if not isinstance(X, torch.Tensor) or X.dtype not in FEATURE_DTYPES or X.dim() != 2:
        raise TypeError("X must be a 2-D float32 or bfloat16 tensor")
    if not 0 <= max_depth <= MAX_SUPPORTED_DEPTH:
        raise ValueError(f"max_depth must be in [0, {MAX_SUPPORTED_DEPTH}], got {max_depth}")
    nodes, num_leaves = 2**max_depth - 1, 2**max_depth
    if features_heap.dtype != torch.int32 or thresholds_heap.dtype != torch.float32:
        raise TypeError("features_heap must be int32 and thresholds_heap float32")
    if leaves.dtype != torch.float32:
        raise TypeError("leaf parameters must be float32")
    trees = features_heap.shape[0] if features_heap.dim() == 2 else -1
    if (
        features_heap.shape != (trees, nodes)
        or thresholds_heap.shape != (trees, nodes)
        or leaves.dim() != leaf_ndim
        or tuple(leaves.shape[:2]) != (trees, num_leaves)
    ):
        raise ValueError(
            f"heap shapes {tuple(features_heap.shape)}, "
            f"{tuple(thresholds_heap.shape)}, {tuple(leaves.shape)} do not "
            f"match depth {max_depth}"
        )
    for tensor in (features_heap, thresholds_heap, leaves):
        if tensor.device != X.device:
            raise ValueError(f"parameters on {tensor.device}, rows on {X.device}")
    if X.shape[0] > _INT32_LIMIT or X.shape[1] > _INT32_LIMIT:
        raise ValueError(f"X of shape {tuple(X.shape)} is too large for the kernel")


def ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth):
    """Mean leaf class distribution ``(rows, C)`` over the trees."""
    _check_heaps(X, features_heap, thresholds_heap, leaf_probs, 3, max_depth)
    rows, num_classes = X.shape[0], leaf_probs.shape[2]
    if features_heap.shape[0] == 0:
        return _uniform(rows, num_classes, X.device)
    if X.device.type == "cpu":
        return _ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth)
    return _launch_ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth, 1)[0]


def _launch_ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth, jobs):
    """K6's ensemble forward over ``jobs`` jobs: X shared ``(rows, F)`` or
    ``(J, rows, F)``, heaps ``(J, T, nodes)``, leaf_probs ``(J, T,
    leaves, C)``; ``(J, rows, C)`` probabilities."""
    kernels.check_operands(X, features_heap, thresholds_heap, leaf_probs)
    rows = X.shape[-2]
    out = torch.empty((jobs, rows, leaf_probs.shape[-1]), dtype=torch.float32, device=X.device)
    _launch_forward(
        "tree_ensemble_forward", X, features_heap, thresholds_heap, leaf_probs, out, max_depth, jobs
    )
    return out


def job_ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth):
    """Each job's mean leaf class distribution over its own trees, on its
    own rows (K6 over a job axis, one launch): X ``(J, rows, F)`` or one
    shared ``(rows, F)``, ``features_heap`` and ``thresholds_heap`` ``(J,
    T, 2^D - 1)``, ``leaf_probs (J, T, 2^D, C)``; ``(J, rows, C)``. No sum
    crosses jobs."""
    if features_heap.dim() != 3 or thresholds_heap.dim() != 3 or leaf_probs.dim() != 4:
        raise ValueError("job heaps must be (J, T, nodes) and leaf_probs (J, T, leaves, C)")
    jobs = features_heap.shape[0]
    if (
        not isinstance(X, torch.Tensor) or X.dtype != torch.float32 or X.dim() not in (2, 3)
        or (X.dim() == 3 and X.shape[0] != jobs)
    ):
        # a sweep's payload is float32 whatever the policy
        raise TypeError(f"X must be float32 (rows, F), shared, or ({jobs}, rows, F)")
    if thresholds_heap.shape[0] != jobs or leaf_probs.shape[0] != jobs:
        raise ValueError("heaps and leaf_probs of different job counts")
    _check_heaps(
        X if X.dim() == 2 else X[0], features_heap[0], thresholds_heap[0], leaf_probs[0], 3, max_depth
    )
    rows, num_classes = X.shape[-2], leaf_probs.shape[-1]
    if features_heap.shape[1] == 0:
        return _uniform(rows, num_classes, X.device).expand(jobs, rows, num_classes).contiguous()
    if X.device.type == "cpu":
        return _job_ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth)
    return _launch_ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth, jobs)


def _job_ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth):
    """The plain twin of :func:`job_ensemble_forward`, a job at a time."""
    return torch.stack([
        _ensemble_forward(
            X if X.dim() == 2 else X[j], features_heap[j], thresholds_heap[j], leaf_probs[j], max_depth
        )
        for j in range(features_heap.shape[0])
    ])


def gbt_forward(X, f0, features_heap, thresholds_heap, leaf_values, step, max_depth):
    """Boosted class probabilities ``(rows, 2)``."""
    _check_heaps(X, features_heap, thresholds_heap, leaf_values, 2, max_depth)
    if X.device.type == "cpu":
        return _gbt_forward(
            X, f0, features_heap, thresholds_heap, leaf_values, step, max_depth
        )
    kernels.check_operands(X, features_heap, thresholds_heap, leaf_values)
    out = torch.empty((X.shape[0], 2), dtype=torch.float32, device=X.device)
    _launch_forward(
        "gbt_forward", X, features_heap, thresholds_heap, leaf_values, out, max_depth, 1,
        float(f0), float(step),
    )
    return out


# K6's launch geometry (kernels/csrc/tree_forward.cu): a block's threads,
# the staging items of X a thread holds ahead and the walks a tile holds
# at most (4 items and 16 walks a thread), the shared memory a block may
# take (set it low to force the passes and global trees, as the tests
# do), the sums carried between passes in shared memory at most, the
# blocks that small row counts are spread over (two an SM of an H100),
# the least tile, and where a thread walks its own row: at most
# kRegClasses classes, at least 16 trees a row and rows enough for tiles
# of a row a thread on every block
_FORWARD_THREADS = 256        # kThreads
_FORWARD_AHEAD = 4            # kAhead
_FORWARD_TILE_WALKS = _FORWARD_THREADS * 16
_FORWARD_SHARE = kernels.SHARED_BYTES
_FORWARD_ACC_SHARE = 48 * 1024
_FORWARD_BLOCKS = 264
_FORWARD_MIN_TILE = 32        # a warp's rows: a warp walks 32 rows of one tree
_FORWARD_REG_CLASSES = 4      # kRegClasses
_FORWARD_ROW_TREES = 16
_FORWARD_ROW_ROWS = _FORWARD_THREADS * _FORWARD_BLOCKS // 2


class ForwardGeometry(NamedTuple):
    """K6's launch: ``group_jobs`` jobs a block (jobs that share X, else
    one), tiles of ``tile_rows`` rows (a power of two, at least a warp's),
    trees staged (``staged``) or read from global memory ``pass_trees`` at
    a time (a group's every tree when one pass), the tile's rows staged in
    shared memory (``x_staged``), a thread walking its own row through
    every tree and summing in registers (``row_threads``) or a tile's
    (tree, row) walks spread over the threads before the sums, the sums
    carried between passes in shared memory (``acc_shared``, else in the
    output), ``shared_bytes`` a block."""

    group_jobs: int
    tile_rows: int
    pass_trees: int
    staged: bool
    x_staged: bool
    row_threads: bool
    acc_shared: bool
    shared_bytes: int


def _forward_shared_bytes(
    tile_rows, pass_trees, staged, x_staged, row_threads, acc, num_features, tree_bytes, classes
):
    """A block's shared memory, in the kernel's order: the staged trees,
    the tile's rows by feature column with a zero column, the walks' leaf
    offsets (none when a thread walks its row), the carried sums."""
    per_row = (
        ((num_features + 1) * 4 if x_staged else 0)
        + (0 if row_threads else pass_trees * 4)
        + (classes * 4 if acc else 0)
    )
    return (pass_trees * tree_bytes if staged else 0) + tile_rows * per_row


def _forward_geometry(
    rows: int, num_features: int, trees: int, depth: int, classes: int, jobs: int = 1,
    x_shared: bool = False, share: int | None = None,
) -> ForwardGeometry:
    """K6's geometry, a function of the shapes alone (``classes``: values a
    leaf, 1 for gb). Tiers, in order: (1) every tree of a group staged
    once, as many jobs a group as fit when they share X; (2) one job a
    block, passes of the trees that fit half the share, over tiles that
    fill the rest; (3) trees past half the share read from global memory,
    in passes only where a tile's leaf offsets of every tree pass the
    share. A thread walks its own row (tiles of a row a thread) at the
    batch lane's row counts, at most ``_FORWARD_REG_CLASSES`` classes and
    at least ``_FORWARD_ROW_TREES`` trees a row; else a tile holds up to
    16 walks a thread and 4 staging items of X a thread, fewer rows where
    that leaves the card short of blocks. Rows are staged while 32 of them
    take at most half the share."""
    share = _FORWARD_SHARE if share is None else share
    return _forward_geometry_at(rows, num_features, trees, depth, classes, jobs, x_shared, share)


def _power_of_two_at_most(value: int) -> int:
    return 1 << (max(1, value).bit_length() - 1)


@functools.lru_cache(maxsize=1024)
def _forward_geometry_at(rows, num_features, trees, depth, classes, jobs, x_shared, share):
    tree_bytes = (2**depth - 1) * 8 + 2**depth * classes * 4
    least = _FORWARD_MIN_TILE
    x_staged = least * (num_features + 1) * 4 <= share // 2
    # a tile's leaf offsets index its pass's leaf values as int32
    offsets = (2**31 - 1) // (2**depth * classes)
    row_threads = classes <= _FORWARD_REG_CLASSES and rows >= _FORWARD_ROW_ROWS

    def size(tile, pass_trees, staged, rows_form, acc=False):
        return _forward_shared_bytes(
            tile, pass_trees, staged, x_staged, rows_form, acc, num_features, tree_bytes, classes
        )

    def tile_rows(walks, staged, rows_form):
        if rows_form:   # a row a thread, the items past those fetched ahead loaded in place
            most = _FORWARD_THREADS
        else:
            words = _FORWARD_THREADS * _FORWARD_AHEAD * 4 // num_features
            most = min(_FORWARD_TILE_WALKS // max(walks, 1), words)
        fill = 1 << (-(-rows // _FORWARD_BLOCKS) - 1).bit_length()
        tile = max(least, min(_power_of_two_at_most(most), fill))
        while tile > least and size(tile, walks, staged, rows_form) > share:
            tile //= 2
        return tile

    # (1) a group's trees staged together, one pass
    group = jobs if x_shared else 1
    if trees:
        group = min(group, (share - size(least, 0, False, True)) // (trees * (tree_bytes + 4 * least)))
    if group >= 1:
        group = -(-jobs // -(-jobs // group))   # the groups evenly filled
        walks = group * trees
        rows_form = row_threads and walks >= _FORWARD_ROW_TREES
        tile = tile_rows(walks, True, rows_form)
        shared = size(tile, walks, True, rows_form)
        return ForwardGeometry(group, tile, walks, True, x_staged, rows_form, False, shared)
    rows_form = row_threads and trees >= _FORWARD_ROW_TREES
    # (2) passes of the trees that fit half the share
    pass_trees = min(trees, share // 2 // tree_bytes)
    if pass_trees >= 1:
        rest = share - pass_trees * tree_bytes
        cap = max(least, 1 << (rows - 1).bit_length())
        per_row = size(1, pass_trees, False, rows_form, acc=True)
        tile = min(_power_of_two_at_most(rest // per_row), cap)
        acc = tile * classes * 4 <= _FORWARD_ACC_SHARE
        if not acc:
            per_row = max(1, size(1, pass_trees, False, rows_form))
            tile = min(_power_of_two_at_most(rest // per_row), cap)
        shared = size(tile, pass_trees, True, rows_form, acc)
        if tile >= least and shared <= share:
            return ForwardGeometry(1, tile, pass_trees, True, x_staged, rows_form, acc, shared)
    # (3) trees from global memory
    if size(least, trees, False, False) > share or trees > offsets:
        acc = least * classes * 4 <= _FORWARD_ACC_SHARE and size(least, 1, False, False, True) <= share
        pass_trees = max(1, min(offsets, (share - size(least, 0, False, False, acc)) // (4 * least)))
        shared = size(least, pass_trees, False, False, acc)
        return ForwardGeometry(1, least, pass_trees, False, x_staged, False, acc, shared)
    tile = tile_rows(trees, False, rows_form)
    shared = size(tile, trees, False, rows_form)
    return ForwardGeometry(1, tile, trees, False, x_staged, rows_form, False, shared)


_forward_prepared: dict = {}
_forward_lock = threading.Lock()


def _forward_occupancy(device_index: int, gbt: bool, geometry: ForwardGeometry, x_bf16: bool) -> int:
    """Blocks of K6's form at ``geometry`` (over float32 or bfloat16 X) that
    the card holds at once, its shared-memory cap raised where needed:
    asked of the card once per device and form, then kept."""
    key = (
        device_index, x_bf16, gbt, geometry.staged, geometry.x_staged, geometry.row_threads,
        geometry.shared_bytes,
    )
    with _forward_lock:
        if key not in _forward_prepared:
            lib = kernels.library("tree_forward")
            per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
            kernels.check(lib, "tree_forward", lib.lo_tree_forward_prepare(
                int(x_bf16), int(gbt), int(geometry.staged), int(geometry.x_staged), int(geometry.row_threads),
                geometry.shared_bytes, device_index, ctypes.byref(per_sm), ctypes.byref(sms),
            ))
            if per_sm.value < 1:
                raise RuntimeError(f"K6 at {geometry} does not fit an SM")
            _forward_prepared[key] = per_sm.value * sms.value
        return _forward_prepared[key]


def _launch_forward(
    name, X, features_heap, thresholds_heap, values, out, max_depth, jobs, f0=0.0, step=0.0
):
    """One launch of K6 (``name``: the ensemble's or gb's) into ``out``:
    X ``(rows, F)`` shared by the jobs or ``(J, rows, F)``, heaps ``((J,)
    T, nodes)``, values ``((J,) T, leaves(, C))``."""
    rows, num_features = X.shape[-2:]
    if rows == 0:
        return
    gbt = name == "gbt_forward"
    trees = features_heap.shape[-2]
    classes = 1 if gbt else values.shape[-1]
    job_stride = rows * num_features if X.dim() == 3 else 0
    geometry = _forward_geometry(rows, num_features, trees, max_depth, classes, jobs, X.dim() == 2)
    device = X.device.index
    x_bf16 = X.dtype == torch.bfloat16
    resident = _forward_occupancy(device, gbt, geometry, x_bf16)
    groups = min(-(-jobs // geometry.group_jobs), 65535)
    blocks = max(1, min(-(-rows // geometry.tile_rows), resident // groups))
    # rows as 16-byte words: 4 float32 values, or 8 bfloat16
    vector = num_features % (8 if x_bf16 else 4) == 0 and X.data_ptr() % 16 == 0
    kernels.launch(
        name, "lo_tree_forward",
        int(x_bf16), int(gbt), int(geometry.staged), int(geometry.x_staged), int(geometry.row_threads),
        X.data_ptr(), features_heap.data_ptr(), thresholds_heap.data_ptr(), values.data_ptr(),
        out.data_ptr(), rows, num_features, trees, max_depth, classes, jobs, job_stride,
        geometry.group_jobs, geometry.tile_rows.bit_length() - 1, geometry.pass_trees,
        int(geometry.acc_shared), int(vector), f0, step, blocks, geometry.shared_bytes, device,
        torch.cuda.current_stream(X.device).cuda_stream,
    )


# --------------------------------------------------------------------------
# Models
# --------------------------------------------------------------------------

class _TreeEnsembleModel(FittedModel):
    """dt (one tree) and rf (T trees): stacked heaps plus leaf class
    distributions, on one device."""

    def __init__(self, features_heap, thresholds_heap, leaf_probs, max_depth):
        self.features_heap = features_heap        # (T, 2^D - 1) int32
        self.thresholds_heap = thresholds_heap    # (T, 2^D - 1) float32
        self.leaf_probs = leaf_probs              # (T, 2^D, C) float32
        self.max_depth = int(max_depth)
        self.device = features_heap.device

    def _forward(self, X):
        return ensemble_forward(
            X, self.features_heap, self.thresholds_heap, self.leaf_probs, self.max_depth
        )


class GBTModel(FittedModel):
    """gb: binary boosted trees with margin ``f0 + sum(step * leaf)``."""

    def __init__(self, f0, features_heap, thresholds_heap, leaf_values, step, max_depth):
        self.f0 = float(f0)
        self.features_heap = features_heap        # (T, 2^D - 1) int32
        self.thresholds_heap = thresholds_heap    # (T, 2^D - 1) float32
        self.leaf_values = leaf_values            # (T, 2^D) float32
        self.step = float(step)
        self.max_depth = int(max_depth)
        self.device = features_heap.device

    def _forward(self, X):
        return gbt_forward(
            X, self.f0, self.features_heap, self.thresholds_heap,
            self.leaf_values, self.step, self.max_depth,
        )


# --------------------------------------------------------------------------
# Fit: the level programs, plain versions
# --------------------------------------------------------------------------

def _level_histograms(bins, node, channels, n_nodes: int, max_bins: int):
    """Per-row channel vectors summed into ``(node, feature, bin, K)``: a
    scatter-add over rows, in float64, rounded once to float32 (see
    :func:`_leaf_sums`). ``node (rows,)`` and ``channels (rows, K)`` give
    one tree's ``(n_nodes, F, max_bins, K)``; a forest's ``node (T, rows)``
    and ``channels (T, rows, K)`` over the same bins give
    ``(T, n_nodes, F, max_bins, K)``, and so do a sweep's jobs over their
    own bins ``(T, rows, F)``."""
    if node.dim() == 1:
        return _level_histograms(bins, node[None], channels[None], n_nodes, max_bins)[0]
    trees, rows = node.shape
    num_features = bins.shape[-1]
    tree_bins = bins.long() if bins.dim() == 3 else bins.long()[None]
    num_channels = channels.shape[2]
    tree_node = torch.arange(trees, device=bins.device)[:, None] * n_nodes + node.long()
    index = (
        tree_node[:, :, None] * (num_features * max_bins)
        + torch.arange(num_features, device=bins.device) * max_bins
        + tree_bins
    )
    hist = torch.zeros(
        (trees * n_nodes * num_features * max_bins, num_channels),
        dtype=torch.float64,
        device=bins.device,
    )
    hist.index_add_(
        0,
        index.reshape(-1),
        channels.to(torch.float64)[:, :, None, :]
        .expand(trees, rows, num_features, num_channels)
        .reshape(-1, num_channels),
    )
    return hist.to(torch.float32).reshape(
        trees, n_nodes, num_features, max_bins, num_channels
    )


def _leaf_sums(leaf_of_row, channels, n_leaves: int):
    """Per-leaf channel sums ``(n_leaves, K)``; a forest's ``leaf_of_row
    (T, rows)`` and ``channels (T, rows, K)`` give ``(T, n_leaves, K)``.

    Sums of float32 channels are taken in float64 and rounded once to
    float32, here and in the kernels: a float32 sum of a node's rows in
    row order drifts by ~1e-5 relative over a few thousand rows, while the
    reference's float32 matmul sums in blocks and lands within ~1e-7 of the
    exact sum. In float64 the order of the adds no longer shows in the
    float32 result, so the plain version and the kernels agree, and class
    counts stay exact integers."""
    if leaf_of_row.dim() == 1:
        return _leaf_sums(leaf_of_row[None], channels[None], n_leaves)[0]
    trees, num_channels = leaf_of_row.shape[0], channels.shape[2]
    index = (
        torch.arange(trees, device=channels.device)[:, None] * n_leaves + leaf_of_row.long()
    )
    sums = torch.zeros(
        (trees * n_leaves, num_channels), dtype=torch.float64, device=channels.device
    )
    sums.index_add_(0, index.reshape(-1), channels.to(torch.float64).reshape(-1, num_channels))
    return sums.to(torch.float32).reshape(trees, n_leaves, num_channels)


def _cumsum_bins(hist):
    """Cumulative sum over the bin axis (2), one bin after the other, so
    every element rounds as a sequential sum does on any device."""
    left = torch.empty_like(hist)
    running = hist[:, :, 0]
    left[:, :, 0] = running
    for b in range(1, hist.shape[2]):
        running = running + hist[:, :, b]
        left[:, :, b] = running
    return left


def _channel_sum(values):
    """Sum over the last axis, in order from channel 0."""
    total = values[..., 0]
    for k in range(1, values.shape[-1]):
        total = total + values[..., k]
    return total


def _gini_gain(hist):
    """Split scores from class-count histograms ``(nodes, F, B, C)``:
    ``sum_c l_c^2 / n_l + sum_c r_c^2 / n_r - parent``; -inf where a side
    is empty."""
    left = _cumsum_bins(hist)
    total = left[:, :, -1:, :]
    right = total - left
    n_left = _channel_sum(left)
    n_right = _channel_sum(right)
    score_left = _channel_sum(left * left) / n_left.clamp(min=EPS)
    score_right = _channel_sum(right * right) / n_right.clamp(min=EPS)
    parent_total = total[:, :, 0, :]
    parent = _channel_sum(parent_total * parent_total) / _channel_sum(parent_total).clamp(min=EPS)
    gain = score_left + score_right - parent[:, :, None]
    valid = (n_left > 0) & (n_right > 0)
    return torch.where(valid, gain, -torch.inf)


def _newton_gain(hist, lam=1.0):
    """Split scores from ``(g, h)`` histograms ``(nodes, F, B, 2)``: the
    second-order gain of logistic boosting; -inf where a side has no
    hessian mass."""
    left = _cumsum_bins(hist)
    total = left[:, :, -1:, :]
    right = total - left
    g_left, h_left = left[..., 0], left[..., 1]
    g_right, h_right = right[..., 0], right[..., 1]
    score = g_left * g_left / (h_left + lam) + g_right * g_right / (h_right + lam)
    parent = total[:, :, 0, 0] * total[:, :, 0, 0] / (total[:, :, 0, 1] + lam)
    gain = score - parent[:, :, None]
    valid = (h_left > EPS) & (h_right > EPS)
    return torch.where(valid, gain, -torch.inf)


_GAINS = {"gini": _gini_gain, "newton": _newton_gain}
_MODES = {"gini": 0, "newton": 1}   # the kernel's mode argument


def _select_splits(gain, subset_scores=None, subset_k=None):
    """Best ``(feature, bin)`` per node from ``gain (nodes, F, B)``: the
    first maximum over the flattened ``(F, B)`` (a NaN gain counts as the
    maximum); a node whose best gain is not > 0, or is inf, becomes a leaf
    (feature -1, the argmax's bin kept). ``subset_scores (nodes, F)``
    restrict each node to the ``subset_k`` features of lowest score (the
    random forest's per-node feature subsets; the scores are drawn by the
    caller)."""
    n_nodes, num_features, max_bins = gain.shape
    if subset_scores is not None and subset_k is not None and subset_k < num_features:
        kth = torch.sort(subset_scores, dim=1).values[:, subset_k - 1]
        allowed = subset_scores <= kth[:, None]
        gain = torch.where(allowed[:, :, None], gain, -torch.inf)
    flat = gain.reshape(n_nodes, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    is_leaf = ~(best_gain > 0) | torch.isinf(best_gain)
    feature = torch.where(is_leaf, -1, best // max_bins).to(torch.int32)
    return feature, (best % max_bins).to(torch.int32)


def _select_plain(hist, mode: str, subset_scores=None, subset_k=None):
    """:func:`_select_splits` under the ``mode`` gain; a forest's ``hist
    (T, nodes, F, B, K)`` and ``subset_scores (T, nodes, F)`` go with
    ``(T, nodes)`` flattened into the node axis."""
    if hist.dim() == 5:
        trees, n_nodes = hist.shape[:2]
        scores = None if subset_scores is None else subset_scores.reshape(trees * n_nodes, -1)
        feature, bin_index = _select_plain(
            hist.reshape(trees * n_nodes, *hist.shape[2:]), mode, scores, subset_k
        )
        return feature.reshape(trees, n_nodes), bin_index.reshape(trees, n_nodes)
    return _select_splits(_GAINS[mode](hist), subset_scores, subset_k)


def _route(bins, node, feature, bin_index):
    """Each row one level down: right iff its bin at the node's feature is
    above the node's split bin; feature -1 nodes send every row left. A
    forest's ``node (T, rows)`` goes down its trees' splits ``feature``
    and ``bin_index (T, nodes)``, over the same bins (or a sweep's jobs,
    each over its own bins ``(T, rows, F)``)."""
    if node.dim() == 1:
        return _route(bins, node[None], feature[None], bin_index[None])[0]
    row_feature = feature.gather(1, node.long())
    row_bin = bin_index.gather(1, node.long())
    rows = torch.arange(bins.shape[-2], device=bins.device)
    if bins.dim() == 3:
        tree = torch.arange(bins.shape[0], device=bins.device)
        x_bin = bins[tree[:, None], rows[None, :], row_feature.clamp(min=0).long()]
    else:
        x_bin = bins[rows[None, :], row_feature.clamp(min=0).long()]
    go_right = (x_bin.to(torch.int32) > row_bin) & (row_feature >= 0)
    return node * 2 + go_right.to(torch.int32)


# --------------------------------------------------------------------------
# Fit: wrappers, plain version on the CPU, the CUDA kernel on the card
# --------------------------------------------------------------------------

# K2's sums path and K5's sum a fixed split of the rows into chunks
# (``kernels.row_chunks``, and for K2 ``_sum_chunks``: functions of the
# level's shape alone), so a refit repeats bit for bit. The counts paths
# add integers, whose sums no order changes.
# K5's sums path: warps a block (tree_fit.cu kLeafWarps), each with its own
# float64 copy of the cells, within a quarter of an SM's shared memory;
# its last block adds the chunks' partials when they are at most
# _LEAF_FUSE_VALUES a tree (else a second kernel does)
_LEAF_WARPS = 32
_LEAF_SUM_SHARE = kernels.SHARED_BYTES // 4
_LEAF_FUSE_VALUES = 32_768
# K5's most shared memory a block: all of it but room for its kernels'
# few static words (the last block's flag)
_LEAF_SHARE = kernels.SHARED_BYTES - 1024
# K5's counts: a chunk counting in shared memory takes at least this many
# rows a cell (its flush of the cells it touched then costs at most a
# sixteenth of its adds); a call whose chunks would then be fewer than
# _LEAF_COUNT_MIN_CHUNKS counts straight into global memory, every block
# busy (4,096 leaves x 10 classes at 1,000,000 rows)
_LEAF_COUNT_ROWS_PER_CELL = 16
_LEAF_COUNT_MIN_CHUNKS = 32
# K4: a block's share for its tree group's splits (8 bytes a node); a
# group whose one tree passes it reads its splits from global memory
_ROUTE_SHARE = kernels.BLOCK_SHARED_BYTES
# K2's sums path: warps a block (tree_fit.cu kSumWarps), each with its own
# copy of the window's cells, and a block's share of shared memory (two
# blocks an SM) unless one node and feature needs more
_SUM_WARPS = 8
_SUM_STAGE_ROWS = 128      # rows a warp stages at a time (tree_fit.cu kSumStageRows)
_SUM_SHARE = 100 * 1024
_SUM_ROWS_PER_CELL = 4
# Levels of several node windows, up to this many, partition each chunk's
# rows by window first (their counts sit in shared memory): a window's
# blocks then read only its rows
_PARTITION_WINDOWS = 4096
# K2's counts path: a block's 32-bit counts of its features' cells (two
# blocks an SM); one feature's cells past it go straight to global memory
_COUNT_SHARE = 96 * 1024
# Counts: a channel is an integer below this (a chunk of at most as many
# rows cannot pass 2^32 in a 32-bit count), and a chunk takes at least
# this many rows a cell of a feature, so that its flush of the cells it
# touched costs at most a quarter of its adds
COUNT_LIMIT = 65536
_COUNT_ROWS_PER_CELL = 4


class HistogramTiling(NamedTuple):
    """How K2's sums path covers a level: blocks of windows of ``nodes``
    nodes and of ``block_features`` features (one launch), one pass per
    window of ``bins`` x ``channels`` (the whole of both when a node and a
    feature fit a block)."""

    nodes: int
    bins: int
    channels: int
    block_features: int


class CountTiling(NamedTuple):
    """How K2's counts path covers a level: ``chunks`` chunks of
    ``rows_per_chunk`` rows, blocks of ``block_features`` features that
    count in shared memory when ``in_shared`` (else one block of every
    feature counts straight into the output)."""

    chunks: int
    rows_per_chunk: int
    block_features: int
    in_shared: bool


class LeafTiling(NamedTuple):
    """How K5's sums path covers the leaves: one pass per window of
    ``leaves`` x ``channels`` cells, ``warps`` private copies of them a
    block."""

    leaves: int
    channels: int
    warps: int


class LeafCountTiling(NamedTuple):
    """How K5's counts path covers the rows: ``chunks`` chunks of
    ``rows_per_chunk`` rows, a block each, counting in shared memory when
    ``in_shared`` (else in global memory)."""

    chunks: int
    rows_per_chunk: int
    in_shared: bool


class RouteGeometry(NamedTuple):
    """How K4 covers a level: trees in groups of ``group`` (each row's
    bins read once a group: 1 when each tree has its own bins), the
    group's splits staged in ``shared_bytes`` of shared memory when
    ``staged``."""

    group: int
    staged: bool
    shared_bytes: int


class SplitGeometry(NamedTuple):
    """How K3 covers a level: blocks of ``block_nodes`` nodes of
    ``node_threads`` threads each; each node's features in windows of
    ``window_features``, staged in shared memory when ``in_shared`` (else
    in global scratch); ``shared_bytes`` a block."""

    node_threads: int
    block_nodes: int
    window_features: int
    in_shared: bool
    shared_bytes: int


# K3: threads a node (tree_fit.cu kSplitThreads at most: a thread a
# (feature, bin) cell up to it), and a block's threads when nodes of few
# cells share a block
_SPLIT_THREADS = 512
_SPLIT_BLOCK_THREADS = 256
_SPLIT_FEW_CELLS = 128
# A K3 block's shared memory: all of it; a smaller share takes a node in
# windows of features sooner
_SPLIT_SHARE = kernels.SHARED_BYTES


def _split_stage_floats(window_features: int, max_bins: int, num_channels: int) -> int:
    """A node's staged window (tree_fit.cu select_splits_kernel): bin-major,
    each bin's ``window_features * K`` floats padded to an odd count."""
    return max_bins * (window_features * num_channels | 1)


def _split_shared_bytes(
    node_threads, block_nodes, window_features, num_features, max_bins, num_channels, in_shared
):
    """A K3 block's shared memory: its nodes' stages (when in shared
    memory), parents, candidate flags and subset scores, and each warp's
    best."""
    stage = _split_stage_floats(window_features, max_bins, num_channels) if in_shared else 0
    per_node = stage + 2 * window_features + num_features
    return 4 * block_nodes * per_node + 8 * (node_threads * block_nodes // 32)


@functools.lru_cache(maxsize=256)
def _k3_geometry(
    num_features: int, max_bins: int, num_channels: int, share: int = kernels.SHARED_BYTES
) -> SplitGeometry:
    """K3's geometry, a function of the shape alone: a thread a (feature,
    bin) cell up to ``_SPLIT_THREADS`` a node; nodes of at most
    ``_SPLIT_FEW_CELLS`` cells several a block. A node's histogram in
    shared memory (``share`` bytes a block, all of it by default) when it
    fits; else windows of as many features as fit, spread evenly; past
    one feature's bins, the stage in global scratch, windows of as many
    features as their parents and flags let fit."""
    F, B, K = num_features, max_bins, num_channels
    cells = F * B
    node_threads = min(_SPLIT_THREADS, -(-cells // 32) * 32)
    block_nodes = max(1, _SPLIT_BLOCK_THREADS // node_threads) if cells <= _SPLIT_FEW_CELLS else 1

    def fits(nodes, features, in_shared):
        return _split_shared_bytes(node_threads, nodes, features, F, B, K, in_shared) <= share

    while block_nodes > 1 and not fits(block_nodes, F, True):
        block_nodes //= 2
    if fits(block_nodes, F, True):
        return SplitGeometry(node_threads, block_nodes, F, True,
                             _split_shared_bytes(node_threads, block_nodes, F, F, B, K, True))
    features = F
    while features > 0 and not fits(1, features, True):
        features -= 1
    in_shared = features > 0
    if not in_shared:
        features = F
        while features > 1 and not fits(1, features, False):
            features //= 2
    windows = -(-F // features)
    features = -(-F // windows)
    return SplitGeometry(node_threads, 1, features, in_shared,
                         _split_shared_bytes(node_threads, 1, features, F, B, K, in_shared))


def _windows(total: int, size: int) -> list[tuple[int, int]]:
    """``(begin, count)`` of each window of ``size`` over ``range(total)``,
    in the order the kernels' entry points run them."""
    return [(begin, min(size, total - begin)) for begin in range(0, total, size)]


def _word_features(num_features: int, block_features: int, bin_bytes: int, fits) -> int:
    """``block_features`` rounded up to whole 16-byte words of bins, when
    the rows fall on 16 bytes and ``fits(rounded)``: the kernels then load
    a row's bins as words."""
    per_word = 16 // bin_bytes
    rounded = min(num_features, -(-block_features // per_word) * per_word)
    if num_features % per_word == 0 and rounded % per_word == 0 and fits(rounded):
        return rounded
    return block_features


def _sum_shared_bytes(tiling: HistogramTiling, bin_bytes: int) -> int:
    """A sums block's shared memory: each warp's float64 copy of its
    window's cells and its staged rows (tree_fit.cu ``sum_staging_bytes``:
    their bins, a multiple of 16 bytes, then their channels and nodes)."""
    cells = tiling.nodes * tiling.block_features * tiling.bins * tiling.channels
    staged = _SUM_STAGE_ROWS * (tiling.block_features * bin_bytes + 4 * (tiling.channels + 1))
    return _SUM_WARPS * (cells * 8 + staged)


@functools.lru_cache(maxsize=256)
def _block_features(
    num_features: int, n_nodes: int, max_bins: int, num_channels: int, bin_bytes: int = 1
) -> HistogramTiling:
    """K2's sums tiling, a function of the level's shape alone. Each of a
    block's ``_SUM_WARPS`` warps keeps a float64 copy of the block's cells
    (``_sum_shared_bytes``): every feature of as many nodes as fit
    ``_SUM_SHARE`` (the whole level when it fits); else one node of as
    many features as fit, spread evenly over the blocks (rounded up to
    whole words of bins where a block still fits its shared memory); else,
    when one node and feature need more, a block of up to all of its
    shared memory, and past that windows of bins, then of channels, over
    one feature."""
    F, B, K, rows = num_features, max_bins, num_channels, _SUM_STAGE_ROWS

    def room(share, channels):   # a warp's bytes past its staged rows' channels and nodes
        return share // _SUM_WARPS - rows * 4 * (channels + 1)

    for share in (_SUM_SHARE, kernels.SHARED_BYTES):
        nodes = (room(share, K) - rows * F * bin_bytes) // (F * B * K * 8)
        if nodes >= 1:
            return HistogramTiling(min(n_nodes, nodes), B, K, F)
        most = room(share, K) // (B * K * 8 + rows * bin_bytes)
        if most >= 1:
            blocks = -(-F // most)
            features = _word_features(
                F, -(-F // blocks), bin_bytes,
                lambda f: _sum_shared_bytes(HistogramTiling(1, B, K, f), bin_bytes) <= kernels.SHARED_BYTES,
            )
            return HistogramTiling(1, B, K, features)
    channels = K
    while channels > 1 and room(kernels.SHARED_BYTES, channels) - rows * bin_bytes < channels * 8:
        channels = max(1, channels // 2)
    bins = (room(kernels.SHARED_BYTES, channels) - rows * bin_bytes) // (channels * 8)
    return HistogramTiling(1, min(B, bins), channels, 1)


@functools.lru_cache(maxsize=256)
def _sum_chunks(rows: int, n_nodes: int, max_bins: int) -> tuple[int, int]:
    """``(chunks, rows per chunk)`` of K2's sums path: ``kernels.row_chunks``,
    with at least ``_SUM_ROWS_PER_CELL`` rows a (node, bin) of a feature for
    each warp of a block, so that a warp's adds outnumber the cells of its
    copy that it zeroes and hands on, and a deep level's partials (a
    chunk's cells) stay within its rows. A function of the level's shape
    alone."""
    chunks, per_chunk = kernels.row_chunks(rows)
    per_chunk = max(per_chunk, _SUM_ROWS_PER_CELL * _SUM_WARPS * n_nodes * max_bins)
    return -(-rows // per_chunk), per_chunk


def _partitioned(windows: int) -> bool:
    """Whether K2's sums path partitions each chunk's rows by node window
    first: levels of several windows, up to ``_PARTITION_WINDOWS``. A
    warp's part of the rows is then a contiguous part of its window's rows
    (in row order), else of the chunk's; a function of the shape alone."""
    return 1 < windows <= _PARTITION_WINDOWS


@functools.lru_cache(maxsize=256)
def _count_tiling(
    rows: int, num_features: int, n_nodes: int, max_bins: int, num_channels: int,
    bin_bytes: int = 1,
) -> CountTiling:
    """K2's counts tiling, a function of the level's shape alone. When one
    feature's 32-bit counts fit ``_COUNT_SHARE``, blocks of as many
    features as fit it, spread evenly (rounded up to whole words of bins
    where a block still fits its shared memory), over chunks of at least
    ``_COUNT_ROWS_PER_CELL`` rows a cell of a feature and at most
    ``COUNT_LIMIT``; else one block of every feature counting into the
    output, over ``kernels.row_chunks``' split."""
    chunks, per_chunk = kernels.row_chunks(rows)
    per_feature = n_nodes * max_bins * num_channels * 4
    if per_feature > _COUNT_SHARE:
        return CountTiling(chunks, per_chunk, num_features, False)
    blocks = -(-num_features // (_COUNT_SHARE // per_feature))
    block_features = _word_features(
        num_features, -(-num_features // blocks), bin_bytes,
        lambda f: f * per_feature <= kernels.SHARED_BYTES,
    )
    per_chunk = min(COUNT_LIMIT, max(per_chunk, _COUNT_ROWS_PER_CELL * per_feature // 4))
    return CountTiling(-(-rows // per_chunk), per_chunk, block_features, True)


def _leaf_warps(n_leaves: int, num_channels: int) -> LeafTiling:
    """K5's sums tiling: warps of a block, each with its own float64 copy
    of the sums, as many as fit ``_LEAF_SUM_SHARE`` (up to
    ``_LEAF_WARPS``); past one block's shared memory, windows of leaves (or
    of channels) that fit one warp's copy."""
    per_warp = n_leaves * num_channels * 8
    if per_warp <= _LEAF_SHARE:
        warps = max(1, min(_LEAF_WARPS, _LEAF_SUM_SHARE // per_warp))
        return LeafTiling(n_leaves, num_channels, warps)
    if num_channels * 8 <= _LEAF_SHARE:
        return LeafTiling(_LEAF_SHARE // (num_channels * 8), num_channels, 1)
    return LeafTiling(1, _LEAF_SHARE // 8, 1)


def _leaf_fused(chunks: int, tiling: LeafTiling, n_leaves: int, num_channels: int) -> bool:
    """Whether K5's sums path is one launch: one window of every cell, and
    a tree's partials (chunks x cells) few enough for its last block to
    add them. A function of one tree's shape, so that a tree alone and
    within a tree axis take the same path."""
    return (tiling.leaves, tiling.channels) == (n_leaves, num_channels) and (
        chunks * n_leaves * num_channels <= _LEAF_FUSE_VALUES
    )


@functools.lru_cache(maxsize=256)
def _leaf_count_tiling(rows: int, n_leaves: int, num_channels: int) -> LeafCountTiling:
    """K5's counts tiling, a function of the shape alone: a block counts
    its chunk's rows in shared memory while the tree's cells fit it, in
    chunks of at least ``_LEAF_COUNT_ROWS_PER_CELL`` rows a cell and at
    most ``COUNT_LIMIT``, unless that leaves fewer than
    ``_LEAF_COUNT_MIN_CHUNKS`` chunks (and fewer than ``kernels.row_chunks``
    gives): then every block of that split counts straight into global
    memory."""
    chunks, per_chunk = kernels.row_chunks(rows)
    cells = n_leaves * num_channels
    shared_chunk = min(COUNT_LIMIT, max(per_chunk, _LEAF_COUNT_ROWS_PER_CELL * cells))
    shared_chunks = -(-rows // shared_chunk)
    if cells * 4 <= _LEAF_SHARE and shared_chunks >= min(chunks, _LEAF_COUNT_MIN_CHUNKS):
        return LeafCountTiling(shared_chunks, shared_chunk, True)
    return LeafCountTiling(chunks, per_chunk, False)


def _route_geometry(
    trees: int, n_nodes: int, bins_shared: bool, share: int | None = None
) -> RouteGeometry:
    """K4's tree groups. Trees over one bins matrix (``bins_shared``) go in
    groups of as many as ``share`` holds the splits of (each row's bins
    read once a group); trees with their own bins in groups of one. A
    group whose one tree's splits pass the share reads them from global
    memory (every shared-bins tree then in one group)."""
    share = _ROUTE_SHARE if share is None else share
    per_tree = n_nodes * 8
    fits = share // per_tree if per_tree else trees
    if not bins_shared:
        return RouteGeometry(1, fits >= 1, per_tree if fits >= 1 else 0)
    if fits < 1:
        return RouteGeometry(max(1, trees), False, 0)
    group = max(1, min(trees, fits))
    return RouteGeometry(group, True, group * per_tree)


def _check_rows(bins, node, channels=None):
    """Raise on what K2, K4 and K5 do not take. ``node`` is ``(rows,)``,
    or a forest's ``(T, rows)``; ``channels`` ``node.shape + (K,)``; bins
    ``(rows, F)``, or a sweep's jobs' own ``(T, rows, F)``."""
    if not isinstance(bins, torch.Tensor) or bins.dim() not in (2, 3) or bins.dtype not in (
        torch.int8, torch.int32
    ):
        raise TypeError("bins must be a 2-D (or a job axis' 3-D) int8 or int32 tensor")
    if node.dtype != torch.int32 or node.dim() not in (1, 2) or node.shape[-1] != bins.shape[-2]:
        raise TypeError("node must be an int32 tensor of one entry per row (of each tree)")
    if bins.dim() == 3 and (node.dim() != 2 or node.shape[0] != bins.shape[0]):
        raise ValueError(f"{bins.shape[0]} jobs of bins for nodes of shape {tuple(node.shape)}")
    tensors = [node]
    if channels is not None:
        if channels.dtype != torch.float32 or channels.dim() != node.dim() + 1:
            raise TypeError("channels must be a float32 tensor of K channels a row (of each tree)")
        if channels.shape[:-1] != node.shape:
            raise ValueError(
                f"channels of shape {tuple(channels.shape)} for nodes of shape {tuple(node.shape)}"
            )
        tensors.append(channels)
    for tensor in tensors:
        if tensor.device != bins.device:
            raise ValueError(f"operands on {tensor.device} and {bins.device}")


def _stream(tensor):
    return torch.cuda.current_stream(tensor.device).cuda_stream


def _check_counts(channels) -> None:
    """Raise unless every channel is an integer in ``[0, COUNT_LIMIT)``:
    the claim a caller of the counts path makes."""
    if channels.numel() and not bool(
        ((channels >= 0) & (channels < COUNT_LIMIT) & (channels == channels.trunc())).all()
    ):
        raise ValueError(
            f"integer channels must be integers in [0, {COUNT_LIMIT}): the claim is false"
        )


def level_histograms(bins, node, channels, n_nodes: int, max_bins: int, integer: bool = False):
    """``(n_nodes, F, max_bins, K)`` float32 sums of the rows' channels by
    node, feature and bin (K2). A forest's ``node (T, rows)`` and
    ``channels (T, rows, K)`` over the same bins give ``(T, n_nodes, F,
    max_bins, K)`` from one launch, and so do a sweep's T jobs over their
    own bins ``(T, rows, F)``.

    ``integer=True`` is the caller's statement that every channel is an
    integer in ``[0, COUNT_LIMIT)`` (class one-hots times integer
    weights): the sums are then counted as integers, exact in any order
    (the counts path). A false claim raises: here a ``ValueError``; on the
    card the kernel traps on the first value that breaks it, and PyTorch
    raises the device error at the next synchronization. Nothing falls
    back to the sums path. Either path gives each cell's float64 sum
    rounded once to float32."""
    _check_rows(bins, node, channels)
    if bins.device.type == "cpu":
        if integer:
            _check_counts(channels)
        return _level_histograms(bins, node, channels, n_nodes, max_bins)
    kernels.check_operands(bins, node, channels)
    forest = node.dim() == 2
    trees = node.shape[0] if forest else 1
    rows, num_features = bins.shape[-2:]
    num_channels = channels.shape[-1]
    shape = (trees, n_nodes, num_features, max_bins, num_channels)
    if rows == 0:
        out = torch.zeros(shape, dtype=torch.float32, device=bins.device)
        return out if forest else out[0]
    # the kernels write every cell
    out = torch.empty(shape, dtype=torch.float32, device=bins.device)
    if out.numel() == 0:
        return out if forest else out[0]
    # a forest's trees share the bins; a sweep's jobs each have their own
    bins_tree_stride = rows * num_features if bins.dim() == 3 else 0
    if integer:
        counts = _count_tiling(rows, num_features, n_nodes, max_bins, num_channels, bins.element_size())
        kernels.launch(
            "level_histograms", "lo_level_counts",
            bins.data_ptr(), bins.element_size(), node.data_ptr(), channels.data_ptr(),
            out.data_ptr(), rows, num_features, n_nodes, max_bins, num_channels,
            trees, bins_tree_stride, counts.chunks, counts.rows_per_chunk,
            counts.block_features, int(counts.in_shared),
            kernels.max_blocks(bins.device.index), bins.device.index, _stream(bins),
        )
        return out if forest else out[0]
    chunks, per_chunk = _sum_chunks(rows, n_nodes, max_bins)
    tiling = _block_features(num_features, n_nodes, max_bins, num_channels, bins.element_size())
    # a pass's partials of each tree, reused by every pass
    partials = torch.empty(
        (trees, chunks, n_nodes, num_features, tiling.bins, tiling.channels),
        dtype=torch.float64, device=bins.device,
    )
    order = window_begin = None
    windows = -(-n_nodes // tiling.nodes)
    if _partitioned(windows):
        order = torch.empty((trees, rows), dtype=torch.int32, device=bins.device)
        window_begin = torch.empty((trees, chunks, windows + 1), dtype=torch.int32, device=bins.device)
    kernels.launch(
        "level_histograms", "lo_level_histograms",
        bins.data_ptr(), bins.element_size(), node.data_ptr(), channels.data_ptr(),
        partials.data_ptr(), None if order is None else order.data_ptr(),
        None if window_begin is None else window_begin.data_ptr(), out.data_ptr(),
        rows, num_features, n_nodes, max_bins, num_channels,
        trees, bins_tree_stride,
        chunks, per_chunk, tiling.nodes, tiling.bins, tiling.channels,
        tiling.block_features,
        kernels.max_blocks(bins.device.index), bins.device.index, _stream(bins),
    )
    return out if forest else out[0]


def select_splits(hist, mode: str, subset_scores=None, subset_k=None):
    """Best ``(feature, bin)`` per node of ``hist (nodes, F, B, K)``, or of
    a forest's ``(T, nodes, F, B, K)`` with ``(T, nodes)`` flattened into
    the node axis, under the ``"gini"`` or ``"newton"`` gain (K3); with
    ``subset_scores`` (``hist``'s leading shape by F, float32 in [0, 1))
    each node takes its ``subset_k`` features of lowest score. See
    :func:`_select_splits`."""
    if not isinstance(hist, torch.Tensor) or hist.dtype != torch.float32 or hist.dim() not in (4, 5):
        raise TypeError("hist must be a 4-D (or a forest's 5-D) float32 tensor")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    if mode == "newton" and hist.shape[-1] != 2:
        raise ValueError("the newton gain takes (g, h) channels: K must be 2")
    leading, num_features = hist.shape[:-3], hist.shape[-3]
    if subset_scores is not None:
        if subset_scores.dtype != torch.float32 or subset_scores.shape != (*leading, num_features):
            raise ValueError(
                f"subset_scores must be float32 of shape {(*leading, num_features)}, "
                f"got {subset_scores.dtype} {tuple(subset_scores.shape)}"
            )
        if subset_k is None or subset_k < 1:
            raise ValueError(f"subset_k must be at least 1, got {subset_k}")
        if subset_scores.device != hist.device:
            raise ValueError(f"subset_scores on {subset_scores.device}, hist on {hist.device}")
    if hist.device.type == "cpu":
        return _select_plain(hist, mode, subset_scores, subset_k)
    kernels.check_operands(hist)
    max_bins, num_channels = hist.shape[-2:]
    n_nodes = int(np.prod(leading))
    scores = None
    if subset_scores is not None and subset_k < num_features:
        # the forest's slice of a level: a copy when it is not contiguous
        scores = subset_scores.reshape(n_nodes, num_features).contiguous()
    feature, bin_index = torch.empty((2, *leading), dtype=torch.int32, device=hist.device)
    if n_nodes == 0:
        return feature, bin_index
    geometry = _k3_geometry(num_features, max_bins, num_channels, _SPLIT_SHARE)
    stage = None
    if not geometry.in_shared:
        stage = torch.empty(
            n_nodes * _split_stage_floats(geometry.window_features, max_bins, num_channels),
            dtype=torch.float32, device=hist.device,
        )
    kernels.launch(
        "select_splits", "lo_select_splits",
        hist.data_ptr(), None if scores is None else scores.data_ptr(), subset_k or 0,
        feature.data_ptr(), bin_index.data_ptr(), None if stage is None else stage.data_ptr(),
        n_nodes, num_features, max_bins, num_channels, _MODES[mode],
        geometry.node_threads, geometry.block_nodes, geometry.window_features,
        hist.device.index, _stream(hist),
    )
    return feature, bin_index


def route(bins, node, feature, bin_index):
    """Each row's node one level down (K4); a forest's ``node (T, rows)``
    down its trees' splits ``feature`` and ``bin_index (T, nodes)``, over
    one bins matrix (read once for a group of trees) or a sweep's jobs'
    own ``(T, rows, F)``."""
    _check_rows(bins, node)
    if feature.dtype != torch.int32 or bin_index.dtype != torch.int32:
        raise TypeError("feature and bin_index must be int32")
    if (
        feature.dim() != node.dim()
        or feature.shape != bin_index.shape
        or feature.shape[:-1] != node.shape[:-1]
    ):
        raise ValueError("feature and bin_index must hold one entry per node (of each tree)")
    if feature.device != bins.device or bin_index.device != bins.device:
        raise ValueError("the split and the rows must lie on one device")
    if bins.device.type == "cpu":
        return _route(bins, node, feature, bin_index)
    kernels.check_operands(bins, node, feature, bin_index)
    out = torch.empty_like(node)
    if node.numel() == 0:
        return out
    trees, n_nodes = (node.shape[0] if node.dim() == 2 else 1), feature.shape[-1]
    geometry = _route_geometry(trees, n_nodes, bins.dim() == 2)
    kernels.launch(
        "route", "lo_route",
        bins.data_ptr(), bins.element_size(), node.data_ptr(), feature.data_ptr(),
        bin_index.data_ptr(), out.data_ptr(),
        bins.shape[-2], bins.shape[-1], trees, n_nodes,
        bins.shape[-2] * bins.shape[-1] if bins.dim() == 3 else 0,
        geometry.group, int(geometry.staged), bins.device.index, _stream(bins),
    )
    return out


def leaf_sums(leaf_of_row, channels, n_leaves: int, integer: bool = False):
    """``(n_leaves, K)`` float32 sums of the rows' channels by leaf (K5); a
    forest's ``leaf_of_row (T, rows)`` and ``channels (T, rows, K)`` give
    ``(T, n_leaves, K)`` from one launch, and so do a sweep's jobs.

    ``integer=True`` is the caller's statement that every channel is an
    integer in ``[0, COUNT_LIMIT)``, as for :func:`level_histograms`: the
    sums are counted as 32-bit integers (a ``ValueError`` here on a false
    claim, a trap on the card; nothing falls back). Either path gives each
    cell's float64 sum rounded once to float32."""
    if leaf_of_row.dtype != torch.int32 or leaf_of_row.dim() not in (1, 2):
        raise TypeError("leaf_of_row must be an int32 tensor of one entry per row (of each tree)")
    if channels.dtype != torch.float32 or channels.dim() != leaf_of_row.dim() + 1:
        raise TypeError("channels must be a float32 tensor of K channels a row (of each tree)")
    if channels.shape[:-1] != leaf_of_row.shape:
        raise ValueError(
            f"channels of shape {tuple(channels.shape)} for leaves of shape {tuple(leaf_of_row.shape)}"
        )
    if channels.device != leaf_of_row.device:
        raise ValueError(f"operands on {channels.device} and {leaf_of_row.device}")
    if channels.device.type == "cpu":
        if integer:
            _check_counts(channels)
        return _leaf_sums(leaf_of_row, channels, n_leaves)
    kernels.check_operands(leaf_of_row, channels)
    forest = leaf_of_row.dim() == 2
    trees = leaf_of_row.shape[0] if forest else 1
    rows, num_channels = leaf_of_row.shape[-1], channels.shape[-1]
    shape = (trees, n_leaves, num_channels)
    if rows == 0:
        out = torch.zeros(shape, dtype=torch.float32, device=channels.device)
        return out if forest else out[0]
    # the kernels write every cell
    out = torch.empty(shape, dtype=torch.float32, device=channels.device)
    if out.numel() == 0:
        return out if forest else out[0]
    device = channels.device
    if integer:
        tiling = _leaf_count_tiling(rows, n_leaves, num_channels)
        scratch = kernels.zeroed_scratch(device, trees * (1 + n_leaves * num_channels))
        kernels.launch(
            "leaf_sums", "lo_leaf_counts",
            leaf_of_row.data_ptr(), channels.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            rows, n_leaves, num_channels, trees, tiling.chunks, tiling.rows_per_chunk,
            int(tiling.in_shared), device.index, _stream(channels),
        )
        return out if forest else out[0]
    tiling = _leaf_warps(n_leaves, num_channels)
    chunks, per_chunk = kernels.row_chunks(rows)
    fused = _leaf_fused(chunks, tiling, n_leaves, num_channels)
    tickets = kernels.zeroed_scratch(device, trees) if fused else None
    # one window's partials of each tree, reused by every pass
    partials = torch.empty(
        (trees, chunks, tiling.leaves, tiling.channels), dtype=torch.float64, device=device
    )
    kernels.launch(
        "leaf_sums", "lo_leaf_sums",
        leaf_of_row.data_ptr(), channels.data_ptr(), partials.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out.data_ptr(),
        rows, n_leaves, num_channels, trees, chunks, per_chunk,
        tiling.leaves, tiling.channels, tiling.warps, int(fused),
        kernels.max_blocks(device.index), device.index, _stream(channels),
    )
    return out if forest else out[0]


# --------------------------------------------------------------------------
# Fits. No host sync anywhere in a level or boosting loop: each level's
# split feeds the next level's routing on the device.
# --------------------------------------------------------------------------

def _grow(
    bins, channels, mode: str, max_depth: int, max_bins: int, subset_scores=None, subset_k=None,
    integer: bool = False,
):
    """Grow one tree, or a forest's trees together, level by level.
    ``channels (rows, K)`` grow one tree; a forest's ``(T, rows, K)`` grow
    T trees over the same bins, each level one launch of each kernel for
    all of them. ``subset_scores ((T,) 2^D - 1, F)``, in heap order (level
    l's nodes are rows ``2^l - 1 .. 2^(l+1) - 2``), restrict each node to
    its ``subset_k`` features of lowest score. ``integer``: the caller's
    statement that the channels are integers (the counts paths of K2 and
    K5, see :func:`level_histograms`). Returns the heaps (features and
    split bins per internal node, ``((T,) 2^D - 1)``) and every row's leaf
    index ``((T,) rows)``."""
    node = torch.zeros(channels.shape[:-1], dtype=torch.int32, device=bins.device)
    features_heap, bins_heap = [], []
    for level in range(max_depth):
        hist = level_histograms(bins, node, channels, 2**level, max_bins, integer=integer)
        scores = None
        if subset_scores is not None:
            scores = subset_scores[..., 2**level - 1 : 2 ** (level + 1) - 1, :]
        feature, bin_index = select_splits(hist, mode, scores, subset_k)
        features_heap.append(feature)
        bins_heap.append(bin_index)
        node = route(bins, node, feature, bin_index)
    return torch.cat(features_heap, dim=-1), torch.cat(bins_heap, dim=-1), node


def _fit_classification_tree(
    bins, one_hot, max_depth: int, max_bins: int, subset_scores=None, subset_k=None,
    integer: bool = False,
):
    features_heap, bins_heap, leaf_of_row = _grow(
        bins, one_hot, "gini", max_depth, max_bins, subset_scores, subset_k, integer
    )
    leaf_counts = leaf_sums(leaf_of_row, one_hot, 2**max_depth, integer=integer)
    leaf_probs = leaf_counts / _channel_sum(leaf_counts).clamp(min=EPS)[..., None]
    return features_heap, bins_heap, leaf_probs


def _fit_newton_tree(bins, g, h, max_depth: int, max_bins: int):
    channels = torch.stack([g, h], dim=1)
    features_heap, bins_heap, leaf_of_row = _grow(
        bins, channels, "newton", max_depth, max_bins
    )
    sums = leaf_sums(leaf_of_row, channels, 2**max_depth)
    leaf_values = -sums[:, 0] / (sums[:, 1] + 1.0)
    return features_heap, bins_heap, leaf_values, leaf_of_row


def _dt_fit(
    bins, y, weights, num_classes: int, max_depth: int, max_bins: int, integer: bool = False
):
    """A decision tree on the class one-hots times ``weights``; ``integer``:
    the caller's statement that the weights are integers (the estimator's
    are ones)."""
    one_hot = torch.nn.functional.one_hot(y.long(), num_classes).to(torch.float32)
    return _fit_classification_tree(
        bins, one_hot * weights[:, None], max_depth, max_bins, integer=integer
    )


class ForestDraws(NamedTuple):
    """A forest fit's random draws, made by the caller: each tree's
    Poisson(1) bootstrap count of every row, and each node's feature
    scores, in heap order, of which the node takes the ``subset_k``
    lowest."""

    bootstrap: torch.Tensor       # (T, rows) float32
    subset_scores: torch.Tensor   # (T, 2^D - 1, F) float32 in [0, 1)


def _forest_draws(
    num_trees: int, rows: int, max_depth: int, num_features: int, generator, device
) -> ForestDraws:
    """The draws of a forest fit, on ``device`` from ``generator`` (a
    ``torch.Generator`` of that device): the bootstrap first, then the
    scores. The same generator state gives the same draws."""
    bootstrap = torch.poisson(
        torch.ones((num_trees, rows), dtype=torch.float32, device=device), generator=generator
    )
    subset_scores = torch.rand(
        (num_trees, 2**max_depth - 1, num_features),
        generator=generator, dtype=torch.float32, device=device,
    )
    return ForestDraws(bootstrap, subset_scores)


def _rf_chunk(
    bins, y, weights, bootstrap, subset_scores, num_classes: int, max_depth: int,
    max_bins: int, subset_k: int,
):
    """A chunk of trees grown together: tree t's channels are the class
    one-hots weighted by ``weights * bootstrap[t]``, rounded in the
    reference's order. The forest's weights are ones and its bootstrap
    Poisson counts, so the channels are integers (the counts paths)."""
    base_one_hot = torch.nn.functional.one_hot(y.long(), num_classes).to(torch.float32)
    one_hot = base_one_hot[None] * (weights[None] * bootstrap)[:, :, None]
    return _fit_classification_tree(
        bins, one_hot, max_depth, max_bins, subset_scores, subset_k, integer=True
    )


# Per-chunk budget in row*trees (the reference's, so the chunks match)
_RF_ROW_TREES_BUDGET = 40e6

# Device bytes the trees of one chunk may hold together: 32 GB, 40% of
# the H100's 80 GB, leaving the rest to X and its bins, the caching
# allocator's slack and the models the serve registry keeps. At the
# default forest (1,000,000 rows x 16 features, 2 classes, depth 5, 32
# bins) a tree holds 24 MB of rows (24 B a row, see _rf_tree_bytes) and
# 64 KB of its deepest level's histogram (K2's counts path keeps no
# partials): 1,330 trees a chunk, so the 20 trees run as one. At
# 10,000,000 rows: 133 trees. (The reference's cap of 20e6 row*trees was
# sized for a 16 GB TPU chip's one-hot transients, which the port does
# not make.)
_RF_CHUNK_BYTES = 32e9


def _rf_tree_bytes(bins, num_classes: int, max_depth: int, max_bins: int) -> int:
    """Device bytes one tree of a chunk holds at its widest level: per
    row, its node before and after routing (4 + 4), its bootstrap count
    and that times the row's weight (4 + 4), and its class channels (4 C);
    per tree, the float32 histogram of the deepest level, which K2's
    counts path fills in place."""
    rows, num_features = bins.shape
    n_nodes = 2 ** max(max_depth - 1, 0)
    hist = n_nodes * num_features * max_bins * num_classes * 4
    return rows * (16 + 4 * num_classes) + hist


def _rf_fit(
    bins, y, weights, draws: ForestDraws, num_classes: int, max_depth: int,
    max_bins: int, num_trees: int, subset_k: int,
):
    """Forest fit in chunks of trees: the reference's watchdog budget and
    a device-memory cap (``_RF_CHUNK_BYTES``). Trees are independent and
    each takes its own draws, so the chunking changes no bit. Returns the
    stacked heaps ``(T, 2^D - 1)`` and leaf probabilities
    ``(T, 2^D, C)``."""
    nodes = 2**max_depth - 1
    rows, num_features = bins.shape
    if tuple(draws.bootstrap.shape) != (num_trees, rows) or tuple(
        draws.subset_scores.shape
    ) != (num_trees, nodes, num_features):
        raise ValueError(
            f"draws of shapes {tuple(draws.bootstrap.shape)}, "
            f"{tuple(draws.subset_scores.shape)} for {num_trees} trees of depth "
            f"{max_depth} over {rows} rows x {num_features} features"
        )
    if num_trees <= 0:   # an empty forest: empty heaps
        device = bins.device
        return (
            torch.zeros((0, nodes), dtype=torch.int32, device=device),
            torch.zeros((0, nodes), dtype=torch.int32, device=device),
            torch.zeros((0, nodes + 1, num_classes), dtype=torch.float32, device=device),
        )
    chunk = segment_steps(num_trees, rows, _RF_ROW_TREES_BUDGET, num_features)
    memory_chunk = max(
        1, int(_RF_CHUNK_BYTES // _rf_tree_bytes(bins, num_classes, max_depth, max_bins))
    )
    if memory_chunk < chunk:
        chunk = largest_divisor(num_trees, memory_chunk)
    parts = [
        _rf_chunk(
            bins, y, weights, draws.bootstrap[start : start + chunk],
            draws.subset_scores[start : start + chunk], num_classes, max_depth,
            max_bins, subset_k,
        )
        for start in range(0, num_trees, chunk)
    ]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(arrays) for arrays in zip(*parts))


def _heap_thresholds(features_heap, bins_heap, thresholds):
    """Float threshold per internal node: ``thresholds[f, b]`` (a split at
    the last bin is never selected, its right side being empty)."""
    safe_feature = features_heap.clamp(min=0).long()
    safe_bin = bins_heap.clamp(max=thresholds.shape[1] - 1).long()
    return thresholds[safe_feature, safe_bin]


def _gbt_init(y, weights):
    """``f0``, the log-odds of the weighted base rate, as a float32 device
    scalar, and every row's starting margin."""
    y_f = y.to(torch.float32)
    n_real = weights.sum().clamp(min=1.0)
    base_rate = ((y_f * weights).sum() / n_real).clamp(1e-6, 1 - 1e-6)
    f0 = torch.log(base_rate / (1 - base_rate))
    return f0, f0.expand(y.shape[0]).clone()


def _gbt_rounds_impl(bins, y, weights, margins, max_depth: int, max_bins: int, rounds: int, step):
    """``rounds`` boosting rounds, margins in and out; the heaps of the
    rounds stacked. Each margin update rounds the product before the add."""
    y_f = y.to(torch.float32)
    # a fill on the device: a copy from the host would wait for the stream
    step = torch.full((), float(step), dtype=torch.float32, device=margins.device)
    features, split_bins, values = [], [], []
    for _ in range(rounds):
        p = torch.sigmoid(margins)
        g = (p - y_f) * weights
        h = (p * (1 - p)).clamp(min=1e-6) * weights
        features_heap, bins_heap, leaf_values, leaf_of_row = _fit_newton_tree(
            bins, g, h, max_depth, max_bins
        )
        margins = margins + step * leaf_values[leaf_of_row.long()]
        features.append(features_heap)
        split_bins.append(bins_heap)
        values.append(leaf_values)
    if rounds <= 0:
        nodes, device = 2**max_depth - 1, margins.device
        return (
            margins,
            torch.zeros((0, nodes), dtype=torch.int32, device=device),
            torch.zeros((0, nodes), dtype=torch.int32, device=device),
            torch.zeros((0, nodes + 1), dtype=torch.float32, device=device),
        )
    return margins, torch.stack(features), torch.stack(split_bins), torch.stack(values)


# Per-segment budget in row*rounds (the reference's, so the segments match)
_GB_ROW_ROUNDS_BUDGET = 40e6


def _gbt_fit(bins, y, weights, max_depth: int, max_bins: int, rounds: int, step):
    """Sequential boosting in segments of ``segment_steps`` rounds; the
    margins carry from one segment to the next. Returns ``f0``, the
    stacked heaps and leaf values, and the final margins."""
    f0, margins = _gbt_init(y, weights)
    if rounds <= 0:
        margins, features_heap, bins_heap, leaf_values = _gbt_rounds_impl(
            bins, y, weights, margins, max_depth, max_bins, 0, step
        )
        return f0, features_heap, bins_heap, leaf_values, margins
    chunk = segment_steps(rounds, bins.shape[0], _GB_ROW_ROUNDS_BUDGET, bins.shape[1])
    total_chunks = rounds // chunk
    # Crash resume (reference ml/trees.py:594-637, ml/progress.py): the
    # margins and the heaps so far are enough to replay the remaining
    # chunks bit for bit (f0 is recomputed from y and the weights above).
    # The artifact must match this call's chunking and hyperparameters
    # on top of the sink's own key, else the fit restarts clean.
    scalars = {
        "chunk": chunk,
        "rounds": rounds,
        "max_depth": max_depth,
        "max_bins": max_bins,
        "step": float(np.asarray(step)),
    }
    heaps = []
    start = 0
    sink = _progress.current_sink()
    if sink is not None:
        restored = sink.load("gbt")
        if restored is not None:
            done, arrays, saved = restored
            state = None
            nodes = 2**max_depth - 1
            if (
                all(saved.get(key) == scalars[key] for key in scalars)
                and 0 < done <= total_chunks
                and len(arrays) == 4
            ):
                templates = (
                    margins,
                    torch.zeros((done * chunk, nodes), dtype=torch.int32, device=margins.device),
                    torch.zeros((done * chunk, nodes), dtype=torch.int32, device=margins.device),
                    torch.zeros((done * chunk, nodes + 1), dtype=torch.float32, device=margins.device),
                )
                state = _progress.device_restore(templates, arrays)
            if state is None:
                sink.discard()
            else:
                margins = state[0]
                heaps.append(tuple(state[1:]))
                start = done
                _progress.segments_skipped(done)
    for index in range(start, total_chunks):
        margins, features_heap, bins_heap, leaf_values = _gbt_rounds_impl(
            bins, y, weights, margins, max_depth, max_bins, chunk, step
        )
        heaps.append((features_heap, bins_heap, leaf_values))
        if sink is not None:
            sink.save(
                "gbt",
                index + 1,
                [to_host(margins)]
                + [to_host(torch.cat([h[i] for h in heaps])) for i in range(3)],
                scalars,
            )
    features_heap, bins_heap, leaf_values = (torch.cat(parts) for parts in zip(*heaps))
    return f0, features_heap, bins_heap, leaf_values, margins


# --------------------------------------------------------------------------
# Estimators
# --------------------------------------------------------------------------

def _fit_inputs(X, y, max_bins: int, device):
    """Host thresholds (float64 quantiles of the host rows, then float32 as
    the bins use them) and the rows (in the policy's type), labels and
    thresholds on ``device``."""
    thresholds = make_thresholds(X, max_bins)
    X_dev = shard_matrix(X, device)
    y_dev = torch.from_numpy(np.asarray(y, dtype=np.int64)).to(device)
    thresholds_dev = torch.from_numpy(thresholds.astype(np.float32)).to(device)
    return X_dev, y_dev, thresholds_dev


class DecisionTreeClassifier:
    def __init__(
        self, max_depth: int = MAX_DEPTH, max_bins: int = MAX_BINS, device: DeviceLike = None
    ):
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.device = resolve_device(device)

    def fit(self, X, y) -> _TreeEnsembleModel:
        num_classes = infer_num_classes(y)
        X_dev, y_dev, thresholds = _fit_inputs(X, y, self.max_bins, self.device)
        bins = apply_bins(X_dev, thresholds)
        weights = torch.ones(X_dev.shape[0], dtype=torch.float32, device=self.device)
        features_heap, bins_heap, leaf_probs = _dt_fit(
            bins, y_dev, weights, num_classes, self.max_depth, self.max_bins, integer=True
        )
        thresholds_heap = _heap_thresholds(features_heap, bins_heap, thresholds)
        return _TreeEnsembleModel(
            features_heap[None], thresholds_heap[None], leaf_probs[None], self.max_depth
        )


class RandomForestClassifier:
    """``num_trees`` trees, each grown on a Poisson(1) bootstrap of the
    rows, each node splitting on the best of ``ceil(sqrt(F))`` features
    drawn for it (MLlib's featureSubsetStrategy "auto").

    The draws are not the reference's. The reference draws the bootstrap
    and the feature scores from threefry keys of ``jax.random.key(seed)``;
    the port draws them on the device from a ``torch.Generator`` seeded
    with ``seed`` (:func:`_forest_draws`). One seed so grows another forest
    in each package, from the same distributions; each package refits its
    own forest bit for bit from the same seed on the same device, and
    handed the same draws the two grow identical heaps."""

    def __init__(
        self,
        num_trees: int = NUM_TREES,
        max_depth: int = MAX_DEPTH,
        max_bins: int = MAX_BINS,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.num_trees = num_trees
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.seed = seed
        self.device = resolve_device(device)

    def fit(self, X, y) -> _TreeEnsembleModel:
        rows, num_features = np.shape(X)
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        draws = _forest_draws(
            self.num_trees, rows, self.max_depth, num_features, generator, self.device
        )
        return self._fit_with_draws(X, y, draws)

    def _fit_with_draws(self, X, y, draws: ForestDraws) -> _TreeEnsembleModel:
        num_classes = infer_num_classes(y)
        subset_k = max(1, int(np.ceil(np.sqrt(np.shape(X)[1]))))
        X_dev, y_dev, thresholds = _fit_inputs(X, y, self.max_bins, self.device)
        bins = apply_bins(X_dev, thresholds)
        weights = torch.ones(X_dev.shape[0], dtype=torch.float32, device=self.device)
        features_heap, bins_heap, leaf_probs = _rf_fit(
            bins, y_dev, weights, draws, num_classes, self.max_depth, self.max_bins,
            self.num_trees, subset_k,
        )
        thresholds_heap = _heap_thresholds(features_heap, bins_heap, thresholds)
        return _TreeEnsembleModel(features_heap, thresholds_heap, leaf_probs, self.max_depth)


class GBTClassifier:
    """Binary gradient-boosted trees (MLlib GBTClassifier is binary-only)."""

    def __init__(
        self,
        rounds: int = GBT_ROUNDS,
        step: float = GBT_STEP,
        max_depth: int = MAX_DEPTH,
        max_bins: int = MAX_BINS,
        device: DeviceLike = None,
    ):
        self.rounds = rounds
        self.step = step
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.device = resolve_device(device)

    def fit(self, X, y) -> GBTModel:
        if infer_num_classes(y) > 2:
            raise ValueError("GBTClassifier supports binary labels only (MLlib contract)")
        X_dev, y_dev, thresholds = _fit_inputs(X, y, self.max_bins, self.device)
        bins = apply_bins(X_dev, thresholds)
        weights = torch.ones(X_dev.shape[0], dtype=torch.float32, device=self.device)
        f0, features_heap, bins_heap, leaf_values, _ = _gbt_fit(
            bins, y_dev, weights, self.max_depth, self.max_bins, self.rounds, self.step
        )
        thresholds_heap = _heap_thresholds(features_heap, bins_heap, thresholds)
        # the fit's one device-to-host copy: f0, which the model keeps on the host
        return GBTModel(
            float(to_host(f0)), features_heap, thresholds_heap, leaf_values, self.step, self.max_depth
        )
