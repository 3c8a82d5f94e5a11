"""Tree-ensemble prediction: the heap walk on raw floats.

Counterpart of the predict half of ``learningorchestra_tpu/ml/trees.py``:
``_descend`` (:303), ``_ensemble_forward`` (:364, dt and rf),
``_gbt_forward`` (:648, gb), ``_TreeEnsembleModel`` and ``GBTModel``.
The fits (histograms, split search, routing) are not ported yet.

A fitted tree is a static heap: ``features_heap (T, 2^D - 1)`` int32
(``-1`` marks a node that stopped splitting), ``thresholds_heap`` float32
of the same shape, and per-leaf ``leaf_probs (T, 2^D, C)`` or boosted
``leaf_values (T, 2^D)``.

Two versions of each forward live here:

- the plain PyTorch functions ``_descend``, ``_ensemble_forward`` and
  ``_gbt_forward``, which repeat the reference's arithmetic in the same
  order (the tests hold them against the JAX functions, and the chip
  smoke holds the kernel against them);
- the wrappers ``ensemble_forward`` and ``gbt_forward``, which the models
  call. On a CPU tensor a wrapper runs the plain function; on a CUDA
  tensor it launches the hand-written kernel (``kernels/csrc/
  tree_forward.cu``) or raises. Nothing falls back.
"""

from __future__ import annotations

import functools

import torch

from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.ml.base import FittedModel

MAX_DEPTH = 5          # MLlib default maxDepth
NUM_TREES = 20         # MLlib default numTrees (RF)
GBT_ROUNDS = 20        # MLlib default maxIter (GBT)
GBT_STEP = 0.1         # MLlib default stepSize

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
    """Raise on what the forward does not take: types, shapes, devices."""
    if not isinstance(X, torch.Tensor) or X.dtype != torch.float32 or X.dim() != 2:
        raise TypeError("X must be a 2-D float32 tensor")
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


def _check_kernel_operands(*tensors) -> None:
    for tensor in tensors:
        if tensor.device.type != "cuda":
            raise ValueError(f"kernel operand on {tensor.device}, not a CUDA device")
        if not tensor.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int) -> int:
    # enough resident blocks to fill every SM; the grid-stride loop
    # covers the remaining rows
    return torch.cuda.get_device_properties(device_index).multi_processor_count * 8


def ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth):
    """Mean leaf class distribution ``(rows, C)`` over the trees."""
    _check_heaps(X, features_heap, thresholds_heap, leaf_probs, 3, max_depth)
    rows, num_classes = X.shape[0], leaf_probs.shape[2]
    if features_heap.shape[0] == 0:
        return _uniform(rows, num_classes, X.device)
    if X.device.type == "cpu":
        return _ensemble_forward(X, features_heap, thresholds_heap, leaf_probs, max_depth)
    _check_kernel_operands(X, features_heap, thresholds_heap, leaf_probs)
    out = torch.empty((rows, num_classes), dtype=torch.float32, device=X.device)
    if rows == 0:
        return out
    lib = kernels.library()
    error = lib.lo_tree_ensemble_forward(
        X.data_ptr(), features_heap.data_ptr(), thresholds_heap.data_ptr(),
        leaf_probs.data_ptr(), out.data_ptr(),
        rows, X.shape[1], features_heap.shape[0], max_depth, num_classes,
        _max_blocks(X.device.index), X.device.index,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    kernels.check(lib, "tree_ensemble_forward", error)
    kernels.count_launch("tree_ensemble_forward")
    return out


def gbt_forward(X, f0, features_heap, thresholds_heap, leaf_values, step, max_depth):
    """Boosted class probabilities ``(rows, 2)``."""
    _check_heaps(X, features_heap, thresholds_heap, leaf_values, 2, max_depth)
    if X.device.type == "cpu":
        return _gbt_forward(
            X, f0, features_heap, thresholds_heap, leaf_values, step, max_depth
        )
    _check_kernel_operands(X, features_heap, thresholds_heap, leaf_values)
    rows = X.shape[0]
    out = torch.empty((rows, 2), dtype=torch.float32, device=X.device)
    if rows == 0:
        return out
    lib = kernels.library()
    error = lib.lo_gbt_forward(
        X.data_ptr(), features_heap.data_ptr(), thresholds_heap.data_ptr(),
        leaf_values.data_ptr(), out.data_ptr(),
        rows, X.shape[1], features_heap.shape[0], max_depth,
        float(f0), float(step),
        _max_blocks(X.device.index), X.device.index,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    kernels.check(lib, "gbt_forward", error)
    kernels.count_launch("gbt_forward")
    return out


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
