"""Feature binning: quantile thresholds on the host, bins on the device.

Counterpart of ``learningorchestra_tpu/ml/binning.py:20-54``. Bin ``b``
holds the values ``thresholds[b-1] < x <= thresholds[b]``; a split "at
bin b" sends ``x <= thresholds[b]`` left, so prediction on raw floats
needs only the float threshold. NaN goes to the last bin.

- :func:`make_thresholds` is the reference's, exactly: host numpy,
  float64 ``nanquantile``, NaN thresholds (all-NaN features) become inf.
  The fits cast the thresholds to float32 before binning, as the
  reference does (``ml/trees.py:684``).
- :func:`_apply_bins` is the plain PyTorch version of
  ``searchsorted(side="left")``; :func:`apply_bins` is the wrapper the fits
  call. On a CPU tensor it runs the plain version; on a CUDA tensor it
  launches K1 (``kernels/csrc/tree_fit.cu``) or raises. Both give int8
  bins while ``max_bins`` <= 127 and int32 bins above, as the reference.
- :func:`job_apply_bins` bins a job axis in one launch (the sweep's dt
  program, ``ml/sweep.py:263``, runs ``apply_bins`` under ``vmap``): each
  job its own rows and thresholds; its plain twin loops over the jobs.
- :func:`_k1_geometry` is how K1 covers a launch, a function of the
  shapes alone: each feature's thresholds padded with +inf to a power of
  two (a branch-free search), the jobs that share X in groups whose
  thresholds fit a block's shared memory (each row of X read once a
  group), windows of features past it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from learningorchestra_tpu_torch import kernels

MAX_BINS = 32
# bins are int8 up to this many bins, int32 above (reference ml/binning.py:54)
INT8_MAX_BINS = 127


def make_thresholds(X: np.ndarray, max_bins: int = MAX_BINS) -> np.ndarray:
    """Per-feature quantile thresholds, shape ``(features, max_bins - 1)``,
    float64. Duplicate quantiles leave empty bins, which never win a
    split. NaNs are ignored by the quantiles and land in the last bin."""
    quantiles = np.linspace(0, 1, max_bins + 1)[1:-1]
    with np.errstate(all="ignore"):
        thresholds = np.nanquantile(np.asarray(X, np.float64), quantiles, axis=0).T
    return np.nan_to_num(thresholds, nan=np.inf)


def _apply_bins(X: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Bin index in ``[0, max_bins)`` of every value: the count of the
    feature's thresholds below it (``searchsorted(side="left")`` on sorted
    thresholds), and ``max_bins - 1`` for NaN, which is below nothing.
    int8 while the bin count fits, else int32, as the reference."""
    num_thresholds = thresholds.shape[1]
    bins = torch.empty(X.shape, dtype=bin_dtype(num_thresholds + 1), device=X.device)
    for feature in range(X.shape[1]):  # one feature at a time: (rows, B-1) transient
        column = X[:, feature]
        below = (thresholds[feature][None, :] < column[:, None]).sum(dim=1)
        bins[:, feature] = torch.where(column.isnan(), num_thresholds, below).to(bins.dtype)
    return bins


def bin_dtype(max_bins: int) -> torch.dtype:
    return torch.int8 if max_bins <= INT8_MAX_BINS else torch.int32


def apply_bins(X: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """``(rows, features)`` bins of ``X`` under ``thresholds
    (features, max_bins - 1)``, both float32 on one device: int8, or
    int32 past 127 bins."""
    if not isinstance(X, torch.Tensor) or X.dtype != torch.float32 or X.dim() != 2:
        raise TypeError("X must be a 2-D float32 tensor")
    if thresholds.dtype != torch.float32 or thresholds.dim() != 2:
        raise TypeError("thresholds must be a 2-D float32 tensor")
    if thresholds.shape[0] != X.shape[1]:
        raise ValueError(
            f"{thresholds.shape[0]} threshold rows for {X.shape[1]} features"
        )
    if thresholds.device != X.device:
        raise ValueError(f"thresholds on {thresholds.device}, rows on {X.device}")
    if X.device.type == "cpu":
        return _apply_bins(X, thresholds)
    return _launch_apply_bins(X, thresholds, 1)[0]


# K1's block (tree_fit.cu kBinThreads: a row a thread) and the share of
# shared memory a block keeps to for its staged thresholds (two blocks an
# SM); past one feature's row, the thresholds stay in global memory
_BIN_THREADS = 256
_BIN_SHARE = 96 * 1024
# rows K1 indexes with 32-bit integers, a tile of _BIN_THREADS at a time
_INT32_ROWS = 2**31 - 1 - _BIN_THREADS


class BinGeometry(NamedTuple):
    """How K1 covers a launch: each feature's thresholds padded with +inf
    to ``2**steps`` floats; ``group`` jobs a block (jobs that share X;
    else 1); windows of ``window_features`` features, staged in shared
    memory (``shared_bytes`` a block) when ``staged``, else searched in a
    padded table in global memory."""

    steps: int
    group: int
    window_features: int
    staged: bool
    shared_bytes: int


@functools.lru_cache(maxsize=256)
def _k1_geometry(
    num_features: int, num_thresholds: int, jobs: int, x_shared: bool, bin_bytes: int,
    share: int = _BIN_SHARE,
) -> BinGeometry:
    """K1's geometry, a function of the shapes alone. When a job's padded
    thresholds fit ``share`` bytes: groups of as many jobs as fit (jobs
    that share X; else one a group), spread evenly. Else one job a block
    and windows of as many features as fit (whole 16-byte words of bins
    where that is more than one word); past one feature's row, the padded
    table in global memory, one window and the groups of the shared X."""
    steps = int(num_thresholds).bit_length()   # the least power of two > num_thresholds
    per_feature = 4 << steps
    per_job = num_features * per_feature
    if per_job <= share:
        groups = -(-jobs // (min(jobs, share // per_job) if x_shared else 1))
        group = -(-jobs // groups)
        return BinGeometry(steps, group, num_features, True, group * per_job)
    features = share // per_feature
    if features == 0:
        return BinGeometry(steps, jobs if x_shared else 1, num_features, False, 0)
    per_word = 16 // bin_bytes
    if features > per_word:
        features -= features % per_word
    return BinGeometry(steps, 1, features, True, features * per_feature)


def _launch_apply_bins(X, thresholds, jobs: int):
    """K1 over ``jobs`` jobs: X shared ``(rows, F)`` or ``(J, rows, F)``,
    thresholds shared ``(F, B-1)`` or ``(J, F, B-1)``; ``(J, rows, F)``
    bins."""
    kernels.check_operands(X, thresholds)
    rows, num_features = X.shape[-2:]
    if rows > _INT32_ROWS:
        raise ValueError(f"{rows} rows is too many for the kernel (at most {_INT32_ROWS})")
    num_thresholds = thresholds.shape[-1]
    bins = torch.empty(
        (jobs, rows, num_features), dtype=bin_dtype(num_thresholds + 1), device=X.device
    )
    if bins.numel() == 0:
        return bins
    geometry = _k1_geometry(
        num_features, num_thresholds, jobs, X.dim() == 2, bins.element_size(), _BIN_SHARE
    )
    table = thresholds
    if not geometry.staged:   # a padded table, +inf past each feature's thresholds
        table = torch.full(
            (*thresholds.shape[:-1], 1 << geometry.steps), float("inf"), device=X.device
        )
        table[..., :num_thresholds] = thresholds
    kernels.launch(
        "apply_bins", "lo_apply_bins",
        X.data_ptr(), table.data_ptr(), bins.data_ptr(), bins.element_size(),
        rows, num_features, num_thresholds, geometry.steps, jobs, geometry.group,
        geometry.window_features, int(geometry.staged),
        rows * num_features if X.dim() == 3 else 0,
        table.shape[-2] * table.shape[-1] if table.dim() == 3 else 0,
        X.device.index,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    return bins


def _job_apply_bins(X, thresholds):
    """The plain twin of :func:`job_apply_bins`, a job at a time."""
    jobs = X.shape[0] if X.dim() == 3 else thresholds.shape[0]
    return torch.stack([
        _apply_bins(X if X.dim() == 2 else X[j], thresholds if thresholds.dim() == 2 else thresholds[j])
        for j in range(jobs)
    ])


def job_apply_bins(X: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """``(J, rows, F)`` bins of every job's rows under its own thresholds
    (K1 over a job axis, one launch): X ``(J, rows, F)`` or one shared
    ``(rows, F)``, thresholds ``(J, F, B-1)`` or one shared ``(F, B-1)``,
    at least one of them with the job axis."""
    if not isinstance(X, torch.Tensor) or X.dtype != torch.float32 or X.dim() not in (2, 3):
        raise TypeError("X must be a float32 tensor (rows, F), shared, or (jobs, rows, F)")
    if thresholds.dtype != torch.float32 or thresholds.dim() not in (2, 3):
        raise TypeError("thresholds must be a float32 tensor (F, B-1), shared, or (jobs, F, B-1)")
    if X.dim() == 2 and thresholds.dim() == 2:
        raise ValueError("X or thresholds must carry the job axis")
    jobs = X.shape[0] if X.dim() == 3 else thresholds.shape[0]
    if X.dim() == 3 and thresholds.dim() == 3 and thresholds.shape[0] != jobs:
        raise ValueError(f"{thresholds.shape[0]} threshold jobs for {jobs} jobs of rows")
    if thresholds.shape[-2] != X.shape[-1]:
        raise ValueError(f"{thresholds.shape[-2]} threshold rows for {X.shape[-1]} features")
    if thresholds.device != X.device:
        raise ValueError(f"thresholds on {thresholds.device}, rows on {X.device}")
    if X.device.type == "cpu":
        return _job_apply_bins(X, thresholds)
    return _launch_apply_bins(X, thresholds, jobs)
