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
"""

from __future__ import annotations

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
    kernels.check_operands(X, thresholds)
    bins = torch.empty(X.shape, dtype=bin_dtype(thresholds.shape[1] + 1), device=X.device)
    kernels.launch(
        "apply_bins", "lo_apply_bins",
        X.data_ptr(), thresholds.data_ptr(), bins.data_ptr(), bins.element_size(),
        X.shape[0], X.shape[1], thresholds.shape[1],
        kernels.max_blocks(X.device.index), X.device.index,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    return bins

