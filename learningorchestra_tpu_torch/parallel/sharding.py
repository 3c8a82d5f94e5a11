"""Rows over the ``data`` axis: padding, blocks, replication, the dtype policy.

Counterpart of ``learningorchestra_tpu/parallel/sharding.py:34-123``.
Padded row counts are bucketed to the shared quarter-octave grid
(utils/shapegrid.py), then aligned to the data axis, so nearby dataset
sizes share one padded shape: the job coalescer keys on it, and members of
nearby sizes fuse. The mask keeps the padded rows out of every sum.

The reference puts the whole padded array on a ``NamedSharding`` and XLA
hands each device its shard; here each rank keeps only its own block:
:func:`shard_rows` returns data index ``r``'s rows ``[r * block, (r + 1)
* block)`` of the padded array and their validity mask, the reference's
shard ``r`` exactly, replicated over the model group (its
``P(DATA_AXIS)``: every rank of one model group holds the same block).
The single-card callers (the sweep's job axis) pass ``multiple=1`` to
:func:`pad_rows`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from learningorchestra_tpu_torch.utils.dtypepolicy import dtype_policy
from learningorchestra_tpu_torch.utils.shapegrid import bucket_count, grid_size


def bucket_rows(n: int) -> int:
    """Smallest quarter-octave grid value >= n: {4,5,6,7} x 2^k."""
    return bucket_count(n)


def padded_row_count(n: int, multiple: int) -> int:
    """Rows after bucket-then-align padding — THE padded-shape rule, shared
    by :func:`pad_rows` and the per-host feeder
    (``multihost.shard_rows_local``)."""
    # grid_size honors LO_SHAPE_BUCKETS (read once in utils/shapegrid)
    target = grid_size(n)
    return ((target + multiple - 1) // multiple) * multiple


def pad_rows(array: np.ndarray, multiple: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad axis 0 to the bucketed grid; returns (padded, validity mask)."""
    n = array.shape[0]
    padded_n = padded_row_count(n, multiple)
    mask = np.zeros(padded_n, dtype=bool)
    mask[:n] = True
    if padded_n == n:
        return array, mask
    pad_width = [(0, padded_n - n)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_width), mask


def policy_dtype(dtype) -> Optional[torch.dtype]:
    """The torch dtype a buffer requested as ``dtype`` (numpy or torch)
    ships in under ``LO_DTYPE_POLICY``: ``bf16`` maps float requests to
    bfloat16, while int, bool and mask buffers are never touched. Identity
    under ``f32``."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        floating = dtype.is_floating_point
        as_torch = dtype
    else:
        floating = np.issubdtype(np.dtype(dtype), np.floating)
        as_torch = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    if floating and dtype_policy() == "bf16":
        return torch.bfloat16
    return as_torch


def to_device(host: np.ndarray, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One host-to-device copy of ``host`` in ``dtype``, counted by the
    port's one funnel (``ml/base.h2d_bytes``)."""
    from learningorchestra_tpu_torch.ml.base import _account_h2d

    tensor = torch.from_numpy(np.ascontiguousarray(host))
    if dtype is not None and dtype != tensor.dtype:
        # through float32 first, as the reference's astype of float64 rows
        if dtype == torch.bfloat16 and tensor.dtype == torch.float64:
            tensor = tensor.to(torch.float32)
        tensor = tensor.to(dtype)
    return _account_h2d(tensor.to(device))


def shard_rows(array: np.ndarray, mesh: Mesh, dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad ``array`` over the mesh's data axis and copy this rank's data
    index's block to its device (the same block on every rank of its model
    group). Returns ``(block, mask)``: the block's rows and a boolean
    tensor marking its real (non-padding) rows. Float ``dtype`` requests go
    through :func:`policy_dtype`."""
    data = mesh.shape[DATA_AXIS]
    padded, mask = pad_rows(np.asarray(array), data)
    block = padded.shape[0] // data
    rows = slice(mesh.data_index * block, (mesh.data_index + 1) * block)
    return (
        to_device(padded[rows], mesh.device, policy_dtype(dtype)),
        to_device(mask[rows], mesh.device),
    )


def put_replicated(value, mesh: Mesh) -> torch.Tensor:
    """``value`` as a tensor on this rank's device (every rank holds it)."""
    return torch.as_tensor(value, device=mesh.device)
