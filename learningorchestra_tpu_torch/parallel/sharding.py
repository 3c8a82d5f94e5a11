"""Row padding to the quarter-octave grid, with a validity mask.

A copy of ``padded_row_count`` and ``pad_rows`` from
``learningorchestra_tpu/parallel/sharding.py:44-63``. Padded row counts
are bucketed to the shared grid (utils/shapegrid.py), so nearby dataset
sizes share one padded shape: the job coalescer keys on it, and members
of nearby sizes fuse. The mask keeps the padded rows out of every sum.
One card has no data axis to align to, so the port's callers pass
``multiple=1``; the multi-GPU slice passes its world size.
"""

from __future__ import annotations

import numpy as np

from learningorchestra_tpu_torch.utils.shapegrid import grid_size


def padded_row_count(n: int, multiple: int) -> int:
    """Rows after bucket-then-align padding — THE padded-shape rule."""
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
