"""The padded-shape grid: quarter-octave size bucketing.

A copy of ``learningorchestra_tpu/utils/shapegrid.py:43-90``. The serve
batcher pads a dispatch to ``grid_size(total, max_batch)`` rows, so the
port's dispatch shapes are the reference's. On the card this bounds the
number of distinct shapes the forward sees; the kernels take any row
count.
"""

from __future__ import annotations

import os

import numpy as np

# LO_SHAPE_BUCKETS=0 restores minimal padding above the floor. Read once,
# as in the reference.
_BUCKETS_ENABLED = os.environ.get("LO_SHAPE_BUCKETS", "1") != "0"


def bucket_count(n: int) -> int:
    """Smallest quarter-octave grid value >= n: {4,5,6,7} x 2^k.
    Values <= 8 pass through."""
    if n <= 8:
        return n
    power = 1 << (n.bit_length() - 1)  # largest power of two <= n
    if n == power:
        return n
    for quarters in (5, 6, 7, 8):
        candidate = power * quarters // 4
        if candidate >= n:
            return candidate
    raise AssertionError("unreachable: 2*power >= n by construction")


def grid_size(n: int, floor: int = 0) -> int:
    """``n`` rounded up to the grid; counts at or under ``floor`` pad to
    exactly ``floor``."""
    if n <= floor:
        return floor
    return bucket_count(n) if _BUCKETS_ENABLED else n


def pad_axis0(array: np.ndarray, target: int) -> np.ndarray:
    """Zero-pad ``array`` along axis 0 up to ``target`` rows (no copy
    when already there)."""
    n = array.shape[0]
    if n >= target:
        return array
    pad_width = [(0, target - n)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_width)
