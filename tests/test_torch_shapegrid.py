"""The JAX package's shape-grid tests (``tests/test_shapegrid.py``), run on
the port's ``utils/shapegrid.py`` and ``parallel/sharding.py``.

Their source is read and run here with every module path pointed at the
port's, with no other edit: the quarter-octave buckets, the floor of
``grid_size``, the ``LO_SHAPE_BUCKETS`` flag (patched on the port's
module) and the pad helpers, and ``sharding.bucket_rows`` delegating to
the grid.

Below them, the port against the JAX package on the same counts: every
function of the grid gives the same value, and pads the same arrays.
"""

import pathlib
import re

import numpy as np
import pytest

from learningorchestra_tpu.utils import shapegrid as jax_shapegrid
from learningorchestra_tpu_torch.parallel import sharding as port_sharding
from learningorchestra_tpu_torch.utils import shapegrid as port_shapegrid

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_shapegrid.py")

_source = REFERENCE_TESTS.read_text().replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's grid and its sharding."""
    assert bucket_count is port_shapegrid.bucket_count  # noqa: F821
    assert grid_size is port_shapegrid.grid_size  # noqa: F821
    assert pad_axis0 is port_shapegrid.pad_axis0  # noqa: F821
    assert padded_indices is port_shapegrid.padded_indices  # noqa: F821
    assert re.findall(r"learningorchestra_tpu\.\w+", _source) == []
    classes = [name for name in list(globals()) if name.startswith("Test")]
    assert classes == ["TestBucketCount", "TestGridSize", "TestPadHelpers"]


@pytest.mark.parametrize("floor", [0, 1, 64, 1000])
def test_grid_is_the_references(floor):
    counts = list(range(1, 5000)) + [10**6, 10**6 + 1, (1 << 20) + 1, 10**7 + 3]
    assert [port_shapegrid.bucket_count(n) for n in counts] == [
        jax_shapegrid.bucket_count(n) for n in counts]
    assert [port_shapegrid.grid_size(n, floor=floor) for n in counts] == [
        jax_shapegrid.grid_size(n, floor=floor) for n in counts]
    assert [port_sharding.bucket_rows(n) for n in counts[:500]] == [
        jax_shapegrid.bucket_count(n) for n in counts[:500]]


@pytest.mark.parametrize("n, target", [(3, 5), (4, 4), (1, 8), (7, 9)])
def test_pad_helpers_are_the_references(n, target):
    array = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    np.testing.assert_array_equal(port_shapegrid.pad_axis0(array, target),
                                  jax_shapegrid.pad_axis0(array, target))
    assert port_shapegrid.padded_indices(n, target) == jax_shapegrid.padded_indices(n, target)
