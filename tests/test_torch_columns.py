"""The JAX package's column tests (``tests/test_columns.py``), run on the
port's ``core/columns.py``.

Their source is read and run here with every module path pointed at the
port's (``learningorchestra_tpu.`` becomes ``learningorchestra_tpu_torch.``),
with no other edit: the typed columns' kinds and their merge lattice,
appends, sets, snapshots, slices, unique counts, serialization, the numpy
hand-off, the vector kind and the spill to disk.
"""

import pathlib
import re

from learningorchestra_tpu_torch.core import columns as port_columns

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_columns.py")

_source = REFERENCE_TESTS.read_text().replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's columns."""
    assert Column is port_columns.Column  # noqa: F821
    assert merge_kind is port_columns.merge_kind  # noqa: F821
    assert MISSING is port_columns.MISSING  # noqa: F821
    assert re.findall(r"learningorchestra_tpu\.\w+", _source) == []
    classes = [name for name in list(globals()) if name.startswith("Test")]
    assert classes == ["TestKinds", "TestAppend", "TestSet", "TestSnapshot", "TestSlice",
                       "TestUniqueCounts", "TestSerialization", "TestNumpyHandoff",
                       "TestReviewRegressions", "TestVecKind", "TestSpill"]
