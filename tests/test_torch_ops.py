"""The JAX package's ops tests (``tests/test_ops.py``), run on the port's
``ops/projection.py``, ``ops/dtype.py`` and ``ops/histogram.py``.

Their source is read and run here with every module path pointed at the
port's (``learningorchestra_tpu.`` becomes ``learningorchestra_tpu_torch.``),
with one other edit: the reference imports ``project``,
``convert_field_types``, ``create_histogram`` and ``value_counts`` from its
``ops`` package, whose ``__init__`` re-exports them; the port's ``ops``
package does not, so that import names the port's modules
(``ops.projection``, ``ops.dtype``, ``ops.histogram``) instead. The
``store`` fixture of tests/conftest.py gives the JAX package's
``InMemoryStore``: this file overrides it with the port's (``titanic_csv``
is a path to a CSV file and is used as it is).
"""

import pathlib
import re

import pytest

from learningorchestra_tpu_torch.core.store import InMemoryStore
from learningorchestra_tpu_torch.ops import dtype as port_dtype
from learningorchestra_tpu_torch.ops import histogram as port_histogram
from learningorchestra_tpu_torch.ops import projection as port_projection

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_ops.py")

_PACKAGE_IMPORT = """from learningorchestra_tpu.ops import (
    convert_field_types,
    create_histogram,
    project,
    value_counts,
)"""
_MODULE_IMPORTS = """from learningorchestra_tpu_torch.ops.projection import project
from learningorchestra_tpu_torch.ops.dtype import convert_field_types
from learningorchestra_tpu_torch.ops.histogram import create_histogram, value_counts"""

_text = REFERENCE_TESTS.read_text()
assert _text.count(_PACKAGE_IMPORT) == 1
_source = _text.replace(_PACKAGE_IMPORT, _MODULE_IMPORTS).replace(
    "learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture()
def store():
    """The port's in-memory store, where conftest.py gives the JAX package's."""
    return InMemoryStore()


def test_the_reference_tests_run_on_the_port(store):
    """The tests above use the port's ops and store."""
    assert project is port_projection.project  # noqa: F821
    assert convert_field_types is port_dtype.convert_field_types  # noqa: F821
    assert create_histogram is port_histogram.create_histogram  # noqa: F821
    assert value_counts is port_histogram.value_counts  # noqa: F821
    assert type(store).__module__ == "learningorchestra_tpu_torch.core.store"
    assert re.findall(r"learningorchestra_tpu\.\w+", _source) == []
    classes = [name for name in list(globals()) if name.startswith("Test")]
    assert classes == ["TestProjection", "TestDtype", "TestValueCounts", "TestHistogram",
                       "TestReviewRegressions", "TestDtypeVectorizedParity"]
