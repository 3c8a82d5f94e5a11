"""The JAX package's table tests (``tests/test_core_table.py``), run on the
port's ``core/table.py``, ``core/ingest.py`` and ``core/store.py``.

Their source is read and run here with every module path pointed at the
port's (``learningorchestra_tpu.`` becomes ``learningorchestra_tpu_torch.``),
with no other edit. The ``store`` fixture of tests/conftest.py gives the JAX
package's ``InMemoryStore``: this file overrides it with the port's
(``titanic_csv`` is a path to a CSV file and is used as it is).
"""

import pathlib
import re

import pytest

from learningorchestra_tpu_torch.core import ingest as port_ingest
from learningorchestra_tpu_torch.core import table as port_table
from learningorchestra_tpu_torch.core.store import InMemoryStore

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_core_table.py")

_source = REFERENCE_TESTS.read_text().replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture()
def store():
    """The port's in-memory store, where conftest.py gives the JAX package's."""
    return InMemoryStore()


def test_the_reference_tests_run_on_the_port(store):
    """The tests above use the port's table, ingest and store."""
    assert ColumnTable is port_table.ColumnTable  # noqa: F821
    assert write_table is port_table.write_table  # noqa: F821
    assert ingest_csv is port_ingest.ingest_csv  # noqa: F821
    assert type(store).__module__ == "learningorchestra_tpu_torch.core.store"
    assert re.findall(r"learningorchestra_tpu\.\w+", _source) == []
    tests = sorted(name for name in list(globals()) if name.startswith("test_") and name != (
        "test_the_reference_tests_run_on_the_port"))
    assert tests == ["test_column_typing_and_nan", "test_dropna_both_kinds",
                     "test_encoded_matches_label_encoder_order", "test_ingest_csv_contract",
                     "test_ingest_preserves_embedded_newlines", "test_ingest_rejects_html",
                     "test_matrix_shape_and_order", "test_store_roundtrip"]
