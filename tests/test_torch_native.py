"""The JAX package's native-loader tests (``tests/test_native.py``), run
on the port's ``native/loader.py``, ``core/table.py`` and
``core/ingest.py``.

Their source is read and run here with every module path pointed at the
port's (``TestSlabbedIngest`` patches the port's ``ingest._SLAB_BYTES``),
and the ``store`` fixture gives the port's ``InMemoryStore``.

Below them, the port against the JAX package and against its own Python
path, on CSVs made from a numpy seed (quoted fields with commas, quotes
and newlines, CRLF line ends, empty cells, hex-like and underscore
cells, short and long rows): the typed columns and the raw string
columns of each parse are equal; a slabbed ingest of a file whose slabs
end inside quoted fields gives the collection of a whole ingest; the
library is built under ``native/_build/``; and ``native_stats`` counts
each native parse and each fallback.
"""

import os
import pathlib

import numpy as np
import pytest

from learningorchestra_tpu.native import loader as jax_loader
from learningorchestra_tpu_torch.core import ingest as port_ingest
from learningorchestra_tpu_torch.core import store as port_store
from learningorchestra_tpu_torch.native import loader as port_loader

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_native.py")
_source = REFERENCE_TESTS.read_text().replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture()
def store():
    return port_store.InMemoryStore()


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's loader and table, on a library the
    port built, and none of them names the JAX package."""
    assert NativeCsv is port_loader.NativeCsv  # noqa: F821
    assert read_csv_columns is port_loader.read_csv_columns  # noqa: F821
    assert ColumnTable.__module__ == "learningorchestra_tpu_torch.core.table"  # noqa: F821
    assert "learningorchestra_tpu." not in _source
    assert "import learningorchestra_tpu_torch.core.ingest as ingest" in _source
    assert 'monkeypatch.setattr(ingest, "_SLAB_BYTES"' in _source
    assert port_loader.native_available()


# --- the port against the JAX package and its own Python path ---------------


def seeded_csv(path, seed: int, rows: int = 400, crlf: bool = False, ragged: bool = False) -> str:
    """A CSV of six columns from ``seed``: numbers with empty cells,
    quoted names (commas, doubled quotes, embedded newlines), hex-like
    cells, underscore cells, plain tags and integers; ``ragged`` drops
    the last cell of some rows."""
    rng = np.random.default_rng(seed)
    end = "\r\n" if crlf else "\n"
    lines = ["value,name,hexish,underscored,tag,count"]
    for i in range(rows):
        value = "" if rng.random() < 0.1 else f"{rng.normal() * 100:.6g}"
        kind = int(rng.integers(4))
        name = ['"Brown, Mr. A"', '"Say ""hi"""', f'"two{end}lines {i}"', f"plain{i}"][kind]
        hexish = f"0x{int(rng.integers(4096)):x}" if rng.random() < 0.5 else str(int(rng.integers(100)))
        underscored = f"{int(rng.integers(1, 9))}_{int(rng.integers(100, 999))}"
        tag = "" if rng.random() < 0.2 else f"t{int(rng.integers(7))}"
        count = str(int(rng.integers(-50, 50)))
        cells = [value, name, hexish, underscored, tag, count]
        if ragged and rng.random() < 0.1:
            cells = cells[:-1]
        lines.append(",".join(cells))
    path.write_bytes((end.join(lines) + end).encode())
    return str(path)


def _same_columns(ours: dict, theirs: dict) -> None:
    assert list(ours) == list(theirs)
    for name in ours:
        assert ours[name].dtype == theirs[name].dtype, name
        if ours[name].dtype == object:
            assert list(ours[name]) == list(theirs[name]), name
        else:
            np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)


CASES = {"plain": {}, "crlf": dict(crlf=True), "ragged": dict(ragged=True)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_native_parse_is_the_references_and_the_python_parse(tmp_path, seed, case):
    path = seeded_csv(tmp_path / "seeded.csv", seed, **CASES[case])
    before = port_loader.native_stats()
    ours = port_loader.read_csv_columns(path)
    assert port_loader.native_stats()["native_parses"] == before["native_parses"] + 1
    _same_columns(ours, jax_loader.read_csv_columns(path))
    _same_columns(ours, port_loader._python_read(path))
    assert ours["value"].dtype == np.float64 and ours["count"].dtype == np.float64
    assert ours["hexish"].dtype == object and ours["underscored"].dtype == object

    header, columns = port_loader.read_csv_string_columns(path)
    their_header, their_columns = jax_loader.read_csv_string_columns(path)
    python_header, python_columns = port_ingest._python_raw_columns(path)
    assert header == their_header == python_header
    for ours_column, theirs_column, python_column in zip(columns, their_columns, python_columns):
        assert ours_column.tolist() == theirs_column.tolist() == python_column
    assert port_loader.read_csv_raw_columns(path) == (python_header, python_columns)


def test_ragged_wide_rows_fall_back_and_say_so(tmp_path):
    path = tmp_path / "wide.csv"
    path.write_text("a,b\n1,2,3\n4,5\n")
    before = port_loader.native_stats()
    columns = port_loader.read_csv_columns(str(path))
    _same_columns(columns, jax_loader.read_csv_columns(str(path)))
    stats = port_loader.native_stats()
    assert stats["fallbacks"] == before["fallbacks"] + 1
    assert stats["native_parses"] == before["native_parses"]
    assert "cannot parse CSV" in stats["error"]


def _ingested(store, name, path, monkeypatch):
    monkeypatch.setattr(port_ingest, "timestamp", lambda: "2026-01-01T00:00:00-00:00")
    port_ingest.write_ingest_metadata(store, name, path)
    return port_ingest.ingest_csv(store, name, path)


@pytest.mark.parametrize("slab", [97, 300, 4_000])
def test_a_slabbed_ingest_is_a_whole_ingest(tmp_path, monkeypatch, slab):
    """Slabs of ``slab`` bytes end inside quoted fields (embedded
    newlines) and run on to the record's end; the collection equals a
    whole ingest's: columns, ids, metadata and ``finished``."""
    path = seeded_csv(tmp_path / "seeded.csv", 5, rows=600)
    whole, slabbed = port_store.InMemoryStore(), port_store.InMemoryStore()
    monkeypatch.setattr(port_ingest, "_SLAB_BYTES", 0)
    assert _ingested(whole, "ds", path, monkeypatch) == 600
    monkeypatch.setattr(port_ingest, "_SLAB_BYTES", slab)
    before = port_loader.native_stats()
    assert _ingested(slabbed, "ds", path, monkeypatch) == 600
    parses = port_loader.native_stats()["native_parses"] - before["native_parses"]
    assert parses >= os.path.getsize(path) // (4 * slab)
    assert port_loader.native_stats()["fallbacks"] == before["fallbacks"]
    assert list(slabbed.find("ds")) == list(whole.find("ds"))
    assert slabbed.metadata("ds")["finished"] is True
    got, want = slabbed.read_column_arrays("ds"), whole.read_column_arrays("ds")
    assert {name: column.tolist() for name, column in got.items()} == {
        name: column.tolist() for name, column in want.items()
    }
    assert not [name for name in os.listdir(tmp_path) if name != "seeded.csv"]  # no slab left behind


def test_the_library_is_built_under_native_build():
    assert port_loader.native_available()
    library = port_loader.native_stats()["library"]
    build_dir = os.path.join(os.path.dirname(port_loader.__file__), "_build")
    assert os.path.dirname(library) == build_dir == port_loader.BUILD_DIR
    assert library == port_loader.library_path()
    assert os.path.isfile(library)
    assert not [name for name in os.listdir(os.path.dirname(port_loader.__file__)) if name.endswith(".so")]
