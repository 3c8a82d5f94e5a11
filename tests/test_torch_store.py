"""The JAX package's store tests (``tests/test_core_store.py``), run on the
port's copy of the store (``learningorchestra_tpu_torch/core/store.py``).

The copy differs from ``learningorchestra_tpu/core/store.py`` only in its
imports, so the reference's own tests hold it: the Mongo-contract
queries, the columnar blocks, the WAL and its replay, compaction,
replication (``wal_feed``, resync) and spill to disk. Their source is
read and run here with the store's module path pointed at the port's,
and so are the job manager's and the ingest's (``core/jobs.py``,
``core/ingest.py``), which three of the tests go through.
"""

import pathlib

import pytest

from learningorchestra_tpu_torch.core import store as port_store

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_core_store.py")
_source = REFERENCE_TESTS.read_text()
for _module in ("store", "jobs", "ingest"):
    _source = _source.replace(
        f"learningorchestra_tpu.core.{_module}", f"learningorchestra_tpu_torch.core.{_module}"
    )
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture()
def store():
    return port_store.InMemoryStore()


def _module_names(code):
    """The dotted names a code object (and the code nested in it) uses:
    its imports among them."""
    yield from code.co_names
    for const in code.co_consts:
        if hasattr(const, "co_names"):
            yield from _module_names(const)


def test_the_reference_tests_run_on_the_port():
    """Every store the tests above build is the port's, and none of them
    imports the JAX package."""
    assert InMemoryStore is port_store.InMemoryStore  # noqa: F821
    tests = [
        member
        for name, value in list(globals().items()) if name.startswith(("test_", "Test"))
        for member in ([value] if callable(value) and not isinstance(value, type) else vars(value).values())
        if getattr(member, "__code__", None) is not None
    ]
    assert len(tests) > 40
    for test in tests:
        assert not any(
            name.startswith("learningorchestra_tpu.") for name in _module_names(test.__code__)
        ), test.__name__
