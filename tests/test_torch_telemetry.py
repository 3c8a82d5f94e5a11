"""The JAX package's telemetry tests (``tests/test_telemetry.py``), run on
the port on the CPU.

The reference's source is read and run here with every module path
pointed at the port: the metrics registry (concurrency, get-or-create,
the Prometheus rendering golden, label escaping, a failing collector),
spans (no-ops without a trace, nesting and thread attach, the
PhaseTimer's bridge), the REST surface (``/metrics`` on all seven
services, the request counters and the correlation header, an ingest
job's trace under the request's correlation ID, the 404), the build's
trace (stage spans covering the wall clock, a failing sync build run
once, the async build's trace) and the store's telemetry stats.

The apps run on the CPU (``device="cpu"``), and the ``store`` fixture is
the port's ``InMemoryStore``. ``/metrics`` on the seven services is held
to show ``lo_compile_events_total`` where the reference's shows
``lo_jitcache_persistent_hits``: the reference's family is its XLA
compile cache's, which the port does not have; the port's kernel
libraries' loads count into the flight recorder's compile family.

Left out (``NOT_PORTED``): ``TestSpmdTelemetry``: the multi-host SPMD
dispatcher (``parallel/spmd.py``) is not ported (ROADMAP Queue 1 item
6d).
"""

import pathlib

import pytest

from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore
from learningorchestra_tpu_torch.services import runner as port_runner
from learningorchestra_tpu_torch.telemetry import tracing as port_tracing

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_telemetry.py")
NOT_PORTED = {"TestSpmdTelemetry": "the SPMD dispatcher, ROADMAP Queue 1 item 6d"}
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ('build_apps(store, str(tmp_path / "images"))', 1, 'build_apps(store, str(tmp_path / "images"), device="cpu")'),
    ('"lo_jitcache_persistent_hits",', 1, '"lo_compile_events_total",'),
    ('titanic_store, models_dir="", jobs=jobs', 2, 'titanic_store, models_dir="", jobs=jobs, device="cpu"'),
    ('titanic_store, build=exploding_build, models_dir=""', 1,
     'titanic_store, build=exploding_build, models_dir="", device="cpu"'),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102
for _name in NOT_PORTED:
    del globals()[_name]


@pytest.fixture()
def store():
    return PortStore()


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's telemetry, runner and store."""
    assert tracing is port_tracing  # noqa: F821
    assert build_apps is port_runner.build_apps  # noqa: F821
    assert "learningorchestra_tpu." not in _source
