"""The JAX package's observability-plane tests
(``tests/test_observability.py``), run on the port on the CPU.

The reference's source is read and run here with every module path
pointed at the port: the exposition parser (label sets summed, the
derived 5xx family, histogram buckets merged, malformed bodies refused),
the store's trim primitive under the ``__lo_metrics__`` ring, the TSDB
(the ring cap, delta compression and fold-forward, counter rates and
resets, histogram p99, the reseed after a restart, the collector), the
SLO rules (a scripted burn and clear, a ``serve.forward`` latency fault
that flips exactly one rule, the per-rev cache, ``/debug/slo`` and
``/health``'s ``degraded``, the burning gauge), the stitcher (the golden
fields, the fan-out, the dedupe of the own group, a down member, the
trace ring), and the ``/debug/spans``, ``/traces/<cid>``,
``/metrics/history`` and ``/metrics/ingest`` routes. Its ``store``
fixture is the port's ``InMemoryStore``.

Left out (``NOT_PORTED``): ``TestClientCorrelation``: it tests the
client SDK (``learningorchestra_tpu/client.py``), which is the JAX
package's own; the port serves the routes that client calls, and
``tests/test_torch_titanic.py`` drives the port with it.
"""

import pathlib

import pytest

from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore
from learningorchestra_tpu_torch.telemetry import slo as port_slo
from learningorchestra_tpu_torch.telemetry import stitch as port_stitch
from learningorchestra_tpu_torch.telemetry import tsdb as port_tsdb

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_observability.py")
NOT_PORTED = {"TestClientCorrelation": "the JAX package's client SDK"}

_source = REFERENCE_TESTS.read_text().replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102
for _name in NOT_PORTED:
    del globals()[_name]


@pytest.fixture()
def store():
    return PortStore()


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's telemetry modules, web layer and
    store."""
    assert (tsdb, slo, stitch) == (port_tsdb, port_slo, port_stitch)  # noqa: F821
    assert WebApp.__module__ == "learningorchestra_tpu_torch.utils.web"  # noqa: F821
    assert InMemoryStore is PortStore  # noqa: F821
    assert "learningorchestra_tpu." not in _source
