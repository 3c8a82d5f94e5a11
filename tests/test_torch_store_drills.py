"""The JAX package's store drills (``tests/test_faults.py``), run on the
port's store server, client and arbiter on the CPU.

Their source is read and run here with every module path pointed at the
port, and the classes that drill the networked store are kept: the
arbiter's idempotent vote, a torn wire frame retried in place (and
surfaced past its budget), ``/wal``'s long-poll woken by a write, the
store voters' ``voted_term``, a 500 after the write applied replayed as
landed, the quorum partition drills (the minority primary suspends, the
majority follower wins the election, an asymmetric partition keeps no
second writer, a campaign without quorum fails), the measured loss
window, sync replication's acks and the device cache across a failover.
The kill-primary drill in real processes stays marked ``slow``, as it is
in the reference. Where the reference's tests expect the client to raise
``requests``' HTTP error, the port's client raises its transport's
(``utils/httpclient.py``).

The fault specs' own tests (``TestFaultSpecs``) are not the store's and
are not run here.
"""

import pathlib

from learningorchestra_tpu_torch.core import store_service as port_store_service
from learningorchestra_tpu_torch.utils import httpclient  # noqa: F401 (the edits name it)

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_faults.py")
DRILLS = (
    "TestArbiterVotes", "TestTornChunk", "TestWalLongPoll", "TestLandedOkAfterServerError",
    "TestQuorumPartition", "TestLossWindow", "TestSyncReplication", "TestDevcacheAcrossFailover",
    "test_kill_primary_mid_ingest_zero_lost_acked_writes",
)
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ("with pytest.raises(requests.HTTPError):", 1, "with pytest.raises(httpclient.HTTPError):"),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102
del TestFaultSpecs  # noqa: F821


def test_the_reference_drills_run_on_the_port():
    """The drills above use the port's store service, and every one of
    them is here."""
    assert RemoteStore is port_store_service.RemoteStore  # noqa: F821
    assert serve is port_store_service.serve  # noqa: F821
    assert all(name in globals() for name in DRILLS)
    assert "learningorchestra_tpu." not in _source
