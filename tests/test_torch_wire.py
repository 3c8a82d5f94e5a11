"""The JAX package's zero-copy wire tests (``tests/test_wire_v2.py``), run
on the port's ``core/wire.py``, ``core/shmring.py`` and
``core/store_service.py`` on the CPU.

Their source is read and run here with every module path pointed at the
port: the v1 and v2 frames' golden round trips, v2's aligned read-only
views on one owner and their copy on write, the version negotiation
against a live server (old clients, old servers, the re-probe after a
failover), the shared-memory ring (a ring read equal to a body read,
the fall back to the body when the server cannot attach the segment,
when it has the ring off or when a frame is too large, the torn slot,
the refused segment names, the attach cache's order, ``LO_SHM_BYTES``'
validation) and a build and its predictions over every transport. The
port's entry points default to the card, so the build is given
``device="cpu"``.
"""

import pathlib

from learningorchestra_tpu_torch.core import shmring as port_shmring
from learningorchestra_tpu_torch.core import wire as port_wire

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_wire_v2.py")
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ('client, "wtrain", "wtest", PREPROCESSOR, ["lr", "nb"]\n', 1,
     'client, "wtrain", "wtest", PREPROCESSOR, ["lr", "nb"], device="cpu"\n'),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's frames and ring."""
    assert wire is port_wire and shmring is port_shmring  # noqa: F821
    assert "learningorchestra_tpu." not in _source
