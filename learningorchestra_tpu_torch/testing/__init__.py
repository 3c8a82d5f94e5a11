"""Test-and-chaos machinery that ships WITH the framework.

The reference proves nothing about its failover story — the Mongo
replica set is assumed to work (docker-compose.yml:27-91). This package
is the machinery that lets US prove ours: named fault points threaded
through the store wire, WAL feed, and promotion path
(:mod:`learningorchestra_tpu_torch.testing.faults`), driven either by
``LO_FAULT_*`` environment knobs (subprocess chaos — kill a primary mid
write burst) or programmatic installs (in-process partition tests).
Production code imports :mod:`faults` unconditionally; with nothing
installed every fault point is a dict lookup that misses — no
measurable cost on the data plane.

The port's copy of ``learningorchestra_tpu/testing/__init__.py``.
"""

from learningorchestra_tpu_torch.testing.faults import (  # noqa: F401
    FAULT_POINTS,
    FaultInjected,
    fire,
    install,
    reset,
    torn,
    validate_env,
)
