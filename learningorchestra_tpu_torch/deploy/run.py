"""Single-host bring-up: the preflight, then the all-in-one runner.

Counterpart of ``deploy/run.sh:165-357``:

    python -m learningorchestra_tpu_torch.deploy.run [data_dir]

sets ``LO_DATA_DIR`` (``data_dir``, else ``LO_DATA_DIR``, else
``./lo_data``, made absolute), runs :mod:`.preflight` (every knob
validated; a malformed one refuses bring-up with a non-zero exit) and
replaces this process with ``python -m
learningorchestra_tpu_torch.services.runner``, which serves the seven
services on the card (``LO_DEVICE=cpu`` asks for the CPU). Every knob of
``deploy/run.sh``'s table applies, with ``LO_DEVICE`` and
``LO_DIST_BACKEND`` in place of ``JAX_PLATFORMS``.

The reference's ``analysis`` step (``run.sh:330-355``: the SPMD-safety,
lock-discipline and deployment-contract rules) has no counterpart: its
analyzer scans the JAX package's tree (``analysis/registry.py:45``) and
knows none of the port's modules.
"""

from __future__ import annotations

import os
import sys

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list) -> int:
    data_dir = argv[0] if argv else os.environ.get("LO_DATA_DIR", os.path.join(os.getcwd(), "lo_data"))
    os.environ["LO_DATA_DIR"] = os.path.abspath(data_dir)
    path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = _PACKAGE_PARENT + (os.pathsep + path if path else "")
    from learningorchestra_tpu_torch.deploy import preflight

    preflight.main()
    sys.stdout.flush()
    os.execv(sys.executable, [sys.executable, "-m", "learningorchestra_tpu_torch.services.runner"])
    return 0   # not reached: execv replaces the process


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
