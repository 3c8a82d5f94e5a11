"""The compile plane's deployment knobs.

Counterpart of ``learningorchestra_tpu/compile/config.py:35-84``: the
same knobs, defaults and strict parsing. In the port a "program" is one
of the five CUDA kernel libraries (``kernels.KERNEL_LIBRARIES``).

=========================  =======  =====================================
knob                       default  meaning
=========================  =======  =====================================
``LO_AOT``                 0        run the boot-time pass over the
                                    library manifest (compile/aot.py):
                                    build every library with nvcc, or
                                    find it built, before a request
                                    needs it. Off by default: the pass
                                    spends nvcc's seconds at boot, which
                                    a short-lived test or script process
                                    never amortizes.
``LO_AOT_MAX_PROGRAMS``    64       cap on manifest entries the pass
                                    builds; everything past the cap
                                    lands on a LOGGED drop list (no
                                    silent caps). 0 = enumerate only,
                                    build nothing.
``LO_AOT_PUBLISH``         1        publish the built libraries into the
                                    ``__lo_executables__`` store
                                    collection so the rest of the fleet
                                    skips nvcc (compile/fleetcache.py).
                                    Only matters when a store is
                                    attached.
=========================  =======  =====================================

A malformed value raises at read time, so the preflight
(``deploy/preflight.py``) and the runner's boot line refuse bring-up
instead of silently picking a side.
"""

from __future__ import annotations

import os


def _flag_env(name: str, default: bool) -> bool:
    """Strict 0/1: ``LO_AOT=yes`` silently meaning "off" (or "on") is the
    ambiguity the preflight exists to refuse."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    if raw not in ("0", "1"):
        raise ValueError(f"{name} must be 0 or 1, got {raw!r}")
    return raw == "1"


def aot_enabled() -> bool:
    """Whether the boot-time pass runs (``LO_AOT``)."""
    return _flag_env("LO_AOT", False)


def publish_enabled() -> bool:
    """Whether the libraries built here are published to the fleet cache
    (``LO_AOT_PUBLISH``)."""
    return _flag_env("LO_AOT_PUBLISH", True)


def max_programs() -> int:
    """Manifest-entry cap of the pass (``LO_AOT_MAX_PROGRAMS``). Strictly
    integral >= 0: ``6.5`` silently truncating would cut the built set
    without a trace."""
    raw = os.environ.get("LO_AOT_MAX_PROGRAMS", "").strip()
    if not raw:
        return 64
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"LO_AOT_MAX_PROGRAMS must be an integer, got {raw!r}") from None
    if value < 0:
        raise ValueError(f"LO_AOT_MAX_PROGRAMS must be >= 0, got {value}")
    return value


def validate_env() -> dict:
    """Read every compile knob (raising on malformed values) and return
    the resolved configuration: the preflight and the runner's boot."""
    return {
        "LO_AOT": 1 if aot_enabled() else 0,
        "LO_AOT_MAX_PROGRAMS": max_programs(),
        "LO_AOT_PUBLISH": 1 if publish_enabled() else 0,
    }
