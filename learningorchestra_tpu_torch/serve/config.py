"""Serving knobs, env-configurable with validation.

The same ``LO_SERVE_*`` names, defaults and validation as
``learningorchestra_tpu/serve/config.py:50-98``; ``_int_env`` and
``_float_env`` are copied from ``learningorchestra_tpu/sched/config.py``.
Every knob is read when a plane or app is built, not at import, and a
malformed value raises with the offending text.

==============================  =======  ==================================
env var                         default  meaning
==============================  =======  ==================================
``LO_SERVE_BYTES``              1e9      registry device-byte budget; past
                                         it LRU eviction; ``0`` = load per
                                         request, no pinning
``LO_SERVE_BATCH_WINDOW_MS``    1.0      micro-batch collection window (ms)
``LO_SERVE_MAX_BATCH``          64       max requests per forward dispatch,
                                         and the row count small batches
                                         pad to
``LO_SERVE_MAX_ROWS``           4096     max rows in one predict request
                                         (413 past it)
``LO_SERVE_QUEUE_CAP``          256      bounded batcher inbox (429 past it)
``LO_SERVE_TIMEOUT_S``          30       per-request wait bound (503 past it)
==============================  =======  ==================================
"""

from __future__ import annotations

import os

DEFAULT_SERVE_BYTES = 1_000_000_000


def _int_env(name: str, default: int, minimum: int = 1) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer, got {raw!r}"
        ) from None
    if value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return value


def _float_env(name: str, default: float, minimum: float = 0.0) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None
    if value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return value


def serve_bytes() -> int:
    """Registry capacity in bytes of pinned model parameters; ``0``
    disables pinning (every predict loads the checkpoint fresh)."""
    return int(_float_env("LO_SERVE_BYTES", DEFAULT_SERVE_BYTES, 0))


def batch_window_s() -> float:
    """The micro-batch collection window, converted to seconds."""
    return _float_env("LO_SERVE_BATCH_WINDOW_MS", 1.0, 0.0) / 1000.0


def max_batch() -> int:
    return _int_env("LO_SERVE_MAX_BATCH", 64, 1)


def max_rows() -> int:
    """Row cap per predict request; bulk scoring belongs on the batch lane."""
    return _int_env("LO_SERVE_MAX_ROWS", 4096, 1)


def queue_cap() -> int:
    return _int_env("LO_SERVE_QUEUE_CAP", 256, 1)


def request_timeout_s() -> float:
    value = _float_env("LO_SERVE_TIMEOUT_S", 30.0, 0.0)
    if value <= 0:
        raise ValueError(f"LO_SERVE_TIMEOUT_S must be > 0, got {value}")
    return value


def validate_all() -> dict:
    """Read every serving knob once; returns the resolved values."""
    return {
        "serve_bytes": serve_bytes(),
        "batch_window_s": batch_window_s(),
        "max_batch": max_batch(),
        "max_rows": max_rows(),
        "queue_cap": queue_cap(),
        "request_timeout_s": request_timeout_s(),
    }
