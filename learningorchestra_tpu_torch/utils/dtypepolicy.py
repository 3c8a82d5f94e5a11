"""End-to-end feature dtype policy (``LO_DTYPE_POLICY``).

The port's copy of ``learningorchestra_tpu/utils/dtypepolicy.py``: the
same values, validation and read-once cache. ``f32`` (the default) ships
feature matrices to the card and keeps them there as float32. ``bf16``
halves both: every feature matrix is cast to bfloat16 where its rows go
to the device (``ml/base.shard_matrix``), so the host-to-device copy and
the matrix kept on the card are half the bytes. Parameters, reductions
and metrics stay float32: the kernels that read X (K1, K6, K7) widen each
bfloat16 value exactly to float32 and compute as before, and the torch
ops widen X where the reference's jnp promotes ``bf16`` with ``f32`` to
``f32``.

The policy is part of every device-cache key (core/devcache.py): an
entry made under one policy never serves another.

Read once per process: the policy names the dtype every cached device
matrix was made in, and the resume artifacts' key, so it must not
change under a running service. ``device.policy_dtype`` is a view of
this one reader. Stdlib only.
"""

from __future__ import annotations

import os

POLICIES = ("f32", "bf16")

_POLICY: list = []  # one-element cache: read once per process (tests empty it)


def validate_policy(raw: str) -> str:
    value = raw.strip() or "f32"
    if value not in POLICIES:
        raise ValueError(
            f"LO_DTYPE_POLICY must be one of {'|'.join(POLICIES)}, "
            f"got {raw!r}"
        )
    return value


def dtype_policy() -> str:
    """The process's feature dtype policy string, also the token that
    rides device-cache keys."""
    if not _POLICY:
        _POLICY.append(validate_policy(os.environ.get("LO_DTYPE_POLICY", "f32")))
    return _POLICY[0]


def validate_env() -> None:
    """Fail fast on a malformed ``LO_DTYPE_POLICY``: the preflight
    (``deploy/preflight.py``) calls this, uncached, so it always reads
    the environment again."""
    validate_policy(os.environ.get("LO_DTYPE_POLICY", "f32"))
