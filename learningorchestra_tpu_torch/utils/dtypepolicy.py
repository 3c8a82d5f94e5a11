"""End-to-end feature dtype policy (``LO_DTYPE_POLICY``).

The port's copy of ``learningorchestra_tpu/utils/dtypepolicy.py``: the
same values, validation and read-once cache. ``f32`` (the default) ships
feature matrices to the card and keeps them there as float32. ``bf16``
is a valid value but not yet ported: :func:`dtype_policy` refuses it, as
``device.policy_dtype`` does, instead of silently staying float32.

Read once per process: the policy names the dtype every cached device
matrix was made in, so it must not change under a running service.
Stdlib only.
"""

from __future__ import annotations

import os

POLICIES = ("f32", "bf16")

_POLICY: list = []  # one-element cache: read once per process


def validate_policy(raw: str) -> str:
    value = raw.strip() or "f32"
    if value not in POLICIES:
        raise ValueError(
            f"LO_DTYPE_POLICY must be one of {'|'.join(POLICIES)}, "
            f"got {raw!r}"
        )
    return value


def dtype_policy() -> str:
    """The process's feature dtype policy string. ``bf16`` raises
    ``NotImplementedError``: the port moves float32 features only."""
    if not _POLICY:
        policy = validate_policy(os.environ.get("LO_DTYPE_POLICY", "f32"))
        if policy == "bf16":
            raise NotImplementedError(
                "LO_DTYPE_POLICY=bf16 is not yet ported; unset it or use f32"
            )
        _POLICY.append(policy)
    return _POLICY[0]
