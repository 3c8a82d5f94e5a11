"""Device resolution and numeric policy.

Counterpart of ``learningorchestra_tpu/parallel/mesh.py`` (which device
runs the work) and ``parallel/sharding.py:policy_dtype`` (which float
type feature matrices travel in). One card needs no mesh: the port
resolves a single ``torch.device``.

- ``device=None`` means CUDA. With no CUDA device that raises; nothing
  falls back to the CPU, which runs only when a caller asks for it.
- Float32 products stay full float32: the reference pins
  ``Precision.HIGHEST`` (``ml/trees.py:110-119``), so TF32 is off for
  both cuBLAS and cuDNN.
- ``LO_DTYPE_POLICY``: only ``f32`` is ported. ``bf16`` raises instead of
  silently staying float32.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DTYPE_POLICIES = ("f32", "bf16")

DeviceLike = Union[str, torch.device, None]


def pin_fp32() -> None:
    """Keep float32 matrix products in float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked for the CPU."""
    pin_fp32()
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {resolved}")
    if resolved.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if resolved.index is None:
            # name the card, so that devices compare equal to tensors' devices
            resolved = torch.device("cuda", torch.cuda.current_device())
    return resolved


def policy_dtype() -> torch.dtype:
    """The float type feature matrices travel in, from ``LO_DTYPE_POLICY``
    (same values and validation as the JAX package's
    ``utils/dtypepolicy.py``)."""
    raw = os.environ.get("LO_DTYPE_POLICY", "f32")
    policy = raw.strip() or "f32"
    if policy not in DTYPE_POLICIES:
        raise ValueError(
            f"LO_DTYPE_POLICY must be one of {'|'.join(DTYPE_POLICIES)}, "
            f"got {raw!r}"
        )
    if policy == "bf16":
        raise NotImplementedError(
            "LO_DTYPE_POLICY=bf16 is not yet ported; unset it or use f32"
        )
    return torch.float32
