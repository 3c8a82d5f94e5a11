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
- ``LO_DTYPE_POLICY`` (``utils/dtypepolicy.py``, read once a process):
  feature matrices travel and stay on the card as float32 under ``f32``,
  as bfloat16 under ``bf16``.
"""

from __future__ import annotations

from typing import Union

import torch

from learningorchestra_tpu_torch.utils.dtypepolicy import dtype_policy

# The float types a feature matrix can have: policy_dtype's two answers.
FEATURE_DTYPES = (torch.float32, torch.bfloat16)

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
    """The float type feature matrices travel in: ``bfloat16`` under
    ``LO_DTYPE_POLICY=bf16``, else ``float32``. A view of
    ``utils.dtypepolicy.dtype_policy``, read once a process. Integer,
    boolean and mask tensors never take it (reference
    ``parallel/sharding.py:78-89``)."""
    return torch.bfloat16 if dtype_policy() == "bf16" else torch.float32
