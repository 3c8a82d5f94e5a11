"""learningorchestra_tpu_torch — the PyTorch/CUDA port of learningorchestra_tpu.

A second package beside the JAX one, written for one NVIDIA H100. The
JAX package is the reference: each module here keeps its counterpart's
name and public names, and tier-1 tests hold the two against each other
on the CPU.

Ported so far: the online predict lane — ``.model`` checkpoints of all
four kinds, the serving registry and micro-batcher, and
``POST /models/<name>/predict`` over a stdlib HTTP server. The tree
forward runs as a hand-written CUDA kernel (``kernels/csrc``).

Rules that hold for every module:

- Nothing here imports ``jax`` or any module of ``learningorchestra_tpu``;
  what the port needs from a jax-free module there is copied.
- Entry points take ``device=None``, which means CUDA, and raise when
  there is no CUDA device. The CPU is used only when a caller passes
  ``device="cpu"``.
"""

from learningorchestra_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
