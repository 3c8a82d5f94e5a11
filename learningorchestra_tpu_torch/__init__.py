"""learningorchestra_tpu_torch — the PyTorch/CUDA port of learningorchestra_tpu.

A second package beside the JAX one, written for one NVIDIA H100. The
JAX package is the reference: each module here keeps its counterpart's
name and public names, and tier-1 tests hold the two against each other
on the CPU.

Ported so far: the whole service stack in one process
(``services.runner``: the data services, the model builder with its
sweeps and the predict lane, the PCA and t-SNE image lane), over an
in-process store or the networked one (``core.store_service``: a store
server with WAL replication and quorum failover, its client over the
binary wire and a shared-memory ring), its job
scheduler with a journal and crash recovery, the five classifiers' fits
with segment-granular resume, and ``.model`` checkpoints either package
reads. The device programs on those paths run as hand-written CUDA
kernels (``kernels/csrc``) beside their plain PyTorch versions.

Rules that hold for every module:

- Nothing here imports ``jax`` or any module of ``learningorchestra_tpu``;
  what the port needs from a jax-free module there is copied.
- Entry points take ``device=None``, which means CUDA, and raise when
  there is no CUDA device. The CPU is used only when a caller passes
  ``device="cpu"``.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # torch loads with the first module that needs it, not with the
    # package: a store server's process (core/store_service.py) runs
    # without it and boots seconds sooner
    if name == "resolve_device":
        from learningorchestra_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
