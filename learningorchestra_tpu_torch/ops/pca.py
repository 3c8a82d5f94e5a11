"""PCA on one card: covariance and eigendecomposition (K10, torch ops).

Counterpart of ``learningorchestra_tpu/ops/pca.py``: centre the rows,
form the ``(features, features)`` covariance with one float32
``Xᵀ @ X`` product (TF32 off: ``device.pin_fp32``, as the reference
pins ``Precision.HIGHEST``), ``eigh`` it, and project onto the top
components, largest first.

Signs: an eigenvector is defined up to its sign, and LAPACK (the
reference on the CPU), cuSOLVER (the port on the card) and the TPU's
``eigh`` each choose their own. The reference fixes no sign convention,
so neither does the port: each component of the embedding agrees with
the reference's up to its sign.
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device


def _pca(X, mask, n_components: int):
    """``(embedding, components, explained variances)`` of the rows of
    ``X`` where ``mask`` is set (reference ``:30``)."""
    weights = mask.to(X.dtype)
    n = weights.sum()
    mean = (X * weights[:, None]).sum(dim=0) / n
    centered = (X - mean) * weights[:, None]
    covariance = (centered.T @ centered) / (n - 1)
    # fewer than two rows: the reference's NaN, without eigh of a NaN matrix
    defined = n >= 2
    identity = torch.eye(covariance.shape[0], dtype=covariance.dtype, device=covariance.device)
    eigenvalues, eigenvectors = torch.linalg.eigh(torch.where(defined, covariance, identity))
    # eigh is ascending; take the top components, largest first
    components = torch.where(defined, eigenvectors.flip(1)[:, :n_components], torch.nan)
    explained = torch.where(defined, eigenvalues.flip(0)[:n_components], torch.nan)
    return centered @ components, components, explained


def pca_embedding(X, n_components: int = 2, device: DeviceLike = None) -> np.ndarray:
    """Project the rows of ``X`` (an array or a tensor) onto their top
    principal components; a host ``(rows, n_components)`` float32 array."""
    device = resolve_device(device)
    if not torch.is_tensor(X):
        X = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))
    X = X.to(device, torch.float32)
    mask = torch.ones(X.shape[0], dtype=torch.bool, device=device)
    embedded, _, _ = _pca(X, mask, n_components)
    return embedded.cpu().numpy()
