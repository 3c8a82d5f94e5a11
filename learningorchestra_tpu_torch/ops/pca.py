"""PCA on the card: covariance and eigendecomposition (K10, torch ops).

Counterpart of ``learningorchestra_tpu/ops/pca.py``: centre the rows,
form the ``(features, features)`` covariance with one float32
``Xᵀ @ X`` product (TF32 off: ``device.pin_fp32``, as the reference
pins ``Precision.HIGHEST``), ``eigh`` it, and project onto the top
components, largest first.

Over a data axis of several ranks (``mesh``) each rank holds its block of
the padded rows and their mask, as the reference shards them: the masked
sums and the count are every rank's, added in float64 in rank order, for
the mean; each rank's Gram matrix of its centred block (a float32
product) is widened and added in rank order, so every rank runs ``eigh``
on the same bits; each rank projects its block, and ``fetch`` gathers the
embedding.

Signs: an eigenvector is defined up to its sign, and LAPACK (the
reference on the CPU), cuSOLVER (the port on the card) and the TPU's
``eigh`` each choose their own. The reference fixes no sign convention,
so neither does the port: each component of the embedding agrees with
the reference's up to its sign.

Under ``LO_DTYPE_POLICY=bf16`` the reference keeps the matrix's bfloat16
to the end (its weights are ``mask.astype(X.dtype)``, so its mean,
centring and covariance are bfloat16) and its ``eigh`` refuses bfloat16:
the image request fails with a 500 whose body is that refusal. The port
does the same, word for word (:data:`EIGH_BF16_REFUSAL`): a PCA image
under ``bf16`` is the reference's failure, not a float32 PCA.
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.device import FEATURE_DTYPES, DeviceLike, resolve_device
from learningorchestra_tpu_torch.parallel.mesh import over_ranks

# The reference's eigh on a bfloat16 matrix (jaxlib's LAPACK binding on the
# CPU) raises NotImplementedError with these words.
EIGH_BF16_REFUSAL = "(KeyError(<class 'ml_dtypes.bfloat16'>), 'Unsupported dtype bfloat16.')"


def _moments_over_ranks(X, weights, mesh):
    """``(n, centred block, covariance)`` over every rank's rows: the
    float64 sums and Gram matrices added in rank order, each rounded once
    to X's type."""
    from learningorchestra_tpu_torch.parallel.multihost import all_sum

    local = torch.cat([
        (X.to(torch.float64) * weights.to(torch.float64)[:, None]).sum(dim=0),
        weights.to(torch.float64).sum().reshape(1),
    ])
    total = all_sum(local, mesh)
    n = total[-1]
    mean = (total[:-1] / n).to(X.dtype)
    centered = (X - mean) * weights[:, None]
    gram = all_sum((centered.T @ centered).to(torch.float64), mesh)
    return n.to(X.dtype), centered, (gram / (n - 1)).to(X.dtype)


def _pca(X, mask, n_components: int, mesh=None):
    """``(embedding, components, explained variances)`` of the rows of
    ``X`` where ``mask`` is set (reference ``:30``); over the data ranks of
    ``mesh``, ``X`` and ``mask`` are this rank's block and the moments
    every rank's."""
    weights = mask.to(X.dtype)
    if over_ranks(mesh):
        n, centered, covariance = _moments_over_ranks(X, weights, mesh)
    else:
        n = weights.sum()
        mean = (X * weights[:, None]).sum(dim=0) / n
        centered = (X - mean) * weights[:, None]
        covariance = (centered.T @ centered) / (n - 1)
    # fewer than two rows: the reference's NaN, without eigh of a NaN matrix
    if covariance.dtype == torch.bfloat16:
        raise NotImplementedError(EIGH_BF16_REFUSAL)
    defined = n >= 2
    identity = torch.eye(covariance.shape[0], dtype=covariance.dtype, device=covariance.device)
    eigenvalues, eigenvectors = torch.linalg.eigh(torch.where(defined, covariance, identity))
    # eigh is ascending; take the top components, largest first
    components = torch.where(defined, eigenvectors.flip(1)[:, :n_components], torch.nan)
    explained = torch.where(defined, eigenvalues.flip(0)[:n_components], torch.nan)
    return centered @ components, components, explained


def pca_embedding(
    X, n_components: int = 2, device: DeviceLike = None, mesh=None,
) -> np.ndarray:
    """Project the rows of ``X`` (an array or a tensor) onto their top
    principal components; a host ``(rows, n_components)`` float32 array.
    A host array goes to the device in the policy's type; a float32 or
    bfloat16 tensor keeps its type (the device cache's matrices are
    already in the policy's), another float32. Over the data ranks of
    ``mesh`` every rank passes the full rows, fits on its block and gets
    the whole embedding.

    Spans, as the reference's: ``pca:prepare`` (the copy of a host array
    and the launches) and ``d2h:pca``, the embedding's copy back, in
    which the device's time lands (the launches are asynchronous)."""
    from learningorchestra_tpu_torch.ml.base import shard_matrix, to_host
    from learningorchestra_tpu_torch.telemetry import span

    if over_ranks(mesh):
        from learningorchestra_tpu_torch.ml.base import prepare_xy
        from learningorchestra_tpu_torch.parallel.multihost import fetch

        with span("pca:prepare", rows=len(X)):
            rows = to_host(X) if torch.is_tensor(X) else np.asarray(X)
            block, _, mask = prepare_xy(rows, None, mesh)
            embedded, _, _ = _pca(block, mask, n_components, mesh)
        with span("d2h:pca", rows=len(X), components=n_components):
            return fetch(embedded, mesh, mask)
    device = resolve_device(device)
    with span("pca:prepare", rows=len(X)):
        if not torch.is_tensor(X):
            X = shard_matrix(X, device)
        X = X.to(device, X.dtype if X.dtype in FEATURE_DTYPES else torch.float32)
        mask = torch.ones(X.shape[0], dtype=torch.bool, device=device)
        embedded, _, _ = _pca(X, mask, n_components)
    with span("d2h:pca", rows=len(X), components=n_components):
        return to_host(embedded)
