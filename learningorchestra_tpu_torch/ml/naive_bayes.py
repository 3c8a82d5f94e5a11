"""Multinomial naive Bayes: the fit and the prediction.

Counterpart of ``learningorchestra_tpu/ml/naive_bayes.py``: ``_fit`` (:35),
``NaiveBayes`` (:64) with MLlib's ``smoothing=1.0`` and its refusal of
negative features, and the predict half (``_forward`` :45,
``NaiveBayesModel`` :52-59). Over a data axis of several ranks (``mesh``)
each rank sums its block of the rows, the mask as row weights, and the
ranks' float64 sums are added in rank order before the one rounding
(:func:`_fit_block`).

The fit is one product, ``one_hot(y)^T @ X`` (the per-class feature sums),
plus two log-normalizations: K8, plain torch (``torch.matmul``, as the
reference left it to XLA). The product runs in float64 and is rounded
once to float32, as the tree fits' sums are: deterministic (cuBLAS
repeats its sums bit for bit, where an ``index_add_`` of floats would
reorder them with atomics) and closer to the exact sums than the
reference's float32 product. The log-normalizations then run in float32,
as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.device import DeviceLike
from learningorchestra_tpu_torch.ml.base import (
    FittedModel,
    infer_num_classes,
    prepare_xy,
    shard_matrix,
)
from learningorchestra_tpu_torch.parallel.mesh import default_mesh, over_ranks


def _normalized(class_feature_sums, class_counts, rows, smoothing: float):
    """The float32 sums' log-normalizations: ``(theta, prior)``."""
    smoothed = class_feature_sums + smoothing
    theta = torch.log(smoothed) - torch.log(smoothed.sum(dim=1, keepdim=True))
    prior = torch.log(class_counts) - torch.log(rows)
    return theta, prior


def _fit(X, y, num_classes: int, smoothing: float):
    """``(theta (C, F), prior (C,))``: log feature probabilities per class
    with additive smoothing, and log class priors."""
    one_hot = torch.nn.functional.one_hot(y.long(), num_classes).to(torch.float64)
    class_feature_sums = torch.matmul(one_hot.T, X.to(torch.float64)).to(torch.float32)
    class_counts = one_hot.sum(dim=0).to(torch.float32)
    rows = torch.full((), float(X.shape[0]), dtype=torch.float32, device=X.device)
    return _normalized(class_feature_sums, class_counts, rows, smoothing)


def _fit_block(X, y, mask, num_classes: int, smoothing: float, mesh):
    """:func:`_fit` over a data axis: this rank's block ``X``, ``y`` and
    validity ``mask``; its float64 class-feature sums, class counts and
    valid rows (the mask as row weights), every rank's added in rank order
    and rounded once to float32, the same bits on every rank. The prior's
    row count is the global number of valid rows."""
    from learningorchestra_tpu_torch.parallel.multihost import all_sum

    weights = mask.to(torch.float64)
    one_hot = torch.nn.functional.one_hot(y.long(), num_classes).to(torch.float64) * weights[:, None]
    local = torch.cat([
        torch.matmul(one_hot.T, X.to(torch.float64)).reshape(-1),
        one_hot.sum(dim=0),
        weights.sum().reshape(1),
    ])
    total = all_sum(local, mesh).to(torch.float32)
    cells = num_classes * X.shape[1]
    class_feature_sums = total[:cells].reshape(num_classes, X.shape[1])
    return _normalized(class_feature_sums, total[cells:-1], total[-1], smoothing)


def _forward(X, theta, prior):
    # The softmax over classes is invariant to a per-row shift, so theta is
    # centred across classes before the product. Uncentred, the joint
    # log-likelihood grows with |X| * |log p| (about 700 at 16 features of
    # values up to 20, where one float32 step is 6e-5) and the product's
    # rounding shows in the probabilities; centred, it carries only the
    # class differences.
    centred = theta - theta.mean(dim=0, keepdim=True)
    # bfloat16 X widens exactly, as jnp promotes X @ theta.T to float32
    joint = torch.matmul(X.to(torch.float32), centred.T) + prior   # (N, C)
    return torch.softmax(joint, dim=1)


class NaiveBayesModel(FittedModel):
    def __init__(self, theta, prior, mesh=None):
        self.theta = theta    # (C, F) log feature probabilities
        self.prior = prior    # (C,) log class priors
        self.device = theta.device
        self.mesh = mesh

    def _forward(self, X):
        return _forward(X, self.theta, self.prior)


class NaiveBayes:
    """``mesh``: the ranks to fit over (``parallel/mesh.py``), by default
    every rank of the process group; in one process a 1×1 mesh on
    ``device`` and the single-device fit."""

    def __init__(self, smoothing: float = 1.0, device: DeviceLike = None, mesh=None):
        self.smoothing = smoothing
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self.device = self.mesh.device

    def fit(self, X, y) -> NaiveBayesModel:
        X = np.asarray(X)
        if np.nanmin(X) < 0:
            raise ValueError(
                "NaiveBayes requires non-negative features (MLlib contract)"
            )
        num_classes = infer_num_classes(y)
        if over_ranks(self.mesh):
            X_block, y_block, mask = prepare_xy(X, y, self.mesh)
            theta, prior = _fit_block(
                X_block, y_block, mask, num_classes, float(self.smoothing), self.mesh)
            return NaiveBayesModel(theta, prior, self.mesh)
        X_dev = shard_matrix(X, self.device)   # the policy's type; the sums widen it
        y_dev = torch.from_numpy(np.asarray(y, dtype=np.int64)).to(self.device)
        theta, prior = _fit(X_dev, y_dev, num_classes, float(self.smoothing))
        return NaiveBayesModel(theta, prior, self.mesh)
