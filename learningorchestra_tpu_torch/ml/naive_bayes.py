"""Multinomial naive Bayes: the fit and the prediction.

Counterpart of ``learningorchestra_tpu/ml/naive_bayes.py``: ``_fit`` (:35),
``NaiveBayes`` (:64) with MLlib's ``smoothing=1.0`` and its refusal of
negative features, and the predict half (``_forward`` :45,
``NaiveBayesModel`` :52-59).

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

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.ml.base import FittedModel, infer_num_classes


def _fit(X, y, num_classes: int, smoothing: float):
    """``(theta (C, F), prior (C,))``: log feature probabilities per class
    with additive smoothing, and log class priors."""
    one_hot = torch.nn.functional.one_hot(y.long(), num_classes).to(torch.float64)
    class_feature_sums = torch.matmul(one_hot.T, X.to(torch.float64)).to(torch.float32)
    class_counts = one_hot.sum(dim=0).to(torch.float32)
    smoothed = class_feature_sums + smoothing
    theta = torch.log(smoothed) - torch.log(smoothed.sum(dim=1, keepdim=True))
    rows = torch.full((), float(X.shape[0]), dtype=torch.float32, device=X.device)
    prior = torch.log(class_counts) - torch.log(rows)
    return theta, prior


def _forward(X, theta, prior):
    # The softmax over classes is invariant to a per-row shift, so theta is
    # centred across classes before the product. Uncentred, the joint
    # log-likelihood grows with |X| * |log p| (about 700 at 16 features of
    # values up to 20, where one float32 step is 6e-5) and the product's
    # rounding shows in the probabilities; centred, it carries only the
    # class differences.
    centred = theta - theta.mean(dim=0, keepdim=True)
    joint = torch.matmul(X, centred.T) + prior   # (N, C)
    return torch.softmax(joint, dim=1)


class NaiveBayesModel(FittedModel):
    def __init__(self, theta, prior):
        self.theta = theta    # (C, F) log feature probabilities
        self.prior = prior    # (C,) log class priors
        self.device = theta.device

    def _forward(self, X):
        return _forward(X, self.theta, self.prior)


class NaiveBayes:
    def __init__(self, smoothing: float = 1.0, device: DeviceLike = None):
        self.smoothing = smoothing
        self.device = resolve_device(device)

    def fit(self, X, y) -> NaiveBayesModel:
        X = np.asarray(X)
        if np.nanmin(X) < 0:
            raise ValueError(
                "NaiveBayes requires non-negative features (MLlib contract)"
            )
        num_classes = infer_num_classes(y)
        X_dev = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(self.device)
        y_dev = torch.from_numpy(np.asarray(y, dtype=np.int64)).to(self.device)
        theta, prior = _fit(X_dev, y_dev, num_classes, float(self.smoothing))
        return NaiveBayesModel(theta, prior)
