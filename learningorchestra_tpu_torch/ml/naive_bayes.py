"""Multinomial naive Bayes prediction.

Counterpart of the predict half of ``learningorchestra_tpu/ml/
naive_bayes.py`` (``_forward`` :45, ``NaiveBayesModel`` :52-59): the joint
log-likelihood ``X @ theta.T + prior`` and a softmax over classes, the
same function computed with less float32 rounding (see ``_forward``). The
fit is not ported yet.
"""

from __future__ import annotations

import torch

from learningorchestra_tpu_torch.ml.base import FittedModel


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
