"""Logistic regression prediction.

Counterpart of the predict half of ``learningorchestra_tpu/ml/logistic.py``
(``_forward`` :431, ``LogisticRegressionModel`` :447-458): standardize,
one ``(rows, F) x (F, C)`` product, bias, softmax. The product is a plain
``torch.matmul`` in full float32 (TF32 is off, ``device.py``), as the
reference left it to XLA. The L-BFGS fit is not ported yet.
"""

from __future__ import annotations

import torch

from learningorchestra_tpu_torch.ml.base import FittedModel


def _forward(X, w, b, mean, scale):
    logits = torch.matmul((X - mean) / scale, w) + b
    return torch.softmax(logits, dim=1)


class LogisticRegressionModel(FittedModel):
    def __init__(self, w, b, mean, scale):
        self.w = w            # (F, C)
        self.b = b            # (C,)
        self.mean = mean      # (F,)
        self.scale = scale    # (F,)
        self.device = w.device

    def _forward(self, X):
        return _forward(X, self.w, self.b, self.mean, self.scale)
