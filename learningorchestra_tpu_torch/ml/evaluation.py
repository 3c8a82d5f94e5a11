"""Multiclass evaluation metrics: accuracy and weighted F1.

Counterpart of ``learningorchestra_tpu/ml/evaluation.py:19-95`` (K9).
Spark's "f1" is the weighted F1: per-class F1 averaged with true-class
support weights. Both metrics come from one confusion matrix, built on
the device.

The counts are exact integers: a float64 ``index_add_`` of 0/1 weights,
exact in any order up to 2^53, so no float atomic makes them depend on
the order threads run in. (``torch.bincount`` counts exactly too, but on
CUDA it copies its input's min and max to the host to size its output;
this keeps a forward's metrics free of host syncs.) The metrics then run
in float32, as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device


def _counts(y_true, y_pred, weights, num_classes: int) -> torch.Tensor:
    index = y_true.long() * num_classes + y_pred.long()
    if weights is None:
        weights = torch.ones(index.shape, dtype=torch.float64, device=index.device)
    flat = torch.zeros(num_classes * num_classes, dtype=torch.float64, device=index.device)
    flat.index_add_(0, index, weights.to(torch.float64))
    return flat.to(torch.float32).reshape(num_classes, num_classes)


def confusion_matrix(y_true, y_pred, num_classes: int) -> torch.Tensor:
    """``(num_classes, num_classes)`` float32 counts, rows = true class."""
    return _counts(y_true, y_pred, None, num_classes)


def masked_metrics(y_true, y_pred, weights, num_classes: int):
    """``(accuracy, weighted_f1)`` as float32 device scalars, each row
    counted with its weight (the reference's validity mask, 0 or 1);
    ``weights=None`` counts every row once."""
    return _metrics_from_cm(_counts(y_true, y_pred, weights, num_classes))


def _metrics_from_cm(cm: torch.Tensor):
    total = cm.sum()
    accuracy = torch.trace(cm) / total
    true_positive = torch.diagonal(cm)
    support = cm.sum(dim=1)           # actual count per class
    predicted = cm.sum(dim=0)         # predicted count per class
    precision = torch.where(predicted > 0, true_positive / predicted, 0.0)
    recall = torch.where(support > 0, true_positive / support, 0.0)
    f1 = torch.where(
        precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0
    )
    weighted_f1 = (f1 * support).sum() / total
    return accuracy, weighted_f1


def evaluate_both(y_true, y_pred, device: DeviceLike = None) -> tuple[float, float]:
    """``(accuracy, weighted_f1)`` of host labels, from one confusion
    matrix on ``device`` and one device-to-host copy."""
    device = resolve_device(device)
    num_classes = int(max(np.max(y_true), np.max(y_pred))) + 1
    accuracy, weighted_f1 = masked_metrics(
        torch.as_tensor(np.asarray(y_true, np.int64), device=device),
        torch.as_tensor(np.asarray(y_pred, np.int64), device=device),
        None,
        num_classes,
    )
    accuracy, weighted_f1 = torch.stack([accuracy, weighted_f1]).cpu().tolist()
    return accuracy, weighted_f1


def accuracy_score(y_true, y_pred, device: DeviceLike = None) -> float:
    return evaluate_both(y_true, y_pred, device)[0]


def f1_score(y_true, y_pred, device: DeviceLike = None) -> float:
    """Weighted multiclass F1 (Spark ``metricName="f1"`` semantics)."""
    return evaluate_both(y_true, y_pred, device)[1]
