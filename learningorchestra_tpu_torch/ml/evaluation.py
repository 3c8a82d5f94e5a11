"""Multiclass evaluation metrics: accuracy and weighted F1.

Counterpart of ``learningorchestra_tpu/ml/evaluation.py:19-95`` (K9),
and of its sharded form over a data axis of ranks (``masked_metrics``
with a ``mesh``).
Spark's "f1" is the weighted F1: per-class F1 averaged with true-class
support weights. Both metrics come from one confusion matrix, built on
the device.

The counts are exact integers: a float64 ``index_add_`` of 0/1 weights,
exact in any order up to 2^53, so no float atomic makes them depend on
the order threads run in. (``torch.bincount`` counts exactly too, but on
CUDA it copies its input's min and max to the host to size its output;
this keeps a forward's metrics free of host syncs.) The metrics then run
in float32, as the reference's do.

:func:`job_masked_metrics` is ``masked_metrics`` over a job axis, as the
sweep's fused programs run it under ``vmap`` (``ml/sweep.py:249, :263``):
each job's counts go into its own C x C block, so no count crosses jobs.
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.ml.base import to_host


def _counts(y_true, y_pred, weights, num_classes: int, mesh=None) -> torch.Tensor:
    index = y_true.long() * num_classes + y_pred.long()
    if weights is None:
        weights = torch.ones(index.shape, dtype=torch.float64, device=index.device)
    flat = torch.zeros(num_classes * num_classes, dtype=torch.float64, device=index.device)
    flat.index_add_(0, index, weights.to(torch.float64))
    if mesh is not None:
        from learningorchestra_tpu_torch.parallel.multihost import all_sum

        flat = all_sum(flat, mesh)
    return flat.to(torch.float32).reshape(num_classes, num_classes)


def confusion_matrix(y_true, y_pred, num_classes: int) -> torch.Tensor:
    """``(num_classes, num_classes)`` float32 counts, rows = true class."""
    return _counts(y_true, y_pred, None, num_classes)


def masked_metrics(y_true, y_pred, weights, num_classes: int, mesh=None):
    """``(accuracy, weighted_f1)`` as float32 device scalars, each row
    counted with its weight (the reference's validity mask, 0 or 1);
    ``weights=None`` counts every row once. On a ``mesh`` the rows are this
    rank's block, and every data rank's counts are added (in rank order:
    exact integers) before the metrics, the same on every rank."""
    return _metrics_from_cm(_counts(y_true, y_pred, weights, num_classes, mesh))


def job_masked_metrics(y_true, y_pred, weights, num_classes: int):
    """``(accuracy, weighted_f1)``, each ``(J,)`` float32, of every job's
    ``y_pred (J, rows)`` against ``y_true`` and row ``weights`` (each
    ``(J, rows)``, one shared ``(rows,)``, or weights None)."""
    jobs, rows = y_pred.shape
    block = num_classes * num_classes
    index = (
        torch.arange(jobs, device=y_pred.device)[:, None] * block
        + y_true.long() * num_classes
        + y_pred.long()
    )
    if weights is None:
        weights = torch.ones((rows,), dtype=torch.float64, device=index.device)
    flat = torch.zeros(jobs * block, dtype=torch.float64, device=index.device)
    flat.index_add_(0, index.reshape(-1), weights.to(torch.float64).expand(jobs, rows).reshape(-1))
    return _metrics_from_cm(flat.to(torch.float32).reshape(jobs, num_classes, num_classes))


def _metrics_from_cm(cm: torch.Tensor):
    """Metrics of a ``(C, C)`` confusion matrix, or of each of a job
    axis' ``(J, C, C)``."""
    total = cm.sum(dim=(-2, -1))
    true_positive = torch.diagonal(cm, dim1=-2, dim2=-1)
    accuracy = true_positive.sum(dim=-1) / total
    support = cm.sum(dim=-1)          # actual count per class
    predicted = cm.sum(dim=-2)        # predicted count per class
    precision = torch.where(predicted > 0, true_positive / predicted, 0.0)
    recall = torch.where(support > 0, true_positive / support, 0.0)
    f1 = torch.where(
        precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0
    )
    weighted_f1 = (f1 * support).sum(dim=-1) / total
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
    accuracy, weighted_f1 = to_host(torch.stack([accuracy, weighted_f1])).tolist()
    return accuracy, weighted_f1


def accuracy_score(y_true, y_pred, device: DeviceLike = None) -> float:
    return evaluate_both(y_true, y_pred, device)[0]


def f1_score(y_true, y_pred, device: DeviceLike = None) -> float:
    """Weighted multiclass F1 (Spark ``metricName="f1"`` semantics)."""
    return evaluate_both(y_true, y_pred, device)[1]
