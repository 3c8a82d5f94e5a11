"""Shared estimator contract: numpy rows in, numpy out, device inside.

Counterpart of ``learningorchestra_tpu/ml/base.py``: ``CLASSIFIER_NAMES``,
``largest_divisor`` and ``segment_steps`` (:36-93), ``infer_num_classes``,
``FittedModel`` with ``evaluate`` and ``evaluate_predict`` (:250-297) and
``make_classifier`` (:306). A model holds its parameters as tensors on one
device; its forward is a plain function on tensors.

The reference pads rows to a multiple of the mesh's data axis and carries
a validity mask (``prepare_xy``, ``ml/base.py:145-163``). One card has no
mesh to divide the rows over, so the port sends the rows as they are and
needs no mask. The serve batcher still pads a dispatch to the shared
shape grid, as the reference's does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from learningorchestra_tpu_torch.device import DeviceLike, policy_dtype

# The model-builder request contract.
CLASSIFIER_NAMES = ("lr", "dt", "rf", "gb", "nb")

# Multiplier on every per-estimator segment budget, read once at import,
# as the reference reads it: the segmentation decides which resume
# artifacts a fit writes, so it must not change within a process.
try:
    _PROGRAM_BUDGET_SCALE = float(os.environ.get("LO_PROGRAM_ROW_STEPS", "1") or "1")
except ValueError as error:
    raise ValueError(
        "LO_PROGRAM_ROW_STEPS must be a number, got "
        f"{os.environ.get('LO_PROGRAM_ROW_STEPS')!r}"
    ) from error


def largest_divisor(total: int, cap: int, multiple_of: int = 1) -> int:
    """Largest divisor of ``total`` that is <= ``cap`` and a multiple of
    ``multiple_of``; falls back to ``multiple_of`` (assumed to divide
    ``total``) when no divisor fits under the cap."""
    best = 0
    for candidate in range(multiple_of, total + 1, multiple_of):
        if total % candidate == 0 and candidate <= cap:
            best = candidate
    return best or multiple_of


def segment_steps(
    total: int, rows: int, row_steps_budget: float, features: int = 16
) -> int:
    """Steps per segment of an iterative fit (boosting rounds, ...): the
    largest divisor of ``total`` within ``row_steps_budget`` row*steps at
    a 16-feature reference width, scaled by ``LO_PROGRAM_ROW_STEPS``. The
    reference's formula, exactly: segment boundaries decide the resume
    artifacts, which either package must be able to read."""
    row_steps_budget *= _PROGRAM_BUDGET_SCALE
    if total <= 1 or rows <= 0:
        return max(total, 1)
    cost_rows = rows * max(features, 1) / 16
    target = max(1, int(row_steps_budget / cost_rows))
    if target >= total:
        return total
    return largest_divisor(total, target)


def infer_num_classes(y: np.ndarray) -> int:
    """Labels are class indices 0..C-1 (the MLlib convention)."""
    return int(np.max(y)) + 1 if len(y) else 1


def labels_from_probs(probs: np.ndarray) -> np.ndarray:
    """Every model's labels are ``argmax(probs)`` (softmax, posterior and
    ensemble mean are all argmax-monotonic), so labels are rebuilt on the
    host and only the probabilities travel back from the device."""
    return np.argmax(probs, axis=1)


class FittedModel:
    """Base for fitted models. Subclasses set ``device`` and implement
    ``_forward(X) -> probs`` on a float32 ``(rows, F)`` tensor there."""

    device: torch.device

    def _forward(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _to_device(self, X) -> torch.Tensor:
        dtype = policy_dtype()
        if isinstance(X, torch.Tensor):
            return X.to(self.device, dtype).contiguous()
        host = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))
        return host.to(self.device, dtype)

    def _eval(self, X) -> tuple[np.ndarray, np.ndarray]:
        # the one device-to-host copy of a forward: the probabilities
        probs = self._forward(self._to_device(X)).cpu().numpy()
        return labels_from_probs(probs), probs

    def predict(self, X) -> np.ndarray:
        return self._eval(X)[0]

    def predict_proba(self, X) -> np.ndarray:
        return self._eval(X)[1]

    def predict_both(self, X) -> tuple[np.ndarray, np.ndarray]:
        """``(labels, probabilities)`` from one forward pass."""
        return self._eval(X)

    def _device_metrics(self, X, y_true):
        """Forward plus the confusion metrics on the device: unfetched
        ``(accuracy, weighted_f1)`` scalars and the probabilities."""
        from learningorchestra_tpu_torch.ml.evaluation import masked_metrics

        probs = self._forward(self._to_device(X))
        num_classes = max(int(probs.shape[-1]), infer_num_classes(y_true))
        y_dev = torch.from_numpy(np.asarray(y_true, np.int64)).to(self.device)
        accuracy, weighted_f1 = masked_metrics(y_dev, probs.argmax(dim=1), None, num_classes)
        return accuracy, weighted_f1, probs

    def evaluate(self, X, y_true) -> tuple[float, float]:
        """``(accuracy, weighted_f1)``: the confusion matrix is built on the
        device, and only the two scalars travel back."""
        accuracy, weighted_f1, _ = self._device_metrics(X, y_true)
        accuracy, weighted_f1 = torch.stack([accuracy, weighted_f1]).cpu().tolist()
        return accuracy, weighted_f1

    def evaluate_predict(
        self, X_eval, y_eval, X_test
    ) -> tuple[float, float, np.ndarray, np.ndarray]:
        """Metrics on the eval rows and ``(labels, probabilities)`` on the
        test rows in one device-to-host copy; when ``X_test is X_eval`` the
        forward runs once."""
        accuracy, weighted_f1, probs = self._device_metrics(X_eval, y_eval)
        if X_test is not X_eval:
            probs = self._forward(self._to_device(X_test))
        flat = torch.cat([probs.reshape(-1), torch.stack([accuracy, weighted_f1])])
        host = flat.cpu().numpy()
        probs_np = host[:-2].reshape(probs.shape)
        return float(host[-2]), float(host[-1]), labels_from_probs(probs_np), probs_np

    def device_state(self) -> list:
        """The model's parameter tensors (the serve registry counts their
        bytes against its budget)."""
        return [value for value in vars(self).values() if isinstance(value, torch.Tensor)]


def make_classifier(name: str, device: DeviceLike = None):
    """The classifier switcher (reference ``ml/base.py:306``): ``lr``,
    ``dt``, ``rf``, ``gb`` and ``nb`` at their defaults."""
    from learningorchestra_tpu_torch.ml.logistic import LogisticRegression
    from learningorchestra_tpu_torch.ml.naive_bayes import NaiveBayes
    from learningorchestra_tpu_torch.ml.trees import (
        DecisionTreeClassifier,
        GBTClassifier,
        RandomForestClassifier,
    )

    estimators = {
        "lr": LogisticRegression,
        "dt": DecisionTreeClassifier,
        "rf": RandomForestClassifier,
        "gb": GBTClassifier,
        "nb": NaiveBayes,
    }
    if name not in CLASSIFIER_NAMES:
        raise KeyError(name)
    return estimators[name](device=device)
