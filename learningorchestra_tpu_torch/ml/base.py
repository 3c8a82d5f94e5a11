"""Shared estimator contract: numpy rows in, numpy out, device inside.

Counterpart of ``learningorchestra_tpu/ml/base.py``: ``CLASSIFIER_NAMES``,
``largest_divisor`` and ``segment_steps`` (:36-93), ``infer_num_classes``,
``DeviceLabels``, ``shard_matrix`` and ``shard_labels`` (:125-142, one
copy to the device here, in the dtype policy's type: the reference's
``prepare_xy`` funnel, ``parallel/sharding.py:78-107``), ``FittedModel`` with ``evaluate`` and
``evaluate_predict`` (:250-297), ``prepare_xy`` (:145-163) and
``make_classifier`` (:306). A model holds its parameters as tensors on one
device; its forward is a plain function on tensors.

Over a data axis of several ``torch.distributed`` ranks (a ``mesh``,
``parallel/mesh.py``), every rank passes the full rows and each takes its
block of them, padded and masked as the reference's ``prepare_xy`` pads
them (:func:`prepare_xy`); the fits add every rank's sums in rank order,
and a fitted model's forward and metrics run over the ranks too
(``FittedModel``). In one process the mesh is 1×1: the rows go to the
card as they are, with no padding and no mask. The serve batcher still
pads a dispatch to the shared shape grid, as the reference's does.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from learningorchestra_tpu_torch.device import DeviceLike, policy_dtype, resolve_device
from learningorchestra_tpu_torch.telemetry import profile as _profile
from learningorchestra_tpu_torch.telemetry import span as _span

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


class DeviceLabels:
    """A label vector on the device (int64) with its class count taken on
    the host, so the device metrics need no sync to size their scatter.
    Shared across classifier threads like a frame's device matrix."""

    __slots__ = ("data", "num_classes")

    def __init__(self, data: torch.Tensor, num_classes: int):
        self.data = data
        self.num_classes = num_classes


# Bytes copied host-to-device by shard_matrix and shard_labels, the one
# funnel every feature matrix and label vector of the product path goes
# through; each copy also counts into the flight recorder's
# lo_h2d_bytes_total and the active span. A cached input adds none.
_h2d = {"bytes": 0}
_h2d_lock = threading.Lock()


def h2d_bytes() -> int:
    """Bytes this process has copied to a device through :func:`shard_matrix`
    and :func:`shard_labels`."""
    with _h2d_lock:
        return _h2d["bytes"]


def _record_h2d(nbytes: int) -> None:
    with _h2d_lock:
        _h2d["bytes"] += nbytes
    _profile.account_h2d(nbytes)


def _on_card(tensor: torch.Tensor) -> bool:
    """Whether a copy to or from ``tensor`` crosses to a card (and counts);
    a CPU tensor is copied nowhere."""
    return tensor.device.type != "cpu"


def _account_h2d(tensor: torch.Tensor) -> torch.Tensor:
    """Count ``tensor``'s bytes where it lies on a card (the copy that
    made it)."""
    if _on_card(tensor):
        _record_h2d(tensor.numel() * tensor.element_size())
    return tensor


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` as a numpy array: one device-to-host copy, counted into
    ``lo_d2h_bytes_total`` and the active span where it leaves a card.
    Every copy of the port's ``ml/``, ``ops/`` and ``parallel/`` from a card
    goes through here: predictions, metrics, fitted parameters, progress
    snapshots, embeddings, gb's ``f0``."""
    host = tensor.cpu().numpy()
    if _on_card(tensor):
        _profile.account_d2h(int(host.nbytes))
    return host


def shard_matrix(X: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """``X`` as a tensor on ``device`` in the policy's float type (float32,
    or bfloat16 under ``LO_DTYPE_POLICY=bf16``): one host-to-device copy
    of that type (the reference's ``shard_matrix`` pads and row-shards on a
    mesh). The cast rounds float64 through float32, as the reference's."""
    host = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(policy_dtype())
    return _account_h2d(host.to(resolve_device(device)))


def shard_labels(y: np.ndarray, device: DeviceLike = None) -> DeviceLabels:
    y = np.asarray(y)
    data = _account_h2d(torch.from_numpy(y.astype(np.int64)).to(resolve_device(device)))
    return DeviceLabels(data, infer_num_classes(y))


def prepare_xy(X, y, mesh):
    """This rank's block of the rows ``X`` (in the policy's float type), of
    the labels ``y`` (int64; None gives None) and the block's validity
    mask, by the reference's block rule (``parallel.shard_rows``: the rows
    padded to the bucketed grid, aligned to the data axis; rank ``r``'s
    block is the reference's shard ``r``)."""
    from learningorchestra_tpu_torch.parallel.sharding import shard_rows

    X_block, mask = shard_rows(np.asarray(X), mesh, dtype=np.float32)
    y_block = None if y is None else shard_rows(np.asarray(y).astype(np.int64), mesh)[0]
    return X_block, y_block, mask


def labels_from_probs(probs: np.ndarray) -> np.ndarray:
    """Every model's labels are ``argmax(probs)`` (softmax, posterior and
    ensemble mean are all argmax-monotonic), so labels are rebuilt on the
    host and only the probabilities travel back from the device."""
    return np.argmax(probs, axis=1)


class FittedModel:
    """Base for fitted models. Subclasses set ``device`` and implement
    ``_forward(X) -> probs`` on a ``(rows, F)`` tensor there in the
    policy's float type.

    A model fitted over a data axis of several ranks sets ``mesh``
    (``parallel/mesh.py``): every rank passes the full rows, each runs the
    forward on its block of them (``parallel.shard_rows``), the
    probabilities are gathered (``parallel.fetch``), and the metrics add
    every rank's weighted confusion counts before they are computed (K9
    over ranks, reference ``ml/evaluation.py:31 masked_metrics``)."""

    device: torch.device
    mesh = None

    def _forward(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _sharded(self) -> bool:
        from learningorchestra_tpu_torch.parallel.mesh import over_ranks

        return over_ranks(self.mesh)

    def _block(self, X):
        """This rank's block of the rows ``X`` and its validity mask."""
        rows = to_host(X) if isinstance(X, torch.Tensor) else np.asarray(X)
        block, _, mask = prepare_xy(rows, None, self.mesh)
        return block, mask

    def _to_device(self, X) -> torch.Tensor:
        if isinstance(X, torch.Tensor):
            return X.to(self.device, policy_dtype()).contiguous()
        return shard_matrix(X, self.device)

    def _eval(self, X) -> tuple[np.ndarray, np.ndarray]:
        if self._sharded():
            from learningorchestra_tpu_torch.parallel.multihost import fetch

            block, mask = self._block(X)
            probs = fetch(self._forward(block), self.mesh, mask)
            return labels_from_probs(probs), probs
        # the one device-to-host copy of a forward: the probabilities
        probs = self._forward(self._to_device(X))
        with _span("d2h:predictions", rows=len(X)):
            probs = to_host(probs)
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

        if self._sharded():
            from learningorchestra_tpu_torch.parallel.sharding import shard_rows

            block, mask = self._block(X)
            probs = self._forward(block)
            y = to_host(y_true.data) if isinstance(y_true, DeviceLabels) else np.asarray(y_true)
            num_classes = max(int(probs.shape[-1]), infer_num_classes(y))
            y_block, _ = shard_rows(y.astype(np.int64), self.mesh)
            accuracy, weighted_f1 = masked_metrics(
                y_block, probs.argmax(dim=1), mask, num_classes, self.mesh)
            return accuracy, weighted_f1, probs
        probs = self._forward(self._to_device(X))
        if isinstance(y_true, DeviceLabels):  # copied once by the builder
            y_dev = y_true.data.to(self.device)
            num_classes = max(int(probs.shape[-1]), y_true.num_classes)
        else:
            num_classes = max(int(probs.shape[-1]), infer_num_classes(y_true))
            y_dev = torch.from_numpy(np.asarray(y_true, np.int64)).to(self.device)
        accuracy, weighted_f1 = masked_metrics(y_dev, probs.argmax(dim=1), None, num_classes)
        return accuracy, weighted_f1, probs

    def evaluate(self, X, y_true) -> tuple[float, float]:
        """``(accuracy, weighted_f1)``: the confusion matrix is built on the
        device, and only the two scalars travel back."""
        accuracy, weighted_f1, _ = self._device_metrics(X, y_true)
        with _span("d2h:predictions", rows=len(X)):
            accuracy, weighted_f1 = to_host(torch.stack([accuracy, weighted_f1])).tolist()
        return accuracy, weighted_f1

    def evaluate_predict(
        self, X_eval, y_eval, X_test
    ) -> tuple[float, float, np.ndarray, np.ndarray]:
        """Metrics on the eval rows and ``(labels, probabilities)`` on the
        test rows in one device-to-host copy (its ``d2h:predictions``
        span); when ``X_test is X_eval`` the forward runs once. Over
        several data ranks: the metrics, then the test rows' forward
        gathered."""
        if self._sharded():
            accuracy, weighted_f1 = self.evaluate(X_eval, y_eval)
            return (accuracy, weighted_f1, *self._eval(X_test))
        accuracy, weighted_f1, probs = self._device_metrics(X_eval, y_eval)
        if X_test is not X_eval:
            probs = self._forward(self._to_device(X_test))
        flat = torch.cat([probs.reshape(-1), torch.stack([accuracy, weighted_f1])])
        with _span("d2h:predictions", rows=len(X_test)):
            host = to_host(flat)
        probs_np = host[:-2].reshape(probs.shape)
        return float(host[-2]), float(host[-1]), labels_from_probs(probs_np), probs_np

    def device_state(self) -> list:
        """The model's parameter tensors (the serve registry counts their
        bytes against its budget)."""
        return [value for value in vars(self).values() if isinstance(value, torch.Tensor)]


def make_classifier(name: str, device: DeviceLike = None, mesh=None):
    """The classifier switcher (reference ``ml/base.py:306``): ``lr``,
    ``dt``, ``rf``, ``gb`` and ``nb`` at their defaults, on ``mesh`` (by
    default every rank of the process group; in one process a 1×1 mesh on
    ``device``)."""
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
    return estimators[name](device=device, mesh=mesh)
