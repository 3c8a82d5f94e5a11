"""Shared estimator contract: numpy rows in, numpy out, device inside.

Counterpart of ``learningorchestra_tpu/ml/base.py`` (``CLASSIFIER_NAMES``,
``infer_num_classes`` and the predict half of ``FittedModel``). A model
holds its parameters as tensors on one device; its forward is a plain
function on tensors.

The reference pads rows to a multiple of the mesh's data axis and carries
a validity mask (``prepare_xy``, ``ml/base.py:145-163``). One card has no
mesh to divide the rows over, so the port sends the rows as they are and
needs no mask. The serve batcher still pads a dispatch to the shared
shape grid, as the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.device import policy_dtype

# The model-builder request contract.
CLASSIFIER_NAMES = ("lr", "dt", "rf", "gb", "nb")


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

    def device_state(self) -> list:
        """The model's parameter tensors (the serve registry counts their
        bytes against its budget)."""
        return [value for value in vars(self).values() if isinstance(value, torch.Tensor)]
