"""Model checkpoints: the reference's ``.model`` format, read and written.

Counterpart of ``learningorchestra_tpu/ml/checkpoint.py:26-168``. A
checkpoint is one ``.npz`` archive of the model's arrays plus a
``__model__.json`` header ``{"kind": ..., "scalars": {...}}``. The format
is shared: a ``.model`` written by either package loads and predicts the
same in the other. Kinds and contents:

==================  ==============================================  =======================
kind                arrays                                          scalars
==================  ==============================================  =======================
``logistic``        ``w (F,C)``, ``b (C,)``, ``mean (F,)``,         —
                    ``scale (F,)``
``naive_bayes``     ``theta (C,F)``, ``prior (C,)``                 —
``gbt``             ``features_heap (T,2^D-1)``,                    ``f0``, ``step``,
                    ``thresholds_heap (T,2^D-1)``,                  ``max_depth``
                    ``leaf_values (T,2^D)``
``tree_ensemble``   ``features_heap``, ``thresholds_heap``,         ``max_depth``
                    ``leaf_probs (T,2^D,C)``
==================  ==============================================  =======================

:func:`model_from_arrays` is the weight carrier: it turns a kind, its
arrays (numpy, in the reference's layout) and scalars into a port model on
a device. :func:`load_model` goes through it. :func:`lbfgs_state_from_arrays`
carries a logistic regression fit's mid-fit state the same way.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.ml.base import to_host
from learningorchestra_tpu_torch.ml.logistic import LogisticRegressionModel
from learningorchestra_tpu_torch.ml.naive_bayes import NaiveBayesModel
from learningorchestra_tpu_torch.ml.trees import GBTModel, _TreeEnsembleModel

_HEADER = "__model__.json"

# <models_dir>/<name>.model, shared by the builder and the service
CHECKPOINT_SUFFIX = ".model"

# kind -> {array name: dtype the port holds it in}
ARRAY_DTYPES = {
    "logistic": {
        "w": np.float32, "b": np.float32, "mean": np.float32, "scale": np.float32,
    },
    "naive_bayes": {"theta": np.float32, "prior": np.float32},
    "gbt": {
        "features_heap": np.int32,
        "thresholds_heap": np.float32,
        "leaf_values": np.float32,
    },
    "tree_ensemble": {
        "features_heap": np.int32,
        "thresholds_heap": np.float32,
        "leaf_probs": np.float32,
    },
}


def checkpoint_path(models_dir: str, name: str) -> str:
    return os.path.join(models_dir, name + CHECKPOINT_SUFFIX)


def model_from_arrays(
    kind: str, arrays: dict, scalars: dict, device: DeviceLike = None, mesh=None,
):
    """A predict-ready port model from the reference's parameters. Given a
    ``mesh`` of several data ranks (every rank loads the same file), the
    model lies on the mesh's device and predicts and evaluates over its
    ranks."""
    if kind not in ARRAY_DTYPES:
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    device = mesh.device if mesh is not None else resolve_device(device)
    model = _model(kind, arrays, scalars, device)
    model.mesh = mesh
    return model


def _model(kind: str, arrays: dict, scalars: dict, device: torch.device):
    tensors = {
        name: torch.tensor(np.asarray(arrays[name], dtype=dtype), device=device)
        for name, dtype in ARRAY_DTYPES[kind].items()
    }
    if kind == "logistic":
        return LogisticRegressionModel(**tensors)
    if kind == "naive_bayes":
        return NaiveBayesModel(**tensors)
    if kind == "gbt":
        return GBTModel(
            scalars["f0"],
            tensors["features_heap"],
            tensors["thresholds_heap"],
            tensors["leaf_values"],
            scalars["step"],
            scalars["max_depth"],
        )
    return _TreeEnsembleModel(
        tensors["features_heap"],
        tensors["thresholds_heap"],
        tensors["leaf_probs"],
        scalars["max_depth"],
    )


# The leaves of the reference's ``(params, opt_state)`` in
# ``jax.tree.leaves`` order (dict keys sorted), as ``ml/progress.py`` saves
# a logistic fit's segment: params, then the L-BFGS state
# (ml/logistic.py:82)
LBFGS_LEAVES = (
    "b", "w",
    "S.b", "S.w", "Y.b", "Y.w", "filled", "grad.b", "grad.w", "head", "rho", "value",
)


def lbfgs_state_from_arrays(leaves, device: DeviceLike = None):
    """``(W, b, state)`` for the port's L-BFGS from the reference's
    ``(params, opt_state)`` leaves (numpy arrays, in ``LBFGS_LEAVES``
    order): a fit can go on in the port from where the reference left it."""
    if len(leaves) != len(LBFGS_LEAVES):
        raise ValueError(f"{len(leaves)} leaves, expected {len(LBFGS_LEAVES)}")
    device = resolve_device(device)
    named = dict(zip(LBFGS_LEAVES, leaves))

    def tensor(name, dtype=np.float32):
        return torch.tensor(np.asarray(named[name], dtype=dtype), device=device)

    state = {
        "S": {"w": tensor("S.w"), "b": tensor("S.b")},
        "Y": {"w": tensor("Y.w"), "b": tensor("Y.b")},
        "rho": tensor("rho"),
        "head": tensor("head", np.int32),
        "filled": tensor("filled", np.int32),
        "value": tensor("value"),
        "grad": {"w": tensor("grad.w"), "b": tensor("grad.b")},
    }
    return tensor("w"), tensor("b"), state


def gather_model(model) -> tuple[str, dict, dict]:
    """``(kind, arrays, scalars)`` of a port model, arrays on the host."""
    if isinstance(model, LogisticRegressionModel):
        kind, scalars = "logistic", {}
    elif isinstance(model, NaiveBayesModel):
        kind, scalars = "naive_bayes", {}
    elif isinstance(model, GBTModel):
        kind = "gbt"
        scalars = {"f0": model.f0, "step": model.step, "max_depth": model.max_depth}
    elif isinstance(model, _TreeEnsembleModel):
        kind, scalars = "tree_ensemble", {"max_depth": model.max_depth}
    else:
        raise TypeError(f"unknown model type {type(model).__name__}")
    arrays = {
        name: to_host(getattr(model, name)) for name in ARRAY_DTYPES[kind]
    }
    return kind, arrays, scalars


def write_checkpoint(gathered: tuple[str, dict, dict], path: str) -> None:
    """Write ``(kind, arrays, scalars)`` to ``path``. Atomic (temp file +
    ``os.replace``): a reader never sees a partial archive, and every
    rewrite gets a new inode, which the serve registry's rev notices."""
    kind, arrays, scalars = gathered
    tmp_path = path + ".tmp"
    # through a file object: np.savez given a name appends ".npz"
    with open(tmp_path, "wb") as handle:
        np.savez(handle, **arrays)
    header = json.dumps({"kind": kind, "scalars": scalars})
    with zipfile.ZipFile(tmp_path, "a") as archive:
        archive.writestr(_HEADER, header)
    os.replace(tmp_path, path)


def save_model(model, path: str) -> None:
    """Write ``model`` to ``path``. A model fitted over several ranks holds
    the same whole parameters on every rank (lr's class shards and rf's
    tree shards are gathered at the end of their fits): the rank at (0, 0)
    of the mesh writes, the others write nothing."""
    mesh = getattr(model, "mesh", None)
    if mesh is not None and (mesh.data_index != 0 or mesh.model_index != 0):
        return
    write_checkpoint(gather_model(model), path)


def read_checkpoint(path: str) -> tuple[str, dict, dict]:
    """``(kind, arrays, scalars)`` as stored in ``path``."""
    with zipfile.ZipFile(path) as archive:
        header = json.loads(archive.read(_HEADER))
    kind = header["kind"]
    if kind not in ARRAY_DTYPES:
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    with np.load(path) as data:
        arrays = {name: data[name] for name in ARRAY_DTYPES[kind]}
    return kind, arrays, header["scalars"]


def load_model(path: str, device: DeviceLike = None, mesh=None):
    """Load a ``.model`` written by either package; predict-ready (over the
    ranks of ``mesh``, given one)."""
    return model_from_arrays(*read_checkpoint(path), device=device, mesh=mesh)
