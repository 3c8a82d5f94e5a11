"""The compile plane's manifest: the kernel libraries the boot pass
builds, in the order it builds them.

Counterpart of ``learningorchestra_tpu/compile/manifest.py:120``
(``enumerate_programs``) and ``:196`` (``specs_for_artifact``). The
reference's universe is every XLA program a deployment can dispatch
(program kind x shape bucket x dtype x mesh); the port's device programs
are hand-written kernels compiled once per source into five libraries
(``kernels.KERNEL_LIBRARIES``: ``tree_forward``, ``tree_fit``,
``logistic``, ``scaler``, ``tsne``), whatever the shapes, so its
universe is those five. The order keeps the reference's rule, first
request's impact first: the libraries that the published checkpoints in
``models_dir`` need to serve come first (a dt, rf or gb ``.model``
needs ``tree_forward``; an lr or nb forward is ``torch.matmul`` and
needs none), then the rest in the order of ``kernels.KERNEL_LIBRARIES``.
A cap (``LO_AOT_MAX_PROGRAMS``) keeps a prefix and RETURNS the rest as
the drop list, which the caller logs: no silent caps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Optional

from learningorchestra_tpu_torch import kernels

CHECKPOINT_SUFFIX = ".model"   # ml/checkpoint.py's, without importing torch

# a checkpoint's kind -> the libraries its forward launches kernels from
FORWARD_LIBRARIES = {
    "tree_ensemble": ("tree_forward",),   # dt, rf: K6
    "gbt": ("tree_forward",),             # gb: K6
    "logistic": (),                       # torch.matmul
    "naive_bayes": (),                    # torch.matmul
}


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One library the pass builds."""

    library: str

    @property
    def key(self) -> str:
        """The library's name: the span attribute and the identity the
        fleet agrees on (its file name adds its source's digest)."""
        return self.library


def libraries() -> tuple:
    """Every kernel library, in the order of ``kernels.KERNEL_LIBRARIES``."""
    return tuple(dict.fromkeys(kernels.KERNEL_LIBRARIES.values()))


def specs_for_artifact(path: str) -> list:
    """The specs of the libraries a published checkpoint's forward
    needs, read from its ``__model__.json`` header."""
    with zipfile.ZipFile(path) as archive:
        kind = json.loads(archive.read("__model__.json"))["kind"]
    return [ProgramSpec(library) for library in FORWARD_LIBRARIES.get(kind, ())]


def enumerate_programs(models_dir: str = "", max_programs: Optional[int] = None) -> tuple:
    """The (kept, dropped) library universe: the libraries that the
    checkpoints in ``models_dir`` need first, then the rest.
    ``max_programs`` keeps that many and returns the others as the drop
    list, never swallowed."""
    needed: list = []
    if models_dir and os.path.isdir(models_dir):
        for entry in sorted(os.listdir(models_dir)):
            if not entry.endswith(CHECKPOINT_SUFFIX):
                continue
            try:
                derived = specs_for_artifact(os.path.join(models_dir, entry))
            except Exception:  # noqa: BLE001 — a corrupt checkpoint is the serve path's 500
                continue
            needed += [spec for spec in derived if spec not in needed]
    specs = needed + [ProgramSpec(library) for library in libraries() if ProgramSpec(library) not in needed]
    if max_programs is None:
        return specs, []
    return specs[:max_programs], specs[max_programs:]
