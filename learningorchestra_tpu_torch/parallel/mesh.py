"""The ``(data, model)`` grid of ranks.

Counterpart of ``learningorchestra_tpu/parallel/mesh.py:28-66``. The
reference's mesh is a grid of JAX devices; the port's is a grid of
``torch.distributed`` ranks, one process a rank, each with one device
(its own card, or a card that several ranks share over gloo). Rows are
sharded over the ``data`` axis; a rank holds one block of them, and the
sums that cross blocks are all-gathered over the data axis's process group
and added in rank order (``parallel/multihost.all_sum``), so every rank
holds the same bits.

A one-process run gets a 1×1 mesh with no process group: the estimators
then take their single-device paths, with no padding and no collective.
The ``model`` axis (lr classes, rf trees over a model group) is not
ported: ``model > 1`` raises (ROADMAP Queue 1 item 6c).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True, eq=False)
class Mesh:
    """``shape``: ``{"data": D, "model": M}``; ``data_index``: this rank's
    coordinate on the data axis (the block of rows it holds);
    ``group``: the data axis's process group, None for a data axis of 1;
    ``device``: this rank's device."""

    shape: dict
    data_index: int
    group: Optional[Any]
    device: torch.device


def _world() -> tuple[int, int]:
    """``(world size, rank)`` of the initialized process group, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> Mesh:
    """Build a ``(data, model)`` mesh over the ranks ``devices`` (default:
    every rank of the initialized process group, in rank order).

    ``data=None`` takes every remaining rank after ``model`` is carved
    out. The shape checks and their messages are the reference's.
    ``device`` is this rank's device (CUDA unless asked for the CPU). Every
    rank calls this with the same arguments: a data axis over a subset of
    the ranks makes a process group, which is a collective call.
    """
    world, rank = _world()
    ranks = list(devices if devices is not None else range(world))
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if data is None:
        if len(ranks) % model:
            raise ValueError(f"{len(ranks)} devices not divisible by model={model}")
        data = len(ranks) // model
    if data * model > len(ranks):
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have {len(ranks)}"
        )
    if model > 1:
        raise NotImplementedError(
            "a model axis (model > 1: lr classes, rf trees over a model group) is not "
            "ported yet: ROADMAP Queue 1 item 6c"
        )
    grid = ranks[:data]
    if grid != list(range(data)) or data > world:
        raise ValueError(
            f"the data axis takes ranks 0..{data - 1} of the process group in rank order "
            f"(ranks {grid}, world size {world})"
        )
    if rank not in grid:
        raise ValueError(f"rank {rank} is not on the mesh's {data} data ranks")
    group = None
    if data > 1:
        import torch.distributed as dist

        group = dist.group.WORLD if data == world else dist.new_group(grid)
    return Mesh(
        shape={DATA_AXIS: data, MODEL_AXIS: model},
        data_index=grid.index(rank),
        group=group,
        device=resolve_device(device),
    )


def default_mesh(device: DeviceLike = None) -> Mesh:
    """All ranks on the ``data`` axis."""
    return make_mesh(device=device)


def data_size(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


def over_ranks(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` spreads rows over a data axis of several ranks
    (else a caller takes its single-device path)."""
    return mesh is not None and mesh.shape[DATA_AXIS] > 1


def model_size(mesh: Mesh) -> int:
    return mesh.shape[MODEL_AXIS]
