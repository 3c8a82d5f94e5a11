"""The ``(data, model)`` grid of ranks.

Counterpart of ``learningorchestra_tpu/parallel/mesh.py:28-66``. The
reference's mesh is a grid of JAX devices; the port's is a grid of
``torch.distributed`` ranks, one process a rank, each with one device
(its own card, or a card that several ranks share over gloo). The ranks
lie in the reference's layout (``devices[:data*model].reshape(data,
model)``): rank ``r`` has data index ``r // model`` and model index
``r % model``.

- A rank's **data group** is the ranks that share its model index. Rows
  are sharded over it: a rank holds one block of them, and the sums that
  cross blocks are all-gathered over this group and added in data-index
  order (``parallel/multihost.all_sum``), so every rank holds the same
  bits.
- Its **model group** is the ranks that share its data index: they hold
  the same block of rows, and lr's classes and rf's trees are sharded
  over them (``multihost.model_all_gather``, ``model_all_sum``).

A one-process run gets a 1×1 mesh with no process group: the estimators
then take their single-device paths, with no padding and no collective.
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
    """``shape``: ``{"data": D, "model": M}``; ``data_index`` and
    ``model_index``: this rank's coordinates (its block of rows, its shard
    of classes or trees); ``group``: the data group's process group, None
    for a data axis of 1; ``model_group``: the model group's, None for a
    model axis of 1; ``device``: this rank's device."""

    shape: dict
    data_index: int
    group: Optional[Any]
    device: torch.device
    model_index: int = 0
    model_group: Optional[Any] = None


def _world() -> tuple[int, int]:
    """``(world size, rank)`` of the initialized process group, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def grid(data: int, model: int) -> list[list[int]]:
    """The ranks of a ``data x model`` mesh, row ``d`` the model group of
    data index ``d`` (the reference's ``reshape(data, model)`` of ranks
    ``0 .. data*model - 1``); column ``m`` is a data group."""
    return [[d * model + m for m in range(model)] for d in range(data)]


# process groups made so far, by the world's group and their ranks: every
# rank makes the same meshes in the same order, so every rank finds the
# same groups here, and the collective that makes one runs once
_GROUPS: dict = {}


def _groups(layout: list[list[int]], world: int) -> tuple[list, list]:
    """Every model group (a row of ``layout``) and every data group (a
    column), in that order, each made once. ``new_group`` is a collective
    of every rank of the world, members or not: every rank makes every
    group, in one fixed order, or the ranks hang. A group of the whole
    world is the world's own; a group of one rank is None."""
    import torch.distributed as dist

    def group(ranks: list[int]):
        if len(ranks) == 1:
            return None
        if len(ranks) == world:
            return dist.group.WORLD
        key = (id(dist.group.WORLD), tuple(ranks))
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(ranks)
        return _GROUPS[key]

    model_groups = [group(row) for row in layout]
    data_groups = [group([row[m] for row in layout]) for m in range(len(layout[0]))]
    return data_groups, model_groups


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
    rank of the world calls this with the same arguments: a group of a
    subset of the ranks is made by a collective call.
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
    size = data * model
    if ranks[:size] != list(range(size)) or size > world:
        raise ValueError(
            f"the mesh takes ranks 0..{size - 1} of the process group in rank order "
            f"(ranks {ranks[:size]}, world size {world})"
        )
    layout = grid(data, model)
    data_groups, model_groups = ([None] * model, [None] * data) if world == 1 else _groups(
        layout, world)
    if rank >= size:
        raise ValueError(f"rank {rank} is not on the mesh's {size} ranks")
    data_index, model_index = divmod(rank, model)
    return Mesh(
        shape={DATA_AXIS: data, MODEL_AXIS: model},
        data_index=data_index,
        group=data_groups[model_index],
        device=resolve_device(device),
        model_index=model_index,
        model_group=model_groups[data_index],
    )


def default_mesh(device: DeviceLike = None) -> Mesh:
    """All ranks on the ``data`` axis."""
    return make_mesh(device=device)


def data_size(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


def model_size(mesh: Mesh) -> int:
    return mesh.shape[MODEL_AXIS]


def over_ranks(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` spreads rows over a data axis of several ranks
    (else a caller takes its single-device path)."""
    return mesh is not None and mesh.shape[DATA_AXIS] > 1


def over_model(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` has a model axis of several ranks (lr's classes and
    rf's trees may then be sharded over its model group)."""
    return mesh is not None and mesh.shape[MODEL_AXIS] > 1
