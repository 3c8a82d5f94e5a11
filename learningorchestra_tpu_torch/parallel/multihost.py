"""Several processes: bootstrap, per-host feeding, the gather, rank-ordered sums.

Counterpart of ``learningorchestra_tpu/parallel/multihost.py:64-193``. The
reference joins hosts into one JAX runtime and lets XLA route the data
axis's collectives; the port runs one process a rank over
``torch.distributed`` and calls its collectives by hand:

- :func:`initialize_from_env` — join the process group named by
  ``LO_COORDINATOR`` (host:port), ``LO_NUM_PROCESSES`` and
  ``LO_PROCESS_ID``: NCCL on a CUDA device, gloo on the CPU. ``backend=``
  lets ranks that share one card take gloo; nothing picks it unasked.
- :func:`host_row_range` / :func:`shard_rows_local` — per-host feeding:
  each rank loads ONLY its block's rows of the dataset, and no process ever
  holds the full matrix.
- :func:`fetch` — every rank's block gathered, so that each rank holds the
  same global numpy array (the ``collect()`` analogue); :func:`gather_rows`
  the same for a tensor of each rank's ``host_row_range`` rows, left on
  the device.
- :func:`all_sum` — the sums that cross the data axis (a fit's float64
  partial sums, the confusion counts): gathered from every rank of the
  data group and added in rank order in float64, so that every rank holds
  the same bits and a run repeats them. No all-reduce: its order of
  addition is the library's.
- :func:`model_all_gather` / :func:`model_all_sum` — their counterparts
  on the model group (the ranks that share this rank's block of rows: lr's
  class shards, rf's tree shards), in model-rank order, the sums in
  float64.

Gloo on CUDA tensors: the collectives take them as they are. Where the
installed gloo refuses them, :func:`stage_through_host` makes every
collective of this process copy its tensors to the host and back.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from learningorchestra_tpu_torch.parallel.sharding import padded_row_count, to_device
from learningorchestra_tpu_torch.telemetry import profile as _profile

_ENV_COORDINATOR = "LO_COORDINATOR"
_ENV_NUM_PROCESSES = "LO_NUM_PROCESSES"
_ENV_PROCESS_ID = "LO_PROCESS_ID"

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 300.0

_state = {"host_staging": False, "collective_s": 0.0, "collectives": 0,
          "model_collective_s": 0.0, "model_collectives": 0}
_state_lock = threading.Lock()


def initialize_from_env(
    backend: Optional[str] = None,
    device: DeviceLike = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the process group if the environment asks for one.

    Reads ``LO_COORDINATOR`` (host:port), ``LO_NUM_PROCESSES`` and
    ``LO_PROCESS_ID``; when all are present, calls
    ``torch.distributed.init_process_group`` over ``tcp://<coordinator>``
    with an explicit ``timeout``. ``backend=None`` takes NCCL when
    ``device`` (default: CUDA) is a CUDA device, which it makes the current
    one, and gloo on the CPU. Idempotent; returns True when more than one
    process runs.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = os.environ.get(_ENV_COORDINATOR)
    num_processes = os.environ.get(_ENV_NUM_PROCESSES)
    process_id = os.environ.get(_ENV_PROCESS_ID)
    if not (coordinator and num_processes and process_id):
        return False
    resolved = resolve_device(device)
    if resolved.type == "cuda":
        torch.cuda.set_device(resolved)
    if backend is None:
        backend = "nccl" if resolved.type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dist.get_world_size() > 1


def stage_through_host(on: bool = True) -> None:
    """Make this process's collectives copy CUDA tensors to the host and
    back (for a gloo that refuses CUDA tensors)."""
    with _state_lock:
        _state["host_staging"] = bool(on)


def stage_if_refused(device: DeviceLike = None) -> Optional[str]:
    """Under gloo over several ranks on a CUDA ``device``: one
    ``all_gather`` of a CUDA tensor, and where this gloo refuses it,
    :func:`stage_through_host` for every later collective. Returns the
    first line of the refusal (None: staged nothing). A collective: every
    rank of the world calls it at the same point."""
    import torch.distributed as dist

    device = resolve_device(device)
    if device.type != "cuda" or dist.get_backend() != "gloo" or dist.get_world_size() == 1:
        return None
    parts = [torch.empty(2, device=device) for _ in range(dist.get_world_size())]
    try:
        dist.all_gather(parts, torch.full((2,), float(dist.get_rank()), device=device))
    except RuntimeError as error:
        stage_through_host(True)
        return str(error).splitlines()[0][:200]
    return None


def collective_stats() -> dict:
    """``{"host_staging", "collective_s", "collectives", "model_collective_s",
    "model_collectives"}``: host seconds spent in this process's collective
    calls and their count, on the data group and on the model group apart."""
    with _state_lock:
        return dict(_state)


def reset_collective_stats() -> None:
    with _state_lock:
        _state["collective_s"], _state["collectives"] = 0.0, 0
        _state["model_collective_s"], _state["model_collectives"] = 0.0, 0


def _gather(tensor: torch.Tensor, group, size: int, axis: str) -> list:
    """Every rank's ``tensor`` of ``group`` (``size`` ranks, equal shapes),
    in group-rank order, on this rank's device; its time and count booked
    under ``axis``. No group gives ``[tensor]`` with no collective."""
    import torch.distributed as dist

    if group is None:
        return [tensor]
    staged = _state["host_staging"] and tensor.device.type == "cuda"
    local = tensor.contiguous()
    if staged:
        local = local.cpu()
        _profile.account_d2h(local.numel() * local.element_size())
    parts = [torch.empty_like(local) for _ in range(size)]
    started = time.perf_counter()
    dist.all_gather(parts, local, group=group)
    prefix = "" if axis == DATA_AXIS else "model_"
    with _state_lock:
        _state[prefix + "collective_s"] += time.perf_counter() - started
        _state[prefix + "collectives"] += 1
    return [part.to(tensor.device) for part in parts] if staged else parts


def _rank_order_sum(parts: list) -> torch.Tensor:
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def all_gather(tensor: torch.Tensor, mesh: Mesh) -> list:
    """Every data rank's ``tensor`` (equal shapes), in rank order, on this
    rank's device. A data axis of 1 gives ``[tensor]`` with no collective."""
    return _gather(tensor, mesh.group, mesh.shape[DATA_AXIS], DATA_AXIS)


def all_sum(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every data rank's ``tensor``, added in rank order (the
    same bits on every rank). A data axis of 1 returns ``tensor``."""
    return _rank_order_sum(all_gather(tensor, mesh))


def model_all_gather(tensor: torch.Tensor, mesh: Mesh) -> list:
    """Every model rank's ``tensor`` (equal shapes) of this rank's model
    group, in model-rank order. A model axis of 1 gives ``[tensor]``."""
    return _gather(tensor, mesh.model_group, mesh.shape[MODEL_AXIS], MODEL_AXIS)


def model_all_sum(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over this rank's model group of ``tensor`` taken in float64,
    added in model-rank order: float64, the same bits on every rank of
    the group. A model axis of 1 returns ``tensor`` in float64."""
    return _rank_order_sum(model_all_gather(tensor.to(torch.float64), mesh))


def _block(n_rows: int, mesh: Mesh) -> int:
    data = mesh.shape[DATA_AXIS]
    return padded_row_count(n_rows, data) // data


def host_row_range(n_rows: int, mesh: Mesh) -> tuple[int, int]:
    """Global row range this rank must feed for an ``n_rows`` dataset
    row-sharded over ``mesh``'s data axis: its data index's block of the
    padded row space (the reference's block rule), clamped to ``n_rows``;
    the ranks of one model group feed the same block. Padding rows are
    made by :func:`shard_rows_local`, never loaded."""
    block = _block(n_rows, mesh)
    index = mesh.data_index
    return min(index * block, n_rows), min((index + 1) * block, n_rows)


def shard_rows_local(
    local_rows: np.ndarray, mesh: Mesh, n_rows: int, dtype=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's block from its own slice of the dataset.

    ``local_rows`` must be exactly the ``host_row_range(n_rows, mesh)``
    slice. It is padded to the block and returned with its validity mask,
    on this rank's device: the same block and mask as
    ``sharding.shard_rows`` gives from the full array.
    """
    local_rows = np.asarray(local_rows)
    if dtype is not None:
        local_rows = local_rows.astype(dtype)
    start, stop = host_row_range(n_rows, mesh)
    if len(local_rows) != stop - start:
        raise ValueError(
            f"expected rows [{start}, {stop}) = {stop - start} rows, "
            f"got {len(local_rows)}"
        )
    block = _block(n_rows, mesh)
    pad = block - len(local_rows)
    local_mask = np.zeros(block, dtype=bool)
    local_mask[: len(local_rows)] = True
    if pad:
        pad_width = [(0, pad)] + [(0, 0)] * (local_rows.ndim - 1)
        local_rows = np.pad(local_rows, pad_width)
    return to_device(local_rows, mesh.device), to_device(local_mask, mesh.device)


def gather_rows(rows: torch.Tensor, n_rows: int, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``host_row_range(n_rows, mesh)`` rows of an
    ``(n_rows, ...)`` tensor, gathered in rank order: the whole tensor on
    every rank's device. Each rank's rows are padded to the block for the
    collective only."""
    block = _block(n_rows, mesh)
    padded = rows.new_zeros((block, *rows.shape[1:]))
    padded[: rows.shape[0]] = rows
    return torch.cat(all_gather(padded, mesh))[:n_rows]


def fetch(tensor: torch.Tensor, mesh: Mesh, mask: Optional[torch.Tensor] = None) -> np.ndarray:
    """The global numpy array of a row-sharded tensor, the same on every
    rank: every rank's block gathered in rank order, then, given this
    rank's validity ``mask``, only the real rows. On a data axis of 1 it is
    a plain ``.cpu().numpy()`` (of the real rows, given a mask)."""
    from learningorchestra_tpu_torch.ml.base import to_host

    parts = all_gather(tensor, mesh)
    if mask is not None:
        masks = all_gather(mask, mesh)
        parts = [part[keep] for part, keep in zip(parts, masks)]
    return to_host(torch.cat(parts) if len(parts) > 1 else parts[0])
