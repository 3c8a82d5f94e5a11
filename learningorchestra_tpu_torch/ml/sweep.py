"""Batched-fit entry points: many fits as ONE dispatch over a job axis.

Counterpart of ``learningorchestra_tpu/ml/sweep.py``, less ``run_sweep``
(the ``POST /models/sweep`` flow, which comes with the builder). Two
workloads share this machinery:

- **Hyperparameter sweeps**: a λ grid over logistic regression or a
  depth grid over a decision tree, fitted as one program over the grid
  axis with per-point metrics.
- **Job coalescing** (sched/coalesce.py): a flood of small
  single-classifier builds from many users fuses into one dispatch —
  every member's (X, y, λ) tuple becomes one more slot on the same job
  axis a sweep uses for its grid points.

Where the reference ``vmap``s its solo programs over the job axis, the
port writes the axis out (``torch.func.vmap`` cannot pass through the
ctypes launches): the hand-written kernels take it as a grid dimension —
K7 (``ml/logistic.py job_loss_and_grad``, ``job_trial_losses``, with the
rows' validity mask as a weight), K1 (``ml/binning.py job_apply_bins``,
or ``apply_bins`` once where a program's slots share one member's X),
K2-K5 (``ml/trees.py``: the tree axis with each job's own bins) and K6
(``ml/trees.py job_ensemble_forward``) — one launch for the whole group a
level or an iteration, and the L-BFGS bookkeeping around K7 is torch ops
on ``(J, ...)`` tensors.

The job axis pads to the shared quarter-octave shape grid
(utils/shapegrid.py) with a fixed floor; one card has no data axis to
align it to. Dummy slots replicate slot 0 rather than holding zeros (an
all-zero member would drive 0/0 NaNs through its slots).

Reproducibility contract (the coalescer's acceptance bar): a job's
results depend only on its own inputs. Every per-job sum in the kernels
takes that job's rows alone, in a fixed order, with no float atomics, and
the torch ops around them reduce within a job; two dispatches padded to
the SAME job-axis width run the same ops on the same shapes. So a job
fused into a batch of N is bit-identical to the same job run alone
whenever both land on one grid value (which the fixed pad floor
guarantees for small batches). Batched fits run their full iteration
budget — the solo path's plateau early-exit is per-member host control
flow that would make one member's stopping point depend on its
neighbours'.

A chunk whose slots are all one member's (a one-member sweep) reads that
member's rows once, at a job stride of 0, instead of a stacked copy per
slot; that changes no bit, only the bytes copied to the card. The lr
evaluation stacks its rows all the same, so that its batched product has
one shape whatever the chunk holds.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.ml import logistic, trees
from learningorchestra_tpu_torch.ml.base import infer_num_classes, segment_steps
from learningorchestra_tpu_torch.ml.binning import MAX_BINS, apply_bins, job_apply_bins, make_thresholds
from learningorchestra_tpu_torch.ml.evaluation import job_masked_metrics
from learningorchestra_tpu_torch.ml.logistic import (
    _ARMIJO_C1,
    _BACKTRACK_STEPS,
    _LBFGS_MEMORY,
    _LR_ROW_ITERS_BUDGET,
    scaler_stats,
)
from learningorchestra_tpu_torch.parallel.sharding import pad_rows
from learningorchestra_tpu_torch.sched.cancel import check_cancelled
from learningorchestra_tpu_torch.telemetry import tracing as _tracing
from learningorchestra_tpu_torch.utils.shapegrid import grid_size, padded_indices

SWEEP_CLASSIFIERS = ("lr", "dt")

# Fused job axes pad to grid_size(n, floor=_JOB_PAD_FLOOR). The floor is
# the MicroBatcher trick at job granularity: every batch of <= 8 jobs runs
# the one 8-slot shape (bit-reproducible across batch sizes), larger
# batches ride the quarter-octave grid.
_JOB_PAD_FLOOR = 8

# One fused dispatch's job axis is capped so a large grid over a large
# dataset cannot demand (points x rows x features) device memory at once;
# grids past the cap chain through several fused dispatches.
_MAX_FUSED_SLICES = 128

# Grids past this are a misuse of the synchronous sweep route, not a
# bigger batch (the job axis multiplies every member's arrays).
MAX_GRID_POINTS = 1024

_DEFAULT_MAX_ITER = 100  # MLlib maxIter default, like the solo LR path

# The fused programs (K14 a-c): each call counts one, so that a run can
# show how many dispatches its path made.
PROGRAM_NAMES = ("lr_fused_segment", "lr_fused_eval", "dt_fused")
_program_calls = {name: 0 for name in PROGRAM_NAMES}
_program_lock = threading.Lock()


def _count_program(name: str) -> None:
    with _program_lock:
        _program_calls[name] += 1


def program_calls() -> dict:
    with _program_lock:
        return dict(_program_calls)


def reset_program_calls() -> None:
    with _program_lock:
        for name in _program_calls:
            _program_calls[name] = 0


# --------------------------------------------------------------------------
# Grid validation (the route's 406 surface)
# --------------------------------------------------------------------------

def validate_grid(kind: str, grid) -> list[dict]:
    """Normalize a sweep grid or raise ``ValueError`` with the offending
    entry. ``lr`` grids sweep ``reg_param`` (λ >= 0); ``dt`` grids sweep
    ``max_depth`` (int in [1, 12] — the tree heap is 2^depth arrays)."""
    if kind not in SWEEP_CLASSIFIERS:
        raise ValueError(
            f"classificator {kind!r} is not sweepable "
            f"(have: {SWEEP_CLASSIFIERS})"
        )
    if not isinstance(grid, list) or not grid:
        raise ValueError("grid must be a non-empty list of points")
    if len(grid) > MAX_GRID_POINTS:
        raise ValueError(
            f"grid has {len(grid)} points (max {MAX_GRID_POINTS})"
        )
    normalized: list[dict] = []
    for entry in grid:
        if not isinstance(entry, dict):
            raise ValueError(f"grid points must be objects, got {entry!r}")
        if kind == "lr":
            value = entry.get("reg_param")
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise ValueError(
                    f"lr grid points need a numeric reg_param, got {entry!r}"
                )
            if not np.isfinite(value) or value < 0:
                raise ValueError(f"reg_param must be finite and >= 0: {entry!r}")
            normalized.append({"reg_param": float(value)})
        else:
            value = entry.get("max_depth")
            if isinstance(value, bool) or not isinstance(value, int):
                raise ValueError(
                    f"dt grid points need an integer max_depth, got {entry!r}"
                )
            if not 1 <= value <= 12:
                raise ValueError(f"max_depth must be in [1, 12]: {entry!r}")
            normalized.append({"max_depth": int(value)})
    return normalized


# --------------------------------------------------------------------------
# Member preparation (host work, BEFORE the device queue)
# --------------------------------------------------------------------------

def prepare_member(
    kind: str,
    X_train: np.ndarray,
    y_train: np.ndarray,
    X_eval: np.ndarray,
    y_eval: np.ndarray,
    grid: list[dict],
    device: DeviceLike = None,
    max_iter: int = _DEFAULT_MAX_ITER,
) -> tuple[tuple, dict]:
    """Host-side prep for one coalescible fit/sweep job: pad + dtype the
    arrays and derive the compatibility ``key`` — everything the fused
    program's shape depends on, so two members with equal keys stack on
    one job axis. Runs on the submitting thread (prep must precede the
    device queue: a leader can only stack payloads that already exist).

    Deliberately does NOT validate finiteness: a NaN-poisoned member
    must fail INSIDE the fused dispatch (alone, neighbours unaffected) —
    that isolation is part of the coalescer's contract and is tested.
    """
    device = resolve_device(device)
    grid = validate_grid(kind, grid)
    if not isinstance(max_iter, int) or max_iter < 1:
        raise ValueError(f"max_iter must be an integer >= 1, got {max_iter!r}")
    X_train = np.asarray(X_train)
    y_train = np.asarray(y_train)
    X_eval = np.asarray(X_eval)
    y_eval = np.asarray(y_eval)
    if X_train.ndim != 2 or X_eval.ndim != 2:
        raise ValueError("feature matrices must be 2-D")
    if X_train.shape[1] != X_eval.shape[1]:
        raise ValueError("train/eval feature widths differ")
    num_classes = max(infer_num_classes(y_train), infer_num_classes(y_eval))
    # one card: no data axis to align the padded rows to
    X_pad, mask = pad_rows(X_train, 1)
    y_pad, _ = pad_rows(y_train, 1)
    Xe_pad, mask_e = pad_rows(X_eval, 1)
    ye_pad, _ = pad_rows(y_eval, 1)
    payload = {
        "kind": kind,
        "grid": grid,
        # scanned HERE on the submitting thread (parallel across
        # requests), verdict carried to the fused dispatch where the
        # member fails ALONE (run_group)
        "finite": bool(
            np.isfinite(X_train).all() and np.isfinite(X_eval).all()
        ),
        "X": X_pad.astype(np.float32),
        "y": y_pad.astype(np.int32),
        "mask": mask.astype(np.float32),
        "X_eval": Xe_pad.astype(np.float32),
        "y_eval": ye_pad.astype(np.int32),
        "mask_eval": mask_e.astype(np.float32),
        "rows": int(len(X_train)),
        "num_classes": num_classes,
        "max_iter": int(max_iter),
    }
    if kind == "lr":
        # the solo fit's scaler recipe (logistic.scaler_stats, shared so
        # the paths cannot drift) — λ never changes it, so it is
        # per-member, not per-point
        mean, scale = scaler_stats(X_train)
        payload["mean"] = mean.astype(np.float32)
        payload["scale"] = scale.astype(np.float32)
    else:
        payload["thresholds"] = make_thresholds(X_train, MAX_BINS).astype(
            np.float32
        )
    key = (
        "sweep",
        kind,
        int(X_pad.shape[0]),
        int(Xe_pad.shape[0]),
        int(X_pad.shape[1]),
        num_classes,
        int(max_iter) if kind == "lr" else MAX_BINS,
        "f32",
        _device_signature(device),
    )
    return key, payload


def _device_signature(device: torch.device) -> tuple:
    """The device part of a member's key (the reference's mesh
    signature): members fuse only onto the card their payloads were
    prepared for."""
    return (device.type, device.index)


# --------------------------------------------------------------------------
# The fused programs: batched L-BFGS around K7
# --------------------------------------------------------------------------

def _leaf(alpha, like):
    """A ``(J,)`` per-job scalar shaped to broadcast against ``like``."""
    return alpha.view((-1,) + (1,) * (like.dim() - 1))


def _job_dot(a, b):
    """The reference's pytree inner product, one per job: ``vdot(b) +
    vdot(w)`` over each job's leaves, a ``(J,)`` float32 tensor."""
    return (a["b"] * b["b"]).sum(dim=-1) + (a["w"] * b["w"]).sum(dim=(-2, -1))


def _job_axpy(alpha, x, y):
    """``y + alpha * x`` leaf-wise, ``alpha`` one scalar a job."""
    return {key: y[key] + _leaf(alpha, y[key]) * x[key] for key in ("w", "b")}


def _job_lbfgs_state(W, b):
    """The solo fit's optimizer state (``logistic._lbfgs_state``) with a
    leading job axis: ``(J, m, ...)`` ring buffers, ``(J,)`` ``head``,
    ``filled`` and ``value``."""
    jobs, m = W.shape[0], _LBFGS_MEMORY

    def history():
        return {
            "w": W.new_zeros((jobs, m) + tuple(W.shape[1:])),
            "b": b.new_zeros((jobs, m) + tuple(b.shape[1:])),
        }

    return {
        "S": history(),
        "Y": history(),
        "rho": W.new_zeros((jobs, m)),
        "head": torch.zeros(jobs, dtype=torch.int32, device=W.device),
        "filled": torch.zeros(jobs, dtype=torch.int32, device=W.device),
        "value": W.new_zeros(jobs),
        "grad": {"w": torch.zeros_like(W), "b": torch.zeros_like(b)},
    }


def _job_two_loop(state):
    """Each job's search direction ``-H g`` by the two-loop recursion over
    its ring buffers, newest pair first (``logistic._two_loop`` with a job
    axis): each job's ring is read in its own newest-first order with one
    gather a buffer."""
    m = _LBFGS_MEMORY
    jobs = state["rho"].shape[0]
    steps = torch.arange(m, device=state["rho"].device)
    order = torch.remainder(state["head"][:, None] - 1 - steps[None], m).long()
    valid = (steps[None] < state["filled"][:, None]).to(torch.float32)
    job = torch.arange(jobs, device=order.device)[:, None]
    S = {key: state["S"][key][job, order] for key in ("w", "b")}
    Y = {key: state["Y"][key][job, order] for key in ("w", "b")}
    rho = state["rho"].gather(1, order)

    def at(history, k):
        return {key: history[key][:, k] for key in ("w", "b")}

    q = state["grad"]
    alphas = []
    for k in range(m):
        alpha = valid[:, k] * rho[:, k] * _job_dot(at(S, k), q)
        q = _job_axpy(-alpha, at(Y, k), q)
        alphas.append(alpha)
    s_new, y_new = at(S, 0), at(Y, 0)
    y_dot = _job_dot(y_new, y_new)
    gamma = torch.where(
        (state["filled"] > 0) & (y_dot > 0.0),
        _job_dot(s_new, y_new) / torch.clamp(y_dot, min=1e-20),
        1.0,
    )
    r = {key: _leaf(gamma, value) * value for key, value in q.items()}
    for k in range(m - 1, -1, -1):
        beta = valid[:, k] * rho[:, k] * _job_dot(at(Y, k), r)
        r = _job_axpy(alphas[k] - beta, at(S, k), r)
    return {key: -value for key, value in r.items()}


def _lr_fused_segment(W, b, state, X, y, mask, l2s, iters: int):
    """``iters`` L-BFGS iterations for EVERY job of the axis (reference
    ``:237``, the solo segment under ``vmap``): the solo segment's seed
    pass, descent safeguard, Armijo choice and ring writes, each per job,
    with K7 over the job axis (two launches an iteration, one a segment's
    seed, for the whole group). ``W (J, F, C)``, ``b (J, C)``, ``l2s
    (J,)``; X, y and the row mask shared or stacked (see
    ``logistic.job_loss_and_grad``). Returns ``(W, b, state, losses)``,
    the losses ``(J, iters)`` pre-step values, all on the device."""
    _count_program("lr_fused_segment")
    x = {"w": W, "b": b}
    value, dW, db = logistic.job_loss_and_grad(W, b, X, y, mask, l2s)
    state = {**state, "value": value, "grad": {"w": dW, "b": db}}
    # the trial steps 1, 1/2, 1/4, 1/8, made on the device
    steps = torch.full((_BACKTRACK_STEPS,), 0.5, device=W.device).cumprod(0) * 2.0
    floor = 1.0 / (1 << _BACKTRACK_STEPS)
    m = _LBFGS_MEMORY
    slots = torch.arange(m, device=W.device)
    losses = []
    for _ in range(iters):
        value, grad = state["value"], state["grad"]
        direction = _job_two_loop(state)
        slope = _job_dot(grad, direction)
        # a non-descent direction (stale curvature) falls back to steepest descent
        descent = slope < 0.0
        direction = {
            key: torch.where(_leaf(descent, direction[key]), direction[key], -grad[key])
            for key in ("w", "b")
        }
        slope = torch.where(descent, slope, -_job_dot(grad, grad))

        trial = logistic.job_trial_losses(
            x["w"][:, None] + steps[None, :, None, None] * direction["w"][:, None],
            x["b"][:, None] + steps[None, :, None] * direction["b"][:, None],
            X, y, mask, l2s,
        )
        ok = trial <= value[:, None] + (_ARMIJO_C1 * steps)[None] * slope[:, None]
        first = ok & (torch.cumsum(ok.to(torch.int32), 1) == 1)
        accepted = torch.where(ok.any(dim=1), (steps[None] * first).sum(dim=1), floor)
        x_new = _job_axpy(accepted, direction, x)
        value_new, dW, db = logistic.job_loss_and_grad(x_new["w"], x_new["b"], X, y, mask, l2s)
        grad_new = {"w": dW, "b": db}

        # curvature pair; skipped where s.y is not positive
        s = {key: x_new[key] - x[key] for key in ("w", "b")}
        y_vec = {key: grad_new[key] - grad[key] for key in ("w", "b")}
        sy = _job_dot(s, y_vec)
        keep = sy > 1e-10
        head = state["head"]
        write = keep[:, None] & (slots[None] == head[:, None])

        def ring_write(history, pair):
            return {
                key: torch.where(
                    write.view(write.shape + (1,) * (pair[key].dim() - 1)),
                    pair[key][:, None],
                    history[key],
                )
                for key in ("w", "b")
            }

        state = {
            **state,
            "S": ring_write(state["S"], s),
            "Y": ring_write(state["Y"], y_vec),
            "rho": torch.where(write, (1.0 / torch.clamp(sy, min=1e-20))[:, None], state["rho"]),
            "head": torch.where(keep, torch.remainder(head + 1, m), head),
            "filled": torch.where(keep, torch.clamp(state["filled"] + 1, max=m), state["filled"]),
            "value": value_new,
            "grad": grad_new,
        }
        x = x_new
        losses.append(value)
    if not losses:
        return x["w"], x["b"], state, W.new_zeros((W.shape[0], 0))
    return x["w"], x["b"], state, torch.stack(losses, dim=1)


def _lr_fused_eval(W, b, Xe, means, scales, ye, masks_e, num_classes: int):
    """Every job's forward and on-device confusion metrics (reference
    ``:249``): each slot's eval rows ``Xe (J, rows, F)`` standardized with
    its member's float32 mean and scale, ``X @ W + b`` as one batched
    ``torch.matmul`` (K8's product, in full float32), the first maximum of
    the logits as the label (the reference's ``argmax(logits)``; the
    softmax it also returns is not needed for a label), and
    :func:`job_masked_metrics`. Returns ``(accuracy, weighted_f1)``, each
    ``(J,)``."""
    _count_program("lr_fused_eval")
    X_std = (Xe - means[:, None, :]) / scales[:, None, :]
    logits = torch.matmul(X_std, W) + b[:, None, :]
    return job_masked_metrics(ye, logits.argmax(dim=2), masks_e, num_classes)


def _job_heap_thresholds(features_heap, bins_heap, thresholds):
    """Float threshold per internal node of each job's tree:
    ``thresholds[j, f, b]`` (``trees._heap_thresholds`` with a job axis),
    or ``thresholds[f, b]`` of one table ``(F, B-1)`` the jobs share."""
    if thresholds.dim() == 2:
        return trees._heap_thresholds(features_heap, bins_heap, thresholds)
    job = torch.arange(features_heap.shape[0], device=features_heap.device)[:, None]
    safe_feature = features_heap.clamp(min=0).long()
    safe_bin = bins_heap.clamp(max=thresholds.shape[-1] - 1).long()
    return thresholds[job, safe_feature, safe_bin]


def _dt_fused(Xs, ys, ws, thresholds, Xe, ye, we, num_classes: int, max_depth: int, max_bins: int):
    """Bin, grow and evaluate one decision tree PER JOB (reference
    ``:263``): K1 over the job axis, then the level loop of
    ``trees._fit_classification_tree`` with the jobs on its tree axis (K2
    and K4 over each job's own bins, K3 on the jobs' nodes flattened, K5),
    the heaps' float thresholds per job, K6 over the job axis on each
    job's eval rows, the first-maximum label and the metrics. Xs and Xe
    shared or stacked; ys, ws ``(J, rows)``; thresholds ``(J, F, B-1)``,
    or one shared ``(F, B-1)`` with a shared Xs: then K1 bins the rows once
    and the jobs grow over those bins, as a forest's trees do (K2 and K4
    read them once for a group of jobs), with the bits of the stacked
    path. Depth is a shape of the program, so a depth grid runs one per
    depth. Returns the heaps ``(J, 2^D - 1)``, leaf probabilities ``(J,
    2^D, C)`` and the ``(J,)`` metrics."""
    _count_program("dt_fused")
    if thresholds.dim() == 2 and Xs.dim() == 2:
        bins = apply_bins(Xs, thresholds)
    else:
        bins = job_apply_bins(Xs, thresholds)
    one_hot = torch.nn.functional.one_hot(ys.long(), num_classes).to(torch.float32)
    # the weights are the slots' 0/1 row masks: integer channels (K2's counts)
    features_heap, bins_heap, leaf_probs = trees._fit_classification_tree(
        bins, one_hot * ws[..., None], max_depth, max_bins, integer=True
    )
    thresholds_heap = _job_heap_thresholds(features_heap, bins_heap, thresholds)
    probs = trees.job_ensemble_forward(
        Xe, features_heap[:, None], thresholds_heap[:, None], leaf_probs[:, None], max_depth
    )
    accuracy, weighted_f1 = job_masked_metrics(ye, probs.argmax(dim=2), we, num_classes)
    return features_heap, thresholds_heap, leaf_probs, accuracy, weighted_f1


def _job_axis(n: int) -> int:
    """Padded slot count of a fused job axis: the grid with its floor."""
    return grid_size(n, _JOB_PAD_FLOOR)


def _stack(arrays: dict, members: list[int]) -> torch.Tensor:
    """One device tensor a slot, stacked along a new job axis (callers
    build the padded slot list via ``padded_indices``: dummy slots
    replicate slot 0)."""
    return torch.stack([arrays[m] for m in members])


def _slot_rows(arrays: dict, members: list[int]) -> torch.Tensor:
    """The slots' rows (or thresholds): the one member's, shared (a job
    stride of 0), when every slot is that member's, else stacked."""
    if len(set(members)) == 1:
        return arrays[members[0]]
    return _stack(arrays, members)


def _uploaded(payloads, members, name: str, device) -> dict:
    """Each distinct member's host array ``name`` on the device, once."""
    return {
        m: torch.from_numpy(np.ascontiguousarray(payloads[m][name])).to(device)
        for m in dict.fromkeys(members)
    }


# --------------------------------------------------------------------------
# The group runner (executed ONCE per fused batch by the coalescer leader)
# --------------------------------------------------------------------------

def group_runner(device: DeviceLike = None):
    """The coalescer's runner for sweep/fit members: ``(payloads) ->
    [outcome, ...]`` with the per-member isolation contract from
    sched/coalesce.py (an outcome is ``("ok", result)`` or
    ``("error", exception)``)."""
    device = resolve_device(device)

    def run(payloads: list) -> list:
        return run_group(payloads, device)

    return run


def run_group(payloads: list, device: DeviceLike = None) -> list:
    device = resolve_device(device)
    outcomes: list = [None] * len(payloads)
    live: list[int] = []
    for index, payload in enumerate(payloads):
        # per-member validation verdict (computed at prepare_member on
        # the submitting thread): a poisoned member fails ALONE — NaN
        # features would otherwise silently NaN its fitted params
        if not payload.get("finite", True):
            outcomes[index] = (
                "error",
                ValueError(
                    "non-finite features in coalesced member "
                    f"{index} — member failed, neighbors unaffected"
                ),
            )
        else:
            live.append(index)
    if not live:
        return outcomes
    kind = payloads[live[0]]["kind"]
    # one flat slot list: (member, point) pairs — a 100-λ sweep is one
    # member with 100 slots, 64 coalesced small builds are 64 members
    # with one slot each; the fused program cannot tell the difference
    slices = [
        (member, point)
        for member in live
        for point in range(len(payloads[member]["grid"]))
    ]
    per_point: dict[tuple[int, int], dict] = {}
    for start in range(0, len(slices), _MAX_FUSED_SLICES):
        chunk = slices[start : start + _MAX_FUSED_SLICES]
        if kind == "lr":
            _run_lr_chunk(payloads, chunk, per_point, device)
        else:
            _run_dt_chunk(payloads, chunk, per_point, device)
        if len(payloads) == 1:
            # chunk boundary of a single-member (big-grid) sweep: the
            # executing leader IS that member, so its DELETE aborts
            # cleanly between fused programs. With multiple members
            # fused, the batch runs to completion instead — an abort
            # here would fail the leader's NEIGHBORS for the leader's
            # cancellation (the ambient token is the leader's)
            check_cancelled()
    for member in live:
        payload = payloads[member]
        points = []
        for point in range(len(payload["grid"])):
            entry = per_point[(member, point)]
            points.append({**entry, "grid": payload["grid"][point]})
        accuracies = [p["accuracy"] for p in points]
        best = int(np.argmax(accuracies))
        outcomes[member] = (
            "ok",
            {
                "kind": kind,
                "points": [
                    {
                        "grid": p["grid"],
                        "accuracy": p["accuracy"],
                        "weighted_f1": p["weighted_f1"],
                    }
                    for p in points
                ],
                "params": [p["params"] for p in points],
                "best": best,
                "_attribution": {
                    "rows": payload["rows"],
                    "bytes": int(
                        payload["X"].nbytes + payload["X_eval"].nbytes
                    ),
                    "points": len(points),
                },
            },
        )
    return outcomes


def _run_lr_chunk(payloads, chunk, per_point, device) -> None:
    first = payloads[chunk[0][0]]
    features = first["X"].shape[1]
    num_classes = first["num_classes"]
    max_iter = first["max_iter"]
    padded = _job_axis(len(chunk))
    # dummy slots replicate slot 0's (member, point) pair
    slots = [chunk[i] for i in padded_indices(len(chunk), padded)]
    members = [member for member, _ in slots]
    l2s = torch.tensor(
        [payloads[member]["grid"][point]["reg_param"] for member, point in slots],
        dtype=torch.float32,
    ).to(device)
    with _tracing.span(
        "coalesce:lr_chunk", slices=len(chunk), padded=padded
    ):
        # standardized ON DEVICE in float32 from the per-member scaler, as
        # the reference does (λ shares one standardization; members each
        # carry their own)
        means = _uploaded(payloads, members, "mean", device)
        scales = _uploaded(payloads, members, "scale", device)
        X_std = {
            m: (X - means[m]) / scales[m]
            for m, X in _uploaded(payloads, members, "X", device).items()
        }
        Xs = _slot_rows(X_std, members)
        ys = _slot_rows(_uploaded(payloads, members, "y", device), members)
        masks = _slot_rows(_uploaded(payloads, members, "mask", device), members)
        W = torch.zeros((padded, features, num_classes), dtype=torch.float32, device=device)
        b = torch.zeros((padded, num_classes), dtype=torch.float32, device=device)
        states = _job_lbfgs_state(W, b)
        # the reference's segmentation, the job axis multiplying the
        # per-program row cost; NO plateau exit — batched stopping must
        # not couple members (module docstring)
        iters = segment_steps(
            max_iter, first["X"].shape[0] * padded, _LR_ROW_ITERS_BUDGET,
            features,
        )
        for _ in range(max(1, max_iter // iters)):
            W, b, states, _ = _lr_fused_segment(W, b, states, Xs, ys, masks, l2s, iters)
        Xe = _stack(_uploaded(payloads, members, "X_eval", device), members)
        ye = _stack(_uploaded(payloads, members, "y_eval", device), members)
        we = _stack(_uploaded(payloads, members, "mask_eval", device), members)
        accuracy, weighted_f1 = _lr_fused_eval(
            W, b, Xe, _stack(means, members), _stack(scales, members), ye, we, num_classes
        )
        # ONE host transfer for the whole chunk's params + metrics
        flat = torch.cat([W.reshape(-1), b.reshape(-1), accuracy, weighted_f1]).cpu().numpy()
    w_size, b_size = W.numel(), b.numel()
    w_host = flat[:w_size].reshape(W.shape)
    b_host = flat[w_size : w_size + b_size].reshape(b.shape)
    acc_host = flat[w_size + b_size : w_size + b_size + padded]
    f1_host = flat[w_size + b_size + padded :]
    for i, (member, point) in enumerate(chunk):
        per_point[(member, point)] = {
            "accuracy": float(acc_host[i]),
            "weighted_f1": float(f1_host[i]),
            "params": {
                "kind": "lr",
                "w": w_host[i].copy(),
                "b": b_host[i].copy(),
                "mean": payloads[member]["mean"],
                "scale": payloads[member]["scale"],
            },
        }


def _run_dt_chunk(payloads, chunk, per_point, device) -> None:
    first = payloads[chunk[0][0]]
    num_classes = first["num_classes"]
    # depth is a shape of the program: group this chunk's slots by depth
    # and run one fused program per distinct depth — each still a batched
    # job axis, never one dispatch per grid point
    by_depth: dict[int, list[tuple[int, int]]] = {}
    for member, point in chunk:
        depth = payloads[member]["grid"][point]["max_depth"]
        by_depth.setdefault(depth, []).append((member, point))
    for depth, group in sorted(by_depth.items()):
        padded = _job_axis(len(group))
        members = [
            group[i][0] for i in padded_indices(len(group), padded)
        ]
        with _tracing.span(
            "coalesce:dt_chunk", slices=len(group), padded=padded,
            depth=depth,
        ):
            Xs = _slot_rows(_uploaded(payloads, members, "X", device), members)
            ys = _stack(_uploaded(payloads, members, "y", device), members)
            ws = _stack(_uploaded(payloads, members, "mask", device), members)
            ths = _slot_rows(_uploaded(payloads, members, "thresholds", device), members)
            Xe = _slot_rows(_uploaded(payloads, members, "X_eval", device), members)
            ye = _stack(_uploaded(payloads, members, "y_eval", device), members)
            we = _stack(_uploaded(payloads, members, "mask_eval", device), members)
            features_heap, thresholds_heap, leaf_probs, accuracy, f1 = _dt_fused(
                Xs, ys, ws, ths, Xe, ye, we, num_classes, depth, MAX_BINS,
            )
            fh = features_heap.cpu().numpy()
            th, lp, acc_host, f1_host = (
                t.cpu().numpy() for t in (thresholds_heap, leaf_probs, accuracy, f1)
            )
        for i, (member, point) in enumerate(group):
            per_point[(member, point)] = {
                "accuracy": float(acc_host[i]),
                "weighted_f1": float(f1_host[i]),
                "params": {
                    "kind": "dt",
                    "features_heap": fh[i].copy(),
                    "thresholds_heap": th[i].copy(),
                    "leaf_probs": lp[i].copy(),
                    "max_depth": depth,
                },
            }


# --------------------------------------------------------------------------
# Model reconstruction
# --------------------------------------------------------------------------

def model_from_params(params: dict, device: DeviceLike = None):
    """A predict-ready model from one grid point's fitted params — the
    object the argmax checkpoint serializes."""
    device = resolve_device(device)

    def on_device(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    if params["kind"] == "lr":
        return logistic.LogisticRegressionModel(
            on_device(params["w"]),
            on_device(params["b"]),
            on_device(params["mean"]),
            on_device(params["scale"]),
        )
    return trees._TreeEnsembleModel(
        on_device(params["features_heap"])[None],
        on_device(params["thresholds_heap"])[None],
        on_device(params["leaf_probs"])[None],
        params["max_depth"],
    )
