"""Multinomial logistic regression: the L-BFGS fit and the prediction.

Counterpart of ``learningorchestra_tpu/ml/logistic.py``:

- K7, the loss-and-gradient pass (``_loss_fn`` :35 under
  ``jax.value_and_grad`` in ``_fit_segment_impl`` :141): the plain twin
  :func:`_loss_fn` (value and gradient, in torch) and the wrappers
  :func:`loss_and_grad` and :func:`trial_losses`. On a CPU tensor a
  wrapper runs the plain version; on a CUDA tensor it launches the
  hand-written kernel (``kernels/csrc/logistic.cu``) for the mean NLL and
  its gradient, adds the L2 term with torch ops, or raises.
- K7 over a job axis (the sweep's fused L-BFGS, ``ml/sweep.py:237``
  ``_lr_fused_segment``, a ``vmap`` of ``_loss_fn`` with its validity
  mask): :func:`job_loss_and_grad` and :func:`job_trial_losses`, one
  launch for every job, each job with its own rows (or one shared X),
  labels, row weights, parameters and λ; their plain twins
  :func:`_job_loss_fn` and :func:`_job_trial_losses` loop over the jobs,
  so that their float64 transients stay one job's.
- The optimizer (:56-408): ``_lbfgs_state``, ``_two_loop``,
  ``_fit_segment_impl`` and ``_fit`` with the reference's segmentation,
  its plateau stop (``_plateaued``) and its constants.
- ``scaler_stats`` (:437), the estimator ``LogisticRegression`` (:460) and
  the model ``LogisticRegressionModel`` (:447) with its forward (:431):
  standardize, one ``(rows, F) x (F, C)`` product, bias, softmax. That
  product is a plain ``torch.matmul`` in full float32 (TF32 is off,
  ``device.py``), as the reference left it to XLA.

Parameters are two tensors, ``W (F, C)`` and ``b (C,)``; the optimizer
state is a dict of tensors shaped as the reference's (``S``, ``Y`` and
``grad`` hold ``{"w", "b"}``), its ring position ``head`` and count
``filled`` int32 tensors on the device. A segment runs with no host sync:
indices into the ring are tensors (``index_select``, ``torch.where``),
and the line search computes all four trial losses in one pass and picks
the first accepted step on the device. Its losses come back to the host
once a segment, for the plateau check.

Sums over rows are float64 and rounded once to float32, in the kernel and
in the plain twin alike (as the tree fits' K2 and K5 do): the plain twin
is the kernel's oracle on the card, and both sit closer to the exact sum
than the reference's float32 reductions.

``_fit`` saves and resumes its segments through the ambient progress
sink (``ml/progress.py``), as the reference's does.

Rows sharded over the ranks of a mesh (``parallel/``, the reference's
data axis):

- K7's sums form: on a mesh, :func:`loss_and_grad` and
  :func:`trial_losses` take a rank's block of rows with its row weights
  (the validity mask) and launch the kernel's sums form, which writes the
  block's un-divided float64 sums ``[sum w dW | sum w db | sum w nll | sum
  w]``; every rank's sums are gathered and added in rank order in float64,
  divided by the global ``sum w`` and rounded once (the reference's
  ``_loss_fn`` :35 with XLA's psums in its sharded ``_fit`` :308). Every
  rank then holds the same bits, takes the same steps and stops at the
  same segment. The plain twins are :func:`_weighted_sums` and
  :func:`_weighted_trial_sums`.
- K8′, the masked scaler (``_masked_stats`` :412) and the standardization
  (``_standardize`` :426): :func:`masked_stats` (two passes of the kernel
  :func:`masked_col_sums`, gathered like K7's sums) and
  :func:`standardize` (the kernel ``masked_standardize``), both in
  ``kernels/csrc/scaler.cu``, with their plain twins
  :func:`_masked_col_sums` and :func:`_standardize`.
- ``LogisticRegression(mesh=...)``: ``fit`` (every rank passes the full
  rows; the host scaler, then each rank's block) and ``fit_sharded`` (the
  per-host feeding entry, :489: K8′ on the device from the blocks). The
  model predicts on each rank's block and gathers (``ml/base.py``).
- K8′ on bfloat16 rows (``LO_DTYPE_POLICY=bf16``): the reference's
  ``_masked_stats`` and ``_standardize`` run in X's type, so the port's
  do too: each term rounded to bfloat16 where the reference rounds it, the
  float64 sums rounded as its bfloat16 sums round (float32, then
  bfloat16: 1,000,000 ones count 999,424), the divisions in bfloat16.

Classes sharded over the mesh's model axis (the reference's
``_fit_prepared`` :516-560, W and b under ``P(None, MODEL_AXIS)``): when
C divides the model axis M, model rank m holds classes ``[m C/M, (m+1)
C/M)`` of W and b, and the ranks of its model group (which hold the same
block of rows) fit them together:

- K7's class-shard form: :func:`shard_stats` (each row's largest logit,
  sum of exps and label logit over the shard's classes, at one point or
  the four Armijo points) and :func:`shard_grad` (the shard's sums in K7's
  sums layout, given each row's log-sum-exp), with their plain twins
  :func:`_shard_stats` and :func:`_shard_grad`. Each row's shard log-sums
  are gathered over the model group and combined in model-rank order in
  float64 (:func:`_combine_log_sums`: log_softmax's normaliser, the model
  axis's collective); the sums then cross the data group as K7's sums form.
- L-BFGS's inner products (``_tree_dot`` :64) and the L2 term add each
  shard's float64 part over the model group in model-rank order (the
  two-loop recursion's all at once, as one Gram matrix:
  :func:`_shard_direction`), so that every rank takes the same steps and
  stops at the same segment.
- The fitted model holds the whole W and b on every rank (gathered over
  the model group in class order at the end of the fit), as a
  ``NamedSharding`` array is logically whole.
- C not dividing M: the reference's warning, word for word, and W and b
  replicated (each rank of a model group then fits them all on its block,
  as over the data axis alone).
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.device import FEATURE_DTYPES, DeviceLike
from learningorchestra_tpu_torch.ml import progress as _progress
from learningorchestra_tpu_torch.ml.base import (
    FittedModel,
    infer_num_classes,
    largest_divisor,
    segment_steps,
    shard_matrix,
    to_host,
)

# The reference's L-BFGS constants (ml/logistic.py:56-61)
_LBFGS_MEMORY = 10
_BACKTRACK_STEPS = 4
_ARMIJO_C1 = 1e-4
_LR_STOP_DELTAS = 3

# Per-program budget in row*iterations, convergence-check granularity and
# MLlib's default tolerance (ml/logistic.py:278-286)
_LR_ROW_ITERS_BUDGET = 180e6
_LR_CHECK_ITERS = 25
_LR_TOL = 1e-6

# K7's launch geometry (kernels/csrc/logistic.cu): a block's threads, the
# rows of a group of float64 sums (a tile holds whole groups), the classes
# and features of a wide slot, the sum forms, the cells a thread owns in the
# narrow form, and the shared memory a block keeps to while its geometry
# allows (two blocks an SM; wider rows take up to kernels.SHARED_BYTES)
_THREADS = 256              # kThreads
_GROUP_ROWS = 16            # kGroupRows
_WIDE_CLASSES, _WIDE_FEATURES = 2, 8
_NARROW, _WIDE, _WIDE_STAGED = 0, 1, 2
_MAX_OWNED = 5              # kMaxOwned
_MAX_TILE = 256
_TRIAL_WARP_ROWS = 64       # the trial losses' rows a warp (kWarpRows)
_K7_BLOCK_BYTES = 112 * 1024


# --------------------------------------------------------------------------
# K7: the plain twin
# --------------------------------------------------------------------------

def _row_terms(X, y, W, b):
    """Per row: the nll and the log-softmax's shifted logits and log-sum,
    the reference's log_softmax (``shifted - log(sum(exp(shifted)))``).
    The product ``X W`` is taken in float64 (each float32 product exact)
    and rounded once to float32: the float32 product's bits depend on the
    BLAS path that a CPU picks (threads, alignment, its float32 precision
    mode), and a twin that is an oracle should not."""
    logits = torch.matmul(X.to(torch.float64), W.to(torch.float64)).to(torch.float32) + b
    shifted = logits - logits.max(dim=1, keepdim=True).values
    log_sum = torch.log(torch.exp(shifted).sum(dim=1))
    nll = log_sum - shifted.gather(1, y.long()[:, None])[:, 0]
    return nll, shifted, log_sum


def _mean(values, rows: int):
    """Float64 mean over the rows (axis 0), rounded once to float32."""
    return (values.to(torch.float64).sum(dim=0) / rows).to(torch.float32)


def _l2_term(W, l2: float):
    return 0.5 * l2 * (W * W).sum()


def _data_loss(X, y, W, b):
    """The mean nll, as a float32 0-d tensor."""
    return _mean(_row_terms(X, y, W, b)[0], X.shape[0])


def _loss_fn(W, b, X, y, l2: float):
    """Value and gradient of the reference's ``_loss_fn``: the mean nll
    plus ``0.5 * l2 * |W|^2``. Returns ``(value, dW, db)``; the gradient
    of the mean nll is ``X^T (P - onehot(y)) / rows``. No rows give a NaN
    value and a data gradient of 0, as ``jax.grad`` of the reference's
    mean over no rows does (its contraction over no rows is 0 before any
    division)."""
    rows = X.shape[0]
    nll, shifted, log_sum = _row_terms(X, y, W, b)
    residual = torch.exp(shifted - log_sum[:, None])
    residual = residual - torch.nn.functional.one_hot(y.long(), W.shape[1]).to(residual.dtype)
    dW = (torch.matmul(X.to(torch.float64).T, residual.to(torch.float64)) / rows).to(torch.float32)
    db = _mean(residual, rows)
    if rows == 0:
        dW, db = torch.zeros_like(dW), torch.zeros_like(db)
    return _mean(nll, rows) + _l2_term(W, l2), dW + l2 * W, db


def _trial_losses(W4, b4, X, y, l2: float):
    """The loss at each of the candidate parameter sets ``W4 (k, F, C)``,
    ``b4 (k, C)``: a ``(k,)`` float32 tensor."""
    data = torch.stack([_data_loss(X, y, W4[k], b4[k]) for k in range(W4.shape[0])])
    return data + 0.5 * l2 * (W4 * W4).sum(dim=(1, 2))


# --------------------------------------------------------------------------
# K7: the wrappers, plain version on the CPU, the CUDA kernel on the card
# --------------------------------------------------------------------------

def _grouped_cells(num_features: int, num_classes: int, group: int, weighted: bool, trial: bool) -> int:
    """The cells a block sums group by group (the narrow form, the trial
    losses): each job's dW, db and loss (its four losses), and the
    weights'."""
    per_job = _BACKTRACK_STEPS if trial else num_features * num_classes + num_classes + 1
    return group * per_job + int(weighted)


class _K7Layout(ctypes.Structure):
    """A K7 block's geometry and shared memory, as the kernels read it
    (``Layout`` in kernels/csrc/logistic.cu, field for field): the group,
    the tile rows, the sum form, whether the parameters sit in shared
    memory and whether X is bfloat16; the strides; the byte offsets of
    each region and the total."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "group", "tile", "form", "params_shared", "x_bf16",
        "xs", "tp", "js", "fd", "cells", "buffer_floats",
        "ring", "raw", "xd", "terms", "nll", "wd", "scratch", "sums", "sources", "one",
        "params_w", "params_b", "bytes",
    )]


def _stored_classes(num_features: int, num_classes: int, form: int) -> int:
    """The classes whose terms a gradient block keeps: all of them, or, in
    the wide forms, as many as a window of ``_THREADS`` slots (a job's
    slots, 2 classes by 8 features each, class pair by class pair) can
    span when one job's slots pass one block."""
    if form == _NARROW:
        return num_classes
    feature_blocks = -(-num_features // _WIDE_FEATURES)
    pairs = -(-(_THREADS - 1) // feature_blocks) + 1
    return min(num_classes, _WIDE_CLASSES * pairs)


def _k7_layout(
    num_features: int, num_classes: int, group: int, tile: int, form: int, x_staged: bool,
    params_shared: bool, weighted: bool, trial: bool, x_bf16: bool = False,
) -> dict:
    """The fields of :class:`_K7Layout` for a K7 block of geometry ``(group, tile, form,
    x_staged, params_shared)`` (:func:`_k7_geometry`). Its shared memory, in order: a ring of two tiles (x at an
    odd row stride when it is staged, the labels and the weights); for
    staged bfloat16 X a raw tile (its values as they arrive, before they
    are widened into the ring; 8 values of slack so that 16-byte copies
    land on 16-byte words); for
    the gradient the float64 copy of x (the staged wide form), each job's
    residuals (of its stored classes) and nll of the tile, and the weights
    in float64; for the trial losses each warp's scratch (the candidates'
    and the weights' rows at 68 floats, 17 a group of 16 rows); the group
    sums of two tiles (the narrow form, with each cell's source, an int2,
    and a 1.0; the trial losses); and the group's parameters when they sit
    in shared memory. Each region starts on 16 bytes."""
    F, C = num_features, num_classes
    narrow = not trial and form == _NARROW
    grouped = trial or narrow
    xs = (F | 1) if x_staged else 0
    tp = tile | 1
    js = (_stored_classes(F, C, form) * tp) | 1
    fd = F + (F & 1)
    cells = _grouped_cells(F, C, group, weighted, trial) if grouped else 0
    buffer_floats = tile * (xs + 1 + int(weighted))
    sets = _BACKTRACK_STEPS if trial else 1
    sizes = {   # region -> bytes, in the order they lie
        "ring": 4 * 2 * buffer_floats,
        "raw": 2 * (tile * F + 8) if x_bf16 and x_staged else 0,
        "xd": 8 * tile * fd if not trial and form == _WIDE_STAGED else 0,
        "terms": 8 * group * js if not trial else 0,
        "nll": 8 * group * tp if not trial else 0,
        "wd": 8 * tile if not trial and weighted else 0,
        "scratch": 4 * (_THREADS // 32) * (_BACKTRACK_STEPS + 1) * 68 if trial else 0,
        "sums": 8 * 2 * cells * (tile // _GROUP_ROWS),
        "sources": 8 * cells if narrow else 0,
        "one": 4 if narrow else 0,
        "params_w": 4 * group * sets * F * C if params_shared else 0,
        "params_b": 4 * group * sets * C if params_shared else 0,
    }
    offsets, at = {}, 0
    for region, size in sizes.items():
        offsets[region] = at
        at += -(-size // 16) * 16
    return dict(
        group=group, tile=tile, form=form, params_shared=int(params_shared),
        x_bf16=int(x_bf16), xs=xs, tp=tp, js=js, fd=fd, cells=cells, buffer_floats=buffer_floats,
        bytes=at, **offsets,
    )


@functools.lru_cache(maxsize=None)
def _k7_geometry(
    num_features: int, num_classes: int, jobs: int, shared_rows: bool,
    trial: bool = False, weighted: bool = False, x_bf16: bool = False,
) -> tuple[int, int, int, bool, bool]:
    """``(group, tile rows, sum form, x in shared memory, parameters in
    shared memory)`` of a K7 launch. Jobs that share their rows
    (``shared_rows``) go in groups that read each tile once; the group is
    as large as the threads and the shared memory allow. The sums: cells
    summed 16 rows at a time by every thread (``_NARROW``, the trial
    losses) while a group's cells are few, else a (job, 2 classes, 8
    features) block of cells a thread, x made float64 once a row in shared
    memory when it fits (``_WIDE_STAGED``). The tile gives every thread a
    (row, job) in phase 1. Within ``_K7_BLOCK_BYTES`` (two blocks an SM)
    when that holds a tile of 32 rows, else within ``kernels.SHARED_BYTES``;
    wide rows fall back to x read from global memory and parameters there.
    A job's slots past one block go in windows that keep only their
    classes' terms (:func:`_stored_classes`), so every F and C fits.
    bfloat16 X (``x_bf16``) stages its tiles through a raw tile as well.
    None of these changes a bit of the outputs. Raises where a block cannot
    hold one group of rows."""
    F, C = num_features, num_classes
    jobs = max(jobs, 1)
    cells = C * F
    wide_slots = -(-C // _WIDE_CLASSES) * -(-F // _WIDE_FEATURES)
    owned = _MAX_OWNED * _THREADS
    if trial:
        form, group = _NARROW, min(jobs, _THREADS) if shared_rows else 1
    elif not shared_rows or jobs == 1:
        form, group = (_NARROW if cells <= _THREADS else _WIDE_STAGED), 1
    elif jobs * cells <= _THREADS or jobs <= 2 * (_THREADS // cells):
        form, group = _NARROW, max(1, min(jobs, _THREADS // cells))
    else:
        form, group = _WIDE_STAGED, max(1, min(jobs, _THREADS // wide_slots))
    forms = (form, _WIDE) if form == _WIDE_STAGED else (form,)
    # a tile of 32 rows or more gives a warp one job's rows in phase 1 (its
    # parameters' loads the same for the warp), 16 only for rows too wide
    # for 32 of them; the trial losses give a warp 64 rows of one job
    unit, most = (_TRIAL_WARP_ROWS, _TRIAL_WARP_ROWS * _THREADS // 32) if trial else (32, _MAX_TILE)
    least = _TRIAL_WARP_ROWS if trial else _GROUP_ROWS
    for budget, least_tile in ((_K7_BLOCK_BYTES, unit), (kernels.SHARED_BYTES, least)):
        for x_staged in (True, False):
            size = group
            while size >= 1:
                tile = min(most, max(unit, most // size // unit * unit))
                while tile >= least_tile:
                    for shape, params_shared in itertools.product(forms, (True, False)):
                        if shape == _NARROW and _grouped_cells(F, C, size, weighted, trial) > owned:
                            continue
                        if _k7_layout(
                            F, C, size, tile, shape, x_staged, params_shared, weighted, trial,
                            x_bf16,
                        )["bytes"] <= budget:
                            return size, tile, shape, x_staged, params_shared
                    tile //= 2
                size //= 2
    raise ValueError(
        f"{num_features} features x {num_classes} classes: the rows of one group of sums do "
        "not fit a block's shared memory"
    )


@functools.lru_cache(maxsize=None)
def _k7_launch_layout(
    num_features: int, num_classes: int, jobs: int, shared_rows: bool, trial: bool,
    weighted: bool, x_bf16: bool,
) -> _K7Layout:
    """The layout a K7 launch hands its kernel (read, never written)."""
    geometry = _k7_geometry(num_features, num_classes, jobs, shared_rows, trial, weighted, x_bf16)
    return _K7Layout(**_k7_layout(
        num_features, num_classes, *geometry, weighted=weighted, trial=trial, x_bf16=x_bf16))


def _check_operands(X, y, W, b, leading: tuple = ()):
    """X float32, or bfloat16 (``LO_DTYPE_POLICY=bf16``): the kernel and the
    plain twin widen each value exactly to float32 (the twin's float64
    product is then the same as on the widened X)."""
    if not isinstance(X, torch.Tensor) or X.dtype not in FEATURE_DTYPES or X.dim() != 2:
        raise TypeError("X must be a 2-D float32 or bfloat16 tensor")
    if y.dtype != torch.int32 or y.shape != (X.shape[0],):
        raise TypeError("y must be an int32 tensor of one label per row")
    if W.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("W and b must be float32")
    if W.dim() != len(leading) + 2 or tuple(W.shape[:-1]) != leading + (X.shape[1],):
        raise ValueError(f"W of shape {tuple(W.shape)} for {X.shape[1]} features")
    if tuple(b.shape) != leading + (W.shape[-1],):
        raise ValueError(f"b of shape {tuple(b.shape)} for W of shape {tuple(W.shape)}")
    for tensor in (y, W, b):
        if tensor.device != X.device:
            raise ValueError(f"operands on {tensor.device} and {X.device}")


def _stream(tensor):
    return torch.cuda.current_stream(tensor.device).cuda_stream


def _launch_loss_grad(W, b, X, y, weights, jobs: int, sums: bool = False):
    """K7's loss-and-gradient launch over ``jobs`` jobs: ``W (J, F, C)``,
    ``b (J, C)``; X shared ``(rows, F)`` or ``(J, rows, F)``; y and the
    weights (or None) shared ``(rows,)`` or ``(J, rows)``. Returns the
    ``(J, F*C + C + 1)`` float32 outputs, ``[dW | db | data loss]``; the
    sums form (``sums``, weighted) the ``(J, F*C + C + 2)`` float64
    un-divided sums, ``[sum w dW | sum w db | sum w nll | sum w]``."""
    kernels.check_operands(*(t for t in (X, y, weights, W, b) if t is not None))
    rows, num_features = X.shape[-2:]
    num_classes = W.shape[-1]
    weighted = weights is not None
    shared_rows = X.dim() == 2 and y.dim() == 1
    x_bf16 = X.dtype == torch.bfloat16   # widened exactly in the kernel
    layout = _k7_launch_layout(
        num_features, num_classes, jobs, shared_rows, False, weighted, x_bf16)
    chunks, per_chunk = kernels.row_chunks(rows)
    cells = num_features * num_classes + num_classes + 1
    partials = torch.empty(
        (jobs, max(chunks, 1), cells + int(weighted)), dtype=torch.float64, device=X.device
    )
    if sums:
        out = torch.empty((jobs, cells + 1), dtype=torch.float64, device=X.device)
        pointers = (None, out.data_ptr())
    else:
        out = torch.empty((jobs, cells), dtype=torch.float32, device=X.device)
        pointers = (out.data_ptr(), None)
    kernels.launch(
        "logistic_loss_grad_sums" if sums else "logistic_loss_grad", "lo_logistic_loss_grad",
        X.data_ptr(), int(x_bf16), y.data_ptr(), weights.data_ptr() if weighted else None,
        W.data_ptr(), b.data_ptr(), partials.data_ptr(), *pointers,
        rows, num_features, num_classes, jobs,
        rows * num_features if X.dim() == 3 else 0, rows if y.dim() == 2 else 0,
        chunks, per_chunk, ctypes.addressof(layout),
        kernels.max_blocks(X.device.index), X.device.index, _stream(X),
    )
    return out


def _launch_trial_losses(W4, b4, X, y, weights, jobs: int, sums: bool = False):
    """K7's trial-loss launch over ``jobs`` jobs: ``W4 (J, 4, F, C)``,
    ``b4 (J, 4, C)``, the rest as :func:`_launch_loss_grad`. Returns the
    ``(J, 4)`` float32 data losses; the sums form (``sums``, weighted) the
    ``(J, 5)`` float64 sums ``[sum w nll at each point | sum w]``."""
    kernels.check_operands(*(t for t in (X, y, weights, W4, b4) if t is not None))
    rows, num_features = X.shape[-2:]
    num_classes = W4.shape[-1]
    weighted = weights is not None
    shared_rows = X.dim() == 2 and y.dim() == 1
    x_bf16 = X.dtype == torch.bfloat16   # widened exactly in the kernel
    layout = _k7_launch_layout(num_features, num_classes, jobs, shared_rows, True, weighted, x_bf16)
    chunks, per_chunk = kernels.row_chunks(rows)
    partials = torch.empty(
        (jobs, max(chunks, 1), _BACKTRACK_STEPS + int(weighted)),
        dtype=torch.float64, device=X.device,
    )
    if sums:
        out = torch.empty((jobs, _BACKTRACK_STEPS + 1), dtype=torch.float64, device=X.device)
        pointers = (None, out.data_ptr())
    else:
        out = torch.empty((jobs, _BACKTRACK_STEPS), dtype=torch.float32, device=X.device)
        pointers = (out.data_ptr(), None)
    kernels.launch(
        "logistic_trial_losses_sums" if sums else "logistic_trial_losses",
        "lo_logistic_trial_losses",
        X.data_ptr(), int(x_bf16), y.data_ptr(), weights.data_ptr() if weighted else None,
        W4.data_ptr(), b4.data_ptr(), partials.data_ptr(), *pointers,
        rows, num_features, num_classes, jobs,
        rows * num_features if X.dim() == 3 else 0, rows if y.dim() == 2 else 0,
        chunks, per_chunk, ctypes.addressof(layout),
        X.device.index, _stream(X),
    )
    return out


def _check_block_weights(X, weights, mesh):
    if mesh is None:
        if weights is not None:
            raise ValueError("row weights go with a mesh: the solo fit weighs every row 1")
        return
    if (
        not isinstance(weights, torch.Tensor) or weights.dtype != torch.float32
        or tuple(weights.shape) != (X.shape[0],) or weights.device != X.device
    ):
        raise TypeError("weights must be float32, one a row of X, on X's device")


def _global_means(sums, mesh):
    """Every data rank's float64 sums (the weights' last) added in rank
    order, over the global sum of the weights, rounded once to float32."""
    from learningorchestra_tpu_torch.parallel.multihost import all_sum

    total = all_sum(sums, mesh)
    return (total[:-1] / total[-1]).to(torch.float32)


def loss_and_grad(W, b, X, y, l2: float, weights=None, mesh=None, first=None):
    """``(value, dW, db)`` of the loss at ``(W, b)`` (K7). On a ``mesh``,
    X, y and the row ``weights`` are this rank's block of rows sharded over
    its data axis, and the data term is the reference's ``sum w nll / sum
    w`` over every rank's rows: K7's sums form, gathered and added in rank
    order, so that every rank holds the same bits. ``first``: W and b are
    this rank's class shard, classes ``[first, first + Cs)`` of the model
    group's (K7's class-shard form, :func:`_shard_loss_and_grad`)."""
    _check_operands(X, y, W, b)
    _check_block_weights(X, weights, mesh)
    num_features, num_classes = W.shape
    if first is not None:
        return _shard_loss_and_grad(W, b, X, y, l2, weights, mesh, first)
    if mesh is not None:
        if X.device.type == "cpu":
            sums = _weighted_sums(W, b, X, y, weights)
        else:
            sums = _launch_loss_grad(W, b, X, y, weights, 1, sums=True)[0]
        out = _global_means(sums, mesh)
    elif X.device.type == "cpu":
        return _loss_fn(W, b, X, y, l2)
    else:
        out = _launch_loss_grad(W, b, X, y, None, 1)[0]
    dW = out[: num_features * num_classes].view(num_features, num_classes)
    db = out[num_features * num_classes : -1]
    return out[-1] + _l2_term(W, l2), dW + l2 * W, db


def trial_losses(W4, b4, X, y, l2: float, weights=None, mesh=None, first=None):
    """``(4,)`` losses at the Armijo trial points ``W4 (4, F, C)``,
    ``b4 (4, C)`` (K7, one read of X for all four); on a ``mesh`` over
    every rank's rows, and on a class shard (``first``), as
    :func:`loss_and_grad`."""
    _check_operands(X, y, W4, b4, leading=(_BACKTRACK_STEPS,))
    _check_block_weights(X, weights, mesh)
    if first is not None:
        return _shard_trial_losses(W4, b4, X, y, l2, weights, mesh, first)
    if mesh is not None:
        if X.device.type == "cpu":
            sums = _weighted_trial_sums(W4, b4, X, y, weights)
        else:
            sums = _launch_trial_losses(W4, b4, X, y, weights, 1, sums=True)[0]
        out = _global_means(sums, mesh)
    elif X.device.type == "cpu":
        return _trial_losses(W4, b4, X, y, l2)
    else:
        out = _launch_trial_losses(W4, b4, X, y, None, 1)[0]
    return out + 0.5 * l2 * (W4 * W4).sum(dim=(1, 2))


# --------------------------------------------------------------------------
# K7's class-shard form: W and b's classes over the mesh's model group
# --------------------------------------------------------------------------

def _shard_logits(X, W, b):
    """The shard's logits ``(rows, Cs)`` float32, as :func:`_row_terms`
    forms them (a float64 product rounded once, then b)."""
    return torch.matmul(X.to(torch.float64), W.to(torch.float64)).to(torch.float32) + b


def _in_shard(y, first: int, classes: int):
    """Each row's label as the shard's class index (clamped) and whether it
    lies in the shard."""
    local = y.long() - first
    return local.clamp(0, classes - 1), (local >= 0) & (local < classes)


def _shard_stats(W, b, X, y, first: int):
    """The plain twin of :func:`shard_stats`: ``(points, rows, 3)`` float32,
    each row's ``[top, sum exp(z - top), z_y or 0]`` over the shard."""
    classes = W.shape[-1]
    local, inside = _in_shard(y, first, classes)
    out = []
    for p in range(W.shape[0]):
        z = _shard_logits(X, W[p], b[p])
        top = z.max(dim=1).values if z.shape[0] else z.new_zeros(0)
        total = torch.exp(z - top[:, None]).sum(dim=1)
        at_label = torch.where(inside, z.gather(1, local[:, None])[:, 0], torch.zeros_like(top))
        out.append(torch.stack([top, total, at_label], dim=1))
    return torch.stack(out)


def _shard_grad(W, b, X, y, weights, lse, first: int):
    """The plain twin of :func:`shard_grad`: the shard's float64 sums
    ``[sum w x r (F*Cs) | sum w r (Cs) | sum_{y in shard} w (lse - z_y) |
    sum w]``, ``r = exp(z - lse) - onehot(y)`` in float64."""
    classes = W.shape[-1]
    local, inside = _in_shard(y, first, classes)
    z = _shard_logits(X, W, b).to(torch.float64)
    wd = weights.to(torch.float64)
    onehot = torch.nn.functional.one_hot(local, classes).to(torch.float64) * inside[:, None]
    residual = (torch.exp(z - lse[:, None]) - onehot) * wd[:, None]
    nll = torch.where(inside, (lse - z.gather(1, local[:, None])[:, 0]) * wd, torch.zeros_like(wd))
    return torch.cat([
        torch.matmul(X.to(torch.float64).T, residual).reshape(-1), residual.sum(dim=0),
        nll.sum()[None], wd.sum()[None],
    ])


# The class-shard form's launch geometry (kernels/csrc/logistic.cu): a
# stats thread's rows, the tiles a block may take (largest first), a narrow
# grad item's classes, grad's sum forms, and the shared memory a block keeps
# to (two blocks an SM), the parameters' share of it
_STATS_ROWS = 2             # kStatsRows
_GRAD_STAGES = 3            # kGradStages: the grad's ring of tiles
_STATS_TILES = tuple(_THREADS * _STATS_ROWS >> k for k in range(5))   # 512 .. 32 rows
_GRAD_TILES = tuple(range(_THREADS, 0, -_GROUP_ROWS * 2)) + (_GROUP_ROWS,)   # 256, 224 .. 32, 16
_GRAD_CLASSES = 8           # kGradClasses
_SHARD_NARROW, _SHARD_SERIAL = 0, 1
_SHARD_BLOCK_BYTES = _K7_BLOCK_BYTES
_SHARD_PARAMS_BYTES = 32 * 1024


class _ShardLayout(ctypes.Structure):
    """A class-shard block's geometry and shared memory, as the kernels read
    it (``ShardLayout`` in kernels/csrc/logistic.cu, field for field): the
    tile's rows; x's row stride (0: rows read from global memory); a
    feature's class stride in the shared parameters (0: read from global
    memory); grad's sum form; the residuals' stride a class; a ring
    buffer's bytes; each region's byte offset; a point's floats in the
    outputs' stage; the total bytes."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "tile", "xs", "ws", "form", "tp", "buffer",
        "params_w", "params_b", "raw", "x", "ring", "terms", "nll", "wd", "sums", "stage",
        "stage_floats", "bytes",
    )]


def _shard_cells(num_features: int, classes: int) -> int:
    """The shard's sums: ``F*Cs`` of dW, ``Cs`` of db, the nll, the weights."""
    return num_features * classes + classes + 2


def _shard_layout(
    num_features: int, classes: int, points: int, tile: int, x_staged: bool,
    params_shared: bool, x_bytes: int, grad: bool, form: int = _SHARD_NARROW,
) -> dict:
    """The fields of :class:`_ShardLayout` for a stats (``grad`` False) or a
    grad block. Its shared memory, in order: the parameters when they sit
    there (every point's W, a feature's classes at a stride of Cs rounded up
    to 4, then b at that stride); for staged x the raw tile (a tile's
    values as they arrive, a 16-byte word of slack) and x at an odd row
    stride; the buffers (stats: the labels, two; grad: the log-sum-exp,
    the labels and the weights, its raw tiles and buffers a ring of
    ``_GRAD_STAGES``); grad's residuals (a class's at ``tp`` doubles), nll
    terms and weights in float64 and, in the narrow form, the group sums of
    two tiles; stats' outputs of every point (``3 tile + 4`` floats each,
    so that a point's 16-byte words line up with its rows'). Each region
    starts on 16 bytes."""
    F, Cs = num_features, classes
    sets = 1 if grad else points
    xs = (F | 1) if x_staged else 0
    ws = -(-Cs // 4) * 4 if params_shared else 0
    tp = tile
    buffer = 16 * tile if grad else 4 * tile
    stage_floats = 0 if grad else 3 * tile + 4
    narrow = grad and form == _SHARD_NARROW
    sizes = {   # region -> bytes, in the order they lie
        "params_w": 4 * sets * F * ws,
        "params_b": 4 * sets * ws,
        "raw": (_GRAD_STAGES if grad else 1) * x_bytes * (tile * F + 16 // x_bytes) if x_staged else 0,
        "x": 4 * tile * xs,
        "ring": (_GRAD_STAGES if grad else 2) * buffer,
        "terms": 8 * Cs * tp if grad else 0,
        "nll": 8 * tile if grad else 0,
        "wd": 8 * tile if grad else 0,
        "sums": 8 * 2 * (tile // _GROUP_ROWS) * _shard_cells(F, Cs) if narrow else 0,
        "stage": 4 * points * stage_floats,
    }
    offsets, at = {}, 0
    for region, size in sizes.items():
        offsets[region] = at
        at += -(-size // 16) * 16
    return dict(tile=tile, xs=xs, ws=ws, form=form if grad else 0, tp=tp, buffer=buffer,
                stage_floats=stage_floats, bytes=at, **offsets)


def _params_shared(num_features: int, classes: int, sets: int) -> bool:
    """Whether a block keeps the parameter sets in shared memory."""
    ws = -(-classes // 4) * 4
    return 4 * sets * (num_features * ws + ws) <= _SHARD_PARAMS_BYTES


@functools.lru_cache(maxsize=None)
def _shard_stats_geometry(num_features: int, classes: int, points: int,
                          x_bytes: int) -> tuple[int, bool, bool]:
    """``(tile rows, x staged, parameters in shared memory)`` of a stats
    launch: the largest tile whose staged rows fit ``_SHARD_BLOCK_BYTES``,
    else rows read from global memory at the largest tile. None of these
    changes a bit of the outputs."""
    F, Cs = num_features, classes
    shared = _params_shared(F, Cs, points)
    for x_staged in (True, False):
        for tile in _STATS_TILES:
            if _shard_layout(F, Cs, points, tile, x_staged, shared, x_bytes, False)["bytes"] \
                    <= _SHARD_BLOCK_BYTES:
                return tile, x_staged, shared
    raise ValueError(f"{points} points x {F} features x {Cs} classes: no stats tile fits a block")


@functools.lru_cache(maxsize=None)
def _shard_grad_geometry(num_features: int, classes: int, x_bytes: int) -> tuple[int, bool, bool, int]:
    """``(tile rows, x staged, parameters in shared memory, sum form)`` of a
    grad launch: staged rows first, the narrow form while a thread owns at
    most ``_MAX_OWNED`` cells and its group sums fit, the largest tile that
    fits ``_SHARD_BLOCK_BYTES``; else the serial form, else rows from
    global memory. Both forms give the same bits."""
    F, Cs = num_features, classes
    shared = _params_shared(F, Cs, 1)
    forms = (_SHARD_NARROW, _SHARD_SERIAL) if _shard_cells(F, Cs) <= _MAX_OWNED * _THREADS \
        else (_SHARD_SERIAL,)
    for x_staged in (True, False):
        for form in forms:
            for tile in _GRAD_TILES:
                if _shard_layout(F, Cs, 1, tile, x_staged, shared, x_bytes, True, form)["bytes"] \
                        <= _SHARD_BLOCK_BYTES:
                    return tile, x_staged, shared, form
    raise ValueError(f"{F} features x {Cs} classes: no grad tile fits a block")


@functools.lru_cache(maxsize=None)
def _shard_stats_layout(num_features: int, classes: int, points: int, x_bytes: int) -> _ShardLayout:
    """The layout a stats launch hands its kernel (read, never written)."""
    tile, x_staged, shared = _shard_stats_geometry(num_features, classes, points, x_bytes)
    return _ShardLayout(**_shard_layout(
        num_features, classes, points, tile, x_staged, shared, x_bytes, False))


@functools.lru_cache(maxsize=None)
def _shard_grad_layout(num_features: int, classes: int, x_bytes: int) -> _ShardLayout:
    """The layout a grad launch hands its kernel (read, never written)."""
    tile, x_staged, shared, form = _shard_grad_geometry(num_features, classes, x_bytes)
    return _ShardLayout(**_shard_layout(
        num_features, classes, 1, tile, x_staged, shared, x_bytes, True, form))


def _check_shard(W, first):
    if not isinstance(first, int) or first < 0:
        raise ValueError(f"the shard's first class must be an int >= 0, got {first!r}")
    if W.shape[-1] < 1:
        raise ValueError("a class shard holds one class or more")


def shard_stats(W, b, X, y, first: int):
    """Each row's stats over the shard's classes ``[first, first + Cs)``
    at ``points`` parameter sets ``W (points, F, Cs)``, ``b (points, Cs)``
    (1: the loss's point; 4: the Armijo trial points, one read of X):
    ``(points, rows, 3)`` float32, ``[largest logit, sum of exp(z - it),
    the label's logit where the label lies in the shard, else 0]``. On a
    CUDA tensor one launch of K7's ``lo_logistic_shard_stats`` (its tiles,
    staging and parameters' place from :func:`_shard_stats_geometry`)."""
    points = W.shape[0] if W.dim() == 3 else -1
    _check_operands(X, y, W, b, leading=(points,))
    _check_shard(W, first)
    if X.device.type == "cpu":
        return _shard_stats(W, b, X, y, first)
    kernels.check_operands(X, y, W, b)
    rows, num_features = X.shape
    layout = _shard_stats_layout(num_features, W.shape[-1], points, X.element_size())
    out = torch.empty((points, rows, 3), dtype=torch.float32, device=X.device)
    kernels.launch(
        "logistic_shard_stats", "lo_logistic_shard_stats",
        X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(), W.data_ptr(), b.data_ptr(),
        out.data_ptr(), rows, num_features, W.shape[-1], points, first,
        kernels.max_blocks(X.device.index), X.device.index, _stream(X), ctypes.addressof(layout),
    )
    return out


def shard_grad(W, b, X, y, weights, lse, first: int):
    """The shard's un-divided float64 sums in K7's sums layout, given each
    row's log-sum-exp over every class ``lse (rows,)`` float64: ``(F*Cs +
    Cs + 2,)``, ``[sum w x r | sum w r | sum_{y in shard} w nll | sum w]``.
    On a CUDA tensor one launch of K7's ``lo_logistic_shard_grad`` (its
    geometry from :func:`_shard_grad_geometry`; each cell's 16-row groups
    added in group order, the chunks in chunk order by ``sums_kernel``)."""
    _check_operands(X, y, W, b)
    _check_shard(W, first)
    if weights is None or weights.dtype != torch.float32 or tuple(weights.shape) != (X.shape[0],):
        raise TypeError("weights must be float32, one a row of X")
    if lse.dtype != torch.float64 or tuple(lse.shape) != (X.shape[0],):
        raise TypeError("lse must be float64, one a row of X")
    if X.device.type == "cpu":
        return _shard_grad(W, b, X, y, weights, lse, first)
    kernels.check_operands(X, y, weights, lse, W, b)
    rows, num_features = X.shape
    classes = W.shape[-1]
    cells = _shard_cells(num_features, classes)
    layout = _shard_grad_layout(num_features, classes, X.element_size())
    chunks, per_chunk = kernels.row_chunks(rows)
    partials = torch.empty((max(chunks, 1), cells), dtype=torch.float64, device=X.device)
    out = torch.empty(cells, dtype=torch.float64, device=X.device)
    kernels.launch(
        "logistic_shard_grad", "lo_logistic_shard_grad",
        X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(), weights.data_ptr(),
        lse.data_ptr(), W.data_ptr(), b.data_ptr(), partials.data_ptr(), out.data_ptr(),
        rows, num_features, classes, first, chunks, per_chunk,
        kernels.max_blocks(X.device.index), X.device.index, _stream(X), ctypes.addressof(layout),
    )
    return out


def _shard_log_sums(stats):
    """Each row's float64 log-sum over the shard's classes, from its stats:
    ``top + log(sum exp(z - top))``."""
    return stats[..., 0].to(torch.float64) + torch.log(stats[..., 1].to(torch.float64))


def _combine_log_sums(parts):
    """Each row's log-sum-exp over every shard's classes from the shards'
    log-sums (in model-rank order), in float64: the largest, plus the log
    of the sum of each shard's exp about it, added in model-rank order."""
    top = parts[0]
    for part in parts[1:]:
        top = torch.maximum(top, part)
    total = torch.exp(parts[0] - top)
    for part in parts[1:]:
        total = total + torch.exp(part - top)
    return top + torch.log(total)


def _rank_sum(parts):
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _shard_loss_and_grad(W, b, X, y, l2: float, weights, mesh, first: int):
    """``(value, dW, db)`` on a class shard: the shard's stats (K7's class-
    shard stats), each row's log-sum-exp and the L2 term's ``|W|^2`` over
    the model group (one gather), the shard's sums (K7's class-shard grad)
    over the data group, the nll over the model group; dW and db are the
    shard's. The same value on every rank."""
    from learningorchestra_tpu_torch.parallel.multihost import (
        all_sum, model_all_gather, model_all_sum)

    stats = shard_stats(W[None], b[None], X, y, first)[0]
    local = torch.cat([_shard_log_sums(stats), (W.to(torch.float64) ** 2).sum()[None]])
    parts = model_all_gather(local, mesh)
    lse = _combine_log_sums([part[:-1] for part in parts])
    squares = _rank_sum([part[-1:] for part in parts])
    total = all_sum(shard_grad(W, b, X, y, weights, lse, first), mesh)
    nll = model_all_sum(total[-2:-1], mesh)
    cells = W.shape[0] * W.shape[1]
    dW = (total[:cells] / total[-1]).to(torch.float32).view(W.shape)
    db = (total[cells:-2] / total[-1]).to(torch.float32)
    value = (nll / total[-1]).to(torch.float32)[0] + 0.5 * l2 * squares.to(torch.float32)[0]
    return value, dW + l2 * W, db


def _shard_trial_losses(W4, b4, X, y, l2: float, weights, mesh, first: int):
    """``(4,)`` trial losses on a class shard from K7's class-shard stats
    alone: each row's log-sum-exp at each point, the shards' label logits
    and ``|W4|^2`` over the model group (one gather), then ``sum w (lse -
    z_y)`` and ``sum w`` over the data group."""
    from learningorchestra_tpu_torch.parallel.multihost import all_sum, model_all_gather

    points, rows = W4.shape[0], X.shape[0]
    stats = shard_stats(W4, b4, X, y, first)
    wd = weights.to(torch.float64)
    at_label = (stats[..., 2].to(torch.float64) * wd).sum(dim=1)
    squares = (W4.to(torch.float64) ** 2).sum(dim=(1, 2))
    local = torch.cat([_shard_log_sums(stats).reshape(-1), at_label, squares])
    parts = model_all_gather(local, mesh)
    lse = _combine_log_sums([part[: points * rows].view(points, rows) for part in parts])
    labels = _rank_sum([part[points * rows : points * (rows + 1)] for part in parts])
    squares = _rank_sum([part[points * (rows + 1) :] for part in parts])
    total = all_sum(torch.cat([(lse * wd).sum(dim=1) - labels, wd.sum()[None]]), mesh)
    return (total[:-1] / total[-1]).to(torch.float32) + 0.5 * l2 * squares.to(torch.float32)


def _shard_dot(a, b, mesh):
    """The pytree inner product over a class shard: each shard's float64
    ``vdot(b) + vdot(w)``, added over the model group in model-rank order,
    rounded once to float32 (the same bits on every rank)."""
    from learningorchestra_tpu_torch.parallel.multihost import model_all_sum

    local = sum((a[key].to(torch.float64) * b[key].to(torch.float64)).sum() for key in ("b", "w"))
    return model_all_sum(local[None], mesh).to(torch.float32)[0]

# --------------------------------------------------------------------------
# K7 over a job axis: many fits in one launch (the sweep's fused L-BFGS)
# --------------------------------------------------------------------------

def _weight_total(X, weights):
    """A job's float64 denominator: the sum of its weights, or its rows."""
    if weights is None:
        return torch.tensor(float(X.shape[0]), dtype=torch.float64, device=X.device)
    return weights.to(torch.float64).sum()


def _weighted_mean(values, total):
    """Float64 sum over the rows (axis 0) over ``total``, rounded once."""
    return (values.to(torch.float64).sum(dim=0) / total).to(torch.float32)


def _weighted_parts(W, b, X, y, weights):
    """One job's float64 sums over its rows: ``(sum w nll, X^T (w (P -
    onehot(y))), sum w (P - onehot(y)), sum w)``, the nll and the residuals
    weighted row by row (a float32 product). ``weights=None`` weighs every
    row 1 (and the last is the row count)."""
    nll, shifted, log_sum = _row_terms(X, y, W, b)
    residual = torch.exp(shifted - log_sum[:, None])
    residual = residual - torch.nn.functional.one_hot(y.long(), W.shape[1]).to(residual.dtype)
    if weights is not None:
        nll, residual = nll * weights, residual * weights[:, None]
    return (
        nll.to(torch.float64).sum(dim=0),
        torch.matmul(X.to(torch.float64).T, residual.to(torch.float64)),
        residual.to(torch.float64).sum(dim=0),
        _weight_total(X, weights),
    )


def _weighted_terms(W, b, X, y, weights):
    """One job's ``(data loss, dW, db)``: :func:`_weighted_parts` divided
    by the float64 sum of the weights, each rounded once to float32 (the
    reference's ``(nll * mask).sum() / mask.sum()`` and its gradient). No
    rows give a NaN loss and a gradient of 0, as ``jax.grad`` of the
    reference does; rows whose weights are all 0 give NaN for all three,
    as it does too (0 / 0 in the loss, and in the gradient the rows'
    cotangents of ``mask / mask.sum()``)."""
    loss, dW, db, total = _weighted_parts(W, b, X, y, weights)
    dW, db = (dW / total).to(torch.float32), (db / total).to(torch.float32)
    if X.shape[0] == 0:
        dW, db = torch.zeros_like(dW), torch.zeros_like(db)
    return (loss / total).to(torch.float32), dW, db


def _weighted_sums(W, b, X, y, weights):
    """The plain twin of K7's sums form: a rank's block's un-divided
    float64 sums ``[sum w dW | sum w db | sum w nll | sum w]``, the parts
    of :func:`_weighted_terms`."""
    loss, dW, db, total = _weighted_parts(W, b, X, y, weights)
    return torch.cat([dW.reshape(-1), db, loss[None], total[None]])


def _weighted_data_loss(W, b, X, y, weights):
    """One job's data loss alone, as :func:`_weighted_terms` computes it."""
    nll = _row_terms(X, y, W, b)[0]
    if weights is not None:
        nll = nll * weights
    return _weighted_mean(nll, _weight_total(X, weights))


def _weighted_trial_sums(W4, b4, X, y, weights):
    """The plain twin of the trial losses' sums form: ``[sum w nll at each
    point | sum w]``, float64."""
    sums = [(_row_terms(X, y, W4[k], b4[k])[0] * weights).to(torch.float64).sum(dim=0)
            for k in range(W4.shape[0])]
    return torch.stack(sums + [_weight_total(X, weights)])


def _job_rows(X, y, weights, job: int):
    """Job ``job``'s rows, labels and weights, from shared or stacked ones."""
    return (
        X if X.dim() == 2 else X[job],
        y if y.dim() == 1 else y[job],
        weights if weights is None or weights.dim() == 1 else weights[job],
    )


def _job_l2(value, dW, W, l2s):
    """Each job's L2 term and its gradient, with the job's own λ."""
    return value + 0.5 * l2s * (W * W).sum(dim=(1, 2)), dW + l2s[:, None, None] * W


def _job_loss_fn(W, b, X, y, weights, l2s):
    """The plain twin of :func:`job_loss_and_grad`: the jobs one at a
    time, so that the float64 transients are one job's."""
    terms = [_weighted_terms(W[j], b[j], *_job_rows(X, y, weights, j)) for j in range(W.shape[0])]
    value, dW, db = (torch.stack(parts) for parts in zip(*terms))
    value, dW = _job_l2(value, dW, W, l2s)
    return value, dW, db


def _job_trial_losses(W4, b4, X, y, weights, l2s):
    """The plain twin of :func:`job_trial_losses`, the jobs one at a time."""
    data = torch.stack([
        torch.stack([
            _weighted_data_loss(W4[j, k], b4[j, k], *_job_rows(X, y, weights, j))
            for k in range(W4.shape[1])
        ])
        for j in range(W4.shape[0])
    ])
    return data + 0.5 * l2s[:, None] * (W4 * W4).sum(dim=(2, 3))


def _check_job_operands(X, y, weights, W, b, l2s, leading: tuple = ()):
    if not isinstance(X, torch.Tensor) or X.dtype != torch.float32 or X.dim() not in (2, 3):
        raise TypeError("X must be a float32 tensor (rows, F), shared, or (jobs, rows, F)")
    jobs = W.shape[0] if W.dim() > 0 else -1
    rows, num_features = X.shape[-2:]
    if X.dim() == 3 and X.shape[0] != jobs:
        raise ValueError(f"X of {X.shape[0]} jobs for parameters of {jobs}")
    shared = (rows,) if y.dim() == 1 else (jobs, rows)
    if y.dtype != torch.int32 or tuple(y.shape) != shared:
        raise TypeError("y must be int32 labels (rows,), shared, or (jobs, rows)")
    if weights is not None and (weights.dtype != torch.float32 or weights.shape != y.shape):
        raise TypeError("weights must be float32 of y's shape")
    if W.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("W and b must be float32")
    if W.dim() != len(leading) + 3 or tuple(W.shape[1:-1]) != leading + (num_features,):
        raise ValueError(f"W of shape {tuple(W.shape)} for {num_features} features")
    if tuple(b.shape) != (jobs,) + leading + (W.shape[-1],):
        raise ValueError(f"b of shape {tuple(b.shape)} for W of shape {tuple(W.shape)}")
    if l2s.dtype != torch.float32 or tuple(l2s.shape) != (jobs,):
        raise TypeError("l2s must be a float32 tensor of one lambda a job")
    for tensor in (y, weights, W, b, l2s):
        if tensor is not None and tensor.device != X.device:
            raise ValueError(f"operands on {tensor.device} and {X.device}")


def job_loss_and_grad(W, b, X, y, weights, l2s):
    """Every job's ``(value, dW, db)`` at its ``(W[j], b[j])`` (K7 over a
    job axis, one launch): ``W (J, F, C)``, ``b (J, C)``, ``l2s (J,)``
    float32; X one shared ``(rows, F)`` or ``(J, rows, F)``; y and the
    row weights (or None) ``(rows,)`` or ``(J, rows)``. A job's data term
    is ``sum(w * nll) / sum(w)``. Returns ``(J,)``, ``(J, F, C)`` and
    ``(J, C)`` float32 tensors."""
    _check_job_operands(X, y, weights, W, b, l2s)
    if X.device.type == "cpu":
        return _job_loss_fn(W, b, X, y, weights, l2s)
    jobs, num_features, num_classes = W.shape
    out = _launch_loss_grad(W, b, X, y, weights, jobs)
    dW = out[:, : num_features * num_classes].view(jobs, num_features, num_classes)
    db = out[:, num_features * num_classes : -1]
    value, dW = _job_l2(out[:, -1], dW, W, l2s)
    return value, dW, db


def job_trial_losses(W4, b4, X, y, weights, l2s):
    """``(J, 4)`` losses of every job at its Armijo trial points ``W4 (J,
    4, F, C)``, ``b4 (J, 4, C)`` (K7 over a job axis, one launch)."""
    _check_job_operands(X, y, weights, W4, b4, l2s, leading=(_BACKTRACK_STEPS,))
    if X.device.type == "cpu":
        return _job_trial_losses(W4, b4, X, y, weights, l2s)
    out = _launch_trial_losses(W4, b4, X, y, weights, W4.shape[0])
    return out + 0.5 * l2s[:, None] * (W4 * W4).sum(dim=(2, 3))


# --------------------------------------------------------------------------
# L-BFGS
# --------------------------------------------------------------------------

def _tree_dot(a, b):
    """The reference's pytree inner product over the leaves ``b`` and
    ``w``: ``vdot(b) + vdot(w)``, one float32 device scalar."""
    return torch.dot(a["b"].reshape(-1), b["b"].reshape(-1)) + torch.dot(
        a["w"].reshape(-1), b["w"].reshape(-1)
    )


def _tree_axpy(alpha, x, y):
    """``y + alpha * x`` leaf-wise (alpha a scalar)."""
    return {key: y[key] + alpha * x[key] for key in ("w", "b")}


def _lbfgs_state(W, b):
    """Curvature memory as ``(m, *leaf.shape)`` ring buffers, as the
    reference's; ``head`` (next slot to write) and ``filled`` (valid
    pairs) are int32 device scalars."""
    m = _LBFGS_MEMORY

    def history():
        return {"w": W.new_zeros((m,) + tuple(W.shape)), "b": b.new_zeros((m,) + tuple(b.shape))}

    return {
        "S": history(),
        "Y": history(),
        "rho": W.new_zeros(m),
        "head": torch.zeros((), dtype=torch.int32, device=W.device),
        "filled": torch.zeros((), dtype=torch.int32, device=W.device),
        "value": W.new_zeros(()),
        "grad": {"w": torch.zeros_like(W), "b": torch.zeros_like(b)},
    }


def _two_loop(state):
    """Search direction ``-H g`` by the two-loop recursion over the ring
    buffers, newest pair first; unfilled slots are masked out. The ring is
    read in newest-first order with one ``index_select`` a buffer, so the
    device-side ``head`` never comes to the host."""
    m = _LBFGS_MEMORY
    steps = torch.arange(m, device=state["rho"].device)
    order = torch.remainder(state["head"] - 1 - steps, m)
    valid = (steps < state["filled"]).to(torch.float32)
    S = {key: state["S"][key].index_select(0, order) for key in ("w", "b")}
    Y = {key: state["Y"][key].index_select(0, order) for key in ("w", "b")}
    rho = state["rho"].index_select(0, order)

    def at(history, k):
        return {key: history[key][k] for key in ("w", "b")}

    q = state["grad"]
    alphas = []
    for k in range(m):
        alpha = valid[k] * rho[k] * _tree_dot(at(S, k), q)
        q = _tree_axpy(-alpha, at(Y, k), q)
        alphas.append(alpha)
    s_new, y_new = at(S, 0), at(Y, 0)
    y_dot = _tree_dot(y_new, y_new)
    gamma = torch.where(
        (state["filled"] > 0) & (y_dot > 0.0),
        _tree_dot(s_new, y_new) / torch.clamp(y_dot, min=1e-20),
        1.0,
    )
    r = {key: gamma * value for key, value in q.items()}
    for k in range(m - 1, -1, -1):
        beta = valid[k] * rho[k] * _tree_dot(at(Y, k), r)
        r = _tree_axpy(alphas[k] - beta, at(S, k), r)
    return {key: -value for key, value in r.items()}


def _shard_direction(state, mesh):
    """The two-loop recursion of :func:`_two_loop` on a class shard, every
    inner product it needs taken at once: the float64 Gram matrix of the
    ring's pairs and the gradient ``[S; Y; g]`` on each shard, added over
    the model group in model-rank order (one collective, where a dot at a
    time would take 2m + 3), then the recursion's scalars from it in
    float64 (``s_k.q = s_k.g - sum_{j<k} alpha_j s_k.y_j``, ``y_k.r`` the
    same way), and the direction from them. Returns ``(direction, slope
    g.d, g.g)``, the scalars rounded once to float32, the same bits on
    every rank of the model group."""
    from learningorchestra_tpu_torch.parallel.multihost import model_all_sum

    m = _LBFGS_MEMORY
    steps = torch.arange(m, device=state["rho"].device)
    order = torch.remainder(state["head"] - 1 - steps, m)
    valid = (steps < state["filled"]).to(torch.float64)
    rho = state["rho"].index_select(0, order).to(torch.float64)
    S = {key: state["S"][key].index_select(0, order) for key in ("w", "b")}
    Y = {key: state["Y"][key].index_select(0, order) for key in ("w", "b")}
    grad = state["grad"]

    def rows(tree, count):
        return torch.cat([tree["b"].reshape(count, -1), tree["w"].reshape(count, -1)], dim=1)

    V = torch.cat([rows(S, m), rows(Y, m), rows(grad, 1)]).to(torch.float64)
    gram = model_all_sum(V @ V.T, mesh)
    SY, YY = gram[:m, m:2 * m], gram[m:2 * m, m:2 * m]   # SY[k, j] = s_k . y_j
    SG, YG, GG = gram[:m, 2 * m], gram[m:2 * m, 2 * m], gram[2 * m, 2 * m]
    alphas = torch.zeros(m, dtype=torch.float64, device=gram.device)
    for k in range(m):   # newest pair first
        alphas[k] = valid[k] * rho[k] * (SG[k] - (alphas[:k] * SY[k, :k]).sum())
    gamma = torch.where(
        (state["filled"] > 0) & (YY[0, 0] > 0.0), SY[0, 0] / torch.clamp(YY[0, 0], min=1e-20), 1.0)
    # q = g - sum_i alpha_i y_i; r = gamma q + sum_j (alpha_j - beta_j) s_j over the pairs done
    yq = YG - YY @ alphas
    coefficients = torch.zeros(m, dtype=torch.float64, device=gram.device)
    for k in range(m - 1, -1, -1):   # oldest of the valid window first
        beta = valid[k] * rho[k] * (gamma * yq[k] + (coefficients * SY[:, k]).sum())
        coefficients[k] = alphas[k] - beta
    slope = -(gamma * (GG - (alphas * YG).sum()) + (coefficients * SG).sum())
    direction = {
        key: -(gamma * grad[key].to(torch.float64)
               - torch.tensordot(gamma * alphas, Y[key].to(torch.float64), dims=1)
               + torch.tensordot(coefficients, S[key].to(torch.float64), dims=1)).to(torch.float32)
        for key in ("w", "b")
    }
    return direction, slope.to(torch.float32), GG.to(torch.float32)


def _first_accepted(steps, ok, floor: float):
    """The first step whose trial passed, else ``floor``: the reference's
    backtracking while_loop, chosen on the device."""
    first = ok & (torch.cumsum(ok.to(torch.int32), 0) == 1)
    return torch.where(ok.any(), (steps * first).sum(), floor)


def _fit_segment_impl(
    W, b, state, X, y, iters: int, l2: float, weights=None, mesh=None, first=None,
):
    """``iters`` L-BFGS iterations, optimizer state in and out: the
    reference's segment (seed pass, descent safeguard, Armijo choice, ring
    writes gated by ``s.y > 1e-10``). Returns ``(W, b, state, losses)``,
    the losses the ``(iters,)`` pre-step values, all on the device. On a
    ``mesh`` the passes run over every rank's rows (:func:`loss_and_grad`),
    so that every rank takes the same steps; on a class shard (``first``)
    the inner products are the model group's (:func:`_shard_direction`,
    :func:`_shard_dot`), so that every rank of it takes them too."""
    x = {"w": W, "b": b}
    # the solo call keeps the wrappers' five arguments (a plain-version
    # context swaps in the twins, which take those alone)
    over_ranks = () if mesh is None else (weights, mesh)
    if first is not None:
        over_ranks += (first,)
    dot = _tree_dot if first is None else functools.partial(_shard_dot, mesh=mesh)
    value, dW, db = loss_and_grad(W, b, X, y, l2, *over_ranks)
    state = {**state, "value": value, "grad": {"w": dW, "b": db}}
    # the trial steps 1, 1/2, 1/4, 1/8, made on the device (a copy from the
    # host would wait for the stream)
    steps = torch.full((_BACKTRACK_STEPS,), 0.5, device=W.device).cumprod(0) * 2.0
    floor = 1.0 / (1 << _BACKTRACK_STEPS)
    m = _LBFGS_MEMORY
    slots = torch.arange(m, device=W.device)
    losses = []
    for _ in range(iters):
        value, grad = state["value"], state["grad"]
        if first is None:
            direction = _two_loop(state)
            slope, steepest = _tree_dot(grad, direction), _tree_dot(grad, grad)
        else:
            direction, slope, steepest = _shard_direction(state, mesh)
        # a non-descent direction (stale curvature) falls back to steepest descent
        descent = slope < 0.0
        direction = {key: torch.where(descent, direction[key], -grad[key]) for key in ("w", "b")}
        slope = torch.where(descent, slope, -steepest)

        trial = trial_losses(
            x["w"][None] + steps[:, None, None] * direction["w"][None],
            x["b"][None] + steps[:, None] * direction["b"][None],
            X, y, l2, *over_ranks,
        )
        ok = trial <= value + _ARMIJO_C1 * steps * slope
        x_new = _tree_axpy(_first_accepted(steps, ok, floor), direction, x)
        value_new, dW, db = loss_and_grad(x_new["w"], x_new["b"], X, y, l2, *over_ranks)
        grad_new = {"w": dW, "b": db}

        # curvature pair; skipped when s.y is not positive
        s = {key: x_new[key] - x[key] for key in ("w", "b")}
        y_vec = {key: grad_new[key] - grad[key] for key in ("w", "b")}
        sy = dot(s, y_vec)
        keep = sy > 1e-10
        head = state["head"]
        write = keep & (slots == head)

        def ring_write(history, pair):
            return {
                key: torch.where(write.view((m,) + (1,) * pair[key].dim()), pair[key], history[key])
                for key in ("w", "b")
            }

        state = {
            **state,
            "S": ring_write(state["S"], s),
            "Y": ring_write(state["Y"], y_vec),
            "rho": torch.where(write, 1.0 / torch.clamp(sy, min=1e-20), state["rho"]),
            "head": torch.where(keep, torch.remainder(head + 1, m), head),
            "filled": torch.where(keep, torch.clamp(state["filled"] + 1, max=m), state["filled"]),
            "value": value_new,
            "grad": grad_new,
        }
        x = x_new
        losses.append(value)
    if not losses:
        return x["w"], x["b"], state, W.new_zeros(0)
    return x["w"], x["b"], state, torch.stack(losses)


def _plateaued(history: list[float], tol: float, window: int) -> bool:
    """True when the trailing ``window`` pre-step losses form a genuine
    plateau: every consecutive delta is under the (relative) tolerance,
    and so is the total improvement across the window (reference
    ``ml/logistic.py:289``, exactly)."""
    if len(history) < window:
        return False
    recent = history[-window:]
    threshold = tol * max(abs(recent[-1]), 1.0)
    return abs(recent[-1] - recent[0]) <= threshold and all(
        abs(recent[i + 1] - recent[i]) <= threshold
        for i in range(len(recent) - 1)
    )


def _segment_iters(max_iter: int, rows: int, features: int, tol: float) -> int:
    """Iterations a segment: ``segment_steps`` over the row*iterations
    budget, capped for the convergence check's granularity, never below 5
    iterations (a prime max_iter would otherwise shatter into
    per-iteration segments, each with a host copy)."""
    iters = segment_steps(max_iter, rows, _LR_ROW_ITERS_BUDGET, features)
    if tol > 0:
        capped = largest_divisor(max_iter, min(iters, _LR_CHECK_ITERS))
        if capped >= min(iters, 5):
            iters = capped
    return iters


def _fit(
    W, b, X, y, max_iter: int, l2: float, tol: float = _LR_TOL, weights=None, mesh=None,
    first=None,
):
    """L-BFGS in segments of ``iters`` iterations (the reference's
    ``segment_steps`` over ``_LR_ROW_ITERS_BUDGET``, capped at
    ``_LR_CHECK_ITERS`` for the convergence check), stopping at the top
    of a segment once the trailing losses plateau. Returns ``(W, b,
    losses)``: the losses of every iteration run, on the device. One host
    copy a segment: its losses, for the plateau check.

    Crash resume (reference :341-405): a progress sink bound by
    ``ml/builder.py`` (``ml/progress.py``) saves ``(params, opt_state)``
    in the reference's leaf order (``checkpoint.LBFGS_LEAVES``), the
    losses so far and the plateau window after each segment, and a fit
    that finds a valid artifact re-enters the loop at its segment. The
    artifact must match this call's segmentation (``iters``,
    ``max_iter``, ``l2``) and every leaf's shape and dtype; anything else
    restarts the fit clean. Each segment re-seeds ``value`` and ``grad``
    at entry, so a resumed fit is bit-identical to an uninterrupted one.

    On a ``mesh`` (X, y and the row ``weights`` this rank's block, the
    reference's sharded ``_fit`` with the mask as weights): the segments
    are cut from the global padded rows, as the reference's, and every
    rank holds the same values, steps and losses, so the plateau check
    stops every rank at the same segment (a stop decided from one rank's
    own values would leave the others in their next collective). On a class
    shard (``first``, W and b this rank's classes) every rank of the model
    group holds the same values too; no progress is saved (a shard's leaves
    are not a resumable fit's)."""
    if max_iter <= 0:  # MLlib allows maxIter=0: the initial model
        return W, b, W.new_zeros(0)
    rows = X.shape[0] * (mesh.shape["data"] if mesh is not None else 1)
    iters = _segment_iters(max_iter, rows, X.shape[1], tol)
    state = _lbfgs_state(W, b)
    losses = []
    # trailing pre-step losses across segment boundaries (the resume key's
    # ``history``); a plateau needs every delta in the window to be small
    history: list[float] = []
    window = _LR_STOP_DELTAS + 1
    total_segments = max_iter // iters
    key = {"iters": iters, "max_iter": max_iter, "l2": float(l2)}
    sink = _progress.current_sink() if first is None else None
    start = 0
    if sink is not None:
        restored = sink.load("logistic")
        if restored is not None:
            done, arrays, scalars = restored
            params = None
            if (
                all(scalars.get(name) == value for name, value in key.items())
                and 0 < done <= total_segments
                and len(arrays) >= 1
            ):
                params = _progress.device_restore(({"w": W, "b": b}, state), arrays[:-1])
            if params is None:
                sink.discard()
            else:
                (x, state), start = params, done
                W, b = x["w"], x["b"]
                losses.append(torch.tensor(np.asarray(arrays[-1], np.float32), device=W.device))
                history.extend(float(v) for v in scalars.get("history") or [])
                del history[:-window]
                _progress.segments_skipped(done)
    for index in range(start, total_segments):
        # the plateau check at the top, so that a resumed fit that had
        # already converged stops where the uninterrupted one did
        if tol > 0 and _plateaued(history, tol, window):
            break
        W, b, state, segment_losses = _fit_segment_impl(
            W, b, state, X, y, iters, l2, weights, mesh, first)
        losses.append(segment_losses)
        if tol > 0:
            history.extend(float(v) for v in to_host(segment_losses))
            del history[:-window]
        if sink is not None:
            sink.save(
                "logistic",
                index + 1,
                [to_host(leaf) for leaf in _progress.tree_leaves(({"w": W, "b": b}, state))]
                + [to_host(torch.cat(losses))],
                {**key, "history": list(history)},
            )
    return W, b, torch.cat(losses)


def scaler_stats(X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The host-side standardization scaler: float64 mean, and std with
    zero-variance features pinned to 1 (reference ``ml/logistic.py:437``,
    exactly)."""
    mean = np.asarray(X, np.float64).mean(axis=0)
    std = np.asarray(X, np.float64).std(axis=0)
    return mean, np.where(std > 0, std, 1.0)


def _standardized(X, mean, scale) -> np.ndarray:
    """The fit's rows: standardized in float64 on the host, then float32,
    as the reference sends them to its device."""
    return ((np.asarray(X) - mean) / scale).astype(np.float32)


# --------------------------------------------------------------------------
# K8′: the masked scaler and the standardization of a rank's block of rows
# --------------------------------------------------------------------------

def _check_block(X, w, *params):
    if not isinstance(X, torch.Tensor) or X.dim() != 2:
        raise TypeError("X must be a 2-D tensor of a block's rows")
    if X.dtype not in FEATURE_DTYPES:
        raise TypeError("X must be float32 or bfloat16")
    if w.dtype != torch.float32 or tuple(w.shape) != (X.shape[0],):
        raise TypeError("w must be float32, one weight a row of X")
    for tensor in (w, *params):
        if tensor.device != X.device:
            raise ValueError(f"operands on {tensor.device} and {X.device}")


def _bf16(values):
    """``values`` rounded to bfloat16 as float32 rounds (through float32:
    the reference's float32 sums, then its bfloat16 result)."""
    return values.to(torch.float32).to(torch.bfloat16)


def _masked_col_sums(X, w, mean=None):
    """The plain twin of :func:`masked_col_sums`: ``[sum w x_f ... | sum
    w]``, or about ``mean`` ``[sum w (x_f - mean_f)^2 ... | sum w]``, in
    float64 (the same products; the adds in torch's order). On bfloat16
    rows each term is the reference's bfloat16 one: ``bf16(x w)``, and
    about the bfloat16 mean ``bf16(bf16(d d) w)``, ``d = bf16(x - mean)``."""
    wd = w.to(torch.float64)
    if X.dtype == torch.bfloat16:
        x, wf = X.to(torch.float32), w[:, None]
        if mean is None:
            terms = _bf16(x * wf)
        else:
            d = _bf16(x - mean.to(torch.float32)).to(torch.float32)
            terms = _bf16(_bf16(d * d).to(torch.float32) * wf)
        return torch.cat([terms.to(torch.float64).sum(dim=0), wd.sum()[None]])
    if mean is None:
        terms = X.to(torch.float64) * wd[:, None]
    else:
        centred = X.to(torch.float64) - mean
        terms = centred * centred * wd[:, None]
    return torch.cat([terms.sum(dim=0), wd.sum()[None]])


# K8′'s column sums split a block's rows in chunks of their own (not
# kernels.row_chunks): as many as make _SUMS_BLOCKS blocks with the feature
# windows, two resident blocks of 512 threads on each of an H100's 132 SMs
# (scaler.cu's launch bounds: one wave), and no more than leave each at
# least _SUMS_MIN_CHUNK_ROWS rows (one chunk below that). Rows of up to 64
# features are one window, wider rows windows of 32 (scaler.cu
# `window_features`). A function of (rows, F) alone, so that the order of
# every float64 add, and with it a fit, repeats bit for bit.
_SUMS_BLOCKS = 2 * 132
_SUMS_MIN_CHUNK_ROWS = 1024


def _sums_windows(num_features: int) -> int:
    return 1 if num_features <= 64 else -(-num_features // 32)


def _sums_chunks(rows: int, num_features: int) -> tuple[int, int]:
    """``(chunks, rows per chunk)`` of K8′'s column sums, with no empty
    chunk (none at 0 rows: the kernel then runs one block of no rows)."""
    by_blocks = -(-_SUMS_BLOCKS // _sums_windows(num_features))
    chunks = max(1, min(by_blocks, rows // _SUMS_MIN_CHUNK_ROWS))
    per_chunk = max(1, -(-rows // chunks))
    return -(-rows // per_chunk), per_chunk


def masked_col_sums(X, w, mean=None):
    """A block's float64 column sums weighted by its rows' ``w``, and the
    sum of ``w``: ``(F + 1,)``. Pass 1 (``mean=None``) sums ``w x``; the
    centred pass sums ``w (x - mean)^2`` about the float64 ``mean``. X is
    float32, or bfloat16 (each term then rounded as the reference's
    bfloat16 arithmetic rounds it, about a bfloat16 ``mean`` given as
    float64: :func:`_masked_col_sums`). On a CUDA tensor one launch of the
    kernel (``kernels/csrc/scaler.cu``) adds in an order fixed by the
    shape: the chunks of :func:`_sums_chunks`, its last block adding their
    sums."""
    _check_block(X, w, *(() if mean is None else (mean,)))
    if mean is not None and (mean.dtype != torch.float64 or tuple(mean.shape) != (X.shape[1],)):
        raise TypeError("mean must be float64, one a feature")
    if X.device.type == "cpu":
        return _masked_col_sums(X, w, mean)
    kernels.check_operands(X, w, *(() if mean is None else (mean,)))
    rows, num_features = X.shape
    chunks, per_chunk = _sums_chunks(rows, num_features)
    chunks = max(chunks, 1)
    partials = torch.empty((chunks, num_features + 1), dtype=torch.float64, device=X.device)
    ticket = kernels.zeroed_scratch(X.device, 1)
    out = torch.empty(num_features + 1, dtype=torch.float64, device=X.device)
    kernels.launch(
        "masked_col_sums" if mean is None else "masked_col_sums_centred", "lo_masked_col_sums",
        X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(),
        None if mean is None else mean.data_ptr(),
        partials.data_ptr(), ticket.data_ptr(), out.data_ptr(), rows, num_features, chunks,
        per_chunk, X.device.index, _stream(X),
    )
    return out


def masked_stats(X, w, mesh=None):
    """The mean and scale of each feature over the rows of every data rank
    (reference ``_masked_stats``, :412): two passes of
    :func:`masked_col_sums`, each rank's sums gathered and added in rank
    order in float64; the float64 mean, the variance about it, ``std =
    sqrt(var)``, each rounded once to float32, a std of 0 pinned to 1.
    Returns ``(mean, scale)``, float32, the same bits on every rank. Two
    passes, as the reference: ``E[x^2] - mean^2`` cancels on features with
    large means. ``mesh=None``: this block's rows alone.

    On bfloat16 rows the reference computes in bfloat16: its count, sums,
    mean, variance and std are bfloat16, so here each total is rounded
    once (float32, then bfloat16), and ``mean = sum / count``, ``var``
    and ``sqrt`` are bfloat16 operations; ``(mean, scale)`` are bfloat16."""
    from learningorchestra_tpu_torch.parallel.multihost import all_sum

    def across(sums):
        return sums if mesh is None else all_sum(sums, mesh)

    if X.dtype == torch.bfloat16:
        first = across(masked_col_sums(X, w))
        count = _bf16(first[-1]).to(torch.float32)
        mean = _bf16(_bf16(first[:-1]).to(torch.float32) / count)
        second = across(masked_col_sums(X, w, mean.to(torch.float64)))
        var = _bf16(_bf16(second[:-1]).to(torch.float32) / count)
        std = _bf16(torch.sqrt(var.to(torch.float32)))
        return mean, torch.where(std > 0, std, torch.ones_like(std))
    first = across(masked_col_sums(X, w))
    total = first[-1]
    mean = first[:-1] / total
    second = across(masked_col_sums(X, w, mean))
    std = torch.sqrt(second[:-1] / total).to(torch.float32)
    return mean.to(torch.float32), torch.where(std > 0, std, torch.ones_like(std))


def _standardize(X, mean, scale, w):
    """The plain twin of :func:`standardize` (reference :426, exactly): on
    bfloat16 rows each operation rounded to bfloat16."""
    if X.dtype == torch.bfloat16:
        centred = _bf16(X.to(torch.float32) - mean.to(torch.float32)).to(torch.float32)
        scaled = _bf16(centred / scale.to(torch.float32)).to(torch.float32)
        return _bf16(scaled * w[:, None])
    return ((X - mean) / scale) * w[:, None]


def standardize(X, mean, scale, w):
    """``((X - mean) / scale) * w`` in X's type, row by row: a block's rows
    standardized, its padded rows (w = 0) zeroed. Float32 rows take a
    float32 mean and scale; bfloat16 rows the bfloat16 ones of
    :func:`masked_stats`, each operation rounded to bfloat16. On a CUDA
    tensor the kernel (``kernels/csrc/scaler.cu``) rounds each operation
    on its own, so its output is bit-equal to the plain twin's."""
    _check_block(X, w, mean, scale)
    for name, value in (("mean", mean), ("scale", scale)):
        if value.dtype != X.dtype or tuple(value.shape) != (X.shape[1],):
            raise TypeError(f"{name} must be of X's type, one a feature")
    if X.device.type == "cpu":
        return _standardize(X, mean, scale, w)
    kernels.check_operands(X, mean, scale, w)
    mean, scale = mean.to(torch.float32), scale.to(torch.float32)   # bfloat16 widened exactly
    out = torch.empty_like(X)
    kernels.launch(
        "masked_standardize", "lo_masked_standardize",
        X.data_ptr(), int(X.dtype == torch.bfloat16), mean.data_ptr(), scale.data_ptr(),
        w.data_ptr(), out.data_ptr(), X.shape[0], X.shape[1],
        kernels.max_blocks(X.device.index), X.device.index, _stream(X),
    )
    return out


# --------------------------------------------------------------------------
# Prediction and the estimator
# --------------------------------------------------------------------------

def _forward(X, w, b, mean, scale):
    # bfloat16 X widens exactly first, as jnp promotes it against the
    # float32 mean (torch's mixed matmul would raise instead)
    logits = torch.matmul((X.to(torch.float32) - mean) / scale, w) + b
    return torch.softmax(logits, dim=1)


class LogisticRegressionModel(FittedModel):
    """``mesh``: the mesh it was fitted on; over a data axis of several
    ranks, its predictions and metrics run on each rank's block of rows
    (``ml/base.FittedModel``). The parameters are the same on every rank."""

    def __init__(self, w, b, mean, scale, mesh=None):
        self.w = w            # (F, C)
        self.b = b            # (C,)
        self.mean = mean      # (F,)
        self.scale = scale    # (F,)
        self.device = w.device
        self.mesh = mesh

    def _forward(self, X):
        return _forward(X, self.w, self.b, self.mean, self.scale)


class LogisticRegression:
    """MLlib's defaults: ``maxIter=100``, ``regParam=0.0``, ``tol=1e-6``,
    fit-intercept, internal standardization.

    ``mesh``: the ranks to fit over (``parallel/mesh.py``), by default
    every rank of the process group, as the reference's ``resolve_mesh``:
    in one process a 1×1 mesh on ``device``, and the single-device fit.
    Over a model axis of M ranks the classes are sharded when M divides
    them (the reference's ``_fit_prepared``). ``loss_history_``: the last
    fit's losses, on the device."""

    def __init__(
        self,
        max_iter: int = 100,
        reg_param: float = 0.0,
        tol: float = _LR_TOL,
        device: DeviceLike = None,
        mesh=None,
    ):
        from learningorchestra_tpu_torch.parallel.mesh import default_mesh

        self.max_iter = max_iter
        self.reg_param = reg_param
        self.tol = tol
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self.device = self.mesh.device
        self.loss_history_ = None

    def fit(self, X, y) -> LogisticRegressionModel:
        """Every rank passes the full rows (the reference's SPMD call); over
        several data ranks each fits on its block of the padded rows, the
        mask as row weights."""
        from learningorchestra_tpu_torch.parallel.sharding import shard_rows

        num_classes = infer_num_classes(y)
        mean, scale = scaler_stats(X)
        mean32 = torch.from_numpy(mean.astype(np.float32)).to(self.device)
        scale32 = torch.from_numpy(scale.astype(np.float32)).to(self.device)
        if self.mesh.shape["data"] > 1 or self.mesh.shape["model"] > 1:
            # the standardized rows in the policy's type (reference :476-479)
            X_dev, mask = shard_rows(_standardized(X, mean, scale), self.mesh, dtype=np.float32)
            y_dev, _ = shard_rows(np.asarray(y), self.mesh, dtype=np.int32)
            return self._fit_prepared(X_dev, y_dev, mask, num_classes, mean32, scale32)
        # the standardized rows in the policy's type (reference :476-478)
        X_dev = shard_matrix(_standardized(X, mean, scale), self.device)
        y_dev = torch.from_numpy(np.asarray(y, dtype=np.int32)).to(self.device)
        W = torch.zeros((X_dev.shape[1], num_classes), dtype=torch.float32, device=self.device)
        b = torch.zeros(num_classes, dtype=torch.float32, device=self.device)
        W, b, self.loss_history_ = _fit(
            W, b, X_dev, y_dev, self.max_iter, float(self.reg_param), self.tol)
        return LogisticRegressionModel(W, b, mean32, scale32)

    def fit_sharded(self, X_dev, y_dev, mask, num_classes: int) -> LogisticRegressionModel:
        """Fit from this rank's block of rows (reference :489): pair with
        ``parallel.shard_rows_local``, so that each rank loads only its
        ``host_row_range`` rows and no process holds the full matrix. The
        standardization runs on the device from the blocks (K8′:
        :func:`masked_stats`, :func:`standardize`); ``num_classes`` must be
        given, since no rank sees every label."""
        weights = mask.to(torch.float32)
        mean, scale = masked_stats(X_dev, weights, self.mesh)
        X_std = standardize(X_dev, mean, scale, weights)
        return self._fit_prepared(
            X_std, y_dev.to(torch.int32), mask, num_classes, mean.to(torch.float32),
            scale.to(torch.float32))

    def _fit_prepared(self, X_dev, y_dev, mask, num_classes, mean, scale) -> LogisticRegressionModel:
        """The data-parallel fit of a block: the mask as row weights (the
        reference's sharded ``_fit``, :551). Over a model axis of M ranks
        that divides the classes, this rank fits its shard of W and b
        (classes ``[m C/M, (m+1) C/M)``) with its model group, and the
        shards are gathered in class order at the end; else the
        reference's warning, and W and b replicate."""
        from learningorchestra_tpu_torch.parallel.mesh import model_size, over_model

        model = model_size(self.mesh)
        shardable = num_classes % model == 0
        if not shardable:
            import warnings

            warnings.warn(
                f"LogisticRegression: {num_classes} classes do not divide "
                f"the model axis ({model} devices); W/b "
                "replicate and the model axis adds no parallelism for "
                "this fit",
                stacklevel=3,
            )
        first, classes = None, num_classes
        if shardable and over_model(self.mesh):
            classes = num_classes // model
            first = self.mesh.model_index * classes
        W = torch.zeros((X_dev.shape[1], classes), dtype=torch.float32, device=self.device)
        b = torch.zeros(classes, dtype=torch.float32, device=self.device)
        W, b, self.loss_history_ = _fit(
            W, b, X_dev, y_dev, self.max_iter, float(self.reg_param), self.tol,
            weights=mask.to(torch.float32), mesh=self.mesh, first=first,
        )
        if first is not None:
            from learningorchestra_tpu_torch.parallel.multihost import model_all_gather

            W = torch.cat(model_all_gather(W, self.mesh), dim=1)
            b = torch.cat(model_all_gather(b, self.mesh))
        return LogisticRegressionModel(W, b, mean, scale, mesh=self.mesh)
