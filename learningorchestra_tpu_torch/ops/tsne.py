"""t-SNE on the card: exact, with a landmark path past the O(n²) wall.

Counterpart of ``learningorchestra_tpu/ops/tsne.py``: on one CUDA card,
or over a data axis of several ranks (a ``mesh``), where each rank owns a
slab of P's rows (the reference's ``shard_map`` over its data axis; see
"Over ranks" below).

- K11 ``affinities``: each row's conditional affinities, calibrated to
  the target perplexity by a 32-step bisection on beta, then
  symmetrised. The calibration is two hand CUDA kernels (``tsne.cu``):
  the distances into P by tiles of X, then several rows a block
  calibrated in place (``_k11_geometry``); its plain twin is
  ``_conditional_affinities``.
- K12 ``gradient``: one iteration's gradient as two launches, the
  normalizer Z (``tsne_z``) and the gradient itself (``tsne_grad``),
  with no ``(n, n)`` q in memory and no host sync; the update of
  momentum, gains and Y stays torch ops on ``(n, 2)`` (``_optimize``).
  Both do each unordered pair of rows once, a block per unordered pair
  of ``PAIR_TILE``-row tiles (``_tile_pairs``), and each runs a second
  kernel that adds the blocks' float64 partials in a fixed order (a
  launch counts the wrapper's call).
- K13 ``interpolate``: out-of-sample placement of the rows onto the
  landmarks' embedding, one launch a macro block. K11 and K13 calibrate
  with one exp a column and bisection step (the entropy by the identity
  ``(T/T') log T' + Σ e (−l) / T'``).

Each wrapper takes its plain version only because its tensors lie on the
CPU; on a CUDA tensor it launches the kernel or raises.

No padding: the reference pads rows to its mesh's bucketed shapes
(``_pad_for_mesh``), and padded rows carry zero affinity and zero
repulsion weight, so the port runs at ``n`` rows.

Over ranks (``mesh`` with a data axis of several ranks): X is replicated
and unpadded, and rank r owns P's rows ``host_row_range(n, mesh)`` (the
block rule of the rows, clamped to n). K11's row-slab form calibrates the
slab; the slabs are gathered (padded to the block only for the
collective) and each rank takes its rows of ``(P + Pᵀ) / 2n``, where the
reference lets XLA transpose across devices. Each iteration K12's
row-slab form gives the slab's float64 part of Z, every rank's added in
rank order and rounded once before any rank divides, then the slab's
gradient rows, gathered so that Y, the velocity and the gains stay
replicated (the reference's ``_optimize``). ``Y0`` comes from the same
seeded generator on every rank. The landmark path runs that exact fit on
the landmarks, then K13 on each rank's block of rows, gathered.

The random start: the reference draws ``Y0`` from JAX's threefry over its
padded row count. The port's ``_tsne_exact`` and ``_tsne_landmark`` take
``Y0`` as an input, and ``tsne_embedding`` draws it on the device from a
``torch.Generator`` seeded with ``seed`` (``_initial_embedding``). One
seed so starts each package elsewhere; each refits its own bit for bit.
The landmarks are numpy's ``default_rng(seed).choice``, as in the
reference, so both packages choose the same ones.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.parallel.mesh import over_ranks
from learningorchestra_tpu_torch.parallel.multihost import all_sum, gather_rows, host_row_range

PERPLEXITY = 30.0
ITERATIONS = 1000
EARLY_EXAGGERATION = 12.0
EARLY_PHASE = 250
LEARNING_RATE = 200.0
CHUNK = 1024
# Rows of a tile in K12's unordered tile pairs (tsne.cu's kTile)
PAIR_TILE = 128
# Exact t-SNE holds n² floats of P; past this the landmark path wins.
EXACT_ROWS_LIMIT = 20_000
LANDMARKS = 5_000
INTERP_CHUNK = 8_192
# Rows per interpolation launch, as the reference's rows per program: it
# bounds how long one launch runs at any n.
_INTERP_ROWS_PER_PROGRAM = 4_000_000
BISECTION_STEPS = 32


def _target_entropy(perplexity: float) -> float:
    """``log(perplexity)`` in float32, as the reference's
    ``jnp.log(jnp.float32(perplexity))``; the kernels and their plain
    twins take the same value."""
    return float(torch.log(torch.tensor(perplexity, dtype=torch.float32)))


def _clamped_perplexity(perplexity: float, rows: int) -> float:
    """The reference's clamp for small inputs (:286, :381)."""
    return min(perplexity, max((rows - 1) / 3.0, 1.0))


# --------------------------------------------------------------------------
# Plain versions: the reference's expressions, the CPU path and the
# kernels' yardstick on the card
# --------------------------------------------------------------------------

def _squared_distances(A, B):
    """``‖a‖² + ‖b‖² − 2 a·b`` clamped at 0, a float32 product (TF32 off,
    ``device.pin_fp32``)."""
    return torch.clamp_min(
        (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * (A @ B.T), 0.0
    )


def _calibrate_row_block(block_distances, excluded, target: float):
    """Per-row Gaussian bandwidths matching ``target`` entropy, by
    bisection on beta = 1/(2σ²); returns the rows' normalised p.
    ``excluded`` masks the columns that get zero affinity (each row's own
    column): self is excluded by index, so duplicate rows keep their
    maximal mutual affinity."""
    keep = ~excluded

    def entropy_and_p(beta):
        logits = -block_distances * beta[:, None]
        logits = logits - logits.amax(dim=1, keepdim=True)
        p = torch.exp(logits) * keep
        total = torch.clamp_min(p.sum(dim=1, keepdim=True), 1e-12)
        p = p / total
        entropy = -torch.where(p > 0, p * torch.log(p), 0.0).sum(dim=1)
        return entropy, p

    rows = block_distances.shape[0]
    like = dict(dtype=torch.float32, device=block_distances.device)
    low = torch.zeros(rows, **like)
    high = torch.full((rows,), float("inf"), **like)
    beta = torch.ones(rows, **like)
    for _ in range(BISECTION_STEPS):
        entropy, _ = entropy_and_p(beta)
        too_high = entropy > target  # entropy too high → increase beta
        low = torch.where(too_high, beta, low)
        high = torch.where(too_high, high, beta)
        beta = torch.where(torch.isinf(high), beta * 2.0, (low + high) / 2.0)
    _, p = entropy_and_p(beta)
    return p


def _conditional_affinities(X, perplexity: float, chunk: int = CHUNK):
    """K11's plain twin: each row's calibrated p over all ``n`` columns,
    a block of ``chunk`` rows at a time (the reference's ``local_slab``)."""
    n = X.shape[0]
    target = _target_entropy(perplexity)
    P = torch.empty((n, n), dtype=torch.float32, device=X.device)
    columns = torch.arange(n, device=X.device)
    for start in range(0, n, chunk):
        rows = columns[start : start + chunk]
        distances = _squared_distances(X[start : start + chunk], X)
        excluded = rows[:, None] == columns[None, :]
        P[start : start + chunk] = _calibrate_row_block(distances, excluded, target)
    return P


def _symmetrize(P):
    """``(P + Pᵀ) / (2n)`` floored at 1e-12, out of place (an in-place
    ``P.add_(P.T)`` would read what it writes)."""
    n = P.shape[0]
    out = P + P.T
    # a true division by float32(2n), as the reference's; a Python scalar
    # divisor may become a multiplication by its reciprocal on the card
    out /= torch.tensor(2.0 * n, dtype=torch.float32, device=P.device)
    return out.clamp_min_(1e-12)


def _affinities(X, perplexity: float, chunk: int = CHUNK):
    """The symmetrised affinities P, in plain torch (reference ``:122``)."""
    return _symmetrize(_conditional_affinities(X, perplexity, chunk))


def _pair_mask(n: int, device):
    return ~torch.eye(n, dtype=torch.bool, device=device)


def _tsne_z(Y):
    """K12's first plain pass: ``Z = Σ_{i≠j} 1/(1 + d_ij)``, a ``(1,)``
    tensor."""
    inv = (1.0 / (1.0 + _squared_distances(Y, Y))) * _pair_mask(Y.shape[0], Y.device)
    return inv.sum().reshape(1)


def _tsne_grad(Y, P, Z, exaggeration: float):
    """K12's second plain pass: the gradient at ``Y`` given ``Z``, the
    reference's ``gradient`` (``:192-205``) with ``P`` exaggerated."""
    inv = (1.0 / (1.0 + _squared_distances(Y, Y))) * _pair_mask(Y.shape[0], Y.device)
    Q = inv / torch.clamp_min(Z, 1e-12)
    W = (P * exaggeration - torch.clamp_min(Q, 1e-12)) * inv
    return 4.0 * (W.sum(dim=1)[:, None] * Y - W @ Y)


def _interpolate(X, landmarks, Y_landmarks, perplexity: float, chunk: int = INTERP_CHUNK):
    """K13's plain twin: each row's calibrated affinities to the landmarks
    (nothing excluded), then ``p @ Y_L``, a block of ``chunk`` rows at a
    time (reference ``:315``)."""
    target = _target_entropy(perplexity)
    out = torch.empty((X.shape[0], 2), dtype=torch.float32, device=X.device)
    for start in range(0, X.shape[0], chunk):
        distances = _squared_distances(X[start : start + chunk], landmarks)
        excluded = torch.zeros(distances.shape, dtype=torch.bool, device=X.device)
        p = _calibrate_row_block(distances, excluded, target)
        out[start : start + chunk] = p @ Y_landmarks
    return out


def _conditional_affinities_slab(X, perplexity: float, first: int, slab: int, chunk: int = CHUNK):
    """K11's row-slab twin: rows ``first .. first + slab - 1`` of
    :func:`_conditional_affinities`, ``(slab, n)``, each row's own column
    excluded."""
    n = X.shape[0]
    target = _target_entropy(perplexity)
    P = torch.empty((slab, n), dtype=torch.float32, device=X.device)
    columns = torch.arange(n, device=X.device)
    for start in range(0, slab, chunk):
        stop = min(start + chunk, slab)
        rows = columns[first + start : first + stop]
        distances = _squared_distances(X[first + start : first + stop], X)
        excluded = rows[:, None] == columns[None, :]
        P[start:stop] = _calibrate_row_block(distances, excluded, target)
    return P


def _slab_inverse(Y, first: int, slab: int):
    """``1 / (1 + d_ij)`` of the slab's rows against every row, 0 on each
    row's own column: the rows of :func:`_tsne_z`'s and :func:`_tsne_grad`'s
    inverse distances."""
    inv = 1.0 / (1.0 + _squared_distances(Y[first : first + slab], Y))
    inv[torch.arange(slab, device=Y.device), torch.arange(first, first + slab, device=Y.device)] = 0.0
    return inv


def _tsne_z_slab(Y, first: int, slab: int):
    """K12's row-slab twin, pass 1: the slab's float64 part of Z, ``(1,)``:
    its float32 inverse distances added in float64."""
    return _slab_inverse(Y, first, slab).to(torch.float64).sum().reshape(1)


def _tsne_grad_slab(Y, P_slab, Z, first: int, exaggeration: float):
    """K12's row-slab twin, pass 2: the gradient ``(slab, 2)`` of the slab's
    rows given the global ``Z``, with ``P_slab`` the slab's rows of P."""
    slab = P_slab.shape[0]
    inv = _slab_inverse(Y, first, slab)
    Q = inv / torch.clamp_min(Z, 1e-12)
    W = (P_slab * exaggeration - torch.clamp_min(Q, 1e-12)) * inv
    return 4.0 * (W.sum(dim=1)[:, None] * Y[first : first + slab] - W @ Y)


# --------------------------------------------------------------------------
# Kernel wrappers (K11, K12, K13)
# --------------------------------------------------------------------------

# A row's distances stay in shared memory when they fit beside the
# kernels' static shared memory (2 KB)
_SHARED_DISTANCE_BYTES = kernels.SHARED_BYTES - 2048
# K11's blocks: 1,024 threads over as many rows (a power of two, at most
# 32: a warp a row) as keep their distances within 160 KB, when that is 8
# rows or more; else 512 threads over as many as fit 80 KB, so that two
# blocks share an SM (the faster of the two at 5,000 and 20,000 rows)
_K11_GEOMETRIES = ((1024, 160 * 1024, 8), (512, 80 * 1024, 1))


@functools.lru_cache(maxsize=16)
def _tile_pairs(n: int):
    """K12's split of the ``n`` rows: ``(tiles, pairs)``, the count of
    ``PAIR_TILE``-row tiles and the unordered tile pairs ``(I, J)``,
    ``I <= J``, in the order of the kernels' blocks (row-major over the
    upper triangle; ``tsne.cu`` ``tile_pair_at``). Z keeps one float64 slot a
    pair; the gradient a ``(tiles, n, 3)`` float64 buffer of partials,
    where slot ``K`` of row ``r`` comes from the pair of ``r``'s tile with
    tile ``K``."""
    tiles = -(-n // PAIR_TILE)
    return tiles, tuple((I, J) for I in range(tiles) for J in range(I, tiles))


def _check_float32(*tensors) -> None:
    for tensor in tensors:
        if tensor.dtype != torch.float32:
            raise TypeError(f"t-SNE kernels take float32, got {tensor.dtype}")


def _check_embedding(*tensors) -> None:
    """``(rows, 2)`` float32; read as float2 by the kernels."""
    for tensor in tensors:
        if tensor.dim() != 2 or tensor.shape[1] != 2:
            raise ValueError(f"an embedding is (rows, 2), got {tuple(tensor.shape)}")
        if tensor.device.type == "cuda" and tensor.data_ptr() % 8:
            raise ValueError("an embedding must be 8-byte aligned")


def _stream(tensor):
    return torch.cuda.current_stream(tensor.device).cuda_stream


@functools.lru_cache(maxsize=16)
def _k11_geometry(n: int) -> tuple[int, int]:
    """K11's block: ``(rows, threads)``, a function of n alone (so the
    result does not depend on where the distances sit). ``rows`` rows a
    block of ``threads`` threads, each row a group of ``threads / rows``
    (thread t's columns are t + group k)."""
    for threads, budget, least in _K11_GEOMETRIES:
        fit = max(1, budget // (4 * max(n, 1)))
        rows = min(threads // 32, 1 << (fit.bit_length() - 1))
        if rows >= least:
            return rows, threads
    raise AssertionError("the last geometry takes any n")


def conditional_affinities(X, perplexity: float):
    """Each row's calibrated p (n, n), not yet symmetrised (K11). No rows
    raise the reference's error: its calibration takes each row's maximum
    over the columns (``:91``), a reduction that has no identity when
    there are none."""
    _check_float32(X)
    if X.shape[0] == 0:
        raise ValueError("zero-size array to reduction operation max which has no identity")
    if X.device.type == "cpu":
        return _conditional_affinities(X, perplexity)
    kernels.check_operands(X)
    n, num_features = X.shape
    rows, threads = _k11_geometry(n)
    P = torch.empty((n, n), dtype=torch.float32, device=X.device)
    kernels.launch(
        "tsne_affinities", "lo_tsne_affinities",
        X.data_ptr(), P.data_ptr(), n, num_features, _target_entropy(perplexity),
        rows, threads, int(4 * rows * n <= _SHARED_DISTANCE_BYTES),
        kernels.max_blocks(X.device.index), X.device.index, _stream(X),
    )
    return P


def affinities(X, perplexity: float):
    """The symmetrised affinities P (K11, then torch ops)."""
    return _symmetrize(conditional_affinities(X, perplexity))


def tsne_z(Y):
    """``Z``, a ``(1,)`` float32 tensor left on the device (K12, pass 1)."""
    _check_float32(Y)
    _check_embedding(Y)
    if Y.device.type == "cpu":
        return _tsne_z(Y)
    kernels.check_operands(Y)
    n = Y.shape[0]
    tiles, pairs = _tile_pairs(n)
    slots = torch.empty(len(pairs), dtype=torch.float64, device=Y.device)
    Z = torch.empty(1, dtype=torch.float32, device=Y.device)
    kernels.launch(
        "tsne_z", "lo_tsne_z",
        Y.data_ptr(), slots.data_ptr(), Z.data_ptr(), n, tiles,
        Y.device.index, _stream(Y),
    )
    return Z


def tsne_grad(Y, P, Z, exaggeration: float):
    """The gradient ``(n, 2)`` at ``Y`` given ``Z`` (K12, pass 2); the
    exaggeration multiplies ``P`` inside the kernel."""
    _check_float32(Y, P, Z)
    _check_embedding(Y)
    n = Y.shape[0]
    if P.shape != (n, n) or Z.shape != (1,):
        raise ValueError(f"P must be ({n}, {n}) and Z (1,), got {tuple(P.shape)}, {tuple(Z.shape)}")
    if Y.device.type == "cpu":
        return _tsne_grad(Y, P, Z, exaggeration)
    kernels.check_operands(Y, P, Z)
    tiles, _ = _tile_pairs(n)
    partials = torch.empty((tiles, n, 3), dtype=torch.float64, device=Y.device)
    grad = torch.empty((n, 2), dtype=torch.float32, device=Y.device)
    kernels.launch(
        "tsne_grad", "lo_tsne_grad",
        Y.data_ptr(), P.data_ptr(), Z.data_ptr(), partials.data_ptr(), grad.data_ptr(),
        n, tiles, exaggeration, Y.device.index, _stream(Y),
    )
    return grad


def gradient(Y, P, exaggeration: float):
    """One iteration's gradient: two launches, no host sync."""
    return tsne_grad(Y, P, tsne_z(Y), exaggeration)


def _check_slab(n: int, first: int, slab: int) -> None:
    if first < 0 or slab < 0 or first + slab > n:
        raise ValueError(f"rows [{first}, {first + slab}) are not a slab of {n} rows")


def conditional_affinities_slab(X, perplexity: float, first: int, slab: int):
    """Rows ``first .. first + slab - 1`` of :func:`conditional_affinities`,
    ``(slab, n)`` against all n columns (K11's row-slab form). Each row's
    arithmetic is the whole launch's (the geometry is n's), so the rows
    have its bits."""
    _check_float32(X)
    if X.shape[0] == 0:
        raise ValueError("zero-size array to reduction operation max which has no identity")
    n, num_features = X.shape
    _check_slab(n, first, slab)
    if X.device.type == "cpu":
        return _conditional_affinities_slab(X, perplexity, first, slab)
    kernels.check_operands(X)
    rows, threads = _k11_geometry(n)
    P = torch.empty((slab, n), dtype=torch.float32, device=X.device)
    kernels.launch(
        "tsne_affinities_slab", "lo_tsne_affinities_slab",
        X.data_ptr(), P.data_ptr(), n, num_features, first, slab, _target_entropy(perplexity),
        rows, threads, int(4 * rows * n <= _SHARED_DISTANCE_BYTES),
        kernels.max_blocks(X.device.index), X.device.index, _stream(X),
    )
    return P


def tsne_z_slab(Y, first: int, slab: int):
    """The slab's part of Z, a ``(1,)`` float64 tensor on the device: the
    sum over its rows i and every j != i of ``1 / (1 + d_ij)``, not
    rounded (K12's row-slab form, pass 1)."""
    _check_float32(Y)
    _check_embedding(Y)
    _check_slab(Y.shape[0], first, slab)
    if Y.device.type == "cpu":
        return _tsne_z_slab(Y, first, slab)
    kernels.check_operands(Y)
    row_sums = torch.empty(max(slab, 1), dtype=torch.float64, device=Y.device)
    total = torch.empty(1, dtype=torch.float64, device=Y.device)
    kernels.launch(
        "tsne_z_slab", "lo_tsne_z_slab",
        Y.data_ptr(), row_sums.data_ptr(), total.data_ptr(), Y.shape[0], first, slab,
        Y.device.index, _stream(Y),
    )
    return total


def tsne_grad_slab(Y, P_slab, Z, first: int, exaggeration: float):
    """The gradient ``(slab, 2)`` of the slab's rows given the global ``Z``
    (K12's row-slab form, pass 2); ``P_slab`` holds the slab's rows of P,
    read at its stride of n."""
    _check_float32(Y, P_slab, Z)
    _check_embedding(Y)
    n, slab = Y.shape[0], P_slab.shape[0]
    if P_slab.dim() != 2 or P_slab.shape[1] != n or Z.shape != (1,):
        raise ValueError(
            f"P_slab must be (slab, {n}) and Z (1,), got {tuple(P_slab.shape)}, {tuple(Z.shape)}"
        )
    _check_slab(n, first, slab)
    if Y.device.type == "cpu":
        return _tsne_grad_slab(Y, P_slab, Z, first, exaggeration)
    kernels.check_operands(Y, P_slab, Z)
    grad = torch.empty((slab, 2), dtype=torch.float32, device=Y.device)
    kernels.launch(
        "tsne_grad_slab", "lo_tsne_grad_slab",
        Y.data_ptr(), P_slab.data_ptr(), Z.data_ptr(), grad.data_ptr(), n, first, slab,
        exaggeration, Y.device.index, _stream(Y),
    )
    return grad


def interpolate(X, landmarks, Y_landmarks, perplexity: float):
    """Each row of ``X`` placed onto the landmarks' embedding (K13, one
    launch)."""
    _check_float32(X, landmarks, Y_landmarks)
    _check_embedding(Y_landmarks)
    if X.shape[1] != landmarks.shape[1] or landmarks.shape[0] != Y_landmarks.shape[0]:
        raise ValueError("rows, landmarks and their embedding disagree in shape")
    if X.device.type == "cpu":
        return _interpolate(X, landmarks, Y_landmarks, perplexity)
    kernels.check_operands(X, landmarks, Y_landmarks)
    rows, num_features = X.shape
    m = landmarks.shape[0]
    out = torch.empty((rows, 2), dtype=torch.float32, device=X.device)
    blocks = max(1, min(rows, kernels.max_blocks(X.device.index)))
    distances = None
    if 4 * m > _SHARED_DISTANCE_BYTES:
        distances = torch.empty((blocks, m), dtype=torch.float32, device=X.device)
    # the kernel reads the landmarks transposed, (F, m): a warp's loads of a
    # feature are then contiguous
    landmarks_t = landmarks.t().contiguous()
    kernels.launch(
        "tsne_interpolate", "lo_tsne_interpolate",
        X.data_ptr(), landmarks_t.data_ptr(), Y_landmarks.data_ptr(), out.data_ptr(),
        None if distances is None else distances.data_ptr(),
        rows, m, num_features, _target_entropy(perplexity),
        blocks, X.device.index, _stream(X),
    )
    return out


# --------------------------------------------------------------------------
# The fits
# --------------------------------------------------------------------------

def _affinities_over_ranks(X, perplexity: float, mesh):
    """This rank's rows ``[first, first + slab)`` of the symmetrised P,
    ``(slab, n)``, and ``first``: K11's row slab, the slabs gathered, then
    the rank's rows of ``(P + Pᵀ) / 2n`` (the bits of :func:`affinities`'
    rows)."""
    n = X.shape[0]
    first, stop = host_row_range(n, mesh)
    conditional = gather_rows(conditional_affinities_slab(X, perplexity, first, stop - first), n, mesh)
    rows = conditional[first:stop] + conditional[:, first:stop].T
    rows /= torch.tensor(2.0 * n, dtype=torch.float32, device=X.device)
    return rows.clamp_min_(1e-12), first


def _gradient_over_ranks(Y, P_slab, first: int, exaggeration: float, mesh):
    """One iteration's gradient ``(n, 2)`` over ranks: the slab's part of Z
    (K12's row slab), every rank's added in float64 in rank order and
    rounded once; the slab's gradient rows given that Z, gathered."""
    Z = all_sum(tsne_z_slab(Y, first, P_slab.shape[0]), mesh).to(torch.float32)
    return gather_rows(tsne_grad_slab(Y, P_slab, Z, first, exaggeration), Y.shape[0], mesh)


def _optimize(
    P, Y0, iterations: int, early_phase: int, learning_rate: float, exaggeration: float,
    mesh=None, first: int = 0,
):
    """Gradient descent with momentum and adaptive gains (reference
    ``:170-233``): the gradient by K12, the ``(n, 2)`` update in torch
    ops. Python control flow only: nothing waits for the device. Over
    ranks (``mesh``), ``P`` is this rank's rows from ``first`` and the
    gradient every rank's (:func:`_gradient_over_ranks`); Y stays
    replicated."""
    Y = Y0.clone()
    velocity = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    for i in range(iterations):
        early = i < early_phase
        if over_ranks(mesh):
            grad = _gradient_over_ranks(Y, P, first, exaggeration if early else 1.0, mesh)
        else:
            grad = gradient(Y, P, exaggeration if early else 1.0)
        momentum = 0.5 if early else 0.8
        same_sign = torch.sign(grad) == torch.sign(velocity)
        gains = torch.clamp_min(torch.where(same_sign, gains * 0.8, gains + 0.2), 0.01)
        velocity = momentum * velocity - learning_rate * gains * grad
        Y = Y + velocity
    return Y


def _tsne_exact(X, perplexity: float, iterations: int, learning_rate: float, Y0, mesh=None):
    """Exact t-SNE of the float32 rows ``X`` from the start ``Y0``
    ``(n, 2)``: the reference's ``_tsne_exact`` and
    ``_tsne_exact_on_device`` in one, since ``X`` is already a tensor on
    its device. Returns ``(n, 2)`` on that device (on every rank, over
    the ranks of ``mesh``)."""
    n = X.shape[0]
    perplexity = _clamped_perplexity(perplexity, n)
    first = 0
    if over_ranks(mesh):
        P, first = _affinities_over_ranks(X, perplexity, mesh)
    else:
        P = affinities(X, perplexity)
    return _optimize(
        P, Y0, iterations, min(EARLY_PHASE, iterations // 2),
        learning_rate, EARLY_EXAGGERATION, mesh, first,
    )


def _choose_landmarks(n: int, landmarks: int, seed: int) -> np.ndarray:
    """The landmark rows: numpy's ``default_rng(seed).choice`` of
    ``min(landmarks, n)`` of the ``n`` rows without replacement, as the
    reference chooses them."""
    return np.random.default_rng(seed).choice(n, size=min(landmarks, n), replace=False)


def _tsne_landmark(
    X, perplexity: float, iterations: int, learning_rate: float, seed: int,
    landmarks: int, Y0, mesh=None,
):
    """Exact t-SNE on ``landmarks`` rows chosen by numpy's
    ``default_rng(seed)`` (from the start ``Y0``, one row a landmark),
    then every row placed by K13, a macro block of rows a launch. Its
    phases are the reference's spans, ``tsne:landmark_fit`` and
    ``tsne:interpolate`` (their launches are asynchronous: the device's
    time lands where the host first waits on it). Over ranks the exact
    fit runs over them, and each rank places its block of the rows."""
    from learningorchestra_tpu_torch.telemetry import span

    n = X.shape[0]
    m = min(landmarks, n)
    chosen = torch.from_numpy(_choose_landmarks(n, landmarks, seed)).to(X.device)
    L = X[chosen]
    with span("tsne:landmark_fit", rows=m):
        Y_L = _tsne_exact(L, perplexity, iterations, learning_rate, Y0, mesh)
    if m == n:
        # every row is a landmark: undo the sampling permutation instead of
        # blurring the exact embedding through interpolation
        out = torch.empty((n, 2), dtype=torch.float32, device=X.device)
        out[chosen] = Y_L
        return out
    interp_perplexity = _clamped_perplexity(perplexity, m)
    first, stop = 0, n
    if over_ranks(mesh):
        first, stop = host_row_range(n, mesh)
    macro = max(1, min(stop - first, _INTERP_ROWS_PER_PROGRAM))
    with span("tsne:interpolate", rows=n, landmarks=m, macro_rows=macro):
        outs = [
            interpolate(X[start : min(start + macro, stop)], L, Y_L, interp_perplexity)
            for start in range(first, stop, macro)
        ]
        placed = outs[0] if len(outs) == 1 else (
            torch.cat(outs) if outs else X.new_zeros((0, 2)))
        return gather_rows(placed, n, mesh) if over_ranks(mesh) else placed


def _initial_embedding(rows: int, seed: int, device) -> torch.Tensor:
    """``Y0``: ``normal(0, 1) · 1e-4``, ``(rows, 2)`` float32, from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return torch.randn((rows, 2), generator=generator, dtype=torch.float32, device=device) * 1e-4


def tsne_embedding(
    X,
    perplexity: float = PERPLEXITY,
    iterations: int = ITERATIONS,
    learning_rate: float = LEARNING_RATE,
    seed: int = 0,
    method: str = "auto",
    exact_rows_limit: int = EXACT_ROWS_LIMIT,
    landmarks: int = LANDMARKS,
    device: DeviceLike = None,
    mesh=None,
) -> np.ndarray:
    """2-D t-SNE embedding of ``X`` (an array or a tensor), as a host
    ``(rows, 2)`` float32 array. Over the data ranks of ``mesh`` (on its
    device) every rank passes the same rows and gets the same embedding.

    ``method``: ``"exact"``, ``"landmark"`` (exact on a subsample, then
    calibrated kernel regression for the rest: linear in n) or ``"auto"``
    (exact up to ``exact_rows_limit`` rows). A host array's copy to the
    device counts into ``ml/base.h2d_bytes``; the embedding's copy back
    is the ``d2h:tsne`` span."""
    from learningorchestra_tpu_torch.ml.base import _account_h2d, to_host
    from learningorchestra_tpu_torch.telemetry import span

    device = mesh.device if mesh is not None else resolve_device(device)
    if not torch.is_tensor(X):
        X = _account_h2d(torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(device))
    X = X.to(device, torch.float32).contiguous()
    n = X.shape[0]
    if method == "auto":
        method = "exact" if n <= exact_rows_limit else "landmark"
    if method == "exact":
        Y = _tsne_exact(
            X, perplexity, iterations, learning_rate, _initial_embedding(n, seed, device), mesh
        )
    elif method == "landmark":
        Y0 = _initial_embedding(min(landmarks, n), seed, device)
        Y = _tsne_landmark(X, perplexity, iterations, learning_rate, seed, landmarks, Y0, mesh)
    else:
        raise ValueError(f"unknown t-SNE method {method!r}")
    with span("d2h:tsne", rows=n):
        return to_host(Y)
