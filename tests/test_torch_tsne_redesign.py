"""The arithmetic of t-SNE's redesigned kernels, held on the CPU.

The CUDA kernels (learningorchestra_tpu_torch/kernels/csrc/tsne.cu) run
only on the card, where chip_smoke.py holds them against their plain
versions. Here numpy models of what they compute, in the order they
compute it, are held against the JAX package and the port's plain
versions on seeded inputs:

- The calibration (K11, K13): one pass a bisection step, the entropy of
  p = e / T' by the identity (T / T') log T' + (sum e (-l)) / T', a
  thread's columns (j = thread + 128 k) added in float32 in column order
  and the threads' sums in float64. Against the JAX package's
  ``_calibrate_row_block`` on the same distances: p within chip_smoke's
  K11_TOL (1e-3) of each row's largest p, and the placement sum p y
  within its K13_TOL (1e-3) of the largest coordinate, as the card is
  held (measured here: ~1e-6; the float32 sums round in another order,
  and a bisection step may take the other branch on a knife edge).
- The gradient and Z (K12): each unordered pair once, a block per
  unordered pair of tiles in ``_tile_pairs``' order, the rows' partials
  in a (tiles, n, 3) buffer, then added. In float64, on a
  non-symmetric P, against the port's ``_tsne_grad`` and ``_tsne_z`` in
  float64: 1e-12 of the largest entry (the same function; only the order
  of float64 sums differs).
- The tile pairs: every unordered pair of rows once, the diagonal tiles'
  pairs i < j, in the order the kernels' blocks decode (``tile_pair_at``).
- K11's thread map: the distances by tiles (the bits
  of a sequential fmaf dot, symmetric), a row's group of 32, 128 or 512
  threads, its float32 thread sums added by xor shuffles in each warp and
  the group's warps in order: within K11_TOL of each row's largest p of
  the port's plain version and, symmetrised, of the reference's
  ``_affinities``; ``_k11_geometry`` at the main path's rows.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from learningorchestra_tpu.ops import tsne as jax_tsne  # noqa: E402
from learningorchestra_tpu_torch.ops import tsne  # noqa: E402

GROUP = 128  # K13's threads a row (tsne.cu kGroupThreads)
TILE = tsne.PAIR_TILE
RAGGED_ROWS = (1, 2, 3, TILE - 1, TILE, TILE + 1, 2 * TILE + 5)
PERPLEXITY = 30.0
f32, f64 = np.float32, np.float64


# --------------------------------------------------------------------------
# The calibration: one exp a column and bisection step
# --------------------------------------------------------------------------

def _fma32(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(f32)


def _thread_sums(terms):
    """Each term array (rows, m) float32, added as the kernels add it: a
    thread's columns j = thread + GROUP k in float32 in order of k (by
    ``terms``' own rule), then the threads' sums in float64."""
    rows, m = terms[0].shape
    k_count = -(-m // GROUP)
    pad = k_count * GROUP - m
    return [np.pad(term, ((0, 0), (0, pad))).reshape(rows, k_count, GROUP) for term in terms]


def model_calibrate(d, excluded, target, Y=None):
    """A float32 model of the kernels' calibration of each row of ``d``
    (rows, m) with ``excluded`` columns given no affinity: returns p
    (rows, m) and, given the landmarks' embedding ``Y`` (m, 2), the
    placement (sum e y) / T'."""
    d = np.asarray(d, f32)
    keep = ~np.asarray(excluded)
    rows, m = d.shape
    target = f32(target)
    d_min = d.min(axis=1)  # over every column, the excluded ones too

    def logits_and_e(beta):
        shift = (-d_min * beta).astype(f32)
        logit = ((-d) * beta[:, None]).astype(f32) - shift[:, None]
        e = np.exp(logit) * keep
        return logit, e.astype(f32)

    def row_sums(beta):
        logit, e = logits_and_e(beta)
        e3, logit3 = _thread_sums([e, np.where(keep, logit, f32(0))])
        total = np.zeros((rows, GROUP), f32)
        weighted = np.zeros((rows, GROUP), f32)
        for k in range(e3.shape[1]):
            total = (total + e3[:, k]).astype(f32)
            weighted = _fma32(e3[:, k], -logit3[:, k], weighted)
        return total.sum(axis=1, dtype=np.float64), weighted.sum(axis=1, dtype=np.float64)

    low = np.zeros(rows, f32)
    high = np.full(rows, np.inf, f32)
    beta = np.ones(rows, f32)
    for _ in range(tsne.BISECTION_STEPS):
        total, weighted = row_sums(beta)
        clamped = np.maximum(total.astype(f32), f32(1e-12))
        inverse = 1.0 / clamped.astype(np.float64)
        entropy = (total * inverse * np.log(clamped).astype(np.float64) + weighted * inverse).astype(f32)
        too_high = entropy > target
        low = np.where(too_high, beta, low)
        high = np.where(too_high, high, beta)
        beta = np.where(np.isinf(high), beta * f32(2), (low + high) / f32(2)).astype(f32)
    _, e = logits_and_e(beta)
    (e3,) = _thread_sums([e])
    total = np.zeros((rows, GROUP), f32)
    for k in range(e3.shape[1]):
        total = (total + e3[:, k]).astype(f32)
    clamped = np.maximum(total.sum(axis=1, dtype=np.float64).astype(f32), f32(1e-12))
    p = (e / clamped[:, None]).astype(f32)
    if Y is None:
        return p, None
    placed = []
    for column in range(2):
        y = np.broadcast_to(np.asarray(Y, f32)[:, column], d.shape)
        e3, y3 = _thread_sums([e, np.ascontiguousarray(y)])
        sums = np.zeros((rows, GROUP), f32)
        for k in range(e3.shape[1]):
            sums = _fma32(e3[:, k], y3[:, k], sums)
        placed.append(sums.sum(axis=1, dtype=np.float64) / clamped.astype(np.float64))
    return p, np.stack(placed, axis=1)


def calibration_rows(seed=3):
    """Distances of 16-feature blobs to themselves (each row's own column
    excluded, as K11 excludes it), and three rows built to edge: one whose
    every included distance is >= 150, so that the first steps' total
    underflows below 1e-12 (its excluded column holds the row's only
    small distance); one of equal distances; and one of a few repeated
    values with nothing excluded."""
    rng = np.random.default_rng(seed)
    m = 300
    centres = rng.normal(size=(6, 16)) * 4.0
    X = (centres[rng.integers(0, 6, size=m)] + rng.normal(size=(m, 16))).astype(f32)
    D = tsne._squared_distances(torch.from_numpy(X), torch.from_numpy(X)).numpy()[:200]
    excluded = np.eye(200, m, dtype=bool)
    underflow = rng.uniform(150.0, 400.0, size=m).astype(f32)
    underflow[7] = 0.0
    equal = np.full(m, 7.0, f32)
    repeated = rng.choice(np.array([3.0, 3.0, 9.5, 20.0, 41.0], f32), size=m)
    D = np.vstack([D, underflow, equal, repeated]).astype(f32)
    excluded = np.vstack([excluded, np.eye(1, m, 7, dtype=bool), np.eye(1, m, 3, dtype=bool),
                          np.zeros((1, m), bool)])
    Y = (rng.normal(size=(m, 2)) * 20.0).astype(f32)
    return D, excluded, Y


def test_a_row_whose_first_total_underflows_is_among_the_rows():
    D, excluded, _ = calibration_rows()
    row = D[200]
    first = np.exp((-row + row.min()).astype(f32)) * ~excluded[200]  # beta = 1
    assert first.sum(dtype=np.float64) < 1e-12
    assert (np.unique(D[202]).size == 4) and (np.unique(D[201][~excluded[201]]).size == 1)


@pytest.mark.parametrize("x64", [False, True])
def test_calibration_model_matches_the_reference(x64):
    D, excluded, Y = calibration_rows()
    target = tsne._target_entropy(PERPLEXITY)
    p, placed = model_calibrate(D, excluded, target, Y)
    with jax.enable_x64(x64):
        want = np.asarray(
            jax_tsne._calibrate_row_block(jnp.asarray(D), jnp.asarray(excluded), jnp.float32(PERPLEXITY)),
            np.float64,
        )
    row_error = np.abs(p - want) / want.max(axis=1, keepdims=True)
    assert row_error.max() <= chip_smoke.K11_TOL
    assert (p[excluded] == 0).all()
    placed_want = want @ Y.astype(np.float64)
    assert np.abs(placed - placed_want).max() / np.abs(Y).max() <= chip_smoke.K13_TOL
    assert np.isfinite(p).all() and np.isfinite(placed).all()


def test_calibration_model_matches_the_ports_plain_version():
    D, excluded, Y = calibration_rows(seed=5)
    target = tsne._target_entropy(PERPLEXITY)
    p, placed = model_calibrate(D, excluded, target, Y)
    want = tsne._calibrate_row_block(torch.from_numpy(D), torch.from_numpy(excluded), target).numpy()
    assert (np.abs(p - want) / want.max(axis=1, keepdims=True)).max() <= chip_smoke.K11_TOL
    np.testing.assert_allclose(p.sum(axis=1, dtype=np.float64), 1.0, rtol=1e-5)
    placed_want = want.astype(np.float64) @ Y.astype(np.float64)
    assert np.abs(placed - placed_want).max() / np.abs(Y).max() <= chip_smoke.K13_TOL


def test_entropy_identity_equals_the_direct_entropy():
    """(T / T') log T' + sum e (-l) / T' is -sum p log p of p = e / T',
    in float64 on the same logits, the total under the floor too."""
    rng = np.random.default_rng(1)
    for scale in (1.0, 40.0):
        logit = -rng.uniform(0.0, 30.0, size=(4, 500)) * scale
        logit[:, 0] = 0.0 if scale == 1.0 else -80.0
        e = np.exp(logit)
        total = e.sum(axis=1)
        clamped = np.maximum(total, 1e-12)
        identity = total / clamped * np.log(clamped) + (e * -logit).sum(axis=1) / clamped
        p = e / clamped[:, None]
        direct = -np.where(p > 0, p * np.log(np.where(p > 0, p, 1.0)), 0.0).sum(axis=1)
        np.testing.assert_allclose(identity, direct, rtol=1e-10, atol=1e-300)


# --------------------------------------------------------------------------
# K11's thread map: a row a group of warps, its sums by xor shuffles and
# the group's warps in order
# --------------------------------------------------------------------------

def model_k11_distances(X):
    """K11's distances (tsne.cu distances_kernel, row_distance's bits):
    |a|^2 and |b|^2 as float32 squares added in feature order, the dot a
    float32 fmaf chain in feature order, then |a|^2 + |b|^2 - 2 a.b
    clamped at 0."""
    X = np.asarray(X, f32)
    norms = np.zeros(X.shape[0], f32)
    for f in range(X.shape[1]):
        norms = (norms + (X[:, f] * X[:, f]).astype(f32)).astype(f32)
    dot = np.zeros((X.shape[0], X.shape[0]), f32)
    for f in range(X.shape[1]):
        dot = _fma32(X[:, f : f + 1], np.broadcast_to(X[:, f], dot.shape), dot)
    d = ((norms[:, None] + norms[None, :]).astype(f32) - (f32(2) * dot).astype(f32)).astype(f32)
    return np.maximum(d, f32(0))


def _row_reduce(partials):
    """A row's threads' float64 partials (rows, group), added as
    tsne.cu ``row_sum`` adds them: each warp's 32 lanes by xor shuffles
    (offsets 16 to 1; every lane ends with the same bits), then the
    group's warps in warp order."""
    rows, group = partials.shape
    warps = partials.reshape(rows, group // 32, 32)
    lanes = np.arange(32)
    for offset in (16, 8, 4, 2, 1):
        warps = warps + warps[:, :, lanes ^ offset]
    total = warps[:, 0, 0]
    for w in range(1, group // 32):
        total = total + warps[:, w, 0]
    return total


def model_k11(d, target, group):
    """K11's calibration of each row of ``d`` (n, n), self excluded, with
    a row's ``group`` threads: thread t's columns t + group k added in
    float32 in order of k (the own column adding 0), the threads' sums by
    ``_row_reduce``; the bisection and p as ``model_calibrate``'s."""
    d = np.asarray(d, f32)
    n = d.shape[0]
    keep = ~np.eye(n, dtype=bool)
    k_count = -(-n // group)
    pad = k_count * group - n

    def per_thread(term):
        return np.pad(term, ((0, 0), (0, pad))).reshape(n, k_count, group)

    d_min = d.min(axis=1)

    def logits_and_e(beta):
        shift = (-d_min * beta).astype(f32)
        logit = ((-d) * beta[:, None]).astype(f32) - shift[:, None]
        return np.where(keep, logit, f32(0)), (np.exp(logit) * keep).astype(f32)

    def sums(beta):
        logit, e = logits_and_e(beta)
        e3, logit3 = per_thread(e), per_thread(logit)
        total = np.zeros((n, group), f32)
        weighted = np.zeros((n, group), f32)
        for k in range(k_count):
            total = (total + e3[:, k]).astype(f32)
            weighted = _fma32(e3[:, k], -logit3[:, k], weighted)
        return _row_reduce(total.astype(f64)), _row_reduce(weighted.astype(f64))

    target = f32(target)
    low, high, beta = np.zeros(n, f32), np.full(n, np.inf, f32), np.ones(n, f32)
    for _ in range(tsne.BISECTION_STEPS):
        total, weighted = sums(beta)
        clamped = np.maximum(total.astype(f32), f32(1e-12))
        inverse = 1.0 / clamped.astype(f64)
        entropy = (total * inverse * np.log(clamped).astype(f64) + weighted * inverse).astype(f32)
        too_high = entropy > target
        low = np.where(too_high, beta, low)
        high = np.where(too_high, high, beta)
        beta = np.where(np.isinf(high), beta * f32(2), (low + high) / f32(2)).astype(f32)
    _, e = logits_and_e(beta)
    e3 = per_thread(e)
    total = np.zeros((n, group), f32)
    for k in range(k_count):
        total = (total + e3[:, k]).astype(f32)
    clamped = np.maximum(_row_reduce(total.astype(f64)).astype(f32), f32(1e-12))
    return (e / clamped[:, None]).astype(f32)


def k11_rows(seed=8, rows=300):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(6, 17)) * 4.0
    return (centres[rng.integers(0, 6, size=rows)] + rng.normal(size=(rows, 17))).astype(f32)


def test_k11_geometry_at_the_main_paths_rows():
    """The exact request's 20,000 rows: a row a block of 512 threads (two
    blocks an SM); the landmark fit's 5,000: eight rows a block of 1,024,
    128 threads a row; a block's distances within shared memory; a
    function of n alone."""
    assert tsne._k11_geometry(20_000) == (1, 512)
    assert tsne._k11_geometry(tsne.LANDMARKS) == (8, 1024)
    assert tsne._k11_geometry(2_048) == (16, 1024) and tsne._k11_geometry(300) == (32, 1024)
    for n in (1, 300, 2_048, 5_000, 5_121, 20_000, 57_000, 100_000):
        rows, threads = tsne._k11_geometry(n)
        assert threads % (32 * rows) == 0 and rows & (rows - 1) == 0
        assert 4 * rows * n <= tsne._SHARED_DISTANCE_BYTES or rows == 1


@pytest.mark.parametrize("group", [32, 128, 512])
def test_k11_thread_map_matches_the_plain_version_and_the_reference(group):
    """The model of K11's sums at a row's group of 32 (a warp a row), 128
    (5,000 rows) and 512 threads (20,000 rows) on 300 seeded rows: within
    K11_TOL of each row's largest p of the port's plain version, and,
    symmetrised, of the JAX package's ``_affinities``."""
    X = k11_rows()
    perplexity = tsne._clamped_perplexity(PERPLEXITY, X.shape[0])
    p = model_k11(model_k11_distances(X), tsne._target_entropy(perplexity), group)
    assert (np.diag(p) == 0).all() and np.isfinite(p).all()
    want = tsne._conditional_affinities(torch.from_numpy(X), perplexity).numpy()
    assert (np.abs(p - want) / want.max(axis=1, keepdims=True)).max() <= chip_smoke.K11_TOL
    from learningorchestra_tpu.parallel.mesh import default_mesh

    mesh = default_mesh()
    X_pad, valid, chunk = jax_tsne._pad_for_mesh(X, mesh, jax_tsne.CHUNK)
    reference = np.asarray(jax_tsne._affinities(
        mesh, jnp.asarray(X_pad), jnp.asarray(valid), jnp.float32(perplexity), chunk))[:300, :300]
    symmetric = tsne._symmetrize(torch.from_numpy(p)).numpy()
    assert (np.abs(symmetric - reference) / reference.max(axis=1, keepdims=True)).max() <= chip_smoke.K11_TOL


def test_k11_distances_keep_row_distances_bits():
    """The distance kernel's model: symmetric bit for bit (d_ij = d_ji, the
    norms added commutatively and the fmaf products the same), 0 on the
    diagonal of distinct rows' clamp, and within a few float32 steps of
    |x|^2 of the plain version's product."""
    X = k11_rows(seed=2, rows=120)
    d = model_k11_distances(X)
    np.testing.assert_array_equal(d, d.T)
    plain = tsne._squared_distances(torch.from_numpy(X), torch.from_numpy(X)).numpy()
    scale = (X.astype(f64) ** 2).sum(axis=1).max()
    assert np.abs(d - plain).max() <= 8 * np.finfo(f32).eps * scale


# --------------------------------------------------------------------------
# The gradient: each unordered pair once, in tile pairs
# --------------------------------------------------------------------------

def model_z_and_gradient(Y, P, exaggeration):
    """float64 model of K12: Z over the tiles on and above the diagonal,
    doubled; then for each tile pair, in ``_tile_pairs``' order, inv and q
    once a pair, W_ij with P_ij and W_ji with P_ji, each row's (s, t) into
    slot K of a (tiles, n, 3) buffer; then the slots added."""
    n = Y.shape[0]
    tiles, pairs = tsne._tile_pairs(n)
    norms = (Y * Y).sum(axis=1)

    def block(I, J):
        rows_i = slice(I * TILE, min(n, (I + 1) * TILE))
        rows_j = slice(J * TILE, min(n, (J + 1) * TILE))
        d = np.maximum(norms[rows_i, None] + norms[None, rows_j] - 2.0 * Y[rows_i] @ Y[rows_j].T, 0.0)
        inv = 1.0 / (1.0 + d)
        if I == J:
            inv = np.triu(inv, k=1)  # the diagonal tile's pairs i < j
        return rows_i, rows_j, inv

    slots = [block(I, J)[2].sum() for I, J in pairs]
    Z = 2.0 * sum(slots)
    partials = np.zeros((tiles, n, 3))
    for I, J in pairs:
        rows_i, rows_j, inv = block(I, J)
        q = np.maximum(inv / max(Z, 1e-12), 1e-12)
        pair = inv > 0
        w_ij = np.where(pair, (P[rows_i, rows_j] * exaggeration - q) * inv, 0.0)
        w_ji = np.where(pair, (P[rows_j, rows_i].T * exaggeration - q) * inv, 0.0)
        rows_side = np.column_stack([w_ij.sum(axis=1), w_ij @ Y[rows_j]])
        columns_side = np.column_stack([w_ji.sum(axis=0), w_ji.T @ Y[rows_i]])
        if I == J:
            partials[I, rows_i] = rows_side + columns_side
        else:
            partials[J, rows_i] = rows_side
            partials[I, rows_j] = columns_side
    sums = partials.sum(axis=0)
    return Z, 4.0 * (sums[:, :1] * Y - sums[:, 1:])


@pytest.mark.parametrize("n", RAGGED_ROWS)
@pytest.mark.parametrize("exaggeration", [1.0, 12.0])
def test_tile_pair_gradient_matches_the_plain_version_in_float64(n, exaggeration):
    rng = np.random.default_rng(n)
    Y = rng.normal(size=(n, 2)) * 5.0
    P = rng.random((n, n))
    P /= P.sum()
    assert n < 2 or not np.allclose(P, P.T)
    Z, grad = model_z_and_gradient(Y, P, exaggeration)
    Y64, P64 = torch.from_numpy(Y), torch.from_numpy(P)
    Z_plain = tsne._tsne_z(Y64)
    grad_plain = tsne._tsne_grad(Y64, P64, Z_plain, exaggeration).numpy()
    assert Z_plain.dtype == torch.float64
    assert abs(Z - float(Z_plain)) <= 1e-12 * max(float(Z_plain), 1e-300)
    if n == 1:  # no pair: nothing attracts or repels
        assert Z == 0.0 and not grad.any() and not grad_plain.any()
    else:
        assert np.abs(grad - grad_plain).max() <= 1e-12 * np.abs(grad_plain).max()


# --------------------------------------------------------------------------
# The tile pairs
# --------------------------------------------------------------------------

def kernel_tile_pair(b, tiles):
    """tsne.cu's ``tile_pair_at``: block b's {I, J}, the closed form and its
    integer corrections."""
    def start(i):
        return i * tiles - i * (i - 1) // 2

    t = 2.0 * tiles + 1.0
    i = int(math.floor((t - math.sqrt(t * t - 8.0 * b)) * 0.5))
    i = max(0, min(i, tiles - 1))
    while i > 0 and start(i) > b:
        i -= 1
    while i + 1 < tiles and start(i + 1) <= b:
        i += 1
    return i, i + (b - start(i))


@pytest.mark.parametrize("n", RAGGED_ROWS)
def test_tile_pairs_visit_every_unordered_pair_once(n):
    tiles, pairs = tsne._tile_pairs(n)
    assert tiles == -(-n // TILE) and len(pairs) == tiles * (tiles + 1) // 2
    visits = np.zeros((n, n), np.int64)
    for I, J in pairs:
        assert 0 <= I <= J < tiles
        rows_i = np.arange(I * TILE, min(n, (I + 1) * TILE))
        rows_j = np.arange(J * TILE, min(n, (J + 1) * TILE))
        pair = np.ones((len(rows_i), len(rows_j)), bool)
        if I == J:
            pair = rows_i[:, None] < rows_j[None, :]
        np.add.at(visits, (np.repeat(rows_i, len(rows_j)), np.tile(rows_j, len(rows_i))), pair.ravel())
    assert (np.tril(visits) == 0).all()  # the diagonal tiles' pairs as i < j
    assert (visits + visits.T == 1 - np.eye(n, dtype=np.int64)).all()


@pytest.mark.parametrize("n", [1, 300, 20_000, 128 * 1000])
def test_the_kernels_block_order_is_the_helpers(n):
    tiles, pairs = tsne._tile_pairs(n)
    assert list(pairs) == sorted(pairs)  # row-major over the upper triangle
    assert [kernel_tile_pair(b, tiles) for b in range(len(pairs))] == list(pairs)


def test_gradient_partials_are_small_beside_p():
    n = tsne.EXACT_ROWS_LIMIT
    tiles, pairs = tsne._tile_pairs(n)
    partials_bytes = tiles * n * 3 * 8
    assert (tiles, len(pairs)) == (157, 12_403)
    assert partials_bytes == 75_360_000
    assert partials_bytes * 20 < n * n * 4  # under 5% of P's 1.6 GB


def test_bounds_count_the_redesigned_work():
    """Z and the gradient over the n (n - 1) / 2 unordered pairs, the
    gradient still bound by reading P once; K11 and K13 one exp a step."""
    n, features = 20_000, 17
    rate = chip_smoke.PEAK_FP32_INSTRUCTIONS_PER_S
    z_ms, z_by = chip_smoke._tsne_bound("tsne_z", n, n, features)
    assert z_by == "operations"
    assert z_ms == pytest.approx(n * (n - 1) // 2 * 8 / rate * 1e3)
    grad_ms, grad_by = chip_smoke._tsne_bound("tsne_grad", n, n, features)
    assert grad_by == "bytes"
    assert grad_ms == pytest.approx((4 * n * n + 16 * n + 4) / chip_smoke.PEAK_BYTES_PER_S * 1e3)
    assert chip_smoke.TSNE_AFFINITY_INSTRUCTIONS == 32 * 5 + 8
    assert chip_smoke.TSNE_INTERPOLATION_INSTRUCTIONS == 32 * 5 + 6
    rows, m = 1_000_000, 5_000
    k13_ms, k13_by = chip_smoke._tsne_bound("tsne_interpolate", rows, m, features)
    assert k13_by == "operations"
    assert k13_ms == pytest.approx(rows * m * (features + 3 + 166) / rate * 1e3)
