"""The arithmetic of K7's redesigned kernels, held on the CPU.

The CUDA kernels (learningorchestra_tpu_torch/kernels/csrc/logistic.cu)
run only on the card, where chip_smoke.py holds them against their plain
twins. Here a numpy model of what they compute, in the order and through
the shared-memory layout they compute it in, is held against the JAX
package and the port's plain twins on seeded inputs:

- Phase 1, a (row, job) at a time: the logits by fmaf in feature order,
  then b; the reference's log-softmax; the nll and the residual p -
  onehot(y), times the row's weight, each rounded once to float64 into
  the block's terms (a (job, class) at an odd stride ``tile | 1``, a job
  at ``(C * (tile | 1)) | 1``).
- Phase 2: each cell's float64 sum over the chunk is the sums of its
  groups of 16 rows (each from 0, in row order, x * r exact and added by
  fma), added in group order; db, the loss and the weights' sum
  likewise. The narrow form (every thread sums (group, cell) items, the
  cells' owners add the groups) and the wide form (a (job, 2 classes, 8
  features) block of cells a thread) follow the same order.
- The finish: the chunks' partials added in chunk order, divided by the
  rows (by the sum of the weights), rounded once to float32.

Against the JAX package's ``_loss_fn`` (its value and ``jax.grad``, with a
0/1 mask) and the port's plain twins: the loss within chip_smoke's
K7_LOSS_RTOL (1e-6) relative, the gradient within K7_GRAD_ATOL (1e-6), as
the card is held. A job's outputs in the model are bit-equal whatever
its group (1, 7, 112, 113 jobs: the narrow and the wide forms), as
chip_smoke.py requires of the kernel. The geometry helper keeps every
block within the card's shared memory, and the kernels' thread-to-work
maps cover every element once.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from learningorchestra_tpu.ml import logistic as jax_logistic  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import logistic  # noqa: E402

f32, f64 = np.float32, np.float64
THREADS = logistic._THREADS
CANDIDATES = logistic._BACKTRACK_STEPS
GROUP = logistic._GROUP_ROWS
FEATURES = 16
ROWS = 2_500          # three chunks of 834, 834 and 832 rows: no tile divides them
LOSS_RTOL, GRAD_ATOL = chip_smoke.K7_LOSS_RTOL, chip_smoke.K7_GRAD_ATOL


def t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


# --------------------------------------------------------------------------
# The model: phase 1, a (row, job)'s terms in float32, rounded once to float64
# --------------------------------------------------------------------------

def _logits(x, W, b):
    """(rows, C) float32: fmaf over the features in order from 0, then
    ``__fadd_rn`` of b (each fma rounded once: the product is exact in
    float64)."""
    z = np.zeros((x.shape[0], W.shape[1]), f32)
    for f in range(x.shape[1]):
        z = (x[:, f : f + 1].astype(f64) * W[f].astype(f64) + z.astype(f64)).astype(f32)
    return (z + b).astype(f32)


def _softmax(z, y):
    """The reference's log-softmax, as the kernels round it: the shifted
    logits, their log-sum (the exps added in class order in float32) and
    the nll, NaN for a label outside [0, C)."""
    C = z.shape[1]
    shifted = (z - z.max(axis=1, keepdims=True)).astype(f32)
    total = np.zeros(z.shape[0], f32)
    for c in range(C):
        total = (total + np.exp(shifted[:, c])).astype(f32)
    log_sum = np.log(total).astype(f32)
    valid = (y >= 0) & (y < C)
    at_label = shifted[np.arange(len(y)), np.where(valid, y, 0)]
    nll = np.where(valid, (log_sum - at_label).astype(f32), f32(np.nan)).astype(f32)
    return shifted, log_sum, nll


def _row_terms(x, y, w, W, b):
    """One job's rows: the (weighted) nll (rows,) and residuals (rows, C),
    float32, as ``row_residuals`` computes them."""
    shifted, log_sum, nll = _softmax(_logits(x, W, b), y)
    C = W.shape[1]
    onehot = (y[:, None] == np.arange(C)[None]).astype(f32)
    residual = (np.exp((shifted - log_sum[:, None]).astype(f32)) - onehot).astype(f32)
    if w is not None:
        residual = (w[:, None] * residual).astype(f32)
        nll = (w * nll).astype(f32)
    return nll, residual


# --------------------------------------------------------------------------
# The model: a block's shared memory, its slots and each form's phase 2
# --------------------------------------------------------------------------

def _slots(G, F, C, shape):
    """Phase 2's slots of a group: (job, first class, classes, first
    feature, features) in the kernel's slot order."""
    classes, features = (1, 1) if shape == logistic._NARROW else (
        logistic._WIDE_CLASSES, logistic._WIDE_FEATURES)
    blocks = -(-F // features)
    per_job = -(-C // classes) * blocks
    out = []
    for slot in range(G * per_job):
        jl, within = divmod(slot, per_job)
        c0, f0 = within // blocks * classes, within % blocks * features
        out.append((jl, c0, classes, f0, features))
    return out


def _cells_of(slots, F, C, tp, js, weighted, first_class=0):
    """Each (slot, cell) the slots add: the index of its term in the
    block's terms (a job at js, a kept class at tp from ``first_class``),
    its feature (-1: a sum of the terms alone, db or the loss; -2: the
    weights), its job, its cell of the partials and whether it is the
    loss (its term in the nll's run)."""
    terms, features, jobs, cells, nll = [], [], [], [], []
    for jl, c0, classes, f0, width in slots:
        for i in range(classes):
            if c0 + i >= C:
                continue
            at = jl * js + (c0 + i - first_class) * tp
            for f in range(width):
                if f0 + f < F:
                    terms.append(at)
                    features.append(f0 + f)
                    jobs.append(jl)
                    cells.append((f0 + f) * C + c0 + i)
                    nll.append(False)
            if f0 == 0:                                   # db of the slot's classes
                terms.append(at)
                features.append(-1)
                jobs.append(jl)
                cells.append(F * C + c0 + i)
                nll.append(False)
        if f0 == 0 and c0 == 0:                           # the loss
            terms.append(jl * tp)
            features.append(-1)
            jobs.append(jl)
            cells.append(F * C + C)
            nll.append(True)
    if weighted:
        terms.append(0)
        features.append(-2)
        jobs.append(-1)
        cells.append(F * C + C + 1)
        nll.append(False)
    return (np.array(terms), np.array(features), np.array(jobs), np.array(cells),
            np.array(nll, bool))


def _phase_one(x, y, w, W, b, tp, js, first_class, end_class):
    """A tile's float64 terms as phase 1 leaves them in shared memory:
    each job's residuals of classes [first_class, end_class) at ``jl *
    js + (c - first_class) * tp + r``, its nll at ``jl * tp + r`` (the
    softmax over every class either way)."""
    G, n = W.shape[0], x.shape[0]
    terms = np.full(G * js, np.nan, f64)
    nll_terms = np.full(G * tp, np.nan, f64)
    for jl in range(G):
        nll, residual = _row_terms(x, y, w, W[jl], b[jl])
        for c in range(first_class, end_class):
            at = jl * js + (c - first_class) * tp
            terms[at : at + n] = residual[:, c]
        nll_terms[jl * tp : jl * tp + n] = nll
    return terms, nll_terms


def _values(cells, terms, nll_terms, xd, wd, r):
    """Row r's (factor, term) of each cell: factor * term is its addend (x
    * r exact in float64, so an fma rounds once as numpy's add does)."""
    terms_of, features, _, _, is_nll = cells
    value = np.where(is_nll, nll_terms[np.where(is_nll, terms_of, 0) + r],
                     terms[np.where(features == -2, 0, terms_of) + r])
    if wd is not None:
        value = np.where(features == -2, wd[r], value)
    factor = np.where(features >= 0, xd[r, np.maximum(features, 0)], 1.0)
    return factor, value


def _tiles(row_begin, row_end, tile):
    for start in range(row_begin, row_end, tile):
        yield start, min(tile, row_end - start)


def _narrow_chunk(X, y, w, W, b, tile, row_begin, row_end):
    """The narrow form over one chunk: each tile's (group, cell) sums
    (``group_sums``: from 0 over the group's rows in row order, by any
    thread), which the cells' owners add group by group (``add_groups``)
    while the next tile is computed. Returns the cells and their sums."""
    G, F, C = W.shape
    tp = tile | 1
    js = (C * tp) | 1
    cells = _cells_of(_slots(G, F, C, logistic._NARROW), F, C, tp, js, w is not None)
    owned = np.zeros(len(cells[0]), f64)
    pending = None   # the previous tile's group sums
    for start, n in _tiles(row_begin, row_end, tile):
        rows = slice(start, start + n)
        ws = None if w is None else w[rows]
        terms, nll_terms = _phase_one(X[rows], y[rows], ws, W, b, tp, js, 0, C)
        xd = X[rows].astype(f64)
        wd = None if ws is None else ws.astype(f64)
        if pending is not None:
            for sums in pending:
                owned = owned + sums
        pending = []
        for r0 in range(0, n, GROUP):
            sums = np.zeros(len(owned), f64)
            for r in range(r0, min(n, r0 + GROUP)):
                factor, value = _values(cells, terms, nll_terms, xd, wd, r)
                sums = factor * value + sums
            pending.append(sums)
    for sums in pending or ():
        owned = owned + sums
    return cells, owned


def _wide_chunk(X, y, w, W, b, tile, row_begin, row_end):
    """The wide form over one chunk: blocks along grid z take windows of
    ``THREADS`` slots; each keeps the terms of its window's classes only
    when one job's slots pass one block, and a slot (job, 2 classes, 8
    features) keeps its ``Sums``: each group of 16 rows from 0 in row
    order, then added to the slot's. Returns the cells and their sums."""
    G, F, C = W.shape
    weighted = w is not None
    tp = tile | 1
    js = (logistic._stored_classes(F, C, logistic._WIDE_STAGED) * tp) | 1
    slots = _slots(G, F, C, logistic._WIDE_STAGED)
    per_job = len(slots) // G
    parts = []
    for first in range(0, len(slots), THREADS):
        window = slots[first : first + THREADS]
        first_class, end_class = 0, C
        if G == 1:
            first_class = window[0][1]
            end_class = min(C, window[-1][1] + logistic._WIDE_CLASSES)
        assert end_class - first_class <= logistic._stored_classes(F, C, logistic._WIDE_STAGED)
        # each slot's cells, and a slot's weights' sum for slot 0 alone
        slot_cells = [
            _cells_of([slot], F, C, tp, js, weighted and first + k == 0, first_class)
            for k, slot in enumerate(window)
        ]
        acc = [np.zeros(len(cells[0]), f64) for cells in slot_cells]
        for start, n in _tiles(row_begin, row_end, tile):
            rows = slice(start, start + n)
            ws = None if w is None else w[rows]
            terms, nll_terms = _phase_one(
                X[rows], y[rows], ws, W, b, tp, js, first_class, end_class)
            xd = X[rows].astype(f64)
            wd = None if ws is None else ws.astype(f64)
            for k, cells in enumerate(slot_cells):
                for r0 in range(0, n, GROUP):
                    sums = np.zeros(len(acc[k]), f64)
                    for r in range(r0, min(n, r0 + GROUP)):
                        factor, value = _values(cells, terms, nll_terms, xd, wd, r)
                        sums = factor * value + sums
                    acc[k] = acc[k] + sums
        parts += list(zip(slot_cells, acc))
    cells = tuple(np.concatenate([c[i] for c, _ in parts]) for i in range(5))
    return cells, np.concatenate([a for _, a in parts])


def _model_partials(X, y, w, W, b, group, tile=None, shape=None):
    """``(J, chunks, F*C + C + 1 + weighted)`` float64 partial sums of
    ``lo_logistic_loss_grad``'s first kernel for jobs that share their
    rows, in groups of ``group`` jobs, each form through its own phase 2
    (the tile and the form as the geometry gives them unless set)."""
    J, F, C = W.shape
    rows = X.shape[0]
    weighted = w is not None
    cells_out = F * C + C + 1 + int(weighted)
    if tile is None or shape is None:
        group, tile, shape, _, _ = logistic._k7_geometry(F, C, group, True, weighted=weighted)
    chunk_sums = _narrow_chunk if shape == logistic._NARROW else _wide_chunk
    chunks, per_chunk = kernels.row_chunks(rows)
    partials = np.zeros((J, max(chunks, 1), cells_out), f64)
    for job0 in range(0, J, group):
        G = min(group, J - job0)
        for chunk in range(chunks):
            row_begin = chunk * per_chunk
            cells, sums = chunk_sums(X, y, w, W[job0 : job0 + G], b[job0 : job0 + G], tile,
                                     row_begin, min(rows, row_begin + per_chunk))
            _, _, jobs, out_cells, _ = cells
            for k in range(len(sums)):
                for jl in (range(G) if jobs[k] == -1 else (jobs[k],)):
                    partials[job0 + jl, chunk, out_cells[k]] = sums[k]
    return partials


def _model_loss_grad(X, y, w, W, b, group, tile=None, shape=None):
    """``(J, F*C + C + 1)`` float32 outputs ``[dW | db | loss]``: the
    partials' finish."""
    F, C = W.shape[1:]
    partials = _model_partials(X, y, w, W, b, group, tile, shape)
    return _finish(partials, kernels.row_chunks(X.shape[0])[0], F * C + C + 1, X.shape[0],
                   w is not None, gradient_outputs=F * C + C)


def _finish(partials, chunks, outputs, rows, weighted, gradient_outputs=0):
    """The chunks' partials added in chunk order, over the rows or the
    chunk-ordered sum of the weights, rounded once to float32. No chunks
    (no rows): the first ``gradient_outputs`` (the gradient) are 0, the
    rest 0 / 0."""
    J = partials.shape[0]
    totals = np.zeros((J, partials.shape[2]), f64)
    for chunk in range(chunks):
        totals = totals + partials[:, chunk]
    with np.errstate(invalid="ignore", divide="ignore"):
        denominator = totals[:, -1:] if weighted else f64(rows)
        out = (totals[:, :outputs] / denominator).astype(f32)
    if chunks == 0:
        out[:, :gradient_outputs] = 0.0
    return out


def _model_trial_losses(X, y, w, W4, b4, group):
    """``(J, 4)`` float32 of ``lo_logistic_trial_losses`` for jobs that
    share their rows: each (row, job, candidate)'s nll in float64, each
    (job, candidate)'s sum over a group of 16 rows from 0 in row order (a
    half-warp's shuffles), the groups added in group order."""
    J = W4.shape[0]
    rows = X.shape[0]
    weighted = w is not None
    sums_a_job = CANDIDATES + int(weighted)
    chunks, per_chunk = kernels.row_chunks(rows)
    partials = np.zeros((J, max(chunks, 1), sums_a_job), f64)
    warp_rows = logistic._TRIAL_WARP_ROWS
    most = warp_rows * THREADS // 32
    tile = min(most, max(warp_rows, most // group // warp_rows * warp_rows))
    for job0 in range(0, J, group):
        G = min(group, J - job0)
        for chunk in range(chunks):
            row_begin = chunk * per_chunk
            row_end = min(rows, row_begin + per_chunk)
            acc = np.zeros((G, CANDIDATES), f64)
            weight = f64(0.0)
            for start in range(row_begin, row_end, tile):
                n = min(tile, row_end - start)
                ws = None if w is None else w[start : start + n]
                nll = np.stack([
                    np.stack([
                        _row_terms(X[start : start + n], y[start : start + n], ws,
                                   W4[job0 + jl, k], b4[job0 + jl, k])[0]
                        for k in range(CANDIDATES)
                    ], axis=1)
                    for jl in range(G)
                ]).astype(f64)
                for r0 in range(0, n, GROUP):
                    group_acc = np.zeros_like(acc)
                    group_weight = f64(0.0)
                    for r in range(r0, min(n, r0 + GROUP)):
                        group_acc = group_acc + nll[:, r]
                        if weighted:
                            group_weight = group_weight + f64(ws[r])
                    acc = acc + group_acc
                    weight = weight + group_weight
            partials[job0 : job0 + G, chunk, :CANDIDATES] = acc
            if weighted:
                partials[job0 : job0 + G, chunk, CANDIDATES] = weight
    return _finish(partials, chunks, CANDIDATES, rows, weighted)


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

def _inputs(classes, jobs, rows=ROWS, seed=0, weighted=True):
    rng = np.random.default_rng(seed + 10 * classes)
    X = rng.normal(size=(rows, FEATURES)).astype(f32)
    y = rng.integers(0, classes, rows).astype(np.int32)
    w = None
    if weighted:   # the sweep's validity mask: its padded rows weigh 0
        w = np.ones(rows, f32)
        w[rows - rows // 9 :] = 0.0
    W = (rng.normal(size=(jobs, FEATURES, classes)) * 0.3).astype(f32)
    b = (rng.normal(size=(jobs, classes)) * 0.3).astype(f32)
    return X, y, w, W, b


def _split(out, F, C):
    """``[dW | db | loss]`` rows into (loss, dW, db)."""
    return out[:, -1], out[:, : F * C].reshape(-1, F, C), out[:, F * C : -1]


# --------------------------------------------------------------------------
# The model against the JAX package and the plain twins
# --------------------------------------------------------------------------

@pytest.mark.parametrize("classes", [2, 10])
@pytest.mark.parametrize("weighted", [False, True])
def test_model_matches_the_reference_loss_and_gradient(classes, weighted):
    X, y, w, W, b = _inputs(classes, 2, weighted=weighted)
    loss, dW, db = _split(_model_loss_grad(X, y, w, W, b, group=2), FEATURES, classes)
    mask = np.ones(ROWS, f32) if w is None else w
    for j in range(2):
        value, grad = jax.value_and_grad(jax_logistic._loss_fn)(
            {"w": jnp.asarray(W[j]), "b": jnp.asarray(b[j])},
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask), jnp.float32(0.0),
        )
        np.testing.assert_allclose(loss[j], float(value), rtol=LOSS_RTOL)
        np.testing.assert_allclose(dW[j], np.asarray(grad["w"]), rtol=0, atol=GRAD_ATOL)
        np.testing.assert_allclose(db[j], np.asarray(grad["b"]), rtol=0, atol=GRAD_ATOL)


def _checksum(array) -> str:
    array = np.ascontiguousarray(array)
    return f"{hashlib.sha256(array.tobytes()).hexdigest()[:16]} {array.dtype}{array.shape}"


def _files_run_before(request) -> list:
    """The test files this process ran before the current test: pytest
    drops an item's ``funcargs`` (sets it to None) once the item's
    teardown is done, so the items that ran are the ones without them."""
    files = []
    for item in request.session.items:
        if item is request.node:
            break
        if getattr(item, "funcargs", {}) is None and item.location[0] not in files:
            files.append(item.location[0])
    return files


def _twin_diagnostics(request, inputs, seeded, loss, value, recompute) -> str:
    """What a failing comparison of the model with the plain twins needs
    to tell whether the inputs moved or the twin's arithmetic did."""
    lines = ["the model against the plain twins disagreed:"]
    for name, used, fresh in zip(("X", "y", "w", "W", "b"), inputs, seeded):
        if used is None:
            continue
        lines.append(
            f"  {name}: used {_checksum(used)}, seeded {_checksum(fresh)}"
            + ("" if np.array_equal(used, fresh) else "  <- MOVED")
        )
    again = recompute()
    lines.append(f"  model loss     {np.asarray(loss).tolist()}")
    lines.append(f"  twin loss      {np.asarray(value).tolist()}")
    lines.append(
        f"  twin again on fresh copies {np.asarray(again).tolist()}"
        + (" (equal)" if np.array_equal(again, value) else "  <- DIFFERS from the first")
    )
    lines.append(f"  torch.get_num_threads() = {torch.get_num_threads()}")
    lines.append(f"  files this process ran before: {_files_run_before(request)}")
    return "\n".join(lines)


@pytest.mark.parametrize("classes", [2, 10])
@pytest.mark.parametrize("weighted", [False, True])
def test_model_matches_the_plain_twins(classes, weighted, request):
    X, y, w, W, b = _inputs(classes, 3, weighted=weighted, seed=1)
    l2s = np.zeros(3, f32)
    loss, dW, db = _split(_model_loss_grad(X, y, w, W, b, group=3), FEATURES, classes)
    value, plain_dW, plain_db = logistic._job_loss_fn(
        t(W), t(b), t(X), t(y), None if w is None else t(w), t(l2s))

    def recompute():
        X2, y2, w2, W2, b2 = (None if a is None else np.array(a, copy=True) for a in (X, y, w, W, b))
        return logistic._job_loss_fn(
            t(W2), t(b2), t(X2), t(y2), None if w2 is None else t(w2), t(np.zeros(3, f32)))[0].numpy()

    try:
        np.testing.assert_allclose(loss, value.numpy(), rtol=LOSS_RTOL)
        np.testing.assert_allclose(dW, plain_dW.numpy(), rtol=0, atol=GRAD_ATOL)
        np.testing.assert_allclose(db, plain_db.numpy(), rtol=0, atol=GRAD_ATOL)
        if not weighted:   # the solo twin: unweighted rows
            solo = logistic._loss_fn(t(W[0]), t(b[0]), t(X), t(y), 0.0)
            np.testing.assert_allclose(loss[0], float(solo[0]), rtol=LOSS_RTOL)
            np.testing.assert_allclose(dW[0], solo[1].numpy(), rtol=0, atol=GRAD_ATOL)
            np.testing.assert_allclose(db[0], solo[2].numpy(), rtol=0, atol=GRAD_ATOL)
    except AssertionError as error:
        seeded = _inputs(classes, 3, weighted=weighted, seed=1)
        raise AssertionError(
            f"{error}\n" + _twin_diagnostics(request, (X, y, w, W, b), seeded, loss, value.numpy(), recompute)
        ) from None


@pytest.mark.parametrize("classes", [2, 10])
@pytest.mark.parametrize("weighted", [False, True])
def test_trial_model_matches_the_reference_and_the_plain_twins(classes, weighted):
    X, y, w, W, b = _inputs(classes, 2, weighted=weighted, seed=2)
    rng = np.random.default_rng(classes)
    D = (rng.normal(size=W.shape) * 0.3).astype(f32)
    d = (rng.normal(size=b.shape) * 0.3).astype(f32)
    steps = np.array([1.0, 0.5, 0.25, 0.125], f32)
    W4 = (W[:, None] + steps[None, :, None, None] * D[:, None]).astype(f32)
    b4 = (b[:, None] + steps[None, :, None] * d[:, None]).astype(f32)
    got = _model_trial_losses(X, y, w, W4, b4, group=2)
    plain = logistic._job_trial_losses(
        t(W4), t(b4), t(X), t(y), None if w is None else t(w), t(np.zeros(2, f32)))
    np.testing.assert_allclose(got, plain.numpy(), rtol=LOSS_RTOL)
    mask = np.ones(ROWS, f32) if w is None else w
    for j in range(2):
        for k in range(CANDIDATES):
            expected = jax_logistic._loss_fn(
                {"w": jnp.asarray(W4[j, k]), "b": jnp.asarray(b4[j, k])},
                jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask), jnp.float32(0.0),
            )
            np.testing.assert_allclose(got[j, k], float(expected), rtol=LOSS_RTOL)


def test_no_rows_give_a_nan_loss_as_the_reference():
    """No rows: the loss is 0 / 0 = NaN and the gradient of the data term
    is 0 in the reference (``jax.grad`` contracts the cotangent over no
    rows, which is 0 before any division), in the plain twins and in the
    model of the kernel's finish; the L2 term's gradient stays. The trial
    losses are NaN."""
    X, y, w, W, b = _inputs(2, 1, rows=0)
    F, C = W.shape[1:]
    loss, dW, db = _split(_model_loss_grad(X, y, w, W, b, group=1), F, C)
    assert np.isnan(loss).all() and (dW == 0).all() and (db == 0).all()
    for l2 in (0.0, 0.5):
        value, grad = jax.value_and_grad(jax_logistic._loss_fn)(
            {"w": jnp.asarray(W[0]), "b": jnp.asarray(b[0])},
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.float32(l2),
        )
        assert np.isnan(float(value)) and (np.asarray(grad["b"]) == 0).all()
        np.testing.assert_array_equal(np.asarray(grad["w"]), (f32(l2) * W[0]).astype(f32))
        plain = logistic._job_loss_fn(t(W), t(b), t(X), t(y), t(w), t(np.full(1, l2, f32)))
        solo = logistic._loss_fn(t(W[0]), t(b[0]), t(X), t(y), l2)
        for part in (plain, [p[None] for p in solo]):
            assert torch.isnan(part[0]).all()
            np.testing.assert_array_equal(part[1][0].numpy(), np.asarray(grad["w"]))
            np.testing.assert_array_equal(part[2][0].numpy(), np.asarray(grad["b"]))
    W4 = np.repeat(W[:, None], CANDIDATES, axis=1)
    b4 = np.repeat(b[:, None], CANDIDATES, axis=1)
    assert np.isnan(_model_trial_losses(X, y, w, W4, b4, group=1)).all()


def test_rows_whose_weights_are_all_zero_give_nan_as_the_reference():
    """Rows whose weights are all 0: the reference's loss is 0 / 0 and its
    gradient NaN too (each row's cotangent of ``mask / mask.sum()``); so
    are the plain twin's and the model's, for that job alone in a group
    of jobs whose other members have rows that weigh."""
    X, y, w, W, b = _inputs(2, 3, rows=300, seed=4)
    weights = np.stack([w, np.zeros_like(w), w])
    out = np.stack([
        _model_loss_grad(X, y, weights[j], W[j : j + 1], b[j : j + 1], group=1)[0] for j in range(3)
    ])
    plain = logistic._job_loss_fn(t(W), t(b), t(X), t(y), t(weights), t(np.zeros(3, f32)))
    value, grad = jax.value_and_grad(jax_logistic._loss_fn)(
        {"w": jnp.asarray(W[1]), "b": jnp.asarray(b[1])},
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(weights[1]), jnp.float32(0.0),
    )
    assert np.isnan(float(value)) and np.isnan(np.asarray(grad["w"])).all()
    assert np.isnan(np.asarray(grad["b"])).all()
    assert np.isnan(out[1]).all() and all(torch.isnan(part[1]).all() for part in plain)
    for j in (0, 2):   # the members that weigh are untouched
        assert np.isfinite(out[j]).all() and all(torch.isfinite(part[j]).all() for part in plain)
        np.testing.assert_allclose(out[j][-1], plain[0][j].numpy(), rtol=LOSS_RTOL)


def test_a_label_outside_the_classes_gives_a_nan_loss():
    X, y, _, W, b = _inputs(2, 1, rows=300, weighted=False)
    y[17] = 2
    loss, dW, _ = _split(_model_loss_grad(X, y, None, W, b, group=1), FEATURES, 2)
    assert np.isnan(loss[0]) and np.isfinite(dW).all()


# --------------------------------------------------------------------------
# A job's outputs whatever its group
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_a_jobs_outputs_are_bit_equal_whatever_its_group(weighted):
    """113 jobs on shared rows in groups of 1 and 7 (the narrow form) and
    of 112 and 113 (the wide form), each form through its own phase 2:
    every job's outputs in the model bit for bit the same. The model
    holds the order; the kernels themselves are held to it on the card
    (chip_smoke.py ``_bit_equal_per_job``)."""
    X, y, w, W, b = _inputs(2, 113, rows=1_100, weighted=weighted, seed=3)
    outputs = {}
    for group in (1, 7, 112, 113):
        shape = logistic._k7_geometry(FEATURES, 2, group, True, weighted=weighted)[2]
        assert shape == (logistic._NARROW if group < 100 else logistic._WIDE_STAGED)
        outputs[group] = _model_partials(X, y, w, W, b, group)
    for group in (7, 112, 113):   # the float64 partials, before one rounding hides a change
        np.testing.assert_array_equal(outputs[group], outputs[1])
    W4 = np.repeat(W[:, None], CANDIDATES, axis=1) * np.array([1.0, 0.9, 0.8, 0.7], f32)[:, None, None]
    b4 = np.repeat(b[:, None], CANDIDATES, axis=1).astype(f32)
    trials = {group: _model_trial_losses(X, y, w, W4.astype(f32), b4, group) for group in (1, 7, 113)}
    np.testing.assert_array_equal(trials[7], trials[1])
    np.testing.assert_array_equal(trials[113], trials[1])


@pytest.mark.parametrize("classes", [2, 10])
@pytest.mark.parametrize("weighted", [False, True])
def test_the_narrow_and_the_wide_form_give_the_same_bits(classes, weighted):
    """The same jobs through the narrow form (tile group sums, added by
    the cells' owners) and the wide form (a slot's Sums, group by group),
    at tiles of 32 and 256 rows and groups of 1 and 3: the same bits."""
    X, y, w, W, b = _inputs(classes, 3, rows=700, weighted=weighted, seed=4)
    want = _model_partials(X, y, w, W, b, 1, tile=256, shape=logistic._NARROW)
    for group, tile, shape in ((3, 32, logistic._NARROW), (1, 32, logistic._WIDE_STAGED),
                               (3, 256, logistic._WIDE_STAGED)):
        np.testing.assert_array_equal(
            _model_partials(X, y, w, W, b, group, tile=tile, shape=shape), want)


def test_class_windows_keep_the_bits_and_the_reference():
    """600 classes at 16 features: a job's 600 wide slots pass one block,
    so three blocks along grid z keep 256, 256 and 88 classes' terms each.
    The windowed wide form gives the narrow form's bits and stays within
    the plain twin's tolerance."""
    classes = 600
    X, y, w, W, b = _inputs(classes, 1, rows=90, weighted=True, seed=5)
    group, tile, shape, _, _ = logistic._k7_geometry(FEATURES, classes, 1, False, weighted=True)
    assert (group, shape) == (1, logistic._WIDE_STAGED)
    assert logistic._stored_classes(FEATURES, classes, shape) == 258
    windowed = _model_partials(X, y, w, W, b, 1, tile=tile, shape=shape)
    np.testing.assert_array_equal(
        windowed, _model_partials(X, y, w, W, b, 1, tile=tile, shape=logistic._NARROW))
    outputs = _finish(windowed, kernels.row_chunks(90)[0], FEATURES * classes + classes + 1, 90,
                      True)
    loss, dW, db = _split(outputs, FEATURES, classes)
    value, plain_dW, plain_db = logistic._job_loss_fn(
        t(W), t(b), t(X), t(y), t(w), t(np.zeros(1, f32)))
    np.testing.assert_allclose(loss, value.numpy(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(dW, plain_dW.numpy(), rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(db, plain_db.numpy(), rtol=0, atol=GRAD_ATOL)


def test_the_slot_forms_cover_every_cell_once():
    for F, C in ((16, 2), (16, 10), (6, 3), (1, 2), (33, 5)):
        for shape in (logistic._NARROW, logistic._WIDE_STAGED):
            tp = 33
            js = (C * tp) | 1
            G = 3
            _, features, jobs, cells, _ = _cells_of(_slots(G, F, C, shape), F, C, tp, js, True)
            owned = sorted(zip(jobs.tolist(), cells.tolist()))
            expected = sorted((j, cell) for j in range(G) for cell in range(F * C + C + 1))
            assert owned == sorted(expected + [(-1, F * C + C + 1)])


# --------------------------------------------------------------------------
# The launch geometry, the block's layout and the kernels' thread-to-work maps
# --------------------------------------------------------------------------

def _layout(F, C, geometry, weighted, trial):
    return logistic._k7_layout(F, C, *geometry, weighted=weighted, trial=trial)


@pytest.mark.parametrize("trial", [False, True])
def test_the_geometry_keeps_each_block_within_shared_memory(trial):
    for F in (1, 16, 100):
        for C in (2, 10, 100, 2_000):
            for J in (1, 112, 65_536):
                for shared_rows in (True, False):
                    for weighted in (False, True):
                        geometry = logistic._k7_geometry(
                            F, C, J, shared_rows, trial=trial, weighted=weighted)
                        group, tile, form, x_staged, params = geometry
                        assert _layout(F, C, geometry, weighted, trial)["bytes"] <= kernels.SHARED_BYTES
                        assert 1 <= group <= min(J, THREADS)
                        if trial:   # whole 64-row warp items
                            assert tile % logistic._TRIAL_WARP_ROWS == 0 and tile <= 512
                        else:       # whole groups of sums
                            assert tile % GROUP == 0 and GROUP <= tile <= logistic._MAX_TILE
                        assert shared_rows or group == 1   # a group shares its rows
                        if trial or form == logistic._NARROW:   # the owners' cells
                            cells = logistic._grouped_cells(F, C, group, weighted, trial)
                            assert cells <= logistic._MAX_OWNED * THREADS
                        elif group > 1:                    # a group's slots fit the threads
                            assert len(_slots(group, F, C, form)) <= THREADS


@pytest.mark.parametrize("trial", [False, True])
def test_the_layout_holds_what_the_kernel_keeps(trial):
    """Each region of ``_k7_layout`` starts on 16 bytes past the one
    before and holds what the kernel puts there: two ring buffers of the
    tile's x, labels and weights; the float64 x; each job's terms of every
    class a window of slots spans, and its nll; the weights; the warps'
    scratch; two tiles' group sums; the cells' sources and the 1.0; the
    group's parameters."""
    regions = ("ring", "xd", "terms", "nll", "wd", "scratch", "sums", "sources", "one",
               "params_w", "params_b", "bytes")
    for F in (1, 16, 17, 100, 3_000):
        for C in (2, 3, 10, 100, 600, 2_000):
            for J, shared_rows in ((1, False), (7, True), (112, True)):
                for weighted in (False, True):
                    geometry = logistic._k7_geometry(
                        F, C, J, shared_rows, trial=trial, weighted=weighted)
                    group, tile, form, x_staged, params = geometry
                    layout = _layout(F, C, geometry, weighted, trial)
                    at = [layout[region] for region in regions]
                    assert all(a % 16 == 0 for a in at) and at == sorted(at)
                    size = dict(zip(regions, np.diff(at).tolist()))
                    assert layout["buffer_floats"] == tile * (layout["xs"] + 1 + int(weighted))
                    assert size["ring"] >= 8 * layout["buffer_floats"]
                    assert layout["xs"] == ((F | 1) if x_staged else 0)
                    assert layout["tp"] == tile | 1
                    sets = CANDIDATES if trial else 1
                    if params:
                        assert size["params_w"] >= 4 * group * sets * F * C
                        assert size["params_b"] >= 4 * group * sets * C
                    if trial:
                        assert size["scratch"] >= 4 * THREADS // 32 * 5 * 68
                        assert size["sums"] >= 8 * 2 * layout["cells"] * (tile // GROUP)
                        continue
                    if form == logistic._WIDE_STAGED:
                        assert size["xd"] >= 8 * tile * layout["fd"] and layout["fd"] >= F
                    # every window's classes fit a job's terms
                    slots = _slots(group, F, C, form)
                    spans = [slots[min(len(slots), first + THREADS) - 1][1] + 2 - slots[first][1]
                             for first in range(0, len(slots), THREADS)]
                    kept = C if len(spans) == 1 or form == logistic._NARROW else min(C, max(spans))
                    assert layout["js"] >= kept * layout["tp"] and layout["js"] % 2 == 1
                    assert size["terms"] >= 8 * group * layout["js"]
                    assert size["nll"] >= 8 * group * layout["tp"]
                    if weighted:
                        assert size["wd"] >= 8 * tile
                    if form == logistic._NARROW:
                        assert layout["cells"] == logistic._grouped_cells(F, C, group, weighted, False)
                        assert size["sums"] >= 8 * 2 * layout["cells"] * (tile // GROUP)
                        assert size["sources"] >= 8 * layout["cells"] and size["one"] >= 4


def test_the_sweeps_shape_reads_x_once():
    """At the λ sweep's shape (16 features, 2 classes, 112 slots sharing
    their rows) the gradient's 112 jobs are one group of wide slots with
    x made float64 once a row, in two blocks an SM; the trial losses' one
    group too, 64 rows a tile; a solo fit narrow, 256 rows a tile."""
    geometry = logistic._k7_geometry(16, 2, 112, True, weighted=True)
    assert geometry == (112, 32, logistic._WIDE_STAGED, True, True)
    assert _layout(16, 2, geometry, True, False)["bytes"] <= logistic._K7_BLOCK_BYTES
    assert logistic._k7_geometry(16, 2, 112, True, trial=True, weighted=True) == (
        112, 64, logistic._NARROW, True, True)
    assert logistic._k7_geometry(16, 2, 1, False) == (1, 256, logistic._NARROW, True, True)
    assert logistic._k7_geometry(16, 2, 64, False)[0] == 1       # the flood: stacked rows


def test_wide_rows_and_many_classes_fit():
    """Rows past shared memory are read from global memory; a job's
    terms past it keep a window's classes, so no F or C is refused."""
    for F in (40_000, 60_000):
        group, tile, form, x_staged, params = logistic._k7_geometry(F, 10, 1, False)
        assert (group, form, x_staged, params) == (1, logistic._WIDE, False, False)
        assert logistic._k7_geometry(F, 10, 1, False, trial=True)[3] is False
    for F, C in ((16, 2_000), (16, 50_000), (1, 100_000), (3_000, 3_000)):
        geometry = logistic._k7_geometry(F, C, 1, False)
        assert geometry[2] != logistic._NARROW
        assert logistic._stored_classes(F, C, geometry[2]) < C
        assert _layout(F, C, geometry, True, False)["bytes"] <= kernels.SHARED_BYTES
        trial = logistic._k7_geometry(F, C, 1, False, trial=True)
        assert _layout(F, C, trial, True, True)["bytes"] <= kernels.SHARED_BYTES


@pytest.mark.parametrize("F", [1, 6, 16, 17, 300])
@pytest.mark.parametrize("n", [1, 7, 32, 33, 256])
def test_the_copy_and_phase_one_maps_cover_each_element_once(F, n):
    """``stage_tile``'s (row, feature) steps and phase 1's (job, row) steps,
    thread by thread as the kernel walks them."""
    def walk(count, width, total_rows):
        seen = []
        for thread in range(THREADS):
            r, f = divmod(thread, width)
            step_r, step_f = divmod(THREADS, width)
            while r < total_rows:
                seen.append((r, f))
                r, f = r + step_r, f + step_f
                if f >= width:
                    f, r = f - width, r + 1
        return sorted(seen)

    assert walk(n * F, F, n) == [(r, f) for r in range(n) for f in range(F)]
    for G in (1, 3, 112):
        assert walk(G * n, n, G) == [(j, r) for j in range(G) for r in range(n)]
    groups = -(-n // GROUP)   # group_sums' (group, cell) items, F standing for the cells
    assert walk(groups * F, F, groups) == [(g, c) for g in range(groups) for c in range(F)]
