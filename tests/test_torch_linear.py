"""The port's lr and nb fits held against the JAX reference on the CPU.

The port (learningorchestra_tpu_torch/ml/logistic.py, naive_bayes.py,
checkpoint.py) and the JAX package (learningorchestra_tpu/ml/...) get the
same seeded numpy inputs: 2,048 rows x 6 features (no mesh padding on the
reference's 8 virtual devices), 2 and 3 classes.

Tolerances, and why:
- K7's plain twin against ``jax.value_and_grad(_loss_fn)``: loss rtol 1e-6,
  gradients atol 1e-6 (largest entries ~0.6). The port sums over rows in
  float64 and rounds once; the reference's float32 sums of 2,048 rows
  carry ~1e-7 of their magnitude.
- The trial losses: identical to the plain loss at each point (the same
  float32 operations), within 1e-6 relative of the reference's.
- ``_two_loop``: 1e-5 relative to the direction's largest entry (ten
  float32 dot products and axpys in each loop, summed in another order).
- One segment from a carried state: losses rtol 1e-5, parameters and ring
  buffers 1e-4 relative to their largest entry (gradients and their
  differences: 1e-6 absolute at least, as above), ``head`` and ``filled``
  identical. The Armijo test compares values a few ulps apart, so
  rounding may part two trajectories late in a segment; on nearly
  collinear features the parameters then part along the flat direction
  while the losses still agree, so this test takes well-conditioned data.
- The whole fit: the first loss is float32(log C), the exact mean, in the
  port; the reference's float32 sum of 2,048 equal values lands within
  4 ulps of it. Per-iteration losses rtol 1e-5; the fit stops in the same
  segment; probabilities within 1e-4
  (the tolerance tests/test_ml_linear.py holds the reference to against
  sklearn).
- ``scaler_stats`` and the float32 standardized rows: identical.
- Where the plateau is a knife edge (nearly collinear features, reg 0)
  the two fits may stop a segment apart; see
  ``test_ill_conditioned_fit_reaches_the_reference_objective``.
- nb: theta and prior within 1e-6 (float64 class sums rounded once in the
  port, a float32 product in the reference); probabilities 1e-5, as
  tests/test_torch_checkpoint.py holds lr and nb (the port's forward
  centres theta; the reference's float32 joint log-likelihood rounds at
  its magnitude).
- Checkpoints: labels identical, probabilities 1e-5 (as above).

The CUDA kernels (kernels/csrc/logistic.cu) are held against these plain
versions on the card by chip_smoke.py (phases fit-kernels and fit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from learningorchestra_tpu.ml import base as jax_base  # noqa: E402
from learningorchestra_tpu.ml import checkpoint as jax_checkpoint  # noqa: E402
from learningorchestra_tpu.ml import logistic as jax_logistic  # noqa: E402
from learningorchestra_tpu.ml import naive_bayes as jax_naive_bayes  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import (  # noqa: E402
    LogisticRegression,
    NaiveBayes,
    RandomForestClassifier,
    checkpoint,
    logistic,
    make_classifier,
    naive_bayes,
)

ROWS, FEATURES = 2048, 6
SEGMENT = 25          # the reference's segment at this size (_LR_CHECK_ITERS)


def t(array):
    return torch.from_numpy(np.array(array))


def jax_params(W, b):
    return {"w": jnp.asarray(W), "b": jnp.asarray(b)}


def blobs(classes, seed=0, spread=1.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, FEATURES)) * spread
    y = rng.integers(0, classes, size=ROWS).astype(np.int32)
    X = (centers[y] + rng.normal(size=(ROWS, FEATURES))).astype(np.float32)
    return X, y


def ill_conditioned(seed=2, noise=0.01):
    """3-class blobs with two nearly collinear feature groups: L-BFGS
    still descends in its fourth segment at reg 0."""
    X, y = blobs(3, seed=seed, spread=1.0)
    rng = np.random.default_rng(seed + 100)
    X[:, 1] = X[:, 0] + noise * rng.normal(size=ROWS).astype(np.float32)
    X[:, 3] = X[:, 2] * 0.5 + X[:, 4] * 0.5 + noise * rng.normal(size=ROWS).astype(np.float32)
    return X, y


def standardized(X):
    mean, scale = jax_logistic.scaler_stats(X)
    return ((X - mean) / scale).astype(np.float32)


def jax_prepared(X_std, y):
    mesh = jax_base.resolve_mesh(None)
    X_dev, y_dev, mask = jax_base.prepare_xy(X_std, y, mesh)
    return X_dev, y_dev, mask.astype(jnp.float32)


def assert_close_to_scale(got, expected, relative, floor=1e-30):
    got, expected = np.asarray(got), np.asarray(expected)
    scale = max(np.abs(expected).max(), floor)
    assert np.abs(got - expected).max() <= relative * scale, (np.abs(got - expected).max(), scale)


# --------------------------------------------------------------------------
# K7: the plain twin and its wrappers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("l2", [0.0, 0.1])
def test_loss_and_gradient_match_reference(classes, l2):
    rng = np.random.default_rng(classes)
    X = rng.normal(size=(ROWS, FEATURES)).astype(np.float32)
    y = rng.integers(0, classes, ROWS).astype(np.int32)
    W = rng.normal(size=(FEATURES, classes)).astype(np.float32)
    b = rng.normal(size=classes).astype(np.float32)
    value, grad = jax.value_and_grad(jax_logistic._loss_fn)(
        jax_params(W, b), jnp.asarray(X), jnp.asarray(y), jnp.ones(ROWS, jnp.float32), jnp.float32(l2)
    )
    for function in (logistic._loss_fn, logistic.loss_and_grad):
        got_value, got_dW, got_db = function(t(W), t(b), t(X), t(y), l2)
        assert got_value.dtype == got_dW.dtype == got_db.dtype == torch.float32
        np.testing.assert_allclose(float(got_value), float(value), rtol=1e-6)
        np.testing.assert_allclose(got_dW.numpy(), np.asarray(grad["w"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_db.numpy(), np.asarray(grad["b"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("l2", [0.0, 0.1])
def test_trial_losses_are_the_loss_at_each_point(l2):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(ROWS, FEATURES)).astype(np.float32)
    y = rng.integers(0, 3, ROWS).astype(np.int32)
    W, D = (rng.normal(size=(2, FEATURES, 3)).astype(np.float32))
    b, d = (rng.normal(size=(2, 3)).astype(np.float32))
    steps = t(np.array([1.0, 0.5, 0.25, 0.125], np.float32))
    W4 = t(W)[None] + steps[:, None, None] * t(D)[None]
    b4 = t(b)[None] + steps[:, None] * t(d)[None]
    for function in (logistic._trial_losses, logistic.trial_losses):
        got = function(W4, b4, t(X), t(y), l2)
        assert got.shape == (4,) and got.dtype == torch.float32
        for k in range(4):
            assert float(got[k]) == float(logistic._loss_fn(W4[k], b4[k], t(X), t(y), l2)[0])
            expected = jax_logistic._loss_fn(
                jax_params(W4[k].numpy(), b4[k].numpy()),
                jnp.asarray(X), jnp.asarray(y), jnp.ones(ROWS, jnp.float32), jnp.float32(l2),
            )
            np.testing.assert_allclose(float(got[k]), float(expected), rtol=1e-6)


def test_first_accepted_step_is_the_reference_backtracking():
    steps = t(np.array([1.0, 0.5, 0.25, 0.125], np.float32))
    for ok, expected in (
        ([True, True, False, False], 1.0),
        ([False, True, True, True], 0.5),
        ([False, False, False, True], 0.125),
        ([False, False, False, False], 1 / 16),
    ):
        assert float(logistic._first_accepted(steps, t(np.array(ok)), 1 / 16)) == expected


def test_wrappers_take_the_plain_path_on_cpu_and_refuse_bad_operands():
    rng = np.random.default_rng(5)
    X = t(rng.normal(size=(64, FEATURES)).astype(np.float32))
    y = t(rng.integers(0, 2, 64).astype(np.int32))
    W, b = torch.zeros((FEATURES, 2)), torch.zeros(2)
    kernels.reset_launches()
    value, dW, db = logistic.loss_and_grad(W, b, X, y, 0.0)
    assert float(value) == float(np.float32(np.log(2)))
    logistic.trial_losses(torch.stack([W] * 4), torch.stack([b] * 4), X, y, 0.0)
    assert set(kernels.launches().values()) == {0}
    with pytest.raises(TypeError):
        logistic.loss_and_grad(W, b, X.double(), y, 0.0)
    with pytest.raises(TypeError):
        logistic.loss_and_grad(W, b, X, y.long(), 0.0)
    with pytest.raises(ValueError):
        logistic.loss_and_grad(W[:3], b, X, y, 0.0)
    with pytest.raises(ValueError):
        logistic.loss_and_grad(W, b[:1], X, y, 0.0)
    with pytest.raises(ValueError):    # the trial points come four at a time
        logistic.trial_losses(torch.stack([W] * 3), torch.stack([b] * 3), X, y, 0.0)
    with pytest.raises(ValueError):    # a CPU tensor is no kernel operand
        kernels.check_operands(X)


def test_loss_tiling_fits_a_block():
    """K7's launch geometry (``_k7_geometry``: group, tile rows, sum form,
    x in shared memory, parameters in shared memory) keeps a block within
    the card's shared memory: a solo fit stages 256 rows a tile (its
    trial losses 512), 20,100 cells take wide slots, rows of 40,000 and
    60,000 features are read from global memory, and 2,000 classes keep
    a window's classes' terms a block."""
    def fits(F, C, trial=False, weighted=False):
        geometry = logistic._k7_geometry(F, C, 1, False, trial=trial, weighted=weighted)
        layout = logistic._k7_layout(F, C, *geometry, weighted=weighted, trial=trial)
        assert layout["bytes"] <= kernels.SHARED_BYTES
        return geometry[:4]

    assert fits(16, 2) == (1, 256, logistic._NARROW, True)
    assert fits(16, 10)[:2] == (1, 256)
    assert fits(16, 10, trial=True)[:2] == (1, 512)   # 64 rows a warp
    group, tile, form, _ = fits(200, 100)             # 20,100 cells: wide slots
    assert form in (logistic._WIDE, logistic._WIDE_STAGED) and 16 <= tile < 256
    assert fits(40_000, 10)[3] is False               # x from global memory
    assert fits(60_000, 10, trial=True)[3] is False
    form = fits(16, 2_000)[2]                         # 2,000 classes: windows of slots
    assert logistic._stored_classes(16, 2_000, form) == 258
    fits(16, 2_000, trial=True)


# --------------------------------------------------------------------------
# L-BFGS
# --------------------------------------------------------------------------

def ring_state(classes=3, head=3, filled=10, seed=6):
    """A reference L-BFGS state whose ring is full and wrapped past head."""
    rng = np.random.default_rng(seed)
    m = jax_logistic._LBFGS_MEMORY
    S = {"w": rng.normal(size=(m, FEATURES, classes)), "b": rng.normal(size=(m, classes))}
    Y = {key: value * 0.5 + rng.normal(size=value.shape) * 0.1 for key, value in S.items()}
    rho = 1.0 / np.abs(rng.normal(size=m) * 3 + 5)
    grad = {"w": rng.normal(size=(FEATURES, classes)), "b": rng.normal(size=classes)}
    f32 = lambda tree: {k: np.asarray(v, np.float32) for k, v in tree.items()}  # noqa: E731
    return {
        "S": f32(S), "Y": f32(Y), "rho": rho.astype(np.float32),
        "head": np.int32(head), "filled": np.int32(filled),
        "value": np.float32(0.7), "grad": f32(grad),
    }


def port_state(state):
    return {
        "S": {k: t(v) for k, v in state["S"].items()},
        "Y": {k: t(v) for k, v in state["Y"].items()},
        "rho": t(state["rho"]),
        "head": torch.tensor(int(state["head"]), dtype=torch.int32),
        "filled": torch.tensor(int(state["filled"]), dtype=torch.int32),
        "value": torch.tensor(float(state["value"])),
        "grad": {k: t(v) for k, v in state["grad"].items()},
    }


@pytest.mark.parametrize("head,filled", [(3, 10), (0, 10), (7, 7), (0, 0)])
def test_two_loop_matches_reference(head, filled):
    state = ring_state(head=head, filled=filled)
    expected = jax_logistic._two_loop(jax.tree.map(jnp.asarray, state))
    got = logistic._two_loop(port_state(state))
    for key in ("w", "b"):
        assert_close_to_scale(got[key].numpy(), expected[key], 1e-5)


def test_lbfgs_state_from_arrays_takes_the_reference_leaves():
    params = {"w": jnp.arange(12.0, dtype=jnp.float32).reshape(6, 2), "b": jnp.asarray([5.0, 6.0], jnp.float32)}
    opt_state = jax.tree.map(jnp.asarray, ring_state(classes=2, head=4, filled=9))
    leaves = [np.asarray(leaf) for leaf in jax.tree.leaves((params, opt_state))]
    W, b, state = checkpoint.lbfgs_state_from_arrays(leaves, device="cpu")
    np.testing.assert_array_equal(W.numpy(), np.asarray(params["w"]))
    np.testing.assert_array_equal(b.numpy(), np.asarray(params["b"]))
    for key in ("S", "Y", "grad"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(state[key][leaf].numpy(), np.asarray(opt_state[key][leaf]))
    np.testing.assert_array_equal(state["rho"].numpy(), np.asarray(opt_state["rho"]))
    assert int(state["head"]) == 4 and int(state["filled"]) == 9
    assert state["head"].dtype == state["filled"].dtype == torch.int32
    assert float(state["value"]) == float(opt_state["value"])
    with pytest.raises(ValueError):
        checkpoint.lbfgs_state_from_arrays(leaves[:-1], device="cpu")


@pytest.mark.parametrize("l2", [0.0, 0.1])
def test_segment_from_a_carried_state_matches_reference(l2):
    X, y = blobs(3, seed=1)
    X_dev, y_dev, mask = jax_prepared(standardized(X), y)
    params = {"w": jnp.zeros((FEATURES, 3), jnp.float32), "b": jnp.zeros((3,), jnp.float32)}
    opt_state = jax_logistic._lbfgs_state(params)
    params, opt_state, _ = jax_logistic._fit_segment(params, opt_state, X_dev, y_dev, mask, SEGMENT, jnp.float32(l2))
    leaves = [np.asarray(leaf) for leaf in jax.tree.leaves((params, opt_state))]
    expected = jax_logistic._fit_segment(params, opt_state, X_dev, y_dev, mask, SEGMENT, jnp.float32(l2))

    W, b, state = checkpoint.lbfgs_state_from_arrays(leaves, device="cpu")
    W, b, state, losses = logistic._fit_segment_impl(
        W, b, state, t(np.asarray(X_dev)), t(np.asarray(y_dev)), SEGMENT, l2
    )
    np.testing.assert_allclose(losses.numpy(), np.asarray(expected[2]), rtol=1e-5)
    assert_close_to_scale(W.numpy(), expected[0]["w"], 1e-4)
    assert_close_to_scale(b.numpy(), expected[0]["b"], 1e-4)
    ref_state = expected[1]
    assert int(state["head"]) == int(ref_state["head"])
    assert int(state["filled"]) == int(ref_state["filled"])
    for leaf in ("w", "b"):
        assert_close_to_scale(state["S"][leaf].numpy(), ref_state["S"][leaf], 1e-4)
        # gradients: within 1e-6 absolute, as the loss-and-gradient test
        for key in ("Y", "grad"):
            assert_close_to_scale(state[key][leaf].numpy(), ref_state[key][leaf], 1e-4, floor=1e-2)
    assert_close_to_scale(state["rho"].numpy(), ref_state["rho"], 1e-4)


@pytest.mark.parametrize("reg_param", [0.0, 0.1])
def test_whole_fit_matches_reference(reg_param):
    X, y = blobs(3)
    X_std = standardized(X)
    X_dev, y_dev, mask = jax_prepared(X_std, y)
    params0 = {"w": jnp.zeros((FEATURES, 3), jnp.float32), "b": jnp.zeros((3,), jnp.float32)}
    _, expected_losses = jax_logistic._fit(params0, X_dev, y_dev, mask, max_iter=100, l2=jnp.float32(reg_param))
    expected_losses = np.asarray(expected_losses)
    _, _, losses = logistic._fit(
        torch.zeros((FEATURES, 3)), torch.zeros(3), t(X_std), t(y), 100, reg_param
    )
    losses = losses.numpy()
    exact_first = np.float32(np.log(3))
    assert losses[0] == exact_first
    assert abs(expected_losses[0] - exact_first) <= 4 * np.spacing(exact_first)
    assert len(losses) == len(expected_losses)          # the same stop segment
    assert len(losses) % SEGMENT == 0 and len(losses) < 100
    np.testing.assert_allclose(losses, expected_losses, rtol=1e-5)

    expected = jax_logistic.LogisticRegression(max_iter=100, reg_param=reg_param).fit(X, y)
    got = LogisticRegression(reg_param=reg_param, device="cpu").fit(X, y)
    labels, probs = got.predict_both(X)
    ref_labels, ref_probs = expected.predict_both(X)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-4)
    differ = labels != ref_labels
    assert not differ.any() or np.abs(np.sort(ref_probs[differ], axis=1)[:, -1] - np.sort(ref_probs[differ], axis=1)[:, -2]).max() < 2e-4


def test_ill_conditioned_fit_reaches_the_reference_objective():
    """Where a plateau is a knife edge the two fits may stop a segment
    apart: at reg 0 on nearly collinear features the window of the last
    losses falls just under the plateau threshold in one package and just
    over it in the other. The losses agree within 5e-5 over the
    iterations both ran (the Armijo choices part late), both stop at the
    same objective within 1e-6 relative, and their probabilities lie
    within 1e-3."""
    X, y = ill_conditioned()
    X_std = standardized(X)
    X_dev, y_dev, mask = jax_prepared(X_std, y)
    params0 = {"w": jnp.zeros((FEATURES, 3), jnp.float32), "b": jnp.zeros((3,), jnp.float32)}
    params, expected_losses = jax_logistic._fit(params0, X_dev, y_dev, mask, max_iter=100, l2=jnp.float32(0.0))
    expected_losses = np.asarray(expected_losses)
    W, b, losses = logistic._fit(torch.zeros((FEATURES, 3)), torch.zeros(3), t(X_std), t(y), 100, 0.0)
    losses = losses.numpy()
    both = min(len(losses), len(expected_losses))
    assert abs(len(losses) - len(expected_losses)) <= SEGMENT and both >= 3 * SEGMENT
    np.testing.assert_allclose(losses[:both], expected_losses[:both], rtol=5e-5)
    objective = float(logistic._loss_fn(W, b, t(X_std), t(y), 0.0)[0])
    reference_objective = float(
        logistic._loss_fn(t(np.asarray(params["w"])), t(np.asarray(params["b"])), t(X_std), t(y), 0.0)[0]
    )
    np.testing.assert_allclose(objective, reference_objective, rtol=1e-6)
    probs = LogisticRegression(device="cpu").fit(X, y).predict_proba(X)
    ref_probs = jax_logistic.LogisticRegression().fit(X, y).predict_proba(X)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-3)


def test_zero_iterations_is_the_initial_model():
    X, y = blobs(2)
    W, b, losses = logistic._fit(torch.zeros((FEATURES, 2)), torch.zeros(2), t(standardized(X)), t(y), 0, 0.0)
    assert losses.shape == (0,) and not W.any() and not b.any()
    probs = LogisticRegression(max_iter=0, device="cpu").fit(X, y).predict_proba(X[:5])
    np.testing.assert_array_equal(probs, np.full((5, 2), 0.5, np.float32))


def test_plateaued_matches_reference():
    tol = 1e-6
    cases = [
        ([0.5, 0.5, 0.5, 0.5], tol, 4),
        ([1.0, 0.9999999, 0.99, 0.98], tol, 4),
        ([1.0, 0.99, 0.9899999, 0.97], tol, 4),
        ([0.5, 0.5], tol, 4),
        ([1.03, 1.02, 1.01, 1.00], 1.1e-2, 4),
        ([3.0, 3.0 + 2e-6, 3.0 + 4e-6, 3.0 + 5e-6], tol, 4),
    ]
    answers = [logistic._plateaued(*case) for case in cases]
    assert answers == [jax_logistic._plateaued(*case) for case in cases]
    assert answers[:5] == [True, False, False, False, False]


def test_scaler_and_standardized_rows_are_identical():
    X, _ = blobs(2, seed=3)
    X[:, 4] = 7.0   # zero variance: scale pinned to 1
    mean, scale = logistic.scaler_stats(X)
    ref_mean, ref_scale = jax_logistic.scaler_stats(X)
    np.testing.assert_array_equal(mean, ref_mean)
    np.testing.assert_array_equal(scale, ref_scale)
    assert scale[4] == 1.0
    X_dev, _, _ = jax_prepared((np.asarray(X) - ref_mean) / ref_scale, np.zeros(ROWS, np.int32))
    np.testing.assert_array_equal(logistic._standardized(X, mean, scale), np.asarray(X_dev))


# --------------------------------------------------------------------------
# Naive Bayes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("classes", [2, 3])
def test_nb_fit_matches_reference(classes):
    rng = np.random.default_rng(classes)
    X = rng.integers(0, 20, size=(ROWS, FEATURES)).astype(np.float32)
    X[:, 2] = rng.random(ROWS) * 20      # fractional counts too
    y = rng.integers(0, classes, ROWS).astype(np.int32)
    X_dev, y_dev, mask = jax_prepared(X, y)
    theta, prior = jax_naive_bayes._fit(X_dev, y_dev, mask, num_classes=classes, smoothing=jnp.float32(1.0))
    got_theta, got_prior = naive_bayes._fit(t(X), t(y.astype(np.int64)), classes, 1.0)
    assert got_theta.dtype == got_prior.dtype == torch.float32
    np.testing.assert_allclose(got_theta.numpy(), np.asarray(theta), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_prior.numpy(), np.asarray(prior), rtol=0, atol=1e-6)
    expected = jax_naive_bayes.NaiveBayes().fit(X, y)
    got = NaiveBayes(device="cpu").fit(X, y)
    labels, probs = got.predict_both(X)
    ref_labels, ref_probs = expected.predict_both(X)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, ref_labels)


def test_nb_refuses_negative_features_as_the_reference():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(50, 3))
    y = rng.integers(0, 2, size=50)
    with pytest.raises(ValueError) as reference:
        jax_naive_bayes.NaiveBayes().fit(X, y)
    with pytest.raises(ValueError) as port:
        NaiveBayes(device="cpu").fit(X, y)
    assert str(port.value) == str(reference.value)


# --------------------------------------------------------------------------
# The switcher and checkpoints
# --------------------------------------------------------------------------

def test_make_classifier_fits_lr_and_nb_on_cpu():
    X, y = blobs(2, seed=4)
    X = np.abs(X)
    for name, kind in (("lr", logistic.LogisticRegressionModel), ("nb", naive_bayes.NaiveBayesModel)):
        model = make_classifier(name, device="cpu").fit(X, y)
        assert isinstance(model, kind)
        accuracy, weighted_f1 = model.evaluate(X, y)
        assert 0.5 < accuracy <= 1.0 and 0 < weighted_f1 <= 1.0
    assert isinstance(make_classifier("rf", device="cpu"), RandomForestClassifier)


@pytest.mark.parametrize("name", ["lr", "nb"])
def test_fit_checkpoints_cross_over(name, tmp_path):
    """A port-fit lr or nb saved by the port loads and predicts the same
    in the JAX package, and a JAX-fit one the other way."""
    X, y = blobs(3, seed=5)
    X = np.abs(X)
    rows = np.abs(blobs(3, seed=6)[0][:300])
    port_model = make_classifier(name, device="cpu").fit(X, y)
    port_path = str(tmp_path / "port.model")
    checkpoint.save_model(port_model, port_path)
    jax_labels, jax_probs = jax_checkpoint.load_model(port_path).predict_both(rows)
    labels, probs = port_model.predict_both(rows)
    np.testing.assert_array_equal(jax_labels, labels)
    np.testing.assert_allclose(jax_probs, probs, rtol=0, atol=1e-5)

    jax_estimator = jax_logistic.LogisticRegression() if name == "lr" else jax_naive_bayes.NaiveBayes()
    jax_model = jax_estimator.fit(X, y)
    jax_path = str(tmp_path / "jax.model")
    jax_checkpoint.save_model(jax_model, jax_path)
    ported = checkpoint.load_model(jax_path, device="cpu")
    labels, probs = ported.predict_both(rows)
    ref_labels, ref_probs = jax_model.predict_both(rows)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)


def test_lr_and_nb_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    for name in ("lr", "nb"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_classifier(name)


def test_rows_need_no_padding_on_the_reference_mesh():
    X_dev, _, mask = jax_prepared(np.zeros((ROWS, FEATURES), np.float32), np.zeros(ROWS, np.int32))
    assert X_dev.shape[0] == ROWS and float(mask.sum()) == ROWS
