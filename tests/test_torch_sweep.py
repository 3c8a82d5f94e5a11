"""The port's sweep library (``ml/sweep.py``) and its job-axis kernels'
plain twins, held against the JAX package on the CPU.

Both packages get the same seeded numpy inputs: a few hundred rows x 6
features, 2 and 3 classes, λ grids of 3 points and depths {2, 3}. The
row counts are off the quarter-octave grid, so every member carries
masked padded rows (300 rows pad to 320, 200 to 224).

Tolerances, and why:
- K7 over a job axis (``job_loss_and_grad``) against ``jax.vmap`` of
  ``jax.value_and_grad(_loss_fn)`` with masks: loss rtol 1e-6, gradients
  atol 1e-6, as the solo twin is held (tests/test_torch_linear.py): the
  port sums in float64 and rounds once, the reference sums in float32.
  ``job_trial_losses`` is the loss at each trial point, rtol 1e-6.
- K1, K4 over a job axis, K2 with each job's own bins (its stride):
  identical bins, nodes and class counts (integers; 0/1 weights).
- K6 over a job axis: probabilities within 1e-6, labels identical (the
  same float32 operations; the reference's mean divides once).
- ``job_masked_metrics`` against ``vmap(masked_metrics)``: accuracy
  identical; weighted F1 within 1e-6 (XLA fuses the reference's float32
  product into its sum: a last-bit difference in about a quarter of
  cases, as for the solo metrics).
- The batched L-BFGS segment (``_lr_fused_segment``) against the
  reference's, from the same start: losses rtol 1e-5, parameters 1e-4
  relative to their largest entry (the solo segment's tolerances).
- ``run_group``: keys equal but for the device (mesh) signature; lr ``w``
  and ``b`` 1e-4 relative to their largest entry (the segment's
  tolerance: 15 iterations are one segment here) and each point's
  probabilities on the eval rows within 1e-4, as the whole solo fit is
  held; dt heaps identical and leaf probabilities within 1e-6; accuracy
  identical and weighted F1 within 1e-6 (above). The blobs overlap
  (``blobs``): the solo parity tests take well-conditioned data too.
- A sweep winner's checkpoint, across the packages: labels identical,
  probabilities within 1e-6 (dt) and 1e-5 (lr: the GEMM sums in another
  order), as tests/test_torch_checkpoint.py holds them.

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py's ``sweep`` phase.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from learningorchestra_tpu.ml import binning as jax_binning  # noqa: E402
from learningorchestra_tpu.ml import checkpoint as jax_checkpoint  # noqa: E402
from learningorchestra_tpu.ml import evaluation as jax_evaluation  # noqa: E402
from learningorchestra_tpu.ml import logistic as jax_logistic  # noqa: E402
from learningorchestra_tpu.ml import sweep as jax_sweep  # noqa: E402
from learningorchestra_tpu.ml import trees as jax_trees  # noqa: E402
from learningorchestra_tpu.ml.base import resolve_mesh  # noqa: E402
from learningorchestra_tpu_torch.ml import (  # noqa: E402
    binning,
    checkpoint,
    evaluation,
    logistic,
    sweep,
    trees,
)
from learningorchestra_tpu_torch.parallel.sharding import pad_rows  # noqa: E402
from learningorchestra_tpu_torch.utils.shapegrid import padded_indices  # noqa: E402

FEATURES = 6
ROWS, EVAL_ROWS = 300, 200
LAMBDAS = [{"reg_param": l2} for l2 in (0.0, 0.01, 0.5)]
DEPTHS = [{"max_depth": 2}, {"max_depth": 3}]
MAX_ITER = 15


def t(array):
    return torch.from_numpy(np.array(array))


def assert_close_to_scale(got, expected, relative):
    got, expected = np.asarray(got), np.asarray(expected)
    scale = max(np.abs(expected).max(), 1e-30)
    assert np.abs(got - expected).max() <= relative * scale, (np.abs(got - expected).max(), scale)


def blobs(classes, rows, seed):
    """Overlapping blobs: no class is separable, so at λ = 0 the loss
    stays away from 0 and the fit is well-conditioned (on separable rows
    the weights grow without bound and rounding parts the trajectories)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, FEATURES)) * 0.5
    y = rng.integers(0, classes, size=rows).astype(np.int64)
    X = (centers[y] + rng.normal(size=(rows, FEATURES))).astype(np.float32)
    return X, y


def member_data(classes, seed):
    X, y = blobs(classes, ROWS, seed)
    Xe, ye = blobs(classes, EVAL_ROWS, seed + 100)
    return X, y, Xe, ye


@pytest.fixture(scope="module")
def mesh():
    return resolve_mesh(None)


# --------------------------------------------------------------------------
# The job-axis plain twins against jax.vmap of the reference functions
# --------------------------------------------------------------------------

JOBS = 4


def job_rows(seed, classes=3, rows=ROWS):
    """Stacked rows, labels and a padded-row mask of JOBS jobs."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(JOBS, rows, FEATURES)).astype(np.float32)
    y = rng.integers(0, classes, (JOBS, rows)).astype(np.int32)
    mask = np.ones((JOBS, rows), np.float32)
    for j in range(JOBS):
        mask[j, rows - 7 * (j + 1):] = 0.0   # each job its own padding
    return X, y, mask


@pytest.mark.parametrize("classes", [2, 3])
def test_job_loss_and_grad_is_the_vmapped_masked_loss(classes):
    X, y, mask = job_rows(classes, classes)
    rng = np.random.default_rng(classes + 10)
    W = rng.normal(size=(JOBS, FEATURES, classes)).astype(np.float32)
    b = rng.normal(size=(JOBS, classes)).astype(np.float32)
    l2s = np.array([0.0, 0.1, 0.01, 0.5], np.float32)
    value, grad = jax.vmap(jax.value_and_grad(jax_logistic._loss_fn))(
        {"w": jnp.asarray(W), "b": jnp.asarray(b)},
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask), jnp.asarray(l2s),
    )
    got_value, got_dW, got_db = logistic.job_loss_and_grad(t(W), t(b), t(X), t(y), t(mask), t(l2s))
    assert got_value.shape == (JOBS,) and got_value.dtype == torch.float32
    np.testing.assert_allclose(got_value.numpy(), np.asarray(value), rtol=1e-6)
    np.testing.assert_allclose(got_dW.numpy(), np.asarray(grad["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_db.numpy(), np.asarray(grad["b"]), rtol=0, atol=1e-6)
    # a shared X, labels and mask (a job stride of 0) give each job the same
    shared = logistic.job_loss_and_grad(t(W), t(b), t(X[0]), t(y[0]), t(mask[0]), t(l2s))
    for j in range(JOBS):
        alone = logistic.job_loss_and_grad(
            t(W[j:j + 1]), t(b[j:j + 1]), t(X[0]), t(y[0]), t(mask[0]), t(l2s[j:j + 1])
        )
        for got, want in zip(shared, alone):
            assert torch.equal(got[j], want[0])


def test_job_trial_losses_are_the_masked_loss_at_each_point():
    classes = 3
    X, y, mask = job_rows(7, classes)
    rng = np.random.default_rng(8)
    W4 = rng.normal(size=(JOBS, 4, FEATURES, classes)).astype(np.float32)
    b4 = rng.normal(size=(JOBS, 4, classes)).astype(np.float32)
    l2s = np.array([0.0, 0.1, 0.01, 0.5], np.float32)
    got = logistic.job_trial_losses(t(W4), t(b4), t(X), t(y), t(mask), t(l2s))
    assert got.shape == (JOBS, 4)
    for j in range(JOBS):
        for k in range(4):
            expected = jax_logistic._loss_fn(
                {"w": jnp.asarray(W4[j, k]), "b": jnp.asarray(b4[j, k])},
                jnp.asarray(X[j]), jnp.asarray(y[j]), jnp.asarray(mask[j]), jnp.float32(l2s[j]),
            )
            np.testing.assert_allclose(float(got[j, k]), float(expected), rtol=1e-6)


def test_job_wrappers_refuse_bad_operands():
    X, y, mask = job_rows(1, 2)
    W, b, l2s = torch.zeros(JOBS, FEATURES, 2), torch.zeros(JOBS, 2), torch.zeros(JOBS)
    with pytest.raises(ValueError, match="jobs"):
        logistic.job_loss_and_grad(W[:2], b[:2], t(X), t(y), t(mask), l2s[:2])
    with pytest.raises(TypeError, match="l2s"):
        logistic.job_loss_and_grad(W, b, t(X), t(y), t(mask), l2s[:2])
    with pytest.raises(TypeError, match="weights"):
        logistic.job_loss_and_grad(W, b, t(X), t(y), t(mask[0]), l2s)
    with pytest.raises(ValueError, match="job axis"):
        binning.job_apply_bins(t(X[0]), torch.zeros(FEATURES, 31))
    with pytest.raises(ValueError, match="jobs of bins"):
        trees.route(torch.zeros(JOBS, ROWS, FEATURES, dtype=torch.int8),
                    torch.zeros(ROWS, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))


def test_job_apply_bins_is_the_vmapped_reference():
    X, _, _ = job_rows(3)
    X[0, 5, 2] = np.nan
    thresholds = np.stack([
        jax_binning.make_thresholds(X[j], 32).astype(np.float32) for j in range(JOBS)
    ])
    expected = jax.vmap(jax_binning.apply_bins)(jnp.asarray(X), jnp.asarray(thresholds))
    got = binning.job_apply_bins(t(X), t(thresholds))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    # one shared X under each job's thresholds
    shared = binning.job_apply_bins(t(X[0]), t(thresholds))
    for j in range(JOBS):
        np.testing.assert_array_equal(
            shared[j].numpy(), np.asarray(jax_binning.apply_bins(jnp.asarray(X[0]), jnp.asarray(thresholds[j])))
        )


def job_level(seed, classes=3, n_nodes=4, max_bins=32):
    """Each job's own bins, nodes, weighted one-hot channels and split."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, max_bins, (JOBS, ROWS, FEATURES)).astype(np.int8)
    node = rng.integers(0, n_nodes, (JOBS, ROWS)).astype(np.int32)
    y = rng.integers(0, classes, (JOBS, ROWS))
    mask = (rng.random((JOBS, ROWS)) < 0.9).astype(np.float32)
    channels = (np.eye(classes, dtype=np.float32)[y] * mask[..., None]).astype(np.float32)
    feature = rng.integers(-1, FEATURES, (JOBS, n_nodes)).astype(np.int32)
    split = rng.integers(0, max_bins, (JOBS, n_nodes)).astype(np.int32)
    return bins, node, channels, feature, split


def test_level_histograms_over_each_jobs_bins_are_the_vmapped_reference():
    bins, node, channels, _, _ = job_level(4)
    expected = jax.vmap(partial(jax_trees._level_histograms, n_nodes=4, max_bins=32))(
        jnp.asarray(bins), jnp.asarray(node), jnp.asarray(channels)
    )
    got = trees.level_histograms(t(bins), t(node), t(channels), 4, 32)
    assert got.shape == (JOBS, 4, FEATURES, 32, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def test_route_over_each_jobs_bins_is_the_vmapped_reference():
    bins, node, _, feature, split = job_level(5)
    expected = jax.vmap(jax_trees._route)(
        jnp.asarray(bins), jnp.asarray(node), jnp.asarray(feature), jnp.asarray(split)
    )
    got = trees.route(t(bins), t(node), t(feature), t(split))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def job_heaps(seed, depth=3, classes=3, trees_per_job=1):
    rng = np.random.default_rng(seed)
    nodes, leaves = 2**depth - 1, 2**depth
    X = rng.normal(size=(JOBS, EVAL_ROWS, FEATURES)).astype(np.float32)
    X[1, 3, :] = np.nan
    fh = rng.integers(-1, FEATURES, (JOBS, trees_per_job, nodes)).astype(np.int32)
    th = rng.normal(size=(JOBS, trees_per_job, nodes)).astype(np.float32)
    lp = rng.dirichlet(np.ones(classes), size=(JOBS, trees_per_job, leaves)).astype(np.float32)
    return X, fh, th, lp


@pytest.mark.parametrize("trees_per_job", [1, 3])
def test_job_ensemble_forward_is_the_vmapped_reference(trees_per_job):
    depth = 3
    X, fh, th, lp = job_heaps(6, depth, trees_per_job=trees_per_job)
    expected = jax.vmap(lambda *a: jax_trees._ensemble_forward(*a, max_depth=depth))(
        jnp.asarray(X), jnp.asarray(fh), jnp.asarray(th), jnp.asarray(lp)
    )
    got = trees.job_ensemble_forward(t(X), t(fh), t(th), t(lp), depth)
    assert got.shape == (JOBS, EVAL_ROWS, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy().argmax(2), np.asarray(expected).argmax(2))
    # one shared X: each job's trees on the same rows
    shared = trees.job_ensemble_forward(t(X[0]), t(fh), t(th), t(lp), depth)
    for j in range(JOBS):
        assert torch.equal(shared[j], trees.ensemble_forward(t(X[0]), t(fh[j]), t(th[j]), t(lp[j]), depth))


def test_job_masked_metrics_is_the_vmapped_reference():
    rng = np.random.default_rng(9)
    y_true = rng.integers(0, 3, (JOBS, ROWS))
    y_pred = np.where(rng.random((JOBS, ROWS)) < 0.7, y_true, rng.integers(0, 3, (JOBS, ROWS)))
    weights = (rng.random((JOBS, ROWS)) < 0.9).astype(np.float32)
    accuracy, f1 = jax.vmap(partial(jax_evaluation.masked_metrics, num_classes=3))(
        jnp.asarray(y_true), jnp.asarray(y_pred), jnp.asarray(weights)
    )
    got_accuracy, got_f1 = evaluation.job_masked_metrics(t(y_true), t(y_pred), t(weights), 3)
    np.testing.assert_array_equal(got_accuracy.numpy(), np.asarray(accuracy))
    np.testing.assert_allclose(got_f1.numpy(), np.asarray(f1), rtol=0, atol=1e-6)
    for j in range(JOBS):   # each job its own confusion block
        solo = evaluation.masked_metrics(t(y_true[j]), t(y_pred[j]), t(weights[j]), 3)
        assert float(solo[0]) == float(got_accuracy[j])


@pytest.mark.parametrize("iters", [1, 5])
def test_fused_segment_matches_the_reference(iters):
    """Well-conditioned data (blobs), as the solo segment is held: on
    random labels the loss is flat and rounding parts the parameters
    along the flat direction."""
    classes = 3
    _, _, mask = job_rows(11, classes)
    X, y = zip(*(blobs(classes, ROWS, seed=40 + j) for j in range(JOBS)))
    X, y = np.stack(X), np.stack(y).astype(np.int32)
    l2s = np.array([0.0, 0.1, 0.01, 0.5], np.float32)
    params = {
        "w": jnp.zeros((JOBS, FEATURES, classes), jnp.float32),
        "b": jnp.zeros((JOBS, classes), jnp.float32),
    }
    states = jax.vmap(jax_logistic._lbfgs_state)(params)
    args = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask), jnp.asarray(l2s))
    expected = jax_sweep._lr_fused_segment(params, states, *args, iters)
    expected = jax_sweep._lr_fused_segment(*expected[:2], *args, iters)   # a carried state
    W = torch.zeros(JOBS, FEATURES, classes)
    b = torch.zeros(JOBS, classes)
    state = sweep._job_lbfgs_state(W, b)
    operands = (t(X), t(y), t(mask), t(l2s))
    W, b, state, _ = sweep._lr_fused_segment(W, b, state, *operands, iters)
    W, b, state, losses = sweep._lr_fused_segment(W, b, state, *operands, iters)
    assert losses.shape == (JOBS, iters)
    np.testing.assert_allclose(losses.numpy(), np.asarray(expected[2]), rtol=1e-5)
    for j in range(JOBS):
        assert_close_to_scale(W[j].numpy(), expected[0]["w"][j], 1e-4)
        assert_close_to_scale(b[j].numpy(), expected[0]["b"][j], 1e-4)
    np.testing.assert_array_equal(state["head"].numpy(), np.asarray(expected[1]["head"]))
    np.testing.assert_array_equal(state["filled"].numpy(), np.asarray(expected[1]["filled"]))


# --------------------------------------------------------------------------
# prepare_member and run_group, both packages
# --------------------------------------------------------------------------

def both_groups(kind, classes, grid, mesh, members=1):
    """The same members through each package's prepare_member and
    run_group: ``(port keys, jax keys, port results, jax results)``."""
    port_keys, jax_keys, port_payloads, jax_payloads = [], [], [], []
    for m in range(members):
        X, y, Xe, ye = member_data(classes, seed=31 * m + classes)
        key, payload = sweep.prepare_member(kind, X, y, Xe, ye, grid, device="cpu", max_iter=MAX_ITER)
        port_keys.append(key)
        port_payloads.append(payload)
        key, payload = jax_sweep.prepare_member(kind, X, y, Xe, ye, grid, mesh=mesh, max_iter=MAX_ITER)
        jax_keys.append(key)
        jax_payloads.append(payload)
    ours = sweep.run_group(port_payloads, "cpu")
    theirs = jax_sweep.run_group(jax_payloads, mesh)
    return port_keys, jax_keys, ours, theirs


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("members", [1, 2])
def test_lr_group_matches_the_reference(classes, members, mesh):
    port_keys, jax_keys, ours, theirs = both_groups("lr", classes, LAMBDAS, mesh, members)
    for key, jax_key in zip(port_keys, jax_keys):
        assert key[:-1] == jax_key[:-1] and key[-1] == ("cpu", None)
        assert key[2] > ROWS    # masked padded rows ride along
    for (status, got), (jax_status, want) in zip(ours, theirs):
        assert status == jax_status == "ok"
        assert got["kind"] == "lr" and got["best"] == want["best"]
        assert got["_attribution"] == want["_attribution"]
        for point, jax_point in zip(got["points"], want["points"]):
            assert point["grid"] == jax_point["grid"]
            assert point["accuracy"] == jax_point["accuracy"]
            assert abs(point["weighted_f1"] - jax_point["weighted_f1"]) <= 1e-6
        X_eval = member_data(classes, seed=classes)[2]
        for params, jax_params in zip(got["params"], want["params"]):
            np.testing.assert_array_equal(params["mean"], jax_params["mean"])
            np.testing.assert_array_equal(params["scale"], jax_params["scale"])
            assert_close_to_scale(params["w"], jax_params["w"], 1e-4)
            assert_close_to_scale(params["b"], jax_params["b"], 1e-4)
            probs = sweep.model_from_params(params, device="cpu").predict_proba(X_eval)
            jax_probs = jax_sweep.model_from_params(jax_params, mesh).predict_proba(X_eval)
            np.testing.assert_allclose(probs, np.asarray(jax_probs), rtol=0, atol=1e-4)


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("members", [1, 2])
def test_dt_group_matches_the_reference(classes, members, mesh):
    port_keys, jax_keys, ours, theirs = both_groups("dt", classes, DEPTHS, mesh, members)
    for key, jax_key in zip(port_keys, jax_keys):
        assert key[:-1] == jax_key[:-1]
    for (status, got), (_, want) in zip(ours, theirs):
        assert status == "ok" and got["best"] == want["best"]
        for point, jax_point in zip(got["points"], want["points"]):
            assert point["accuracy"] == jax_point["accuracy"]
            assert abs(point["weighted_f1"] - jax_point["weighted_f1"]) <= 1e-6
        for params, jax_params in zip(got["params"], want["params"]):
            assert params["max_depth"] == jax_params["max_depth"]
            np.testing.assert_array_equal(params["features_heap"], jax_params["features_heap"])
            np.testing.assert_array_equal(params["thresholds_heap"], jax_params["thresholds_heap"])
            np.testing.assert_allclose(params["leaf_probs"], jax_params["leaf_probs"], rtol=0, atol=1e-6)


def test_a_poisoned_member_fails_alone_as_in_the_reference(mesh):
    X, y, Xe, ye = member_data(2, 5)
    bad = X.copy()
    bad[3, 1] = np.nan
    payloads = [
        sweep.prepare_member("lr", data, y, Xe, ye, LAMBDAS[:1], device="cpu", max_iter=3)[1]
        for data in (X, bad)
    ]
    ours = sweep.run_group(payloads, "cpu")
    assert ours[0][0] == "ok"
    assert ours[1][0] == "error" and "non-finite" in str(ours[1][1])


def test_validate_grid_is_the_reference():
    for kind, grid in (
        ("lr", [{"reg_param": 1}]), ("dt", [{"max_depth": 4}]), ("lr", [{"reg_param": -1.0}]),
        ("dt", [{"max_depth": 13}]), ("dt", [{"max_depth": True}]), ("nb", [{}]), ("lr", []),
    ):
        try:
            want = jax_sweep.validate_grid(kind, grid)
        except ValueError as error:
            with pytest.raises(ValueError) as raised:
                sweep.validate_grid(kind, grid)
            assert str(raised.value) == str(error)
        else:
            assert sweep.validate_grid(kind, grid) == want
    for name in ("SWEEP_CLASSIFIERS", "_JOB_PAD_FLOOR", "_MAX_FUSED_SLICES", "MAX_GRID_POINTS"):
        assert getattr(sweep, name) == getattr(jax_sweep, name)
    assert padded_indices(3, 8) == [0, 1, 2, 0, 0, 0, 0, 0]
    padded, mask = pad_rows(np.ones((ROWS, 2)), 1)
    assert padded.shape == (320, 2) and mask.sum() == ROWS


def test_fused_programs_count_their_calls():
    X, y, Xe, ye = member_data(2, 3)
    sweep.reset_program_calls()
    _, payload = sweep.prepare_member("lr", X, y, Xe, ye, LAMBDAS, device="cpu", max_iter=4)
    sweep.run_group([payload], "cpu")
    _, payload = sweep.prepare_member("dt", X, y, Xe, ye, DEPTHS, device="cpu")
    sweep.run_group([payload], "cpu")
    # lr: one segment of 4 iterations at this size, one eval; dt: one program a depth
    assert sweep.program_calls() == {"lr_fused_segment": 1, "lr_fused_eval": 1, "dt_fused": 2}


# --------------------------------------------------------------------------
# A sweep winner's checkpoint, across the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind, grid", [("lr", LAMBDAS), ("dt", DEPTHS)])
def test_winner_checkpoints_cross_over(kind, grid, mesh, tmp_path):
    X, y, Xe, ye = member_data(3, 17)
    _, payload = sweep.prepare_member(kind, X, y, Xe, ye, grid, device="cpu", max_iter=MAX_ITER)
    result = sweep.run_group([payload], "cpu")[0][1]
    _, jax_payload = jax_sweep.prepare_member(kind, X, y, Xe, ye, grid, mesh=mesh, max_iter=MAX_ITER)
    jax_result = jax_sweep.run_group([jax_payload], mesh)[0][1]
    atol = 1e-5 if kind == "lr" else 1e-6

    ours = sweep.model_from_params(result["params"][result["best"]], device="cpu")
    path = str(tmp_path / "ours.model")
    checkpoint.save_model(ours, path)
    loaded = jax_checkpoint.load_model(path, mesh)
    labels, probs = ours.predict_both(Xe)
    np.testing.assert_array_equal(np.asarray(loaded.predict(Xe)), labels)
    np.testing.assert_allclose(np.asarray(loaded.predict_proba(Xe)), probs, rtol=0, atol=atol)

    theirs = jax_sweep.model_from_params(jax_result["params"][jax_result["best"]], mesh)
    path = str(tmp_path / "theirs.model")
    jax_checkpoint.save_model(theirs, path)
    loaded = checkpoint.load_model(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict(Xe), np.asarray(theirs.predict(Xe)))
    np.testing.assert_allclose(loaded.predict_proba(Xe), np.asarray(theirs.predict_proba(Xe)), rtol=0, atol=atol)
