"""The model axis's kernels and K8′ on bfloat16 rows, on the CPU.

K7's class-shard form (``ml/logistic.py`` ``shard_stats``, ``shard_grad``
and their twins) against K7's whole-class twin, and K8′'s bfloat16 twins
against the JAX package's ``_masked_stats`` and ``_standardize`` on
bfloat16 rows. The collectives over a model group run in
tests/test_torch_multichip.py (four gloo ranks, a 2 × 2 mesh).

Tolerances, and why:
- the shard stats of M shards combined (``_combine_log_sums``) against the
  whole twin (``_weighted_sums``, ``_weighted_trial_sums``): the nll sums
  within 1e-6 relative (chip_smoke's ``K7_LOSS_RTOL``), the gradient sums
  within 1e-6 of the largest gradient sum. The whole twin rounds each
  row's log-softmax and residual to float32; the shards carry the row's
  log-sum-exp and residuals in float64. The logits are the same float32
  values in both, and the weights' sum is exact.
- K8′ on bfloat16 rows against the reference: mean and scale within one
  bfloat16 ulp (its float32 sums against the twin's float64 ones, each
  rounded once to bfloat16), the count exact (its bfloat16 rounding:
  1,000,000 valid rows count 999,424), the standardization bit-equal on
  the same mean and scale (every operation rounded to bfloat16 in both).
- ``_shard_direction`` on a model group of one against ``_two_loop``:
  within 1e-5 of the direction's and the slope's scale (float64 scalars
  from one Gram matrix against float32 dots taken one at a time).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learningorchestra_tpu.ml import logistic as jax_logistic  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import logistic  # noqa: E402

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-6
STEPS = (1.0, 0.5, 0.25, 0.125)


def k7_operands(rows=1_000, features=6, classes=4, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(rows, features)).astype(np.float32)).to(dtype)
    y = torch.from_numpy(rng.integers(0, classes, rows).astype(np.int32))
    w = torch.from_numpy((np.arange(rows) < rows - rows // 10).astype(np.float32))
    W = torch.from_numpy((rng.normal(size=(features, classes)) * 0.5).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=classes) * 0.5).astype(np.float32))
    return X, y, w, W, b


def shards(W, b, model: int):
    width = W.shape[-1] // model
    return [(W[..., m * width:(m + 1) * width].contiguous(), b[..., m * width:(m + 1) * width].contiguous(),
             m * width) for m in range(model)]


def combined_lse(W, b, X, y, model: int):
    return logistic._combine_log_sums([
        logistic._shard_log_sums(logistic.shard_stats(Ws, bs, X, y, first))
        for Ws, bs, first in shards(W, b, model)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("classes, model", [(2, 2), (4, 2), (10, 2), (6, 3)])
def test_shard_grads_combined_are_the_whole_twins(classes, model, dtype):
    """C/M = 1, 2, 5: each shard's sums given the combined log-sum-exp, its
    gradient columns in class order and its nll cells added, are K7's
    whole-class sums."""
    X, y, w, W, b = k7_operands(classes=classes, seed=classes, dtype=dtype)
    whole = logistic._weighted_sums(W, b, X, y, w)
    lse = combined_lse(W[None], b[None], X, y, model)[0]
    F, C = W.shape
    grads = [logistic.shard_grad(Ws, bs, X, y, w, lse, first) for Ws, bs, first in shards(W, b, model)]
    width = C // model
    dW = torch.cat([g[:F * width].view(F, width) for g in grads], dim=1).reshape(-1)
    db = torch.cat([g[F * width:F * width + width] for g in grads])
    nll = sum(g[-2] for g in grads)
    scale = float(whole[:F * C + C].abs().max())
    assert float((dW - whole[:F * C]).abs().max()) <= GRAD_RTOL * scale
    assert float((db - whole[F * C:F * C + C]).abs().max()) <= GRAD_RTOL * scale
    assert abs(float(nll) - float(whole[-2])) <= LOSS_RTOL * abs(float(whole[-2]))
    assert all(float(g[-1]) == float(whole[-1]) == 900.0 for g in grads)


@pytest.mark.parametrize("classes, model", [(2, 2), (4, 2), (10, 2)])
def test_shard_trial_losses_from_the_stats_are_the_whole_twins(classes, model):
    """The four Armijo points from one stats launch: ``sum w (lse - z_y)``
    over the shards' label logits, over ``sum w``, is K7's trial twin."""
    X, y, w, W, b = k7_operands(classes=classes, seed=classes + 1)
    rng = np.random.default_rng(classes)
    D = torch.from_numpy(rng.normal(size=W.shape).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=b.shape).astype(np.float32))
    steps = torch.tensor(STEPS)
    W4 = (W[None] + steps[:, None, None] * D[None]).contiguous()
    b4 = (b[None] + steps[:, None] * d[None]).contiguous()
    want = logistic._weighted_trial_sums(W4, b4, X, y, w)
    lse = combined_lse(W4, b4, X, y, model)
    wd = w.to(torch.float64)
    labels = sum((logistic.shard_stats(Ws, bs, X, y, first)[..., 2].to(torch.float64) * wd).sum(dim=1)
                 for Ws, bs, first in shards(W4, b4, model))
    got = (lse * wd).sum(dim=1) - labels
    np.testing.assert_allclose(got.numpy(), want[:-1].numpy(), rtol=LOSS_RTOL, atol=0)


def test_shard_stats_are_the_row_terms_of_the_shard():
    """A shard of all the classes gives each row's K7 terms: the largest
    logit, the log-sum over it and the label's logit."""
    X, y, w, W, b = k7_operands(classes=3)
    stats = logistic.shard_stats(W[None], b[None], X, y, 0)[0]
    logits = logistic._shard_logits(X, W, b)
    nll, shifted, log_sum = logistic._row_terms(X, y, W, b)
    assert torch.equal(stats[:, 0], logits.max(dim=1).values)
    assert torch.equal(stats[:, 2], logits.gather(1, y.long()[:, None])[:, 0])
    np.testing.assert_allclose(torch.log(stats[:, 1]).numpy(), log_sum.numpy(), rtol=1e-6, atol=1e-7)
    # a label outside the shard: no logit
    outside = logistic.shard_stats(W[None, :, :1].contiguous(), b[None, :1].contiguous(), X, y, 0)[0]
    assert bool((outside[y != 0, 2] == 0).all())


def test_combined_log_sums_are_the_log_sum_exp():
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.normal(size=50) * 30) for _ in range(3)]
    np.testing.assert_allclose(logistic._combine_log_sums(parts).numpy(),
                               torch.logsumexp(torch.stack(parts), dim=0).numpy(), rtol=1e-14)


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA branch on ``meta`` tensors: the launches recorded,
    not run."""
    record = []
    monkeypatch.setattr(kernels, "check_operands", lambda *tensors: None)
    monkeypatch.setattr(kernels, "launch", lambda name, entry, *args: record.append((name, entry, args)))
    monkeypatch.setattr(kernels, "max_blocks", lambda index: 1056)
    monkeypatch.setattr(kernels, "zeroed_scratch",
                        lambda device, count: torch.zeros(1024, dtype=torch.int32, device=device))
    monkeypatch.setattr(logistic, "_stream", lambda tensor: 0)
    return record


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("points", [1, 4])
def test_shard_wrappers_launch_their_kernels_on_a_card(recorded, dtype, points):
    rows, F, Cs, first = 500_000, 16, 5, 5
    X = torch.zeros((rows, F), dtype=dtype, device="meta")
    y = torch.zeros(rows, dtype=torch.int32, device="meta")
    W = torch.zeros((points, F, Cs), device="meta")
    b = torch.zeros((points, Cs), device="meta")
    stats = logistic.shard_stats(W, b, X, y, first)
    assert stats.shape == (points, rows, 3) and stats.dtype == torch.float32
    w = torch.zeros(rows, device="meta")
    lse = torch.zeros(rows, dtype=torch.float64, device="meta")
    sums = logistic.shard_grad(W[0], b[0], X, y, w, lse, first)
    assert sums.shape == (F * Cs + Cs + 2,) and sums.dtype == torch.float64
    (stats_name, stats_entry, stats_args), (grad_name, grad_entry, grad_args) = recorded
    assert (stats_name, stats_entry) == ("logistic_shard_stats", "lo_logistic_shard_stats")
    assert stats_args[1] == int(dtype == torch.bfloat16)
    assert stats_args[6:11] == (rows, F, Cs, points, first)
    assert (grad_name, grad_entry) == ("logistic_shard_grad", "lo_logistic_shard_grad")
    assert grad_args[1] == int(dtype == torch.bfloat16)
    assert grad_args[9:15] == (rows, F, Cs, first, *kernels.row_chunks(rows))
    assert kernels.KERNEL_LIBRARIES[stats_name] == kernels.KERNEL_LIBRARIES[grad_name] == "logistic"


def test_shard_wrappers_refuse_bad_operands_and_do_not_launch_on_the_cpu(monkeypatch):
    def refuse(*args):
        raise AssertionError("a launch on the CPU")

    monkeypatch.setattr(kernels, "launch", refuse)
    X, y, w, W, b = k7_operands()
    lse = combined_lse(W[None], b[None], X, y, 1)[0]
    logistic.shard_grad(W, b, X, y, w, lse, 0)
    for bad in (-1, 1.0, None):
        with pytest.raises(ValueError):
            logistic.shard_stats(W[None], b[None], X, y, bad)
    with pytest.raises(TypeError):
        logistic.shard_grad(W, b, X, y, w, lse.to(torch.float32), 0)
    with pytest.raises(TypeError):
        logistic.shard_grad(W, b, X, y, None, lse, 0)
    with pytest.raises(ValueError):
        logistic.shard_stats(W[None, :, :0].contiguous(), b[None, :0].contiguous(), X, y, 0)


# --------------------------------------------------------------------------
# K8′ on bfloat16 rows against the reference
# --------------------------------------------------------------------------

def bf16_rows(rows: int, features: int, valid: int, seed: int):
    """Seeded rows as both packages' bfloat16 arrays (the same values),
    column ``features // 2`` constant, the rows past ``valid`` padding."""
    rng = np.random.default_rng(seed)
    X = rng.normal(loc=rng.normal(size=features) * 5, scale=rng.uniform(0.5, 3, size=features),
                   size=(rows, features)).astype(np.float32)
    X[:, features // 2] = 2.5
    X[valid:] = 0.0
    X_jax = jnp.asarray(X).astype(jnp.bfloat16)
    X_port = torch.from_numpy(np.array(X_jax.astype(jnp.float32))).to(torch.bfloat16)
    mask = np.arange(rows) < valid
    return X_jax, X_port, mask


def ulps(got, want) -> int:
    """The largest distance in bfloat16 steps (of finite values)."""
    a = got.to(torch.float32).numpy().view(np.int32) >> 16
    b = np.asarray(want.astype(jnp.float32)).view(np.int32) >> 16
    return int(np.abs(a.astype(np.int64) - b).max())


@pytest.mark.parametrize("rows, features, valid", [
    (1_048_576, 1, 1_000_000), (4096, 1, 4000), (4096, 5, 4000), (4096, 16, 4000),
    (4096, 17, 4000), (777, 3, 700),
])
def test_bf16_masked_stats_and_standardize_are_the_references(rows, features, valid):
    X_jax, X, mask = bf16_rows(rows, features, valid, seed=rows + features)
    want_mean, want_scale = jax_logistic._masked_stats(X_jax, jnp.asarray(mask))
    w = torch.from_numpy(mask.astype(np.float32))
    first = logistic.masked_col_sums(X, w)
    count = float(logistic._bf16(first[-1]))
    assert count == float(jnp.asarray(mask).astype(jnp.bfloat16).sum())
    if valid == 1_000_000:
        assert first[-1] == 1_000_000 and count == 999_424   # the reference's bfloat16 count
    mean, scale = logistic.masked_stats(X, w)
    assert mean.dtype == scale.dtype == torch.bfloat16
    assert ulps(mean, want_mean) <= 1 and ulps(scale, want_scale) <= 1
    # the constant column: pinned to 1 where the reference's bfloat16 sums
    # leave no residue, the reference's residue where they do (2.5 over
    # 1,000,000 rows)
    assert float(scale[features // 2]) == float(want_scale[features // 2])
    want = jax_logistic._standardize(X_jax, want_mean, want_scale, jnp.asarray(mask).astype(jnp.bfloat16))
    got = logistic.standardize(
        X, torch.from_numpy(np.array(want_mean.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(np.array(want_scale.astype(jnp.float32))).to(torch.bfloat16), w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("features", [5, 16])
def test_bf16_masked_stats_over_blocks_in_rank_order_are_the_whole(features):
    """Two blocks' float64 sums added in rank order, then rounded once, give
    the whole block's bfloat16 statistics within one ulp."""
    _, X, mask = bf16_rows(4096, features, 4000, seed=features)
    w = torch.from_numpy(mask.astype(np.float32))
    whole = logistic.masked_stats(X, w)
    halves = [(X[:2048], w[:2048]), (X[2048:], w[2048:])]
    first = sum(logistic.masked_col_sums(x, v) for x, v in halves)
    count = logistic._bf16(first[-1]).to(torch.float32)
    mean = logistic._bf16(logistic._bf16(first[:-1]).to(torch.float32) / count)
    second = sum(logistic.masked_col_sums(x, v, mean.to(torch.float64)) for x, v in halves)
    var = logistic._bf16(logistic._bf16(second[:-1]).to(torch.float32) / count)
    assert torch.equal(mean, whole[0])
    std = logistic._bf16(torch.sqrt(var.to(torch.float32)))
    assert torch.equal(torch.where(std > 0, std, torch.ones_like(std)), whole[1])


@pytest.mark.parametrize("features", [16, 17])
def test_bf16_scaler_wrappers_launch_with_bfloat16_rows(recorded, features):
    rows = 4096
    X = torch.zeros((rows, features), dtype=torch.bfloat16, device="meta")
    w = torch.zeros(rows, device="meta")
    logistic.masked_col_sums(X, w)
    logistic.masked_col_sums(X, w, torch.zeros(features, dtype=torch.float64, device="meta"))
    mean = torch.zeros(features, dtype=torch.bfloat16, device="meta")
    out = logistic.standardize(X, mean, mean, w)
    assert out.dtype == torch.bfloat16 and out.shape == X.shape
    names = [name for name, _, _ in recorded]
    assert names == ["masked_col_sums", "masked_col_sums_centred", "masked_standardize"]
    assert [args[1] for _, _, args in recorded] == [1, 1, 1]


@pytest.mark.parametrize("head, filled", [(0, 0), (3, 3), (7, 10), (2, 10)])
def test_the_shard_direction_from_one_gram_is_the_two_loop(head, filled):
    """On a model group of one, the Gram-matrix form of the two-loop
    recursion gives the sequential recursion's direction and slope within
    1e-5 of their scale (float64 scalars from the Gram against float32
    dots one at a time), and ``g.g``."""
    from learningorchestra_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(head * 11 + filled)
    F, C, m = 6, 4, logistic._LBFGS_MEMORY
    W = torch.from_numpy(rng.normal(size=(F, C)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=C).astype(np.float32))
    state = logistic._lbfgs_state(W, b)
    for key, shape in (("w", (m, F, C)), ("b", (m, C))):
        state["S"][key] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        state["Y"][key] = state["S"][key] + torch.from_numpy(0.1 * rng.normal(size=shape).astype(np.float32))
    sy = sum((state["S"][k] * state["Y"][k]).sum(dim=tuple(range(1, state["S"][k].dim()))) for k in ("w", "b"))
    state["rho"] = (1.0 / sy).to(torch.float32)
    state["head"] = torch.tensor(head, dtype=torch.int32)
    state["filled"] = torch.tensor(filled, dtype=torch.int32)
    state["grad"] = {"w": torch.from_numpy(rng.normal(size=(F, C)).astype(np.float32)),
                     "b": torch.from_numpy(rng.normal(size=C).astype(np.float32))}
    want = logistic._two_loop(state)
    direction, slope, steepest = logistic._shard_direction(state, make_mesh(device="cpu"))
    scale = max(float(want[key].abs().max()) for key in ("w", "b"))
    for key in ("w", "b"):
        assert direction[key].dtype == torch.float32
        assert float((direction[key] - want[key]).abs().max()) <= 1e-5 * scale
    want_slope = logistic._tree_dot(state["grad"], want)
    assert abs(float(slope) - float(want_slope)) <= 1e-5 * abs(float(want_slope))
    assert abs(float(steepest) - float(logistic._tree_dot(state["grad"], state["grad"]))) <= 1e-5 * float(steepest)
