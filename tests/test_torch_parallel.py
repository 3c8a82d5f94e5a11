"""The port's data axis (learningorchestra_tpu_torch/parallel/) and K8′,
held against the JAX package on the conftest's 8 virtual devices.

No process group here: a rank's block comes from ``shard_rows`` on a
``Mesh`` built by hand with its data coordinate (the layout needs no
collective); tests/test_torch_multihost.py runs the collectives in gloo
processes.

Tolerances, and why:
- ``make_mesh``'s shape errors, ``padded_row_count``, ``bucket_rows``,
  ``host_row_range``, ``shard_rows``' blocks and masks: identical.
- ``masked_stats`` against the reference's ``_masked_stats`` on the
  8-device sharded X and mask: mean and scale within ``rtol=2e-6,
  atol=1e-6``. The reference sums in float32 (its ``weights`` are X's
  dtype) and takes the variance about its float32 mean; the port sums in
  float64 about the float64 mean and rounds each result once, so the two
  part by the reference's float32 rounding of a few hundred rows. The
  constant column is 2.5, which float32 sums exactly: where they do not
  (3.7), the reference's variance keeps a residue and its scale is not
  pinned, while the port's is 1 (its own test below).
- ``standardize`` on the same mean and scale: bit-equal (float32, each
  operation rounded on its own in both).
- K7's sums form on the CPU: the twin's sums over ``sum w`` are today's
  weighted ``_weighted_terms`` bit for bit, and the trial losses' the
  same; split over blocks and added in rank order, the sums give what one
  block gives within float64 rounding (1e-12 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from learningorchestra_tpu.ml import logistic as jax_logistic  # noqa: E402
from learningorchestra_tpu.parallel import mesh as jax_mesh  # noqa: E402
from learningorchestra_tpu.parallel import multihost as jax_multihost  # noqa: E402
from learningorchestra_tpu.parallel import sharding as jax_sharding  # noqa: E402
from learningorchestra_tpu_torch import kernels, parallel  # noqa: E402
from learningorchestra_tpu_torch.ml import logistic  # noqa: E402
from learningorchestra_tpu_torch.parallel import mesh, multihost, sharding  # noqa: E402

ROW_COUNTS = (1, 7, 8, 9, 100, 400, 1000, 4097)


def port_mesh(data: int, index: int) -> mesh.Mesh:
    """Rank ``index``'s view of a data axis of ``data`` (no process group)."""
    return mesh.Mesh(shape={mesh.DATA_AXIS: data, mesh.MODEL_AXIS: 1}, data_index=index,
                     group=None, device=torch.device("cpu"))


def reference_mesh(data: int):
    return jax_mesh.make_mesh(data=data, devices=jax.devices()[:data])


def shard_of(array, r: int) -> np.ndarray:
    return np.asarray(array.addressable_shards[r].data)


def rows_with_a_constant_column(rows: int, features: int, seed: int = 0,
                                constant: float = 2.5) -> np.ndarray:
    """Seeded rows, column ``features // 2`` constant. 2.5 sums exactly in
    float32 too, so that both packages pin its scale to 1."""
    rng = np.random.default_rng(seed)
    X = rng.normal(loc=rng.normal(size=features) * 5, scale=rng.uniform(0.5, 3, size=features),
                   size=(rows, features)).astype(np.float32)
    X[:, features // 2] = np.float32(constant)
    return X


# --------------------------------------------------------------------------
# mesh.py, sharding.py, multihost.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("data, model, devices", [
    (None, 0, 8), (None, 3, 8), (16, 1, 8), (5, 2, 8), (2, 1, 1), (None, -1, 4),
])
def test_make_mesh_shape_errors_are_the_reference(data, model, devices):
    with pytest.raises(ValueError) as expected:
        jax_mesh.make_mesh(data=data, model=model, devices=jax.devices()[:devices])
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(data=data, model=model, devices=list(range(devices)), device="cpu")
    assert str(got.value) == str(expected.value)


def test_one_process_gets_a_one_by_one_mesh_and_no_model_axis():
    """One process is one rank: a 1×1 mesh with no group on either axis; a
    model axis of 2 needs two ranks of a process group."""
    one = mesh.make_mesh(device="cpu")
    assert (mesh.data_size(one), mesh.model_size(one)) == (1, 1)
    assert one.group is None and one.data_index == 0 and one.device == torch.device("cpu")
    assert one.model_group is None and one.model_index == 0
    assert not mesh.over_ranks(one) and not mesh.over_model(one)
    assert parallel.default_mesh(device="cpu").shape == one.shape
    with pytest.raises(ValueError, match="world size 1"):
        mesh.make_mesh(model=2, devices=[0, 1], device="cpu")


@pytest.mark.parametrize("data, model, devices", [
    (2, 2, 4), (4, 2, 8), (2, 3, 8), (None, 2, 8), (None, 4, 8), (1, 8, 8), (8, 1, 8), (3, 2, 7),
])
def test_the_two_d_layout_is_the_references(data, model, devices):
    """``mesh.grid`` lays the ranks out as the reference's ``make_mesh``
    lays out its devices (``devices[:data*model].reshape(data, model)``):
    rank r at data index r // model and model index r % model; a model
    group a row, a data group a column."""
    expected = jax_mesh.make_mesh(data=data, model=model, devices=jax.devices()[:devices])
    D, M = expected.shape[mesh.DATA_AXIS], expected.shape[mesh.MODEL_AXIS]
    layout = mesh.grid(D, M)
    assert layout == [[device.id for device in row] for row in expected.devices]
    for d, row in enumerate(layout):
        for m, rank in enumerate(row):
            assert divmod(rank, M) == (d, m)


@pytest.mark.parametrize("n", ROW_COUNTS + (0, 5_000, 1 << 20, (1 << 20) + 1))
def test_padded_row_count_and_bucket_rows_are_the_reference(n):
    assert sharding.bucket_rows(max(n, 1)) == jax_sharding.bucket_rows(max(n, 1))
    for multiple in (1, 2, 3, 4, 8):
        assert sharding.padded_row_count(n, multiple) == jax_sharding.padded_row_count(n, multiple)


@pytest.mark.parametrize("data", [1, 2, 4, 8])
@pytest.mark.parametrize("n", ROW_COUNTS)
def test_shard_rows_block_and_host_row_range_are_the_reference_shard(data, n):
    X = np.arange(n * 3, dtype=np.float64).reshape(n, 3) - 0.5
    expected_rows, expected_mask = jax_sharding.shard_rows(X, reference_mesh(data), dtype=np.float32)
    for r in range(data):
        block, mask = sharding.shard_rows(X, port_mesh(data, r), dtype=np.float32)
        assert block.dtype == torch.float32 and mask.dtype == torch.bool
        np.testing.assert_array_equal(block.numpy(), shard_of(expected_rows, r))
        np.testing.assert_array_equal(mask.numpy(), shard_of(expected_mask, r))
        rows = expected_rows.addressable_shards[r].index[0].indices(expected_rows.shape[0])
        start, stop = multihost.host_row_range(n, port_mesh(data, r))
        assert (start, stop) == (min(rows[0], n), min(rows[1], n))
    # one process of the reference feeds every block: its range is all rows
    assert jax_multihost.host_row_range(n, reference_mesh(data)) == (0, n)


@pytest.mark.parametrize("data", [1, 2, 4, 8])
def test_shard_rows_local_is_the_block_of_shard_rows(data):
    n = 1000
    X = np.random.default_rng(1).normal(size=(n, 5))
    for r in range(data):
        at = port_mesh(data, r)
        start, stop = multihost.host_row_range(n, at)
        local, local_mask = multihost.shard_rows_local(X[start:stop], at, n, dtype=np.float32)
        block, mask = sharding.shard_rows(X, at, dtype=np.float32)
        assert torch.equal(local, block) and torch.equal(local_mask, mask)
        # a wrong slice raises the reference's error
        with pytest.raises(ValueError, match=r"expected rows \["):
            multihost.shard_rows_local(np.concatenate([X[start:stop], X[:1]]), at, n)


def test_fetch_and_all_sum_without_a_group_are_local():
    one = port_mesh(1, 0)
    rows = torch.arange(12.0).reshape(6, 2)
    mask = torch.tensor([True] * 4 + [False] * 2)
    np.testing.assert_array_equal(multihost.fetch(rows, one), rows.numpy())
    np.testing.assert_array_equal(multihost.fetch(rows, one, mask), rows[:4].numpy())
    assert multihost.all_sum(rows, one) is rows


def test_initialize_from_env_needs_all_three_variables(monkeypatch):
    for name in ("LO_COORDINATOR", "LO_NUM_PROCESSES", "LO_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("LO_COORDINATOR", "127.0.0.1:1")
    assert multihost.initialize_from_env(device="cpu") is False


def test_policy_dtype_and_put_replicated(monkeypatch):
    assert sharding.policy_dtype(np.float32) == torch.float32
    assert sharding.policy_dtype(np.int32) == torch.int32
    assert sharding.policy_dtype(None) is None
    from learningorchestra_tpu_torch.utils import dtypepolicy

    monkeypatch.setenv("LO_DTYPE_POLICY", "bf16")
    monkeypatch.setattr(dtypepolicy, "_POLICY", [])
    assert sharding.policy_dtype(np.float32) == torch.bfloat16
    assert sharding.policy_dtype(np.bool_) == torch.bool
    replicated = sharding.put_replicated(np.ones(3, np.float32), port_mesh(1, 0))
    assert replicated.device == torch.device("cpu") and replicated.tolist() == [1.0, 1.0, 1.0]


# --------------------------------------------------------------------------
# K8′: the masked scaler and the standardization
# --------------------------------------------------------------------------

@pytest.mark.parametrize("features", [1, 12, 17])
@pytest.mark.parametrize("rows", [400, 1000])
def test_masked_stats_and_standardize_match_the_reference(features, rows):
    X = rows_with_a_constant_column(rows, features, seed=features)
    ref_mesh = reference_mesh(8)
    X_dev, mask = jax_sharding.shard_rows(X, ref_mesh)
    assert not np.asarray(mask).all()      # padded rows are in the blocks
    ref_mean, ref_scale = jax_logistic._masked_stats(X_dev, mask)
    ref_mean, ref_scale = np.asarray(ref_mean), np.asarray(ref_scale)

    padded, padded_mask = sharding.pad_rows(X, 8)
    weights = torch.from_numpy(padded_mask.astype(np.float32))
    mean, scale = logistic.masked_stats(torch.from_numpy(padded), weights)
    assert mean.dtype == scale.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), ref_mean, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(scale.numpy(), ref_scale, rtol=2e-6, atol=1e-6)
    assert scale[features // 2] == 1.0 and ref_scale[features // 2] == 1.0

    # the standardization, on the same mean and scale: the same bits
    expected = np.asarray(jax_logistic._standardize(
        X_dev, ref_mean, ref_scale, mask.astype(X_dev.dtype)))
    got = logistic.standardize(torch.from_numpy(padded), torch.tensor(ref_mean),
                               torch.tensor(ref_scale), weights)
    assert got.numpy().tobytes() == expected.tobytes()
    assert not got.numpy()[~padded_mask].any()


def test_a_constant_column_pins_to_one_where_float32_sums_leave_a_residue():
    """A constant of 3.7 over 400 rows: the reference's float32 sums leave
    its variance a rounding residue, so its scale is a few ulps of the
    mean and is not pinned; the port's float64 sums are exact there, the
    variance 0 and the scale 1 (the reference's intent)."""
    X = rows_with_a_constant_column(400, 3, constant=3.7)
    X_dev, mask = jax_sharding.shard_rows(X, reference_mesh(8))
    ref_scale = np.asarray(jax_logistic._masked_stats(X_dev, mask)[1])
    padded, padded_mask = sharding.pad_rows(X, 8)
    scale = logistic.masked_stats(torch.from_numpy(padded), torch.from_numpy(padded_mask.astype(np.float32)))[1]
    assert 0 < ref_scale[1] < 1e-5 and scale[1] == 1.0
    np.testing.assert_allclose(scale.numpy()[[0, 2]], ref_scale[[0, 2]], rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("features", [1, 12, 17])
def test_masked_stats_from_blocks_is_the_whole_in_rank_order(features):
    """The two passes' sums over each rank's block, added in rank order (what
    ``all_sum`` does over a group), give the stats of the whole rows."""
    X = rows_with_a_constant_column(1000, features, seed=3)
    whole = logistic.masked_stats(*(torch.from_numpy(a) for a in (
        sharding.pad_rows(X, 4)[0], sharding.pad_rows(X, 4)[1].astype(np.float32))))
    blocks = [sharding.shard_rows(X, port_mesh(4, r), dtype=np.float32) for r in range(4)]
    weights = [mask.to(torch.float32) for _, mask in blocks]

    def in_rank_order(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    first = in_rank_order([logistic.masked_col_sums(b, w) for (b, _), w in zip(blocks, weights)])
    mean64 = first[:-1] / first[-1]
    second = in_rank_order([logistic.masked_col_sums(b, w, mean64) for (b, _), w in zip(blocks, weights)])
    std = torch.sqrt(second[:-1] / first[-1]).to(torch.float32)
    np.testing.assert_allclose(mean64.to(torch.float32).numpy(), whole[0].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(torch.where(std > 0, std, 1.0).numpy(), whole[1].numpy(), rtol=1e-6)


def test_masked_col_sums_two_passes_and_the_operands():
    X = rows_with_a_constant_column(300, 5, seed=4)
    w = (np.arange(300) < 250).astype(np.float32)
    got = logistic.masked_col_sums(torch.from_numpy(X), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got[:-1], (X.astype(np.float64) * w[:, None]).sum(0), rtol=1e-13)
    assert got[-1] == 250.0
    mean = got[:-1] / got[-1]
    centred = logistic.masked_col_sums(torch.from_numpy(X), torch.from_numpy(w), torch.from_numpy(mean))
    np.testing.assert_allclose(
        centred.numpy()[:-1], (((X.astype(np.float64) - mean) ** 2) * w[:, None]).sum(0), rtol=1e-12)
    assert centred[2] == 0.0        # the constant column
    with pytest.raises(TypeError):
        logistic.masked_col_sums(torch.from_numpy(X).double(), torch.from_numpy(w))
    # bfloat16 rows: bfloat16 statistics, and a standardization that takes them
    X16 = torch.from_numpy(X).to(torch.bfloat16)
    mean16, scale16 = logistic.masked_stats(X16, torch.from_numpy(w))
    assert mean16.dtype == scale16.dtype == torch.bfloat16 and float(scale16[2]) == 1.0
    out = logistic.standardize(X16, mean16, scale16, torch.from_numpy(w))
    assert out.dtype == torch.bfloat16 and not bool(out[250:].any())
    with pytest.raises(TypeError):   # float32 statistics for bfloat16 rows
        logistic.standardize(X16, torch.zeros(5), torch.ones(5), torch.from_numpy(w))


def test_k8_kernels_are_registered_and_not_launched_on_the_cpu():
    assert "scaler" in kernels.SOURCES and kernels.SOURCES["scaler"].endswith("scaler.cu")
    for name in ("masked_col_sums", "masked_col_sums_centred", "masked_standardize"):
        assert kernels.KERNEL_LIBRARIES[name] == "scaler"
    for name in ("logistic_loss_grad_sums", "logistic_trial_losses_sums"):
        assert kernels.KERNEL_LIBRARIES[name] == "logistic"
    kernels.reset_launches()
    X = torch.from_numpy(rows_with_a_constant_column(64, 3))
    w = torch.ones(64)
    mean, scale = logistic.masked_stats(X, w)
    logistic.standardize(X, mean, scale, w)
    assert set(kernels.launches().values()) == {0}


# --------------------------------------------------------------------------
# K7's sums form
# --------------------------------------------------------------------------

def k7_operands(rows=500, features=6, classes=3, seed=5):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(rows, features)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, classes, rows).astype(np.int32))
    w = torch.from_numpy((rng.random(rows) < 0.8).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(features, classes)).astype(np.float32) * 0.3)
    b = torch.from_numpy(rng.normal(size=classes).astype(np.float32) * 0.1)
    return X, y, w, W, b


@pytest.mark.parametrize("classes", [2, 3])
def test_k7_sums_twin_over_the_weights_is_the_weighted_terms(classes):
    X, y, w, W, b = k7_operands(classes=classes)
    F, C = W.shape
    sums = logistic._weighted_sums(W, b, X, y, w)
    assert sums.dtype == torch.float64 and sums.shape == (F * C + C + 2,)
    assert sums[-1] == w.double().sum()
    means = (sums[:-1] / sums[-1]).to(torch.float32)
    loss, dW, db = logistic._weighted_terms(W, b, X, y, w)
    assert torch.equal(means[: F * C].view(F, C), dW)
    assert torch.equal(means[F * C : -1], db)
    assert torch.equal(means[-1], loss)

    steps = torch.tensor([1.0, 0.5, 0.25, 0.125])
    W4, b4 = W[None] * steps[:, None, None], b[None] * steps[:, None]
    trial = logistic._weighted_trial_sums(W4, b4, X, y, w)
    expected = torch.stack([logistic._weighted_data_loss(W4[k], b4[k], X, y, w) for k in range(4)])
    assert torch.equal((trial[:-1] / trial[-1]).to(torch.float32), expected)


def test_k7_on_a_one_rank_mesh_is_the_weighted_job_pass():
    """On a data axis of 1 the wrappers' sums form gives today's weighted
    job launch's values, L2 included."""
    X, y, w, W, b = k7_operands()
    one = port_mesh(1, 0)
    value, dW, db = logistic.loss_and_grad(W, b, X, y, 0.1, w, one)
    ref_value, ref_dW, ref_db = logistic.job_loss_and_grad(
        W[None], b[None], X, y, w, torch.tensor([0.1]))
    assert torch.equal(value, ref_value[0]) and torch.equal(dW, ref_dW[0]) and torch.equal(db, ref_db[0])
    W4 = W[None] * torch.tensor([1.0, 0.5, 0.25, 0.125])[:, None, None]
    b4 = b[None].expand(4, -1).contiguous()
    got = logistic.trial_losses(W4, b4, X, y, 0.1, w, one)
    assert torch.equal(got, logistic.job_trial_losses(W4[None], b4[None], X, y, w, torch.tensor([0.1]))[0])
    with pytest.raises(ValueError, match="row weights go with a mesh"):
        logistic.loss_and_grad(W, b, X, y, 0.0, w)


def test_k7_sums_over_blocks_in_rank_order_are_the_whole():
    X, y, w, W, b = k7_operands(rows=1000)
    whole = logistic._weighted_sums(W, b, X, y, w)
    parts = [logistic._weighted_sums(W, b, X[i:i + 250], y[i:i + 250], w[i:i + 250])
             for i in range(0, 1000, 250)]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)


def test_parallel_reexports_the_reference_names():
    import learningorchestra_tpu.parallel as jax_parallel

    ported = {"DATA_AXIS", "MODEL_AXIS", "default_mesh", "make_mesh", "pad_rows", "shard_rows",
              "fetch", "host_row_range", "initialize_from_env", "shard_rows_local"}
    assert ported <= set(dir(jax_parallel)) and ported <= set(dir(parallel))
    assert (parallel.DATA_AXIS, parallel.MODEL_AXIS) == (jax_mesh.DATA_AXIS, jax_mesh.MODEL_AXIS)


def test_the_solo_fit_calls_the_wrappers_as_before(monkeypatch):
    """Without a mesh the L-BFGS loop calls the K7 wrappers with their five
    arguments, so that a plain-version context (chip_smoke's ``_plain_k7``,
    which swaps in ``_loss_fn`` and ``_trial_losses``) still runs the solo
    fit, with the wrappers' bits."""
    X, y, _, W, b = k7_operands()
    expected = logistic._fit(torch.zeros_like(W), torch.zeros_like(b), X, y, 10, 0.0)
    monkeypatch.setattr(logistic, "loss_and_grad", logistic._loss_fn)
    monkeypatch.setattr(logistic, "trial_losses", logistic._trial_losses)
    got = logistic._fit(torch.zeros_like(W), torch.zeros_like(b), X, y, 10, 0.0)
    assert all(torch.equal(a, c) for a, c in zip(got, expected))
