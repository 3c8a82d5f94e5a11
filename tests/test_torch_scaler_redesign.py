"""K8′'s masked column sums as redesigned for the H100
(learningorchestra_tpu_torch/kernels/csrc/scaler.cu ``masked_sums_kernel``,
ml/logistic.py ``masked_col_sums``): one launch a pass over a chunk split
of its own, 16-byte rows in flight, the chunks added by the last block.

The kernel runs only on the card (``chip_smoke.py multigpu`` holds it
against its twin there); here:

- the split (``logistic._sums_chunks``): every row in exactly one chunk,
  no empty chunk, a function of (rows, F) alone, a block for each of the
  264 that an H100 holds at once at the main path's 1,048,576 x 16; its
  constants are the ones the kernel's source states;
- the wrapper's CUDA branch, driven with tensors on the ``meta`` device
  and the launch recorded: one launch a pass, the split's chunk count and
  rows, the partials sized from the split, the ticket from the zeroed
  scratch; on the CPU it launches nothing, and it raises on wrong dtypes,
  shapes and devices;
- ``masked_stats`` against the reference's ``_masked_stats`` on the
  conftest's 8 virtual devices, at row counts that cross the split's
  chunk boundaries (1, 1,023, 1,025, 4,097) and widths that take the
  16-byte path, the one-feature path and the windows of wide rows (1, 4,
  5, 16, 17, 65, 256). Tolerance ``rtol=2e-6, atol=1e-6``, as
  tests/test_torch_parallel.py states it: the reference sums in float32
  about its float32 mean, the port in float64 about the float64 mean, each
  result rounded once.
"""

import inspect
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from learningorchestra_tpu.ml import logistic as jax_logistic  # noqa: E402
from learningorchestra_tpu.parallel import mesh as jax_mesh  # noqa: E402
from learningorchestra_tpu.parallel import sharding as jax_sharding  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import logistic  # noqa: E402
from learningorchestra_tpu_torch.parallel import sharding  # noqa: E402

SPLIT_ROWS = (0, 1, 1023, 1024, 1025, 4096, 1_000_000, 1_048_576)
SPLIT_FEATURES = (1, 5, 16, 17, 64, 65, 256)
H100_SMS = 132
RESIDENT_BLOCKS = 2      # masked_sums_kernel's launch bounds: blocks an SM holds


def chunk_ranges(rows: int, num_features: int) -> list:
    chunks, per_chunk = logistic._sums_chunks(rows, num_features)
    return [(c * per_chunk, min(rows, (c + 1) * per_chunk)) for c in range(chunks)]


# --------------------------------------------------------------------------
# The split
# --------------------------------------------------------------------------

@pytest.mark.parametrize("features", SPLIT_FEATURES)
@pytest.mark.parametrize("rows", SPLIT_ROWS)
def test_the_split_covers_every_row_once_with_no_empty_chunk(rows, features):
    ranges = chunk_ranges(rows, features)
    covered = np.zeros(rows, np.int64)
    for start, stop in ranges:
        assert stop > start, (start, stop)
        covered[start:stop] += 1
    assert (covered == 1).all()
    chunks, per_chunk = logistic._sums_chunks(rows, features)
    assert per_chunk >= min(rows, logistic._SUMS_MIN_CHUNK_ROWS)
    assert chunks * logistic._sums_windows(features) <= max(
        logistic._SUMS_BLOCKS, logistic._sums_windows(features))
    assert (chunks == 0) == (rows == 0)


def test_the_split_is_a_function_of_rows_and_features_alone():
    assert set(inspect.signature(logistic._sums_chunks).parameters) == {"rows", "num_features"}
    assert set(inspect.signature(logistic._sums_windows).parameters) == {"num_features"}
    for rows in SPLIT_ROWS:
        for features in SPLIT_FEATURES:
            assert logistic._sums_chunks(rows, features) == logistic._sums_chunks(rows, features)


def test_the_split_fills_the_card_at_the_main_shape():
    chunks, per_chunk = logistic._sums_chunks(1_048_576, 16)
    assert logistic._sums_windows(16) == 1
    assert chunks == logistic._SUMS_BLOCKS == H100_SMS * RESIDENT_BLOCKS
    assert (chunks, per_chunk) == (264, 3972)
    # wide rows: the windows take the blocks, the chunks fewer
    assert logistic._sums_windows(256) == 8
    assert logistic._sums_chunks(1_048_576, 256) == (33, 31776)
    # a block's rows at least 1,024, so small blocks take one chunk
    assert logistic._sums_chunks(4096, 16) == (4, 1024)
    assert logistic._sums_chunks(2047, 16) == (1, 2047)


def test_the_split_and_the_kernel_state_the_same_geometry():
    with open(kernels.SOURCES["scaler"]) as handle:
        source = handle.read()
    assert f"constexpr int kSumsBlocksPerSM = {RESIDENT_BLOCKS};" in source
    assert "__launch_bounds__(kSumsThreads, kSumsBlocksPerSM)" in source
    assert "constexpr int kSumsThreads = 512;" in source
    assert "return F <= 64 ? F : 32;" in source
    for features in (1, 63, 64, 65, 96, 97, 256, 1000):
        assert logistic._sums_windows(features) == (1 if features <= 64 else -(-features // 32))
    # one kernel, no second pass over the chunks
    assert "sum_chunks_kernel" not in source and "col_sums_kernel" not in source
    assert len(re.findall(r"__global__ void", source)) == 3   # the sums, two standardizations


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The wrapper's CUDA branch on ``meta`` tensors: the operand check, the
    zeroed scratch, the stream and the launch recorded, not run; every
    ``torch.empty`` the wrapper makes recorded."""
    record = {"launches": [], "scratch": [], "empty": []}
    monkeypatch.setattr(kernels, "check_operands", lambda *tensors: None)

    def scratch(device, count):
        record["scratch"].append((device, count))
        return torch.zeros(1024, dtype=torch.int32, device=device)

    def launch(name, entry, *args):
        record["launches"].append((name, entry, args))

    real_empty = torch.empty

    def empty(*args, **kwargs):
        tensor = real_empty(*args, **kwargs)
        record["empty"].append((tuple(tensor.shape), tensor.dtype, tensor.device.type))
        return tensor

    monkeypatch.setattr(kernels, "zeroed_scratch", scratch)
    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(logistic, "_stream", lambda tensor: 0)
    monkeypatch.setattr(torch, "empty", empty)
    return record


@pytest.mark.parametrize("rows, features", [(0, 16), (1, 5), (1025, 4), (4097, 17),
                                            (1_048_576, 16), (4096, 256)])
@pytest.mark.parametrize("centred", [False, True])
def test_a_pass_is_one_launch_over_the_split_with_the_zeroed_ticket(recorded, rows, features, centred):
    X = torch.zeros((rows, features), dtype=torch.float32, device="meta")
    w = torch.zeros(rows, dtype=torch.float32, device="meta")
    mean = torch.zeros(features, dtype=torch.float64, device="meta") if centred else None
    recorded["empty"].clear()     # meta factories make their tensors through torch.empty
    out = logistic.masked_col_sums(X, w, mean)
    assert out.shape == (features + 1,) and out.dtype == torch.float64

    chunks, per_chunk = logistic._sums_chunks(rows, features)
    [(name, entry, args)] = recorded["launches"]
    assert name == ("masked_col_sums_centred" if centred else "masked_col_sums")
    assert entry == "lo_masked_col_sums"
    assert len(args) == 12
    # rows, F, the blocks along the rows (one of no rows at 0 rows), rows a chunk
    assert args[6:10] == (rows, features, max(chunks, 1), per_chunk)
    assert recorded["scratch"] == [(X.device, 1)]
    # the wrapper's own tensors: the partials, a row of F + 1 a chunk, and out
    assert [entry for entry in recorded["empty"] if entry[1] == torch.float64] == [
        ((max(chunks, 1), features + 1), torch.float64, "meta"),
        ((features + 1,), torch.float64, "meta"),
    ]


def test_on_the_cpu_nothing_launches(monkeypatch):
    def refuse(*args):
        raise AssertionError("a launch on the CPU")

    monkeypatch.setattr(kernels, "launch", refuse)
    monkeypatch.setattr(kernels, "zeroed_scratch", refuse)
    kernels.reset_launches()
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.normal(size=(1025, 16)).astype(np.float32))
    w = torch.from_numpy((np.arange(1025) < 1000).astype(np.float32))
    first = logistic.masked_col_sums(X, w)
    second = logistic.masked_col_sums(X, w, first[:-1] / first[-1])
    logistic.masked_stats(X, w)
    assert first[-1] == 1000.0 and second.shape == (17,)
    assert set(kernels.launches().values()) == {0}


def test_wrong_dtypes_shapes_and_devices_raise():
    X = torch.ones((8, 4))
    w = torch.ones(8)
    for bad_X, bad_w, error in (
        (X.double(), w, TypeError),
        (X.to(torch.int32), w, TypeError),
        (X.to(torch.bfloat16), w, NotImplementedError),
        (X[0], w, TypeError),
        (X.numpy(), w, TypeError),
        (X, w.double(), TypeError),
        (X, torch.ones(7), TypeError),
        (X, torch.ones(8, device="meta"), ValueError),     # operands on two devices
    ):
        with pytest.raises(error):
            logistic.masked_col_sums(bad_X, bad_w)
    for bad_mean in (torch.zeros(4), torch.zeros(5, dtype=torch.float64),
                     torch.zeros(4, dtype=torch.float64, device="meta")):
        with pytest.raises((TypeError, ValueError)):
            logistic.masked_col_sums(X, w, bad_mean)
    # off the CPU the operands must be CUDA tensors: no path for another device
    with pytest.raises(ValueError, match="not a CUDA device"):
        logistic.masked_col_sums(X.to("meta"), w.to("meta"))


# --------------------------------------------------------------------------
# masked_stats against the reference, across the split's chunk boundaries
# --------------------------------------------------------------------------

@pytest.mark.parametrize("features", [1, 4, 5, 16, 17, 65, 256])
@pytest.mark.parametrize("rows", [1, 1023, 1025, 4097])
def test_masked_stats_match_the_reference_across_chunk_boundaries(rows, features):
    rng = np.random.default_rng(rows * 1000 + features)
    X = rng.normal(loc=rng.normal(size=features) * 5, scale=rng.uniform(0.5, 3, size=features),
                   size=(rows, features)).astype(np.float32)
    X[:, features // 2] = np.float32(2.5)      # sums exactly in float32 too: both pin it to 1
    X_dev, mask = jax_sharding.shard_rows(X, jax_mesh.make_mesh(data=8, devices=jax.devices()[:8]))
    ref_mean, ref_scale = (np.asarray(value) for value in jax_logistic._masked_stats(X_dev, mask))

    padded, padded_mask = sharding.pad_rows(X, 8)
    mean, scale = logistic.masked_stats(torch.from_numpy(padded),
                                        torch.from_numpy(padded_mask.astype(np.float32)))
    assert mean.dtype == scale.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), ref_mean, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(scale.numpy(), ref_scale, rtol=2e-6, atol=1e-6)
    assert scale[features // 2] == 1.0 and ref_scale[features // 2] == 1.0
    if rows == 1:    # one row: no spread, every scale pinned to 1
        assert (scale.numpy() == 1.0).all()
