"""K7 on bfloat16 rows of any width, on the CPU.

Since bfloat16 rows of 202 or more features fit no staged tile of K7
(``ml/logistic._k7_geometry``), the kernel reads them from global memory
and widens each value where it loads it, and a staged tile's raw
bfloat16 bytes arrive by 16-byte ``cp.async`` and are widened in shared
memory (``kernels/csrc/logistic.cu`` ``stage_raw``, ``widen_tile``). On
the CPU the wrappers run the plain twin, which widens X exactly; what is
held here:

- the wrappers take bfloat16 rows of 202, 444 and 20,000 features at 2
  and 10 classes without raising, bit-equal to themselves on the
  widened X (as ``tests/test_torch_bf16.py`` holds them at 5 features),
  and within ``tests/test_torch_linear.py``'s tolerances of the JAX
  package's ``jax.value_and_grad(_loss_fn)`` on the widened X (loss
  rtol 1e-6, gradient atol 1e-6; the trial losses rtol 1e-6);
- the launch layouts at those widths: every block within the card's
  shared memory, the raw tile after the ring on 16 bytes, as large as
  a tile's values and 8 of slack, only where bfloat16 rows are staged,
  and the layout marked bfloat16 as the kernel checks;
- a numpy model of ``stage_raw``'s placement: at every 2-byte alignment
  of the tile's first value and for counts across the word boundaries,
  its 16-byte copies land on 16-byte words of the raw tile and, with
  the values it loads one by one, put each value exactly once at
  ``raw[shift + i]``, the place ``widen_tile`` reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.ml import logistic as jax_logistic
from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.ml import logistic

WIDTHS = (202, 444, 20_000)
ROWS = 48


def wide_inputs(features, classes, seed=None):
    rng = np.random.default_rng(seed if seed is not None else features * 31 + classes)
    X = torch.from_numpy(rng.normal(size=(ROWS, features)).astype(np.float32)).to(torch.bfloat16)
    y = rng.integers(0, classes, ROWS).astype(np.int32)
    W = (rng.normal(size=(features, classes)) * 0.3 / np.sqrt(features)).astype(np.float32)
    b = (rng.normal(size=classes) * 0.3).astype(np.float32)
    return X, y, W, b


def reference_loss(W, b, X, y, l2):
    return jax.value_and_grad(jax_logistic._loss_fn)(
        {"w": jnp.asarray(W), "b": jnp.asarray(b)}, jnp.asarray(X), jnp.asarray(y),
        jnp.ones(len(y), jnp.float32), jnp.float32(l2),
    )


@pytest.mark.parametrize("classes", [2, 10])
@pytest.mark.parametrize("features", WIDTHS)
def test_wide_bf16_rows_are_the_references_loss(features, classes):
    X, y, W, b = wide_inputs(features, classes)
    widened = X.to(torch.float32)
    got = logistic.loss_and_grad(torch.from_numpy(W), torch.from_numpy(b), X, torch.from_numpy(y), 0.1)
    again = logistic.loss_and_grad(torch.from_numpy(W), torch.from_numpy(b), widened, torch.from_numpy(y), 0.1)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    value, grad = reference_loss(W, b, widened.numpy(), y, 0.1)
    np.testing.assert_allclose(float(got[0]), float(value), rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(grad["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(grad["b"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("classes", [2, 10])
@pytest.mark.parametrize("features", WIDTHS)
def test_wide_bf16_rows_are_the_references_trial_losses(features, classes):
    X, y, W, b = wide_inputs(features, classes)
    steps = np.array([1.0, 0.5, 0.25, 0.125], np.float32)
    W4 = torch.from_numpy(W[None] * (1 + steps[:, None, None]))
    b4 = torch.from_numpy(b[None] * (1 + steps[:, None]))
    got = logistic.trial_losses(W4, b4, X, torch.from_numpy(y), 0.0)
    assert torch.equal(got, logistic.trial_losses(W4, b4, X.to(torch.float32), torch.from_numpy(y), 0.0))
    for k in range(4):
        value, _ = reference_loss(W4[k].numpy(), b4[k].numpy(), X.to(torch.float32).numpy(), y, 0.0)
        np.testing.assert_allclose(float(got[k]), float(value), rtol=1e-6)


@pytest.mark.parametrize("trial", [False, True])
def test_bf16_layouts_hold_the_raw_tile(trial):
    for features in (1, 5, 16, 17, 100, *WIDTHS):
        for classes in (2, 10):
            for weighted in (False, True):
                f32 = logistic._k7_geometry(features, classes, 1, False, trial=trial, weighted=weighted)
                geometry = logistic._k7_geometry(
                    features, classes, 1, False, trial=trial, weighted=weighted, x_bf16=True)
                group, tile, form, x_staged, params = geometry
                layout = logistic._k7_layout(
                    features, classes, *geometry, weighted=weighted, trial=trial, x_bf16=True)
                assert layout["bytes"] <= kernels.SHARED_BYTES
                assert layout["x_bf16"] == 1 and layout["raw"] % 16 == 0
                raw = layout["xd"] - layout["raw"]
                assert layout["raw"] - layout["ring"] >= 8 * layout["buffer_floats"]
                if x_staged:
                    assert raw >= 2 * (tile * features + 8)
                else:
                    assert raw == 0 and layout["xs"] == 0
                assert logistic._k7_layout(
                    features, classes, *f32, weighted=weighted, trial=trial)["x_bf16"] == 0
    wide = logistic._k7_launch_layout(20_000, 10, 1, False, False, False, True)
    assert (wide.x_bf16, wide.xs) == (1, 0)   # rows from global memory, widened at each load


def raw_placement(address, count):
    """``stage_raw``'s copies, by the kernel's arithmetic: the shift, the
    16-byte words (source value, raw slot) and the values loaded one by
    one (raw slot of value i: shift + i)."""
    head_full = ((16 - (address & 15)) & 15) // 2
    shift = (8 - head_full) & 7
    head = min(count, head_full)
    words = (count - head) // 8
    tail = head + 8 * words
    singles = list(range(head)) + list(range(tail, count))
    return shift, [head + 8 * i for i in range(words)], singles


@pytest.mark.parametrize("address", range(0, 16, 2))
def test_stage_raw_puts_each_value_once_on_aligned_words(address):
    for count in (0, 1, 3, 7, 8, 9, 15, 16, 17, 64, 202 * 32, 16 * 256 + 5):
        shift, words, singles = raw_placement(address, count)
        seen = np.zeros(count, np.int64)
        for first in words:
            assert (address + 2 * first) % 16 == 0          # the source word is aligned
            assert (2 * (shift + first)) % 16 == 0          # so is its slot in raw
            seen[first:first + 8] += 1
        for value in singles:
            seen[value] += 1
        assert (seen == 1).all()
        assert shift + count <= count + 7                   # inside the raw tile's slack
