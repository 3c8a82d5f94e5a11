"""The port's tree forward (learningorchestra_tpu_torch/ml/trees.py) held
against the JAX reference (learningorchestra_tpu/ml/trees.py) on the CPU.

The same numpy inputs, made from a seed, go through both: heaps with
early leaves (feature -1), an out-of-range feature, inf thresholds, and
NaN in selected and unselected columns. Leaves and labels must be
identical; probabilities agree within 1e-6 (the two forwards run the same
float32 operations in the same order; the sigmoid's implementations
differ in the last bits). The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learningorchestra_tpu.ml import trees as jax_trees  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import trees  # noqa: E402

ROWS, FEATURES, DEPTH, TREES, CLASSES = 257, 6, 3, 4, 3
ATOL = 1e-6


def make_heaps(seed, trees_count=TREES, classes=CLASSES, depth=DEPTH, features=FEATURES):
    rng = np.random.default_rng(seed)
    nodes, leaves = 2**depth - 1, 2**depth
    features_heap = rng.integers(-1, features, size=(trees_count, nodes)).astype(np.int32)
    if features_heap.size:
        features_heap[0, 0] = features + 1  # past the row width: reads 0
    thresholds_heap = rng.normal(size=(trees_count, nodes)).astype(np.float32)
    thresholds_heap[rng.random((trees_count, nodes)) < 0.2] = np.inf  # constant features
    leaf_probs = rng.dirichlet(np.ones(classes), size=(trees_count, leaves)).astype(np.float32)
    leaf_values = rng.normal(size=(trees_count, leaves)).astype(np.float32)
    return features_heap, thresholds_heap, leaf_probs, leaf_values


def make_rows(seed, rows=ROWS, features=FEATURES):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, features)).astype(np.float32)
    X[rng.random((rows, features)) < 0.1] = np.nan
    X[:, 2] = np.nan  # a whole column: selected by some nodes, not by others
    return X


def t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


@pytest.fixture(scope="module")
def inputs():
    return make_rows(1), make_heaps(2)


def test_descend_leaves_identical(inputs):
    X, (features_heap, thresholds_heap, _, _) = inputs
    for tree in range(TREES):
        expected = np.asarray(
            jax_trees._descend(
                jnp.asarray(X),
                jnp.asarray(features_heap[tree]),
                jnp.asarray(thresholds_heap[tree]),
                DEPTH,
            )
        )
        got = trees._descend(t(X), t(features_heap[tree]), t(thresholds_heap[tree]), DEPTH)
        np.testing.assert_array_equal(got.numpy(), expected)
        # both sides of several nodes are taken, NaN rows included
        assert len(np.unique(expected)) > 2


def test_ensemble_forward_matches_reference(inputs):
    X, (features_heap, thresholds_heap, leaf_probs, _) = inputs
    expected = np.asarray(
        jax_trees._ensemble_forward(
            jnp.asarray(X),
            jnp.asarray(features_heap),
            jnp.asarray(thresholds_heap),
            jnp.asarray(leaf_probs),
            max_depth=DEPTH,
        )
    )
    got = trees._ensemble_forward(
        t(X), t(features_heap), t(thresholds_heap), t(leaf_probs), DEPTH
    ).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(1), expected.argmax(1))


def test_gbt_forward_matches_reference(inputs):
    X, (features_heap, thresholds_heap, _, leaf_values) = inputs
    f0, step = np.float32(-0.37), np.float32(0.1)
    expected = np.asarray(
        jax_trees._gbt_forward(
            jnp.asarray(X),
            jnp.float32(f0),
            jnp.asarray(features_heap),
            jnp.asarray(thresholds_heap),
            jnp.asarray(leaf_values),
            jnp.float32(step),
            max_depth=DEPTH,
        )
    )
    got = trees._gbt_forward(
        t(X), float(f0), t(features_heap), t(thresholds_heap), t(leaf_values), 0.1, DEPTH
    ).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(1), expected.argmax(1))


@pytest.mark.parametrize("depth", [0, 1])
def test_shallow_heaps_match_reference(depth):
    X = make_rows(3, rows=40)
    features_heap, thresholds_heap, leaf_probs, _ = make_heaps(4, depth=depth)
    expected = np.asarray(
        jax_trees._ensemble_forward(
            jnp.asarray(X),
            jnp.asarray(features_heap),
            jnp.asarray(thresholds_heap),
            jnp.asarray(leaf_probs),
            max_depth=depth,
        )
    )
    got = trees.ensemble_forward(
        t(X), t(features_heap), t(thresholds_heap), t(leaf_probs), depth
    ).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    "trees_count,depth,classes",
    [(20, 10, 2), (1, 12, 20)],   # past one block's shared memory on the card
)
def test_deep_and_wide_forests_match_reference(trees_count, depth, classes):
    """The shapes whose heaps the card's kernel stages in groups (20 trees
    of depth 10) or reads from global memory (a depth-12 tree of 20
    classes): the plain forward agrees with the reference."""
    X = make_rows(7, rows=300)
    features_heap, thresholds_heap, leaf_probs, leaf_values = make_heaps(
        8, trees_count=trees_count, classes=classes, depth=depth
    )
    expected = np.asarray(
        jax_trees._ensemble_forward(
            jnp.asarray(X), jnp.asarray(features_heap), jnp.asarray(thresholds_heap),
            jnp.asarray(leaf_probs), max_depth=depth,
        )
    )
    got = trees.ensemble_forward(
        t(X), t(features_heap), t(thresholds_heap), t(leaf_probs), depth
    ).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(1), expected.argmax(1))
    expected = np.asarray(
        jax_trees._gbt_forward(
            jnp.asarray(X), jnp.float32(0.2), jnp.asarray(features_heap),
            jnp.asarray(thresholds_heap), jnp.asarray(leaf_values), jnp.float32(0.1),
            max_depth=depth,
        )
    )
    got = trees.gbt_forward(
        t(X), 0.2, t(features_heap), t(thresholds_heap), t(leaf_values), 0.1, depth
    ).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


def test_zero_trees_is_uniform():
    X = make_rows(5, rows=10)
    features_heap, thresholds_heap, leaf_probs, _ = make_heaps(6, trees_count=0)
    expected = np.asarray(
        jax_trees._ensemble_forward(
            jnp.asarray(X),
            jnp.asarray(features_heap),
            jnp.asarray(thresholds_heap),
            jnp.asarray(leaf_probs),
            max_depth=DEPTH,
        )
    )
    got = trees.ensemble_forward(
        t(X), t(features_heap), t(thresholds_heap), t(leaf_probs), DEPTH
    ).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, 1.0 / CLASSES)


def test_wrappers_take_the_plain_path_on_cpu(inputs):
    X, (features_heap, thresholds_heap, leaf_probs, leaf_values) = inputs
    kernels.reset_launches()
    ensemble = trees.ensemble_forward(
        t(X), t(features_heap), t(thresholds_heap), t(leaf_probs), DEPTH
    )
    plain = trees._ensemble_forward(
        t(X), t(features_heap), t(thresholds_heap), t(leaf_probs), DEPTH
    )
    assert torch.equal(ensemble, plain)
    boosted = trees.gbt_forward(
        t(X), -0.37, t(features_heap), t(thresholds_heap), t(leaf_values), 0.1, DEPTH
    )
    plain = trees._gbt_forward(
        t(X), -0.37, t(features_heap), t(thresholds_heap), t(leaf_values), 0.1, DEPTH
    )
    assert torch.equal(boosted, plain)
    counts = kernels.launches()
    assert counts["tree_ensemble_forward"] == 0 and counts["gbt_forward"] == 0
    assert set(counts.values()) == {0}


def test_wrappers_refuse_what_the_kernel_does_not_take(inputs):
    X, (features_heap, thresholds_heap, leaf_probs, leaf_values) = inputs
    good = (t(X), t(features_heap), t(thresholds_heap), t(leaf_probs))
    with pytest.raises(TypeError):  # float64 rows
        trees.ensemble_forward(t(X.astype(np.float64)), *good[1:], DEPTH)
    with pytest.raises(TypeError):  # float features heap
        trees.ensemble_forward(good[0], good[2], good[2], good[3], DEPTH)
    with pytest.raises(ValueError):  # heap does not match the depth
        trees.ensemble_forward(*good, DEPTH + 1)
    with pytest.raises(ValueError):  # leaf values where probabilities belong
        trees.ensemble_forward(*good[:3], t(leaf_values), DEPTH)
    with pytest.raises(ValueError):
        trees.gbt_forward(good[0], 0.0, *good[1:3], t(leaf_probs), 0.1, DEPTH)
    with pytest.raises(ValueError):
        kernels.check_operands(good[0])  # a CPU tensor is no kernel operand
