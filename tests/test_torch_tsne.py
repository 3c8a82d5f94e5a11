"""The port's t-SNE and PCA held against the JAX reference on the CPU.

The port (learningorchestra_tpu_torch/ops/tsne.py, pca.py) and the JAX
package (learningorchestra_tpu/ops/...) get the same seeded numpy inputs:
four blobs of 300 rows x 6 float32 features. The reference runs as its
own tests run it, on the 8-device virtual CPU mesh, its rows padded by
``_pad_for_mesh`` and its output cut to the first ``n`` rows and columns
(padded rows carry no affinity and no repulsion weight). The port runs
at ``n`` rows.

Float32 semantics: the test suite turns JAX's x64 mode on, and then the
reference's bisection state, and with it its P and its gradient's W,
come out float64 (they were float32 on the TPU, and are in the port).
The t-SNE checks therefore run the reference's calls with x64 off
(``jax.enable_x64(False)``), where it computes in float32 as the port
does; the affinity checks run both ways, to show the same tolerance
covers the x64 reference too.

Tolerances, and why:
- The calibration on identical distances: 1e-5 of each row's largest p
  (measured 9e-7: the exp, log and the row sums round in another order).
- P from the rows: 1e-4 of each row's largest p (measured 2.7e-5). The
  reference's formula |a|^2 + |b|^2 - 2 a.b cancels: at squared norms of
  ~580 the two packages' float32 distances differ by up to 2.4e-4, and p
  = exp(-beta d) moves by beta times that.
- The gradient, recovered from the reference's first step: 1e-5 of its
  largest entry. The optimizer after 1 iteration 1e-5 and after 10
  iterations 1e-4 of the largest coordinate (measured 1e-7 and 4e-6;
  t-SNE is chaotic, and 50 iterations already part the two).
- ``tsne_embedding``, exact, 10 iterations from the rows: 1e-3 of the
  largest coordinate (measured 2.9e-4: P's differences, above, grow over
  the iterations); landmark, 10 iterations: 1e-4 (the interpolation
  averages over the landmarks).
- The interpolation: 1e-4 of the largest coordinate (the distances as
  above).
- PCA: each component within 1e-4 of the largest coordinate, up to its
  sign (float32 covariance; LAPACK picks each eigenvector's sign); the
  components themselves within 1e-4, the explained variances 1e-5
  relative.

The CUDA kernels (kernels/csrc/tsne.cu) are held against these plain
versions on the card by chip_smoke.py (phases embed-kernels and embed).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from learningorchestra_tpu.ops import pca as jax_pca  # noqa: E402
from learningorchestra_tpu.ops import tsne as jax_tsne  # noqa: E402
from learningorchestra_tpu.parallel.mesh import data_size, default_mesh  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ops import pca, tsne  # noqa: E402

ROWS, FEATURES = 300, 6
PERPLEXITY = 30.0
LEARNING_RATE = 200.0


def blobs(rows=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 4, size=(rows, 1)) * 3.0
    return (rng.normal(size=(rows, FEATURES)) + centres).astype(np.float32)


def row_error(got, want):
    """The largest difference, relative to the largest p of its row."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / want.max(axis=1, keepdims=True)).max())


def coordinate_error(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def mesh():
    return default_mesh()


def reference_affinities(mesh, X, perplexity=PERPLEXITY):
    X_pad, valid, chunk = jax_tsne._pad_for_mesh(X, mesh, jax_tsne.CHUNK)
    P = jax_tsne._affinities(
        mesh, jnp.asarray(X_pad), jnp.asarray(valid), jnp.float32(perplexity), chunk
    )
    return np.asarray(P)[: len(X), : len(X)], X_pad, valid


def reference_y0(rows, seed=0):
    """The reference's start: threefry normals over its padded rows."""
    return np.asarray(jax.random.normal(jax.random.key(seed), (rows, 2), jnp.float32) * 1e-4)


@pytest.mark.parametrize("x64", [False, True])
def test_calibration_matches_reference_on_the_same_distances(x64):
    X = blobs()
    distances = tsne._squared_distances(torch.from_numpy(X), torch.from_numpy(X)).numpy()
    excluded = np.eye(ROWS, dtype=bool)
    with jax.enable_x64(x64):
        want = np.asarray(
            jax_tsne._calibrate_row_block(
                jnp.asarray(distances), jnp.asarray(excluded), jnp.float32(PERPLEXITY)
            )
        )
    got = tsne._calibrate_row_block(
        torch.from_numpy(distances), torch.from_numpy(excluded),
        tsne._target_entropy(PERPLEXITY),
    )
    assert got.dtype == torch.float32
    assert row_error(got.numpy(), want) <= 1e-5
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-5)
    assert (np.diag(got.numpy()) == 0).all()


@pytest.mark.parametrize("x64", [False, True])
def test_affinities_match_reference(mesh, x64):
    X = blobs()
    with jax.enable_x64(x64):
        want, _, _ = reference_affinities(mesh, X)
    got = tsne.affinities(torch.from_numpy(X), PERPLEXITY)  # the CPU path: plain
    assert got.shape == (ROWS, ROWS) and got.dtype == torch.float32
    assert row_error(got.numpy(), want) <= 1e-4
    assert torch.equal(got, got.T)
    assert float(got.min()) == float(np.float32(1e-12))
    assert torch.equal(got, tsne._affinities(torch.from_numpy(X), PERPLEXITY))


def test_conditional_affinities_are_chunk_independent():
    X = torch.from_numpy(blobs())
    whole = tsne._conditional_affinities(X, PERPLEXITY, chunk=ROWS)
    for chunk in (7, 64):
        assert torch.equal(tsne._conditional_affinities(X, PERPLEXITY, chunk=chunk), whole)


def test_duplicate_rows_keep_max_affinity(mesh):
    """Self is excluded by index, not by distance: a duplicate row is its
    twin's highest-affinity neighbour (as tests/test_embeddings.py holds
    the reference)."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(20, 3)).astype(np.float32)
    X = np.vstack([base, base[:1]])
    P = tsne._affinities(torch.from_numpy(X), 5.0).numpy()
    assert P[0].argmax() == 20 and P[20].argmax() == 0
    assert P[0, 20] > 10 * np.median(P[0])
    with jax.enable_x64(False):
        want, _, _ = reference_affinities(mesh, X, 5.0)
    assert row_error(P, want) <= 1e-4


@pytest.mark.parametrize("early", [True, False], ids=["exaggerated", "late"])
def test_gradient_matches_reference_first_step(mesh, early):
    """The reference's first step from zero velocity and unit gains is
    ``Y1 = Y0 - lr * 1.2 * grad`` (every sign differs from sign(0)), so
    one iteration of its ``_optimize`` gives its gradient."""
    X = blobs()
    with jax.enable_x64(False):
        P, X_pad, valid = reference_affinities(mesh, X)
        P_pad = np.pad(P, ((0, len(X_pad) - ROWS),) * 2, constant_values=1e-12)
        Y0 = reference_y0(len(X_pad))
        Y1 = np.asarray(jax_tsne._optimize(
            mesh, jnp.asarray(P_pad), jnp.asarray(Y0), jnp.asarray(valid), 1,
            1 if early else 0, jnp.float32(LEARNING_RATE), jnp.float32(12.0),
        ))[:ROWS]
    want = (Y0[:ROWS].astype(np.float64) - Y1) / (LEARNING_RATE * 1.2)
    Y = torch.from_numpy(Y0[:ROWS].copy())
    P_t = torch.from_numpy(np.ascontiguousarray(P))
    got = tsne.gradient(Y, P_t, 12.0 if early else 1.0)
    assert got.shape == (ROWS, 2) and got.dtype == torch.float32
    assert coordinate_error(got.numpy(), want) <= 1e-5
    # the two passes are the plain gradient, Z a (1,) tensor between them
    Z = tsne.tsne_z(Y)
    assert Z.shape == (1,)
    assert torch.equal(tsne.tsne_grad(Y, P_t, Z, 12.0 if early else 1.0), got)


@pytest.mark.parametrize("iterations", [1, 10])
def test_optimize_matches_reference(mesh, iterations):
    X = blobs()
    early_phase = min(jax_tsne.EARLY_PHASE, iterations // 2)
    with jax.enable_x64(False):
        X_pad, valid, chunk = jax_tsne._pad_for_mesh(X, mesh, jax_tsne.CHUNK)
        P = jax_tsne._affinities(
            mesh, jnp.asarray(X_pad), jnp.asarray(valid), jnp.float32(PERPLEXITY), chunk
        )
        Y0 = reference_y0(len(X_pad))
        want = np.asarray(jax_tsne._optimize(
            mesh, P, jnp.asarray(Y0), jnp.asarray(valid), iterations, early_phase,
            jnp.float32(LEARNING_RATE), jnp.float32(jax_tsne.EARLY_EXAGGERATION),
        ))[:ROWS]
    got = tsne._optimize(
        torch.from_numpy(np.ascontiguousarray(np.asarray(P)[:ROWS, :ROWS])),
        torch.from_numpy(Y0[:ROWS].copy()),
        iterations, early_phase, LEARNING_RATE, tsne.EARLY_EXAGGERATION,
    )
    tolerance = 1e-5 if iterations == 1 else 1e-4
    assert coordinate_error(got.numpy(), want) <= tolerance


def test_interpolate_matches_reference(mesh):
    X = blobs(600, seed=1)
    rng = np.random.default_rng(2)
    chosen = rng.choice(len(X), size=100, replace=False)
    L = X[chosen]
    Y_L = (rng.normal(size=(100, 2)) * 5).astype(np.float32)
    perplexity = 20.0
    shards = data_size(mesh)
    chunk = min(jax_tsne.INTERP_CHUNK, -(-len(X) // shards))
    padded = -(-len(X) // (shards * chunk)) * shards * chunk
    X_pad = np.pad(X, ((0, padded - len(X)), (0, 0)))
    with jax.enable_x64(False):
        want = np.asarray(jax_tsne._interpolate(
            mesh, jnp.asarray(X_pad), jnp.asarray(L), jnp.asarray(Y_L),
            jnp.float32(perplexity), chunk,
        ))[: len(X)]
    got = tsne.interpolate(
        torch.from_numpy(X), torch.from_numpy(L), torch.from_numpy(Y_L), perplexity
    )
    assert got.shape == (len(X), 2)
    assert coordinate_error(got.numpy(), want) <= 1e-4
    # chunking changes no bit
    assert torch.equal(
        tsne._interpolate(torch.from_numpy(X), torch.from_numpy(L), torch.from_numpy(Y_L),
                          perplexity, chunk=37),
        got,
    )


def _inject_reference_y0(monkeypatch, padded_rows):
    """``tsne_embedding`` draws Y0 through ``_initial_embedding``: give it
    the reference's threefry start (the first rows of its padded draw)."""
    calls = []

    def initial_embedding(rows, seed, device):
        calls.append((rows, seed))
        return torch.from_numpy(reference_y0(padded_rows(rows), seed)[:rows].copy()).to(device)

    monkeypatch.setattr(tsne, "_initial_embedding", initial_embedding)
    return calls


def test_tsne_embedding_exact_matches_reference(mesh, monkeypatch):
    X = blobs()
    calls = _inject_reference_y0(
        monkeypatch, lambda rows: len(jax_tsne._pad_for_mesh(X[:rows], mesh, 1)[0])
    )
    with jax.enable_x64(False):
        want = jax_tsne.tsne_embedding(X, iterations=10, seed=3, mesh=mesh)
    got = tsne.tsne_embedding(X, iterations=10, seed=3, device="cpu")
    assert calls == [(ROWS, 3)]
    assert isinstance(got, np.ndarray) and got.shape == (ROWS, 2) and got.dtype == np.float32
    assert coordinate_error(got, want) <= 1e-3


def test_tsne_embedding_landmark_matches_reference(mesh, monkeypatch):
    X = blobs(600, seed=4)
    landmarks = 100
    calls = _inject_reference_y0(
        monkeypatch, lambda rows: len(jax_tsne._pad_for_mesh(X[:rows], mesh, 1)[0])
    )
    with jax.enable_x64(False):
        want = jax_tsne.tsne_embedding(
            X, iterations=10, seed=5, mesh=mesh, method="auto",
            exact_rows_limit=500, landmarks=landmarks,
        )
    got = tsne.tsne_embedding(
        X, iterations=10, seed=5, method="auto", exact_rows_limit=500,
        landmarks=landmarks, device="cpu",
    )
    assert calls == [(landmarks, 5)]
    assert got.shape == (600, 2)
    assert coordinate_error(got, want) <= 1e-4
    # the same landmarks: numpy's default_rng(seed).choice, as the reference
    chosen = np.random.default_rng(5).choice(600, size=landmarks, replace=False)
    Y0 = torch.from_numpy(reference_y0(landmarks, 5).copy())
    Y_L = tsne._tsne_exact(torch.from_numpy(X[chosen]), PERPLEXITY, 10, LEARNING_RATE, Y0)
    interp_perplexity = tsne._clamped_perplexity(PERPLEXITY, landmarks)
    again = tsne._tsne_landmark(
        torch.from_numpy(X), PERPLEXITY, 10, LEARNING_RATE, 5, landmarks, Y0
    )
    assert torch.equal(
        again, tsne.interpolate(torch.from_numpy(X), torch.from_numpy(X[chosen]), Y_L,
                                interp_perplexity)
    )


@pytest.mark.parametrize("rows_per_program", [128, 256])
def test_landmark_interpolation_in_macro_blocks_matches_one_block(
    mesh, monkeypatch, rows_per_program
):
    """Past ``_INTERP_ROWS_PER_PROGRAM`` rows the interpolation runs a
    macro block a launch, as the reference's does a program: several
    blocks (600 rows in 128 or 256) give what one block gives, within
    1e-6 of the largest coordinate, and the reference's embedding in the
    same blocks within 1e-4 (as above)."""
    X = blobs(600, seed=4)
    landmarks = 100
    _inject_reference_y0(
        monkeypatch, lambda rows: len(jax_tsne._pad_for_mesh(X[:rows], mesh, 1)[0])
    )

    def embed():
        return tsne.tsne_embedding(
            X, iterations=10, seed=5, method="landmark", landmarks=landmarks, device="cpu"
        )

    whole = embed()
    blocks = []
    real_interpolate = tsne.interpolate

    def interpolate(X_block, *args):
        blocks.append(len(X_block))
        return real_interpolate(X_block, *args)

    monkeypatch.setattr(tsne, "interpolate", interpolate)
    monkeypatch.setattr(tsne, "_INTERP_ROWS_PER_PROGRAM", rows_per_program)
    monkeypatch.setattr(jax_tsne, "_INTERP_ROWS_PER_PROGRAM", rows_per_program)
    got = embed()
    assert blocks == [rows_per_program] * (600 // rows_per_program) + [600 % rows_per_program]
    assert got.shape == (600, 2)
    assert coordinate_error(got, whole) <= 1e-6
    with jax.enable_x64(False):
        want = jax_tsne.tsne_embedding(
            X, iterations=10, seed=5, mesh=mesh, method="landmark", landmarks=landmarks
        )
    assert coordinate_error(got, want) <= 1e-4


def test_landmark_with_every_row_a_landmark_undoes_the_permutation():
    X = torch.from_numpy(blobs(40, seed=6))
    Y0 = tsne._initial_embedding(40, 7, "cpu")
    got = tsne._tsne_landmark(X, 10.0, 20, LEARNING_RATE, 7, 100, Y0)
    chosen = torch.from_numpy(np.random.default_rng(7).choice(40, size=40, replace=False))
    exact = tsne._tsne_exact(X[chosen], 10.0, 20, LEARNING_RATE, Y0)
    assert torch.equal(got[chosen], exact)


def test_small_inputs_clamp_the_perplexity():
    X = np.random.default_rng(8).normal(size=(8, 3))
    embedded = tsne.tsne_embedding(X, iterations=50, device="cpu")
    assert embedded.shape == (8, 2) and np.isfinite(embedded).all()
    assert tsne._clamped_perplexity(30.0, 8) == 7 / 3
    assert tsne._clamped_perplexity(30.0, 2) == 1.0
    assert tsne._clamped_perplexity(30.0, 5000) == 30.0


def test_initial_embedding_is_seeded():
    a = tsne._initial_embedding(1000, 3, "cpu")
    assert a.shape == (1000, 2) and a.dtype == torch.float32
    assert torch.equal(a, tsne._initial_embedding(1000, 3, "cpu"))
    assert not torch.equal(a, tsne._initial_embedding(1000, 4, "cpu"))
    assert 0.8e-4 < float(a.std()) < 1.2e-4


def test_refit_is_bit_identical():
    X = blobs(120, seed=9)
    first = tsne.tsne_embedding(X, iterations=30, seed=1, device="cpu")
    assert np.array_equal(first, tsne.tsne_embedding(X, iterations=30, seed=1, device="cpu"))


def test_wrappers_take_the_plain_path_on_cpu_and_refuse_bad_operands():
    X = torch.from_numpy(blobs(50))
    Y = tsne._initial_embedding(50, 0, "cpu")
    kernels.reset_launches()
    P = tsne.affinities(X, 10.0)
    tsne.gradient(Y, P, 12.0)
    tsne.interpolate(X, X[:10], Y[:10], 3.0)
    assert set(kernels.launches().values()) == {0}
    for name in ("tsne_affinities", "tsne_z", "tsne_grad", "tsne_interpolate"):
        assert kernels.KERNEL_LIBRARIES[name] == "tsne"
    assert "tsne" in kernels.SOURCES
    with pytest.raises(TypeError):
        tsne.affinities(X.double(), 10.0)
    with pytest.raises(ValueError):
        tsne.tsne_grad(Y, P[:10], tsne.tsne_z(Y), 1.0)
    with pytest.raises(ValueError):
        tsne.gradient(torch.zeros((50, 3)), P, 1.0)
    with pytest.raises(ValueError):
        tsne.interpolate(X, X[:10, :3], Y[:10], 3.0)
    # a tensor on another device than the CPU goes to the kernel or raises:
    # it never takes the plain path
    for call in (
        lambda: tsne.conditional_affinities(torch.empty((50, 6), device="meta"), 10.0),
        lambda: tsne.tsne_z(torch.empty((50, 2), device="meta")),
        lambda: tsne.interpolate(
            torch.empty((50, 6), device="meta"), torch.empty((10, 6), device="meta"),
            torch.empty((10, 2), device="meta"), 3.0,
        ),
    ):
        with pytest.raises(ValueError, match="not a CUDA device"):
            call()
    assert set(kernels.launches().values()) == {0}


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown t-SNE method"):
        tsne.tsne_embedding(blobs(20), method="barnes_hut", device="cpu")


def test_embeddings_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsne.tsne_embedding(blobs(20))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pca.pca_embedding(blobs(20))


def test_pca_matches_reference_up_to_sign(mesh):
    X = blobs(500, seed=10)
    want = np.asarray(jax_pca.pca_embedding(X.astype(np.float64), n_components=3, mesh=mesh))
    got = pca.pca_embedding(X, n_components=3, device="cpu")
    assert got.shape == (500, 3) and got.dtype == np.float32
    scale = np.abs(want).max()
    for component in range(3):
        sign = np.sign(np.dot(got[:, component], want[:, component]))
        assert np.abs(sign * got[:, component] - want[:, component]).max() <= 1e-4 * scale


def test_pca_plain_matches_reference_with_a_mask():
    """``_pca`` itself, with padded rows masked out, against the
    reference's ``_pca`` on the same padded rows."""
    X = np.vstack([blobs(200, seed=11), np.zeros((24, FEATURES), np.float32)])
    mask = np.arange(len(X)) < 200
    with jax.enable_x64(False):
        want = [np.asarray(a) for a in jax_pca._pca(jnp.asarray(X), jnp.asarray(mask), 2)]
    got = [a.numpy() for a in pca._pca(torch.from_numpy(X), torch.from_numpy(mask), 2)]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    signs = np.sign((got[1] * want[1]).sum(axis=0))
    np.testing.assert_allclose(got[1] * signs, want[1], atol=1e-4)
    np.testing.assert_allclose(got[0] * signs, want[0], atol=1e-4 * np.abs(want[0]).max())
    assert (got[0][200:] == 0).all()
