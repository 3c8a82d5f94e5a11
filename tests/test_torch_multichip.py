"""The port's fits over ranks: R gloo processes on the CPU, held against the
port's one-process fits and the JAX package's 8-device mesh.

A gloo analogue of tests/test_multichip.py:40-152. The file launches
itself as the worker (``python tests/test_torch_multichip.py <rank>
<world> <addr> <out> [<model>]``): each rank joins a ``torch.distributed``
gloo group of R in {2, 4} processes (a group timeout of 60 s), builds the
mesh (every rank on the data axis, ``device="cpu"``; in the third run a
2 × 2 grid, ``make_mesh(data=2, model=2)``) and, on the
reference test's data (640 x 6 XOR rows, 200 x 5 PCA rows, 120 blob rows,
each from ``default_rng(0)``), fits dt, rf (on injected draws: the
reference's own, rebuilt with ``jax.random`` in the test process as
tests/test_torch_forest.py rebuilds them; and from its seed), gb (5
rounds) and nb; runs PCA, the symmetrised affinities and
t-SNE (250 iterations, seed 3) over the ranks; and builds all five
classifiers through ``train_one`` over the ranks on the rows' absolute
values (nb takes no negative feature), rank 0 alone writing.

What is held:
- every rank of a run holds the same bits;
- against the port's one-process fits: dt heaps identical, rf heaps
  identical on injected draws, gb heaps identical with leaf values within
  1e-6 relative, nb probabilities within 1e-6, every model's accuracy and
  weighted F1 within 1e-6;
- against the JAX package on ``make_mesh(data=8)``: nb probabilities
  within atol 1e-5, dt heaps identical, rf (on the reference's draws) and
  gb accuracy within 0.02,
  PCA within atol 1e-3 (each component's sign matched), the symmetrised P
  within atol 1e-7 of ``_affinities`` on 8 devices, t-SNE's kNN label
  agreement above 0.9;
- R = 2 grows the heaps R = 4 grows;
- gb's resume over ranks: a fit in segments with a progress sink (rank 0
  writes every rank's margins), then a fit from its artifact, which runs
  no round and gives the same model; the artifact's layout key names the
  data axis size;
- ``train_one`` over the ranks: only rank 0 writes, and its metadata
  metrics equal the one-process build's.

lr on seeded blobs (640 x 6) with C = 2, 4 and 3 classes, in every run:
- the 2 × 2 grid shards C = 2 and C = 4 over the model axis (one and two
  classes a rank): every rank's bits equal, the losses within 1e-5
  relative of the 2 × 1 run's (float64 sums over the shards against one
  rank's whole classes, the same iterations), accuracy within 0.02 of the
  JAX package's fit on ``make_mesh(data=2, model=2)`` (the reference's own
  bound, tests/test_multichip.py:57-64); C = 3 raises the reference's
  warning word for word and replicates, and is then the 2 × 1 fit bit for
  bit;
- rf's 10 trees on the reference's draws over 2 × 2: each rank grew 5,
  and the gathered heaps are the one-process fit's bit for bit; nb, dt,
  gb, PCA, the affinities and t-SNE on 2 × 2 are the 2 × 1 run's bits;
- ``fit_sharded`` under ``LO_DTYPE_POLICY=bf16`` (K8′ on bfloat16 rows,
  K7 on the standardized bfloat16 rows) over 2 × 1 against the JAX
  package's on ``make_mesh(data=2)``: mean and scale within one bfloat16
  ulp, probabilities within 1e-4 and labels equal but at near ties (the
  tolerances of tests/test_torch_bf16.py); over 2 × 2 its losses within
  1e-5 relative of the 2 × 1 run's;
- ``train_one`` over 2 × 2 writes on rank 0 only, and lr's ``.model``
  file has the one-process layout (every rank entered the gathers).

The twins of the four new kernel forms are held beside them, in the test
process: each rank's block (or slab) added in rank order against the
whole, with no launch on the CPU.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np

_TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_TESTS_DIR)
WORLDS = (2, 4)
GRID = "2x2"                  # the third run: four ranks as data 2 x model 2
GROUP_TIMEOUT_S = 60
RF_TREES = 10
GB_ROUNDS = 5
TSNE_ITERATIONS = 250
TSNE_SEED = 3
PERPLEXITY = 10.0
MODEL_NAMES = ("lr", "dt", "rf", "gb", "nb")
DRAWS_FILE = "reference_draws.npz"
LR_CLASSES = (2, 4, 3)
LR_LOSS_RTOL = 1e-5
BF16_PROB_TOL = 1e-4
NEAR_TIE = 2e-4
SHARD_WARNING = ("LogisticRegression: 3 classes do not divide the model axis (2 devices); W/b "
                 "replicate and the model axis adds no parallelism for this fit")


def lr_data(classes: int):
    rng = np.random.default_rng(classes)
    centers = rng.normal(size=(classes, 6)) * 0.8
    labels = rng.integers(0, classes, size=640)
    return centers[labels] + rng.normal(size=(640, 6)), labels


def xor_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(640, 6))
    return X, ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(int)


def pca_data():
    return np.random.default_rng(0).normal(size=(200, 5))


def blob_data():
    rng = np.random.default_rng(0)
    centers = np.array([[10, 0], [0, 10], [5, -8]])
    labels = rng.integers(0, 3, size=120)
    return (centers[labels] + rng.normal(size=(120, 2))).astype(np.float32), labels


def load_draws(torch, trees, path: str):
    with np.load(path) as saved:
        return trees.ForestDraws(torch.from_numpy(saved["bootstrap"]), torch.from_numpy(saved["scores"]))


def _hex(array) -> str:
    return np.ascontiguousarray(array).tobytes().hex()


def model_record(model, X, y) -> dict:
    """A fitted model's parameters (as bits), probabilities and metrics."""
    labels, probs = model.predict_both(X)
    accuracy, weighted_f1 = model.evaluate(X, y)
    both = model.evaluate_predict(X, y, X)
    record = {
        "probs": probs.tolist(), "probs_bits": _hex(probs), "accuracy": accuracy,
        "weighted_f1": weighted_f1,
        "evaluate_predict_ok": bool(
            both[:2] == (accuracy, weighted_f1) and np.array_equal(both[2], labels)
            and both[3].tobytes() == probs.tobytes()
        ),
    }
    for name in ("features_heap", "thresholds_heap", "leaf_probs", "leaf_values", "theta", "prior"):
        if hasattr(model, name):
            value = getattr(model, name).numpy()
            record[name] = value.tolist()
            record[name + "_bits"] = _hex(value)
    if hasattr(model, "f0"):
        record["f0"] = model.f0
    return record


def gb_resume(torch, dist, X, y, folder: str) -> dict:
    """A gb fit in 5 segments of one round with a progress sink that saves
    at segment 3 (rank 0 writes every rank's margins), then the same fit
    from that artifact: rounds 4 and 5 from the restored margins, each
    rank's block of them. ``{"identical": both models' bits equal,
    "skipped": the segments each fit restored}``."""
    from learningorchestra_tpu_torch.ml import progress, trees

    sink = progress.ProgressSink(os.path.join(folder, "gb.progress"), {"layout": "multichip"}, every=3)
    skipped, count = [], progress.segments_skipped
    budget = trees._GB_ROW_ROUNDS_BUDGET
    progress.segments_skipped = lambda done: (skipped.append(done), count(done))
    trees._GB_ROW_ROUNDS_BUDGET = 1.0   # one round a segment
    try:
        with progress.bind_sink(sink):
            first = trees.GBTClassifier(rounds=GB_ROUNDS, device="cpu").fit(X, y)
            restored_first = list(skipped)
            dist.barrier()   # rank 0's save has landed
            again = trees.GBTClassifier(rounds=GB_ROUNDS, device="cpu").fit(X, y)
    finally:
        trees._GB_ROW_ROUNDS_BUDGET = budget
        progress.segments_skipped = count
    fields = ("features_heap", "thresholds_heap", "leaf_values")
    return {
        "identical": all(torch.equal(getattr(first, f), getattr(again, f)) for f in fields)
        and first.f0 == again.f0,
        "skipped": [restored_first, skipped[len(restored_first):]],
    }


def lr_fits(torch, mesh) -> dict:
    """lr on each of LR_CLASSES' blobs over ``mesh``: losses, accuracy,
    parameters (as bits), probabilities and the warnings raised."""
    import warnings

    from learningorchestra_tpu_torch.ml.logistic import LogisticRegression

    out = {}
    for classes in LR_CLASSES:
        X, y = lr_data(classes)
        estimator = LogisticRegression(device="cpu", mesh=mesh)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model = estimator.fit(X, y)
        labels, probs = model.predict_both(X)
        out[str(classes)] = {
            "losses": estimator.loss_history_.tolist(), "accuracy": float((labels == y).mean()),
            "w_shape": list(model.w.shape), "w_bits": _hex(model.w.numpy()), "b_bits": _hex(model.b.numpy()),
            "probs_bits": _hex(probs),
            "warnings": [str(w.message) for w in caught if issubclass(w.category, UserWarning)],
        }
    return out


def lr_bf16_fit_sharded(torch, mesh) -> dict:
    """``fit_sharded`` on the C = 2 blobs under ``LO_DTYPE_POLICY=bf16``:
    each rank's block of the rows in bfloat16 (``shard_rows``), K8′ on
    them, then the fit; the policy is set for this fit alone."""
    from learningorchestra_tpu_torch.ml.logistic import LogisticRegression
    from learningorchestra_tpu_torch.parallel import shard_rows
    from learningorchestra_tpu_torch.utils import dtypepolicy

    os.environ["LO_DTYPE_POLICY"] = "bf16"
    dtypepolicy._POLICY.clear()
    try:
        X, y = lr_data(2)
        X_block, mask = shard_rows(X, mesh, dtype=np.float32)
        y_block, _ = shard_rows(y, mesh, dtype=np.int32)
        assert X_block.dtype == torch.bfloat16
        estimator = LogisticRegression(device="cpu", mesh=mesh)
        model = estimator.fit_sharded(X_block, y_block, mask, 2)
        labels, probs = model.predict_both(X)
    finally:
        os.environ.pop("LO_DTYPE_POLICY")
        dtypepolicy._POLICY.clear()
    return {"losses": estimator.loss_history_.tolist(), "mean": model.mean.tolist(),
            "scale": model.scale.tolist(), "probs": probs.tolist(), "labels": labels.tolist(),
            "probs_bits": _hex(probs)}


def worker(rank: int, world: int, address: str, out_path: str, model_axis: int = 1) -> None:
    os.environ["LO_COORDINATOR"] = address
    os.environ["LO_NUM_PROCESSES"] = str(world)
    os.environ["LO_PROCESS_ID"] = str(rank)
    import torch
    import torch.distributed as dist

    from learningorchestra_tpu_torch.core.store import InMemoryStore
    from learningorchestra_tpu_torch.frame.dataframe import DataFrame
    from learningorchestra_tpu_torch.ml import builder, checkpoint, trees
    from learningorchestra_tpu_torch.ml.naive_bayes import NaiveBayes
    from learningorchestra_tpu_torch.ops import pca, tsne
    from learningorchestra_tpu_torch.parallel import gather_rows, initialize_from_env, make_mesh

    assert initialize_from_env(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    mesh = make_mesh(data=world // model_axis, model=model_axis, device="cpu")
    X, y = xor_data()
    grown = []   # the trees each call of the forest fit grew on this rank
    forest_fit = trees._rf_fit

    def counted_forest_fit(*args, **kwargs):
        grown.append(args[7])
        return forest_fit(*args, **kwargs)

    trees._rf_fit = counted_forest_fit
    try:
        rf_draws = trees.RandomForestClassifier(num_trees=RF_TREES, device="cpu", mesh=mesh)._fit_with_draws(
            X, y, load_draws(torch, trees, os.path.join(os.path.dirname(out_path), DRAWS_FILE)))
    finally:
        trees._rf_fit = forest_fit
    models = {
        "dt": trees.DecisionTreeClassifier(device="cpu", mesh=mesh).fit(X, y),
        "rf_draws": rf_draws,
        "rf": trees.RandomForestClassifier(num_trees=RF_TREES, device="cpu", mesh=mesh).fit(X, y),
        "gb": trees.GBTClassifier(rounds=GB_ROUNDS, device="cpu", mesh=mesh).fit(X, y),
        "nb": NaiveBayes(device="cpu", mesh=mesh).fit(np.abs(X), y),
    }
    record = {
        "rank": rank, "world": world, "data": mesh.shape["data"], "model": mesh.shape["model"],
        "coordinates": [mesh.data_index, mesh.model_index], "rf_trees_grown": grown,
        "models": {
            name: model_record(model, np.abs(X) if name == "nb" else X, y)
            for name, model in models.items()
        },
        "meshes": {name: model.mesh.shape["data"] for name, model in models.items()},
    }
    record["pca"] = pca.pca_embedding(pca_data(), mesh=mesh).tolist()
    blobs, _ = blob_data()
    blobs_t = torch.from_numpy(blobs)
    P_rows, first = tsne._affinities_over_ranks(blobs_t, PERPLEXITY, mesh)
    record["affinities"] = gather_rows(P_rows, blobs.shape[0], mesh).numpy().tolist()
    record["tsne"] = tsne.tsne_embedding(
        blobs, iterations=TSNE_ITERATIONS, seed=TSNE_SEED, mesh=mesh).tolist()

    if model_axis == 1:
        record["gb_resume"] = gb_resume(torch, dist, X, y, os.path.dirname(out_path))
    record["lr"] = lr_fits(torch, mesh)
    if world == 2 or model_axis > 1:
        record["lr_bf16"] = lr_bf16_fit_sharded(torch, mesh)

    store = InMemoryStore()
    frame = DataFrame({"features": np.abs(X), "label": y.astype(np.float64)})   # nb takes no negatives
    models_dir = os.path.join(os.path.dirname(out_path), "models")
    metadata, checkpoints = {}, {}
    for name in MODEL_NAMES:
        out = builder.train_one(store, name, frame, frame, frame, "multichip", device="cpu",
                                models_dir=models_dir, mesh=mesh, write_outputs=rank == 0)
        metadata[name] = {"F1": out["F1"], "accuracy": out["accuracy"],
                          "written": store.find_one(out["filename"], {builder.ROW_ID: 0}) is not None}
        if rank == 0:
            kind, arrays, _ = checkpoint.read_checkpoint(out["model_checkpoint"])
            checkpoints[name] = {
                "kind": kind, "arrays": {key: [list(value.shape), str(value.dtype)]
                                         for key, value in arrays.items()},
                **({"w": arrays["w"].tolist()} if name == "lr" else {}),
            }
    record["train_one"] = metadata
    record["checkpoints"] = checkpoints
    record["model_files"] = sorted(os.listdir(models_dir)) if os.path.isdir(models_dir) else []
    digest = hashlib.sha256(json.dumps(
        {key: record[key] for key in ("models", "pca", "affinities", "tsne", "lr")}, sort_keys=True,
    ).encode()).hexdigest()
    record["digest"] = digest
    with open(out_path, "w") as handle:
        json.dump(record, handle)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path[:0] = [_REPO_ROOT, _TESTS_DIR]
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           int(sys.argv[5]) if len(sys.argv) > 5 else 1)
    sys.exit(0)


import pytest  # noqa: E402

torch = pytest.importorskip("torch")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reference_draws():
    """The reference's forest draws of ``RandomForestClassifier(num_trees=10,
    seed=0)`` on the 8-device mesh (its 640 rows need no padding there),
    rebuilt with ``jax.random`` (tests/test_torch_forest.py:79)."""
    import jax

    from learningorchestra_tpu.ml.trees import MAX_DEPTH
    from learningorchestra_tpu.parallel.sharding import padded_row_count

    X, _ = xor_data()
    rows, features = X.shape
    assert padded_row_count(rows, 8) == rows
    bootstrap, scores = [], []
    for tree_key in jax.random.split(jax.random.key(0), RF_TREES):
        bootstrap_key, subset_key = jax.random.split(tree_key)
        bootstrap.append(np.asarray(jax.random.poisson(bootstrap_key, 1.0, (rows,))))
        scores.append(np.concatenate([
            np.asarray(jax.random.uniform(jax.random.fold_in(subset_key, level), (2**level, features)))
            for level in range(MAX_DEPTH)
        ]))
    scores = np.stack(scores).reshape(RF_TREES, 2**MAX_DEPTH - 1, features).astype(np.float32)
    assert (np.diff(np.sort(scores, axis=-1), axis=-1) > 0).all()
    return {"bootstrap": np.stack(bootstrap).astype(np.float32), "scores": scores}


@pytest.fixture(scope="module")
def draws_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_multichip_draws") / DRAWS_FILE
    np.savez(path, **reference_draws())
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, draws_file):
    """``{R: [each rank's record]}`` for R in WORLDS and the 2 × 2 grid
    (``GRID``), the three runs at once."""
    import shutil

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_REPO_ROOT, _TESTS_DIR, env.get("PYTHONPATH", "")])
    env.pop("LO_DTYPE_POLICY", None)
    env["OMP_NUM_THREADS"] = "1"
    procs, outs = {}, {}
    for run, (world, model) in {**{world: (world, 1) for world in WORLDS}, GRID: (4, 2)}.items():
        folder = tmp_path_factory.mktemp(f"torch_multichip_{run}")
        shutil.copy(draws_file, folder / DRAWS_FILE)
        address = f"127.0.0.1:{_free_port()}"
        outs[run] = [str(folder / f"p{rank}.json") for rank in range(world)]
        procs[run] = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank), str(world), address,
                 outs[run][rank], str(model)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=_TESTS_DIR,
            )
            for rank in range(world)
        ]
    logs = {}
    try:
        for run in procs:
            logs[run] = [proc.communicate(timeout=240)[0].decode(errors="replace")
                         for proc in procs[run]]
    finally:
        for proc in (p for group in procs.values() for p in group):
            if proc.poll() is None:
                proc.kill()
    results = {}
    for run in procs:
        for rank, proc in enumerate(procs[run]):
            assert proc.returncode == 0, f"run {run} rank {rank} failed:\n{logs[run][rank]}"
        results[run] = []
        for path in outs[run]:
            with open(path) as handle:
                results[run].append(json.load(handle))
    return results


@pytest.fixture(scope="module")
def solo(draws_file):
    """The port's one-process fits and build on the same data."""
    from learningorchestra_tpu_torch.core.store import InMemoryStore
    from learningorchestra_tpu_torch.frame.dataframe import DataFrame
    from learningorchestra_tpu_torch.ml import builder, trees
    from learningorchestra_tpu_torch.ml.naive_bayes import NaiveBayes

    X, y = xor_data()
    models = {
        "dt": trees.DecisionTreeClassifier(device="cpu").fit(X, y),
        "rf_draws": trees.RandomForestClassifier(num_trees=RF_TREES, device="cpu")._fit_with_draws(
            X, y, load_draws(torch, trees, draws_file)),
        "rf": trees.RandomForestClassifier(num_trees=RF_TREES, device="cpu").fit(X, y),
        "gb": trees.GBTClassifier(rounds=GB_ROUNDS, device="cpu").fit(X, y),
        "nb": NaiveBayes(device="cpu").fit(np.abs(X), y),
    }
    records = {name: model_record(model, np.abs(X) if name == "nb" else X, y)
               for name, model in models.items()}
    store = InMemoryStore()
    frame = DataFrame({"features": np.abs(X), "label": y.astype(np.float64)})   # nb takes no negatives
    metadata = {}
    for name in MODEL_NAMES:
        out = builder.train_one(store, name, frame, frame, frame, "solo", device="cpu")
        metadata[name] = {"F1": out["F1"], "accuracy": out["accuracy"]}
    return {"models": records, "train_one": metadata}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's fits, PCA, affinities and t-SNE on its 8-device mesh,
    and lr on its 2 × 2 mesh."""
    import jax
    import jax.numpy as jnp

    from learningorchestra_tpu.ml.evaluation import accuracy_score
    from learningorchestra_tpu.ml.naive_bayes import NaiveBayes as JaxNaiveBayes
    from learningorchestra_tpu.ml.trees import (
        DecisionTreeClassifier as JaxDecisionTree,
        GBTClassifier as JaxGBT,
        RandomForestClassifier as JaxForest,
    )
    from learningorchestra_tpu.ops.pca import pca_embedding as jax_pca
    from learningorchestra_tpu.ops.tsne import _affinities, _pad_for_mesh
    from learningorchestra_tpu.parallel.mesh import make_mesh

    from learningorchestra_tpu.ml.logistic import LogisticRegression as JaxLogistic

    mesh = make_mesh(data=8, model=1)
    grid = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    lr_accuracy = {}
    for classes in (2, 4):
        X_lr, y_lr = lr_data(classes)
        lr_accuracy[str(classes)] = accuracy_score(y_lr, JaxLogistic(mesh=grid).fit(X_lr, y_lr).predict(X_lr))
    X, y = xor_data()
    dt = JaxDecisionTree(mesh=mesh).fit(X, y)
    blobs, _ = blob_data()
    X_pad, valid, chunk = _pad_for_mesh(blobs, mesh, 1024)
    P = _affinities(mesh, jnp.asarray(X_pad), jnp.asarray(valid), jnp.float32(PERPLEXITY), chunk)
    return {
        "lr_accuracy": lr_accuracy,
        "nb_probs": JaxNaiveBayes(mesh=mesh).fit(np.abs(X), y).predict_proba(np.abs(X)),
        "dt": {name: np.asarray(getattr(dt, name)) for name in (
            "features_heap", "thresholds_heap", "leaf_probs")},
        "rf_draws_accuracy": accuracy_score(
            y, JaxForest(num_trees=RF_TREES, mesh=mesh).fit(X, y).predict(X)),
        "gb_accuracy": accuracy_score(y, JaxGBT(rounds=GB_ROUNDS, mesh=mesh).fit(X, y).predict(X)),
        "pca": np.asarray(jax_pca(pca_data(), mesh=mesh)),
        "affinities": np.asarray(P)[:120, :120],
    }


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_the_same_bits(runs, world):
    assert [r["rank"] for r in runs[world]] == list(range(world))
    for result in runs[world]:
        assert result["data"] == world
        assert set(result["meshes"].values()) == {world}
        assert result["digest"] == runs[world][0]["digest"]
        assert result["train_one"] == {
            name: {**value, "written": result["train_one"][name]["written"]}
            for name, value in runs[world][0]["train_one"].items()
        }


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ("dt", "rf_draws"))
def test_count_fits_grow_the_one_process_heaps(runs, solo, world, name):
    got, want = runs[world][0]["models"][name], solo["models"][name]
    for key in ("features_heap_bits", "thresholds_heap_bits", "leaf_probs_bits", "probs_bits"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("world", WORLDS)
def test_gb_grows_the_one_process_heaps(runs, solo, world):
    got, want = runs[world][0]["models"]["gb"], solo["models"]["gb"]
    assert got["features_heap_bits"] == want["features_heap_bits"]
    assert got["thresholds_heap_bits"] == want["thresholds_heap_bits"]
    assert got["f0"] == want["f0"]
    np.testing.assert_allclose(got["leaf_values"], want["leaf_values"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_nb_probabilities_match_the_one_process_fit(runs, solo, world):
    np.testing.assert_allclose(runs[world][0]["models"]["nb"]["probs"], solo["models"]["nb"]["probs"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ("dt", "rf_draws", "rf", "gb", "nb"))
def test_metrics_over_ranks_match_the_one_process_fit(runs, solo, world, name):
    got, want = runs[world][0]["models"][name], solo["models"][name]
    np.testing.assert_allclose([got["accuracy"], got["weighted_f1"]],
                               [want["accuracy"], want["weighted_f1"]], rtol=0, atol=1e-6)
    assert got["evaluate_predict_ok"]


@pytest.mark.parametrize("world", WORLDS)
def test_nb_matches_the_reference_mesh(runs, reference, world):
    np.testing.assert_allclose(runs[world][0]["models"]["nb"]["probs"], reference["nb_probs"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_dt_heaps_match_the_reference_mesh(runs, reference, world):
    got = runs[world][0]["models"]["dt"]
    np.testing.assert_array_equal(got["features_heap"], reference["dt"]["features_heap"])
    np.testing.assert_array_equal(got["thresholds_heap"], reference["dt"]["thresholds_heap"])
    np.testing.assert_allclose(got["leaf_probs"], reference["dt"]["leaf_probs"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ("rf_draws", "gb"))
def test_rf_and_gb_accuracy_match_the_reference_mesh(runs, reference, world, name):
    assert abs(runs[world][0]["models"][name]["accuracy"] - reference[f"{name}_accuracy"]) < 0.02


@pytest.mark.parametrize("world", WORLDS)
def test_pca_matches_the_reference_mesh(runs, reference, world):
    got, want = np.asarray(runs[world][0]["pca"]), reference["pca"]
    assert got.shape == want.shape == (200, 2)
    for component in range(2):
        sign = np.sign(np.dot(got[:, component], want[:, component]))
        np.testing.assert_allclose(sign * got[:, component], want[:, component], rtol=0, atol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_affinities_match_the_reference_mesh(runs, reference, world):
    np.testing.assert_allclose(runs[world][0]["affinities"], reference["affinities"], rtol=0, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_tsne_over_ranks_keeps_the_clusters(runs, world):
    _, labels = blob_data()
    embedded = np.asarray(runs[world][0]["tsne"])
    assert embedded.shape == (120, 2) and np.all(np.isfinite(embedded))
    d = ((embedded[:, None, :] - embedded[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    assert (labels[d.argmin(axis=1)] == labels).mean() > 0.9


@pytest.mark.parametrize("world", WORLDS)
def test_gb_resumes_over_ranks_from_every_ranks_margins(runs, world):
    for result in runs[world]:
        assert result["gb_resume"] == {"identical": True, "skipped": [[], [3]]}


def test_the_resume_key_names_the_data_axis():
    from types import SimpleNamespace

    from learningorchestra_tpu_torch.ml import builder

    cpu = torch.device("cpu")
    assert builder._mesh_key(cpu) == builder._mesh_key(cpu, SimpleNamespace(shape={"data": 1})) == "cpu"
    assert builder._mesh_key(cpu, SimpleNamespace(shape={"data": 4})) == "cpu data=4"


def test_two_and_four_ranks_grow_the_same_heaps(runs):
    for name in ("dt", "rf_draws", "rf", "gb"):
        for key in ("features_heap_bits", "thresholds_heap_bits"):
            assert runs[2][0]["models"][name][key] == runs[4][0]["models"][name][key], (name, key)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_train_one_over_two_ranks_writes_on_rank_zero(runs, solo, name):
    written = [r["train_one"][name]["written"] for r in runs[2]]
    assert written == [True, False]
    got = runs[2][0]["train_one"][name]
    want = solo["train_one"][name]
    np.testing.assert_allclose([float(got["accuracy"]), float(got["F1"])],
                               [float(want["accuracy"]), float(want["F1"])], rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# The model axis: the 2 x 2 grid against the 2 x 1 run and the reference
# --------------------------------------------------------------------------

def test_the_grid_holds_the_references_layout_and_the_same_bits(runs):
    records = runs[GRID]
    assert [r["coordinates"] for r in records] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert all((r["data"], r["model"]) == (2, 2) for r in records)
    assert len({r["digest"] for r in records}) == 1
    assert all(r["train_one"] == {name: {**value, "written": r["train_one"][name]["written"]}
                                  for name, value in records[0]["train_one"].items()} for r in records)


@pytest.mark.parametrize("classes", ["2", "4"])
def test_lr_classes_over_the_model_axis_match_the_data_axis_and_the_reference(runs, reference, classes):
    got, want = runs[GRID][0]["lr"][classes], runs[2][0]["lr"][classes]
    assert got["warnings"] == [] and got["w_shape"] == [6, int(classes)]
    assert len(got["losses"]) == len(want["losses"])
    losses, wanted = np.asarray(got["losses"]), np.asarray(want["losses"])
    assert np.max(np.abs(losses - wanted) / np.abs(wanted)) <= LR_LOSS_RTOL
    assert abs(got["accuracy"] - want["accuracy"]) <= 0.02
    assert abs(got["accuracy"] - reference["lr_accuracy"][classes]) < 0.02


def test_lr_classes_that_do_not_divide_the_model_axis_warn_and_replicate(runs):
    got, want = runs[GRID][0]["lr"]["3"], runs[2][0]["lr"]["3"]
    assert got["warnings"] == [SHARD_WARNING] and want["warnings"] == []
    for key in ("losses", "w_bits", "b_bits", "probs_bits"):
        assert got[key] == want[key], key


def test_the_reference_warns_with_the_same_words():
    import warnings

    import jax

    from learningorchestra_tpu.ml.logistic import LogisticRegression as JaxLogistic
    from learningorchestra_tpu.parallel.mesh import make_mesh

    X, y = lr_data(3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        JaxLogistic(max_iter=2, mesh=make_mesh(data=2, model=2, devices=jax.devices()[:4])).fit(X, y)
    assert SHARD_WARNING in [str(w.message) for w in caught]


def test_rf_trees_over_the_model_axis_grow_the_one_process_heaps(runs, solo):
    """The counterpart of the reference's test_rf_tree_axis_actually_sharded:
    each rank grew its 5 of the 10 trees, and the gathered heaps are the
    one-process fit's."""
    assert [r["rf_trees_grown"] for r in runs[GRID]] == [[RF_TREES // 2]] * 4
    assert all(r["rf_trees_grown"] == [RF_TREES] for r in runs[2])
    got, want = runs[GRID][0]["models"]["rf_draws"], solo["models"]["rf_draws"]
    for key in ("features_heap_bits", "thresholds_heap_bits", "leaf_probs_bits", "probs_bits"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("name", ("dt", "rf_draws", "rf", "gb", "nb"))
def test_the_other_fits_on_the_grid_are_the_data_axis_bits(runs, name):
    got, want = runs[GRID][0]["models"][name], runs[2][0]["models"][name]
    assert {key: value for key, value in got.items() if key.endswith("_bits")} == {
        key: value for key, value in want.items() if key.endswith("_bits")}


@pytest.mark.parametrize("what", ("pca", "affinities", "tsne"))
def test_pca_and_tsne_on_the_grid_are_the_data_axis_results(runs, what):
    assert runs[GRID][0][what] == runs[2][0][what]


def test_train_one_on_the_grid_writes_once_in_the_one_process_layout(runs):
    for name in MODEL_NAMES:
        assert [r["train_one"][name]["written"] for r in runs[GRID]] == [True, False, False, False]
        got, want = runs[GRID][0]["train_one"][name], runs[2][0]["train_one"][name]
        np.testing.assert_allclose([float(got["accuracy"]), float(got["F1"])],
                                   [float(want["accuracy"]), float(want["F1"])], rtol=0, atol=1e-6)
    assert len(runs[GRID][0]["model_files"]) == len(MODEL_NAMES)
    for name in MODEL_NAMES:
        got, want = runs[GRID][0]["checkpoints"][name], runs[2][0]["checkpoints"][name]
        assert (got["kind"], got["arrays"]) == (want["kind"], want["arrays"])
    np.testing.assert_allclose(runs[GRID][0]["checkpoints"]["lr"]["w"],
                               runs[2][0]["checkpoints"]["lr"]["w"], rtol=0, atol=1e-3)


def test_bf16_fit_sharded_over_the_grid_matches_the_data_axis(runs):
    got, want = runs[GRID][0]["lr_bf16"], runs[2][0]["lr_bf16"]
    assert all(r["lr_bf16"]["probs_bits"] == got["probs_bits"] for r in runs[GRID])
    assert (got["mean"], got["scale"]) == (want["mean"], want["scale"])
    losses, wanted = np.asarray(got["losses"]), np.asarray(want["losses"])
    assert losses.shape == wanted.shape
    assert np.max(np.abs(losses - wanted) / np.abs(wanted)) <= LR_LOSS_RTOL


def test_bf16_fit_sharded_over_two_ranks_is_the_references(runs, monkeypatch):
    """K8′ on bfloat16 rows and the fit on them, over 2 × 1 gloo ranks,
    against the JAX package's ``fit_sharded`` on ``make_mesh(data=2)``
    under the same policy."""
    import jax
    import jax.numpy as jnp

    from learningorchestra_tpu.ml.logistic import LogisticRegression as JaxLogistic
    from learningorchestra_tpu.parallel.mesh import make_mesh
    from learningorchestra_tpu.parallel.sharding import shard_rows
    from learningorchestra_tpu.utils import dtypepolicy as jax_dtypepolicy

    monkeypatch.setenv("LO_DTYPE_POLICY", "bf16")
    monkeypatch.setattr(jax_dtypepolicy, "_POLICY", [])
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    X, y = lr_data(2)
    X_dev, mask = shard_rows(X, mesh, dtype=np.float32)
    y_dev, _ = shard_rows(y, mesh, dtype=np.int32)
    assert X_dev.dtype == jnp.bfloat16
    theirs = JaxLogistic(mesh=mesh).fit_sharded(X_dev, y_dev, mask, 2)
    their_probs = np.asarray(theirs.predict_proba(X))
    got = runs[2][0]["lr_bf16"]

    def steps(ours, want):   # bfloat16 ulps between float32 copies of bfloat16 values
        a = np.asarray(ours, np.float32).view(np.int32) >> 16
        return int(np.abs(a.astype(np.int64) - (np.asarray(want, np.float32).view(np.int32) >> 16)).max())

    assert steps(got["mean"], theirs.mean) <= 1 and steps(got["scale"], theirs.scale) <= 1
    probs = np.asarray(got["probs"])
    np.testing.assert_allclose(probs, their_probs, rtol=0, atol=BF16_PROB_TOL)
    labels, their_labels = np.asarray(got["labels"]), np.argmax(their_probs, axis=1)
    differ = labels != their_labels
    top = np.sort(their_probs[differ], axis=1)
    assert not differ.any() or (top[:, -1] - top[:, -2]).max() < NEAR_TIE


# --------------------------------------------------------------------------
# The new kernel forms' plain twins: blocks added in rank order against the
# whole, on the CPU (where nothing launches)
# --------------------------------------------------------------------------

def _blocks(rows: int, world: int):
    """Each rank's row range under the block rule (``host_row_range``)."""
    from learningorchestra_tpu_torch.parallel.sharding import padded_row_count

    block = padded_row_count(rows, world) // world
    return [(min(r * block, rows), min((r + 1) * block, rows)) for r in range(world)]


def _gb_level(seed: int, rows: int = 3_000, features: int = 6, n_nodes: int = 8):
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, 32, size=(rows, features), dtype=np.int8))
    node = torch.from_numpy(rng.integers(0, n_nodes, size=rows, dtype=np.int32))
    p = rng.random(rows)
    label = rng.integers(0, 2, size=rows)
    channels = torch.from_numpy(np.stack([p - label, p * (1 - p)], axis=1).astype(np.float32))
    return bins, node, channels


def _relative(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("world", WORLDS)
def test_k2_sums_form_twin_adds_over_blocks(world):
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.ml import trees

    kernels.reset_launches()
    bins, node, channels = _gb_level(world)
    whole = trees.level_histograms(bins, node, channels, 8, 32, sums=True)
    assert whole.dtype == torch.float64
    total = None
    for start, stop in _blocks(bins.shape[0], world):
        part = trees.level_histograms(bins[start:stop], node[start:stop], channels[start:stop], 8, 32,
                                      sums=True)
        total = part if total is None else total + part
    assert _relative(total, whole) <= 1e-12
    assert torch.equal(total.to(torch.float32), trees.level_histograms(bins, node, channels, 8, 32))
    assert set(kernels.launches().values()) == {0}
    with pytest.raises(ValueError, match="sums form"):
        trees.level_histograms(bins, node, channels.abs().round(), 8, 32, integer=True, sums=True)


@pytest.mark.parametrize("world", WORLDS)
def test_k5_sums_form_twin_adds_over_blocks(world):
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.ml import trees

    kernels.reset_launches()
    _, leaf, channels = _gb_level(world + 10)
    whole = trees.leaf_sums(leaf, channels, 32, sums=True)
    assert whole.dtype == torch.float64
    total = None
    for start, stop in _blocks(leaf.shape[0], world):
        part = trees.leaf_sums(leaf[start:stop], channels[start:stop], 32, sums=True)
        total = part if total is None else total + part
    assert _relative(total, whole) <= 1e-12
    assert torch.equal(total.to(torch.float32), trees.leaf_sums(leaf, channels, 32))
    assert set(kernels.launches().values()) == {0}


@pytest.mark.parametrize("world", WORLDS)
def test_k11_slab_twin_gives_the_whole_rows(world):
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.ops import tsne

    kernels.reset_launches()
    X = torch.from_numpy(blob_data()[0])
    whole = tsne.conditional_affinities(X, PERPLEXITY)
    for start, stop in _blocks(X.shape[0], world):
        slab = tsne.conditional_affinities_slab(X, PERPLEXITY, start, stop - start)
        assert slab.shape == (stop - start, X.shape[0])
        np.testing.assert_allclose(slab.numpy(), whole[start:stop].numpy(), rtol=0, atol=1e-7)
    assert set(kernels.launches().values()) == {0}


@pytest.mark.parametrize("world", WORLDS)
def test_k12_slab_twin_adds_over_slabs(world):
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.ops import tsne

    kernels.reset_launches()
    rng = np.random.default_rng(world)
    n = 150
    Y = torch.from_numpy((rng.normal(size=(n, 2)) * 5.0).astype(np.float32))
    P = torch.from_numpy(rng.random((n, n), dtype=np.float32))
    P /= P.sum()
    whole_z = tsne.tsne_z_slab(Y, 0, n)
    parts = [tsne.tsne_z_slab(Y, start, stop - start) for start, stop in _blocks(n, world)]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    assert total.dtype == torch.float64
    assert abs(float(total) - float(whole_z)) <= 1e-12 * float(whole_z)
    Z = total.to(torch.float32)
    want = tsne._tsne_grad(Y, P, Z, tsne.EARLY_EXAGGERATION)
    scale = float(want.abs().max())
    for start, stop in _blocks(n, world):
        got = tsne.tsne_grad_slab(Y, P[start:stop].contiguous(), Z, start, tsne.EARLY_EXAGGERATION)
        assert got.shape == (stop - start, 2)
        assert float((got - want[start:stop]).abs().max()) <= 1e-6 * scale
    assert set(kernels.launches().values()) == {0}
