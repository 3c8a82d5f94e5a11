"""The port's lr fit over ranks: R gloo processes on the CPU, held against
the JAX package's 8-device fit.

The file launches itself as the worker (``python
tests/test_torch_multihost.py <rank> <world> <addr> <out>``): each rank
joins a ``torch.distributed`` gloo group of R in {2, 4} processes
(``parallel.initialize_from_env``, a group timeout of 60 s), builds the
default mesh (every rank on the data axis, ``device="cpu"``) and fits the
reference's multi-host job (tests/multihost_dataset.py: 400 x 12, 3
classes, ``max_iter=25``) twice, as tests/multihost_worker.py does:

- ``fit``: every rank passes the full rows (the SPMD call); each fits on
  its block of the padded rows, the mask as row weights;
- ``fit_sharded``: each rank loads only its ``host_row_range`` rows
  (``shard_rows_local``); K8′ standardizes on the device from the blocks.

What is held, as tests/test_multihost.py:80-109 and :198-225 hold the
reference:
- every rank of a run holds the same bits (W, b, the scaler, the
  predictions, the probabilities);
- per-host feeding covers the rows once and round-trips through ``fetch``;
- the sharded ``fit`` gives 100% of the JAX package's single-process
  8-device ``fit``'s predictions, its first 8 rows' probabilities within
  1e-6: the same padded rows and mask weights (448 rows), float64 sums
  rounded once in the port, float32 sums in the reference, over 25
  L-BFGS steps; its accuracy and weighted F1 (every rank's confusion
  counts added) within 1e-6 of the reference's, and ``evaluate_predict``
  the same as ``evaluate`` and ``predict_both``;
- ``fit_sharded`` agrees with the JAX package's ``fit_sharded`` on the
  same mesh on at least 98% of rows, the bound that the reference sets
  between its own ``fit_sharded`` and ``fit`` (tests/test_multihost.py:104);
- R = 2 and R = 4 give the same predictions;
- rank 0's ``.model`` (the only one written) loads in the JAX package and
  predicts the port's labels, and a JAX ``fit_sharded`` model loads in
  the port and predicts its labels.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

_TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_TESTS_DIR)
WORLDS = (2, 4)
GROUP_TIMEOUT_S = 60
MAX_ITER = 25


def _hex(tensor) -> str:
    return tensor.detach().cpu().numpy().tobytes().hex()


def worker(rank: int, world: int, address: str, out_path: str) -> None:
    os.environ["LO_COORDINATOR"] = address
    os.environ["LO_NUM_PROCESSES"] = str(world)
    os.environ["LO_PROCESS_ID"] = str(rank)
    import torch.distributed as dist

    from multihost_dataset import make_dataset

    from learningorchestra_tpu_torch.ml.checkpoint import save_model
    from learningorchestra_tpu_torch.ml.logistic import LogisticRegression
    from learningorchestra_tpu_torch.parallel import (
        fetch,
        host_row_range,
        initialize_from_env,
        make_mesh,
        shard_rows,
        shard_rows_local,
    )

    assert initialize_from_env(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    mesh = make_mesh(device="cpu")
    X, y = make_dataset()

    estimator = LogisticRegression(max_iter=MAX_ITER, device="cpu")
    assert estimator.mesh.shape["data"] == world
    model = estimator.fit(X, y)
    labels, probs = model.predict_both(X)
    accuracy, weighted_f1 = model.evaluate(X, y)
    both = model.evaluate_predict(X, y, X[:50])
    evaluate_predict_ok = bool(
        both[:2] == (accuracy, weighted_f1) and np.array_equal(both[2], labels[:50])
        and both[3].tobytes() == probs[:50].tobytes()
    )

    start, stop = host_row_range(len(X), mesh)
    arr, mask = shard_rows_local(X[start:stop], mesh, len(X), dtype=np.float32)
    block, block_mask = shard_rows(X.astype(np.float32), mesh)
    feeding_ok = bool(
        np.array_equal(fetch(arr, mesh), fetch(block, mesh))
        and np.array_equal(fetch(mask, mesh), fetch(block_mask, mesh))
        and np.array_equal(fetch(arr, mesh, mask), X.astype(np.float32))
    )
    y_arr, _ = shard_rows_local(y[start:stop], mesh, len(y), dtype=np.int32)
    sharded_estimator = LogisticRegression(max_iter=MAX_ITER, mesh=mesh)
    sharded = sharded_estimator.fit_sharded(arr, y_arr, mask, num_classes=int(y.max()) + 1)
    sharded_labels, sharded_probs = sharded.predict_both(X)
    model_path = os.path.join(os.path.dirname(out_path), f"sharded_r{world}_p{rank}.model")
    save_model(sharded, model_path)

    with open(out_path, "w") as handle:
        json.dump({
            "rank": rank,
            "world": world,
            "data": mesh.shape["data"],
            "host_rows": [start, stop],
            "feeding_ok": feeding_ok,
            "accuracy": accuracy,
            "weighted_f1": weighted_f1,
            "evaluate_predict_ok": evaluate_predict_ok,
            "predictions": labels.tolist(),
            "probs_head": probs[:8].tolist(),
            "probs_bits": probs.tobytes().hex(),
            "params": [_hex(model.w), _hex(model.b), _hex(model.mean), _hex(model.scale)],
            "sharded_predictions": sharded_labels.tolist(),
            "sharded_probs_bits": sharded_probs.tobytes().hex(),
            "sharded_params": [_hex(sharded.w), _hex(sharded.b), _hex(sharded.mean),
                               _hex(sharded.scale)],
            "sharded_losses": sharded_estimator.loss_history_.tolist(),
            "model_path": model_path,
            "model_written": os.path.exists(model_path),
        }, handle)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path[:0] = [_REPO_ROOT, _TESTS_DIR]
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


import pytest  # noqa: E402

torch = pytest.importorskip("torch")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{R: [each rank's record]}`` for R in WORLDS, both runs at once."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_REPO_ROOT, _TESTS_DIR, env.get("PYTHONPATH", "")])
    env.pop("LO_DTYPE_POLICY", None)
    procs, outs = {}, {}
    for world in WORLDS:
        folder = tmp_path_factory.mktemp(f"torch_multihost_{world}")
        address = f"127.0.0.1:{_free_port()}"
        outs[world] = [str(folder / f"p{rank}.json") for rank in range(world)]
        procs[world] = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank), str(world), address,
                 outs[world][rank]],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=_TESTS_DIR,
            )
            for rank in range(world)
        ]
    logs = {}
    try:
        for world in WORLDS:
            logs[world] = [proc.communicate(timeout=180)[0].decode(errors="replace")
                           for proc in procs[world]]
    finally:
        for proc in (p for group in procs.values() for p in group):
            if proc.poll() is None:
                proc.kill()
    results = {}
    for world in WORLDS:
        for rank, proc in enumerate(procs[world]):
            assert proc.returncode == 0, f"R={world} rank {rank} failed:\n{logs[world][rank]}"
        results[world] = []
        for path in outs[world]:
            with open(path) as handle:
                results[world].append(json.load(handle))
    return results


@pytest.fixture(scope="module")
def reference():
    """The JAX package's 8-device fit and fit_sharded of the same job."""
    from multihost_dataset import make_dataset

    from learningorchestra_tpu.ml.logistic import LogisticRegression
    from learningorchestra_tpu.parallel.mesh import make_mesh
    from learningorchestra_tpu.parallel.sharding import shard_rows

    X, y = make_dataset()
    mesh = make_mesh()
    model = LogisticRegression(max_iter=MAX_ITER, mesh=mesh).fit(X, y)
    X_dev, mask = shard_rows(X.astype(np.float32), mesh)
    y_dev, _ = shard_rows(y, mesh, dtype=np.int32)
    sharded = LogisticRegression(max_iter=MAX_ITER, mesh=mesh).fit_sharded(
        X_dev, y_dev, mask, num_classes=int(y.max()) + 1)
    return {
        "X": X, "y": y, "predictions": model.predict(X), "probs_head": model.predict_proba(X)[:8],
        "metrics": model.evaluate(X, y),
        "sharded_model": sharded, "sharded_predictions": sharded.predict(X),
    }


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_the_same_bits(runs, world):
    first = runs[world][0]
    assert [r["rank"] for r in runs[world]] == list(range(world))
    for result in runs[world]:
        assert result["data"] == world
        for key in ("params", "predictions", "probs_bits", "sharded_params",
                    "sharded_predictions", "sharded_probs_bits", "sharded_losses",
                    "accuracy", "weighted_f1"):
            assert result[key] == first[key], key


@pytest.mark.parametrize("world", WORLDS)
def test_per_host_feeding_covers_the_rows_and_round_trips(runs, world):
    ranges = [tuple(r["host_rows"]) for r in runs[world]]
    assert ranges[0][0] == 0 and ranges[-1][1] == 400
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(r["feeding_ok"] for r in runs[world])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_matches_the_reference_fit(runs, reference, world):
    for result in runs[world]:
        assert np.mean(np.asarray(result["predictions"]) == reference["predictions"]) == 1.0
        np.testing.assert_allclose(result["probs_head"], reference["probs_head"], rtol=0, atol=1e-6)
        # K9 over ranks: every rank's confusion counts added before the metrics
        np.testing.assert_allclose([result["accuracy"], result["weighted_f1"]], reference["metrics"],
                                   rtol=0, atol=1e-6)
        assert result["evaluate_predict_ok"]


@pytest.mark.parametrize("world", WORLDS)
def test_fit_sharded_agrees_with_the_reference_fit_sharded(runs, reference, world):
    for result in runs[world]:
        agreement = np.mean(np.asarray(result["sharded_predictions"]) == reference["sharded_predictions"])
        assert agreement >= 0.98, agreement
        losses = np.asarray(result["sharded_losses"])
        assert len(losses) == MAX_ITER and np.all(np.isfinite(losses))


def test_two_and_four_ranks_predict_the_same(runs):
    for key in ("predictions", "sharded_predictions"):
        assert runs[2][0][key] == runs[4][0][key]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_model_crosses_both_ways(runs, reference, world, tmp_path):
    from learningorchestra_tpu.ml import checkpoint as jax_checkpoint

    from learningorchestra_tpu_torch.ml import checkpoint

    written = [r["model_written"] for r in runs[world]]
    assert written == [True] + [False] * (world - 1)    # only rank 0 writes
    X = reference["X"]
    port_labels = np.asarray(runs[world][0]["sharded_predictions"])
    np.testing.assert_array_equal(jax_checkpoint.load_model(runs[world][0]["model_path"]).predict(X),
                                  port_labels)
    jax_path = str(tmp_path / "jax_sharded.model")
    jax_checkpoint.save_model(reference["sharded_model"], jax_path)
    np.testing.assert_array_equal(checkpoint.load_model(jax_path, device="cpu").predict(X),
                                  reference["sharded_predictions"])
