"""One gloo rank on the CPU for the port's tests over several processes
(not a pytest file): ``tests/test_torch_spmd.py`` and
``tests/test_torch_sweep_ranks.py`` start ``world`` of these together.

argv: ``<job> <rank> <world> <init file> <out folder> [job arguments]``.
Each joins a gloo group through the shared ``file://`` rendezvous (no
port to race for), runs ``<job>`` and writes ``<out>/rank<rank>.pkl``.

Jobs:
- ``broadcast``: ``spmd._broadcast_json`` of ``BROADCAST_PAYLOADS``;
- ``stack <store url> <models dir> <images root> <cid>``: the port's
  counterpart of the reference's ``tests/spmd_worker.py``: two ranks of
  ``services/runner.make_dispatcher`` over one store server; rank 0
  submits a build of lr and dt, a batch prediction from the lr
  checkpoint and a PCA image, then shuts the worker down; every store
  write each rank makes is counted;
- ``death <phase>``: the reference's ``tests/spmd_death.py`` on the
  port's dispatcher: a healthy job, then (``drill``) a job the worker
  dies in, then one more, or (``recover``) a clean shutdown;
- ``sweep``: ``ml/sweep.run_group`` over the data ranks of the lr and dt
  grids of ``sweep_members``, a group with a NaN-poisoned member, and
  ``run_sweep`` of both kinds into this rank's own store and one models
  folder, every checkpoint each rank saves listed.
"""

import datetime
import os
import pickle
import sys

import numpy as np

FEATURES = 6
ROWS, EVAL_ROWS = 300, 203
LAMBDAS = [{"reg_param": l2} for l2 in (0.0, 0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0)]
DEPTHS = [{"max_depth": d} for d in (2, 3, 2, 4, 3)]
MAX_ITER = 15
SWEEP_MEMBERS = 2
BROADCAST_PAYLOADS = [
    {},
    {"texte": "ünïcødé ✓ 学习 🚀", "nested": [1, 2.5, None, {"k": "v"}]},
    {"blob": "x" * (1 << 20) + "é", "n": 3},
]
WATCHDOG_S = 8


def blobs(classes, rows, seed):
    """Overlapping blobs (``tests/test_torch_sweep.py``'s)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, FEATURES)) * 0.5
    y = rng.integers(0, classes, size=rows).astype(np.int64)
    X = (centers[y] + rng.normal(size=(rows, FEATURES))).astype(np.float32)
    return X, y


def sweep_members(classes=3):
    """``SWEEP_MEMBERS`` members' ``(X, y, X_eval, y_eval)``."""
    return [
        (*blobs(classes, ROWS, 31 * m + classes), *blobs(classes, EVAL_ROWS, 31 * m + classes + 100))
        for m in range(SWEEP_MEMBERS)
    ]


def sweep_body(kind: str) -> dict:
    """A ``run_sweep`` body over the ``sweep_train`` collection."""
    return {
        "sweep_name": f"sweep_{kind}",
        "training_filename": "sweep_train",
        "test_filename": "sweep_train",
        "preprocessor_code": PREPROCESSOR,
        "classificator": kind,
        "grid": LAMBDAS if kind == "lr" else DEPTHS,
        "max_iter": MAX_ITER,
    }


PREPROCESSOR = """
from pyspark.ml.feature import VectorAssembler
assembler = VectorAssembler(inputCols=["f1", "f2"], outputCol="features")
features_training = assembler.transform(training_df)
features_testing = assembler.transform(testing_df)
features_evaluation = features_training
"""


def sweep_store():
    """An in-process store holding ``sweep_train``: two features and a
    label, 240 rows, as the port's ingest leaves them after the cast."""
    from learningorchestra_tpu_torch.core.store import InMemoryStore

    rng = np.random.default_rng(9)
    labels = rng.integers(0, 2, 240)
    store = InMemoryStore()
    store.insert_one("sweep_train", {"_id": 0, "filename": "sweep_train", "finished": True,
                                     "fields": ["f1", "f2", "label"]})
    store.insert_many("sweep_train", [
        {"_id": i + 1, "f1": float(lab * 2 + rng.normal()), "f2": float(-lab + rng.normal()),
         "label": float(lab)}
        for i, lab in enumerate(labels)
    ])
    return store


def _counted(store) -> dict:
    """Count every write ``store`` takes, by method."""
    writes: dict = {}
    for name in ("drop", "insert_one", "insert_many", "insert_columns", "insert_column_arrays",
                 "update_one", "delete_one", "delete_many", "create_collection"):
        method = getattr(store, name, None)
        if method is None:
            continue

        def counted(*args, _name=name, _method=method, **kwargs):
            writes[_name] = writes.get(_name, 0) + 1
            return _method(*args, **kwargs)

        setattr(store, name, counted)
    return writes


def job_broadcast(rank: int, args: list) -> dict:
    from learningorchestra_tpu_torch.parallel.spmd import _broadcast_json

    return {"received": [_broadcast_json(p if rank == 0 else None) for p in BROADCAST_PAYLOADS]}


def job_stack(rank: int, args: list) -> dict:
    from learningorchestra_tpu_torch.core.store_service import connect
    from learningorchestra_tpu_torch.ml.checkpoint import checkpoint_path
    from learningorchestra_tpu_torch.services.runner import make_dispatcher
    from learningorchestra_tpu_torch.telemetry import tracing

    store_url, models_dir, images_root, cid = args
    store = connect(store_url)
    writes = _counted(store)
    images_dir = os.path.join(images_root, f"rank{rank}")
    dispatcher = make_dispatcher(store, images_dir, device="cpu")
    if rank != 0:
        dispatcher.run_worker_loop()
        return {"writes": writes, "images": sorted(_files(images_dir))}
    jobs = [
        ("build_model", {"training_filename": "spmd_train", "test_filename": "spmd_train",
                         "preprocessor_code": PREPROCESSOR, "classificators_list": ["lr", "dt"],
                         "models_dir": models_dir}),
        ("predict_model", {"checkpoint_path": checkpoint_path(models_dir, "spmd_train_prediction_lr"),
                           "training_filename": "spmd_train", "test_filename": "spmd_train",
                           "preprocessor_code": PREPROCESSOR, "prediction_filename": "spmd_predicted"}),
        ("embedding_image", {"parent_filename": "spmd_train", "label_name": "label",
                             "output_filename": "spmd_pca", "method": "pca"}),
    ]
    for op, payload in jobs:
        with tracing.activate(tracing.Trace(f"{cid}-{op}")):
            dispatcher.submit(op, payload, timeout=120)
    dispatcher.shutdown_workers()
    return {"writes": writes, "images": sorted(_files(images_dir))}


def _files(folder: str) -> list:
    return [os.path.relpath(os.path.join(root, name), folder)
            for root, _, names in os.walk(folder) for name in names]


def job_death(rank: int, args: list) -> dict:
    import torch
    import torch.distributed as dist

    from learningorchestra_tpu_torch.parallel.spmd import (
        SpmdDispatcher,
        SpmdRuntimePoisonedError,
        SpmdTimeoutError,
    )

    (phase,) = args
    dispatcher = SpmdDispatcher()

    def fit(payload):
        """A collective job (it stands in for a fit)."""
        parts = [torch.zeros(1, dtype=torch.int64) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, torch.tensor([dist.get_rank() + 1]))
        return int(sum(int(part) for part in parts))

    def die_mid_job(payload):
        if dist.get_rank() != 0:
            os._exit(17)   # the worker "crashes" mid-job
        return fit(payload)   # the coordinator enters a collective missing a peer

    dispatcher.register("fit", fit)
    dispatcher.register("die", die_mid_job)
    if rank != 0:
        try:
            dispatcher.run_worker_loop()
        finally:
            os._exit(0)
    results = {"fit_before": dispatcher.submit("fit", {}, timeout=60)}
    if phase == "drill":
        try:
            dispatcher.submit("die", {}, timeout=WATCHDOG_S)
            results["death_job"] = "no-error"
        except SpmdTimeoutError:
            results["death_job"] = "timeout"
        except Exception as error:   # gloo may raise for the dead peer itself
            results["death_job"] = f"error:{type(error).__name__}"
        try:
            dispatcher.submit("fit", {}, timeout=WATCHDOG_S)
            results["after_death"] = "no-error"
        except SpmdRuntimePoisonedError:
            results["after_death"] = "poisoned"
        except Exception as error:
            results["after_death"] = f"error:{type(error).__name__}"
    else:
        dispatcher.shutdown_workers()
    return results


def job_sweep(rank: int, args: list) -> dict:
    from learningorchestra_tpu_torch.core.jobs import JobManager
    from learningorchestra_tpu_torch.ml import checkpoint, sweep
    from learningorchestra_tpu_torch.parallel import make_mesh, multihost
    from learningorchestra_tpu_torch.sched.coalesce import Coalescer

    (folder,) = args
    mesh = make_mesh(device="cpu")
    out = {"mesh": [mesh.shape["data"], mesh.data_index]}
    multihost.reset_collective_stats()
    for kind, grid in (("lr", LAMBDAS), ("dt", DEPTHS)):
        payloads = [
            sweep.prepare_member(kind, X, y, Xe, ye, grid, max_iter=MAX_ITER, mesh=mesh)
            for X, y, Xe, ye in sweep_members()
        ]
        out[f"{kind}_keys"] = [key for key, _ in payloads]
        out[kind] = sweep.run_group([payload for _, payload in payloads], mesh=mesh)
    out["collectives"] = multihost.collective_stats()["collectives"]
    X, y, Xe, ye = sweep_members()[0]
    bad = X.copy()
    bad[3, 1] = np.nan
    # member 1 poisoned on every rank, member 2 on rank 1 alone
    rows = (X, bad, bad if rank == 1 else X)
    payloads = [sweep.prepare_member("lr", data, y, Xe, ye, LAMBDAS[:2], max_iter=3, mesh=mesh)[1]
                for data in rows]
    out["poisoned"] = [(status, str(value) if status == "error" else value["best"])
                       for status, value in sweep.run_group(payloads, mesh=mesh)]
    store = sweep_store()
    writes = _counted(store)
    models_dir = os.path.join(folder, "models")   # one folder, as every rank's host mounts it
    saved = []
    save_model = checkpoint.save_model
    checkpoint.save_model = lambda model, path: saved.append(os.path.basename(path)) or save_model(model, path)
    out["run_sweep"] = {}
    for kind in ("lr", "dt"):
        result = sweep.run_sweep(store, sweep_body(kind), jobs=JobManager(), coalescer=Coalescer(window_s=0.0),
                                 models_dir=models_dir, mesh=mesh)
        out["run_sweep"][kind] = {**result, "document": store.find_one(f"sweep_{kind}", {"_id": 0})}
    out["writes"] = writes
    out["saved"] = saved
    return out


def run_ranks(job: str, world: int, folder, *args, timeout_s: float = 120, checked=None) -> tuple:
    """Start ``world`` ranks of ``job`` together and wait for them, all
    within ``timeout_s``; ``(each rank's result or None, each rank's
    output)``. Fails when a rank of ``checked`` (default: every rank)
    exits with an error; kills any rank still running at the timeout."""
    import subprocess
    import time

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    out = os.path.join(str(folder), f"{job}{world}")
    os.makedirs(out)
    init = os.path.join(str(folder), f"{job}{world}.rendezvous")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, here, os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(rank), str(world), init, out,
                          *map(str, args)], env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)
    ]
    logs = []
    deadline = time.monotonic() + timeout_s
    try:
        for proc in procs:
            try:
                output, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                output, _ = proc.communicate()
            logs.append(output.decode(errors="replace"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank in checked if checked is not None else range(world):
        assert procs[rank].returncode == 0, (
            f"rank {rank} of {job} exited {procs[rank].returncode}:\n{logs[rank][-4000:]}")
    results = []
    for rank in range(world):
        path = os.path.join(out, f"rank{rank}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as handle:
                results.append(pickle.load(handle))
        else:
            results.append(None)
    return results, logs


JOBS = {"broadcast": job_broadcast, "stack": job_stack, "death": job_death, "sweep": job_sweep}


def main() -> int:
    job, rank, world, init_file, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    result = JOBS[job](rank, sys.argv[6:])
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as handle:
        pickle.dump(result, handle)
    if job == "death":
        os._exit(0)   # no teardown of a group with a dead peer
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

