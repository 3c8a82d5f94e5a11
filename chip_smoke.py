"""Drive the PyTorch port's online predict lane on one CUDA card.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — CUDA must be available; the card's name and power limit.
2. build   — build (or load) the CUDA kernel library from
             ``learningorchestra_tpu_torch/kernels/csrc``.
3. kernels — each kernel against its plain PyTorch version on the same
             seeded inputs, at N in {1, 64, 4096, 1,048,576} rows, 1 and 20
             trees of depth 5: identical labels and probabilities within
             1e-6; times at 4096 and 1,048,576 rows.
4. serve   — ``dt``, ``rf``, ``gb``, ``lr`` and ``nb`` checkpoints at full
             width (16 features, 2 classes, depth 5, 20 trees or rounds) with
             seeded parameters, written by the port and served by its HTTP
             app over real sockets: single rows, 8 concurrent single rows
             and one 4096-row request to each model, checked against the
             plain forward on the CPU; 404, 406 and 413; the kernels' launch
             counts must rise during this phase.

Then the ``kernels`` summary line, the card's ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero without that last line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.ml import trees
from learningorchestra_tpu_torch.ml.checkpoint import (
    checkpoint_path,
    load_model,
    write_checkpoint,
)
from learningorchestra_tpu_torch.ml.trees import GBT_STEP, MAX_DEPTH, NUM_TREES
from learningorchestra_tpu_torch.serve import ServePlane
from learningorchestra_tpu_torch.serve import config as serve_config
from learningorchestra_tpu_torch.services.model_builder import create_app
from learningorchestra_tpu_torch.utils.web import ServerThread

FEATURES = 16          # bench.py's synthetic width
CLASSES = 2
DEPTH = MAX_DEPTH      # the repo's default models at full width
TREES = NUM_TREES      # rf trees; gb rounds are the same 20
STEP = GBT_STEP
MAX_BINS = 32
KERNEL_ROWS = (1, 64, 4096, 1_048_576)
TIMED_ROWS = (4096, 1_048_576)
TREE_TOL = 1e-6
LINEAR_TOL = 1e-5      # lr/nb: the GEMM sums in another order on the card
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 ops/s off the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

KERNEL_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/tree_forward.cu"
REPLACES = {
    "tree_ensemble_forward": (
        "learningorchestra_tpu/ml/trees.py:303 _descend under :364 _ensemble_forward"
    ),
    "gbt_forward": "learningorchestra_tpu/ml/trees.py:303 _descend under :648 _gbt_forward",
}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


# --------------------------------------------------------------------------
# Seeded parameters in the shapes and dtypes a fit writes
# --------------------------------------------------------------------------

def bench_rows(rng, rows: int, features: int = FEATURES) -> np.ndarray:
    """bench.py-style rows: uniform x 20, float32."""
    return rng.random((rows, features), dtype=np.float32) * 20.0


def _heaps(rng, thresholds, count: int, depth: int, leaf_rate: float = 0.1):
    """``features_heap`` and ``thresholds_heap`` of ``count`` trees grown
    as a fit grows them: a node whose parent stopped splitting stops too
    (feature -1), and a split's threshold is one of the feature's quantile
    thresholds."""
    features, bins = thresholds.shape
    nodes = 2**depth - 1
    features_heap = np.full((count, nodes), -1, np.int32)
    thresholds_heap = np.full((count, nodes), thresholds[0, 0], np.float32)
    for tree in range(count):
        for node in range(nodes):
            parent_split = node == 0 or features_heap[tree, (node - 1) // 2] >= 0
            if parent_split and rng.random() >= leaf_rate:
                feature = int(rng.integers(features))
                features_heap[tree, node] = feature
                thresholds_heap[tree, node] = thresholds[feature, rng.integers(bins)]
    return features_heap, thresholds_heap


def synthetic_checkpoints(
    seed: int = 0,
    features: int = FEATURES,
    depth: int = DEPTH,
    num_trees: int = TREES,
    classes: int = CLASSES,
) -> dict:
    """``{name: (kind, arrays, scalars)}`` for dt, rf, gb, lr and nb, with
    seeded parameters in exactly the shapes and dtypes the fits write."""
    rng = np.random.default_rng(seed)
    X = bench_rows(rng, 4096, features)
    quantiles = np.linspace(0, 1, MAX_BINS + 1)[1:-1]
    thresholds = np.quantile(X.astype(np.float64), quantiles, axis=0).T
    thresholds[-1] = np.inf  # a constant training feature: never splits right
    thresholds = thresholds.astype(np.float32)
    leaves = 2**depth

    def leaf_probs(count):
        return rng.dirichlet(np.ones(classes), size=(count, leaves)).astype(np.float32)

    dt = _heaps(rng, thresholds, 1, depth)
    rf = _heaps(rng, thresholds, num_trees, depth)
    gb = _heaps(rng, thresholds, num_trees, depth)
    theta = rng.random((classes, features)) + 0.1
    prior = rng.random(classes) + 0.5
    return {
        "dt": (
            "tree_ensemble",
            {"features_heap": dt[0], "thresholds_heap": dt[1], "leaf_probs": leaf_probs(1)},
            {"max_depth": depth},
        ),
        "rf": (
            "tree_ensemble",
            {"features_heap": rf[0], "thresholds_heap": rf[1], "leaf_probs": leaf_probs(num_trees)},
            {"max_depth": depth},
        ),
        "gb": (
            "gbt",
            {
                "features_heap": gb[0],
                "thresholds_heap": gb[1],
                "leaf_values": (rng.normal(size=(num_trees, leaves)) * 2).astype(np.float32),
            },
            {"f0": float(np.float32(-0.2)), "step": STEP, "max_depth": depth},
        ),
        "lr": (
            "logistic",
            {
                "w": rng.normal(size=(features, classes)).astype(np.float32),
                "b": rng.normal(size=classes).astype(np.float32),
                "mean": X.mean(axis=0, dtype=np.float64).astype(np.float32),
                "scale": X.std(axis=0, dtype=np.float64).astype(np.float32),
            },
            {},
        ),
        "nb": (
            "naive_bayes",
            {
                "theta": np.log(theta / theta.sum(axis=1, keepdims=True)).astype(np.float32),
                "prior": np.log(prior / prior.sum()).astype(np.float32),
            },
            {},
        ),
    }


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def nvidia_smi_line() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return result.stdout.strip().splitlines()[0]


def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")
    card = nvidia_smi_line()
    emit({
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })
    return {"card": card}


def phase_build() -> None:
    started = time.perf_counter()
    kernels.library()
    ptxas = [
        line.strip() for line in kernels.build_info.get("ptxas", "").splitlines()
        if "registers" in line or "Compiling entry" in line
    ]
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - started,
        "built": kernels.build_info["built"],
        "library": os.path.relpath(kernels.build_info["path"]),
        "ptxas": ptxas,
    })


def _kernel_inputs(torch, rows: int, count: int, seed: int):
    """Rows and heaps for the kernel checks: early leaves anywhere
    (feature -1), inf thresholds, NaN in selected and unselected columns."""
    rng = np.random.default_rng(seed)
    nodes, leaves = 2**DEPTH - 1, 2**DEPTH
    X = bench_rows(rng, rows)
    X[rng.random(X.shape) < 0.05] = np.nan
    features_heap = rng.integers(-1, FEATURES, size=(count, nodes)).astype(np.int32)
    thresholds_heap = (rng.random((count, nodes)) * 20).astype(np.float32)
    thresholds_heap[rng.random((count, nodes)) < 0.1] = np.inf
    leaf_probs = rng.dirichlet(np.ones(CLASSES), size=(count, leaves)).astype(np.float32)
    leaf_values = rng.normal(size=(count, leaves)).astype(np.float32)

    def cuda(array):
        return torch.from_numpy(array).cuda()

    return (
        cuda(X), cuda(features_heap), cuda(thresholds_heap),
        cuda(leaf_probs), cuda(leaf_values),
    )


def _event_ms(torch, fn, repeats: int) -> float:
    """Mean milliseconds per call of ``fn`` on the stream, back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _device_ms(torch, fn, kernel_name: str, repeats: int):
    """Mean device milliseconds of the kernel ``kernel_name`` per call, from
    the profiler's trace of the card; None when the trace has no device
    time for it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    total_us, calls = 0.0, 0
    for event in prof.key_averages():
        if kernel_name in event.key:
            total_us += getattr(event, "device_time_total", 0.0) or getattr(
                event, "cuda_time_total", 0.0
            )
            calls += event.count
    return total_us / 1000.0 / calls if calls and total_us > 0 else None


def _bound(rows: int, count: int, kernel: str) -> tuple[float, str]:
    """Least milliseconds the card could take: bytes (X read once, the
    output written once, the heaps read once) over HBM bandwidth against
    float32 operations (D compares per row and tree, plus C adds for the
    mean or a multiply and an add for the margin) over the float32 peak."""
    nodes, leaves = 2**DEPTH - 1, 2**DEPTH
    per_leaf = CLASSES if kernel == "tree_ensemble_forward" else 1
    heap_bytes = count * (nodes * 8 + leaves * per_leaf * 4)
    bytes_moved = rows * FEATURES * 4 + rows * CLASSES * 4 + heap_bytes
    ops = rows * count * (DEPTH + (CLASSES if kernel == "tree_ensemble_forward" else 2))
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def phase_kernels(torch) -> dict:
    results = {name: {"max_abs_err": 0.0, "by_rows": {}} for name in REPLACES}
    for rows in KERNEL_ROWS:
        for tree_count in (1, TREES):
            X, fh, th, lp, lv = _kernel_inputs(torch, rows, tree_count, seed=rows + tree_count)
            calls = {
                "tree_ensemble_forward": (
                    lambda: trees.ensemble_forward(X, fh, th, lp, DEPTH),
                    lambda: trees._ensemble_forward(X, fh, th, lp, DEPTH),
                ),
                "gbt_forward": (
                    lambda: trees.gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH),
                    lambda: trees._gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH),
                ),
            }
            for name, (kernel, plain) in calls.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if got.shape != want.shape or not torch.isfinite(got).all():
                    raise AssertionError(f"{name} at {rows} rows: bad output {got.shape}")
                error = float((got - want).abs().max())
                if error > TREE_TOL:
                    raise AssertionError(f"{name} at {rows} rows, {tree_count} trees: err {error}")
                if not torch.equal(got.argmax(1), want.argmax(1)):
                    raise AssertionError(f"{name} at {rows} rows: labels differ")
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], error)
                if rows in TIMED_ROWS and tree_count == TREES:
                    repeats = 200 if rows <= 4096 else 50
                    bound_ms, bound_by = _bound(rows, tree_count, name)
                    results[name]["by_rows"][rows] = {
                        "ms": _event_ms(torch, kernel, repeats),
                        "device_ms": _device_ms(torch, kernel, f"{name}_kernel", repeats),
                        "plain_ms": _event_ms(torch, plain, max(5, repeats // 10)),
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                    }
    emit({"phase": "kernels", "rows": KERNEL_ROWS, "trees": (1, TREES), **results})
    return results


class _Client:
    """JSON over HTTP to the local server, never through a proxy."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def call(self, method: str, path: str, payload=None) -> tuple[int, dict]:
        data = None if payload is None else json.dumps(payload).encode()
        request = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with self.opener.open(request, timeout=120) as response:
                return response.status, json.loads(response.read())
        except urllib.error.HTTPError as error:
            return error.code, json.loads(error.read())


def _check_answer(name, status, body, rows, reference, tolerance) -> None:
    if status != 200:
        raise AssertionError(f"{name}: status {status} {body}")
    result = body["result"]
    labels = np.asarray(result["predictions"])
    probs = np.asarray(result["probabilities"], dtype=np.float64)
    if probs.shape != (len(rows), CLASSES) or not np.isfinite(probs).all():
        raise AssertionError(f"{name}: probabilities of shape {probs.shape}")
    if not np.array_equal(labels, probs.argmax(axis=1)):
        raise AssertionError(f"{name}: labels are not the argmax of the probabilities")
    error = np.abs(probs - reference).max()
    if error > tolerance:
        raise AssertionError(f"{name}: probabilities differ from the CPU forward by {error}")


def phase_serve(torch, card: str) -> dict:
    max_rows = serve_config.max_rows()
    rng = np.random.default_rng(7)
    single = bench_rows(rng, 16)
    full = bench_rows(rng, max_rows)
    latencies_ms, checks = [], 0
    with tempfile.TemporaryDirectory() as models_dir:
        tolerances = {}
        for name, gathered in synthetic_checkpoints(seed=0).items():
            write_checkpoint(gathered, checkpoint_path(models_dir, name))
            tolerances[name] = TREE_TOL if gathered[0] in ("tree_ensemble", "gbt") else LINEAR_TOL
        plane = ServePlane()
        server = ServerThread(create_app(models_dir=models_dir, serve=plane)).start()
        try:
            client = _Client(server.port)
            kernels.reset_launches()
            for name, tolerance in tolerances.items():
                cpu_model = load_model(checkpoint_path(models_dir, name), device="cpu")
                path = f"/models/{name}/predict"
                for row in single:
                    started = time.perf_counter()
                    status, body = client.call("POST", path, {"rows": [row.tolist()]})
                    latencies_ms.append((time.perf_counter() - started) * 1e3)
                    expected = cpu_model.predict_proba(row[None])
                    _check_answer(name, status, body, row[None], expected, tolerance)
                    checks += 1
                answers: list = [None] * 8
                barrier = threading.Barrier(8)

                def one(index, _path=path):
                    barrier.wait(timeout=60)
                    answers[index] = client.call("POST", _path, {"rows": [single[index].tolist()]})

                workers = [threading.Thread(target=one, args=(i,)) for i in range(8)]
                for worker in workers:
                    worker.start()
                for worker in workers:
                    worker.join(timeout=120)
                    if worker.is_alive():
                        raise AssertionError(f"{name}: a concurrent request did not finish")
                for index, (status, body) in enumerate(answers):
                    row = single[index][None]
                    _check_answer(name, status, body, row, cpu_model.predict_proba(row), tolerance)
                    checks += 1
                status, body = client.call("POST", path, {"rows": full.tolist()})
                _check_answer(name, status, body, full, cpu_model.predict_proba(full), tolerance)
                checks += 1
            torch.cuda.synchronize()
            launches = kernels.launches()
            nan_rows = single[:2].tolist()
            nan_rows[1][3] = float("nan")
            refusals = (
                ("/models/missing/predict", {"rows": [single[0].tolist()]},
                 404, {"result": "file_not_found"}),
                ("/models/rf/predict", {"rows": nan_rows}, 406, {"result": "invalid_rows"}),
                ("/models/gb/predict", {"rows": bench_rows(rng, max_rows + 1).tolist()},
                 413, {"result": "too_many_rows"}),
            )
            for path, payload, status, answer in refusals:
                got = client.call("POST", path, payload)
                if got != (status, answer):
                    raise AssertionError(f"{path}: expected {status} {answer}, got {got}")
            stats = plane.stats()
        finally:
            server.stop()
            plane.close()
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"the serve path never launched {missing}")
    record = {
        "phase": "serve",
        "models": sorted(tolerances),
        "answers_checked": checks,
        "launches": launches,
        "p50_single_row_ms": statistics.median(latencies_ms),
        "p99_single_row_ms": float(np.percentile(latencies_ms, 99)),
        "mean_batch_size": stats["mean_batch_size"],
        "batches": stats["batches"],
        "registry": stats["registry"],
        "nvidia_smi": card,
    }
    emit(record)
    return record


def main() -> int:
    import torch

    device = phase_device(torch)
    phase_build()
    kernel_results = phase_kernels(torch)
    serve = phase_serve(torch, device["card"])
    summary = []
    for name, result in kernel_results.items():
        at_serve = result["by_rows"][4096]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": serve["launches"][name],
            "max_abs_err": result["max_abs_err"],
            "rows": 4096,
            "ms": at_serve["ms"],
            "device_ms": at_serve["device_ms"],
            "plain_ms": at_serve["plain_ms"],
            "bound_ms": at_serve["bound_ms"],
            "bound_by": at_serve["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a tree-ensemble forward
            "by_rows": result["by_rows"],
        })
    emit({"kernels": summary})
    print(device["card"], flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
