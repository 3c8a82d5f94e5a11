"""Drive the PyTorch port's predict lane and its lr, dt, rf, gb and nb fits
on one CUDA card.

Run from the repository root, with one card visible:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py fit-kernels fit  # device, build and the named phases

Phases, one JSON line each:

1. device      — CUDA must be available; the card's name and power limit.
2. build       — build (or load) the CUDA kernel libraries from
                 ``learningorchestra_tpu_torch/kernels/csrc``, one nvcc per
                 source, all started together.
3. kernels     — each forward kernel (K6) against its plain PyTorch version
                 on the same seeded inputs, at N in {1, 64, 4096, 1,048,576}
                 rows, 1 and 20 trees of depth 5: identical labels and
                 probabilities within 1e-6; times at 4096 and 1,048,576 rows.
                 Also the times of the lr and nb forwards (K8, cuBLAS).
4. serve       — ``dt``, ``rf``, ``gb``, ``lr`` and ``nb`` checkpoints at full
                 width (16 features, 2 classes, depth 5, 20 trees or rounds)
                 with seeded parameters, written by the port and served by its
                 HTTP app over real sockets: single rows, 8 concurrent single
                 rows and one 4096-row request to each model, checked against
                 the plain forward on the CPU; 404, 406 and 413; the kernels'
                 launch counts must rise during this phase.
5. fit-kernels — each fit kernel (K1-K5) against its plain version on
                 bench.py's synthetic rows at full width (1,000,000 x 16,
                 32 bins), at every level of a depth-5 tree, with dt (class
                 one-hot) and gb ((g, h)) channels: bins, counts, splits and
                 routes identical, gb sums within 1e-5 relative; times,
                 each call with L2 overwritten before it, no time below
                 its bound. Then the size limits: K1, K2 and K4 at 255 bins
                 (int32 bins) identical; K2 at a 2,048-node level with K = 2
                 and K = 10 and K5 at 4,096 leaves with K = 10 (windows
                 past one block's shared memory), counts identical and sums
                 within 1e-5; K6 at 20 trees of depth 10 and at one tree of
                 depth 12 with 20 classes, bit-equal. Then the forest's
                 tree axis: K2, K4 and K5 over 20 trees (one launch a
                 level) and K3 with each node's subset of 4 features, at
                 every level of a depth-5 forest grown by the plain
                 versions from seeded bootstrap counts, identical to the
                 plain versions and, tree by tree, to one-tree launches;
                 K3 on tied scores, on a node whose every allowed gain is
                 -inf and with NaN outside the subset; K2 at 20 trees of
                 a 2,048-node level, K = 10 (windows); the one-tree calls
                 of dt and gb bit-equal with a tree axis of 1; times as
                 above. Then K7, both entry
                 points, against the plain twin on the same rows
                 standardized by scaler_stats, with 2 and 10 classes: loss
                 within 1e-6 relative, gradient within 1e-6, a second launch
                 bit identical; times cold (L2 overwritten) and warm.
6. fit         — ``make_classifier(...)`` fits dt, rf, gb, lr and nb on the
                 same 1,000,000 rows on the card, then evaluate_predict,
                 save_model and one request each over HTTP. Held against
                 plain-version fits on the card (dt: identical heaps and
                 metrics; rf: the 20 trees in one chunk, one launch of K2,
                 K3 and K4 a level, heaps identical and leaf probabilities
                 within 1e-6 on the same draws, refit bit for bit; gb:
                 margins and accuracy within 1e-3; lr: losses
                 within 1e-5 relative, the same stop segment, probabilities
                 within 1e-4), gb and lr refit bit for bit, no host sync in
                 a level, round or L-BFGS segment; nb's theta and prior
                 within 4e-6 of a float64 host computation; a depth-12 dt
                 of 10 classes with heaps identical to its plain-version
                 fit; the fit kernels' launch counts per fit; K9's time.

Then the ``kernels`` summary line, the card's ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero without that last line. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.ml import (
    binning,
    evaluation,
    logistic,
    make_classifier,
    naive_bayes,
    trees,
)
from learningorchestra_tpu_torch.ml.checkpoint import (
    checkpoint_path,
    load_model,
    model_from_arrays,
    save_model,
    write_checkpoint,
)
from learningorchestra_tpu_torch.ml.trees import GBT_ROUNDS, GBT_STEP, MAX_DEPTH, NUM_TREES
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
# Overwritten between the timed calls of a fit kernel, so that each call
# reads its inputs from HBM: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20

KERNEL_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/tree_forward.cu"
FIT_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/tree_fit.cu"
REPLACES = {
    "tree_ensemble_forward": (
        "learningorchestra_tpu/ml/trees.py:303 _descend under :364 _ensemble_forward"
    ),
    "gbt_forward": "learningorchestra_tpu/ml/trees.py:303 _descend under :648 _gbt_forward",
}
FIT_REPLACES = {
    "apply_bins": "learningorchestra_tpu/ml/binning.py:37 apply_bins",
    "level_histograms": (
        "learningorchestra_tpu/ml/trees.py:66 _level_histograms (also vmapped over trees, :437)"
    ),
    "select_splits": (
        "learningorchestra_tpu/ml/trees.py:160 _gini_gain, :181 _newton_gain, "
        ":196 _select_splits (with feature subsets, :201-206)"
    ),
    "route": (
        "learningorchestra_tpu/ml/trees.py:235 _route (:217 _indicator_lookup; "
        "also vmapped over trees, :437)"
    ),
    "leaf_sums": "learningorchestra_tpu/ml/trees.py:142 _leaf_sums (also vmapped over trees, :437)",
}
FOREST_KERNELS = ("level_histograms", "select_splits", "route", "leaf_sums")
SUBSET_K = int(np.ceil(np.sqrt(FEATURES)))   # rf's feature subsets: 4 of 16
WIDE_FOREST_ROWS = 100_000   # the windowed forest level: rows enough for every node
LOGISTIC_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/logistic.cu"
LOGISTIC_REPLACES = {
    "logistic_loss_grad": (
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn under value_and_grad "
        "in :141 _fit_segment_impl"
    ),
    "logistic_trial_losses": (
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn in the Armijo loop "
        ":176-200 of :141 _fit_segment_impl"
    ),
}
FIT_KERNELS = tuple(FIT_REPLACES) + tuple(LOGISTIC_REPLACES)
FIT_ROWS = 1_000_000   # bench.py's synthetic rows
GB_SUM_RTOL = 1e-5     # gb sums: float64 atomics in the plain version's scatter
FIT_MARGIN_TOL = 1e-3  # gb fit against the plain-version fit: margins, accuracy
# K7 against its plain twin: both sum rows in float64; the logits round in
# another order (fmaf in the kernel, cuBLAS in the twin)
K7_LOSS_RTOL = 1e-6
K7_GRAD_ATOL = 1e-6
LR_LOSS_RTOL = 1e-5    # lr fit against the plain-version fit, per iteration
LR_PROB_TOL = 1e-4     # and its probabilities
# nb theta and prior against float64 on the host: each is a float32
# difference of two logs near 16 (sums near 1e7), where one float32 step
# is 1.9e-6
NB_TOL = 4e-6
DEEP_DEPTH, DEEP_CLASSES = 12, 10   # the deep dt: 2,048 nodes at its last level
# H100 SXM float64 peak off the tensor cores (NVIDIA data sheet): K7 sums
# its gradient in float64
PEAK_FP64_OPS_PER_S = 33.5e12
# CUDA kernels of each device program; the profiler sums their device time
DEVICE_KERNELS = {
    "tree_ensemble_forward": ("tree_ensemble_forward_kernel",),
    "gbt_forward": ("gbt_forward_kernel",),
    "apply_bins": ("apply_bins_kernel",),
    "level_histograms": ("level_histograms_kernel", "sum_partials_kernel"),
    "select_splits": ("select_splits_kernel",),
    "route": ("route_kernel",),
    "leaf_sums": ("leaf_sums_kernel", "sum_partials_kernel"),
    "logistic_loss_grad": ("loss_grad_kernel", "finish_kernel"),
    "logistic_trial_losses": ("trial_losses_kernel", "finish_kernel"),
}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


# --------------------------------------------------------------------------
# Seeded parameters in the shapes and dtypes a fit writes
# --------------------------------------------------------------------------

def bench_rows(rng, rows: int, features: int = FEATURES) -> np.ndarray:
    """bench.py-style rows: uniform x 20, float32."""
    return rng.random((rows, features), dtype=np.float32) * 20.0


def bench_synthetic(rows: int, seed: int = 0):
    """bench.py's synthetic classification data (its ``_synthetic``): 16
    uniform features in [0, 20), a noisy threshold on two of them."""
    rng = np.random.default_rng(seed)
    X = rng.random((rows, FEATURES), dtype=np.float32) * 20.0
    y = (
        (X[:, 0] + X[:, 1] * 0.5 + rng.random(rows, dtype=np.float32) * 8) > 22
    ).astype(np.int32)
    return X, y


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
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=len(kernels.SOURCES)) as pool:
        for future in [pool.submit(kernels.build, name) for name in kernels.SOURCES]:
            future.result()
    libraries = {}
    for name in kernels.SOURCES:
        kernels.library(name)
        info = kernels.build_info[name]
        libraries[name] = {
            "seconds": info["seconds"],
            "built": info["built"],
            "library": os.path.relpath(info["path"]),
            "ptxas": [
                line.strip() for line in info["ptxas"].splitlines()
                if "registers" in line or "Compiling entry" in line
            ],
        }
    emit({"phase": "build", "seconds": time.perf_counter() - started, "libraries": libraries})


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


def _event_ms(torch, fn, repeats: int, flush=None) -> float:
    """Mean milliseconds per call of ``fn`` on the stream: back to back,
    or, given a ``flush`` buffer, each call alone right after the buffer
    is overwritten, so that it finds none of its inputs in L2."""
    fn()
    torch.cuda.synchronize()
    if flush is not None:
        pairs = []
        for _ in range(repeats):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in pairs) / repeats
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _profile_device_us(torch, fn, kernel_names=None) -> float:
    """Device microseconds the profiler's trace of the card shows while
    ``fn`` runs: of the CUDA kernels whose names contain one of
    ``kernel_names``, or of every CUDA kernel when that is None."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for event in prof.key_averages():
        if getattr(event, "device_type", None) is not None and "CUDA" not in str(event.device_type):
            continue
        if kernel_names is None or any(name in event.key for name in kernel_names):
            total_us += getattr(event, "self_device_time_total", 0.0) or getattr(
                event, "self_cuda_time_total", 0.0
            )
    return total_us


def _busy_ms(torch, fn):
    """Device milliseconds of every CUDA kernel in the trace of ``fn``;
    None when the trace shows no device time (the profiler missed it)."""
    total_us = _profile_device_us(torch, fn)
    return total_us / 1000.0 if total_us > 0 else None


def _device_ms(torch, fn, kernel_names, repeats: int, flush=None):
    """Mean device milliseconds per call of ``fn`` in the CUDA kernels
    named ``kernel_names``, from the profiler's trace of the card; None
    when the trace has no device time for them. Given a ``flush`` buffer,
    it is overwritten before each call (the fill's own kernel is not
    counted)."""

    def run():
        for _ in range(repeats):
            if flush is not None:
                flush.zero_()
            fn()

    total_us = _profile_device_us(torch, run, kernel_names)
    return total_us / 1000.0 / repeats if total_us > 0 else None


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
                        "device_ms": _device_ms(torch, kernel, DEVICE_KERNELS[name], repeats),
                        "plain_ms": _event_ms(torch, plain, max(5, repeats // 10)),
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                    }
    linear = _linear_forward_times(torch)
    emit({
        "phase": "kernels", "rows": KERNEL_ROWS, "trees": (1, TREES), **results,
        "linear_forwards": linear,
    })
    return results


def _linear_forward_times(torch) -> dict:
    """The lr and nb forwards (K8: ``torch.matmul`` + softmax, no hand
    kernel) at the serve and batch shapes, beside their bound: X read once,
    the probabilities written once, over HBM bandwidth (their float32
    operations, ~5 per weight, are far below the peak)."""
    rng = np.random.default_rng(11)
    checkpoints = synthetic_checkpoints(seed=0)
    times = {}
    for name in ("lr", "nb"):
        model = model_from_arrays(*checkpoints[name])
        times[name] = {}
        for rows in TIMED_ROWS:
            X = torch.from_numpy(bench_rows(rng, rows)).cuda()
            bytes_moved = rows * FEATURES * 4 + rows * CLASSES * 4
            ops = rows * CLASSES * (2 * FEATURES + 5)
            byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
            op_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
            times[name][rows] = {
                "ms": _event_ms(torch, lambda: model._forward(X), 200 if rows <= 4096 else 50),
                "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            }
    return times


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
    missing = [name for name in REPLACES if launches[name] == 0]
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


# --------------------------------------------------------------------------
# The fit: kernels K1-K5 and the dt and gb fits
# --------------------------------------------------------------------------

def _fit_bound(
    name: str, rows: int, n_nodes: int, channels: int, bins_read: int = 0,
    trees: int = 1, subsets: bool = False,
) -> tuple[float, str]:
    """Least milliseconds the card could take for one call at these shapes:
    the bytes the function needs, each read once and each output written
    once, over HBM bandwidth, against the float32 operations it needs over
    the float32 peak. ``route`` needs one bin of each row whose node
    splits (``bins_read``, from this run's data), not the whole matrix. A
    forest's ``trees`` share the bins and each has its own nodes, channels
    and output; its split search reads each node's feature scores."""
    F, B, K, T = FEATURES, MAX_BINS, channels, trees
    if name == "apply_bins":      # X, thresholds -> int8 bins; a 5-step search
        bytes_moved = rows * F * 4 + F * (B - 1) * 4 + rows * F
        ops = rows * F * int(np.ceil(np.log2(B)))
    elif name == "level_histograms":   # bins, node, channels -> histogram
        bytes_moved = rows * F + T * (rows * 4 + rows * K * 4 + n_nodes * F * B * K * 4)
        ops = T * rows * F * K
    elif name == "select_splits":  # histogram -> feature, bin; ~5 ops a channel
        bytes_moved = T * n_nodes * (F * B * K * 4 + 8 + (F * 4 if subsets else 0))
        ops = T * n_nodes * F * B * (5 * K + 5)
    elif name == "route":          # node, a bin per split row, split -> node
        bytes_moved = T * (rows * 4 * 2 + n_nodes * 8) + bins_read
        ops = T * rows * 2
    else:                          # leaf_sums: leaf, channels -> sums
        bytes_moved = T * (rows * 4 + rows * K * 4 + n_nodes * K * 4)
        ops = T * rows * K
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _fit_channels(torch, y_dev, seed: int) -> dict:
    """A fit's channels on the card: class one-hots (dt, gini) and the
    (g, h) pairs of a boosting round at seeded margins (gb, newton)."""
    rng = np.random.default_rng(seed)
    margins = torch.from_numpy(rng.normal(size=y_dev.shape[0]).astype(np.float32)).to(y_dev.device)
    p = torch.sigmoid(margins)
    g = p - y_dev.to(torch.float32)
    h = (p * (1 - p)).clamp(min=1e-6)
    one_hot = torch.nn.functional.one_hot(y_dev.long(), CLASSES).to(torch.float32)
    return {"gini": one_hot.contiguous(), "newton": torch.stack([g, h], dim=1)}


def _sums_error(name: str, mode: str, got, want) -> float:
    """Counts (dt) must be identical; gb sums agree within GB_SUM_RTOL of
    each cell. Returns the largest absolute difference."""
    if got.shape != want.shape or not bool(got.isfinite().all()):
        raise AssertionError(f"{name} ({mode}): bad output {tuple(got.shape)}")
    difference = (got - want).abs()
    if mode == "gini" and bool((difference > 0).any()):
        raise AssertionError(f"{name} (gini): class counts differ")
    relative = float((difference / want.abs().clamp(min=1e-30)).max())
    if relative > GB_SUM_RTOL:
        raise AssertionError(f"{name} ({mode}): relative difference {relative}")
    return float(difference.max())


def check_fit_kernels(torch, X_dev, y_dev, thresholds, seed: int = 5) -> dict:
    """Each fit kernel against its plain version on the same inputs, at
    every level of a depth-DEPTH tree grown by the plain versions, for dt
    and gb channels. Returns each kernel's largest difference and the
    inputs of each (mode, level) for timing."""
    errors = {name: 0.0 for name in FIT_REPLACES}
    # searchsorted(side="left") at its edges: NaN past every threshold (inf
    # ones too), +inf at the first inf threshold, -inf and -0.0 in bin 0
    edges = torch.tensor([[0.0, 1.0, 2.0, np.inf, np.inf]], device=X_dev.device)
    values = torch.tensor(
        [[np.nan], [np.inf], [-np.inf], [-0.0], [0.0], [2.0], [0.5], [3.0]], device=X_dev.device
    )
    expected = [5, 3, 0, 0, 0, 2, 1, 3]
    for apply in (binning.apply_bins, binning._apply_bins):
        if apply(values, edges)[:, 0].tolist() != expected:
            raise AssertionError(f"{apply.__name__}: edge values binned {apply(values, edges)[:, 0].tolist()}")
    bins = binning.apply_bins(X_dev, thresholds)
    if not torch.equal(bins, binning._apply_bins(X_dev, thresholds)):
        raise AssertionError("apply_bins: bins differ")
    cases = {}
    for mode, channels in _fit_channels(torch, y_dev, seed).items():
        node = torch.zeros(X_dev.shape[0], dtype=torch.int32, device=X_dev.device)
        for level in range(DEPTH):
            n_nodes = 2**level
            hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS)
            plain_hist = trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS)
            errors["level_histograms"] = max(
                errors["level_histograms"], _sums_error("level_histograms", mode, hist, plain_hist)
            )
            feature, bin_index = trees.select_splits(plain_hist, mode)
            plain_feature, plain_bin = trees._select_plain(plain_hist, mode)
            if not (torch.equal(feature, plain_feature) and torch.equal(bin_index, plain_bin)):
                raise AssertionError(f"select_splits ({mode}, level {level}): splits differ")
            routed = trees.route(bins, node, plain_feature, plain_bin)
            plain_routed = trees._route(bins, node, plain_feature, plain_bin)
            if not torch.equal(routed, plain_routed):
                raise AssertionError(f"route ({mode}, level {level}): nodes differ")
            # the one-tree calls of dt and gb are a forest of one, bit for bit
            split = trees.select_splits(plain_hist[None], mode)
            if not (
                torch.equal(trees.level_histograms(bins, node[None], channels[None], n_nodes, MAX_BINS)[0], hist)
                and torch.equal(split[0][0], feature) and torch.equal(split[1][0], bin_index)
                and torch.equal(trees.route(bins, node[None], plain_feature[None], plain_bin[None])[0], routed)
            ):
                raise AssertionError(f"{mode}, level {level}: a tree axis of 1 changes the bits")
            cases[(mode, level)] = (node, channels, plain_hist, plain_feature, plain_bin)
            node = plain_routed
        sums = trees.leaf_sums(node, channels, 2**DEPTH)
        plain_sums = trees._leaf_sums(node, channels, 2**DEPTH)
        errors["leaf_sums"] = max(errors["leaf_sums"], _sums_error("leaf_sums", mode, sums, plain_sums))
        if not torch.equal(trees.leaf_sums(node[None], channels[None], 2**DEPTH)[0], sums):
            raise AssertionError(f"leaf_sums ({mode}): a tree axis of 1 changes the bits")
        cases[(mode, DEPTH)] = (node, channels, None, None, None)
    return {"errors": errors, "bins": bins, "cases": cases}


def _card_draws(torch, rows: int, seed: int, device):
    """A forest's draws on the card, as the rf estimator makes them."""
    generator = torch.Generator(device=device).manual_seed(seed)
    return trees._forest_draws(TREES, rows, DEPTH, FEATURES, generator, device)


def check_forest_kernels(torch, bins, y_dev, seed: int = 6) -> dict:
    """K2, K4 and K5 over a forest's tree axis and K3 with its feature
    subsets against their plain versions, at every level of a depth-DEPTH
    forest of TREES trees grown by the plain versions from seeded draws:
    counts, splits and routes identical. A tree's histogram in the forest
    launch equals the launch of that tree alone, bit for bit. Then K3 on
    tied scores, on a node whose every allowed gain is -inf and with a NaN
    outside the subset, and K2 at a windowed level of the forest. Returns
    each kernel's largest difference and the inputs of each level for
    timing."""
    errors = {name: 0.0 for name in FOREST_KERNELS}
    rows = bins.shape[0]
    draws = _card_draws(torch, rows, seed, bins.device)
    one_hot = torch.nn.functional.one_hot(y_dev.long(), CLASSES).to(torch.float32)
    channels = (one_hot[None] * draws.bootstrap[:, :, None]).contiguous()
    node = torch.zeros((TREES, rows), dtype=torch.int32, device=bins.device)
    cases = {}
    for level in range(DEPTH):
        n_nodes = 2**level
        hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS)
        plain_hist = trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS)
        errors["level_histograms"] = max(
            errors["level_histograms"], _sums_error("level_histograms (forest)", "gini", hist, plain_hist)
        )
        for tree in (0, TREES - 1):
            alone = trees.level_histograms(bins, node[tree], channels[tree], n_nodes, MAX_BINS)
            if not torch.equal(alone, hist[tree]):
                raise AssertionError(f"level_histograms (forest, level {level}): tree {tree} differs alone")
        scores = draws.subset_scores[:, n_nodes - 1 : 2 * n_nodes - 1]
        feature, bin_index = trees.select_splits(plain_hist, "gini", scores, SUBSET_K)
        plain_feature, plain_bin = trees._select_plain(plain_hist, "gini", scores, SUBSET_K)
        if not (torch.equal(feature, plain_feature) and torch.equal(bin_index, plain_bin)):
            raise AssertionError(f"select_splits (forest, level {level}): splits differ")
        routed = trees.route(bins, node, plain_feature, plain_bin)
        plain_routed = trees._route(bins, node, plain_feature, plain_bin)
        if not torch.equal(routed, plain_routed):
            raise AssertionError(f"route (forest, level {level}): nodes differ")
        cases[level] = (node, channels, plain_hist, scores, plain_feature, plain_bin)
        node = plain_routed
    sums = trees.leaf_sums(node, channels, 2**DEPTH)
    plain_sums = trees._leaf_sums(node, channels, 2**DEPTH)
    errors["leaf_sums"] = _sums_error("leaf_sums (forest)", "gini", sums, plain_sums)
    cases[DEPTH] = (node, channels, None, None, None, None)
    special = _check_subset_edges(torch, cases[DEPTH - 1][2], cases[DEPTH - 1][3])
    wide = _check_wide_forest_level(torch, bins[:WIDE_FOREST_ROWS])
    errors["level_histograms"] = max(errors["level_histograms"], wide.pop("max_abs_err"))
    return {"errors": errors, "cases": cases, "subset_edges": special, "wide_level": wide}


def _check_subset_edges(torch, hist, scores) -> dict:
    """K3 against its plain version on a forest level's histogram where
    the plain version's sort meets ties (scores in steps of 1/8), where
    tree 0's node 0 has no rows in its allowed features (every allowed
    gain -inf: a leaf at bin 0), and under newton with a NaN in a feature
    outside node 0's subset (-inf there, so no NaN wins)."""
    tied = (scores * 8).floor() / 8
    kth = torch.sort(tied, dim=-1).values[..., SUBSET_K - 1 : SUBSET_K]
    allowed = tied <= kth
    empty = hist.clone()
    empty[0, 0][allowed[0, 0]] = 0.0
    rng = np.random.default_rng(4)
    newton = torch.from_numpy(rng.random(tuple(hist.shape[:-1]) + (2,), dtype=np.float32)).to(hist.device)
    newton[..., 0] -= 0.5
    outside = int(torch.nonzero(~allowed[0, 0])[0, 0])
    newton[0, 0, outside, 3, 0] = float("nan")
    outcomes = {}
    for name, values, mode in (("ties", hist, "gini"), ("empty_node", empty, "gini"), ("nan_outside", newton, "newton")):
        got = trees.select_splits(values, mode, tied, SUBSET_K)
        want = trees._select_plain(values, mode, tied, SUBSET_K)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"select_splits (forest, {name}): splits differ")
        outcomes[name] = {"leaf_nodes": int((got[0] < 0).sum()), "nodes": int(got[0].numel())}
    empty_split = trees.select_splits(empty, "gini", tied, SUBSET_K)
    if (int(empty_split[0][0, 0]), int(empty_split[1][0, 0])) != (-1, 0):
        raise AssertionError("select_splits (forest, empty_node): not a leaf at bin 0")
    ties = int((tied[..., None, :] == tied[..., :, None]).sum() - tied.numel())
    return {"tied_score_pairs": ties, **outcomes}


def _check_wide_forest_level(torch, bins) -> dict:
    """K2 over the forest's trees at a 2,048-node level of 10 classes
    (windows of nodes past one block's shared memory), counts identical
    to the plain version; one cold call timed."""
    rows, deep = bins.shape[0], 2 ** (DEEP_DEPTH - 1)
    rng = np.random.default_rng(12)
    node = torch.from_numpy(rng.integers(0, deep, (TREES, rows)).astype(np.int32)).to(bins.device)
    bootstrap = torch.from_numpy(rng.poisson(1.0, (TREES, rows)).astype(np.float32)).to(bins.device)
    labels = torch.from_numpy(rng.integers(0, DEEP_CLASSES, rows)).to(bins.device)
    one_hot = torch.nn.functional.one_hot(labels, DEEP_CLASSES).to(torch.float32)
    channels = (one_hot[None] * bootstrap[:, :, None]).contiguous()
    hist = trees.level_histograms(bins, node, channels, deep, MAX_BINS)
    plain = trees._level_histograms(bins, node, channels, deep, MAX_BINS)
    error = _sums_error("level_histograms (forest, 2,048 nodes)", "gini", hist, plain)
    del hist, plain
    tiling = trees._block_features(FEATURES, deep, MAX_BINS, DEEP_CLASSES, 1)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=bins.device)
    return {
        "rows": rows, "trees": TREES, "nodes": deep, "channels": DEEP_CLASSES,
        "windows": len(trees._windows(deep, tiling.nodes)), "max_abs_err": error,
        "ms": _event_ms(torch, lambda: trees.level_histograms(bins, node, channels, deep, MAX_BINS), 2, flush),
    }


def ten_classes(X: np.ndarray, seed: int = 3) -> np.ndarray:
    """Ten roughly balanced classes of bench.py's rows: deciles of the
    same noisy score that makes its two classes."""
    rng = np.random.default_rng(seed)
    score = X[:, 0] + X[:, 1] * 0.5 + rng.random(X.shape[0], dtype=np.float32) * 8
    return np.digitize(score, np.quantile(score, np.linspace(0.1, 0.9, 9))).astype(np.int32)


def check_repairs(torch, X: np.ndarray, y: np.ndarray) -> dict:
    """The kernels at the shapes past their former limits, against their
    plain versions on the same inputs: int32 bins (255 bins), a 2,048-node
    level and 4,096 leaves (windows of shared memory), and forests whose
    heaps do not fit a block together (20 trees of depth 10) or at all (a
    depth-12 tree of 20 classes)."""
    record = {}
    X_dev = torch.from_numpy(X).cuda()
    y10 = torch.from_numpy(ten_classes(X).astype(np.int64)).cuda()
    # R1: 255 bins, int32
    thresholds = torch.from_numpy(binning.make_thresholds(X, 255).astype(np.float32)).cuda()
    bins = binning.apply_bins(X_dev, thresholds)
    if bins.dtype != torch.int32 or not torch.equal(bins, binning._apply_bins(X_dev, thresholds)):
        raise AssertionError("apply_bins at 255 bins: bins differ (or are not int32)")
    channels = _fit_channels(torch, y10 % 2, seed=8)
    channels["gini"] = torch.nn.functional.one_hot(y10, DEEP_CLASSES).to(torch.float32)
    node = torch.zeros(X.shape[0], dtype=torch.int32, device=X_dev.device)
    errors = {"level_histograms": 0.0, "leaf_sums": 0.0}
    for level in range(4):
        plain = {}
        for mode, values in channels.items():
            hist = trees.level_histograms(bins, node, values, 2**level, 255)
            plain[mode] = trees._level_histograms(bins, node, values, 2**level, 255)
            errors["level_histograms"] = max(
                errors["level_histograms"],
                _sums_error("level_histograms (255 bins)", mode, hist, plain[mode]),
            )
        feature, bin_index = trees._select_plain(plain["newton"], "newton")
        routed = trees.route(bins, node, feature, bin_index)
        if not torch.equal(routed, trees._route(bins, node, feature, bin_index)):
            raise AssertionError(f"route at 255 bins, level {level}: nodes differ")
        node = routed
    record["bins_255"] = {"int32": True, "levels": 4, "max_abs_err": errors["level_histograms"]}
    # R2: a depth-12 level and 4,096 leaves
    bins = binning.apply_bins(X_dev, torch.from_numpy(binning.make_thresholds(X).astype(np.float32)).cuda())
    rng = np.random.default_rng(9)
    deep = 2 ** (DEEP_DEPTH - 1)
    node = torch.from_numpy(rng.integers(0, deep, X.shape[0]).astype(np.int32)).cuda()
    leaf = torch.from_numpy(rng.integers(0, 2 * deep, X.shape[0]).astype(np.int32)).cuda()
    timings = {}
    for mode, values in channels.items():
        K = values.shape[1]
        hist = trees.level_histograms(bins, node, values, deep, MAX_BINS)
        plain = trees._level_histograms(bins, node, values, deep, MAX_BINS)
        errors["level_histograms"] = max(
            errors["level_histograms"], _sums_error("level_histograms (2,048 nodes)", mode, hist, plain)
        )
        tiling = trees._block_features(FEATURES, deep, MAX_BINS, K, 1)
        timings[f"level_histograms:{deep}x{K}"] = {
            "ms": _event_ms(torch, lambda: trees.level_histograms(bins, node, values, deep, MAX_BINS), 3),
            "windows": len(trees._windows(deep, tiling.nodes)),
        }
    sums = trees.leaf_sums(leaf, channels["gini"], 2 * deep)
    plain = trees._leaf_sums(leaf, channels["gini"], 2 * deep)
    errors["leaf_sums"] = _sums_error("leaf_sums (4,096 leaves)", "gini", sums, plain)
    timings[f"leaf_sums:{2 * deep}x{DEEP_CLASSES}"] = {
        "ms": _event_ms(torch, lambda: trees.leaf_sums(leaf, channels["gini"], 2 * deep), 3),
        "windows": len(trees._windows(2 * deep, trees._leaf_warps(2 * deep, DEEP_CLASSES).leaves)),
    }
    record["wide_levels"] = {"max_abs_err": errors, "timings": timings}
    # R3: forests past a block's shared memory, bit-equal to the plain forward
    forests = {}
    for count, depth, classes in ((TREES, 10, CLASSES), (1, DEEP_DEPTH, 20)):
        fh, th, lp, lv = _forest(torch, X, count, depth, classes, seed=count + depth)
        calls = {
            "tree_ensemble_forward": (
                lambda: trees.ensemble_forward(X_dev, fh, th, lp, depth),
                lambda: trees._ensemble_forward(X_dev, fh, th, lp, depth),
            ),
            "gbt_forward": (
                lambda: trees.gbt_forward(X_dev, -0.2, fh, th, lv, STEP, depth),
                lambda: trees._gbt_forward(X_dev, -0.2, fh, th, lv, STEP, depth),
            ),
        }
        for name, (kernel, plain) in calls.items():
            if not torch.equal(kernel(), plain()):
                raise AssertionError(f"{name} at {count} trees of depth {depth}: not bit-equal")
            forests[f"{name}:{count}x{depth}x{classes}"] = {"ms": _event_ms(torch, kernel, 3)}
    record["forests"] = {"bit_equal": True, "timings": forests}
    return record


def _forest(torch, X, count, depth, classes, seed):
    """Heaps of ``count`` trees of ``depth`` on ``X``'s features, as a fit
    writes them, and their leaf parameters, on the card."""
    rng = np.random.default_rng(seed)
    thresholds = binning.make_thresholds(X[:4096]).astype(np.float32)
    features_heap, thresholds_heap = _heaps(rng, thresholds, count, depth, leaf_rate=0.02)
    leaves = 2**depth
    leaf_probs = rng.dirichlet(np.ones(classes), size=(count, leaves)).astype(np.float32)
    leaf_values = rng.normal(size=(count, leaves)).astype(np.float32)
    return tuple(
        torch.from_numpy(array).cuda()
        for array in (features_heap, thresholds_heap, leaf_probs, leaf_values)
    )


def _k7_bound(rows: int, features: int, classes: int, trial: bool) -> tuple[float, str]:
    """Least milliseconds for one K7 call: X and y read once (the
    parameters and outputs are bytes beside them) over HBM bandwidth,
    against its operations at their type's peak: per row and candidate
    2FC float32 for the logits and ~4C for the softmax, and for the
    gradient 2FC + 2C float64."""
    F, C = features, classes
    candidates = 4 if trial else 1
    params = candidates * (F * C + C) * 4
    bytes_moved = rows * F * 4 + rows * 4 + params + (candidates if trial else F * C + C + 1) * 4
    fp32_ops = rows * candidates * (2 * F * C + 4 * C)
    fp64_ops = 0 if trial else rows * (2 * F * C + 2 * C + 1)
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = (fp32_ops / PEAK_FP32_OPS_PER_S + fp64_ops / PEAK_FP64_OPS_PER_S) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_logistic_kernels(torch, X: np.ndarray, y: np.ndarray, flush) -> dict:
    """K7's two entry points against the plain twin at the fit's shape:
    bench.py's rows standardized by scaler_stats, 2 and 10 classes, at a
    seeded mid-fit point, reg 0 and 0.1. Times at reg 0: cold (L2
    overwritten before each call) and warm (back to back)."""
    mean, scale = logistic.scaler_stats(X)
    X_dev = torch.from_numpy(logistic._standardized(X, mean, scale)).cuda()
    rows = X.shape[0]
    results = {name: {"max_abs_err": 0.0, "by_classes": {}} for name in LOGISTIC_REPLACES}
    for classes, labels in ((CLASSES, y), (DEEP_CLASSES, ten_classes(X))):
        rng = np.random.default_rng(classes)
        y_dev = torch.from_numpy(labels.astype(np.int32)).cuda()

        def cuda(*shape, scale_by=0.3):
            return torch.from_numpy((rng.normal(size=shape) * scale_by).astype(np.float32)).cuda()

        W, b, D, d = cuda(FEATURES, classes), cuda(classes), cuda(FEATURES, classes), cuda(classes)
        steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=X_dev.device)
        W4 = (W[None] + steps[:, None, None] * D[None]).contiguous()
        b4 = (b[None] + steps[:, None] * d[None]).contiguous()
        for l2 in (0.0, 0.1):
            got = logistic.loss_and_grad(W, b, X_dev, y_dev, l2)
            want = logistic._loss_fn(W, b, X_dev, y_dev, l2)
            again = logistic.loss_and_grad(W, b, X_dev, y_dev, l2)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"logistic_loss_grad ({classes} classes): a second launch differs")
            loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
            grad_err = max(float((got[i] - want[i]).abs().max()) for i in (1, 2))
            if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
                raise AssertionError(
                    f"logistic_loss_grad ({classes} classes, l2 {l2}): loss {loss_rel} "
                    f"relative, gradient {grad_err}"
                )
            trial = logistic.trial_losses(W4, b4, X_dev, y_dev, l2)
            plain_trial = logistic._trial_losses(W4, b4, X_dev, y_dev, l2)
            if not torch.equal(trial, logistic.trial_losses(W4, b4, X_dev, y_dev, l2)):
                raise AssertionError(f"logistic_trial_losses ({classes} classes): a second launch differs")
            trial_rel = float(((trial - plain_trial).abs() / plain_trial.abs()).max())
            if not trial_rel <= K7_LOSS_RTOL:
                raise AssertionError(f"logistic_trial_losses ({classes} classes, l2 {l2}): {trial_rel} relative")
            results["logistic_loss_grad"]["max_abs_err"] = max(
                results["logistic_loss_grad"]["max_abs_err"],
                grad_err, abs(float(got[0]) - float(want[0])),
            )
            results["logistic_trial_losses"]["max_abs_err"] = max(
                results["logistic_trial_losses"]["max_abs_err"], float((trial - plain_trial).abs().max())
            )
        calls = {
            "logistic_loss_grad": (
                lambda: logistic.loss_and_grad(W, b, X_dev, y_dev, 0.0),
                lambda: logistic._loss_fn(W, b, X_dev, y_dev, 0.0),
            ),
            "logistic_trial_losses": (
                lambda: logistic.trial_losses(W4, b4, X_dev, y_dev, 0.0),
                lambda: logistic._trial_losses(W4, b4, X_dev, y_dev, 0.0),
            ),
        }
        for name, (kernel, plain) in calls.items():
            bound_ms, bound_by = _k7_bound(rows, FEATURES, classes, name == "logistic_trial_losses")
            results[name]["by_classes"][classes] = {
                "ms": _event_ms(torch, kernel, 20, flush),
                "warm_ms": _event_ms(torch, kernel, 50),
                "device_ms": _device_ms(torch, kernel, DEVICE_KERNELS[name], 20, flush),
                "plain_ms": _event_ms(torch, plain, 3, flush),
                # no single PyTorch call computes the mean nll with its
                # gradient, or at four parameter sets
                "library_ms": None,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
    for result in results.values():
        # the main path's shape: bench.py's two classes
        result.update(result["by_classes"][CLASSES])
    return results


def phase_fit_kernels(torch) -> dict:
    X, y = bench_synthetic(FIT_ROWS)
    thresholds_np = binning.make_thresholds(X).astype(np.float32)
    thresholds_np[3, -2:] = np.inf  # a feature with repeated inf thresholds
    # values binning must place exactly, among the rows
    X[:4, 0] = [np.nan, np.inf, -np.inf, -0.0]
    X[4:6, 1] = thresholds_np[1, 7:9]
    X[6:8, 3] = [np.inf, np.nan]
    X_dev = torch.from_numpy(X).cuda()
    y_dev = torch.from_numpy(y.astype(np.int64)).cuda()
    thresholds = torch.from_numpy(thresholds_np).cuda()
    checked = check_fit_kernels(torch, X_dev, y_dev, thresholds)
    bins, cases = checked["bins"], checked["cases"]
    rows = X.shape[0]
    results = {name: {"max_abs_err": checked["errors"][name], "by_level": {}} for name in FIT_REPLACES}
    # every call timed with a cold L2: the bounds count HBM bytes, and the
    # inputs of K2, K4 and K5 (28, 21 and 12 MB) would otherwise stay in L2
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=X_dev.device)

    def timed(name, key, kernel, plain, library, n_nodes, channels, bins_read=0, trees_=1):
        bound_ms, bound_by = _fit_bound(
            name, rows, n_nodes, channels, bins_read, trees_, subsets=trees_ > 1
        )
        into = results[name]["forest"] if trees_ > 1 else results[name]
        into["by_level"][key] = {
            "ms": _event_ms(torch, kernel, 20, flush),
            "device_ms": _device_ms(torch, kernel, DEVICE_KERNELS[name], 20, flush),
            "plain_ms": _event_ms(torch, plain, 3, flush),
            "library_ms": None if library is None else _event_ms(torch, library, 3, flush),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }

    X_columns = X_dev.T.contiguous()
    timed(
        "apply_bins", "all",
        lambda: binning.apply_bins(X_dev, thresholds),
        lambda: binning._apply_bins(X_dev, thresholds),
        lambda: torch.searchsorted(thresholds, X_columns, side="left"),
        1, 1,
    )
    feature_offsets = torch.arange(FEATURES, device=bins.device) * MAX_BINS
    for (mode, level), (node, channels, hist, feature, bin_index) in cases.items():
        key = f"{mode}:{level}"
        K = channels.shape[1]
        if level == DEPTH:
            n_leaves = 2**DEPTH
            leaf = node.long()
            timed(
                "leaf_sums", key,
                lambda: trees.leaf_sums(node, channels, n_leaves),
                lambda: trees._leaf_sums(node, channels, n_leaves),
                lambda: [torch.bincount(leaf, weights=channels[:, k], minlength=n_leaves) for k in range(K)],
                n_leaves, K,
            )
            continue
        n_nodes = 2**level
        flat = (node.long()[:, None] * (FEATURES * MAX_BINS) + feature_offsets + bins.long()).reshape(-1)
        weights = [channels[:, k : k + 1].expand(rows, FEATURES).reshape(-1) for k in range(K)]
        timed(
            "level_histograms", key,
            lambda: trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS),
            lambda: trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS),
            lambda: [torch.bincount(flat, weights=w, minlength=n_nodes * FEATURES * MAX_BINS) for w in weights],
            n_nodes, K,
        )
        timed(
            "select_splits", key,
            lambda: trees.select_splits(hist, mode),
            lambda: trees._select_plain(hist, mode),
            None, n_nodes, K,
        )
        # the rows whose node splits: each needs one bin
        bins_read = int((feature.long()[node.long()] >= 0).sum())
        timed(
            "route", key,
            lambda: trees.route(bins, node, feature, bin_index),
            lambda: trees._route(bins, node, feature, bin_index),
            None, n_nodes, K, bins_read,
        )
    forest = check_forest_kernels(torch, bins, y_dev)
    for name in FOREST_KERNELS:
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], forest["errors"][name])
        results[name]["forest"] = {
            "trees": TREES, "subset_k": SUBSET_K, "max_abs_err": forest["errors"][name], "by_level": {},
        }
    tree_ids = torch.arange(TREES, device=bins.device)[:, None]
    for level, (node, channels, hist, scores, feature, bin_index) in forest["cases"].items():
        key, K = f"rf:{level}", channels.shape[2]
        if level == DEPTH:
            n_leaves = 2**DEPTH
            index = (tree_ids * n_leaves + node.long()).reshape(-1)
            weights = [channels[:, :, k].reshape(-1) for k in range(K)]
            timed(
                "leaf_sums", key,
                lambda: trees.leaf_sums(node, channels, n_leaves),
                lambda: trees._leaf_sums(node, channels, n_leaves),
                lambda: [torch.bincount(index, weights=w, minlength=TREES * n_leaves) for w in weights],
                n_leaves, K, trees_=TREES,
            )
            continue
        n_nodes = 2**level
        flat = (
            ((tree_ids * n_nodes + node.long())[:, :, None] * (FEATURES * MAX_BINS))
            + feature_offsets + bins.long()[None]
        ).reshape(-1)
        weights = [channels[:, :, k : k + 1].expand(TREES, rows, FEATURES).reshape(-1) for k in range(K)]
        cells = TREES * n_nodes * FEATURES * MAX_BINS
        timed(
            "level_histograms", key,
            lambda: trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS),
            lambda: trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS),
            lambda: [torch.bincount(flat, weights=w, minlength=cells) for w in weights],
            n_nodes, K, trees_=TREES,
        )
        del flat, weights
        timed(
            "select_splits", key,
            lambda: trees.select_splits(hist, "gini", scores, SUBSET_K),
            lambda: trees._select_plain(hist, "gini", scores, SUBSET_K),
            None, n_nodes, K, trees_=TREES,
        )
        # the (tree, row) pairs whose node splits: each needs one bin
        bins_read = int((feature.long().gather(1, node.long()) >= 0).sum())
        timed(
            "route", key,
            lambda: trees.route(bins, node, feature, bin_index),
            lambda: trees._route(bins, node, feature, bin_index),
            None, n_nodes, K, bins_read, trees_=TREES,
        )
    for result in results.values():
        # a fit's mean call: over the levels, dt and gb channels alike (the
        # forest's apart)
        for into in (result, result.get("forest")):
            if into is None:
                continue
            levels = list(into["by_level"].values())
            for field in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                values = [level[field] for level in levels]
                into[field] = None if None in values else sum(values) / len(values)
            into["bound_by"] = levels[0]["bound_by"]
    forest_checks = {"subset_edges": forest["subset_edges"], "wide_level": forest["wide_level"]}
    X, y = bench_synthetic(FIT_ROWS)
    repairs = check_repairs(torch, X, y)
    results.update(check_logistic_kernels(torch, X, y, flush))
    emit({
        "phase": "fit-kernels", "rows": rows, "features": FEATURES, "max_bins": MAX_BINS,
        **results, "repairs": repairs, "forest_checks": forest_checks,
    })
    return results


def _fit_launches(before: dict, after: dict) -> dict:
    return {name: after[name] - before[name] for name in FIT_KERNELS}


@contextlib.contextmanager
def _plain_level_loop():
    """Within the block, the fits of ``trees`` run the level loop's plain
    versions in place of its kernels, on any device: the yardstick that a
    fit by the kernels is held to. Raises if a kernel launched."""
    with _plain(trees, {
        "level_histograms": trees._level_histograms,
        "select_splits": trees._select_plain,
        "route": trees._route,
        "leaf_sums": trees._leaf_sums,
    }):
        yield


@contextlib.contextmanager
def _plain_k7():
    """Within the block, the lr fit runs K7's plain twin in place of the
    kernel, on any device. Raises if a kernel launched."""
    with _plain(logistic, {
        "loss_and_grad": logistic._loss_fn,
        "trial_losses": logistic._trial_losses,
    }):
        yield


@contextlib.contextmanager
def _plain(module, plain: dict):
    wrappers = {name: getattr(module, name) for name in plain}
    before = kernels.launches()
    for name, function in plain.items():
        setattr(module, name, function)
    try:
        yield
    finally:
        for name, function in wrappers.items():
            setattr(module, name, function)
    if kernels.launches() != before:
        raise AssertionError("a plain-version fit launched a kernel")


def _tree_launches(depth: int, rounds: int = 1) -> dict:
    return {
        "apply_bins": 1, "level_histograms": depth * rounds, "select_splits": depth * rounds,
        "route": depth * rounds, "leaf_sums": rounds,
        "logistic_loss_grad": 0, "logistic_trial_losses": 0,
    }


def phase_fit(torch, card: str) -> dict:
    X, y = bench_synthetic(FIT_ROWS)
    rows = X.shape[0]
    started = time.perf_counter()
    thresholds_np = binning.make_thresholds(X)
    thresholds_s = time.perf_counter() - started
    torch.cuda.synchronize()
    started = time.perf_counter()
    X_dev = torch.from_numpy(X).cuda()
    y_dev = torch.from_numpy(y.astype(np.int64)).cuda()
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - started

    # the main path: fit, evaluate, save, serve
    models, record = {}, {"phase": "fit", "rows": rows, "features": FEATURES}
    no_launches = {name: 0 for name in FIT_KERNELS}
    expected = {
        "dt": _tree_launches(DEPTH),
        # the 20 trees in one chunk: one launch a level for all of them
        "rf": _tree_launches(DEPTH),
        "gb": _tree_launches(DEPTH, GBT_ROUNDS),
        "lr": None,   # from the direct fit's iterations, below
        "nb": no_launches,
    }
    kernels.reset_launches()
    for name in ("dt", "rf", "gb", "lr", "nb"):
        before = kernels.launches()
        torch.cuda.synchronize()
        started = time.perf_counter()
        model = make_classifier(name).fit(X, y)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - started
        launches = _fit_launches(before, kernels.launches())
        if expected[name] is not None and launches != expected[name]:
            raise AssertionError(f"{name} fit launched {launches}, expected {expected[name]}")
        accuracy, weighted_f1, labels, probs = model.evaluate_predict(X, y, X)
        if probs.shape != (rows, CLASSES) or not np.isfinite(probs).all():
            raise AssertionError(f"{name}: probabilities of shape {probs.shape}")
        if not 0.5 < accuracy <= 1.0:
            raise AssertionError(f"{name}: accuracy {accuracy}")
        models[name] = model
        record[name] = {
            "wall_s": wall_s,
            "launches": launches,
            "accuracy": accuracy,
            "weighted_f1": weighted_f1,
        }
        if name in ("dt", "rf", "gb"):
            record[name].update(host_thresholds_s=thresholds_s, h2d_s=h2d_s)
    serve_rows = bench_rows(np.random.default_rng(13), 8)
    with tempfile.TemporaryDirectory() as models_dir:
        for name, model in models.items():
            save_model(model, checkpoint_path(models_dir, f"{name}_fit"))
        plane = ServePlane()
        server = ServerThread(create_app(models_dir=models_dir, serve=plane)).start()
        try:
            client = _Client(server.port)
            for name, model in models.items():
                status, body = client.call("POST", f"/models/{name}_fit/predict", {"rows": serve_rows.tolist()})
                tolerance = LINEAR_TOL if name in ("lr", "nb") else TREE_TOL
                _check_answer(name, status, body, serve_rows, model.predict_proba(serve_rows), tolerance)
        finally:
            server.stop()
            plane.close()
    torch.cuda.synchronize()
    record["launches"] = kernels.launches()
    missing = [name for name in FIT_KERNELS if record["launches"][name] == 0]
    if missing:
        raise AssertionError(f"the fit path never launched {missing}")

    check_tree_fits(torch, X, y, X_dev, y_dev, thresholds_np, models, record)
    check_rf_fit(torch, X, y, X_dev, y_dev, thresholds_np, models["rf"], record)
    check_lr_fit(torch, X, y, models["lr"], record)
    check_nb_fit(torch, X, y, models["nb"], record)
    record["dt_deep"] = check_deep_dt(torch, X)
    record["K9"] = time_metrics(torch, y_dev)
    # the device's share of a fit's wall time: the trace's kernel time of
    # one more fit through the estimator
    for name in models:
        record[name]["device_busy_ms"] = _busy_ms(torch, lambda: make_classifier(name).fit(X, y))
    record["host_syncs_in_fit_loops"] = 0
    record["nvidia_smi"] = card
    emit(record)
    return record


def check_tree_fits(torch, X, y, X_dev, y_dev, thresholds_np, models, record) -> None:
    """dt and gb held against fits by the plain versions on the card; gb
    refit bit for bit; no host sync in a level or boosting loop."""
    rows = X.shape[0]
    thresholds = torch.from_numpy(thresholds_np.astype(np.float32)).cuda()
    weights = torch.ones(rows, dtype=torch.float32, device=X_dev.device)
    plain_bins = binning._apply_bins(X_dev, thresholds)
    with _plain_level_loop():
        features_heap, bins_heap, leaf_probs = trees._dt_fit(
            plain_bins, y_dev, weights, CLASSES, DEPTH, MAX_BINS
        )
    plain_dt = trees._TreeEnsembleModel(
        features_heap[None], trees._heap_thresholds(features_heap, bins_heap, thresholds)[None],
        leaf_probs[None], DEPTH,
    )
    dt = models["dt"]
    if not (
        torch.equal(dt.features_heap, plain_dt.features_heap)
        and torch.equal(dt.thresholds_heap, plain_dt.thresholds_heap)
        and torch.equal(dt.leaf_probs, plain_dt.leaf_probs)
    ):
        raise AssertionError("dt: the kernels' heaps differ from the plain-version fit")
    plain_metrics = plain_dt.evaluate_predict(X, y, X)[:2]
    if plain_metrics != (record["dt"]["accuracy"], record["dt"]["weighted_f1"]):
        raise AssertionError(f"dt: metrics {plain_metrics} of the plain-version fit differ")

    bins = binning.apply_bins(X_dev, thresholds)

    def gb_fit():
        return trees._gbt_fit(bins, y_dev, weights, DEPTH, MAX_BINS, GBT_ROUNDS, GBT_STEP)

    # no host sync anywhere in a level or boosting loop: any would raise here
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = gb_fit()
        direct_dt = trees._dt_fit(bins, y_dev, weights, CLASSES, DEPTH, MAX_BINS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(direct_dt[0], dt.features_heap[0]):
        raise AssertionError("dt: the estimator's fit differs from the same fit run directly")
    second = gb_fit()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("gb: a second fit with the kernels is not bit identical")
    gb = models["gb"]
    if not (
        float(first[0]) == gb.f0
        and torch.equal(first[1], gb.features_heap)
        and torch.equal(first[3], gb.leaf_values)
    ):
        raise AssertionError("gb: the estimator's fit differs from the same fit run directly")
    with _plain_level_loop():
        plain = gb_fit()
    differing = int(((first[1] != plain[1]) | (first[2] != plain[2])).sum())
    margin_error = float((first[4] - plain[4]).abs().max())
    y_dev_f = y_dev.to(torch.float32)
    accuracy = float(((first[4] > 0).to(torch.float32) == y_dev_f).to(torch.float32).mean())
    plain_accuracy = float(((plain[4] > 0).to(torch.float32) == y_dev_f).to(torch.float32).mean())
    if margin_error > FIT_MARGIN_TOL or abs(accuracy - plain_accuracy) > FIT_MARGIN_TOL:
        raise AssertionError(
            f"gb: margins differ by {margin_error}, accuracy {accuracy} against {plain_accuracy}"
        )
    record["gb"].update(
        heap_nodes_differing_from_plain=differing,
        heap_nodes=int(first[1].numel()),
        max_margin_err=margin_error,
        train_accuracy_from_margins=accuracy,
        plain_train_accuracy_from_margins=plain_accuracy,
        rerun_bit_identical=True,
    )
    record["dt"]["heaps_identical_to_plain"] = True


def check_rf_fit(torch, X, y, X_dev, y_dev, thresholds_np, model, record) -> None:
    """The estimator's rf fit against the same fit run directly on its
    draws (made again from the seed), with host syncs made errors; a
    second fit through the estimator bit for bit; and a fit by the plain
    versions on the card from the same draws: heaps identical, leaf
    probabilities within TREE_TOL."""
    rows = X.shape[0]
    thresholds = torch.from_numpy(thresholds_np.astype(np.float32)).cuda()
    weights = torch.ones(rows, dtype=torch.float32, device=X_dev.device)
    draws = _card_draws(torch, rows, 0, X_dev.device)
    bins = binning.apply_bins(X_dev, thresholds)

    def rf_fit(level_bins):
        return trees._rf_fit(
            level_bins, y_dev, weights, draws, CLASSES, DEPTH, MAX_BINS, TREES, SUBSET_K
        )

    torch.cuda.set_sync_debug_mode("error")
    try:
        features_heap, bins_heap, leaf_probs = rf_fit(bins)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    thresholds_heap = trees._heap_thresholds(features_heap, bins_heap, thresholds)
    if not (
        torch.equal(features_heap, model.features_heap)
        and torch.equal(thresholds_heap, model.thresholds_heap)
        and torch.equal(leaf_probs, model.leaf_probs)
    ):
        raise AssertionError("rf: the estimator's fit differs from the same fit run directly")
    again = make_classifier("rf").fit(X, y)
    if not all(
        torch.equal(getattr(again, name), getattr(model, name))
        for name in ("features_heap", "thresholds_heap", "leaf_probs")
    ):
        raise AssertionError("rf: a second fit with the same seed is not bit identical")
    with _plain_level_loop():
        plain = rf_fit(binning._apply_bins(X_dev, thresholds))
    if not (torch.equal(plain[0], features_heap) and torch.equal(plain[1], bins_heap)):
        raise AssertionError("rf: the kernels' heaps differ from the plain-version fit")
    prob_error = float((plain[2] - leaf_probs).abs().max())
    if prob_error > TREE_TOL:
        raise AssertionError(f"rf: leaf probabilities differ from the plain-version fit by {prob_error}")
    record["rf"].update(
        trees=TREES,
        subset_k=SUBSET_K,
        splits=int((features_heap >= 0).sum()),
        heaps_identical_to_plain=True,
        max_leaf_prob_err_to_plain=prob_error,
        refit_bit_identical=True,
    )


def check_lr_fit(torch, X, y, model, record) -> None:
    """The estimator's lr fit against the same fit run directly (its K7
    launches: two an iteration, one a segment), a second run bit for bit,
    segments run with host syncs made errors, and a fit by the plain twin
    on the card: losses within LR_LOSS_RTOL, the same stop segment and
    probabilities within LR_PROB_TOL."""
    started = time.perf_counter()
    mean, scale = logistic.scaler_stats(X)
    X_std = logistic._standardized(X, mean, scale)
    host_scaler_s = time.perf_counter() - started
    X_dev = torch.from_numpy(X_std).cuda()
    y_dev = torch.from_numpy(y.astype(np.int32)).cuda()

    def start():
        W = torch.zeros((FEATURES, CLASSES), dtype=torch.float32, device=X_dev.device)
        return W, torch.zeros(CLASSES, dtype=torch.float32, device=X_dev.device)

    def fit():
        return logistic._fit(*start(), X_dev, y_dev, 100, 0.0)

    torch.cuda.synchronize()
    started = time.perf_counter()
    W, b, losses = fit()
    torch.cuda.synchronize()
    lbfgs_s = time.perf_counter() - started
    iterations = losses.shape[0]
    iters = logistic._segment_iters(100, X.shape[0], FEATURES, logistic._LR_TOL)
    expected = {
        **{name: 0 for name in FIT_KERNELS},
        "logistic_loss_grad": iterations + iterations // iters,
        "logistic_trial_losses": iterations,
    }
    if record["lr"]["launches"] != expected:
        raise AssertionError(f"lr fit launched {record['lr']['launches']}, expected {expected}")
    if not (torch.equal(W, model.w) and torch.equal(b, model.b)):
        raise AssertionError("lr: the estimator's fit differs from the same fit run directly")
    again = fit()
    if not all(torch.equal(a, c) for a, c in zip((W, b, losses), again)):
        raise AssertionError("lr: a second fit with the kernel is not bit identical")
    # no host sync inside a segment: the loss copy between segments is the
    # fit's one transfer
    W_s, b_s = start()
    state = logistic._lbfgs_state(W_s, b_s)
    segment_losses = []
    for _ in range(iterations // iters):
        torch.cuda.set_sync_debug_mode("error")
        try:
            W_s, b_s, state, part = logistic._fit_segment_impl(W_s, b_s, state, X_dev, y_dev, iters, 0.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        segment_losses.append(part.cpu())
    if not torch.equal(torch.cat(segment_losses), losses.cpu()):
        raise AssertionError("lr: the segments run one by one differ from the fit")
    with _plain_k7():
        plain_W, plain_b, plain_losses = fit()
    if plain_losses.shape != losses.shape:
        raise AssertionError(
            f"lr: {iterations} iterations with the kernel, {plain_losses.shape[0]} with the plain twin"
        )
    loss_rel = float(((losses - plain_losses).abs() / plain_losses.abs()).max())
    probs = logistic._forward(X_dev, W, b, 0.0, 1.0)
    plain_probs = logistic._forward(X_dev, plain_W, plain_b, 0.0, 1.0)
    prob_err = float((probs - plain_probs).abs().max())
    if loss_rel > LR_LOSS_RTOL or prob_err > LR_PROB_TOL:
        raise AssertionError(f"lr: losses {loss_rel} relative, probabilities {prob_err} from the plain fit")
    record["lr"].update(
        host_scaler_s=host_scaler_s,
        lbfgs_s=lbfgs_s,
        lbfgs_device_busy_ms=_busy_ms(torch, fit),
        iterations=iterations,
        segments=iterations // iters,
        first_loss=float(losses[0]),
        last_loss=float(losses[-1]),
        max_loss_rel_err_to_plain=loss_rel,
        max_prob_err_to_plain=prob_err,
        rerun_bit_identical=True,
    )


def check_nb_fit(torch, X, y, model, record) -> None:
    """nb's theta and prior against a float64 computation on the host, and
    a second fit bit for bit."""
    classes = int(y.max()) + 1
    sums = np.stack([X[y == c].astype(np.float64).sum(axis=0) for c in range(classes)])
    counts = np.bincount(y, minlength=classes).astype(np.float64)
    smoothed = sums + 1.0
    theta = np.log(smoothed) - np.log(smoothed.sum(axis=1, keepdims=True))
    prior = np.log(counts) - np.log(len(y))
    theta_err = float(np.abs(model.theta.cpu().numpy() - theta).max())
    prior_err = float(np.abs(model.prior.cpu().numpy() - prior).max())
    if theta_err > NB_TOL or prior_err > NB_TOL:
        raise AssertionError(f"nb: theta {theta_err}, prior {prior_err} from float64")
    again = naive_bayes.NaiveBayes().fit(X, y)
    if not (torch.equal(again.theta, model.theta) and torch.equal(again.prior, model.prior)):
        raise AssertionError("nb: a second fit is not bit identical")
    record["nb"].update(max_theta_err_to_f64=theta_err, max_prior_err_to_f64=prior_err, rerun_bit_identical=True)


def check_deep_dt(torch, X) -> dict:
    """A depth-12 dt of 10 classes (2,048 nodes at its last level, past
    one block's shared memory) through the estimator, its heaps identical
    to a fit by the plain versions on the card."""
    y10 = ten_classes(X)
    estimator = make_classifier("dt")
    estimator.max_depth = DEEP_DEPTH
    torch.cuda.synchronize()
    started = time.perf_counter()
    model = estimator.fit(X, y10)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - started
    X_dev = torch.from_numpy(X).cuda()
    y_dev = torch.from_numpy(y10.astype(np.int64)).cuda()
    thresholds = torch.from_numpy(binning.make_thresholds(X).astype(np.float32)).cuda()
    weights = torch.ones(X.shape[0], dtype=torch.float32, device=X_dev.device)
    with _plain_level_loop():
        features_heap, bins_heap, leaf_probs = trees._dt_fit(
            binning._apply_bins(X_dev, thresholds), y_dev, weights, DEEP_CLASSES, DEEP_DEPTH, MAX_BINS
        )
    if not (
        torch.equal(model.features_heap[0], features_heap)
        and torch.equal(model.thresholds_heap[0], trees._heap_thresholds(features_heap, bins_heap, thresholds))
        and torch.equal(model.leaf_probs[0], leaf_probs)
    ):
        raise AssertionError("deep dt: the kernels' heaps differ from the plain-version fit")
    splits = int((features_heap >= 0).sum())
    last_level = int((features_heap[2 ** (DEEP_DEPTH - 1) - 1 :] >= 0).sum())
    if last_level == 0:
        raise AssertionError("deep dt: the last level does not split")
    return {
        "depth": DEEP_DEPTH, "classes": DEEP_CLASSES, "wall_s": wall_s,
        "splits": splits, "last_level_splits": last_level, "heaps_identical_to_plain": True,
        "device_busy_ms": _busy_ms(torch, lambda: estimator.fit(X, y10)),
    }


def time_metrics(torch, y_dev) -> dict:
    """K9 (the confusion matrix and its metrics, torch ops) at the fit's
    rows, cold and warm, beside its bound: the two int64 label vectors
    read once over HBM bandwidth."""
    predicted = (y_dev + (torch.arange(y_dev.shape[0], device=y_dev.device) % 7 == 0)) % CLASSES
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=y_dev.device)

    def call():
        return evaluation.masked_metrics(y_dev, predicted, None, CLASSES)

    return {
        "ms": _event_ms(torch, call, 20, flush),
        "warm_ms": _event_ms(torch, call, 50),
        "bound_ms": 2 * y_dev.numel() * 8 / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


def check_bounds(summary) -> None:
    """A time below its kernel's bound means that the bound or the timing
    is wrong: raise."""
    for entry in summary:
        timed = {
            **entry.get("by_rows", {}), **entry.get("by_level", {}), **entry.get("by_classes", {}),
            **entry.get("forest", {}).get("by_level", {}),
        }
        for key, at in timed.items():
            for field in ("ms", "device_ms"):
                if at[field] is not None and at[field] < at["bound_ms"]:
                    raise AssertionError(
                        f"{entry['name']} at {key}: {field} {at[field]} is below "
                        f"its bound {at['bound_ms']}"
                    )


PHASES = ("kernels", "serve", "fit-kernels", "fit")


def main(argv) -> int:
    import torch

    wanted = argv or list(PHASES)
    unknown = sorted(set(wanted) - set(PHASES))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; phases are {list(PHASES)}")
    device = phase_device(torch)
    phase_build()
    summary = []
    if "kernels" in wanted:
        kernel_results = phase_kernels(torch)
        serve = phase_serve(torch, device["card"]) if "serve" in wanted else None
        for name, result in kernel_results.items():
            at_serve = result["by_rows"][4096]
            summary.append({
                "name": name,
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": REPLACES[name],
                "launches": serve["launches"][name] if serve else None,
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
    elif "serve" in wanted:
        phase_serve(torch, device["card"])
    fit_kernels = phase_fit_kernels(torch) if "fit-kernels" in wanted else None
    fit = phase_fit(torch, device["card"]) if "fit" in wanted else None
    if fit_kernels:
        for name, result in fit_kernels.items():
            k7 = name in LOGISTIC_REPLACES
            summary.append({
                "name": name,
                "route": "cuda",
                "source": LOGISTIC_SOURCE if k7 else FIT_SOURCE,
                "replaces": LOGISTIC_REPLACES[name] if k7 else FIT_REPLACES[name],
                "launches": fit["launches"][name] if fit else None,
                "max_abs_err": result["max_abs_err"],
                "rows": FIT_ROWS,
                **{field: result[field] for field in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms"
                )},
                **({"warm_ms": result["warm_ms"], "by_classes": result["by_classes"]} if k7
                   else {"by_level": result["by_level"]}),
                **({"forest": result["forest"]} if name in FOREST_KERNELS else {}),
            })
    check_bounds(summary)
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
    sys.exit(main(sys.argv[1:]))
