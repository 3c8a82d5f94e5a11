"""Drive the PyTorch port's predict lane, its lr, dt, rf, gb and nb fits,
its PCA and t-SNE image lane and its sweeps and job coalescing on one
CUDA card.

Run from the repository root, with one card visible:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py fit-kernels fit  # device, build and the named phases
    python3 chip_smoke.py sweep            # the sweeps and the coalescer alone

Phases, one JSON line each:

1. device      — CUDA must be available; the card's name and power limit.
2. build       — build (or load) the CUDA kernel libraries from
                 ``learningorchestra_tpu_torch/kernels/csrc``, one nvcc per
                 source, all started together.
3. kernels     — each forward kernel (K6) against its plain PyTorch version
                 on the same seeded inputs, at N in {1, 64, 4096, 1,048,576}
                 rows, 1 and 20 trees of depth 5: identical labels, the
                 ensemble's probabilities bit-equal and gb's within 1e-6;
                 times at 64 (the serve lane's dispatch shape), 4096 and
                 1,048,576 rows: events and device time warm, device time
                 cold (256 MB written before each call) and with L2
                 evicted by reads. A thread a row on 32-feature rows
                 at 1,048,576 rows, also with tiles cut below a block's
                 threads: ten calls each bit-equal. Also the times of
                 the lr and nb forwards (K8, cuBLAS).
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
                 above. K5's counts path (integer=True: dt's, the forest's
                 and the sweep's calls) identical to the plain version and
                 to its sums path, tree by tree and job by job; K4 over
                 20 trees of int32 bins (a row's words read once a group)
                 and at 20 trees x 2,048 nodes (the group's splits past
                 its shared table: windows of trees, and with the share
                 cut, splits from global memory), each tree bit-equal to
                 its launch alone; the CUDA kernels a K4 and a K5 call
                 run, and their device time with L2 evicted by reads
                 (no dirty lines left to write back). Then K7, both entry
                 points, against the plain twin on the same rows
                 standardized by scaler_stats, with 2 and 10 classes: loss
                 within 1e-6 relative, gradient within 1e-6, a second launch
                 bit identical; times cold (L2 overwritten) and warm. K7
                 also past the sweep's width: 20,000 features (rows read
                 from global memory) and 300 classes, 4,096 rows, at the
                 same tolerances.
6. fit         — ``make_classifier(...)`` fits dt, rf, gb, lr and nb on the
                 same 1,000,000 rows on the card, then evaluate_predict
                 (its launches counted alone: K6's are the summary's
                 ``evaluate_launches``), save_model and one request each
                 over HTTP. Held against
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
7. embed-kernels — t-SNE's kernels against their plain versions on the
                 main path's own matrices: bench.py's embedding blobs (16
                 features, 10 centres) as the image requests read them
                 from the store, label column included (17 columns). K11
                 (calibrated affinities) at the landmark fit's 5,000 rows,
                 the exact fit's 20,000 and the quality fit's 2,048 (see
                 embed), each p within 1e-3 of its row's largest, rows
                 past it counted; K12 (Z, then the gradient) on each
                 fit's own P, at its start Y0 with exaggeration and at
                 its final embedding without, no farther from float64
                 than the plain version and within 1e-3 of the plain
                 gradient's largest entry (or twice the plain version's
                 distance from float64), three optimizer iterations each
                 way; the same checks on a seeded non-symmetric P at 1,
                 2, 261 and 300 rows (no pair, one pair, ragged tiles
                 with 4-byte and 16-byte copies of P); K13
                 (interpolation) of the 1,000,000 rows onto the 5,000
                 landmarks' fitted embedding in one launch, and of their
                 first 65,536 rows, within 1e-3 of the largest landmark
                 coordinate, a row's distances in global scratch bit
                 identical to shared memory; a second launch bit
                 identical, K11's distances in global memory bit
                 identical to shared; times cold beside their bounds
                 (one exp a bisection step for K11 and K13; Z and the
                 gradient over the unordered pairs). Then K10 (PCA, torch
                 ops) on the 1,000,000 x 17 matrix, cold and warm,
                 beside its bound.
8. embed       — the port's tsne and pca services over real HTTP on the
                 same store: PCA and t-SNE (auto: landmark) at 1,000,000
                 rows and t-SNE (auto: exact) at 20,000; each PNG read
                 back; K11-K13's launches per request (K12 two an
                 iteration). Each request's exact fit (the 20,000 rows;
                 the 5,000 landmarks) against the plain versions' fit
                 from the same X and Y0: KL(P || Q) within 2%; the
                 landmark request's interpolation against the plain
                 version on its own inputs, within 1e-3; the same at
                 2,048 rows, where half the iterations and a PCA
                 projection must fail the KL gate; the k = 10 label
                 agreement of each embedding against the 2,048-row plain
                 fit's; both t-SNE refits bit identical.
9. sweep       — the fused programs (K14) through ``ml/sweep.run_group`` on
                 bench.py's synthetic rows (1,000,000 train, seed 0; a
                 200,000-row eval draw, seed 1): bench.py's sweep_100 lr
                 grid (100 λ over linspace(0, 1), 25 iterations: 112
                 padded slots of 1,048,576 rows) and a dt depth grid {2,
                 5, 8} (three programs of 8 slots), each one member, each
                 run with the counts set to 0 just before it: K7
                 segments + iterations and iterations launches for the
                 whole group, K1 3 (a program's shared rows binned once
                 under its member's unstacked thresholds), K2-K4 15
                 each, K5 3, K6 3; points/s. Each depth's program over
                 the shared thresholds bit-equal (heaps, leaf
                 probabilities, metrics) to the same program over them
                 stacked slot by slot.
                 Both held against the same groups through the plain
                 versions on the card (lr: the same winner, every point's
                 probabilities within 1e-4; dt: heaps identical, leaf
                 probabilities within 1e-6). K7 (weighted), K1, K2 with
                 each job's bins, K4, K5 and K6 over 8 jobs: each job
                 bit-equal to a launch of it alone and within the plain
                 versions' tolerances; K7 also in each geometry its
                 wrappers choose: jobs sharing X in groups of 1, 7, 112
                 and 113 and the flood's 64 stacked jobs of 1,024 rows,
                 weighted and not, 2 and 10 classes, each job bit-equal
                 to its solo launch and a second launch bit identical;
                 each timed cold at the main path's shapes with the three
                 programs. Five lr members (own
                 data, 1,000,000 rows) and three dt members fused by a
                 Coalescer in one dispatch, bit-identical to their solo
                 runs; bench.py's flood of 64 concurrent lr jobs of 1,024
                 rows at a 10 ms window (one fused dispatch) and at 0.

Then the ``kernels`` summary line, the card's ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero without that last line. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import struct
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
from learningorchestra_tpu_torch.ml.base import segment_steps
from learningorchestra_tpu_torch.ml.trees import GBT_ROUNDS, GBT_STEP, MAX_DEPTH, NUM_TREES
from learningorchestra_tpu_torch.ops import pca, tsne
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
TIMED_ROWS = (64, 4096, 1_048_576)
TREE_TOL = 1e-6
# K6 a thread a row on rows wider than the items a thread fetches ahead
# (4 words), and a share that cuts its tile below a block's 256 threads
WIDE_FEATURES, WIDE_SHARE, WIDE_CALLS = 32, 30_000, 10
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
    # the counts path's memset of its output is part of its work
    "level_histograms": (
        "level_histograms_kernel", "sum_partials_kernel", "level_counts_kernel",
        "counts_to_float_kernel", "Memset",
    ),
    "select_splits": ("select_splits_kernel",),
    "route": ("route_kernel",),
    # the counts path is one kernel; the sums path one, or two past one
    # block's partials
    "leaf_sums": ("leaf_counts_kernel", "leaf_sums_kernel", "sum_partials_kernel"),
    "logistic_loss_grad": ("loss_grad_kernel", "finish_kernel"),
    "logistic_trial_losses": ("trial_losses_kernel", "finish_kernel"),
    "tsne_affinities": ("distances_kernel", "affinities_kernel"),
    "tsne_z": ("z_pairs_kernel", "z_total_kernel"),
    "tsne_grad": ("gradient_pairs_kernel", "gradient_finish_kernel"),
    "tsne_interpolate": ("interpolate_kernel",),
}
TSNE_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/tsne.cu"
TSNE_REPLACES = {
    "tsne_affinities": (
        "learningorchestra_tpu/ops/tsne.py:122 _affinities with :65 _squared_distances "
        "and :79 _calibrate_row_block"
    ),
    "tsne_z": "learningorchestra_tpu/ops/tsne.py:170 _optimize, its gradient's normalizer (:192-198)",
    "tsne_grad": "learningorchestra_tpu/ops/tsne.py:170 _optimize, its gradient (:192-205)",
    "tsne_interpolate": "learningorchestra_tpu/ops/tsne.py:315 _interpolate",
}
TSNE_KERNELS = tuple(TSNE_REPLACES)
EMBED_ROWS = 1_000_000          # bench.py's embedding rows (its EMBED_ROWS)
EXACT_ROWS = tsne.EXACT_ROWS_LIMIT   # the largest exact t-SNE: 20,000 rows
QUALITY_ROWS = 2_048            # bench.py's head-to-head t-SNE size
INTERP_ROWS = 65_536            # K13 also on the first rows alone
QUALITY_SAMPLE, QUALITY_K = 4_000, 10
# Kernel against plain version on the same inputs, and why:
# K11: each p within 1e-3 of its row's largest p. The kernel's distances
# (a sequential fmaf dot) and the plain version's (cuBLAS) round apart by
# a few float32 steps of |x|^2 (~1,000 here, ~1e-4 apart), and p =
# exp(-beta d) moves by beta times that.
K11_TOL = 1e-3
# K12: Z within 1e-5 relative (float64 row sums against torch's float32
# sum); the gradient no farther from a float64 evaluation of the same
# expressions than the plain version is (1e-6 of the largest entry of
# slack), and so within 1e-3 of the plain version's largest entry or
# within twice the plain version's own distance from float64, whichever
# is larger; three iterations of the optimizer within 1e-4 of the largest
# coordinate. The reference's |a|^2 + |b|^2 - 2 a.b rounds at |y|^2 ~
# 3,600 (coordinates up to ~60), and the gradient 4 (s_i y_i - t_i) is a
# difference of two sums: at a fit's start both float32 versions sit
# ~2e-7 of the largest entry from float64, but at its final embedding,
# where attraction and repulsion nearly cancel, 1e-2 (5,000 and 20,000
# rows on an H100; the kernel the nearer of the two).
K12_Z_RTOL = 1e-5
K12_PLAIN_TOL = 1e-3
K12_FLOAT64_SLACK = 1e-6
K12_TOL = 1e-4
# K13: within 1e-3 of the landmarks' largest coordinate (K11's distances,
# then a float64 sum against a float32 product).
K13_TOL = 1e-3
# The 2,048-row exact fit by the kernels against the plain versions' fit
# from the same Y0: k = 10 label agreement within 0.02 (t-SNE is chaotic,
# so the two embeddings part; their quality must not); the main path's
# t-SNE embeddings no worse than the plain fit less the same margin.
QUALITY_MARGIN = 0.02
# Each exact fit of the main path (and the 2,048-row fit) against the
# plain versions' fit from the same P and Y0: KL(P || Q) of the two final
# embeddings within 2% of the plain fit's. Four 2,048-row fits whose Y0
# differ by a float32 step or less part by 0.6% in KL; half the
# iterations leave it 5% higher, a PCA projection 40% (the port's plain
# versions on a CPU). The 2,048-row fit's controls, half its iterations
# and the PCA projection, must fall outside the margin.
KL_MARGIN = 0.02
# The t-SNE kernels' work is mostly not multiply-adds: it is counted in
# float32 instructions, a fused multiply-add one of them, at the card's
# instruction rate, half the 67 TFLOP/s that counts a multiply-add as two.
PEAK_FP32_INSTRUCTIONS_PER_S = PEAK_FP32_OPS_PER_S / 2
# The float32 instructions a t-SNE kernel needs, an exp and a division
# one each (a lower bound: each is several on the card), counted from the
# kernels' arithmetic (tsne.cu). K11 and K13, for one (row, column) pair:
# a distance from the norms (a multiply-add a feature, three more); each
# of 32 bisection steps one pass (multiply, subtract, exp, add into the
# total, multiply-add of e and the logit into the entropy's sum; the log
# and the division are the row's, not the pair's); the final pass's
# multiply, subtract, exp and add, then K11's p (multiply, subtract, exp,
# divide) or K13's two multiply-adds into sum e y.
TSNE_STEP_INSTRUCTIONS = 5
TSNE_AFFINITY_INSTRUCTIONS = 32 * TSNE_STEP_INSTRUCTIONS + 4 + 4
TSNE_INTERPOLATION_INSTRUCTIONS = 32 * TSNE_STEP_INSTRUCTIONS + 4 + 2
# K12, for one unordered pair {i, j}, done once: 1 / (1 + d) of two 2-D
# rows from their norms; q and its floor; and for each of W_ij and W_ji
# the exaggerated P less q, W, and its three float64 sums. Z: the inverse
# and its sum. Both over the n (n - 1) / 2 unordered pairs.
TSNE_INVERSE_INSTRUCTIONS = 7
TSNE_GRADIENT_PAIR_INSTRUCTIONS = TSNE_INVERSE_INSTRUCTIONS + 2 + 2 * 6


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


# SASS opcodes counted in each kernel: the pipes that run at a quarter of
# the float32 rate or less (MUFU, conversions, FCHK), float64 and barriers
SASS_COUNTED = ("MUFU", "F2F", "FCHK", "DADD", "DFMA", "DMUL", "SHFL", "BAR", "LDGSTS")


def sass_summary(library_path: str) -> dict | None:
    """Per kernel of a built library, from ``cuobjdump -sass``: its SASS
    instruction count and the counts of ``SASS_COUNTED``. None when the
    toolkit has no cuobjdump."""
    import re

    cuobjdump = os.path.join(os.path.dirname(kernels._find_nvcc()), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        return None
    text = subprocess.run(
        [cuobjdump, "-sass", library_path], capture_output=True, text=True, timeout=120, check=True
    ).stdout
    summary = {}
    for section in re.split(r"\n\s*Function : ", text)[1:]:
        name = section.split("\n", 1)[0].strip()
        counts = dict.fromkeys(SASS_COUNTED, 0)
        total = 0
        for instruction in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", section):
            words = instruction.split()
            opcode = (words[1] if words[0].startswith("@") else words[0]).split(".")[0]
            total += opcode != "NOP"
            if opcode in counts:
                counts[opcode] += 1
        # the kernel's own name, and its integer template arguments if it has any
        short = re.search(r"\d([a-z][a-z_]*?_kernel)(?:I((?:L\w\d+E)+)E)?", name)
        arguments = re.findall(r"L\w(\d+)E", short.group(2) or "") if short else []
        key = name if short is None else short.group(1) + (f"<{','.join(arguments)}>" if arguments else "")
        summary[key] = {"instructions": total, **counts}
    return summary


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
                if "registers" in line or "Compiling entry" in line or "spill" in line
            ],
            "sass": sass_summary(info["path"]),
        }
    emit({"phase": "build", "seconds": time.perf_counter() - started, "libraries": libraries})


def _kernel_inputs(torch, rows: int, count: int, seed: int, features: int = FEATURES):
    """Rows and heaps for the kernel checks: early leaves anywhere
    (feature -1), inf thresholds, NaN in selected and unselected columns."""
    rng = np.random.default_rng(seed)
    nodes, leaves = 2**DEPTH - 1, 2**DEPTH
    X = bench_rows(rng, rows, features)
    X[rng.random(X.shape) < 0.05] = np.nan
    features_heap = rng.integers(-1, features, size=(count, nodes)).astype(np.int32)
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


# Cycles of the spin kernel that keeps the card busy while the host
# enqueues the first work of a trace (~6 ms on an H100)
SPIN_CYCLES = 10_000_000


def _trace_device_us(events, kernel_names, wall_ms: float) -> tuple[float, int]:
    """Device microseconds and launches of the kernels whose names contain
    one of ``kernel_names`` (every device event when that is None) in a
    trace's device ``events``, (name, start_us, end_us) on the trace's
    clock, which CUDA events measured as ``wall_ms`` from the first one's
    start to the last one's end. The trace's clock can be off by a factor
    over a whole trace (0.49 to 1.03 of CUDA events' on an H100), so the
    kernels' time is their share of the span from the first event's
    start to the last one's end, times ``wall_ms``: a share and a span of
    one clock."""
    first, last, named_us, launches = float("inf"), float("-inf"), 0.0, 0
    for name, start_us, end_us in events:
        first, last = min(first, start_us), max(last, end_us)
        if kernel_names is None or any(wanted in name for wanted in kernel_names):
            named_us += end_us - start_us
            launches += 1
    if launches == 0 or last <= first:
        return 0.0, launches
    return named_us / (last - first) * wall_ms * 1000.0, launches


def _profile_device_us(torch, fn, kernel_names=None, event_clock: bool = True) -> tuple[float, int]:
    """Device microseconds and launches of the CUDA kernels whose names
    contain one of ``kernel_names``, or of every CUDA kernel when that is
    None, while ``fn`` runs: from the profiler's trace of the card, put on
    the clock of CUDA events recorded around ``fn`` (``_trace_device_us``).
    A spin kernel ahead of the start event (and out of the count) keeps
    the card busy until ``fn``'s first work is enqueued, so that the events
    span the same time as ``fn``'s device events. With ``event_clock``
    False, the trace's own sum of every device event's time: for a
    ``fn`` whose host work precedes its first device work (a fit's
    thresholds), the events' span holds that host time too, and the
    share of the trace's span would count it as busy."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    events = [
        (event.name, event.time_range.start, event.time_range.end)
        for event in prof.events()
        if "CUDA" in str(getattr(event, "device_type", "")) and "spin_kernel" not in event.name
    ]
    if not event_clock:
        return sum(end_us - start_us for _, start_us, end_us in events), len(events)
    return _trace_device_us(events, kernel_names, start.elapsed_time(end))


def _busy_ms(torch, fn):
    """Device milliseconds of every device event (kernels, copies,
    memsets) in the trace of ``fn``, on the trace's own clock; None when
    the trace shows no device time (the profiler missed it)."""
    total_us, _ = _profile_device_us(torch, fn, event_clock=False)
    return total_us / 1000.0 if total_us > 0 else None


# Traces taken for one device time before it is given up as not measured,
# and the traces that lost launches (reported before the summary)
PROFILE_ATTEMPTS = 3
LOST_TRACES: list = []


def _device_ms(torch, fn, kernel_names, repeats: int, flush=None):
    """Mean device milliseconds per call of ``fn`` in the CUDA kernels
    named ``kernel_names``, from the profiler's trace of the card. Given a
    ``flush`` buffer, it is overwritten before each call (the fill's own
    kernel is not counted). The profiler can lose a kernel's records, and
    a trace that lost some gives a time below the truth: a trace of the
    ``repeats`` calls counts only when it shows ``repeats`` times the
    most launches that a trace of one call has shown. None when no trace
    of ``PROFILE_ATTEMPTS`` does, or when the trace has no device time for
    the kernels."""

    def calls(count):
        def run():
            for _ in range(count):
                if flush is not None:
                    flush.zero_()
                fn()

        return run

    per_call = 0
    for _ in range(PROFILE_ATTEMPTS):
        per_call = max(per_call, _profile_device_us(torch, calls(1), kernel_names)[1])
        total_us, launches = _profile_device_us(torch, calls(repeats), kernel_names)
        if per_call > 0 and launches == per_call * repeats:
            return total_us / 1000.0 / repeats if total_us > 0 else None
        LOST_TRACES.append({
            "kernels": list(kernel_names), "launches": launches, "expected": per_call * repeats,
        })
    return None


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
    results = {name: {"max_abs_err": 0.0, "bit_equal": True, "by_rows": {}} for name in REPLACES}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    read_flush = _ReadFlush(torch, flush.device)
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
                # the ensemble's sums and division are the plain version's
                # float32 operations in its order: the same bits
                if name == "tree_ensemble_forward" and not torch.equal(got, want):
                    raise AssertionError(f"{name} at {rows} rows, {tree_count} trees: not bit-equal")
                results[name]["bit_equal"] &= bool(torch.equal(got, want))
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], error)
                if rows in TIMED_ROWS and tree_count == TREES:
                    repeats = 200 if rows <= 4096 else 50
                    bound_ms, bound_by = _bound(rows, tree_count, name)
                    results[name]["by_rows"][rows] = {
                        "ms": _event_ms(torch, kernel, repeats),
                        "device_ms": _device_ms(torch, kernel, DEVICE_KERNELS[name], repeats),
                        "ms_cold": _event_ms(torch, kernel, 20, flush),
                        "device_ms_cold": _device_ms(torch, kernel, DEVICE_KERNELS[name], 20, flush),
                        "device_ms_clean_l2": _device_ms(torch, kernel, DEVICE_KERNELS[name], 20, read_flush),
                        "plain_ms": _event_ms(torch, plain, max(5, repeats // 10)),
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "geometry": trees._forward_geometry(
                            rows, FEATURES, tree_count, DEPTH,
                            CLASSES if name == "tree_ensemble_forward" else 1,
                        )._asdict(),
                    }
    linear = _linear_forward_times(torch)
    emit({
        "phase": "kernels", "rows": KERNEL_ROWS, "trees": (1, TREES), **results,
        "wide_rows": check_wide_rows(torch), "linear_forwards": linear,
    })
    return results


def check_wide_rows(torch) -> dict:
    """K6 a thread a row on rows wider than a thread's items fetched ahead:
    1,048,576 rows of WIDE_FEATURES features through 20 trees of depth 5,
    the ensemble's and gb's, at the geometry's tile (a row a thread) and
    with the share cut to WIDE_SHARE, so that a tile holds fewer rows than
    a block has threads and the threads past them stage the next tile
    while the others still walk this one. Every call of WIDE_CALLS is
    bit-equal to the plain version; the times beside."""
    rows = KERNEL_ROWS[-1]
    X, fh, th, lp, lv = _kernel_inputs(torch, rows, TREES, seed=WIDE_FEATURES, features=WIDE_FEATURES)
    calls = {
        "tree_ensemble_forward": (
            CLASSES,
            lambda: trees.ensemble_forward(X, fh, th, lp, DEPTH),
            lambda: trees._ensemble_forward(X, fh, th, lp, DEPTH),
        ),
        "gbt_forward": (
            1,
            lambda: trees.gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH),
            lambda: trees._gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH),
        ),
    }
    record = {}
    saved = trees._FORWARD_SHARE
    try:
        for share in (saved, WIDE_SHARE):
            trees._FORWARD_SHARE = share
            for name, (classes, kernel, plain) in calls.items():
                geometry = trees._forward_geometry(rows, WIDE_FEATURES, TREES, DEPTH, classes)
                if not geometry.row_threads:
                    raise AssertionError(f"{name} at {WIDE_FEATURES} features: not a thread a row ({geometry})")
                want = plain()
                for call in range(WIDE_CALLS):
                    if not torch.equal(kernel(), want):
                        raise AssertionError(
                            f"{name} at {WIDE_FEATURES} features, share {share}, call {call}: not bit-equal"
                        )
                record[f"{name}:share_{share}"] = {
                    "ms": _event_ms(torch, kernel, 20), "geometry": geometry._asdict(),
                }
    finally:
        trees._FORWARD_SHARE = saved
    return {"bit_equal": True, "rows": rows, "features": WIDE_FEATURES, "calls": WIDE_CALLS, **record}


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
    trees: int = 1, subsets: bool = False, max_bins: int = MAX_BINS,
) -> tuple[float, str]:
    """Least milliseconds the card could take for one call at these shapes:
    the bytes the function needs, each read once and each output written
    once, over HBM bandwidth, against the float32 operations it needs over
    the float32 peak. ``route`` needs one bin of each row whose node
    splits (``bins_read``, from this run's data), not the whole matrix. A
    forest's ``trees`` share the bins and each has its own nodes, channels
    and output; its split search reads each node's feature scores."""
    F, B, K, T = FEATURES, max_bins, channels, trees
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
        # dt's one-hots are integer channels (K2's counts path), gb's (g, h)
        # are not (its sums path)
        integer = mode == "gini"
        for level in range(DEPTH):
            n_nodes = 2**level
            hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=integer)
            plain_hist = trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS)
            errors["level_histograms"] = max(
                errors["level_histograms"], _sums_error("level_histograms", mode, hist, plain_hist)
            )
            if not torch.equal(
                trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=integer), hist
            ):
                raise AssertionError(f"level_histograms ({mode}, level {level}): a second launch differs")
            if integer and not torch.equal(
                trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS), hist
            ):
                raise AssertionError(f"level_histograms (level {level}): the sums path's counts differ")
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
                torch.equal(trees.level_histograms(
                    bins, node[None], channels[None], n_nodes, MAX_BINS, integer=integer)[0], hist)
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
        if not torch.equal(trees.leaf_sums(node, channels, 2**DEPTH), sums):
            raise AssertionError(f"leaf_sums ({mode}): a second launch differs")
        if integer:
            # dt's call: the counts path, as exact as the sums path
            counted = trees.leaf_sums(node, channels, 2**DEPTH, integer=True)
            if not torch.equal(counted, plain_sums):
                raise AssertionError("leaf_sums (counts): class counts differ")
            if not torch.equal(trees.leaf_sums(node[None], channels[None], 2**DEPTH, integer=True)[0], counted):
                raise AssertionError("leaf_sums (counts): a tree axis of 1 changes the bits")
        cases[(mode, DEPTH)] = (node, channels, None, None, None)
    return {"errors": errors, "bins": bins, "cases": cases}


K1_EDGE_ROWS = 1001     # not a multiple of a tile, a word or a warp


def check_k1_edges(torch, X: np.ndarray, thresholds: np.ndarray) -> dict:
    """K1's bins torch.equal to the plain version's at its edges: NaN,
    +-inf, ties with a threshold and duplicate thresholds, an all-inf
    feature (an all-NaN column), 255 bins (int32), K1_EDGE_ROWS rows at 5
    and 17 features (no 16-byte words), a shared X against each job's
    thresholds at the main path's rows (8 jobs, one group) and at 113
    jobs (three groups), and the thresholds in windows of features and in
    a padded table in global memory (shares forced down)."""
    rng = np.random.default_rng(13)
    rows = K1_EDGE_ROWS
    edge = X[:rows].copy()
    edge[:, 2] = np.nan                                   # an all-NaN feature
    edge[rng.random(edge.shape) < 0.02] = np.nan
    edge[:6, 0] = [np.inf, -np.inf, -0.0, np.nan, thresholds[0, 0], thresholds[0, -1]]
    edge_thresholds = thresholds.copy()
    edge_thresholds[2] = np.inf                           # the all-NaN feature's
    edge_thresholds[5, 10:14] = edge_thresholds[5, 10]    # duplicates
    edge[6:9, 5] = edge_thresholds[5, 10]                 # ties with the duplicates
    X_full = torch.from_numpy(X).cuda()

    def held(name, X_dev, thresholds_dev):
        if thresholds_dev.dim() == 3:
            got, want = binning.job_apply_bins(X_dev, thresholds_dev), binning._job_apply_bins(X_dev, thresholds_dev)
        else:
            got, want = binning.apply_bins(X_dev, thresholds_dev), binning._apply_bins(X_dev, thresholds_dev)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"apply_bins ({name}): bins differ from the plain version")
        return got

    cases = {}
    X_edge, th_edge = torch.from_numpy(edge).cuda(), torch.from_numpy(edge_thresholds).cuda()
    held("edges", X_edge, th_edge)
    th255 = torch.from_numpy(binning.make_thresholds(X[:200_000], 255).astype(np.float32)).cuda()
    cases["int32_255_bins"] = str(held("255 bins", X_full, th255).dtype)
    for features in (5, 17):
        wide = np.ascontiguousarray(np.concatenate([edge, edge[:, ::-1]], axis=1)[:, :features])
        th = np.concatenate([edge_thresholds, edge_thresholds[::-1]])[:features]
        held(f"{features} features", torch.from_numpy(wide).cuda(), torch.from_numpy(np.ascontiguousarray(th)).cuda())
    jobs = {}
    for count in (JOB_CHECK_JOBS, 113):
        stacked = torch.stack([th_edge * (1.0 + 1e-3 * j) for j in range(count)]).contiguous()
        X_jobs = X_full if count == JOB_CHECK_JOBS else X_full[:100_000]
        got = held(f"shared X, {count} jobs", X_jobs, stacked)
        for j in (0, count - 1):
            if not torch.equal(got[j], binning.job_apply_bins(X_jobs, stacked[j:j + 1])[0]):
                raise AssertionError(f"apply_bins (shared X, {count} jobs): job {j} differs alone")
        jobs[count] = binning._k1_geometry(FEATURES, MAX_BINS - 1, count, True, 1)._asdict()
    cases["shared_x_jobs"] = jobs
    forced = {}
    saved = binning._BIN_SHARE
    try:
        for share in (1024, 64):   # windows of 8 features; a padded table in global memory
            binning._BIN_SHARE = share
            held(f"share {share}", X_edge, th_edge)
            held(f"share {share}, 255 bins", X_full[:rows], th255)
            held(f"share {share}, jobs", X_edge, torch.stack([th_edge, th_edge * 1.001]).contiguous())
            forced[share] = binning._k1_geometry(FEATURES, MAX_BINS - 1, 1, True, 1, share)._asdict()
    finally:
        binning._BIN_SHARE = saved
    cases["forced"] = forced
    return cases


def _k3_hist(torch, nodes: int, max_bins: int, channels: int, rows: int, seed: int):
    """A level's class counts on the card: ``rows`` rows spread at random
    over ``nodes`` nodes, each feature's bins and ``channels`` classes."""
    rng = np.random.default_rng(seed)
    lam = rows / (nodes * max_bins * channels)
    return torch.from_numpy(rng.poisson(lam, (nodes, FEATURES, max_bins, channels)).astype(np.float32)).cuda()


def check_k3_edges(torch) -> dict:
    """K3's splits equal to the plain version's at its edges: a NaN gain
    (newton: the first NaN wins and its node is a leaf), exact ties
    between features, an empty node (a leaf at bin 0), newton at 255
    bins, 2,048 nodes of 10 classes, and 16 features x 255 bins x 10
    classes in one window of shared memory, in windows of features and in
    global scratch (shares forced down)."""
    rng = np.random.default_rng(14)
    gini = _k3_hist(torch, 16, MAX_BINS, CLASSES, FIT_ROWS // 16, 1)
    gini[3] = 0.0                                       # no rows
    gini[5, 9] = gini[5, 2]                             # feature 9 ties feature 2
    newton = torch.from_numpy(rng.random((16, FEATURES, MAX_BINS, 2), dtype=np.float32)).cuda()
    newton[..., 0] -= 0.5
    newton[3] = 0.0
    newton[7, 4, 6, 0] = float("nan")
    newton[7, 9, 2, 0] = float("nan")
    newton255 = torch.from_numpy(rng.random((16, FEATURES, 255, 2), dtype=np.float32)).cuda()
    newton255[..., 0] -= 0.5
    cases = {
        "nan_ties_empty": (gini, "gini"), "nan_gain": (newton, "newton"), "newton_255_bins": (newton255, "newton"),
        "2048_nodes_10_classes": (_k3_hist(torch, 2048, MAX_BINS, DEEP_CLASSES, FIT_ROWS, 2), "gini"),
        "255_bins_10_classes": (_k3_hist(torch, 16, 255, DEEP_CLASSES, FIT_ROWS, 3), "gini"),
    }
    outcomes = {}

    def held(name, hist, mode):
        got, want = trees.select_splits(hist, mode), trees._select_plain(hist, mode)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"select_splits ({name}): splits differ from the plain version")
        return got

    for name, (hist, mode) in cases.items():
        feature, bin_index = held(name, hist, mode)
        outcomes[name] = {"nodes": int(feature.numel()), "leaf_nodes": int((feature < 0).sum()),
                          "geometry": trees._k3_geometry(*hist.shape[-3:])._asdict()}
    feature, bin_index = held("empty", gini, "gini")
    if (int(feature[3]), int(bin_index[3])) != (-1, 0) or int(feature[5]) == 9:
        raise AssertionError("select_splits: the empty node is not a leaf at bin 0, or a tie went to the later feature")
    if int(held("nan", newton, "newton")[0][7]) != -1:
        raise AssertionError("select_splits: a NaN gain did not make its node a leaf")
    saved = trees._SPLIT_SHARE
    try:
        for share in (65_536, 4_096):   # windows of 6 features; the stage in global scratch
            trees._SPLIT_SHARE = share
            for name in ("255_bins_10_classes", "newton_255_bins"):
                held(f"{name}, share {share}", *cases[name])
            outcomes[f"255_bins_10_classes:share_{share}"] = trees._k3_geometry(16, 255, DEEP_CLASSES, share)._asdict()
    finally:
        trees._SPLIT_SHARE = saved
    return {"outcomes": outcomes, "cases": cases}


class _ReadFlush:
    """A flush that evicts L2 by reading a buffer past its size, in place
    of overwriting one (``zero_`` is the name the timing helpers call):
    the next call finds none of its inputs in L2, and no dirty lines for
    its own reads to write back first."""

    def __init__(self, torch, device):
        self.buffer = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def zero_(self):
        self.buffer.sum()


def _launch_floor_ms(torch, flush) -> float:
    """Milliseconds of one launch of an empty kernel (tree_fit.cu
    ``lo_empty``) through ctypes, cold, on the same clock as the kernels:
    the card's launch floor."""
    lib = kernels.library("tree_fit")
    index = torch.cuda.current_device()
    return _event_ms(torch, lambda: lib.lo_empty(index, torch.cuda.current_stream().cuda_stream), 20, flush)


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
        hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True)
        plain_hist = trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS)
        errors["level_histograms"] = max(
            errors["level_histograms"], _sums_error("level_histograms (forest)", "gini", hist, plain_hist)
        )
        for tree in (0, TREES - 1):
            alone = trees.level_histograms(bins, node[tree], channels[tree], n_nodes, MAX_BINS, integer=True)
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
        for tree in (0, TREES - 1):
            if not torch.equal(trees.route(bins, node[tree], plain_feature[tree], plain_bin[tree]), routed[tree]):
                raise AssertionError(f"route (forest, level {level}): tree {tree} differs alone")
        cases[level] = (node, channels, plain_hist, scores, plain_feature, plain_bin)
        node = plain_routed
    sums = trees.leaf_sums(node, channels, 2**DEPTH)
    plain_sums = trees._leaf_sums(node, channels, 2**DEPTH)
    errors["leaf_sums"] = _sums_error("leaf_sums (forest)", "gini", sums, plain_sums)
    # the forest's call: the counts path
    counted = trees.leaf_sums(node, channels, 2**DEPTH, integer=True)
    if not torch.equal(counted, plain_sums):
        raise AssertionError("leaf_sums (forest, counts): class counts differ")
    for tree in (0, TREES - 1):
        if not (
            torch.equal(trees.leaf_sums(node[tree], channels[tree], 2**DEPTH, integer=True), counted[tree])
            and torch.equal(trees.leaf_sums(node[tree], channels[tree], 2**DEPTH), sums[tree])
        ):
            raise AssertionError(f"leaf_sums (forest): tree {tree} differs alone")
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
    hist = trees.level_histograms(bins, node, channels, deep, MAX_BINS, integer=True)
    plain = trees._level_histograms(bins, node, channels, deep, MAX_BINS)
    error = _sums_error("level_histograms (forest, 2,048 nodes)", "gini", hist, plain)
    for tree in (0, TREES - 1):
        alone = trees.level_histograms(bins, node[tree], channels[tree], deep, MAX_BINS, integer=True)
        if not torch.equal(alone, hist[tree]):
            raise AssertionError(f"level_histograms (forest, 2,048 nodes): tree {tree} differs alone")
    del hist, plain
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=bins.device)
    return {
        "rows": rows, "trees": TREES, "nodes": deep, "channels": DEEP_CLASSES,
        "path": _histogram_path(rows, deep, DEEP_CLASSES, True), "max_abs_err": error,
        "ms": _event_ms(
            torch, lambda: trees.level_histograms(bins, node, channels, deep, MAX_BINS, integer=True), 2, flush
        ),
    }


def _histogram_path(rows: int, n_nodes: int, channels: int, integer: bool, max_bins: int = MAX_BINS,
                    bin_bytes: int = 1) -> dict:
    """How K2 covers a level of this shape: the counts path's chunks and
    whether it counts in shared memory, or the sums path's chunks and its
    windows of nodes, feature blocks and passes."""
    if integer:
        tiling = trees._count_tiling(rows, FEATURES, n_nodes, max_bins, channels, bin_bytes)
        return {"path": "counts", "chunks": tiling.chunks, "in_shared": tiling.in_shared,
                "block_features": tiling.block_features}
    tiling = trees._block_features(FEATURES, n_nodes, max_bins, channels, bin_bytes)
    return {
        "path": "sums", "chunks": trees._sum_chunks(rows, n_nodes, max_bins)[0],
        "node_windows": -(-n_nodes // tiling.nodes), "feature_blocks": -(-FEATURES // tiling.block_features),
        "passes": -(-max_bins // tiling.bins) * -(-channels // tiling.channels),
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
            hist = trees.level_histograms(bins, node, values, 2**level, 255, integer=mode == "gini")
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
    # int32 bins through the tree-group route: 20 trees over one matrix
    # (a row's 16 int32 bins as four 16-byte words, read once a group)
    rng = np.random.default_rng(10)
    forest_node = torch.from_numpy(rng.integers(0, 16, (TREES, X.shape[0])).astype(np.int32)).cuda()
    forest_feature = torch.from_numpy(rng.integers(-1, FEATURES, (TREES, 16)).astype(np.int32)).cuda()
    forest_bin = torch.from_numpy(rng.integers(0, 255, (TREES, 16)).astype(np.int32)).cuda()
    routed = trees.route(bins, forest_node, forest_feature, forest_bin)
    if not torch.equal(routed, trees._route(bins, forest_node, forest_feature, forest_bin)):
        raise AssertionError("route at 255 bins, 20 trees: nodes differ")
    for tree in (0, TREES - 1):
        if not torch.equal(trees.route(bins, forest_node[tree], forest_feature[tree], forest_bin[tree]), routed[tree]):
            raise AssertionError(f"route at 255 bins: tree {tree} differs alone")
    del forest_node, routed
    record["bins_255"] = {
        "int32": True, "levels": 4, "max_abs_err": errors["level_histograms"],
        "forest_route": trees._route_geometry(TREES, 16, True)._asdict(),
    }
    # R2: a depth-12 level and 4,096 leaves
    bins = binning.apply_bins(X_dev, torch.from_numpy(binning.make_thresholds(X).astype(np.float32)).cuda())
    rng = np.random.default_rng(9)
    deep = 2 ** (DEEP_DEPTH - 1)
    node = torch.from_numpy(rng.integers(0, deep, X.shape[0]).astype(np.int32)).cuda()
    leaf = torch.from_numpy(rng.integers(0, 2 * deep, X.shape[0]).astype(np.int32)).cuda()
    timings = {}
    for mode, values in channels.items():
        K, integer = values.shape[1], mode == "gini"
        hist = trees.level_histograms(bins, node, values, deep, MAX_BINS, integer=integer)
        plain = trees._level_histograms(bins, node, values, deep, MAX_BINS)
        errors["level_histograms"] = max(
            errors["level_histograms"], _sums_error("level_histograms (2,048 nodes)", mode, hist, plain)
        )
        timings[f"level_histograms:{deep}x{K}"] = {
            "ms": _event_ms(
                torch, lambda: trees.level_histograms(bins, node, values, deep, MAX_BINS, integer=integer), 3
            ),
            **_histogram_path(X.shape[0], deep, K, integer),
        }
    sums = trees.leaf_sums(leaf, channels["gini"], 2 * deep)
    plain = trees._leaf_sums(leaf, channels["gini"], 2 * deep)
    errors["leaf_sums"] = _sums_error("leaf_sums (4,096 leaves)", "gini", sums, plain)
    timings[f"leaf_sums:{2 * deep}x{DEEP_CLASSES}"] = {
        "ms": _event_ms(torch, lambda: trees.leaf_sums(leaf, channels["gini"], 2 * deep), 3),
        "windows": len(trees._windows(2 * deep, trees._leaf_warps(2 * deep, DEEP_CLASSES).leaves)),
    }
    # the deep dt's call: the counts path (in global memory: 160 KB of
    # counts a block would leave 16 chunks)
    counted = trees.leaf_sums(leaf, channels["gini"], 2 * deep, integer=True)
    if not torch.equal(counted, plain):
        raise AssertionError("leaf_sums (4,096 leaves, counts): class counts differ")
    timings[f"leaf_sums:{2 * deep}x{DEEP_CLASSES}:counts"] = {
        "ms": _event_ms(torch, lambda: trees.leaf_sums(leaf, channels["gini"], 2 * deep, integer=True), 3),
        **trees._leaf_count_tiling(X.shape[0], 2 * deep, DEEP_CLASSES)._asdict(),
    }
    del counted
    # K4 at a 2,048-node level of 20 trees: the group's splits pass a
    # block's share (windows of trees), and, with the share cut to 64
    # bytes, every tree's splits read from global memory
    deep_node = torch.from_numpy(rng.integers(0, deep, (TREES, X.shape[0])).astype(np.int32)).cuda()
    deep_feature = torch.from_numpy(rng.integers(-1, FEATURES, (TREES, deep)).astype(np.int32)).cuda()
    deep_bin = torch.from_numpy(rng.integers(0, MAX_BINS, (TREES, deep)).astype(np.int32)).cuda()
    saved = trees._ROUTE_SHARE
    try:
        for share in (saved, 64):
            trees._ROUTE_SHARE = share
            routed = trees.route(bins, deep_node, deep_feature, deep_bin)
            if not torch.equal(routed, trees._route(bins, deep_node, deep_feature, deep_bin)):
                raise AssertionError(f"route (20 trees x {deep} nodes, share {share}): nodes differ")
            for tree in (0, TREES - 1):
                if not torch.equal(trees.route(bins, deep_node[tree], deep_feature[tree], deep_bin[tree]), routed[tree]):
                    raise AssertionError(f"route (20 trees x {deep} nodes, share {share}): tree {tree} differs alone")
            timings[f"route:{TREES}x{deep}:share_{share}"] = {
                "ms": _event_ms(torch, lambda: trees.route(bins, deep_node, deep_feature, deep_bin), 3),
                **trees._route_geometry(TREES, deep, True)._asdict(),
            }
    finally:
        trees._ROUTE_SHARE = saved
    del deep_node, routed
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
            forests[f"{name}:{count}x{depth}x{classes}"] = {
                "ms": _event_ms(torch, kernel, 3),
                "geometry": trees._forward_geometry(
                    X.shape[0], FEATURES, count, depth, classes if name == "tree_ensemble_forward" else 1
                )._asdict(),
            }
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
                "geometry": logistic._k7_geometry(
                    FEATURES, classes, 1, False, trial=name == "logistic_trial_losses"),
            }
    for result in results.values():
        # the main path's shape: bench.py's two classes
        result.update(result["by_classes"][CLASSES])
    return results


def _same_bits(got, want) -> bool:
    """Tensors equal, NaN where NaN."""
    return all(
        bool((a.isnan() == c.isnan()).all()) and bool((a.nan_to_num() == c.nan_to_num()).all())
        for a, c in zip(got, want)
    )


def check_k7_empty(torch) -> dict:
    """K7 where the reference's gradient is no quotient of sums. No rows:
    the loss is NaN and the data term's gradient 0 (``jax.grad`` of the
    reference's mean contracts over no rows, which is 0 before any
    division), so dW is the L2 term's l2 W and db 0: solo, and a group of
    three jobs that share their (no) rows. Rows whose weights are all 0:
    loss and gradient NaN, as the reference's: job 1 of one launch of three
    jobs with rows, the others bit-equal to their launches alone and
    within K7_LOSS_RTOL and K7_GRAD_ATOL of the plain twin. The no-row
    cases held against the plain twin bit for bit, NaN where NaN."""
    device = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(11)

    def cuda(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    W = cuda((rng.normal(size=(3, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    b = cuda((rng.normal(size=(3, CLASSES)) * 0.3).astype(np.float32))
    l2s = cuda(np.array([0.0, 0.1, 0.5], np.float32))
    X0 = torch.empty((0, FEATURES), dtype=torch.float32, device=device)
    y0 = torch.empty((0,), dtype=torch.int32, device=device)
    record = {}
    solo = logistic.loss_and_grad(W[1], b[1], X0, y0, 0.1)
    jobs = logistic.job_loss_and_grad(W, b, X0, y0, None, l2s)
    torch.cuda.synchronize()
    if not (
        _same_bits(solo, logistic._loss_fn(W[1], b[1], X0, y0, 0.1))
        and _same_bits(jobs, logistic._job_loss_fn(W, b, X0, y0, None, l2s))
    ):
        raise AssertionError("logistic_loss_grad (no rows): the kernel differs from the plain twin")
    if not (
        bool(solo[0].isnan()) and torch.equal(solo[1], 0.1 * W[1]) and bool((solo[2] == 0).all())
        and bool(jobs[0].isnan().all()) and torch.equal(jobs[1], l2s[:, None, None] * W)
        and bool((jobs[2] == 0).all())
    ):
        raise AssertionError("logistic_loss_grad (no rows): not a NaN loss and the L2 term's gradient")
    record["no_rows"] = {"solo": True, "group_of_3": True, "geometry": logistic._k7_geometry(
        FEATURES, CLASSES, 3, True)}
    rows = K7_WIDE_ROWS
    X = cuda(rng.normal(size=(rows, FEATURES)).astype(np.float32))
    y = cuda(rng.integers(0, CLASSES, size=(3, rows)).astype(np.int32))
    weights = cuda(np.stack([np.ones(rows, np.float32), np.zeros(rows, np.float32),
                             (rng.random(rows) < 0.8).astype(np.float32)]))
    got = logistic.job_loss_and_grad(W, b, X, y, weights, l2s)
    want = logistic._job_loss_fn(W, b, X, y, weights, l2s)
    if not (all(bool(part[1].isnan().all()) for part in (*got, *want))
            and all(bool(part[j].isfinite().all()) for part in (*got, *want) for j in (0, 2))):
        raise AssertionError("logistic_loss_grad (zero weights): job 1 is not NaN, or another job is")
    live = torch.tensor([0, 2], device=device)
    loss_rel = float(((got[0][live] - want[0][live]).abs() / want[0][live].abs()).max())
    grad_err = max(float((got[i][live] - want[i][live]).abs().max()) for i in (1, 2))
    if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
        raise AssertionError(
            f"logistic_loss_grad (zero weights): loss {loss_rel} relative, gradient {grad_err}")
    for j in (0, 2):
        alone = logistic.job_loss_and_grad(
            W[j:j + 1], b[j:j + 1], X, y[j:j + 1], weights[j:j + 1], l2s[j:j + 1])
        if not all(torch.equal(part[j], one[0]) for part, one in zip(got, alone)):
            raise AssertionError(f"logistic_loss_grad (zero weights): job {j} differs alone")
    record["zero_weights"] = {"jobs": 3, "nan_job": 1, "others_bit_equal_alone": True}
    return record


# K7 past the sweep's width, each entry point alone: rows too wide for
# shared memory (read from global memory, the wide form unstaged, slot
# windows), classes past the registers (logits recomputed, windows) and
# classes whose terms pass a block's shared memory (each window keeps its
# own classes')
K7_WIDE_SHAPES = ((20_000, 2), (16, 300), (16, 2_000))
K7_WIDE_ROWS = 4_096


def check_k7_wide(torch) -> dict:
    """K7's two entry points at K7_WIDE_SHAPES on K7_WIDE_ROWS seeded rows
    (the logits kept small: W scaled by 1/sqrt(F)), against the plain twin
    at K7_LOSS_RTOL and K7_GRAD_ATOL, a second launch bit identical; with
    the geometry each ran in."""
    record = {}
    for features, classes in K7_WIDE_SHAPES:
        rng = np.random.default_rng(features + classes)

        def cuda(array):
            return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).cuda()

        X = cuda(rng.normal(size=(K7_WIDE_ROWS, features)))
        y = torch.from_numpy(rng.integers(0, classes, K7_WIDE_ROWS).astype(np.int32)).cuda()
        W = cuda(rng.normal(size=(features, classes)) * 0.3 / np.sqrt(features))
        b = cuda(rng.normal(size=classes) * 0.3)
        steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=X.device)
        W4 = (W[None] * (1.0 + steps[:, None, None])).contiguous()
        b4 = (b[None] * (1.0 + steps[:, None])).contiguous()
        what = f"{features} features x {classes} classes"
        got = logistic.loss_and_grad(W, b, X, y, 0.0)
        if not all(torch.equal(a, c) for a, c in zip(got, logistic.loss_and_grad(W, b, X, y, 0.0))):
            raise AssertionError(f"logistic_loss_grad ({what}): a second launch differs")
        want = logistic._loss_fn(W, b, X, y, 0.0)
        loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        grad_err = max(float((got[i] - want[i]).abs().max()) for i in (1, 2))
        if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
            raise AssertionError(f"logistic_loss_grad ({what}): loss {loss_rel} relative, gradient {grad_err}")
        trial = logistic.trial_losses(W4, b4, X, y, 0.0)
        if not torch.equal(trial, logistic.trial_losses(W4, b4, X, y, 0.0)):
            raise AssertionError(f"logistic_trial_losses ({what}): a second launch differs")
        plain_trial = logistic._trial_losses(W4, b4, X, y, 0.0)
        trial_rel = float(((trial - plain_trial).abs() / plain_trial.abs()).max())
        if not trial_rel <= K7_LOSS_RTOL:
            raise AssertionError(f"logistic_trial_losses ({what}): {trial_rel} relative")
        record[what] = {
            "loss_rel": loss_rel, "grad_err": grad_err, "trial_rel": trial_rel,
            "geometry": logistic._k7_geometry(features, classes, 1, False),
            "trial_geometry": logistic._k7_geometry(features, classes, 1, False, trial=True),
        }
    return record


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
    k1_edges = check_k1_edges(torch, X, thresholds_np)
    k3_edges = check_k3_edges(torch)
    rows = X.shape[0]
    results = {name: {"max_abs_err": checked["errors"][name], "by_level": {}} for name in FIT_REPLACES}
    # every call timed with a cold L2: the bounds count HBM bytes, and the
    # inputs of K2, K4 and K5 (28, 21 and 12 MB) would otherwise stay in L2
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=X_dev.device)
    read_flush = _ReadFlush(torch, X_dev.device)

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
        if name in ("route", "leaf_sums"):
            # the CUDA kernels one wrapper call ran (the profiler's count),
            # and the device time with L2 evicted by reads: the write flush
            # leaves dirty lines that the call's reads then write back
            into["by_level"][key]["kernels_a_call"] = _profile_device_us(torch, kernel, DEVICE_KERNELS[name])[1]
            into["by_level"][key]["device_ms_clean_l2"] = _device_ms(
                torch, kernel, DEVICE_KERNELS[name], 20, read_flush
            )

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
            # dt's call counts (integer channels), gb's sums
            timed(
                "leaf_sums", key,
                lambda: trees.leaf_sums(node, channels, n_leaves, integer=mode == "gini"),
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
            lambda: trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=mode == "gini"),
            lambda: trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS),
            lambda: [torch.bincount(flat, weights=w, minlength=n_nodes * FEATURES * MAX_BINS) for w in weights],
            n_nodes, K,
        )
        results["level_histograms"]["by_level"][key]["k2_path"] = _histogram_path(rows, n_nodes, K, mode == "gini")
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
                lambda: trees.leaf_sums(node, channels, n_leaves, integer=True),
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
            lambda: trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True),
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
    # K3 also at the deep dt's last level (2,048 nodes x 10 classes) and at
    # 255 bins x 10 classes (16 nodes), beside the card's launch floor
    by_shape = results["select_splits"]["by_shape"] = {}
    for name in ("2048_nodes_10_classes", "255_bins_10_classes"):
        hist, mode = k3_edges["cases"][name]
        n_nodes, B, K = hist.shape[0], hist.shape[2], hist.shape[3]
        bound_ms, bound_by = _fit_bound("select_splits", rows, n_nodes, K, max_bins=B)
        by_shape[name] = {
            "ms": _event_ms(torch, lambda: trees.select_splits(hist, mode), 20, flush),
            "device_ms": _device_ms(torch, lambda: trees.select_splits(hist, mode),
                                    DEVICE_KERNELS["select_splits"], 20, flush),
            "plain_ms": _event_ms(torch, lambda: trees._select_plain(hist, mode), 3, flush),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        }
    results["select_splits"]["launch_floor_ms"] = _launch_floor_ms(torch, flush)
    forest_checks = {"subset_edges": forest["subset_edges"], "wide_level": forest["wide_level"]}
    X, y = bench_synthetic(FIT_ROWS)
    repairs = check_repairs(torch, X, y)
    results.update(check_logistic_kernels(torch, X, y, flush))
    emit({
        "phase": "fit-kernels", "rows": rows, "features": FEATURES, "max_bins": MAX_BINS,
        **results, "repairs": repairs, "forest_checks": forest_checks,
        "k7_wide": check_k7_wide(torch),
        "k7_empty": check_k7_empty(torch),
        "k1_edges": k1_edges, "k3_edges": k3_edges["outcomes"],
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
        "level_histograms": _plain_histograms,
        "select_splits": trees._select_plain,
        "route": trees._route,
        "leaf_sums": _plain_leaf_sums,
    }):
        yield


def _plain_histograms(bins, node, channels, n_nodes, max_bins, integer=False):
    """K2's plain version in the wrappers' signature (the plain version's
    float64 sums are the same for integer channels and any others)."""
    return trees._level_histograms(bins, node, channels, n_nodes, max_bins)


def _plain_leaf_sums(leaf_of_row, channels, n_leaves, integer=False):
    """K5's plain version in the wrappers' signature (as K2's)."""
    return trees._leaf_sums(leaf_of_row, channels, n_leaves)


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
        before = kernels.launches()
        accuracy, weighted_f1, labels, probs = model.evaluate_predict(X, y, X)
        evaluate_launches = {
            kernel: count - before.get(kernel, 0)
            for kernel, count in kernels.launches().items() if count != before.get(kernel, 0)
        }
        if probs.shape != (rows, CLASSES) or not np.isfinite(probs).all():
            raise AssertionError(f"{name}: probabilities of shape {probs.shape}")
        if not 0.5 < accuracy <= 1.0:
            raise AssertionError(f"{name}: accuracy {accuracy}")
        models[name] = model
        record[name] = {
            "wall_s": wall_s,
            "launches": launches,
            "evaluate_launches": evaluate_launches,
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


# --------------------------------------------------------------------------
# The image lane: t-SNE's kernels K11-K13 and the tsne and pca services
# --------------------------------------------------------------------------

def embed_blobs(rows: int, seed: int = 7):
    """bench.py's embedding data (its ``blobs``): 16 float32 features
    around 10 centres drawn at 8 times the unit noise; and each row's
    centre."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(10, FEATURES)) * 8.0
    labels = rng.integers(0, 10, size=rows)
    X = (centres[labels] + rng.normal(size=(rows, FEATURES))).astype(np.float32)
    return X, labels


def _tsne_bound(name: str, rows: int, columns: int, features: int) -> tuple[float, str]:
    """Least milliseconds the card could take for one call: bytes (inputs
    read once, outputs written once) over HBM bandwidth against the
    float32 instructions of its pairs over the card's instruction rate:
    ``rows`` x ``columns`` for K11 and K13, the ``rows (rows - 1) / 2``
    unordered pairs for K12. K11: X in, P out; K12: Y in (and P for the
    gradient), Z or the gradient out; K13: rows, landmarks and their
    embedding in, (rows, 2) out."""
    pairs = rows * columns
    unordered = rows * (rows - 1) // 2
    distance = features + 3
    if name == "tsne_affinities":
        bytes_moved = rows * features * 4 + pairs * 4
        instructions = pairs * (distance + TSNE_AFFINITY_INSTRUCTIONS)
    elif name == "tsne_z":
        bytes_moved = rows * 8 + 4
        instructions = unordered * (TSNE_INVERSE_INSTRUCTIONS + 1)
    elif name == "tsne_grad":
        bytes_moved = pairs * 4 + rows * 8 * 2 + 4
        instructions = unordered * TSNE_GRADIENT_PAIR_INSTRUCTIONS
    else:
        bytes_moved = (rows + columns) * features * 4 + columns * 8 + rows * 8
        instructions = pairs * (distance + TSNE_INTERPOLATION_INSTRUCTIONS)
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = instructions / PEAK_FP32_INSTRUCTIONS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


@contextlib.contextmanager
def _plain_tsne():
    """Within the block, the t-SNE fits run K11-K13's plain versions in
    place of the kernels, on any device. Raises if a kernel launched."""
    with _plain(tsne, {
        "conditional_affinities": tsne._conditional_affinities,
        "tsne_z": tsne._tsne_z,
        "tsne_grad": tsne._tsne_grad,
        "interpolate": tsne._interpolate,
    }):
        yield


@contextlib.contextmanager
def _distances_in_global_memory():
    """Within the block, K11 and K13 keep a row's distances in global
    memory, as past ~57,000 columns, and not in shared memory."""
    saved = tsne._SHARED_DISTANCE_BYTES
    tsne._SHARED_DISTANCE_BYTES = 0
    try:
        yield
    finally:
        tsne._SHARED_DISTANCE_BYTES = saved


# K12 on a seeded non-symmetric P (the kernels assume no symmetry): no
# pair, one pair, and ragged tiles at n % 4 != 0 (4-byte copies of P) and
# n % 4 == 0 (16-byte copies)
K12_EDGE_ROWS = (1, 2, 2 * tsne.PAIR_TILE + 5, 300)


def check_k12_edges(torch, device, held, failures) -> dict:
    """Z and the gradient on a non-symmetric P at ``K12_EDGE_ROWS``,
    against the plain versions with the main path's tolerances (the
    gradient no farther from float64 than the plain version), and a
    second launch bit identical. Where there is no pair (n = 1) both are
    0: errors are absolute there."""
    rng = np.random.default_rng(11)
    edges = {}
    for n in K12_EDGE_ROWS:
        key = f"{n}:non-symmetric"
        Y = torch.from_numpy((rng.normal(size=(n, 2)) * 10.0).astype(np.float32)).to(device)
        P = torch.from_numpy(rng.random((n, n), dtype=np.float32)).to(device)
        P /= P.sum()
        exaggeration = tsne.EARLY_EXAGGERATION
        Z, Z_plain = tsne.tsne_z(Y), tsne._tsne_z(Y)
        grad = tsne.tsne_grad(Y, P, Z, exaggeration)
        grad_plain = tsne._tsne_grad(Y, P, Z_plain, exaggeration)
        Y64 = Y.double()
        grad64 = tsne._tsne_grad(Y64, P.double(), tsne._tsne_z(Y64), exaggeration)
        z_difference = float((Z.double() - Z_plain.double()).abs())
        z_checked = held("tsne_z", key, z_difference, z_difference / (float(Z_plain) or 1.0), K12_Z_RTOL)
        scale64 = float(grad64.abs().max()) or 1.0
        float64_err = float((grad - grad64).abs().max()) / scale64
        plain_float64_err = float((grad_plain - grad64).abs().max()) / scale64
        difference = float((grad - grad_plain).abs().max())
        grad_checked = held(
            "tsne_grad", key, difference, difference / (float(grad_plain.abs().max()) or 1.0),
            max(K12_PLAIN_TOL, 2.0 * plain_float64_err + K12_FLOAT64_SLACK),
            {"float64_err": float64_err, "plain_float64_err": plain_float64_err},
        )
        if not float64_err <= plain_float64_err + K12_FLOAT64_SLACK:
            failures.append(
                f"tsne_grad at {key}: {float64_err} from float64, farther "
                f"than the plain version's {plain_float64_err}"
            )
        if not (torch.equal(tsne.tsne_z(Y), Z) and torch.equal(tsne.tsne_grad(Y, P, Z, exaggeration), grad)):
            failures.append(f"K12 at {key}: a second launch differs")
        edges[key] = {"z": z_checked, "grad": grad_checked}
    return edges


def _card(torch):
    return torch.device("cuda", torch.cuda.current_device())


def embed_store():
    """bench.py's blobs in the port's store, as the image requests read
    them: ``blobs_1m`` (1,000,000 rows, class numbers in the label
    column) and ``blobs_20k`` (20,000 rows, class names, label-encoded in
    sorted order, c0 < c1 < ...). Returns the store, each collection's
    labels and the seconds the writes took."""
    from learningorchestra_tpu_torch.core.store import InMemoryStore
    from learningorchestra_tpu_torch.core.table import ColumnTable, write_table

    started = time.perf_counter()
    store = InMemoryStore()
    labels_by_name = {}
    for name, rows, seed, string_labels in (
        ("blobs_1m", EMBED_ROWS, 7, False), ("blobs_20k", EXACT_ROWS, 8, True),
    ):
        X, labels = embed_blobs(rows, seed)
        columns = {f"f{k}": X[:, k].astype(np.float64) for k in range(FEATURES)}
        columns["label"] = (
            np.array([f"c{label}" for label in labels], dtype=object)
            if string_labels else labels.astype(np.float64)
        )
        write_table(
            store, name, ColumnTable(columns),
            {"filename": name, "finished": True, "fields": list(columns)},
        )
        labels_by_name[name] = labels
    return store, labels_by_name, time.perf_counter() - started


def phase_embed_kernels(torch, store) -> dict:
    """K11, K12 and K13 against their plain versions on the card, on the
    main path's own matrices (the store's blobs as the image requests read
    them, label column included), each timed cold beside its bound. Every
    check runs and is reported; the phase raises at its end if any
    failed."""
    from learningorchestra_tpu_torch.core.devcache import dataset_embedding_inputs

    started = time.perf_counter()
    device = _card(torch)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    results = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0, "by_rows": {}} for name in TSNE_KERNELS}
    failures: list = []

    def held(name, key, abs_err, rel_err, tolerance, extra=None):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], abs_err)
        results[name]["max_rel_err"] = max(results[name]["max_rel_err"], rel_err)
        if not rel_err <= tolerance:
            failures.append(f"{name} at {key}: error {rel_err} against a tolerance of {tolerance}")
        return {"abs_err": abs_err, "rel_err": rel_err, "tolerance": tolerance, **(extra or {})}

    def plain_call(fn):
        """One call of a plain version, cold: its result and milliseconds."""
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        return result, start.elapsed_time(end)

    def timed(name, key, kernel, plain_ms, bound, repeats, checked):
        bound_ms, bound_by = bound
        results[name]["by_rows"][key] = {
            "ms": _event_ms(torch, kernel, repeats, flush),
            "device_ms": _device_ms(torch, kernel, DEVICE_KERNELS[name], repeats, flush),
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            **checked,
        }

    # the main path's matrices: the 20,000-row exact fit's, and the
    # landmark fit's 5,000 rows of the 1,000,000 (the requests' seed, 0)
    _, _, X_exact = dataset_embedding_inputs(store, "blobs_20k", device)
    _, _, X_all = dataset_embedding_inputs(store, "blobs_1m", device)
    chosen = torch.from_numpy(tsne._choose_landmarks(len(X_all), tsne.LANDMARKS, 0)).to(device)
    fit_inputs = {tsne.LANDMARKS: X_all[chosen], EXACT_ROWS: X_exact}
    features = X_all.shape[1]

    # K11: each row's calibrated p, at the two fits' rows and at the
    # 2,048-row quality fit's (the 20,000 rows' first)
    for rows, X in {QUALITY_ROWS: X_exact[:QUALITY_ROWS].contiguous(), **fit_inputs}.items():
        perplexity = tsne._clamped_perplexity(tsne.PERPLEXITY, rows)
        got = tsne.conditional_affinities(X, perplexity)
        want, plain_ms = plain_call(lambda: tsne._conditional_affinities(X, perplexity))
        again = tsne.conditional_affinities(X, perplexity)
        torch.cuda.synchronize()
        difference = (got - want).abs_()
        row_error = (difference / want.amax(dim=1, keepdim=True)).amax(dim=1)
        checked = held(
            "tsne_affinities", rows, float(difference.max()), float(row_error.max()), K11_TOL,
            {
                # rows past the tolerance: a bisection step that took the
                # other branch on a knife edge
                "rows_past_tolerance": int((row_error > K11_TOL).sum()),
                "rows_past_1e-5": int((row_error > 1e-5).sum()),
                "row_sums_err": float((got.double().sum(dim=1) - 1.0).abs().max()),
            },
        )
        del difference, row_error
        if not torch.equal(got, again):
            failures.append(f"tsne_affinities at {rows}: a second launch differs")
        if not (torch.isfinite(got).all() and bool((got.diagonal() == 0).all())):
            failures.append(f"tsne_affinities at {rows}: non-finite p or self affinity")
        if rows == tsne.LANDMARKS:
            # the distances in global memory (past ~57,000 rows) give the
            # same bits as in shared memory
            with _distances_in_global_memory():
                in_global = tsne.conditional_affinities(X, perplexity)
            checked["global_distances_identical"] = bool(torch.equal(in_global, got))
            if not checked["global_distances_identical"]:
                failures.append("tsne_affinities: distances in global memory change the result")
            del in_global
        del got, want, again
        timed(
            "tsne_affinities", rows,
            lambda: tsne.conditional_affinities(X, perplexity), plain_ms,
            _tsne_bound("tsne_affinities", rows, rows, features), 3, checked,
        )
        torch.cuda.empty_cache()

    # K12 on each fit's own P: Z and the gradient at its start Y0
    # (exaggerated) and at its final embedding (late); then three
    # iterations of the optimizer from each
    fitted = {}
    for rows, X in fit_inputs.items():
        P = tsne.affinities(X, tsne._clamped_perplexity(tsne.PERPLEXITY, rows))
        Y0 = tsne._initial_embedding(rows, 0, device)
        fitted[rows] = tsne._tsne_exact(X, tsne.PERPLEXITY, tsne.ITERATIONS, tsne.LEARNING_RATE, Y0)
        for phase, Y, exaggeration in (
            ("early", Y0, tsne.EARLY_EXAGGERATION), ("late", fitted[rows], 1.0),
        ):
            key = f"{rows}:{phase}"
            Z = tsne.tsne_z(Y)
            Z_plain, z_plain_ms = plain_call(lambda: tsne._tsne_z(Y))
            grad = tsne.tsne_grad(Y, P, Z, exaggeration)
            grad_plain, grad_plain_ms = plain_call(lambda: tsne._tsne_grad(Y, P, Z_plain, exaggeration))
            z_error = float((Z.double() - Z_plain.double()).abs() / Z_plain.double())
            z_checked = held("tsne_z", key, float((Z - Z_plain).abs()), z_error, K12_Z_RTOL)
            Y64, P64 = Y.double(), P.double()
            grad64 = tsne._tsne_grad(Y64, P64, tsne._tsne_z(Y64), exaggeration)
            del P64
            scale64 = float(grad64.abs().max())
            float64_err = float((grad - grad64).abs().max()) / scale64
            plain_float64_err = float((grad_plain - grad64).abs().max()) / scale64
            del grad64
            difference = float((grad - grad_plain).abs().max())
            grad_checked = held(
                "tsne_grad", key, difference, difference / float(grad_plain.abs().max()),
                max(K12_PLAIN_TOL, 2.0 * plain_float64_err + K12_FLOAT64_SLACK),
                {
                    "float64_err": float64_err, "plain_float64_err": plain_float64_err,
                    # the (tiles, n, 3) float64 partials beside P's bytes
                    "partials_bytes": tsne._tile_pairs(rows)[0] * rows * 3 * 8,
                    "p_bytes": rows * rows * 4,
                },
            )
            if not float64_err <= plain_float64_err + K12_FLOAT64_SLACK:
                failures.append(
                    f"tsne_grad at {key}: {float64_err} from float64, farther "
                    f"than the plain version's {plain_float64_err}"
                )
            torch.cuda.empty_cache()
            if not (torch.equal(tsne.tsne_z(Y), Z) and torch.equal(tsne.tsne_grad(Y, P, Z, exaggeration), grad)):
                failures.append(f"K12 at {key}: a second launch differs")
            early_phase = 3 if phase == "early" else 0
            stepped = tsne._optimize(P, Y, 3, early_phase, tsne.LEARNING_RATE, tsne.EARLY_EXAGGERATION)
            with _plain_tsne():
                stepped_plain = tsne._optimize(
                    P, Y, 3, early_phase, tsne.LEARNING_RATE, tsne.EARLY_EXAGGERATION
                )
            step_error = float((stepped - stepped_plain).abs().max() / stepped_plain.abs().max())
            grad_checked["three_iterations_err"] = step_error
            if not step_error <= K12_TOL:
                failures.append(f"K12 at {key}: three iterations apart by {step_error}")
            timed(
                "tsne_z", key, lambda: tsne.tsne_z(Y), z_plain_ms,
                _tsne_bound("tsne_z", rows, rows, features), 20, z_checked,
            )
            timed(
                "tsne_grad", key, lambda: tsne.tsne_grad(Y, P, Z, exaggeration), grad_plain_ms,
                _tsne_bound("tsne_grad", rows, rows, features), 20, grad_checked,
            )
        del P
        torch.cuda.empty_cache()
    results["tsne_grad"]["edges"] = check_k12_edges(torch, device, held, failures)

    # K13: the 1,000,000 rows onto the landmarks' fitted embedding, the
    # main path's one launch; and their first 65,536 rows
    L, Y_L = fit_inputs[tsne.LANDMARKS], fitted[tsne.LANDMARKS]
    perplexity = tsne._clamped_perplexity(tsne.PERPLEXITY, tsne.LANDMARKS)
    for rows in (EMBED_ROWS, INTERP_ROWS):
        X = X_all[:rows]
        key = f"{rows}x{tsne.LANDMARKS}"
        got = tsne.interpolate(X, L, Y_L, perplexity)
        want, plain_ms = plain_call(lambda: tsne._interpolate(X, L, Y_L, perplexity))
        difference = float((got - want).abs().max())
        checked = held("tsne_interpolate", key, difference, difference / float(Y_L.abs().max()), K13_TOL)
        if not torch.equal(tsne.interpolate(X, L, Y_L, perplexity), got):
            failures.append(f"tsne_interpolate at {key}: a second launch differs")
        # the main path keeps a row's 5,000 distances in shared memory; in
        # global scratch (a grid of fewer blocks walking the rows) they
        # give the same bits
        with _distances_in_global_memory():
            checked["global_distances_identical"] = bool(
                torch.equal(tsne.interpolate(X, L, Y_L, perplexity), got)
            )
        if not checked["global_distances_identical"]:
            failures.append(f"tsne_interpolate at {key}: distances in global memory change the result")
        del got, want
        timed(
            "tsne_interpolate", key, lambda: tsne.interpolate(X, L, Y_L, perplexity), plain_ms,
            _tsne_bound("tsne_interpolate", rows, tsne.LANDMARKS, features), 3, checked,
        )
    pca_times = time_pca(torch, flush, X_all)
    emit({
        "phase": "embed-kernels", "features": features, **results, "pca": pca_times,
        "failures": failures, "seconds": time.perf_counter() - started,
    })
    if failures:
        raise AssertionError(f"embed-kernels: {failures}")
    return results


def time_pca(torch, flush, X) -> dict:
    """K10 (``ops/pca.py:_pca``, torch ops and ``torch.linalg.eigh``) on
    the main path's matrix ``X`` (bench.py's 1,000,000 blobs with their
    label column), cold and warm, beside its bound: the rows read once and
    the (rows, 2) embedding written once over HBM bandwidth against its
    float32 operations (the covariance's 2 n F^2 and the projection's
    4 n F, the centring's 3 n F)."""
    mask = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    rows, features = X.shape

    def call():
        return pca._pca(X, mask, 2)

    byte_ms = (rows * features * 4 + rows * 2 * 4) / PEAK_BYTES_PER_S * 1e3
    op_ms = rows * features * (2 * features + 4 * 2 + 3) / PEAK_FP32_OPS_PER_S * 1e3
    embedded, _, _ = call()
    if embedded.shape != (rows, 2) or not bool(torch.isfinite(embedded).all()):
        raise AssertionError(f"pca: an embedding of shape {tuple(embedded.shape)}, or not finite")
    return {
        "rows": rows, "features": features,
        "ms": _event_ms(torch, call, 10, flush),
        "warm_ms": _event_ms(torch, call, 10),
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
    }


def knn_agreement(embedded: np.ndarray, labels: np.ndarray, sample: int, seed: int = 0) -> float:
    """The share of the k = 10 nearest neighbours (in the embedding, among
    ``sample`` rows drawn with ``seed``) that carry the row's label."""
    rows = len(embedded)
    chosen = np.random.default_rng(seed).choice(rows, size=min(sample, rows), replace=False)
    points = np.asarray(embedded, np.float64)[chosen]
    norms = (points * points).sum(axis=1)
    distances = norms[:, None] + norms[None, :] - 2.0 * points @ points.T
    np.fill_diagonal(distances, np.inf)
    nearest = np.argpartition(distances, QUALITY_K, axis=1)[:, :QUALITY_K]
    picked = labels[chosen]
    return float((picked[nearest] == picked[:, None]).mean())


def kl_divergence(torch, P, Y, block: int = 2_048) -> float:
    """t-SNE's objective: KL(P || Q) over the pairs i != j, where
    Q = (1 + |y_i - y_j|^2)^-1 / Z, in float64 on P's device, a block of
    rows at a time."""
    Y = torch.as_tensor(Y).to(P.device, torch.float64)
    n = Y.shape[0]
    norms = (Y * Y).sum(dim=1)

    def inverse(start):
        stop = min(start + block, n)
        d = norms[start:stop, None] + norms[None, :] - 2.0 * (Y[start:stop] @ Y.T)
        inv = 1.0 / (1.0 + d.clamp_min_(0.0))
        inv[torch.arange(stop - start), torch.arange(start, stop)] = 0.0
        return inv

    Z = sum(inverse(start).sum() for start in range(0, n, block))
    total = torch.zeros((), dtype=torch.float64, device=P.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        p = P[start:stop].double()
        terms = p * (torch.log(p) - torch.log(inverse(start) / Z))
        terms[torch.arange(stop - start), torch.arange(start, stop)] = 0.0
        total += terms.sum()
    return float(total)


def _read_png_header(data: bytes) -> tuple[int, int]:
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError("the image is not a PNG")
    width, height = struct.unpack(">II", data[16:24])
    return width, height


def _kl_held(torch, X, perplexity, fit, plain_fit, what: str) -> dict:
    """KL(P || Q) of a fit and of the plain versions' fit on the same P
    (the plain version's); raises if they differ by more than KL_MARGIN
    of the plain fit's."""
    P = tsne._affinities(X, tsne._clamped_perplexity(perplexity, X.shape[0]))
    kl = {"kernels": kl_divergence(torch, P, fit), "plain": kl_divergence(torch, P, plain_fit)}
    kl["rel_diff"] = abs(kl["kernels"] - kl["plain"]) / kl["plain"]
    kl["margin"] = KL_MARGIN
    if not kl["rel_diff"] <= KL_MARGIN:
        raise AssertionError(f"{what}: KL(P || Q) of the kernels' fit and the plain fit differ: {kl}")
    return kl


def phase_embed(torch, card: str, store, labels_by_name: dict, setup_s: float) -> dict:
    """The image lane end to end: the port's tsne and pca services over
    real HTTP on ``store``, PNGs read back, the kernels' launches per
    request, each request's t-SNE fits and interpolation held against the
    plain versions on the same inputs, the embeddings' quality, and
    bit-identical refits."""
    from learningorchestra_tpu_torch.core.devcache import dataset_embedding_inputs
    from learningorchestra_tpu_torch.ops import images as image_ops
    from learningorchestra_tpu_torch.services import images as image_services

    started = time.perf_counter()
    captured, fits, interpolations = {}, {}, {}
    real_scatter, real_exact, real_interpolate = image_ops._scatter_png, tsne._tsne_exact, tsne.interpolate
    current = [None]

    # the requests' own fits and interpolation, with their inputs, for the
    # checks below (the kernels' launches are read before the checks)
    def scatter(embedded, hue, image_path):
        captured[os.path.basename(image_path)] = embedded
        real_scatter(embedded, hue, image_path)

    def exact(X, perplexity, iterations, learning_rate, Y0):
        Y = real_exact(X, perplexity, iterations, learning_rate, Y0)
        fits[current[0]] = (X, perplexity, iterations, learning_rate, Y0, Y)
        return Y

    def interpolate(X, landmarks, Y_landmarks, perplexity):
        out = real_interpolate(X, landmarks, Y_landmarks, perplexity)
        interpolations.setdefault(current[0], []).append((X, landmarks, Y_landmarks, perplexity, out))
        return out

    requests = (
        ("pca", "blobs_1m", "pca_1m"),
        ("tsne", "blobs_1m", "tsne_1m"),    # auto: landmark
        ("tsne", "blobs_20k", "tsne_20k"),  # auto: exact
    )
    expected_launches = {
        "pca_1m": dict.fromkeys(TSNE_KERNELS, 0),
        "tsne_1m": {"tsne_affinities": 1, "tsne_z": tsne.ITERATIONS, "tsne_grad": tsne.ITERATIONS,
                    "tsne_interpolate": 1},
        "tsne_20k": {"tsne_affinities": 1, "tsne_z": tsne.ITERATIONS, "tsne_grad": tsne.ITERATIONS,
                     "tsne_interpolate": 0},
    }
    answers = {}
    image_ops._scatter_png, tsne._tsne_exact, tsne.interpolate = scatter, exact, interpolate
    try:
        with tempfile.TemporaryDirectory() as images_dir:
            servers = {
                method: ServerThread(image_services.create_app(store, images_dir, method)).start()
                for method in ("pca", "tsne")
            }
            try:
                for method, parent, name in requests:
                    client = _Client(servers[method].port)
                    current[0] = name
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                    began = time.perf_counter()
                    status, body = client.call(
                        "POST", f"/images/{parent}",
                        {f"{method}_filename": name, "label_name": "label"},
                    )
                    wall_s = time.perf_counter() - began
                    launches = {k: kernels.launches()[k] for k in TSNE_KERNELS}
                    if (status, body) != (201, {"result": "created_file"}):
                        raise AssertionError(f"POST {name}: {status} {body}")
                    if launches != expected_launches[name]:
                        raise AssertionError(
                            f"{name}: launches {launches}, expected {expected_launches[name]}"
                        )
                    with client.opener.open(f"{client.base}/images/{name}", timeout=120) as response:
                        png = response.read()
                        kind = response.headers["Content-Type"]
                    if kind != "image/png" or _read_png_header(png) != (image_ops.WIDTH, image_ops.HEIGHT):
                        raise AssertionError(f"GET {name}: {kind}, {_read_png_header(png)}")
                    answers[name] = {
                        "method": method, "rows": len(labels_by_name[parent]), "wall_s": wall_s,
                        "launches": launches, "png_bytes": len(png),
                    }
                status, body = _Client(servers["tsne"].port).call("GET", "/images")
                if status != 200 or sorted(body["result"]) != sorted(f"{n}.png" for _, _, n in requests):
                    raise AssertionError(f"GET /images: {status} {body}")
            finally:
                for server in servers.values():
                    server.stop()
    finally:
        image_ops._scatter_png, tsne._tsne_exact, tsne.interpolate = real_scatter, real_exact, real_interpolate

    # the embeddings: shape, finiteness, k = 10 label agreement
    for _, parent, name in requests:
        embedded = captured[f"{name}.png"]
        if embedded.shape != (len(labels_by_name[parent]), 2) or not np.isfinite(embedded).all():
            raise AssertionError(f"{name}: an embedding of shape {embedded.shape}, or not finite")
        answers[name]["knn_agreement"] = knn_agreement(embedded, labels_by_name[parent], QUALITY_SAMPLE)

    # each request's exact fit (the 20,000 rows; the 1,000,000 rows'
    # 5,000 landmarks) against the plain versions' fit from the same X and
    # Y0, by KL(P || Q); the landmark request's interpolation against the
    # plain version on the same rows, landmarks and fitted embedding
    if sorted(fits) != ["tsne_1m", "tsne_20k"] or sorted(interpolations) != ["tsne_1m"]:
        raise AssertionError(f"captured fits {sorted(fits)}, interpolations {sorted(interpolations)}")
    for name, (X, perplexity, iterations, learning_rate, Y0, Y) in fits.items():
        began = time.perf_counter()
        with _plain_tsne():
            plain_fit = real_exact(X, perplexity, iterations, learning_rate, Y0)
        answers[name]["fit_rows"] = X.shape[0]
        answers[name]["kl"] = _kl_held(torch, X, perplexity, Y, plain_fit, f"{name}'s fit")
        answers[name]["kl"]["plain_fit_s"] = time.perf_counter() - began
        del plain_fit
        torch.cuda.empty_cache()
    (X, L, Y_L, perplexity, out), = interpolations["tsne_1m"]
    if X.shape[0] != EMBED_ROWS or L.shape[0] != tsne.LANDMARKS or Y_L is not fits["tsne_1m"][5]:
        raise AssertionError("the landmark request interpolated other inputs than its own")
    difference = float((out - tsne._interpolate(X, L, Y_L, perplexity)).abs().max())
    answers["tsne_1m"]["interpolation"] = {
        "abs_err": difference, "rel_err": difference / float(Y_L.abs().max()), "tolerance": K13_TOL,
    }
    if not answers["tsne_1m"]["interpolation"]["rel_err"] <= K13_TOL:
        raise AssertionError(f"tsne_1m's interpolation: {answers['tsne_1m']['interpolation']}")
    del fits, interpolations, X, L, Y_L, out
    torch.cuda.empty_cache()

    # the same exact fit at 2,048 rows, by the kernels and by the plain
    # versions, from the same Y0; and two embeddings the KL gate must
    # refuse: the kernels' fit stopped at half its iterations, and the PCA
    # projection scaled to the fit's spread
    _, _, X_exact = dataset_embedding_inputs(store, "blobs_20k")
    X_small = X_exact[:QUALITY_ROWS].contiguous()
    labels_small = labels_by_name["blobs_20k"][:QUALITY_ROWS]
    Y0 = tsne._initial_embedding(QUALITY_ROWS, 0, X_small.device)
    kernel_fit = tsne._tsne_exact(X_small, tsne.PERPLEXITY, tsne.ITERATIONS, tsne.LEARNING_RATE, Y0)
    with _plain_tsne():
        plain_fit = tsne._tsne_exact(X_small, tsne.PERPLEXITY, tsne.ITERATIONS, tsne.LEARNING_RATE, Y0)
    quality = {
        "rows": QUALITY_ROWS,
        "kernels": knn_agreement(kernel_fit.cpu().numpy(), labels_small, QUALITY_SAMPLE),
        "plain": knn_agreement(plain_fit.cpu().numpy(), labels_small, QUALITY_SAMPLE),
        "margin": QUALITY_MARGIN,
        "kl": _kl_held(torch, X_small, tsne.PERPLEXITY, kernel_fit, plain_fit, "the 2,048-row fit"),
    }
    if abs(quality["kernels"] - quality["plain"]) > QUALITY_MARGIN:
        raise AssertionError(f"the kernels' fit and the plain fit differ in quality: {quality}")
    for name in ("tsne_1m", "tsne_20k"):
        if answers[name]["knn_agreement"] < quality["plain"] - QUALITY_MARGIN:
            raise AssertionError(f"{name}: quality {answers[name]['knn_agreement']} below {quality}")
    half_fit = tsne._tsne_exact(X_small, tsne.PERPLEXITY, tsne.ITERATIONS // 2, tsne.LEARNING_RATE, Y0)
    projected = torch.from_numpy(pca.pca_embedding(X_small, device=X_small.device)).to(X_small.device)
    projected *= (kernel_fit.square().sum(dim=1).mean() / projected.square().sum(dim=1).mean()).sqrt()
    P_small = tsne._affinities(X_small, tsne.PERPLEXITY)
    quality["kl_controls"] = {}
    for control, embedded in (("half_iterations", half_fit), ("pca_scaled", projected)):
        kl = kl_divergence(torch, P_small, embedded)
        quality["kl_controls"][control] = kl
        if abs(kl - quality["kl"]["plain"]) <= KL_MARGIN * quality["kl"]["plain"]:
            raise AssertionError(f"the KL gate takes {control} ({kl}) for a fit: {quality['kl']}")

    # refits from the same seed, through the same reads
    refits = {}
    for parent, name in (("blobs_20k", "tsne_20k"), ("blobs_1m", "tsne_1m")):
        _, _, X = dataset_embedding_inputs(store, parent)
        began = time.perf_counter()
        again = tsne.tsne_embedding(X, device=X.device)
        refits[name] = {"seconds": time.perf_counter() - began,
                        "identical": bool(np.array_equal(again, captured[f"{name}.png"]))}
        if not refits[name]["identical"]:
            raise AssertionError(f"{name}: a refit from the same seed differs")
    launches_total = {
        kernel: sum(answer["launches"][kernel] for answer in answers.values()) for kernel in TSNE_KERNELS
    }
    record = {
        "phase": "embed", "setup_s": setup_s, "requests": answers,
        "quality": quality, "refits": refits, "launches": launches_total, "nvidia_smi": card,
        "seconds": time.perf_counter() - started,
    }
    emit(record)
    return record


# --------------------------------------------------------------------------
# Sweeps and job coalescing: the fused programs (K14) over the job axis of
# K7, K1, K2, K4, K5 and K6
# --------------------------------------------------------------------------

SWEEP_SOURCE = "learningorchestra_tpu_torch/ml/sweep.py"
# job-axis rows of the kernels line: (kernel counter, source, what it replaces)
JOB_KERNELS = {
    "logistic_loss_grad:jobs": (
        "logistic_loss_grad", LOGISTIC_SOURCE,
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn (masked) under value_and_grad, "
        "vmapped in learningorchestra_tpu/ml/sweep.py:237 _lr_fused_segment",
    ),
    "logistic_trial_losses:jobs": (
        "logistic_trial_losses", LOGISTIC_SOURCE,
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn (masked) in the Armijo loop, "
        "vmapped in learningorchestra_tpu/ml/sweep.py:237 _lr_fused_segment",
    ),
    "apply_bins:jobs": (
        "apply_bins", FIT_SOURCE,
        "learningorchestra_tpu/ml/binning.py:37 apply_bins, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "level_histograms:jobs": (
        "level_histograms", FIT_SOURCE,
        "learningorchestra_tpu/ml/trees.py:66 _level_histograms, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "select_splits:jobs": (
        "select_splits", FIT_SOURCE,
        "learningorchestra_tpu/ml/trees.py:160 _gini_gain and :196 _select_splits, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "route:jobs": (
        "route", FIT_SOURCE,
        "learningorchestra_tpu/ml/trees.py:235 _route, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "leaf_sums:jobs": (
        "leaf_sums", FIT_SOURCE,
        "learningorchestra_tpu/ml/trees.py:142 _leaf_sums, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "tree_ensemble_forward:jobs": (
        "tree_ensemble_forward", KERNEL_SOURCE,
        "learningorchestra_tpu/ml/trees.py:303 _descend under :364 _ensemble_forward, "
        "vmapped in learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
}
PROGRAM_REPLACES = {
    "lr_fused_segment": "learningorchestra_tpu/ml/sweep.py:237 _lr_fused_segment",
    "lr_fused_eval": "learningorchestra_tpu/ml/sweep.py:249 _lr_fused_eval",
    "dt_fused": "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
}
SWEEP_ROWS = FIT_ROWS          # bench.py's synthetic rows, seed 0
SWEEP_EVAL_ROWS = 200_000      # an eval draw of the same data, seed 1
SWEEP_POINTS = 100             # bench.py's sweep_100 grid: linspace(0, 1, 100)
SWEEP_MAX_ITER = 25            # bench.py's max_iter
SWEEP_DEPTHS = (2, 5, 8)
JOB_CHECK_JOBS = 8             # jobs of the per-job kernel checks
BIT_ROWS = FIT_ROWS            # rows of each bit-identity member
FLOOD_JOBS, FLOOD_ROWS = 64, 1024   # bench.py's coalesce flood
FLOOD_WINDOW_S = 0.010


@contextlib.contextmanager
def _plain_sweep():
    """Within the block, the fused programs run the plain versions of
    every job-axis kernel (K7's twins, K1, the level loop, K6), on any
    device. Raises if a kernel launched."""
    from learningorchestra_tpu_torch.ml import sweep

    with _plain(logistic, {
        "job_loss_and_grad": logistic._job_loss_fn,
        "job_trial_losses": logistic._job_trial_losses,
    }), _plain(sweep, {
        "apply_bins": binning._apply_bins,
        "job_apply_bins": binning._job_apply_bins,
    }), _plain(trees, {"job_ensemble_forward": trees._job_ensemble_forward}), _plain_level_loop():
        yield


def _outcome(outcomes):
    (status, value), = outcomes
    if status != "ok":
        raise AssertionError(f"a sweep member failed: {value!r}")
    return value


def _job_bound(name: str, rows: int, jobs: int, *, features: int = FEATURES, classes: int = CLASSES,
               x_shared: bool = False, weighted: bool = True, n_nodes: int = 1,
               bins_read: int = 0, depth: int = 0, bins_shared: bool = False) -> tuple[float, str]:
    """Least milliseconds for one job-axis call: each input read once
    (a shared X once, not once a job; K2's bins once when the jobs share
    them) and each output written once over HBM bandwidth, against its
    operations at their type's peak."""
    F, C, J, B = features, classes, jobs, MAX_BINS
    x_bytes = rows * F * 4 * (1 if x_shared else J)
    row_bytes = rows * (4 + (4 if weighted else 0)) * (1 if x_shared else J)
    fp64_ops = 0
    if name in ("logistic_loss_grad", "logistic_trial_losses"):
        trial = name == "logistic_trial_losses"
        candidates = 4 if trial else 1
        bytes_moved = x_bytes + row_bytes + J * candidates * (F * C + C) * 4 * 2
        fp32_ops = J * rows * candidates * (2 * F * C + 4 * C)
        fp64_ops = 0 if trial else J * rows * (2 * F * C + 2 * C + 2)
    elif name == "apply_bins":       # X, thresholds -> int8 bins; a 5-step search
        bytes_moved = x_bytes + J * F * (B - 1) * 4 + J * rows * F
        fp32_ops = J * rows * F * int(np.ceil(np.log2(B)))
    elif name == "level_histograms":  # each job's bins (or shared ones), node, channels -> histogram
        bytes_moved = rows * F * (1 if bins_shared else J) + J * (rows * 4 + rows * C * 4 + n_nodes * F * B * C * 4)
        fp32_ops = J * rows * F * C
    elif name == "route":            # node, a bin per split row, split -> node
        bytes_moved = J * (rows * 4 * 2 + n_nodes * 8) + bins_read
        fp32_ops = J * rows * 2
    elif name == "leaf_sums":
        bytes_moved = J * (rows * 4 + rows * C * 4 + n_nodes * C * 4)
        fp32_ops = J * rows * C
    elif name == "select_splits":
        bytes_moved = J * n_nodes * (F * B * C * 4 + 8)
        fp32_ops = J * n_nodes * F * B * (5 * C + 5)
    else:                            # tree_ensemble_forward: X, one tree a job -> probs
        nodes, leaves = 2**depth - 1, 2**depth
        bytes_moved = x_bytes + J * (nodes * 8 + leaves * C * 4) + J * rows * C * 4
        fp32_ops = J * rows * (depth + C)
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = (fp32_ops / PEAK_FP32_OPS_PER_S + fp64_ops / PEAK_FP64_OPS_PER_S) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _bit_equal_per_job(name: str, got, alone) -> None:
    """Raise unless job j of ``got`` equals ``alone(j)``, the same launch
    over job j alone, bit for bit."""
    import torch

    for j in range(got[0].shape[0]):
        for part, single in zip(got, alone(j)):
            if not torch.equal(part[j], single[0]):
                raise AssertionError(f"{name}: job {j} differs from a launch of that job alone")


K7_GROUP_JOBS = (1, 7, 112, 113)   # shared-X jobs: narrow groups, one wide group, and past it


def _job_rows_of(X, y, weights, j: int):
    """Job j's rows, labels and weights as a one-job launch takes them."""
    if X.dim() == 2:
        return X, y, weights
    return X[j:j + 1], y[j:j + 1], None if weights is None else weights[j:j + 1]


def check_k7_groups(torch, X_std, y_dev, mask) -> dict:
    """K7 over a job axis in each geometry its wrappers choose
    (``logistic._k7_geometry``), against its plain twins at K7_LOSS_RTOL
    and K7_GRAD_ATOL: jobs sharing the sweep's X in groups of 1, 7, 112 and
    113, and the flood's 64 stacked jobs of 1,024 rows (each its own data,
    its last 100 rows weighing 0), weighted and not, 2 and 10 classes.
    Each job bit-equal to a launch of it alone, a second launch bit
    identical. Returns the largest differences from the plain twins."""
    device = X_std.device
    rng = np.random.default_rng(62)
    boundaries = torch.linspace(-1.5, 1.5, DEEP_CLASSES - 1, device=device)

    def ten(X):
        return torch.bucketize(X[..., 0].contiguous(), boundaries).to(torch.int32)

    flood = [bench_synthetic(FLOOD_ROWS, seed=100 + i) for i in range(FLOOD_JOBS)]
    flood_X = torch.from_numpy(np.stack([
        logistic._standardized(X, *logistic.scaler_stats(X)) for X, _ in flood
    ])).to(device)
    flood_y = torch.from_numpy(np.stack([y for _, y in flood]).astype(np.int32)).to(device)
    flood_mask = torch.ones((FLOOD_JOBS, FLOOD_ROWS), dtype=torch.float32, device=device)
    flood_mask[:, -100:] = 0.0
    labels = {(CLASSES, 2): y_dev, (DEEP_CLASSES, 2): ten(X_std),
              (CLASSES, 3): flood_y, (DEEP_CLASSES, 3): ten(flood_X)}
    steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=device)
    errors = {"logistic_loss_grad:jobs": 0.0, "logistic_trial_losses:jobs": 0.0}
    cases = [(jobs, X_std, mask) for jobs in K7_GROUP_JOBS] + [(FLOOD_JOBS, flood_X, flood_mask)]
    for classes in (CLASSES, DEEP_CLASSES):
        for jobs, X, all_weights in cases:
            y = labels[classes, X.dim()]
            for weights in (all_weights, None):
                what = (f"{jobs} jobs, {'shared' if X.dim() == 2 else 'stacked'} X, {classes} classes, "
                        f"{'weighted' if weights is not None else 'unweighted'}")

                def on_card(*shape):
                    return torch.from_numpy((rng.normal(size=shape) * 0.3).astype(np.float32)).to(device)

                W, b = on_card(jobs, FEATURES, classes), on_card(jobs, classes)
                D, d = on_card(jobs, FEATURES, classes), on_card(jobs, classes)
                W4 = (W[:, None] + steps[None, :, None, None] * D[:, None]).contiguous()
                b4 = (b[:, None] + steps[None, :, None] * d[:, None]).contiguous()
                l2s = torch.from_numpy(rng.uniform(0.0, 1.0, jobs).astype(np.float32)).to(device)
                got = logistic.job_loss_and_grad(W, b, X, y, weights, l2s)
                again = logistic.job_loss_and_grad(W, b, X, y, weights, l2s)
                if not all(torch.equal(first, second) for first, second in zip(got, again)):
                    raise AssertionError(f"logistic_loss_grad:jobs ({what}): a second launch differs")
                _bit_equal_per_job(f"logistic_loss_grad:jobs ({what})", got, lambda j: logistic.job_loss_and_grad(
                    W[j:j + 1], b[j:j + 1], *_job_rows_of(X, y, weights, j), l2s[j:j + 1]))
                want = logistic._job_loss_fn(W, b, X, y, weights, l2s)
                loss_rel = float(((got[0] - want[0]).abs() / want[0].abs()).max())
                grad_err = max(float((got[i] - want[i]).abs().max()) for i in (1, 2))
                if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
                    raise AssertionError(
                        f"logistic_loss_grad:jobs ({what}): loss {loss_rel} relative, gradient {grad_err}")
                errors["logistic_loss_grad:jobs"] = max(
                    errors["logistic_loss_grad:jobs"], grad_err, float((got[0] - want[0]).abs().max()))
                trial = logistic.job_trial_losses(W4, b4, X, y, weights, l2s)
                if not torch.equal(trial, logistic.job_trial_losses(W4, b4, X, y, weights, l2s)):
                    raise AssertionError(f"logistic_trial_losses:jobs ({what}): a second launch differs")
                _bit_equal_per_job(f"logistic_trial_losses:jobs ({what})", (trial,), lambda j: (
                    logistic.job_trial_losses(W4[j:j + 1], b4[j:j + 1], *_job_rows_of(X, y, weights, j),
                                              l2s[j:j + 1]),))
                plain_trial = logistic._job_trial_losses(W4, b4, X, y, weights, l2s)
                trial_rel = float(((trial - plain_trial).abs() / plain_trial.abs()).max())
                if not trial_rel <= K7_LOSS_RTOL:
                    raise AssertionError(f"logistic_trial_losses:jobs ({what}): {trial_rel} relative")
                errors["logistic_trial_losses:jobs"] = max(
                    errors["logistic_trial_losses:jobs"], float((trial - plain_trial).abs().max()))
    return errors


def check_job_kernels(torch, X_std, y_dev, mask, X_raw, thresholds, X_eval) -> dict:
    """K7, K1, K2 (each job's own bins), K3, K4, K5 and K6 over JOB_CHECK_JOBS
    jobs, each job its own rows (the main rows rolled a job apart, so
    every job has its own padded rows), parameters and λ: each job's
    output bit-equal to a launch over that job alone, and within the
    existing tolerances of the plain version. Returns each kernel's
    largest difference from its plain version."""
    J, rows = JOB_CHECK_JOBS, X_std.shape[0]
    rng = np.random.default_rng(60)
    shifts = [j * (rows // J + 12_345) for j in range(J)]

    def rolled(tensor):
        return torch.stack([torch.roll(tensor, s, dims=0) for s in shifts])

    Xs, ys, ms, Xr = rolled(X_std), rolled(y_dev), rolled(mask), rolled(X_raw)
    device = X_std.device

    def on_card(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    errors = {}
    W = on_card((rng.normal(size=(J, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    b = on_card((rng.normal(size=(J, CLASSES)) * 0.3).astype(np.float32))
    D = on_card((rng.normal(size=(J, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    d = on_card((rng.normal(size=(J, CLASSES)) * 0.3).astype(np.float32))
    l2s = on_card(np.array([0.0, 0.1, 0.01, 0.5, 0.0, 0.2, 0.05, 1.0][:J], np.float32))
    steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=device)
    W4 = (W[:, None] + steps[None, :, None, None] * D[:, None]).contiguous()
    b4 = (b[:, None] + steps[None, :, None] * d[:, None]).contiguous()
    got = logistic.job_loss_and_grad(W, b, Xs, ys, ms, l2s)
    _bit_equal_per_job("logistic_loss_grad:jobs", got, lambda j: logistic.job_loss_and_grad(
        W[j:j + 1], b[j:j + 1], Xs[j:j + 1], ys[j:j + 1], ms[j:j + 1], l2s[j:j + 1]))
    want = logistic._job_loss_fn(W, b, Xs, ys, ms, l2s)
    loss_rel = float(((got[0] - want[0]).abs() / want[0].abs()).max())
    grad_err = max(float((got[i] - want[i]).abs().max()) for i in (1, 2))
    if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
        raise AssertionError(f"logistic_loss_grad:jobs: loss {loss_rel} relative, gradient {grad_err}")
    errors["logistic_loss_grad:jobs"] = max(grad_err, float((got[0] - want[0]).abs().max()))
    trial = logistic.job_trial_losses(W4, b4, Xs, ys, ms, l2s)
    _bit_equal_per_job("logistic_trial_losses:jobs", (trial,), lambda j: (logistic.job_trial_losses(
        W4[j:j + 1], b4[j:j + 1], Xs[j:j + 1], ys[j:j + 1], ms[j:j + 1], l2s[j:j + 1]),))
    plain_trial = logistic._job_trial_losses(W4, b4, Xs, ys, ms, l2s)
    trial_rel = float(((trial - plain_trial).abs() / plain_trial.abs()).max())
    if not trial_rel <= K7_LOSS_RTOL:
        raise AssertionError(f"logistic_trial_losses:jobs: {trial_rel} relative")
    errors["logistic_trial_losses:jobs"] = float((trial - plain_trial).abs().max())
    for name, error in check_k7_groups(torch, X_std, y_dev, mask).items():
        errors[name] = max(errors[name], error)

    # each job its own thresholds: the main ones stretched a little a job
    ths = torch.stack([thresholds * (1.0 + 1e-3 * j) for j in range(J)]).contiguous()
    bins = binning.job_apply_bins(Xr, ths)
    _bit_equal_per_job("apply_bins:jobs", (bins,), lambda j: (binning.job_apply_bins(Xr[j:j + 1], ths[j:j + 1]),))
    if not torch.equal(bins, binning._job_apply_bins(Xr, ths)):
        raise AssertionError("apply_bins:jobs: bins differ from the plain version")
    errors["apply_bins:jobs"] = 0.0

    n_nodes, n_leaves = 16, 2**DEPTH
    node = on_card(rng.integers(0, n_nodes, (J, rows)).astype(np.int32))
    channels = (torch.nn.functional.one_hot(ys.long(), CLASSES).to(torch.float32) * ms[..., None]).contiguous()
    hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True)
    _bit_equal_per_job("level_histograms:jobs", (hist,), lambda j: (trees.level_histograms(
        bins[j:j + 1], node[j:j + 1], channels[j:j + 1], n_nodes, MAX_BINS, integer=True),))
    if not torch.equal(hist, trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS)):
        raise AssertionError("level_histograms:jobs: class counts differ from the plain version")
    errors["level_histograms:jobs"] = 0.0
    chosen = trees.select_splits(hist, "gini")
    _bit_equal_per_job("select_splits:jobs", chosen, lambda j: trees.select_splits(hist[j:j + 1], "gini"))
    plain_chosen = trees._select_plain(hist, "gini")
    if not all(torch.equal(a, c) for a, c in zip(chosen, plain_chosen)):
        raise AssertionError("select_splits:jobs: splits differ from the plain version")
    errors["select_splits:jobs"] = 0.0
    feature = on_card(rng.integers(-1, FEATURES, (J, n_nodes)).astype(np.int32))
    split = on_card(rng.integers(0, MAX_BINS, (J, n_nodes)).astype(np.int32))
    routed = trees.route(bins, node, feature, split)
    _bit_equal_per_job("route:jobs", (routed,), lambda j: (trees.route(
        bins[j:j + 1], node[j:j + 1], feature[j:j + 1], split[j:j + 1]),))
    if not torch.equal(routed, trees._route(bins, node, feature, split)):
        raise AssertionError("route:jobs: nodes differ from the plain version")
    errors["route:jobs"] = 0.0
    leaf = on_card(rng.integers(0, n_leaves, (J, rows)).astype(np.int32))
    sums = trees.leaf_sums(leaf, channels, n_leaves)
    _bit_equal_per_job("leaf_sums:jobs", (sums,), lambda j: (trees.leaf_sums(
        leaf[j:j + 1], channels[j:j + 1], n_leaves),))
    if not torch.equal(sums, trees._leaf_sums(leaf, channels, n_leaves)):
        raise AssertionError("leaf_sums:jobs: class counts differ from the plain version")
    # the sweep's call: the counts path (0/1 masks times one-hots)
    counted = trees.leaf_sums(leaf, channels, n_leaves, integer=True)
    _bit_equal_per_job("leaf_sums:jobs (counts)", (counted,), lambda j: (trees.leaf_sums(
        leaf[j:j + 1], channels[j:j + 1], n_leaves, integer=True),))
    if not torch.equal(counted, sums):
        raise AssertionError("leaf_sums:jobs: the counts path's counts differ")
    errors["leaf_sums:jobs"] = 0.0

    thresholds_np = thresholds.cpu().numpy()
    heaps = [_heaps(rng, thresholds_np, 1, DEPTH) for _ in range(J)]
    fh = on_card(np.stack([h[0] for h in heaps]))
    th = on_card(np.stack([h[1] for h in heaps]))
    lp = on_card(rng.dirichlet(np.ones(CLASSES), size=(J, 1, n_leaves)).astype(np.float32))
    Xe = torch.stack([torch.roll(X_eval, s, dims=0) for s in shifts])
    probs = trees.job_ensemble_forward(Xe, fh, th, lp, DEPTH)
    _bit_equal_per_job("tree_ensemble_forward:jobs", (probs,), lambda j: (trees.job_ensemble_forward(
        Xe[j:j + 1], fh[j:j + 1], th[j:j + 1], lp[j:j + 1], DEPTH),))
    plain = trees._job_ensemble_forward(Xe, fh, th, lp, DEPTH)
    error = float((probs - plain).abs().max())
    if error > TREE_TOL or not torch.equal(probs.argmax(2), plain.argmax(2)):
        raise AssertionError(f"tree_ensemble_forward:jobs: {error} from the plain version")
    errors["tree_ensemble_forward:jobs"] = error
    return errors


def time_job_kernels(torch, X_std, y_dev, mask, X_raw, thresholds, X_eval, flush) -> dict:
    """Each job-axis kernel at the main path's shapes, cold (L2
    overwritten before each call), beside its bound and its plain
    version: K7 over the λ sweep's 112 slots of 1,048,576 rows, one shared
    X, weighted; K1, K2, K3, K4, K5 and K6 over the depth sweep's 8 slots,
    one shared X (K2, K4: each slot's own bins, a 16-node level; K3 on K2's
    16-node histograms; K5: 256
    leaves; K6: depth 8 on the shared eval rows)."""
    from learningorchestra_tpu_torch.ml import sweep

    rows, device = X_std.shape[0], X_std.device
    jobs_lr = sweep._job_axis(SWEEP_POINTS)
    rng = np.random.default_rng(61)

    def on_card(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    # CUDA events only: in a process that ran the other phases first, the
    # profiler's trace read these kernels at a fifth of their event times,
    # below what the bytes allow (PERF.md section 7)
    def timed(name, kernel, plain, bound, library=None):
        bound_ms, bound_by = bound
        return {
            "ms": _event_ms(torch, kernel, 5, flush),
            "plain_ms": _event_ms(torch, plain, 1, flush),
            "library_ms": None if library is None else _event_ms(torch, library, 3, flush),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }

    W = on_card((rng.normal(size=(jobs_lr, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    b = on_card((rng.normal(size=(jobs_lr, CLASSES)) * 0.3).astype(np.float32))
    W4 = on_card((rng.normal(size=(jobs_lr, 4, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    b4 = on_card((rng.normal(size=(jobs_lr, 4, CLASSES)) * 0.3).astype(np.float32))
    l2s = on_card(np.linspace(0.0, 1.0, jobs_lr).astype(np.float32))
    results = {
        "logistic_loss_grad:jobs": timed(
            "logistic_loss_grad:jobs",
            lambda: logistic.job_loss_and_grad(W, b, X_std, y_dev, mask, l2s),
            lambda: logistic._job_loss_fn(W, b, X_std, y_dev, mask, l2s),
            _job_bound("logistic_loss_grad", rows, jobs_lr, x_shared=True),
        ),
        "logistic_trial_losses:jobs": timed(
            "logistic_trial_losses:jobs",
            lambda: logistic.job_trial_losses(W4, b4, X_std, y_dev, mask, l2s),
            lambda: logistic._job_trial_losses(W4, b4, X_std, y_dev, mask, l2s),
            _job_bound("logistic_trial_losses", rows, jobs_lr, x_shared=True),
        ),
    }
    for name, result in results.items():
        result.update(jobs=jobs_lr, rows=rows, x_shared=True, geometry=logistic._k7_geometry(
            FEATURES, CLASSES, jobs_lr, True, trial=name == "logistic_trial_losses:jobs", weighted=True))
    J = sweep._job_axis(1)
    ths = torch.stack([thresholds * (1.0 + 1e-3 * j) for j in range(J)]).contiguous()
    bins = binning.job_apply_bins(X_raw, ths)
    n_nodes, n_leaves, depth = 16, 2 ** max(SWEEP_DEPTHS), max(SWEEP_DEPTHS)
    y_jobs = y_dev[None].expand(J, rows)
    channels = (torch.nn.functional.one_hot(y_jobs.long(), CLASSES).to(torch.float32) * mask[None, :, None]).contiguous()
    node = on_card(rng.integers(0, n_nodes, (J, rows)).astype(np.int32))
    feature = on_card(rng.integers(-1, FEATURES, (J, n_nodes)).astype(np.int32))
    split = on_card(rng.integers(0, MAX_BINS, (J, n_nodes)).astype(np.int32))
    leaf = on_card(rng.integers(0, n_leaves, (J, rows)).astype(np.int32))
    bins_read = int((feature.long().gather(1, node.long()) >= 0).sum())
    thresholds_np = thresholds.cpu().numpy()
    heaps = [_heaps(rng, thresholds_np, 1, depth) for _ in range(J)]
    fh = on_card(np.stack([h[0] for h in heaps]))
    th = on_card(np.stack([h[1] for h in heaps]))
    lp = on_card(rng.dirichlet(np.ones(CLASSES), size=(J, 1, n_leaves)).astype(np.float32))
    rows_e = X_eval.shape[0]
    # the library yardsticks: one batched searchsorted (K1); bincount, one
    # a channel, over (job, node, feature, bin) and (job, leaf) cells (K2, K5)
    X_columns = X_raw.T[None].expand(J, -1, -1).contiguous()
    job_ids = torch.arange(J, device=device)[:, None]
    feature_offsets = torch.arange(FEATURES, device=device) * MAX_BINS
    flat = (
        ((job_ids * n_nodes + node.long())[:, :, None] * (FEATURES * MAX_BINS)) + feature_offsets + bins.long()
    ).reshape(-1)
    cell_weights = [channels[:, :, k : k + 1].expand(J, rows, FEATURES).reshape(-1) for k in range(CLASSES)]
    leaf_index = (job_ids * n_leaves + leaf.long()).reshape(-1)
    leaf_weights = [channels[:, :, k].reshape(-1) for k in range(CLASSES)]
    hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True)
    results.update({
        "apply_bins:jobs": timed(
            "apply_bins:jobs",
            lambda: binning.job_apply_bins(X_raw, ths),
            lambda: binning._job_apply_bins(X_raw, ths),
            _job_bound("apply_bins", rows, J, x_shared=True),
            lambda: torch.searchsorted(ths, X_columns, side="left"),
        ),
        "level_histograms:jobs": timed(
            "level_histograms:jobs",
            lambda: trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True),
            lambda: trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS),
            _job_bound("level_histograms", rows, J, n_nodes=n_nodes),
            lambda: [torch.bincount(flat, weights=w, minlength=J * n_nodes * FEATURES * MAX_BINS)
                     for w in cell_weights],
        ),
        "select_splits:jobs": timed(
            "select_splits:jobs",
            lambda: trees.select_splits(hist, "gini"),
            lambda: trees._select_plain(hist, "gini"),
            _job_bound("select_splits", rows, J, n_nodes=n_nodes),
        ),
        "route:jobs": timed(
            "route:jobs",
            lambda: trees.route(bins, node, feature, split),
            lambda: trees._route(bins, node, feature, split),
            _job_bound("route", rows, J, n_nodes=n_nodes, bins_read=bins_read),
        ),
        "leaf_sums:jobs": timed(
            "leaf_sums:jobs",
            lambda: trees.leaf_sums(leaf, channels, n_leaves, integer=True),
            lambda: trees._leaf_sums(leaf, channels, n_leaves),
            _job_bound("leaf_sums", rows, J, n_nodes=n_leaves),
            lambda: [torch.bincount(leaf_index, weights=w, minlength=J * n_leaves) for w in leaf_weights],
        ),
        "tree_ensemble_forward:jobs": timed(
            "tree_ensemble_forward:jobs",
            lambda: trees.job_ensemble_forward(X_eval, fh, th, lp, depth),
            lambda: trees._job_ensemble_forward(X_eval, fh, th, lp, depth),
            _job_bound("tree_ensemble_forward", rows_e, J, x_shared=True, depth=depth),
        ),
    })
    del flat, cell_weights, leaf_index, leaf_weights, X_columns
    for name in ("apply_bins:jobs", "level_histograms:jobs", "select_splits:jobs", "route:jobs",
                 "leaf_sums:jobs"):
        results[name].update(jobs=J, rows=rows, x_shared=name == "apply_bins:jobs")
    results["tree_ensemble_forward:jobs"].update(jobs=J, rows=rows_e, x_shared=True, depth=depth)
    results["level_histograms:jobs"]["nodes"] = results["route:jobs"]["nodes"] = n_nodes
    results["select_splits:jobs"]["nodes"] = n_nodes
    results["leaf_sums:jobs"]["leaves"] = n_leaves
    return results


def check_dt_binned_once(torch, dt_inputs) -> dict:
    """The depth program over shared thresholds (K1 once, the jobs growing
    over one bins matrix) against the same program over the thresholds
    stacked slot by slot (K1 over the job axis, each job its own bins), at
    every depth of the sweep: heaps, leaf probabilities and metrics
    bit-equal, and the K1 and K2-K4 launches each makes."""
    from learningorchestra_tpu_torch.ml import sweep

    Xs, ys, ws, thresholds, Xe, ye, we, _ = dt_inputs
    stacked_thresholds = thresholds[None].expand(ys.shape[0], -1, -1).contiguous()
    launches = {}
    for depth in SWEEP_DEPTHS:
        outputs = {}
        for form, table in (("shared", thresholds), ("stacked", stacked_thresholds)):
            torch.cuda.synchronize()
            kernels.reset_launches()
            outputs[form] = sweep._dt_fused(Xs, ys, ws, table, Xe, ye, we, CLASSES, depth, MAX_BINS)
            torch.cuda.synchronize()
            launches[f"{form}:{depth}"] = {k: v for k, v in kernels.launches().items() if v}
        for got, want in zip(outputs["shared"], outputs["stacked"]):
            if not torch.equal(got, want):
                raise AssertionError(f"dt sweep, depth {depth}: the shared bins' program differs from the stacked one")
    return {"bit_equal": True, "launches": launches}


def time_programs(torch, lr_inputs, dt_inputs, flush) -> dict:
    """The three fused programs (K14) at the main path's shapes: one L-BFGS
    segment of the λ sweep (112 slots; its seed pass and one iteration),
    its evaluation, and the depth sweep's depth-8 program (8 slots),
    each beside its bound (the sum of its kernels' bounds; for the
    evaluation its bytes) and the same program through the plain
    versions."""
    from learningorchestra_tpu_torch.ml import sweep

    W, b, state, Xs, ys, masks, l2s, Xe, means, scales, ye, we = lr_inputs
    jobs, rows = W.shape[0], Xs.shape[-2]
    # the runner's segment at this shape
    iters = segment_steps(SWEEP_MAX_ITER, rows * jobs, logistic._LR_ROW_ITERS_BUDGET, FEATURES)

    def segment():
        return sweep._lr_fused_segment(W, b, state, Xs, ys, masks, l2s, iters)

    def evaluate():
        return sweep._lr_fused_eval(W, b, Xe, means, scales, ye, we, CLASSES)

    def plain_segment():
        with _plain_sweep():
            return segment()

    loss_ms, _ = _job_bound("logistic_loss_grad", rows, jobs, x_shared=Xs.dim() == 2)
    trial_ms, _ = _job_bound("logistic_trial_losses", rows, jobs, x_shared=Xs.dim() == 2)
    rows_e = Xe.shape[1]
    eval_bytes = jobs * rows_e * (FEATURES * 4 + 8) + jobs * (FEATURES * CLASSES + CLASSES + 2 * FEATURES) * 4
    results = {
        "lr_fused_segment": {
            "ms": _event_ms(torch, segment, 3, flush),
            "plain_ms": _event_ms(torch, plain_segment, 1, flush),
            "bound_ms": (1 + iters) * loss_ms + iters * trial_ms,
            "bound_by": "operations" if Xs.dim() == 2 else "bytes",
            "jobs": jobs, "rows": rows, "iterations": iters,
        },
        "lr_fused_eval": {
            "ms": _event_ms(torch, evaluate, 5, flush),
            "bound_ms": eval_bytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "jobs": jobs, "rows": rows_e,
        },
    }
    # the evaluation is torch ops (a batched torch.matmul, as K8's forward,
    # and K9's metrics): it is its own plain version
    results["lr_fused_eval"]["plain_ms"] = results["lr_fused_eval"]["ms"]
    Xs_t, ys_t, ws_t, ths_t, Xe_t, ye_t, we_t, depth = dt_inputs
    J, rows_t = ys_t.shape[0], Xs_t.shape[-2]

    def dt_program():
        return sweep._dt_fused(Xs_t, ys_t, ws_t, ths_t, Xe_t, ye_t, we_t, CLASSES, depth, MAX_BINS)

    def plain_dt():
        with _plain_sweep():
            return dt_program()

    # one shared table: the rows are binned once, and the jobs share the bins
    shared = ths_t.dim() == 2
    bound = _job_bound("apply_bins", rows_t, 1 if shared else J, x_shared=Xs_t.dim() == 2)[0]
    for level in range(depth):
        for name in ("level_histograms", "select_splits", "route"):
            bound += _job_bound(name, rows_t, J, n_nodes=2**level, bins_shared=shared)[0]
    bound += _job_bound("leaf_sums", rows_t, J, n_nodes=2**depth)[0]
    bound += _job_bound("tree_ensemble_forward", Xe_t.shape[-2], J, x_shared=Xe_t.dim() == 2, depth=depth)[0]
    results["dt_fused"] = {
        "ms": _event_ms(torch, dt_program, 3, flush),
        "plain_ms": _event_ms(torch, plain_dt, 1, flush),
        "bound_ms": bound,
        "bound_by": "bytes",
        "jobs": J, "rows": rows_t, "depth": depth,
    }
    return results


def _coalesced(torch, coalescer, members_data, runner, kind: str, grids, max_iter: int):
    """Register every member with ``coalescer`` and run each: returns the
    results and the coalescer's stats."""
    from learningorchestra_tpu_torch.ml import sweep

    device = _card(torch)
    members = []
    for i, ((X, y), grid) in enumerate(zip(members_data, grids)):
        key, payload = sweep.prepare_member(kind, X, y, X, y, grid, device=device, max_iter=max_iter)
        members.append(coalescer.register(key, payload, runner, name=f"{kind}-{i}"))
    results = [coalescer.run_member(member) for member in members]
    return results, coalescer.stats()


def check_bit_identity(torch) -> dict:
    """Five single-point lr members (λ 0, 0.1, 0.01, 0.5, 0; each its own
    seeded data at BIT_ROWS rows) fused through a Coalescer in one
    dispatch, against each run alone at the same width (window 0): w, b,
    accuracy and F1 identical. The same for three dt members at depths
    {2, 3}."""
    from learningorchestra_tpu_torch.ml import sweep
    from learningorchestra_tpu_torch.sched.coalesce import Coalescer

    runner = sweep.group_runner(_card(torch))
    record = {}
    for kind, data, grids, max_iter in (
        ("lr", [bench_synthetic(BIT_ROWS, seed=20 + i) for i in range(5)],
         [[{"reg_param": l2}] for l2 in (0.0, 0.1, 0.01, 0.5, 0.0)], SWEEP_MAX_ITER),
        ("dt", [bench_synthetic(BIT_ROWS, seed=30 + i) for i in range(3)],
         [[{"max_depth": 2}, {"max_depth": 3}]] * 3, SWEEP_MAX_ITER),
    ):
        started = time.perf_counter()
        fused, fused_stats = _coalesced(torch, Coalescer(window_s=0.05, max_jobs=8), data, runner, kind, grids, max_iter)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - started
        if fused_stats["fused_dispatches"] != 1:
            raise AssertionError(f"{kind} bit identity: {fused_stats['fused_dispatches']} fused dispatches, not 1")
        solo, _ = _coalesced(torch, Coalescer(window_s=0.0, max_jobs=8), data, runner, kind, grids, max_iter)
        fields = ("w", "b") if kind == "lr" else ("features_heap", "thresholds_heap", "leaf_probs")
        for i, (f_result, s_result) in enumerate(zip(fused, solo)):
            for f_point, s_point in zip(f_result["points"], s_result["points"]):
                if (f_point["accuracy"], f_point["weighted_f1"]) != (s_point["accuracy"], s_point["weighted_f1"]):
                    raise AssertionError(f"{kind} member {i}: fused metrics differ from its solo run")
            for f_params, s_params in zip(f_result["params"], s_result["params"]):
                for field in fields:
                    if not np.array_equal(f_params[field], s_params[field]):
                        raise AssertionError(f"{kind} member {i}: fused {field} differs from its solo run")
        record[kind] = {
            "members": len(data), "rows": BIT_ROWS, "fused_dispatches": 1, "fused_s": fused_s,
            "accuracies": [p["accuracy"] for result in fused for p in result["points"]],
            "bit_identical": True,
        }
    return record


def coalescing_flood(torch) -> dict:
    """bench.py's flood: FLOOD_JOBS concurrent lr members of FLOOD_ROWS
    rows, each its own seeded data, max_iter 25, from as many threads
    through one Coalescer, with the window at 10 ms and at 0. A lock
    stands in for the scheduler's width-1 device class (the scheduler
    comes with the builder): one member runs at a time, and a leader's
    fused dispatch serves the members it collected."""
    from learningorchestra_tpu_torch.ml import sweep
    from learningorchestra_tpu_torch.sched.coalesce import Coalescer

    device = _card(torch)
    runner = sweep.group_runner(device)
    prepared = []
    for i in range(FLOOD_JOBS):
        X, y = bench_synthetic(FLOOD_ROWS, seed=100 + i)
        prepared.append(sweep.prepare_member(
            "lr", X, y, X, y, [{"reg_param": 0.0}], device=device, max_iter=SWEEP_MAX_ITER
        ))
    # both shapes once before the clock: the 8-slot floor and the 64-slot batch
    sweep.run_group([prepared[0][1]], device)
    sweep.run_group([payload for _, payload in prepared], device)
    torch.cuda.synchronize()

    def flood(window_s: float) -> dict:
        coalescer = Coalescer(window_s=window_s, max_jobs=FLOOD_JOBS)
        lane = threading.Lock()
        barrier = threading.Barrier(FLOOD_JOBS + 1)
        results, failures = [None] * FLOOD_JOBS, []

        def client(index: int) -> None:
            key, payload = prepared[index]
            member = coalescer.register(key, payload, runner, name=f"flood-{index}")
            barrier.wait()
            try:
                with lane:
                    results[index] = coalescer.run_member(member)
                    torch.cuda.synchronize()
            except Exception as error:  # noqa: BLE001 — surfaced below
                failures.append(error)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(FLOOD_JOBS)]
        for thread in threads:
            thread.start()
        barrier.wait()
        started = time.perf_counter()
        for thread in threads:
            thread.join(timeout=600)
        elapsed = time.perf_counter() - started
        if failures or any(result is None for result in results):
            raise AssertionError(f"flood at window {window_s}: {len(failures)} failed, {failures[:1]!r}")
        stats = coalescer.stats()
        return {
            "jobs_per_s": FLOOD_JOBS / elapsed,
            "wall_s": elapsed,
            "fused_dispatches": stats["fused_dispatches"],
            "mean_batch_size": stats["mean_batch_size"],
            "finished": sum(result is not None for result in results),
        }

    coalesced = flood(FLOOD_WINDOW_S)
    uncoalesced = flood(0.0)
    if coalesced["fused_dispatches"] != 1:
        raise AssertionError(f"the 10 ms flood made {coalesced['fused_dispatches']} fused dispatches, not 1")
    if uncoalesced["fused_dispatches"] != FLOOD_JOBS:
        raise AssertionError(f"the window-0 flood made {uncoalesced['fused_dispatches']} dispatches")
    return {
        "jobs": FLOOD_JOBS, "rows": FLOOD_ROWS,
        "coalesced": coalesced, "uncoalesced_window0": uncoalesced,
        "coalesce_speedup": coalesced["jobs_per_s"] / uncoalesced["jobs_per_s"],
    }


def _sweep_launches(kind: str, payload, padded: int) -> tuple[dict, dict]:
    """The kernel launches and program calls one sweep of ``payload``
    makes: one launch a level or an iteration for the whole group."""
    expected = {name: 0 for name in kernels.KERNEL_NAMES}
    if kind == "lr":
        iters = segment_steps(
            SWEEP_MAX_ITER, payload["X"].shape[0] * padded, logistic._LR_ROW_ITERS_BUDGET, FEATURES
        )
        segments = max(1, SWEEP_MAX_ITER // iters)
        expected.update(logistic_loss_grad=segments + segments * iters,
                        logistic_trial_losses=segments * iters)
        return expected, {"lr_fused_segment": segments, "lr_fused_eval": 1, "dt_fused": 0}
    levels = sum(SWEEP_DEPTHS)
    programs = len(SWEEP_DEPTHS)
    expected.update(apply_bins=programs, level_histograms=levels, select_splits=levels, route=levels,
                    leaf_sums=programs, tree_ensemble_forward=programs)
    return expected, {"lr_fused_segment": 0, "lr_fused_eval": 0, "dt_fused": programs}


def phase_sweep(torch, card: str) -> dict:
    """The fused programs on the card at full width: bench.py's sweep_100
    λ grid over lr and a depth grid over dt on 1,000,000 rows, each one
    member through run_group, launches counted, held against the same
    group through the plain versions; the per-job kernel checks; the
    bit-identity of fused and solo members; the coalescing flood."""
    from learningorchestra_tpu_torch.ml import sweep

    device = _card(torch)
    record = {"phase": "sweep", "rows": SWEEP_ROWS, "eval_rows": SWEEP_EVAL_ROWS, "features": FEATURES}
    started = time.perf_counter()
    X, y = bench_synthetic(SWEEP_ROWS, seed=0)
    X_eval, y_eval = bench_synthetic(SWEEP_EVAL_ROWS, seed=1)
    lambdas = [{"reg_param": float(v)} for v in np.linspace(0.0, 1.0, SWEEP_POINTS)]
    depths = [{"max_depth": depth} for depth in SWEEP_DEPTHS]
    _, lr_payload = sweep.prepare_member(
        "lr", X, y, X_eval, y_eval, lambdas, device=device, max_iter=SWEEP_MAX_ITER
    )
    _, dt_payload = sweep.prepare_member("dt", X, y, X_eval, y_eval, depths, device=device)
    record["prepare_s"] = time.perf_counter() - started

    # the main path: each sweep with the counts set to 0 just before it
    # and read just after
    runs = {}
    for kind, payload, padded in (
        ("lr", lr_payload, sweep._job_axis(SWEEP_POINTS)), ("dt", dt_payload, sweep._job_axis(1)),
    ):
        expected, expected_programs = _sweep_launches(kind, payload, padded)
        torch.cuda.synchronize()
        kernels.reset_launches()
        sweep.reset_program_calls()
        started = time.perf_counter()
        result = _outcome(sweep.run_group([payload], device))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - started
        launches, programs = kernels.launches(), sweep.program_calls()
        if launches != expected or programs != expected_programs:
            raise AssertionError(
                f"{kind} sweep launched {launches} in {programs}, expected {expected} in {expected_programs}"
            )
        accuracies = [point["accuracy"] for point in result["points"]]
        if not all(0.5 < accuracy <= 1.0 for accuracy in accuracies):
            raise AssertionError(f"{kind} sweep: accuracies {accuracies}")
        runs[kind] = result
        record[kind] = {
            "points": len(payload["grid"]), "padded_slots": padded, "wall_s": wall_s,
            "points_per_s": len(payload["grid"]) / wall_s,
            "launches": {name: count for name, count in launches.items() if count},
            "programs": programs, "best": result["best"],
            "best_accuracy": accuracies[result["best"]],
        }

    # the same groups through the plain versions on the card
    with _plain_sweep():
        started = time.perf_counter()
        plain_lr = _outcome(sweep.run_group([lr_payload], device))
        torch.cuda.synchronize()
        record["lr"]["plain_wall_s"] = time.perf_counter() - started
        started = time.perf_counter()
        plain_dt = _outcome(sweep.run_group([dt_payload], device))
        torch.cuda.synchronize()
        record["dt"]["plain_wall_s"] = time.perf_counter() - started
    lr, X_eval_dev = runs["lr"], torch.from_numpy(X_eval).to(device)
    if lr["best"] != plain_lr["best"]:
        raise AssertionError(f"lr sweep: winner {lr['best']}, the plain versions' {plain_lr['best']}")
    prob_err = 0.0
    for params, plain_params in zip(lr["params"], plain_lr["params"]):
        probs = sweep.model_from_params(params, device)._forward(X_eval_dev)
        plain_probs = sweep.model_from_params(plain_params, device)._forward(X_eval_dev)
        prob_err = max(prob_err, float((probs - plain_probs).abs().max()))
    if prob_err > LR_PROB_TOL:
        raise AssertionError(f"lr sweep: probabilities {prob_err} from the plain versions' fits")
    dt = runs["dt"]
    leaf_err = 0.0
    for params, plain_params in zip(dt["params"], plain_dt["params"]):
        for field in ("features_heap", "thresholds_heap"):
            if not np.array_equal(params[field], plain_params[field]):
                raise AssertionError(f"dt sweep, depth {params['max_depth']}: {field} differs from the plain versions'")
        leaf_err = max(leaf_err, float(np.abs(params["leaf_probs"] - plain_params["leaf_probs"]).max()))
    if leaf_err > TREE_TOL:
        raise AssertionError(f"dt sweep: leaf probabilities {leaf_err} from the plain versions'")
    if [p["accuracy"] for p in dt["points"]] != [p["accuracy"] for p in plain_dt["points"]]:
        raise AssertionError("dt sweep: accuracies differ from the plain versions'")
    record["lr"]["max_prob_err_to_plain"] = prob_err
    record["dt"]["max_leaf_err_to_plain"] = leaf_err

    # the kernels on the main path's own inputs
    X_raw = torch.from_numpy(lr_payload["X"]).to(device)
    mean = torch.from_numpy(lr_payload["mean"]).to(device)
    scale = torch.from_numpy(lr_payload["scale"]).to(device)
    X_std = (X_raw - mean) / scale
    y_dev = torch.from_numpy(lr_payload["y"]).to(device)
    mask = torch.from_numpy(lr_payload["mask"]).to(device)
    thresholds = torch.from_numpy(dt_payload["thresholds"]).to(device)
    Xe_dev = torch.from_numpy(dt_payload["X_eval"]).to(device)
    errors = check_job_kernels(torch, X_std, y_dev, mask, X_raw, thresholds, Xe_dev)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    timings = time_job_kernels(torch, X_std, y_dev, mask, X_raw, thresholds, Xe_dev, flush)
    for name, result in timings.items():
        result["max_abs_err"] = errors[name]
        result["launches"] = record["lr" if name.startswith("logistic") else "dt"]["launches"].get(
            JOB_KERNELS[name][0], 0
        )
    padded = sweep._job_axis(SWEEP_POINTS)
    W0 = torch.zeros((padded, FEATURES, CLASSES), dtype=torch.float32, device=device)
    b0 = torch.zeros((padded, CLASSES), dtype=torch.float32, device=device)
    ones = torch.ones(padded, 1, device=device)
    lr_inputs = (
        W0, b0, sweep._job_lbfgs_state(W0, b0), X_std, y_dev, mask,
        torch.linspace(0.0, 1.0, padded, device=device),
        Xe_dev[None].expand(padded, -1, -1).contiguous(), mean * ones, scale * ones,
        torch.from_numpy(lr_payload["y_eval"]).to(device)[None].expand(padded, -1).contiguous(),
        torch.from_numpy(lr_payload["mask_eval"]).to(device)[None].expand(padded, -1).contiguous(),
    )
    slots = sweep._job_axis(1)
    # the runner's call: one member's slots share X and its thresholds
    dt_inputs = (
        X_raw, y_dev[None].expand(slots, -1).contiguous(), mask[None].expand(slots, -1).contiguous(),
        thresholds, Xe_dev,
        lr_inputs[10][:slots].contiguous(), lr_inputs[11][:slots].contiguous(), max(SWEEP_DEPTHS),
    )
    record["dt"]["binned_once"] = check_dt_binned_once(torch, dt_inputs)
    programs = time_programs(torch, lr_inputs, dt_inputs, flush)
    for name, result in programs.items():
        result["launches"] = (record["lr"] if name.startswith("lr") else record["dt"])["programs"][name]
    program_errors = {"lr_fused_segment": prob_err, "lr_fused_eval": 0.0, "dt_fused": leaf_err}
    for name, result in programs.items():
        result["max_abs_err"] = program_errors[name]
    del lr_inputs, dt_inputs, flush
    record["bit_identity"] = check_bit_identity(torch)
    record["flood"] = coalescing_flood(torch)
    record["kernels"] = timings
    record["programs"] = programs
    record["nvidia_smi"] = card
    emit(record)
    return record


def check_bounds(summary) -> None:
    """A time below its kernel's bound means that the bound or the timing
    is wrong: raise."""
    for entry in summary:
        timed = {
            **entry.get("by_rows", {}), **entry.get("by_level", {}), **entry.get("by_classes", {}),
            **entry.get("by_shape", {}),
            **entry.get("forest", {}).get("by_level", {}), "at the main path's shape": entry,
        }
        for key, at in timed.items():
            for field in ("ms", "device_ms", "ms_cold", "device_ms_cold", "device_ms_clean_l2"):
                if at.get(field) is not None and at[field] < at["bound_ms"]:
                    raise AssertionError(
                        f"{entry['name']} at {key}: {field} {at[field]} is below "
                        f"its bound {at['bound_ms']}"
                    )


PHASES = ("kernels", "serve", "fit-kernels", "fit", "embed-kernels", "embed", "sweep")

# why no single PyTorch call stands beside a job-axis kernel or a program
NO_LIBRARY = {
    "logistic_loss_grad:jobs": "no PyTorch call gives a masked mean nll with its gradient, per job",
    "logistic_trial_losses:jobs": "no PyTorch call gives the masked nll at four points, per job",
    "select_splits:jobs": "no PyTorch call picks a node's best gini split over (feature, bin)",
    "route:jobs": "no PyTorch call routes rows down a split heap",
    "tree_ensemble_forward:jobs": "no PyTorch call computes a tree-ensemble forward",
    "lr_fused_segment": "no PyTorch call runs an L-BFGS segment",
    "lr_fused_eval": "the program is torch ops itself (torch.matmul and K9's metrics)",
    "dt_fused": "no PyTorch call fits a decision tree",
}


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
    for entry in summary:   # K6: the fits' evaluates (evaluate_predict on the fit's rows) launch it too
        entry["evaluate_launches"] = sum(
            fit[name]["evaluate_launches"].get(entry["name"], 0) for name in ("dt", "rf", "gb")
        ) if fit else None
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
                **{field: result[field] for field in ("by_shape", "launch_floor_ms") if field in result},
                **({"forest": result["forest"]} if name in FOREST_KERNELS else {}),
            })
    if "embed-kernels" in wanted or "embed" in wanted:
        store, labels_by_name, setup_s = embed_store()
    embed_kernels = phase_embed_kernels(torch, store) if "embed-kernels" in wanted else None
    embed = phase_embed(torch, device["card"], store, labels_by_name, setup_s) if "embed" in wanted else None
    if embed_kernels:
        # each at the main path's largest shape: K11 and K12 at the exact
        # fit's 20,000 rows (K12 late), K13 at 1,000,000 rows x 5,000
        # landmarks
        at_main = {
            "tsne_affinities": EXACT_ROWS,
            "tsne_z": f"{EXACT_ROWS}:late",
            "tsne_grad": f"{EXACT_ROWS}:late",
            "tsne_interpolate": f"{EMBED_ROWS}x{tsne.LANDMARKS}",
        }
        for name, result in embed_kernels.items():
            at = result["by_rows"][at_main[name]]
            summary.append({
                "name": name,
                "route": "cuda",
                "source": TSNE_SOURCE,
                "replaces": TSNE_REPLACES[name],
                "launches": embed["launches"][name] if embed else None,
                "max_abs_err": result["max_abs_err"],
                "max_rel_err": result["max_rel_err"],
                "rows": at_main[name],
                **{field: at[field] for field in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                # no single PyTorch call computes calibrated affinities, the
                # t-SNE gradient or the calibrated interpolation
                "library_ms": None,
                "by_rows": result["by_rows"],
            })
    sweep_record = phase_sweep(torch, device["card"]) if "sweep" in wanted else None
    if sweep_record:
        for name, result in sweep_record["kernels"].items():
            _, source, replaces = JOB_KERNELS[name]
            summary.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                **{field: result[field] for field in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "jobs", "rows",
                )},
                **({"library_note": NO_LIBRARY[name]} if name in NO_LIBRARY else {}),
            })
        for name, result in sweep_record["programs"].items():
            summary.append({
                "name": name, "route": "cuda", "source": SWEEP_SOURCE,
                "replaces": PROGRAM_REPLACES[name],
                **{field: result[field] for field in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "jobs", "rows",
                )},
                "library_ms": None, "library_note": NO_LIBRARY[name],
            })
    emit({"phase": "profiler", "lost_traces": LOST_TRACES})
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
