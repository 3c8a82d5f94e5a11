"""Hand-written CUDA kernels: build, binding and launch counters.

Each source in ``csrc/`` is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds):

- ``tree_forward.cu``: the tree forward (K6), for the predict lane and
  over a sweep's jobs;
- ``tree_fit.cu``: the fit's level loop (K1-K5), over one tree, a
  forest's trees, or a sweep's jobs (each with its own rows), and K2's
  and K5's sums form (a rank's unrounded float64 sums) for fits over
  ranks;
- ``logistic.cu``: the logistic regression fit's loss-and-gradient pass
  and its Armijo trial losses (K7), for one fit or a job axis of fits
  with row weights (the sweep's fused L-BFGS), their sums form for a
  rank's block of rows sharded over ranks, and the class-shard form (a
  row's stats over a rank's classes, then its shard's sums given every
  row's log-sum-exp) for classes sharded over a model group;
- ``scaler.cu``: the masked scaler's column sums (both passes) and the
  masked standardization of a rank's block (K8′, ``fit_sharded``), on
  float32 or bfloat16 rows;
- ``tsne.cu``: t-SNE's affinities (K11), gradient (K12) and landmark
  interpolation (K13), for the image lane, and K11's and K12's row-slab
  forms for the rows a rank owns.

A library lands in ``_build/`` under a name that carries a hash of its
source, and is published with ``os.replace``, so two processes never load
half a file and an edited source is rebuilt.

The wrappers that launch these kernels live beside their plain PyTorch
versions (``ml/binning.py``, ``ml/trees.py``, ``ml/logistic.py``,
``ops/tsne.py``). Each wrapper adds one to
its kernel's launch count where it launches, and nowhere else, so a run
can show that its main path went through the kernel; the counts also
feed ``lo_kernel_launches_total{kernel}``, so a service process's
``/metrics`` shows it too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
# library name -> its source; each source builds into a library of its own
SOURCES = {
    "tree_forward": os.path.join(_HERE, "csrc", "tree_forward.cu"),
    "tree_fit": os.path.join(_HERE, "csrc", "tree_fit.cu"),
    "logistic": os.path.join(_HERE, "csrc", "logistic.cu"),
    "tsne": os.path.join(_HERE, "csrc", "tsne.cu"),
    "scaler": os.path.join(_HERE, "csrc", "scaler.cu"),
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# kernel -> the library that holds it
KERNEL_LIBRARIES = {
    "tree_ensemble_forward": "tree_forward",
    "gbt_forward": "tree_forward",
    "apply_bins": "tree_fit",
    "level_histograms": "tree_fit",
    "level_histograms_sums": "tree_fit",
    "select_splits": "tree_fit",
    "route": "tree_fit",
    "leaf_sums": "tree_fit",
    "leaf_sums_sums": "tree_fit",
    "logistic_loss_grad": "logistic",
    "logistic_trial_losses": "logistic",
    "logistic_loss_grad_sums": "logistic",
    "logistic_trial_losses_sums": "logistic",
    "logistic_shard_stats": "logistic",
    "logistic_shard_grad": "logistic",
    "masked_col_sums": "scaler",
    "masked_col_sums_centred": "scaler",
    "masked_standardize": "scaler",
    "tsne_affinities": "tsne",
    "tsne_z": "tsne",
    "tsne_grad": "tsne",
    "tsne_interpolate": "tsne",
    "tsne_affinities_slab": "tsne",
    "tsne_z_slab": "tsne",
    "tsne_grad_slab": "tsne",
}
KERNEL_NAMES = tuple(KERNEL_LIBRARIES)
_launches = {name: 0 for name in KERNEL_NAMES}
_launch_lock = threading.Lock()
_launch_samples: dict = {}   # kernel -> its lo_kernel_launches_total sample

_libraries: dict = {}
_library_lock = threading.Lock()
# library name -> what its last build in this process did: path, seconds,
# whether nvcc ran, and the ptxas report
build_info: dict = {}


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: its count here and its
    ``lo_kernel_launches_total{kernel}`` sample on this process's
    ``/metrics``, the family declared at the process's first launch (so a
    service process shows which kernels its requests ran)."""
    with _launch_lock:
        _launches[name] += 1
        sample = _launch_samples.get(name)
        if sample is None:
            from learningorchestra_tpu_torch.telemetry.metrics import global_registry

            sample = _launch_samples[name] = global_registry().counter(
                "lo_kernel_launches_total", "Hand-written CUDA kernel launches", labels=("kernel",)
            ).labels(name)
    sample.inc()


def launches() -> dict:
    with _launch_lock:
        return dict(_launches)


def reset_launches() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)"
    )


def build(name: str) -> str:
    """Compile library ``name`` into ``_build/`` unless a library built
    from the same source bytes is already there; returns its path."""
    source = SOURCES[name]
    with open(source, "rb") as handle:
        digest = hashlib.sha256(handle.read()).hexdigest()[:16]
    target = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if os.path.isfile(target):
        # keep the record of a build made earlier in this process
        if build_info.get(name, {}).get("path") != target:
            build_info[name] = dict(path=target, seconds=0.0, built=False, ptxas="")
        return target
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    partial = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    started = time.perf_counter()
    result = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", partial, source],
        capture_output=True,
        text=True,
        timeout=600,
    )
    if result.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source}:\n{result.stdout}{result.stderr}"
        )
    os.replace(partial, target)
    build_info[name] = dict(
        path=target,
        seconds=time.perf_counter() - started,
        built=True,
        ptxas=result.stdout + result.stderr,
    )
    return target


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built at first use. The first load in
    a process counts into the flight recorder's
    ``lo_compile_events_total``: ``miss`` with nvcc's seconds
    (``lo_compile_seconds_total``) when it ran nvcc, ``hit`` when the
    library was already built."""
    with _library_lock:
        if name not in _libraries:
            from learningorchestra_tpu_torch.telemetry import profile

            _libraries[name] = _BINDERS[name](ctypes.CDLL(build(name)))
            info = build_info[name]
            if info["built"]:
                profile.account_compile("miss", info["seconds"])
            else:
                profile.account_compile("hit")
        return _libraries[name]


def _bind_tree_forward(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lo_tree_forward_prepare.argtypes = [
        c_int,                               # X is bfloat16 (else float32)
        c_int, c_int, c_int, c_int,          # gbt, staged, x staged, a thread a row
        c_int, c_int,                        # shared bytes, device
        ctypes.POINTER(c_int), ctypes.POINTER(c_int),   # out: blocks an SM, SMs
    ]
    lib.lo_tree_forward.argtypes = [
        c_int,                               # X is bfloat16 (else float32)
        c_int, c_int, c_int, c_int,          # gbt, staged, x staged, a thread a row
        ptr, ptr, ptr, ptr, ptr,             # X, features, thresholds, leaf values, out
        c_int, c_int, c_int, c_int, c_int,   # rows, F, trees, depth, values a leaf
        c_int, ctypes.c_longlong,            # jobs, X's stride along the job axis
        c_int, c_int, c_int, c_int,          # jobs a group, log2 of rows a tile, trees a pass, sums shared
        c_int, c_float, c_float,             # 16-byte rows, f0, step
        c_int, c_int, c_int, ptr,            # blocks, shared bytes, device, stream
    ]
    lib.lo_tree_forward_prepare.restype = c_int
    lib.lo_tree_forward.restype = c_int
    return _bind_errors(lib)


def _bind_tree_fit(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, c_int, c_longlong = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lo_apply_bins.argtypes = [
        ptr, c_int,                          # X, X is bfloat16 (else float32)
        ptr, ptr, c_int,                     # thresholds (or their padded table), bins, bin bytes
        c_int, c_int, c_int, c_int,          # rows, F, thresholds per feature, search steps
        c_int, c_int, c_int, c_int,          # jobs, jobs a group, features a window, staged
        c_longlong, c_longlong,              # X's and thresholds' job strides
        c_int, ptr,                          # device, stream
    ]
    lib.lo_level_counts.argtypes = [
        ptr, c_int, ptr, ptr, ptr,           # bins, bin bytes, node, channels, out
        c_int, c_int, c_int, c_int, c_int,   # rows, F, nodes, bins, channels
        c_int, c_longlong,                   # trees, bins' stride along the tree axis
        c_int, c_int,                        # chunks, rows/chunk
        c_int, c_int,                        # features/block, counts in shared
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    lib.lo_level_histograms.argtypes = [
        ptr, c_int, ptr, ptr, ptr,           # bins, bin bytes, node, channels, partials
        ptr, ptr, ptr,                       # order and window begins (or null), out
        c_int, c_int, c_int, c_int, c_int,   # rows, F, nodes, bins, channels
        c_int, c_longlong,                   # trees, bins' stride along the tree axis
        c_int, c_int,                        # chunks, rows/chunk
        c_int, c_int, c_int,                 # window: nodes, bins, channels
        c_int,                               # features/block
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    # the sums form: the same arguments, out float64
    lib.lo_level_histogram_sums.argtypes = list(lib.lo_level_histograms.argtypes)
    lib.lo_select_splits.argtypes = [
        ptr, ptr, c_int,                     # hist, subset scores (or null), subset k
        ptr, ptr, ptr,                       # feature, bin, global stage (or null)
        c_int, c_int, c_int, c_int, c_int,   # nodes, F, bins, channels, mode
        c_int, c_int, c_int,                 # threads a node, nodes a block, features a window
        c_int, ptr,                          # device, stream
    ]
    lib.lo_empty.argtypes = [c_int, ptr]     # device, stream
    lib.lo_route.argtypes = [
        ptr, c_int, ptr, ptr, ptr, ptr,      # bins, bin bytes, node, feature, split bin, out
        c_int, c_int, c_int, c_int,          # rows, F, trees, nodes a tree
        c_longlong,                          # bins' stride along the tree axis
        c_int, c_int,                        # trees a group, splits staged in shared memory
        c_int, ptr,                          # device, stream
    ]
    lib.lo_leaf_counts.argtypes = [
        ptr, ptr, ptr, ptr,                  # leaf, channels, zeroed scratch, out
        c_int, c_int, c_int, c_int,          # rows, leaves, channels, trees
        c_int, c_int, c_int,                 # chunks, rows/chunk, counts in shared
        c_int, ptr,                          # device, stream
    ]
    lib.lo_leaf_sums.argtypes = [
        ptr, ptr, ptr, ptr, ptr,             # leaf, channels, partials, tickets (or null), out
        c_int, c_int, c_int, c_int,          # rows, leaves, channels, trees
        c_int, c_int,                        # chunks, rows/chunk
        c_int, c_int, c_int, c_int,          # window: leaves, channels; warps; fused
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    lib.lo_leaf_sum_sums.argtypes = list(lib.lo_leaf_sums.argtypes)   # out float64
    for entry in (
        "apply_bins", "level_histograms", "level_histogram_sums", "level_counts",
        "select_splits", "route", "leaf_counts", "leaf_sums", "leaf_sum_sums", "empty",
    ):
        getattr(lib, f"lo_{entry}").restype = c_int
    return _bind_errors(lib)


def _bind_logistic(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, c_int, c_longlong = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lo_logistic_loss_grad.argtypes = [
        ptr, c_int,                          # X, X is bfloat16 (else float32)
        ptr, ptr, ptr, ptr, ptr, ptr,        # y, weights (or null), W, b, partials, out
        ptr,                                 # the sums form's float64 sums (or null)
        c_int, c_int, c_int, c_int,          # rows, F, C, jobs
        c_longlong, c_longlong,              # X's and the rows' strides along the job axis
        c_int, c_int,                        # chunks, rows/chunk
        ptr,                                 # the block's layout (ml/logistic.py _K7Layout)
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    lib.lo_logistic_trial_losses.argtypes = [
        ptr, c_int,                          # X, X is bfloat16 (else float32)
        ptr, ptr, ptr, ptr, ptr, ptr,        # y, weights (or null), W4, b4, partials, out
        ptr,                                 # the sums form's float64 sums (or null)
        c_int, c_int, c_int, c_int,          # rows, F, C, jobs
        c_longlong, c_longlong,              # X's and the rows' strides along the job axis
        c_int, c_int,                        # chunks, rows/chunk
        ptr,                                 # the block's layout (ml/logistic.py _K7Layout)
        c_int, ptr,                          # device, stream
    ]
    lib.lo_logistic_shard_stats.argtypes = [
        ptr, c_int, ptr,                     # X, X is bfloat16 (else float32), y
        ptr, ptr, ptr,                       # W (points, F, Cs), b (points, Cs), out (points, rows, 3)
        c_int, c_int, c_int, c_int, c_int,   # rows, F, Cs, points, the shard's first class
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    lib.lo_logistic_shard_grad.argtypes = [
        ptr, c_int, ptr, ptr, ptr,           # X, X is bfloat16 (else float32), y, weights, lse
        ptr, ptr, ptr, ptr,                  # W (F, Cs), b (Cs,), partials, out
        c_int, c_int, c_int, c_int,          # rows, F, Cs, the shard's first class
        c_int, c_int,                        # chunks, rows/chunk
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    for entry in ("loss_grad", "trial_losses", "shard_stats", "shard_grad"):
        getattr(lib, f"lo_logistic_{entry}").restype = c_int
    return _bind_errors(lib)


def _bind_tsne(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lo_tsne_affinities.argtypes = [
        ptr, ptr,                            # X, P
        c_int, c_int, c_float,               # n, F, target entropy
        c_int, c_int, c_int,                 # rows a block, threads, distances in shared
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    lib.lo_tsne_z.argtypes = [
        ptr, ptr, ptr, c_int, c_int,         # Y, a slot a tile pair, Z, n, tiles
        c_int, ptr,                          # device, stream
    ]
    lib.lo_tsne_grad.argtypes = [
        ptr, ptr, ptr, ptr, ptr,             # Y, P, Z, (tiles, n, 3) partials, grad
        c_int, c_int, c_float,               # n, tiles, exaggeration
        c_int, ptr,                          # device, stream
    ]
    lib.lo_tsne_interpolate.argtypes = [
        ptr, ptr, ptr, ptr, ptr,             # X, landmarks (F, m), Y_L, out, distances (or null)
        c_int, c_int, c_int, c_float,        # rows, m, F, target entropy
        c_int, c_int, ptr,                   # grid blocks, device, stream
    ]
    lib.lo_tsne_affinities_slab.argtypes = [
        ptr, ptr,                            # X, the slab of P
        c_int, c_int, c_int, c_int, c_float,  # n, F, first row, slab rows, target entropy
        c_int, c_int, c_int,                 # rows a block, threads, distances in shared
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    lib.lo_tsne_z_slab.argtypes = [
        ptr, ptr, ptr,                       # Y, a slot a block, the slab's total
        c_int, c_int, c_int,                 # n, first row, slab rows
        c_int, c_int,                        # columns a range, ranges
        c_int, ptr,                          # device, stream
    ]
    lib.lo_tsne_grad_slab.argtypes = [
        ptr, ptr, ptr, ptr, ptr,             # Y, the slab of P, Z, (ranges, slab, 3) partials, gradient
        c_int, c_int, c_int,                 # n, first row, slab rows
        c_int, c_int, c_float,               # columns a range, ranges, exaggeration
        c_int, ptr,                          # device, stream
    ]
    for entry in ("affinities", "z", "grad", "interpolate", "affinities_slab", "z_slab",
                  "grad_slab"):
        getattr(lib, f"lo_tsne_{entry}").restype = c_int
    return _bind_errors(lib)


def _bind_scaler(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, c_int, c_longlong = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lo_masked_col_sums.argtypes = [
        ptr, c_int,                          # X, X is bfloat16 (else float32)
        ptr, ptr, ptr, ptr, ptr,             # w, mean (or null: pass 1), partials, ticket, out
        c_int, c_int, c_int, c_int,          # rows, F, chunks, rows/chunk
        c_int, ptr,                          # device, stream
    ]
    lib.lo_masked_standardize.argtypes = [
        ptr, c_int,                          # X, X (and out) bfloat16 (else float32)
        ptr, ptr, ptr, ptr,                  # mean, scale, w, out
        c_longlong, c_int,                   # rows, F
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    lib.lo_masked_col_sums.restype = c_int
    lib.lo_masked_standardize.restype = c_int
    return _bind_errors(lib)


def _bind_errors(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.lo_error_string.argtypes = [ctypes.c_int]
    lib.lo_error_string.restype = ctypes.c_char_p
    return lib


_BINDERS = {
    "tree_forward": _bind_tree_forward,
    "tree_fit": _bind_tree_fit,
    "logistic": _bind_logistic,
    "tsne": _bind_tsne,
    "scaler": _bind_scaler,
}


def check(lib: ctypes.CDLL, name: str, error: int) -> None:
    """Raise when a launch was refused (``cudaGetLastError`` != 0)."""
    if error != 0:
        message = lib.lo_error_string(error).decode(errors="replace")
        raise RuntimeError(f"{name} launch failed: CUDA error {error}: {message}")


def check_operands(*tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for tensor in tensors:
        if tensor.device.type != "cuda":
            raise ValueError(f"kernel operand on {tensor.device}, not a CUDA device")
        if not tensor.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


# The row-chunk kernels (K2, K5, K7) sum a fixed split of the rows into
# chunks, one block each: at most 264 chunks (two per SM of an H100) of at
# least 1,024 rows. The split depends on the row count alone, so the order
# of every float sum, and with it a fit, repeats bit for bit.
MAX_CHUNKS = 264
MIN_CHUNK_ROWS = 1024
# Shared memory one block may use on an H100, and the share a block keeps
# to so that several fit on an SM
SHARED_BYTES = 232_448
BLOCK_SHARED_BYTES = 48 * 1024


def row_chunks(rows: int) -> tuple[int, int]:
    """``(chunks, rows per chunk)``, with no empty chunk."""
    chunks = max(1, min(MAX_CHUNKS, -(-rows // MIN_CHUNK_ROWS)))
    per_chunk = max(1, -(-rows // chunks))
    return -(-rows // per_chunk), per_chunk


_scratch: dict = {}
_scratch_lock = threading.Lock()


def zeroed_scratch(device, count: int):
    """At least ``count`` int32 zeros on ``device``, kept for the current
    stream: the tickets and counts of the kernels whose last block zeroes
    them again (K5, K8′'s column sums; a launch on one stream never
    overlaps another's use). Made once, and again only when a call needs
    more."""
    import torch

    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    with _scratch_lock:
        scratch = _scratch.get(key)
        if scratch is None or scratch.numel() < count:
            scratch = _scratch[key] = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        return scratch


@functools.lru_cache(maxsize=None)
def max_blocks(device_index: int) -> int:
    """Resident blocks enough to fill every SM; a kernel's grid-stride
    loop covers the remaining items."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count * 8


def launch(name: str, entry: str, *args) -> None:
    """Call ``entry`` of kernel ``name``'s library with ``args``, raise if
    the launch was refused, and count the launch."""
    lib = library(KERNEL_LIBRARIES[name])
    check(lib, name, getattr(lib, entry)(*args))
    count_launch(name)
