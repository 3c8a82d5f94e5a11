"""Times K7's class-shard kernels (``shard_stats_tiles_kernel`` and
``shard_grad_tiles_kernel`` of learningorchestra_tpu_torch/kernels/csrc/
logistic.cu) beside the forms they replaced and forms their design
weighed, on one CUDA card.

The replaced forms (``PARENT_FORMS`` below, their source as it was, the
entry points renamed ``lo_parent_shard_stats`` and ``lo_parent_shard_grad``)
are built together with the kept source into one library:

- ``shard_stats_kernel``: a thread a row, 256-row tiles staged by plain
  loads between two barriers, each logit computed twice (its max, then its
  exp) by an fmaf chain that loads W and b from global memory at every
  step, three scalar stores a row and point;
- ``shard_grad_kernel``: a block a chunk of rows; a thread a row for the
  residuals, then a thread a cell, each cell's float64 sum one serial chain
  over the chunk's rows; ``sums_kernel`` adds the chunks.

The weighed forms: builds of the kept source with a constant replaced
(``rows1`` and ``rows4``: one or four rows a stats thread, tiles of 256 and
1,024 rows; ``logits_unroll1`` and ``logits_unroll8``: the logits'
feature loop unrolled once or eight times, where the kept form unrolls it
four times), and the kept grad at other geometries (``grad_tile128``:
tiles of 128 rows; ``grad_serial``: the serial form, a thread a cell, where
the geometry picks the narrow form).

Inputs: chip_smoke.py's run d block (bench.py's rows 0 .. 524,287,
standardized; 16 features), C = 10 and C = 2 over two shards (shard 0:
five classes, one), chip_smoke's seeded W, b and trial points, float32 and
bfloat16 rows; the stats at the four trial points, the grad at the first
point given the kept stats' log-sum-exp. The kept stats are held bit-equal
to the parent's at these shapes (1 and 4 points) and at chip_smoke's edge
shapes (SHARD_EDGE_*, rows also 4 bytes off 16 bytes), and every form is
held against the twins at chip_smoke's tolerances, with a second launch
bit-equal. Then each is timed: device ms cold (256 MB overwritten before
each call) and with L2 evicted by reads (chip_smoke's ``_ReadFlush``),
from the profiler's trace (chip_smoke's ``_device_ms``), and event ms cold:
kept and parent in the order kept, parent, parent, kept at every shape,
the weighed forms at five classes a shard (float32) in the order kept,
forms, forms reversed, kept; each run reported on its own.

Run it from the repository's root on a machine with a card and the CUDA
toolkit:

    python3 logistic_shard_variants.py           # the forms
    python3 logistic_shard_variants.py --edges   # chip_smoke's edge check first

It prints the ptxas lines of the shard kernels, the card's name and power
limit, then one JSON object as its last line.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPEATS = 10

PARENT_FORMS = r'''
namespace {

// Rows of X staged in shared memory as float32: value i of rows [start,
// start + n) at x[(i / F) * xs + i % F].
template <typename In>
__device__ __forceinline__ void stage_rows(float* x, const In* __restrict__ X, long long start,
                                           int n, int F, int xs) {
  const In* from = X + start * F;
  for (int i = threadIdx.x; i < n * F; i += blockDim.x) {
    const int row = i / F;
    const float v = [&] {
      if constexpr (std::is_same<In, float>::value) return __ldg(from + i);
      else return widen(__ldg(from + i));
    }();
    x[row * xs + (i - row * F)] = v;
  }
}

// The shard's logit z_c: b_c + K7's fmaf chain (softmax_any's bits).
template <typename XP>
__device__ __forceinline__ float shard_logit(XP x, int F, const float* W, const float* b, int Cs,
                                             int c) {
  return __fadd_rn(dot(x, F, W, Cs, c), b[c]);
}

// Whether a tile of kThreads rows of F features fits shared memory.
__host__ __device__ __forceinline__ bool stats_staged(int F) {
  return static_cast<size_t>(kThreads) * (F | 1) * sizeof(float) <= kDefaultSharedBytes;
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
    shard_stats_kernel(const In* __restrict__ X, const int* __restrict__ y,
                       const float* __restrict__ W, const float* __restrict__ b,
                       float* __restrict__ out, int rows, int F, int Cs, int points, int first) {
  extern __shared__ float staged_x[];
  const bool staged = stats_staged(F);
  const int xs = F | 1;
  for (long long start = static_cast<long long>(blockIdx.x) * kThreads; start < rows;
       start += static_cast<long long>(gridDim.x) * kThreads) {
    const int n = static_cast<int>(min(static_cast<long long>(kThreads), rows - start));
    if (staged) {
      __syncthreads();  // the last tile's rows are read
      stage_rows(staged_x, X, start, n, F, xs);
      __syncthreads();
    }
    if (threadIdx.x >= n) continue;
    const long long row = start + threadIdx.x;
    const int local = y[row] - first;
    auto row_stats = [&](auto x) {
      for (int p = 0; p < points; ++p) {
        const float* Wp = W + static_cast<size_t>(p) * F * Cs;
        const float* bp = b + static_cast<size_t>(p) * Cs;
        float top = -INFINITY;
        for (int c = 0; c < Cs; ++c) top = fmaxf(top, shard_logit(x, F, Wp, bp, Cs, c));
        float sum = 0.0f, at_label = 0.0f;
        for (int c = 0; c < Cs; ++c) {
          const float z = shard_logit(x, F, Wp, bp, Cs, c);
          sum = __fadd_rn(sum, expf(__fsub_rn(z, top)));
          if (c == local) at_label = z;
        }
        float* o = out + (static_cast<size_t>(p) * rows + row) * 3;
        o[0] = top;
        o[1] = sum;
        o[2] = at_label;
      }
    };
    if (staged) row_stats(static_cast<const float*>(staged_x + threadIdx.x * xs));
    else row_stats(global_rows(X, static_cast<size_t>(row) * F));
  }
}

// grad's shared memory for a tile of `tile` rows: x (staged: tile * xs
// floats, rounded up to 8 bytes), the residuals (Cs * tile doubles), the
// nll terms and the weights (tile doubles each), the cells' sums.
struct ShardGradLayout {
  int tile, xs, cells;
  size_t residuals, nll, weights, sums, bytes;
};

__host__ __device__ __forceinline__ ShardGradLayout shard_grad_layout(int F, int Cs, int tile,
                                                                       bool staged) {
  ShardGradLayout l;
  l.tile = tile;
  l.xs = staged ? (F | 1) : 0;
  l.cells = F * Cs + Cs + 2;
  l.residuals = (static_cast<size_t>(tile) * l.xs * sizeof(float) + 7) / 8 * 8;
  l.nll = l.residuals + static_cast<size_t>(Cs) * tile * sizeof(double);
  l.weights = l.nll + static_cast<size_t>(tile) * sizeof(double);
  l.sums = l.weights + static_cast<size_t>(tile) * sizeof(double);
  l.bytes = l.sums + static_cast<size_t>(l.cells) * sizeof(double);
  return l;
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
    shard_grad_kernel(const In* __restrict__ X, const int* __restrict__ y,
                      const float* __restrict__ w, const double* __restrict__ lse,
                      const float* __restrict__ W, const float* __restrict__ b,
                      double* __restrict__ partials, int rows, int F, int Cs, int first,
                      int rows_per_chunk, const ShardGradLayout layout) {
  extern __shared__ __align__(16) unsigned char shard_shared[];
  float* x_tile = reinterpret_cast<float*>(shard_shared);
  double* residuals = reinterpret_cast<double*>(shard_shared + layout.residuals);
  double* nll = reinterpret_cast<double*>(shard_shared + layout.nll);
  double* weights = reinterpret_cast<double*>(shard_shared + layout.weights);
  double* sums = reinterpret_cast<double*>(shard_shared + layout.sums);
  const int tile = layout.tile, xs = layout.xs, cells = layout.cells, FC = F * Cs;
  for (int cell = threadIdx.x; cell < cells; cell += kThreads) sums[cell] = 0.0;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long row1 = min(static_cast<long long>(rows), row0 + rows_per_chunk);
  for (long long start = row0; start < row1; start += tile) {
    const int n = static_cast<int>(min(static_cast<long long>(tile), row1 - start));
    __syncthreads();  // the last tile's terms are added
    if (xs > 0) {
      stage_rows(x_tile, X, start, n, F, xs);
      __syncthreads();
    }
    // phase 1: a thread a row of the tile
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const long long row = start + i;
      const int local = y[row] - first;
      const double row_lse = lse[row];
      const double weight = static_cast<double>(w[row]);
      auto terms = [&](auto x) {
        double at_label = 0.0;
        for (int c = 0; c < Cs; ++c) {
          const double z = static_cast<double>(shard_logit(x, F, W, b, Cs, c));
          const double r = __dsub_rn(exp(__dsub_rn(z, row_lse)), c == local ? 1.0 : 0.0);
          residuals[static_cast<size_t>(c) * tile + i] = __dmul_rn(r, weight);
          if (c == local) at_label = z;
        }
        nll[i] = local >= 0 && local < Cs ? __dmul_rn(__dsub_rn(row_lse, at_label), weight) : 0.0;
        weights[i] = weight;
      };
      if (xs > 0) terms(static_cast<const float*>(x_tile + i * xs));
      else terms(global_rows(X, static_cast<size_t>(row) * F));
    }
    __syncthreads();
    // phase 2: a thread a cell, the tile's rows in row order
    for (int cell = threadIdx.x; cell < cells; cell += kThreads) {
      double sum = sums[cell];
      if (cell < FC) {
        const int f = cell / Cs, c = cell - f * Cs;
        const double* r = residuals + static_cast<size_t>(c) * tile;
        if (xs > 0) {
          for (int i = 0; i < n; ++i)
            sum = fma(r[i], static_cast<double>(x_tile[i * xs + f]), sum);
        } else {
          const auto x = global_rows(X, static_cast<size_t>(start) * F);
          for (int i = 0; i < n; ++i)
            sum = fma(r[i], static_cast<double>(x[static_cast<long long>(i) * F + f]), sum);
        }
      } else {
        const double* terms = cell < FC + Cs ? residuals + static_cast<size_t>(cell - FC) * tile
                              : cell == FC + Cs ? nll : weights;
        for (int i = 0; i < n; ++i) sum = __dadd_rn(sum, terms[i]);
      }
      sums[cell] = sum;
    }
  }
  __syncthreads();
  for (int cell = threadIdx.x; cell < cells; cell += kThreads)
    partials[static_cast<size_t>(blockIdx.x) * cells + cell] = sums[cell];
}

// The largest tile of rows (256 down to 16) whose layout fits 48 KB,
// staged first; a zero tile when none does.
ShardGradLayout pick_shard_grad_layout(int F, int Cs) {
  for (int tile = kThreads; tile >= kGroupRows; tile /= 2)
    for (int staged = 1; staged >= 0; --staged) {
      const ShardGradLayout l = shard_grad_layout(F, Cs, tile, staged != 0);
      if (l.bytes <= kDefaultSharedBytes) return l;
    }
  ShardGradLayout none = shard_grad_layout(F, Cs, 0, false);
  none.tile = 0;
  return none;
}

}  // namespace

extern "C" {

int lo_parent_shard_stats(const void* X, int x_bf16, const int* y, const float* W,
                          const float* b, float* out, int rows, int F, int Cs, int points,
                          int first, int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || Cs <= 0 || rows < 0 || points <= 0 || max_blocks <= 0)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = stats_staged(F) ? static_cast<size_t>(kThreads) * (F | 1) * sizeof(float) : 0;
  const int grid = grid_for(rows, max_blocks);
  if (x_bf16)
    shard_stats_kernel<bf16_bits><<<grid, kThreads, bytes, s>>>(
        static_cast<const bf16_bits*>(X), y, W, b, out, rows, F, Cs, points, first);
  else
    shard_stats_kernel<float><<<grid, kThreads, bytes, s>>>(
        static_cast<const float*>(X), y, W, b, out, rows, F, Cs, points, first);
  return cudaGetLastError();
}

// grad: W (F, Cs), b (Cs,), weights (rows,) float32, lse (rows,) float64;
// partials: chunks * (F*Cs + Cs + 2) doubles of scratch; out: F*Cs + Cs + 2
// doubles, the shard's sums. chunks * rows_per_chunk >= rows (no chunks: no
// rows, sums of 0).
int lo_parent_shard_grad(const void* X, int x_bf16, const int* y, const float* weights,
                         const double* lse, const float* W, const float* b, double* partials,
                         double* out, int rows, int F, int Cs, int first, int chunks,
                         int rows_per_chunk, int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || Cs <= 0 || rows < 0 || chunks < 0 || rows_per_chunk <= 0 || max_blocks <= 0 ||
      static_cast<long long>(chunks) * rows_per_chunk < rows)
    return cudaErrorInvalidValue;
  const ShardGradLayout layout = pick_shard_grad_layout(F, Cs);
  if (layout.tile == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    if (x_bf16)
      shard_grad_kernel<bf16_bits><<<chunks, kThreads, layout.bytes, s>>>(
          static_cast<const bf16_bits*>(X), y, weights, lse, W, b, partials, rows, F, Cs, first,
          rows_per_chunk, layout);
    else
      shard_grad_kernel<float><<<chunks, kThreads, layout.bytes, s>>>(
          static_cast<const float*>(X), y, weights, lse, W, b, partials, rows, F, Cs, first,
          rows_per_chunk, layout);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  sums_kernel<<<dim3(grid_for(layout.cells, max_blocks), 1), kThreads, 0, s>>>(
      partials, out, chunks, layout.cells);
  return cudaGetLastError();
}

}  // extern "C"
'''

PARENT_KERNELS = {"stats": ("shard_stats_kernel",), "grad": ("shard_grad_kernel", "sums_kernel")}


def _replaced(text: str, kept: str, replacement: str, name: str) -> str:
    if text.count(kept) != 1:
        raise SystemExit(f"logistic.cu no longer holds the passage {name} replaces:\n{kept}")
    return text.replace(kept, replacement)


def form_sources(source: str) -> dict:
    """Each library's source: the kept one with the parent's forms
    appended, and the builds with a constant replaced."""
    kept = source + PARENT_FORMS
    rows = "constexpr int kStatsRows = 2;"
    stats_call = """rows_stats<kStatsRows, kShared>(x, F, Wp + static_cast<size_t>(p) * F * ws, bp + p * ws,
                                        ws, Cs, local, top, sum, at);"""
    phase2 = """        if (t > 0)
          add_groups(owned, group_sums + ((t - 1) & 1) * tile_groups * cells, cells, tile_groups);
        grad_items(group_sums + (t & 1) * tile_groups * cells, x0, stride, terms, tp, nll, wd, n,
                   F, Cs, cells);"""
    phase1 = "for (int r = threadIdx.x; r < n; r += kThreads) {"
    no_phase2 = _replaced(kept, phase2, "", "probe_grad_phase1")
    features = "#pragma unroll 4\n  for (int f = 0; f < F; ++f) {\n    float xf[kR];"
    return {
        "kept": kept,
        "logits_unroll1": _replaced(kept, features, features.replace("unroll 4", "unroll 1"),
                                    "logits_unroll1"),
        "logits_unroll8": _replaced(kept, features, features.replace("unroll 4", "unroll 8"),
                                    "logits_unroll8"),
        "rows1": _replaced(kept, rows, rows.replace("2", "1"), "rows1"),
        "rows4": _replaced(kept, rows, rows.replace("2", "4"), "rows4"),
        # probes, timed only (their outputs are not the kernels'): the
        # stats without their arithmetic, the grad without its sums, and
        # without its rows' terms as well
        "probe_stats_memory": _replaced(
            kept, stats_call, "for (int q = 0; q < kStatsRows; ++q) top[q] = sum[q] = at[q] = x[q][0];",
            "probe_stats_memory"),
        "probe_grad_phase1": no_phase2,
        "probe_grad_memory": _replaced(no_phase2, phase1, phase1.replace("r < n", "r < 0"),
                                       "probe_grad_memory"),
    }


def build_all(kernels, sources: dict) -> tuple[dict, dict]:
    """Each library, built by nvcc processes started together; and the
    ptxas lines of each library's shard kernels."""
    folder = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(folder, exist_ok=True)
    nvcc = kernels._find_nvcc()
    processes = {}
    for name, text in sources.items():
        path = os.path.join(folder, f"logistic-{name}.cu")
        with open(path, "w") as handle:
            handle.write(text)
        processes[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libraries, ptxas = {}, {}
    for name, process in processes.items():
        output = process.communicate()[0]
        if process.returncode != 0:
            raise SystemExit(f"nvcc failed to build form {name}:\n{output[-4000:]}")
        ptxas[name], entry = [], None
        for line in output.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "shard" in line and "'" in line else None
            elif entry is not None and ("Used" in line or "spill" in line):
                ptxas[name].append(f"{entry}: {line.split(':', 1)[-1].strip()}")
        lib = kernels._bind_logistic(ctypes.CDLL(os.path.join(folder, f"logistic-{name}.so")))
        # the parent's entry points: the kept ones' arguments but the layout
        lib.lo_parent_shard_stats.argtypes = lib.lo_logistic_shard_stats.argtypes[:-1]
        lib.lo_parent_shard_grad.argtypes = lib.lo_logistic_shard_grad.argtypes[:-1]
        lib.lo_parent_shard_stats.restype = lib.lo_parent_shard_grad.restype = ctypes.c_int
        libraries[name] = lib
    return libraries, ptxas


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("logistic_shard_variants.py needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.ml import logistic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with open(kernels.SOURCES["logistic"]) as handle:
        libraries, ptxas = build_all(kernels, form_sources(handle.read()))
    for name, lines in ptxas.items():
        for line in lines:
            print(f"ptxas {name}: {line}")
    edges = chip_smoke.check_shard_edges(torch) if "--edges" in sys.argv[1:] else None
    stream = torch.cuda.current_stream().cuda_stream
    device = torch.cuda.current_device()
    max_blocks = kernels.max_blocks(device)

    def layout_of(F, Cs, points, x_bytes, grad, tile=None, form=None):
        if grad:
            geometry = list(logistic._shard_grad_geometry(F, Cs, x_bytes))
            if tile is not None:
                geometry[0] = tile
            if form is not None:
                geometry[3] = form
            tile, staged, shared, form = geometry
            fields = logistic._shard_layout(F, Cs, 1, tile, staged, shared, x_bytes, True, form)
        else:
            default, staged, shared = logistic._shard_stats_geometry(F, Cs, points, x_bytes)
            fields = logistic._shard_layout(F, Cs, points, tile or default, staged, shared, x_bytes,
                                            False)
        return logistic._ShardLayout(**fields)

    # form -> (library, stats tile, grad tile, grad form); None: the parent's
    forms = {
        "kept": ("kept", None, None, None),
        "parent": None,
        "logits_unroll1": ("logits_unroll1", None, None, None),
        "logits_unroll8": ("logits_unroll8", None, None, None),
        "rows1": ("rows1", 256, None, None),
        "rows4": ("rows4", 1024, None, None),
        "grad_tile128": ("kept", None, 128, None),
        "grad_serial": ("kept", None, None, logistic._SHARD_SERIAL),
        "probe_stats_memory": ("probe_stats_memory", None, None, None),
        "probe_grad_phase1": ("probe_grad_phase1", None, None, None),
        "probe_grad_memory": ("probe_grad_memory", None, None, None),
    }
    probes = [form for form in forms if form.startswith("probe_")]

    def stats_call(form, W, b, X, y, first):
        points, F, Cs = W.shape[0], X.shape[1], W.shape[-1]
        out = torch.empty((points, X.shape[0], 3), dtype=torch.float32, device=X.device)
        common = (X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(), W.data_ptr(),
                  b.data_ptr(), out.data_ptr(), X.shape[0], F, Cs, points, first, max_blocks,
                  device, stream)
        if forms[form] is None:
            lib = libraries["kept"]
            error = lib.lo_parent_shard_stats(*common)
        else:
            lib_name, tile, _, _ = forms[form]
            lib = libraries[lib_name]
            layout = layout_of(F, Cs, points, X.element_size(), False, tile)
            error = lib.lo_logistic_shard_stats(*common, ctypes.addressof(layout))
        kernels.check(lib, f"{form} stats", error)
        return out

    def grad_call(form, W, b, X, y, w, lse, first):
        F, Cs = X.shape[1], W.shape[-1]
        cells = logistic._shard_cells(F, Cs)
        chunks, per_chunk = kernels.row_chunks(X.shape[0])
        partials = torch.empty((max(chunks, 1), cells), dtype=torch.float64, device=X.device)
        out = torch.empty(cells, dtype=torch.float64, device=X.device)
        common = (X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(), w.data_ptr(),
                  lse.data_ptr(), W.data_ptr(), b.data_ptr(), partials.data_ptr(), out.data_ptr(),
                  X.shape[0], F, Cs, first, chunks, per_chunk, max_blocks, device, stream)
        if forms[form] is None:
            lib = libraries["kept"]
            error = lib.lo_parent_shard_grad(*common)
        else:
            lib_name, _, tile, sum_form = forms[form]
            lib = libraries[lib_name]
            layout = layout_of(F, Cs, 1, X.element_size(), True, tile, sum_form)
            error = lib.lo_logistic_shard_grad(*common, ctypes.addressof(layout))
        kernels.check(lib, f"{form} grad", error)
        return out

    # the kept stats bit-equal to the parent's at the edge shapes
    edge_shapes = 0
    for rows in chip_smoke.SHARD_EDGE_ROWS:
        for features in chip_smoke.SHARD_EDGE_FEATURES:
            rng = np.random.default_rng(rows * 10_007 + features)
            X_host = rng.normal(size=(rows, features)).astype(np.float32)
            for classes in chip_smoke.SHARD_EDGE_CLASSES:
                W4 = torch.from_numpy((rng.normal(size=(4, features, classes))
                                       * chip_smoke._edge_weight_scale(features)).astype(np.float32)).cuda()
                b4 = torch.from_numpy(rng.normal(size=(4, classes)).astype(np.float32)).cuda()
                y = torch.from_numpy(rng.integers(0, 2 * classes + 1, size=rows).astype(np.int32)).cuda()
                for dtype in (torch.float32, torch.bfloat16):
                    X = torch.from_numpy(X_host).cuda().to(dtype)
                    for points in (1, 4):
                        Wp, bp = W4[:points].contiguous(), b4[:points].contiguous()
                        kept = stats_call("kept", Wp, bp, X, y, classes // 2)
                        shifted = stats_call("kept", Wp, bp, chip_smoke._misaligned(torch, X), y,
                                             classes // 2)
                        parent = stats_call("parent", Wp, bp, X, y, classes // 2)
                        if not torch.equal(kept, parent) or not torch.equal(shifted, parent):
                            raise SystemExit(f"stats at {rows}x{features}, Cs {classes}, {points} "
                                             f"points, {dtype}: not the parent's bits")
                    edge_shapes += 1

    X_np, y_np = chip_smoke.bench_synthetic(chip_smoke.FIT_ROWS)
    mean, scale = logistic.scaler_stats(X_np)
    rows = chip_smoke._grid_block_rows()
    X32 = torch.from_numpy(logistic._standardized(X_np[:rows], mean, scale)).cuda()
    w = torch.ones(rows, dtype=torch.float32, device=X32.device)
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    read_flush = chip_smoke._ReadFlush(torch, flush.device)
    shapes, bounds, held, grad_by_kernel = {}, {}, {}, {}
    for classes, labels in ((chip_smoke.DEEP_CLASSES, chip_smoke.ten_classes(X_np)),
                            (chip_smoke.CLASSES, y_np)):
        y = torch.from_numpy(labels[:rows].astype(np.int32)).cuda()
        rng = np.random.default_rng(classes + 200)   # check_k7_shards' parameters

        def cuda(*shape):
            return torch.from_numpy((rng.normal(size=shape) * 0.3).astype(np.float32)).cuda()

        W, b, D, d = (cuda(chip_smoke.FEATURES, classes), cuda(classes),
                      cuda(chip_smoke.FEATURES, classes), cuda(classes))
        steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=X32.device)
        W4 = (W[None] + steps[:, None, None] * D[None]).contiguous()
        b4 = (b[None] + steps[:, None] * d[None]).contiguous()
        width = classes // chip_smoke.GRID_MODEL
        Ws, bs = W[:, :width].contiguous(), b[:width].contiguous()
        W4s, b4s = W4[:, :, :width].contiguous(), b4[:, :width].contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            X = X32.to(dtype)
            key = f"{rows}x{chip_smoke.FEATURES}:C{classes}/M{chip_smoke.GRID_MODEL}:" + (
                "bf16" if dtype == torch.bfloat16 else "f32")
            for Wp, bp in ((Ws[None], bs[None]), (W4s, b4s)):
                if not torch.equal(stats_call("kept", Wp, bp, X, y, 0), stats_call("parent", Wp, bp, X, y, 0)):
                    raise SystemExit(f"stats at {key}, {Wp.shape[0]} points: not the parent's bits")
            lse = logistic._combine_log_sums([logistic._shard_log_sums(stats_call(
                "kept", W[None, :, first:first + width].contiguous(),
                b[None, first:first + width].contiguous(), X, y, first)[0])
                for first in range(0, classes, width)])
            twin_stats = logistic._shard_stats(W4s, b4s, X, y, 0)
            twin_grad = logistic._shard_grad(Ws, bs, X, y, w, lse, 0)
            names = [form for form in forms if dtype == torch.float32 and classes == chip_smoke.DEEP_CLASSES
                     or form in ("kept", "parent") or form in probes and dtype == torch.float32]
            for form in (form for form in names if form not in probes):
                stats = stats_call(form, W4s, b4s, X, y, 0)
                grad = grad_call(form, Ws, bs, X, y, w, lse, 0)
                if not torch.equal(stats, stats_call(form, W4s, b4s, X, y, 0)) or \
                        not torch.equal(grad, grad_call(form, Ws, bs, X, y, w, lse, 0)):
                    raise SystemExit(f"{form} at {key}: a second launch differs")
                what = f"{form} at {key}"
                held[f"{what}"] = {
                    "stats": chip_smoke._held_shard_stats(what, stats, twin_stats, X, W4s, b4s),
                    "grad": chip_smoke._held_shard_grad(what, grad, twin_grad, rows),
                }
            calls = {
                "stats": lambda form: stats_call(form, W4s, b4s, X, y, 0),
                "grad": lambda form: grad_call(form, Ws, bs, X, y, w, lse, 0),
            }
            x_bytes = X.element_size()
            bounds[key] = {
                "stats": chip_smoke._shard_bound("logistic_shard_stats", rows, chip_smoke.FEATURES, width, 4, x_bytes),
                "grad": chip_smoke._shard_bound("logistic_shard_grad", rows, chip_smoke.FEATURES, width, 1, x_bytes),
            }
            # the kept grad's time by kernel: the chunks' and their sum's
            grad_by_kernel[key] = {name: {
                "device_ms": chip_smoke._device_ms(
                    torch, lambda: calls["grad"]("kept"), (name,), REPEATS, flush),
                "device_ms_clean_l2": chip_smoke._device_ms(
                    torch, lambda: calls["grad"]("kept"), (name,), REPEATS, read_flush),
            } for name in chip_smoke.SHARD_KERNELS["logistic_shard_grad"]}
            order = ["kept", "parent", "parent", "kept"]
            if len(names) > 2:
                weighed = [form for form in names if form not in ("kept", "parent")]
                order += ["kept"] + weighed + weighed[::-1] + ["kept"]
            timing = shapes.setdefault(key, {})
            for form in order:
                for kernel, call in calls.items():
                    kernel_names = (PARENT_KERNELS[kernel] if form == "parent"
                                    else chip_smoke.SHARD_KERNELS[f"logistic_shard_{kernel}"])
                    entry = timing.setdefault(form, {}).setdefault(
                        kernel, {"device_ms": [], "device_ms_clean_l2": [], "ms": []})
                    entry["device_ms"].append(chip_smoke._device_ms(
                        torch, lambda: call(form), kernel_names, REPEATS, flush))
                    entry["device_ms_clean_l2"].append(chip_smoke._device_ms(
                        torch, lambda: call(form), kernel_names, REPEATS, read_flush))
                    entry["ms"].append(chip_smoke._event_ms(torch, lambda: call(form), REPEATS, flush))
    results = {
        "grad_by_kernel": grad_by_kernel,
        "shapes": shapes, "bound_ms": bounds, "held": held,
        "stats_bit_equal_to_parent": {"run_d_shapes": True, "edge_shapes": edge_shapes},
        "geometry": {
            key: {"stats": list(logistic._shard_stats_geometry(chip_smoke.FEATURES, width, 4, x_bytes)),
                  "grad": list(logistic._shard_grad_geometry(chip_smoke.FEATURES, width, x_bytes))}
            for key, width, x_bytes in (("C/M 5 f32", 5, 4), ("C/M 5 bf16", 5, 2),
                                        ("C/M 1 f32", 1, 4), ("C/M 1 bf16", 1, 2))},
        "lost_traces": len(chip_smoke.LOST_TRACES),
    }
    if edges is not None:
        results["edges"] = edges
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
