// scaler.cu — the masked scaler and the standardization of a row block
// (K8′) for Hopper (sm_90a), for a logistic regression fit from rows
// sharded over ranks.
//
// Replaces, in learningorchestra_tpu/:
//   K8′ ml/logistic.py:412 `_masked_stats`  -> lo_masked_col_sums (two passes)
//       ml/logistic.py:426 `_standardize`   -> lo_masked_standardize
//
// lo_masked_col_sums: from one read of a rank's block X (N, F) float32 and
// its row weights w (N,) float32 (the validity mask, 0 or 1), the float64
// sums of the block:
//   pass 1 (mean null):  out[f] = sum_i w_i x_if          out[F] = sum_i w_i
//   pass 2 (centred):    out[f] = sum_i w_i (x_if - mean_f)^2, about the
//                        float64 mean of pass 1;          out[F] = sum_i w_i
// The caller (ml/logistic.py `masked_stats`) gathers every rank's sums, adds
// them in rank order in float64, divides by the global sum of the weights,
// takes the square root and rounds once to float32. Two passes, as the
// reference: one pass of E[x^2] - mean^2 cancels on features whose mean is
// large against their spread.
// lo_masked_standardize: out = ((x - mean_f) / scale_f) * w_i in float32,
// each operation rounded on its own (__fsub_rn, __fdiv_rn, __fmul_rn: no
// contraction into an fma), so that the output is bit-equal to the plain
// version's, and to the reference's on the same mean and scale.
//
// What bounds it on this card, at the fit's shape (a rank's block of
// 1,048,576 rows x 16 features): a stats pass reads X and w once, 71.3 MB
// (68 MiB), 21.3 us at 3.35 TB/s. Its float64 work (a product and an add a
// value in pass 1; a difference, two products and an add in pass 2) is 1 to
// 2 us at 33.5 T/s, and the float32 -> float64 conversions (one a value and
// one a weight a thread), at a quarter of that rate, some 5 us: bytes bound
// it, as long as enough of them are in flight. The standardization reads X
// and w and writes X once, 138 MB, 41 us.
//
// lo_masked_col_sums: one launch a pass (masked_sums_kernel).
//   - The geometry is a function of (rows, F) alone. ml/logistic.py
//     `_sums_chunks` splits the rows into chunks, as many as make 264 blocks
//     with the feature windows (two resident blocks of 512 threads on each
//     of the 132 SMs, one wave: the launch bounds hold a thread to 64
//     registers, so that two fit), and no more than leave 1,024 rows to a
//     chunk. Rows of up to 64 features are one window; wider rows go in
//     windows of 32 features along grid y, so that a few chunks of wide rows
//     still spread over many blocks.
//   - A thread owns a unit of a window's row: a 16-byte word of 4 features
//     where F is a multiple of 4 and X is 16-byte aligned (at F = 16 four
//     threads a row, a warp 8 whole rows: 512 contiguous bytes a load), else
//     one feature. With `units` threads a row, a block takes lanes =
//     512 / units rows at a time; lane l adds the rows l, l + lanes, ... of
//     its chunk.
//   - Bytes in flight: a lane's rows come in batches of kBatch (2), and the
//     next batch's loads are issued before the current batch is added
//     (registers double-buffered, no break in the loop): 32 to 64 bytes of X
//     a thread, 32 to 64 KB an SM. A row past the chunk is predicated off
//     (no load; its add a select that keeps the sum), so the sums do not
//     depend on the batch.
//   - The order of the float64 adds, a function of (rows, F) alone:
//     (1) a thread adds its rows' terms in row order, from 0;
//     (2) the block adds its lanes' sums a cell (a feature, or the weights)
//         at a time by `sum_along`: runs of consecutive lanes, each run in
//         lane order by one thread, then the runs in run order by one thread
//         a cell; the block writes the result as its chunk's float64
//         partials, partials[chunk][f] and, in window 0, partials[chunk][F];
//     (3) the last block to finish adds the chunks' partials by `sum_along`
//         too (runs of consecutive chunks, each in chunk order, then the
//         runs in run order), with all of its threads, and writes out.
//     `sum_along` over n items and c cells makes r = min(n, 512 / c) runs
//     of ceil(n / r) items (the last run shorter; fewer runs where that
//     leaves one empty); over more than 512 cells, one run a cell. A run's
//     loads are issued 16 at a time before its adds. At the main shape:
//     128 lanes in 26 runs of 5 (the last of 3), 264 chunks in 30 runs of 9
//     (the last of 3). No float atomics: a second launch gives the same
//     bits, and the ranks of fit_sharded, whose blocks have one shape, the
//     same sums.
//   - The kernel's serial tail comes after the last chunk is done: its
//     partials made visible, the ticket, every chunk's partials read, out
//     written, each an L2 round trip, and the adds between them. Blocks of
//     512 threads halve the partials the last block reads against blocks
//     of 256, and double the threads that read them; a run's loads go out
//     together (one round trip at the main shape).
//   - The ticket: one unsigned in a scratch that the wrapper keeps zeroed
//     (kernels.zeroed_scratch, the one K5 uses). After a barrier, one
//     thread of a block makes the block's partials visible (__threadfence,
//     cumulative over what the barrier ordered) and takes a ticket
//     (atomicAdd); the block that draws the last one reads every chunk's
//     partials from L2 (__ldcg), writes out and sets the ticket back to 0
//     for the next launch on the stream. No memset runs.
//   - Products in float64: w x is exact (two float32 values); the centred
//     term rounds x - mean, its square and the product by w, each once
//     (__dsub_rn, __dmul_rn, __dadd_rn: no contraction into an fma).
// lo_masked_standardize: a grid-stride loop over the N * F values, four of
//   one row at a time (one 16-byte load and store) when F is a multiple of
//   4 and the pointers allow it, else one at a time.
// Build without -use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// masked_sums_kernel: its threads a block, the blocks an SM holds at once
// (its launch bounds; ml/logistic.py `_SUMS_BLOCKS` is 132 SMs times this),
// the rows of a lane's batch, and the loads sum_along issues together
constexpr int kSumsThreads = 512;
constexpr int kSumsBlocksPerSM = 2;
constexpr int kBatch = 2;
constexpr int kRunLoads = 16;

// The features a block of masked_sums_kernel sums: all of a row of up to
// 64, else a window of 32 (ml/logistic.py `_sums_windows`).
__host__ __device__ __forceinline__ int window_features(int F) { return F <= 64 ? F : 32; }

// The V values of a row that a thread owns: one 16-byte word (V = 4), or
// one value.
template <int V>
__device__ __forceinline__ void load_unit(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Is this block the last of `blocks` to finish? After the barrier one
// thread makes the block's writes visible to the device (__threadfence is
// cumulative: it orders the writes the barrier showed it) and takes the
// ticket; the last block then reads the others' with __ldcg (L2, not a
// stale L1).
__device__ __forceinline__ bool last_block(unsigned* __restrict__ ticket, unsigned blocks) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == blocks - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

// total + load(i, c) for i in [begin, end), in i order, the loads issued
// kRunLoads at a time before their adds.
template <typename Load>
__device__ __forceinline__ double add_run(double total, int begin, int end, int c, Load load) {
  for (int i = begin; i < end; i += kRunLoads) {
    double value[kRunLoads];
#pragma unroll
    for (int k = 0; k < kRunLoads; ++k) value[k] = i + k < end ? load(i + k, c) : 0.0;
#pragma unroll
    for (int k = 0; k < kRunLoads; ++k)
      if (i + k < end) total = __dadd_rn(total, value[k]);
  }
  return total;
}

// The float64 sums along i < n (n >= 1) of load(i, c), for each cell
// c < cells, in an order fixed by (n, cells): runs of consecutive i, each
// added in i order by one thread, then the runs in run order by one thread
// a cell, which calls emit(c, sum). Over more than kSumsThreads cells, one
// run a cell. Every thread of the block calls it; `runs` holds
// kSumsThreads doubles of shared memory.
template <typename Load, typename Emit>
__device__ __forceinline__ void sum_along(int n, int cells, Load load, Emit emit,
                                          double* __restrict__ runs) {
  if (cells > kSumsThreads) {
    for (int c = threadIdx.x; c < cells; c += kSumsThreads) emit(c, add_run(0.0, 0, n, c, load));
    return;
  }
  const int per = (n + min(n, kSumsThreads / cells) - 1) / min(n, kSumsThreads / cells);
  const int count = (n + per - 1) / per;
  if (threadIdx.x < count * cells) {
    const int run = threadIdx.x / cells, c = threadIdx.x - run * cells;
    runs[threadIdx.x] = add_run(0.0, run * per, min(n, (run + 1) * per), c, load);
  }
  __syncthreads();
  if (threadIdx.x < cells) {
    double total = 0.0;
    for (int run = 0; run < count; ++run) total = __dadd_rn(total, runs[run * cells + threadIdx.x]);
    emit(threadIdx.x, total);
  }
}

// Block (chunk blockIdx.x, feature window blockIdx.y) of one pass: its
// chunk's float64 sums of its window's features into partials[chunk][f],
// and in window 0 the sum of the weights into partials[chunk][F]; the last
// block adds the chunks into out (F + 1) and resets the ticket. V: the
// features a thread owns (4: a 16-byte word, X 16-byte aligned and F a
// multiple of 4). kCentred: pass 2, about mean.
template <int V, bool kCentred>
__global__ void __launch_bounds__(kSumsThreads, kSumsBlocksPerSM)
    masked_sums_kernel(const float* __restrict__ X, const float* __restrict__ w,
                       const double* __restrict__ mean, double* __restrict__ partials,
                       unsigned* __restrict__ ticket, double* __restrict__ out, int rows, int F,
                       int rows_per_chunk) {
  __shared__ double table[(V + 1) * kSumsThreads];  // (lane, cell): lanes x (cols + 1)
  __shared__ double runs[kSumsThreads];
  const int cols = window_features(F);
  const int units = cols / V;
  const int lanes = kSumsThreads / units;
  const int lane = threadIdx.x / units, unit = threadIdx.x - lane * units;
  const int base = blockIdx.y * cols;  // the window's first feature
  const int f = base + unit * V;       // this thread's first feature
  const bool active = lane < lanes && f < F;
  const bool weights = blockIdx.y == 0 && unit == 0;
  const int row0 = blockIdx.x * rows_per_chunk;
  const int row1 = min(rows, row0 + rows_per_chunk);
  double centre[V], sum[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    centre[j] = kCentred && active ? mean[f + j] : 0.0;
    sum[j] = 0.0;
  }
  double weight_sum = 0.0;
  if (active) {
    // the batch of rows first, first + lanes, ...: loaded, or zeros past the chunk
    auto load = [&](int first, float (&xs)[kBatch][V], float (&ws)[kBatch]) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int row = first + u * lanes;
        if (row < row1) {
          load_unit<V>(X + static_cast<size_t>(row) * F + f, xs[u]);
          ws[u] = __ldg(w + row);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) xs[u][j] = 0.0f;
          ws[u] = 0.0f;
        }
      }
    };
    float x[kBatch][V], wr[kBatch];
    load(row0 + lane, x, wr);
    for (int r = row0 + lane; r < row1; r += lanes * kBatch) {
      float next_x[kBatch][V], next_w[kBatch];
      load(r + lanes * kBatch, next_x, next_w);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = r + u * lanes < row1;
        const double weight = static_cast<double>(wr[u]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          double term;
          if (kCentred) {
            const double d = __dsub_rn(static_cast<double>(x[u][j]), centre[j]);
            term = __dmul_rn(__dmul_rn(d, d), weight);
          } else {
            term = __dmul_rn(weight, static_cast<double>(x[u][j]));
          }
          sum[j] = in ? __dadd_rn(sum[j], term) : sum[j];
        }
        if (weights) weight_sum = in ? __dadd_rn(weight_sum, weight) : weight_sum;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) x[u][j] = next_x[u][j];
        wr[u] = next_w[u];
      }
    }
  }
  // the lanes' sums, then added along the lanes (sum_along) into the chunk's partials
  const int stride = cols + 1;
  if (lane < lanes) {
#pragma unroll
    for (int j = 0; j < V; ++j) table[lane * stride + unit * V + j] = sum[j];
    if (unit == 0) table[lane * stride + cols] = weight_sum;
  }
  __syncthreads();
  double* chunk_sums = partials + static_cast<size_t>(blockIdx.x) * (F + 1);
  sum_along(
      lanes, stride, [&](int i, int c) { return table[i * stride + c]; },
      [&](int c, double total) {
        if (c < cols) {
          if (base + c < F) chunk_sums[base + c] = total;
        } else if (blockIdx.y == 0) {
          chunk_sums[F] = total;
        }
      },
      runs);
  if (!last_block(ticket, gridDim.x * gridDim.y)) return;
  const int cells = F + 1;
  sum_along(
      gridDim.x, cells,
      [&](int i, int c) { return __ldcg(partials + static_cast<size_t>(i) * cells + c); },
      [&](int c, double total) { out[c] = total; }, runs);
  if (threadIdx.x == 0) *ticket = 0u;
}

__device__ __forceinline__ float standardized(float x, float mean, float scale, float weight) {
  return __fmul_rn(__fdiv_rn(__fsub_rn(x, mean), scale), weight);
}

__global__ void __launch_bounds__(kThreads)
    standardize_kernel(const float* __restrict__ X, const float* __restrict__ mean,
                       const float* __restrict__ scale, const float* __restrict__ w,
                       float* __restrict__ out, long long rows, int F) {
  const long long values = rows * F;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < values;
       i += step) {
    const long long row = i / F;
    const int f = static_cast<int>(i - row * F);
    out[i] = standardized(X[i], mean[f], scale[f], w[row]);
  }
}

// Four values of one row a thread (F a multiple of 4, 16-byte aligned X and out).
__global__ void __launch_bounds__(kThreads)
    standardize4_kernel(const float4* __restrict__ X, const float* __restrict__ mean,
                        const float* __restrict__ scale, const float* __restrict__ w,
                        float4* __restrict__ out, long long rows, int F) {
  const int words = F / 4;
  const long long total = rows * words;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; q < total;
       q += step) {
    const long long row = q / words;
    const int f = static_cast<int>(q - row * words) * 4;
    const float weight = w[row];
    const float4 x = X[q];
    float4 y;
    y.x = standardized(x.x, mean[f], scale[f], weight);
    y.y = standardized(x.y, mean[f + 1], scale[f + 1], weight);
    y.z = standardized(x.z, mean[f + 2], scale[f + 2], weight);
    y.w = standardized(x.w, mean[f + 3], scale[f + 3], weight);
    out[q] = y;
  }
}

int grid_for(long long items, int max_blocks) {
  return static_cast<int>(std::max<long long>(
      1, std::min<long long>((items + kThreads - 1) / kThreads, max_blocks)));
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) of
// `device`, does not synchronize, and returns cudaGetLastError() after its
// launches: 0 means they were accepted. Outputs and scratch are allocated
// by the caller.

// X (rows, F) float32, w (rows,) float32, mean (F,) float64 or null (pass
// 1); partials: chunks * (F + 1) doubles of scratch; ticket: one unsigned,
// 0, left 0; out: F + 1 doubles. chunks >= 1 (one block with no rows when
// rows is 0), chunks * rows_per_chunk >= rows.
int lo_masked_col_sums(const float* X, const float* w, const double* mean, double* partials,
                       unsigned* ticket, double* out, int rows, int F, int chunks,
                       int rows_per_chunk, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || rows < 0 || chunks <= 0 || rows_per_chunk <= 0 || ticket == nullptr ||
      static_cast<long long>(chunks) * rows_per_chunk < rows)
    return cudaErrorInvalidValue;
  const int windows = (F + window_features(F) - 1) / window_features(F);
  if (windows > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, windows);
  const bool words = F % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  if (words && mean != nullptr)
    masked_sums_kernel<4, true><<<grid, kSumsThreads, 0, s>>>(X, w, mean, partials, ticket, out,
                                                          rows, F, rows_per_chunk);
  else if (words)
    masked_sums_kernel<4, false><<<grid, kSumsThreads, 0, s>>>(X, w, mean, partials, ticket, out,
                                                           rows, F, rows_per_chunk);
  else if (mean != nullptr)
    masked_sums_kernel<1, true><<<grid, kSumsThreads, 0, s>>>(X, w, mean, partials, ticket, out,
                                                          rows, F, rows_per_chunk);
  else
    masked_sums_kernel<1, false><<<grid, kSumsThreads, 0, s>>>(X, w, mean, partials, ticket, out,
                                                           rows, F, rows_per_chunk);
  return cudaGetLastError();
}

// X (rows, F), mean (F,), scale (F,), w (rows,), out (rows, F), all float32.
int lo_masked_standardize(const float* X, const float* mean, const float* scale, const float* w,
                          float* out, long long rows, int F, int max_blocks, int device,
                          void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || rows < 0 || max_blocks <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (F % 4 == 0 && aligned) {
    standardize4_kernel<<<grid_for(rows * (F / 4), max_blocks), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(X), mean, scale, w, reinterpret_cast<float4*>(out), rows,
        F);
  } else {
    standardize_kernel<<<grid_for(rows * F, max_blocks), kThreads, 0, s>>>(X, mean, scale, w,
                                                                          out, rows, F);
  }
  return cudaGetLastError();
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
