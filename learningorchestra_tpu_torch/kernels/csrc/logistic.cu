// logistic.cu — the logistic regression fit's loss-and-gradient pass (K7)
// for Hopper (sm_90a).
//
// Replaces, in learningorchestra_tpu/:
//   K7 ml/logistic.py:35 `_loss_fn` and its jax.value_and_grad inside
//      :141 `_fit_segment_impl`             -> lo_logistic_loss_grad
//      the Armijo trial losses of :176-200  -> lo_logistic_trial_losses
//
// lo_logistic_loss_grad: from one read of the standardized rows X (N, F)
// float32 and their labels y (N,) int32, at W (F, C) and b (C,):
//   loss = mean_i nll_i,  nll_i = log sum_c exp(z_ic) - z_iy,  z = xW + b
//   dW   = X^T (P - onehot(y)) / N,  db = sum_i (p_i - onehot(y_i)) / N
// lo_logistic_trial_losses: the mean nll at four candidate parameter sets
// (W + t D, b + t d_b for t = 1, 1/2, 1/4, 1/8), again from one read of X:
// the reference's while_loop stops at the first accepted step; the port
// computes the four trial losses at once and picks on the device.
// The L2 term 0.5 l2 |W|^2 and its gradient l2 W act on F x C values and
// stay torch ops (ml/logistic.py).
//
// What bounds it on this card, at the fit's shape (N = 1,000,000 rows,
// F = 16, C = 2 or 10): X and y read once, 68 MB, ~20 us at 3.35 TB/s.
// Its operations (2NFC float32 for the logits, 2NFC float64 for the
// gradient, 8NFC float32 for the trial losses) take less at the float32
// and float64 peaks. This is the simple version, written to be right
// first, not tuned to its bound.
//
// Design and numerics:
//   - Deterministic, as K2 and K5 are: the rows go in fixed chunks (a
//     function of the row count alone), a block per chunk. In a chunk,
//     tiles of rows are staged in shared memory; a thread computes one
//     row's logits, log-softmax, nll and residual p - onehot into the
//     tile; then each (cell, group) of the block's float64 partial sums
//     (F*C cells of dW, C of db and 1 of the loss) is owned by one thread,
//     which adds its rows of the tile in row order. No float atomics: the
//     groups are added in order, and a second kernel adds the chunks'
//     partials in chunk order and divides by N, rounding once to float32.
//     A refit is bit identical.
//   - Accurate: the sums over rows are float64 (each product x * r of two
//     float32 values is exact in float64), as the plain twin's are.
//   - The row's log-softmax is the reference's: shifted = z - max(z),
//     nll = log(sum(exp(shifted))) - shifted[y], p = exp(shifted - log sum).
//   - The tile's rows sit at an odd stride in shared memory, so that a
//     warp's threads, a row each, read 32 different banks (at F = 16 a
//     stride of 16 made every such read a 16-way bank conflict).
//   - Any class count: a row's logits live in the shared tile, which
//     holds fewer rows when C is large; when F*C + C + 1 cells do not fit
//     one block's partials, the cells are split into windows over a
//     second grid dimension (each window's blocks recompute the residuals).
//     The wrapper picks the tile and window (ml/logistic.py).
//   - Build without -use_fast_math: expf and logf are the accurate ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;  // _THREADS in ml/logistic.py
constexpr int kCandidates = 4;  // Armijo trial steps 1, 1/2, 1/4, 1/8
constexpr size_t kDefaultSharedBytes = 48 * 1024;

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int grid_for(long long items, int max_blocks) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  const long long capped = blocks < max_blocks ? blocks : max_blocks;
  return static_cast<int>(capped > 0 ? capped : 1);
}

// One row at (W, b): its logits z = x W + b, shifted by their maximum, into
// z[0..C); returns the row's nll. With `residual`, z then holds
// p - onehot(label). A label outside [0, C) gives a NaN nll.
__device__ float row_terms(const float* x, int F, const float* __restrict__ W,
                           const float* __restrict__ b, int C, int label,
                           float* z, bool residual) {
  float top = -INFINITY;
  for (int c = 0; c < C; ++c) {
    float dot = 0.0f;
#pragma unroll 4
    for (int f = 0; f < F; ++f) dot = fmaf(x[f], __ldg(W + f * C + c), dot);
    z[c] = __fadd_rn(dot, __ldg(b + c));
    top = fmaxf(top, z[c]);
  }
  float sum = 0.0f;
  for (int c = 0; c < C; ++c) {
    z[c] = __fsub_rn(z[c], top);
    sum = __fadd_rn(sum, expf(z[c]));
  }
  const float log_sum = logf(sum);
  const float nll =
      label >= 0 && label < C ? __fsub_rn(log_sum, z[label]) : nanf("");
  if (residual)
    for (int c = 0; c < C; ++c)
      z[c] = __fsub_rn(expf(__fsub_rn(z[c], log_sum)), c == label ? 1.0f : 0.0f);
  return nll;
}

// A tile's row stride in shared memory: odd, so that the 32 threads of a
// warp, one row each, read 32 different banks.
__host__ __device__ __forceinline__ int odd_stride(int width) { return width | 1; }

// Stage rows [start, start + n) of X into the tile (row stride
// odd_stride(F)), coalesced.
__device__ __forceinline__ void stage_rows(const float* __restrict__ X,
                                           float* tile_x, int start, int n,
                                           int F) {
  const float* src = X + static_cast<size_t>(start) * F;
  const int stride = odd_stride(F);
  for (int i = threadIdx.x; i < n * F; i += blockDim.x)
    tile_x[(i / F) * stride + i % F] = src[i];
}

// Block (chunk, cell window): the float64 partial sums over the chunk's
// rows of cells [cell_begin, cell_begin + window): cell f*C + c of dW,
// F*C + c of db, F*C + C of the loss. Slot (group, cell) is owned by one
// thread, which adds rows group, group + groups, ... of each tile in order.
__global__ void __launch_bounds__(kThreads)
    loss_grad_kernel(const float* __restrict__ X, const int* __restrict__ y,
                     const float* __restrict__ W, const float* __restrict__ b,
                     double* __restrict__ partials, int rows, int F, int C,
                     int rows_per_chunk, int tile_rows, int window_cells) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int cells = F * C + C + 1;
  const int cell_begin = blockIdx.y * window_cells;
  const int wc = min(window_cells, cells - cell_begin);
  const int groups = max(1, kThreads / wc);
  const int slots = groups * wc;
  double* acc = reinterpret_cast<double*>(shared);  // [group][cell]
  const int xs = odd_stride(F), zs = odd_stride(C);
  float* tile_x = reinterpret_cast<float*>(acc + max(kThreads, window_cells));
  float* tile_z = tile_x + tile_rows * xs;
  float* tile_nll = tile_z + tile_rows * zs;

  for (int i = threadIdx.x; i < slots; i += kThreads) acc[i] = 0.0;
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  for (int start = row_begin; start < row_end; start += tile_rows) {
    const int n = min(tile_rows, row_end - start);
    __syncthreads();  // the previous tile is consumed
    stage_rows(X, tile_x, start, n, F);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += kThreads)
      tile_nll[r] = row_terms(tile_x + r * xs, F, W, b, C, y[start + r],
                              tile_z + r * zs, true);
    __syncthreads();
    for (int slot = threadIdx.x; slot < slots; slot += kThreads) {
      const int group = slot / wc;
      const int cell = cell_begin + slot % wc;
      double sum = 0.0;
      if (cell < F * C) {
        const int f = cell / C, c = cell % C;
#pragma unroll 4
        for (int r = group; r < n; r += groups)
          sum = __fma_rn(static_cast<double>(tile_x[r * xs + f]),
                         static_cast<double>(tile_z[r * zs + c]), sum);
      } else if (cell < F * C + C) {
        const int c = cell - F * C;
#pragma unroll 4
        for (int r = group; r < n; r += groups)
          sum = __dadd_rn(sum, static_cast<double>(tile_z[r * zs + c]));
      } else {
#pragma unroll 4
        for (int r = group; r < n; r += groups)
          sum = __dadd_rn(sum, static_cast<double>(tile_nll[r]));
      }
      acc[slot] = __dadd_rn(acc[slot], sum);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < wc; i += kThreads) {
    double total = acc[i];
    for (int g = 1; g < groups; ++g) total = __dadd_rn(total, acc[g * wc + i]);
    partials[static_cast<size_t>(blockIdx.x) * cells + cell_begin + i] = total;
  }
}

// Block = one chunk: the float64 sums of the nll of the chunk's rows at
// each of the four candidate parameter sets W4 (4, F, C), b4 (4, C).
// Thread t takes rows t, t + kThreads, ... of every tile; the block's
// threads are then added in a fixed tree order.
__global__ void __launch_bounds__(kThreads)
    trial_losses_kernel(const float* __restrict__ X, const int* __restrict__ y,
                        const float* __restrict__ W4,
                        const float* __restrict__ b4,
                        double* __restrict__ partials, int rows, int F, int C,
                        int rows_per_chunk, int tile_rows) {
  extern __shared__ __align__(16) unsigned char shared[];
  double* reduce = reinterpret_cast<double*>(shared);  // [candidate][thread]
  const int xs = odd_stride(F), zs = odd_stride(C);
  float* tile_x = reinterpret_cast<float*>(reduce + kCandidates * kThreads);
  float* tile_z = tile_x + tile_rows * xs;

  double acc[kCandidates] = {0.0, 0.0, 0.0, 0.0};
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  for (int start = row_begin; start < row_end; start += tile_rows) {
    const int n = min(tile_rows, row_end - start);
    __syncthreads();  // the previous tile is consumed
    stage_rows(X, tile_x, start, n, F);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += kThreads) {
      const int label = y[start + r];
      for (int k = 0; k < kCandidates; ++k)
        acc[k] = __dadd_rn(acc[k], static_cast<double>(row_terms(
                                       tile_x + r * xs, F, W4 + k * F * C,
                                       b4 + k * C, C, label, tile_z + r * zs,
                                       false)));
    }
  }
  for (int k = 0; k < kCandidates; ++k) reduce[k * kThreads + threadIdx.x] = acc[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride)
      for (int k = 0; k < kCandidates; ++k)
        reduce[k * kThreads + threadIdx.x] = __dadd_rn(
            reduce[k * kThreads + threadIdx.x],
            reduce[k * kThreads + threadIdx.x + stride]);
    __syncthreads();
  }
  if (threadIdx.x < kCandidates)
    partials[static_cast<size_t>(blockIdx.x) * kCandidates + threadIdx.x] =
        reduce[threadIdx.x * kThreads];
}

// out[i] = (sum over chunks, in chunk order, of partials[chunk][i]) / rows,
// rounded once to float32; no chunks (no rows) give 0 / 0 = NaN, as the
// reference's mean over no rows does.
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const double* __restrict__ partials, float* __restrict__ out,
                  int chunks, int cells, double rows) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += gridDim.x * blockDim.x) {
    // in chunk order, the loads issued sixteen at a time
    double sum = 0.0;
    int c = 0;
    for (; c + 16 <= chunks; c += 16) {
      double value[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        value[j] = partials[static_cast<size_t>(c + j) * cells + i];
#pragma unroll
      for (int j = 0; j < 16; ++j) sum = __dadd_rn(sum, value[j]);
    }
    for (; c < chunks; ++c)
      sum = __dadd_rn(sum, partials[static_cast<size_t>(c) * cells + i]);
    out[i] = __double2float_rn(__ddiv_rn(sum, rows));
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) of
// `device`, does not synchronize, and returns cudaGetLastError() after its
// launches: 0 means they were accepted. Outputs and scratch are allocated
// by the caller.

// partials: chunks * (F*C + C + 1) doubles of scratch; out: F*C + C + 1
// floats, [dW (F, C) | db (C) | loss].
int lo_logistic_loss_grad(const float* X, const int* y, const float* W,
                          const float* b, double* partials, float* out,
                          int rows, int F, int C, int chunks,
                          int rows_per_chunk, int tile_rows, int window_cells,
                          int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || C <= 0 || tile_rows <= 0 || window_cells <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cells = F * C + C + 1;
  if (chunks > 0) {
    const size_t shared_bytes =
        sizeof(double) * static_cast<size_t>(std::max(kThreads, window_cells)) +
        sizeof(float) * static_cast<size_t>(tile_rows) *
            (odd_stride(F) + odd_stride(C) + 1);
    error = allow_shared(loss_grad_kernel, shared_bytes);
    if (error != cudaSuccess) return error;
    const dim3 grid(chunks, (cells + window_cells - 1) / window_cells);
    loss_grad_kernel<<<grid, kThreads, shared_bytes, s>>>(
        X, y, W, b, partials, rows, F, C, rows_per_chunk, tile_rows,
        window_cells);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  finish_kernel<<<grid_for(cells, max_blocks), kThreads, 0, s>>>(
      partials, out, chunks, cells, static_cast<double>(rows));
  return cudaGetLastError();
}

// W4 (4, F, C), b4 (4, C); partials: chunks * 4 doubles of scratch; out: 4
// floats, the mean nll at each candidate.
int lo_logistic_trial_losses(const float* X, const int* y, const float* W4,
                             const float* b4, double* partials, float* out,
                             int rows, int F, int C, int chunks,
                             int rows_per_chunk, int tile_rows, int device,
                             void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || C <= 0 || tile_rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    const size_t shared_bytes =
        sizeof(double) * kCandidates * kThreads +
        sizeof(float) * static_cast<size_t>(tile_rows) *
            (odd_stride(F) + odd_stride(C));
    error = allow_shared(trial_losses_kernel, shared_bytes);
    if (error != cudaSuccess) return error;
    trial_losses_kernel<<<chunks, kThreads, shared_bytes, s>>>(
        X, y, W4, b4, partials, rows, F, C, rows_per_chunk, tile_rows);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  finish_kernel<<<1, kThreads, 0, s>>>(partials, out, chunks, kCandidates,
                                       static_cast<double>(rows));
  return cudaGetLastError();
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
