// logistic.cu — the logistic regression fit's loss-and-gradient pass (K7)
// for Hopper (sm_90a), for one fit or for a job axis of fits.
//
// Replaces, in learningorchestra_tpu/:
//   K7 ml/logistic.py:35 `_loss_fn` and its jax.value_and_grad inside
//      :141 `_fit_segment_impl`             -> lo_logistic_loss_grad
//      the Armijo trial losses of :176-200  -> lo_logistic_trial_losses
//   and both under ml/sweep.py:237 `_lr_fused_segment`'s vmap over jobs
//   (K14a), with the sweep's validity mask as a row weight.
//
// lo_logistic_loss_grad: from one read of the standardized rows X (N, F)
// float32, their labels y (N,) int32 and, for a weighted pass, their
// weights w (N,) float32, at W (F, C) and b (C,):
//   loss = sum_i w_i nll_i / sum_i w_i,  nll_i = log sum_c exp(z_ic) - z_iy
//   dW   = X^T (w (P - onehot(y))) / sum w,  db = sum_i w_i (p_i - onehot(y_i)) / sum w
//   with z = xW + b; without weights every w_i is 1 and sum w is N.
// lo_logistic_trial_losses: the (weighted) mean nll at four candidate
// parameter sets (W + t D, b + t d_b for t = 1, 1/2, 1/4, 1/8), again from
// one read of X: the reference's while_loop stops at the first accepted
// step; the port computes the four trial losses at once and picks on the
// device.
// A job axis: J jobs in one launch, job j with its own rows (X at
// j * x_job_stride floats, 0 when the jobs share one X), labels and
// weights (at j * row_job_stride entries), and its own W, b (W4, b4).
// The L2 term 0.5 l2 |W|^2 and its gradient l2 W act on F x C values, with
// each job's own l2, and stay torch ops (ml/logistic.py).
//
// What bounds it on this card, at the fit's shape (N = 1,000,000 rows,
// F = 16, C = 2 or 10): X and y read once, 68 MB, ~20 us at 3.35 TB/s;
// over a sweep's job axis J times that (J * N * (4F + 4 + 4) bytes with
// the weights: 7.6 GB, ~2.3 ms a pass at J = 112 slots of 1,048,576 rows).
// Its operations (2NFC float32 for the logits, 2NFC float64 for the
// gradient, 8NFC float32 for the trial losses) take less at the float32
// and float64 peaks. This is the simple version, written to be right
// first, not tuned to its bound: a shared X is read once a job, not once.
//
// Design and numerics:
//   - Deterministic, as K2 and K5 are: the rows go in fixed chunks (a
//     function of the row count alone), a block per chunk. In a chunk,
//     tiles of rows are staged in shared memory; a thread computes one
//     row's logits, log-softmax, nll and residual p - onehot into the
//     tile; then each (cell, group) of the block's float64 partial sums
//     (F*C cells of dW, C of db, 1 of the loss and, weighted, 1 of the
//     weights) is owned by one thread, which adds its rows of the tile in
//     row order. No float atomics: the groups are added in order, and a
//     second kernel adds the chunks' partials in chunk order and divides
//     by N (by the chunk-ordered sum of the weights, when weighted),
//     rounding once to float32. A refit is bit identical.
//   - The job is grid dimension z (groups of launches past 65,535 jobs):
//     a job's blocks read that job's rows alone and write that job's
//     partials alone, in the order a launch of that job alone uses, so
//     each job's outputs are bit-equal to such a launch. A solo,
//     unweighted launch runs exactly the arithmetic it ran before the
//     job axis.
//   - Weighted: a row's nll and residual are multiplied by its float32
//     weight before the float64 sums (exact for the 0/1 validity mask).
//   - Accurate: the sums over rows are float64 (each product x * r of two
//     float32 values is exact in float64), as the plain twin's are.
//   - The row's log-softmax is the reference's: shifted = z - max(z),
//     nll = log(sum(exp(shifted))) - shifted[y], p = exp(shifted - log sum).
//   - The tile's rows sit at an odd stride in shared memory, so that a
//     warp's threads, a row each, read 32 different banks (at F = 16 a
//     stride of 16 made every such read a 16-way bank conflict).
//   - Any class count: a row's logits live in the shared tile, which
//     holds fewer rows when C is large; when the cells do not fit one
//     block's partials, the cells are split into windows over grid
//     dimension y (each window's blocks recompute the residuals).
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
// The most blocks a launch may have along grid dimensions y and z: jobs
// past it go in groups of launches.
constexpr int kMaxGridYZ = 65535;

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

// Block (chunk, cell window, job): the float64 partial sums over the
// chunk's rows of the job of cells [cell_begin, cell_begin + window):
// cell f*C + c of dW, F*C + c of db, F*C + C of the loss and, with
// weights, F*C + C + 1 of the weights. Slot (group, cell) is owned by one
// thread, which adds rows group, group + groups, ... of each tile in order.
__global__ void __launch_bounds__(kThreads)
    loss_grad_kernel(const float* __restrict__ X, const int* __restrict__ y,
                     const float* __restrict__ weights,
                     const float* __restrict__ W, const float* __restrict__ b,
                     double* __restrict__ partials, int rows, int F, int C,
                     long long x_job_stride, long long row_job_stride,
                     int rows_per_chunk, int tile_rows, int window_cells) {
  extern __shared__ __align__(16) unsigned char shared[];
  const bool weighted = weights != nullptr;
  const int cells = F * C + C + 1 + (weighted ? 1 : 0);
  const long long job = blockIdx.z;
  X += job * x_job_stride;
  y += job * row_job_stride;
  if (weighted) weights += job * row_job_stride;
  W += job * F * C;
  b += job * C;
  partials += job * gridDim.x * cells;
  const int cell_begin = blockIdx.y * window_cells;
  const int wc = min(window_cells, cells - cell_begin);
  const int groups = max(1, kThreads / wc);
  const int slots = groups * wc;
  double* acc = reinterpret_cast<double*>(shared);  // [group][cell]
  const int xs = odd_stride(F), zs = odd_stride(C);
  float* tile_x = reinterpret_cast<float*>(acc + max(kThreads, window_cells));
  float* tile_z = tile_x + tile_rows * xs;
  float* tile_nll = tile_z + tile_rows * zs;
  float* tile_w = tile_nll + tile_rows;  // weighted only

  for (int i = threadIdx.x; i < slots; i += kThreads) acc[i] = 0.0;
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  for (int start = row_begin; start < row_end; start += tile_rows) {
    const int n = min(tile_rows, row_end - start);
    __syncthreads();  // the previous tile is consumed
    stage_rows(X, tile_x, start, n, F);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += kThreads) {
      float* z = tile_z + r * zs;
      const float nll = row_terms(tile_x + r * xs, F, W, b, C, y[start + r], z, true);
      if (weighted) {
        const float w = weights[start + r];
        tile_w[r] = w;
        tile_nll[r] = __fmul_rn(w, nll);
        for (int c = 0; c < C; ++c) z[c] = __fmul_rn(w, z[c]);
      } else {
        tile_nll[r] = nll;
      }
    }
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
      } else if (cell == F * C + C) {
#pragma unroll 4
        for (int r = group; r < n; r += groups)
          sum = __dadd_rn(sum, static_cast<double>(tile_nll[r]));
      } else {
#pragma unroll 4
        for (int r = group; r < n; r += groups)
          sum = __dadd_rn(sum, static_cast<double>(tile_w[r]));
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

// Block (chunk, job) : the float64 sums of the (weighted) nll of the
// chunk's rows of the job at each of the four candidate parameter sets W4
// (4, F, C), b4 (4, C) of the job and, with weights, of the weights.
// Thread t takes rows t, t + kThreads, ... of every tile; the block's
// threads are then added in a fixed tree order.
__global__ void __launch_bounds__(kThreads)
    trial_losses_kernel(const float* __restrict__ X, const int* __restrict__ y,
                        const float* __restrict__ weights,
                        const float* __restrict__ W4,
                        const float* __restrict__ b4,
                        double* __restrict__ partials, int rows, int F, int C,
                        long long x_job_stride, long long row_job_stride,
                        int rows_per_chunk, int tile_rows) {
  extern __shared__ __align__(16) unsigned char shared[];
  const bool weighted = weights != nullptr;
  const int sums = kCandidates + (weighted ? 1 : 0);
  const long long job = blockIdx.y;
  X += job * x_job_stride;
  y += job * row_job_stride;
  if (weighted) weights += job * row_job_stride;
  W4 += job * kCandidates * F * C;
  b4 += job * kCandidates * C;
  partials += job * gridDim.x * sums;
  double* reduce = reinterpret_cast<double*>(shared);  // [sum][thread]
  const int xs = odd_stride(F), zs = odd_stride(C);
  float* tile_x = reinterpret_cast<float*>(reduce + sums * kThreads);
  float* tile_z = tile_x + tile_rows * xs;

  double acc[kCandidates + 1] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  for (int start = row_begin; start < row_end; start += tile_rows) {
    const int n = min(tile_rows, row_end - start);
    __syncthreads();  // the previous tile is consumed
    stage_rows(X, tile_x, start, n, F);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += kThreads) {
      const int label = y[start + r];
      const float w = weighted ? weights[start + r] : 1.0f;
      for (int k = 0; k < kCandidates; ++k) {
        float nll = row_terms(tile_x + r * xs, F, W4 + k * F * C, b4 + k * C,
                              C, label, tile_z + r * zs, false);
        if (weighted) nll = __fmul_rn(w, nll);
        acc[k] = __dadd_rn(acc[k], static_cast<double>(nll));
      }
      if (weighted) acc[kCandidates] = __dadd_rn(acc[kCandidates], static_cast<double>(w));
    }
  }
  for (int k = 0; k < sums; ++k) reduce[k * kThreads + threadIdx.x] = acc[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride)
      for (int k = 0; k < sums; ++k)
        reduce[k * kThreads + threadIdx.x] = __dadd_rn(
            reduce[k * kThreads + threadIdx.x],
            reduce[k * kThreads + threadIdx.x + stride]);
    __syncthreads();
  }
  if (threadIdx.x < sums)
    partials[static_cast<size_t>(blockIdx.x) * sums + threadIdx.x] =
        reduce[threadIdx.x * kThreads];
}

// Job blockIdx.y: out[i] = (sum over chunks, in chunk order, of
// partials[chunk][i]) / denominator, rounded once to float32, for the
// `cells` outputs of the job. The denominator is `rows`, or, `weighted`,
// the chunk-ordered sum of the partials' last cell (the weights), which
// follows the outputs. No chunks (no rows) give 0 / 0 = NaN, as the
// reference's mean over no rows does.
__device__ __forceinline__ double sum_chunks(const double* __restrict__ partials,
                                             int chunks, int stride, int i) {
  // in chunk order, the loads issued sixteen at a time
  double sum = 0.0;
  int c = 0;
  for (; c + 16 <= chunks; c += 16) {
    double value[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      value[j] = partials[static_cast<size_t>(c + j) * stride + i];
#pragma unroll
    for (int j = 0; j < 16; ++j) sum = __dadd_rn(sum, value[j]);
  }
  for (; c < chunks; ++c)
    sum = __dadd_rn(sum, partials[static_cast<size_t>(c) * stride + i]);
  return sum;
}

__global__ void __launch_bounds__(kThreads)
    finish_kernel(const double* __restrict__ partials, float* __restrict__ out,
                  int chunks, int cells, double rows, int weighted) {
  const int stride = cells + weighted;
  partials += static_cast<size_t>(blockIdx.y) * chunks * stride;
  out += static_cast<size_t>(blockIdx.y) * cells;
  const double denominator =
      weighted ? sum_chunks(partials, chunks, stride, cells) : rows;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += gridDim.x * blockDim.x)
    out[i] = __double2float_rn(
        __ddiv_rn(sum_chunks(partials, chunks, stride, i), denominator));
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) of
// `device`, does not synchronize, and returns cudaGetLastError() after its
// launches: 0 means they were accepted. Outputs and scratch are allocated
// by the caller.

// J = `jobs` jobs: X of job j at j * x_job_stride floats (0: one shared
// X), y and weights (null: unweighted) at j * row_job_stride entries, W
// (J, F, C), b (J, C). partials: J * chunks * (F*C + C + 1 + weighted)
// doubles of scratch; out: (J, F*C + C + 1) floats, [dW (F, C) | db (C) |
// loss] a job.
int lo_logistic_loss_grad(const float* X, const int* y, const float* weights,
                          const float* W, const float* b, double* partials,
                          float* out, int rows, int F, int C, int jobs,
                          long long x_job_stride, long long row_job_stride,
                          int chunks, int rows_per_chunk, int tile_rows,
                          int window_cells, int max_blocks, int device,
                          void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || C <= 0 || tile_rows <= 0 || window_cells <= 0 || jobs < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int weighted = weights != nullptr ? 1 : 0;
  const int cells = F * C + C + 1;
  const int partial_cells = cells + weighted;
  const size_t shared_bytes =
      sizeof(double) * static_cast<size_t>(std::max(kThreads, window_cells)) +
      sizeof(float) * static_cast<size_t>(tile_rows) *
          (odd_stride(F) + odd_stride(C) + 1 + weighted);
  if (chunks > 0) {
    error = allow_shared(loss_grad_kernel, shared_bytes);
    if (error != cudaSuccess) return error;
  }
  for (int j0 = 0; j0 < jobs; j0 += kMaxGridYZ) {
    const int group = std::min(kMaxGridYZ, jobs - j0);
    double* group_partials =
        partials + static_cast<size_t>(j0) * std::max(chunks, 1) * partial_cells;
    if (chunks > 0) {
      const dim3 grid(chunks, (partial_cells + window_cells - 1) / window_cells,
                      group);
      loss_grad_kernel<<<grid, kThreads, shared_bytes, s>>>(
          X + j0 * x_job_stride, y + j0 * row_job_stride,
          weighted ? weights + j0 * row_job_stride : nullptr,
          W + static_cast<size_t>(j0) * F * C, b + static_cast<size_t>(j0) * C,
          group_partials, rows, F, C, x_job_stride, row_job_stride,
          rows_per_chunk, tile_rows, window_cells);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
    finish_kernel<<<dim3(grid_for(cells, max_blocks), group), kThreads, 0, s>>>(
        group_partials, out + static_cast<size_t>(j0) * cells, chunks, cells,
        static_cast<double>(rows), weighted);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  return cudaSuccess;
}

// Jobs as above, W4 (J, 4, F, C), b4 (J, 4, C); partials: J * chunks *
// (4 + weighted) doubles of scratch; out: (J, 4) floats, the (weighted)
// mean nll at each candidate.
int lo_logistic_trial_losses(const float* X, const int* y,
                             const float* weights, const float* W4,
                             const float* b4, double* partials, float* out,
                             int rows, int F, int C, int jobs,
                             long long x_job_stride, long long row_job_stride,
                             int chunks, int rows_per_chunk, int tile_rows,
                             int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || C <= 0 || tile_rows <= 0 || jobs < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int weighted = weights != nullptr ? 1 : 0;
  const int sums = kCandidates + weighted;
  const size_t shared_bytes =
      sizeof(double) * sums * kThreads +
      sizeof(float) * static_cast<size_t>(tile_rows) *
          (odd_stride(F) + odd_stride(C));
  if (chunks > 0) {
    error = allow_shared(trial_losses_kernel, shared_bytes);
    if (error != cudaSuccess) return error;
  }
  for (int j0 = 0; j0 < jobs; j0 += kMaxGridYZ) {
    const int group = std::min(kMaxGridYZ, jobs - j0);
    double* group_partials =
        partials + static_cast<size_t>(j0) * std::max(chunks, 1) * sums;
    if (chunks > 0) {
      trial_losses_kernel<<<dim3(chunks, group), kThreads, shared_bytes, s>>>(
          X + j0 * x_job_stride, y + j0 * row_job_stride,
          weighted ? weights + j0 * row_job_stride : nullptr,
          W4 + static_cast<size_t>(j0) * kCandidates * F * C,
          b4 + static_cast<size_t>(j0) * kCandidates * C, group_partials,
          rows, F, C, x_job_stride, row_job_stride, rows_per_chunk, tile_rows);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
    finish_kernel<<<dim3(1, group), kThreads, 0, s>>>(
        group_partials, out + static_cast<size_t>(j0) * kCandidates, chunks,
        kCandidates, static_cast<double>(rows), weighted);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  return cudaSuccess;
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
