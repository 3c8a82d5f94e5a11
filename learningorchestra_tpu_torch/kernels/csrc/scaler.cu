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
// What bounds it on this card, at the fit's shape (N = 1,000,000, F = 16):
// a stats pass reads X and w once, 68 MB, ~20 us at 3.35 TB/s; the
// standardization reads them and writes X once, 132 MB, ~39 us. The float64
// adds (2 a value) are far below the card's float64 rate.
//
// Design:
//   - The sums are in a fixed order that depends on the row count alone:
//     the rows go in the chunks of kernels.row_chunks (at most 264, of at
//     least 1,024 rows), a block a chunk. Within a block a thread owns a
//     (row lane, feature): `lanes` = 256 / F threads a feature, and a lane
//     adds the rows lane, lane + lanes, ... of its chunk in row order, from
//     0. The lanes are added in lane order through shared memory, and a
//     second kernel adds the chunks in chunk order. No atomics: a second
//     launch gives the same bits. Rows of more than 64 features go in
//     windows of 32 features along grid y (8 lanes a feature), so that a
//     few chunks of wide rows still spread over many blocks and lanes.
//   - Reads are coalesced: a block's threads read `lanes` rows at a time,
//     neighbouring threads neighbouring features (whole rows up to 64
//     features: one contiguous run of lanes * F floats); each thread issues
//     eight loads before it adds, so that enough bytes are in flight.
//   - Products in float64: w x is exact (two float32 values); the centred
//     term rounds x - mean, its square and the product by w, each once.
//   - The standardization is a grid-stride loop over the N * F values, four
//     of one row at a time (one 16-byte load and store) when F is a multiple
//     of 4 and the pointers allow it, else one at a time.
//   - Build without -use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// The features a block of col_sums_kernel sums: all of a row of up to 64,
// else a window of 32.
__host__ __device__ __forceinline__ int window_features(int F) { return F <= 64 ? F : 32; }

// Block (chunk blockIdx.x, feature window blockIdx.y): the chunk's float64
// sums of its window's features into partials[chunk][f], and in window 0
// the sum of the weights into partials[chunk][F].
__global__ void __launch_bounds__(kThreads)
    col_sums_kernel(const float* __restrict__ X, const float* __restrict__ w,
                    const double* __restrict__ mean, double* __restrict__ partials, int rows,
                    int F, int rows_per_chunk) {
  __shared__ double lane_sums[2 * kThreads];
  const int cols = window_features(F);
  const int lanes = kThreads / cols;
  const int lane = threadIdx.x / cols, col = threadIdx.x % cols;
  const int f = blockIdx.y * cols + col;
  const bool active = lane < lanes && f < F;
  const bool weights = blockIdx.y == 0 && col == 0 && lane < lanes;
  const int row0 = blockIdx.x * rows_per_chunk;
  const int row1 = min(rows, row0 + rows_per_chunk);
  const double centre = active && mean != nullptr ? mean[f] : 0.0;
  double sum = 0.0, weight_sum = 0.0;
  if (lane < lanes) {
    for (int r = row0 + lane; r < row1; r += lanes * kUnroll) {
      float x[kUnroll], wr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r + u * lanes;
        const bool in = row < row1;
        x[u] = in && active ? X[static_cast<size_t>(row) * F + f] : 0.0f;
        wr[u] = in ? w[row] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * lanes >= row1) break;
        const double weight = static_cast<double>(wr[u]);
        double term;
        if (mean == nullptr) {
          term = __dmul_rn(weight, static_cast<double>(x[u]));
        } else {
          const double d = __dsub_rn(static_cast<double>(x[u]), centre);
          term = __dmul_rn(__dmul_rn(d, d), weight);
        }
        sum = __dadd_rn(sum, term);
        if (weights) weight_sum = __dadd_rn(weight_sum, weight);
      }
    }
  }
  // the lanes' sums, then added in lane order by one thread a feature
  const int stride = cols + 1;
  if (lane < lanes) {
    lane_sums[lane * stride + col] = sum;
    if (col == 0) lane_sums[lane * stride + cols] = weight_sum;
  }
  __syncthreads();
  double* out = partials + static_cast<size_t>(blockIdx.x) * (F + 1);
  if (threadIdx.x < cols && f < F) {
    double total = 0.0;
    for (int l = 0; l < lanes; ++l) total = __dadd_rn(total, lane_sums[l * stride + col]);
    out[f] = total;
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    double total = 0.0;
    for (int l = 0; l < lanes; ++l) total = __dadd_rn(total, lane_sums[l * stride + cols]);
    out[F] = total;
  }
}

// out[i] = the chunks' partials[chunk][i] added in chunk order, i < cells.
__global__ void __launch_bounds__(kThreads)
    sum_chunks_kernel(const double* __restrict__ partials, double* __restrict__ out,
                      int chunks, int cells) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells; i += gridDim.x * blockDim.x) {
    double sum = 0.0;
    int c = 0;
    for (; c + 16 <= chunks; c += 16) {  // the loads issued sixteen at a time
      double value[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) value[j] = partials[static_cast<size_t>(c + j) * cells + i];
#pragma unroll
      for (int j = 0; j < 16; ++j) sum = __dadd_rn(sum, value[j]);
    }
    for (; c < chunks; ++c) sum = __dadd_rn(sum, partials[static_cast<size_t>(c) * cells + i]);
    out[i] = sum;
  }
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
// 1); partials: chunks * (F + 1) doubles of scratch; out: F + 1 doubles.
int lo_masked_col_sums(const float* X, const float* w, const double* mean, double* partials,
                       double* out, int rows, int F, int chunks, int rows_per_chunk,
                       int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || rows < 0 || chunks < 0 || rows_per_chunk <= 0 ||
      static_cast<long long>(chunks) * rows_per_chunk < rows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int windows = (F + window_features(F) - 1) / window_features(F);
  if (chunks > 0) {
    col_sums_kernel<<<dim3(chunks, windows), kThreads, 0, s>>>(X, w, mean, partials, rows, F,
                                                              rows_per_chunk);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  sum_chunks_kernel<<<grid_for(F + 1, 1024), kThreads, 0, s>>>(partials, out, chunks, F + 1);
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
