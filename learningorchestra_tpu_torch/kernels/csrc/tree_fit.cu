// tree_fit.cu — the tree fit's level loop (K1–K5) for Hopper (sm_90a).
//
// Replaces, in learningorchestra_tpu/:
//   K1 ml/binning.py:37 `apply_bins`           -> lo_apply_bins
//   K2 ml/trees.py:66 `_level_histograms`      -> lo_level_histograms
//   K3 ml/trees.py:160 `_gini_gain`, :181 `_newton_gain`,
//      :196 `_select_splits`                   -> lo_select_splits
//   K4 ml/trees.py:235 `_route` (:217 `_indicator_lookup`)
//                                              -> lo_route
//   K5 ml/trees.py:142 `_leaf_sums`            -> lo_leaf_sums
//
// What bounds them on this card, at the default fit (N = 1,000,000 rows,
// F = 16 features, B = 32 bins, depth 5, K = 2 channels):
//   - K1 reads X (64 MB) and writes int8 bins (16 MB): ~24 us of bytes.
//   - K2 reads bins, node and channels once per level (28 MB): ~8.4 us.
//   - K4 reads node, one bin of each row whose node splits, and writes
//     node (at most 9 MB): ~2.7 us.
//   - K3 reads a histogram of at most 64 KB: launch latency.
//   - K5 reads leaf and channels (12 MB): ~3.6 us.
// These kernels are the simple versions, written to be right first; none
// is tuned to its bound yet.
//
// Design and numerics:
//   - Deterministic. A resumed or coalesced fit must rerun bit for bit,
//     and K3 takes an argmax over K2's sums, so no float sum depends on
//     the order in which threads happen to run: there are no float
//     atomics. K2 and K5 split the rows into fixed chunks (a function of
//     the row count alone). In a chunk, a warp walks its rows 32 at a time
//     in order; lanes whose rows fall in one histogram cell are grouped
//     (__match_any_sync) and one lane adds the group in row order, into
//     cells no other warp touches. A second kernel adds the chunks'
//     partial histograms in chunk order.
//   - Accurate sums. The float32 channels are summed in float64 and each
//     sum is rounded once to float32, as the plain versions do: a float32
//     sum in row order drifts by ~1e-5 relative over a few thousand rows,
//     where the reference's blocked float32 matmul stays within ~1e-7 of
//     the exact sum. Class counts stay exact integers either way.
//   - Exact float32 where the reference rounds: K3 repeats the
//     reference's expressions in its order with __fmul_rn / __fadd_rn /
//     __fdiv_rn (no FMA contraction, IEEE division); the cumulative sum
//     over bins is sequential. Build without -use_fast_math.
//   - argmax semantics of the reference: the first maximum wins, and a
//     NaN gain counts as the maximum (the first NaN wins).
//   - K1 is a binary search, searchsorted(side=left) on the sorted
//     thresholds; NaN goes past every threshold (last bin).
//   - K4 is one indexed load per row; the reference's select-sum lookup
//     worked around serialized gathers on the TPU.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;       // ml/trees.py:56 EPS, as float32
constexpr int kThreads = 256;
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr int kGini = 0;
constexpr int kNewton = 1;

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int round_up_warp(int n) { return ((n + 31) / 32) * 32; }

// ------------------------------------------------------------------ K1

// Bin of each value: a binary search for the first threshold that is not
// below it, which is searchsorted(side=left) on the feature's sorted
// thresholds; NaN, below nothing, goes past every threshold.
__global__ void __launch_bounds__(kThreads)
    apply_bins_kernel(const float* __restrict__ X,
                      const float* __restrict__ thresholds,
                      int8_t* __restrict__ bins, long long total,
                      int num_features, int num_thresholds) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float x = X[i];
    const float* t =
        thresholds + static_cast<size_t>(i % num_features) * num_thresholds;
    int low = isnan(x) ? num_thresholds : 0;
    int high = num_thresholds;
    while (low < high) {
      const int mid = (low + high) / 2;
      if (__ldg(t + mid) < x) low = mid + 1;
      else high = mid;
    }
    bins[i] = static_cast<int8_t>(low);
  }
}

// ------------------------------------------------------------- K2, K5

// Sum `chunks` float64 partial arrays of `cells` values in chunk order,
// and round each sum once to float32.
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const double* __restrict__ partials,
                        float* __restrict__ out, int chunks, long long cells) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < cells; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    double sum = partials[i];
    for (int c = 1; c < chunks; ++c) sum = __dadd_rn(sum, partials[c * cells + i]);
    out[i] = __double2float_rn(sum);
  }
}

// Block (chunk, feature block): the partial histogram of the chunk's rows
// over `block_features` features, laid out like the output
// (node, feature, bin, channel). Warp w owns feature w of the block and
// walks the chunk's rows 32 at a time, in order: the lanes whose rows
// share a (node, bin) cell find each other with __match_any_sync, and the
// lowest of them adds the group's channels, in row order, into the cell.
// No two threads ever add into one cell.
__global__ void __launch_bounds__(1024) level_histograms_kernel(
    const int8_t* __restrict__ bins, const int* __restrict__ node,
    const float* __restrict__ channels, double* __restrict__ partials,
    int rows, int num_features, int n_nodes, int max_bins, int num_channels,
    int rows_per_chunk, int block_features, int tile_rows) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int chunk = blockIdx.x;
  const int f_begin = blockIdx.y * block_features;
  const int fb = min(block_features, num_features - f_begin);
  const int K = num_channels;
  const int hist_size = n_nodes * fb * max_bins * K;
  double* hist = reinterpret_cast<double*>(shared);
  float* tile_channels = reinterpret_cast<float*>(hist + hist_size);
  int* tile_node = reinterpret_cast<int*>(tile_channels + tile_rows * K);
  int8_t* tile_bins = reinterpret_cast<int8_t*>(tile_node + tile_rows);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < hist_size; i += blockDim.x) hist[i] = 0.0;

  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  for (int start = row_begin; start < row_end; start += tile_rows) {
    const int n = min(tile_rows, row_end - start);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile_node[i] = node[start + i];
    for (int i = threadIdx.x; i < n * K; i += blockDim.x)
      tile_channels[i] = channels[static_cast<size_t>(start) * K + i];
    for (int i = threadIdx.x; i < n * fb; i += blockDim.x) {
      const int r = i / fb;
      tile_bins[i] =
          bins[static_cast<size_t>(start + r) * num_features + f_begin + i % fb];
    }
    __syncthreads();
    if (warp >= fb) continue;
    for (int base = 0; base < n; base += 32) {
      const int r = base + lane;
      int key = -1;  // no cell: past the tile, or a node or bin out of range
      if (r < n) {
        const int nd = tile_node[r];
        const int b = tile_bins[r * fb + warp];
        if (nd >= 0 && nd < n_nodes && b >= 0 && b < max_bins) key = nd * max_bins + b;
      }
      const unsigned group = __match_any_sync(0xffffffffu, key);
      if (key < 0 || lane != __ffs(group) - 1) continue;
      double* dst =
          hist + ((key / max_bins * fb + warp) * max_bins + key % max_bins) * K;
      for (int k = 0; k < K; ++k) {
        double sum = 0.0;
        for (unsigned members = group; members != 0; members &= members - 1)
          sum = __dadd_rn(sum, tile_channels[(base + __ffs(members) - 1) * K + k]);
        dst[k] = __dadd_rn(dst[k], sum);
      }
    }
  }
  __syncthreads();
  double* out = partials + static_cast<size_t>(chunk) * n_nodes *
                               num_features * max_bins * K;
  for (int i = threadIdx.x; i < hist_size; i += blockDim.x) {
    const int k = i % K;
    int rest = i / K;
    const int b = rest % max_bins;
    rest /= max_bins;
    const int f = rest % fb;
    const int nd = rest / fb;
    out[((static_cast<size_t>(nd) * num_features + f_begin + f) * max_bins + b) *
            K + k] = hist[i];
  }
}

// Block = one chunk of rows: the partial per-leaf channel sums. Each warp
// walks its own contiguous part of the chunk, 32 rows at a time, into a
// private copy of the sums (lanes of one leaf grouped as in K2); the
// warps' copies are then added in warp order.
__global__ void __launch_bounds__(1024)
    leaf_sums_kernel(const int* __restrict__ leaf,
                     const float* __restrict__ channels,
                     double* __restrict__ partials, int rows, int n_leaves,
                     int num_channels, int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int K = num_channels;
  const int cells = n_leaves * K;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  double* sums = reinterpret_cast<double*>(shared);  // [warp][leaf][channel]
  for (int i = threadIdx.x; i < warps * cells; i += blockDim.x) sums[i] = 0.0;
  __syncthreads();

  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  const int per_warp = (row_end - row_begin + warps - 1) / warps;
  const int warp_begin = row_begin + warp * per_warp;
  const int warp_end = min(row_end, warp_begin + per_warp);
  double* mine = sums + warp * cells;
  for (int base = warp_begin; base < warp_end; base += 32) {
    const int r = base + lane;
    int key = -1;
    if (r < warp_end) {
      const int l = leaf[r];
      if (l >= 0 && l < n_leaves) key = l;
    }
    const unsigned group = __match_any_sync(0xffffffffu, key);
    if (key < 0 || lane != __ffs(group) - 1) continue;
    for (int k = 0; k < K; ++k) {
      double sum = 0.0;
      for (unsigned members = group; members != 0; members &= members - 1)
        sum = __dadd_rn(sum, channels[static_cast<size_t>(base + __ffs(members) - 1) * K + k]);
      mine[key * K + k] = __dadd_rn(mine[key * K + k], sum);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    double sum = sums[i];
    for (int w = 1; w < warps; ++w) sum = __dadd_rn(sum, sums[w * cells + i]);
    partials[static_cast<size_t>(blockIdx.x) * cells + i] = sum;
  }
}

// ------------------------------------------------------------------ K3

// Is (value_b, index_b) the better argmax candidate than (value_a,
// index_a)? NaN beats every number, a larger value beats a smaller one,
// and among equals the lower index wins.
__device__ __forceinline__ bool better(float value_a, int index_a,
                                       float value_b, int index_b) {
  const bool nan_a = isnan(value_a);
  const bool nan_b = isnan(value_b);
  if (nan_a || nan_b) return nan_b && (!nan_a || index_b < index_a);
  if (value_b != value_a) return value_b > value_a;
  return index_b < index_a;
}

// max(n, EPS), NaN passing through as jnp.maximum and torch.clamp pass it
__device__ __forceinline__ float floor_eps(float n) {
  return isnan(n) || n > kEps ? n : kEps;
}

// Block = one node. A thread walks one feature's bins in order: the
// cumulative sum, the gain of each split, and its own first maximum; the
// block then reduces to the node's first maximum over (feature, bin).
__global__ void __launch_bounds__(kThreads)
    select_splits_kernel(const float* __restrict__ hist,
                                     int* __restrict__ feature_out,
                                     int* __restrict__ bin_out,
                                     int num_features, int max_bins,
                                     int num_channels, int mode) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int K = num_channels;
  float* best_value = reinterpret_cast<float*>(shared);
  int* best_index = reinterpret_cast<int*>(best_value + blockDim.x);
  float* left = reinterpret_cast<float*>(best_index + blockDim.x) +
                threadIdx.x * 2 * K;  // this thread's running sums
  float* total = left + K;
  const float* node_hist =
      hist + static_cast<size_t>(blockIdx.x) * num_features * max_bins * K;

  float my_value = -INFINITY;
  int my_index = 0x7fffffff;
  for (int f = threadIdx.x; f < num_features; f += blockDim.x) {
    const float* h = node_hist + static_cast<size_t>(f) * max_bins * K;
    // the cumulative sum's last element: the feature's totals
    for (int k = 0; k < K; ++k) {
      float sum = h[k];
      for (int b = 1; b < max_bins; ++b) sum = __fadd_rn(sum, h[b * K + k]);
      total[k] = sum;
    }
    float parent;
    if (mode == kGini) {
      float n = 0.0f, squares = 0.0f;
      for (int k = 0; k < K; ++k) {
        n = __fadd_rn(n, total[k]);
        squares = __fadd_rn(squares, __fmul_rn(total[k], total[k]));
      }
      parent = __fdiv_rn(squares, floor_eps(n));
    } else {
      parent = __fdiv_rn(__fmul_rn(total[0], total[0]), __fadd_rn(total[1], 1.0f));
    }
    for (int b = 0; b < max_bins; ++b) {
      for (int k = 0; k < K; ++k)
        left[k] = b == 0 ? h[k] : __fadd_rn(left[k], h[b * K + k]);
      float gain;
      bool valid;
      if (mode == kGini) {
        float n_left = 0.0f, n_right = 0.0f, sq_left = 0.0f, sq_right = 0.0f;
        for (int k = 0; k < K; ++k) {
          const float right = __fsub_rn(total[k], left[k]);
          n_left = __fadd_rn(n_left, left[k]);
          n_right = __fadd_rn(n_right, right);
          sq_left = __fadd_rn(sq_left, __fmul_rn(left[k], left[k]));
          sq_right = __fadd_rn(sq_right, __fmul_rn(right, right));
        }
        valid = n_left > 0.0f && n_right > 0.0f;
        gain = __fsub_rn(__fadd_rn(__fdiv_rn(sq_left, floor_eps(n_left)),
                                   __fdiv_rn(sq_right, floor_eps(n_right))),
                         parent);
      } else {
        const float g_left = left[0], h_left = left[1];
        const float g_right = __fsub_rn(total[0], g_left);
        const float h_right = __fsub_rn(total[1], h_left);
        valid = h_left > kEps && h_right > kEps;
        const float score = __fadd_rn(
            __fdiv_rn(__fmul_rn(g_left, g_left), __fadd_rn(h_left, 1.0f)),
            __fdiv_rn(__fmul_rn(g_right, g_right), __fadd_rn(h_right, 1.0f)));
        gain = __fsub_rn(score, parent);
      }
      if (!valid) gain = -INFINITY;
      const int index = f * max_bins + b;
      if (better(my_value, my_index, gain, index)) {
        my_value = gain;
        my_index = index;
      }
    }
  }
  best_value[threadIdx.x] = my_value;
  best_index[threadIdx.x] = my_index;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) {
      const int other = threadIdx.x + stride;
      if (better(best_value[threadIdx.x], best_index[threadIdx.x],
                 best_value[other], best_index[other])) {
        best_value[threadIdx.x] = best_value[other];
        best_index[threadIdx.x] = best_index[other];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float gain = best_value[0];
    const int index = best_index[0];
    const bool is_leaf = !(gain > 0.0f) || isinf(gain);
    feature_out[blockIdx.x] = is_leaf ? -1 : index / max_bins;
    bin_out[blockIdx.x] = index % max_bins;
  }
}

// ------------------------------------------------------------------ K4

__global__ void __launch_bounds__(kThreads)
    route_kernel(const int8_t* __restrict__ bins, const int* __restrict__ node,
                 const int* __restrict__ feature,
                 const int* __restrict__ split_bin, int* __restrict__ node_out,
                 int rows, int num_features) {
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < rows;
       row += gridDim.x * blockDim.x) {
    const int nd = node[row];
    const int f = __ldg(feature + nd);
    const int x_bin =
        f >= 0 && f < num_features
            ? bins[static_cast<size_t>(row) * num_features + f]
            : 0;
    const bool go_right = x_bin > __ldg(split_bin + nd) && f >= 0;
    node_out[row] = 2 * nd + (go_right ? 1 : 0);
  }
}

int grid_for(long long items, int max_blocks) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < max_blocks ? blocks : max_blocks);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) of
// `device`, does not synchronize, and returns cudaGetLastError() after its
// launches: 0 means they were accepted. Outputs and scratch are allocated
// by the caller.

int lo_apply_bins(const float* X, const float* thresholds, int8_t* bins,
                  long long rows, int num_features, int num_thresholds,
                  int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const long long total = rows * num_features;
  if (total <= 0) return cudaSuccess;
  apply_bins_kernel<<<grid_for(total, max_blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      X, thresholds, bins, total, num_features, num_thresholds);
  return cudaGetLastError();
}

// partials: chunks * n_nodes * F * B * K doubles of scratch;
// out: (n_nodes, F, B, K).
int lo_level_histograms(const int8_t* bins, const int* node,
                        const float* channels, double* partials, float* out,
                        int rows, int num_features, int n_nodes, int max_bins,
                        int num_channels, int chunks, int rows_per_chunk,
                        int block_features, int tile_rows, int max_blocks,
                        int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const long long cells = static_cast<long long>(n_nodes) * num_features *
                          max_bins * num_channels;
  if (cells <= 0) return cudaSuccess;
  const size_t shared_bytes =
      sizeof(double) * static_cast<size_t>(n_nodes) * block_features *
          max_bins * num_channels +
      sizeof(float) * static_cast<size_t>(tile_rows) * num_channels +
      sizeof(int) * tile_rows + static_cast<size_t>(tile_rows) * block_features;
  error = allow_shared(level_histograms_kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  const dim3 grid(chunks, (num_features + block_features - 1) / block_features);
  const int threads = 32 * block_features;  // a warp per feature
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  level_histograms_kernel<<<grid, threads, shared_bytes, s>>>(
      bins, node, channels, partials, rows, num_features, n_nodes, max_bins,
      num_channels, rows_per_chunk, block_features, tile_rows);
  error = cudaGetLastError();
  if (error != cudaSuccess) return error;
  sum_partials_kernel<<<grid_for(cells, max_blocks), kThreads, 0, s>>>(
      partials, out, chunks, cells);
  return cudaGetLastError();
}

// mode 0: gini over K class channels; mode 1: newton over (g, h), K = 2.
int lo_select_splits(const float* hist, int* feature, int* bin, int n_nodes,
                     int num_features, int max_bins, int num_channels,
                     int mode, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (n_nodes <= 0) return cudaSuccess;
  if (mode == kNewton && num_channels != 2) return cudaErrorInvalidValue;
  int threads = round_up_warp(num_features);
  if (threads > kThreads) threads = kThreads;
  const size_t shared_bytes =
      static_cast<size_t>(threads) * (sizeof(float) + sizeof(int)) +
      static_cast<size_t>(threads) * 2 * num_channels * sizeof(float);
  error = allow_shared(select_splits_kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  select_splits_kernel<<<n_nodes, threads, shared_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      hist, feature, bin, num_features, max_bins, num_channels, mode);
  return cudaGetLastError();
}

int lo_route(const int8_t* bins, const int* node, const int* feature,
             const int* split_bin, int* node_out, int rows, int num_features,
             int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (rows <= 0) return cudaSuccess;
  route_kernel<<<grid_for(rows, max_blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      bins, node, feature, split_bin, node_out, rows, num_features);
  return cudaGetLastError();
}

// partials: chunks * n_leaves * K doubles of scratch; out: (n_leaves, K).
int lo_leaf_sums(const int* leaf, const float* channels, double* partials,
                 float* out, int rows, int n_leaves, int num_channels,
                 int chunks, int rows_per_chunk, int warps, int max_blocks,
                 int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const long long cells = static_cast<long long>(n_leaves) * num_channels;
  if (cells <= 0) return cudaSuccess;
  const size_t shared_bytes = sizeof(double) * cells * warps;
  error = allow_shared(leaf_sums_kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  leaf_sums_kernel<<<chunks, 32 * warps, shared_bytes, s>>>(
      leaf, channels, partials, rows, n_leaves, num_channels, rows_per_chunk);
  error = cudaGetLastError();
  if (error != cudaSuccess) return error;
  sum_partials_kernel<<<grid_for(cells, max_blocks), kThreads, 0, s>>>(
      partials, out, chunks, cells);
  return cudaGetLastError();
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
