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
// K2, K4 and K5 also run under the random forest's vmap over trees
// (ml/trees.py:437 in `_rf_chunk`), and K3 with its per-node feature
// subsets (:201-206).
//
// What bounds them on this card, at the default fit (N = 1,000,000 rows,
// F = 16 features, B = 32 bins, depth 5, K = 2 channels):
//   - K1 reads X (64 MB) and writes int8 bins (16 MB): ~24 us of bytes.
//   - K2 reads bins, node and channels once per level (28 MB): ~8.4 us.
//   - K4 reads node, one bin of each row whose node splits, and writes
//     node (at most 9 MB): ~2.7 us.
//   - K3 reads a histogram of at most 64 KB: launch latency.
//   - K5 reads leaf and channels (12 MB): ~3.6 us.
// The random forest's level (T = 20 trees over the same bins) reads the
// bins once and each tree's node and channels: 256 MB, ~77 us for K2.
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
//   - Bins are int8 while max_bins <= 127 and int32 above, as the
//     reference's (ml/binning.py:54): K1 writes either, K2 and K4 read
//     either (a template on the bin type; `bin_bytes` picks it).
//   - Any level width. K2 keeps one feature's float64 histogram of a
//     window of (node, bin, channel) cells in a block's shared memory;
//     when a level's whole histogram does not fit, the entry point runs
//     one pass per window, and rows whose cell lies outside the window
//     are skipped. K5 does the same over (leaf, channel) windows. A
//     cell's sum takes its rows in the same order in every window, so
//     the result does not depend on the windows.
//   - A tree axis. K2, K4 and K5 take T trees in one launch: each tree
//     has its own node and channels (its own bootstrap weights), and the
//     trees read one bins matrix (K2 takes the bins' stride along the
//     tree axis, 0 for the forest). A tree's sums are those of a launch
//     of that tree alone, bit for bit: trees never share a cell, and a
//     cell adds its rows in the same order. K3 takes the forest's
//     (T, nodes) flattened into its node axis.
//   - Feature subsets (K3). A feature is a candidate of its node iff
//     fewer than `subset_k` of the node's scores are below its own, which
//     is `score <= sort(scores)[subset_k - 1]` of the reference, ties
//     included; every cell of any other feature is -inf, NaN or not.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

// A window of histogram cells: nodes (or leaves) [node_begin, +nodes),
// bins [bin_begin, +bins) and channels [channel_begin, +channels).
struct Window {
  int node_begin, nodes;
  int bin_begin, bins;
  int channel_begin, channels;
};

// ------------------------------------------------------------------ K1

// Bin of each value: a binary search for the first threshold that is not
// below it, which is searchsorted(side=left) on the feature's sorted
// thresholds; NaN, below nothing, goes past every threshold.
template <typename Bin>
__global__ void __launch_bounds__(kThreads)
    apply_bins_kernel(const float* __restrict__ X,
                      const float* __restrict__ thresholds,
                      Bin* __restrict__ bins, long long total,
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
    bins[i] = static_cast<Bin>(low);
  }
}

// ------------------------------------------------------------- K2, K5

// partials[0][i] + partials[1][i] + ... in chunk order, the loads issued
// sixteen at a time so that they are in flight together.
__device__ __forceinline__ double sum_chunks(const double* __restrict__ partials,
                                             int chunks, long long cells,
                                             long long i) {
  double sum = 0.0;
  int c = 0;
  for (; c + 16 <= chunks; c += 16) {
    double value[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) value[j] = partials[(c + j) * cells + i];
#pragma unroll
    for (int j = 0; j < 16; ++j) sum = __dadd_rn(sum, value[j]);
  }
  for (; c < chunks; ++c) sum = __dadd_rn(sum, partials[c * cells + i]);
  return sum;
}

// Sum `chunks` float64 partial arrays of one window's `cells` values in
// chunk order, round each sum once to float32, and store it at its place
// in the (nodes, F, B, K) output (K5: F = B = 1). Grid dimension y is the
// tree: partials [tree][chunk][cell], `out_tree_stride` floats of output
// a tree. (The tree is not found by dividing a flat index: a 64-bit
// division in the loop costs the registers that keep the sixteen loads of
// sum_chunks in flight.)
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const double* __restrict__ partials,
                        float* __restrict__ out, int chunks, long long cells,
                        long long out_tree_stride, Window w, int num_features,
                        int max_bins, int num_channels) {
  partials += static_cast<long long>(blockIdx.y) * chunks * cells;
  out += static_cast<long long>(blockIdx.y) * out_tree_stride;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < cells; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const double sum = sum_chunks(partials, chunks, cells, i);
    const int k = static_cast<int>(i % w.channels);
    long long rest = i / w.channels;
    const int b = static_cast<int>(rest % w.bins);
    rest /= w.bins;
    const int f = static_cast<int>(rest % num_features);
    const long long nd = rest / num_features + w.node_begin;
    out[((nd * num_features + f) * max_bins + w.bin_begin + b) * num_channels +
        w.channel_begin + k] = __double2float_rn(sum);
  }
}

// Block (chunk, feature block, tree): the partial histogram of the
// chunk's rows over `block_features` features and the cells of window
// `w`, laid out like the output (node, feature, bin, channel), from the
// tree's nodes and channels and the bins at the tree's offset
// `bins_tree_stride` (0: the trees share one bins matrix). All warps stage
// the rows; warp w < block_features owns feature w of the block and walks
// the chunk's rows 32 at a time, in order: the lanes whose rows share a
// (node, bin) cell find each other with __match_any_sync, and the lowest
// of them adds the group's channels, in row order, into the cell. No two
// threads ever add into one cell. Rows whose node or bin lies outside the
// window are skipped.
template <typename Bin>
__global__ void __launch_bounds__(1024) level_histograms_kernel(
    const Bin* __restrict__ bins, const int* __restrict__ node,
    const float* __restrict__ channels, double* __restrict__ partials,
    int rows, int num_features, int num_channels, Window w,
    int rows_per_chunk, int block_features, int tile_rows,
    long long bins_tree_stride) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int chunk = blockIdx.x;
  const long long tree = blockIdx.z;
  bins += tree * bins_tree_stride;
  node += tree * rows;
  channels += tree * rows * num_channels;
  const int f_begin = blockIdx.y * block_features;
  const int fb = min(block_features, num_features - f_begin);
  const int K = w.channels;
  const int hist_size = w.nodes * fb * w.bins * K;
  double* hist = reinterpret_cast<double*>(shared);
  float* tile_channels = reinterpret_cast<float*>(hist + hist_size);
  int* tile_node = reinterpret_cast<int*>(tile_channels + tile_rows * K);
  Bin* tile_bins = reinterpret_cast<Bin*>(tile_node + tile_rows);
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
      tile_channels[i] = channels[static_cast<size_t>(start + i / K) * num_channels +
                                  w.channel_begin + i % K];
    for (int i = threadIdx.x; i < n * fb; i += blockDim.x) {
      const int r = i / fb;
      tile_bins[i] =
          bins[static_cast<size_t>(start + r) * num_features + f_begin + i % fb];
    }
    __syncthreads();
    if (warp >= fb) continue;
    for (int base = 0; base < n; base += 32) {
      const int r = base + lane;
      int key = -1;  // no cell: past the tile, or outside the window
      if (r < n) {
        const int nd = tile_node[r] - w.node_begin;
        const int b = static_cast<int>(tile_bins[r * fb + warp]) - w.bin_begin;
        if (nd >= 0 && nd < w.nodes && b >= 0 && b < w.bins) key = nd * w.bins + b;
      }
      const unsigned group = __match_any_sync(0xffffffffu, key);
      if (key < 0 || lane != __ffs(group) - 1) continue;
      double* dst = hist + ((key / w.bins * fb + warp) * w.bins + key % w.bins) * K;
      for (int k = 0; k < K; ++k) {
        double sum = 0.0;
        for (unsigned members = group; members != 0; members &= members - 1)
          sum = __dadd_rn(sum, tile_channels[(base + __ffs(members) - 1) * K + k]);
        dst[k] = __dadd_rn(dst[k], sum);
      }
    }
  }
  __syncthreads();
  double* out = partials + (tree * gridDim.x + chunk) * w.nodes * num_features *
                               w.bins * K;
  for (int i = threadIdx.x; i < hist_size; i += blockDim.x) {
    const int k = i % K;
    int rest = i / K;
    const int b = rest % w.bins;
    rest /= w.bins;
    const int f = rest % fb;
    const int nd = rest / fb;
    out[((static_cast<size_t>(nd) * num_features + f_begin + f) * w.bins + b) * K +
        k] = hist[i];
  }
}

// Block (chunk, tree): the partial per-leaf channel sums of the chunk's
// rows of the tree, over the (leaf, channel) cells of window `w`. Each
// warp walks its own contiguous part of the chunk, 32 rows at a time, into
// a private copy of the sums (lanes of one leaf grouped as in K2; rows of
// a leaf outside the window skipped); the warps' copies are then added in
// warp order.
__global__ void __launch_bounds__(1024)
    leaf_sums_kernel(const int* __restrict__ leaf,
                     const float* __restrict__ channels,
                     double* __restrict__ partials, int rows,
                     int num_channels, Window w, int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int K = w.channels;
  const int cells = w.nodes * K;
  const long long tree = blockIdx.y;
  leaf += tree * rows;
  channels += tree * rows * num_channels;
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
      const int l = leaf[r] - w.node_begin;
      if (l >= 0 && l < w.nodes) key = l;
    }
    const unsigned group = __match_any_sync(0xffffffffu, key);
    if (key < 0 || lane != __ffs(group) - 1) continue;
    for (int k = 0; k < K; ++k) {
      double sum = 0.0;
      for (unsigned members = group; members != 0; members &= members - 1)
        sum = __dadd_rn(sum, channels[static_cast<size_t>(base + __ffs(members) - 1) *
                                          num_channels + w.channel_begin + k]);
      mine[key * K + k] = __dadd_rn(mine[key * K + k], sum);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    double sum = sums[i];
    for (int w2 = 1; w2 < warps; ++w2) sum = __dadd_rn(sum, sums[w2 * cells + i]);
    partials[(tree * gridDim.x + blockIdx.x) * cells + i] = sum;
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

// Is feature f among the `subset_k` of lowest score of its node? Fewer
// than subset_k scores below its own: the reference's `scores <= kth`,
// kth the subset_k-th smallest, ties included.
__device__ __forceinline__ bool in_subset(const float* __restrict__ scores,
                                          int num_features, int subset_k,
                                          int f) {
  const float own = scores[f];
  int below = 0;
  for (int g = 0; g < num_features; ++g) below += scores[g] < own ? 1 : 0;
  return below < subset_k;
}

// Block = one node. A thread walks one feature's bins in order: the
// cumulative sum, the gain of each split, and its own first maximum; the
// block then reduces to the node's first maximum over (feature, bin).
// With `subset_scores` (nodes, F), a feature outside its node's subset
// offers only -inf gains: its first bin, at -inf, stands for them all.
__global__ void __launch_bounds__(kThreads)
    select_splits_kernel(const float* __restrict__ hist,
                         const float* __restrict__ subset_scores,
                         int subset_k, int* __restrict__ feature_out,
                         int* __restrict__ bin_out, int num_features,
                         int max_bins, int num_channels, int mode) {
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
  const float* scores =
      subset_scores == nullptr
          ? nullptr
          : subset_scores + static_cast<size_t>(blockIdx.x) * num_features;
  for (int f = threadIdx.x; f < num_features; f += blockDim.x) {
    if (scores != nullptr && !in_subset(scores, num_features, subset_k, f)) {
      if (better(my_value, my_index, -INFINITY, f * max_bins)) {
        my_value = -INFINITY;
        my_index = f * max_bins;
      }
      continue;
    }
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

// Each row of tree blockIdx.y one level down, against the tree's split of
// the row's node; the trees read one bins matrix.
template <typename Bin>
__global__ void __launch_bounds__(kThreads)
    route_kernel(const Bin* __restrict__ bins, const int* __restrict__ node,
                 const int* __restrict__ feature,
                 const int* __restrict__ split_bin, int* __restrict__ node_out,
                 int rows, int num_features, int n_nodes) {
  const long long tree = blockIdx.y;
  node += tree * rows;
  node_out += tree * rows;
  feature += tree * n_nodes;
  split_bin += tree * n_nodes;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < rows;
       row += gridDim.x * blockDim.x) {
    const int nd = node[row];
    const int f = __ldg(feature + nd);
    const int x_bin =
        f >= 0 && f < num_features
            ? static_cast<int>(bins[static_cast<size_t>(row) * num_features + f])
            : 0;
    const bool go_right = x_bin > __ldg(split_bin + nd) && f >= 0;
    node_out[row] = 2 * nd + (go_right ? 1 : 0);
  }
}

int grid_for(long long items, int max_blocks) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < max_blocks ? blocks : max_blocks);
}

template <typename Bin>
cudaError_t launch_apply_bins(const float* X, const float* thresholds,
                              void* bins, long long total, int num_features,
                              int num_thresholds, int max_blocks,
                              cudaStream_t stream) {
  apply_bins_kernel<Bin><<<grid_for(total, max_blocks), kThreads, 0, stream>>>(
      X, thresholds, static_cast<Bin*>(bins), total, num_features,
      num_thresholds);
  return cudaGetLastError();
}

// The most blocks a launch may have along grid dimensions y and z: trees
// past it go in groups of launches.
constexpr int kMaxGridYZ = 65535;

// One pass of K2 per window of cells: the histogram kernel over every
// tree, then the sum of each tree's chunk partials into the window's
// cells of `out`.
template <typename Bin>
cudaError_t launch_level_histograms(
    const void* bins, const int* node, const float* channels,
    double* partials, float* out, int rows, int num_features, int n_nodes,
    int max_bins, int num_channels, int trees, long long bins_tree_stride,
    int chunks, int rows_per_chunk, int window_nodes, int window_bins,
    int window_channels, int block_features, int tile_rows, int max_blocks,
    cudaStream_t stream) {
  const size_t shared_bytes =
      sizeof(double) * static_cast<size_t>(window_nodes) * block_features *
          window_bins * window_channels +
      sizeof(float) * static_cast<size_t>(tile_rows) * window_channels +
      sizeof(int) * tile_rows +
      sizeof(Bin) * static_cast<size_t>(tile_rows) * block_features;
  cudaError_t error = allow_shared(level_histograms_kernel<Bin>, shared_bytes);
  if (error != cudaSuccess) return error;
  const int feature_blocks = (num_features + block_features - 1) / block_features;
  // a warp per feature; at least eight warps, so that the staging of the
  // rows, the zeroing and the write-out are not left to a single warp
  const int threads = std::max(32 * block_features, kThreads);
  const long long out_tree_stride =
      static_cast<long long>(n_nodes) * num_features * max_bins * num_channels;
  for (int n0 = 0; n0 < n_nodes; n0 += window_nodes) {
    for (int b0 = 0; b0 < max_bins; b0 += window_bins) {
      for (int k0 = 0; k0 < num_channels; k0 += window_channels) {
        const Window w{n0, std::min(window_nodes, n_nodes - n0),
                       b0, std::min(window_bins, max_bins - b0),
                       k0, std::min(window_channels, num_channels - k0)};
        const long long cells = static_cast<long long>(w.nodes) * num_features *
                                w.bins * w.channels;
        for (int t0 = 0; t0 < trees; t0 += kMaxGridYZ) {
          const int group = std::min(kMaxGridYZ, trees - t0);
          double* group_partials = partials + static_cast<long long>(t0) * chunks * cells;
          level_histograms_kernel<Bin>
              <<<dim3(chunks, feature_blocks, group), threads, shared_bytes, stream>>>(
                  static_cast<const Bin*>(bins) + t0 * bins_tree_stride,
                  node + static_cast<long long>(t0) * rows,
                  channels + static_cast<long long>(t0) * rows * num_channels,
                  group_partials, rows, num_features, num_channels, w,
                  rows_per_chunk, block_features, tile_rows, bins_tree_stride);
          error = cudaGetLastError();
          if (error != cudaSuccess) return error;
          sum_partials_kernel<<<dim3(grid_for(cells, max_blocks), group), kThreads,
                                0, stream>>>(
              group_partials, out + t0 * out_tree_stride, chunks, cells,
              out_tree_stride, w, num_features, max_bins, num_channels);
          error = cudaGetLastError();
          if (error != cudaSuccess) return error;
        }
      }
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) of
// `device`, does not synchronize, and returns cudaGetLastError() after its
// launches: 0 means they were accepted. Outputs and scratch are allocated
// by the caller. `bin_bytes` is 1 for int8 bins and 4 for int32 bins.

int lo_apply_bins(const float* X, const float* thresholds, void* bins,
                  int bin_bytes, long long rows, int num_features,
                  int num_thresholds, int max_blocks, int device,
                  void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const long long total = rows * num_features;
  if (total <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch_apply_bins<int8_t>(X, thresholds, bins, total, num_features,
                                     num_thresholds, max_blocks, s);
  if (bin_bytes == 4)
    return launch_apply_bins<int32_t>(X, thresholds, bins, total, num_features,
                                      num_thresholds, max_blocks, s);
  return cudaErrorInvalidValue;
}

// T = `trees` trees, each with its own node (T, rows) and channels (T,
// rows, K), the bins of tree t at t * bins_tree_stride (0: one shared
// matrix). partials: T * chunks * window_nodes * F * window_bins *
// window_channels doubles of scratch, reused by every window; out: (T,
// n_nodes, F, B, K).
int lo_level_histograms(const void* bins, int bin_bytes, const int* node,
                        const float* channels, double* partials, float* out,
                        int rows, int num_features, int n_nodes, int max_bins,
                        int num_channels, int trees, long long bins_tree_stride,
                        int chunks, int rows_per_chunk, int window_nodes,
                        int window_bins, int window_channels,
                        int block_features, int tile_rows, int max_blocks,
                        int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (static_cast<long long>(n_nodes) * num_features * max_bins *
          num_channels * trees <= 0)
    return cudaSuccess;
  if (window_nodes <= 0 || window_bins <= 0 || window_channels <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch_level_histograms<int8_t>(
        bins, node, channels, partials, out, rows, num_features, n_nodes,
        max_bins, num_channels, trees, bins_tree_stride, chunks,
        rows_per_chunk, window_nodes, window_bins, window_channels,
        block_features, tile_rows, max_blocks, s);
  if (bin_bytes == 4)
    return launch_level_histograms<int32_t>(
        bins, node, channels, partials, out, rows, num_features, n_nodes,
        max_bins, num_channels, trees, bins_tree_stride, chunks,
        rows_per_chunk, window_nodes, window_bins, window_channels,
        block_features, tile_rows, max_blocks, s);
  return cudaErrorInvalidValue;
}

// mode 0: gini over K class channels; mode 1: newton over (g, h), K = 2.
// subset_scores: null, or (n_nodes, F) scores of which each node takes
// the subset_k lowest (1 <= subset_k).
int lo_select_splits(const float* hist, const float* subset_scores,
                     int subset_k, int* feature, int* bin, int n_nodes,
                     int num_features, int max_bins, int num_channels,
                     int mode, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (n_nodes <= 0) return cudaSuccess;
  if (mode == kNewton && num_channels != 2) return cudaErrorInvalidValue;
  if (subset_scores != nullptr && subset_k < 1) return cudaErrorInvalidValue;
  int threads = round_up_warp(num_features);
  if (threads > kThreads) threads = kThreads;
  const size_t shared_bytes =
      static_cast<size_t>(threads) * (sizeof(float) + sizeof(int)) +
      static_cast<size_t>(threads) * 2 * num_channels * sizeof(float);
  error = allow_shared(select_splits_kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  select_splits_kernel<<<n_nodes, threads, shared_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      hist, subset_scores, subset_k, feature, bin, num_features, max_bins,
      num_channels, mode);
  return cudaGetLastError();
}

// node, node_out: (T, rows); feature, split_bin: (T, n_nodes); one bins
// matrix (rows, F) for every tree.
int lo_route(const void* bins, int bin_bytes, const int* node,
             const int* feature, const int* split_bin, int* node_out, int rows,
             int num_features, int trees, int n_nodes, int max_blocks,
             int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (rows <= 0 || trees <= 0) return cudaSuccess;
  if (bin_bytes != 1 && bin_bytes != 4) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t0 = 0; t0 < trees; t0 += kMaxGridYZ) {
    const dim3 grid(grid_for(rows, max_blocks), std::min(kMaxGridYZ, trees - t0));
    const long long row_offset = static_cast<long long>(t0) * rows;
    const long long split_offset = static_cast<long long>(t0) * n_nodes;
    if (bin_bytes == 1)
      route_kernel<int8_t><<<grid, kThreads, 0, s>>>(
          static_cast<const int8_t*>(bins), node + row_offset,
          feature + split_offset, split_bin + split_offset,
          node_out + row_offset, rows, num_features, n_nodes);
    else
      route_kernel<int32_t><<<grid, kThreads, 0, s>>>(
          static_cast<const int32_t*>(bins), node + row_offset,
          feature + split_offset, split_bin + split_offset,
          node_out + row_offset, rows, num_features, n_nodes);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  return cudaSuccess;
}

// leaf: (T, rows); channels: (T, rows, K). partials: T * chunks *
// window_leaves * window_channels doubles of scratch, reused by every
// window; out: (T, n_leaves, K).
int lo_leaf_sums(const int* leaf, const float* channels, double* partials,
                 float* out, int rows, int n_leaves, int num_channels,
                 int trees, int chunks, int rows_per_chunk, int window_leaves,
                 int window_channels, int warps, int max_blocks, int device,
                 void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (static_cast<long long>(n_leaves) * num_channels * trees <= 0)
    return cudaSuccess;
  if (window_leaves <= 0 || window_channels <= 0) return cudaErrorInvalidValue;
  const size_t shared_bytes = sizeof(double) *
                              static_cast<size_t>(window_leaves) *
                              window_channels * warps;
  error = allow_shared(leaf_sums_kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long out_tree_stride = static_cast<long long>(n_leaves) * num_channels;
  for (int l0 = 0; l0 < n_leaves; l0 += window_leaves) {
    for (int k0 = 0; k0 < num_channels; k0 += window_channels) {
      const Window w{l0, std::min(window_leaves, n_leaves - l0), 0, 1,
                     k0, std::min(window_channels, num_channels - k0)};
      const long long cells = static_cast<long long>(w.nodes) * w.channels;
      for (int t0 = 0; t0 < trees; t0 += kMaxGridYZ) {
        const int group = std::min(kMaxGridYZ, trees - t0);
        double* group_partials = partials + static_cast<long long>(t0) * chunks * cells;
        leaf_sums_kernel<<<dim3(chunks, group), 32 * warps, shared_bytes, s>>>(
            leaf + static_cast<long long>(t0) * rows,
            channels + static_cast<long long>(t0) * rows * num_channels,
            group_partials, rows, num_channels, w, rows_per_chunk);
        error = cudaGetLastError();
        if (error != cudaSuccess) return error;
        sum_partials_kernel<<<dim3(grid_for(cells, max_blocks), group), kThreads, 0, s>>>(
            group_partials, out + t0 * out_tree_stride, chunks, cells,
            out_tree_stride, w, 1, 1, num_channels);
        error = cudaGetLastError();
        if (error != cudaSuccess) return error;
      }
    }
  }
  return cudaSuccess;
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
