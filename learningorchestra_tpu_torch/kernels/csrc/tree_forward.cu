// tree_forward.cu — the tree-ensemble forward (K6) for Hopper (sm_90a).
//
// Replaces learningorchestra_tpu/ml/trees.py:303 `_descend`, as run under
// `_ensemble_forward` (:364, dt and rf: the mean of the trees' leaf class
// distributions) and `_gbt_forward` (:648, gb: boosted margins
// f0 + sum(step * leaf) through a sigmoid, returned as [1 - p, p]); the
// ensemble forward also under the sweep's vmap over jobs
// (ml/sweep.py:263 `_dt_fused`, K14c): each job's trees on its own rows.
//
// What bounds it on this card: the kernel reads X once (N * F * 4 bytes)
// and writes N * C * 4 bytes. The heaps are kilobytes and the work is
// T * D comparisons per row.
//   - At the serve lane's dispatch shapes (N <= 4096 rows, 16 features:
//     256 KB of X) it is bound by launch latency, not by the card.
//   - At the batch lane's N = 1,048,576 rows it moves ~72 MB, so the
//     bound is ~72 MB / 3.35 TB/s ~= 21 us.
//   - Over a job axis, J times that: a dt sweep's 8 slots of 262,144 eval
//     rows move ~151 MB, ~45 us.
//
// Design (a simple kernel that is right first):
//   - One thread walks one row through every tree; a grid-stride loop
//     lets a capped grid cover any N.
//   - A job axis (ensemble forward): grid dimension y is the job, with
//     its own rows (X at j * x_job_stride floats), trees and output
//     (J, N, C); a job's trees are averaged over that job alone, so its
//     probabilities are bit-equal to a launch of that job alone.
//   - Any depth and tree count. The trees are staged in shared memory in
//     groups that fit a block's share: at full width (T = 20, D = 5,
//     C = 2) all of them at once (20*31*8 + 20*32*2*4 bytes ~= 10 KB),
//     once per block. When they do not fit together, the block walks its
//     rows 256 at a time and stages one group after the other for each
//     such tile. When a single tree does not fit (a depth-12 tree of 20
//     classes takes 360 KB), every tree is read from global memory.
//   - The ensemble's per-class sums live in shared memory ([class][thread])
//     while 256 threads' worth fits in 48 KB, else in the output row
//     itself; either way each class sums trees 0..T-1 in order, so the
//     grouping changes no bit of the result.
//   - X is read straight from global memory. The reference's
//     `_indicator_lookup` select-sum worked around serialized TPU
//     gathers; here the lookup is one indexed load.
//   - Numerics match the reference exactly: routing is
//     `!(x <= t) && f >= 0` with x = X[row, max(f, 0)] (so NaN goes right
//     and feature -1 nodes send everything left); a feature index at or
//     past F reads 0, as the reference's one-hot select does. The
//     ensemble sums trees in order 0..T-1 for each class, then divides
//     by T. The boosted margin rounds the product before the add
//     (__fmul_rn/__fadd_rn keep nvcc from contracting them to an FMA),
//     and the sigmoid uses expf. Build without -use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSharedBytes = 48 * 1024;
// The most blocks a launch may have along grid dimension y: jobs past it
// go in groups of launches.
constexpr int kMaxGridYZ = 65535;

// Leaf index in [0, 2^depth) of one row in one tree's heap.
__device__ __forceinline__ int descend(const float* __restrict__ row,
                                       int num_features,
                                       const int* features,
                                       const float* thresholds, int depth) {
  int node = 0;
  for (int level = 0; level < depth; ++level) {
    const int pos = (1 << level) - 1 + node;
    const int feature = features[pos];
    const int column = feature > 0 ? feature : 0;
    const float x = column < num_features ? __ldg(row + column) : 0.0f;
    const bool go_right = !(x <= thresholds[pos]) && feature >= 0;
    node = 2 * node + (go_right ? 1 : 0);
  }
  return node;
}

constexpr size_t kAccBytes = 48 * 1024;  // the ensemble's shared sums, at most

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// Where a block reads trees [first, first + count) from: shared memory,
// staged here (`group` > 0), or global memory (`group` == 0). With every
// tree in one group the block stages them once, before its first tile.
struct TreeGroup {
  const int* features;
  const float* thresholds;
  const float* leaves;
};

__device__ __forceinline__ TreeGroup tree_group(
    const int* __restrict__ features_heap,
    const float* __restrict__ thresholds_heap,
    const float* __restrict__ leaves, int first, int count, int trees,
    int group, int nodes, int leaf_values, int* s_features,
    float* s_thresholds, float* s_leaves) {
  if (group == 0)
    return {features_heap + static_cast<size_t>(first) * nodes,
            thresholds_heap + static_cast<size_t>(first) * nodes,
            leaves + static_cast<size_t>(first) * leaf_values};
  if (group < trees) {  // one group of several: stage it now
    __syncthreads();  // the previous group is consumed
    stage(s_features, features_heap + static_cast<size_t>(first) * nodes,
          count * nodes);
    stage(s_thresholds, thresholds_heap + static_cast<size_t>(first) * nodes,
          count * nodes);
    stage(s_leaves, leaves + static_cast<size_t>(first) * leaf_values,
          count * leaf_values);
    __syncthreads();
  }
  return {s_features, s_thresholds, s_leaves};
}

// `group`: trees staged at a time (0: read from global memory);
// `shared_sums`: keep the per-class sums in shared memory, else in `out`.
__global__ void __launch_bounds__(kThreads)
    tree_ensemble_forward_kernel(const float* __restrict__ X,
                                 const int* __restrict__ features_heap,
                                 const float* __restrict__ thresholds_heap,
                                 const float* __restrict__ leaf_probs,
                                 float* __restrict__ out, int rows,
                                 int num_features, int trees, int depth,
                                 int classes, int group, int shared_sums,
                                 long long x_job_stride) {
  extern __shared__ float shared[];
  const int nodes = (1 << depth) - 1;
  const int leaves = 1 << depth;
  const long long job = blockIdx.y;
  X += job * x_job_stride;
  features_heap += job * trees * nodes;
  thresholds_heap += job * trees * nodes;
  leaf_probs += job * trees * leaves * classes;
  out += job * rows * classes;
  const int staged = group < trees ? group : trees;
  int* s_features = reinterpret_cast<int*>(shared);
  float* s_thresholds = shared + staged * nodes;
  float* s_leaves = s_thresholds + staged * nodes;
  float* s_acc = s_leaves + static_cast<size_t>(staged) * leaves * classes;

  if (group >= trees) {  // every tree at once, for all of the block's rows
    stage(s_features, features_heap, trees * nodes);
    stage(s_thresholds, thresholds_heap, trees * nodes);
    stage(s_leaves, leaf_probs, trees * leaves * classes);
    __syncthreads();
  }
  const int step = group > 0 ? group : trees;
  const float divisor = static_cast<float>(trees);
  for (int tile = blockIdx.x * blockDim.x; tile < rows;
       tile += gridDim.x * blockDim.x) {
    const int row = tile + threadIdx.x;
    const bool active = row < rows;
    float* dst = out + static_cast<size_t>(active ? row : 0) * classes;
    float* acc = shared_sums ? s_acc + threadIdx.x : dst;
    const int stride = shared_sums ? kThreads : 1;
    const float* x = X + static_cast<size_t>(active ? row : 0) * num_features;
    if (active)
      for (int c = 0; c < classes; ++c) acc[c * stride] = 0.0f;
    for (int first = 0; first < trees; first += step) {
      const int count = min(step, trees - first);
      const TreeGroup g = tree_group(features_heap, thresholds_heap, leaf_probs,
                                     first, count, trees, group, nodes,
                                     leaves * classes, s_features,
                                     s_thresholds, s_leaves);
      if (!active) continue;
      for (int t = 0; t < count; ++t) {
        const int leaf = descend(x, num_features, g.features + t * nodes,
                                 g.thresholds + t * nodes, depth);
        const float* probs = g.leaves + (static_cast<size_t>(t) * leaves + leaf) * classes;
        for (int c = 0; c < classes; ++c) acc[c * stride] += probs[c];
      }
    }
    if (active)
      for (int c = 0; c < classes; ++c) dst[c] = acc[c * stride] / divisor;
  }
}

__global__ void __launch_bounds__(kThreads)
    gbt_forward_kernel(const float* __restrict__ X,
                       const int* __restrict__ features_heap,
                       const float* __restrict__ thresholds_heap,
                       const float* __restrict__ leaf_values,
                       float* __restrict__ out, int rows, int num_features,
                       int trees, int depth, float f0, float step_size,
                       int group) {
  extern __shared__ float shared[];
  const int nodes = (1 << depth) - 1;
  const int leaves = 1 << depth;
  const int staged = group < trees ? group : trees;
  int* s_features = reinterpret_cast<int*>(shared);
  float* s_thresholds = shared + staged * nodes;
  float* s_values = s_thresholds + staged * nodes;

  if (group >= trees && trees > 0) {
    stage(s_features, features_heap, trees * nodes);
    stage(s_thresholds, thresholds_heap, trees * nodes);
    stage(s_values, leaf_values, trees * leaves);
    __syncthreads();
  }
  const int step = group > 0 ? group : trees;
  for (int tile = blockIdx.x * blockDim.x; tile < rows;
       tile += gridDim.x * blockDim.x) {
    const int row = tile + threadIdx.x;
    const bool active = row < rows;
    const float* x = X + static_cast<size_t>(active ? row : 0) * num_features;
    float margin = f0;
    for (int first = 0; first < trees; first += step) {
      const int count = min(step, trees - first);
      const TreeGroup g = tree_group(features_heap, thresholds_heap, leaf_values,
                                     first, count, trees, group, nodes, leaves,
                                     s_features, s_thresholds, s_values);
      if (!active) continue;
      for (int t = 0; t < count; ++t) {
        const int leaf = descend(x, num_features, g.features + t * nodes,
                                 g.thresholds + t * nodes, depth);
        margin = __fadd_rn(margin, __fmul_rn(step_size, g.leaves[t * leaves + leaf]));
      }
    }
    if (!active) continue;
    const float p = 1.0f / (1.0f + expf(-margin));
    out[2 * static_cast<size_t>(row)] = 1.0f - p;
    out[2 * static_cast<size_t>(row) + 1] = p;
  }
}

// Raise the kernel's dynamic shared-memory cap when it needs more than
// the default 48 KB; past the card's limit this returns the error.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int grid_for(int rows, int max_blocks) {
  const int blocks = (rows + kThreads - 1) / kThreads;
  return blocks < max_blocks ? blocks : max_blocks;
}

// Trees staged at a time in `available` bytes of shared memory, at
// `per_tree` bytes a tree: all of them, a group, or 0 (global memory).
int tree_group_size(int trees, size_t per_tree, size_t available) {
  const size_t fit = available / per_tree;
  return static_cast<int>(fit < static_cast<size_t>(trees) ? fit : trees);
}

cudaError_t max_shared_bytes(int device, size_t* bytes) {
  int value = 0;
  const cudaError_t error = cudaDeviceGetAttribute(
      &value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes = static_cast<size_t>(value);
  return error;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) of
// `device`, does not synchronize, and returns cudaGetLastError() after
// the launch: 0 means the launch was accepted.

// J = `jobs` jobs: X of job j at j * x_job_stride floats, heaps (J, T,
// nodes), leaf_probs (J, T, leaves, C), out (J, rows, C).
int lo_tree_ensemble_forward(const float* X, const int* features_heap,
                             const float* thresholds_heap,
                             const float* leaf_probs, float* out, int rows,
                             int num_features, int trees, int depth,
                             int classes, int jobs, long long x_job_stride,
                             int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (rows <= 0 || trees <= 0 || jobs <= 0) return cudaSuccess;
  size_t limit = 0;
  error = max_shared_bytes(device, &limit);
  if (error != cudaSuccess) return error;
  const size_t nodes = (size_t{1} << depth) - 1;
  const size_t leaves = size_t{1} << depth;
  const size_t acc_bytes = sizeof(float) * kThreads * static_cast<size_t>(classes);
  const int shared_sums = acc_bytes <= kAccBytes ? 1 : 0;
  const size_t available = limit - (shared_sums ? acc_bytes : 0);
  const size_t per_tree = sizeof(float) * (2 * nodes + leaves * classes);
  const int group = tree_group_size(trees, per_tree, available);
  const size_t shared_bytes =
      per_tree * group + (shared_sums ? acc_bytes : 0);
  error = allow_shared(tree_ensemble_forward_kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  for (int j0 = 0; j0 < jobs; j0 += kMaxGridYZ) {
    const size_t tree_offset = static_cast<size_t>(j0) * trees;
    tree_ensemble_forward_kernel<<<dim3(grid_for(rows, max_blocks),
                                        std::min(kMaxGridYZ, jobs - j0)),
                                   kThreads, shared_bytes,
                                   static_cast<cudaStream_t>(stream)>>>(
        X + j0 * x_job_stride, features_heap + tree_offset * nodes,
        thresholds_heap + tree_offset * nodes,
        leaf_probs + tree_offset * leaves * classes,
        out + static_cast<size_t>(j0) * rows * classes, rows, num_features,
        trees, depth, classes, group, shared_sums, x_job_stride);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  return cudaSuccess;
}

int lo_gbt_forward(const float* X, const int* features_heap,
                   const float* thresholds_heap, const float* leaf_values,
                   float* out, int rows, int num_features, int trees,
                   int depth, float f0, float step, int max_blocks, int device,
                   void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  // no rounds is well defined here: every row's margin is f0
  if (rows <= 0) return cudaSuccess;
  size_t limit = 0;
  error = max_shared_bytes(device, &limit);
  if (error != cudaSuccess) return error;
  const size_t nodes = (size_t{1} << depth) - 1;
  const size_t leaves = size_t{1} << depth;
  const size_t per_tree = sizeof(float) * (2 * nodes + leaves);
  const int group = tree_group_size(trees, per_tree, limit);
  const size_t shared_bytes = per_tree * group;
  error = allow_shared(gbt_forward_kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  gbt_forward_kernel<<<grid_for(rows, max_blocks), kThreads, shared_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      X, features_heap, thresholds_heap, leaf_values, out, rows, num_features,
      trees, depth, f0, step, group);
  return cudaGetLastError();
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
