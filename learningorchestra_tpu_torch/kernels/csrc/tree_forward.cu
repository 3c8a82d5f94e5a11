// tree_forward.cu — the tree-ensemble forward (K6) for Hopper (sm_90a).
//
// Replaces learningorchestra_tpu/ml/trees.py:303 `_descend`, as run under
// `_ensemble_forward` (:364, dt and rf: the mean of the trees' leaf class
// distributions) and `_gbt_forward` (:648, gb: boosted margins
// f0 + sum(step * leaf) through a sigmoid, returned as [1 - p, p]).
//
// What bounds it on this card: the kernel reads X once (N * F * 4 bytes)
// and writes N * C * 4 bytes. The heaps are kilobytes and the work is
// T * D comparisons per row.
//   - At the serve lane's dispatch shapes (N <= 4096 rows, 16 features:
//     256 KB of X) it is bound by launch latency, not by the card.
//   - At the batch lane's N = 1,048,576 rows it moves ~72 MB, so the
//     bound is ~72 MB / 3.35 TB/s ~= 21 us.
//
// Design (a simple kernel that is right first):
//   - One thread walks one row through every tree; a grid-stride loop
//     lets a capped grid cover any N, so the heaps are staged once per
//     block, not once per 256 rows.
//   - The block stages all T heaps in shared memory: at full width
//     (T = 20, D = 5, C = 2) that is 20*31*8 + 20*32*2*4 bytes ~= 10 KB.
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

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

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

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
    tree_ensemble_forward_kernel(const float* __restrict__ X,
                                 const int* __restrict__ features_heap,
                                 const float* __restrict__ thresholds_heap,
                                 const float* __restrict__ leaf_probs,
                                 float* __restrict__ out, int rows,
                                 int num_features, int trees, int depth,
                                 int classes) {
  extern __shared__ float shared[];
  const int nodes = (1 << depth) - 1;
  const int leaves = 1 << depth;
  int* s_features = reinterpret_cast<int*>(shared);
  float* s_thresholds = shared + trees * nodes;
  float* s_leaves = s_thresholds + trees * nodes;
  // per-thread class accumulators, laid out [class][thread]
  float* s_acc = s_leaves + trees * leaves * classes;

  stage(s_features, features_heap, trees * nodes);
  stage(s_thresholds, thresholds_heap, trees * nodes);
  stage(s_leaves, leaf_probs, trees * leaves * classes);
  __syncthreads();

  const float divisor = static_cast<float>(trees);
  float* acc = s_acc + threadIdx.x;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < rows;
       row += gridDim.x * blockDim.x) {
    const float* x = X + static_cast<size_t>(row) * num_features;
    for (int c = 0; c < classes; ++c) acc[c * kThreads] = 0.0f;
    for (int t = 0; t < trees; ++t) {
      const int leaf = descend(x, num_features, s_features + t * nodes,
                               s_thresholds + t * nodes, depth);
      const float* probs = s_leaves + (t * leaves + leaf) * classes;
      for (int c = 0; c < classes; ++c) acc[c * kThreads] += probs[c];
    }
    float* dst = out + static_cast<size_t>(row) * classes;
    for (int c = 0; c < classes; ++c) dst[c] = acc[c * kThreads] / divisor;
  }
}

__global__ void __launch_bounds__(kThreads)
    gbt_forward_kernel(const float* __restrict__ X,
                       const int* __restrict__ features_heap,
                       const float* __restrict__ thresholds_heap,
                       const float* __restrict__ leaf_values,
                       float* __restrict__ out, int rows, int num_features,
                       int trees, int depth, float f0, float step) {
  extern __shared__ float shared[];
  const int nodes = (1 << depth) - 1;
  const int leaves = 1 << depth;
  int* s_features = reinterpret_cast<int*>(shared);
  float* s_thresholds = shared + trees * nodes;
  float* s_values = s_thresholds + trees * nodes;

  stage(s_features, features_heap, trees * nodes);
  stage(s_thresholds, thresholds_heap, trees * nodes);
  stage(s_values, leaf_values, trees * leaves);
  __syncthreads();

  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < rows;
       row += gridDim.x * blockDim.x) {
    const float* x = X + static_cast<size_t>(row) * num_features;
    float margin = f0;
    for (int t = 0; t < trees; ++t) {
      const int leaf = descend(x, num_features, s_features + t * nodes,
                               s_thresholds + t * nodes, depth);
      margin = __fadd_rn(margin, __fmul_rn(step, s_values[t * leaves + leaf]));
    }
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

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) of
// `device`, does not synchronize, and returns cudaGetLastError() after
// the launch: 0 means the launch was accepted.

int lo_tree_ensemble_forward(const float* X, const int* features_heap,
                             const float* thresholds_heap,
                             const float* leaf_probs, float* out, int rows,
                             int num_features, int trees, int depth,
                             int classes, int max_blocks, int device,
                             void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (rows <= 0 || trees <= 0) return cudaSuccess;
  const size_t nodes = (size_t{1} << depth) - 1;
  const size_t leaves = size_t{1} << depth;
  const size_t shared_bytes =
      sizeof(float) * (2 * trees * nodes + trees * leaves * classes +
                       static_cast<size_t>(kThreads) * classes);
  error = allow_shared(tree_ensemble_forward_kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  tree_ensemble_forward_kernel<<<grid_for(rows, max_blocks), kThreads,
                                 shared_bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      X, features_heap, thresholds_heap, leaf_probs, out, rows, num_features,
      trees, depth, classes);
  return cudaGetLastError();
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
  const size_t nodes = (size_t{1} << depth) - 1;
  const size_t leaves = size_t{1} << depth;
  const size_t shared_bytes = sizeof(float) * (2 * trees * nodes + trees * leaves);
  error = allow_shared(gbt_forward_kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  gbt_forward_kernel<<<grid_for(rows, max_blocks), kThreads, shared_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      X, features_heap, thresholds_heap, leaf_values, out, rows, num_features,
      trees, depth, f0, step);
  return cudaGetLastError();
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
