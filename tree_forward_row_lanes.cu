// tree_forward_row_lanes.cu — a form of the tree-ensemble forward (K6)
// that its design weighed and left out, kept beside tree_fit_variants.py,
// which times it against learningorchestra_tpu_torch/kernels/csrc/
// tree_forward.cu on the card. The package never builds or calls it.
// It takes tree_forward.cu's entry points and geometry (ml/trees.py
// `_forward_geometry`, with a thread a row switched off: row_threads is
// ignored), with a row tile of F + 1 floats a row (the same bytes at an
// even F + 1, as at the 16 features it is timed at):
//   - a tile's rows staged row by row at an odd stride, (F + 1) | 1, with
//     a zero at entry F;
//   - a row's trees walked side by side: walk i of a tile is (row
//     i / trees, tree i % trees), so the lanes of a warp walk one row's
//     trees, and their node loads fall on the trees' scattered levels;
//   - nodes staged as (feature, threshold) and routed by the reference's
//     rule; the sums and margins as tree_forward.cu's, in the same order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSharedBytes = 48 * 1024;
// The most blocks a launch may have along grid dimension y: job groups
// past it go in launches of their own.
constexpr int kMaxGridYZ = 65535;
constexpr int kInFlight = 4;  // walks a thread keeps in flight
constexpr int kAhead = 4;     // words of the next tile a thread holds in registers

// One launch's operands and geometry (ml/trees.py `_forward_geometry`).
struct Forward {
  const float* X;            // the first job's rows (rows, F)
  const int* features;       // (J, T, nodes)
  const float* thresholds;   // (J, T, nodes)
  const float* values;       // the leaves' values: (J, T, leaves, C), gb's (T, leaves)
  float* out;                // (J, rows, C), gb's (rows, 2)
  long long x_job_stride;    // floats from one job's rows to the next's (0: shared)
  int rows, num_features, trees, depth;
  int classes;               // values a leaf: C, or 1 for gb
  int jobs;                  // jobs of this launch
  int group_jobs;            // jobs a block walks together
  int tile_rows;
  int pass_trees;            // trees staged (or walked) at a time
  int acc_shared;            // between passes, the sums in shared memory (else in out)
  int x_stride;              // floats of a staged row
  int vector;                // every tile's rows begin on 16 bytes
  float f0, step;            // gb's margin
};

// Raise a kernel's dynamic shared-memory cap to `bytes` when it needs
// more than it allows; the cap only grows, so a cap raised for one shape
// keeps every smaller shape launchable. The default 48 KB bounds a block's
// static and dynamic shared memory together, so its static bytes count.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  cudaFuncAttributes attributes;
  cudaError_t error = cudaFuncGetAttributes(&attributes, kernel);
  if (error != cudaSuccess) return error;
  if (bytes + attributes.sharedSizeBytes <= kDefaultSharedBytes ||
      bytes <= static_cast<size_t>(attributes.maxDynamicSharedSizeBytes))
    return cudaSuccess;
  error = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (error != cudaSuccess) return error;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Word `word` of a tile's `floats` floats at `base`: four floats (16 bytes,
// zeros past the end) where the tile begins on 16 bytes, else one.
__device__ __forceinline__ float4 load_word(const float* __restrict__ base, int word,
                                            int floats, bool vector) {
  if (!vector) return make_float4(__ldg(base + word), 0.0f, 0.0f, 0.0f);
  const int q = 4 * word;
  if (q + 4 <= floats) return __ldg(reinterpret_cast<const float4*>(base) + word);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (q < floats) v.x = __ldg(base + q);
  if (q + 1 < floats) v.y = __ldg(base + q + 1);
  if (q + 2 < floats) v.z = __ldg(base + q + 2);
  return v;
}

// The floats of word `word` into their staged rows (row r at r * stride).
__device__ __forceinline__ void store_word(float* s_x, float4 v, int word, int floats,
                                           int num_features, int stride, bool vector) {
  const int per = vector ? 4 : 1;
  const int q = per * word;
  int r = q / num_features;
  int f = q - r * num_features;
  const float parts[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < per && q + i < floats) {
      s_x[r * stride + f] = parts[i];
      if (++f == num_features) {
        f = 0;
        ++r;
      }
    }
  }
}

// Walks [0, n * np) of a tile: walk i is (row i / np, tree i % np) of the
// pass, whose nodes are staged at s_nodes (kStaged) or read from global
// memory from tree `t0` on; its leaf index goes to s_leaf[i].
template <bool kStaged, bool kXStaged>
__device__ __forceinline__ void walk(const Forward& p, const int2* s_nodes, const int* features,
                                     const float* thresholds, const float* rows_x, int n, int np,
                                     int nodes, int* s_leaf) {
  const int items = n * np;
  const int F = p.num_features;
  for (int first = threadIdx.x; first < items; first += kThreads * kInFlight) {
    const int live = min(kInFlight, (items - first + kThreads - 1) / kThreads);
    int node[kInFlight], tree[kInFlight];
    const float* row[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int item = k < live ? first + k * kThreads : first;
      const int r = item / np;
      tree[k] = item - r * np;
      row[k] = rows_x + static_cast<long long>(r) * (kXStaged ? p.x_stride : F);
      node[k] = 0;
    }
    for (int level = 0; level < p.depth; ++level) {
      const int base = (1 << level) - 1;
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        if (k >= live) continue;
        int feature;
        float threshold;
        if (kStaged) {
          const int2 nd = s_nodes[tree[k] * nodes + base + node[k]];
          feature = nd.x;
          threshold = __int_as_float(nd.y);
        } else {
          const long long at = static_cast<long long>(tree[k]) * nodes + base + node[k];
          feature = __ldg(features + at);
          threshold = __ldg(thresholds + at);
        }
        float x;
        if (kXStaged) {
          x = row[k][min(max(feature, 0), F)];
        } else {
          const int column = max(feature, 0);
          x = column < F ? __ldg(row[k] + column) : 0.0f;
        }
        node[k] = 2 * node[k] + (!(x <= threshold) && feature >= 0 ? 1 : 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (k < live) s_leaf[first + k * kThreads] = node[k];
  }
}

// The ensemble's sums of a tile's pass: item (job j, row r, class c) adds
// its job's trees' leaf values in tree order onto the sum carried from
// the previous pass (0 at the first), and at the last pass writes sum / T.
// One pass: job j's trees are walks [j T, j T + T) of a row; several
// passes (one job): the pass's np trees.
__device__ __forceinline__ void ensemble_sums(const Forward& p, const float* values,
                                              const int* s_leaf, float* s_acc, float* out,
                                              int jobs_here, int row0, int n, int np, int pass,
                                              bool last, int leaves) {
  const int C = p.classes;
  const bool one_pass = pass == 0 && last;
  const int count = one_pass ? p.trees : np;
  const int per_job = n * C;
  const float divisor = static_cast<float>(p.trees);
  for (int s = threadIdx.x; s < jobs_here * per_job; s += kThreads) {
    const int j = s / per_job;
    const int rc = s - j * per_job;
    const int r = rc / C;
    const int c = rc - r * C;
    const int first = one_pass ? j * p.trees : 0;
    const int* leaf = s_leaf + r * np + first;
    const float* v = values + static_cast<long long>(first) * leaves * C + c;
    float* dst = out + (static_cast<long long>(j) * p.rows + row0 + r) * C + c;
    float acc = pass == 0 ? 0.0f : (p.acc_shared ? s_acc[r * C + c] : *dst);
#pragma unroll 4
    for (int t = 0; t < count; ++t)
      acc = __fadd_rn(acc, v[(static_cast<long long>(t) * leaves + leaf[t]) * C]);
    if (last)
      *dst = __fdiv_rn(acc, divisor);
    else if (p.acc_shared)
      s_acc[r * C + c] = acc;
    else
      *dst = acc;
  }
}

// gb's margins of a tile's pass: row r adds step * leaf value in round
// order onto the margin carried from the previous pass (f0 at the first),
// and at the last pass writes [1 - p, p], p = 1 / (1 + expf(-margin)).
// Between passes the margin waits in shared memory or in out[2 row].
__device__ __forceinline__ void gbt_margins(const Forward& p, const float* values,
                                            const int* s_leaf, float* s_acc, int row0, int n,
                                            int np, int pass, bool last, int leaves) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float* dst = p.out + 2 * (static_cast<long long>(row0) + r);
    float margin = pass == 0 ? p.f0 : (p.acc_shared ? s_acc[r] : dst[0]);
    const int* leaf = s_leaf + r * np;
#pragma unroll 4
    for (int t = 0; t < np; ++t)
      margin = __fadd_rn(margin, __fmul_rn(p.step, values[static_cast<long long>(t) * leaves + leaf[t]]));
    if (last) {
      const float prob = 1.0f / (1.0f + expf(-margin));
      dst[0] = 1.0f - prob;
      dst[1] = prob;
    } else if (p.acc_shared) {
      s_acc[r] = margin;
    } else {
      dst[0] = margin;
    }
  }
}

// Trees [first, first + count) of the block's group into shared memory:
// each node as (feature, threshold bits), then their leaf values.
__device__ __forceinline__ void stage_trees(int2* s_nodes, float* s_values, const int* features,
                                            const float* thresholds, const float* values,
                                            int first, int count, int nodes, int leaf_floats) {
  const long long n0 = static_cast<long long>(first) * nodes;
  for (int i = threadIdx.x; i < count * nodes; i += kThreads)
    s_nodes[i] = make_int2(__ldg(features + n0 + i), __float_as_int(__ldg(thresholds + n0 + i)));
  const long long v0 = static_cast<long long>(first) * leaf_floats;
  for (int i = threadIdx.x; i < count * leaf_floats; i += kThreads)
    s_values[i] = __ldg(values + v0 + i);
}

// Block (tiles, job group). Shared memory, in order: the staged nodes
// (int2, pass_trees a pass when kStaged) and leaf values, the tile's rows
// (kXStaged), the walks' leaf indices (tile_rows * pass_trees), and
// between passes the sums (tile_rows * classes).
template <bool kGbt, bool kStaged, bool kXStaged>
__device__ __forceinline__ void forward(const Forward& p) {
  extern __shared__ __align__(16) float shared[];
  const int nodes = (1 << p.depth) - 1;
  const int leaves = 1 << p.depth;
  const int C = p.classes;
  const int F = p.num_features;
  const int R = p.tile_rows;
  const int S = p.x_stride;
  const int P = p.pass_trees;
  const int job0 = blockIdx.y * p.group_jobs;
  const int jobs_here = min(p.group_jobs, p.jobs - job0);
  const int W = jobs_here * p.trees;  // the trees this block walks
  const int passes = W > P ? (W + P - 1) / P : 1;
  const float* X = p.X + job0 * p.x_job_stride;
  const long long first_tree = static_cast<long long>(job0) * p.trees;
  const int* features = p.features + first_tree * nodes;
  const float* thresholds = p.thresholds + first_tree * nodes;
  const float* values = p.values + first_tree * leaves * C;
  float* out = p.out + (kGbt ? 0 : static_cast<long long>(job0) * p.rows * C);
  const int staged = kStaged ? P : 0;
  int2* s_nodes = reinterpret_cast<int2*>(shared);
  float* s_values = shared + 2 * staged * nodes;
  float* s_x = s_values + staged * leaves * C;
  int* s_leaf = reinterpret_cast<int*>(s_x + (kXStaged ? R * S : 0));
  float* s_acc = reinterpret_cast<float*>(s_leaf + R * P);

  if (kStaged && passes == 1)  // every tree at once, for all of the block's tiles
    stage_trees(s_nodes, s_values, features, thresholds, values, 0, W, nodes, leaves * C);
  if (kXStaged)
    for (int r = threadIdx.x; r < R; r += kThreads) s_x[r * S + F] = 0.0f;
  const bool vector = p.vector != 0;
  const int tiles = (p.rows + R - 1) / R;
  float4 ahead[kAhead];
  auto fetch = [&](int tile) {  // the first words of a tile, into registers
    const int n = min(R, p.rows - tile * R);
    const int floats = n * F;
    const int words = vector ? (floats + 3) / 4 : floats;
    const float* base = X + static_cast<long long>(tile) * R * F;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int word = threadIdx.x + k * kThreads;
      if (word < words) ahead[k] = load_word(base, word, floats, vector);
    }
  };
  if (kXStaged && static_cast<int>(blockIdx.x) < tiles) fetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * R;
    const int n = min(R, p.rows - row0);
    const float* tile_x = X + static_cast<long long>(row0) * F;
    for (int pass = 0; pass < passes; ++pass) {
      const int t0 = pass * P;
      const int np = min(P, W - t0);
      const bool last = pass == passes - 1;
      if (kXStaged && pass == 0) {  // the tile's rows: the words fetched ahead, then the rest
        const int floats = n * F;
        const int words = vector ? (floats + 3) / 4 : floats;
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          const int word = threadIdx.x + k * kThreads;
          if (word < words) store_word(s_x, ahead[k], word, floats, F, S, vector);
        }
        for (int word = threadIdx.x + kAhead * kThreads; word < words; word += kThreads)
          store_word(s_x, load_word(tile_x, word, floats, vector), word, floats, F, S, vector);
      }
      if (kStaged && passes > 1)
        stage_trees(s_nodes, s_values, features, thresholds, values, t0, np, nodes, leaves * C);
      __syncthreads();
      if (kXStaged && pass == 0 && tile + static_cast<int>(gridDim.x) < tiles)
        fetch(tile + gridDim.x);
      walk<kStaged, kXStaged>(p, s_nodes, features + static_cast<long long>(t0) * nodes,
                              thresholds + static_cast<long long>(t0) * nodes,
                              kXStaged ? s_x : tile_x, n, np, nodes, s_leaf);
      __syncthreads();
      const float* pass_values =
          kStaged ? s_values : values + static_cast<long long>(t0) * leaves * C;
      if (kGbt)
        gbt_margins(p, pass_values, s_leaf, s_acc, row0, n, np, pass, last, leaves);
      else
        ensemble_sums(p, pass_values, s_leaf, s_acc, out, jobs_here, row0, n, np, pass, last,
                      leaves);
      // the next pass restages the trees (or rewrites the sums) these read
      if (passes > 1) __syncthreads();
    }
  }
}

template <bool kStaged, bool kXStaged>
__global__ void __launch_bounds__(kThreads) tree_ensemble_forward_kernel(Forward p) {
  forward<false, kStaged, kXStaged>(p);
}

template <bool kStaged, bool kXStaged>
__global__ void __launch_bounds__(kThreads) gbt_forward_kernel(Forward p) {
  forward<true, kStaged, kXStaged>(p);
}

using Kernel = void (*)(Forward);

Kernel kernel_of(int gbt, int staged, int x_staged) {
  if (gbt) {
    if (staged) return x_staged ? gbt_forward_kernel<true, true> : gbt_forward_kernel<true, false>;
    return x_staged ? gbt_forward_kernel<false, true> : gbt_forward_kernel<false, false>;
  }
  if (staged)
    return x_staged ? tree_ensemble_forward_kernel<true, true>
                    : tree_ensemble_forward_kernel<true, false>;
  return x_staged ? tree_ensemble_forward_kernel<false, true>
                  : tree_ensemble_forward_kernel<false, false>;
}

}  // namespace

extern "C" {

// The form (gbt, staged, x_staged) at `shared_bytes` a block, made
// launchable on `device`: its shared-memory cap raised where it needs
// more, and the blocks of it one SM holds at once and the SM count
// returned. The wrapper asks once per device and shape.
int lo_tree_forward_prepare(int gbt, int staged, int x_staged, int row_threads, int shared_bytes,
                            int device, int* blocks_per_sm, int* sms) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const Kernel kernel = kernel_of(gbt, staged, x_staged);
  if ((error = allow_shared(kernel, static_cast<size_t>(shared_bytes))) != cudaSuccess)
    return error;
  if ((error = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return error;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                       static_cast<size_t>(shared_bytes));
}

// The ensemble forward (gbt 0: X of job j at j * x_job_stride floats, heaps
// (J, T, nodes), values (J, T, leaves, C), out (J, rows, C)) or gb's (gbt
// 1: one job, values (T, leaves), out (rows, 2)), on `blocks` blocks along
// x (grid-stride over the tiles) and a block a job group along y. Launches
// on `stream` of `device`, does not synchronize, and returns
// cudaGetLastError() after the launch: 0 means it was accepted.
int lo_tree_forward(int gbt, int staged, int x_staged, int row_threads, const float* X,
                    const int* features,
                    const float* thresholds, const float* values, float* out, int rows,
                    int num_features, int trees, int depth, int classes, int jobs,
                    long long x_job_stride, int group_jobs, int log_tile_rows, int pass_trees,
                    int acc_shared, int vector, float f0, float step, int blocks,
                    int shared_bytes, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (rows <= 0 || jobs <= 0) return cudaSuccess;
  const Kernel kernel = kernel_of(gbt, staged, x_staged);
  const long long nodes = (1LL << depth) - 1;
  const long long leaf_floats = (1LL << depth) * classes;
  const int groups = (jobs + group_jobs - 1) / group_jobs;
  for (int g0 = 0; g0 < groups; g0 += kMaxGridYZ) {
    const long long j0 = static_cast<long long>(g0) * group_jobs;
    const long long tree0 = j0 * trees;
    Forward p;
    p.X = X + j0 * x_job_stride;
    p.features = features + tree0 * nodes;
    p.thresholds = thresholds + tree0 * nodes;
    p.values = values + tree0 * leaf_floats;
    p.out = out + (gbt ? 0 : j0 * rows * classes);
    p.x_job_stride = x_job_stride;
    p.rows = rows;
    p.num_features = num_features;
    p.trees = trees;
    p.depth = depth;
    p.classes = classes;
    p.jobs = static_cast<int>(jobs - j0);
    p.group_jobs = group_jobs;
    p.tile_rows = 1 << log_tile_rows;
    p.pass_trees = pass_trees;
    p.acc_shared = acc_shared;
    p.x_stride = (num_features + 1) | 1;
    p.vector = vector;
    p.f0 = f0;
    p.step = step;
    kernel<<<dim3(blocks, std::min(kMaxGridYZ, groups - g0)), kThreads, shared_bytes,
             static_cast<cudaStream_t>(stream)>>>(p);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  return cudaSuccess;
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
