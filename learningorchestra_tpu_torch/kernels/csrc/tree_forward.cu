// tree_forward.cu — the tree-ensemble forward (K6) for Hopper (sm_90a).
//
// Replaces learningorchestra_tpu/ml/trees.py:303 `_descend`, as run under
// `_ensemble_forward` (:364, dt and rf: the mean of the trees' leaf class
// distributions) and `_gbt_forward` (:648, gb: boosted margins
// f0 + sum(step * leaf) through a sigmoid, returned as [1 - p, p]); the
// ensemble forward also under the sweep's vmap over jobs
// (ml/sweep.py:263 `_dt_fused`, K14c): each job's trees on its own rows,
// or on rows the jobs share.
//
// What bounds it on this card: the kernel reads X once (N * F * 4 bytes)
// and writes N * C * 4 bytes. The heaps are kilobytes and the work is
// T * D comparisons per row.
//   - At the serve lane's dispatch shapes (64 and 4,096 rows, 16 features)
//     the bytes take nanoseconds: what is left is latency, the launch and
//     the chain of dependent loads of a walk.
//   - At the batch lane's N = 1,048,576 rows it moves ~72 MB, so the
//     bound is ~72 MB / 3.35 TB/s ~= 21 us.
//   - Over a job axis whose jobs share X, the rows count once: a dt
//     sweep's 8 slots of 200,000 eval rows move ~26 MB, ~8.8 us.
//
// Design. A block takes a tile of rows and the trees of a group of jobs
// (ml/trees.py `_forward_geometry` picks the tile, the group, the passes
// and the form, a pure function of the shapes that the CPU tests model):
//   - The tile's rows are staged once in shared memory by feature column
//     (feature f of row r at f * R + r, R a power of two) with a column of
//     zeros after the last: a warp loads one 16-byte word of 32 rows (a
//     float where rows do not fall on 16 bytes) and stores each float
//     into 32 consecutive entries of its column. The next tile's words are
//     loaded into registers while this tile is walked. Past half of a
//     block's shared memory for 32 rows, rows are read from global memory
//     instead (x_staged false).
//   - A staged node is one 8-byte word, (column offset, threshold) as an
//     int2: the feature's column f * R, F * R (the zero column) for a
//     feature at or past F, and for a feature -1 node also a threshold of
//     +inf, so that a level is `!(x <= t)` on one shared load and one load
//     of x, with the reference's routing.
//   - A warp walks 32 consecutive rows of one tree: its node loads fall in
//     one level of one tree and its x loads in one column each, on
//     distinct banks. Each thread keeps kInFlight walks in flight, so its
//     chain is D steps a tree.
//   - Two forms of the walk. Tree lanes (serve and sweep shapes): walk i
//     of a tile is (tree i / R, row i % R), spread over the threads, each
//     walk's leaf offset kept in shared memory; after a barrier each
//     (job, row, class) sums its trees' leaf values in tree order. A
//     thread a row (the batch lane's row counts, at most kRegClasses
//     classes and many trees a row): a thread walks its own row through
//     every tree, kInFlight at a time, and adds each leaf's values in
//     tree order into sums in registers, with no leaf offsets and no
//     barrier between the walks and the sums. Both give the same bits.
//   - The sums start from 0, add the trees in order 0..T-1 and divide by T
//     (IEEE, __fdiv_rn); gb's margin adds step * leaf in round order from
//     f0 (__fmul_rn, __fadd_rn: no FMA) and goes through
//     1 / (1 + expf(-m)). No float atomics, so every output is bit-equal
//     to the plain version's and to a launch of its job alone.
//   - Jobs that share X (x_job_stride 0) go in groups that a block walks
//     together: the tile is read once for the group, whose jobs' trees
//     are staged as one forest, each job summed over its own trees. Jobs
//     with their own rows form groups of one (grid dimension y).
//   - Size tiers: (1) every tree of the group staged once for all of the
//     block's tiles; (2) trees past that go in passes of `pass_trees`,
//     staged again for each tile, over tiles long enough to make that
//     cheap, the sums carried between passes in shared memory (or, past
//     its share, in the output itself) in tree order; (3) a tree past half
//     a block's shared memory is read from global memory (in passes only
//     where a tile's leaf offsets of every tree pass the share).
//   - Tiles are walked in a grid-stride loop over as many blocks as the
//     card holds at once (the occupancy API, asked once per device and
//     form by the wrapper), registers capped for kMinBlocks blocks an SM;
//     two barriers a tile (and one a pass in passes).
// Build without -use_fast_math.

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
constexpr int kAhead = 4;     // staging items of the next tile a thread holds in registers
constexpr int kRegClasses = 4;  // a thread a row: the classes it sums in registers
// Blocks an SM should hold at once: registers are capped to fit them
constexpr int kMinBlocks = 4;

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
  int log_tile_rows;         // a tile holds 2^log_tile_rows rows
  int pass_trees;            // trees staged (or walked) at a time
  int acc_shared;            // between passes, the sums in shared memory (else in out)
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

// Staging item i of a tile: the 16-byte word q (or the float q, where rows
// do not fall on 16 bytes) of row r, q = i >> log_r, r = i % R, so that a
// warp loads one word of 32 rows and stores each of its floats into one
// feature column: 32 consecutive entries, distinct banks. Rows past the
// tile's n read 0.
__device__ __forceinline__ float4 load_item(const float* tile_x, int item, int n,
                                            int num_features, int log_r, bool vector) {
  const int r = item & ((1 << log_r) - 1);
  const int q = item >> log_r;
  if (r >= n) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* row = tile_x + static_cast<long long>(r) * num_features;
  if (vector) return __ldg(reinterpret_cast<const float4*>(row) + q);
  return make_float4(__ldg(row + q), 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void store_item(float* s_x, float4 v, int item, int log_r,
                                           bool vector) {
  const int R = 1 << log_r;
  const int r = item & (R - 1);
  const int q = item >> log_r;
  if (vector) {
    float* column = s_x + 4 * q * R + r;
    column[0] = v.x;
    column[R] = v.y;
    column[2 * R] = v.z;
    column[3 * R] = v.w;
  } else {
    s_x[q * R + r] = v.x;
  }
}

// Walks [0, R * np) of a tile: walk i is (tree i / R of the pass, row
// i % R), so a warp walks 32 rows of one tree, and its node loads (one
// tree's level) and x loads (one feature column each, 32 rows) fall on
// distinct banks. Staged nodes are (x offset, threshold): the feature's
// column f * R (F * R, the zero column, for a feature at or past F and for
// a feature -1 node, whose threshold is +inf so that every row goes left).
// The walk's leaf goes to s_leaf[i] as the offset of its values in the
// pass, (tree * leaves + leaf) * C.
template <bool kStaged, bool kXStaged>
__device__ __forceinline__ void walk(const Forward& p, const int2* s_nodes, const int* features,
                                     const float* thresholds, const float* tile_x, int n, int np,
                                     int nodes, int leaves, int log_r, int* s_leaf) {
  const int R = 1 << log_r;
  const int items = np << log_r;
  const int F = p.num_features;
  for (int first = threadIdx.x; first < items; first += kThreads * kInFlight) {
    int pos[kInFlight], tree[kInFlight], row[kInFlight];
    bool live[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int item = first + k * kThreads;
      tree[k] = item >> log_r;
      row[k] = item & (R - 1);
      live[k] = item < items && row[k] < n;
      pos[k] = 0;
    }
    for (int level = 0; level < p.depth; ++level) {
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        if (!live[k]) continue;
        bool right;
        if (kStaged) {
          const int2 nd = s_nodes[tree[k] * nodes + pos[k]];
          float x;
          if (kXStaged) {
            x = tile_x[nd.x + row[k]];
          } else {
            x = nd.x < F ? __ldg(tile_x + static_cast<long long>(row[k]) * F + nd.x) : 0.0f;
          }
          right = !(x <= __int_as_float(nd.y));
        } else {
          const long long at = static_cast<long long>(tree[k]) * nodes + pos[k];
          const int feature = __ldg(features + at);
          const int column = min(max(feature, 0), F);
          float x;
          if (kXStaged)
            x = tile_x[column * R + row[k]];
          else
            x = column < F ? __ldg(tile_x + static_cast<long long>(row[k]) * F + column) : 0.0f;
          right = !(x <= __ldg(thresholds + at)) && feature >= 0;
        }
        pos[k] = 2 * pos[k] + (right ? 2 : 1);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (live[k]) s_leaf[first + k * kThreads] = (tree[k] * leaves + pos[k] - nodes) * p.classes;
  }
}

// The ensemble's sums of a tile's pass: item (row r, class c), for each
// job j of the group, adds its trees' leaf values in tree order onto the
// sum carried from the previous pass (0 at the first), and at the last
// pass writes sum / T. One pass: job j's trees are the pass's [j T, j T +
// T); several passes (one job): the pass's np trees.
__device__ __forceinline__ void ensemble_sums(const Forward& p, const float* values,
                                              const int* s_leaf, float* s_acc, float* out,
                                              int jobs_here, int row0, int n, int np, int pass,
                                              bool last, int R) {
  const int C = p.classes;
  const bool one_pass = pass == 0 && last;
  const int count = one_pass ? p.trees : np;
  const float divisor = static_cast<float>(p.trees);
  for (int rc = threadIdx.x; rc < n * C; rc += kThreads) {
    const int r = rc / C;
    const int c = rc - r * C;
    const float* v = values + c;
    for (int j = 0; j < jobs_here; ++j) {
      const int* leaf = s_leaf + (one_pass ? j * p.trees : 0) * R + r;
      float* dst = out + (static_cast<long long>(j) * p.rows + row0) * C + rc;
      float acc = pass == 0 ? 0.0f : (p.acc_shared ? s_acc[rc] : *dst);
#pragma unroll 4
      for (int t = 0; t < count; ++t) acc = __fadd_rn(acc, v[leaf[t * R]]);
      if (last)
        *dst = __fdiv_rn(acc, divisor);
      else if (p.acc_shared)
        s_acc[rc] = acc;
      else
        *dst = acc;
    }
  }
}

// gb's margins of a tile's pass: row r adds step * leaf value in round
// order onto the margin carried from the previous pass (f0 at the first),
// and at the last pass writes [1 - p, p], p = 1 / (1 + expf(-margin)).
// Between passes the margin waits in shared memory or in out[2 row].
__device__ __forceinline__ void gbt_margins(const Forward& p, const float* values,
                                            const int* s_leaf, float* s_acc, int row0, int n,
                                            int np, int pass, bool last, int R) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    float* dst = p.out + 2 * (static_cast<long long>(row0) + r);
    float margin = pass == 0 ? p.f0 : (p.acc_shared ? s_acc[r] : dst[0]);
    const int* leaf = s_leaf + r;
#pragma unroll 4
    for (int t = 0; t < np; ++t)
      margin = __fadd_rn(margin, __fmul_rn(p.step, values[leaf[t * R]]));
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

// A thread a row (kRowThreads): lanes are consecutive rows, as in `walk`,
// and each thread walks its own row through the pass's trees, kInFlight at
// a time, adding each tree's leaf values in tree order into sums it keeps
// in registers (at most kRegClasses classes): no leaf offsets, no barrier
// before the sums. Item (row, job) of one pass sums the job's trees; between
// passes the sums wait in shared memory (class c of row r at c * R + r) or
// in the output.
template <bool kGbt, bool kStaged, bool kXStaged>
__device__ __forceinline__ void walk_rows(const Forward& p, const int2* s_nodes,
                                          const int* features, const float* thresholds,
                                          const float* tile_x, const float* values, float* s_acc,
                                          float* out, int jobs_here, int row0, int n, int np,
                                          int pass, bool last, int nodes, int leaves, int log_r) {
  const int R = 1 << log_r;
  const int C = kGbt ? 1 : p.classes;
  const int F = p.num_features;
  const bool one_pass = pass == 0 && last;
  const int groups = one_pass ? jobs_here : 1;
  const int count = one_pass ? p.trees : np;
  const float divisor = static_cast<float>(p.trees);
  for (int r = threadIdx.x; r < n; r += kThreads) {
    for (int j = 0; j < groups; ++j) {
      const int t_first = one_pass ? j * p.trees : 0;
      float* dst = kGbt ? p.out + 2 * (static_cast<long long>(row0) + r)
                        : out + (static_cast<long long>(j) * p.rows + row0 + r) * C;
      const float start = kGbt ? p.f0 : 0.0f;
      float acc[kRegClasses];
#pragma unroll
      for (int c = 0; c < kRegClasses; ++c) {
        if (c >= C) acc[c] = 0.0f;
        else if (pass == 0) acc[c] = start;
        else acc[c] = p.acc_shared ? s_acc[c * R + r] : dst[c];
      }
      for (int t0 = 0; t0 < count; t0 += kInFlight) {
        int pos[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) pos[k] = 0;
        for (int level = 0; level < p.depth; ++level) {
#pragma unroll
          for (int k = 0; k < kInFlight; ++k) {
            if (t0 + k >= count) continue;
            const int tree = t_first + t0 + k;
            bool right;
            if (kStaged) {
              const int2 nd = s_nodes[tree * nodes + pos[k]];
              float x;
              if (kXStaged) x = tile_x[nd.x + r];
              else x = nd.x < F ? __ldg(tile_x + static_cast<long long>(r) * F + nd.x) : 0.0f;
              right = !(x <= __int_as_float(nd.y));
            } else {
              const long long at = static_cast<long long>(tree) * nodes + pos[k];
              const int feature = __ldg(features + at);
              const int column = min(max(feature, 0), F);
              float x;
              if (kXStaged) x = tile_x[column * R + r];
              else x = column < F ? __ldg(tile_x + static_cast<long long>(r) * F + column) : 0.0f;
              right = !(x <= __ldg(thresholds + at)) && feature >= 0;
            }
            pos[k] = 2 * pos[k] + (right ? 2 : 1);
          }
        }
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          if (t0 + k >= count) continue;
          const int tree = t_first + t0 + k;
          const float* v = values + (static_cast<long long>(tree) * leaves + pos[k] - nodes) * C;
          if (kGbt) {
            acc[0] = __fadd_rn(acc[0], __fmul_rn(p.step, v[0]));
          } else {
#pragma unroll
            for (int c = 0; c < kRegClasses; ++c)
              if (c < C) acc[c] = __fadd_rn(acc[c], v[c]);
          }
        }
      }
      if (last) {
        if (kGbt) {
          const float prob = 1.0f / (1.0f + expf(-acc[0]));
          dst[0] = 1.0f - prob;
          dst[1] = prob;
        } else {
#pragma unroll
          for (int c = 0; c < kRegClasses; ++c)
            if (c < C) dst[c] = __fdiv_rn(acc[c], divisor);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kRegClasses; ++c)
          if (c < C) {
            if (p.acc_shared) s_acc[c * R + r] = acc[c];
            else dst[c] = acc[c];
          }
      }
    }
  }
}

// Trees [first, first + count) of the block's group into shared memory:
// each node as (x offset, threshold bits) for `walk` and `walk_rows`,
// then their leaf values.
template <bool kXStaged>
__device__ __forceinline__ void stage_trees(int2* s_nodes, float* s_values, const int* features,
                                            const float* thresholds, const float* values,
                                            int first, int count, int nodes, int leaf_floats,
                                            int num_features, int R) {
  const long long n0 = static_cast<long long>(first) * nodes;
#pragma unroll 4
  for (int i = threadIdx.x; i < count * nodes; i += kThreads) {
    const int feature = __ldg(features + n0 + i);
    const float threshold = feature < 0 ? INFINITY : __ldg(thresholds + n0 + i);
    const int column = feature < 0 ? num_features : min(feature, num_features);
    s_nodes[i] = make_int2(kXStaged ? column * R : column, __float_as_int(threshold));
  }
  const long long v0 = static_cast<long long>(first) * leaf_floats;
#pragma unroll 4
  for (int i = threadIdx.x; i < count * leaf_floats; i += kThreads)
    s_values[i] = __ldg(values + v0 + i);
}

// Block (tiles, job group). Shared memory, in order: the staged nodes
// (int2, pass_trees a pass when kStaged) and leaf values, the tile's rows
// by feature column with the zero column last (kXStaged: (F + 1) * R
// floats), the walks' leaf offsets (R * pass_trees; none when a thread
// walks its row), and between passes the sums (R * classes).
template <bool kGbt, bool kStaged, bool kXStaged, bool kRowThreads>
__device__ __forceinline__ void forward(const Forward& p) {
  extern __shared__ __align__(16) float shared[];
  const int nodes = (1 << p.depth) - 1;
  const int leaves = 1 << p.depth;
  const int C = p.classes;
  const int F = p.num_features;
  const int log_r = p.log_tile_rows;
  const int R = 1 << log_r;
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
  int* s_leaf = reinterpret_cast<int*>(s_x + (kXStaged ? (F + 1) * R : 0));
  float* s_acc = reinterpret_cast<float*>(s_leaf + (kRowThreads ? 0 : R * P));

  if (kStaged && passes == 1)  // every tree at once, for all of the block's tiles
    stage_trees<kXStaged>(s_nodes, s_values, features, thresholds, values, 0, W, nodes,
                          leaves * C, F, R);
  if (kXStaged)
    for (int r = threadIdx.x; r < R; r += kThreads) s_x[F * R + r] = 0.0f;
  const bool vector = p.vector != 0;
  const int stage_items = (vector ? F / 4 : F) << log_r;
  const int tiles = (p.rows + R - 1) / R;
  float4 ahead[kAhead];
  auto fetch = [&](int tile) {  // the first items of a tile, into registers
    const int n = min(R, p.rows - tile * R);
    const float* base = X + static_cast<long long>(tile) * R * F;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int item = threadIdx.x + k * kThreads;
      if (item < stage_items) ahead[k] = load_item(base, item, n, F, log_r, vector);
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
      if (kXStaged && pass == 0) {  // the tile's rows: the items fetched ahead, then the rest
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          const int item = threadIdx.x + k * kThreads;
          if (item < stage_items) store_item(s_x, ahead[k], item, log_r, vector);
        }
        for (int item = threadIdx.x + kAhead * kThreads; item < stage_items; item += kThreads)
          store_item(s_x, load_item(tile_x, item, n, F, log_r, vector), item, log_r, vector);
      }
      if (kStaged && passes > 1)
        stage_trees<kXStaged>(s_nodes, s_values, features, thresholds, values, t0, np, nodes,
                              leaves * C, F, R);
      __syncthreads();
      if (kXStaged && pass == 0 && tile + static_cast<int>(gridDim.x) < tiles)
        fetch(tile + gridDim.x);
      const float* pass_values =
          kStaged ? s_values : values + static_cast<long long>(t0) * leaves * C;
      if (kRowThreads) {
        walk_rows<kGbt, kStaged, kXStaged>(
            p, s_nodes, features + static_cast<long long>(t0) * nodes,
            thresholds + static_cast<long long>(t0) * nodes, kXStaged ? s_x : tile_x, pass_values,
            s_acc, out, jobs_here, row0, n, np, pass, last, nodes, leaves, log_r);
      } else {
        walk<kStaged, kXStaged>(p, s_nodes, features + static_cast<long long>(t0) * nodes,
                                thresholds + static_cast<long long>(t0) * nodes,
                                kXStaged ? s_x : tile_x, n, np, nodes, leaves, log_r, s_leaf);
        __syncthreads();
        if (kGbt)
          gbt_margins(p, pass_values, s_leaf, s_acc, row0, n, np, pass, last, R);
        else
          ensemble_sums(p, pass_values, s_leaf, s_acc, out, jobs_here, row0, n, np, pass, last, R);
      }
      // the next pass restages the trees (or rewrites the sums) these read;
      // a thread a row reads its rows of s_x up to here, and where a tile
      // holds fewer rows than the block has threads, the threads past them
      // store the next tile's items into rows that others still read
      if (passes > 1 || kRowThreads) __syncthreads();
    }
  }
}

template <bool kStaged, bool kXStaged, bool kRowThreads>
__global__ void __launch_bounds__(kThreads, kMinBlocks) tree_ensemble_forward_kernel(Forward p) {
  forward<false, kStaged, kXStaged, kRowThreads>(p);
}

template <bool kStaged, bool kXStaged, bool kRowThreads>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gbt_forward_kernel(Forward p) {
  forward<true, kStaged, kXStaged, kRowThreads>(p);
}

using Kernel = void (*)(Forward);

template <bool kGbt, bool kRowThreads>
Kernel kernel_as(int staged, int x_staged) {
  const auto pick = [&](auto staged_x, auto staged_only, auto x_only, auto neither) {
    return staged ? (x_staged ? staged_x : staged_only) : (x_staged ? x_only : neither);
  };
  if (kGbt)
    return pick(gbt_forward_kernel<true, true, kRowThreads>,
                gbt_forward_kernel<true, false, kRowThreads>,
                gbt_forward_kernel<false, true, kRowThreads>,
                gbt_forward_kernel<false, false, kRowThreads>);
  return pick(tree_ensemble_forward_kernel<true, true, kRowThreads>,
              tree_ensemble_forward_kernel<true, false, kRowThreads>,
              tree_ensemble_forward_kernel<false, true, kRowThreads>,
              tree_ensemble_forward_kernel<false, false, kRowThreads>);
}

Kernel kernel_of(int gbt, int staged, int x_staged, int row_threads) {
  if (row_threads)
    return gbt ? kernel_as<true, true>(staged, x_staged) : kernel_as<false, true>(staged, x_staged);
  return gbt ? kernel_as<true, false>(staged, x_staged) : kernel_as<false, false>(staged, x_staged);
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
  const Kernel kernel = kernel_of(gbt, staged, x_staged, row_threads);
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
  const Kernel kernel = kernel_of(gbt, staged, x_staged, row_threads);
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
    p.log_tile_rows = log_tile_rows;
    p.pass_trees = pass_trees;
    p.acc_shared = acc_shared;
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
