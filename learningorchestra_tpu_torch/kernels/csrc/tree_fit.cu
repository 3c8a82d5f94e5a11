// tree_fit.cu — the tree fit's level loop (K1–K5) for Hopper (sm_90a).
//
// Replaces, in learningorchestra_tpu/:
//   K1 ml/binning.py:37 `apply_bins`           -> lo_apply_bins
//   K2 ml/trees.py:66 `_level_histograms`      -> lo_level_histograms
//   K3 ml/trees.py:160 `_gini_gain`, :181 `_newton_gain`,
//      :196 `_select_splits`                   -> lo_select_splits
//   K4 ml/trees.py:235 `_route` (:217 `_indicator_lookup`)
//                                              -> lo_route
//   K5 ml/trees.py:142 `_leaf_sums`            -> lo_leaf_counts, lo_leaf_sums
// K2, K4 and K5 also run under the random forest's vmap over trees
// (ml/trees.py:437 in `_rf_chunk`), and K3 with its per-node feature
// subsets (:201-206). K1-K5 also run under the sweep's vmap over jobs
// (ml/sweep.py:263 `_dt_fused`, K14c): one tree a job, each job with its
// own rows, bins and thresholds.
//
// What bounds them on this card, at the default fit (N = 1,000,000 rows,
// F = 16 features, B = 32 bins, depth 5, K = 2 channels):
//   - K1 reads X (64 MB; 32 MB of bfloat16 under LO_DTYPE_POLICY=bf16) and
//     writes int8 bins (16 MB): ~24 us of bytes (~14 us at bfloat16); its
//     searches (5 a value at 32 bins) come second.
//   - K2 reads bins, node and channels once per level (28 MB): ~8.4 us.
//     Its counts path also zeroes, flushes and rounds the output (a
//     level's 64 KB) and its sums path writes and reads a chunk's float64
//     partials (at most its rows' cells): costs the design is charged
//     with, the bound unchanged.
//   - K4 reads node, one bin of each row whose node splits, and writes
//     node (at most 9 MB): ~2.7 us. A bin is read as its 32-byte sector,
//     so where every row splits the level moves the whole bins matrix:
//     24 MB, ~7.2 us (the sector floor).
//   - K3 reads a histogram of a few KB a node: launch latency, then the
//     chain of each node's phases.
//   - K5 reads leaf and channels (12 MB): ~3.6 us.
// The random forest's level (T = 20 trees over the same bins) reads the
// bins once and each tree's node and channels: 256 MB, ~77 us for K2.
// A dt sweep's level (J jobs, each with its own bins) reads J times what
// one tree's does: at J = 8 slots of 1,048,576 rows, K2 moves 224 MB a
// level (~67 us). K1 reads the slots' one X once (64 MB) and writes each
// slot's bins (128 MB): ~60 us of bytes, beside 8 times the searches.
// All five are designed for the card (described at their kernels below).
//
// Design and numerics:
//   - Deterministic. A resumed or coalesced fit must rerun bit for bit,
//     and K3 takes an argmax over K2's sums, so no float sum depends on
//     the order in which threads happen to run: there are no float
//     atomics. K2 takes integer channels (the gini fits') as integer
//     counts, exact in any order, and any other channels (gb's) as
//     float64 sums in an order fixed by the rows: fixed chunks (a function
//     of the level's shape alone), each warp's part of a chunk in row
//     order, the warps' parts and then the chunks added in order. K5 takes
//     the same two paths: integer channels as 32-bit counts; float ones
//     in fixed chunks (a function of the row count alone), in a chunk a
//     warp its rows 32 at a time in order, the lanes of one leaf
//     (__match_any_sync) added in lane order into the warp's own copy,
//     the copies in warp order, the chunks in a fixed order.
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
//   - K1 is searchsorted(side=left) on the sorted thresholds, each
//     feature's padded with +inf to a power of two and bisected in
//     branch-free steps; NaN goes past every threshold (last bin).
//   - K4 picks a row's bin in registers from its 16-byte words (or gathers
//     it); the reference's select-sum lookup worked around serialized
//     gathers on the TPU.
//   - Bins are int8 while max_bins <= 127 and int32 above, as the
//     reference's (ml/binning.py:54): K1 writes either, K2 and K4 read
//     either (a template on the bin type; `bin_bytes` picks it).
//   - Any level width. K2's counts path counts a block's features in
//     shared memory while one feature's cells fit its share, else straight
//     into the output in global memory. Its sums path keeps a window of
//     (node, bin, channel) cells of a block's features in shared memory,
//     the windows of nodes and the feature blocks as blocks of one launch
//     and windows of bins or channels as passes; rows whose cell lies
//     outside the window are skipped. K5's counts take any width in one
//     pass (in shared memory while the cells fit it, else in global
//     memory); its sums run one pass per window of (leaf, channel) cells
//     past one block. A cell's sum takes its rows in the same order in
//     every window, so the result does not depend on the windows.
//   - A tree axis. K2, K4 and K5 take T trees in one launch: each tree
//     has its own node and channels (its own bootstrap weights), and the
//     trees read one bins matrix (K2 and K4 take the bins' stride along
//     the tree axis: 0 for the forest, rows * F for a sweep's jobs, each
//     with its own bins; K4 reads a shared matrix once for a group of
//     trees). A tree's sums are those of a launch of that
//     tree alone, bit for bit: trees never share a cell, and a cell adds
//     its rows in the same order. K3 takes the forest's (or the jobs')
//     (T, nodes) flattened into its node axis.
//   - A job axis for K1: J jobs in one launch, job j's rows at j *
//     x_job_stride floats (0: one X that a group of jobs reads once) and
//     its thresholds at j * thresholds_job_stride (0: shared), its bins
//     at j * rows * F.
//   - Feature subsets (K3). A feature is a candidate of its node iff
//     fewer than `subset_k` of the node's scores are below its own, which
//     is `score <= sort(scores)[subset_k - 1]` of the reference, ties
//     included; every cell of any other feature is -inf, NaN or not.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float kEps = 1e-12f;       // ml/trees.py:56 EPS, as float32
constexpr int kThreads = 256;
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr int kGini = 0;
constexpr int kNewton = 1;
// K2's sums path: warps a block, each with its own copy of the cells
constexpr int kSumWarps = 8;
constexpr int kSumThreads = 32 * kSumWarps;

// Past the default 48 KB, a kernel's dynamic shared memory is allowed up
// to `bytes`, and its SMs are asked for their largest shared-memory
// carveout, so that several blocks of that size fit one SM.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  // the default 48 KB bounds a block's static and dynamic shared memory
  // together, so a kernel's static bytes count against it
  cudaFuncAttributes attributes;
  cudaError_t error = cudaFuncGetAttributes(&attributes, kernel);
  if (error != cudaSuccess) return error;
  if (bytes + attributes.sharedSizeBytes <= kDefaultSharedBytes) return cudaSuccess;
  error = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (error != cudaSuccess) return error;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// A window of histogram cells: nodes (or leaves) [node_begin, +nodes),
// bins [bin_begin, +bins) and channels [channel_begin, +channels).
struct Window {
  int node_begin, nodes;
  int bin_begin, bins;
  int channel_begin, channels;
};

// ------------------------------------------------------------------ K1
//
// Bound by bytes: X read once (64 MB at the default fit), the bins written
// once (16 MB), the thresholds (2 KB a job) nothing. A block takes a
// group of jobs and walks tiles of kBinThreads rows, a row a thread:
//   - The group's thresholds sit in shared memory, each feature's row
//     padded with +inf to a power of two P (32 floats at 32 bins, 256 at
//     255), so the search is log2(P) branch-free steps. The lanes of a
//     warp search one feature at a time: at 32 bins its 32 entries lie in
//     32 distinct banks.
//   - A thread reads its row as float4 words (when F is a multiple of 4),
//     with no per-element modulo, and writes each job's bins of a word of
//     features (16 int8 or 4 int32 bins) as one 16-byte store where the
//     rows fall on 16 bytes, else bin by bin.
//   - X shared by the jobs (x_job_stride 0, the sweep's slots): a row is
//     read once for the whole group, each job searched against its own
//     thresholds. Blocks of one tile and different groups are neighbours
//     in the grid, so a tile that several groups read comes from L2.
//   - Thresholds past a block's shared memory go in windows of features
//     (ml/binning.py _k1_geometry); past one feature's row, the wrapper
//     pads them into a table in global memory, searched in place.
//   - As many blocks as the card holds at once, each thread at most 64
//     registers (four blocks an SM), so no partial second wave trails the
//     grid. (A double-buffered cp.async ring of X tiles was slower at one
//     job: its barriers cost more than the latency it hid.)
//   - X may be bfloat16 (LO_DTYPE_POLICY=bf16, the one-tree fits; the job
//     form stays float32): each value is widened exactly to float32 as it
//     is loaded, and the search is unchanged, so the bins are those of the
//     float32 kernel on the widened X (the reference's jnp promotes the
//     bfloat16 X to float32 against its float32 thresholds). A row is read
//     as 16-byte words of 8 values where F and the window are multiples of
//     8 (8-byte words of 4 for int32 bins), else value by value.
constexpr int kBinThreads = 256;

// A bfloat16 value's bits; widened to float32 by a shift, exactly
// (__bfloat162float's bits).
typedef unsigned short bf16_bits;
__device__ __forceinline__ float widen(bf16_bits bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
// The two bfloat16 values of a 32-bit word, the lower address first.
__device__ __forceinline__ void widen_pair(unsigned word, float* value) {
  value[0] = __uint_as_float(word << 16);
  value[1] = __uint_as_float(word & 0xffff0000u);
}

// kPerWord values of a row from x: as 16-byte words (`vector`: x on 16
// bytes and width a multiple of 4 floats), else value by value, 0 past
// `width`.
template <int kPerWord>
__device__ __forceinline__ void load_values(const float* x, int width, bool vector, float* value) {
  if (vector) {
#pragma unroll
    for (int q = 0; q < kPerWord / 4; ++q) {
      if (4 * q >= width) break;
      const float4 word = __ldg(reinterpret_cast<const float4*>(x) + q);
      value[4 * q] = word.x;
      value[4 * q + 1] = word.y;
      value[4 * q + 2] = word.z;
      value[4 * q + 3] = word.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerWord; ++i) value[i] = i < width ? __ldg(x + i) : 0.0f;
  }
}
// bfloat16: 16-byte words of 8 values (8-byte words of 4 when kPerWord
// is 4) where `vector` (x on 16 bytes, width a multiple of 8 values, or 4
// at kPerWord 4), each widened exactly.
template <int kPerWord>
__device__ __forceinline__ void load_values(const bf16_bits* x, int width, bool vector,
                                            float* value) {
  if (vector) {
    if constexpr (kPerWord >= 8) {
#pragma unroll
      for (int q = 0; q < kPerWord / 8; ++q) {
        if (8 * q >= width) break;
        const uint4 word = __ldg(reinterpret_cast<const uint4*>(x) + q);
        widen_pair(word.x, value + 8 * q);
        widen_pair(word.y, value + 8 * q + 2);
        widen_pair(word.z, value + 8 * q + 4);
        widen_pair(word.w, value + 8 * q + 6);
      }
    } else {
      const uint2 word = __ldg(reinterpret_cast<const uint2*>(x));
      widen_pair(word.x, value);
      widen_pair(word.y, value + 2);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerWord; ++i) value[i] = i < width ? widen(__ldg(x + i)) : 0.0f;
  }
}

// The count of a padded row's entries below x, which is
// searchsorted(side=left) on the feature's sorted thresholds: a bisection
// of `steps` (kSteps when it is not 0) branch-free steps over the
// 2^steps-entry row, whose entries past its n thresholds are +inf and so
// below nothing. NaN, below nothing, goes past every threshold: bin n.
template <int kSteps>
__device__ __forceinline__ int padded_search(const float* t, int steps, float x, int n) {
  int pos = 0;
  if (kSteps > 0) {
#pragma unroll
    for (int s = kSteps - 1; s >= 0; --s) pos += t[pos + (1 << s) - 1] < x ? 1 << s : 0;
  } else {
    for (int s = steps - 1; s >= 0; --s) pos += t[pos + (1 << s) - 1] < x ? 1 << s : 0;
  }
  return isnan(x) ? n : pos;
}

// Word i of a row's bins: 16 int8 bins in four 32-bit words, or 4 int32.
__device__ __forceinline__ void set_bin(uint4& word, int i, int bin, int8_t) {
  unsigned& part = i < 4 ? word.x : i < 8 ? word.y : i < 12 ? word.z : word.w;
  part |= (static_cast<unsigned>(bin) & 0xffu) << (8 * (i & 3));
}
__device__ __forceinline__ void set_bin(uint4& word, int i, int bin, int32_t) {
  (i == 0 ? word.x : i == 1 ? word.y : i == 2 ? word.z : word.w) = static_cast<unsigned>(bin);
}

// Block b: job group b % groups (`group` jobs from group * (b % groups))
// over row tiles b / groups, b / groups + tile_blocks, ... Thresholds of
// job j at j * thresholds_job_stride, (F, num_thresholds) when staged,
// else the padded (F, 2^steps) table; X of job j at j * x_job_stride (0:
// shared; a group of one job when not); bins (J, rows, F). At most 64
// registers a thread: four blocks an SM.
template <typename In, typename Bin, bool kStaged, int kSteps>
__global__ void __launch_bounds__(kBinThreads, 4)
    apply_bins_kernel(const In* __restrict__ X, const float* __restrict__ thresholds,
                      Bin* __restrict__ bins, int rows, int num_features,
                      int num_thresholds, int steps, int jobs, int group,
                      int window_features, long long x_job_stride,
                      long long thresholds_job_stride, int vector_x, int vector_bins) {
  extern __shared__ __align__(16) float staged_thresholds[];
  constexpr int kPerWord = 16 / sizeof(Bin);
  const int F = num_features;
  // a row's entries: a constant where the search is unrolled, so that each
  // feature's row is an immediate offset from the table
  const int P = kSteps > 0 ? 1 << kSteps : 1 << steps;
  const int groups = (jobs + group - 1) / group;
  const int job_begin = blockIdx.x % groups * group;
  const int group_jobs = min(group, jobs - job_begin);
  const int tile_blocks = gridDim.x / groups;
  const int tiles = (rows + kBinThreads - 1) / kBinThreads;
  const size_t out_job_stride = static_cast<size_t>(rows) * F;
  X += job_begin * x_job_stride;
  bins += job_begin * out_job_stride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int f0 = 0; f0 < F; f0 += window_features) {
    const int wf = min(window_features, F - f0);
    const float* table;
    long long table_job_stride;
    if (kStaged) {
      if (f0 > 0) __syncthreads();  // the previous window's searches are done
      // a warp a (job, feature) row: its thresholds, then +inf to P
      for (int row = warp; row < group_jobs * wf; row += kBinThreads / 32) {
        const int jj = row / wf, f = row - jj * wf;
        const float* source = thresholds + (job_begin + jj) * thresholds_job_stride +
                              static_cast<size_t>(f0 + f) * num_thresholds;
        for (int p = lane; p < P; p += 32)
          staged_thresholds[row * P + p] = p < num_thresholds ? __ldg(source + p) : INFINITY;
      }
      __syncthreads();
      table = staged_thresholds;
      table_job_stride = static_cast<long long>(wf) * P;
    } else {
      table = thresholds + job_begin * thresholds_job_stride + static_cast<size_t>(f0) * P;
      table_job_stride = thresholds_job_stride;
    }
    for (int tile = blockIdx.x / groups; tile < tiles; tile += tile_blocks) {
      const int r = tile * kBinThreads + threadIdx.x;
      if (r >= rows) continue;
      const In* row_x = X + static_cast<size_t>(r) * F + f0;
      Bin* row_bins = bins + static_cast<size_t>(r) * F + f0;
      for (int c0 = 0; c0 < wf; c0 += kPerWord) {
        const int width = min(kPerWord, wf - c0);
        float value[kPerWord];
        // vector_x: F, window_features, f0 and c0 multiples of a word's values
        load_values<kPerWord>(row_x + c0, width, vector_x != 0, value);
        for (int jj = 0; jj < group_jobs; ++jj) {
          const float* t = table + jj * table_job_stride + static_cast<size_t>(c0) * P;
          Bin* out = row_bins + jj * out_job_stride + c0;
          if (vector_bins && width == kPerWord) {
            uint4 word = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int i = 0; i < kPerWord; ++i)
              set_bin(word, i, padded_search<kSteps>(t + i * P, steps, value[i], num_thresholds),
                      Bin());
            *reinterpret_cast<uint4*>(out) = word;
          } else {
#pragma unroll
            for (int i = 0; i < kPerWord; ++i)
              if (i < width)
                out[i] = static_cast<Bin>(
                    padded_search<kSteps>(t + i * P, steps, value[i], num_thresholds));
          }
        }
      }
    }
  }
}

// An empty kernel: the card's launch floor, timed beside the small kernels.
__global__ void empty_kernel() {}

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

// A row's bins of features [f_begin, f_begin + fb), each given to
// `visit(f - f_begin, bin)` in feature order: as 16-byte words when
// `vector` (the row, f_begin and fb fall on 16 bytes), else one by one.
__device__ __forceinline__ int bin_at(const uint4& word, int i, int8_t) {
  const unsigned part = i < 4 ? word.x : i < 8 ? word.y : i < 12 ? word.z : word.w;
  return static_cast<int8_t>(part >> (8 * (i & 3)));
}
__device__ __forceinline__ int bin_at(const uint4& word, int i, int32_t) {
  return static_cast<int32_t>(i == 0 ? word.x : i == 1 ? word.y : i == 2 ? word.z : word.w);
}

template <typename Bin, typename Visit>
__device__ __forceinline__ void for_row_bins(const Bin* __restrict__ row, int f_begin,
                                             int fb, bool vector, Visit visit) {
  if (vector) {
    constexpr int kPerWord = 16 / sizeof(Bin);
    const uint4* words = reinterpret_cast<const uint4*>(row + f_begin);
    for (int f0 = 0; f0 < fb; f0 += kPerWord) {
      const uint4 word = __ldg(words + f0 / kPerWord);
#pragma unroll
      for (int i = 0; i < kPerWord; ++i) visit(f0 + i, bin_at(word, i, Bin()));
    }
  } else {
    for (int f = 0; f < fb; ++f) visit(f, static_cast<int>(__ldg(row + f_begin + f)));
  }
}

// ---------------------------------------------------------------- K2, counts
//
// The gini fits' channels are class one-hots times integer weights (dt's
// ones, the forest's Poisson counts, a sweep's 0/1 masks), and their
// callers say so. Their sums are integers, exact in any order, so the
// counts path adds them as integers: the order of the adds cannot show,
// and any thread may add into any cell.
//   - Block (chunk, feature block, tree); every thread walks rows (a row a
//     thread, its bins as 16-byte words), and adds each nonzero channel
//     of each of the block's features into its cell with a shared-memory
//     atomic on a 32-bit count.
//   - The block then adds each cell it touched into the level's counts
//     with one global atomic (coalesced): no partials a chunk. A chunk
//     takes at least 4 rows for each cell of a feature, so the flush is
//     at most a quarter of the adds.
//   - Where one feature's cells do not fit a block, every thread adds
//     straight into the level's counts in global memory: no windows, no
//     row read twice.
//   - The counts are the output's own bytes (zeroed first); a last kernel
//     rounds each count to float32 in place, which is the float64 sum
//     rounded once.
//   - The claim is checked value by value: a channel that is not an
//     integer in [0, 65536), or a count that passes 2^32, traps (a
//     device-side error, raised by PyTorch at the next synchronization).

constexpr int kCountThreads = 512;
constexpr float kCountLimit = 65536.0f;

__device__ __forceinline__ unsigned count_of(float value, const char* entry) {
  if (!(value >= 0.0f && value < kCountLimit && value == truncf(value))) {
    printf("%s: channel value %g is not an integer in [0, 65536)\n", entry, value);
    __trap();
  }
  return static_cast<unsigned>(value);
}

__device__ __forceinline__ void add_count(unsigned* __restrict__ cell, unsigned value,
                                          const char* entry) {
  const unsigned before = atomicAdd(cell, value);
  if (before + value < before) {
    printf("%s: a count passes 2^32\n", entry);
    __trap();
  }
}

template <typename Bin, bool kShared>
__global__ void __launch_bounds__(kCountThreads) level_counts_kernel(
    const Bin* __restrict__ bins, const int* __restrict__ node,
    const float* __restrict__ channels, unsigned* __restrict__ counts, int rows,
    int num_features, int n_nodes, int max_bins, int num_channels,
    int rows_per_chunk, int block_features, int vector, long long bins_tree_stride) {
  extern __shared__ __align__(16) unsigned char shared[];
  unsigned* hist = reinterpret_cast<unsigned*>(shared);  // (node, f, bin, k)
  const long long tree = blockIdx.z;
  const int F = num_features, B = max_bins, K = num_channels;
  bins += tree * bins_tree_stride;
  node += tree * rows;
  channels += tree * rows * K;
  counts += tree * n_nodes * F * B * K;
  const int f_begin = blockIdx.y * block_features;
  const int fb = min(block_features, F - f_begin);
  const int run = fb * B * K;  // a node's cells of the block's features
  if (kShared) {
    for (int i = threadIdx.x; i < n_nodes * run; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
  }
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  for (int r = row_begin + threadIdx.x; r < row_end; r += blockDim.x) {
    const int nd = __ldg(node + r);
    if (nd < 0 || nd >= n_nodes) continue;
    for (int k = 0; k < K; ++k) {
      const unsigned value = count_of(__ldg(channels + static_cast<size_t>(r) * K + k),
                                      "lo_level_counts");
      if (value == 0u) continue;
      for_row_bins(bins + static_cast<size_t>(r) * F, f_begin, fb, vector != 0,
                   [&](int f, int b) {
                     if (f >= fb || b < 0 || b >= B) return;
                     if (kShared)
                       atomicAdd(hist + (nd * fb + f) * B * K + b * K + k, value);
                     else
                       add_count(counts + ((static_cast<long long>(nd) * F + f_begin + f) *
                                               B + b) * K + k,
                                 value, "lo_level_counts");
                   });
    }
  }
  if (!kShared) return;
  __syncthreads();
  for (int i = threadIdx.x; i < n_nodes * run; i += blockDim.x) {
    const unsigned value = hist[i];
    if (value != 0u)
      add_count(counts + (static_cast<long long>(i / run) * F + f_begin) * B * K + i % run,
                value, "lo_level_counts");
  }
}

// Each count rounded once to float32, in place.
__global__ void __launch_bounds__(kThreads)
    counts_to_float_kernel(float* __restrict__ out, long long cells) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < cells; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = __uint2float_rn(reinterpret_cast<const unsigned*>(out)[i]);
}

// Copies of 16 and 4 bytes from global into shared memory that do not
// wait for their data; async_wait_all waits for all of this thread's.
__device__ __forceinline__ void copy_async16(void* shared, const void* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(address), "l"(global)
               : "memory");
}

__device__ __forceinline__ void copy_async4(void* shared, const void* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(address), "l"(global)
               : "memory");
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- K2, sums
//
// Channels of any float values (gb's Newton (g, h)): float64 sums in an
// order fixed by the rows. No lane waits on another's adds:
//   - Block (chunk, node window and feature block, tree) of kSumWarps
//     warps. The block's rows are the chunk's or, at a level of several
//     windows, the chunk's rows of its window (partition_rows_kernel lists
//     them window by window first, so a window's blocks read only its rows).
//     Warp w walks its own contiguous part of them, in order, into its own
//     copy of the window's cells; a lane owns (feature, channel) items of a
//     row (lane, lane + 32, ...), so no two lanes ever add into one cell
//     and one lane adds a cell's rows in row order. A warp stages its rows
//     128 at a time in its own shared memory (their nodes first, then their
//     bins, as 16-byte words where they fall on 16 bytes, and channels by
//     cp.async, all in flight together) and takes them one by one.
//   - A cell's partial of a chunk is its warps' row-order sums (each from
//     0) added in warp order; the chunks' partials are added in chunk
//     order (sum_partials_kernel). Windows of nodes and feature blocks are
//     blocks of one launch; windows of bins or channels, for levels whose
//     one node and feature does not fit a block, are passes. A chunk takes
//     at least 32 rows a (node, bin) of a feature, so a warp's adds
//     outnumber the cells of its copy and a deep level's partials do not
//     outgrow its rows.

// The sums path's partition of a level's rows by node window, for levels
// of several windows: block (chunk, tree) of kSumWarps warps, warp w
// counting then placing the w-th contiguous part of the chunk's rows. The
// chunk's rows go into order[chunk's first row ..] window by window, each
// window's in row order; window_begin[(tree, chunk)][window] is the first
// place of each window and [windows] the end. Rows of no window (a node
// outside the level) are left out. The (window, warp) counts sit in shared
// memory, window-major, and become their first places by a block scan.
__device__ int block_exclusive_scan(int* values, int n, int* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int per_thread = (n + blockDim.x - 1) / blockDim.x;
  const int begin = min(n, static_cast<int>(threadIdx.x) * per_thread);
  const int end = min(n, begin + per_thread);
  int sum = 0;
  for (int i = begin; i < end; ++i) sum += values[i];
  int inclusive = sum;
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int other = __shfl_up_sync(0xffffffffu, inclusive, offset);
    if (lane >= offset) inclusive += other;
  }
  if (lane == 31) scratch[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < warps ? scratch[lane] : 0;
    int running = own;
    for (int offset = 1; offset < 32; offset <<= 1) {
      const int other = __shfl_up_sync(0xffffffffu, running, offset);
      if (lane >= offset) running += other;
    }
    if (lane < warps) scratch[lane] = running - own;
    if (lane == warps - 1) scratch[32] = running;
  }
  __syncthreads();
  int place = scratch[warp] + inclusive - sum;
  for (int i = begin; i < end; ++i) {
    const int value = values[i];
    values[i] = place;
    place += value;
  }
  const int total = scratch[32];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kSumThreads) partition_rows_kernel(
    const int* __restrict__ node, int* __restrict__ order, int* __restrict__ window_begin,
    int rows, int rows_per_chunk, int n_nodes, int window_nodes, int windows) {
  extern __shared__ int counts[];  // (windows, kSumWarps)
  __shared__ int scratch[33];
  const long long tree = blockIdx.y;
  node += tree * rows;
  order += tree * rows;
  window_begin += (tree * gridDim.x + blockIdx.x) * (windows + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < windows * kSumWarps; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  const int per_warp = (row_end - row_begin + kSumWarps - 1) / kSumWarps;
  const int warp_begin = row_begin + warp * per_warp;
  const int warp_end = min(row_end, warp_begin + per_warp);
  const auto window_of = [&](int r) {
    if (r >= warp_end) return -1;
    const int nd = __ldg(node + r);
    return nd >= 0 && nd < n_nodes ? nd / window_nodes : -1;
  };
  for (int base = warp_begin; base < warp_end; base += 32) {
    const int window = window_of(base + lane);
    if (window >= 0) atomicAdd(counts + window * kSumWarps + warp, 1);
  }
  __syncthreads();
  const int total = block_exclusive_scan(counts, windows * kSumWarps, scratch);
  for (int window = threadIdx.x; window <= windows; window += blockDim.x)
    window_begin[window] =
        row_begin + (window < windows ? counts[window * kSumWarps] : total);
  const unsigned lower_lanes = (1u << lane) - 1u;
  for (int base = warp_begin; base < warp_end; base += 32) {
    const int window = window_of(base + lane);
    const unsigned group = __match_any_sync(0xffffffffu, window);
    if (window >= 0)
      order[row_begin + counts[window * kSumWarps + warp] + __popc(group & lower_lanes)] =
          base + lane;
    __syncwarp();
    if (window >= 0 && lane == __ffs(group) - 1)
      counts[window * kSumWarps + warp] += __popc(group);
    __syncwarp();
  }
}

// A warp stages kSumStageRows rows at a time, those of its window: the
// bytes of their bins (on 16 bytes), their channels of the window and
// their nodes. (ml/trees.py _sum_shared_bytes counts the same.)
constexpr int kSumStageRows = 128;

template <typename Bin>
__host__ __device__ __forceinline__ int sum_staging_bytes(int block_features, int channels) {
  return (kSumStageRows * block_features * static_cast<int>(sizeof(Bin)) + 15) / 16 * 16 +
         kSumStageRows * 4 * channels + kSumStageRows * 4;
}

// Block (chunk, node window + node_windows * feature block, tree), its
// node window `window_base` + blockIdx.y % node_windows: the
// partial histogram of the chunk's rows over `block_features` features
// and the cells of window `w` (w.nodes a window's nodes; its bins and
// channels), written into the chunk's (n_nodes, F, w.bins, w.channels)
// partials, from the tree's nodes and channels and the bins at the
// tree's offset `bins_tree_stride` (0: the trees share one bins matrix).
// Rows whose node or bin lies outside the window are skipped.
template <typename Bin>
__global__ void __launch_bounds__(kSumThreads) level_histograms_kernel(
    const Bin* __restrict__ bins, const int* __restrict__ node,
    const float* __restrict__ channels, double* __restrict__ partials,
    const int* __restrict__ order, const int* __restrict__ window_begin,
    int rows, int num_features, int num_channels, int n_nodes, Window w, int windows,
    int window_base, int node_windows, int rows_per_chunk, int block_features, int vector,
    long long bins_tree_stride) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int chunk = blockIdx.x;
  const long long tree = blockIdx.z;
  bins += tree * bins_tree_stride;
  node += tree * rows;
  channels += tree * rows * num_channels;
  const int window = window_base + blockIdx.y % node_windows;
  const int node_begin = window * w.nodes;
  const int nodes = min(w.nodes, n_nodes - node_begin);
  const int f_begin = blockIdx.y / node_windows * block_features;
  const int fb = min(block_features, num_features - f_begin);
  const int K = w.channels;
  const int copy = w.nodes * block_features * w.bins * K;  // a warp's cells
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  double* hist = reinterpret_cast<double*>(shared);
  double* mine = hist + warp * copy;
  unsigned char* staging = reinterpret_cast<unsigned char*>(hist + kSumWarps * copy) +
                           warp * sum_staging_bytes<Bin>(block_features, K);
  Bin* row_bins = reinterpret_cast<Bin*>(staging);  // (kSumStageRows, block_features)
  float* row_channels = reinterpret_cast<float*>(
      staging + (kSumStageRows * block_features * sizeof(Bin) + 15) / 16 * 16);  // (.., K)
  // a staged row's node, as the offset of its cells in the copy
  int* row_node = reinterpret_cast<int*>(row_channels + kSumStageRows * K);

  for (int i = threadIdx.x; i < kSumWarps * copy; i += blockDim.x) hist[i] = 0.0;
  __syncthreads();

  // the rows the block walks: the chunk's, or, partitioned, its window's
  // places in `order`; warp w takes the w-th contiguous part of them
  int list_begin = chunk * rows_per_chunk;
  int list_end = min(rows, list_begin + rows_per_chunk);
  if (order != nullptr) {
    order += tree * rows;
    const int* begins = window_begin + (tree * gridDim.x + chunk) * (windows + 1);
    list_begin = begins[window];
    list_end = begins[window + 1];
  }
  const int per_warp = (list_end - list_begin + kSumWarps - 1) / kSumWarps;
  const int warp_begin = list_begin + warp * per_warp;
  const int warp_end = min(list_end, warp_begin + per_warp);
  constexpr int kPerWord = 16 / sizeof(Bin);
  const int items = fb * K;  // a row's (feature, channel) items
  constexpr int kSlots = kSumStageRows / 32;
  for (int base = warp_begin; base < warp_end; base += kSumStageRows) {
    // each lane stages rows base + lane + 32 s of its window: their nodes
    // first, all in flight together, then their bins and channels copied
    // into shared memory asynchronously, also all in flight together
    int row[kSlots], nd[kSlots];
    unsigned members[kSlots];
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const int at = base + lane + 32 * slot;
      row[slot] = at < warp_end ? (order != nullptr ? __ldg(order + at) : at) : -1;
    }
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot)
      nd[slot] = row[slot] >= 0 ? __ldg(node + row[slot]) - node_begin : -1;
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const bool in_window = nd[slot] >= 0 && nd[slot] < nodes;
      members[slot] = __ballot_sync(0xffffffffu, in_window);
      if (!in_window) continue;
      const int staged_row = lane + 32 * slot;
      const int r = row[slot];
      row_node[staged_row] = nd[slot] * block_features * w.bins * K;
      for (int k = 0; k < K; ++k)
        copy_async4(row_channels + staged_row * K + k,
                    channels + static_cast<size_t>(r) * num_channels + w.channel_begin + k);
      const Bin* source = bins + static_cast<size_t>(r) * num_features + f_begin;
      if (vector) {
        for (int f0 = 0; f0 < fb; f0 += kPerWord)
          copy_async16(row_bins + staged_row * block_features + f0, source + f0);
      } else {
        for (int f = 0; f < fb; ++f)
          row_bins[staged_row * block_features + f] = __ldg(source + f);
      }
    }
    async_wait_all();
    __syncwarp();
    // a lane's items (feature f, channel k) are cells no other lane adds
    // into, so each walks the staged rows in order on its own: two rows at
    // a time, their adds into two cells side by side, into one cell one
    // after the other. No cell (null) when the bin lies outside the window
    // or the value is 0 (an add of 0 never changes a sum that starts at +0).
    for (int item = lane; item < items; item += 32) {
      const int f = item / K, k = item % K;
      double* cells = mine + f * w.bins * K + k;
      const Bin* item_bins = row_bins + f;
      const float* item_channels = row_channels + k;
#pragma unroll 1
      for (int slot = 0; slot < kSlots; ++slot) {
        for (unsigned left = members[slot]; left != 0u;) {
          const int m1 = __ffs(left) - 1 + 32 * slot;
          left &= left - 1;
          const int m2 = left != 0u ? __ffs(left) - 1 + 32 * slot : m1;
          if (left != 0u) left &= left - 1;
          const int b1 = static_cast<int>(item_bins[m1 * block_features]) - w.bin_begin;
          const int b2 = static_cast<int>(item_bins[m2 * block_features]) - w.bin_begin;
          const float value1 = item_channels[m1 * K];
          const float value2 = m2 != m1 ? item_channels[m2 * K] : 0.0f;
          double* cell1 = b1 >= 0 && b1 < w.bins && value1 != 0.0f
                              ? cells + row_node[m1] + b1 * K : nullptr;
          double* cell2 = b2 >= 0 && b2 < w.bins && value2 != 0.0f
                              ? cells + row_node[m2] + b2 * K : nullptr;
          if (cell1 != nullptr && cell1 == cell2) {
            *cell1 = __dadd_rn(__dadd_rn(*cell1, value1), value2);
          } else {
            const double sum1 = cell1 != nullptr ? *cell1 : 0.0;
            const double sum2 = cell2 != nullptr ? *cell2 : 0.0;
            if (cell1 != nullptr) *cell1 = __dadd_rn(sum1, value1);
            if (cell2 != nullptr) *cell2 = __dadd_rn(sum2, value2);
          }
        }
      }
    }
    __syncwarp();  // the staged rows are read before the next ones land
  }
  __syncthreads();
  double* out = partials + (tree * gridDim.x + chunk) * n_nodes * num_features * w.bins * K;
  const int cells = nodes * fb * w.bins * K;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int k = i % K;
    int rest = i / K;
    const int b = rest % w.bins;
    rest /= w.bins;
    const int f = rest % fb;
    const int nd = rest / fb;
    const int at = ((nd * block_features + f) * w.bins + b) * K + k;
    double sum = hist[at];
    for (int other = 1; other < kSumWarps; ++other) sum = __dadd_rn(sum, hist[other * copy + at]);
    out[((static_cast<size_t>(node_begin + nd) * num_features + f_begin + f) * w.bins + b) * K +
        k] = sum;
  }
}

// ------------------------------------------------------------------ K5
//
// Per-leaf channel sums (ml/trees.py:142 `_leaf_sums`): a tree's rows
// read once (leaf and channels: 12 MB at the default fit), its L x K sums
// written once. Two paths behind one wrapper, as K2's:
//   - Counts (dt's, the forest's and a sweep's integer channels, the
//     caller's claim, checked as K2 checks it): block (chunk, tree), a
//     warp 32 consecutive rows at a time, four such steps in flight (a
//     row's leaf and channels coalesced), each nonzero channel added into
//     the block's 32-bit counts in shared memory with an integer atomic.
//     (Grouping a warp's lanes by cell first, __match_any_sync then
//     __reduce_add_sync, was slower on an H100: the match costs more than
//     the shared atomics' conflicts it saves.) The block then adds each
//     cell it touched into the call's counts in global memory with one
//     integer atomic: exact in any order. Where a chunk's counts would
//     leave the card few chunks (4,096 leaves x 10 classes: 160 KB a
//     block, 16 chunks), every block counts straight into global memory
//     (ml/trees.py _leaf_count_tiling).
//   - Sums (gb's float (g, h)): block (chunk, tree) of 32 warps, each with
//     its own float64 copy of the cells; a warp reads 32 consecutive rows
//     (leaf and channels coalesced), and the lanes of one leaf (a
//     __match_any_sync group) add their rows in lane order by shuffles,
//     so every lane of a group holds the group's sum and one adds it into
//     the warp's copy. The warps' copies are added in warp order into the
//     chunk's float64 partials.
//   - One launch a call. The last block of a tree to finish (a ticket
//     taken after __threadfence) writes the tree's float32 results: the
//     counts rounded once, or the chunks' partials added in a fixed order
//     (consecutive chunks in chunk order by one thread, then those
//     segments in segment order; a function of the shape alone). The
//     counts and the tickets live in a scratch the wrapper keeps zeroed
//     (kernels.zeroed_scratch): the last block reads its tree's
//     counts and zeroes them, and resets its ticket, so no memset runs.
//     Sums past one block's partials (chunks x cells over
//     trees._LEAF_FUSE_VALUES) or past its shared memory (windows of
//     leaves or channels) take a second kernel, sum_partials_kernel, in
//     chunk order.
constexpr int kLeafCountThreads = 512;
constexpr int kLeafCountSteps = 4;     // rows a thread has in flight
constexpr int kLeafWarps = 32;         // the sums path's warps a block (ml/trees.py _LEAF_WARPS)

// Is this block the last of `blocks` to finish? Its writes are made
// visible first (__threadfence), the ticket taken by one thread; the last
// block then reads the others' with __ldcg (L2, not a stale L1).
__device__ __forceinline__ bool last_block(unsigned* __restrict__ ticket, unsigned blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Block (chunk, tree) of the counts path: counts (T, L, K) and tickets
// (T) in the zeroed scratch, out (T, L, K). `kShared`: the block counts in
// shared memory (L x K fit it), else straight into the scratch.
template <bool kShared>
__global__ void __launch_bounds__(kLeafCountThreads) leaf_counts_kernel(
    const int* __restrict__ leaf, const float* __restrict__ channels,
    unsigned* __restrict__ counts, unsigned* __restrict__ tickets, float* __restrict__ out,
    int rows, int n_leaves, int num_channels, int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char shared[];
  unsigned* hist = reinterpret_cast<unsigned*>(shared);  // (leaf, channel)
  const long long tree = blockIdx.y;
  const int K = num_channels;
  const int cells = n_leaves * K;
  leaf += tree * rows;
  channels += tree * rows * K;
  counts += tree * cells;
  out += tree * cells;
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
  }
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  for (int base = row_begin; base < row_end; base += kLeafCountSteps * kLeafCountThreads) {
    int l[kLeafCountSteps];
#pragma unroll
    for (int s = 0; s < kLeafCountSteps; ++s) {
      const int r = base + s * kLeafCountThreads + threadIdx.x;
      l[s] = r < row_end ? __ldg(leaf + r) : -1;
      if (l[s] >= n_leaves) l[s] = -1;
    }
    for (int k = 0; k < K; ++k) {
      float v[kLeafCountSteps];
#pragma unroll
      for (int s = 0; s < kLeafCountSteps; ++s) {
        const int r = base + s * kLeafCountThreads + threadIdx.x;
        v[s] = r < row_end ? __ldg(channels + static_cast<size_t>(r) * K + k) : 0.0f;
      }
#pragma unroll
      for (int s = 0; s < kLeafCountSteps; ++s) {
        const unsigned value = count_of(v[s], "lo_leaf_counts");
        if (l[s] < 0 || value == 0u) continue;
        if (kShared)
          atomicAdd(hist + l[s] * K + k, value);
        else
          add_count(counts + l[s] * K + k, value, "lo_leaf_counts");
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const unsigned value = hist[i];
      if (value != 0u) add_count(counts + i, value, "lo_leaf_counts");
    }
  }
  if (!last_block(tickets + tree, gridDim.x)) return;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    out[i] = __uint2float_rn(__ldcg(counts + i));
    counts[i] = 0u;
  }
  if (threadIdx.x == 0) tickets[tree] = 0u;
}

// The float64 sum, in lane order, of `value` over the lanes of `group`
// (this lane's __match_any_sync group): every lane of the group gets the
// same bits. `members`: the largest group of the warp (the loop is warp
// uniform, as the shuffles need).
__device__ __forceinline__ double group_sum(float value, unsigned group, int members) {
  double sum = 0.0;
  unsigned rest = group;
  for (int j = 0; j < members; ++j) {
    const float member = __shfl_sync(0xffffffffu, value, rest != 0u ? __ffs(rest) - 1 : 0);
    if (rest != 0u) sum = __dadd_rn(sum, static_cast<double>(member));
    rest &= rest - 1u;
  }
  return sum;
}

// Block (chunk, tree) of the sums path over the (leaf, channel) cells of
// window `w`: the chunk's float64 partials at partials[tree][chunk] (the
// window's cells); with `kFused`, the tree's last block also writes its
// float32 sums into out (T, n_leaves, num_channels) and resets its ticket.
template <bool kFused>
__global__ void __launch_bounds__(32 * kLeafWarps) leaf_sums_kernel(
    const int* __restrict__ leaf, const float* __restrict__ channels,
    double* __restrict__ partials, unsigned* __restrict__ tickets, float* __restrict__ out,
    int rows, int num_channels, Window w, int rows_per_chunk) {
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
      const int l = __ldg(leaf + r) - w.node_begin;
      if (l >= 0 && l < w.nodes) key = l;
    }
    const unsigned group = __match_any_sync(0xffffffffu, key);
    const int members = __reduce_max_sync(0xffffffffu, key >= 0 ? __popc(group) : 0);
    const bool leader = key >= 0 && lane == __ffs(group) - 1;
    for (int k = 0; k < K; ++k) {
      // loaded with the leaf, not after it
      const float value =
          r < warp_end ? __ldg(channels + static_cast<size_t>(r) * num_channels + w.channel_begin + k)
                       : 0.0f;
      const double sum = group_sum(value, group, members);
      if (leader) mine[key * K + k] = __dadd_rn(mine[key * K + k], sum);
    }
  }
  __syncthreads();
  const int chunks = gridDim.x;
  double* chunk_partials = partials + (tree * chunks + blockIdx.x) * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    double sum = sums[i];
    for (int other = 1; other < warps; ++other) sum = __dadd_rn(sum, sums[other * cells + i]);
    chunk_partials[i] = sum;
  }
  if (!kFused || !last_block(tickets + tree, chunks)) return;
  // segments of consecutive chunks, each added in chunk order by one
  // thread, then the segments in order: as many segments as the block's
  // threads give each cell, at most one a warp (their sums fit `sums`)
  const double* tree_partials = partials + tree * chunks * cells;
  const int wanted = max(1, min(warps, min(chunks, static_cast<int>(blockDim.x) / cells)));
  const int per_segment = (chunks + wanted - 1) / wanted;
  const int segments = (chunks + per_segment - 1) / per_segment;
  __syncthreads();  // `sums` is reused for the segments' sums
  for (int i = threadIdx.x; i < segments * cells; i += blockDim.x) {
    const int s = i / cells, cell = i - s * cells;
    const int first = s * per_segment, last = min(chunks, first + per_segment);
    double sum = 0.0;
    for (int c = first; c < last; ++c)
      sum = __dadd_rn(sum, __ldcg(tree_partials + static_cast<size_t>(c) * cells + cell));
    sums[i] = sum;
  }
  __syncthreads();
  out += tree * static_cast<long long>(w.nodes) * num_channels;
  for (int cell = threadIdx.x; cell < cells; cell += blockDim.x) {
    double sum = sums[cell];
    for (int s = 1; s < segments; ++s) sum = __dadd_rn(sum, sums[s * cells + cell]);
    out[cell] = __double2float_rn(sum);
  }
  if (threadIdx.x == 0) tickets[tree] = 0u;
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

// Bound by latency: a node's histogram is a few KB (F x B x K floats) and
// its work a few hundred operations a cell. Block: `block_nodes` nodes of
// `node_threads` threads each (a multiple of 32: no warp spans two
// nodes), one node's phases, a barrier apart:
//   1. Stage. The node's histogram of a window of features, read from
//      global memory as float4 words where its rows fall on 16 bytes,
//      goes into shared memory bin-major: bin b of (feature f, channel k)
//      at b * row + f * K + k, `row` = wf * K made odd, so that lanes of
//      consecutive features or consecutive bins hit distinct banks. (A
//      forest's node scores are staged once, before the first window.)
//   2. Cumulative sums. A thread a (feature, channel) walks the bins in
//      order and overwrites each with its running sum: _cumsum_bins'
//      sequence of float32 adds. The last bin holds the feature's totals.
//   3. Parents. A thread a feature: the parent term from its totals, and
//      the feature-subset test against the staged scores.
//   4. Gains. A thread a (feature, bin) cell, in bin-major order: the
//      cell's gain in the reference's order (__fmul_rn, __fadd_rn,
//      __fsub_rn, __fdiv_rn, channels from 0 to K - 1), the divisions of
//      the cells side by side; each thread keeps its first maximum.
//   5. Argmax. Warp shuffles, then the node's warps in order, under
//      `better`: a total order (NaN first, then the larger value, then
//      the lower index), so the order of the reduction cannot show.
// A node whose histogram passes shared memory is taken in windows of
// features (ml/trees.py _k3_geometry), each thread's best carried from one
// window to the next; past one feature's bins, the stage lies in global
// scratch (`global_stage`), laid out the same.
constexpr int kSplitThreads = 512;

template <bool kShared>
__global__ void __launch_bounds__(kSplitThreads)
    select_splits_kernel(const float* __restrict__ hist,
                         const float* __restrict__ subset_scores, int subset_k,
                         int* __restrict__ feature_out, int* __restrict__ bin_out,
                         float* __restrict__ global_stage, int n_nodes, int num_features,
                         int max_bins, int num_channels, int mode, int node_threads,
                         int block_nodes, int window_features) {
  extern __shared__ __align__(16) float split_shared[];
  const int F = num_features, B = max_bins, K = num_channels;
  const int slot = threadIdx.x / node_threads;
  const int tid = threadIdx.x - slot * node_threads;
  const long long node = static_cast<long long>(blockIdx.x) * block_nodes + slot;
  const bool active = node < n_nodes;
  const int row = window_features * K | 1;  // odd: see the stage above
  const int stage_floats = B * row;
  // shared memory: [stages], parents, candidates, scores, each warp's best
  float* arrays = split_shared + (kShared ? block_nodes * stage_floats : 0);
  float* stage = kShared ? split_shared + slot * stage_floats
                         : global_stage + (active ? node : 0) * stage_floats;
  float* parent = arrays + slot * window_features;
  int* candidate = reinterpret_cast<int*>(arrays + block_nodes * window_features) +
                   slot * window_features;
  float* node_scores = arrays + 2 * block_nodes * window_features + slot * F;
  float* warp_value = arrays + block_nodes * (2 * window_features + F);
  int* warp_index = reinterpret_cast<int*>(warp_value + blockDim.x / 32);
  const float* node_hist = hist + (active ? node : 0) * F * B * K;
  const float* scores =
      subset_scores == nullptr ? nullptr : subset_scores + (active ? node : 0) * F;
  const bool vector = (B * K) % 4 == 0 && reinterpret_cast<uintptr_t>(hist) % 16 == 0;

  if (active && scores != nullptr)  // read after the first window's barrier
    for (int f = tid; f < F; f += node_threads) node_scores[f] = __ldg(scores + f);
  float best_value = -INFINITY;
  int best_index = 0x7fffffff;
  for (int f0 = 0; f0 < F; f0 += window_features) {
    const int wf = min(window_features, F - f0);
    if (f0 > 0) __syncthreads();  // the previous window's gains are done
    if (active) {
      const float* source = node_hist + static_cast<size_t>(f0) * B * K;
      const int count = wf * B * K;
      if (vector) {
        for (int q = tid; q < count / 4; q += node_threads) {
          const float4 word = __ldg(reinterpret_cast<const float4*>(source) + q);
          const float values[4] = {word.x, word.y, word.z, word.w};
          int k = 4 * q % K, rest = 4 * q / K;
          int b = rest % B, f = rest / B;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            stage[b * row + f * K + k] = values[e];
            if (++k == K) {
              k = 0;
              if (++b == B) {
                b = 0;
                ++f;
              }
            }
          }
        }
      } else {
        for (int i = tid; i < count; i += node_threads) {
          const int k = i % K, rest = i / K;
          stage[rest % B * row + rest / B * K + k] = __ldg(source + i);
        }
      }
    }
    __syncthreads();
    if (active) {
      // a (feature, channel) column: bin b at column[b * row]
      for (int item = tid; item < wf * K; item += node_threads) {
        float* column = stage + item;
        float sum = column[0];
        int b = 1;
        for (; b + 8 <= B; b += 8) {
          float value[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) value[i] = column[(b + i) * row];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            sum = __fadd_rn(sum, value[i]);
            column[(b + i) * row] = sum;
          }
        }
        for (; b < B; ++b) {
          sum = __fadd_rn(sum, column[b * row]);
          column[b * row] = sum;
        }
      }
    }
    __syncthreads();
    if (active) {
      for (int f = tid; f < wf; f += node_threads) {
        candidate[f] = scores == nullptr || in_subset(node_scores, F, subset_k, f0 + f);
        const float* total = stage + (B - 1) * row + f * K;
        if (mode == kGini) {
          float n = 0.0f, squares = 0.0f;
          for (int k = 0; k < K; ++k) {
            n = __fadd_rn(n, total[k]);
            squares = __fadd_rn(squares, __fmul_rn(total[k], total[k]));
          }
          parent[f] = __fdiv_rn(squares, floor_eps(n));
        } else {
          parent[f] = __fdiv_rn(__fmul_rn(total[0], total[0]), __fadd_rn(total[1], 1.0f));
        }
      }
    }
    __syncthreads();
    if (active) {
      for (int cell = tid; cell < wf * B; cell += node_threads) {
        const int b = cell / wf, f = cell - b * wf;
        const int index = (f0 + f) * B + b;
        float gain = -INFINITY;
        if (candidate[f]) {
          const float* left = stage + b * row + f * K;
          const float* total = stage + (B - 1) * row + f * K;
          bool valid;
          if (mode == kGini) {
            float n_left = 0.0f, n_right = 0.0f, sq_left = 0.0f, sq_right = 0.0f;
            for (int k = 0; k < K; ++k) {
              const float l = left[k];
              const float r = __fsub_rn(total[k], l);
              n_left = __fadd_rn(n_left, l);
              n_right = __fadd_rn(n_right, r);
              sq_left = __fadd_rn(sq_left, __fmul_rn(l, l));
              sq_right = __fadd_rn(sq_right, __fmul_rn(r, r));
            }
            valid = n_left > 0.0f && n_right > 0.0f;
            gain = __fsub_rn(__fadd_rn(__fdiv_rn(sq_left, floor_eps(n_left)),
                                       __fdiv_rn(sq_right, floor_eps(n_right))),
                             parent[f]);
          } else {
            const float g_left = left[0], h_left = left[1];
            const float g_right = __fsub_rn(total[0], g_left);
            const float h_right = __fsub_rn(total[1], h_left);
            valid = h_left > kEps && h_right > kEps;
            const float score = __fadd_rn(
                __fdiv_rn(__fmul_rn(g_left, g_left), __fadd_rn(h_left, 1.0f)),
                __fdiv_rn(__fmul_rn(g_right, g_right), __fadd_rn(h_right, 1.0f)));
            gain = __fsub_rn(score, parent[f]);
          }
          if (!valid) gain = -INFINITY;
        }
        if (better(best_value, best_index, gain, index)) {
          best_value = gain;
          best_index = index;
        }
      }
    }
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float value = __shfl_down_sync(0xffffffffu, best_value, offset);
    const int index = __shfl_down_sync(0xffffffffu, best_index, offset);
    if (better(best_value, best_index, value, index)) {
      best_value = value;
      best_index = index;
    }
  }
  if (threadIdx.x % 32 == 0) {
    warp_value[threadIdx.x / 32] = best_value;
    warp_index[threadIdx.x / 32] = best_index;
  }
  __syncthreads();
  if (active && tid == 0) {
    const int first = threadIdx.x / 32, warps = node_threads / 32;
    float gain = warp_value[first];
    int index = warp_index[first];
    for (int w = first + 1; w < first + warps; ++w) {
      if (better(gain, index, warp_value[w], warp_index[w])) {
        gain = warp_value[w];
        index = warp_index[w];
      }
    }
    const bool is_leaf = !(gain > 0.0f) || isinf(gain);
    feature_out[node] = is_leaf ? -1 : index / max_bins;
    bin_out[node] = index % max_bins;
  }
}

// ------------------------------------------------------------------ K4
//
// Each row one level down its tree (ml/trees.py:235 `_route`): node' =
// 2 node + (the row's bin of the node's feature > the node's split bin),
// left where the node does not split (feature -1). Bound by bytes: each
// tree's node read and written once (8 MB at 1,000,000 rows), one bin of
// each split row. A bin gathered from an int8 row of 16 still moves its
// 32-byte sector, so a level whose rows all split moves the whole bins
// matrix (16 MB): the sector floor, ~0.0072 ms for one tree.
//   - Block (row tiles, tree group): the group's splits staged once in
//     shared memory, one int2 (feature, split bin) a node, in place of two
//     global loads a row; a group whose splits pass its share reads them
//     from global memory (ml/trees.py _route_geometry).
//   - A thread takes a row: its bins as one to four 16-byte words where a
//     row is at most 64 bytes and falls on 16 bytes (the bin is picked in
//     registers, as K2's for_row_bins does), else the one bin a tree
//     needs, gathered.
//   - Trees that share one bins matrix (bins_tree_stride 0: the forest;
//     any stride-0 caller) go in groups: a thread routes its row down
//     every tree of its group from one read of the row's bins, each tree's
//     node read and node_out written coalesced along rows, four trees'
//     nodes in flight together. Trees with their own bins (a sweep's jobs)
//     form groups of one, through the same loop.
//   - A row's words load with its nodes, neither waiting on the other,
//     also where no tree of the group splits the row: such a row mostly
//     shares its 32-byte sector with rows that need theirs, and loading
//     the words only once a node splits (a second round trip) was slower
//     at every level measured, three in four leaf nodes included
//     (tree_fit_variants.py, PERF.md section 6). A gathered bin is read
//     only for a split.
//   - As many blocks as the card holds at once (the occupancy API).
constexpr int kRouteThreads = 256;
constexpr int kRouteTreeBatch = 4;  // trees' nodes a thread has in flight

// Bin `f` of a row held as `kWords` 16-byte words.
template <typename Bin, int kWords>
__device__ __forceinline__ int word_bin(const uint4 (&words)[kWords > 0 ? kWords : 1], int f) {
  constexpr int kPerWord = 16 / sizeof(Bin);
  const int q = f / kPerWord;
  uint4 word = words[0];
#pragma unroll
  for (int i = 1; i < kWords; ++i)
    if (q == i) word = words[i];
  return bin_at(word, f - q * kPerWord, Bin());
}

template <int kWords>
__device__ __forceinline__ void load_words(uint4 (&words)[kWords > 0 ? kWords : 1], const void* row) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) words[i] = __ldg(reinterpret_cast<const uint4*>(row) + i);
}

// Tree t's (feature, split bin) of node nd: (-1, 0) for a node outside
// the level.
template <bool kStaged>
__device__ __forceinline__ int2 split_of(const int2* __restrict__ splits,
                                         const int* __restrict__ feature,
                                         const int* __restrict__ split_bin, int t, int n_nodes,
                                         int nd) {
  if (nd < 0 || nd >= n_nodes) return make_int2(-1, 0);
  if (kStaged) return splits[t * n_nodes + nd];
  const long long at = static_cast<long long>(t) * n_nodes + nd;
  return make_int2(__ldg(feature + at), __ldg(split_bin + at));
}

// node' = 2 node + (x_bin > split bin), left where the node does not split
__device__ __forceinline__ int routed(int nd, int2 split, int x_bin) {
  return 2 * nd + (x_bin > split.y && split.x >= 0 ? 1 : 0);
}

// Block (row tiles, tree group): trees [group * blockIdx.y, + group) of
// `trees`; node, node_out (T, rows); feature, split_bin (T, n_nodes);
// the bins (rows, F) of tree t at t * bins_tree_stride (0: shared; a
// group of one tree when not). kWords: a row's 16-byte words (0: gather
// one bin a tree); kStaged: the group's splits in shared memory.
template <typename Bin, int kWords, bool kStaged>
__global__ void __launch_bounds__(kRouteThreads) route_kernel(
    const Bin* __restrict__ bins, const int* __restrict__ node, const int* __restrict__ feature,
    const int* __restrict__ split_bin, int* __restrict__ node_out, int rows, int num_features,
    int n_nodes, int trees, int group, long long bins_tree_stride) {
  extern __shared__ __align__(16) int2 splits[];  // [tree of the group][node]
  constexpr int W = kWords > 0 ? kWords : 1;
  const int t0 = blockIdx.y * group;
  const int group_trees = min(group, trees - t0);
  const int F = num_features;
  bins += t0 * bins_tree_stride;
  node += static_cast<long long>(t0) * rows;
  node_out += static_cast<long long>(t0) * rows;
  feature += static_cast<long long>(t0) * n_nodes;
  split_bin += static_cast<long long>(t0) * n_nodes;
  if (kStaged) {
    for (int i = threadIdx.x; i < group_trees * n_nodes; i += blockDim.x)
      splits[i] = make_int2(__ldg(feature + i), __ldg(split_bin + i));
    __syncthreads();
  }
  // a row's bins read once for every tree of the group, with its nodes;
  // kRouteTreeBatch trees' nodes in flight
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < rows;
       row += gridDim.x * blockDim.x) {
    const Bin* row_bins = bins + static_cast<size_t>(row) * F;
    uint4 words[W];
    if (kWords > 0) load_words<kWords>(words, row_bins);
    for (int b = 0; b < group_trees; b += kRouteTreeBatch) {
      int nd[kRouteTreeBatch];
#pragma unroll
      for (int j = 0; j < kRouteTreeBatch; ++j)
        nd[j] = b + j < group_trees ? __ldg(node + static_cast<long long>(b + j) * rows + row) : -1;
#pragma unroll
      for (int j = 0; j < kRouteTreeBatch; ++j) {
        const int t = b + j;
        if (t >= group_trees) break;
        const int2 split = split_of<kStaged>(splits, feature, split_bin, t, n_nodes, nd[j]);
        const int f = split.x;
        int x_bin = 0;
        if (f >= 0 && f < F)
          x_bin = kWords > 0 ? word_bin<Bin, kWords>(words, f)
                             : static_cast<int>(__ldg(row_bins + f));
        node_out[static_cast<long long>(t) * rows + row] = routed(nd[j], split, x_bin);
      }
    }
  }
}

int grid_for(long long items, int max_blocks) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < max_blocks ? blocks : max_blocks);
}

// The most blocks a launch may have along grid dimensions y and z: trees
// (or jobs) past it go in groups of launches.
constexpr int kMaxGridYZ = 65535;

template <typename In, typename Bin, bool kStaged, int kSteps>
cudaError_t launch_apply_bins_as(const In* X, const float* thresholds, void* bins, int rows,
                                 int num_features, int num_thresholds, int steps, int jobs,
                                 int group, int window_features, long long x_job_stride,
                                 long long thresholds_job_stride, cudaStream_t stream) {
  const auto kernel = apply_bins_kernel<In, Bin, kStaged, kSteps>;
  constexpr int kPerWord = 16 / sizeof(Bin);
  // a word of X: 4 floats, or 8 bfloat16 values
  constexpr int kXWord = 16 / sizeof(In);
  const int vector_x = num_features % kXWord == 0 && window_features % kXWord == 0 &&
                       reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                       x_job_stride % kXWord == 0;
  const int vector_bins = (num_features * sizeof(Bin)) % 16 == 0 &&
                          window_features % kPerWord == 0 &&
                          reinterpret_cast<uintptr_t>(bins) % 16 == 0;
  const size_t shared_bytes =
      kStaged ? sizeof(float) * static_cast<size_t>(group) * window_features * (1 << steps) : 0;
  cudaError_t error = allow_shared(kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  // as many blocks as are resident at once: no second, partial wave
  int device = 0, sms = 0, per_sm = 0;
  if ((error = cudaGetDevice(&device)) != cudaSuccess) return error;
  if ((error = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return error;
  error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBinThreads, shared_bytes);
  if (error != cudaSuccess) return error;
  const int groups = (jobs + group - 1) / group;
  const int tiles = (rows + kBinThreads - 1) / kBinThreads;
  const int tile_blocks = std::max(1, std::min(tiles, std::max(1, per_sm) * sms / groups));
  if (static_cast<long long>(groups) * tile_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<groups * tile_blocks, kBinThreads, shared_bytes, stream>>>(
      X, thresholds, static_cast<Bin*>(bins), rows, num_features, num_thresholds, steps, jobs,
      group, window_features, x_job_stride, thresholds_job_stride, vector_x, vector_bins);
  return cudaGetLastError();
}

// The search unrolled at 32 and 256 entries a row (32 and 255 bins).
template <typename In, typename Bin, bool kStaged>
cudaError_t launch_apply_bins(const In* X, const float* thresholds, void* bins, int rows,
                              int num_features, int num_thresholds, int steps, int jobs,
                              int group, int window_features, long long x_job_stride,
                              long long thresholds_job_stride, cudaStream_t stream) {
  const auto launch = steps == 5   ? launch_apply_bins_as<In, Bin, kStaged, 5>
                      : steps == 8 ? launch_apply_bins_as<In, Bin, kStaged, 8>
                                   : launch_apply_bins_as<In, Bin, kStaged, 0>;
  return launch(X, thresholds, bins, rows, num_features, num_thresholds, steps, jobs, group,
                window_features, x_job_stride, thresholds_job_stride, stream);
}

// K2's sums path, one pass per window of bins and channels: the
// histogram kernel over every node window, feature block and tree, then
// the sum of each tree's chunk partials into the window's cells of `out`.
// `vector`: the bins are staged as 16-byte words.
template <typename Bin>
cudaError_t launch_level_histograms(
    const void* bins, const int* node, const float* channels,
    double* partials, int* order, int* window_begin, float* out, int rows,
    int num_features, int n_nodes,
    int max_bins, int num_channels, int trees, long long bins_tree_stride,
    int chunks, int rows_per_chunk, int window_nodes, int window_bins,
    int window_channels, int block_features, int max_blocks,
    cudaStream_t stream) {
  const size_t shared_bytes =
      kSumWarps * (sizeof(double) * static_cast<size_t>(window_nodes) * block_features *
                       window_bins * window_channels +
                   sum_staging_bytes<Bin>(block_features, window_channels));
  cudaError_t error = allow_shared(level_histograms_kernel<Bin>, shared_bytes);
  if (error != cudaSuccess) return error;
  const int node_windows = (n_nodes + window_nodes - 1) / window_nodes;
  const int feature_blocks = (num_features + block_features - 1) / block_features;
  // node windows past grid dimension y go in launches of their own
  const int windows_a_launch = kMaxGridYZ / feature_blocks;
  if (windows_a_launch < 1) return cudaErrorInvalidValue;
  constexpr int kPerWord = 16 / sizeof(Bin);
  const int vector = num_features % kPerWord == 0 && block_features % kPerWord == 0 &&
                     reinterpret_cast<uintptr_t>(bins) % 16 == 0 &&
                     (bins_tree_stride * sizeof(Bin)) % 16 == 0;
  const long long out_tree_stride =
      static_cast<long long>(n_nodes) * num_features * max_bins * num_channels;
  if (order != nullptr) {
    const size_t counts_bytes = sizeof(int) * static_cast<size_t>(node_windows) * kSumWarps;
    error = allow_shared(partition_rows_kernel, counts_bytes);
    if (error != cudaSuccess) return error;
    for (int t0 = 0; t0 < trees; t0 += kMaxGridYZ) {
      const int group = std::min(kMaxGridYZ, trees - t0);
      partition_rows_kernel<<<dim3(chunks, group), kSumThreads, counts_bytes, stream>>>(
          node + static_cast<long long>(t0) * rows, order + static_cast<long long>(t0) * rows,
          window_begin + static_cast<long long>(t0) * chunks * (node_windows + 1), rows,
          rows_per_chunk, n_nodes, window_nodes, node_windows);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
  }
  for (int b0 = 0; b0 < max_bins; b0 += window_bins) {
    for (int k0 = 0; k0 < num_channels; k0 += window_channels) {
      const Window w{0, window_nodes, b0, std::min(window_bins, max_bins - b0),
                     k0, std::min(window_channels, num_channels - k0)};
      const long long cells = static_cast<long long>(n_nodes) * num_features *
                              w.bins * w.channels;
      for (int t0 = 0; t0 < trees; t0 += kMaxGridYZ) {
        const int group = std::min(kMaxGridYZ, trees - t0);
        double* group_partials = partials + static_cast<long long>(t0) * chunks * cells;
        for (int nw0 = 0; nw0 < node_windows; nw0 += windows_a_launch) {
          const int launch_windows = std::min(windows_a_launch, node_windows - nw0);
          level_histograms_kernel<Bin>
              <<<dim3(chunks, launch_windows * feature_blocks, group), kSumThreads, shared_bytes,
                 stream>>>(
                  static_cast<const Bin*>(bins) + t0 * bins_tree_stride,
                  node + static_cast<long long>(t0) * rows,
                  channels + static_cast<long long>(t0) * rows * num_channels,
                  group_partials,
                  order == nullptr ? nullptr : order + static_cast<long long>(t0) * rows,
                  order == nullptr ? nullptr
                                   : window_begin + static_cast<long long>(t0) * chunks *
                                                        (node_windows + 1),
                  rows, num_features, num_channels, n_nodes, w, node_windows, nw0,
                  launch_windows, rows_per_chunk, block_features, vector, bins_tree_stride);
          error = cudaGetLastError();
          if (error != cudaSuccess) return error;
        }
        const Window whole{0, n_nodes, w.bin_begin, w.bins, w.channel_begin, w.channels};
        sum_partials_kernel<<<dim3(grid_for(cells, max_blocks), group), kThreads,
                              0, stream>>>(
            group_partials, out + t0 * out_tree_stride, chunks, cells,
            out_tree_stride, whole, num_features, max_bins, num_channels);
        error = cudaGetLastError();
        if (error != cudaSuccess) return error;
      }
    }
  }
  return cudaSuccess;
}

// K2's counts path: zero the output's bytes, add the counts (in shared
// memory a block when `in_shared`, else straight into the output), and
// round them to float32 in place.
template <typename Bin>
cudaError_t launch_level_counts(const void* bins, const int* node,
                                const float* channels, float* out, int rows,
                                int num_features, int n_nodes, int max_bins,
                                int num_channels, int trees,
                                long long bins_tree_stride, int chunks,
                                int rows_per_chunk, int block_features,
                                int in_shared, int max_blocks,
                                cudaStream_t stream) {
  const long long cells =
      static_cast<long long>(trees) * n_nodes * num_features * max_bins * num_channels;
  cudaError_t error = cudaMemsetAsync(out, 0, sizeof(float) * cells, stream);
  if (error != cudaSuccess) return error;
  const auto kernel = in_shared ? level_counts_kernel<Bin, true> : level_counts_kernel<Bin, false>;
  const size_t shared_bytes =
      in_shared ? sizeof(unsigned) * static_cast<size_t>(n_nodes) * block_features *
                      max_bins * num_channels
                : 0;
  error = allow_shared(kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  const int feature_blocks = (num_features + block_features - 1) / block_features;
  constexpr int kPerWord = 16 / sizeof(Bin);
  const int vector = num_features % kPerWord == 0 && block_features % kPerWord == 0 &&
                     reinterpret_cast<uintptr_t>(bins) % 16 == 0 &&
                     (bins_tree_stride * sizeof(Bin)) % 16 == 0;
  const long long out_tree_stride =
      static_cast<long long>(n_nodes) * num_features * max_bins * num_channels;
  for (int t0 = 0; t0 < trees; t0 += kMaxGridYZ) {
    const int group = std::min(kMaxGridYZ, trees - t0);
    kernel<<<dim3(chunks, feature_blocks, group), kCountThreads, shared_bytes, stream>>>(
        static_cast<const Bin*>(bins) + t0 * bins_tree_stride,
        node + static_cast<long long>(t0) * rows,
        channels + static_cast<long long>(t0) * rows * num_channels,
        reinterpret_cast<unsigned*>(out + t0 * out_tree_stride), rows, num_features,
        n_nodes, max_bins, num_channels, rows_per_chunk, block_features, vector,
        bins_tree_stride);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  counts_to_float_kernel<<<grid_for(cells, max_blocks), kThreads, 0, stream>>>(out, cells);
  return cudaGetLastError();
}

// K4 over tree groups of `group` trees (1 when each tree has its own
// bins), as many blocks as the card holds at once; groups past grid
// dimension y go in launches of their own.
template <typename Bin, int kWords, bool kStaged>
cudaError_t launch_route_as(const void* bins, const int* node, const int* feature,
                            const int* split_bin, int* node_out, int rows, int num_features,
                            int trees, int n_nodes, int group, long long bins_tree_stride,
                            cudaStream_t stream) {
  const auto kernel = route_kernel<Bin, kWords, kStaged>;
  const size_t shared_bytes = kStaged ? sizeof(int2) * static_cast<size_t>(group) * n_nodes : 0;
  cudaError_t error = allow_shared(kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  int device = 0, sms = 0, per_sm = 0;
  if ((error = cudaGetDevice(&device)) != cudaSuccess) return error;
  if ((error = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return error;
  error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRouteThreads, shared_bytes);
  if (error != cudaSuccess) return error;
  const int groups = (trees + group - 1) / group;
  const long long tiles = (rows + kRouteThreads - 1) / kRouteThreads;
  for (int g0 = 0; g0 < groups; g0 += kMaxGridYZ) {
    const int launch_groups = std::min(kMaxGridYZ, groups - g0);
    const long long t0 = static_cast<long long>(g0) * group;
    const int blocks = static_cast<int>(
        std::max(1LL, std::min(tiles, static_cast<long long>(std::max(1, per_sm)) * sms / launch_groups)));
    kernel<<<dim3(blocks, launch_groups), kRouteThreads, shared_bytes, stream>>>(
        static_cast<const Bin*>(bins) + t0 * bins_tree_stride, node + t0 * rows,
        feature + t0 * n_nodes, split_bin + t0 * n_nodes, node_out + t0 * rows, rows,
        num_features, n_nodes, static_cast<int>(trees - t0), group, bins_tree_stride);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  return cudaSuccess;
}

// A row's 16-byte words where a row is at most 64 bytes and every tree's
// rows fall on 16 bytes, else 0 (a bin gathered a tree).
template <typename Bin, bool kStaged>
cudaError_t launch_route(const void* bins, const int* node, const int* feature,
                         const int* split_bin, int* node_out, int rows, int num_features,
                         int trees, int n_nodes, int group, long long bins_tree_stride,
                         cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(num_features) * sizeof(Bin);
  const int words = row_bytes % 16 == 0 && row_bytes <= 64 &&
                            reinterpret_cast<uintptr_t>(bins) % 16 == 0 &&
                            (bins_tree_stride * static_cast<long long>(sizeof(Bin))) % 16 == 0
                        ? static_cast<int>(row_bytes / 16)
                        : 0;
  const auto launch = words == 1   ? launch_route_as<Bin, 1, kStaged>
                      : words == 2 ? launch_route_as<Bin, 2, kStaged>
                      : words == 3 ? launch_route_as<Bin, 3, kStaged>
                      : words == 4 ? launch_route_as<Bin, 4, kStaged>
                                   : launch_route_as<Bin, 0, kStaged>;
  return launch(bins, node, feature, split_bin, node_out, rows, num_features, trees, n_nodes,
                group, bins_tree_stride, stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) of
// `device`, does not synchronize, and returns cudaGetLastError() after its
// launches: 0 means they were accepted. Outputs and scratch are allocated
// by the caller. `bin_bytes` is 1 for int8 bins and 4 for int32 bins.

// J = `jobs` jobs in groups of `group` (1 unless x_job_stride is 0): X
// (float32, or bfloat16 when x_bf16) of job j at j * x_job_stride values; its thresholds (F, num_thresholds)
// at j * thresholds_job_stride (0: shared), staged in shared memory in
// windows of `window_features` features when `staged`, else a padded (F,
// 2^steps) table in global memory, +inf past the thresholds; 2^steps >
// num_thresholds. bins: (J, rows, F). A group's blocks walk the rows'
// tiles, as many blocks in all as the card holds at once.
int lo_apply_bins(const void* X, int x_bf16, const float* thresholds, void* bins, int bin_bytes,
                  int rows, int num_features, int num_thresholds, int steps, int jobs, int group,
                  int window_features, int staged, long long x_job_stride,
                  long long thresholds_job_stride, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (rows <= 0 || num_features <= 0 || jobs <= 0) return cudaSuccess;
  if (group <= 0 || window_features <= 0 || steps < 0 || steps > 30 ||
      (1 << steps) <= num_thresholds || (x_job_stride != 0 && group != 1) ||
      (bin_bytes != 1 && bin_bytes != 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto pick = [&](auto x) {
    using In = std::remove_const_t<std::remove_pointer_t<decltype(x)>>;
    if (bin_bytes == 1)
      return (staged ? launch_apply_bins<In, int8_t, true> : launch_apply_bins<In, int8_t, false>)(
          x, thresholds, bins, rows, num_features, num_thresholds, steps, jobs, group,
          window_features, x_job_stride, thresholds_job_stride, s);
    return (staged ? launch_apply_bins<In, int32_t, true> : launch_apply_bins<In, int32_t, false>)(
        x, thresholds, bins, rows, num_features, num_thresholds, steps, jobs, group,
        window_features, x_job_stride, thresholds_job_stride, s);
  };
  return x_bf16 ? pick(static_cast<const bf16_bits*>(X)) : pick(static_cast<const float*>(X));
}

// T = `trees` trees, each with its own node (T, rows) and channels (T,
// rows, K), the bins of tree t at t * bins_tree_stride (0: one shared
// matrix). partials: T * chunks * n_nodes * F * window_bins *
// window_channels doubles of scratch, reused by every pass; out: (T,
// n_nodes, F, B, K). Windows of `window_nodes` nodes and blocks of
// `block_features` features are blocks of one launch a pass. order and
// window_begin: null, or scratch of T * rows and T * chunks * (windows + 1)
// ints for the rows partitioned by window (levels of several windows).
int lo_level_histograms(const void* bins, int bin_bytes, const int* node,
                        const float* channels, double* partials, int* order,
                        int* window_begin, float* out,
                        int rows, int num_features, int n_nodes, int max_bins,
                        int num_channels, int trees, long long bins_tree_stride,
                        int chunks, int rows_per_chunk, int window_nodes,
                        int window_bins, int window_channels,
                        int block_features, int max_blocks, int device,
                        void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (static_cast<long long>(n_nodes) * num_features * max_bins *
          num_channels * trees <= 0)
    return cudaSuccess;
  if (window_nodes <= 0 || window_bins <= 0 || window_channels <= 0 || block_features <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch_level_histograms<int8_t>(
        bins, node, channels, partials, order, window_begin, out, rows, num_features, n_nodes,
        max_bins, num_channels, trees, bins_tree_stride, chunks,
        rows_per_chunk, window_nodes, window_bins, window_channels,
        block_features, max_blocks, s);
  if (bin_bytes == 4)
    return launch_level_histograms<int32_t>(
        bins, node, channels, partials, order, window_begin, out, rows, num_features, n_nodes,
        max_bins, num_channels, trees, bins_tree_stride, chunks,
        rows_per_chunk, window_nodes, window_bins, window_channels,
        block_features, max_blocks, s);
  return cudaErrorInvalidValue;
}

// The counts path of K2, for channels that are integers in [0, 65536)
// (the caller's claim, checked by the kernel): bins, node and channels as
// lo_level_histograms; out: (T, n_nodes, F, B, K), its bytes the counts
// until the last kernel rounds them. Blocks of `block_features` features
// count in shared memory when `in_shared`, else (block_features = F) in
// the output.
int lo_level_counts(const void* bins, int bin_bytes, const int* node,
                    const float* channels, float* out, int rows,
                    int num_features, int n_nodes, int max_bins,
                    int num_channels, int trees, long long bins_tree_stride,
                    int chunks, int rows_per_chunk, int block_features,
                    int in_shared, int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (static_cast<long long>(n_nodes) * num_features * max_bins * num_channels *
          trees <= 0)
    return cudaSuccess;
  if (block_features <= 0 || (!in_shared && block_features != num_features))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch_level_counts<int8_t>(bins, node, channels, out, rows, num_features,
                                       n_nodes, max_bins, num_channels, trees,
                                       bins_tree_stride, chunks, rows_per_chunk,
                                       block_features, in_shared, max_blocks, s);
  if (bin_bytes == 4)
    return launch_level_counts<int32_t>(bins, node, channels, out, rows, num_features,
                                        n_nodes, max_bins, num_channels, trees,
                                        bins_tree_stride, chunks, rows_per_chunk,
                                        block_features, in_shared, max_blocks, s);
  return cudaErrorInvalidValue;
}

// mode 0: gini over K class channels; mode 1: newton over (g, h), K = 2.
// subset_scores: null, or (n_nodes, F) scores of which each node takes
// the subset_k lowest (1 <= subset_k). Blocks of `block_nodes` nodes of
// `node_threads` threads; windows of `window_features` features, staged in
// shared memory, or, given `stage`, in n_nodes * B * (window_features * K
// made odd) floats of global scratch.
int lo_select_splits(const float* hist, const float* subset_scores, int subset_k, int* feature,
                     int* bin, float* stage, int n_nodes, int num_features, int max_bins,
                     int num_channels, int mode, int node_threads, int block_nodes,
                     int window_features, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (n_nodes <= 0) return cudaSuccess;
  if (mode == kNewton && num_channels != 2) return cudaErrorInvalidValue;
  if (subset_scores != nullptr && subset_k < 1) return cudaErrorInvalidValue;
  if (node_threads <= 0 || node_threads % 32 != 0 || block_nodes <= 0 ||
      node_threads * block_nodes > kSplitThreads || window_features <= 0)
    return cudaErrorInvalidValue;
  const size_t stage_bytes = sizeof(float) * static_cast<size_t>(max_bins) *
                             (window_features * num_channels | 1);
  const size_t shared_bytes =
      (stage == nullptr ? stage_bytes * block_nodes : 0) +
      sizeof(float) * static_cast<size_t>(block_nodes) * (2 * window_features + num_features) +
      sizeof(float) * 2 * (node_threads * block_nodes / 32);
  const auto kernel = stage == nullptr ? select_splits_kernel<true> : select_splits_kernel<false>;
  error = allow_shared(kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  const int blocks = (n_nodes + block_nodes - 1) / block_nodes;
  kernel<<<blocks, node_threads * block_nodes, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      hist, subset_scores, subset_k, feature, bin, stage, n_nodes, num_features, max_bins,
      num_channels, mode, node_threads, block_nodes, window_features);
  return cudaGetLastError();
}

// One launch of an empty kernel: the card's launch floor.
int lo_empty(int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// node, node_out: (T, rows); feature, split_bin: (T, n_nodes); the bins
// (rows, F) of tree t at t * bins_tree_stride (0: one shared matrix).
// Trees go in groups of `group` (1 unless the stride is 0), their splits
// staged in shared memory when `staged` (group * n_nodes int2 pairs).
int lo_route(const void* bins, int bin_bytes, const int* node, const int* feature,
             const int* split_bin, int* node_out, int rows, int num_features, int trees,
             int n_nodes, long long bins_tree_stride, int group, int staged, int device,
             void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (rows <= 0 || trees <= 0) return cudaSuccess;
  if ((bin_bytes != 1 && bin_bytes != 4) || group <= 0 || (bins_tree_stride != 0 && group != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = bin_bytes == 1 ? (staged ? launch_route<int8_t, true> : launch_route<int8_t, false>)
                                     : (staged ? launch_route<int32_t, true> : launch_route<int32_t, false>);
  return launch(bins, node, feature, split_bin, node_out, rows, num_features, trees, n_nodes,
                group, bins_tree_stride, s);
}

// The counts path of K5, for channels that are integers in [0, 65536)
// (the caller's claim, checked by the kernel). leaf: (T, rows); channels:
// (T, rows, K); scratch: T tickets, then T * n_leaves * K counts, all zero
// on entry and left zero; out: (T, n_leaves, K). One launch a group of
// trees (65,535 at most along grid y).
int lo_leaf_counts(const int* leaf, const float* channels, unsigned* scratch, float* out,
                   int rows, int n_leaves, int num_channels, int trees, int chunks,
                   int rows_per_chunk, int in_shared, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const long long cells = static_cast<long long>(n_leaves) * num_channels;
  if (cells * trees <= 0 || rows <= 0) return cudaSuccess;
  if (chunks <= 0 || rows_per_chunk <= 0) return cudaErrorInvalidValue;
  const auto kernel = in_shared ? leaf_counts_kernel<true> : leaf_counts_kernel<false>;
  const size_t shared_bytes = in_shared ? sizeof(unsigned) * static_cast<size_t>(cells) : 0;
  error = allow_shared(kernel, shared_bytes);
  if (error != cudaSuccess) return error;
  unsigned* tickets = scratch;
  unsigned* counts = scratch + trees;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t0 = 0; t0 < trees; t0 += kMaxGridYZ) {
    const int group = std::min(kMaxGridYZ, trees - t0);
    kernel<<<dim3(chunks, group), kLeafCountThreads, shared_bytes, s>>>(
        leaf + static_cast<long long>(t0) * rows,
        channels + static_cast<long long>(t0) * rows * num_channels, counts + t0 * cells,
        tickets + t0, out + t0 * cells, rows, n_leaves, num_channels, rows_per_chunk);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  return cudaSuccess;
}

// The sums path of K5. leaf: (T, rows); channels: (T, rows, K).
// partials: T * chunks * window_leaves * window_channels doubles of
// scratch, reused by every window; out: (T, n_leaves, K). `fused` (one
// window of every cell): one launch a group of trees, the last block of a
// tree writing its sums, `tickets` (T zeroed counters, left zero);
// otherwise a second kernel a window adds the partials in chunk order.
int lo_leaf_sums(const int* leaf, const float* channels, double* partials, unsigned* tickets,
                 float* out, int rows, int n_leaves, int num_channels, int trees, int chunks,
                 int rows_per_chunk, int window_leaves, int window_channels, int warps,
                 int fused, int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (static_cast<long long>(n_leaves) * num_channels * trees <= 0 || rows <= 0)
    return cudaSuccess;
  if (window_leaves <= 0 || window_channels <= 0 || warps <= 0 || warps > kLeafWarps ||
      (fused && (window_leaves != n_leaves || window_channels != num_channels || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const size_t shared_bytes = sizeof(double) * static_cast<size_t>(window_leaves) *
                              window_channels * warps;
  const auto kernel = fused ? leaf_sums_kernel<true> : leaf_sums_kernel<false>;
  error = allow_shared(kernel, shared_bytes);
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
        kernel<<<dim3(chunks, group), 32 * warps, shared_bytes, s>>>(
            leaf + static_cast<long long>(t0) * rows,
            channels + static_cast<long long>(t0) * rows * num_channels, group_partials,
            fused ? tickets + t0 : nullptr, out + t0 * out_tree_stride, rows, num_channels, w,
            rows_per_chunk);
        error = cudaGetLastError();
        if (error != cudaSuccess) return error;
        if (fused) continue;
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
