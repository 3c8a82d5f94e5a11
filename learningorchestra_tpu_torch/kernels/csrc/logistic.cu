// logistic.cu — the logistic regression fit's loss-and-gradient pass (K7)
// for Hopper (sm_90a), for one fit or for a job axis of fits.
//
// Replaces, in learningorchestra_tpu/:
//   K7 ml/logistic.py:35 `_loss_fn` and its jax.value_and_grad inside
//      :141 `_fit_segment_impl`             -> lo_logistic_loss_grad
//      the Armijo trial losses of :176-200  -> lo_logistic_trial_losses
//   and both under ml/sweep.py:237 `_lr_fused_segment`'s vmap over jobs
//   (K14a), with the sweep's validity mask as a row weight;
//   and both on a rank's block of rows sharded over ranks (the reference's
//   `_loss_fn` with XLA's psums across the data axis, :35 in :308 `_fit`):
//   the sums form, which writes the block's un-divided float64 sums for the
//   caller to add across ranks (`sums_kernel`);
//   and `_loss_fn` with W and b sharded by class over the mesh's model axis
//   (:516-560 `_fit_prepared`; log_softmax's normaliser the model axis's
//   one collective): the class-shard form, two kernels over a rank's C/M
//   classes (below, "K7's class-shard form").
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
// F = 16, C = 2 or 10): X and y read once, 68 MB, ~20 us at 3.35 TB/s.
// Over the lambda sweep's job axis (J = 112 slots of 1,048,576 rows, one
// shared X) the bytes stay those of one X, and the work is J times one
// fit's: 2FC float32 operations a row and job for the logits (8FC for the
// four trial points), ~2FC float64 ones for the gradient, and the
// softmax's accurate expf and logf.
//
// Design (a block is a row chunk and a job group):
//   - A shared X is read once for a group of jobs. When the jobs share
//     their rows (both strides 0), a block stages each tile of its chunk
//     once and runs every job of its group on it, the group's W, b (W4,
//     b4) in shared memory when they fit. The wrapper (ml/logistic.py
//     `_k7_geometry`) picks the group and the tile from shared memory: at
//     F = 16, C = 2 all 112 slots of the sweep are one group for both
//     entry points, so X comes from HBM once a call, not 112 times.
//     Stacked rows (the coalescer's flood, members with their own data)
//     give a group of one job.
//   - Tiles arrive through a ring of two buffers by cp.async: the next
//     tile loads while this one is computed. The gradient takes two
//     barriers a tile (the tile has landed; its terms are in), the trial
//     losses one.
//   - Phase 1, a thread a (row, job), rows fastest so that a warp reads
//     one job's parameters: the row's logits (fmaf in feature order, then
//     b), the reference's log-softmax (for C = 2 one expf: the larger
//     shifted logit is 0, whose exp is 1 exactly), the nll and the
//     residual p - onehot(y), times the row's weight, each rounded once
//     to float64 into shared memory. The trial losses give a warp 64 rows
//     of one job, two a lane, so that a parameter load serves two rows.
//   - Float64 sums in a fixed shape: a cell's sum over a chunk is the sums
//     of its groups of 16 rows, each from 0 in row order (x * r exact in
//     float64, added by fma), added in group order. Small groups (a solo
//     fit, up to 8 jobs at F = 16, C = 2: the narrow form) hand every
//     (group, cell) to any thread, so a solo fit's 35 cells keep all 256
//     threads busy, and each cell's owner adds the groups while the next
//     tile is computed; large groups (the wide form) give a thread a (job,
//     2 classes, 8 features) block of 16 cells, x made float64 once a row
//     for the whole group. The trial losses add each (group, candidate) in
//     one lane from a warp's scratch. db, the loss and the weights' sum
//     are the same sums of the residuals, the nll and the weights.
//   - Deterministic and independent of the group: the groups and the
//     chunks are a function of the row count alone, and a second kernel
//     adds the chunks in chunk order, divides by N (by the chunk-ordered
//     sum of the weights when weighted) and rounds once to float32. No
//     float atomics. A job's outputs are therefore bit-equal whatever its
//     group, its tile or its form: bit-equal to a launch of that job
//     alone, and a refit is bit identical.
//   - Weighted: a row's nll and residual are multiplied by its float32
//     weight before the float64 sums (exact for the 0/1 validity mask).
//   - The row's log-softmax is the reference's: shifted = z - max(z),
//     nll = log(sum(exp(shifted))) - shifted[y], p = exp(shifted - log sum).
//     A label outside [0, C) gives a NaN nll.
//   - Any class count: C = 2 keeps its logits in registers; other C keep
//     them in the float64 residuals' place (the gradient), in registers
//     up to 16 classes (the trial losses) or compute each again in each
//     pass (the same fmaf chain, the same bits), so no class count runs
//     out of registers. When one job's wide slots pass one block, blocks
//     along grid z take windows of 256 slots, and each keeps only its
//     window's classes' terms (the row's softmax computed whole, each
//     logit again), so no class count runs out of shared memory. Any
//     feature count: rows too wide for shared memory are read from
//     global memory, with the parameters.
//   - Shared memory: laid out by the wrapper (`Layout`, ml/logistic.py
//     `_k7_layout`): the tile's rows at an odd stride, so that a warp's
//     threads, a row each, read 32 different banks; the float64 terms and
//     the scratch at strides that keep a warp's reads on different banks.
//   - X may be bfloat16 (LO_DTYPE_POLICY=bf16: the solo fit's
//     standardized rows; a sweep's job axis stays float32), of any width.
//     A staged tile's raw bfloat16 bytes come by 16-byte cp.async into a
//     region of their own (`raw`), and after the wait each value is
//     widened exactly to float32 into the ring's tile (one more barrier a
//     tile); rows too wide to stage are read from global memory, each
//     value widened where it is loaded (`Bf16Rows`). Everything after the
//     widening is unchanged, so the outputs are those of the float32
//     kernel on the widened X (the reference's jnp promotes the bfloat16
//     X to float32 in X @ W).
//   - Build without -use_fast_math: expf and logf are the accurate ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

// A block's geometry and shared memory, laid out by the wrapper
// (ml/logistic.py `_k7_layout`, field for field its `_K7Layout`): the
// kernels read the strides and the byte offsets from here and compute
// none of them. Strides: a tile row of x at xs floats (0: x is read from
// global memory); the float64 terms of a (job, class) at tp, a job's at
// js (all C classes, or a window's); a row of float64 x at fd; a ring
// buffer's floats. The float64 terms, the nll and the weights lie in one
// run of doubles, so that a cell names its terms by one offset. `cells`:
// the cells a block sums group by group (the narrow form and the trial
// losses): each job's F*C + C + 1 (the trial losses' 4), and the weights'.
// `raw`: a staged tile's bfloat16 values as they arrive, before they are
// widened into the ring (x_bf16 layouts only).
// Outside the unnamed namespace: the entry points take it, and keep their
// external linkage only for a type that has it.
struct Layout {
  int group, tile, form, params_shared, x_bf16;
  int xs, tp, js, fd, cells, buffer_floats;
  int ring, raw, xd, terms, nll, wd, scratch, sums, sources, one, params_w, params_b, bytes;
};

// The class-shard form's block geometry and shared memory, laid out by the
// wrapper (ml/logistic.py `_shard_layout`, field for field its
// `_ShardLayout`): the tile's rows; x's row stride in floats (0: rows read
// from global memory); a feature's class stride in the shared parameters
// (0: the parameters read from global memory); grad's sum form; the
// residuals' stride in doubles a class; a ring buffer's bytes; the byte
// offsets of each region; a point's floats in the outputs' stage; the
// total bytes.
struct ShardLayout {
  int tile, xs, ws, form, tp, buffer;
  int params_w, params_b, raw, x, ring, terms, nll, wd, sums, stage, stage_floats, bytes;
};

namespace {

constexpr int kThreads = 256;   // _THREADS in ml/logistic.py
constexpr int kCandidates = 4;  // Armijo trial steps 1, 1/2, 1/4, 1/8
constexpr size_t kDefaultSharedBytes = 48 * 1024;
// The most blocks a launch may have along grid dimensions y and z: job
// groups past it go in groups of launches.
constexpr int kMaxGridYZ = 65535;
// A cell's float64 sum over a chunk: the sums of its rows' groups of
// kGroupRows rows (each from 0, in row order), added in group order. Tiles
// hold whole groups (ml/logistic.py _GROUP_ROWS).
constexpr int kGroupRows = 16;
// Phase 2's forms (ml/logistic.py _NARROW, _WIDE, _WIDE_STAGED): cells
// summed group by group by any thread, then added by their owners (a
// thread owns up to kMaxOwned cells); a (job, kWideClasses,
// kWideFeatures) block of cells a thread, x converted by the thread; the
// same with x made float64 once a row in shared memory.
constexpr int kNarrow = 0, kWide = 1, kWideStaged = 2;
constexpr int kWideClasses = 2, kWideFeatures = 8;
constexpr int kMaxOwned = 5;
// The trial losses: a warp's item is 64 rows of one job, two a lane; its
// float32 nll (and weights) pass through the warp's scratch, (candidate or
// weights, group, row) at strides 68 and 17 floats, so that the lanes that
// add a (group, candidate) each read a bank of their own.
constexpr int kWarpRows = 64;
constexpr int kScratchGroup = 17, kScratchSet = 68;
constexpr int kScratchFloats = (kCandidates + 1) * kScratchSet;
// The trial losses keep up to this many classes' logits in registers.
constexpr int kRegisterClasses = 16;

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

__device__ __forceinline__ void copy_async4(void* shared, const void* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(address), "l"(global)
               : "memory");
}

__device__ __forceinline__ void copy_async16(void* shared, const void* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(address), "l"(global)
               : "memory");
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A tile in the ring: x (tile, xs) floats (none when x is read from
// global memory), then the labels and, weighted, the weights.
struct Tile {
  float* x;
  int* y;
  float* w;
  __device__ Tile(float* buffer, int tile, int xs)
      : x(buffer), y(reinterpret_cast<int*>(buffer + static_cast<size_t>(tile) * xs)),
        w(buffer + static_cast<size_t>(tile) * (xs + 1)) {}
};

// A bfloat16 value's bits; widened to float32 by a shift, exactly
// (__bfloat162float's bits).
typedef unsigned short bf16_bits;

__device__ __forceinline__ float widen(bf16_bits bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// Rows of bfloat16 X in global memory, read as float32: each value is
// widened where it is loaded. It reads as a `const float*` does (x[i],
// x + i), so that the row terms and the sums take either.
struct Bf16Rows {
  const bf16_bits* p;
  __device__ __forceinline__ float operator[](long long i) const { return widen(__ldg(p + i)); }
  __device__ __forceinline__ Bf16Rows operator+(long long i) const { return {p + i}; }
};

// Rows of X in global memory, from value `offset`, for the geometries that
// do not stage x (rows too wide for shared memory).
__device__ __forceinline__ const float* global_rows(const float* X, size_t offset) {
  return X + offset;
}
__device__ __forceinline__ Bf16Rows global_rows(const bf16_bits* X, size_t offset) {
  return {X + offset};
}

// A raw tile of X (bfloat16, or float32 for the class-shard form): value i
// of the values from `from` at raw[raw_shift(from) + i], the shift putting
// `from`'s 16-byte words on raw's; raw_head(from) values precede the first
// whole word. kWordValues: the values of a 16-byte word.
template <typename In>
constexpr int kWordValues = 16 / static_cast<int>(sizeof(In));
template <typename In>
__device__ __forceinline__ int raw_head(const In* from) {
  return static_cast<int>((16 - (reinterpret_cast<uintptr_t>(from) & 15)) & 15) /
         static_cast<int>(sizeof(In));
}
template <typename In>
__device__ __forceinline__ int raw_shift(const In* from) {
  return (kWordValues<In> - raw_head(from)) & (kWordValues<In> - 1);
}

// Issue the copies of `count` values from `from` into the raw tile: their
// whole 16-byte words by 16-byte cp.async, the values before the first and
// after the last whole word by loads.
template <typename In>
__device__ __forceinline__ void stage_raw(In* raw, const In* __restrict__ from, int count) {
  constexpr int kV = kWordValues<In>;
  In* to = raw + raw_shift(from);
  const int head = min(count, raw_head(from));
  const int words = (count - head) / kV;
  for (int i = threadIdx.x; i < words; i += kThreads)
    copy_async16(to + head + kV * i, from + head + kV * i);
  const int tail = head + kV * words, edges = head + count - tail;
  for (int i = threadIdx.x; i < edges; i += kThreads) {
    const int at = i < head ? i : tail + i - head;
    to[at] = __ldg(from + at);
  }
}

__device__ __forceinline__ float widen(float value) { return value; }

// The raw tile's n rows widened exactly (float32: copied) into the tile's x
// (row stride xs).
template <typename In>
__device__ __forceinline__ void widen_tile(float* x, const In* raw, int n, int F, int xs) {
  const int step_r = kThreads / F, step_f = kThreads % F;
  int r = threadIdx.x / F, f = threadIdx.x % F;
  while (r < n) {
    x[r * xs + f] = widen(raw[r * F + f]);
    r += step_r;
    f += step_f;
    if (f >= F) {
      f -= F;
      ++r;
    }
  }
}

// Issue the copies of rows [start, start + n) of the block's rows into
// `tile`: float32 x by 4-byte cp.async (x's row stride in shared memory is
// odd; element i = r * F + f of the rows goes to thread i % kThreads),
// bfloat16 x raw into `raw` (widen_tile after the wait); the labels and
// the weights by 4-byte cp.async.
template <typename In>
__device__ __forceinline__ void stage_tile(const Tile& tile, bf16_bits* raw,
                                           const In* __restrict__ X,
                                           const int* __restrict__ y,
                                           const float* __restrict__ weights, int start,
                                           int n, int F, int xs) {
  if (xs > 0) {
    const In* rows = X + static_cast<size_t>(start) * F;
    if constexpr (std::is_same<In, float>::value) {
      const int step_r = kThreads / F, step_f = kThreads % F;
      int r = threadIdx.x / F, f = threadIdx.x % F;
      while (r < n) {
        copy_async4(tile.x + r * xs + f, rows + static_cast<size_t>(r) * F + f);
        r += step_r;
        f += step_f;
        if (f >= F) {
          f -= F;
          ++r;
        }
      }
    } else {
      stage_raw(raw, rows, n * F);
    }
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    copy_async4(tile.y + i, y + start + i);
    if (weights != nullptr) copy_async4(tile.w + i, weights + start + i);
  }
}

// ---------------------------------------------------------------------------
// One row's terms at one parameter set (W (F, C), b (C,)), in the
// reference's roundings
// ---------------------------------------------------------------------------

// The logit of class c without b: fmaf over the features in order. A row
// x is a `const float*` (a staged tile, float32 rows in global memory) or
// Bf16Rows, here and in the functions below.
template <typename XP>
__device__ __forceinline__ float dot(XP x, int F, const float* W, int C, int c) {
  float sum = 0.0f;
#pragma unroll 4
  for (int f = 0; f < F; ++f) sum = fmaf(x[f], W[f * C + c], sum);
  return sum;
}

struct Softmax {
  float top, log_sum, nll;
};

// Any C: the shifted logits' maximum, log-sum and the nll, each logit
// computed again in each pass (the same fmaf chain, so the same bits).
template <typename XP>
__device__ __forceinline__ Softmax softmax_any(XP x, int F, const float* W,
                                               const float* b, int C, int label) {
  Softmax s;
  s.top = -INFINITY;
  for (int c = 0; c < C; ++c) s.top = fmaxf(s.top, __fadd_rn(dot(x, F, W, C, c), b[c]));
  float sum = 0.0f, at_label = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float shifted = __fsub_rn(__fadd_rn(dot(x, F, W, C, c), b[c]), s.top);
    sum = __fadd_rn(sum, expf(shifted));
    if (c == label) at_label = shifted;
  }
  s.log_sum = logf(sum);
  s.nll = label >= 0 && label < C ? __fsub_rn(s.log_sum, at_label) : nanf("");
  return s;
}

// C = 2 from the two logits without b: shifts them in place. The larger
// shifted logit is 0, whose exp is 1 exactly, so one expf gives both
// terms of the sum; when neither is 0 (a NaN or infinite logit) the sum
// is NaN either way.
__device__ __forceinline__ float softmax2(float& z0, float& z1, const float* b, int label,
                                          float& log_sum) {
  z0 = __fadd_rn(z0, b[0]);
  z1 = __fadd_rn(z1, b[1]);
  const float top = fmaxf(fmaxf(-INFINITY, z0), z1);
  z0 = __fsub_rn(z0, top);
  z1 = __fsub_rn(z1, top);
  const bool first_top = z0 == 0.0f;
  const float e = expf(first_top ? z1 : z0);
  const float e0 = first_top ? 1.0f : e;
  const float e1 = first_top ? e : (z1 == 0.0f ? 1.0f : e);
  log_sum = logf(__fadd_rn(__fadd_rn(0.0f, e0), e1));
  return label == 0 ? __fsub_rn(log_sum, z0)
                    : label == 1 ? __fsub_rn(log_sum, z1) : nanf("");
}

__device__ __forceinline__ float residual(float shifted, float log_sum, bool is_label) {
  return __fsub_rn(expf(__fsub_rn(shifted, log_sum)), is_label ? 1.0f : 0.0f);
}

// The row's residuals w (p_c - onehot_c) as float64 at out[c * stride];
// returns its (weighted) nll. kC = 2: C is 2 and W, b are 8-byte aligned.
template <int kC, typename XP>
__device__ __forceinline__ float row_residuals(XP x, int F, const float* W,
                                               const float* b, int C, int label, float w,
                                               bool weighted, double* out, int stride) {
  float nll;
  if constexpr (kC == 2) {
    float z0 = 0.0f, z1 = 0.0f;
    const float2* W2 = reinterpret_cast<const float2*>(W);
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      const float2 wf = W2[f];
      z0 = fmaf(x[f], wf.x, z0);
      z1 = fmaf(x[f], wf.y, z1);
    }
    float log_sum;
    nll = softmax2(z0, z1, b, label, log_sum);
    float r0 = residual(z0, log_sum, label == 0), r1 = residual(z1, log_sum, label == 1);
    if (weighted) {
      r0 = __fmul_rn(w, r0);
      r1 = __fmul_rn(w, r1);
    }
    out[0] = static_cast<double>(r0);
    out[stride] = static_cast<double>(r1);
  } else {
    // each logit computed once and kept in out (float64 holds it exactly)
    // until its residual takes its place
    float top = -INFINITY;
    for (int c = 0; c < C; ++c) {
      const float z = __fadd_rn(dot(x, F, W, C, c), b[c]);
      out[static_cast<size_t>(c) * stride] = static_cast<double>(z);
      top = fmaxf(top, z);
    }
    float sum = 0.0f, at_label = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float shifted =
          __fsub_rn(static_cast<float>(out[static_cast<size_t>(c) * stride]), top);
      sum = __fadd_rn(sum, expf(shifted));
      if (c == label) at_label = shifted;
    }
    const float log_sum = logf(sum);
    nll = label >= 0 && label < C ? __fsub_rn(log_sum, at_label) : nanf("");
    for (int c = 0; c < C; ++c) {
      const float shifted =
          __fsub_rn(static_cast<float>(out[static_cast<size_t>(c) * stride]), top);
      float r = residual(shifted, log_sum, c == label);
      if (weighted) r = __fmul_rn(w, r);
      out[static_cast<size_t>(c) * stride] = static_cast<double>(r);
    }
  }
  return weighted ? __fmul_rn(w, nll) : nll;
}

// Classes [c0, c1) of the row's residuals (a window of a class count too
// wide to keep all of a tile's terms) at out[(c - c0) * stride]; returns
// its (weighted) nll. Each logit is computed again (softmax_any's fmaf
// chains), so the terms are row_residuals' bits.
template <typename XP>
__device__ __forceinline__ float window_residuals(XP x, int F, const float* W,
                                                  const float* b, int C, int label, float w,
                                                  bool weighted, int c0, int c1, double* out,
                                                  int stride) {
  const Softmax s = softmax_any(x, F, W, b, C, label);
  for (int c = c0; c < c1; ++c) {
    const float shifted = __fsub_rn(__fadd_rn(dot(x, F, W, C, c), b[c]), s.top);
    float r = residual(shifted, s.log_sum, c == label);
    if (weighted) r = __fmul_rn(w, r);
    out[static_cast<size_t>(c - c0) * stride] = static_cast<double>(r);
  }
  return weighted ? __fmul_rn(w, s.nll) : s.nll;
}

// Two rows' (weighted) nll at the four candidates W4 (4, F, C), b4 (4, C),
// in out[row][k]. kC = 2: each parameter is read once for both rows.
template <int kC, typename XP>
__device__ __forceinline__ void rows_trial_nll(XP x0, XP x1, int F,
                                               const float* W4, const float* b4, int C,
                                               const int (&label)[2], const float (&w)[2],
                                               bool weighted, float (&out)[2][kCandidates]) {
  if constexpr (kC == 2) {
    float z[2][kCandidates][2] = {};
    const float2* W2 = reinterpret_cast<const float2*>(W4);
#pragma unroll 2
    for (int f = 0; f < F; ++f) {
      const float xf[2] = {x0[f], x1[f]};
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const float2 wf = W2[k * F + f];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          z[q][k][0] = fmaf(xf[q], wf.x, z[q][k][0]);
          z[q][k][1] = fmaf(xf[q], wf.y, z[q][k][1]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        float log_sum;
        float nll = softmax2(z[q][k][0], z[q][k][1], b4 + 2 * k, label[q], log_sum);
        out[q][k] = weighted ? __fmul_rn(w[q], nll) : nll;
      }
  } else if (C <= kRegisterClasses) {
    // up to kRegisterClasses logits of both rows in registers, each a
    // feature-ordered fmaf chain as dot() forms it
    for (int k = 0; k < kCandidates; ++k) {
      const float* W = W4 + static_cast<size_t>(k) * F * C;
      const float* b = b4 + k * C;
      float z[2][kRegisterClasses] = {};
      for (int f = 0; f < F; ++f) {
        const float xf[2] = {x0[f], x1[f]};
#pragma unroll
        for (int c = 0; c < kRegisterClasses; ++c)
          if (c < C) {
            const float wf = W[f * C + c];
            z[0][c] = fmaf(xf[0], wf, z[0][c]);
            z[1][c] = fmaf(xf[1], wf, z[1][c]);
          }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float top = -INFINITY;
#pragma unroll
        for (int c = 0; c < kRegisterClasses; ++c)
          if (c < C) {
            z[q][c] = __fadd_rn(z[q][c], b[c]);
            top = fmaxf(top, z[q][c]);
          }
        float sum = 0.0f, at_label = 0.0f;
#pragma unroll
        for (int c = 0; c < kRegisterClasses; ++c)
          if (c < C) {
            const float shifted = __fsub_rn(z[q][c], top);
            sum = __fadd_rn(sum, expf(shifted));
            if (c == label[q]) at_label = shifted;
          }
        const float log_sum = logf(sum);
        const float nll =
            label[q] >= 0 && label[q] < C ? __fsub_rn(log_sum, at_label) : nanf("");
        out[q][k] = weighted ? __fmul_rn(w[q], nll) : nll;
      }
    }
  } else {
    const XP x[2] = {x0, x1};
    for (int q = 0; q < 2; ++q)
      for (int k = 0; k < kCandidates; ++k) {
        float nll = softmax_any(x[q], F, W4 + static_cast<size_t>(k) * F * C, b4 + k * C, C,
                                label[q]).nll;
        out[q][k] = weighted ? __fmul_rn(w[q], nll) : nll;
      }
  }
}

// ---------------------------------------------------------------------------
// Phase 2: the float64 sums
// ---------------------------------------------------------------------------

// The narrow form's cells, in the order their partials go out: job jl's
// cell q at jl * per_job + q (dW f*C + c, db F*C + c, the loss F*C + C),
// then the weights'. A cell's row r adds
// a_r * b_r: b_r at terms[offset + r] (the residuals, the nll or the
// weights in float64), a_r x[r][feature] in float64, or 1 (feature -1).
struct GroupedCells {
  const double* terms;
  int2* sources;
  int cells, per_job, jobs;
};

__device__ __forceinline__ void describe_cells(const GroupedCells& g, const Layout& layout,
                                               int F, int C) {
  const int nll = static_cast<int>((layout.nll - layout.terms) / sizeof(double));
  const int wd = static_cast<int>((layout.wd - layout.terms) / sizeof(double));
  for (int cell = threadIdx.x; cell < g.cells; cell += kThreads) {
    const int jl = cell / g.per_job, q = cell - jl * g.per_job;
    int2 source;
    if (jl >= g.jobs) {
      source = make_int2(wd, -1);  // the weights
    } else if (q < F * C) {
      source = make_int2(jl * layout.js + (q % C) * layout.tp, q / C);
    } else if (q < F * C + C) {
      source = make_int2(jl * layout.js + (q - F * C) * layout.tp, -1);
    } else {
      source = make_int2(nll + jl * layout.tp, -1);
    }
    g.sources[cell] = source;
  }
}

// Each (group, cell) of the tile's n rows: the cell's sum over the group's
// rows, from 0, in row order, into sums[group * cells + cell]. Work items
// go to every thread, cells fastest.
template <typename XP>
__device__ __forceinline__ void group_sums(const GroupedCells& g, double* __restrict__ sums,
                                           XP x, int x_stride, const float* one, int n) {
  const int groups = (n + kGroupRows - 1) / kGroupRows;
  const int step_g = kThreads / g.cells, step_c = kThreads % g.cells;
  int group = threadIdx.x / g.cells, cell = threadIdx.x % g.cells;
  while (group < groups) {
    const int2 source = g.sources[cell];
    const double* b = g.terms + source.x;
    // a_r: x[r][feature], or the 1.0 of db, the loss and the weights
    const bool unit = source.y < 0;
    const XP a = x + (unit ? 0 : source.y);
    const int r0 = group * kGroupRows;
    double s = 0.0;
    if (r0 + kGroupRows <= n) {
#pragma unroll
      for (int r = r0; r < r0 + kGroupRows; ++r)
        s = __fma_rn(static_cast<double>(unit ? *one : a[r * x_stride]), b[r], s);
    } else {
      for (int r = r0; r < n; ++r)
        s = __fma_rn(static_cast<double>(unit ? *one : a[r * x_stride]), b[r], s);
    }
    sums[group * g.cells + cell] = s;
    group += step_g;
    cell += step_c;
    if (cell >= g.cells) {
      cell -= g.cells;
      ++group;
    }
  }
}

// The owners' sums: thread t owns cells t, t + kThreads, ...; a tile's
// group sums added in group order.
__device__ __forceinline__ void add_groups(double (&owned)[kMaxOwned], const double* sums,
                                           int cells, int groups) {
#pragma unroll
  for (int k = 0; k < kMaxOwned; ++k) {
    const int cell = threadIdx.x + k * kThreads;
    if (cell < cells)
      for (int group = 0; group < groups; ++group)
        owned[k] = __dadd_rn(owned[k], sums[group * cells + cell]);
  }
}

// The wide form's cells: classes [c0, c0 + kCB) and features [f0, f0 +
// kW) of job jl (kFull: all inside C and F), db of those classes when f0
// is 0, the loss when c0 is 0 as well, and the weights' sum for slot 0.
template <int kCB, int kW>
struct Sums {
  double dw[kCB][kW];
  double db[kCB];
  double loss, weight;
};

// One row of the tile into a wide slot's group sums.
template <int kCB, int kW, bool kFull, bool kStaged, typename XP>
__device__ __forceinline__ void wide_row(Sums<kCB, kW>& s, XP x, int x_stride,
                                         const double* __restrict__ xd,
                                         const double* __restrict__ terms,
                                         const double* __restrict__ nll,
                                         const double* __restrict__ wd, int r, int F, int C,
                                         int fd, int tp, int c0, int f0, bool owns_db,
                                         bool owns_loss, bool owns_weight) {
  double rc[kCB], xv[kW];
#pragma unroll
  for (int i = 0; i < kCB; ++i) rc[i] = kFull || c0 + i < C ? terms[i * tp + r] : 0.0;
  if constexpr (kStaged && kFull && kW % 2 == 0) {
    const double2* row = reinterpret_cast<const double2*>(xd + r * fd + f0);
#pragma unroll
    for (int f = 0; f < kW / 2; ++f) {
      const double2 pair = row[f];
      xv[2 * f] = pair.x;
      xv[2 * f + 1] = pair.y;
    }
  } else {
#pragma unroll
    for (int f = 0; f < kW; ++f)
      xv[f] = !kFull && f0 + f >= F ? 0.0
              : kStaged               ? xd[r * fd + f0 + f]
                                      : static_cast<double>(x[r * x_stride + f0 + f]);
  }
#pragma unroll
  for (int i = 0; i < kCB; ++i)
#pragma unroll
    for (int f = 0; f < kW; ++f) s.dw[i][f] = __fma_rn(xv[f], rc[i], s.dw[i][f]);
  if (owns_db) {
#pragma unroll
    for (int i = 0; i < kCB; ++i) s.db[i] = __dadd_rn(s.db[i], rc[i]);
  }
  if (owns_loss) s.loss = __dadd_rn(s.loss, nll[r]);
  if (owns_weight) s.weight = __dadd_rn(s.weight, wd[r]);
}

// The tile's n rows into a wide slot's sums: each group's sums from 0 in
// row order, then added to the slot's.
template <int kCB, int kW, bool kFull, bool kStaged, typename XP>
__device__ __forceinline__ void wide_rows(Sums<kCB, kW>& acc, XP x, int x_stride,
                                          const double* xd, const double* terms,
                                          const double* nll, const double* wd, int n, int F,
                                          int C, int fd, int tp, int c0, int f0, bool owns_db,
                                          bool owns_loss, bool owns_weight) {
  for (int r0 = 0; r0 < n; r0 += kGroupRows) {
    Sums<kCB, kW> s = {};
    const int r1 = min(n, r0 + kGroupRows);
    for (int r = r0; r < r1; ++r)
      wide_row<kCB, kW, kFull, kStaged>(s, x, x_stride, xd, terms, nll, wd, r, F, C, fd, tp,
                                        c0, f0, owns_db, owns_loss, owns_weight);
#pragma unroll
    for (int i = 0; i < kCB; ++i) {
#pragma unroll
      for (int f = 0; f < kW; ++f) acc.dw[i][f] = __dadd_rn(acc.dw[i][f], s.dw[i][f]);
      acc.db[i] = __dadd_rn(acc.db[i], s.db[i]);
    }
    acc.loss = __dadd_rn(acc.loss, s.loss);
    acc.weight = __dadd_rn(acc.weight, s.weight);
  }
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

// Block (chunk, job group, slot window): the float64 partial sums over the
// chunk's rows of each job of the group: cell f*C + c of dW, F*C + c of
// db, F*C + C of the loss and, with weights, F*C + C + 1 of the weights.
// Jobs of a group share their rows (the wrapper makes groups of more than
// one job only then); a group of one may have its own.
template <typename In, int kC, int kForm>
__global__ void __launch_bounds__(kThreads, 2)
    loss_grad_kernel(const void* __restrict__ X_rows, const int* __restrict__ y,
                     const float* __restrict__ weights, const float* __restrict__ W,
                     const float* __restrict__ b, double* __restrict__ partials, int rows,
                     int F, int C, int jobs, long long x_job_stride,
                     long long row_job_stride, int rows_per_chunk, const Layout layout) {
  constexpr int kCB = kForm == kNarrow ? 1 : kWideClasses;
  constexpr int kW = kForm == kNarrow ? 1 : kWideFeatures;
  constexpr bool kStaged = kForm == kWideStaged;
  constexpr bool kRaw = std::is_same<In, bf16_bits>::value;  // staged tiles come raw
  extern __shared__ __align__(16) unsigned char shared[];
  const bool weighted = weights != nullptr;
  const int group = layout.group, tile = layout.tile;
  const int xs = layout.xs, tp = layout.tp, js = layout.js, fd = layout.fd;
  const int cells_out = F * C + C + 1 + (weighted ? 1 : 0);
  const int job0 = blockIdx.y * group;
  const int G = min(group, jobs - job0);
  const In* X = static_cast<const In*>(X_rows) + job0 * x_job_stride;
  y += job0 * row_job_stride;
  if (weighted) weights += job0 * row_job_stride;
  W += static_cast<size_t>(job0) * F * C;
  b += static_cast<size_t>(job0) * C;
  float* ring = reinterpret_cast<float*>(shared + layout.ring);
  bf16_bits* raw = reinterpret_cast<bf16_bits*>(shared + layout.raw);
  double* xd = reinterpret_cast<double*>(shared + layout.xd);
  double* terms = reinterpret_cast<double*>(shared + layout.terms);
  double* nll_terms = reinterpret_cast<double*>(shared + layout.nll);
  double* wd = reinterpret_cast<double*>(shared + layout.wd);
  float* one = reinterpret_cast<float*>(shared + layout.one);
  const float* Wg = W;
  const float* bg = b;
  if (layout.params_shared) {
    float* sw = reinterpret_cast<float*>(shared + layout.params_w);
    float* sb = reinterpret_cast<float*>(shared + layout.params_b);
    for (int i = threadIdx.x; i < G * F * C; i += kThreads) sw[i] = W[i];
    for (int i = threadIdx.x; i < G * C; i += kThreads) sb[i] = b[i];
    Wg = sw;
    bg = sb;
  }
  if (kForm == kNarrow && threadIdx.x == 0) *one = 1.0f;
  // the grouped form: its cells (this block's group's) and their owners' sums
  const GroupedCells grouped{terms, reinterpret_cast<int2*>(shared + layout.sources),
                             G * (F * C + C + 1) + (weighted ? 1 : 0), F * C + C + 1, G};
  double* group_sums_at = reinterpret_cast<double*>(shared + layout.sums);
  const int tile_groups = tile / kGroupRows;
  double owned[kMaxOwned] = {};
  if constexpr (kForm == kNarrow) describe_cells(grouped, layout, F, C);

  // the wide forms: this thread's slot
  const int feature_blocks = (F + kW - 1) / kW;
  const int per_job = (C + kCB - 1) / kCB * feature_blocks;
  const int slot = blockIdx.z * kThreads + threadIdx.x;
  const bool active = kForm != kNarrow && slot < G * per_job;
  const int jl = active ? slot / per_job : 0;
  const int within = slot - jl * per_job;
  const int c0 = within / feature_blocks * kCB, f0 = within % feature_blocks * kW;
  const bool full = c0 + kCB <= C && f0 + kW <= F;
  const bool owns_db = active && f0 == 0;
  const bool owns_loss = owns_db && c0 == 0;
  const bool owns_weight = weighted && active && slot == 0;
  Sums<kCB, kW> sums = {};
  // the classes whose terms the block keeps: all C, or those of its
  // window of slots when one job's slots pass one block
  int cw0 = 0, cw1 = C;
  if (kForm != kNarrow && G == 1) {
    const int first = blockIdx.z * kThreads;
    cw0 = first / feature_blocks * kCB;
    cw1 = min(C, (min(per_job, first + kThreads) - 1) / feature_blocks * kCB + kCB);
  }

  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  const int tiles = (row_end - row_begin + tile - 1) / tile;
  stage_tile(Tile(ring, tile, xs), raw, X, y, weights, row_begin, min(tile, row_end - row_begin),
             F, xs);
  async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int start = row_begin + t * tile;
    const int n = min(tile, row_end - start);
    const Tile here(ring + (t & 1) * layout.buffer_floats, tile, xs);
    async_wait_all();
    __syncthreads();  // the tile has landed; the previous tile's sums are done
    if constexpr (kRaw) {
      if (xs > 0) {
        widen_tile(here.x, raw + raw_shift(X + static_cast<size_t>(start) * F), n, F, xs);
        __syncthreads();  // the tile is widened: raw is free for the next
      }
    }
    if (t + 1 < tiles) {
      const int next = start + tile;
      stage_tile(Tile(ring + ((t + 1) & 1) * layout.buffer_floats, tile, xs), raw, X, y,
                 weights, next, min(tile, row_end - next), F, xs);
      async_commit();
    }
    // the tile's terms and sums, x staged or from global memory
    auto tile_pass = [&](auto x, int x_stride) {
      // phase 1: the row terms of each (row, job), rows fastest
      if constexpr (kStaged) {
        const int step_r = kThreads / F, step_f = kThreads % F;
        int r = threadIdx.x / F, f = threadIdx.x % F;
        while (r < n) {
          xd[r * fd + f] = static_cast<double>(x[r * x_stride + f]);
          r += step_r;
          f += step_f;
          if (f >= F) {
            f -= F;
            ++r;
          }
        }
      }
      if (weighted)
        for (int r = threadIdx.x; r < n; r += kThreads) wd[r] = static_cast<double>(here.w[r]);
      {
        const int step_j = kThreads / n, step_r = kThreads % n;
        int j = threadIdx.x / n, r = threadIdx.x % n;
        while (j < G) {
          const float w = weighted ? here.w[r] : 1.0f;
          const float* Wj = Wg + static_cast<size_t>(j) * F * C;
          double* out = terms + static_cast<size_t>(j) * js + r;
          float nll;
          if (kC == 2 || cw1 - cw0 == C)
            nll = row_residuals<kC>(x + r * x_stride, F, Wj, bg + j * C, C, here.y[r], w,
                                    weighted, out, tp);
          else
            nll = window_residuals(x + r * x_stride, F, Wj, bg + j * C, C, here.y[r], w,
                                   weighted, cw0, cw1, out, tp);
          nll_terms[j * tp + r] = static_cast<double>(nll);
          j += step_j;
          r += step_r;
          if (r >= n) {
            r -= n;
            ++j;
          }
        }
      }
      __syncthreads();  // the terms are in
      // phase 2: the sums, group by group
      if constexpr (kForm == kNarrow) {
        // the previous tile's group sums into their owners' (that tile was whole)
        if (t > 0)
          add_groups(owned, group_sums_at + ((t - 1) & 1) * grouped.cells * tile_groups,
                     grouped.cells, tile_groups);
        group_sums(grouped, group_sums_at + (t & 1) * grouped.cells * tile_groups, x, x_stride,
                   one, n);
      } else if (active) {
        const double* slot_terms = terms + static_cast<size_t>(jl) * js + (c0 - cw0) * tp;
        const double* slot_nll = nll_terms + jl * tp;
        if (full)
          wide_rows<kCB, kW, true, kStaged>(sums, x, x_stride, xd, slot_terms, slot_nll, wd, n,
                                            F, C, fd, tp, c0, f0, owns_db, owns_loss,
                                            owns_weight);
        else
          wide_rows<kCB, kW, false, kStaged>(sums, x, x_stride, xd, slot_terms, slot_nll, wd, n,
                                             F, C, fd, tp, c0, f0, owns_db, owns_loss,
                                             owns_weight);
      }
    };
    if (xs > 0)
      tile_pass(static_cast<const float*>(here.x), xs);
    else
      tile_pass(global_rows(X, static_cast<size_t>(start) * F), F);
  }
  const size_t chunks = gridDim.x;
  if constexpr (kForm == kNarrow) {
    __syncthreads();  // the last tile's group sums are in
    const int last = tiles - 1;
    const int n = row_end - (row_begin + last * tile);
    add_groups(owned, group_sums_at + (last & 1) * grouped.cells * tile_groups, grouped.cells,
               (n + kGroupRows - 1) / kGroupRows);
#pragma unroll
    for (int k = 0; k < kMaxOwned; ++k) {
      const int cell = threadIdx.x + k * kThreads;
      if (cell >= grouped.cells) continue;
      const int owner_job = cell / grouped.per_job;
      if (owner_job < G) {
        partials[(static_cast<size_t>(job0 + owner_job) * chunks + blockIdx.x) * cells_out +
                 cell - owner_job * grouped.per_job] = owned[k];
      } else {  // the group's rows are one: every job's weights' sum
        for (int j = 0; j < G; ++j)
          partials[(static_cast<size_t>(job0 + j) * chunks + blockIdx.x) * cells_out +
                   cells_out - 1] = owned[k];
      }
    }
  } else {
    if (active) {
      double* out = partials + (static_cast<size_t>(job0 + jl) * chunks + blockIdx.x) * cells_out;
#pragma unroll
      for (int i = 0; i < kCB; ++i) {
        if (c0 + i >= C) continue;
#pragma unroll
        for (int f = 0; f < kW; ++f)
          if (f0 + f < F) out[(f0 + f) * C + c0 + i] = sums.dw[i][f];
        if (owns_db) out[F * C + c0 + i] = sums.db[i];
      }
      if (owns_loss) out[F * C + C] = sums.loss;
    }
    if (owns_weight)  // the group's rows are one: every job's weights' sum
      for (int j = 0; j < G; ++j)
        partials[(static_cast<size_t>(job0 + j) * chunks + blockIdx.x) * cells_out +
                 cells_out - 1] = sums.weight;
  }
}

// Block (chunk, job group): the float64 sums of the (weighted) nll of the
// chunk's rows of each job of the group at each of its four candidate
// parameter sets W4 (4, F, C), b4 (4, C) and, with weights, of the
// weights. A warp takes 64 rows of one job, two a lane (rows r and r + 32,
// so that a parameter load serves both); 16 of its lanes then add each
// (group of 16 rows, candidate) in row order from the warp's scratch, 4
// more the weights'; the groups' sums go to shared memory, where their
// owners add them in group order (as the gradient's narrow form does)
// while the next tile is computed. One barrier a tile.
template <typename In, int kC>
__global__ void __launch_bounds__(kThreads, 2)
    trial_losses_kernel(const void* __restrict__ X_rows, const int* __restrict__ y,
                        const float* __restrict__ weights, const float* __restrict__ W4,
                        const float* __restrict__ b4, double* __restrict__ partials,
                        int rows, int F, int C, int jobs, long long x_job_stride,
                        long long row_job_stride, int rows_per_chunk, const Layout layout) {
  extern __shared__ __align__(16) unsigned char shared[];
  const bool weighted = weights != nullptr;
  const int group = layout.group, tile = layout.tile, xs = layout.xs;
  const int sums_out = kCandidates + (weighted ? 1 : 0);
  constexpr bool kRaw = std::is_same<In, bf16_bits>::value;  // staged tiles come raw
  const int job0 = blockIdx.y * group;
  const int G = min(group, jobs - job0);
  const int set = kCandidates * F * C;  // a job's W4 floats
  const int cells = G * kCandidates + (weighted ? 1 : 0);
  const In* X = static_cast<const In*>(X_rows) + job0 * x_job_stride;
  y += job0 * row_job_stride;
  if (weighted) weights += job0 * row_job_stride;
  W4 += static_cast<size_t>(job0) * set;
  b4 += static_cast<size_t>(job0) * kCandidates * C;
  float* ring = reinterpret_cast<float*>(shared + layout.ring);
  bf16_bits* raw = reinterpret_cast<bf16_bits*>(shared + layout.raw);
  double* group_sums_at = reinterpret_cast<double*>(shared + layout.sums);
  const float* Wg = W4;
  const float* bg = b4;
  if (layout.params_shared) {
    float* sw = reinterpret_cast<float*>(shared + layout.params_w);
    float* sb = reinterpret_cast<float*>(shared + layout.params_b);
    for (int i = threadIdx.x; i < G * set; i += kThreads) sw[i] = W4[i];
    for (int i = threadIdx.x; i < G * kCandidates * C; i += kThreads) sb[i] = b4[i];
    Wg = sw;
    bg = sb;
  }
  const int tile_groups = tile / kGroupRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* warp_scratch = reinterpret_cast<float*>(shared + layout.scratch) + warp * kScratchFloats;
  double owned[kMaxOwned] = {};

  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = min(rows, row_begin + rows_per_chunk);
  const int tiles = (row_end - row_begin + tile - 1) / tile;
  stage_tile(Tile(ring, tile, xs), raw, X, y, weights, row_begin, min(tile, row_end - row_begin),
             F, xs);
  async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int start = row_begin + t * tile;
    const int n = min(tile, row_end - start);
    const Tile here(ring + (t & 1) * layout.buffer_floats, tile, xs);
    double* tile_sums = group_sums_at + (t & 1) * cells * tile_groups;
    async_wait_all();
    __syncthreads();  // the tile has landed; the previous tile's group sums are in
    if constexpr (kRaw) {
      if (xs > 0) {
        widen_tile(here.x, raw + raw_shift(X + static_cast<size_t>(start) * F), n, F, xs);
        __syncthreads();  // the tile is widened: raw is free for the next
      }
    }
    if (t + 1 < tiles) {
      const int next = start + tile;
      stage_tile(Tile(ring + ((t + 1) & 1) * layout.buffer_floats, tile, xs), raw, X, y,
                 weights, next, min(tile, row_end - next), F, xs);
      async_commit();
    }
    if (t > 0)
      add_groups(owned, group_sums_at + ((t - 1) & 1) * cells * tile_groups, cells,
                 tile_groups);
    // the tile's items, x staged or from global memory
    auto tile_pass = [&](auto x, int x_stride) {
      // a warp an item: (job, 64 rows); rows past n compute row 0 again, unused
      const int blocks = (n + kWarpRows - 1) / kWarpRows;
      for (int item = warp; item < G * blocks; item += kThreads / 32) {
        const int j = item / blocks, base = (item - j * blocks) * kWarpRows;
        int r[2], label[2];
        float w[2];
  #pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int row = base + q * 32 + lane;
          r[q] = row < n ? row : 0;
          label[q] = here.y[r[q]];
          w[q] = weighted ? here.w[r[q]] : 1.0f;
        }
        float nll[2][kCandidates];
        rows_trial_nll<kC>(x + r[0] * x_stride, x + r[1] * x_stride, F,
                           Wg + static_cast<size_t>(j) * set, bg + j * kCandidates * C, C, label,
                           w, weighted, nll);
  #pragma unroll
        for (int q = 0; q < 2; ++q) {
          // row q * 32 + lane of the item: group 2 q + lane / 16, row lane % 16
          const int at = (2 * q + lane / 16) * kScratchGroup + lane % 16;
  #pragma unroll
          for (int k = 0; k < kCandidates; ++k) warp_scratch[k * kScratchSet + at] = nll[q][k];
          if (weighted) warp_scratch[kCandidates * kScratchSet + at] = w[q];
        }
        __syncwarp();
        // lanes 0-15: (group lane / 4, candidate lane % 4); 16-19: the weights
        // of group lane - 16, from the first job's items
        const bool adds = lane < 16 || (weighted && j == 0 && lane < 20);
        if (adds) {
          const int k = lane < 16 ? lane % kCandidates : kCandidates;
          const int g = lane < 16 ? lane / kCandidates : lane - 16;
          const int rows_in = max(0, min(kGroupRows, n - (base + g * kGroupRows)));
          const float* terms = warp_scratch + k * kScratchSet + g * kScratchGroup;
          double sum = 0.0;
  #pragma unroll
          for (int i = 0; i < kGroupRows; ++i)
            if (i < rows_in) sum = __dadd_rn(sum, static_cast<double>(terms[i]));
          if (rows_in > 0)
            tile_sums[(base / kGroupRows + g) * cells +
                      (k < kCandidates ? j * kCandidates + k : cells - 1)] = sum;
        }
        __syncwarp();  // the scratch is free for the next item
      }
    };
    if (xs > 0)
      tile_pass(static_cast<const float*>(here.x), xs);
    else
      tile_pass(global_rows(X, static_cast<size_t>(start) * F), F);
  }
  __syncthreads();  // the last tile's group sums are in
  const int last = tiles - 1;
  const int n = row_end - (row_begin + last * tile);
  add_groups(owned, group_sums_at + (last & 1) * cells * tile_groups, cells,
             (n + kGroupRows - 1) / kGroupRows);
  const size_t chunks = gridDim.x;
#pragma unroll
  for (int k = 0; k < kMaxOwned; ++k) {
    const int cell = threadIdx.x + k * kThreads;
    if (cell >= cells) continue;
    const int owner_job = cell / kCandidates;
    if (owner_job < G) {
      partials[(static_cast<size_t>(job0 + owner_job) * chunks + blockIdx.x) * sums_out +
               cell % kCandidates] = owned[k];
    } else {  // the group's rows are one: every job's weights' sum
      for (int j = 0; j < G; ++j)
        partials[(static_cast<size_t>(job0 + j) * chunks + blockIdx.x) * sums_out +
                 kCandidates] = owned[k];
    }
  }
}

// Job blockIdx.y: out[i] = (sum over chunks, in chunk order, of
// partials[chunk][i]) / denominator, rounded once to float32, for the
// `cells` outputs of the job. The denominator is `rows`, or, `weighted`,
// the chunk-ordered sum of the partials' last cell (the weights), which
// follows the outputs. No chunks (no rows) give a loss of 0 / 0 = NaN, as
// the reference's mean over no rows does, and a gradient of 0 in its first
// `gradient_cells` outputs: jax.grad of that mean contracts the cotangent
// over no rows, which is 0 before any division.
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
                  int chunks, int cells, int gradient_cells, double rows, int weighted) {
  const int stride = cells + weighted;
  partials += static_cast<size_t>(blockIdx.y) * chunks * stride;
  out += static_cast<size_t>(blockIdx.y) * cells;
  const double denominator =
      weighted ? sum_chunks(partials, chunks, stride, cells) : rows;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += gridDim.x * blockDim.x)
    out[i] = chunks == 0 && i < gradient_cells
                 ? 0.0f
                 : __double2float_rn(
                       __ddiv_rn(sum_chunks(partials, chunks, stride, i), denominator));
}

// The sums form (a rank's block of rows sharded over ranks): job
// blockIdx.y's un-divided float64 sums, out[i] = the partials' cell i added
// in chunk order (sum_chunks, the same adds as finish_kernel's) for every
// cell of the partials, the weights' last: [sum w dW | sum w db | sum w nll
// | sum w] (loss and gradient) or [sum w nll at each candidate | sum w]
// (trial losses). The caller adds every rank's sums in rank order, divides
// by the global sum of the weights and rounds once to float32.
__global__ void __launch_bounds__(kThreads)
    sums_kernel(const double* __restrict__ partials, double* __restrict__ out, int chunks,
                int stride) {
  partials += static_cast<size_t>(blockIdx.y) * chunks * stride;
  out += static_cast<size_t>(blockIdx.y) * stride;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < stride; i += gridDim.x * blockDim.x)
    out[i] = sum_chunks(partials, chunks, stride, i);
}

typedef void (*K7Kernel)(const void*, const int*, const float*, const float*, const float*,
                         double*, int, int, int, int, long long, long long, int, const Layout);

// C = 2 in registers when the parameters allow 8-byte loads.
bool two_classes(int C, const void* W, const void* b) {
  return C == 2 && reinterpret_cast<uintptr_t>(W) % 8 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 8 == 0;
}

K7Kernel loss_grad_for(bool bf16, bool two, int form) {
  static const K7Kernel table[2][2][3] = {
      {{loss_grad_kernel<float, 0, kNarrow>, loss_grad_kernel<float, 0, kWide>,
        loss_grad_kernel<float, 0, kWideStaged>},
       {loss_grad_kernel<float, 2, kNarrow>, loss_grad_kernel<float, 2, kWide>,
        loss_grad_kernel<float, 2, kWideStaged>}},
      {{loss_grad_kernel<bf16_bits, 0, kNarrow>, loss_grad_kernel<bf16_bits, 0, kWide>,
        loss_grad_kernel<bf16_bits, 0, kWideStaged>},
       {loss_grad_kernel<bf16_bits, 2, kNarrow>, loss_grad_kernel<bf16_bits, 2, kWide>,
        loss_grad_kernel<bf16_bits, 2, kWideStaged>}},
  };
  return table[bf16 ? 1 : 0][two ? 1 : 0][form];
}

K7Kernel trial_losses_for(bool bf16, bool two) {
  static const K7Kernel table[2][2] = {
      {trial_losses_kernel<float, 0>, trial_losses_kernel<float, 2>},
      {trial_losses_kernel<bf16_bits, 0>, trial_losses_kernel<bf16_bits, 2>},
  };
  return table[bf16 ? 1 : 0][two ? 1 : 0];
}

// ---------------------------------------------------------------------------
// K7's class-shard form: a rank holds classes [first, first + Cs) of W and b
// (the reference's W, b sharded over the model axis, ml/logistic.py
// :516-560). Over the model group a row's log-softmax needs every shard's
// classes, so the pass is split in two kernels around the caller's
// collective (ml/logistic.py `_shard_loss_and_grad`, `_shard_trial_losses`):
//
// lo_logistic_shard_stats: for each row of the block and each of `points`
// parameter sets (1: the loss and gradient's point; 4: the Armijo trial
// points, from one read of X), over the shard's classes:
//   out[p][i] = {top_i = max_c z_ic, sum_c exp(z_ic - top_i),
//                z_iy where the label y_i lies in the shard, else 0}
// float32, with K7's roundings: z_c = b_c + the fmaf chain over the
// features in order (the logits of K7's whole-class kernels, bit for bit),
// the shifted logits and their exps added in class order. The caller
// makes each shard's float64 log-sum (top + log sum), gathers them over
// the model group and combines them in model-rank order into each row's
// log-sum-exp; the trial losses come from those and the label logits.
//
// lo_logistic_shard_grad: given each row's log-sum-exp over every class
// (float64, lse), the shard's un-divided float64 sums in K7's sums layout,
//   [sum_i w_i x_if r_ic (F x Cs) | sum_i w_i r_ic (Cs) |
//    sum_{i: y_i in the shard} w_i (lse_i - z_iy) | sum_i w_i],
//   r_ic = exp(z_ic - lse_i) - 1[y_i = first + c]   (float64),
// so that the model group's nll cells add to every row's weighted nll and
// the data group adds the blocks (ml/logistic.py).
//
// What bounds them on this card, at a rank's block of 1,000,000 rows over
// a data axis of 2 (524,288 rows x 16 features, Cs = 1 or 5): stats reads
// X and y once (36 MB) and writes 12 bytes a row and point (25 MB for four
// points): 18 us at 3.35 TB/s; its ~168 M fmaf (four points, Cs = 5) are
// ~5 us at the float32 rate. grad reads X, y, w and lse once (42 MB,
// 12.5 us); its float64 work (~46 M fma for the sums, 2.6 M exp) is a few
// us at the float64 rate. Bytes bound both. The first form (a thread a
// row, each logit computed twice from parameters loaded from global memory
// at every fmaf; a thread a gradient cell, its float64 sum one serial
// chain over the chunk) took 8.3x and 14x those bounds: its parameter
// loads and its idle threads set the pace, not the bytes. This form takes
// ~3x (stats) and ~6x (grad) on an H100 at 700 W (logistic_shard_variants.py):
// the stats' memory path alone ~1.5x, its arithmetic not all hidden
// behind it at two blocks an SM; the grad's tiles, spread and barriers
// alone ~3x, its sums' items and `sums_kernel` (the chunks, one block) the
// rest.
//
// Design (the wrapper, ml/logistic.py `_shard_stats_geometry` and
// `_shard_grad_geometry`, lays out each block's shared memory in a
// `ShardLayout`):
//   - A tile's rows land by 16-byte cp.async, contiguous as they lie in X,
//     in a raw tile (the values before the first and after the last whole
//     16-byte word by loads, so X may start anywhere), and are then spread
//     (float32) or widened (bfloat16) into the tile's x at an odd row
//     stride, where a warp's threads, a row each, read 32 banks: a 16-byte
//     copy cannot land at that stride, and at F = 16 a warp's rows read in
//     place would share two banks. The labels (grad: the weights and the
//     log-sum-exp too) come by 4- and 8-byte cp.async into a ring of two
//     buffers. The stats issue the next tile's copies once this tile's raw
//     x is spread, so that they land while it is computed; the grad keeps
//     three tiles' raw x and buffers in a ring (kGradStages), the next two
//     tiles in flight while one is spread and computed. Rows too wide to
//     stage (a tile of 32 past the block's share) are read from global
//     memory.
//   - The parameters (every point's W and b) sit in shared memory once a
//     block, a feature's classes at a stride of Cs rounded up to 4, so that
//     a warp reads four classes with one broadcast 16-byte load; past their
//     share they are read from global memory.
//   - A row's logits: all of the shard's classes at once, feature-major
//     (x_f read once, then z_c = fmaf(x_f, W[f][c], z_c) for every class),
//     in registers up to kRegisterClasses classes: each class's chain is
//     the fmaf chain over the features in order from 0, then + b_c, dot()'s
//     bits. Past kRegisterClasses each logit is computed again in each pass
//     (dot() itself), so no class count runs out of registers.
//   - stats: a thread kStatsRows rows (a parameter load serves each), a
//     tile kThreads * kStatsRows rows, a grid of the blocks the card holds
//     at once walking the tiles. The max in class order, the exps added in
//     class order from 0 with __fadd_rn, the accurate expf: the first
//     form's arithmetic, so its bits at every shape. A tile's outputs are
//     gathered in shared memory and written as 16-byte words.
//   - grad: a block a chunk of rows (kernels.row_chunks), a tile at a time.
//     Phase 1, a thread a row: its residuals, nll term and weight as
//     float64 in shared memory (the first form's arithmetic: the float64
//     exp(z - lse), the __dmul_rn by the weight). Phase 2, the float64 sums
//     in K7's fixed shape: a cell's sum over a chunk is the sum of its
//     16-row groups (kGroupRows), each from 0 in row order, added in group
//     order. The narrow form gives any thread any (group, item), an item
//     a feature's cells for up to kGradClasses classes (one float64 x a
//     row for all of them), the same classes' db cells, or the nll and the
//     weights; so all threads work at 19 or 87 cells, and each cell's
//     owner adds the previous tile's groups while this one is computed.
//     Past kMaxOwned cells a thread, or where a tile's group sums do not
//     fit, the serial form gives a thread a cell, its groups in order, its
//     running sum in `partials`. Both give the same bits; `sums_kernel`
//     adds the chunks in chunk order. No float atomics: the groups and the
//     chunks are a function of the row count alone, so a second launch is
//     bit-equal and a refit bit-identical. The first form added each
//     cell's rows in one chain over the chunk; the groups reassociate those
//     sums, so the grad's bits differ from the first form's (within K7's
//     tolerances of the twin). No consumer needed those bits: the data
//     group adds the ranks' sums in rank order, and the model axis's fit
//     agrees with one rank's within a tolerance, not bit for bit.
//   - Any Cs >= 1 (K7's two-class specialisation does not serve a shard,
//     whose label may lie outside it), any F >= 1, 1 or 4 points, float32
//     or bfloat16 rows.
// ---------------------------------------------------------------------------

constexpr int kStatsRows = 2;      // a stats thread's rows (ml/logistic.py _STATS_ROWS)
// The grad's ring of tiles (ml/logistic.py _GRAD_STAGES): two in flight
// while one is computed
constexpr int kGradStages = 3;
constexpr int kGradClasses = 8;    // a narrow grad item's classes (_GRAD_CLASSES)
constexpr int kShardNarrow = 0, kShardSerial = 1;   // _SHARD_NARROW, _SHARD_SERIAL
constexpr int kMaxSharedBytes = 232448;             // kernels.SHARED_BYTES

// Wait until at most N of this thread's latest cp.async groups are pending.
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void copy_async8(void* shared, const void* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(address), "l"(global)
               : "memory");
}

// The parameter sets W (sets, F, Cs), b (sets, Cs) into shared memory, a
// feature's classes at stride ws (Cs rounded up to 4), padded with 0.
__device__ __forceinline__ void stage_params(float* sw, float* sb, const float* __restrict__ W,
                                             const float* __restrict__ b, int sets, int F, int Cs,
                                             int ws) {
  for (int i = threadIdx.x; i < sets * F * ws; i += kThreads) {
    const int row = i / ws, c = i - row * ws;
    sw[i] = c < Cs ? W[static_cast<size_t>(row) * Cs + c] : 0.0f;
  }
  for (int i = threadIdx.x; i < sets * ws; i += kThreads) {
    const int set = i / ws, c = i - set * ws;
    sb[i] = c < Cs ? b[set * Cs + c] : 0.0f;
  }
}

// Classes c .. c + 3 of a feature's parameters: one 16-byte load from the
// shared copy, or loads from global memory (0 past Cs).
template <bool kShared>
__device__ __forceinline__ float4 class_quad(const float* W_f, int c, int Cs) {
  if constexpr (kShared) {
    return *reinterpret_cast<const float4*>(W_f + c);
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < Cs ? __ldg(W_f + c + j) : 0.0f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// kR rows' logits without b at one parameter set (a feature's classes at
// stride ws), the first kC classes (kC: 1, or Cs rounded up to 4, the
// padding's parameters 0): feature-major, x_f read once a row, each
// class's chain dot()'s fmaf chain over the features in order. No guard
// in the loop: the caller uses classes [0, Cs) only.
template <int kR, int kC, bool kShared, typename XP>
__device__ __forceinline__ void class_logits(const XP (&x)[kR], int F, const float* W, int ws,
                                             int Cs, float (&z)[kR][kRegisterClasses]) {
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    float xf[kR];
#pragma unroll
    for (int q = 0; q < kR; ++q) xf[q] = x[q][f];
    const float* W_f = W + static_cast<size_t>(f) * ws;
    if constexpr (kC == 1) {
      const float w = W_f[0];
#pragma unroll
      for (int q = 0; q < kR; ++q) z[q][0] = fmaf(xf[q], w, z[q][0]);
    } else {
#pragma unroll
      for (int c = 0; c < kC; c += 4) {
        const float4 quad = class_quad<kShared>(W_f, c, Cs);
        const float w[4] = {quad.x, quad.y, quad.z, quad.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < kR; ++q) z[q][c + j] = fmaf(xf[q], w[j], z[q][c + j]);
      }
    }
  }
}

// kR rows' logits without b, Cs <= kRegisterClasses: class_logits at the
// least class count that holds Cs; with the parameters in global memory
// (past their share: wide rows, a rarer path) at kRegisterClasses, which
// keeps the build short.
template <int kR, bool kShared, typename XP>
__device__ __forceinline__ void register_logits(const XP (&x)[kR], int F, const float* W, int ws,
                                                int Cs, float (&z)[kR][kRegisterClasses]) {
#pragma unroll
  for (int q = 0; q < kR; ++q)
#pragma unroll
    for (int c = 0; c < kRegisterClasses; ++c) z[q][c] = 0.0f;
  if constexpr (!kShared)
    class_logits<kR, kRegisterClasses, kShared>(x, F, W, ws, Cs, z);
  else if (Cs == 1)
    class_logits<kR, 1, kShared>(x, F, W, ws, Cs, z);
  else if (Cs <= 4)
    class_logits<kR, 4, kShared>(x, F, W, ws, Cs, z);
  else if (Cs <= 8)
    class_logits<kR, 8, kShared>(x, F, W, ws, Cs, z);
  else
    class_logits<kR, 16, kShared>(x, F, W, ws, Cs, z);
}

// kR rows' stats at one point (W at stride ws, b): the largest logit, the
// sum of the exps about it in class order, and the label's logit (0 when
// the label lies outside the shard).
template <int kR, bool kShared, typename XP>
__device__ __forceinline__ void rows_stats(const XP (&x)[kR], int F, const float* W,
                                           const float* b, int ws, int Cs,
                                           const int (&local)[kR], float (&top)[kR],
                                           float (&sum)[kR], float (&at)[kR]) {
  if (Cs <= kRegisterClasses) {
    float z[kR][kRegisterClasses];
    register_logits<kR, kShared>(x, F, W, ws, Cs, z);
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      top[q] = -INFINITY;
#pragma unroll
      for (int c = 0; c < kRegisterClasses; ++c)
        if (c < Cs) {
          z[q][c] = __fadd_rn(z[q][c], b[c]);
          top[q] = fmaxf(top[q], z[q][c]);
        }
      sum[q] = 0.0f;
      at[q] = 0.0f;
#pragma unroll
      for (int c = 0; c < kRegisterClasses; ++c)
        if (c < Cs) {
          sum[q] = __fadd_rn(sum[q], expf(__fsub_rn(z[q][c], top[q])));
          if (c == local[q]) at[q] = z[q][c];
        }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      top[q] = -INFINITY;
      for (int c = 0; c < Cs; ++c) top[q] = fmaxf(top[q], __fadd_rn(dot(x[q], F, W, ws, c), b[c]));
      sum[q] = 0.0f;
      at[q] = 0.0f;
      for (int c = 0; c < Cs; ++c) {
        const float z = __fadd_rn(dot(x[q], F, W, ws, c), b[c]);
        sum[q] = __fadd_rn(sum[q], expf(__fsub_rn(z, top[q])));
        if (c == local[q]) at[q] = z;
      }
    }
  }
}

// A float's offset in its 16-byte word.
__device__ __forceinline__ int word_shift(const float* at) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(at) >> 2) & 3);
}

// `count` floats gathered in shared memory (value i at stage[word_shift(dst)
// + i], stage on 16 bytes) to dst: the whole 16-byte words by 16-byte
// stores, the values before the first and after the last one by one.
__device__ __forceinline__ void store_words(float* __restrict__ dst, const float* stage,
                                            int count) {
  const int shift = word_shift(dst);
  const int head = min(count, (4 - shift) & 3);
  const int words = (count - head) / 4;
  const float4* from = reinterpret_cast<const float4*>(stage + shift + head);
  float4* to = reinterpret_cast<float4*>(dst + head);
  for (int i = threadIdx.x; i < words; i += kThreads) to[i] = from[i];
  const int tail = head + 4 * words, edges = head + count - tail;
  for (int i = threadIdx.x; i < edges; i += kThreads) {
    const int at = i < head ? i : tail + i - head;
    dst[at] = stage[shift + at];
  }
}

// The tiles walk the rows, tile k at rows [k * tile, ...), k = blockIdx.x
// + i * gridDim.x: a block's tile i + 1 lands in ring buffer (i + 1) & 1
// (its x in the raw tile, spread at i) while tile i is computed.
template <typename In, bool kShared>
__global__ void __launch_bounds__(kThreads, 2)
    shard_stats_tiles_kernel(const void* __restrict__ X_rows, const int* __restrict__ y,
                             const float* __restrict__ W, const float* __restrict__ b,
                             float* __restrict__ out, int rows, int F, int Cs, int points,
                             int first, const ShardLayout layout) {
  extern __shared__ __align__(16) unsigned char shared[];
  const In* X = static_cast<const In*>(X_rows);
  const int tile = layout.tile, xs = layout.xs;
  const float* Wp = W;
  const float* bp = b;
  int ws = Cs;
  if constexpr (kShared) {
    float* sw = reinterpret_cast<float*>(shared + layout.params_w);
    float* sb = reinterpret_cast<float*>(shared + layout.params_b);
    ws = layout.ws;
    stage_params(sw, sb, W, b, points, F, Cs, ws);
    Wp = sw;
    bp = sb;
  }
  In* raw = reinterpret_cast<In*>(shared + layout.raw);
  float* x_tile = reinterpret_cast<float*>(shared + layout.x);
  int* labels = reinterpret_cast<int*>(shared + layout.ring);
  float* stage = reinterpret_cast<float*>(shared + layout.stage);
  const int tiles = (rows + tile - 1) / tile;
  auto issue = [&](int k, int buffer) {  // the copies of tile k
    const int start = k * tile, n = min(tile, rows - start);
    if (xs > 0) stage_raw(raw, X + static_cast<size_t>(start) * F, n * F);
    for (int i = threadIdx.x; i < n; i += kThreads)
      copy_async4(labels + buffer * tile + i, y + start + i);
    async_commit();
  };
  int k = blockIdx.x;
  if (k < tiles) issue(k, 0);
  for (int i = 0; k < tiles; k += gridDim.x, ++i) {
    const int start = k * tile, n = min(tile, rows - start);
    const int* tile_labels = labels + (i & 1) * tile;
    async_wait_all();
    __syncthreads();  // the tile has landed (and the parameters); the last outputs are stored
    if (xs > 0) {
      widen_tile(x_tile, raw + raw_shift(X + static_cast<size_t>(start) * F), n, F, xs);
      __syncthreads();  // the rows are in x: raw is free for the next tile
    }
    if (k + static_cast<int>(gridDim.x) < tiles) issue(k + gridDim.x, (i + 1) & 1);
    auto pass = [&](auto x0, int stride) {  // x staged or from global memory
      decltype(x0) x[kStatsRows];
      int local[kStatsRows];
#pragma unroll
      for (int q = 0; q < kStatsRows; ++q) {
        const int r = q * kThreads + threadIdx.x;
        const int row = r < n ? r : 0;  // rows past the tile compute row 0 again, unused
        x[q] = x0 + static_cast<long long>(row) * stride;
        local[q] = tile_labels[row] - first;
      }
      for (int p = 0; p < points; ++p) {
        float top[kStatsRows], sum[kStatsRows], at[kStatsRows];
        rows_stats<kStatsRows, kShared>(x, F, Wp + static_cast<size_t>(p) * F * ws, bp + p * ws,
                                        ws, Cs, local, top, sum, at);
        float* o = stage + p * layout.stage_floats +
                   word_shift(out + (static_cast<size_t>(p) * rows + start) * 3);
#pragma unroll
        for (int q = 0; q < kStatsRows; ++q) {
          const int r = q * kThreads + threadIdx.x;
          if (r < n) {
            o[3 * r] = top[q];
            o[3 * r + 1] = sum[q];
            o[3 * r + 2] = at[q];
          }
        }
      }
    };
    if (xs > 0)
      pass(static_cast<const float*>(x_tile), xs);
    else
      pass(global_rows(X, static_cast<size_t>(start) * F), F);
    __syncthreads();  // the tile's outputs are gathered
    for (int p = 0; p < points; ++p)
      store_words(out + (static_cast<size_t>(p) * rows + start) * 3,
                  stage + p * layout.stage_floats, 3 * n);
  }
}

// One item's group sums over rows [r0, r1) in row order, kN classes from
// t0 (a class's terms at stride tp): x_f r_c (f < F), or r_c (db, f = F:
// 1.0 r_c + s, one rounding, __dadd_rn's bits).
template <int kN, typename XP>
__device__ __forceinline__ void item_sums(double (&s)[kGradClasses], XP x, int stride,
                                          const double* t0, int tp, int f, int F, int r0, int r1) {
  auto add_row = [&](int r) {
    const double a = f < F ? static_cast<double>(x[static_cast<long long>(r) * stride + f]) : 1.0;
#pragma unroll
    for (int i = 0; i < kN; ++i) s[i] = __fma_rn(a, t0[i * tp + r], s[i]);
  };
  if (r1 - r0 == kGroupRows) {  // a whole group's rows unrolled
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) add_row(r0 + r);
  } else {
    for (int r = r0; r < r1; ++r) add_row(r);
  }
}

// The narrow form: each (group, item) of the tile's n rows to any thread,
// items fastest. Item (f, class block) sums x_f r_c for the block's
// classes, (F, class block) their r_c (db), the last item the nll and the
// weights: each cell's group sum from 0 in row order, into sums[group *
// cells + cell].
template <typename XP>
__device__ __forceinline__ void grad_items(double* __restrict__ sums, XP x, int stride,
                                           const double* terms, int tp, const double* nll,
                                           const double* wd, int n, int F, int Cs, int cells) {
  const int blocks = (Cs + kGradClasses - 1) / kGradClasses;
  const int per_group = (F + 1) * blocks + 1;
  const int groups = (n + kGroupRows - 1) / kGroupRows;
  for (int item = threadIdx.x; item < groups * per_group; item += kThreads) {
    const int group = item / per_group, j = item - group * per_group;
    const int r0 = group * kGroupRows, r1 = min(n, r0 + kGroupRows);
    double* out = sums + static_cast<size_t>(group) * cells;
    if (j == per_group - 1) {
      double nll_sum = 0.0, weight_sum = 0.0;
      for (int r = r0; r < r1; ++r) {
        nll_sum = __dadd_rn(nll_sum, nll[r]);
        weight_sum = __dadd_rn(weight_sum, wd[r]);
      }
      out[F * Cs + Cs] = nll_sum;
      out[F * Cs + Cs + 1] = weight_sum;
      continue;
    }
    const int f = j / blocks, c0 = (j - f * blocks) * kGradClasses;
    const int classes = min(kGradClasses, Cs - c0);
    const double* t0 = terms + static_cast<size_t>(c0) * tp;
    double s[kGradClasses];
#pragma unroll
    for (int i = 0; i < kGradClasses; ++i) s[i] = 0.0;
    switch (classes) {  // the block's classes, unguarded in the rows' loop
      case 1: item_sums<1>(s, x, stride, t0, tp, f, F, r0, r1); break;
      case 2: item_sums<2>(s, x, stride, t0, tp, f, F, r0, r1); break;
      case 3: item_sums<3>(s, x, stride, t0, tp, f, F, r0, r1); break;
      case 4: item_sums<4>(s, x, stride, t0, tp, f, F, r0, r1); break;
      case 5: item_sums<5>(s, x, stride, t0, tp, f, F, r0, r1); break;
      case 6: item_sums<6>(s, x, stride, t0, tp, f, F, r0, r1); break;
      case 7: item_sums<7>(s, x, stride, t0, tp, f, F, r0, r1); break;
      default: item_sums<kGradClasses>(s, x, stride, t0, tp, f, F, r0, r1); break;
    }
    double* to = out + (f < F ? f * Cs : F * Cs) + c0;
#pragma unroll
    for (int i = 0; i < kGradClasses; ++i)
      if (i < classes) to[i] = s[i];
  }
}

// The serial form: a thread a cell, the tile's groups in order (each from 0
// in row order) added to the cell's running sum in `chunk_sums` (from 0 at
// the chunk's first tile): the narrow form's bits.
template <typename XP>
__device__ __forceinline__ void serial_cells(double* __restrict__ chunk_sums, bool first_tile,
                                             XP x, int stride, const double* terms, int tp,
                                             const double* nll, const double* wd, int n, int F,
                                             int Cs, int cells) {
  const int FC = F * Cs;
  for (int cell = threadIdx.x; cell < cells; cell += kThreads) {
    const int f = cell < FC ? cell / Cs : -1;
    const double* term = cell < FC        ? terms + static_cast<size_t>(cell - f * Cs) * tp
                         : cell < FC + Cs ? terms + static_cast<size_t>(cell - FC) * tp
                         : cell == FC + Cs ? nll
                                           : wd;
    double sum = first_tile ? 0.0 : chunk_sums[cell];
    for (int r0 = 0; r0 < n; r0 += kGroupRows) {
      const int r1 = min(n, r0 + kGroupRows);
      double s = 0.0;
      for (int r = r0; r < r1; ++r)  // 1.0 t + s: __dadd_rn's bits
        s = __fma_rn(f >= 0 ? static_cast<double>(x[static_cast<long long>(r) * stride + f]) : 1.0,
                     term[r], s);
      sum = __dadd_rn(sum, s);
    }
    chunk_sums[cell] = sum;
  }
}

// Block: a chunk of rows, its float64 sums into partials[chunk].
template <typename In, bool kShared, int kForm>
__global__ void __launch_bounds__(kThreads, 2)
    shard_grad_tiles_kernel(const void* __restrict__ X_rows, const int* __restrict__ y,
                      const float* __restrict__ w, const double* __restrict__ lse,
                      const float* __restrict__ W, const float* __restrict__ b,
                      double* __restrict__ partials, int rows, int F, int Cs, int first,
                      int rows_per_chunk, const ShardLayout layout) {
  extern __shared__ __align__(16) unsigned char shared[];
  const In* X = static_cast<const In*>(X_rows);
  const int tile = layout.tile, xs = layout.xs, tp = layout.tp;
  const int cells = F * Cs + Cs + 2;
  const float* Wp = W;
  const float* bp = b;
  int ws = Cs;
  if constexpr (kShared) {
    float* sw = reinterpret_cast<float*>(shared + layout.params_w);
    float* sb = reinterpret_cast<float*>(shared + layout.params_b);
    ws = layout.ws;
    stage_params(sw, sb, W, b, 1, F, Cs, ws);
    Wp = sw;
    bp = sb;
  }
  In* raw = reinterpret_cast<In*>(shared + layout.raw);
  float* x_tile = reinterpret_cast<float*>(shared + layout.x);
  unsigned char* ring = shared + layout.ring;
  double* terms = reinterpret_cast<double*>(shared + layout.terms);
  double* nll = reinterpret_cast<double*>(shared + layout.nll);
  double* wd = reinterpret_cast<double*>(shared + layout.wd);
  double* group_sums = reinterpret_cast<double*>(shared + layout.sums);
  double* chunk_sums = partials + static_cast<size_t>(blockIdx.x) * cells;
  const long long chunk_begin = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long all_rows = rows;
  const int row0 = static_cast<int>(min(chunk_begin, all_rows));
  const int row1 = static_cast<int>(min(chunk_begin + rows_per_chunk, all_rows));
  const int tiles = (row1 - row0 + tile - 1) / tile;
  if (tiles == 0) {  // no rows: sums of 0
    for (int cell = threadIdx.x; cell < cells; cell += kThreads) chunk_sums[cell] = 0.0;
    return;
  }
  // ring slot t % kGradStages: tile t's raw x, its lse (doubles), labels and
  // weights; a commit a tile, none past the last, so that the groups count
  // the same on every tile
  const int raw_values = tile * F + kWordValues<In>;
  auto issue = [&](int t) {
    if (t < tiles) {
      const int start = row0 + t * tile, n = min(tile, row1 - start), slot = t % kGradStages;
      if (xs > 0) stage_raw(raw + slot * raw_values, X + static_cast<size_t>(start) * F, n * F);
      unsigned char* to = ring + slot * layout.buffer;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        copy_async8(reinterpret_cast<double*>(to) + i, lse + start + i);
        copy_async4(reinterpret_cast<int*>(to + 8 * tile) + i, y + start + i);
        copy_async4(reinterpret_cast<float*>(to + 12 * tile) + i, w + start + i);
      }
    }
    async_commit();
  };
  const int tile_groups = tile / kGroupRows;
  double owned[kMaxOwned] = {};
  for (int t = 0; t < kGradStages - 1; ++t) issue(t);
  for (int t = 0; t < tiles; ++t) {
    const int start = row0 + t * tile, n = min(tile, row1 - start), slot = t % kGradStages;
    const unsigned char* here = ring + slot * layout.buffer;
    const double* tile_lse = reinterpret_cast<const double*>(here);
    const int* tile_labels = reinterpret_cast<const int*>(here + 8 * tile);
    const float* tile_weights = reinterpret_cast<const float*>(here + 12 * tile);
    async_wait<kGradStages - 2>();
    __syncthreads();  // the tile has landed (and the parameters); the last tile's sums are done
    // the tile kGradStages - 1 ahead, into the last tile's slot
    issue(t + kGradStages - 1);
    if (xs > 0) {
      widen_tile(x_tile, raw + slot * raw_values + raw_shift(X + static_cast<size_t>(start) * F),
                 n, F, xs);
      __syncthreads();  // the rows are in x
    }
    auto pass = [&](auto x0, int stride) {  // x staged or from global memory
      // phase 1: a thread a row
      for (int r = threadIdx.x; r < n; r += kThreads) {
        const int local = tile_labels[r] - first;
        const double row_lse = tile_lse[r];
        const double weight = static_cast<double>(tile_weights[r]);
        decltype(x0) xr[1] = {x0 + static_cast<long long>(r) * stride};
        double at_label = 0.0;
        auto term = [&](int c, float z) {  // z: the logit with b
          const double zd = static_cast<double>(z);
          const double residual = __dsub_rn(exp(__dsub_rn(zd, row_lse)), c == local ? 1.0 : 0.0);
          terms[static_cast<size_t>(c) * tp + r] = __dmul_rn(residual, weight);
          if (c == local) at_label = zd;
        };
        if (Cs <= kRegisterClasses) {
          float z[1][kRegisterClasses];
          register_logits<1, kShared>(xr, F, Wp, ws, Cs, z);
#pragma unroll
          for (int c = 0; c < kRegisterClasses; ++c)
            if (c < Cs) term(c, __fadd_rn(z[0][c], bp[c]));
        } else {
          for (int c = 0; c < Cs; ++c) term(c, __fadd_rn(dot(xr[0], F, Wp, ws, c), bp[c]));
        }
        nll[r] = local >= 0 && local < Cs ? __dmul_rn(__dsub_rn(row_lse, at_label), weight) : 0.0;
        wd[r] = weight;
      }
      __syncthreads();  // the terms are in
      // phase 2: the sums, group by group
      if constexpr (kForm == kShardNarrow) {
        // the previous tile's group sums into their owners' (that tile was whole)
        if (t > 0)
          add_groups(owned, group_sums + ((t - 1) & 1) * tile_groups * cells, cells, tile_groups);
        grad_items(group_sums + (t & 1) * tile_groups * cells, x0, stride, terms, tp, nll, wd, n,
                   F, Cs, cells);
      } else {
        serial_cells(chunk_sums, t == 0, x0, stride, terms, tp, nll, wd, n, F, Cs, cells);
      }
    };
    if (xs > 0)
      pass(static_cast<const float*>(x_tile), xs);
    else
      pass(global_rows(X, static_cast<size_t>(start) * F), F);
  }
  if constexpr (kForm == kShardNarrow) {
    __syncthreads();  // the last tile's group sums are in
    const int last = tiles - 1;
    const int n = row1 - (row0 + last * tile);
    add_groups(owned, group_sums + (last & 1) * tile_groups * cells, cells,
               (n + kGroupRows - 1) / kGroupRows);
#pragma unroll
    for (int k = 0; k < kMaxOwned; ++k) {
      const int cell = threadIdx.x + k * kThreads;
      if (cell < cells) chunk_sums[cell] = owned[k];
    }
  }
}

typedef void (*ShardStatsKernel)(const void*, const int*, const float*, const float*, float*, int,
                                 int, int, int, int, const ShardLayout);
typedef void (*ShardGradKernel)(const void*, const int*, const float*, const double*,
                                const float*, const float*, double*, int, int, int, int, int,
                                const ShardLayout);

ShardStatsKernel shard_stats_for(bool bf16, bool shared_params) {
  static const ShardStatsKernel table[2][2] = {
      {shard_stats_tiles_kernel<float, false>, shard_stats_tiles_kernel<float, true>},
      {shard_stats_tiles_kernel<bf16_bits, false>, shard_stats_tiles_kernel<bf16_bits, true>},
  };
  return table[bf16 ? 1 : 0][shared_params ? 1 : 0];
}

// The narrow form's cells (at most kMaxOwned * kThreads) keep their
// parameters in shared memory at any F (ml/logistic.py _params_shared), so
// it has no global-parameters kernel.
ShardGradKernel shard_grad_for(bool bf16, bool shared_params, int form) {
  static const ShardGradKernel table[2][3] = {
      {shard_grad_tiles_kernel<float, true, kShardNarrow>,
       shard_grad_tiles_kernel<float, false, kShardSerial>,
       shard_grad_tiles_kernel<float, true, kShardSerial>},
      {shard_grad_tiles_kernel<bf16_bits, true, kShardNarrow>,
       shard_grad_tiles_kernel<bf16_bits, false, kShardSerial>,
       shard_grad_tiles_kernel<bf16_bits, true, kShardSerial>},
  };
  return table[bf16 ? 1 : 0][form == kShardNarrow ? 0 : shared_params ? 2 : 1];
}

// A class-shard layout the kernels can run: whole units of rows in a tile,
// no more than its threads take, strides that hold a row and a feature's
// classes, and no more shared memory than a block may have.
bool valid_shard_layout(const ShardLayout& l, int F, int Cs, int unit, int most) {
  if (l.tile < unit || l.tile % unit != 0 || l.tile > most) return false;
  if (l.xs != 0 && l.xs < F) return false;
  if (l.ws != 0 && (l.ws < Cs || l.ws % 4 != 0)) return false;
  return l.bytes >= 0 && l.bytes <= kMaxSharedBytes;
}

bool valid_geometry(int F, int C, int jobs, const Layout& layout, long long x_job_stride,
                    long long row_job_stride, int tile_multiple, int x_bf16) {
  if (F <= 0 || C <= 0 || jobs < 0 || layout.group <= 0) return false;
  if ((layout.x_bf16 != 0) != (x_bf16 != 0)) return false;  // the raw tile is X's type's
  if (layout.tile < tile_multiple || layout.tile % tile_multiple != 0) return false;
  if (layout.cells > kMaxOwned * kThreads) return false;
  // the jobs of a group share their rows
  return layout.group == 1 || (x_job_stride == 0 && row_job_stride == 0);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream) of
// `device`, does not synchronize, and returns cudaGetLastError() after its
// launches: 0 means they were accepted. Outputs and scratch are allocated
// by the caller. `layout` is the wrapper's geometry and shared-memory
// layout (ml/logistic.py `_k7_layout`).

// J = `jobs` jobs: X (float32, or bfloat16 when x_bf16) of job j at
// j * x_job_stride values (0: one shared X), y and weights (null: unweighted) at j * row_job_stride entries, W
// (J, F, C), b (J, C). partials: J * chunks * (F*C + C + 1 + weighted)
// doubles of scratch; out: (J, F*C + C + 1) floats, [dW (F, C) | db (C) |
// loss] a job. The sums form (`sums` not null, weighted only): no `out`;
// sums (J, F*C + C + 2) doubles, the un-divided [sum w dW | sum w db |
// sum w nll | sum w] a job.
int lo_logistic_loss_grad(const void* X, int x_bf16, const int* y, const float* weights,
                          const float* W, const float* b, double* partials,
                          float* out, double* sums, int rows, int F, int C, int jobs,
                          long long x_job_stride, long long row_job_stride,
                          int chunks, int rows_per_chunk, const Layout* layout,
                          int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const int form = layout->form, group = layout->group;
  if (!valid_geometry(F, C, jobs, *layout, x_job_stride, row_job_stride, kGroupRows, x_bf16) ||
      form < kNarrow || form > kWideStaged)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int weighted = weights != nullptr ? 1 : 0;
  if (sums != nullptr && !weighted) return cudaErrorInvalidValue;
  const int cells = F * C + C + 1;
  const int partial_cells = cells + weighted;
  long long windows = 1;
  if (form != kNarrow) {
    const long long per_job = static_cast<long long>((C + kWideClasses - 1) / kWideClasses) *
                              ((F + kWideFeatures - 1) / kWideFeatures);
    windows = (group * per_job + kThreads - 1) / kThreads;
    if ((group > 1 && windows > 1) || windows > kMaxGridYZ) return cudaErrorInvalidValue;
  }
  const K7Kernel kernel = loss_grad_for(x_bf16 != 0, two_classes(C, W, b), form);
  const char* X_bytes = static_cast<const char*>(X);
  const long long x_value_bytes = x_bf16 ? 2 : 4;
  if (chunks > 0) {
    error = allow_shared(kernel, layout->bytes);
    if (error != cudaSuccess) return error;
  }
  const long long jobs_per_launch = static_cast<long long>(kMaxGridYZ) * group;
  for (long long j0 = 0; j0 < jobs; j0 += jobs_per_launch) {
    const int launch_jobs = static_cast<int>(std::min<long long>(jobs_per_launch, jobs - j0));
    double* launch_partials =
        partials + static_cast<size_t>(j0) * std::max(chunks, 1) * partial_cells;
    if (chunks > 0) {
      const dim3 grid(chunks, (launch_jobs + group - 1) / group, static_cast<int>(windows));
      kernel<<<grid, kThreads, layout->bytes, s>>>(
          X_bytes + j0 * x_job_stride * x_value_bytes, y + j0 * row_job_stride,
          weighted ? weights + j0 * row_job_stride : nullptr,
          W + static_cast<size_t>(j0) * F * C, b + static_cast<size_t>(j0) * C,
          launch_partials, rows, F, C, launch_jobs, x_job_stride, row_job_stride,
          rows_per_chunk, *layout);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
    for (int g0 = 0; g0 < launch_jobs; g0 += kMaxGridYZ) {
      const int finish_jobs = std::min(kMaxGridYZ, launch_jobs - g0);
      const double* finish_partials =
          launch_partials + static_cast<size_t>(g0) * std::max(chunks, 1) * partial_cells;
      if (sums != nullptr)
        sums_kernel<<<dim3(grid_for(partial_cells, max_blocks), finish_jobs), kThreads, 0, s>>>(
            finish_partials, sums + static_cast<size_t>(j0 + g0) * partial_cells, chunks,
            partial_cells);
      else
        finish_kernel<<<dim3(grid_for(cells, max_blocks), finish_jobs), kThreads, 0, s>>>(
            finish_partials, out + static_cast<size_t>(j0 + g0) * cells, chunks, cells,
            F * C + C, static_cast<double>(rows), weighted);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
  }
  return cudaSuccess;
}

// Jobs as above, W4 (J, 4, F, C), b4 (J, 4, C); partials: J * chunks *
// (4 + weighted) doubles of scratch; out: (J, 4) floats, the (weighted)
// mean nll at each candidate. The sums form (`sums` not null, weighted
// only): no `out`; sums (J, 5) doubles, [sum w nll at each candidate |
// sum w] a job.
int lo_logistic_trial_losses(const void* X, int x_bf16, const int* y,
                             const float* weights, const float* W4,
                             const float* b4, double* partials, float* out, double* sums,
                             int rows, int F, int C, int jobs,
                             long long x_job_stride, long long row_job_stride,
                             int chunks, int rows_per_chunk, const Layout* layout, int device,
                             void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const int group = layout->group;
  // a tile holds whole 64-row warp items
  if (!valid_geometry(F, C, jobs, *layout, x_job_stride, row_job_stride, kWarpRows, x_bf16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int weighted = weights != nullptr ? 1 : 0;
  if (sums != nullptr && !weighted) return cudaErrorInvalidValue;
  const int partial_cells = kCandidates + weighted;
  const K7Kernel kernel = trial_losses_for(x_bf16 != 0, two_classes(C, W4, b4));
  const char* X_bytes = static_cast<const char*>(X);
  const long long x_value_bytes = x_bf16 ? 2 : 4;
  if (chunks > 0) {
    error = allow_shared(kernel, layout->bytes);
    if (error != cudaSuccess) return error;
  }
  const long long jobs_per_launch = static_cast<long long>(kMaxGridYZ) * group;
  for (long long j0 = 0; j0 < jobs; j0 += jobs_per_launch) {
    const int launch_jobs = static_cast<int>(std::min<long long>(jobs_per_launch, jobs - j0));
    double* launch_partials =
        partials + static_cast<size_t>(j0) * std::max(chunks, 1) * partial_cells;
    if (chunks > 0) {
      kernel<<<dim3(chunks, (launch_jobs + group - 1) / group), kThreads, layout->bytes, s>>>(
          X_bytes + j0 * x_job_stride * x_value_bytes, y + j0 * row_job_stride,
          weighted ? weights + j0 * row_job_stride : nullptr,
          W4 + static_cast<size_t>(j0) * kCandidates * F * C,
          b4 + static_cast<size_t>(j0) * kCandidates * C, launch_partials, rows, F, C,
          launch_jobs, x_job_stride, row_job_stride, rows_per_chunk, *layout);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
    for (int g0 = 0; g0 < launch_jobs; g0 += kMaxGridYZ) {
      const int finish_jobs = std::min(kMaxGridYZ, launch_jobs - g0);
      const double* finish_partials =
          launch_partials + static_cast<size_t>(g0) * std::max(chunks, 1) * partial_cells;
      if (sums != nullptr)
        sums_kernel<<<dim3(1, finish_jobs), kThreads, 0, s>>>(
            finish_partials, sums + static_cast<size_t>(j0 + g0) * partial_cells, chunks,
            partial_cells);
      else
        finish_kernel<<<dim3(1, finish_jobs), kThreads, 0, s>>>(
            finish_partials, out + static_cast<size_t>(j0 + g0) * kCandidates, chunks,
            kCandidates, 0, static_cast<double>(rows), weighted);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
  }
  return cudaSuccess;
}

// K7's class-shard form (ml/logistic.py `shard_stats`, `shard_grad`): X
// (rows, F) float32, or bfloat16 when x_bf16; y (rows,) int32 (global
// labels); the shard's classes [first, first + Cs); `layout` the block's
// geometry (ml/logistic.py `_shard_stats_layout`, `_shard_grad_layout`).
// stats: W (points, F, Cs), b (points, Cs); out (points, rows, 3) floats;
// a grid of the blocks the card holds at once (at most max_blocks).
int lo_logistic_shard_stats(const void* X, int x_bf16, const int* y, const float* W,
                            const float* b, float* out, int rows, int F, int Cs, int points,
                            int first, int max_blocks, int device, void* stream,
                            const ShardLayout* layout) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (F <= 0 || Cs <= 0 || rows < 0 || points <= 0 || max_blocks <= 0 ||
      !valid_shard_layout(*layout, F, Cs, 32, kThreads * kStatsRows) ||
      layout->stage_floats < 3 * layout->tile + 3 || layout->stage_floats % 4 != 0)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const ShardStatsKernel kernel = shard_stats_for(x_bf16 != 0, layout->ws > 0);
  if ((error = allow_shared(kernel, layout->bytes)) != cudaSuccess) return error;
  int sms = 0, per_sm = 0;
  if ((error = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return error;
  error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, layout->bytes);
  if (error != cudaSuccess) return error;
  const long long tiles = (static_cast<long long>(rows) + layout->tile - 1) / layout->tile;
  const int grid = static_cast<int>(
      std::max(1LL, std::min({tiles, static_cast<long long>(max_blocks),
                              static_cast<long long>(sms) * std::max(per_sm, 1)})));
  kernel<<<grid, kThreads, layout->bytes, static_cast<cudaStream_t>(stream)>>>(
      X, y, W, b, out, rows, F, Cs, points, first, *layout);
  return cudaGetLastError();
}

// grad: W (F, Cs), b (Cs,), weights (rows,) float32, lse (rows,) float64;
// partials: chunks * (F*Cs + Cs + 2) doubles of scratch; out: F*Cs + Cs + 2
// doubles, the shard's sums. chunks * rows_per_chunk >= rows (no chunks: no
// rows, sums of 0).
int lo_logistic_shard_grad(const void* X, int x_bf16, const int* y, const float* weights,
                           const double* lse, const float* W, const float* b, double* partials,
                           double* out, int rows, int F, int Cs, int first, int chunks,
                           int rows_per_chunk, int max_blocks, int device, void* stream,
                           const ShardLayout* layout) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const long long cells = static_cast<long long>(F) * Cs + Cs + 2;
  if (F <= 0 || Cs <= 0 || rows < 0 || chunks < 0 || rows_per_chunk <= 0 || max_blocks <= 0 ||
      static_cast<long long>(chunks) * rows_per_chunk < rows ||
      !valid_shard_layout(*layout, F, Cs, kGroupRows, kThreads) || layout->tp < layout->tile ||
      (layout->form != kShardNarrow && layout->form != kShardSerial) ||
      (layout->form == kShardNarrow && (cells > kMaxOwned * kThreads || layout->ws == 0)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    const ShardGradKernel kernel = shard_grad_for(x_bf16 != 0, layout->ws > 0, layout->form);
    if ((error = allow_shared(kernel, layout->bytes)) != cudaSuccess) return error;
    kernel<<<chunks, kThreads, layout->bytes, s>>>(X, y, weights, lse, W, b, partials, rows, F,
                                                     Cs, first, rows_per_chunk, *layout);
    error = cudaGetLastError();
    if (error != cudaSuccess) return error;
  }
  sums_kernel<<<dim3(grid_for(cells, max_blocks), 1), kThreads, 0, s>>>(
      partials, out, chunks, static_cast<int>(cells));
  return cudaGetLastError();
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
