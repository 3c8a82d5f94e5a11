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
//   - Build without -use_fast_math: expf and logf are the accurate ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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
// Outside the unnamed namespace: the entry points take it, and keep their
// external linkage only for a type that has it.
struct Layout {
  int group, tile, form, params_shared;
  int xs, tp, js, fd, cells, buffer_floats;
  int ring, xd, terms, nll, wd, scratch, sums, sources, one, params_w, params_b, bytes;
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

// Issue the copies of rows [start, start + n) of the block's rows into
// `tile` (4-byte cp.async: x's row stride in shared memory is odd).
// Element i = r * F + f of the rows goes to thread i % kThreads.
__device__ __forceinline__ void stage_tile(const Tile& tile, const float* __restrict__ X,
                                           const int* __restrict__ y,
                                           const float* __restrict__ weights, int start,
                                           int n, int F, int xs) {
  if (xs > 0) {
    const int step_r = kThreads / F, step_f = kThreads % F;
    int r = threadIdx.x / F, f = threadIdx.x % F;
    const float* rows = X + static_cast<size_t>(start) * F;
    while (r < n) {
      copy_async4(tile.x + r * xs + f, rows + static_cast<size_t>(r) * F + f);
      r += step_r;
      f += step_f;
      if (f >= F) {
        f -= F;
        ++r;
      }
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

// The logit of class c without b: fmaf over the features in order.
__device__ __forceinline__ float dot(const float* x, int F, const float* W, int C, int c) {
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
__device__ __forceinline__ Softmax softmax_any(const float* x, int F, const float* W,
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
template <int kC>
__device__ __forceinline__ float row_residuals(const float* x, int F, const float* W,
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
__device__ __forceinline__ float window_residuals(const float* x, int F, const float* W,
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
template <int kC>
__device__ __forceinline__ void rows_trial_nll(const float* x0, const float* x1, int F,
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
    const float* x[2] = {x0, x1};
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
__device__ __forceinline__ void group_sums(const GroupedCells& g, double* __restrict__ sums,
                                           const float* x, int x_stride, const float* one,
                                           int n) {
  const int groups = (n + kGroupRows - 1) / kGroupRows;
  const int step_g = kThreads / g.cells, step_c = kThreads % g.cells;
  int group = threadIdx.x / g.cells, cell = threadIdx.x % g.cells;
  while (group < groups) {
    const int2 source = g.sources[cell];
    const double* b = g.terms + source.x;
    const float* a = source.y >= 0 ? x + source.y : one;
    const int a_stride = source.y >= 0 ? x_stride : 0;
    const int r0 = group * kGroupRows;
    double s = 0.0;
    if (r0 + kGroupRows <= n) {
#pragma unroll
      for (int r = r0; r < r0 + kGroupRows; ++r)
        s = __fma_rn(static_cast<double>(a[r * a_stride]), b[r], s);
    } else {
      for (int r = r0; r < n; ++r) s = __fma_rn(static_cast<double>(a[r * a_stride]), b[r], s);
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
template <int kCB, int kW, bool kFull, bool kStaged>
__device__ __forceinline__ void wide_row(Sums<kCB, kW>& s, const float* x, int x_stride,
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
template <int kCB, int kW, bool kFull, bool kStaged>
__device__ __forceinline__ void wide_rows(Sums<kCB, kW>& acc, const float* x, int x_stride,
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
template <int kC, int kForm>
__global__ void __launch_bounds__(kThreads, 2)
    loss_grad_kernel(const float* __restrict__ X, const int* __restrict__ y,
                     const float* __restrict__ weights, const float* __restrict__ W,
                     const float* __restrict__ b, double* __restrict__ partials, int rows,
                     int F, int C, int jobs, long long x_job_stride,
                     long long row_job_stride, int rows_per_chunk, const Layout layout) {
  constexpr int kCB = kForm == kNarrow ? 1 : kWideClasses;
  constexpr int kW = kForm == kNarrow ? 1 : kWideFeatures;
  constexpr bool kStaged = kForm == kWideStaged;
  extern __shared__ __align__(16) unsigned char shared[];
  const bool weighted = weights != nullptr;
  const int group = layout.group, tile = layout.tile;
  const int xs = layout.xs, tp = layout.tp, js = layout.js, fd = layout.fd;
  const int cells_out = F * C + C + 1 + (weighted ? 1 : 0);
  const int job0 = blockIdx.y * group;
  const int G = min(group, jobs - job0);
  X += job0 * x_job_stride;
  y += job0 * row_job_stride;
  if (weighted) weights += job0 * row_job_stride;
  W += static_cast<size_t>(job0) * F * C;
  b += static_cast<size_t>(job0) * C;
  float* ring = reinterpret_cast<float*>(shared + layout.ring);
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
  stage_tile(Tile(ring, tile, xs), X, y, weights, row_begin, min(tile, row_end - row_begin), F,
             xs);
  async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int start = row_begin + t * tile;
    const int n = min(tile, row_end - start);
    const Tile here(ring + (t & 1) * layout.buffer_floats, tile, xs);
    const float* x = xs > 0 ? here.x : X + static_cast<size_t>(start) * F;
    const int x_stride = xs > 0 ? xs : F;
    async_wait_all();
    __syncthreads();  // the tile has landed; the previous tile's sums are done
    if (t + 1 < tiles) {
      const int next = start + tile;
      stage_tile(Tile(ring + ((t + 1) & 1) * layout.buffer_floats, tile, xs), X, y, weights,
                 next, min(tile, row_end - next), F, xs);
      async_commit();
    }
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
template <int kC>
__global__ void __launch_bounds__(kThreads, 2)
    trial_losses_kernel(const float* __restrict__ X, const int* __restrict__ y,
                        const float* __restrict__ weights, const float* __restrict__ W4,
                        const float* __restrict__ b4, double* __restrict__ partials,
                        int rows, int F, int C, int jobs, long long x_job_stride,
                        long long row_job_stride, int rows_per_chunk, const Layout layout) {
  extern __shared__ __align__(16) unsigned char shared[];
  const bool weighted = weights != nullptr;
  const int group = layout.group, tile = layout.tile, xs = layout.xs;
  const int sums_out = kCandidates + (weighted ? 1 : 0);
  const int job0 = blockIdx.y * group;
  const int G = min(group, jobs - job0);
  const int set = kCandidates * F * C;  // a job's W4 floats
  const int cells = G * kCandidates + (weighted ? 1 : 0);
  X += job0 * x_job_stride;
  y += job0 * row_job_stride;
  if (weighted) weights += job0 * row_job_stride;
  W4 += static_cast<size_t>(job0) * set;
  b4 += static_cast<size_t>(job0) * kCandidates * C;
  float* ring = reinterpret_cast<float*>(shared + layout.ring);
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
  stage_tile(Tile(ring, tile, xs), X, y, weights, row_begin, min(tile, row_end - row_begin), F,
             xs);
  async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int start = row_begin + t * tile;
    const int n = min(tile, row_end - start);
    const Tile here(ring + (t & 1) * layout.buffer_floats, tile, xs);
    const float* x = xs > 0 ? here.x : X + static_cast<size_t>(start) * F;
    const int x_stride = xs > 0 ? xs : F;
    double* tile_sums = group_sums_at + (t & 1) * cells * tile_groups;
    async_wait_all();
    __syncthreads();  // the tile has landed; the previous tile's group sums are in
    if (t + 1 < tiles) {
      const int next = start + tile;
      stage_tile(Tile(ring + ((t + 1) & 1) * layout.buffer_floats, tile, xs), X, y, weights,
                 next, min(tile, row_end - next), F, xs);
      async_commit();
    }
    if (t > 0)
      add_groups(owned, group_sums_at + ((t - 1) & 1) * cells * tile_groups, cells,
                 tile_groups);
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

typedef void (*K7Kernel)(const float*, const int*, const float*, const float*, const float*,
                         double*, int, int, int, int, long long, long long, int, const Layout);

// C = 2 in registers when the parameters allow 8-byte loads.
bool two_classes(int C, const void* W, const void* b) {
  return C == 2 && reinterpret_cast<uintptr_t>(W) % 8 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 8 == 0;
}

K7Kernel loss_grad_for(bool two, int form) {
  static const K7Kernel table[2][3] = {
      {loss_grad_kernel<0, kNarrow>, loss_grad_kernel<0, kWide>,
       loss_grad_kernel<0, kWideStaged>},
      {loss_grad_kernel<2, kNarrow>, loss_grad_kernel<2, kWide>,
       loss_grad_kernel<2, kWideStaged>},
  };
  return table[two ? 1 : 0][form];
}

bool valid_geometry(int F, int C, int jobs, const Layout& layout, long long x_job_stride,
                    long long row_job_stride, int tile_multiple) {
  if (F <= 0 || C <= 0 || jobs < 0 || layout.group <= 0) return false;
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

// J = `jobs` jobs: X of job j at j * x_job_stride floats (0: one shared
// X), y and weights (null: unweighted) at j * row_job_stride entries, W
// (J, F, C), b (J, C). partials: J * chunks * (F*C + C + 1 + weighted)
// doubles of scratch; out: (J, F*C + C + 1) floats, [dW (F, C) | db (C) |
// loss] a job.
int lo_logistic_loss_grad(const float* X, const int* y, const float* weights,
                          const float* W, const float* b, double* partials,
                          float* out, int rows, int F, int C, int jobs,
                          long long x_job_stride, long long row_job_stride,
                          int chunks, int rows_per_chunk, const Layout* layout,
                          int max_blocks, int device, void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const int form = layout->form, group = layout->group;
  if (!valid_geometry(F, C, jobs, *layout, x_job_stride, row_job_stride, kGroupRows) ||
      form < kNarrow || form > kWideStaged)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int weighted = weights != nullptr ? 1 : 0;
  const int cells = F * C + C + 1;
  const int partial_cells = cells + weighted;
  long long windows = 1;
  if (form != kNarrow) {
    const long long per_job = static_cast<long long>((C + kWideClasses - 1) / kWideClasses) *
                              ((F + kWideFeatures - 1) / kWideFeatures);
    windows = (group * per_job + kThreads - 1) / kThreads;
    if ((group > 1 && windows > 1) || windows > kMaxGridYZ) return cudaErrorInvalidValue;
  }
  const K7Kernel kernel = loss_grad_for(two_classes(C, W, b), form);
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
          X + j0 * x_job_stride, y + j0 * row_job_stride,
          weighted ? weights + j0 * row_job_stride : nullptr,
          W + static_cast<size_t>(j0) * F * C, b + static_cast<size_t>(j0) * C,
          launch_partials, rows, F, C, launch_jobs, x_job_stride, row_job_stride,
          rows_per_chunk, *layout);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
    for (int g0 = 0; g0 < launch_jobs; g0 += kMaxGridYZ) {
      const int finish_jobs = std::min(kMaxGridYZ, launch_jobs - g0);
      finish_kernel<<<dim3(grid_for(cells, max_blocks), finish_jobs), kThreads, 0, s>>>(
          launch_partials + static_cast<size_t>(g0) * std::max(chunks, 1) * partial_cells,
          out + static_cast<size_t>(j0 + g0) * cells, chunks, cells, F * C + C,
          static_cast<double>(rows), weighted);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
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
                             int chunks, int rows_per_chunk, const Layout* layout, int device,
                             void* stream) {
  cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  const int group = layout->group;
  // a tile holds whole 64-row warp items
  if (!valid_geometry(F, C, jobs, *layout, x_job_stride, row_job_stride, kWarpRows))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int weighted = weights != nullptr ? 1 : 0;
  const int sums = kCandidates + weighted;
  const K7Kernel kernel =
      two_classes(C, W4, b4) ? trial_losses_kernel<2> : trial_losses_kernel<0>;
  if (chunks > 0) {
    error = allow_shared(kernel, layout->bytes);
    if (error != cudaSuccess) return error;
  }
  const long long jobs_per_launch = static_cast<long long>(kMaxGridYZ) * group;
  for (long long j0 = 0; j0 < jobs; j0 += jobs_per_launch) {
    const int launch_jobs = static_cast<int>(std::min<long long>(jobs_per_launch, jobs - j0));
    double* launch_partials = partials + static_cast<size_t>(j0) * std::max(chunks, 1) * sums;
    if (chunks > 0) {
      kernel<<<dim3(chunks, (launch_jobs + group - 1) / group), kThreads, layout->bytes, s>>>(
          X + j0 * x_job_stride, y + j0 * row_job_stride,
          weighted ? weights + j0 * row_job_stride : nullptr,
          W4 + static_cast<size_t>(j0) * kCandidates * F * C,
          b4 + static_cast<size_t>(j0) * kCandidates * C, launch_partials, rows, F, C,
          launch_jobs, x_job_stride, row_job_stride, rows_per_chunk, *layout);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
    for (int g0 = 0; g0 < launch_jobs; g0 += kMaxGridYZ) {
      const int finish_jobs = std::min(kMaxGridYZ, launch_jobs - g0);
      finish_kernel<<<dim3(1, finish_jobs), kThreads, 0, s>>>(
          launch_partials + static_cast<size_t>(g0) * std::max(chunks, 1) * sums,
          out + static_cast<size_t>(j0 + g0) * kCandidates, chunks, kCandidates, 0,
          static_cast<double>(rows), weighted);
      error = cudaGetLastError();
      if (error != cudaSuccess) return error;
    }
  }
  return cudaSuccess;
}

const char* lo_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
