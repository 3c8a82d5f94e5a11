"""Times K8′'s column sums (``masked_sums_kernel`` of
learningorchestra_tpu_torch/kernels/csrc/scaler.cu) against the forms its
design weighed, and against the parts of its own time, on one CUDA card.

Each form is the kernel source with a passage replaced:

- ``blocks_of_256``: blocks of 256 threads, four resident a SM, over a
  split of 528 blocks (twice the chunks, each half the rows), where the
  kept kernel runs blocks of 512 threads, two a SM, over 264;
- ``no_last_block``: each block writes its chunk's partials and ends, with
  no ticket and no last block to add them (its out is not written);
- ``rows_loop_only``: the rows loop alone, each thread's sums kept live
  and never stored (no lanes added, no partials, no last block).

Beside them, ``bare_read``: a grid-stride read of X as 16-byte words and
of w, added in float32 (4,224 blocks of 256 threads, four words in flight
a thread), the card's own read rate for the same bytes.

The forms that write out are checked against the plain twin
(``logistic._masked_col_sums``, 1e-12 of the largest sum) and bit-equal
on a second launch. Every form is timed at chip_smoke.py's main shape (a
rank's block: bench.py's 1,000,000 rows padded to 1,048,576, 16
features), both passes, with L2 evicted by reads before each call
(chip_smoke's ``_ReadFlush``): device ms from the profiler's trace
(chip_smoke's ``_device_ms``). The forms run in the order kept, forms,
forms reversed, kept, each run reported on its own.

Run it from the repository's root on a machine with a card and the CUDA
toolkit:

    python3 scaler_variants.py

It prints the card's name and power limit, then one JSON object as its
last line: {form: {"pass1": [ms, ...], "pass2": [ms, ...]}} with the
bound beside them.
"""

import ctypes
import json
import os
import subprocess
import sys

KEPT_SPLIT_BLOCKS = 264
WIDE_SPLIT_BLOCKS = 528
BARE_READ_BLOCKS = 4224
REPEATS = 20

_TAIL = "  if (!last_block(ticket, gridDim.x * gridDim.y)) return;\n"
_LANES = "  // the lanes' sums, then added along the lanes"
_KEEP_LIVE = """  double keep = weight_sum;
#pragma unroll
  for (int j = 0; j < V; ++j) keep = __dadd_rn(keep, sum[j]);
  if (keep == 1.2345) partials[blockIdx.x] = keep;  // never: keeps every sum live
  return;
"""
_BARE_READ = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) bare_read_kernel(const float4* __restrict__ X,
    const float* __restrict__ w, long long words, long long rows, float* out) {
  float acc = 0.0f;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (; i + 3 * step < words; i += 4 * step) {
    const float4 a = __ldg(X + i), b = __ldg(X + i + step), c = __ldg(X + i + 2 * step),
                 d = __ldg(X + i + 3 * step);
    acc += a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w + c.x + c.y + c.z + c.w + d.x + d.y +
           d.z + d.w;
  }
  for (; i < words; i += step) {
    const float4 a = __ldg(X + i);
    acc += a.x + a.y + a.z + a.w;
  }
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < rows; r += step)
    acc += __ldg(w + r);
  if (acc == 1.2345f) out[0] = acc;  // never: keeps the reads live
}
extern "C" int lo_bare_read(const float* X, const float* w, long long rows, int F, float* out,
                            int blocks, void* stream) {
  bare_read_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)X, w, rows * F / 4, rows, out);
  return cudaGetLastError();
}
"""


def _replaced(text: str, kept: str, replacement: str, name: str) -> str:
    if text.count(kept) != 1:
        raise SystemExit(f"scaler.cu no longer holds the passage {name} replaces:\n{kept}")
    return text.replace(kept, replacement)


def form_sources(source: str) -> dict:
    wide = _replaced(source, "constexpr int kSumsThreads = 512;", "constexpr int kSumsThreads = 256;",
                     "blocks_of_256")
    wide = _replaced(wide, "constexpr int kSumsBlocksPerSM = 2;", "constexpr int kSumsBlocksPerSM = 4;",
                     "blocks_of_256")
    head, rest = _replaced(source, _LANES, _LANES, "rows_loop_only").split(_LANES)
    return {
        "kept": source,
        "blocks_of_256": wide,
        "no_last_block": _replaced(source, _TAIL, "  return;\n", "no_last_block"),
        "rows_loop_only": head + _KEEP_LIVE + _LANES + rest,
    }


def build_all(kernels, sources: dict) -> dict:
    """Each form's library, built by nvcc processes started together."""
    folder = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(folder, exist_ok=True)
    nvcc = kernels._find_nvcc()
    processes = {}
    for name, text in sources.items():
        source = os.path.join(folder, f"scaler-{name}.cu")
        with open(source, "w") as handle:
            handle.write(text)
        processes[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", source[:-3] + ".so", source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libraries = {}
    for name, process in processes.items():
        output = process.communicate()[0]
        if process.returncode != 0:
            raise SystemExit(f"nvcc failed to build form {name}:\n{output[-4000:]}")
        lib = ctypes.CDLL(os.path.join(folder, f"scaler-{name}.so"))
        if name == "bare_read":
            lib.lo_bare_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.lo_bare_read.restype = ctypes.c_int
            libraries[name] = lib
        else:
            libraries[name] = kernels._bind_scaler(lib)
    return libraries


def split(rows: int, blocks: int) -> tuple[int, int]:
    """``logistic._sums_chunks`` at 16 features (one window) for a split of
    ``blocks`` blocks."""
    chunks = max(1, min(blocks, rows // 1024))
    per_chunk = -(-rows // chunks)
    return -(-rows // per_chunk), per_chunk


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scaler_variants.py needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.ml import logistic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with open(kernels.SOURCES["scaler"]) as handle:
        sources = form_sources(handle.read())
    libraries = build_all(kernels, {**sources, "bare_read": _BARE_READ})
    if logistic._sums_chunks(1_048_576, 16)[0] != KEPT_SPLIT_BLOCKS:
        raise SystemExit("logistic._sums_chunks no longer gives the kept kernel 264 blocks")

    rows, features, valid = chip_smoke.SCALER_SHAPES[0]
    X, w = chip_smoke._scaler_inputs(torch, rows, features, valid, seed=rows + features)
    first = logistic._masked_col_sums(X, w)
    mean = first[:-1] / first[-1]
    wants = {"pass1": first, "pass2": logistic._masked_col_sums(X, w, mean)}
    stream = torch.cuda.current_stream().cuda_stream
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    kept_out = torch.zeros(1, device="cuda")

    def call(name: str, centre):
        lib = libraries[name]
        if name == "bare_read":
            kernels.check(lib, name, lib.lo_bare_read(
                X.data_ptr(), w.data_ptr(), rows, features, kept_out.data_ptr(), BARE_READ_BLOCKS, stream))
            return None
        chunks, per_chunk = split(rows, WIDE_SPLIT_BLOCKS if name == "blocks_of_256" else KEPT_SPLIT_BLOCKS)
        partials = torch.empty((chunks, features + 1), dtype=torch.float64, device="cuda")
        out = torch.zeros(features + 1, dtype=torch.float64, device="cuda")
        kernels.check(lib, name, lib.lo_masked_col_sums(
            X.data_ptr(), w.data_ptr(), None if centre is None else centre.data_ptr(),
            partials.data_ptr(), ticket.data_ptr(), out.data_ptr(), rows, features, chunks,
            per_chunk, torch.cuda.current_device(), stream))
        return out

    for name in ("kept", "blocks_of_256"):
        for (key, want), centre in zip(wants.items(), (None, mean)):
            got, again = call(name, centre), call(name, centre)
            error = float((got - want).abs().max() / want.abs().max())
            if not torch.equal(got, again) or not error <= chip_smoke.SCALER_SUM_RTOL:
                raise SystemExit(f"{name} {key}: {error} relative to the largest sum, or a relaunch differs")

    read_flush = chip_smoke._ReadFlush(torch, X.device)
    names = ["kept", "blocks_of_256", "no_last_block", "rows_loop_only", "bare_read"]
    results = {name: {"pass1": [], "pass2": []} for name in names}
    for name in names + names[::-1]:
        for key, centre in (("pass1", None), ("pass2", mean)):
            results[name][key].append(chip_smoke._device_ms(
                torch, lambda: call(name, centre), ("masked_sums_kernel", "bare_read_kernel"), REPEATS,
                read_flush))
    results["bound_ms"] = chip_smoke._scaler_bound("masked_col_sums", rows, features)[0]
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
