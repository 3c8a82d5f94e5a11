"""Times K12's row-slab kernels (``z_slab_tiles_kernel`` and
``grad_slab_tiles_kernel`` of learningorchestra_tpu_torch/kernels/csrc/
tsne.cu) beside the forms they replaced and the forms their design
weighed, on one CUDA card.

The replaced forms (``PARENT_FORMS`` below, their source as it was) are
built together with the kept source into one library:

- ``z_slab_kernel``: a warp a row, 8 rows a block, a lane the columns
  j = lane + 32 k in order with Y read from global memory for every pair,
  the lanes' float64 sums by xor shuffles; ``slab_total_kernel`` adds the
  rows' sums in order (``lo_tsne_z_slab_rows``);
- ``grad_slab_kernel``: the same map, P read by one 4-byte load a lane and
  pair, 4 (s y - t) formed by lane 0 (``lo_tsne_grad_slab_rows``).

The weighed forms: the kept kernels over other splits of the columns
(``ops/tsne._slab_split`` with half and twice the block targets:
``split_half``, ``split_double``), and builds of the kept source with a
passage replaced: ``stages3`` (a ring of three chunks of P),
``z_bounds4`` and ``z_bounds8`` (four or eight blocks of Z an SM in its
launch bounds, where the kept kernel has six, with splits for as many),
``grad_bounds3`` (three blocks of the gradient's an SM, where it has
two). The kept form's time is also split by kernel (the tiles and the
finish).

Inputs: chip_smoke.py's landmark fit (the 5,000 landmarks of bench.py's
1,000,000 embedding rows, P symmetrised, the final embedding of a
one-process exact fit of 1,000 iterations), slab 0 of four (1,280 rows).
Each form is held against the plain twins (Z within K12_Z_RTOL, the
gradient as chip_smoke holds the slab's) and bit-equal on a second
launch; then timed: device ms cold (256 MB overwritten before each call)
and with L2 evicted by reads (chip_smoke's ``_ReadFlush``), from the
profiler's trace (chip_smoke's ``_device_ms``), and event ms cold. The
forms run in the order kept, forms, forms reversed, kept, each run
reported on its own.

Run it from the repository's root on a machine with a card and the CUDA
toolkit:

    python3 tsne_slab_variants.py           # the forms
    python3 tsne_slab_variants.py --edges   # chip_smoke's edge shapes first

It prints the ptxas lines of the slab kernels, the card's name and power
limit, then one JSON object as its last line: {form: {"z": {...},
"grad": {...}}} with the bounds beside them.
"""

import ctypes
import json
import os
import subprocess
import sys

REPEATS = 10
SLAB_WAYS = 4

PARENT_FORMS = r'''
namespace {

constexpr int kSlabWarps = 8;
constexpr int kSlabThreads = 32 * kSlabWarps;

__device__ __forceinline__ double warp_sum(double value) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    value += __shfl_xor_sync(0xffffffffu, value, offset);
  return value;
}

// Each slab row's sum over j != i of inv_ij, into row_sums (slab doubles).
__global__ void __launch_bounds__(kSlabThreads)
z_slab_kernel(const float2* __restrict__ Y, double* __restrict__ row_sums, int n, int first,
              int slab) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kSlabWarps + (threadIdx.x >> 5);
  if (r >= slab) return;  // the whole warp
  const int i = first + r;
  const float4 yi = staged(Y[i]);
  double sum = 0.0;
  for (int j = lane; j < n; j += 32)
    if (j != i) sum += inverse_distance(yi, staged(Y[j]));
  sum = warp_sum(sum);
  if (lane == 0) row_sums[r] = sum;
}

__global__ void __launch_bounds__(kSlabThreads)
grad_slab_kernel(const float2* __restrict__ Y, const float* __restrict__ P,
                 const float* __restrict__ Z, float2* __restrict__ grad, int n, int first,
                 int slab, float exaggeration) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kSlabWarps + (threadIdx.x >> 5);
  if (r >= slab) return;  // the whole warp
  const int i = first + r;
  const float2 y = Y[i];
  const float4 yi = staged(y);
  const Divisor z = divisor(fmaxf(Z[0], 1e-12f));
  const float* __restrict__ p_row = P + static_cast<size_t>(r) * n;
  double s = 0.0, t0 = 0.0, t1 = 0.0;
  for (int j = lane; j < n; j += 32) {
    if (j == i) continue;
    const float2 yj = Y[j];
    const float inv = inverse_distance(yi, staged(yj));
    const float q = fmaxf(quotient(inv, z), 1e-12f);
    const double w = __fmul_rn(__fsub_rn(__fmul_rn(__ldg(p_row + j), exaggeration), q), inv);
    s += w;
    t0 = fma(w, static_cast<double>(yj.x), t0);
    t1 = fma(w, static_cast<double>(yj.y), t1);
  }
  s = warp_sum(s);
  t0 = warp_sum(t0);
  t1 = warp_sum(t1);
  if (lane == 0) {
    const float sf = static_cast<float>(s);
    grad[r] = make_float2(
        __fmul_rn(4.0f, __fsub_rn(__fmul_rn(sf, y.x), static_cast<float>(t0))),
        __fmul_rn(4.0f, __fsub_rn(__fmul_rn(sf, y.y), static_cast<float>(t1))));
  }
}

}  // namespace

extern "C" {

int lo_tsne_z_slab_rows(const float* Y, double* row_sums, double* total, int n, int first,
                        int slab, int device, void* stream) {
  const cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (first < 0 || slab < 0 || first + slab > n) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab > 0)
    z_slab_kernel<<<(slab + kSlabWarps - 1) / kSlabWarps, kSlabThreads, 0, s>>>(
        reinterpret_cast<const float2*>(Y), row_sums, n, first, slab);
  slab_total_kernel<<<1, kSumThreads, 0, s>>>(row_sums, total, slab);
  return cudaGetLastError();
}

int lo_tsne_grad_slab_rows(const float* Y, const float* P, const float* Z, float* grad, int n,
                           int first, int slab, float exaggeration, int device, void* stream) {
  const cudaError_t error = cudaSetDevice(device);
  if (error != cudaSuccess) return error;
  if (first < 0 || slab < 0 || first + slab > n) return cudaErrorInvalidValue;
  if (slab == 0) return cudaSuccess;
  grad_slab_kernel<<<(slab + kSlabWarps - 1) / kSlabWarps, kSlabThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(Y), P, Z, reinterpret_cast<float2*>(grad), n, first, slab,
      exaggeration);
  return cudaGetLastError();
}

}  // extern "C"
'''

PARENT_KERNELS = {"z": ("z_slab_kernel", "slab_total_kernel"), "grad": ("grad_slab_kernel",)}


def _replaced(text: str, kept: str, replacement: str, name: str) -> str:
    if text.count(kept) != 1:
        raise SystemExit(f"tsne.cu no longer holds the passage {name} replaces:\n{kept}")
    return text.replace(kept, replacement)


def form_sources(source: str) -> dict:
    """Each library's source: the kept one with the parent's forms
    appended, and the builds with a passage replaced."""
    kept = source + PARENT_FORMS
    z_bounds = "__launch_bounds__(kPairThreads, 6)\nz_slab_tiles_kernel"
    grad_bounds = "__launch_bounds__(kPairThreads, 2)\ngrad_slab_tiles_kernel"
    return {
        "kept": kept,
        "stages3": _replaced(kept, "constexpr int kSlabStages = 2;", "constexpr int kSlabStages = 3;",
                             "stages3"),
        "z_bounds4": _replaced(kept, z_bounds, z_bounds.replace("6", "4"), "z_bounds4"),
        "z_bounds8": _replaced(kept, z_bounds, z_bounds.replace("6", "8"), "z_bounds8"),
        "grad_bounds3": _replaced(kept, grad_bounds, grad_bounds.replace("2", "3"), "grad_bounds3"),
    }


def build_all(kernels, sources: dict) -> tuple[dict, dict]:
    """Each library, built by nvcc processes started together; and the
    ptxas lines of each library's slab kernels."""
    folder = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(folder, exist_ok=True)
    nvcc = kernels._find_nvcc()
    processes = {}
    for name, text in sources.items():
        path = os.path.join(folder, f"tsne-{name}.cu")
        with open(path, "w") as handle:
            handle.write(text)
        processes[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libraries, ptxas = {}, {}
    for name, process in processes.items():
        output = process.communicate()[0]
        if process.returncode != 0:
            raise SystemExit(f"nvcc failed to build form {name}:\n{output[-4000:]}")
        ptxas[name], entry = [], None
        for line in output.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "slab" in line and "'" in line else None
            elif entry is not None and ("Used" in line or "spill" in line):
                ptxas[name].append(f"{entry}: {line.split(':', 1)[-1].strip()}")
        lib = kernels._bind_tsne(ctypes.CDLL(os.path.join(folder, f"tsne-{name}.so")))
        ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lo_tsne_z_slab_rows.argtypes = [ptr, ptr, ptr, c_int, c_int, c_int, c_int, ptr]
        lib.lo_tsne_grad_slab_rows.argtypes = [ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_float,
                                               c_int, ptr]
        lib.lo_tsne_z_slab_rows.restype = lib.lo_tsne_grad_slab_rows.restype = c_int
        libraries[name] = lib
    return libraries, ptxas


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tsne_slab_variants.py needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.ops import tsne

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with open(kernels.SOURCES["tsne"]) as handle:
        libraries, ptxas = build_all(kernels, form_sources(handle.read()))
    for name, lines in ptxas.items():
        for line in lines:
            print(f"ptxas {name}: {line}")
    edges = chip_smoke.check_slab_edges(torch) if "--edges" in sys.argv[1:] else None

    X_np, _ = chip_smoke.embed_blobs(chip_smoke.EMBED_ROWS)
    chosen = tsne._choose_landmarks(chip_smoke.EMBED_ROWS, tsne.LANDMARKS, 0)
    L = torch.from_numpy(X_np[chosen]).cuda()
    n = L.shape[0]
    P = tsne.affinities(L, tsne._clamped_perplexity(tsne.PERPLEXITY, n))
    Y0 = tsne._initial_embedding(n, 0, L.device)
    Y = tsne._tsne_exact(L, tsne.PERPLEXITY, tsne.ITERATIONS, tsne.LEARNING_RATE, Y0)
    first, stop = chip_smoke._row_slabs(n, SLAB_WAYS)[0]
    slab = stop - first
    P_slab = P[first:stop].contiguous()
    twin_z = tsne._tsne_z_slab(Y, first, slab)
    Z = sum((tsne._tsne_z_slab(Y, a, b - a) for a, b in chip_smoke._row_slabs(n, SLAB_WAYS)),
            torch.zeros(1, dtype=torch.float64, device=Y.device)).to(torch.float32)
    twin_grad = tsne._tsne_grad_slab(Y, P_slab, Z, first, 1.0)
    grad64 = tsne._tsne_grad_slab(Y.double(), P_slab.double(), Z.double(), first, 1.0)
    stream = torch.cuda.current_stream().cuda_stream
    device = torch.cuda.current_device()

    def geometry(z_blocks, grad_blocks):
        return (tsne._slab_split(n, slab, tsne.SLAB_Z_STEP, z_blocks),
                tsne._slab_split(n, slab, tsne.SLAB_GRAD_STEP, grad_blocks))

    # form -> (library, (z span, splits), (grad span, splits)); None: the parent's
    forms = {
        "kept": ("kept", *geometry(tsne.SLAB_Z_BLOCKS, tsne.SLAB_GRAD_BLOCKS)),
        "parent": ("kept", None, None),
        "split_half": ("kept", *geometry(tsne.SLAB_Z_BLOCKS // 2, tsne.SLAB_GRAD_BLOCKS // 2)),
        "split_double": ("kept", *geometry(2 * tsne.SLAB_Z_BLOCKS, 2 * tsne.SLAB_GRAD_BLOCKS)),
        "stages3": ("stages3", *geometry(tsne.SLAB_Z_BLOCKS, tsne.SLAB_GRAD_BLOCKS)),
        "z_bounds4": ("z_bounds4", *geometry(4 * 132, tsne.SLAB_GRAD_BLOCKS)),
        "z_bounds8": ("z_bounds8", *geometry(8 * 132, tsne.SLAB_GRAD_BLOCKS)),
        "grad_bounds3": ("grad_bounds3", *geometry(tsne.SLAB_Z_BLOCKS, 3 * 132)),
    }

    def z_call(form):
        lib_name, z_split, _ = forms[form]
        lib, total = libraries[lib_name], torch.empty(1, dtype=torch.float64, device=Y.device)
        if z_split is None:
            row_sums = torch.empty(max(slab, 1), dtype=torch.float64, device=Y.device)
            error = lib.lo_tsne_z_slab_rows(Y.data_ptr(), row_sums.data_ptr(), total.data_ptr(), n,
                                            first, slab, device, stream)
        else:
            span, splits = z_split
            slots = torch.empty(max(-(-slab // tsne.PAIR_TILE) * splits, 1), dtype=torch.float64,
                                device=Y.device)
            error = lib.lo_tsne_z_slab(Y.data_ptr(), slots.data_ptr(), total.data_ptr(), n, first,
                                       slab, span, splits, device, stream)
        kernels.check(lib, f"{form} z", error)
        return total

    def grad_call(form):
        lib_name, _, grad_split = forms[form]
        lib = libraries[lib_name]
        grad = torch.empty((slab, 2), dtype=torch.float32, device=Y.device)
        if grad_split is None:
            error = lib.lo_tsne_grad_slab_rows(Y.data_ptr(), P_slab.data_ptr(), Z.data_ptr(),
                                               grad.data_ptr(), n, first, slab, 1.0, device, stream)
        else:
            span, splits = grad_split
            partials = torch.empty((splits, slab, 3), dtype=torch.float64, device=Y.device)
            error = lib.lo_tsne_grad_slab(Y.data_ptr(), P_slab.data_ptr(), Z.data_ptr(),
                                          partials.data_ptr(), grad.data_ptr(), n, first, slab,
                                          span, splits, 1.0, device, stream)
        kernels.check(lib, f"{form} grad", error)
        return grad

    held = {}
    for form in forms:
        z, grad = z_call(form), grad_call(form)
        if not torch.equal(z, z_call(form)) or not torch.equal(grad, grad_call(form)):
            raise SystemExit(f"{form}: a second launch differs")
        z_rel = abs(float(z) - float(twin_z)) / float(twin_z)
        if not z_rel <= chip_smoke.K12_Z_RTOL:
            raise SystemExit(f"{form}: Z {z_rel} relative to the twin's")
        torch.cuda.synchronize()
        held[form] = {"z_rel_err": z_rel,
                      **chip_smoke._held_slab_gradient(f"{form} {n}:final", grad, twin_grad, grad64)}

    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    read_flush = chip_smoke._ReadFlush(torch, flush.device)
    names = list(forms)
    results = {form: {"z": {"device_ms": [], "device_ms_clean_l2": [], "ms": []},
                      "grad": {"device_ms": [], "device_ms_clean_l2": [], "ms": []},
                      "held": held[form],
                      "z_split": forms[form][1], "grad_split": forms[form][2]} for form in names}
    for form in names + names[::-1]:
        for key, call in (("z", z_call), ("grad", grad_call)):
            kernel_names = PARENT_KERNELS[key] if form == "parent" else chip_smoke.FORM_KERNELS[f"tsne_{key}_slab"]
            timing = results[form][key]
            timing["device_ms"].append(chip_smoke._device_ms(
                torch, lambda: call(form), kernel_names, REPEATS, flush))
            timing["device_ms_clean_l2"].append(chip_smoke._device_ms(
                torch, lambda: call(form), kernel_names, REPEATS, read_flush))
            timing["ms"].append(chip_smoke._event_ms(torch, lambda: call(form), REPEATS, flush))
    for key, call in (("z", z_call), ("grad", grad_call)):   # the kept form's time by kernel
        results["kept"][key]["by_kernel_clean_l2"] = {
            name: chip_smoke._device_ms(torch, lambda: call("kept"), (name,), REPEATS, read_flush)
            for name in chip_smoke.FORM_KERNELS[f"tsne_{key}_slab"]}
    results["shape"] = {"rows": slab, "columns": n, "first": first}
    results["bound_ms"] = {key: chip_smoke._slab_bound(f"tsne_{key}_slab", slab, n) for key in ("z", "grad")}
    results["lost_traces"] = len(chip_smoke.LOST_TRACES)
    if edges is not None:
        results["edges"] = edges
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
