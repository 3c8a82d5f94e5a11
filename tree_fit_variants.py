"""Times K4 (route) and K5's counts path (leaf_sums, integer=True) of
learningorchestra_tpu_torch/kernels/csrc/tree_fit.cu, and the tree
forward (K6) of learningorchestra_tpu_torch/kernels/csrc/tree_forward.cu,
against the forms their designs weighed and left out, on one CUDA card.

Each variant of tree_fit.cu is the kernel source with a passage or two
replaced:

- ``route_bins_once_a_node_splits``: K4 loads a row's bins only once a
  node of the row splits, so that a row that no tree of its group splits
  reads no bins, where the kept kernel loads them with the row's nodes;
- ``counts_warp_aggregated``: K5's counts path groups a warp's lanes by
  (leaf, channel) cell (``__match_any_sync``) and adds each group's count
  once (``__reduce_add_sync``) before the shared-memory atomic, where the
  kept kernel adds each lane's count with its own atomic.

The forms of tree_forward.cu. The kept kernel stages a tile's rows by
feature column and gives a warp 32 rows of one tree; at the batch lane's
row counts a thread walks its own row through every tree and sums in
registers, else a tile's (tree, row) walks are spread over the threads
and summed after a barrier (ml/trees.py ``_forward_geometry`` picks):

- ``forward_a_thread_a_row``: the staged row tile alone, a thread a row
  with no tree lanes, at every shape (the kept source, the geometry's
  knobs set so);
- ``forward_tree_lanes``: the tree lanes at every shape (the same);
- ``forward_row_lanes`` (tree_forward_row_lanes.cu, beside this script):
  a row's trees side by side on a warp's lanes, rows staged row by row at
  an odd stride, nodes staged as (feature, threshold), through the kept
  entry points and geometry;
- ``forward_row_threads``, given ``--before DIR``: the tree_forward.cu of
  the checkout at DIR (the commit before the tiles, unpacked with ``git
  archive``: a thread a row, X gathered from global memory, trees
  restaged for every 256-row tile when they do not fit together), through
  its own entry points.

Every variant is built with nvcc (all at once) into the kernels' build
folder, checked equal to the plain versions (``trees._route``,
``trees._leaf_sums``, ``trees._ensemble_forward`` bit for bit,
``trees._gbt_forward`` within 1e-6, ``trees._job_ensemble_forward`` bit
for bit) on every case, and timed cold: 256 MB written before each call
so that it finds none of its inputs in L2, CUDA events around the call,
the median of the repeats. The shapes are chip_smoke.py's: 1,000,000 rows
x 16 int8 features at 32 bins, 20 trees over one bins matrix, 8 sweep jobs
of 1,048,576 rows each with its own bins, 256 job leaves, and 4,096
leaves x 10 classes; for K6, 64, 4,096 and 1,048,576 rows of 16 features
through 20 trees of depth 5 (the ensemble and gb), the depth sweep's 8
one-tree jobs of depth 8 over 200,000 shared rows, 20 trees of depth 10
and one tree of depth 12 with 20 classes (and gb's) over 1,000,000 rows. The
variants run in the order kept, variants, variants reversed, kept, each
run reported on its own.

Run it from the repository's root on a machine with a card and the CUDA
toolkit:

    python3 tree_fit_variants.py            # K4, K5 and K6
    python3 tree_fit_variants.py forward    # K6 alone
    python3 tree_fit_variants.py forward --before build/parent   # and the earlier K6

It prints the card's name and power limit, then one JSON object as its
last line: {source: {variant: [{case: ms, ...} for each run]}} (K6's
cases also as ``case:device``: the kernels' device time in the
profiler's trace, each call cold).
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROWS, FEATURES, MAX_BINS = 1_000_000, 16, 32
TREES, JOBS, JOB_ROWS, JOB_LEAVES = 20, 8, 1 << 20, 256
REPEATS = 15

# each variant: (kept passage, its replacement), ...
_ROUTE_LAZY = (
    ("""    uint4 words[W];
    if (kWords > 0) load_words<kWords>(words, row_bins);
""", """    uint4 words[W];
    bool loaded = false;
"""),
    ("""          x_bin = kWords > 0 ? word_bin<Bin, kWords>(words, f)
                             : static_cast<int>(__ldg(row_bins + f));
""", """          if (kWords > 0) {
            if (!loaded) {
              load_words<kWords>(words, row_bins);
              loaded = true;
            }
            x_bin = word_bin<Bin, kWords>(words, f);
          } else {
            x_bin = static_cast<int>(__ldg(row_bins + f));
          }
"""),
)
_COUNTS_AGGREGATED = (
    ("""        const unsigned value = count_of(v[s], "lo_leaf_counts");
        if (l[s] < 0 || value == 0u) continue;
        if (kShared)
          atomicAdd(hist + l[s] * K + k, value);
        else
          add_count(counts + l[s] * K + k, value, "lo_leaf_counts");
""", """        const unsigned value = count_of(v[s], "lo_leaf_counts");
        const int key = l[s] >= 0 && value != 0u ? l[s] * K + k : -1;
        const unsigned group = __match_any_sync(0xffffffffu, key);
        const unsigned total = __reduce_add_sync(group, value);
        if (key >= 0 && static_cast<int>(threadIdx.x & 31u) == __ffs(group) - 1) {
          if (kShared)
            atomicAdd(hist + key, total);
          else
            add_count(counts + key, total, "lo_leaf_counts");
        }
"""),
)


# K6's forms: (library, the geometry's knobs in ml/trees.py)
_NO_ROW_THREADS = {"_FORWARD_ROW_ROWS": 1 << 62}
FORWARD_FORMS = {
    "kept": ("kept", {}),
    "forward_a_thread_a_row": ("kept", {"_FORWARD_ROW_ROWS": 1, "_FORWARD_ROW_TREES": 1}),
    "forward_tree_lanes": ("kept", _NO_ROW_THREADS),
    "forward_row_lanes": ("forward_row_lanes", _NO_ROW_THREADS),
    "forward_row_threads": ("forward_row_threads", {}),
}
ROW_LANES_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tree_forward_row_lanes.cu")


def forward_sources(source: str, before: str | None) -> dict:
    """K6's sources: the kept one, the row lanes beside this script and,
    given the root of an earlier checkout, its tree_forward.cu."""
    sources = {"kept": source}
    with open(ROW_LANES_SOURCE) as handle:
        sources["forward_row_lanes"] = handle.read()
    if before is not None:
        path = os.path.join(before, "learningorchestra_tpu_torch", "kernels", "csrc", "tree_forward.cu")
        with open(path) as handle:
            sources["forward_row_threads"] = handle.read()
    return sources


def variant_sources(source: str) -> dict:
    sources = {"kept": source}
    for name, replacements in (
        ("route_bins_once_a_node_splits", _ROUTE_LAZY),
        ("counts_warp_aggregated", _COUNTS_AGGREGATED),
    ):
        text = source
        for kept, replacement in replacements:
            if text.count(kept) != 1:
                raise SystemExit(f"tree_fit.cu no longer holds the passage {name} replaces:\n{kept}")
            text = text.replace(kept, replacement)
        sources[name] = text
    return sources


def build_all(kernels, sources: dict) -> dict:
    """Each variant's library, built by nvcc processes started together:
    {(library, variant): ctypes library}, each source of ``sources``
    ({library: {variant: text}}) bound by its library's binder (the
    earlier forward by its own)."""
    folder = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(folder, exist_ok=True)
    nvcc = kernels._find_nvcc()
    processes = {}
    for library, texts in sources.items():
        for name, text in texts.items():
            source = os.path.join(folder, f"{library}-{name}.cu")
            with open(source, "w") as handle:
                handle.write(text)
            processes[library, name] = subprocess.Popen(
                [nvcc, *kernels.NVCC_FLAGS, "-o", source[:-3] + ".so", source],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
    libraries = {}
    for (library, name), process in processes.items():
        output = process.communicate()[0]
        if process.returncode != 0:
            raise SystemExit(f"nvcc failed to build variant {name}:\n{output[-4000:]}")
        lib = ctypes.CDLL(os.path.join(folder, f"{library}-{name}.so"))
        if name == "forward_row_threads":
            libraries[library, name] = _bind_row_threads(lib)
        else:
            libraries[library, name] = kernels._BINDERS[library](lib)
    return libraries


def _bind_row_threads(lib):
    """The earlier forward's entry points."""
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lo_tree_ensemble_forward.argtypes = [
        ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, c_int, ctypes.c_longlong,
        c_int, c_int, ptr,
    ]
    lib.lo_gbt_forward.argtypes = [
        ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_float, c_float, c_int, c_int, ptr,
    ]
    lib.lo_tree_ensemble_forward.restype = lib.lo_gbt_forward.restype = c_int
    lib.lo_error_string.argtypes = [c_int]
    lib.lo_error_string.restype = ctypes.c_char_p
    return lib


def row_threads_forward(torch, kernels, lib, X, fh, th, values, depth, gbt=False, f0=0.0, step=0.0):
    """The earlier forward's launch, as its wrapper made it: the ensemble's
    ``(J, rows, C)`` (heaps ``(J, T, nodes)``) or gb's ``(rows, 2)``."""
    rows, num_features = X.shape[-2:]
    stream = torch.cuda.current_stream().cuda_stream
    blocks = kernels.max_blocks(X.device.index)
    if gbt:
        out = torch.empty((rows, 2), dtype=torch.float32, device=X.device)
        error = lib.lo_gbt_forward(
            X.data_ptr(), fh.data_ptr(), th.data_ptr(), values.data_ptr(), out.data_ptr(), rows,
            num_features, fh.shape[-2], depth, f0, step, blocks, X.device.index, stream)
    else:
        jobs = fh.shape[0]
        out = torch.empty((jobs, rows, values.shape[-1]), dtype=torch.float32, device=X.device)
        error = lib.lo_tree_ensemble_forward(
            X.data_ptr(), fh.data_ptr(), th.data_ptr(), values.data_ptr(), out.data_ptr(), rows,
            num_features, fh.shape[-2], depth, values.shape[-1], jobs,
            rows * num_features if X.dim() == 3 else 0, blocks, X.device.index, stream)
    kernels.check(lib, "forward_row_threads", error)
    return out


def time_fit(torch, kernels, trees, libraries, cold_ms) -> dict:
    """K4 and K5: each tree_fit.cu form, every case equal to the plain
    versions, in the order kept, variants, variants reversed, kept."""
    device = torch.device("cuda")
    rng = np.random.default_rng(0)

    def on_card(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    def splits(T, n_nodes, leaf_rate):
        feature = rng.integers(0, FEATURES, (T, n_nodes)).astype(np.int32)
        feature[rng.random((T, n_nodes)) < leaf_rate] = -1
        return on_card(feature), on_card(rng.integers(0, MAX_BINS, (T, n_nodes)).astype(np.int32))

    bins = on_card(rng.integers(0, MAX_BINS, (ROWS, FEATURES)).astype(np.int8))
    job_bins = on_card(rng.integers(0, MAX_BINS, (JOBS, JOB_ROWS, FEATURES)).astype(np.int8))
    node0 = torch.zeros(ROWS, dtype=torch.int32, device=device)
    node16 = on_card(rng.integers(0, 16, ROWS).astype(np.int32))
    node_forest = on_card(rng.integers(0, 16, (TREES, ROWS)).astype(np.int32))
    node_jobs = on_card(rng.integers(0, 16, (JOBS, JOB_ROWS)).astype(np.int32))
    f0, s0 = splits(1, 1, 0.0)
    f16, s16 = splits(1, 16, 0.0)
    f16_leafy, s16_leafy = splits(1, 16, 0.75)
    f_forest, s_forest = splits(TREES, 16, 0.05)
    f_forest_leafy, s_forest_leafy = splits(TREES, 16, 0.5)
    f_jobs, s_jobs = splits(JOBS, 16, 0.05)
    route_cases = {
        "route:level0": (bins, node0, f0[0], s0[0]),
        "route:16_nodes": (bins, node16, f16[0], s16[0]),
        "route:16_nodes_75pct_leaves": (bins, node16, f16_leafy[0], s16_leafy[0]),
        "route:20_trees": (bins, node_forest, f_forest, s_forest),
        "route:20_trees_50pct_leaves": (bins, node_forest, f_forest_leafy, s_forest_leafy),
        "route:jobs": (job_bins, node_jobs, f_jobs, s_jobs),
    }

    labels = on_card(rng.integers(0, 2, ROWS))
    one_hot = torch.nn.functional.one_hot(labels, 2).float().contiguous()
    weights = on_card(rng.poisson(1.0, (TREES, ROWS)).astype(np.float32))
    job_labels = on_card(rng.integers(0, 2, (JOBS, JOB_ROWS)))
    job_mask = on_card((rng.random((JOBS, JOB_ROWS)) < 0.8).astype(np.float32))
    labels10 = on_card(rng.integers(0, 10, ROWS))
    leaf_cases = {
        "counts:dt": (on_card(rng.integers(0, 32, ROWS).astype(np.int32)), one_hot, 32),
        "counts:20_trees": (
            on_card(rng.integers(0, 32, (TREES, ROWS)).astype(np.int32)),
            (one_hot[None] * weights[:, :, None]).contiguous(), 32,
        ),
        "counts:jobs": (
            on_card(rng.integers(0, JOB_LEAVES, (JOBS, JOB_ROWS)).astype(np.int32)),
            (torch.nn.functional.one_hot(job_labels, 2).float() * job_mask[..., None]).contiguous(),
            JOB_LEAVES,
        ),
        "counts:4096x10": (
            on_card(rng.integers(0, 4096, ROWS).astype(np.int32)),
            torch.nn.functional.one_hot(labels10, 10).float().contiguous(), 4096,
        ),
    }
    plain_routes = {case: trees._route(*args) for case, args in route_cases.items()}
    plain_sums = {case: trees._leaf_sums(*args) for case, args in leaf_cases.items()}

    names = [name for library, name in libraries if library == "tree_fit"]
    results: dict = {name: [] for name in names}
    for name in [*names, *names[1:][::-1], names[0]]:
        kernels._libraries["tree_fit"] = libraries["tree_fit", name]
        run = {}
        for case, args in route_cases.items():
            if not torch.equal(trees.route(*args), plain_routes[case]):
                raise SystemExit(f"{name}: {case} differs from the plain version")
            run[case] = cold_ms(lambda: trees.route(*args))
        for case, (leaf, channels, n_leaves) in leaf_cases.items():
            if not torch.equal(trees.leaf_sums(leaf, channels, n_leaves, integer=True), plain_sums[case]):
                raise SystemExit(f"{name}: {case} differs from the plain version")
            run[case] = cold_ms(lambda: trees.leaf_sums(leaf, channels, n_leaves, integer=True))
        results[name].append(run)
    return results


FORWARD_ROWS = (64, 4096, 1 << 20)
DEEP_ROWS, SWEEP_EVAL_ROWS = 1_000_000, 200_000


def time_forward(torch, kernels, trees, libraries, cold_ms, cold_device_ms) -> dict:
    """K6: each tree_forward.cu form, every case equal to the plain
    versions, in the order kept, variants, variants reversed, kept; each
    case's cold event time and, as ``case:device``, its kernels' device
    time."""
    device = torch.device("cuda")
    rng = np.random.default_rng(1)

    def on_card(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    def rows_of(rows, jobs=None):
        shape = (rows, FEATURES) if jobs is None else (jobs, rows, FEATURES)
        X = (rng.random(shape) * 20).astype(np.float32)
        X[rng.random(shape) < 0.05] = np.nan
        return on_card(X)

    def heaps(count, depth, classes, jobs=None):
        lead = (count,) if jobs is None else (jobs, count)
        nodes = 2**depth - 1
        features = rng.integers(-1, FEATURES, lead + (nodes,)).astype(np.int32)
        thresholds = (rng.random(lead + (nodes,)) * 20).astype(np.float32)
        probs = rng.dirichlet(np.ones(classes), size=lead + (2**depth,)).astype(np.float32)
        values = rng.normal(size=lead + (2**depth,)).astype(np.float32)
        return on_card(features), on_card(thresholds), on_card(probs), on_card(values)

    cases = {}   # case: (X, heaps, depth, form): form "ensemble", "gbt" or "jobs"
    for rows in FORWARD_ROWS:
        X, forest = rows_of(rows), heaps(TREES, 5, 2)
        cases[f"ensemble:{rows}"] = (X, forest, 5, "ensemble")
        cases[f"gbt:{rows}"] = (X, forest, 5, "gbt")
    cases["jobs:8x200000_depth8"] = (rows_of(SWEEP_EVAL_ROWS), heaps(1, 8, 2, jobs=JOBS), 8, "jobs")
    X_deep = rows_of(DEEP_ROWS)
    cases["ensemble:20x10"] = (X_deep, heaps(TREES, 10, 2), 10, "ensemble")
    deep_tree = heaps(1, 12, 20)
    cases["ensemble:1x12x20"] = (X_deep, deep_tree, 12, "ensemble")
    cases["gbt:1x12"] = (X_deep, deep_tree, 12, "gbt")

    def call(name, X, forest, depth, form):
        fh, th, probs, values = forest
        if name == "forward_row_threads":
            lib = libraries["tree_forward", name]
            if form == "gbt":
                return row_threads_forward(torch, kernels, lib, X, fh, th, values, depth, True, -0.2, 0.1)
            jobs = (fh, th, probs) if form == "jobs" else (fh[None], th[None], probs[None])
            out = row_threads_forward(torch, kernels, lib, X, *jobs, depth)
            return out if form == "jobs" else out[0]
        if form == "gbt":
            return trees.gbt_forward(X, -0.2, fh, th, values, 0.1, depth)
        if form == "jobs":
            return trees.job_ensemble_forward(X, fh, th, probs, depth)
        return trees.ensemble_forward(X, fh, th, probs, depth)

    def plain(X, forest, depth, form):
        fh, th, probs, values = forest
        if form == "gbt":
            return trees._gbt_forward(X, -0.2, fh, th, values, 0.1, depth)
        if form == "jobs":
            return trees._job_ensemble_forward(X, fh, th, probs, depth)
        return trees._ensemble_forward(X, fh, th, probs, depth)

    plains = {case: plain(*args) for case, args in cases.items()}
    names = [name for name in FORWARD_FORMS if ("tree_forward", FORWARD_FORMS[name][0]) in libraries]
    results: dict = {name: [] for name in names}
    for name in [*names, *names[1:][::-1], names[0]]:
        library, knobs = FORWARD_FORMS[name]
        kernels._libraries["tree_forward"] = libraries["tree_forward", library]
        trees._forward_prepared.clear()
        saved = {knob: getattr(trees, knob) for knob in knobs}
        for knob, value in knobs.items():
            setattr(trees, knob, value)
        trees._forward_geometry_at.cache_clear()
        run = {}
        try:
            for case, args in cases.items():
                got, want = call(library, *args), plains[case]
                same = torch.equal(got, want) if args[3] != "gbt" else float((got - want).abs().max()) <= 1e-6
                if not same:
                    raise SystemExit(f"{name}: {case} differs from the plain version")
                run[case] = cold_ms(lambda: call(library, *args))
                run[f"{case}:device"] = cold_device_ms(lambda: call(library, *args), "forward_kernel")
        finally:
            for knob, value in saved.items():
                setattr(trees, knob, value)
            trees._forward_geometry_at.cache_clear()
        results[name].append(run)
    kernels._libraries.pop("tree_forward", None)
    trees._forward_prepared.clear()
    return results


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tree_fit_variants.py needs a CUDA card", file=sys.stderr)
        return 1
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.ml import trees

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    before = argv[argv.index("--before") + 1] if "--before" in argv else None
    sources = {}
    with open(kernels.SOURCES["tree_forward"]) as handle:
        sources["tree_forward"] = forward_sources(handle.read(), before)
    if "forward" not in argv:
        with open(kernels.SOURCES["tree_fit"]) as handle:
            sources["tree_fit"] = variant_sources(handle.read())
    libraries = build_all(kernels, sources)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def cold_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPEATS):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def cold_device_ms(fn, kernel_name: str):
        """Mean device milliseconds a call of the CUDA kernels named
        ``kernel_name`` (the profiler's trace), each call after the flush;
        None when three traces in a row lost launches."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as trace:
                for _ in range(REPEATS):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
            spans = [e.time_range.end - e.time_range.start for e in trace.events() if kernel_name in e.name]
            if len(spans) == REPEATS:
                return sum(spans) / len(spans) / 1000.0
        return None

    results = {"tree_forward": time_forward(torch, kernels, trees, libraries, cold_ms, cold_device_ms)}
    if "tree_fit" in sources:
        results["tree_fit"] = time_fit(torch, kernels, trees, libraries, cold_ms)
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
