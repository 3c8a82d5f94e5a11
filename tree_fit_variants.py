"""Times K4 (route) and K5's counts path (leaf_sums, integer=True) of
learningorchestra_tpu_torch/kernels/csrc/tree_fit.cu against the forms
their design weighed and left out, on one CUDA card.

Each variant is the kernel source with a passage or two replaced:

- ``route_bins_once_a_node_splits``: K4 loads a row's bins only once a
  node of the row splits, so that a row that no tree of its group splits
  reads no bins, where the kept kernel loads them with the row's nodes;
- ``counts_warp_aggregated``: K5's counts path groups a warp's lanes by
  (leaf, channel) cell (``__match_any_sync``) and adds each group's count
  once (``__reduce_add_sync``) before the shared-memory atomic, where the
  kept kernel adds each lane's count with its own atomic.

Every variant is built with nvcc (all at once) into the kernels' build
folder, checked equal to the plain versions (``trees._route``,
``trees._leaf_sums``) on every case, and timed cold: 256 MB written before
each call so that it finds none of its inputs in L2, CUDA events around
the call, the median of the repeats. The shapes are chip_smoke.py's:
1,000,000 rows x 16 int8 features at 32 bins, 20 trees over one bins
matrix, 8 sweep jobs of 1,048,576 rows each with its own bins, 256 job
leaves, and 4,096 leaves x 10 classes. The variants run in the order
kept, variants, variants reversed, kept, each run reported on its own.

Run it from the repository's root on a machine with a card and the CUDA
toolkit:

    python3 tree_fit_variants.py

It prints the card's name and power limit, then one JSON object as its
last line: {variant: [{case: ms, ...} for each run]}.
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
    """Each variant's library, built by nvcc processes started together."""
    folder = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(folder, exist_ok=True)
    nvcc = kernels._find_nvcc()
    processes = {}
    for name, text in sources.items():
        source = os.path.join(folder, f"{name}.cu")
        with open(source, "w") as handle:
            handle.write(text)
        processes[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", os.path.join(folder, f"{name}.so"), source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libraries = {}
    for name, process in processes.items():
        output = process.communicate()[0]
        if process.returncode != 0:
            raise SystemExit(f"nvcc failed to build variant {name}:\n{output[-4000:]}")
        libraries[name] = kernels._bind_tree_fit(ctypes.CDLL(os.path.join(folder, f"{name}.so")))
    return libraries


def main() -> int:
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
    with open(kernels.SOURCES["tree_fit"]) as handle:
        libraries = build_all(kernels, variant_sources(handle.read()))

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

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

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

    names = list(libraries)
    results: dict = {name: [] for name in names}
    for name in [*names, *names[1:][::-1], names[0]]:
        kernels._libraries["tree_fit"] = libraries[name]
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
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
