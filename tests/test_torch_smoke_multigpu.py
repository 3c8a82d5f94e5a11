"""chip_smoke.py's ``multigpu`` phase, its part over ranks, rehearsed on the
CPU at a small size.

On the card each run's children are ``chip_smoke.py multigpu-child``
processes, one a rank; after the lr fits each runs the SPMD fits of dt,
rf, gb and nb with ``evaluate_predict`` over the ranks, PCA and a landmark
t-SNE request over the ranks, and the parent holds runs (b) and (c)
against its one-process fits (``_others_against_one_process``).

Run (d), four gloo ranks as data 2 x model 2 (lr's classes and rf's
trees over the model axis), is rehearsed beside a one-rank run (b), as the
phase holds it.

Run (c)'s sweeps over its data ranks (the λ and depth sweeps through
``group_runner(mesh=...)``) and run (e), the runner's multi-host mode
(a store server and two runner ranks over gloo, the SPMD dispatcher
carrying the build, the batch prediction and the images to rank 1, and
the drill that kills rank 1 mid-t-SNE), are rehearsed the same way.

Here two gloo ranks run as child processes on the CPU: each child is a
small wrapper that cuts the sizes (3,000 fit rows, 3,000 embed rows, 1,000
landmarks: fewer part the two fits' KL by more than the phase's margin, as
any two t-SNE fits whose sums round apart), stubs ``torch.cuda.synchronize`` and the
kernel libraries, and turns its ``cuda:<n>`` into ``cpu``. The launch
counts (which only the card's kernels raise) are stubbed to one for every
kernel; on the card the phase fails unless every rank launched the
kernels of each fit. The same checks then run in this process against
the port's one-process fits on the CPU at the same sizes.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch.ops import tsne  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"FIT_ROWS": 3_000, "EMBED_ROWS": 3_000, "SWEEP_ROWS": 3_000, "SWEEP_EVAL_ROWS": 1_000,
         "SWEEP_POINTS": 12}
SPMD_ROWS = 1_000   # run e's product rows
LANDMARKS = 1_000
ITERATIONS = 1_000
RANKS = 2

CHILD = """
import inspect, sys
sys.path.insert(0, {root!r})
import torch
torch.cuda.synchronize = lambda *args, **kwargs: None
import chip_smoke
from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.ops import pca, tsne
pca.resolve_device = tsne.resolve_device = lambda device=None: torch.device("cpu")   # a one-rank run's
for name, value in {sizes!r}.items():
    setattr(chip_smoke, name, value)
tsne.LANDMARKS = {landmarks}
names = list(inspect.signature(tsne.tsne_embedding).parameters)[1:]
defaults = dict(zip(names, tsne.tsne_embedding.__defaults__))
defaults.update(iterations={iterations}, landmarks={landmarks})
tsne.tsne_embedding.__defaults__ = tuple(defaults.values())
kernels.library = lambda name: None
kernels.launches = lambda: {{name: 1 for name in kernels.KERNEL_NAMES}}
args = sys.argv[1:]
args[4] = "cpu"
sys.exit(chip_smoke.multigpu_child(args))
"""


def _cut_tsne(monkeypatch):
    import inspect

    names = list(inspect.signature(tsne.tsne_embedding).parameters)[1:]
    defaults = dict(zip(names, tsne.tsne_embedding.__defaults__))
    defaults.update(iterations=ITERATIONS, landmarks=LANDMARKS)
    monkeypatch.setattr(tsne.tsne_embedding, "__defaults__", tuple(defaults.values()))
    monkeypatch.setattr(tsne, "LANDMARKS", LANDMARKS)


@pytest.fixture()
def on_the_cpu(monkeypatch, tmp_path):
    from learningorchestra_tpu_torch.ops import pca
    from learningorchestra_tpu_torch.parallel import mesh

    wrapper = tmp_path / "multigpu_child.py"
    wrapper.write_text(CHILD.format(root=_ROOT, sizes=SIZES, landmarks=LANDMARKS, iterations=ITERATIONS))
    monkeypatch.setattr(chip_smoke, "MULTIGPU_CHILD_COMMAND", [sys.executable, str(wrapper)])
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name, value in SIZES.items():
        monkeypatch.setattr(chip_smoke, name, value)
    _cut_tsne(monkeypatch)

    def cpu(device=None):
        return torch.device("cpu") if device is None else torch.device(device)

    for module in (mesh, pca, tsne):
        monkeypatch.setattr(module, "resolve_device", cpu)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *args, **kwargs: self)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args, **kwargs: None)
    monkeypatch.setattr(chip_smoke, "_card", lambda torch: torch.device("cpu"))


@pytest.fixture()
def rehearsed(on_the_cpu, tmp_path):
    run = chip_smoke._multigpu_run(torch, "c", "gloo", RANKS, 1, True, str(tmp_path / "runs"), sweeps=True)
    return run, chip_smoke._one_process_others(torch)


def test_the_other_fits_over_two_gloo_ranks(rehearsed):
    (run, solo) = rehearsed
    summary, arrays = run["summary"], run["arrays"]
    assert set(summary["others"]) == {*chip_smoke.OTHER_FITS, "pca", "tsne"}
    for name, other in summary["others"].items():
        assert len(other["wall_s"]) == RANKS and all(wall > 0 for wall in other["wall_s"])
        assert all(count > 0 for count in other["collectives"]), name
        assert all(launches for launches in other["launches"])
    for name in chip_smoke.OTHER_FITS:
        assert 0.5 < summary["others"][name]["accuracy"] <= 1.0
        assert summary["others"][name]["evaluate"]["collectives"] > 0
    held = chip_smoke._others_against_one_process(torch, "c", arrays, solo)
    assert held["dt"]["heaps_identical"] and held["rf"]["heaps_identical"]
    assert held["gb"]["margin_max_abs_err"] <= chip_smoke.MULTIGPU_GB_MARGIN_TOL
    assert held["gb"]["gb_heaps_identical"] == (held["gb"]["first_difference"] is None)
    assert held["nb"]["probs_max_abs_err"] <= chip_smoke.MULTIGPU_NB_TOL
    assert held["pca"]["max_rel_err"] <= chip_smoke.MULTIGPU_PCA_RTOL
    assert held["tsne"]["kl"]["rel_diff"] <= chip_smoke.KL_MARGIN
    assert arrays["tsne"].shape == (SIZES["EMBED_ROWS"], 2)
    json.dumps(held)   # the record is emitted as JSON


def test_run_cs_sweeps_over_the_ranks(rehearsed):
    """Run (c)'s sweeps: the ranks' outcomes identical (the run checks
    their digests), each lr slot of every rank's block bit-identical to
    its run alone at the rank's width, every rank launching the job-axis
    kernels, and against one process: dt bit-equal, lr's best and
    accuracies equal and its params within SWEEP_PARAMS_TOL."""
    run, _ = rehearsed
    sweeps, arrays = run["summary"]["sweeps"], run["arrays"]
    from learningorchestra_tpu_torch.ml import sweep

    points = SIZES["SWEEP_POINTS"]
    local = sweep._job_axis(points, _mesh(RANKS)) // RANKS
    assert [alone["width"] for alone in sweeps["lr"]["alone"]] == [local] * RANKS
    assert sum(alone["slots"] for alone in sweeps["lr"]["alone"]) == points
    for kind in ("lr", "dt"):
        assert len(sweeps[kind]["wall_s"]) == RANKS
        assert all(count > 0 for count in sweeps[kind]["collectives"])
        assert arrays[f"sweep_{kind}"]["best"] == sweeps[kind]["best"]
    held = chip_smoke._sweeps_against_one_process(torch, "c", arrays)
    assert held["dt"]["bit_equal"] is True
    assert max(held["lr"]["params_max_rel_err"].values()) <= chip_smoke.SWEEP_PARAMS_TOL
    json.dumps(run["summary"])


def _mesh(world):
    from learningorchestra_tpu_torch.parallel.mesh import Mesh

    return Mesh(shape={"data": world, "model": 1}, data_index=0, group=None, device=torch.device("cpu"))


def test_a_run_fails_when_a_rank_launched_no_sums_form():
    """The launch check a run's ranks are held to: the sums forms and the
    slabs over several ranks, today's launches on one."""
    assert "level_histograms_sums" in chip_smoke._required_launches("gb", 4)
    assert "level_histograms" in chip_smoke._required_launches("gb", 1)
    assert "tsne_grad_slab" in chip_smoke._required_launches("tsne", 2)
    assert "tsne_grad" in chip_smoke._required_launches("tsne", 1)
    assert chip_smoke._required_launches("dt", 4) == chip_smoke._required_launches("dt", 1)
    assert chip_smoke._required_launches("nb", 4) == ()


@pytest.mark.parametrize("name", ("level_histograms_sums", "leaf_sums_sums"))
def test_sums_form_bounds_are_bytes(name):
    bound_ms, bound_by = chip_smoke._sums_bound(name, chip_smoke.MULTIGPU_BLOCK_ROWS, 16 * 16 * 32)
    assert bound_by == "bytes" and 0 < bound_ms < 0.01


@pytest.mark.parametrize("name", ("tsne_affinities_slab", "tsne_z_slab", "tsne_grad_slab"))
def test_slab_bounds_grow_with_the_slab(name):
    small, _ = chip_smoke._slab_bound(name, 1_250, 5_000)
    large, _ = chip_smoke._slab_bound(name, 5_000, 5_000)
    assert 0 < small < large


def test_the_landmark_slabs_cover_the_rows():
    slabs = chip_smoke._row_slabs(5_000, chip_smoke.MULTIGPU_SLABS)
    assert slabs[0][0] == 0 and slabs[-1][1] == 5_000
    assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))


def test_a_gb_split_difference_names_the_node_and_both_gains():
    rng = np.random.default_rng(0)
    X = rng.random((500, 4), dtype=np.float32)
    y = (X[:, 0] > 0.5).astype(np.float64)
    depth, nodes = chip_smoke.DEPTH, 2**chip_smoke.DEPTH - 1
    features = np.full((2, nodes), -1, np.int32)
    thresholds = np.zeros((2, nodes), np.float32)
    features[:, 0], thresholds[:, 0] = 0, 0.5
    want = {"features_heap": features, "thresholds_heap": thresholds, "f0": np.float32(0.0),
            "leaf_values": np.zeros((2, nodes + 1), np.float32)}
    assert chip_smoke._gb_split_difference(want, want, X, y) is None
    got = dict(want, features_heap=features.copy(), thresholds_heap=thresholds.copy())
    got["features_heap"][1, 0], got["thresholds_heap"][1, 0] = 1, 0.5
    difference = chip_smoke._gb_split_difference(want, got, X, y)
    assert (difference["round"], difference["node"], difference["rows"]) == (1, 0, 500)
    assert difference["one_process"]["gain"] > difference["over_ranks"]["gain"]
    assert depth == 5


# --------------------------------------------------------------------------
# Run d: the model axis (four gloo ranks as data 2 x model 2) against run b
# --------------------------------------------------------------------------

@pytest.fixture()
def grid_rehearsed(on_the_cpu, tmp_path):
    folder = str(tmp_path / "runs")
    runs = {
        "b": chip_smoke._multigpu_run(torch, "b", "gloo", 1, 1, False, folder, 1, "ten,bf16"),
        "d": chip_smoke._multigpu_run(torch, "d", "gloo", chip_smoke.GRID_DATA * chip_smoke.GRID_MODEL,
                                      1, False, folder, chip_smoke.GRID_MODEL, "ten,bf16"),
    }
    return runs, chip_smoke._one_process_others(torch)


def test_run_d_shards_lr_and_rf_over_the_model_axis(grid_rehearsed):
    """Run d's lr fits (two classes, ten, and under bf16) agree with run b's
    as the phase holds them (labels 0.999, losses MULTIGPU_LOSS_RTOL, the
    same iterations); its ranks hold the same bits; rf's heaps are the
    one-process fit's and nb's probabilities within MULTIGPU_NB_TOL."""
    runs, solo = grid_rehearsed
    summary, arrays = runs["d"]["summary"], runs["d"]["arrays"]
    assert summary["mesh"] == [2, 2] and summary["coordinates"] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert set(summary["others"]) == set(chip_smoke.GRID_FITS)
    base = runs["b"]["arrays"]
    for fit in chip_smoke.LR_FITS:
        assert len(summary[fit]["wall_s"]) == 4
        assert all(count > 0 for count in summary[fit]["model_collectives"]), fit
        chip_smoke._agreement(fit, arrays[f"{fit}_labels"], arrays[f"{fit}_losses"],
                              base[f"{fit}_labels"], base[f"{fit}_losses"])
    assert runs["b"]["summary"]["fit_sharded"]["model_collectives"] == [0]
    held = chip_smoke._grid_against_one_process("d", arrays, solo)
    assert held["rf"]["heaps_identical"] and held["nb"]["probs_max_abs_err"] <= chip_smoke.MULTIGPU_NB_TOL
    json.dumps(summary)


def test_the_lr_path_names_the_class_shard_kernels_where_the_model_axis_shards():
    shard = chip_smoke._lr_path("fit_sharded", [2, 2])
    assert {"logistic_shard_stats", "logistic_shard_grad", "masked_col_sums"} <= set(shard)
    assert "logistic_loss_grad_sums" not in shard
    assert chip_smoke._lr_path("fit_sharded", [2, 1]) == tuple(chip_smoke.MULTIGPU_REPLACES)
    assert chip_smoke._lr_path("fit", [4, 1]) == ("logistic_loss_grad_sums", "logistic_trial_losses_sums")


@pytest.mark.parametrize("name", ("logistic_shard_stats", "logistic_shard_grad"))
@pytest.mark.parametrize("x_bytes", (4, 2))
def test_shard_bounds_are_bytes_at_run_ds_block(name, x_bytes):
    rows = chip_smoke._grid_block_rows()
    assert rows == 524_288
    bound_ms, bound_by = chip_smoke._shard_bound(name, rows, 16, 5, 4 if name.endswith("stats") else 1,
                                                 x_bytes)
    assert bound_by == "bytes" and 0.005 < bound_ms < 0.05


def test_bf16_ulps_count_bfloat16_steps():
    a = torch.tensor([1.0, 2.0, -3.0], dtype=torch.bfloat16)
    b = a.clone()
    assert chip_smoke._bf16_ulps(torch, a, b) == 0
    b[1] = 2.015625   # the next bfloat16 after 2
    assert chip_smoke._bf16_ulps(torch, a, b) == 1


# --------------------------------------------------------------------------
# Run e: the runner's multi-host mode, two gloo ranks
# --------------------------------------------------------------------------

SPMD_CHILD = """
import sys
sys.path.insert(0, {root!r})
from learningorchestra_tpu_torch import kernels
kernels.library = lambda name: None
kernels.launches = lambda: {{name: 1 for name in kernels.KERNEL_NAMES}}
from learningorchestra_tpu_torch.services.runner import main
main(device="cpu", backend="gloo")
"""


@pytest.fixture()
def spmd_rehearsed(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "SPMD_RUNNER_COMMAND", [sys.executable, "-c", SPMD_CHILD.format(root=_ROOT)])
    monkeypatch.setattr(chip_smoke, "PRODUCT_ROWS", SPMD_ROWS)
    monkeypatch.setattr(chip_smoke, "FIT_ROWS", SIZES["FIT_ROWS"])
    monkeypatch.setattr(chip_smoke, "_card", lambda torch: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args, **kwargs: None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    folder = tmp_path / "runs"
    folder.mkdir()
    return chip_smoke._spmd_stack_run(torch, "cpu", str(folder))


def test_run_e_dispatches_the_stack_over_two_ranks(spmd_rehearsed):
    """Run (e) on the CPU: every answer the reference's, each collection
    its rows and one metadata document, one PNG an image, rank 1's log
    naming each job and its (stubbed) launches, the build held to one
    process's, the drill's t-SNE request a 500 within the watchdog and the
    next build the poisoned error."""
    record = spmd_rehearsed
    assert set(record["prediction_documents"].values()) == {SPMD_ROWS + 1}
    assert record["images"] == {"pca": ["spmd_pca.png"], "tsne": ["spmd_tsne.png"]}
    assert set(record["worker_jobs"]) == {"build", "predict", "pca", "tsne"}
    assert all(job["collectives"] > 0 for what, job in record["worker_jobs"].items() if what != "predict")
    for name in ("dt", "rf", "nb"):
        assert record["against_one_process"][name]["equal"], name
    assert record["drill"]["status"] == 500
    assert "SpmdRuntimePoisonedError" in record["drill"]["poisoned_build"]
    assert record["walls_s"]["drill: kill to error"] <= float(chip_smoke.SPMD_TIMEOUT_S) + 5
    assert any(line.startswith("lo_spmd_jobs_total") for line in record["lo_spmd"])
    json.dumps(record)
