"""chip_smoke.py's ``batch`` and ``bf16`` phases rehearsed on the CPU at a
small size.

``batch``: the five classifiers built over HTTP on the product store,
``POST /models/<name>/predictions`` over a test collection of the same
schema, every written label held to its ``.model``, a second request
served by the device cache (hits, no misses, no copied bytes), an insert
that moves the rev and reloads, and the eviction that frees the cached
matrices. ``bf16``: the child's body under ``LO_DTYPE_POLICY=bf16`` (both
packages' read-once caches emptied and restored): K1, K6 and K7 on
bfloat16 X against their float32 form on the widened X and their plain
versions, at every width and geometry the card checks (K7 also on rows
of 202, 444 and 20,000 features, past its staged tile); the lr build on
rows of 256 features; the bfloat16
product build, its cached matrices and its labels; the image requests
(t-SNE 201, PCA the reference's refusal); a sweep that stays float32.

Here the apps, the serve plane and ``load_model`` run on the CPU, the
sizes are cut, the timers return 0, the card's byte counters are
stubbed (``tests/torch_card_copies.py`` counts the CPU's copies, and
``torch.cuda.memory_allocated`` reads the cache's device entries), and
the kernel launch counts (which only the card's kernels raise) are
stubbed: on the card the phases fail unless every kernel launched.
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu.utils import dtypepolicy as jax_dtypepolicy  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.core import devcache  # noqa: E402
from learningorchestra_tpu_torch.ml.checkpoint import load_model  # noqa: E402
from learningorchestra_tpu_torch.serve import ServePlane  # noqa: E402
from learningorchestra_tpu_torch.services import images  # noqa: E402
from learningorchestra_tpu_torch.services.model_builder import create_app  # noqa: E402
from learningorchestra_tpu_torch.utils import dtypepolicy  # noqa: E402
from tests.torch_card_copies import count_cpu_copies  # noqa: E402


class Launches:
    """Every kernel launched once since the last reset."""

    def reset_launches(self):
        pass

    def launches(self):
        return {name: 1 for name in kernels.KERNEL_NAMES}


def _cached_device_bytes(*args):
    return sum(entry.nbytes for key, entry in devcache.global_devcache()._entries.items() if key[0] == devcache.CONTENT)


@pytest.fixture()
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "create_app", lambda store, **kw: create_app(store, device="cpu", **kw))
    monkeypatch.setattr(chip_smoke, "ServePlane", lambda: ServePlane(device="cpu"))
    monkeypatch.setattr(chip_smoke, "load_model", lambda path: load_model(path, device="cpu"))
    monkeypatch.setattr(chip_smoke, "kernels", Launches())
    monkeypatch.setattr(chip_smoke, "_event_ms", lambda *args, **kwargs: 0.0)
    monkeypatch.setattr(chip_smoke, "_card", lambda torch: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", _cached_device_bytes)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *args, **kwargs: self)
    count_cpu_copies(monkeypatch.setattr)
    monkeypatch.setattr(images, "create_app", lambda *args, create_app=images.create_app, **kw: create_app(
        *args, device="cpu", **kw))
    for name, value in (
        ("PRODUCT_ROWS", 2_000), ("FIT_ROWS", 4_000), ("BATCH_ROWS", 3_000), ("BF16_EDGE_ROWS", 1_001),
        ("KERNEL_ROWS", (1, 64, 4096, 40_000)), ("BF16_EMBED_ROWS", 300), ("BF16_SWEEP_ROWS", 2_000),
        ("BF16_K7_WIDE_ROWS", 64), ("BF16_LR_ROWS", 2_000),
    ):
        monkeypatch.setattr(chip_smoke, name, value)
    devcache.reset_global_devcache()
    yield
    devcache.reset_global_devcache()


@pytest.fixture(autouse=True, scope="module")
def reference_registry_in_step():
    """After this module, the JAX package's process-wide metrics registry
    holds the families that the port's code here registers in the port's
    (the device cache's gauges, the fits' segment counters), as the
    reference's own code registers them when it does the same work:
    tests/test_torch_builder_routes.py holds the port's families to be
    among the reference's in one worker process."""
    yield
    from learningorchestra_tpu.core import devcache as reference_devcache
    from learningorchestra_tpu.ml import progress as reference_progress

    reference_devcache.global_devcache()
    reference_progress._saved_counter()
    reference_progress._skipped_counter()


def test_batch_phase_runs_on_the_cpu(on_the_cpu, capsys):
    record = chip_smoke.phase_batch(torch, "cpu rehearsal")
    assert sorted(record["requests"]) == sorted(chip_smoke.MODEL_NAMES)
    for request in record["requests"].values():
        assert request["rows"] == 3_000
        assert sorted(request["timings"]) == ["h2d", "load_data", "predict", "preprocess", "write"]
    assert record["cached_request"]["rows"] == 3_000 and record["moved_request"]["rows"] == 3_001
    first, second = record["devcache"]["first"], record["devcache"]["second"]
    assert second["misses"] == first["misses"] and second["hits"] >= first["hits"] + 3
    assert record["evicted"]["freed_bytes"] >= record["evicted"]["bytes"] > 0
    assert sorted(record["f32_metrics"]) == sorted(chip_smoke.MODEL_NAMES)
    assert '"phase": "batch"' in capsys.readouterr().out


def test_bf16_child_runs_on_the_cpu(on_the_cpu, monkeypatch, capsys):
    monkeypatch.setenv("LO_DTYPE_POLICY", "bf16")
    monkeypatch.setattr(jax_dtypepolicy, "_POLICY", [])
    monkeypatch.setattr(dtypepolicy, "_POLICY", [])
    checked = chip_smoke.check_bf16_kernels(torch, None)
    assert sorted(checked) == sorted(chip_smoke.BF16_FORMS)
    for name, result in checked.items():
        assert result["bound_ms"] < result["f32_bound_ms"], name
    shapes = checked["tree_ensemble_forward:bf16"]["by_shape"]
    assert {shape["row_threads"] for shape in shapes.values()} == {True, False}
    wide = checked["logistic_loss_grad:bf16"]["wide"]
    assert sorted(wide) == sorted(f"{f}x{c}" for f in chip_smoke.BF16_K7_WIDE_FEATURES for c in (2, 10))
    assert {entry["x_staged"] for entry in wide.values()} == {True, False}
    lr = chip_smoke.bf16_lr_build(torch)
    assert lr["features"] == 256 and lr["geometry"][3] is True and lr["trial_geometry"][3] is False
    build = chip_smoke.bf16_build(torch)
    assert all(matrix["dtype"] == "torch.bfloat16" for matrix in build["device_matrices"])
    assert all(matrix["bytes"] * 2 == matrix["f32_bytes"] for matrix in build["device_matrices"])
    answers = chip_smoke.bf16_images(torch)
    assert answers["tsne"]["status"] == 201 and answers["pca"]["status"] == 500
    assert chip_smoke.bf16_sweep(torch)["payload_dtype"] == "float32"
    capsys.readouterr()


def test_the_bf16_bounds_are_the_bytes_of_bfloat16_rows():
    """At the main path's shapes the bounds fall with the bytes of X."""
    k1, _ = chip_smoke._fit_bound("apply_bins", 1_000_000, 1, 1, x_bytes=2)
    k6, _ = chip_smoke._bound(1_048_576, 20, "tree_ensemble_forward", x_bytes=2)
    k7, _ = chip_smoke._k7_bound(1_000_000, 16, 2, False, x_bytes=2)
    assert (round(k1, 4), round(k6, 4), round(k7, 4)) == (0.0143, 0.0125, 0.0107)
    assert chip_smoke._fit_bound("apply_bins", 1_000_000, 1, 1)[0] == pytest.approx(0.0239, abs=1e-4)
