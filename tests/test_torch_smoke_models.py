"""chip_smoke.py's ``models`` phase rehearsed on the CPU at a small size.

The phase drives two builds through the port's model_builder app over
real HTTP: the Titanic flow of ``tests/data`` (projected, ingested and
cast, then the documented preprocessor) and bench.py's product path,
sync and ``async`` (waited on through ``/jobs/<name>/wait``), and holds
each build's stored labels against its checkpoints, its metrics against
numpy's, its predict lane against the stored labels and its outputs
against the same request built by the plain versions. Here the app,
the serve plane and ``load_model`` run on the CPU, the product path has
2,000 rows, and the kernel launch counts (which only the card's kernels
raise) are stubbed: on the card the phase fails unless every kernel of
the build launched.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml.checkpoint import load_model  # noqa: E402
from learningorchestra_tpu_torch.serve import ServePlane  # noqa: E402
from learningorchestra_tpu_torch.services.model_builder import create_app  # noqa: E402


class Launches:
    """Every kernel launched once since the last reset."""

    def reset_launches(self):
        pass

    def launches(self):
        return {name: 1 for name in kernels.KERNEL_NAMES}


def test_models_phase_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "create_app", lambda store, **kw: create_app(store, device="cpu", **kw))
    monkeypatch.setattr(chip_smoke, "ServePlane", lambda: ServePlane(device="cpu"))
    monkeypatch.setattr(chip_smoke, "load_model", lambda path: load_model(path, device="cpu"))
    monkeypatch.setattr(chip_smoke, "kernels", Launches())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(chip_smoke, "PRODUCT_ROWS", 2_000)
    monkeypatch.setattr(chip_smoke, "FIT_ROWS", 4_000)
    record = chip_smoke.phase_models(torch, "cpu rehearsal")
    builds = {(build["build"], build["async"]): build for build in record["builds"]}
    assert sorted(builds) == [("product", False), ("product", True), ("titanic", False)]
    titanic = builds["titanic", False]
    assert titanic["rows"]["test"] == 418
    assert titanic["rows"]["train"] + titanic["rows"]["eval"] == 891
    assert builds["product", True]["rows"] == {"train": 2_000, "eval": 2_000, "test": 2_000}
    for build in record["builds"]:
        assert sorted(build["classifiers"]) == sorted(chip_smoke.MODEL_NAMES)
        assert sorted(build["spans_s"]) == ["load_data", "preprocess"]
        assert build["k9_calls"] == 5
        assert sorted(build["held_to_plain"]) == sorted(chip_smoke.MODEL_NAMES)
        assert build["plain_build_wall_s"] > 0
        for classifier in build["classifiers"].values():
            assert sorted(classifier["timings"]) == ["checkpoint", "evaluate", "fit", "write"]
    assert '"phase": "models"' in capsys.readouterr().out


def _outputs(labels, probability, metrics):
    return {
        name: {
            "labels": np.array(labels, dtype=np.float64),
            "probability": np.array(probability, dtype=np.float64),
            "metrics": np.array(metrics, dtype=np.float64),
        }
        for name in chip_smoke.MODEL_NAMES
    }


def test_a_build_is_held_to_the_plain_build():
    plain = _outputs([0, 1], [[0.9, 0.1], [0.2, 0.8]], [1.0, 1.0])
    errors = chip_smoke.held_to_plain("same", plain, plain)
    assert errors == {name: {"max_prob_err": 0.0, "max_metric_err": 0.0} for name in chip_smoke.MODEL_NAMES}
    with pytest.raises(AssertionError, match="labels differ"):
        chip_smoke.held_to_plain("label", _outputs([0, 0], [[0.9, 0.1], [0.2, 0.8]], [1.0, 1.0]), plain)
    # dt is held bit for bit, gb within its margin tolerance
    nudged = _outputs([0, 1], [[0.9, 0.1], [0.2 + 1e-7, 0.8]], [1.0, 1.0])
    with pytest.raises(AssertionError, match="dt: probabilities"):
        chip_smoke.held_to_plain("probability", nudged, plain)
    metric = _outputs([0, 1], [[0.9, 0.1], [0.2, 0.8]], [1.0, 1.0 - 1e-5])
    with pytest.raises(AssertionError, match="metrics"):
        chip_smoke.held_to_plain("metric", metric, plain)


def test_the_plain_build_swaps_every_kernel_of_a_build():
    from learningorchestra_tpu_torch.ml import binning, logistic, trees

    wrappers = {
        "apply_bins": (trees, binning._apply_bins),
        "level_histograms": (trees, chip_smoke._plain_histograms),
        "select_splits": (trees, trees._select_plain),
        "route": (trees, trees._route),
        "leaf_sums": (trees, chip_smoke._plain_leaf_sums),
        "ensemble_forward": (trees, trees._ensemble_forward),
        "gbt_forward": (trees, trees._gbt_forward),
        "loss_and_grad": (logistic, logistic._loss_fn),
        "trial_losses": (logistic, logistic._trial_losses),
    }
    before = {name: getattr(module, name) for name, (module, _) in wrappers.items()}
    with chip_smoke._plain_build():
        for name, (module, plain) in wrappers.items():
            assert getattr(module, name) is plain, name
    assert {name: getattr(module, name) for name, (module, _) in wrappers.items()} == before
