"""chip_smoke.py's ``stack`` phase rehearsed on the CPU at a small size.

The phase resumes a gb and an lr fit from a progress artifact after the
``fit.segment`` fault stopped them (each resumed model bit-equal to an
uninterrupted fit), drives the runner's ``start_all`` over HTTP (the
Titanic walkthrough through the four data services and an async build,
held to ``build_model``; ``POST /models/sweep`` held to ``run_sweep``
and its winner to ``load_model``), and kills a child runner mid-build
to prove the restarted one finishes it with equal metrics. Here every
entry point runs on the CPU (``STACK_DEVICE``, and the child started
with ``main(device="cpu")``), the fits have 5,000 rows (cut into 5 gb
chunks and 10 lr segments), the product collections 2,000, the λ grid
10 points, the drill 1,000 rows, and the kernel launch counts (which
only the card's kernels raise) are stubbed: on the card the phase fails
unless the resumed part and every request launched their kernels.
"""

import sys

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402


class Launches:
    """Every kernel launched once since the last reset."""

    def reset_launches(self):
        pass

    def launches(self):
        return {name: 1 for name in kernels.KERNEL_NAMES}


def test_stack_phase_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "STACK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "RUNNER_COMMAND", [
        sys.executable, "-c", "from learningorchestra_tpu_torch.services.runner import main; main(device='cpu')",
    ])
    monkeypatch.setattr(chip_smoke, "kernels", Launches())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(chip_smoke, "FIT_ROWS", 5_000)
    monkeypatch.setattr(chip_smoke, "STACK_SEGMENT_SCALE", 5e-4)
    monkeypatch.setattr(chip_smoke, "PRODUCT_ROWS", 2_000)
    monkeypatch.setattr(chip_smoke, "SWEEP_POINTS", 10)
    monkeypatch.setattr(chip_smoke, "DRILL_ROWS", 1_000)
    monkeypatch.setattr(chip_smoke, "DRILL_ROW_STEPS", "0.0001")
    record = chip_smoke.phase_stack(torch, "cpu rehearsal")
    assert record["resume"]["gbt"]["segments"] == 5 and record["resume"]["logistic"]["segments"] == 10
    for resumed in record["resume"].values():
        assert resumed["skipped"] == 1 and resumed["bit_equal"]
    assert sorted(record["titanic"]["metrics"]) == sorted(chip_smoke.MODEL_NAMES)
    assert record["sweeps"]["lr"]["points"] == 10 and record["sweeps"]["dt"]["points"] == 3
    assert record["sweeps"]["dt"]["k9_calls"] == 3
    drill = record["drill"]
    assert drill["equal_to_uninterrupted"] and drill["segments_skipped"] >= 1 and drill["jobs_resumed"] == 1
    assert sorted(drill["metrics"]) == sorted(chip_smoke.MODEL_NAMES)
    for wall in ("ingest titanic_train", "POST /histograms", "POST /models/sweep lr",
                 "drill restart to finished"):
        assert record["walls_s"][wall] > 0
    assert '"phase": "stack"' in capsys.readouterr().out


def test_the_drill_reads_the_metrics_text():
    text = (
        "# TYPE lo_build_segments_skipped_total counter\n"
        "lo_build_segments_skipped_total 3.0\n"
        'lo_sched_resumed_total{a="b"} 1.0\n'
        'lo_sched_resumed_total{a="c"} 2.0\n'
    )
    assert chip_smoke._metric_total(text, "lo_build_segments_skipped_total") == 3.0
    assert chip_smoke._metric_total(text, "lo_sched_resumed_total") == 3.0
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke._metric_total(text, "lo_build_segments_saved_total")
