"""chip_smoke.py's ``services`` phase rehearsed on the CPU at a small size.

The phase starts a store server and seven runners as child processes,
one a service (``LO_SERVICE``, ``LO_PORT``, ``LO_PLANE_MEMBERS``,
``LO_METRICS_INTERVAL_S=1``), drives the Titanic walkthrough, an async
five-classifier build on the product collections and a PCA image over
HTTP under one correlation ID, and holds them to an in-process twin over
the same store: the build's outputs and the PNG, model_builder's byte
counters against the twin's, the build's Chrome trace and summary, the
stitched trace's rows, a sampled profile during a build, the metrics
history and the SLO verdict.

Here the children run ``main(device='cpu')`` and count the CPU's copies
as a card's (``tests/torch_card_copies.py``, installed before ``main``),
as the twin does in this process; the product collections are cut to
2,000 rows; the kernel launch counts (which only the card's kernels
raise) are stubbed, both the twin's and those on model_builder's
``/metrics``, and with them the kernel libraries whose loads the card's
model_builder counts: on the card the phase fails unless every kernel of
the build launched in both processes and each library's load was
counted.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch.core import devcache  # noqa: E402
from tests.test_torch_smoke_batch import Launches  # noqa: E402
from tests.torch_card_copies import count_cpu_copies  # noqa: E402

# a child runner on the CPU whose copies count as a card's would
CPU_CHILD = """
from tests.torch_card_copies import count_cpu_copies
count_cpu_copies()
from learningorchestra_tpu_torch.services.runner import main
main(device="cpu")
"""


class NoLibraries(Launches):
    KERNEL_LIBRARIES: dict = {}


@pytest.fixture()
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SERVICE_COMMAND", [sys.executable, "-c", CPU_CHILD])
    monkeypatch.setattr(chip_smoke, "SERVICES_CHILD_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SERVICES_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "kernels", NoLibraries())
    monkeypatch.setattr(chip_smoke, "_served_launches", lambda before, after: NoLibraries().launches())
    monkeypatch.setattr(chip_smoke, "PRODUCT_ROWS", 2_000)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    count_cpu_copies(monkeypatch.setattr)
    devcache.reset_global_devcache()
    yield
    devcache.reset_global_devcache()


def test_services_phase_runs_on_the_cpu(on_the_cpu, capsys):
    record = chip_smoke.phase_services(torch, "cpu rehearsal")
    assert sorted(record["boot_s"]) == sorted(chip_smoke.SERVICE_NAMES)
    flows = record["flows"]
    assert flows["model_builder"]["h2d"] == flows["twin"]["h2d"] > 0
    assert flows["model_builder"]["d2h"] == flows["twin"]["d2h"] > 0
    assert flows["model_builder"]["wire_read"] > 0
    assert {"database_api", "projection", "data_type_handler", "histogram", "model_builder", "pca"} <= set(
        record["stitched_rows"])
    assert record["profile_samples"] > 0
    overhead = record["profiler_overhead_build_wall_s"]
    assert len(overhead["with"]) == len(overhead["without"]) == 2 and overhead["window_s"] >= 1.0
    assert sorted(record["held_to_twin"]) == sorted(chip_smoke.MODEL_NAMES)
    assert '"phase": "services"' in capsys.readouterr().out


def test_served_launches_are_the_delta_of_one_process():
    """The served build's launches are read from model_builder's own
    ``/metrics``: each kernel's samples added between two texts, 0 for a
    kernel or a family not there yet."""
    before = '# TYPE lo_kernel_launches_total counter\nlo_kernel_launches_total{kernel="route"} 4.0\n'
    after = (
        "# TYPE lo_kernel_launches_total counter\n"
        'lo_kernel_launches_total{kernel="route"} 9.0\n'
        'lo_kernel_launches_total{kernel="logistic_loss_grad"} 26.0\n'
        'lo_kernel_launches_total{kernel="logistic_loss_grad_sums"} 3.0\n'
    )
    counts = chip_smoke._served_launches(before, after)
    assert sorted(counts) == sorted(chip_smoke.BUILD_KERNELS)
    assert counts["route"] == 5 and counts["logistic_loss_grad"] == 26 and counts["apply_bins"] == 0
    assert chip_smoke._served_launches("", after)["route"] == 9


def test_the_twin_is_held_bit_for_bit():
    outputs = {
        name: {"labels": np.zeros(3), "probability": np.full((3, 2), 0.5), "metrics": np.array([1.0, 1.0])}
        for name in chip_smoke.MODEL_NAMES
    }
    assert chip_smoke._held_bitwise("t", outputs, outputs) == {name: "bit-equal" for name in chip_smoke.MODEL_NAMES}
    moved = {**outputs, "gb": {**outputs["gb"], "probability": np.nextafter(outputs["gb"]["probability"], 1.0)}}
    with pytest.raises(AssertionError, match="gb: probability"):
        chip_smoke._held_bitwise("t", moved, outputs)


def test_services_phase_is_a_phase_of_its_own():
    """``python3 chip_smoke.py services`` runs it, after every other phase."""
    assert chip_smoke.PHASES[-1] == "services"
    assert chip_smoke._build_libraries() == ["logistic", "tree_fit", "tree_forward"]
