"""chip_smoke.py's ``deploy`` phase rehearsed on the CPU at a small size.

The phase runs the port's supervisor (``python -m
learningorchestra_tpu_torch.deploy.stack``) with the compile plane on,
and the cluster driver (``python -m learningorchestra_tpu_torch.deploy.
cluster up``) over the local transport with a head and a worker-only
machine whose build folder starts empty; it builds over REST, holds the
builds to an in-process build and to one process's, and kills
model_builder and then the worker's runner to see both heal.

Here every child runs with ``LO_DEVICE=cpu`` (the cluster's ranks over
gloo, as on the card); the product collections are cut to 2,000 rows; a
stand-in ``nvcc`` first on ``PATH`` writes known bytes (the libraries are
built into a folder of the test's own first, as the build phase builds
them on the card, and none is ever loaded); the kernel launch counts
(which only the card's kernels raise) are stubbed, model_builder's and
the worker rank's. On the card the phase fails unless every kernel of
the build launched in both.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.core import devcache  # noqa: E402
from tests.test_torch_compile import FAKE_NVCC  # noqa: E402


@pytest.fixture()
def on_the_cpu(tmp_path, monkeypatch):
    folder = tmp_path / "fake_bin"
    folder.mkdir()
    nvcc = folder / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(tmp_path / "nvcc_calls.log")))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{folder}{os.pathsep}{os.environ['PATH']}")
    # the build phase's libraries, in a folder of the test's own
    built = tmp_path / "kernels"
    monkeypatch.setattr(kernels, "build_info", {})
    monkeypatch.setenv("LO_JIT_CACHE", str(built))
    for name in kernels.SOURCES:
        kernels.build(name)
    monkeypatch.delenv("LO_JIT_CACHE")
    monkeypatch.setattr(chip_smoke, "DEPLOY_JIT_CACHE", str(built))
    monkeypatch.setattr(chip_smoke, "DEPLOY_ENV", {"LO_DEVICE": "cpu"})
    monkeypatch.setattr(chip_smoke, "DEPLOY_CHILD_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DEPLOY_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "PRODUCT_ROWS", 2_000)
    every_kernel = {name: 1 for name in kernels.KERNEL_NAMES}
    monkeypatch.setattr(chip_smoke, "_served_launches", lambda before, after: dict(every_kernel))
    monkeypatch.setattr(chip_smoke, "_worker_job_launches", lambda counts: dict(every_kernel))
    devcache.reset_global_devcache()
    yield tmp_path / "nvcc_calls.log"
    devcache.reset_global_devcache()


def test_deploy_phase_runs_on_the_cpu(on_the_cpu, capsys):
    nvcc_calls = on_the_cpu.read_text().splitlines()
    assert len(nvcc_calls) == 5   # the build phase's, before the phase
    record = chip_smoke.phase_deploy(torch, "cpu rehearsal")
    assert on_the_cpu.read_text().splitlines() == nvcc_calls   # no child ran nvcc
    stack, cluster = record["stack"], record["cluster"]
    assert sorted(stack["boot_s"]) == sorted([*chip_smoke.SERVICE_NAMES, "all services up"])
    assert stack["aot"] == {"compiled": 5.0, "hits": 5.0, "misses": 0.0}
    assert stack["libraries"] == sorted(kernels.library_file(name) for name in kernels.SOURCES)
    assert sorted(stack["held"]) == sorted(chip_smoke.MODEL_NAMES)
    assert cluster["fetch"]["fetched"] == 5 and cluster["fetch"]["events"] == {"hit/fleetcache": 5.0}
    assert sorted(cluster["held"]) == sorted(chip_smoke.MODEL_NAMES)
    assert len(cluster["worker_jobs"]) == 2
    walls = record["walls_s"]
    for key in ("stack: kill to the next 201", "cluster: kill to the next 201", "stack: build in process"):
        assert walls[key] > 0
    assert sorted(record["cold_nvcc_s"]) == sorted(kernels.SOURCES)
    assert '"phase": "deploy"' in capsys.readouterr().out


def test_deploy_is_a_phase_of_its_own():
    """``python3 chip_smoke.py deploy`` runs it, after every other phase
    but ``services`` (the build phase before it)."""
    assert chip_smoke.PHASES[-2:] == ("deploy", "services")
    assert chip_smoke.DEPLOY_STACK_COMMAND[-1] == "learningorchestra_tpu_torch.deploy.stack"
    assert chip_smoke.DEPLOY_CLUSTER_COMMAND[-2:] == ["learningorchestra_tpu_torch.deploy.cluster", "up"]
