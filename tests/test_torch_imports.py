"""Import rules of the PyTorch port.

The port (learningorchestra_tpu_torch/) and chip_smoke.py import torch,
numpy and the standard library, never ``jax`` and never any module of the
JAX package ``learningorchestra_tpu`` (matched by its exact name or the
prefix ``learningorchestra_tpu.``; the port's own name shares the prefix
without the dot), nor the JAX package's deployment scripts (the
top-level ``deploy``: the port has its own, ``learningorchestra_tpu_torch.
deploy``). Nor ``requests`` or ``werkzeug``, which the machine
with the card does not have: the port's web layer and its store client
are on ``http.server`` and ``http.client``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PACKAGE = os.path.join(_REPO_ROOT, "learningorchestra_tpu_torch")


def forbidden(module: str) -> bool:
    return (
        module == "jax"
        or module.startswith("jax.")
        or module.startswith("jaxlib")
        or module == "learningorchestra_tpu"
        or module.startswith("learningorchestra_tpu.")
        or module.split(".")[0] in ("requests", "werkzeug", "deploy", "cluster", "stack")
    )


def port_sources() -> list:
    paths = [os.path.join(_REPO_ROOT, "chip_smoke.py")]
    for folder, _, files in os.walk(_PACKAGE):
        paths += [os.path.join(folder, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_forbidden_names():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("jaxlib.xla_client")
    assert forbidden("learningorchestra_tpu") and forbidden("learningorchestra_tpu.serve")
    assert forbidden("requests") and forbidden("requests.adapters")
    assert forbidden("werkzeug") and forbidden("werkzeug.serving")
    assert not forbidden("learningorchestra_tpu_torch")
    assert not forbidden("learningorchestra_tpu_torch.serve")
    assert not forbidden("requests_like") and not forbidden("http.client")
    assert forbidden("deploy") and forbidden("deploy.cluster") and forbidden("cluster")
    assert not forbidden("learningorchestra_tpu_torch.deploy.cluster")


def test_sources_import_neither_jax_nor_the_jax_package():
    offenders = []
    for path in port_sources():
        with open(path) as handle:
            tree = ast.parse(handle.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [
                f"{os.path.relpath(path, _REPO_ROOT)}:{node.lineno} {name}"
                for name in names
                if forbidden(name)
            ]
    assert len(port_sources()) > 25
    assert offenders == []


_PROBE = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import learningorchestra_tpu_torch as package
names = [package.__name__] + [
    info.name for info in pkgutil.walk_packages(package.__path__, package.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"imported": names, "added": sorted(set(sys.modules) - before)}))
"""


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    result = subprocess.run(
        [sys.executable, "-c", _PROBE],
        capture_output=True,
        text=True,
        cwd=_REPO_ROOT,
        timeout=120,
    )
    assert result.returncode == 0, result.stderr
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert "learningorchestra_tpu_torch.services.model_builder" in report["imported"]
    assert "learningorchestra_tpu_torch.kernels" in report["imported"]
    for module in ("binning", "evaluation", "trees", "base", "logistic", "naive_bayes"):
        assert f"learningorchestra_tpu_torch.ml.{module}" in report["imported"]
    for module in (
        "core.columns", "core.store", "core.table", "core.devcache",
        "ops.pca", "ops.tsne", "ops.images", "services.images", "services.validators",
        "ml.sweep", "sched", "sched.coalesce", "sched.config", "sched.cancel",
        "telemetry", "telemetry.metrics", "telemetry.tracing", "testing", "testing.faults",
        "parallel", "parallel.sharding", "parallel.mesh", "parallel.multihost", "parallel.spmd",
        "ml.progress", "sched.journal", "sched.recovery", "core.jobs",
        "services.database_api", "services.projection", "services.data_type_handler",
        "services.histogram", "services.runner", "ops.projection", "ops.histogram",
        "core.wire", "core.shmring", "core.arbiter", "core.store_service", "utils.httpclient",
        "telemetry.profile", "telemetry.stitch", "telemetry.tsdb", "telemetry.slo",
        "core.shardmap", "core.shardstore", "core.ingest", "native", "native.loader",
        "utils.webloop", "compile", "compile.warmup", "serve.fleet", "serve.router", "serve.loadgen",
        "compile.aot", "compile.config", "compile.fleetcache", "compile.manifest",
        "deploy", "deploy.preflight", "deploy.run", "deploy.stack", "deploy.cluster",
    ):
        assert f"learningorchestra_tpu_torch.{module}" in report["imported"]
    assert "chip_smoke" in report["added"]
    assert [name for name in report["added"] if forbidden(name)] == []


_MAIN_PROBE = """
import json, runpy, sys
before = set(sys.modules)
try:
    runpy.run_module("learningorchestra_tpu_torch.services.runner", run_name="__main__")
except RuntimeError as error:
    outcome = str(error)
else:
    outcome = "served"
print(json.dumps({"outcome": outcome, "added": sorted(set(sys.modules) - before)}))
"""


def test_the_runner_as_main_needs_cuda_and_loads_no_jax(tmp_path):
    """``python -m learningorchestra_tpu_torch.services.runner`` defaults to
    the CUDA card: here, with none, it raises before it opens a store or
    a port, and what it imported on the way holds neither JAX nor the
    JAX package."""
    env = dict(os.environ, LO_DATA_DIR=str(tmp_path / "lo_data"), CUDA_VISIBLE_DEVICES="")
    result = subprocess.run(
        [sys.executable, "-c", _MAIN_PROBE],
        capture_output=True,
        text=True,
        cwd=_REPO_ROOT,
        env=env,
        timeout=120,
    )
    assert result.returncode == 0, result.stderr
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert "no CUDA device is available" in report["outcome"]
    assert "learningorchestra_tpu_torch.services.model_builder" in report["added"]  # the runner's imports
    assert [name for name in report["added"] if forbidden(name)] == []
    assert not (tmp_path / "lo_data").exists()


@pytest.mark.parametrize("service", ["model_builder", "database_api"])
def test_one_service_as_main_needs_cuda_and_loads_no_jax(tmp_path, service):
    """With ``LO_SERVICE`` and ``LO_PORT`` the runner serves one service,
    on the card all the same: here it raises before it opens a store or
    a port, and imports neither JAX nor the JAX package."""
    env = dict(
        os.environ, LO_DATA_DIR=str(tmp_path / "lo_data"), CUDA_VISIBLE_DEVICES="",
        LO_SERVICE=service, LO_PORT="0",
    )
    result = subprocess.run(
        [sys.executable, "-c", _MAIN_PROBE], capture_output=True, text=True, cwd=_REPO_ROOT, env=env, timeout=120,
    )
    assert result.returncode == 0, result.stderr
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert "no CUDA device is available" in report["outcome"]
    assert [name for name in report["added"] if forbidden(name)] == []
    assert not (tmp_path / "lo_data").exists()


@pytest.mark.parametrize("service,words", [("routers", "'router'"), ("planner", "must be one of")])
def test_the_runner_refuses_a_service_it_does_not_serve(tmp_path, service, words):
    """An unknown ``LO_SERVICE`` lists the seven and the fleet router
    (``router``, which the runner serves)."""
    env = dict(os.environ, LO_DATA_DIR=str(tmp_path / "lo_data"), LO_SERVICE=service)
    result = subprocess.run(
        [sys.executable, "-m", "learningorchestra_tpu_torch.services.runner"],
        capture_output=True, text=True, cwd=_REPO_ROOT, env=env, timeout=120,
    )
    assert result.returncode != 0 and words in result.stderr
    assert not (tmp_path / "lo_data").exists()
