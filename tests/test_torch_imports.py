"""Import rules of the PyTorch port.

The port (learningorchestra_tpu_torch/) and chip_smoke.py import torch,
numpy and the standard library, never ``jax`` and never any module of the
JAX package ``learningorchestra_tpu`` (matched by its exact name or the
prefix ``learningorchestra_tpu.``; the port's own name shares the prefix
without the dot).
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
    )


def port_sources() -> list:
    paths = [os.path.join(_REPO_ROOT, "chip_smoke.py")]
    for folder, _, files in os.walk(_PACKAGE):
        paths += [os.path.join(folder, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_forbidden_names():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("jaxlib.xla_client")
    assert forbidden("learningorchestra_tpu") and forbidden("learningorchestra_tpu.serve")
    assert not forbidden("learningorchestra_tpu_torch")
    assert not forbidden("learningorchestra_tpu_torch.serve")


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
    assert len(port_sources()) > 15
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
    assert "chip_smoke" in report["added"]
    assert [name for name in report["added"] if forbidden(name)] == []
