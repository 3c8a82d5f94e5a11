"""Packaging of the port: an installed ``learningorchestra_tpu_torch``
stands on its own.

The install is the reference's own (``tests/test_packaging.py``: ``pip
install --no-deps --no-build-isolation --target``), of the files that
``git archive`` of the working tree would hold (tracked, and untracked
but not ignored). From the installed tree alone (``PYTHONPATH`` naming
only it, run outside the checkout) the runner, the store, the builder,
the SPMD dispatcher and the kernels' wrappers import, and the CUDA
(``kernels/csrc/*.cu``) and C++ (``native/*.cpp``) sources the port
builds at first use are there. Every directory of the port that holds
an ``__init__.py`` is listed in ``pyproject.toml`` and installed.
"""

import json
import os
import shutil
import subprocess
import sys
import tomllib

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "learningorchestra_tpu_torch"
# what the install reads: the build settings and the packages they list
INSTALLED_FROM = ("pyproject.toml", "README.md", "learningorchestra_tpu/", f"{PACKAGE}/",
                  "learning_orchestra_client/")


def port_packages(root: str) -> list:
    """Every dotted package of the port under ``root``: the directories
    that hold an ``__init__.py``."""
    found = []
    for folder, _, files in os.walk(os.path.join(root, PACKAGE)):
        if "__init__.py" in files:
            found.append(os.path.relpath(folder, root).replace(os.sep, "."))
    return sorted(found)


def archived_files() -> list:
    """The files ``git archive`` of the working tree would hold that the
    install reads."""
    listed = subprocess.run(
        ["git", "-C", _ROOT, "ls-files", "-z", "--cached", "--others", "--exclude-standard"],
        capture_output=True, check=True, timeout=60,
    ).stdout.decode().split("\0")
    return sorted(
        name for name in listed
        if name.startswith(INSTALLED_FROM) and os.path.isfile(os.path.join(_ROOT, name))
    )


_PROBE = """
import importlib, json, os, sys
site = sys.argv[1]
names = ["services.runner", "core.store", "ml.builder", "parallel.spmd", "kernels", "native.loader",
         "parallel", "sched.recovery", "services.model_builder", "ops.images"]
modules = {name: importlib.import_module("learningorchestra_tpu_torch." + name) for name in names}
from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.native import loader
from learningorchestra_tpu_torch.parallel.spmd import SpmdDispatcher
from learningorchestra_tpu_torch.services.runner import main, make_dispatcher
print(json.dumps({
    "files": {name: module.__file__ for name, module in modules.items()},
    "cuda_sources": {name: os.path.isfile(path) and path for name, path in kernels.SOURCES.items()},
    "cpp_source": os.path.isfile(loader._SOURCE) and loader._SOURCE,
    "jax": "jax" in sys.modules or any(m.startswith("learningorchestra_tpu.") for m in sys.modules),
}))
"""


def test_pyproject_lists_every_package_of_the_port():
    with open(os.path.join(_ROOT, "pyproject.toml"), "rb") as handle:
        settings = tomllib.load(handle)["tool"]["setuptools"]
    listed = {name for name in settings["packages"] if name.split(".")[0] == PACKAGE}
    assert listed == set(port_packages(_ROOT))
    assert len(listed) == 16
    data = settings["package-data"]
    assert data[f"{PACKAGE}.kernels"] == ["csrc/*.cu"] and data[f"{PACKAGE}.native"] == ["*.cpp"]
    # the reference's entries as they were
    assert data["learningorchestra_tpu.native"] == ["*.cpp"]


@pytest.mark.integration
def test_an_installed_port_imports_and_ships_its_sources(tmp_path):
    source = tmp_path / "archive"
    for name in archived_files():
        os.makedirs(source / os.path.dirname(name), exist_ok=True)
        shutil.copy2(os.path.join(_ROOT, name), source / name)
    site = tmp_path / "site"
    install = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--quiet", "--no-deps", "--no-build-isolation",
         "--target", str(site), str(source)],
        capture_output=True, text=True, timeout=300,
    )
    assert install.returncode == 0, install.stderr
    assert port_packages(str(site)) == port_packages(_ROOT)

    outside = tmp_path / "elsewhere"
    outside.mkdir()
    env = {**os.environ, "PYTHONPATH": str(site)}   # ONLY the installed tree
    run = subprocess.run(
        [sys.executable, "-c", _PROBE, str(site)], capture_output=True, text=True, env=env,
        cwd=str(outside), timeout=120,
    )
    assert run.returncode == 0, run.stderr
    report = json.loads(run.stdout.strip().splitlines()[-1])
    for name, path in report["files"].items():
        assert path.startswith(str(site)), (name, path)
    expected = {os.path.splitext(name)[0] for name in os.listdir(os.path.join(_ROOT, PACKAGE, "kernels", "csrc"))}
    assert set(report["cuda_sources"]) == expected
    for name, path in report["cuda_sources"].items():
        assert path and path.startswith(str(site)), name
    assert report["cpp_source"] and report["cpp_source"].startswith(str(site))
    assert report["jax"] is False
