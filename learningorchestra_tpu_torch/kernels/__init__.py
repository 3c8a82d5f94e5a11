"""Hand-written CUDA kernels: build, binding and launch counters.

Each kernel's source lives in ``csrc/``. At first use the source is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds). The library lands in ``_build/`` under a name that carries a
hash of the source, and is published with ``os.replace``, so two
processes never load half a file and an edited source is rebuilt.

The wrappers that launch these kernels live beside their plain PyTorch
versions (``ml/trees.py``). Each wrapper adds one to its kernel's launch
count where it launches, and nowhere else, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
TREE_FORWARD_SOURCE = os.path.join(_HERE, "csrc", "tree_forward.cu")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> launches; kernels of this library
KERNEL_NAMES = ("tree_ensemble_forward", "gbt_forward")
_launches = {name: 0 for name in KERNEL_NAMES}
_launch_lock = threading.Lock()

_library: Optional[ctypes.CDLL] = None
_library_lock = threading.Lock()
# what the last build in this process did: path, seconds, ptxas report
build_info: dict = {}


def count_launch(name: str) -> None:
    with _launch_lock:
        _launches[name] += 1


def launches() -> dict:
    with _launch_lock:
        return dict(_launches)


def reset_launches() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)"
    )


def build(source: str = TREE_FORWARD_SOURCE) -> str:
    """Compile ``source`` into ``_build/`` unless a library built from the
    same bytes is already there; returns the library's path."""
    with open(source, "rb") as handle:
        digest = hashlib.sha256(handle.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    target = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    if os.path.isfile(target):
        build_info.update(path=target, seconds=0.0, built=False, ptxas="")
        return target
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    partial = f"{target}.{os.getpid()}.tmp"
    started = time.perf_counter()
    result = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", partial, source],
        capture_output=True,
        text=True,
        timeout=600,
    )
    if result.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source}:\n{result.stdout}{result.stderr}"
        )
    os.replace(partial, target)
    build_info.update(
        path=target,
        seconds=time.perf_counter() - started,
        built=True,
        ptxas=result.stdout + result.stderr,
    )
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _library
    with _library_lock:
        if _library is None:
            _library = _bind(ctypes.CDLL(build()))
        return _library


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lo_tree_ensemble_forward.argtypes = [
        ptr, ptr, ptr, ptr, ptr,             # X, features, thresholds, leaves, out
        c_int, c_int, c_int, c_int, c_int,   # rows, F, trees, depth, classes
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    lib.lo_tree_ensemble_forward.restype = c_int
    lib.lo_gbt_forward.argtypes = [
        ptr, ptr, ptr, ptr, ptr,             # X, features, thresholds, values, out
        c_int, c_int, c_int, c_int,          # rows, F, trees, depth
        c_float, c_float,                    # f0, step
        c_int, c_int, ptr,                   # max_blocks, device, stream
    ]
    lib.lo_gbt_forward.restype = c_int
    lib.lo_error_string.argtypes = [c_int]
    lib.lo_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, error: int) -> None:
    """Raise when a launch was refused (``cudaGetLastError`` != 0)."""
    if error != 0:
        message = lib.lo_error_string(error).decode(errors="replace")
        raise RuntimeError(f"{name} launch failed: CUDA error {error}: {message}")
