"""ctypes bindings for the native CSV loader, with lazy build + fallback.

The port's copy of ``learningorchestra_tpu/native/loader.py``, module and
public names kept. The shared object is compiled on first use with g++
(``-O3 -shared -fPIC -std=c++17``) from ``csv_loader.cpp`` into
``_build/`` beside it (git-ignored), never into the source directory; a
library built from the same source bytes is reused. Hosts without a
toolchain (or where the build fails) fall back to the Python csv module
with identical results: the native path is a performance feature, not a
correctness dependency. The fallback is not silent: :func:`native_stats`
counts native parses and fallbacks and holds why the build failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "csv_loader.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_STATS = {"native_parses": 0, "fallbacks": 0, "library": None, "built": False, "error": None}


def native_stats() -> dict:
    """The loader's record: ``native_parses`` (files the C++ parser read),
    ``fallbacks`` (files that went to the Python parser instead),
    ``library`` (the shared object's path once loaded), ``built`` (this
    process ran g++) and ``error`` (why the library is unavailable, or
    why the last fallback happened)."""
    with _lock:
        return dict(_STATS)


def reset_native_stats() -> None:
    """Zero the parse counts (the library stays loaded)."""
    with _lock:
        _STATS["native_parses"] = 0
        _STATS["fallbacks"] = 0


def _count(kind: str, error: Optional[str] = None) -> None:
    with _lock:
        _STATS[kind] += 1
        if error is not None:
            _STATS["error"] = error


def library_path() -> str:
    """Where the library built from the current source bytes lives."""
    with open(_SOURCE, "rb") as handle:
        digest = hashlib.sha256(handle.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"csv_loader-{digest}.so")


def _build(target: str) -> Optional[ctypes.CDLL]:
    """Compile into a private name, then publish with ``os.replace``, so
    two processes building at once never load a half-written library."""
    global _build_failed
    partial = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", *GXX_FLAGS, _SOURCE, "-o", partial],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(partial, target)
    except subprocess.CalledProcessError as error:
        _build_failed = True
        _STATS["error"] = f"g++ failed: {error.stderr.decode(errors='replace').strip()}"
        return None
    except (OSError, subprocess.SubprocessError) as error:
        _build_failed = True
        _STATS["error"] = f"cannot build {_SOURCE}: {error}"
        return None
    finally:
        if os.path.exists(partial):
            os.unlink(partial)
    _STATS["built"] = True
    return _load(target)


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.csv_open.restype = ctypes.c_void_p
    lib.csv_open.argtypes = [ctypes.c_char_p]
    lib.csv_close.argtypes = [ctypes.c_void_p]
    lib.csv_num_rows.restype = ctypes.c_uint64
    lib.csv_num_rows.argtypes = [ctypes.c_void_p]
    lib.csv_num_cols.restype = ctypes.c_uint64
    lib.csv_num_cols.argtypes = [ctypes.c_void_p]
    lib.csv_cell.restype = ctypes.c_void_p
    lib.csv_cell.argtypes = [
        ctypes.c_void_p,
        ctypes.c_longlong,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.csv_col_is_numeric.restype = ctypes.c_int
    lib.csv_col_is_numeric.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.csv_fill_numeric.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.csv_col_string_bytes.restype = ctypes.c_uint64
    lib.csv_col_string_bytes.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.csv_fill_strings.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
    ]
    _STATS["library"] = path
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            if not os.path.exists(_SOURCE):
                _build_failed = True
                _STATS["error"] = f"no source at {_SOURCE}"
                return None
            target = library_path()
            try:
                _lib = _load(target) if os.path.exists(target) else _build(target)
            except OSError:
                # built on another host (a copied checkout): build it here
                _lib = _build(target)
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


class NativeCsv:
    """A parsed CSV file: header, cells, columnar numeric extraction."""

    def __init__(self, path: str):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native CSV loader unavailable")
        self._lib = lib
        self._handle = lib.csv_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot parse CSV at {path!r}")
        self.num_rows = lib.csv_num_rows(self._handle)
        self.num_cols = lib.csv_num_cols(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.csv_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeCsv":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def cell(self, row: int, col: int) -> str:
        """Cell text; ``row == -1`` reads the header."""
        length = ctypes.c_uint32()
        pointer = self._lib.csv_cell(self._handle, row, col, ctypes.byref(length))
        if not pointer or length.value == 0:
            return ""
        return ctypes.string_at(pointer, length.value).decode("utf-8")

    def header(self) -> list[str]:
        return [self.cell(-1, j) for j in range(self.num_cols)]

    def column_is_numeric(self, col: int) -> bool:
        return bool(self._lib.csv_col_is_numeric(self._handle, col))

    def numeric_column(self, col: int) -> np.ndarray:
        out = np.empty(self.num_rows, dtype=np.float64)
        self._lib.csv_fill_numeric(
            self._handle,
            col,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out

    def string_column(self, col: int) -> np.ndarray:
        """One bulk NUL-joined copy out of C, one decode, one split —
        no per-cell ctypes round trips."""
        total = self._lib.csv_col_string_bytes(self._handle, col)
        buffer = ctypes.create_string_buffer(int(total))
        self._lib.csv_fill_strings(self._handle, col, buffer)
        cells = buffer.raw[: int(total)].decode("utf-8").split("\x00")
        if len(cells) != self.num_rows + 1:
            # a cell contained a literal NUL: the separator protocol
            # over-splits — take the exact per-cell path instead.
            out = np.empty(self.num_rows, dtype=object)
            for i in range(self.num_rows):
                out[i] = self.cell(i, col)
            return out
        out = np.empty(self.num_rows, dtype=object)
        out[:] = cells[: self.num_rows]
        return out


MAX_NUMERIC_CELL = 511  # both paths treat longer cells as strings


def _python_read(path: str) -> dict[str, np.ndarray]:
    import csv

    with open(path, encoding="utf-8", newline="") as handle:
        reader = csv.reader(handle)
        header = next(reader)
        rows = [row for row in reader if row]
    columns: dict[str, np.ndarray] = {}
    for j, name in enumerate(header):
        raw = [row[j] if j < len(row) else "" for row in rows]
        try:
            # Reject what strtod rejects so both paths agree: oversized
            # cells, underscore separators ("1_000"), non-ASCII digits.
            if any(
                len(cell) > MAX_NUMERIC_CELL or "_" in cell or not cell.isascii()
                for cell in raw
            ):
                raise ValueError("cell outside the shared numeric grammar")
            columns[name] = np.array(
                [np.nan if cell == "" else float(cell) for cell in raw],
                dtype=np.float64,
            )
        except ValueError:
            columns[name] = _strings_column(raw)
    return columns


def _strings_column(cells: list[str]) -> np.ndarray:
    """Object column with the ColumnTable missing-value convention:
    empty cells become None, not ''."""
    out = np.empty(len(cells), dtype=object)
    for i, cell in enumerate(cells):
        out[i] = None if cell == "" else cell
    return out


def _open_native(path: str) -> Optional[NativeCsv]:
    """The native parse of ``path``, or ``None`` (counted as a fallback,
    with its reason) when the library is unavailable or the strict
    parser rejects the file (ragged-wide rows, for one)."""
    if _get_lib() is None:
        _count("fallbacks")
        return None
    try:
        parsed = NativeCsv(path)
    except OSError as error:
        _count("fallbacks", str(error))
        return None
    _count("native_parses")
    return parsed


def read_csv_string_columns(path: str):
    """Header plus every column as an Arrow-layout string
    :class:`~learningorchestra_tpu_torch.core.columns.Column`, built
    straight from the native parser's NUL-joined bulk export — raw cell
    strings (``""`` for empty, the ingest contract, reference
    database.py:156-169) with **zero Python string objects
    materialized**. Returns ``None`` when the native parser is
    unavailable or rejects the file.
    """
    from learningorchestra_tpu_torch.core.columns import Column

    parsed = _open_native(path)
    if parsed is None:
        return None
    lib = parsed._lib
    with parsed:
        header = parsed.header()
        columns = []
        for j in range(parsed.num_cols):
            total = int(lib.csv_col_string_bytes(parsed._handle, j))
            buffer = ctypes.create_string_buffer(total)
            lib.csv_fill_strings(parsed._handle, j, buffer)
            try:
                columns.append(
                    Column.from_nul_joined(buffer.raw[:total], parsed.num_rows)
                )
            except ValueError:
                # a cell contained a literal NUL: exact per-cell path
                columns.append(
                    Column.from_strings(
                        [parsed.cell(i, j) for i in range(parsed.num_rows)]
                    )
                )
    return header, columns


def read_csv_raw_columns(path: str) -> Optional[tuple[list[str], list[list[str]]]]:
    """Header plus every column as raw cell strings (``""`` for empty) —
    the ingest contract, which stores values untyped (reference:
    microservices/database_api_image/database.py:156-169; the fieldtypes
    service converts later). Returns ``None`` when the native parser is
    unavailable or rejects the file (caller falls back to Python)."""
    parsed = _open_native(path)
    if parsed is None:
        return None
    with parsed:
        header = parsed.header()
        columns = [
            parsed.string_column(j).tolist() for j in range(parsed.num_cols)
        ]
    return header, columns


def read_csv_columns(path: str) -> dict[str, np.ndarray]:
    """CSV → columns: float64 (NaN for empty) where every cell parses as
    a number, object strings otherwise. Native when available, Python
    fallback with identical semantics."""
    parsed = _open_native(path)
    if parsed is None:
        # e.g. ragged-wide rows the strict native parser rejects — the
        # tolerant Python path still handles them.
        return _python_read(path)
    with parsed:
        header = parsed.header()
        columns: dict[str, np.ndarray] = {}
        for j, name in enumerate(header):
            if parsed.column_is_numeric(j):
                columns[name] = parsed.numeric_column(j)
            else:
                column = parsed.string_column(j)
                column[column == ""] = None  # missing-value convention
                columns[name] = column
        return columns
