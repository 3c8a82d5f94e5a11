"""Native runtime components (C++), bound via ctypes.

``loader.py`` exposes the C++ columnar CSV parser (``csv_loader.cpp``, a
copy of the JAX package's) with a pure-Python fallback, so the port
degrades gracefully on hosts without a toolchain; ``native_stats()``
says which path ran.
"""

from learningorchestra_tpu_torch.native.loader import (
    NativeCsv,
    native_available,
    native_stats,
    read_csv_columns,
)

__all__ = ["NativeCsv", "native_available", "native_stats", "read_csv_columns"]
