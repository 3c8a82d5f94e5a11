"""Filesystem-name safety (copy of ``learningorchestra_tpu/utils/paths.py``)."""

from __future__ import annotations

import os


def safe_filename(name: str) -> bool:
    """A bare filename only — no separators or traversal components — so
    request-supplied names can never escape their volume."""
    return bool(name) and os.path.basename(name) == name and name not in (".", "..")
