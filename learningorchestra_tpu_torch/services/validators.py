"""The request-validation strings the predict lane answers with — the
subset of ``learningorchestra_tpu/services/validators.py`` it needs,
with identical text."""

from __future__ import annotations

from learningorchestra_tpu_torch.utils.paths import safe_filename

MESSAGE_MISSING_FIELDS = "missing_fields"
MESSAGE_NOT_FOUND = "file_not_found"

__all__ = ["MESSAGE_MISSING_FIELDS", "MESSAGE_NOT_FOUND", "safe_filename"]
