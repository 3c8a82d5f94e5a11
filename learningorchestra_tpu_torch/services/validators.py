"""The request-validation strings and checks the model builder and the
image lane answer with: the subset of
``learningorchestra_tpu/services/validators.py`` they need, with
identical text."""

from __future__ import annotations

from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.utils.paths import safe_filename

MESSAGE_INVALID_FILENAME = "invalid_filename"
MESSAGE_DUPLICATE_FILE = "duplicate_file"
MESSAGE_MISSING_FIELDS = "missing_fields"
MESSAGE_INVALID_LABEL = "invalid_field"
MESSAGE_NOT_FOUND = "file_not_found"
MESSAGE_INVALID_TRAINING_FILENAME = "invalid_training_filename"
MESSAGE_INVALID_TEST_FILENAME = "invalid_test_filename"
MESSAGE_INVALID_CLASSIFICATOR = "invalid_classificator_name"

__all__ = [
    "MESSAGE_DUPLICATE_FILE",
    "MESSAGE_INVALID_CLASSIFICATOR",
    "MESSAGE_INVALID_FILENAME",
    "MESSAGE_INVALID_LABEL",
    "MESSAGE_INVALID_TEST_FILENAME",
    "MESSAGE_INVALID_TRAINING_FILENAME",
    "MESSAGE_MISSING_FIELDS",
    "MESSAGE_NOT_FOUND",
    "ValidationError",
    "filename_exists",
    "label_in_metadata",
    "metadata_fields",
    "safe_filename",
]


class ValidationError(Exception):
    """Carries the reference's error string as ``args[0]``."""


def filename_exists(
    store: DocumentStore, filename: str, message: str = MESSAGE_INVALID_FILENAME
) -> None:
    if filename not in store.list_collections():
        raise ValidationError(message)


def metadata_fields(store: DocumentStore, filename: str) -> list:
    metadata = store.find_one(filename, {"filename": filename})
    if metadata is None or not isinstance(metadata.get("fields"), list):
        return []
    return metadata["fields"]


def label_in_metadata(store: DocumentStore, filename: str, label) -> None:
    """tsne/pca label validator: None allowed (reference tsne.py:177-186)."""
    if label is None:
        return
    if label not in metadata_fields(store, filename):
        raise ValidationError(MESSAGE_INVALID_LABEL)
