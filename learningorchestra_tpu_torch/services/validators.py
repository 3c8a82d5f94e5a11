"""Request validators shared by the services — the ``*RequestValidator``
classes of the reference, with identical error strings.

Error-string constants are copied from the reference interfaces (e.g.
projection_image/projection.py:27-30, histogram_image/histogram.py:22-25
— note histogram's deliberately different ``duplicated_filename``).

The port's copy of ``learningorchestra_tpu/services/validators.py``.
"""

from __future__ import annotations

from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.utils.paths import safe_filename  # noqa: F401 — REST-layer re-export

MESSAGE_INVALID_FIELDS = "invalid_fields"
MESSAGE_INVALID_FILENAME = "invalid_filename"
MESSAGE_DUPLICATE_FILE = "duplicate_file"
MESSAGE_MISSING_FIELDS = "missing_fields"
MESSAGE_HISTOGRAM_DUPLICATE = "duplicated_filename"
MESSAGE_INVALID_TRAINING_FILENAME = "invalid_training_filename"
MESSAGE_INVALID_TEST_FILENAME = "invalid_test_filename"
MESSAGE_INVALID_CLASSIFICATOR = "invalid_classificator_name"
MESSAGE_INVALID_LABEL = "invalid_field"
MESSAGE_NOT_FOUND = "file_not_found"

STRING_TYPE = "string"
NUMBER_TYPE = "number"


class ValidationError(Exception):
    """Carries the reference's error string as ``args[0]``."""


def filename_exists(
    store: DocumentStore, filename: str, message: str = MESSAGE_INVALID_FILENAME
) -> None:
    if filename not in store.list_collections():
        raise ValidationError(message)


def filename_free(
    store: DocumentStore, filename: str, message: str = MESSAGE_DUPLICATE_FILE
) -> None:
    if filename in store.list_collections():
        raise ValidationError(message)


def metadata_fields(store: DocumentStore, filename: str) -> list:
    metadata = store.find_one(filename, {"filename": filename})
    if metadata is None or not isinstance(metadata.get("fields"), list):
        return []
    return metadata["fields"]


def fields_in_metadata(store: DocumentStore, filename: str, fields) -> None:
    """Empty → missing_fields; unknown field → invalid_fields (reference
    projection.py:157-167, histogram.py:123-133)."""
    if not fields:
        raise ValidationError(MESSAGE_MISSING_FIELDS)
    known = metadata_fields(store, filename)
    for field in fields:
        if field not in known:
            raise ValidationError(MESSAGE_INVALID_FIELDS)


def field_types_valid(store: DocumentStore, filename: str, fields: dict) -> None:
    """data_type_handler's variant: also validates the requested type
    names (reference data_type_handler.py:117-130)."""
    if not fields:
        raise ValidationError(MESSAGE_MISSING_FIELDS)
    known = metadata_fields(store, filename)
    for field, field_type in fields.items():
        if field not in known:
            raise ValidationError(MESSAGE_INVALID_FIELDS)
        if field_type not in (STRING_TYPE, NUMBER_TYPE):
            raise ValidationError(MESSAGE_INVALID_FIELDS)


def label_in_metadata(store: DocumentStore, filename: str, label) -> None:
    """tsne/pca label validator: None allowed (reference tsne.py:177-186)."""
    if label is None:
        return
    if label not in metadata_fields(store, filename):
        raise ValidationError(MESSAGE_INVALID_LABEL)
