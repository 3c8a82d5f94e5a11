"""Column projection: parent dataset → new dataset with a field subset.

Reference behaviour (microservices/projection_image/projection.py:71-125):
a Spark job reads the parent collection, filters out the metadata row,
``select``s the requested fields (plus ``_id``), appends the rows into the
output collection, and writes a metadata document whose ``finished`` flag
flips when the job completes.

Here projection is a single bulk columnar move: one
``read_column_arrays`` scan (fields + ``_id`` together, so values and
row ids can never mis-pair) and one column-major write under the
``finished`` contract — typed buffers in, typed buffers out, no per-row
dicts and no per-cell conversion anywhere. Row ``_id``s are preserved,
matching the reference's appending of ``_id`` to the projection fields
(projection_image/server.py:104-106). Values are copied raw — projection
never coerces types; that is the fieldtypes service's job.

The port's copy of ``learningorchestra_tpu/ops/projection.py``.
"""

from __future__ import annotations

import numpy as np

from learningorchestra_tpu_torch.core.ingest import timestamp
from learningorchestra_tpu_torch.core.store import ROW_ID, DocumentStore
from learningorchestra_tpu_torch.core.table import write_columns


def project(
    store: DocumentStore,
    parent_filename: str,
    projection_filename: str,
    fields: list[str],
) -> int:
    """Project ``fields`` of ``parent_filename`` into ``projection_filename``.

    Returns the row count.
    """
    field_names = [field for field in fields if field != ROW_ID]
    metadata = store.metadata(parent_filename)
    known = metadata.get("fields") if metadata else None
    if isinstance(known, list):
        missing = [field for field in field_names if field not in known]
        if missing:
            raise KeyError(
                f"fields {missing} not in dataset {parent_filename!r}"
            )
    columns = store.read_column_arrays(
        parent_filename, fields=field_names + [ROW_ID]
    )
    ids_column = columns.pop(ROW_ID)
    num_rows = len(ids_column)
    if ids_column.kind == "i8":
        ids = ids_column.data[:num_rows]
    else:
        ids = np.asarray(ids_column.tolist())

    write_columns(
        store,
        projection_filename,
        columns,
        {
            "filename": projection_filename,
            "finished": True,
            "time_created": timestamp(),
            "parent_filename": parent_filename,
            "fields": field_names,
        },
        ids=ids,
    )
    return num_rows
