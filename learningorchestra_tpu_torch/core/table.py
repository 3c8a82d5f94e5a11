"""Columnar tables: the bridge between the document store and the TPU.

The reference moves data between Mongo and compute row-at-a-time (one RPC
per document: reference microservices/model_builder_image/
model_builder.py:237-247, data_type_handler_image/data_type_handler.py:
47-77). Here a dataset is materialised once into a :class:`ColumnTable`
— a dict of equal-length columns — and all ops/estimators consume columns
(numpy host-side, ``jax.Array`` on device). Strings are dictionary-encoded
(:meth:`ColumnTable.encoded`) before any device transfer, because TPUs
compute on numbers.

The port's copy of ``learningorchestra_tpu/core/table.py``: the same
code with its imports rewritten. ``ColumnTable.from_csv`` parses with the
port's native C++ loader when it is built (``native/loader.py``), with
its Python fallback otherwise.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from learningorchestra_tpu_torch.core.columns import Column
from learningorchestra_tpu_torch.core.store import METADATA_ID, ROW_ID, DocumentStore

NUMBER = "number"
STRING = "string"


def _is_number(value) -> bool:
    return isinstance(value, (int, float, np.integer, np.floating)) and not isinstance(
        value, bool
    )


def column_type(values: Iterable) -> str:
    """A column is numeric iff every non-null value is a number."""
    saw_number = False
    for value in values:
        if value is None:
            continue
        if _is_number(value):
            if isinstance(value, float) and np.isnan(value):
                continue
            saw_number = True
            continue
        return STRING
    return NUMBER if saw_number else STRING


def as_column(values: Sequence) -> np.ndarray:
    """Materialise raw values as float64 (None→NaN) or object array."""
    if column_type(values) == NUMBER:
        return np.array(
            [np.nan if value is None else float(value) for value in values],
            dtype=np.float64,
        )
    return np.array(values, dtype=object)


class ColumnTable:
    """An ordered dict of equal-length columns.

    Numeric columns are ``float64`` numpy arrays with NaN for missing;
    string columns are object arrays with ``None`` for missing.
    """

    def __init__(self, columns: dict[str, np.ndarray]):
        lengths = {len(col) for col in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in columns.items()} }")
        self.columns = dict(columns)
        self.num_rows = lengths.pop() if lengths else 0

    # --- constructors ---------------------------------------------------------
    @classmethod
    def from_lists(cls, raw: dict[str, Sequence]) -> "ColumnTable":
        return cls({name: as_column(values) for name, values in raw.items()})

    @classmethod
    def from_csv(cls, path: str) -> "ColumnTable":
        """Direct CSV → columnar table (bypassing the document store):
        the host-side loader feeding device transfer (SURVEY.md §2's
        connector replacement). Uses the native C++ parser when built
        (native/loader.py), Python otherwise."""
        from learningorchestra_tpu_torch.native.loader import read_csv_columns

        return cls(read_csv_columns(path))

    @classmethod
    def from_store(
        cls,
        store: DocumentStore,
        collection: str,
        fields: Optional[list[str]] = None,
    ) -> "ColumnTable":
        """Bulk columnar read of a dataset (excludes the metadata row).

        Rides the typed-column plane (``read_column_arrays``): numeric
        kinds hand their float64 buffers over directly — zero per-cell
        conversion between storage and the design matrix."""
        arrays = store.read_column_arrays(collection, fields)
        columns: dict[str, np.ndarray] = {}
        for name, column in arrays.items():
            if column.kind in ("f8", "i8", "num"):
                columns[name] = column.to_float64()
            else:
                # str/obj/bool/empty keep object semantics (bools and
                # all-null columns are STRING-typed here, matching
                # column_type's contract)
                columns[name] = column.to_object()
        return cls(columns)

    # --- basic relational verbs -----------------------------------------------
    @property
    def field_names(self) -> list[str]:
        return list(self.columns.keys())

    def dtype_of(self, field: str) -> str:
        column = self.columns[field]
        return NUMBER if column.dtype == np.float64 else STRING

    def string_fields(self) -> list[str]:
        return [f for f in self.field_names if self.dtype_of(f) == STRING]

    def number_fields(self) -> list[str]:
        return [f for f in self.field_names if self.dtype_of(f) == NUMBER]

    def select(self, fields: list[str]) -> "ColumnTable":
        return ColumnTable({field: self.columns[field] for field in fields})

    def take(self, mask_or_index: np.ndarray) -> "ColumnTable":
        return ColumnTable(
            {name: col[mask_or_index] for name, col in self.columns.items()}
        )

    def dropna(self) -> "ColumnTable":
        keep = np.ones(self.num_rows, dtype=bool)
        for column in self.columns.values():
            if column.dtype == np.float64:
                keep &= ~np.isnan(column)
            else:
                keep &= np.array([v is not None for v in column], dtype=bool)
        return self.take(keep)

    # --- device-bound transforms ----------------------------------------------
    def encoded(self) -> tuple["ColumnTable", dict[str, list]]:
        """Dictionary-encode string columns to ordinal float codes.

        Equivalent of the per-column sklearn ``LabelEncoder`` loop the
        reference runs before PCA/t-SNE (reference:
        microservices/pca_image/pca.py:79-85): codes are assigned in
        sorted-value order. Returns the numeric table and the per-field
        vocabularies.
        """
        out: dict[str, np.ndarray] = {}
        vocabularies: dict[str, list] = {}
        for name, column in self.columns.items():
            if column.dtype == np.float64:
                out[name] = column
                continue
            present = [v for v in column if v is not None]
            vocabulary = sorted(set(present), key=str)
            index = {value: code for code, value in enumerate(vocabulary)}
            out[name] = np.array(
                [np.nan if v is None else float(index[v]) for v in column],
                dtype=np.float64,
            )
            vocabularies[name] = vocabulary
        return ColumnTable(out), vocabularies

    def matrix(self, fields: Optional[list[str]] = None) -> np.ndarray:
        """Stack numeric columns into an ``(num_rows, n_fields)`` float64
        design matrix (row-major for device transfer)."""
        fields = fields or self.field_names
        bad = [f for f in fields if self.dtype_of(f) != NUMBER]
        if bad:
            raise TypeError(f"non-numeric fields in matrix(): {bad}")
        if not fields:
            return np.zeros((self.num_rows, 0), dtype=np.float64)
        return np.stack([self.columns[f] for f in fields], axis=1)

    # --- store round-trip -----------------------------------------------------
    def store_columns(self) -> dict[str, Column]:
        """Columns as typed :class:`Column` carriers (float64 NaN →
        null mask) — the zero-conversion shape ``insert_column_arrays``
        takes."""
        out: dict[str, Column] = {}
        for name, column in self.columns.items():
            if column.dtype == np.float64:
                out[name] = Column.from_numpy(column)
            else:
                out[name] = Column.from_values(column.tolist())
        return out

    def value_columns(self) -> dict[str, list]:
        """Columns as plain Python lists with the store's missing-value
        convention (numeric NaN → ``None``) — the shape
        ``DocumentStore.insert_columns`` takes."""
        out: dict[str, list] = {}
        for name, column in self.columns.items():
            if column.dtype == np.float64:
                out[name] = [
                    None if np.isnan(value) else float(value) for value in column
                ]
            else:
                out[name] = column.tolist()
        return out

    def documents(self, start_id: int = 1) -> list[dict]:
        """Row-major view as store documents with ``_id`` ``start_id..``."""
        names = self.field_names
        columns = [self.columns[name] for name in names]
        out = []
        for i in range(self.num_rows):
            document = {}
            for name, column in zip(names, columns):
                value = column[i]
                if column.dtype == np.float64:
                    value = None if np.isnan(value) else float(value)
                document[name] = value
            document[ROW_ID] = start_id + i
            out.append(document)
        return out


BATCH_SIZE = 4096
# Typed columns batch far wider: the per-batch cost is one buffer slice
# + one WAL record, not per-value JSON.
ARRAY_BATCH_SIZE = 1 << 20


def _write_initial_metadata(store: DocumentStore, collection: str, meta: dict) -> None:
    initial = dict(meta)
    initial["finished"] = False
    store.insert_one(collection, initial)


def num_column_rows(columns: dict) -> int:
    return len(next(iter(columns.values()))) if columns else 0


def insert_columns_batched(
    store: DocumentStore,
    collection: str,
    columns: dict,
    start_id: int = 1,
    batch_size: Optional[int] = None,
) -> int:
    """Append ``columns`` as rows ``start_id..`` in ``batch_size`` slices
    (bounds per-call WAL record / wire message sizes). Returns the row
    count. The one batching loop every columnar writer shares — values
    may be plain lists or typed :class:`Column` carriers (which slice
    by buffer and batch ~256× wider)."""
    num_rows = num_column_rows(columns)
    typed = any(isinstance(values, Column) for values in columns.values())
    if batch_size is None:
        batch_size = ARRAY_BATCH_SIZE if typed else BATCH_SIZE

    def part(values, start: int, stop: int):
        if isinstance(values, Column):
            return values.slice(start, stop)
        return values[start:stop]

    for start in range(0, num_rows, batch_size):
        stop = min(start + batch_size, num_rows)
        store.insert_columns(
            collection,
            {name: part(values, start, stop) for name, values in columns.items()},
            start_id=start_id + start,
        )
    return num_rows


def write_documents(
    store: DocumentStore,
    collection: str,
    documents: list[dict],
    metadata: dict,
    batch_size: int = BATCH_SIZE,
) -> None:
    """Write row documents plus an ``_id: 0`` metadata document.

    The ``finished``-flag wire contract: the metadata document is
    inserted with ``finished: false`` first, rows land in ``insert_many``
    batches, and the caller's final metadata (including ``finished:
    true`` if requested) is applied only after the last row — so a
    concurrent poller never observes a "finished" dataset with partial
    rows.
    """
    meta = dict(metadata)
    meta[ROW_ID] = METADATA_ID
    _write_initial_metadata(store, collection, meta)
    for start in range(0, len(documents), batch_size):
        store.insert_many(collection, documents[start : start + batch_size])
    store.update_one(collection, {ROW_ID: METADATA_ID}, meta)


def write_columns(
    store: DocumentStore,
    collection: str,
    columns: dict,
    metadata: dict,
    ids: Optional[Sequence] = None,
    batch_size: Optional[int] = None,
) -> None:
    """Write a dataset column-major under the same ``finished`` contract
    as :func:`write_documents` — the fast path: the store keeps the body
    as a columnar block, no per-row dicts anywhere. ``columns`` values
    may be lists or typed :class:`Column` carriers.

    ``ids`` (when given) must be the contiguous ``1..N`` range a block
    requires; non-contiguous ids take the row-document fallback.
    """
    num_rows = num_column_rows(columns)
    meta = dict(metadata)
    meta[ROW_ID] = METADATA_ID

    contiguous_start = 1
    if ids is not None:
        first = int(ids[0]) if num_rows else 1
        contiguous = True
        if isinstance(ids, np.ndarray) and np.issubdtype(ids.dtype, np.number):
            contiguous = bool(
                np.array_equal(ids, np.arange(first, first + num_rows))
            )
        else:
            contiguous = all(
                int(ids[i]) == first + i for i in range(num_rows)
            )
        if not contiguous:
            value_lists = {
                name: (
                    values.tolist() if isinstance(values, Column) else values
                )
                for name, values in columns.items()
            }
            documents = []
            for i in range(num_rows):
                document = {
                    name: values[i] for name, values in value_lists.items()
                }
                doc_id = ids[i]
                document[ROW_ID] = (
                    doc_id.item() if isinstance(doc_id, np.generic) else doc_id
                )
                documents.append(document)
            write_documents(
                store, collection, documents, metadata, batch_size or BATCH_SIZE
            )
            return
        contiguous_start = first

    _write_initial_metadata(store, collection, meta)
    insert_columns_batched(store, collection, columns, contiguous_start, batch_size)
    store.update_one(collection, {ROW_ID: METADATA_ID}, meta)


def write_table(
    store: DocumentStore,
    collection: str,
    table: ColumnTable,
    metadata: dict,
    batch_size: Optional[int] = None,
) -> None:
    """Write a :class:`ColumnTable` to the store under the ``finished``
    contract, column-major over the typed plane (see
    :func:`write_columns`)."""
    write_columns(
        store, collection, table.store_columns(), metadata, batch_size=batch_size
    )
