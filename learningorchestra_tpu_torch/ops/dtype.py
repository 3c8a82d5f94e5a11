"""Field type conversion: string ↔ number, whole columns at a time.

Reference behaviour (microservices/data_type_handler_image/
data_type_handler.py:47-82): for each requested field, iterate every
document and issue one ``update_one`` RPC per row — 2 RPCs per row per
field. Conversion rules preserved here:

- → string: ``None`` becomes ``""``, everything else ``str(value)``
  (integral floats collapse: ``28.0`` → ``"28"``).
- → number: ``""`` becomes ``None`` (missing), everything else
  ``float(value)``, collapsed to ``int`` when integral (so ``"28"``
  round-trips as ``28`` not ``28.0``).

This implementation is columnar AND typed: one bulk
``read_column_arrays``, a vectorized numpy convert (numpy's C string
parser with a Python-``float()`` fallback for its grammar gaps), one
bulk ``set_column`` write per field — the converted column lands in the
store as a typed block, never a boxed list.

The port's copy of ``learningorchestra_tpu/ops/dtype.py``, unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from learningorchestra_tpu_torch.core.columns import Column
from learningorchestra_tpu_torch.core.store import ROW_ID, DocumentStore

STRING_TYPE = "string"
NUMBER_TYPE = "number"

# str→number casts convert this many rows per boxed-list transient.
_CAST_BLOCK_ROWS = 2_000_000


def _to_string(value):
    if value is None:
        return ""
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return str(value)


def _to_number(value):
    if value is None or value == "":
        return None
    number = float(value)
    return int(number) if number.is_integer() else number


def _num_column(data: np.ndarray, none: np.ndarray) -> Column:
    """float64 values + null mask → a ``num`` column with the
    int-collapse mask set for integral values (the ``"28"`` → ``28``
    contract)."""
    column = Column("num")
    column.size = len(data)
    column.data = data
    finite = np.isfinite(data)
    column.intm = finite & (data == np.floor(np.where(finite, data, 0.0)))
    column.intm[none] = False
    if none.any():
        column.none = none
        column.data = column.data.copy()
        column.data[none] = np.nan
    # NaN parsed from a literal "nan" cell also reads back as null —
    # including when a None/"" mask already exists (data[none] is NaN
    # by the assignment above, so the isnan mask is a superset)
    nan = np.isnan(column.data)
    if nan.any():
        column.none = nan
    return column


def _strings_to_number(
    values: list, empty_mask: Optional[np.ndarray] = None
) -> Column:
    """Vectorized ``float()`` over raw string cells: numpy's
    list-of-str → float64 construction parses with Python ``float``
    semantics (``"1_0"`` included) in one C loop. ``empty_mask`` (from
    the Arrow offsets: zero-length cells) skips the per-value None/""
    scan when the caller already knows it."""
    n = len(values)
    if empty_mask is not None:  # caller-complete None/"" mask: no scan
        none = empty_mask.copy()
    else:
        none = np.zeros(n, dtype=bool)
        for i, v in enumerate(values):
            if v is None or v == "":
                none[i] = True
    filled = (
        ["nan" if none[i] else v for i, v in enumerate(values)]
        if none.any()
        else values
    )
    try:
        data = np.asarray(filled, dtype=np.float64)
    except (ValueError, TypeError):
        # exact per-value fallback, same error surface as float(value)
        data = np.empty(n, dtype=np.float64)
        for i, v in enumerate(filled):
            data[i] = np.nan if none[i] else float(v)
    return _num_column(data, none)


def _numeric_to_string(column: Column) -> Column:
    """Typed numeric column → string column, vectorized: integral
    values render via int64 (no trailing ``.0``), the rest via numpy's
    float repr (identical to ``str(float)``)."""
    data = column.to_float64()
    absent = np.isnan(data)
    safe = np.where(absent, 0.0, data)
    integral = np.isfinite(safe) & (safe == np.floor(safe))
    # int64 only renders magnitudes below 2^63; bigger integral floats
    # go through Python's arbitrary-precision int below
    small = np.abs(safe) < 2**63
    out = np.where(
        integral & small,
        np.where(small, safe, 0.0).astype(np.int64).astype("U21"),
        safe.astype("U32"),
    )
    values = out.tolist()
    for i in np.flatnonzero(integral & ~small):
        values[i] = str(int(data[i]))
    if absent.any():
        for i in np.flatnonzero(absent):
            values[i] = ""
    return Column.from_strings(values)


def _convert_column(column: Column, field_type: str) -> Optional[Column]:
    """Typed fast path; ``None`` means "use the per-value loop"."""
    if field_type == NUMBER_TYPE:
        if column.kind in ("f8", "i8", "num"):
            return _num_column(
                column.data[: len(column)].astype(np.float64, copy=True),
                (
                    column._absent_mask().copy()
                    if column._absent_mask() is not None
                    else np.zeros(len(column), dtype=bool)
                ),
            )
        if column.kind == "str":
            # complete None/"" mask from the Arrow offsets (zero-length
            # cells) + the null/missing masks — skips the Python scan.
            # Converted in blocks: a 100M-row cast must never hold the
            # whole column as a boxed Python list (the out-of-core
            # story caps the anonymous working set at block size).
            source = column._materialized()
            n = len(source)
            absent = source._absent_mask()
            out: Optional[Column] = None
            for start in range(0, max(n, 1), _CAST_BLOCK_ROWS):
                stop = min(start + _CAST_BLOCK_ROWS, n)
                empty = np.diff(source.offsets[start : stop + 1]) == 0
                if absent is not None:
                    empty = empty | absent[start:stop]
                part = _strings_to_number(
                    source.tolist(start, stop), empty_mask=empty
                )
                out = part if out is None else out.append_column(part)
                if stop >= n:
                    break
            return out
        return None  # obj/bool/empty: exact per-value loop
    if field_type == STRING_TYPE:
        if column.kind in ("f8", "i8", "num"):
            return _numeric_to_string(column)
        if column.kind == "str":
            absent = column._absent_mask()
            if absent is None or not absent.any():
                return column  # already strings, no nulls: unchanged
            values = column.tolist()
            for i in np.flatnonzero(absent):
                values[i] = ""
            return Column.from_strings(values)
        return None
    return None


def convert_field_types(
    store: DocumentStore, filename: str, field_types: dict[str, str]
) -> None:
    """Convert each ``field`` of ``filename`` to ``field_types[field]``.

    Raises ``ValueError`` on an unparseable numeric string (the reference
    lets the same error surface as an HTTP 500).
    """
    converters = {STRING_TYPE: _to_string, NUMBER_TYPE: _to_number}
    for field, field_type in field_types.items():
        if field_type not in converters:
            raise ValueError(f"invalid field type {field_type!r}")

    columns = store.read_column_arrays(
        filename, fields=[ROW_ID] + list(field_types)
    )
    ids_column = columns[ROW_ID]
    num_rows = len(ids_column)
    if ids_column.kind == "i8":
        arr = ids_column.data[:num_rows]
        contiguous = num_rows == 0 or bool(
            np.array_equal(arr, np.arange(arr[0], arr[0] + num_rows))
        )
        ids = arr.tolist() if not contiguous else ([int(arr[0])] if num_rows else [])
        del arr  # a live view would pin the full id buffer below
    else:
        ids = ids_column.tolist()
        contiguous = num_rows == 0 or all(
            ids[i] == ids[0] + i for i in range(num_rows)
        )
    del ids_column, columns[ROW_ID]  # 100M ids: don't hold for the pass
    for field, field_type in field_types.items():
        source = columns.pop(field)  # release each snapshot as it casts
        converted = _convert_column(source, field_type)
        if converted is None:
            convert = converters[field_type]
            converted = Column.from_values(
                [convert(value) for value in source.tolist()]
            )
        del source
        if contiguous:
            # one bulk column write (block-replace fast path in the store)
            store.set_column(
                filename, field, converted, start_id=ids[0] if num_rows else 1
            )
        else:
            store.set_field_values(
                filename, field, dict(zip(ids, converted.tolist()))
            )
