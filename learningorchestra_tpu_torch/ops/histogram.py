"""Value-count histograms.

Reference behaviour (microservices/histogram_image/histogram.py:49-74):
per requested field, push a ``$group``/``$sum: 1`` aggregation down to
MongoDB and store the resulting ``[{_id: value, count: n}, ...]`` list as
one document of a new histogram collection, plus a metadata document
``{filename_parent, fields, filename, _id: 0}``.

Counting happens IN the store via the same ``$group`` pushdown
(``store.aggregate``): the columnar engine counts block columns without
synthesizing rows, and over the wire only ``(value, count)`` pairs
travel — never the raw column. Counts stay exact: the store column
holds arbitrary Python values (float64, strings, whatever
``update_one`` wrote), and pushing floats through a float32 device
would silently perturb the histogram keys. Device-side histogramming of
already-binned device data lives where it is actually hot: the
tree-split histograms in ``ml/trees.py``.

The port's copy of ``learningorchestra_tpu/ops/histogram.py``.
"""

from __future__ import annotations

import numpy as np

from learningorchestra_tpu_torch.core.store import METADATA_ID, ROW_ID, DocumentStore


def normalize_group_counts(groups: list[dict]) -> list[tuple[object, int]]:
    """Normalize ``$group`` results (``[{_id, count}]``) into the stored
    histogram order: numbers ascending (integral floats collapsed to int
    so counts round-trip the dtype converter, ops/dtype.py), then other
    values by string, then the merged ``None``/NaN null group (like
    Mongo's null group)."""
    nulls = 0
    numbers: dict[object, int] = {}
    others: dict = {}
    for group in groups:
        value, count = group["_id"], group["count"]
        if value is None or (isinstance(value, float) and np.isnan(value)):
            nulls += count
        elif isinstance(
            value, (int, float, np.integer, np.floating)
        ) and not isinstance(value, bool):
            value = float(value)
            key = int(value) if value.is_integer() else value
            numbers[key] = numbers.get(key, 0) + count
        else:
            others[value] = others.get(value, 0) + count

    pairs: list[tuple[object, int]] = []
    pairs.extend((key, numbers[key]) for key in sorted(numbers))
    pairs.extend((key, others[key]) for key in sorted(others, key=str))
    if nulls:
        pairs.append((None, nulls))
    return pairs


def value_counts(raw_values: list) -> list[tuple[object, int]]:
    """``(value, count)`` pairs for one raw column, same contract as
    :func:`normalize_group_counts` over an ad-hoc value list.

    Keys carry a bool tag because ``True`` hashes equal to ``1``: a
    plain dict would merge them, silently dropping the boolean group."""
    counts: dict = {}
    for value in raw_values:
        key = (isinstance(value, bool), value)
        counts[key] = counts.get(key, 0) + 1
    return normalize_group_counts(
        [{"_id": key[1], "count": count} for key, count in counts.items()]
    )


def create_histogram(
    store: DocumentStore,
    parent_filename: str,
    histogram_filename: str,
    fields: list[str],
) -> None:
    """Build the histogram collection with the reference's document shape
    (histogram.py:50-74): metadata at ``_id: 0`` then one document per
    field containing its ``[{_id: value, count: n}, ...]`` list."""
    store.insert_one(
        histogram_filename,
        {
            "filename_parent": parent_filename,
            "fields": fields,
            "filename": histogram_filename,
            ROW_ID: METADATA_ID,
        },
    )
    for document_id, field in enumerate(fields, start=1):
        # $group pushdown, exactly the reference's Mongo aggregation
        # (histogram.py:63-69): the store counts — its columnar fast
        # path skips row synthesis entirely — and only (value, count)
        # pairs ride the wire, never the raw column.
        groups = store.aggregate(
            parent_filename,
            [{"$group": {"_id": f"${field}", "count": {"$sum": 1}}}],
        )
        store.insert_one(
            histogram_filename,
            {
                field: [
                    {"_id": value, "count": count}
                    for value, count in normalize_group_counts(groups)
                ],
                ROW_ID: document_id,
            },
        )
