"""Eager columnar DataFrame with the PySpark verb surface.

Columns: float64 numpy arrays (NaN = null), object arrays (None = null),
or 2-D float64 matrices (assembled feature vectors). Immutable —
every verb returns a new frame sharing unchanged column arrays.

The port's copy of ``learningorchestra_tpu/frame/dataframe.py``. Only
:meth:`DataFrame.device_matrix` and :meth:`DataFrame.device_labels`
differ: they copy to one ``torch.device``, not a mesh. Both cache twice,
as the reference's: on the frame, and in the process-wide
content-addressed device cache (``core/devcache.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from learningorchestra_tpu_torch.core.table import ColumnTable
from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.frame.expressions import (
    Expression,
    _is_null_array,
)


class Row(dict):
    """``first()`` result: dict with attribute access, like Spark's Row."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as error:
            raise AttributeError(name) from error


class Schema:
    def __init__(self, names: list[str]):
        self.names = names


class NaFunctions:
    """The ``df.na`` namespace (fill only — the documented surface)."""

    def __init__(self, df: "DataFrame"):
        self._df = df

    def fill(self, value, subset: Optional[list[str]] = None) -> "DataFrame":
        if isinstance(value, dict):
            replacements = value
        else:
            names = subset if subset is not None else self._df.columns
            replacements = {name: value for name in names}
        columns = dict(self._df._columns)
        for name, fill_value in replacements.items():
            if name not in columns:
                continue
            column = columns[name]
            if column.ndim != 1:
                continue
            nulls = _is_null_array(column)
            if not nulls.any():
                continue
            # Spark only fills when the value type matches the column
            # type: string fills touch string columns, numeric fills
            # touch numeric columns; mismatches are skipped silently.
            fill_is_string = isinstance(fill_value, str)
            if fill_is_string != (column.dtype == object):
                continue
            patched = column.copy()
            patched[nulls] = fill_value if fill_is_string else float(fill_value)
            columns[name] = patched
        return DataFrame(columns)


class DataFrame:
    def __init__(self, columns: dict[str, np.ndarray]):
        lengths = {col.shape[0] for col in columns.values()}
        if len(lengths) > 1:
            raise ValueError(
                f"ragged columns: { {k: v.shape for k, v in columns.items()} }"
            )
        self._columns = dict(columns)
        self._num_rows = lengths.pop() if lengths else 0

    # --- constructors -------------------------------------------------------
    @classmethod
    def from_table(cls, table: ColumnTable) -> "DataFrame":
        return cls(dict(table.columns))

    def to_table(self) -> ColumnTable:
        return ColumnTable(
            {name: col for name, col in self._columns.items() if col.ndim == 1}
        )

    # --- introspection ------------------------------------------------------
    @property
    def columns(self) -> list[str]:
        return list(self._columns.keys())

    @property
    def schema(self) -> Schema:
        return Schema(self.columns)

    def count(self) -> int:
        return self._num_rows

    def first(self) -> Optional[Row]:
        if self._num_rows == 0:
            return None
        row = {}
        for name, column in self._columns.items():
            value = column[0]
            if column.ndim > 1:
                value = np.asarray(value)
            elif column.dtype != object:
                value = None if np.isnan(value) else float(value)
            row[name] = value
        return Row(row)

    def _column(self, name: str) -> np.ndarray:
        if name not in self._columns:
            raise KeyError(f"no such column: {name!r}")
        return self._columns[name]

    def __getitem__(self, name: str):
        from learningorchestra_tpu_torch.frame.expressions import col

        self._column(name)  # existence check, Spark raises here too
        return col(name)

    # --- verbs --------------------------------------------------------------
    def _materialize(self, value) -> np.ndarray:
        if isinstance(value, Expression):
            result = value.evaluate(self)
        else:
            result = value
        result = np.asarray(result)
        if result.ndim == 0:
            result = np.full(self._num_rows, result.item())
        if result.dtype == bool:
            result = result.astype(np.float64)
        elif result.dtype != object and result.dtype != np.float64 and result.ndim == 1:
            result = result.astype(np.float64)
        return result

    def withColumn(self, name: str, value) -> "DataFrame":
        columns = dict(self._columns)
        columns[name] = self._materialize(value)
        return DataFrame(columns)

    def withColumnRenamed(self, existing: str, new: str) -> "DataFrame":
        columns = {}
        for name, column in self._columns.items():
            columns[new if name == existing else name] = column
        return DataFrame(columns)

    def drop(self, *names: str) -> "DataFrame":
        return DataFrame(
            {n: c for n, c in self._columns.items() if n not in names}
        )

    def select(self, *names) -> "DataFrame":
        flat: list[str] = []
        for name in names:
            if isinstance(name, (list, tuple)):
                flat.extend(name)
            else:
                flat.append(name)
        return DataFrame({name: self._column(name) for name in flat})

    def filter(self, condition: Expression) -> "DataFrame":
        mask = np.asarray(condition.evaluate(self), dtype=bool)
        return self._take(mask)

    where = filter

    def _take(self, mask_or_index: np.ndarray) -> "DataFrame":
        return DataFrame(
            {name: column[mask_or_index] for name, column in self._columns.items()}
        )

    def dropna(self, subset: Optional[list[str]] = None) -> "DataFrame":
        names = subset if subset is not None else self.columns
        keep = np.ones(self._num_rows, dtype=bool)
        for name in names:
            column = self._columns[name]
            if column.ndim == 1:
                keep &= ~_is_null_array(column)
            else:
                keep &= ~np.isnan(column).any(axis=1)
        return self._take(keep)

    def replace(self, to_replace, value=None, subset=None) -> "DataFrame":
        """``df.replace(list, list)`` — value substitution in string
        columns (the documented example replaces misspelled titles,
        docs/model_builder.md)."""
        if isinstance(to_replace, dict):
            mapping = to_replace
        else:
            if not isinstance(to_replace, (list, tuple)):
                to_replace = [to_replace]
            if not isinstance(value, (list, tuple)):
                value = [value] * len(to_replace)
            mapping = dict(zip(to_replace, value))
        names = subset if subset is not None else self.columns
        columns = dict(self._columns)
        for name in names:
            column = columns[name]
            if column.ndim != 1 or column.dtype != object:
                continue
            columns[name] = np.array(
                [mapping.get(v, v) for v in column], dtype=object
            )
        return DataFrame(columns)

    @property
    def na(self) -> NaFunctions:
        return NaFunctions(self)

    def randomSplit(
        self, weights: Sequence[float], seed: Optional[int] = None
    ) -> list["DataFrame"]:
        """Per-row uniform draw bucketed by cumulative weights (Spark's
        randomSplit semantics — split sizes are stochastic)."""
        weights = np.asarray(weights, dtype=np.float64)
        cumulative = np.cumsum(weights / weights.sum())
        draws = np.random.default_rng(seed).uniform(size=self._num_rows)
        buckets = np.searchsorted(cumulative, draws, side="right")
        return [self._take(buckets == i) for i in range(len(weights))]

    # --- estimator bridge ---------------------------------------------------
    def feature_matrix(self, features_col: str = "features") -> np.ndarray:
        matrix = self._column(features_col)
        if matrix.ndim != 2:
            raise TypeError(
                f"column {features_col!r} is not an assembled vector column"
            )
        return matrix

    def label_vector(self, label_col: str = "label") -> np.ndarray:
        labels = self._column(label_col).astype(np.float64)
        if np.isnan(labels).any():
            raise ValueError(
                f"null labels in column {label_col!r}; drop or impute "
                "them in preprocessor_code before fitting"
            )
        return labels.astype(np.int32)

    def _device_cached(self, key: tuple, make):
        """``make()`` once per key for this frame: the frame is immutable,
        so its device copies are too, and N classifier threads over one
        frame share one host-to-device copy."""
        import threading

        cache = self.__dict__.setdefault("_device_matrices", {})
        lock = self.__dict__.setdefault("_device_lock", threading.Lock())
        with lock:
            cached = cache.get(key)
            if cached is None:
                cached = make()
                cache[key] = cached
        return cached

    def device_matrix(self, features_col: str, device=None):
        """The assembled feature matrix as a tensor on ``device`` (None: the
        CUDA card) in the policy's float type, cached twice: on the frame
        (N classifiers predicting over one test or eval frame share one
        copy; the reference re-reads its dataframes per evaluator instead,
        model_builder.py:205-224) and in the process-wide device cache by
        content (``core/devcache.content_device_matrix``), so the same
        bytes across requests (a frame rebuilt from an unchanged
        collection and preprocessor) reuse one device copy."""
        from learningorchestra_tpu_torch.core.devcache import content_device_matrix

        device = resolve_device(device)
        return self._device_cached(
            (features_col, device),
            lambda: content_device_matrix(self.feature_matrix(features_col), device),
        )

    def device_labels(self, label_col: str, device=None):
        """The label vector as :class:`~learningorchestra_tpu_torch.ml.base.
        DeviceLabels` (an int64 tensor on ``device`` and its class count),
        cached on the frame and by content like :meth:`device_matrix`."""
        from learningorchestra_tpu_torch.core.devcache import content_device_labels

        device = resolve_device(device)
        return self._device_cached(
            ("labels:" + label_col, device),
            lambda: content_device_labels(self.label_vector(label_col), device),
        )
