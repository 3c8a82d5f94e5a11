"""Feature stages: StringIndexer, VectorAssembler, Pipeline.

The `pyspark.ml.feature` subset the documented preprocessor example uses
(reference docs/model_builder.md): per-column label indexing and dense
feature assembly feeding the classifiers.

The port's copy of ``learningorchestra_tpu/frame/feature.py``,
unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from learningorchestra_tpu_torch.frame.dataframe import DataFrame
from learningorchestra_tpu_torch.frame.expressions import _is_null_array

ERROR = "error"
SKIP = "skip"
KEEP = "keep"


class StringIndexerModel:
    def __init__(self, input_col: str, output_col: str, labels: list, handle_invalid: str):
        self.inputCol = input_col
        self.outputCol = output_col
        self.labels = labels
        self._index = {label: float(code) for code, label in enumerate(labels)}
        self.handle_invalid = handle_invalid

    def transform(self, df: DataFrame) -> DataFrame:
        column = df._column(self.inputCol)
        codes = np.empty(len(column), dtype=np.float64)
        keep = np.ones(len(column), dtype=bool)
        for i, value in enumerate(column):
            code = self._index.get(value)
            if code is None:
                if self.handle_invalid == ERROR:
                    raise ValueError(
                        f"StringIndexer: unseen or null label {value!r} in "
                        f"column {self.inputCol!r}"
                    )
                if self.handle_invalid == SKIP:
                    keep[i] = False
                    code = np.nan
                else:  # keep: unseen bucket = num labels
                    code = float(len(self.labels))
            codes[i] = code
        out = df.withColumn(self.outputCol, codes)
        if self.handle_invalid == SKIP:
            return out._take(keep)
        return out


class StringIndexer:
    """Orders labels by descending frequency, ties broken
    lexicographically — Spark's default ``frequencyDesc`` order, so
    indexed features match the reference's encoding."""

    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        handleInvalid: str = ERROR,
    ):
        self.inputCol = inputCol
        self.outputCol = outputCol or (f"{inputCol}_index" if inputCol else None)
        self.handleInvalid = handleInvalid

    def setHandleInvalid(self, value: str) -> "StringIndexer":
        self.handleInvalid = value
        return self

    def fit(self, df: DataFrame) -> StringIndexerModel:
        column = df._column(self.inputCol)
        nulls = _is_null_array(column)
        counts: dict = {}
        for value, is_null in zip(column, nulls):
            if is_null:
                continue
            counts[value] = counts.get(value, 0) + 1
        labels = sorted(counts, key=lambda v: (-counts[v], str(v)))
        return StringIndexerModel(
            self.inputCol, self.outputCol, labels, self.handleInvalid
        )


class VectorAssembler:
    """Stacks numeric columns into one 2-D ``outputCol`` matrix — the
    bridge from the host dataframe to the device design matrix."""

    def __init__(
        self,
        inputCols: Optional[list[str]] = None,
        outputCol: str = "features",
        handleInvalid: str = ERROR,
    ):
        self.inputCols = list(inputCols or [])
        self.outputCol = outputCol
        self.handleInvalid = handleInvalid

    def setHandleInvalid(self, value: str) -> "VectorAssembler":
        if value not in (ERROR, SKIP, KEEP):
            raise ValueError(f"invalid handleInvalid {value!r}")
        self.handleInvalid = value
        return self

    def transform(self, df: DataFrame) -> DataFrame:
        stacked = []
        for name in self.inputCols:
            column = df._column(name)
            if column.ndim == 2:
                stacked.append(column)
                continue
            if column.dtype == object:
                nulls = _is_null_array(column)
                numeric = np.array(
                    [np.nan if null else float(v) for v, null in zip(column, nulls)],
                    dtype=np.float64,
                )
            else:
                numeric = column.astype(np.float64)
            stacked.append(numeric[:, None])
        matrix = (
            np.concatenate(stacked, axis=1)
            if stacked
            else np.zeros((df.count(), 0))
        )
        invalid = np.isnan(matrix).any(axis=1)
        if invalid.any():
            if self.handleInvalid == ERROR:
                raise ValueError(
                    "VectorAssembler: null/NaN in input columns "
                    "(handleInvalid='error')"
                )
            if self.handleInvalid == SKIP:
                keep = ~invalid
                return df._take(keep).withColumn(self.outputCol, matrix[keep])
        return df.withColumn(self.outputCol, matrix)


class Pipeline:
    """Minimal stage chainer (fit/transform protocol)."""

    def __init__(self, stages: Optional[list] = None):
        self.stages = list(stages or [])

    def fit(self, df: DataFrame) -> "PipelineModel":
        fitted = []
        current = df
        for stage in self.stages:
            if hasattr(stage, "fit"):
                model = stage.fit(current)
                current = model.transform(current)
                fitted.append(model)
            else:
                current = stage.transform(current)
                fitted.append(stage)
        return PipelineModel(fitted)


class PipelineModel:
    def __init__(self, stages: list):
        self.stages = stages

    def transform(self, df: DataFrame) -> DataFrame:
        for stage in self.stages:
            df = stage.transform(df)
        return df
