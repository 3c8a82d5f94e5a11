"""Column expression trees (`pyspark.sql.functions` compatibility).

Expressions are unresolved (name-based, like Spark's ``col``): they bind
to a concrete :class:`~learningorchestra_tpu_torch.frame.dataframe.DataFrame`
only at ``evaluate`` time. Null semantics follow the column conventions:
NaN in float columns, ``None`` in object columns; comparisons involving
null are False (Spark's null predicate folding under ``when``).

The port's copy of ``learningorchestra_tpu/frame/expressions.py``,
unchanged.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional

import numpy as np


def _is_null_array(values: np.ndarray) -> np.ndarray:
    if values.dtype == object:
        return np.array([v is None for v in values], dtype=bool)
    return np.isnan(values)


def _as_array(value, n: int) -> np.ndarray:
    """Broadcast a scalar evaluation result to column length."""
    if isinstance(value, np.ndarray) and value.ndim >= 1:
        return value
    if isinstance(value, str) or value is None:
        return np.array([value] * n, dtype=object)
    return np.full(n, float(value), dtype=np.float64)


class Expression:
    def evaluate(self, df) -> np.ndarray:
        raise NotImplementedError

    # --- operators ----------------------------------------------------------
    def _binary(self, other, fn: Callable, comparison: bool = False):
        return BinaryOp(self, other, fn, comparison)

    def __add__(self, other):
        return self._binary(other, np.add)

    def __radd__(self, other):
        return BinaryOp(lit(other), self, np.add)

    def __sub__(self, other):
        return self._binary(other, np.subtract)

    def __rsub__(self, other):
        return BinaryOp(lit(other), self, np.subtract)

    def __mul__(self, other):
        return self._binary(other, np.multiply)

    def __rmul__(self, other):
        return BinaryOp(lit(other), self, np.multiply)

    def __truediv__(self, other):
        return self._binary(other, np.divide)

    def __rtruediv__(self, other):
        return BinaryOp(lit(other), self, np.divide)

    def __neg__(self):
        return BinaryOp(lit(0.0), self, np.subtract)

    def __eq__(self, other):  # type: ignore[override]
        return self._binary(other, None, comparison=True)

    def __ne__(self, other):  # type: ignore[override]
        return self._binary(other, "ne", comparison=True)

    def __gt__(self, other):
        return self._binary(other, np.greater, comparison=True)

    def __ge__(self, other):
        return self._binary(other, np.greater_equal, comparison=True)

    def __lt__(self, other):
        return self._binary(other, np.less, comparison=True)

    def __le__(self, other):
        return self._binary(other, np.less_equal, comparison=True)

    def __and__(self, other):
        return BinaryOp(self, other, np.logical_and, comparison=True)

    def __or__(self, other):
        return BinaryOp(self, other, np.logical_or, comparison=True)

    def __invert__(self):
        return UnaryOp(self, np.logical_not)

    def __hash__(self):
        return id(self)

    # --- pyspark Column methods --------------------------------------------
    def isNull(self):
        return UnaryOp(self, _is_null_array)

    def isNotNull(self):
        return UnaryOp(self, lambda v: ~_is_null_array(v))

    def getItem(self, index: int):
        return GetItem(self, index)

    def alias(self, name: str):
        return Alias(self, name)

    def otherwise(self, value):
        raise TypeError("otherwise() is only valid on when(...) expressions")


class Column(Expression):
    def __init__(self, name: str):
        self.name = name

    def evaluate(self, df) -> np.ndarray:
        return df._column(self.name)


class Literal(Expression):
    def __init__(self, value):
        self.value = value

    def evaluate(self, df) -> np.ndarray:
        return _as_array(self.value, df.count())


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        self.child = child
        self.name = name

    def evaluate(self, df) -> np.ndarray:
        return self.child.evaluate(df)


class BinaryOp(Expression):
    def __init__(self, left, right, fn: Optional[Callable], comparison: bool = False):
        self.left = left if isinstance(left, Expression) else Literal(left)
        self.right = right if isinstance(right, Expression) else Literal(right)
        self.fn = fn
        self.comparison = comparison

    def evaluate(self, df) -> np.ndarray:
        left = _as_array(self.left.evaluate(df), df.count())
        right = _as_array(self.right.evaluate(df), df.count())
        if self.fn in (None, "ne"):  # (in)equality, null-is-false
            if left.dtype == object or right.dtype == object:
                equal = np.array(
                    [
                        a is not None and b is not None and a == b
                        for a, b in zip(left, right)
                    ],
                    dtype=bool,
                )
                non_null = ~_is_null_array(left) & ~_is_null_array(right)
            else:
                with np.errstate(invalid="ignore"):
                    equal = np.equal(left, right)
                non_null = ~np.isnan(left) & ~np.isnan(right)
            if self.fn == "ne":
                # Spark: null != x is null → row predicate False, same
                # null-is-false folding as equality.
                return ~equal & non_null
            return equal & non_null
        if self.comparison and self.fn in (
            np.greater,
            np.greater_equal,
            np.less,
            np.less_equal,
        ):
            left_f = left.astype(np.float64)
            right_f = right.astype(np.float64)
            with np.errstate(invalid="ignore"):
                result = self.fn(left_f, right_f)
            return result & ~np.isnan(left_f) & ~np.isnan(right_f)
        return self.fn(left, right)


class UnaryOp(Expression):
    def __init__(self, child: Expression, fn: Callable):
        self.child = child
        self.fn = fn

    def evaluate(self, df) -> np.ndarray:
        return self.fn(_as_array(self.child.evaluate(df), df.count()))


class When(Expression):
    """``when(cond, value)`` chain with ``.when`` / ``.otherwise``.

    Without ``otherwise``, unmatched rows are null (Spark semantics).
    """

    def __init__(self, branches: list[tuple[Expression, Any]], default=None):
        self.branches = branches
        self.default = default

    def when(self, condition, value) -> "When":
        return When(self.branches + [(condition, value)], self.default)

    def otherwise(self, value) -> "When":
        return When(self.branches, value)

    def evaluate(self, df) -> np.ndarray:
        n = df.count()
        evaluated = []
        for condition, value in self.branches:
            value_expr = value if isinstance(value, Expression) else Literal(value)
            evaluated.append(
                (
                    np.asarray(condition.evaluate(df), dtype=bool),
                    _as_array(value_expr.evaluate(df), n),
                )
            )
        any_object = any(values.dtype == object for _, values in evaluated)
        if self.default is None and not any_object:
            # Unmatched numeric rows are null → float64 NaN, keeping the
            # frame's null convention (not an object column of None).
            result = np.full(n, np.nan, dtype=np.float64)
        else:
            default = (
                self.default
                if isinstance(self.default, Expression)
                else Literal(self.default)
            )
            result = _as_array(default.evaluate(df), n).copy()
            any_object = any_object or result.dtype == object
        decided = np.zeros(n, dtype=bool)
        for match, values in evaluated:
            match = match & ~decided
            if any_object and result.dtype != object:
                result = result.astype(object)
            if any_object and values.dtype != object:
                values = values.astype(object)
            result[match] = values[match]
            decided |= match
        return result


class RegexpExtract(Expression):
    def __init__(self, child: Expression, pattern: str, group: int):
        self.child = child
        self.pattern = re.compile(pattern)
        self.group = group

    def evaluate(self, df) -> np.ndarray:
        values = _as_array(self.child.evaluate(df), df.count())

        def extract(value):
            if value is None:
                return None
            match = self.pattern.search(str(value))
            return match.group(self.group) if match else ""

        return np.array([extract(v) for v in values], dtype=object)


class Split(Expression):
    def __init__(self, child: Expression, pattern: str):
        self.child = child
        self.pattern = re.compile(pattern)

    def evaluate(self, df) -> np.ndarray:
        values = _as_array(self.child.evaluate(df), df.count())
        # Per-slot assignment: np.array(list-of-equal-length-lists) would
        # silently build a 2-D object matrix instead of a list column.
        out = np.empty(len(values), dtype=object)
        for i, value in enumerate(values):
            out[i] = None if value is None else self.pattern.split(str(value))
        return out


class GetItem(Expression):
    def __init__(self, child: Expression, index: int):
        self.child = child
        self.index = index

    def evaluate(self, df) -> np.ndarray:
        values = self.child.evaluate(df)
        out = []
        for value in values:
            try:
                out.append(value[self.index])
            except (TypeError, IndexError):
                out.append(None)
        return np.array(out, dtype=object)


class Mean(Expression):
    def __init__(self, child: Expression):
        self.child = child

    def evaluate(self, df) -> np.ndarray:
        values = _as_array(self.child.evaluate(df), df.count())
        return np.full(df.count(), np.nanmean(values.astype(np.float64)))


# --- public constructors (pyspark.sql.functions names) ---------------------

def col(name: str) -> Column:
    return Column(name)


def lit(value) -> Literal:
    return Literal(value)


def when(condition: Expression, value) -> When:
    return When([(condition, value)])


def regexp_extract(column, pattern: str, group: int) -> RegexpExtract:
    if isinstance(column, str):
        column = col(column)
    return RegexpExtract(column, pattern, group)


def split(column, pattern: str) -> Split:
    if isinstance(column, str):
        column = col(column)
    return Split(column, pattern)


def mean(column) -> Mean:
    if isinstance(column, str):
        column = col(column)
    return Mean(column)
