"""Typed columnar blocks: the store's cell engine.

The reference delegates typed storage to MongoDB's BSON (reference:
microservices/database_api_image/database.py:94-130 stores documents;
Mongo owns the bytes). Round 3 kept dataset bodies as Python lists of
boxed objects — ~60-100 bytes of interpreter overhead per cell — which
capped the store at ~1M rows. This module is the fix: a :class:`Column`
holds one field of a dataset block as a typed numpy buffer:

- ``f8``  — float64 values
- ``i8``  — int64 values
- ``num`` — mixed int/float: float64 data + an int-mask so ``28``
  round-trips as ``28`` and ``2.5`` as ``2.5`` (the dtype converter's
  int-collapse contract, ops/dtype.py)
- ``bool`` — bools (kept distinct from ``1``: Mongo's ``$group``
  separates them, reference histogram.py:63-69)
- ``str`` — Arrow-style UTF-8 byte buffer + int64 offsets (dataset
  bodies arrive as raw strings at ingest — reference database.py:156-169
  — so string cells must be unboxed too, not just numbers)
- ``vec`` — fixed-width float64 vectors as one ``(rows, width)`` matrix;
  cells materialize as per-row plain lists only at document reads. The
  probability column the model builder persists for every test row
  (reference model_builder.py:232-247 converts Spark's probability
  vector per row) would otherwise box millions of Python lists.
- ``obj`` — Python-list fallback for mixed/irregular cells (document
  overlays, ragged vectors)

``None`` (explicit null) and *missing* (a row that predates a
later-added field — Mongo's absent-field state) are tracked in packed
side masks, never as boxed sentinels in the data.

Concurrency: columns are copy-on-write. ``snapshot()`` marks buffers
shared; readers work outside the store lock while writers copy before
the first in-place mutation. Appends never copy — they land beyond any
snapshot's recorded ``size``.

The same buffers serialize three ways with zero per-cell work: the
binary HTTP wire (core/wire.py), base64 WAL records (crash recovery /
replication), and numpy hand-off to the compute layer (core/table.py).
"""

from __future__ import annotations

import base64
import os
from collections import Counter
from typing import Any, Iterable, Optional

import numpy as np

__all__ = ["Column", "FrameOwner", "MISSING", "merge_kind"]


class FrameOwner:
    """Ownership token for a zero-copy decoded wire frame: every column
    view of one frame references the SAME aligned backing buffer
    through this token, so pinning any decoded column (the device
    cache's host tier) keeps exactly one allocation alive — and
    ``nbytes`` tells the pinning cache what that costs. The buffer is
    read-only; a column view marked ``_shared`` copies before any
    in-place mutation, so a caller can never corrupt a pinned frame."""

    __slots__ = ("base",)

    def __init__(self, base):
        self.base = base

    @property
    def nbytes(self) -> int:
        return int(self.base.nbytes)


class _Missing:
    """Pad value for block rows that genuinely lack a field. Distinct
    from ``None`` (an explicit null) so synthesized documents keep
    Mongo's missing-field semantics ($exists, $ne on absent fields).
    Never escapes the store: columnar reads map pads to ``None``."""

    __slots__ = ()

    def __repr__(self):
        return "<missing>"


MISSING = _Missing()

EMPTY = "empty"  # only pads so far; adopts the kind of the first data
F8 = "f8"
I8 = "i8"
NUM = "num"
BOOL = "bool"
STR = "str"
VEC = "vec"
OBJ = "obj"

_NUMERIC_KINDS = frozenset((F8, I8, NUM))
_DTYPES = {F8: np.float64, I8: np.int64, NUM: np.float64, BOOL: np.bool_,
           VEC: np.float64}


def merge_kind(a: str, b: str) -> str:
    """Width-blind kind merge; ``vec``+``vec`` of differing widths is
    resolved to ``obj`` in ``append_column`` (widths live on the data
    buffers, not the kind tags)."""
    if a == b:
        return a
    if a == EMPTY:
        return b
    if b == EMPTY:
        return a
    if a in _NUMERIC_KINDS and b in _NUMERIC_KINDS:
        return NUM
    return OBJ


def _classify(values: Iterable) -> tuple[str, bool, bool]:
    """(kind, has_none, has_missing) for raw Python values. The type-set
    scan is a single C loop; per-value Python dispatch happens only for
    genuinely mixed columns (→ obj, where it is unavoidable)."""
    types = {type(v) for v in values}
    has_none = type(None) in types
    has_missing = _Missing in types
    types.discard(type(None))
    types.discard(_Missing)
    kind = EMPTY
    for t in types:
        if t is bool or issubclass(t, np.bool_):
            k = BOOL
        elif issubclass(t, (int, np.integer)):
            k = I8
        elif issubclass(t, (float, np.floating)):
            k = F8
        elif issubclass(t, str):
            k = STR
        else:
            k = OBJ
        kind = merge_kind(kind, k)
    return kind, has_none, has_missing


def _object_array(values: list) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _group_key(value):
    """Canonical hashable grouping key: bools tagged apart from their
    numeric equals PER ELEMENT (so [True] and [1] stay distinct groups,
    like the scalar path); unhashable nested cells (dicts, lists inside
    lists come back from tolist as lists) fall back to repr."""
    if isinstance(value, list):
        return tuple(_group_key(element) for element in value)
    try:
        hash(value)
    except TypeError:
        return ("__unhashable__", repr(value))
    return (isinstance(value, bool), value)


def _pack(mask: Optional[np.ndarray], size: int) -> Optional[np.ndarray]:
    """Packed-bit buffer for the wire — handed over as the packbits
    array itself (a fresh allocation already), never a second
    ``tobytes`` copy (LO106)."""
    if mask is None:
        return None
    return np.packbits(mask[:size])


def _unpack(raw, size: int) -> Optional[np.ndarray]:
    if raw is None:
        return None
    bits = (
        raw
        if isinstance(raw, np.ndarray)
        else np.frombuffer(raw, dtype=np.uint8)
    )
    if size > 8 * len(bits):
        # np.unpackbits with count past the buffer reads OUT OF BOUNDS
        # silently (observed: garbage bytes, no error) — a short mask
        # buffer must raise like any other truncated wire payload
        raise ValueError("packed mask shorter than the row count")
    return np.unpackbits(bits, count=size).astype(bool)


def _b64(raw) -> Optional[str]:
    """Base64 of any bytes-like buffer (bytes or a contiguous numpy
    view — wire_parts hands over views, never tobytes copies)."""
    return None if raw is None else base64.b64encode(raw).decode("ascii")


def _unb64(text: Optional[str]) -> Optional[bytes]:
    return None if text is None else base64.b64decode(text)


def _encode_strings(values: list) -> tuple[np.ndarray, np.ndarray]:
    """Python strings → (uint8 byte buffer, int64 offsets). One joined
    encode; char offsets are reused as byte offsets when the payload is
    pure ASCII (the overwhelmingly common case)."""
    n = len(values)
    joined = "".join(values)
    encoded = joined.encode("utf-8")
    if len(encoded) == len(joined):  # ASCII: char lengths == byte lengths
        lengths = np.fromiter(map(len, values), dtype=np.int64, count=n)
    else:
        lengths = np.fromiter(
            (len(v.encode("utf-8")) for v in values), dtype=np.int64, count=n
        )
    offsets = np.empty(n + 1, dtype=np.int64)
    offsets[0] = 0
    np.cumsum(lengths, out=offsets[1:])
    # the ingest path builds an OWNED, appendable byte buffer from the
    # transient encode — this copy IS the allocation, not a redundancy
    # lo: allow[LO106]
    return np.frombuffer(encoded, dtype=np.uint8).copy(), offsets


class Column:
    """One field of a dataset block. See module docstring for kinds.

    Internal geometry: ``data``/masks are capacity buffers; ``size`` is
    the live prefix. For ``str``, ``data`` is the byte buffer (live
    prefix ``offsets[size]``) and ``offsets`` has ``size + 1`` live
    entries. ``edits`` (str only) overlays single-cell updates so a
    point write into an Arrow layout is O(1), not an O(n) rebuild.
    """

    __slots__ = (
        "kind",
        "size",
        "data",
        "offsets",
        "none",
        "miss",
        "intm",
        "edits",
        "_shared",
        "spill",
        "owner",
    )

    def __init__(self, kind: str = EMPTY):
        self.kind = kind
        self.size = 0
        # Zero-copy wire decode: the FrameOwner whose aligned buffer
        # this column's data/offsets view into (None = owned buffers).
        self.owner: Optional["FrameOwner"] = None
        # Out-of-core state: {"dir", "prefix"} once the payload lives in
        # disk-backed mappings (spill_to); None = all-RAM buffers.
        self.spill: Optional[dict] = None
        if kind == OBJ:
            self.data: Any = []
        elif kind == VEC:
            self.data = np.empty((0, 0), dtype=np.float64)
        else:
            self.data = np.empty(0, dtype=_DTYPES.get(kind, np.uint8))
        self.offsets: Optional[np.ndarray] = (
            np.zeros(1, dtype=np.int64) if kind == STR else None
        )
        self.none: Optional[np.ndarray] = None
        self.miss: Optional[np.ndarray] = None
        self.intm: Optional[np.ndarray] = None
        self.edits: Optional[dict[int, Any]] = None
        self._shared = False

    # --- constructors ---------------------------------------------------------
    @classmethod
    def from_values(cls, values) -> "Column":
        """Build from raw Python values (the JSON-wire / document path)."""
        if isinstance(values, np.ndarray) and values.dtype != object:
            return cls.from_numpy(values)
        values = list(values)
        kind, has_none, has_missing = _classify(values)
        column = cls._build(values, kind, has_none, has_missing)
        return column

    @classmethod
    def _build(
        cls, values: list, kind: str, has_none: bool, has_missing: bool
    ) -> "Column":
        n = len(values)
        column = cls(OBJ if kind == OBJ else kind)
        column.size = n
        if kind == OBJ:
            column.data = list(values)
            if has_missing:
                column.miss = np.fromiter(
                    (v is MISSING for v in values), dtype=bool, count=n
                )
                column.data = [None if v is MISSING else v for v in values]
            return column
        absent = None
        if has_none or has_missing:
            obj = _object_array(values)
            if has_none:
                column.none = np.fromiter(
                    (v is None for v in values), dtype=bool, count=n
                )
            if has_missing:
                column.miss = np.fromiter(
                    (v is MISSING for v in values), dtype=bool, count=n
                )
            absent = (
                column.none
                if column.miss is None
                else (
                    column.miss
                    if column.none is None
                    else column.none | column.miss
                )
            )
        if kind == EMPTY:
            # only None/MISSING cells: keep an empty-kind column; data
            # buffer is a placeholder until real values merge in
            column.data = np.zeros(n, dtype=np.uint8)
            return column
        if kind == STR:
            if absent is not None:
                values = [
                    "" if (v is None or v is MISSING) else v for v in values
                ]
            column.data, column.offsets = _encode_strings(values)
            return column
        try:
            if absent is not None:
                obj[absent] = False if kind == BOOL else 0
                column.data = obj.astype(_DTYPES[kind])
            else:
                column.data = np.asarray(values, dtype=_DTYPES[kind])
        except OverflowError:
            # e.g. a Python int beyond int64 — keep the boxed fallback
            return cls._build(values, OBJ, has_none, has_missing)
        if kind == NUM:
            column.intm = np.fromiter(
                (type(v) is not float and not isinstance(v, np.floating)
                 for v in values),
                dtype=bool,
                count=n,
            )
            if absent is not None:
                column.intm[absent] = False
        if kind == F8 and column.none is None:
            nan = np.isnan(column.data)
            if nan.any():
                # NaN cells behave as nulls end to end (JSON has no NaN)
                column.none = nan
        elif kind == F8 and column.none is not None:
            column.data[column.none] = np.nan
        return column

    @classmethod
    def from_numpy(
        cls, array: np.ndarray, none: Optional[np.ndarray] = None
    ) -> "Column":
        """Zero-conversion constructor from a typed numpy array — the
        compute-layer hand-off. float64 NaNs read back as ``None``."""
        array = np.ascontiguousarray(array)
        if array.ndim == 2:
            if not np.issubdtype(array.dtype, np.number):
                return cls.from_values(array.tolist())
            column = cls(VEC)
            column.data = array.astype(np.float64, copy=False)
            column.size = len(array)
            if none is None:
                # NaN-as-null contract (same as the f8 branch): a cell
                # is the whole row vector, so any NaN nulls the cell —
                # JSON has no NaN to ship the partial vector in
                nan = np.isnan(column.data).any(axis=1)
                if nan.any():
                    none = nan
            if none is not None and none.any():
                column.none = none.astype(bool).copy()
            if not column.data.flags.writeable:
                column._shared = True  # read-only source: copy-on-write
            return column
        if array.dtype == np.bool_:
            column = cls(BOOL)
        elif np.issubdtype(array.dtype, np.integer):
            column = cls(I8)
            array = array.astype(np.int64, copy=False)
        elif np.issubdtype(array.dtype, np.floating):
            column = cls(F8)
            array = array.astype(np.float64, copy=False)
            if none is None:
                nan = np.isnan(array)
                if nan.any():
                    none = nan
        elif array.dtype.kind == "U":
            return cls.from_strings(array.tolist())
        else:
            return cls.from_values(array.tolist())
        column.data = array
        column.size = len(array)
        if none is not None and none.any():
            column.none = none.astype(bool).copy()
            if column.kind == F8:
                column.data = column.data.copy()
                column.data[column.none] = np.nan
        if not column.data.flags.writeable:
            column._shared = True  # read-only source: copy-on-write
        return column

    @classmethod
    def from_strings(
        cls, values: list, none: Optional[np.ndarray] = None
    ) -> "Column":
        """All-string values (``none`` marks nulls) → Arrow layout."""
        column = cls(STR)
        column.size = len(values)
        if none is not None and none.any():
            column.none = none.astype(bool).copy()
            values = [
                "" if m else v for v, m in zip(values, column.none)
            ]
        column.data, column.offsets = _encode_strings(values)
        return column

    @classmethod
    def from_nul_joined(cls, buffer: bytes, count: int) -> "Column":
        """NUL-separated concatenation of ``count`` cells (the native CSV
        parser's bulk export, native/csv_loader.cpp) → Arrow layout with
        no intermediate Python strings."""
        raw = np.frombuffer(buffer, dtype=np.uint8)
        stops = np.flatnonzero(raw == 0)
        if len(stops) != count:
            # short buffer, or a cell containing a literal NUL — the
            # separator protocol can't represent it; caller falls back
            raise ValueError("NUL-joined buffer does not split into count cells")
        column = cls(STR)
        column.size = count
        keep = np.ones(len(raw), dtype=bool)
        keep[stops] = False
        # offsets into the NUL-stripped buffer: each stop shifts later
        # cells left by one
        offsets = np.empty(count + 1, dtype=np.int64)
        offsets[0] = 0
        offsets[1:] = stops - np.arange(count)
        column.data = raw[keep][: offsets[-1]].copy()
        column.offsets = offsets
        return column

    @classmethod
    def pads(cls, count: int) -> "Column":
        column = cls(EMPTY)
        column.size = count
        column.data = np.zeros(count, dtype=np.uint8)
        if count:
            column.miss = np.ones(count, dtype=bool)
        return column

    # --- geometry / flags -----------------------------------------------------
    def __len__(self) -> int:
        return self.size

    @property
    def has_missing(self) -> bool:
        return self.miss is not None and bool(self.miss[: self.size].any())

    def is_missing(self, i: int) -> bool:
        return self.miss is not None and bool(self.miss[i])

    def _absent_mask(self) -> Optional[np.ndarray]:
        if self.none is None and self.miss is None:
            return None
        if self.none is None:
            return self.miss[: self.size]
        if self.miss is None:
            return self.none[: self.size]
        return self.none[: self.size] | self.miss[: self.size]

    # --- copy-on-write --------------------------------------------------------
    def snapshot(self) -> "Column":
        """A consistent read view sharing buffers; both sides copy
        before their next in-place write. Appends by the live column
        never disturb the snapshot (they land beyond its ``size``).
        Must be called under the store lock."""
        clone = Column.__new__(Column)
        clone.kind = self.kind
        clone.size = self.size
        clone.data = self.data
        clone.offsets = self.offsets
        clone.none = self.none
        clone.miss = self.miss
        clone.intm = self.intm
        clone.edits = dict(self.edits) if self.edits else None
        clone.owner = self.owner
        # The clone READS the shared mapping but must never take the
        # append-into-file path — only one column may own the file tail.
        clone.spill = None
        clone._shared = True
        self._shared = True
        return clone

    def _own(self) -> None:
        """Copy shared buffers before an in-place mutation.

        ``np.array`` (not ``.copy()``) for mapped buffers: a memmap's
        ``.copy()`` preserves the subclass, which would leave a RAM
        column still claiming to be spilled."""
        if not self._shared:
            return
        if self.kind == OBJ:
            self.data = list(self.data)
        else:
            self.data = np.array(self.data)
        if self.offsets is not None:
            self.offsets = np.array(self.offsets)
        self.spill = None  # buffers are anonymous RAM again
        self.owner = None  # owned copies no longer pin a wire frame
        for slot in ("none", "miss", "intm"):
            mask = getattr(self, slot)
            if mask is not None:
                setattr(self, slot, mask.copy())
        self._shared = False

    # --- mask helpers ---------------------------------------------------------
    def _row_capacity(self) -> int:
        if self.kind == OBJ:
            return self.size
        if self.kind == STR:
            return max(len(self.offsets) - 1, self.size)
        return max(len(self.data), self.size)

    def _mask(self, slot: str) -> np.ndarray:
        mask = getattr(self, slot)
        capacity = self._row_capacity()
        if mask is None:
            mask = np.zeros(capacity, dtype=bool)
            setattr(self, slot, mask)
        elif len(mask) < capacity:
            grown = np.zeros(capacity, dtype=bool)
            grown[: len(mask)] = mask
            mask = grown
            setattr(self, slot, mask)
        return mask

    # --- appends (never copy shared buffers) ----------------------------------
    def _reserve(self, extra: int) -> None:
        """Grow ``data`` (non-str kinds) so ``size + extra`` fits."""
        need = self.size + extra
        if self.kind == OBJ:
            return
        if len(self.data) >= need:
            return
        capacity = max(need, 2 * len(self.data), 1024)
        if self.kind == VEC:
            grown = np.empty((capacity, self.data.shape[1]), dtype=np.float64)
        else:
            grown = np.empty(capacity, dtype=self.data.dtype)
        grown[: self.size] = self.data[: self.size]
        # NOTE: _shared stays set — masks/offsets may still be shared
        # with a snapshot; _own() decides per-buffer at mutation time.
        self.data = grown

    def _append_masks(self, other: "Column", offset: int) -> None:
        for slot in ("none", "miss"):
            theirs = getattr(other, slot)
            if theirs is not None and theirs[: other.size].any():
                mask = self._mask(slot)
                mask[offset : offset + other.size] = theirs[: other.size]
            elif getattr(self, slot) is not None:
                self._mask(slot)[offset : offset + other.size] = False

    def append_column(self, other: "Column") -> "Column":
        """Append ``other``'s cells; returns the (possibly re-kinded)
        column — callers must re-assign. The store's one append path."""
        if other.size == 0 and merge_kind(self.kind, other.kind) in (
            self.kind,
            EMPTY,
        ):
            # nothing to add and no kind change: return unchanged. This
            # also keeps zero-length slice-assignments away from
            # read-only zero-copy wire views (the paged read loop
            # appends the terminal empty chunk through here).
            return self
        if other.kind == EMPTY and self.kind not in (EMPTY, NUM):
            other = other._as_kind(self.kind, width=self._vec_width())
        merged = merge_kind(self.kind, other.kind)
        if (
            merged == VEC
            and self.kind == VEC
            and other.kind == VEC
            and self.data.shape[1] != other.data.shape[1]
        ):
            if other.size == 0:  # zero rows carry no width information
                return self
            if self.size == 0:  # adopt the first real width
                self.data = np.empty((0, other.data.shape[1]), np.float64)
            else:  # widths differ: vectors become ragged → boxed fallback
                merged = OBJ
        if merged != self.kind or (merged == NUM and other.kind != NUM):
            return self._append_promoted(other, merged)
        offset = self.size
        if self.is_spilled() and merged not in (OBJ, EMPTY):
            return self._append_spilled(other, merged)
        if merged == OBJ:
            if self._shared:
                self.data = list(self.data[: self.size])
                self._shared = False
            self.data.extend(other.tolist(pad_as_none=True))
            self.size += other.size
            if other.miss is not None and other.miss[: other.size].any():
                mask = self._mask("miss")
                mask[offset : offset + other.size] = other.miss[: other.size]
            return self
        if merged == STR:
            other = other._materialized()
            my_bytes = int(self.offsets[self.size])
            their_bytes = int(other.offsets[other.size])
            if their_bytes:
                # guarded: a chunk of all-empty/null strings carries
                # rows but ZERO bytes — the no-growth path would then
                # slice-assign zero length into a possibly read-only
                # zero-copy wire view, which numpy rejects
                if len(self.data) < my_bytes + their_bytes:
                    capacity = max(
                        my_bytes + their_bytes, 2 * len(self.data), 4096
                    )
                    grown = np.empty(capacity, dtype=np.uint8)
                    grown[:my_bytes] = self.data[:my_bytes]
                    self.data = grown
                self.data[my_bytes : my_bytes + their_bytes] = other.data[
                    :their_bytes
                ]
            if len(self.offsets) < self.size + other.size + 1:
                capacity = max(
                    self.size + other.size + 1, 2 * len(self.offsets)
                )
                grown = np.empty(capacity, dtype=np.int64)
                grown[: self.size + 1] = self.offsets[: self.size + 1]
                self.offsets = grown
            self.offsets[self.size + 1 : self.size + other.size + 1] = (
                other.offsets[1 : other.size + 1] + my_bytes
            )
            self.size += other.size
            self._append_masks(other, offset)
            return self
        if merged == EMPTY:
            self._reserve(other.size)
            self.size += other.size
            self._append_masks(other, offset)
            return self
        self._reserve(other.size)
        self.data[offset : offset + other.size] = other.data[: other.size]
        self.size += other.size
        self._append_masks(other, offset)
        if merged == NUM:
            intm = self._mask("intm")
            if other.intm is not None:
                intm[offset : offset + other.size] = other.intm[: other.size]
            else:
                intm[offset : offset + other.size] = False
        return self

    def _append_promoted(self, other: "Column", merged: str) -> "Column":
        """Kind changes: rebuild self at the merged kind, then append."""
        if merged == other.kind and self.kind == EMPTY:
            # adopt the incoming kind, keeping the pad prefix
            fresh = Column(other.kind if other.kind != EMPTY else EMPTY)
            width = other._vec_width()
            if other.kind == STR:
                fresh.data = np.empty(0, dtype=np.uint8)
                fresh.offsets = np.zeros(1, dtype=np.int64)
            elif other.kind == OBJ:
                fresh.data = []
            elif other.kind == VEC:
                fresh.data = np.empty((0, width), dtype=np.float64)
            else:
                fresh.data = np.empty(0, dtype=_DTYPES.get(other.kind, np.uint8))
            fresh = fresh.append_column(self._as_kind(other.kind, width=width))
            return fresh.append_column(other)
        if merged == NUM and self.kind in _NUMERIC_KINDS:
            promoted = self._as_kind(NUM)
            return promoted.append_column(other._as_kind(NUM))
        if merged == OBJ:
            promoted = self._as_kind(OBJ)
            return promoted.append_column(other)
        # e.g. empty incoming into typed self at same merged kind
        return self.append_column(other._as_kind(self.kind))

    def _vec_width(self) -> int:
        return self.data.shape[1] if self.kind == VEC else 0

    def _as_kind(self, kind: str, width: int = 0) -> "Column":
        if kind == self.kind:
            return self
        if kind == NUM and self.kind in (I8, F8, EMPTY):
            out = Column(NUM)
            out.size = self.size
            out.data = self.data[: self.size].astype(np.float64)
            out.none = None if self.none is None else self.none[: self.size].copy()
            out.miss = None if self.miss is None else self.miss[: self.size].copy()
            intm = np.zeros(self.size, dtype=bool)
            if self.kind == I8:
                intm[:] = True
                absent = out._absent_mask()
                if absent is not None:
                    intm[absent] = False
            out.intm = intm
            if out.none is not None:
                out.data[out.none[: self.size]] = np.nan
            return out
        if kind == OBJ:
            out = Column(OBJ)
            out.size = self.size
            out.data = self.tolist(pad_as_none=True)
            out.miss = (
                None if self.miss is None else self.miss[: self.size].copy()
            )
            return out
        if self.kind == EMPTY:
            out = Column(kind)
            if kind == STR:
                pads = [""] * self.size
                out.size = self.size
                out.data, out.offsets = _encode_strings(pads)
            elif kind == OBJ:
                out.size = self.size
                out.data = [None] * self.size
            elif kind == VEC:
                out.size = self.size
                out.data = np.zeros((self.size, width), dtype=np.float64)
            else:
                out.size = self.size
                out.data = np.zeros(self.size, dtype=_DTYPES[kind])
                if kind == NUM:
                    out.intm = np.zeros(self.size, dtype=bool)
            out.none = None if self.none is None else self.none[: self.size].copy()
            out.miss = None if self.miss is None else self.miss[: self.size].copy()
            return out
        raise TypeError(f"cannot view {self.kind} column as {kind}")

    def append_pads(self, count: int) -> "Column":
        return self.append_column(Column.pads(count))

    # --- point access ---------------------------------------------------------
    def get(self, i: int):
        """Python value at ``i`` (``MISSING`` for pads, ``None`` for
        nulls)."""
        if self.miss is not None and self.miss[i]:
            return MISSING
        if self.none is not None and self.none[i]:
            return None
        if self.edits is not None and i in self.edits:
            return self.edits[i]
        if self.kind == OBJ:
            return self.data[i]
        if self.kind == EMPTY:
            return MISSING
        if self.kind == STR:
            start, stop = int(self.offsets[i]), int(self.offsets[i + 1])
            return bytes(self.data[start:stop]).decode("utf-8")
        if self.kind == VEC:
            return self.data[i].tolist()
        value = self.data[i]
        if self.kind == NUM:
            return int(value) if self.intm is not None and self.intm[i] else float(value)
        if self.kind == F8 and np.isnan(value):
            return None
        return value.item()

    def set(self, i: int, value) -> "Column":
        """Point write; returns the (possibly re-kinded) column."""
        self._own()
        if isinstance(value, float) and value != value:
            value = None  # NaN behaves as null end to end (no JSON NaN)
        kind, _, _ = _classify((value,))
        if value is None or value is MISSING:
            slot = "none" if value is None else "miss"
            self._mask(slot)[i] = True
            other = "miss" if value is None else "none"
            if getattr(self, other) is not None:
                self._mask(other)[i] = False
            if self.kind == F8:
                self.data[i] = np.nan
            if self.edits is not None:
                self.edits.pop(i, None)
            return self
        merged = merge_kind(self.kind, kind)
        if merged != self.kind:
            if merged == NUM and self.kind in _NUMERIC_KINDS:
                promoted = self._as_kind(NUM)
                return promoted.set(i, value)
            if self.kind == EMPTY:
                promoted = self._as_kind(kind)
                return promoted.set(i, value)
            promoted = self._as_kind(OBJ)
            return promoted.set(i, value)
        if self.none is not None:
            self.none[i] = False
        if self.miss is not None:
            self.miss[i] = False
        if self.kind == OBJ:
            self.data[i] = value
        elif self.kind == STR:
            if self.edits is None:
                self.edits = {}
            self.edits[i] = value
            if len(self.edits) > max(1024, self.size // 8):
                rebuilt = Column.from_values(self.tolist(pad_as_none=False))
                rebuilt.miss = self.miss
                return rebuilt
        else:
            self.data[i] = value
            if self.kind == NUM:
                self._mask("intm")[i] = type(value) is not float and not isinstance(
                    value, np.floating
                )
        return self

    # --- bulk reads -----------------------------------------------------------
    def _materialized(self) -> "Column":
        """str kind with edits → a fresh edit-free Arrow column."""
        if self.kind != STR or not self.edits:
            return self
        values = self._decode_all()
        for i, value in self.edits.items():
            values[i] = value
        none = self.none[: self.size] if self.none is not None else None
        fresh = Column.from_strings(values, none)
        fresh.miss = self.miss[: self.size].copy() if self.miss is not None else None
        return fresh

    # --- out-of-core spill ----------------------------------------------------
    def is_spilled(self) -> bool:
        # both conditions: snapshots/slices share the mapping (memmap
        # instance) without owning the file (spill is None), and an
        # _own() copy drops both
        return self.spill is not None and isinstance(self.data, np.memmap)

    def resident_nbytes(self) -> int:
        """Anonymous-RAM bytes held by this column's buffers — memmapped
        payloads excluded (their pages are file-backed and evictable).
        The store's spill policy budgets against this, not nbytes()."""
        if self.kind == OBJ:
            return self.size * 64  # boxed estimate, never spillable
        total = 0
        if not isinstance(self.data, np.memmap):
            total += self.data.nbytes
        if self.offsets is not None and not isinstance(
            self.offsets, np.memmap
        ):
            total += self.offsets.nbytes
        for slot in ("none", "miss", "intm"):
            mask = getattr(self, slot)
            if mask is not None:
                total += mask.nbytes
        return total

    def advise_cold(self) -> None:
        """Drop this column's RESIDENT mapped pages (madvise DONTNEED on
        the read-only shared mapping): the data stays in the page cache,
        so a later read refaults cheaply, but the pages stop counting
        against the process's RSS — keeping a spilled store's footprint
        near the LO_SPILL_BYTES budget even while scans page through
        tens of GB."""
        import mmap as mmap_module

        for buffer in (self.data, self.offsets):
            if isinstance(buffer, np.memmap):
                try:
                    buffer._mmap.madvise(mmap_module.MADV_DONTNEED)
                except (AttributeError, OSError, ValueError):
                    pass  # platform without madvise: purely advisory

    def _spill_paths(self) -> tuple[str, str]:
        base = os.path.join(self.spill["dir"], self.spill["prefix"])
        return base + ".data", base + ".offsets"

    def spill_to(self, directory: str, prefix: str) -> int:
        """Move the live payload into files under ``directory`` and
        remap it read-only (``np.memmap``): stored bytes leave anonymous
        RAM and ride the page cache instead — the store's disk-ownership
        story (the reference leans on Mongo's data volumes for this,
        docker-compose.yml:335-340). Returns RAM bytes released; 0 when
        not spillable (obj/empty/zero-size or already spilled).

        Afterwards: bulk appends stream straight to the backing file
        (:meth:`_append_spilled`) — ingestion never pulls the column
        back; point mutations copy-on-write back into RAM (``_own``),
        leaving the stale file for collection drop to reclaim."""
        if self.kind in (OBJ, EMPTY) or self.size == 0 or self.is_spilled():
            return 0
        folded = self._materialized()  # str edits overlay → flat layout
        if folded is not self:
            self.data, self.offsets = folded.data, folded.offsets
            self.none, self.miss = folded.none, folded.miss
            self.edits = None
            self._shared = False
        os.makedirs(directory, exist_ok=True)
        data_path = os.path.join(directory, prefix + ".data")
        offsets_path = os.path.join(directory, prefix + ".offsets")
        live = int(self.offsets[self.size]) if self.kind == STR else self.size
        payload = np.ascontiguousarray(self.data[:live])
        released = payload.nbytes
        # ALL file writes before any state change: a mid-spill OSError
        # (disk full) must leave the column untouched — only orphan
        # partial files, reclaimed with the collection/process
        payload.tofile(data_path)
        live_offsets = None
        if self.kind == STR:
            live_offsets = np.ascontiguousarray(self.offsets[: self.size + 1])
            released += live_offsets.nbytes
            live_offsets.tofile(offsets_path)
        self.data = np.memmap(
            data_path, dtype=payload.dtype, mode="r", shape=payload.shape
        )
        if live_offsets is not None:
            self.offsets = np.memmap(
                offsets_path, dtype=np.int64, mode="r", shape=(self.size + 1,)
            )
        self.spill = {"dir": directory, "prefix": prefix}
        # future in-place mutations must copy out of the read-only map
        self._shared = True
        return released

    def _unspill(self) -> None:
        """Materialize the payload back into anonymous RAM (a failed
        file append); the stale spill files are reclaimed at drop."""
        self.data = np.array(self.data)
        if self.offsets is not None:
            self.offsets = np.array(self.offsets)
        self.spill = None

    def _append_spilled(self, other: "Column", merged: str) -> "Column":
        """Append to a spilled column by growing its backing file and
        remapping — bulk ingestion keeps streaming to disk instead of
        materializing the column back into RAM. Snapshot isolation
        holds: an existing snapshot's memmap covers only its own prefix
        of the (append-only) file. Failure-safe: a partial file write
        (disk full) truncates back to the previous length and the
        append retries through the in-RAM path — the backing file is
        never left with an orphan tail that would shift later records.
        """
        offset = self.size
        other = other._materialized()
        new_size = self.size + other.size
        if other.size == 0:
            return self
        data_path, offsets_path = self._spill_paths()
        prev_data_bytes = os.path.getsize(data_path)
        prev_offsets_bytes = (
            os.path.getsize(offsets_path) if self.kind == STR else 0
        )
        try:
            if merged == STR:
                my_bytes = int(self.offsets[self.size])
                their_bytes = int(other.offsets[other.size])
                with open(data_path, "ab") as handle:
                    np.ascontiguousarray(other.data[:their_bytes]).tofile(
                        handle
                    )
                shifted = np.ascontiguousarray(
                    other.offsets[1 : other.size + 1] + my_bytes,
                    dtype=np.int64,
                )
                with open(offsets_path, "ab") as handle:
                    shifted.tofile(handle)
                self.data = np.memmap(
                    data_path,
                    dtype=np.uint8,
                    mode="r",
                    shape=(my_bytes + their_bytes,),
                )
                self.offsets = np.memmap(
                    offsets_path,
                    dtype=np.int64,
                    mode="r",
                    shape=(new_size + 1,),
                )
            else:
                dtype = self.data.dtype
                payload = np.ascontiguousarray(
                    other.data[: other.size], dtype=dtype
                )
                with open(data_path, "ab") as handle:
                    payload.tofile(handle)
                shape = (
                    (new_size, self.data.shape[1])
                    if self.kind == VEC
                    else (new_size,)
                )
                self.data = np.memmap(
                    data_path, dtype=dtype, mode="r", shape=shape
                )
        except OSError:
            for path, prev in (
                (data_path, prev_data_bytes),
                (offsets_path, prev_offsets_bytes),
            ):
                try:
                    with open(path, "r+b") as handle:
                        handle.truncate(prev)
                except OSError:
                    pass
            self._unspill()
            return self.append_column(other)
        self.size = new_size
        self._append_masks(other, offset)
        if merged == NUM:
            intm = self._mask("intm")
            if other.intm is not None:
                intm[offset:new_size] = other.intm[: other.size]
            else:
                intm[offset:new_size] = False
        return self

    def _decode_all(self) -> list:
        nbytes = int(self.offsets[self.size])
        raw = bytes(self.data[:nbytes])
        text = raw.decode("utf-8")
        offsets = self.offsets
        if len(text) == nbytes:  # ASCII: byte offsets index the str directly
            return [
                text[offsets[i] : offsets[i + 1]] for i in range(self.size)
            ]
        return [
            raw[offsets[i] : offsets[i + 1]].decode("utf-8")
            for i in range(self.size)
        ]

    def tolist(
        self, start: int = 0, stop: Optional[int] = None, pad_as_none: bool = True
    ) -> list:
        """Python values in ``[start, stop)``; pads become ``None``
        (default) or ``MISSING``."""
        stop = self.size if stop is None else min(stop, self.size)
        n = stop - start
        if n <= 0:
            return []
        if self.kind == OBJ:
            out = list(self.data[start:stop])
        elif self.kind == EMPTY:
            out = [None] * n
        elif self.kind == STR:
            if start == 0 and stop == self.size:
                out = self._decode_all()
            else:
                base = int(self.offsets[start])
                nbytes = int(self.offsets[stop]) - base
                raw = bytes(self.data[base : base + nbytes])
                text = raw.decode("utf-8")
                offsets = self.offsets
                if len(text) == nbytes:
                    out = [
                        text[offsets[i] - base : offsets[i + 1] - base]
                        for i in range(start, stop)
                    ]
                else:
                    out = [
                        raw[offsets[i] - base : offsets[i + 1] - base].decode(
                            "utf-8"
                        )
                        for i in range(start, stop)
                    ]
            if self.edits:
                for i, value in self.edits.items():
                    if start <= i < stop:
                        out[i - start] = value
        elif self.kind == NUM:
            floats = self.data[start:stop].tolist()
            if self.intm is None:
                out = floats
            else:
                ints = self.intm[start:stop]
                out = [
                    int(v) if ints[i] else v for i, v in enumerate(floats)
                ]
        elif self.kind == F8:
            out = self.data[start:stop].tolist()
            if self.none is None:
                nan = np.isnan(self.data[start:stop])
                if nan.any():
                    for i in np.flatnonzero(nan):
                        out[i] = None
        else:
            out = self.data[start:stop].tolist()
        if self.none is not None:
            for i in np.flatnonzero(self.none[start:stop]):
                out[i] = None
        if self.miss is not None:
            pad = None if pad_as_none else MISSING
            for i in np.flatnonzero(self.miss[start:stop]):
                out[i] = pad
        return out

    def slice(self, start: int, stop: int) -> "Column":
        """Shared-buffer view of ``[start, stop)`` — O(1) for numeric
        kinds. Used by the wire read path."""
        stop = min(stop, self.size)
        start = min(start, stop)
        if self.kind == STR:
            source = self._materialized()
            out = Column(STR)
            out.size = stop - start
            base = int(source.offsets[start])
            out.data = source.data[base : int(source.offsets[stop])]
            # base == 0 (full-prefix reads — the projection/cast scans):
            # keep the VIEW; subtracting would copy the whole offsets
            # buffer (800 MB at 100M rows, per column, per read)
            out.offsets = (
                source.offsets[start : stop + 1]
                if base == 0
                else source.offsets[start : stop + 1] - base
            )
        elif self.kind == OBJ:
            out = Column(OBJ)
            out.size = stop - start
            out.data = self.data[start:stop]
        else:
            out = Column(self.kind)
            out.size = stop - start
            out.data = self.data[start:stop]
        for slot in ("none", "miss", "intm"):
            mask = getattr(self, slot)
            if mask is not None:
                setattr(out, slot, mask[start:stop])
        out.owner = self.owner
        out._shared = True
        self._shared = True
        return out

    def to_float64(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """float64 view (nulls/pads → NaN) — the design-matrix hand-off.
        Raises TypeError for non-numeric kinds. Mask-free f8/num
        columns hand back a READ-ONLY view of the buffer itself (zero
        copy on the store→matrix path; the copy only happens when NaN
        masking must write) and flip the column copy-on-write — so a
        later column mutation can never rewrite an already-assembled
        matrix, and a matrix writer can never corrupt the store (the
        isolation the old always-copy gave, kept without the copy)."""
        stop = self.size if stop is None else min(stop, self.size)
        absent = self._absent_mask()
        if self.kind in (F8, NUM):
            if absent is None:
                view = self.data[start:stop].astype(np.float64, copy=False)
                if view.flags.writeable:
                    view = view[:]  # fresh view object; base untouched
                    view.flags.writeable = False
                self._shared = True  # next in-place write copies first
                return view
            out = self.data[start:stop].astype(np.float64, copy=True)
        elif self.kind == I8:
            out = self.data[start:stop].astype(np.float64)
        elif self.kind == EMPTY:
            return np.full(stop - start, np.nan)
        else:
            raise TypeError(f"{self.kind} column is not numeric")
        if absent is not None:
            out[absent[start:stop]] = np.nan
        return out

    def to_object(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """Object-array view with ``None`` for nulls AND pads — the
        ColumnTable string-column hand-off."""
        return _object_array(self.tolist(start, stop, pad_as_none=True))

    # --- histogram ($group) fast path -----------------------------------------
    def unique_counts(self) -> list[dict]:
        """``[{_id, count}]`` groups over the live prefix — np.unique for
        typed kinds, tagged Counter for obj (bool-vs-1 parity with the
        row path, store._group_count)."""
        absent = self._absent_mask()
        null_count = int(absent.sum()) if absent is not None else 0
        out: list[dict] = []
        n = self.size
        if self.kind == OBJ:
            counts: dict = {}
            first: dict = {}
            for value in self.data[:n]:
                key = _group_key(value)
                counts[key] = counts.get(key, 0) + 1
                if key not in first:
                    first[key] = value
            # nulls already appear as None entries in data; pads were
            # stored as None too — counts are consistent already
            return [
                {"_id": first[key], "count": count}
                for key, count in counts.items()
            ]
        if self.kind == EMPTY:
            return [{"_id": None, "count": n}] if n else []
        if self.kind == VEC:
            data = self.data[:n]
            if absent is not None:
                data = data[~absent]
            nan = np.isnan(data).any(axis=1)
            if nan.any():  # NaN cells group as null (f8 parity)
                null_count += int(nan.sum())
                data = data[~nan]
            values, counts = np.unique(data, axis=0, return_counts=True)
            out = [
                {"_id": row.tolist(), "count": int(count)}
                for row, count in zip(values, counts)
            ]
            if null_count:
                out.append({"_id": None, "count": null_count})
            return out
        if self.kind == STR:
            source = self._materialized()
            values = source._decode_all()
            if absent is not None:
                keep = ~absent
                values = [v for v, k in zip(values, keep) if k]
            counts = Counter(values)
            out = [
                {"_id": value, "count": count}
                for value, count in counts.items()
            ]
        else:
            data = self.data[:n]
            if absent is not None:
                data = data[~absent]
            if self.kind == NUM:
                intm = (
                    self.intm[:n]
                    if self.intm is not None
                    else np.zeros(n, dtype=bool)
                )
                if absent is not None:
                    intm = intm[~absent]
                # ONE group per numeric value (2 and 2.0 merge, exactly
                # like the dict/Counter row path and Mongo's $group);
                # the key's int/float type follows the value's FIRST
                # occurrence, matching Counter's first-seen-key rule
                values, first, counts = np.unique(
                    data, return_index=True, return_counts=True
                )
                for value, index, count in zip(values, first, counts):
                    key = int(value) if intm[index] else float(value)
                    out.append({"_id": key, "count": int(count)})
            else:
                if self.kind == F8:
                    nan = np.isnan(data)
                    nan_count = int(nan.sum())
                    if nan_count:
                        data = data[~nan]
                        null_count += nan_count
                values, counts = np.unique(data, return_counts=True)
                out = [
                    {"_id": value.item(), "count": int(count)}
                    for value, count in zip(values, counts)
                ]
        if null_count:
            out.append({"_id": None, "count": null_count})
        return out

    # --- serialization --------------------------------------------------------
    def wire_parts(self) -> tuple[dict, list]:
        """(meta, buffers) for the binary HTTP frame (core/wire.py).
        Buffer order: data, offsets, none, miss, intm — present iff the
        corresponding meta flag says so. Buffers are handed over as
        numpy views of the live payload (``ascontiguousarray`` on an
        already-contiguous slice is free) — the frame assembly writes
        them into the output exactly once, with no intermediate
        ``tobytes`` copies (LO106)."""
        source = self._materialized()
        n = source.size
        meta: dict = {"kind": source.kind, "n": n}
        buffers: list = []
        if source.kind == OBJ:
            meta["values"] = source.tolist(pad_as_none=True)
        elif source.kind == STR:
            nbytes = int(source.offsets[n])
            buffers.append(np.ascontiguousarray(source.data[:nbytes]))
            buffers.append(np.ascontiguousarray(source.offsets[: n + 1]))
            meta["data"] = True
            meta["offsets"] = True
        elif source.kind == VEC:
            meta["w"] = source.data.shape[1]
            buffers.append(np.ascontiguousarray(source.data[:n]))
            meta["data"] = True
        elif source.kind != EMPTY:
            buffers.append(np.ascontiguousarray(source.data[:n]))
            meta["data"] = True
        for slot in ("none", "miss", "intm"):
            mask = getattr(source, slot)
            # intm ships even when all-False: a NUM column without its
            # int mask would deserialize structurally incomplete
            if mask is not None and (
                slot == "intm" or mask[:n].any()
            ):
                buffers.append(_pack(mask, n))
                meta[slot] = True
        return meta, buffers

    @classmethod
    def from_wire_parts(
        cls,
        meta: dict,
        buffers: list,
        copy: bool = True,
        owner: Optional["FrameOwner"] = None,
    ) -> "Column":
        """Rebuild a column from its wire buffers.

        ``copy=True`` (v1 frames, WAL base64 records) produces a column
        that OWNS its buffers. ``copy=False`` (aligned v2 frames,
        core/wire.py) produces read-only numpy *views* over the frame's
        one backing buffer — zero per-column copies; ``owner`` is the
        frame's :class:`FrameOwner` token, recorded on the column so a
        pinning consumer (the device cache) holds exactly one
        allocation. Zero-copy columns are marked ``_shared``: any
        in-place mutation copies first (copy-on-write), so a caller
        writing through a view can never corrupt the pinned frame."""
        kind = meta["kind"]
        n = meta["n"]
        column = cls(kind)
        column.size = n
        index = 0

        def take():
            nonlocal index
            raw = buffers[index]
            index += 1
            return raw

        def typed(raw, dtype):
            if not copy:
                # raw is an aligned uint8 view (core/wire.py): a dtype
                # reinterpretation of it is the zero-copy hand-off
                return raw.view(dtype)
            # v1/WAL decode contract: the column must own its buffers
            # (the source bytes are transient) — this copy is that
            # ownership, not a removable redundancy
            # lo: allow[LO106]
            return np.frombuffer(raw, dtype=dtype).copy()

        if kind == OBJ:
            column.data = list(meta["values"])
        elif kind == STR:
            column.data = typed(take(), np.uint8)
            column.offsets = typed(take(), np.int64)
        elif kind == VEC:
            width = int(meta["w"])
            # ALWAYS consume the data buffer — wire_parts emits one for
            # width-0 vec columns too (empty), and skipping it would
            # shift every following mask buffer onto the wrong slot
            raw = take()
            if width:
                # reshape the flat VIEW first, then (only under v1)
                # copy once — never allocate flat and reshape after
                flat = (
                    raw.view(np.float64)
                    if not copy
                    else np.frombuffer(raw, dtype=np.float64)
                )
                shaped = flat.reshape(-1, width)
                column.data = shaped if not copy else shaped.copy()
            else:
                column.data = np.empty((n, 0), dtype=np.float64)
        elif kind == EMPTY:
            column.data = np.zeros(n, dtype=np.uint8)
        else:
            column.data = typed(take(), _DTYPES[kind])
        for slot in ("none", "miss", "intm"):
            if meta.get(slot):
                setattr(column, slot, _unpack(take(), n))
        if kind == NUM and column.intm is None:
            # defensive: a NUM column always carries its int mask
            column.intm = np.zeros(n, dtype=bool)
        if not copy:
            column.owner = owner
            column._shared = True  # copy-on-write before any mutation
        return column

    def to_json_record(self) -> dict:
        """Base64 form for WAL lines (crash recovery + replication)."""
        meta, buffers = self.wire_parts()
        record = {"k": meta["kind"], "n": meta["n"]}
        if "values" in meta:
            record["v"] = meta["values"]
        if "w" in meta:
            record["w"] = meta["w"]
        index = 0
        for key, flag in (
            ("d", "data"),
            ("o", "offsets"),
            ("nm", "none"),
            ("mm", "miss"),
            ("im", "intm"),
        ):
            if meta.get(flag):
                record[key] = _b64(buffers[index])
                index += 1
        return record

    @classmethod
    def from_json_record(cls, record: dict) -> "Column":
        meta = {"kind": record["k"], "n": record["n"]}
        if "v" in record:
            meta["values"] = record["v"]
        if "w" in record:
            meta["w"] = record["w"]
        buffers: list[bytes] = []
        for key, flag in (
            ("d", "data"),
            ("o", "offsets"),
            ("nm", "none"),
            ("mm", "miss"),
            ("im", "intm"),
        ):
            if record.get(key) is not None:
                meta[flag] = True
                buffers.append(_unb64(record[key]))
        return cls.from_wire_parts(meta, buffers)

    def nbytes(self) -> int:
        """Approximate live payload bytes (capacity excluded)."""
        if self.kind == OBJ:
            return self.size * 64  # boxed estimate
        if self.kind == STR:
            return int(self.offsets[self.size]) + 8 * (self.size + 1)
        return int(self.data[: self.size].nbytes)
