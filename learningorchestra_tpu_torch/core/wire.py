"""Binary columnar wire framing for the store service.

The port's copy of ``learningorchestra_tpu/core/wire.py``, with only its
imports rewritten: a frame encoded here is byte for byte the reference's,
so the two packages' clients and servers read each other.

The reference's data plane is BSON over the Mongo wire protocol
(reference: microservices/database_api_image/database.py:94-130 via
pymongo) — typed bytes, not text. Dataset bodies as JSON cost ~10×
the bytes and a float-repr per cell. This frame
is the typed replacement for the three bulk columnar verbs
(``read_columns`` / ``insert_columns`` / ``set_column``).

Two frame versions share one header schema:

**v1** (``LOCB1``) — the original layout, kept for old peers::

    LOCB1\\n | u32 header_len | header JSON | buffer bytes...

**v2** (``LOCB2``) — fixed-width, 64-byte-aligned columnar layout::

    LOCB2\\n | u32 header_len | header JSON | pad | buffer | pad | ...

where every buffer starts on a 64-byte boundary *relative to the frame
start*. Decoding a v2 frame performs ONE allocation (an aligned copy of
the whole frame — or zero when the bytes already sit in an aligned
buffer, e.g. a shared-memory ring slot) and hands each column numpy
**views** into it: no per-column copies, no per-cell work, and every
view is 64-byte aligned (SIMD/DMA friendly). The views are read-only
and carry an ownership token (:class:`FrameOwner`) so a consumer — the
device cache pinning a decoded table — keeps exactly one backing buffer
alive, and a caller writing through a view cannot corrupt it
(copy-on-write via ``Column._shared``).

Version negotiation rides the existing ``X-Lo-Columns-Accept`` header:
a client that understands v2 advertises ``v2`` (alongside ``zlib`` when
it wants compression); a server only emits v2 when asked, so old
clients keep receiving v1 and old servers keep being understood —
:func:`decode_frame` dispatches on the magic either way.

The header describes each column (kind, row count, which buffers
follow, per-buffer lengths); buffers are the columns' live numpy
payloads verbatim (``Column.wire_parts`` — handed over as buffer
views, never ``tobytes`` copies; the LO106 analyzer rule keeps it that
way). Encoding and decoding do zero per-cell work. ``obj``-kind columns
(mixed cells) fall back to JSON values inside the header — they are the
overlay tail, never the dataset body.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Optional, Union

import numpy as np

from learningorchestra_tpu_torch.core.columns import Column, FrameOwner

MAGIC = b"LOCB1\n"
MAGIC_V2 = b"LOCB2\n"
CONTENT_TYPE = "application/x-lo-columns"

# Buffer alignment of the v2 layout. 64 bytes covers every dtype the
# columns ship (f8/i8 need 8) with headroom for cache-line/AVX-512-width
# access — and it is what lets decode hand out *views* instead of
# per-column aligned copies.
ALIGN = 64

# Optional whole-frame compression (LO_STORE_COMPRESS), negotiated per
# request: the client advertises ACCEPT_HEADER on binary reads (and
# stamps ENCODING_HEADER on compressed uploads); the server compresses a
# response ONLY when the request advertised, and always stamps
# ENCODING_HEADER on what it compressed. Custom headers — not HTTP
# Content-Encoding — so no WSGI middleware ever transcodes the frame
# behind the framing's back. stdlib zlib at level 1: typed float columns
# compress 2-4x and the deflate cost overlaps the next chunk's fetch in
# the double-buffered read loop (store_service.RemoteStore).
#
# The same comma-separated ACCEPT_HEADER value carries the frame-version
# token: "v2" means "send me aligned LOCB2 frames".
ACCEPT_HEADER = "X-Lo-Columns-Accept"
ENCODING_HEADER = "X-Lo-Columns-Encoding"
WIRE_COMPRESSION = "zlib"
WIRE_V2 = "v2"
COMPRESS_LEVEL = 1
# Frames below this aren't worth a deflate pass (headers dominate).
COMPRESS_MIN_BYTES = 4096

Buffer = Union[bytes, bytearray, memoryview, np.ndarray]


def compress_frame(frame: bytes) -> bytes:
    return zlib.compress(frame, COMPRESS_LEVEL)


def decode_body(data: bytes, encoding: Optional[str]) -> bytes:
    """Undo wire compression per the peer's ENCODING_HEADER value."""
    if not encoding:
        return data
    if encoding != WIRE_COMPRESSION:
        raise ValueError(f"unknown columns wire encoding {encoding!r}")
    return zlib.decompress(data)


def accept_tokens(header_value: Optional[str]) -> set[str]:
    """The comma-separated ``X-Lo-Columns-Accept`` value as tokens."""
    if not header_value:
        return set()
    return {token.strip() for token in header_value.split(",") if token.strip()}


def _byte_view(part: Buffer) -> memoryview:
    """``part`` as a flat byte view — no copy, whatever the dtype.
    Zero-size arrays short-circuit: ``memoryview.cast`` rejects any
    view with a zero in its shape (a (0, w) vec buffer from a
    beyond-the-end paged chunk, a width-0 vec column)."""
    if isinstance(part, np.ndarray):
        if part.size == 0:
            return memoryview(b"")
        return memoryview(np.ascontiguousarray(part)).cast("B")
    return memoryview(part).cast("B")


def _align_up(offset: int) -> int:
    return (offset + ALIGN - 1) // ALIGN * ALIGN


def _build_header(columns: dict[str, Column], extra: Optional[dict]):
    header: dict = {"extra": extra or {}, "columns": []}
    buffers: list[memoryview] = []
    for name, column in columns.items():
        meta, parts = column.wire_parts()
        views = [_byte_view(part) for part in parts]
        meta["name"] = name
        meta["lens"] = [view.nbytes for view in views]
        header["columns"].append(meta)
        buffers.extend(views)
    return json.dumps(header).encode("utf-8"), buffers


def encode_frame(
    columns: dict[str, Column],
    extra: Optional[dict] = None,
    version: int = 1,
) -> bytes:
    """One frame for ``columns`` (+ the header's ``extra`` dict).

    ``version=2`` emits the aligned LOCB2 layout — only send it to a
    peer that advertised ``v2`` (the decode side accepts both)."""
    encoded, buffers = _build_header(columns, extra)
    if version == 2:
        out = bytearray()
        out += MAGIC_V2
        out += struct.pack("<I", len(encoded))
        out += encoded
        for view in buffers:
            pad = _align_up(len(out)) - len(out)
            out += b"\0" * pad
            out += view
        return bytes(out)
    out = bytearray()
    out += MAGIC
    out += struct.pack("<I", len(encoded))
    out += encoded
    for view in buffers:
        out += view
    return bytes(out)


def frame_version(data: Buffer) -> int:
    """1 or 2 per the magic; raises ``ValueError`` on anything else."""
    magic = bytes(_byte_view(data)[: len(MAGIC)])
    if magic == MAGIC:
        return 1
    if magic == MAGIC_V2:
        return 2
    raise ValueError("bad columnar frame magic")


def aligned_frame(data: Buffer) -> np.ndarray:
    """``data`` as a 64-byte-aligned, read-only uint8 array — ONE
    allocation + one memcpy when the source isn't already aligned, zero
    when it is (a shared-memory ring slot). This is the only copy a v2
    decode ever performs."""
    if (
        isinstance(data, np.ndarray)
        and data.dtype == np.uint8
        and data.ndim == 1
        and data.ctypes.data % ALIGN == 0
    ):
        if data.flags.writeable:
            data = data[:]
            data.flags.writeable = False
        return data
    view = _byte_view(data)
    n = view.nbytes
    backing = np.empty(n + ALIGN, dtype=np.uint8)
    shift = (-backing.ctypes.data) % ALIGN
    base = backing[shift : shift + n]
    base[:] = np.frombuffer(view, dtype=np.uint8)
    base.flags.writeable = False
    return base


def _parse_header(view: memoryview) -> tuple[dict, int]:
    (header_len,) = struct.unpack_from("<I", view, len(MAGIC))
    start = len(MAGIC) + 4
    header = json.loads(bytes(view[start : start + header_len]).decode("utf-8"))
    return header, start + header_len


def decode_frame(data: Buffer) -> tuple[dict[str, Column], dict]:
    """Decode either frame version (dispatching on the magic).

    v1 frames decode into columns that OWN their buffers (per-column
    copies — the compatibility contract old peers rely on). v2 frames
    decode zero-copy: one aligned allocation for the whole frame, every
    column a read-only view into it, ownership tracked by a shared
    :class:`FrameOwner` so a pinning consumer (the device cache) keeps
    exactly one buffer alive."""
    if frame_version(data) == 2:
        return decode_frame_v2(data)
    view = _byte_view(data)
    header, offset = _parse_header(view)
    columns: dict[str, Column] = {}
    for meta in header["columns"]:
        parts: list[bytes] = []
        for length in meta["lens"]:
            if offset + length > view.nbytes:
                # a slice would silently come back short — a truncated
                # frame (server dying mid-response) must RAISE so the
                # chunk-retry machinery re-fetches, never return a
                # silently short column
                raise ValueError("truncated columnar frame")
            parts.append(bytes(view[offset : offset + length]))
            offset += length
        columns[meta["name"]] = Column.from_wire_parts(meta, parts)
    return columns, header.get("extra", {})


def decode_frame_v2(data: Buffer) -> tuple[dict[str, Column], dict]:
    base = aligned_frame(data)
    header, offset = _parse_header(memoryview(base))
    owner = FrameOwner(base)
    columns: dict[str, Column] = {}
    for meta in header["columns"]:
        parts: list[np.ndarray] = []
        for length in meta["lens"]:
            offset = _align_up(offset)
            if offset + length > len(base):
                # see decode_frame: short slices must raise, not decode
                raise ValueError("truncated columnar frame")
            parts.append(base[offset : offset + length])
            offset += length
        columns[meta["name"]] = Column.from_wire_parts(
            meta, parts, copy=False, owner=owner
        )
    return columns, header.get("extra", {})
