"""Shared-memory ring transport for the binary columnar wire.

The port's copy of ``learningorchestra_tpu/core/shmring.py``, with only
its imports rewritten.

When the store server and its client are co-located (the runner's
single-process/LO_STACK topology hosts all seven services and the store
in one process tree — the common case), the HTTP body is pure overhead:
the frame is serialized into a socket, copied through the kernel, and
reassembled by the client just to land in the same machine's RAM. The
ring removes that hop:

- the **client** owns one ``multiprocessing.shared_memory`` segment of
  ``LO_SHM_BYTES`` (0 disables; ``1e9`` notation accepted like
  ``LO_DEVCACHE_BYTES``) and advertises its name + size on every binary
  read request (``X-Lo-Shm-Segment`` / ``X-Lo-Shm-Bytes``);
- the **server** attaches the segment (cached per name), writes the
  encoded frame into the next ring slot, and answers with three tiny
  headers (offset / length / generation) instead of the frame body;
- the client copies the frame out of the slot into ONE aligned private
  buffer (a single memcpy at memory bandwidth — no sockets, no
  chunked-transfer reassembly, no inflate) and decodes it with the v2
  zero-copy path (core/wire.py): per-column decode work is zero.

The ring is **lease-free**: slots carry a monotonically increasing
generation in a 64-byte header, the client re-reads the header after
its copy, and a mismatch (the server lapped the ring while the client
was copying — only possible when outstanding frames exceed the segment)
surfaces as :class:`ShmTornError`, upon which the caller simply
re-fetches that chunk over the plain HTTP body. Falling back is also
what happens transparently when the server cannot attach the segment
(different machine or container, segment unlinked, feature disabled
server-side): it just answers with the body, and the client never
notices beyond the bytes taking the slower road.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np

from learningorchestra_tpu_torch.core.wire import ALIGN as _ALIGN

SEGMENT_HEADER = "X-Lo-Shm-Segment"
BYTES_HEADER = "X-Lo-Shm-Bytes"
OFFSET_HEADER = "X-Lo-Shm-Offset"
LENGTH_HEADER = "X-Lo-Shm-Length"
GENERATION_HEADER = "X-Lo-Shm-Generation"

# Slot header: u32 magic, u32 pad, u64 generation, u64 payload length;
# padded to wire.ALIGN bytes so the payload starts frame-aligned (the
# mmap base is page-aligned and slot offsets are ALIGN multiples) —
# which is what lets the v2 decode treat a slot copy as an aligned
# frame. The header size is DERIVED from the wire alignment, not an
# independent constant: raising ALIGN (wider SIMD) automatically grows
# the header pad, and slot-offset rounding below uses ALIGN directly.
SLOT_MAGIC = 0x4C4F5348  # "LOSH"
_SLOT = struct.Struct("<IIQQ")
SLOT_HEADER_BYTES = _ALIGN
assert SLOT_HEADER_BYTES >= _SLOT.size


class ShmTornError(RuntimeError):
    """The server lapped the ring slot while the client was copying it
    out — re-fetch this chunk over the HTTP body."""


# A segment name is a flat shm identifier (shared_memory mints psm_*).
# The server maps it under /dev/shm, so anything path-like — separators,
# dot-relatives, empties — is rejected before any filesystem call: a
# request header must never be able to point the mmap at an arbitrary
# server-writable file.
_NAME_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9_.-]*\Z")


def valid_segment_name(name: str) -> bool:
    return bool(
        name
        and ".." not in name
        and _NAME_RE.fullmatch(name) is not None
    )


def shm_bytes() -> int:
    """``LO_SHM_BYTES`` validated: ring segment size in bytes, ``1e9``
    notation accepted (like ``LO_DEVCACHE_BYTES``); ``0`` (the default)
    disables the shared-memory transport entirely."""
    # lo: allow[LO305] this IS the validated accessor preflight calls
    raw = os.environ.get("LO_SHM_BYTES", "").strip()
    if not raw:
        return 0
    try:
        value = int(float(raw))
    except ValueError:
        raise ValueError(
            f"LO_SHM_BYTES must be a number of bytes, got {raw!r}"
        ) from None
    if value < 0:
        raise ValueError(f"LO_SHM_BYTES must be >= 0, got {value}")
    return value


class _Attachment:
    """A server-side mapping of a client-owned segment.

    On Linux this maps ``/dev/shm/<name>`` directly — deliberately NOT
    ``multiprocessing.shared_memory`` attach, which on 3.10 registers
    the segment with the attaching process's resource tracker
    (bpo-38119) and would try to unlink the client's segment at server
    exit. Elsewhere it falls back to a SharedMemory attach."""

    __slots__ = ("buf", "size", "_mmap", "_shm")

    def __init__(self, name: str):
        import mmap

        if not valid_segment_name(name):  # defense in depth: no paths
            raise ValueError(f"invalid shm segment name {name!r}")
        self._shm = None
        path = os.path.join("/dev/shm", name)
        if os.path.exists(path):
            fd = os.open(path, os.O_RDWR)
            try:
                self.size = os.fstat(fd).st_size
                self._mmap = mmap.mmap(fd, self.size)
            finally:
                os.close(fd)
            self.buf = memoryview(self._mmap)
            return
        from multiprocessing import shared_memory

        self._mmap = None
        self._shm = shared_memory.SharedMemory(name=name)
        self.size = self._shm.size
        self.buf = self._shm.buf

    def close(self) -> None:
        try:
            if self._mmap is not None:
                self.buf.release()
                self._mmap.close()
            elif self._shm is not None:
                self._shm.close()
        except Exception:  # noqa: BLE001 — best-effort unmap
            pass


def _release(shm) -> None:
    try:
        shm.close()
        shm.unlink()
    except Exception:  # noqa: BLE001 — already gone is fine
        pass


class ClientRing:
    """The client-owned segment: created once per RemoteStore, read by
    slot coordinates the server's response names, unlinked at close /
    garbage collection (``weakref.finalize``)."""

    def __init__(self, nbytes: int):
        from multiprocessing import shared_memory

        self.shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self.name = self.shm.name.lstrip("/")
        self.nbytes = nbytes
        self.frames = 0
        self.bytes = 0
        self._lock = threading.Lock()
        self._finalizer = weakref.finalize(self, _release, self.shm)

    def read(self, offset: int, length: int, generation: int) -> np.ndarray:
        """Copy one frame out of the ring into an aligned private
        buffer, verifying the slot header before AND after the copy —
        a generation mismatch means the server lapped the ring."""
        from learningorchestra_tpu_torch.core.wire import aligned_frame

        view = self.shm.buf

        def check() -> None:
            magic, _, gen, nbytes = _SLOT.unpack_from(view, offset)
            if magic != SLOT_MAGIC or gen != generation or nbytes != length:
                raise ShmTornError(
                    f"ring slot at {offset} overwritten (generation "
                    f"{gen} != {generation})"
                )

        start = offset + SLOT_HEADER_BYTES
        if start + length > self.nbytes:
            raise ShmTornError("ring slot exceeds the segment")
        check()
        frame = aligned_frame(view[start : start + length])
        check()
        with self._lock:
            self.frames += 1
            self.bytes += length
        return frame

    def stats(self) -> dict:
        with self._lock:
            return {"frames": self.frames, "bytes": self.bytes}

    def close(self) -> None:
        self._finalizer()


class _Segment:
    __slots__ = (
        "attachment", "nbytes", "lock", "offset", "generation", "closed"
    )

    def __init__(self, attachment: _Attachment, nbytes: int):
        self.attachment = attachment
        self.nbytes = nbytes
        self.lock = threading.Lock()
        self.offset = 0
        self.generation = 0
        self.closed = False


def _close_segment(segment: _Segment) -> None:
    """Release an evicted segment under ITS lock: a concurrent
    ``place`` holding the lock finishes its write first, and any later
    ``place`` sees ``closed`` and falls back to the HTTP body instead
    of writing into a released mapping."""
    with segment.lock:
        segment.closed = True
        segment.attachment.close()


class ServerRings:
    """Server-side attach cache + per-segment rolling slot allocator.

    One instance per store app. Attachments are LRU-bounded (a client
    churn of segments must not pin mmaps forever; access moves a
    segment to the back, the true-oldest evicts); a failed attach is
    negative-cached briefly by simply answering None — the route then
    falls back to the HTTP body."""

    MAX_SEGMENTS = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._segments: "OrderedDict[str, _Segment]" = OrderedDict()

    def _segment(self, name: str, nbytes: int) -> Optional[_Segment]:
        with self._lock:
            segment = self._segments.get(name)
            if segment is not None:
                self._segments.move_to_end(name)  # LRU touch
                return segment
        try:
            attachment = _Attachment(name)
        except Exception:  # noqa: BLE001 — not co-located / gone: fallback
            return None
        if attachment.size < nbytes:
            # the client lied about (or resized) its segment — refuse
            attachment.close()
            return None
        segment = _Segment(attachment, nbytes)
        evicted: list[_Segment] = []
        with self._lock:
            if name in self._segments:
                self._segments.move_to_end(name)
                existing = self._segments[name]
            else:
                existing = None
                while len(self._segments) >= self.MAX_SEGMENTS:
                    _, oldest = self._segments.popitem(last=False)
                    evicted.append(oldest)
                self._segments[name] = segment
        # closes run OUTSIDE the cache lock (each takes its segment's
        # own lock; no handler path holds a segment lock while taking
        # the cache lock, so the order cannot invert)
        if existing is not None:
            attachment.close()
        for oldest in evicted:
            _close_segment(oldest)
        return existing if existing is not None else segment

    def place(
        self, name: str, nbytes: int, frame: bytes
    ) -> Optional[tuple[int, int, int]]:
        """Write ``frame`` into the next ring slot of segment ``name``;
        returns ``(offset, length, generation)`` or None when the frame
        cannot ride the ring (attach failed or evicted mid-flight,
        frame too large, path-shaped segment name)."""
        need = SLOT_HEADER_BYTES + len(frame)
        if nbytes <= 0 or need > nbytes or not valid_segment_name(name):
            return None
        segment = self._segment(name, nbytes)
        if segment is None:
            return None
        with segment.lock:
            if segment.closed:  # evicted between lookup and write
                return None
            offset = segment.offset
            if offset + need > segment.nbytes:
                offset = 0  # wrap: the remainder can't hold the slot
            segment.generation += 1
            generation = segment.generation
            view = segment.attachment.buf
            _SLOT.pack_into(
                view, offset, SLOT_MAGIC, 0, generation, len(frame)
            )
            view[
                offset + SLOT_HEADER_BYTES : offset
                + SLOT_HEADER_BYTES
                + len(frame)
            ] = frame
            # advance to the next ALIGN boundary past this slot (the
            # alignment the v2 zero-copy decode relies on)
            segment.offset = (
                (offset + need + _ALIGN - 1) // _ALIGN * _ALIGN
            )
        return offset, len(frame), generation

    def close(self) -> None:
        with self._lock:
            segments = list(self._segments.values())
            self._segments.clear()
        for segment in segments:
            _close_segment(segment)
