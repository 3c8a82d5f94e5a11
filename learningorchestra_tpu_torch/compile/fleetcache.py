"""The fleet's shared kernel libraries: the ``__lo_executables__``
collection.

Counterpart of ``learningorchestra_tpu/compile/fleetcache.py:49-189``,
whole: the same collection, layout, trust rules and rev guard. The
reference moves serialized XLA executables out of its persistent cache
folder; the port moves the kernel libraries out of its build folder
(``kernels.build_dir()``: ``LO_JIT_CACHE``, else ``kernels/_build/``).
A runner that built them (its boot pass, compile/aot.py) uploads them; a
runner joining the fleet with an empty build folder (a new machine, or a
restart after kill -9) pulls them in before its first request and runs
``nvcc`` zero times. A miss falls through to a local build that is then
published, so the plane is never load-bearing: an empty or unreachable
collection means a cold boot.

Wire shape: each library becomes chunk rows ``{artifact, seq, data
(base64)}`` of 1 MiB of raw bytes, plus ONE meta row ``{artifact, meta:
1, chunks, size, sha256, fingerprint}`` written LAST, so a reader never
sees an artifact whose chunks are not all there. Their ``_id`` is the
artifact's name with ``#<seq>`` or ``#meta``: two members publishing one
library at once cannot both land, the one that comes second is refused
(the store's duplicate ``_id``) and skips it.

Trust: loading a library executes its code (``ctypes.CDLL`` runs its
initializers), so the meta row's ``fingerprint`` (compile/aot.py's
envelope: nvcc, torch, CUDA, the card, the flags, every source's digest)
and the chunks' sha256 are the trust boundary. A meta row whose
fingerprint differs from this process's is DISCARDED on the meta row
alone: its payload is never decoded, written or loaded, and the library
is built here. A chunk set that fails its sha256 is discarded the same
way, before anything is written; a library lands in the build folder by
a temporary file and ``os.replace`` only after its digest matched. A
name that would leave the build folder is refused. The store itself is
trusted: whoever can write it can forge a fingerprint. Rev-guarded:
:func:`fetch` is a no-op while the collection's rev has not moved since
this process last looked.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading

COLLECTION = "__lo_executables__"

# 1 MiB of raw bytes a chunk row (~1.37 MiB of base64): a library takes a
# handful of rows, each small enough for the store's per-document handling
CHUNK_BYTES = 1 << 20
# chunk rows a request: keeps one insert well under the web loop's
# buffered-bytes cap whatever a library's size
CHUNKS_A_REQUEST = 8

# fetch() no-op guard: the collection rev seen per store object
_REV_SEEN: dict[int, int] = {}
_REV_LOCK = threading.Lock()


def _fingerprint_json() -> str:
    from learningorchestra_tpu_torch.compile.aot import backend_fingerprint

    return json.dumps(backend_fingerprint(), sort_keys=True)


def _metrics():
    from learningorchestra_tpu_torch.compile.aot import _aot_metrics

    return _aot_metrics()


def _partial(name: str) -> bool:
    """A file another writer is still writing (``kernels.build``'s and
    :func:`fetch`'s temporary names)."""
    return name.endswith(".tmp")


def _published_artifacts(store) -> set[str]:
    return {doc["artifact"] for doc in store.find(COLLECTION, {"meta": 1}) if "artifact" in doc}


def publish(store, cache_dir: str) -> dict:
    """Upload every library in ``cache_dir`` the collection does not
    already hold. Returns ``{"published": n, "skipped": m}``."""
    stats = {"published": 0, "skipped": 0}
    if not os.path.isdir(cache_dir):
        return stats
    try:
        existing = _published_artifacts(store)
    except Exception:  # unreachable store: cold-boot semantics
        return stats
    fingerprint = _fingerprint_json()
    for entry in sorted(os.listdir(cache_dir)):
        path = os.path.join(cache_dir, entry)
        if not os.path.isfile(path) or _partial(entry):
            continue
        if entry in existing:
            stats["skipped"] += 1
            continue
        with open(path, "rb") as handle:
            blob = handle.read()
        digest = hashlib.sha256(blob).hexdigest()
        rows = [
            {
                "_id": f"{entry}#{seq}",
                "artifact": entry,
                "seq": seq,
                "data": base64.b64encode(blob[offset:offset + CHUNK_BYTES]).decode("ascii"),
            }
            for seq, offset in enumerate(range(0, len(blob), CHUNK_BYTES))
        ] or [{"_id": f"{entry}#0", "artifact": entry, "seq": 0, "data": ""}]
        try:
            for first in range(0, len(rows), CHUNKS_A_REQUEST):
                store.insert_many(COLLECTION, rows[first:first + CHUNKS_A_REQUEST])
            # meta row LAST: its presence means every chunk landed
            store.insert_one(COLLECTION, {
                "_id": f"{entry}#meta",
                "artifact": entry,
                "meta": 1,
                "chunks": len(rows),
                "size": len(blob),
                "sha256": digest,
                "fingerprint": fingerprint,
            })
        except Exception:
            # another member's copy landed first, or the store went away:
            # without this meta row the artifact is invisible
            stats["skipped"] += 1
            continue
        stats["published"] += 1
        _metrics()["published"].inc()
    return stats


def _safe_name(name) -> bool:
    return (
        isinstance(name, str)
        and name not in ("", ".", "..")
        and os.sep not in name
        and (os.altsep is None or os.altsep not in name)
        and "/" not in name
        and "\0" not in name
        and not _partial(name)
    )


def fetch(store, cache_dir: str, force: bool = False) -> dict:
    """Pull the fleet's libraries ``cache_dir`` lacks. Returns
    ``{"fetched": n, "discarded": d, "skipped": s}``; a no-op (all
    zeros) while the collection rev has not moved."""
    stats = {"fetched": 0, "discarded": 0, "skipped": 0}
    try:
        rev = store.collection_rev(COLLECTION)
    except Exception:
        return stats
    with _REV_LOCK:
        if not force and _REV_SEEN.get(id(store)) == rev:
            return stats
    os.makedirs(cache_dir, exist_ok=True)
    local_fingerprint = _fingerprint_json()
    try:
        metas = [doc for doc in store.find(COLLECTION, {"meta": 1}) if "artifact" in doc]
    except Exception:
        return stats
    for meta in metas:
        name = meta["artifact"]
        if not _safe_name(name):
            stats["discarded"] += 1  # a path-traversal row is hostile,
            _metrics()["discarded"].inc()  # not merely stale
            continue
        path = os.path.join(cache_dir, name)
        if os.path.exists(path):
            stats["skipped"] += 1
            continue
        if meta.get("fingerprint") != local_fingerprint:
            # another envelope: discarded WITHOUT decoding its payload; the
            # library is built here and published under this fingerprint
            stats["discarded"] += 1
            _metrics()["discarded"].inc()
            continue
        chunks = sorted(
            (doc for doc in store.find(COLLECTION, {"artifact": name}) if "data" in doc),
            key=lambda doc: doc.get("seq", 0),
        )
        try:
            blob = b"".join(base64.b64decode(doc["data"]) for doc in chunks)
        except Exception:
            blob = None
        if (
            blob is None
            or len(chunks) != meta.get("chunks")
            or hashlib.sha256(blob).hexdigest() != meta.get("sha256")
        ):
            stats["discarded"] += 1  # corrupt payload: built here instead
            _metrics()["discarded"].inc()
            continue
        partial = f"{path}.{os.getpid()}.{threading.get_ident()}.fetch.tmp"
        with open(partial, "wb") as handle:
            handle.write(blob)
        os.replace(partial, path)  # atomic: a loader never reads half a library
        stats["fetched"] += 1
        _metrics()["fetched"].inc()
    with _REV_LOCK:
        _REV_SEEN[id(store)] = rev
    return stats
