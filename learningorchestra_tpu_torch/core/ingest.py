"""CSV dataset ingestion: URL → document store.

Reference behaviour (microservices/database_api_image/database.py:134-216):
a 3-thread pipeline (download → row-to-dict → per-row ``insert_one``)
guarded by a first-line sniff that rejects HTML/JSON bodies; metadata is
written up front with ``finished: false`` and flipped when the save thread
drains. Values are stored as raw strings — type conversion is a separate
service.

This implementation keeps the observable contract (metadata shape,
``finished`` flag, string values, 201-then-poll asynchrony) but streams
into *batched* ``insert_many`` calls instead of one RPC per row, and
supports ``file://``/local paths so tests need no network.

The port's copy of ``learningorchestra_tpu/core/ingest.py``, with one
difference: http(s) bodies are read with ``urllib`` (the reference uses
``requests``, which the card's machine lacks).
"""

from __future__ import annotations

import csv
import http.client
import io
import os
import shutil
import tempfile
import urllib.request
from contextlib import ExitStack
from datetime import datetime, timezone
from typing import Iterator, Optional, TextIO

from learningorchestra_tpu_torch.core.store import METADATA_ID, ROW_ID, DocumentStore

INVALID_URL = "invalid_url"
DUPLICATE_FILE = "duplicate_file"
FINISHED = "finished"
BATCH_SIZE = 4096

# Files beyond this parse as a sequence of slabs so ingest's transient
# working set stays bounded (the whole-file native parse holds file
# bytes + cell index in anonymous RAM — ~2x file size — which a 12 GB
# CSV cannot afford on an out-of-core store). 0 disables slabbing.
_SLAB_BYTES = int(float(os.environ.get("LO_INGEST_SLAB_BYTES", "536870912") or 0))


class IngestError(Exception):
    pass


def _open_text(url: str, stack: ExitStack) -> TextIO:
    """A text stream over an http(s) URL, file:// URL or local path.

    Returns a real character stream (not pre-split lines) so the csv
    parser sees quoted embedded newlines intact.
    """
    if url.startswith(("http://", "https://")):
        # urlopen raises HTTPError on a status >= 400, as raise_for_status
        response = stack.enter_context(urllib.request.urlopen(url))
        return stack.enter_context(
            io.TextIOWrapper(response, encoding="utf-8", newline="")
        )
    path = url[len("file://") :] if url.startswith("file://") else url
    return stack.enter_context(open(path, encoding="utf-8", newline=""))


def _csv_rows(stream: TextIO) -> Iterator[list[str]]:
    return iter(csv.reader(stream, delimiter=",", quotechar='"'))


def validate_csv_url(url: str) -> list[str]:
    """Sniff the header row; reject HTML/JSON bodies.

    Mirrors the reference's first-character check (reference:
    database.py:183-197). Returns the header row.
    """
    try:
        with ExitStack() as stack:
            header = next(_csv_rows(_open_text(url, stack)))
    # urllib's errors are OSErrors; a malformed status line is not
    except (OSError, http.client.HTTPException, StopIteration) as error:
        raise IngestError(INVALID_URL) from error
    if not header or not header[0] or header[0][0] in ("<", "{"):
        raise IngestError(INVALID_URL)
    return header


def timestamp() -> str:
    """UTC timestamp in the reference's metadata format (reference:
    database.py:201-204)."""
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S-00:00")


def write_ingest_metadata(store: DocumentStore, filename: str, url: str) -> None:
    """The up-front ``finished: false`` metadata document (reference:
    database.py:205-213). Raises KeyError on duplicate collection.

    The duplicate gate is the same atomic ``create_collection`` claim the
    create routes use, so an ingest can never share a collection with a
    concurrently created projection/histogram output."""
    if not store.create_collection(filename):
        raise KeyError(f"collection {filename!r} already exists")
    store.insert_one(
        filename,
        {
            "filename": filename,
            "url": url,
            "time_created": timestamp(),
            ROW_ID: METADATA_ID,
            FINISHED: False,
            "fields": "processing",
        },
    )


def _local_csv_path(url: str, stack: ExitStack) -> str:
    """A local filesystem path for ``url``, downloading http(s) bodies to
    a temp file (deleted when ``stack`` closes). The columnar parsers —
    native C++ and Python alike — work from a file."""
    if not url.startswith(("http://", "https://")):
        return url[len("file://") :] if url.startswith("file://") else url
    response = stack.enter_context(urllib.request.urlopen(url))
    handle = stack.enter_context(
        tempfile.NamedTemporaryFile(suffix=".csv", delete=True)
    )
    shutil.copyfileobj(response, handle, 1 << 20)
    handle.flush()
    return handle.name


def _python_raw_columns(path: str) -> tuple[list[str], list[list[str]]]:
    """Python fallback for :func:`native.loader.read_csv_raw_columns`:
    same raw-string contract, tolerant of ragged rows (short rows pad
    with ``""``, oversized rows truncate to the header width)."""
    with open(path, encoding="utf-8", newline="") as handle:
        reader = _csv_rows(handle)
        header = next(reader)
        width = len(header)
        columns: list[list[str]] = [[] for _ in range(width)]
        for row in reader:
            if not row:
                continue
            for i in range(width):
                columns[i].append(row[i] if i < len(row) else "")
    return header, columns


def ingest_csv(
    store: DocumentStore,
    filename: str,
    url: str,
    batch_size: Optional[int] = None,
) -> int:
    """Ingest the CSV at ``url`` into collection ``filename``,
    column-major.

    Observable contract unchanged from the reference (rows are documents
    ``{header[i]: value, _id: 1..N}``, values kept as raw strings, type
    conversion is the fieldtypes service's job, metadata flips to
    ``finished: true`` with the field list at the end — reference:
    microservices/database_api_image/database.py:144-216) — but the body
    lands as the store's columnar block via batched ``insert_columns``:
    the native C++ parser (native/csv_loader.cpp) feeds column lists
    straight in, and no per-row Python dict is ever built. Returns the
    row count.

    Memory model: the dataset body is resident in the store regardless
    (that is what an in-memory store is); ingest transiently holds a
    second copy (the parse result) before the batched hand-off, so peak
    is ~2× the body — same order as the reference's Mongo working set.
    """
    from learningorchestra_tpu_torch.native.loader import read_csv_string_columns

    with ExitStack() as stack:
        path = _local_csv_path(url, stack)
        if _SLAB_BYTES and os.path.getsize(path) > _SLAB_BYTES:
            num_rows, file_header = _ingest_slabbed(
                store, filename, path, batch_size
            )
        else:
            # Native path: NUL-joined column buffers → Arrow string
            # columns, no Python string objects between the parser and
            # the store.
            parsed = read_csv_string_columns(path)
            if parsed is None:
                parsed = _python_raw_columns(path)
            file_header, raw_columns = parsed
            num_rows = _insert_parsed(
                store, filename, file_header, raw_columns, 1, batch_size
            )

    store.update_one(
        filename,
        {ROW_ID: METADATA_ID},
        {FINISHED: True, "fields": file_header},
    )
    return num_rows


def _insert_parsed(
    store, filename, file_header, raw_columns, start_id, batch_size
) -> int:
    """Batched columnar hand-off of one parse result.

    Duplicate header names collapse last-wins, as the reference's
    per-row dict build did (database.py:156-169); a CSV column named
    `_id` is discarded the same way the reference's row ids overwrote
    it (database.py:161-168) — row ids are always 1..N."""
    from learningorchestra_tpu_torch.core.table import insert_columns_batched

    columns = dict(zip(file_header, raw_columns))
    columns.pop(ROW_ID, None)
    num_rows = len(raw_columns[0]) if raw_columns else 0
    insert_columns_batched(
        store, filename, columns, start_id=start_id, batch_size=batch_size
    )
    return num_rows


def _ingest_slabbed(
    store, filename, path, batch_size
) -> tuple[int, list[str]]:
    """Parse + insert a big CSV one ~slab at a time so the transient
    working set is slab-sized, not file-sized — with the store spilling
    past its RAM budget, total ingest memory stays bounded at any file
    size (the Mongo-owns-disk ingestion story). Slab boundaries land
    only on lines with balanced quotes, so quoted embedded newlines
    never split across parses."""
    from learningorchestra_tpu_torch.native.loader import read_csv_string_columns

    total_rows = 0
    file_header: list[str] = []
    with open(path, encoding="utf-8", newline="") as source:
        header_line = source.readline()
        file_header = next(_csv_rows(io.StringIO(header_line)))
        while True:
            # stream lines STRAIGHT into the slab temp file — holding
            # them in a list first would cost per-str object overhead
            # several times the nominal slab size for short rows
            slab_bytes = 0
            slab_lines = 0
            open_quotes = False
            # slab next to the source file, NOT the default tempdir: on
            # hosts where /tmp is tmpfs a 0.5-2 GB slab would be
            # RAM-backed — the exact cost slabbing exists to avoid
            try:
                slab_handle = tempfile.NamedTemporaryFile(
                    "w",
                    suffix=".csv",
                    delete=False,
                    encoding="utf-8",
                    newline="",
                    dir=os.path.dirname(os.path.abspath(path)) or None,
                )
            except OSError:  # source dir unwritable: default tempdir
                slab_handle = tempfile.NamedTemporaryFile(
                    "w",
                    suffix=".csv",
                    delete=False,
                    encoding="utf-8",
                    newline="",
                )
            with slab_handle as slab:
                slab.write(header_line)
                slab_path = slab.name
                for line in source:
                    slab.write(line)
                    slab_lines += 1
                    if line.count('"') % 2:
                        open_quotes = not open_quotes
                    slab_bytes += len(line)
                    if slab_bytes >= _SLAB_BYTES and (
                        not open_quotes
                        # hard cap: a stray quote in an unquoted field
                        # (legal for csv.reader, e.g. inch marks) would
                        # otherwise pin open_quotes and buffer the rest
                        # of the file into one slab. Files quoted to
                        # RFC-4180 never hit this; a mis-quoted file
                        # splits where a line-based reader would.
                        or slab_bytes >= 4 * _SLAB_BYTES
                    ):
                        break
            if not slab_lines:
                os.unlink(slab_path)
                break
            try:
                parsed = read_csv_string_columns(slab_path)
                if parsed is None:
                    parsed = _python_raw_columns(slab_path)
            finally:
                os.unlink(slab_path)
            slab_header, raw_columns = parsed
            total_rows += _insert_parsed(
                store,
                filename,
                slab_header,
                raw_columns,
                total_rows + 1,
                batch_size,
            )
            del parsed, raw_columns
    return total_rows, file_header
