"""Embedding → scatter-plot PNG pipeline shared by the PCA and t-SNE
services.

Counterpart of ``learningorchestra_tpu/ops/images.py``: load the dataset,
drop rows with a missing value, label-encode string columns (sorted
vocabulary, as sklearn's LabelEncoder), embed to 2-D on the card
(``ops/pca.py``, ``ops/tsne.py``), and save ``<name>.png`` into the
images folder, coloured by the label column when one is given.

The plot: the reference draws it with seaborn and matplotlib, which the
card's machine does not have. Here numpy rasterises the points onto an
RGB canvas (matplotlib's default 640 × 480), a colour a hue value from a
fixed palette (seaborn's default ten colours), and ``zlib`` and
``struct`` write the PNG. The embedding is what the port holds equal to
the reference; the pixels are its own.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Optional

import numpy as np

from learningorchestra_tpu_torch.core.devcache import dataset_embedding_inputs
from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.device import DeviceLike
from learningorchestra_tpu_torch.ops.pca import pca_embedding
from learningorchestra_tpu_torch.ops.tsne import tsne_embedding
from learningorchestra_tpu_torch.utils.paths import safe_filename

IMAGE_FORMAT = ".png"

EMBEDDINGS: dict[str, Callable] = {
    "pca": pca_embedding,
    "tsne": tsne_embedding,
}

WIDTH, HEIGHT = 640, 480
MARGIN = 40      # pixels around the plot's frame
POINT = 2        # a point is a (2·POINT + 1)-pixel square
# seaborn's default "deep" palette, as 8-bit RGB
PALETTE = np.array(
    [
        (76, 114, 176), (221, 132, 82), (85, 168, 104), (196, 78, 82),
        (129, 114, 179), (147, 120, 96), (218, 139, 195), (140, 140, 140),
        (204, 185, 116), (100, 181, 205),
    ],
    dtype=np.uint8,
)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def png_bytes(canvas: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of the ``(height, width, 3)`` uint8 ``canvas``."""
    height, width, _ = canvas.shape
    # each scanline starts with its filter type, 0 (none)
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), canvas.reshape(height, width * 3)], axis=1
    )
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", header)
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def _scatter_canvas(embedded: np.ndarray, hue: Optional[np.ndarray]) -> np.ndarray:
    """The points of ``embedded`` (rows, 2) drawn in row order on a white
    canvas inside a black frame; with ``hue``, a colour for each distinct
    value, in sorted order."""
    canvas = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    left, top, right, bottom = MARGIN, MARGIN, WIDTH - MARGIN, HEIGHT - MARGIN
    canvas[top, left : right + 1] = canvas[bottom, left : right + 1] = 0
    canvas[top : bottom + 1, left] = canvas[top : bottom + 1, right] = 0
    points = np.asarray(embedded, np.float64)
    finite = np.isfinite(points).all(axis=1)
    if hue is None:
        colours = np.zeros(len(points), np.int64)
    else:
        _, colours = np.unique(np.asarray(hue), return_inverse=True)
        colours = colours.reshape(-1) % len(PALETTE)
    points, colours = points[finite], colours[finite]
    if len(points) == 0:
        return canvas
    low, high = points.min(axis=0), points.max(axis=0)
    span = np.where(high > low, high - low, 1.0)
    inner = np.array([right - left, bottom - top]) - 2 * (POINT + 2)
    scaled = (points - low) / span * inner
    x = (left + POINT + 2 + np.rint(scaled[:, 0])).astype(np.int64)
    y = (bottom - POINT - 2 - np.rint(scaled[:, 1])).astype(np.int64)
    for dy in range(-POINT, POINT + 1):
        for dx in range(-POINT, POINT + 1):
            canvas[y + dy, x + dx] = PALETTE[colours]
    return canvas


def _scatter_png(embedded: np.ndarray, hue: Optional[np.ndarray], image_path: str) -> None:
    with open(image_path, "wb") as handle:
        handle.write(png_bytes(_scatter_canvas(embedded, hue)))


def create_embedding_image(
    store: DocumentStore,
    parent_filename: str,
    label_name: Optional[str],
    output_filename: str,
    images_path: str,
    method: str,
    device: DeviceLike = None,
    render: bool = True,
    mesh=None,
) -> str:
    """Embed ``parent_filename`` with ``method`` ("pca" or "tsne") on the
    card and write ``<images_path>/<output_filename>.png``. Returns the
    image path.

    ``mesh``: the data ranks to embed over (its device replaces
    ``device``; every rank calls this with the same arguments and gets
    the same embedding, ``ops/pca.py``, ``ops/tsne.py``). ``render=False``
    runs the embedding, whose collectives every rank must enter, and
    writes no PNG: the runner's SPMD workers pass it, so only the
    coordinator touches the images folder (parallel/spmd.py)."""
    if not safe_filename(output_filename):
        raise ValueError(f"unsafe image filename {output_filename!r}")
    embed = EMBEDDINGS[method]
    # an embedding registered without a ``mesh`` keyword still serves one card
    over = {} if mesh is None else {"mesh": mesh}
    if mesh is not None:
        device = mesh.device
    # one read: the hue labels always match the embedded rows
    encoded, _, X = dataset_embedding_inputs(store, parent_filename, device)
    embedded = embed(X, device=X.device, **over)
    image_path = os.path.join(images_path, output_filename + IMAGE_FORMAT)
    if render:
        hue = None
        if label_name is not None:
            hue = np.asarray(encoded.columns[label_name])
        os.makedirs(images_path, exist_ok=True)
        _scatter_png(embedded, hue, image_path)
    return image_path
