"""The image lane's dataset readers: the port's counterparts of
``dataset_table`` and ``dataset_embedding_inputs`` in the JAX package's
``core/devcache.py``.

Uncached: each call reads the collection from the store and, for the
embedding inputs, copies its matrix to the device once. The rev-keyed
device cache of the reference (the rest of its ``core/devcache.py``) is
a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.core.table import ColumnTable
from learningorchestra_tpu_torch.device import DeviceLike, policy_dtype, resolve_device


def dataset_table(store: DocumentStore, collection: str, fields=None) -> ColumnTable:
    """The collection as a :class:`ColumnTable` (one bulk columnar read)."""
    return ColumnTable.from_store(store, collection, fields)


def dataset_embedding_inputs(
    store: DocumentStore, collection: str, device: DeviceLike = None
) -> tuple:
    """``(encoded_table, vocabularies, X)``, the PCA and t-SNE image
    pipeline's inputs, all from one read: the table less its rows with a
    missing value, its string columns label-encoded in sorted-vocabulary
    order, and ``X``, the whole encoded table (label column included, as
    in the reference) as a float32 ``(rows, fields)`` tensor on the
    device."""
    device = resolve_device(device)
    table = dataset_table(store, collection).dropna()
    encoded, vocabularies = table.encoded()
    X = np.ascontiguousarray(encoded.matrix(), dtype=np.float32)
    return encoded, vocabularies, torch.from_numpy(X).to(device, policy_dtype())
