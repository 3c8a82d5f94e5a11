"""Core: the document store and columnar tables.

``columns.py`` and ``store.py`` are copies of the JAX package's modules of
the same names with only their imports rewritten; ``table.py`` is its
``table.py`` less the CSV loader; ``devcache.py`` holds the two dataset
readers the image lane needs, uncached.
"""

from learningorchestra_tpu_torch.core.store import (  # noqa: F401
    METADATA_ID,
    ROW_ID,
    DocumentStore,
    InMemoryStore,
    global_store,
)
