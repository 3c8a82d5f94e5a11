"""Core: the document store, columnar tables, ingest and jobs.

``columns.py``, ``store.py`` and ``jobs.py`` are copies of the JAX
package's modules of the same names with only their imports rewritten;
``table.py`` and ``ingest.py`` parse CSVs with the reference's Python
path; ``devcache.py`` holds uncached dataset readers.
"""

from learningorchestra_tpu_torch.core.store import (  # noqa: F401
    METADATA_ID,
    ROW_ID,
    DocumentStore,
    InMemoryStore,
    global_store,
)
