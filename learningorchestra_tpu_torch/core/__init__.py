"""Core: the document store, columnar tables, ingest and jobs.

``columns.py``, ``store.py``, ``jobs.py``, ``wire.py`` and ``shmring.py``
are copies of the JAX package's modules of the same names with only their
imports rewritten; ``table.py`` and ``ingest.py`` parse CSVs with the
reference's Python path; ``devcache.py`` is the rev-keyed and
content-addressed device cache; ``store_service.py`` and ``arbiter.py``
are the networked store (a store server with WAL replication and quorum
failover, and ``RemoteStore``, its client on the standard library).
"""

from learningorchestra_tpu_torch.core.store import (  # noqa: F401
    METADATA_ID,
    ROW_ID,
    DocumentStore,
    InMemoryStore,
    global_store,
)
