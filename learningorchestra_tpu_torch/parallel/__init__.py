"""Row padding shared by the batched fits (and, later, the multi-GPU fits).

Counterpart of ``learningorchestra_tpu/parallel/``: so far only
``sharding.padded_row_count`` and ``sharding.pad_rows``.
"""
