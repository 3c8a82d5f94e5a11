"""Parallelism: the ``(data, model)`` mesh of ranks, row blocks, several processes.

Counterpart of ``learningorchestra_tpu/parallel/``: rows of a dataset go
in blocks over the ``data`` axis of ``torch.distributed`` ranks (one
process a rank), the way the reference shards them over a JAX mesh, and
the sums that cross blocks are gathered and added in rank order; lr's
classes and rf's trees go in shards over the ``model`` axis. The
reference's ``NamedSharding`` helpers (``row_sharded``, ``replicated``)
have no counterpart: a rank holds its block (:func:`shard_rows`) or a
replicated tensor (:func:`put_replicated`). Every fit takes a mesh (lr,
nb, dt, rf, gb), a fitted model's forward and metrics run over its ranks,
and so do the builder's ``train_one`` and ``build_model``, PCA and t-SNE.
``spmd.py`` dispatches a job the coordinator (rank 0) accepts to every
rank: the runner's multi-host mode (services/runner.py).
"""

from learningorchestra_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_size,
    default_mesh,
    grid,
    make_mesh,
    model_size,
    over_model,
    over_ranks,
)
from learningorchestra_tpu_torch.parallel.sharding import (  # noqa: F401
    bucket_rows,
    pad_rows,
    padded_row_count,
    policy_dtype,
    put_replicated,
    shard_rows,
)
from learningorchestra_tpu_torch.parallel.multihost import (  # noqa: F401
    all_sum,
    fetch,
    gather_rows,
    host_row_range,
    initialize_from_env,
    model_all_gather,
    model_all_sum,
    shard_rows_local,
)
from learningorchestra_tpu_torch.parallel.spmd import (  # noqa: F401
    SpmdDispatcher,
    SpmdJobError,
    SpmdRuntimePoisonedError,
    SpmdTimeoutError,
)
