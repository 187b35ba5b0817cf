"""Process-group parallelism helpers (counterpart of
``sdfest_tpu/parallel``)."""
from sdfest_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    data_parallel_step,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
    shard_map_data_parallel_step,
)
