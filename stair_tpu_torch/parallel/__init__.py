"""Data-parallel ranks and the placement rules (port of
``stair_tpu/parallel/``)."""

from stair_tpu_torch.parallel.mesh import (  # noqa: F401
    REPLICATED_BATCH_KEYS,
    DataParallel,
    launch,
    llm_param_sharding,
    param_sharding,
    plan,
    shard_batch,
    use_data_parallel,
)
