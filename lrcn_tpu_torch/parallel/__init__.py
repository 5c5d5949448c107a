"""Multi-device runs: the device mesh, batch-sharded decoding, data x
vocabulary-parallel and pipelined training over ``torch.distributed``
(counterpart of ``lrcn_tpu/parallel``)."""

from lrcn_tpu_torch.parallel.mesh import make_mesh, mesh_from_config
from lrcn_tpu_torch.parallel.pipeline import (
    PipelinedTrainStep,
    from_pipeline_params,
    to_pipeline_params,
)
from lrcn_tpu_torch.parallel.train import (
    ShardedTrainStep,
    batch_sharding,
    param_sharding,
    shard_params,
)

__all__ = [
    "make_mesh",
    "mesh_from_config",
    "ShardedTrainStep",
    "PipelinedTrainStep",
    "to_pipeline_params",
    "from_pipeline_params",
    "batch_sharding",
    "param_sharding",
    "shard_params",
]
