"""Meshes of processes and the sharded attention ops (port of
``cvd_tpu/parallel``): SPMD over ``torchrun``'s processes."""
from cvd_tpu_torch.parallel.mesh import (
    Mesh,
    constrain,
    create_mesh,
    gather,
    inference_mesh,
    inference_shape,
    init_distributed,
    process_group,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = ["Mesh", "constrain", "create_mesh", "gather", "inference_mesh", "inference_shape",
           "init_distributed", "process_group", "replicate", "shard_batch", "shard_params"]
