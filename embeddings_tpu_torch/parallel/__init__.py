"""Parallelism of the PyTorch port: data and Megatron tensor parallelism
(a ("data", "model") mesh, ``make_mesh``; ``shard_params``,
``make_sharded_forward``), context parallelism (a ("data", "seq") mesh,
``make_mesh_cp``; ``make_cp_forward``), and several processes on
``torch.distributed`` (``initialize_distributed``, ``auto_initialize``;
``distributed_encode_batch``, ``process_shard``; meshes whose axes cross
processes, from ``global_devices``)."""

from .context import SEQ_AXIS, make_cp_forward, make_mesh_cp
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, ProcessDevice,
                   global_devices, initialize_distributed, make_mesh)
from .multihost import (auto_initialize, distributed_encode_batch,
                        process_shard)
from .sharding import (ModelAxis, ShardedParams, adapt_packed_params,
                       make_sharded_forward, make_sharded_packed_forward,
                       param_pspecs, shard_params)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh", "ModelAxis",
           "ProcessDevice", "ShardedParams", "adapt_packed_params",
           "auto_initialize", "distributed_encode_batch", "global_devices",
           "initialize_distributed", "make_mesh", "make_mesh_cp",
           "make_cp_forward", "make_sharded_forward",
           "make_sharded_packed_forward", "param_pspecs", "process_shard",
           "shard_params"]
