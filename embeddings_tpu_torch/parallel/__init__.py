"""Parallelism of the PyTorch port: data and Megatron tensor parallelism
(a ("data", "model") mesh, ``make_mesh``; ``shard_params``,
``make_sharded_forward``) and context parallelism (a ("data", "seq")
mesh, ``make_mesh_cp``; ``make_cp_forward``). The multi-host helpers of
the JAX package are not ported yet."""

from .context import SEQ_AXIS, make_cp_forward, make_mesh_cp
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh
from .sharding import (ModelAxis, ShardedParams, adapt_packed_params,
                       make_sharded_forward, make_sharded_packed_forward,
                       param_pspecs, shard_params)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh", "ModelAxis",
           "ShardedParams", "adapt_packed_params", "make_mesh",
           "make_mesh_cp", "make_cp_forward", "make_sharded_forward",
           "make_sharded_packed_forward", "param_pspecs", "shard_params"]
