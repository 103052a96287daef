"""Parallelism of the PyTorch port: context parallelism (a ("data",
"seq") mesh; ``make_cp_forward``). Data and tensor parallelism and the
multi-host helpers of the JAX package are not ported yet."""

from .context import SEQ_AXIS, make_cp_forward, make_mesh_cp
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh", "make_mesh_cp",
           "make_cp_forward"]
