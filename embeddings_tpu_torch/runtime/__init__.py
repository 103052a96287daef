"""Runtime of the PyTorch port: batch planning and token packing, the
Engine, the batching service with its TCP and HTTP front-ends, and the
clients."""

from .batching import BatchPlan, pad_batch, pick_bucket, plan_batches
from .engine import Engine, load_model

__all__ = ["Engine", "load_model", "BatchPlan", "pad_batch", "pick_bucket",
           "plan_batches"]
