"""Multi-process support of the PyTorch port — the port of
``embeddings_tpu/parallel/multihost.py``: ``torch.distributed`` bring-up
(``auto_initialize``), a process's contiguous share of a list
(``process_shard``), and a data-parallel batch encode across processes
(``distributed_encode_batch``): each process tokenizes and encodes its
own shard of the corpus with its local Engine, and the results are
exchanged with one all_gather of host tensors over gloo at the end (the
JAX package's ``process_allgather``, a host exchange too).

Serving deployments run one Engine replica per process behind a load
balancer (data parallelism needs no lockstep); this module is for
offline batch jobs where one logical call should use every process. A
mesh whose axes cross processes (``parallel.mesh.global_devices``) runs
one forward across them instead.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import initialize_distributed, world

log = logging.getLogger("embeddings_tpu_torch.multihost")


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def auto_initialize(coordinator: str | None = None,
                    num_processes: int | None = None,
                    process_id: int | None = None) -> bool:
    """Bring up ``torch.distributed`` if this looks like a multi-process
    job.

    Resolution order, each setting on its own: explicit args >
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID (the JAX
    package's variables, so one launcher drives both packages) >
    torchrun's MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK (in place of
    the JAX package's TPU pod autodetection, which has no GPU
    counterpart). Returns True if the job is multi-process. A second call
    is a no-op."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None:
        coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if num_processes is None or num_processes <= 1:
        return False
    initialize_distributed(coordinator, num_processes, process_id)
    log.info("torch.distributed up: process %d/%d", dist.get_rank(),
             dist.get_world_size())
    return True


def process_shard(n: int, *, count: int | None = None,
                  index: int | None = None) -> slice:
    """This process's contiguous slice of n items (balanced, first shards
    get the remainder). ``count`` / ``index`` default to the process
    count and rank (1 / 0 before ``torch.distributed`` is up)."""
    n_proc, rank = world()
    count = count if count is not None else n_proc
    index = index if index is not None else rank
    base, rem = divmod(n, count)
    start = index * base + min(index, rem)
    return slice(start, start + base + (1 if index < rem else 0))


def distributed_encode_batch(engine, texts: Sequence[str],
                             batch_size: int | None = None) -> np.ndarray:
    """Encode a global text list across all processes.

    Every process must call this with the SAME texts (the all_gather is a
    collective). Each process runs its shard through its local engine —
    its own tokenization, device batching, everything — then the results
    are exchanged so every process returns the full [N, E] matrix. An
    Engine on a mesh that spans processes is refused: its encode_batch
    already runs one batch across them."""
    texts = list(texts)
    n_proc, _ = world()
    if n_proc == 1:
        return engine.encode_batch(texts, batch_size=batch_size)
    if engine.mesh is not None and engine.mesh.spans_processes:
        raise ValueError("distributed_encode_batch runs each process's "
                         "local Engine; an Engine on a mesh that spans "
                         "processes encodes the whole batch: call "
                         "encode_batch on every process")
    sl = process_shard(len(texts))
    local = engine.encode_batch(texts[sl], batch_size=batch_size) \
        if sl.stop > sl.start else \
        np.zeros((0, engine.n_embd), np.float32)
    # fixed-size exchange: pad the local shard to the largest shard so
    # every process contributes the same shape (all_gather's rule)
    max_shard = -(-len(texts) // n_proc)
    padded = torch.zeros((max_shard, engine.n_embd), dtype=torch.float32)
    padded[: len(local)] = torch.from_numpy(np.asarray(local, np.float32))
    gathered = [torch.empty_like(padded) for _ in range(n_proc)]
    dist.all_gather(gathered, padded)
    out = np.empty((len(texts), engine.n_embd), np.float32)
    for p in range(n_proc):
        s = process_shard(len(texts), count=n_proc, index=p)
        out[s] = gathered[p][: s.stop - s.start].numpy()
    return out
