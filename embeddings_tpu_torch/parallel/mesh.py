"""Device meshes of the PyTorch port — the counterpart of
``embeddings_tpu/parallel/mesh.py`` (its axis names and ``make_mesh``, the
("data", "model") mesh of data and tensor parallelism) and of the JAX
``Mesh`` the Engine reads.

A ``Mesh`` is a 2-D array of ``torch.device`` with one name per axis.
One program drives every shard of it (the JAX package's single-controller
``shard_map``), so a mesh may name one device more than once: the shards
on that device then run one after another, and a collective between them
is a copy on the device. One H100 can thus run a ``dp x sp`` mesh with
the real sharded numerics. Replicated weights are held once per
distinct device (``replicate``), not once per shard.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def resolve_mesh_device(device) -> torch.device:
    """A mesh entry as the Engine resolves a device (cuda or cpu; a CUDA
    device raises where there is none), "cuda" with its index, so that
    equal devices compare equal."""
    from ..runtime.engine import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """``devices``: a 2-D grid of devices (anything ``torch.device``
    takes), ``axis_names``: one name per axis. ``shape`` maps each axis
    name to its size, in axis order, as JAX's ``Mesh.shape`` does."""

    def __init__(self, devices: Sequence[Sequence], axis_names):
        rows = [[resolve_mesh_device(d) for d in row] for row in devices]
        if not rows or len({len(r) for r in rows}) != 1 or not rows[0]:
            raise ValueError("a mesh is a non-empty 2-D grid of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, d in enumerate(row):
                self.devices[i, j] = d
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 2 or len(set(self.axis_names)) != 2:
            raise ValueError(f"a mesh has two distinct axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def replicate(self, params) -> dict:
        """{device: the parameter tree on it}, one copy per distinct
        device (a tree already on a device is not copied there)."""
        from ..models.params import to_device
        return {d: to_device(params, d) for d in self.distinct_devices()}


def make_mesh(dp: int | None = None, tp: int = 1,
              devices: Sequence | None = None) -> Mesh:
    """A ("data", "model") mesh: the batch over "data", Megatron tensor
    parallelism over "model" (``parallel.sharding``). ``dp`` defaults to
    the device count // tp. ``devices=None`` means the visible CUDA
    devices (and raises without one); one card runs a dp x tp mesh as
    ``devices=[torch.device("cuda")] * (dp * tp)``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] or ["cuda"]
    devices = [resolve_mesh_device(d) for d in devices]  # raises off the card
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) x tp({tp}) != device count {n}")
    return Mesh([devices[i * tp:(i + 1) * tp] for i in range(dp)],
                (DATA_AXIS, MODEL_AXIS))
