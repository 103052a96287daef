"""Device meshes of the PyTorch port — the counterpart of
``embeddings_tpu/parallel/mesh.py`` (its axis names, ``make_mesh``, the
("data", "model") mesh of data and tensor parallelism, and
``initialize_distributed``) and of the JAX ``Mesh`` the Engine reads.

A ``Mesh`` is a 2-D array of ``torch.device`` with one name per axis, and
beside it a grid of the ranks of the processes that own the entries
(``torch.distributed``; all this process's when it runs alone). Within a
process one program drives every shard it owns (the JAX package's
single-controller ``shard_map``), so a mesh may name one device more than
once: the shards on that device then run one after another, and a
collective between them is a copy on the device. One H100 can thus run a
``dp x sp`` mesh with the real sharded numerics. Replicated weights are
held once per distinct device (``replicate``), not once per shard.

A mesh whose entries belong to several processes (built from
``global_devices``, as ``make_mesh(devices=None)`` does after
``initialize_distributed``) joins them with ``torch.distributed``: each
process runs its own entries, the collectives of an axis that crosses
processes reduce or concatenate this process's parts and then run over
the axis's process group (``Collective``), and the data rows' results are
exchanged at the end (``gather_rows``). The groups are made once, when
the mesh is built, and so is the backend (``Mesh.backend``): gloo for CPU
tensors; NCCL for CUDA tensors where no two processes share a GPU; gloo
with every CUDA tensor staged through host memory where they do (two
processes on one card, which NCCL refuses).
"""

from __future__ import annotations

import os
import socket
from collections import Counter, OrderedDict
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# a mesh's backend (``Mesh.backend``): one process; CPU tensors over
# gloo; CUDA tensors through host memory over gloo (processes share a
# card); CUDA tensors over NCCL (each process its own cards)
LOCAL, GLOO, GLOO_HOST, NCCL = "local", "gloo", "gloo+host", "nccl"


def world() -> tuple[int, int]:
    """(process count, this process's rank); (1, 0) while
    ``torch.distributed`` is not initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


# this process's card by the card rule (``initialize_distributed``), or
# None: no card assigned (one process, torchrun's LOCAL_RANK, or more
# processes on the host than cards)
_process_card: int | None = None


def process_card() -> int | None:
    """The card ``initialize_distributed`` gave this process outside
    torchrun, or None."""
    return _process_card


def card_rule(hosts: Sequence[str], rank: int, n_cards: int) -> int | None:
    """The card of process ``rank`` given every process's host name
    (``hosts``, in rank order) and the card count of its host: its index
    among the processes of its host, where the host has a card for each
    of them (JAX's GPU rule: one chip per local process); None where
    they are more than the cards, and so share one."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return mine.index(rank) if len(mine) <= n_cards else None


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-process bring-up: ``torch.distributed`` over gloo, with the
    coordinator's "host:port" as a ``tcp://`` rendezvous (``env://``,
    torchrun's MASTER_ADDR / MASTER_PORT, when it is None). No-op when
    single-process. With a card present, the process's current card
    becomes its own, as ``runtime.engine.resolve_device`` names it: under
    torchrun (LOCAL_RANK set) cuda:LOCAL_RANK; else the card of
    ``card_rule`` (one ``all_gather_object`` of the host names), none
    where the processes of the host outnumber its cards (they then share
    the default card, and a mesh over them stages through the host)."""
    global _process_card
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "gloo", init_method=(f"tcp://{coordinator}" if coordinator
                             else "env://"),
        world_size=num_processes, rank=process_id)
    if not torch.cuda.is_available():
        return
    if "LOCAL_RANK" not in os.environ:
        hosts = [None] * num_processes
        dist.all_gather_object(hosts, socket.gethostname())
        _process_card = card_rule(hosts, dist.get_rank(),
                                  torch.cuda.device_count())
        if _process_card is None:
            return
    from ..runtime.engine import resolve_device
    torch.cuda.set_device(resolve_device(None))


def resolve_mesh_device(device) -> torch.device:
    """A mesh entry as the Engine resolves a device (cuda or cpu; a CUDA
    device raises where there is none), "cuda" with its index, so that
    equal devices compare equal."""
    from ..runtime.engine import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ProcessDevice(NamedTuple):
    """A mesh entry with its owner: ``rank``, the process that runs the
    shard; ``device``, as that process names it; ``key``, the physical
    device across processes (host, and the GPU's UUID), which tells
    whether two processes share a card."""
    rank: int
    device: torch.device
    key: str


def device_key(dev: torch.device) -> str:
    host = socket.gethostname()
    if dev.type == "cuda":
        return f"{host}/{torch.cuda.get_device_properties(dev).uuid}"
    return f"{host}/cpu"


def global_devices(local: Sequence | None = None) -> list[ProcessDevice]:
    """Every process's devices in process order, then local order (the
    JAX package's ``jax.devices()`` order), each with its owner.
    ``local``: this process's devices (default its default card,
    ``resolve_device(None)``: cuda:LOCAL_RANK under torchrun); one card
    may appear more than once. A collective (``all_gather_object``):
    every process calls it, with the same number of devices or not.
    Before ``initialize_distributed``, this process's own."""
    mine = [(str(d), device_key(d)) for d in
            (resolve_mesh_device(d) for d in (local or [None]))]
    n, _ = world()
    parts = [mine]
    if n > 1:
        parts = [None] * n
        dist.all_gather_object(parts, mine)
    return [ProcessDevice(r, torch.device(d), key)
            for r, part in enumerate(parts) for d, key in part]


def mesh_devices(devices: Sequence | None) -> list:
    """The device list of ``make_mesh`` / ``make_mesh_cp``, this
    process's entries resolved (raising off the card). ``None``: after
    ``initialize_distributed`` with more than one process, the global
    list (``global_devices``, each process its default card); else the
    visible CUDA devices."""
    if devices is None:
        if world()[0] > 1:
            return global_devices()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] or ["cuda"]
    return [d if isinstance(d, ProcessDevice) else resolve_mesh_device(d)
            for d in devices]


class Collective:
    """The processes an axis of a mesh spans (``ranks``, a
    ``torch.distributed`` group) and its collectives on this process's
    part. ``staged``: a CUDA tensor goes through host memory (a gloo
    group); else as it is (NCCL). The caller's tensor is never written."""

    def __init__(self, group, ranks: list[int], staged: bool):
        self.group, self.ranks, self.staged = group, ranks, staged

    def _buffer(self, t: torch.Tensor) -> torch.Tensor:
        dev = "cpu" if self.staged else t.device
        return t.to(dev, copy=True).contiguous()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reduction ("sum" or "max") of every process's ``t``, on
        t's device."""
        buf = self._buffer(t)
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every process's ``t`` (all of one shape) concatenated along
        ``dim`` in process order, on t's device."""
        buf = self._buffer(t)
        parts = [torch.empty_like(buf) for _ in self.ranks]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts, dim).to(t.device)


def mesh_backend(entries) -> str:
    """The backend rule over a mesh's ``ProcessDevice`` entries: gloo for
    a mesh of CPUs, NCCL where every card belongs to one process, else
    gloo through host memory."""
    owners: dict[str, set] = {}
    for e in entries:
        if e.device.type == "cuda":
            owners.setdefault(e.key or device_key(e.device),
                              set()).add(e.rank)
    if not owners:
        return GLOO
    return GLOO_HOST if any(len(r) > 1 for r in owners.values()) else NCCL


class Mesh:
    """``devices``: a 2-D grid of devices (anything ``torch.device``
    takes, all this process's, or ``ProcessDevice`` entries of any
    process), ``axis_names``: one name per axis. ``shape`` maps each axis
    name to its size, in axis order, as JAX's ``Mesh.shape`` does.
    ``ranks`` is the grid of the entries' owners.

    A mesh that spans processes spans all of them, and every process
    builds it (the groups are made here, collectively). Along each data
    row each process holds the same number of consecutive entries, in
    process order (the global device list's order), so that a row's
    collectives concatenate in axis order."""

    def __init__(self, devices: Sequence[Sequence], axis_names):
        n_proc, self.rank = world()
        rows = [[d if isinstance(d, ProcessDevice)
                 else ProcessDevice(self.rank, d, "") for d in row]
                for row in devices]
        if not rows or len({len(r) for r in rows}) != 1 or not rows[0]:
            raise ValueError("a mesh is a non-empty 2-D grid of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        self.ranks = np.array([[e.rank for e in row] for row in rows],
                              dtype=np.int64)
        for i, row in enumerate(rows):
            for j, e in enumerate(row):
                # this process resolves its own entries; another's stay
                # as their owner named them
                self.devices[i, j] = (resolve_mesh_device(e.device)
                                      if e.rank == self.rank
                                      else torch.device(e.device))
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 2 or len(set(self.axis_names)) != 2:
            raise ValueError(f"a mesh has two distinct axis names, got "
                             f"{self.axis_names}")
        procs = sorted(set(self.ranks.ravel().tolist()))
        if self.rank not in procs:
            raise ValueError(f"process {self.rank} owns no entry of the "
                             f"mesh")
        self.spans_processes = len(procs) > 1
        self.backend = LOCAL
        self._groups: dict[tuple, Collective] = {}
        if not self.spans_processes:
            return
        if procs != list(range(n_proc)):
            raise ValueError(f"a mesh that spans processes spans all "
                             f"{n_proc} of them; it names {procs}")
        for i, r in enumerate(self.ranks):
            counts = Counter(r.tolist())
            if (np.diff(r) < 0).any() or len(set(counts.values())) != 1:
                raise ValueError(
                    f"data row {i} of the mesh: each process holds the "
                    f"same number of consecutive entries, in process "
                    f"order; its ranks are {r.tolist()}")
        self.backend = mesh_backend(e for row in rows for e in row)
        # made once, here, in the same order on every process
        self._host = Collective(dist.new_group(procs, backend="gloo"),
                                procs, staged=True)
        for i in range(len(rows)):
            rk = self.row_ranks(i)
            if len(rk) > 1 and tuple(rk) not in self._groups:
                group = dist.new_group(
                    rk, backend="cpu:gloo,cuda:nccl" if self.backend == NCCL
                    else "gloo")
                self._groups[tuple(rk)] = Collective(
                    group, rk, staged=self.backend != NCCL)

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def row_ranks(self, i: int) -> list[int]:
        """The processes of data row i, in order."""
        return sorted(set(self.ranks[i].tolist()))

    def local_rows(self) -> list[int]:
        """The data rows that hold an entry of this process."""
        return [i for i in range(self.devices.shape[0])
                if self.rank in self.ranks[i]]

    def row(self, i: int) -> tuple[list[torch.device], int,
                                    Collective | None]:
        """Data row i as this process runs it: its own entries' devices
        in axis order, the axis index of the first, and the collective
        over the row's processes (None when it holds the whole row)."""
        js = [j for j in range(self.devices.shape[1])
              if self.ranks[i, j] == self.rank]
        return ([self.devices[i, j] for j in js], js[0],
                self._groups.get(tuple(self.row_ranks(i))))

    @property
    def home_index(self) -> tuple[int, int]:
        """This process's first entry, in mesh order."""
        i, j = np.argwhere(self.ranks == self.rank)[0]
        return int(i), int(j)

    @property
    def home(self) -> torch.device:
        """This process's first device: where the results land."""
        return self.devices[self.home_index]

    def distinct_devices(self) -> list[torch.device]:
        """Each of this process's devices once, in mesh order."""
        return list(dict.fromkeys(
            d for d, r in zip(self.devices.flat, self.ranks.flat)
            if r == self.rank))

    def replicate(self, params) -> dict:
        """{device: the parameter tree on it}, one copy per distinct
        device of this process (a tree already on a device is not copied
        there)."""
        from ..models.params import to_device
        return {d: to_device(params, d) for d in self.distinct_devices()}

    def gather_rows(self, outs: dict[int, torch.Tensor]) -> torch.Tensor:
        """The data rows' results ({row: [B/dp, ...]}, the rows this
        process ran) -> every row in order, concatenated on ``home``.
        Where a process did not run every row, each row's first process
        sends it: one all_gather of host tensors over gloo, the JAX
        package's ``process_allgather(tiled=True)``."""
        dp = self.devices.shape[0]
        n_proc = len(self._host.ranks) if self.spans_processes else 1
        if all(len(self.row_ranks(i)) == n_proc for i in range(dp)):
            return torch.cat([outs[i].to(self.home) for i in range(dp)], 0)
        lead = [self.row_ranks(i)[0] for i in range(dp)]
        n = max(Counter(lead).values())  # rows a process sends, at most
        ref = next(iter(outs.values()))
        buf = torch.zeros((n, *ref.shape), dtype=ref.dtype)
        for k, i in enumerate(i for i in range(dp) if lead[i] == self.rank):
            buf[k] = outs[i].cpu()
        every = self._host.all_gather(buf, 0)  # [n_proc * n, ...]
        sent: Counter = Counter()
        rows = []
        for i in range(dp):
            rows.append(every[lead[i] * n + sent[lead[i]]])
            sent[lead[i]] += 1
        return torch.cat(rows, 0).to(self.home)


def make_mesh(dp: int | None = None, tp: int = 1,
              devices: Sequence | None = None) -> Mesh:
    """A ("data", "model") mesh: the batch over "data", Megatron tensor
    parallelism over "model" (``parallel.sharding``). ``dp`` defaults to
    the device count // tp. ``devices=None`` means the visible CUDA
    devices (raising without one), or after ``initialize_distributed``
    every process's default card (``mesh_devices``). One card runs a dp x
    tp mesh as ``devices=[torch.device("cuda")] * (dp * tp)``; two
    processes a global one as ``devices=global_devices([...])``."""
    devices = mesh_devices(devices)
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) x tp({tp}) != device count {n}")
    return Mesh([devices[i * tp:(i + 1) * tp] for i in range(dp)],
                (DATA_AXIS, MODEL_AXIS))
