"""Data and Megatron tensor parallelism of the PyTorch port — the port of
``embeddings_tpu/parallel/sharding.py`` on a ("data", "model") mesh
(``parallel.mesh.make_mesh``):

- q/k/v, FFN-up and gate weights are column-parallel (output features over
  "model"): each shard computes its heads' and its intermediate slice;
- attention-out and FFN-down weights are row-parallel (input features over
  "model"): each shard's partial product is summed over the model axis
  (``ModelAxis.psum``) before the bias, the residual and the LayerNorm;
- MPNet's relative-bias table and jina's ALiBi slopes split by head, as
  q/k/v do; an MoE half's expert stacks split by expert (expert
  parallelism on the model axis, ``ops.moe.moe_ffn``'s "replicated"
  schedule);
- embeddings, LayerNorms, biases of row-parallel weights, routers and the
  post-pooling heads are replicated;
- the batch splits over "data".

Quantized weights split the same way: codes, scales and mins along the
same logical axis, all or none of them (``param_pspecs``); a packed
weight's shard must hold whole group-64 packs (``adapt_packed_params``
unpacks the row-parallel weights whose shards would not).

Within a process one program drives every shard it owns, as the JAX
package's ``shard_map`` does, and as context parallelism does here
(``parallel/context.py``): the forward walks this process's data rows,
and within a layer its model-axis shards of a row in turn; a collective
is a plain function over the list of those shards' parts (``ModelAxis``),
joined with the row's other processes by ``torch.distributed`` where the
model axis crosses processes (``mesh.Collective``); the rows' results are
then exchanged (``Mesh.gather_rows``), so every process returns the whole
batch. A mesh may name one device more than once: one H100 runs a dp x tp
mesh with the real sharded numerics. ``shard_params`` cuts each sharded
leaf into its contiguous slices once (at Engine build), and shares the
replicated leaves among the shards on one device, so a tp mesh on one
card holds about one tree's bytes.

The shard forward is ``models.bert``'s with ``tp_axis``: on a CUDA device
the quantized matmuls run K1 (K3 in the int8 mode) at shard shapes — the
row-parallel ones with no epilogue, the sum, bias, residual and
LayerNorm then torch ops — and attention the fused kernels on the shard's
H/tp heads.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import BertConfig
from ..models import bert
from ..ops.quant import QuantizedTensor, codes_int8
from .mesh import MODEL_AXIS, Collective, Mesh

Params = dict[str, Any]


class Spec(NamedTuple):
    """How one leaf lies on the mesh: ``kind`` "replicated", "column",
    "row", "expert" or "head", and ``axis``, the leaf's axis split over
    "model" (None when replicated). A QuantizedTensor has one spec for
    its codes, scales and mins together."""
    kind: str
    axis: int | None


REPLICATED = Spec("replicated", None)
COLUMN = Spec("column", 2)       # [NL, K, N] weight: N over "model"
ROW = Spec("row", 1)             # [NL, K, N] weight: K over "model"
COLUMN_BIAS = Spec("column", 1)  # [NL, N] bias of a column-parallel weight
EXPERT = Spec("expert", 1)       # [NLh, Ex, ...] expert stacks
HEAD_TABLE = Spec("head", 1)     # MPNet's [buckets, H] table
HEAD_SLOPES = Spec("head", 0)    # jina's [H] slopes


def _divisible(shape, spec: Spec, tp: int) -> bool:
    return spec.axis is None or shape[spec.axis] % tp == 0


def _replicated_tree(tree):
    """A spec tree of ``tree``'s shape with every leaf replicated."""
    if isinstance(tree, dict):
        return {k: _replicated_tree(v) for k, v in tree.items()}
    return REPLICATED


def _tp(mesh: Mesh) -> int:
    return mesh.shape.get(MODEL_AXIS, 1)


def param_pspecs(params: Params, mesh: Mesh) -> Params:
    """A tree of ``Spec`` congruent with ``params`` (a QuantizedTensor is
    one leaf). The JAX package's rules: a weight, or a QuantizedTensor's
    codes, scales and mins all together, shards only where every piece
    divides by the model-axis size (else the whole tensor and its bias
    are replicated); a packed weight split along its packed rows only
    where each shard holds whole groups of 32 packed rows; an expert
    stack only where up and down with their biases all divide; embedding
    tables replicated. Leaves the JAX package has no rule for are
    replicated."""
    tp = _tp(mesh)
    if tp > 1 and "qkv" in _first_stack(params)["attn"]:
        raise ValueError("tensor parallelism shards q, k and v apart; pass "
                         "the tree before params.fuse_qkv")

    def for_linear(v: dict, w_spec: Spec, b_spec: Spec) -> dict:
        """All or nothing, as the JAX package's ``for_linear``: a piece
        that cannot shard replicates the whole tensor and its bias."""
        w, b = v["w"], v["b"]
        if isinstance(w, QuantizedTensor):
            pieces = [w.codes, w.scales] + ([] if w.mins is None
                                            else [w.mins])
            ok = all(_divisible(x.shape, w_spec, tp) for x in pieces)
            if ok and w.packed and w_spec.axis == w.codes.dim() - 2:
                # group-64 nibble layout: a shard of the packed rows must
                # hold whole 32-packed-row groups
                ok = (w.codes.shape[w_spec.axis] // tp) % 32 == 0
        else:
            ok = _divisible(w.shape, w_spec, tp)
        out = dict(_replicated_tree(v))
        out["w"] = w_spec if ok else REPLICATED
        # a sharded bias only next to a sharded weight
        out["b"] = (b_spec if ok and _divisible(b.shape, b_spec, tp)
                    else REPLICATED)
        return out

    def stack_specs(lyr: Params) -> Params:
        s = _replicated_tree(lyr)
        a = lyr["attn"]
        for n in ("q", "k", "v"):
            if n in a:  # else fused (tp == 1): replicated as it is
                s["attn"][n] = for_linear(a[n], COLUMN, COLUMN_BIAS)
        s["attn"]["o"] = for_linear(a["o"], ROW, REPLICATED)
        m = lyr["mlp"]
        if "router" in m:
            # expert parallelism over "model": all or nothing across up
            # and down with their biases (the forward reads the local
            # expert count from up.w); router, shared bias and LN
            # replicated
            ok = all(_divisible(t.shape, EXPERT, tp)
                     for t in (m["up"]["w"], m["up"]["b"], m["down"]["w"],
                               m["down"]["b"]))
            for n in ("up", "down"):
                for k in ("w", "b"):
                    s["mlp"][n][k] = EXPERT if ok else REPLICATED
            return s
        s["mlp"]["up"] = for_linear(m["up"], COLUMN, COLUMN_BIAS)
        s["mlp"]["down"] = for_linear(m["down"], ROW, REPLICATED)
        if "gate" in m:
            s["mlp"]["gate"] = for_linear(m["gate"], COLUMN, COLUMN_BIAS)
        return s

    specs = _replicated_tree(params)
    layers = params["layers"]
    if "dense" in layers:
        specs["layers"] = {h: stack_specs(layers[h]) for h in ("dense",
                                                               "moe")}
    else:
        specs["layers"] = stack_specs(layers)
    # the head-split family biases, replicated where H does not divide
    if "rel_bias" in params:
        specs["rel_bias"] = (HEAD_TABLE if _divisible(
            params["rel_bias"].shape, HEAD_TABLE, tp) else REPLICATED)
    if "alibi_slopes" in params:
        specs["alibi_slopes"] = (HEAD_SLOPES if _divisible(
            params["alibi_slopes"].shape, HEAD_SLOPES, tp) else REPLICATED)
    return specs


def _first_stack(params: Params) -> Params:
    layers = params["layers"]
    return layers["dense"] if "dense" in layers else layers


def adapt_packed_params(params: Params, mesh: Mesh) -> Params:
    """Keep 4-bit packed weights under tensor parallelism wherever the
    shards stay valid, unpacking only the exceptions: a row-parallel
    weight (attention-out, FFN-down) splits its packed rows, so each
    shard must hold whole group-64 packs, (K/2)/tp % 32 == 0; where it
    does not (MiniLM's K=384 at tp=4), that weight alone falls back to
    int8 codes. Column-parallel weights split N and stay packed."""
    tp = _tp(mesh)
    if tp <= 1:
        return params

    def shardable_packed(w: QuantizedTensor) -> bool:
        rows = w.codes.shape[-2]  # packed rows = K/2
        return rows % tp == 0 and (rows // tp) % 32 == 0

    def unpack_one(w: QuantizedTensor) -> QuantizedTensor:
        codes = torch.from_numpy(codes_int8(w)).to(w.codes.device)
        return QuantizedTensor(codes, w.scales, w.mins, w.kind,
                               w.block_axis, packed=False)

    def adapt_stack(layers: Params) -> Params:
        out = dict(layers)
        for grp, name in (("attn", "o"), ("mlp", "down")):
            if name not in out.get(grp, {}):
                continue  # an MoE half: its mlp has experts, no "down"
            w = out[grp][name]["w"]
            if (isinstance(w, QuantizedTensor) and w.packed
                    and w.block_axis == -2 and not shardable_packed(w)):
                out[grp] = {**out[grp],
                            name: {**out[grp][name], "w": unpack_one(w)}}
        return out

    out = dict(params)
    if "dense" in params["layers"]:
        out["layers"] = {h: adapt_stack(params["layers"][h])
                         for h in ("dense", "moe")}
    else:
        out["layers"] = adapt_stack(params["layers"])
    return out


def _slice(t: torch.Tensor, spec: Spec, j: int, tp: int) -> torch.Tensor:
    n = t.shape[spec.axis] // tp
    return t.narrow(spec.axis, j * n, n).contiguous()


class ShardedParams:
    """``shard_params``' result: ``specs`` (``param_pspecs``) and one
    parameter tree per mesh shard of this process, ``tree(i, j)`` on
    ``mesh.devices[i, j]`` (None for another process's shard). Sharded
    leaves are contiguous slices; the shards of one device share its
    replicated leaves, and shards (i, j) and (i', j) on one device share
    their tree."""

    def __init__(self, specs: Params, trees: np.ndarray, mesh: Mesh):
        self.specs, self.trees, self.mesh = specs, trees, mesh

    def tree(self, i: int, j: int) -> Params:
        return self.trees[i, j]

    def row(self, i: int) -> list[Params]:
        """Data row i's trees of this process, one per model-axis shard
        it owns, in axis order."""
        return [t for t in self.trees[i] if t is not None]

    def distinct_trees(self) -> list[Params]:
        return list({id(t): t for t in self.trees.flat
                     if t is not None}.values())


def _map_specs(fn, specs, tree):
    """fn(spec, leaf) over congruent trees (a QuantizedTensor is a
    leaf)."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, specs[k], v) for k, v in tree.items()}
    return fn(specs, tree)


def shard_params(params: Params, config: BertConfig, mesh: Mesh
                 ) -> ShardedParams:
    """One tree per mesh shard of this process, by ``param_pspecs``:
    shard j of the model axis holds the j-th contiguous slice of every
    sharded leaf (made here, once), on its device; replicated leaves are
    moved once per distinct device and shared. A kept int8 weight is not
    carried over: the Engine requantizes each shard's slice
    (``params.keep_int8_weights``), as the JAX kernel requantizes the
    weight it is given."""
    specs = param_pspecs(params, mesh)
    tp = _tp(mesh)
    shared: dict = {}   # (id(replicated leaf), device) -> its copy there
    made: dict = {}     # (device, j) -> shard j's tree on it

    def place(t: torch.Tensor, dev) -> torch.Tensor:
        key = (id(t), dev)
        if key not in shared:
            shared[key] = t.to(dev)
        return shared[key]

    def build(dev, j: int) -> Params:
        def leaf(spec: Spec, x):
            if isinstance(x, QuantizedTensor):
                if spec.axis is None:
                    key = (id(x), dev)
                    if key not in shared:
                        shared[key] = QuantizedTensor(
                            place(x.codes, dev), place(x.scales, dev),
                            None if x.mins is None else place(x.mins, dev),
                            x.kind, x.block_axis, x.packed)
                    return shared[key]
                return QuantizedTensor(
                    *(None if t is None else _slice(t, spec, j, tp).to(dev)
                      for t in (x.codes, x.scales, x.mins)),
                    x.kind, x.block_axis, x.packed)
            if spec.axis is None:
                return place(x, dev)
            return _slice(x, spec, j, tp).to(dev)
        return _map_specs(leaf, specs, params)

    dp = mesh.devices.shape[0]
    trees = np.empty((dp, tp), dtype=object)
    for i in range(dp):
        for j in range(tp):
            if mesh.ranks[i, j] != mesh.rank:
                continue  # another process's shard
            dev = mesh.devices[i, j]
            if (dev, j) not in made:
                made[(dev, j)] = build(dev, j)
            trees[i, j] = made[(dev, j)]
    return ShardedParams(specs, trees, mesh)


# the port runs spmd="shard_map" only; the JAX package's "gspmd" is its
# XLA cross-check with the Pallas kernels disabled
SPMD_REFUSAL = ("spmd={spmd!r} is not supported: the port runs "
                "spmd='shard_map' only (the JAX package's spmd='gspmd' is "
                "its numerical cross-check with Pallas disabled: Mosaic "
                "custom calls have no GSPMD partitioning rules)")


def _check_tp_shardable(pspecs: Params, tp: int) -> None:
    """Every matmul weight must really be TP-sharded: a replication
    fallback (non-divisible dim) would make the psum over-count by tp.
    Fail loudly instead, in the JAX package's words. (MoE expert stacks
    are exempt: their replicated fallback is safe — the forward sees all
    experts local by shape and sums nothing.)"""
    layers = pspecs["layers"]
    stacks = ([("", layers)] if "attn" in layers
              else [("dense.", layers["dense"]), ("moe.", layers["moe"])])
    for prefix, node in stacks:
        checks = [("attn", "q"), ("attn", "k"), ("attn", "v"),
                  ("attn", "o")]
        if "router" not in node["mlp"]:
            checks += [("mlp", "up"), ("mlp", "down")]
            if "gate" in node["mlp"]:
                checks.append(("mlp", "gate"))
        for grp, name in checks:
            if node[grp][name]["w"].axis is None:
                raise ValueError(
                    f"tp={tp} cannot shard {prefix}{grp}.{name} for this "
                    f"model (dimension not divisible); lower tp or "
                    f"use spmd='gspmd'")


# ---------------------------------------------------------------------------
# the model axis of one data row: its devices and its collectives
# ---------------------------------------------------------------------------

class ModelAxis:
    """The "model" axis of one data row, as the layer code sees it
    (``tp_axis`` in ``models.bert``, ``ep_axis`` in ``ops.moe``): the
    devices of this process's shards, in axis order (``first`` the axis
    index of the first, ``size`` the whole axis), and the collectives as
    plain functions over the list of those shards' parts (part k on
    ``devices[k]``), joined over ``group`` (a ``mesh.Collective``) where
    the axis crosses processes. A value replicated over the axis lives
    once, on this process's first shard's device (``home``); a shard
    reads it through ``on``."""

    def __init__(self, devices, *, first: int = 0, size: int | None = None,
                 group: Collective | None = None):
        self.devices = list(devices)
        self.first = first
        self.size = len(self.devices) if size is None else size
        self.group = group

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def on(self, k: int, t):
        """t (a tensor, a tuple of them or None) on local shard k's
        device."""
        if t is None:
            return None
        if isinstance(t, tuple):
            return tuple(self.on(k, u) for u in t)
        return t.to(self.devices[k])

    def place(self, t) -> list:
        """t on every local shard's device, one entry per shard (shards
        on one device share one copy)."""
        by_dev: dict = {}
        for k, d in enumerate(self.devices):
            if d not in by_dev:
                by_dev[d] = self.on(k, t)
        return [by_dev[d] for d in self.devices]

    def psum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """``lax.psum`` over the axis, on the home device, in the parts'
        dtype: this process's parts summed in shard order (a part on
        another card first copied to home), then the processes' sums
        added by the group (for two processes, one part each, the same
        bits as the shard-order sum: a + b == b + a; for more, in the
        group's order: four parts reassociate)."""
        acc = parts[0].to(self.home)
        for p in parts[1:]:
            acc = acc + p.to(self.home)
        return acc if self.group is None else self.group.all_reduce(acc)

    def all_gather(self, parts: list[torch.Tensor], dim: int = 0
                   ) -> torch.Tensor:
        """``lax.all_gather(..., tiled=True)``: every shard's part
        concatenated along ``dim`` in axis order, on the home device."""
        whole = torch.cat([p.to(self.home) for p in parts], dim)
        return whole if self.group is None else \
            self.group.all_gather(whole, dim)

    def psum_scatter(self, parts: list[torch.Tensor], dim: int = 0
                     ) -> list[torch.Tensor]:
        """``lax.psum_scatter(..., tiled=True)``: the sum split into
        ``size`` equal chunks along ``dim``, chunk ``first + k`` on local
        shard k's device."""
        chunks = self.psum(parts).chunk(self.size, dim)
        return [chunks[self.first + k].to(d)
                for k, d in enumerate(self.devices)]


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------

def _data_rows(mesh: Mesh, n: int, what: str) -> int:
    dp = mesh.devices.shape[0]
    if n % dp:
        raise ValueError(f"{what} {n} not divisible by the data-axis size "
                         f"{dp}")
    return n // dp


def _sharded_of(config: BertConfig, mesh: Mesh):
    """params -> its ShardedParams: as given, or sharded once (kept while
    the same tree is passed)."""
    cache: list = [None, None]

    def get(params) -> ShardedParams:
        if isinstance(params, ShardedParams):
            return params
        if cache[0] is not params:
            cache[:] = [params, shard_params(params, config, mesh)]
        return cache[1]
    return get


def _run_rows(mesh: Mesh, sp: ShardedParams, arrays, fn) -> torch.Tensor:
    """fn(this process's trees of data row i, tp_axis or None, row i's
    arrays on its first local device) for each data row this process
    holds a shard of; every row's result, in order, on the mesh's
    ``home`` (``Mesh.gather_rows``)."""
    tp = mesh.devices.shape[1]
    arrays = [torch.as_tensor(a) for a in arrays]
    Bd = _data_rows(mesh, arrays[0].shape[0], "batch size")
    out = {}
    for i in mesh.local_rows():
        devices, first, group = mesh.row(i)
        axis = (ModelAxis(devices, first=first, size=tp, group=group)
                if tp > 1 else None)
        rows = [a[i * Bd:(i + 1) * Bd].to(devices[0]) for a in arrays]
        trees = sp.row(i)
        out[i] = fn(trees if axis is not None else trees[0], axis, rows)
    return mesh.gather_rows(out)


def make_sharded_forward(config: BertConfig, mesh: Mesh, *,
                         pooling: str | None = None,
                         compute_dtype: torch.dtype | None = None,
                         mask_value: float = -1e9,
                         use_kernels: bool = True, int8: bool = False,
                         spmd: str = "shard_map"):
    """(params, ids [B, L], mask [B, L]) -> [B, E'] f32 embeddings on the
    mesh's ``home``, the batch over "data" (B must divide by its size)
    and Megatron TP over "model"; every process of a mesh that spans
    processes passes the whole batch and gets the whole result. params:
    a ``ShardedParams``, or a tree (sharded at the first call and kept
    while the same tree is passed).

    spmd="shard_map" (default): every shard runs ``bert.encode_tokens``
    on its own weights with ``tp_axis``: the quantized matmuls through K1
    (K3 with ``int8``) and attention through the fused kernels at shard
    shapes on the card (their plain versions on the CPU), one sum over
    the model axis after each row-parallel matmul. A weight that cannot
    shard raises (``_check_tp_shardable``).

    spmd="gspmd" is refused (``SPMD_REFUSAL``): in the JAX package it is
    a numerical cross-check with the Pallas kernels disabled (Mosaic
    custom calls have no GSPMD partitioning rules), and the port's
    shard_map path is held against the JAX package's results instead."""
    if spmd != "shard_map":
        raise ValueError(SPMD_REFUSAL.format(spmd=spmd))
    tp = _tp(mesh)
    sharded = _sharded_of(config, mesh)
    kw = dict(pooling=pooling, compute_dtype=compute_dtype,
              mask_value=mask_value)

    def fwd(params, ids, mask):
        sp = sharded(params)
        if tp > 1:
            _check_tp_shardable(sp.specs, tp)
        return _run_rows(mesh, sp, (ids, mask), lambda p, axis, a: (
            bert.encode_tokens(p, config, *a, tp_axis=axis,
                               use_kernels=use_kernels, int8=int8, **kw)))
    return fwd


def make_sharded_packed_forward(config: BertConfig, mesh: Mesh, *,
                                compute_dtype: torch.dtype | None = None,
                                mask_value: float = -1e9,
                                use_kernels: bool = True,
                                int8: bool = False):
    """(params, ids, seg, pos, pool, attn_window=0) -> [B, S, E'] for
    token-packed rows over the mesh: rows are independent, so they split
    over "data" as the bucketed batch does, and Megatron TP runs within
    each data row (``bert.encode_packed`` with ``tp_axis``). The same
    loud refusal as ``make_sharded_forward``."""
    tp = _tp(mesh)
    sharded = _sharded_of(config, mesh)

    def fwd(params, ids, seg, pos, pool, attn_window: int = 0):
        sp = sharded(params)
        if tp > 1:
            _check_tp_shardable(sp.specs, tp)
        return _run_rows(mesh, sp, (ids, seg, pos, pool),
                         lambda p, axis, a: bert.encode_packed(
                             p, config, *a, tp_axis=axis,
                             compute_dtype=compute_dtype,
                             mask_value=mask_value, attn_window=attn_window,
                             use_kernels=use_kernels, int8=int8))
    return fwd
