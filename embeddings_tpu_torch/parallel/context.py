"""Sequence/context parallelism (CP) of the PyTorch port — the port of
``embeddings_tpu/parallel/context.py``: the sequence axis is sharded over
a "seq" mesh axis, the batch over "data".

Each shard holds [B/dp, L/sp, E] activations. Every layer gathers K/V
over the seq axis ([B, Lc, 2E] -> [B, L, 2E]) and computes attention for
its local query chunk against the gathered keys; everything else in the
layer is local along L. Pooling finishes with one sum (mean, cls) or max
over the seq axis. Embeddings and RoPE use global positions (shard j
holds positions j*Lc .. j*Lc + Lc - 1), and q/k are rotated before the
gather. ALBERT's factorized embeddings are projected on each shard, and
its one shared layer is walked num_hidden_layers times. Weights are
replicated.

Within a process one program drives every shard it owns, as the JAX
package's ``shard_map`` does: the forward walks the layers, and within a
layer this process's shards of one data row, so the gather and the
pooling reductions (``all_gather``, ``all_reduce``) see every local
shard's part; where the seq axis crosses processes they then run over the
row's process group (``mesh.Collective``). They are the only places
shards meet. The rows' results are exchanged at the end
(``Mesh.gather_rows``). A mesh may name one device more than once (one
H100 runs a dp x sp mesh); the shards on it then run in turn.

Attention per shard runs the hand-written CP kernel the JAX package's
route rule picks: ``fused_attention_cp`` (K8a) for rows within the
whole-row rule, ``fused_attention_cp_stream`` (K8b) past it, else the
einsum path (small or odd shapes, and ``use_kernels=False``). The CP
forward never enters the int8 compute mode (nor does JAX's): its
quantized matmuls run K1.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from ..config import BertConfig
from ..models import bert
from ..models.params import check_supported
from ..ops import attention as attn_ops
from ..ops.linear import linear, linear_residual_ln
from ..ops.rotary import apply_rotary, rope_tables
from .mesh import DATA_AXIS, Collective, Mesh, mesh_devices

SEQ_AXIS = "seq"

Params = dict[str, Any]


def make_mesh_cp(dp: int | None = None, sp: int = 1,
                 devices: Sequence | None = None) -> Mesh:
    """A ("data", "seq") mesh for DP x CP serving. ``devices=None`` means
    the visible CUDA devices (raising without one), or after
    ``initialize_distributed`` every process's default card
    (``mesh.mesh_devices``); dp * sp must equal the number of devices, so
    one card runs a dp x sp mesh as ``devices=[torch.device("cuda")] *
    (dp * sp)``."""
    devices = mesh_devices(devices)
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp({dp}) x sp({sp}) != device count {n}")
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(dp)],
                (DATA_AXIS, SEQ_AXIS))


# ---------------------------------------------------------------------------
# the collectives over one data row's shards: parts[k] is this process's
# k-th shard's value, on its device; ``group`` joins the row's other
# processes where the seq axis crosses them
# ---------------------------------------------------------------------------

def _per_device(parts: list[torch.Tensor], value: torch.Tensor) -> list:
    """value on each part's device, one copy per device."""
    by_dev = {value.device: value}
    for p in parts:
        if p.device not in by_dev:
            by_dev[p.device] = value.to(p.device)
    return [by_dev[p.device] for p in parts]


def all_gather(parts: list[torch.Tensor], dim: int,
               group: Collective | None = None) -> list[torch.Tensor]:
    """``lax.all_gather(..., tiled=True)`` over the seq axis: every shard
    gets all shards' parts concatenated along ``dim`` in axis order, on
    its own device (this process's parts, then the group's gather in
    process order). Shards on one device share one copy."""
    whole = torch.cat([q.to(parts[0].device) for q in parts], dim)
    if group is not None:
        whole = group.all_gather(whole, dim)
    return _per_device(parts, whole)


def all_reduce(parts: list[torch.Tensor], op: str,
               group: Collective | None = None) -> list[torch.Tensor]:
    """``lax.psum`` (op "sum") or ``lax.pmax`` ("max") over the seq axis:
    every shard gets the reduction of all parts, on its own device (this
    process's parts in shard order, then the group's reduction)."""
    fn = {"sum": torch.add, "max": torch.maximum}[op]
    acc = parts[0]
    for q in parts[1:]:
        acc = fn(acc, q.to(acc.device))
    if group is not None:
        acc = group.all_reduce(acc, op)
    return _per_device(parts, acc)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def cp_route_name(Lc: int, L: int, H: int, D: int) -> str:
    """The JAX package's CP route: "cp" (K8a) when whole-row K/V fits the
    TPU's VMEM rule and the kernel takes the shape, "cp_stream" (K8b) when
    the streamed kernel takes it, else "einsum"."""
    if (attn_ops.whole_row_fits(L, H * D) and attn_ops.supported(L, H, D)
            and Lc % 8 == 0):
        return "cp"
    if (attn_ops.stream_supported(L, H, D, attn_ops.pick_bk(L))
            and Lc % attn_ops.BQ == 0):
        return "cp_stream"
    return "einsum"


def _local_qkv(layer: Params, config: BertConfig, x: torch.Tensor,
               rope, use_kernels: bool):
    """One shard's projections: q [B, Lc, E] (with a fused tree a column
    view of the projection, read in place by the kernels) and k | v [B,
    Lc, 2E], q and k rotated at the shard's global positions."""
    B, Lc, _ = x.shape
    D = config.head_dim
    a = layer["attn"]
    kv = None
    if "qkv" in a:
        qkv = linear(x, a["qkv"]["w"], a["qkv"]["b"],
                     use_kernels=use_kernels)                 # [B, Lc, 3E]
        E = qkv.shape[-1] // 3
        q, k, v = qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:]
        kv = qkv[..., E:]  # k | v as they lie: the gather copies them
    else:
        q, k, v = (linear(x, a[n]["w"], a[n]["b"], use_kernels=use_kernels)
                   for n in ("q", "k", "v"))
    if rope is not None:
        E = q.shape[-1]
        q, k = (apply_rotary(t.reshape(B, Lc, E // D, D), *rope,
                             interleaved=config.rotary_interleaved)
                .reshape(B, Lc, E) for t in (q, k))
        kv = None
    return q, torch.cat([k, v], -1) if kv is None else kv


def _cp_attention(layers: list[Params], config: BertConfig,
                  xs: list[torch.Tensor], mask_bias: list[torch.Tensor],
                  lengths: list[torch.Tensor], ropes: list,
                  use_kernels: bool, group: Collective | None = None
                  ) -> list[torch.Tensor]:
    """Local-query attention for each shard of a data row: q from the
    local [B, Lc, E] chunk, k/v all-gathered to the full row. Returns each
    shard's context [B, Lc, E]. With ``use_kernels`` and a shape the
    kernels take, the CP kernel of ``cp_route_name`` on prefix ``lengths`` (the
    [Lc, L] scores never leave the kernel); otherwise the einsum path with
    ``mask_bias`` [B, 1, 1, L]."""
    D = config.head_dim
    parts = [_local_qkv(lay, config, x, rope, use_kernels)
             for lay, x, rope in zip(layers, xs, ropes)]
    kvs = all_gather([kv for _, kv in parts], 1, group)       # [B, L, 2E]
    out = []
    for j, ((q, _), kv) in enumerate(zip(parts, kvs)):
        B, Lc, E = q.shape
        L, H = kv.shape[1], E // D
        route = cp_route_name(Lc, L, H, D) if use_kernels else "einsum"
        if route != "einsum":
            kw = dict(B=B, Lc=Lc, L=L, H=H, D=D)
            q2, kv2 = q.reshape(B * Lc, E), kv.reshape(B * L, 2 * E)
            if route == "cp":
                ctx = attn_ops.fused_attention_cp(q2, kv2, lengths[j], **kw)
            else:
                # past the whole-row rule: K/V streamed in blocks of BK
                ctx = attn_ops.fused_attention_cp_stream(
                    q2, kv2, lengths[j], BK=attn_ops.pick_bk(L), **kw)
            out.append(ctx.reshape(B, Lc, E))
            continue
        qh = q.reshape(B, Lc, H, D)
        kh = kv[..., :E].reshape(B, L, H, D)
        vh = kv[..., E:].reshape(B, L, H, D)
        scores = torch.einsum("blhd,bmhd->bhlm", qh.float(), kh.float())
        scores = scores * (1.0 / math.sqrt(D)) + mask_bias[j]
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        ctx = torch.einsum("bhlm,bmhd->blhd", probs.float(), vh.float())
        out.append(ctx.to(q.dtype).reshape(B, Lc, E))
    return out


def _cp_layer(layers: list[Params], config: BertConfig,
              xs: list[torch.Tensor], mask_bias, lengths, ropes,
              use_kernels: bool, group: Collective | None = None
              ) -> list[torch.Tensor]:
    """One post-LN encoder block with CP attention; everything after the
    attention context is local along L (``bert.encoder_layer``'s
    numerics, bf16 K1 matmuls: no int8 mode)."""
    eps = config.layer_norm_eps
    ctxs = _cp_attention(layers, config, xs, mask_bias, lengths, ropes,
                         use_kernels, group)
    out = []
    for layer, x, ctx in zip(layers, xs, ctxs):
        a, m = layer["attn"], layer["mlp"]
        x = linear_residual_ln(ctx, a["o"]["w"], a["o"]["b"], x,
                               a["ln"]["scale"], a["ln"]["bias"], eps,
                               use_kernels=use_kernels)
        h = bert._ffn_hidden(m, x, config, use_kernels=use_kernels)
        out.append(linear_residual_ln(h, m["down"]["w"], m["down"]["b"], x,
                                      m["ln"]["scale"], m["ln"]["bias"], eps,
                                      use_kernels=use_kernels))
    return out


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _refuse(config: BertConfig) -> None:
    """The JAX package's refusals, word for word, then the port's own:
    mixture-of-experts layers (the JAX package's CP layer has no router
    branch, so its CP forward cannot run them either), then
    ``check_supported``."""
    if (config.relative_attention_num_buckets
            or config.position_embedding_type == "alibi"):
        # the [H, Lc, L] bias would need per-shard global positions in
        # both kernel and einsum paths — not wired; refuse rather than
        # silently dropping the bias (MPNet/jina-v2 without it is a
        # different model)
        raise ValueError("context parallelism does not support "
                         "attention-logit-bias models (MPNet relative "
                         "bias, jina-bert-v2 ALiBi); use dp/tp instead")
    if config.norm_style != "post" or config.causal:
        # the CP layer body is the post-LN BERT block; running a
        # pre-norm (ModernBERT/Qwen2) or causal model through it would
        # silently compute a different network — refuse instead
        raise ValueError("context parallelism supports post-LN "
                         "bidirectional encoders only (ModernBERT/"
                         "Qwen2-family models: use dp/tp instead)")
    if config.num_experts:
        raise NotImplementedError(
            f"context parallelism does not run mixture-of-experts layers "
            f"(num_experts={config.num_experts}): the CP layer is the "
            f"dense post-LN block, with no router; run the model without "
            f"a mesh")
    check_supported(config)


def make_cp_forward(config: BertConfig, mesh: Mesh, *,
                    pooling: str | None = None,
                    compute_dtype: torch.dtype | None = None,
                    mask_value: float = -1e9, use_kernels: bool = True):
    """(params, ids [B, L], mask [B, L]) -> [B, E'] f32 embeddings on the
    mesh's ``home`` (every process of a mesh that spans processes passes
    the whole batch and gets the whole result), with B sharded over
    "data" and L over "seq": B
    must divide by the data-axis size and L by the seq-axis size. ids and
    mask are integer numpy arrays or tensors (mask: right-padded, 1s then
    0s); params is the tree on any device, replicated once per distinct
    mesh device (kept while the same tree is passed). ``use_kernels``
    (the port's switch, as ``encode_tokens``'): the quantized matmuls run
    K1 and attention the CP kernels on the card (their plain versions on
    the CPU); False runs the plain f32 math and the einsum path. Like the
    single-device forward, a SentenceTransformers Dense stack runs before
    the L2 norm."""
    _refuse(config)
    pool = pooling or config.pooling
    if pool not in ("mean", "cls", "max"):
        raise ValueError(f"unknown pooling {pool!r}")
    dp, sp = mesh.devices.shape
    D = config.head_dim
    cache: list = [None, None]  # (params, its replicas)

    def local_row(ps: list[Params], ids: list[torch.Tensor],
                  masks: list[torch.Tensor], first: int,
                  group: Collective | None) -> torch.Tensor:
        """This process's shards of one data row (seq shards first,
        first + 1, ...) -> the row's pooled [B/dp, E'] (its first local
        shard's)."""
        B, Lc = ids[0].shape
        xs, ropes = [], []
        for j, (p, ids_j) in enumerate(zip(ps, ids), start=first):
            dev = ids_j.device
            pos = j * Lc + torch.arange(Lc, device=dev)       # global
            x = bert.embed(p, config, ids_j,
                           position_ids=pos[None].expand(B, Lc))
            if compute_dtype is not None:
                x = x.to(compute_dtype)
            xs.append(bert._project_embeddings(p, x))  # ALBERT
            rope = None
            if config.position_embedding_type == "rotary":
                # local-position tables: rotation precedes the k/v gather
                rope = tuple(t.to(dev) for t in rope_tables(
                    pos, D, config.rotary_base))
            ropes.append(rope)
        mask_full = all_gather(masks, 1, group)                # [B, L]
        bias = [((1.0 - m.float()) * mask_value)[:, None, None, :]
                for m in mask_full]
        # the engine produces prefix masks only: the CP kernels take the
        # per-sequence lengths of the gathered row
        lengths = [m.sum(1, dtype=torch.int32) for m in mask_full]
        # ALBERT's shared layer: the one stored layer, every time
        for layers in zip(*(bert.layer_views(p, config) for p in ps)):
            xs = _cp_layer(list(layers), config, xs, bias, lengths, ropes,
                           use_kernels, group)
        xf = [x.float() for x in xs]
        maskf = [m.float() for m in masks]
        if pool == "mean":
            s = all_reduce([torch.einsum("ble,bl->be", x, m)
                            for x, m in zip(xf, maskf)], "sum", group)
            denom = all_reduce([m.sum(1, keepdim=True) for m in maskf],
                               "sum", group)
            pooled = s[0] / denom[0].clamp_min(1.0)
        elif pool == "cls":
            # the CLS token lives on the first seq shard
            pooled = all_reduce([x[:, 0] if j == 0 else
                                 torch.zeros_like(x[:, 0])
                                 for j, x in enumerate(xf, start=first)],
                                "sum", group)[0]
        else:
            pooled = all_reduce([torch.where(m[..., None] > 0, x,
                                             -1e30).amax(1)
                                 for x, m in zip(xf, maskf)], "max",
                                group)[0]
        return bert._finish(ps[0], config, pooled,
                            config.normalize_embeddings)

    def forward(params: Params, ids, mask) -> torch.Tensor:
        ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
        B, L = ids.shape
        if B % dp or L % sp:
            raise ValueError(f"batch {B} and length {L} must divide by the "
                             f"mesh's data ({dp}) and seq ({sp}) sizes")
        if cache[0] is not params:
            cache[:] = [params, mesh.replicate(params)]
        reps = cache[1]
        Bd, Lc = B // dp, L // sp
        out = {}
        for i in mesh.local_rows():
            devs, first, group = mesh.row(i)
            rows = slice(i * Bd, (i + 1) * Bd)
            cols = [slice(j * Lc, (j + 1) * Lc)
                    for j in range(first, first + len(devs))]
            out[i] = local_row(
                [reps[d] for d in devs],
                [ids[rows, c].to(d) for c, d in zip(cols, devs)],
                [mask[rows, c].to(d) for c, d in zip(cols, devs)],
                first, group)
        return mesh.gather_rows(out)

    return forward
