"""Mixture-of-experts FFN of the PyTorch port (nomic-embed-text-v2-moe,
and DeepSeek-V2's, the port's own) — the port of
``embeddings_tpu/ops/moe.py``.

  router logits = x @ Wr            -> softmax over all experts (f32)
  top-k expert probabilities        (k = moe_top_k, no renormalization
                                     unless moe_normalize_topk)
  y = sum_e  p_e * down_e(act(up_e(x)))   [+ shared output bias]

DeepSeek-V2 (``moe_ffn_ragged`` only): gated experts, down_e(act(gate_e
x) * up_e x) with no biases, the probabilities times
``routed_scaling_factor``, and a shared expert (``moe["shared"]``: one
gated MLP of quantized linears, the published shared experts side by
side) added for every token.

Two evaluations, as in the JAX package:

* ``moe_ffn``: every expert on every token, the top-k weights (zero for
  the others) masking an f32 combine; ``route_topk`` keeps every expert
  whose probability reaches the k-th largest, so a tie can keep more
  than k.
* ``moe_ffn_ragged``: only the selected experts. The T*k (token, expert)
  pairs are sorted by expert (stable), the rows gathered, each non-empty
  expert's contiguous slice multiplied by its weights in the activation
  dtype (``torch.mm``: f32 accumulation in bf16 on the card), and the
  rows weighted and added back to their tokens at f32 (``index_add_``).
  The JAX package's ``lax.ragged_dot`` is an XLA op, not a Pallas
  kernel: its port is the library product. Top-k keeps JAX's tie rule
  (``lax.top_k``: the lower expert index first), which ``torch.topk``
  does not: a stable descending sort gives it.

The per-expert loop needs each expert's row count on the host: one
device-to-host read per MoE layer (``moe_ffn_ragged.host_reads``).
Gated experts in bf16 take no loop and no read: each of their three
products is one grouped product over every expert (``_grouped``), the
row counts kept on the card as offsets. The expert product launches are
counted in ``moe_ffn_ragged.expert_gemms`` (two per non-empty expert;
three a layer for grouped gated experts). The profiler sees three spans
(``utils.spans``): ``moe_dispatch`` (router, top-k, sort, gather, the
weighted ``index_add_``), ``moe_expert_gemm`` (the products, and the
shared expert whole) and ``moe_expert_ops`` (the weight casts, the up
bias and the activation).

Expert weights are never quantized (``models.params.quantize_params``
keeps them dense; a shared expert is quantized like a dense MLP); the
router stays f32.

Expert parallelism (``moe_ffn``'s ``ep_axis``, a
``parallel.sharding.ModelAxis``): shard r holds experts r*e .. r*e + e - 1
and runs them densely on every token it sees, weighted by its slice of
the routing; one program drives every shard of a process, as the JAX
package's ``shard_map`` does, and the axis's group joins the processes
where it crosses them. Two token layouts, the JAX package's schedules:
"sharded" (each shard's own tokens: all-gather, then the summed
contributions scattered back) and "replicated" (every shard sees every
token, as under Megatron TP: one sum, ``models.bert._moe_half``).
"""

from __future__ import annotations

import torch
from ..utils.spans import span
from .linear import _activate, linear

Params = dict


def route_probs(x: torch.Tensor, router_w: torch.Tensor,
                router_b: torch.Tensor | None) -> torch.Tensor:
    """Router softmax over all experts, in f32: [T, D] -> [T, E]."""
    logits = x.float() @ router_w.float()
    if router_b is not None:
        logits = logits + router_b.float()
    return torch.softmax(logits, dim=-1)


def route_topk(x: torch.Tensor, router_w: torch.Tensor,
               router_b: torch.Tensor | None, *, top_k: int,
               normalize: bool = False) -> torch.Tensor:
    """Per-token expert weights [T, E]: the softmax probabilities that
    reach the k-th largest (ties keep more than k), zeros elsewhere;
    ``normalize`` rescales the kept weights to sum to 1."""
    probs = route_probs(x, router_w, router_b)
    kth = torch.topk(probs, top_k, dim=-1).values[..., -1:]
    weights = torch.where(probs >= kth, probs, torch.zeros_like(probs))
    if normalize:
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights


def topk_lower_first(probs: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest per row, ties broken by the
    lower index first (``lax.top_k``'s rule)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x, moe, *, top_k: int, act: str, normalize_topk: bool = False,
            ep_axis=None, ep_tokens: str = "sharded"):
    """Dense-evaluation MoE FFN on [T, D] tokens -> [T, D]: every expert
    on every token (``linear``'s f32 product), combined at f32 with the
    ``route_topk`` weights, the shared ``bias`` added after the combine.

    moe: router {w [D, E], b [E]?}, up {w [E, D, I], b [E, I]}, down {w
    [E, I, D], b [E, D]}, optional bias [D].

    With ``ep_axis`` (expert parallelism), ``moe`` is the list of this
    process's shards' params of the axis, local shard r (axis index
    ``ep_axis.first + r``) with up / down holding its e experts on their
    leading axis (router and bias replicated), and each shard runs its
    experts on every token with its slice of the routing weights:

    * ep_tokens="sharded": x is the list of the local shards' tokens
      [T_r, D]; they are all-gathered, and the summed contributions
      scattered back: returns the list of the local shards' outputs;
    * ep_tokens="replicated": x holds every token, on the axis's home
      device (the Megatron-TP layout); one sum joins the contributions:
      returns [T, D] there.

    Either way the result is the one-device evaluation's up to the f32
    order of the sum."""
    if ep_axis is None:
        weights = route_topk(x, moe["router"]["w"], moe["router"].get("b"),
                             top_k=top_k, normalize=normalize_topk)
        out = _dense_experts(x, moe, weights, act)
        if "bias" in moe:
            out = out + moe["bias"].float()
        return out.to(x.dtype)
    if ep_tokens not in ("sharded", "replicated"):
        raise ValueError(f"ep_tokens must be 'sharded' or 'replicated', "
                         f"got {ep_tokens!r}")
    x_all = ep_axis.all_gather(x, 0) if ep_tokens == "sharded" else x
    m0 = moe[0]  # the replicated router and bias
    weights = route_topk(x_all, m0["router"]["w"], m0["router"].get("b"),
                         top_k=top_k, normalize=normalize_topk)  # [T, E]
    parts = []
    for r, m in enumerate(moe):
        e, g = m["up"]["w"].shape[0], ep_axis.first + r  # g: axis index
        parts.append(_dense_experts(ep_axis.on(r, x_all), m, ep_axis.on(
            r, weights[:, g * e:(g + 1) * e]), act))
    if ep_tokens == "replicated":
        out = ep_axis.psum(parts)
        if "bias" in m0:
            out = out + m0["bias"].float()
        return out.to(x_all.dtype)
    outs = ep_axis.psum_scatter(parts, 0)
    if "bias" in m0:
        outs = [o + m0["bias"].float().to(o.device) for o in outs]
    return [o.to(x_all.dtype) for o in outs]


def _dense_experts(x: torch.Tensor, moe: Params, weights: torch.Tensor,
                   act: str) -> torch.Tensor:
    """sum_e weights[:, e] * down_e(act(up_e(x))) over the stack's experts,
    at f32 ([T, D] f32)."""
    out = torch.zeros(x.shape[0], moe["down"]["w"].shape[-1],
                      dtype=torch.float32, device=x.device)
    for e in range(moe["up"]["w"].shape[0]):
        h = linear(x, moe["up"]["w"][e], moe["up"]["b"][e], act=act)
        y = linear(h, moe["down"]["w"][e], moe["down"]["b"][e])
        out = out + weights[:, e:e + 1] * y.float()
    return out


def moe_ffn_ragged(x: torch.Tensor, moe: Params, *, top_k: int, act: str,
                   normalize_topk: bool = False, scaling: float = 1.0,
                   use_kernels: bool = True,
                   int8: bool = False) -> torch.Tensor:
    """Sparse-dispatch MoE FFN on [T, D] tokens -> [T, D]: only the
    selected experts' products run (k/E of ``moe_ffn``'s). Numerics
    match ``moe_ffn`` up to f32 summation order (and, in bf16, the
    expert products' rounding). ``scaling``: DeepSeek-V2's
    routed_scaling_factor on the kept probabilities; a ``shared`` expert
    runs on every token through ``linear`` (``use_kernels`` and ``int8``
    as there) and adds at f32 before the cast."""
    T, D = x.shape
    E = moe["router"]["w"].shape[-1]
    with span("moe_dispatch"):
        probs = route_probs(x, moe["router"]["w"], moe["router"].get("b"))
        top_w, top_e = topk_lower_first(probs, top_k)        # [T, k]
        if normalize_topk:
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        if scaling != 1.0:
            top_w = top_w * scaling
        flat_e = top_e.reshape(-1)                             # [T*k]
        order = torch.argsort(flat_e, stable=True)             # by expert
        t_sorted = order // top_k                              # its token
        e_sorted = flat_e[order]
        counts = torch.bincount(flat_e, minlength=E)
        if "gate" not in moe:
            counts = counts.tolist()                           # host read
            moe_ffn_ragged.host_reads += 1
        xs = x[t_sorted]                                       # [T*k, D]
    y = (_ragged_gated(xs, counts, moe, act) if "gate" in moe
         else _ragged_mlp(xs, counts, moe, act, x.dtype))
    with span("moe_dispatch"):
        y = y.float()
        if "b" in moe["down"]:
            y = y + moe["down"]["b"].float()[e_sorted]
        y = y * top_w.reshape(-1)[order][:, None]
        out = torch.zeros(T, D, dtype=torch.float32, device=x.device)
        out.index_add_(0, t_sorted, y)
        if "bias" in moe:
            out = out + moe["bias"].float()
    if "shared" in moe:
        with span("moe_expert_gemm"):
            out += _shared_expert(x, moe["shared"], act, use_kernels,
                                  int8).float()
    return out.to(x.dtype)


def _shared_expert(x: torch.Tensor, m: Params, act: str, use_kernels: bool,
                   int8: bool) -> torch.Tensor:
    """DeepSeek-V2's shared expert on every token: down(act(gate x) * up
    x), quantized linears (K1 on the card), the product in x's dtype."""
    mode = dict(use_kernels=use_kernels, int8=int8)
    h = (linear(x, m["gate"]["w"], m["gate"]["b"], act=act, **mode)
         * linear(x, m["up"]["w"], m["up"]["b"], **mode))
    return linear(h, m["down"]["w"], m["down"]["b"], **mode)


moe_ffn_ragged.host_reads = 0
moe_ffn_ragged.expert_gemms = 0


def _ragged_mlp(xs: torch.Tensor, counts: list[int], moe: Params,
                act: str, dtype) -> torch.Tensor:
    """down_e(act(xs_e @ up_e + up_b[e])) over expert-sorted rows (in
    ``dtype``), one pair of products per non-empty expert on its
    contiguous slice, the weights cast to ``dtype`` (the JAX package's
    ``astype(dtype)``), the up bias added in the product's dtype."""
    out = torch.empty(xs.shape[0], moe["down"]["w"].shape[-1], dtype=dtype,
                      device=xs.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        rows = slice(start, start + n)
        start += n
        with span("moe_expert_ops"):
            up_w = moe["up"]["w"][e].to(dtype)
            down_w = moe["down"]["w"][e].to(dtype)
        with span("moe_expert_gemm"):
            h = torch.mm(xs[rows], up_w)
        with span("moe_expert_ops"):
            h = _activate(h + moe["up"]["b"][e].to(h.dtype), act)
        with span("moe_expert_gemm"):
            torch.mm(h, down_w, out=out[rows])
        moe_ffn_ragged.expert_gemms += 2
    return out


def _ragged_gated(xs: torch.Tensor, counts: torch.Tensor, moe: Params,
                  act: str) -> torch.Tensor:
    """down_e(act(xs_e @ gate_e) * (xs_e @ up_e)) over expert-sorted rows,
    for gated experts without biases (DeepSeek-V2's), ``counts`` [E] the
    rows of each expert, on the device. The stacks must be held in xs's
    dtype (``models.params.hold_gated_experts``): a cast here would copy
    every expert of the layer on every call."""
    ws = [moe[k]["w"] for k in ("gate", "up", "down")]
    if any(w.dtype != xs.dtype for w in ws):
        raise TypeError(f"gated experts held in {[w.dtype for w in ws]}, "
                        f"rows in {xs.dtype}: hold them in the compute "
                        "dtype (models.params.hold_gated_experts)")
    mm = _grouped(counts, xs.dtype)
    with span("moe_expert_gemm"):
        g, u = mm(xs, ws[0]), mm(xs, ws[1])
    with span("moe_expert_ops"):
        h = _activate(g, act).mul_(u)
    with span("moe_expert_gemm"):
        return mm(h, ws[2])


def _grouped(counts: torch.Tensor, dtype):
    """The product of expert-sorted rows [M, K] with an expert stack [E,
    K, N], expert e's rows the e-th slice of ``counts``: in bf16 one
    grouped product (``torch._grouped_mm``, the slices' ends as int32
    offsets on the device: no host read, one launch); in another dtype
    one ``torch.mm`` a non-empty expert after one host read of the
    counts."""
    if dtype == torch.bfloat16:
        ends = counts.cumsum(0).to(torch.int32)

        def mm(a, w):
            moe_ffn_ragged.expert_gemms += 1
            return torch._grouped_mm(a, w, offs=ends)
        return mm
    rows = counts.tolist()
    moe_ffn_ragged.host_reads += 1

    def mm(a, w):
        moe_ffn_ragged.expert_gemms += sum(n > 0 for n in rows)
        return torch.cat([torch.mm(p, w[e])
                          for e, p in enumerate(a.split(rows))])
    return mm
