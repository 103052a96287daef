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
  rows weighted and added back to their tokens at f32 in one pass
  (``combine_experts``: on the card the hand-written
  ``csrc/moe_combine.cu``, with the down bias, the output bias and the
  shared expert, no atomics). The JAX package's ``lax.ragged_dot`` is an
  XLA op, not a Pallas kernel: its port is the library product; its
  segment-sum combine has no Pallas kernel either. Top-k keeps JAX's tie
  rule (``lax.top_k``: the lower expert index first), which
  ``torch.topk`` does not: a stable descending sort gives it.

The per-expert loop needs each expert's row count on the host: one
device-to-host read per MoE layer (``moe_ffn_ragged.host_reads``).
Gated experts in bf16 take no loop and no read: each of their three
products is one grouped product over every expert (``_grouped``), the
row counts kept on the card as offsets. The expert product launches are
counted in ``moe_ffn_ragged.expert_gemms`` (two per non-empty expert;
three a layer for grouped gated experts), the combine's launches in
``moe_ffn_ragged.combines`` (one a MoE layer on the card, none on the
CPU). The profiler sees three spans (``utils.spans``): ``moe_dispatch``
(router, top-k, sort, gather, the combine), ``moe_expert_gemm`` (the
products, and the shared expert whole) and ``moe_expert_ops`` (the
weight casts, the up bias and the activation).

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
    as there) and adds at f32 in the combine, before the cast."""
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
        counts = torch.bincount(flat_e, minlength=E)
        if "gate" not in moe:
            counts = counts.tolist()                           # host read
            moe_ffn_ragged.host_reads += 1
        xs = x[t_sorted]                                       # [T*k, D]
    y = (_ragged_gated(xs, counts, moe, act) if "gate" in moe
         else _ragged_mlp(xs, counts, moe, act, x.dtype))
    shared = None
    if "shared" in moe:
        with span("moe_expert_gemm"):
            shared = _shared_expert(x, moe["shared"], act, use_kernels, int8)
    with span("moe_dispatch"):
        return combine_experts(y, top_w, flat_e, order,
                               down_b=moe["down"].get("b"),
                               bias=moe.get("bias"), shared=shared)


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
moe_ffn_ragged.combines = 0


_DTYPE_ID = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def combine_experts(y: torch.Tensor, top_w: torch.Tensor,
                    experts: torch.Tensor, order: torch.Tensor, *,
                    down_b: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None,
                    shared: torch.Tensor | None = None) -> torch.Tensor:
    """The routed experts' rows back on their tokens: out[t] = sum_j
    top_w[t, j] * (y[row of (t, j)] + down_b[experts[t*k + j]]) + bias +
    shared[t], at f32, cast to y's dtype. y [T*k, D] holds the rows in
    expert order (sorted row i is pair ``order[i]`` = t*k + j), top_w [T,
    k] the f32 weights and experts [T*k] the experts in top-k order;
    down_b [E, D], bias [D] and shared [T, D] are optional. A CUDA tensor
    launches ``csrc/moe_combine.cu`` (counted in
    ``moe_ffn_ragged.combines``); a CPU tensor runs ``_combine_plain``,
    the same operations in the same order."""
    if y.device.type == "cpu":
        return _combine_plain(y, top_w, experts, order, down_b=down_b,
                              bias=bias, shared=shared)
    T, k = top_w.shape
    n, D = y.shape
    if y.dtype not in _DTYPE_ID:
        raise TypeError(f"the CUDA combine takes bf16, f16 or f32 rows, "
                        f"got {y.dtype}")
    if n != T * k:
        raise ValueError(f"y holds {n} rows for {T} tokens of {k} experts")
    if n >= 2 ** 31:
        raise ValueError(f"{n} (token, expert) pairs: the combine indexes "
                         f"rows in 32 bits")
    if top_w.dtype != torch.float32 or top_w.stride(1) != 1:
        raise TypeError("top_w must be f32 with unit column stride")
    for name, t in (("experts", experts), ("order", order)):
        if t.dtype != torch.int64 or t.shape != (n,) or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int64 [{n}]")
    if shared is not None and (shared.dtype != y.dtype
                               or shared.shape != (T, D)):
        raise TypeError(f"shared must be {y.dtype} [{T}, {D}], got "
                        f"{shared.dtype} {tuple(shared.shape)}")
    if down_b is not None and down_b.shape[-1] != D:
        raise ValueError(f"down_b must be [E, {D}]")
    if bias is not None and bias.shape != (D,):
        raise ValueError(f"bias must be [{D}]")
    if not y.is_contiguous() or (shared is not None
                                 and not shared.is_contiguous()):
        raise ValueError("y and shared must be contiguous")
    down_b, bias = (None if b is None else b.float().contiguous()
                    for b in (down_b, bias))
    out = torch.empty(T, D, dtype=y.dtype, device=y.device)
    if T == 0 or D == 0:
        return out
    pos = torch.empty(n, dtype=torch.int32, device=y.device)
    lib = _lib()
    from ._cuda import check, on_device
    from .qmatmul import _ptr
    with on_device("combine_experts", y.device, top_w=top_w,
                   experts=experts, order=order, down_b=down_b, bias=bias,
                   shared=shared):
        status = lib.moe_combine_launch(
            y.data_ptr(), order.data_ptr(), pos.data_ptr(), top_w.data_ptr(),
            top_w.stride(0), experts.data_ptr(), _ptr(down_b), _ptr(bias),
            _ptr(shared), out.data_ptr(), T, k, D, _DTYPE_ID[y.dtype],
            torch.cuda.current_stream(y.device).cuda_stream)
    check(status, lib.moe_error_string, "combine_experts")
    moe_ffn_ragged.combines += 1
    return out


def expert_positions(order: torch.Tensor) -> torch.Tensor:
    """The inverse of the expert sort: pos[order[i]] = i, so pair t*k + j
    sits in sorted row pos[t*k + j] (the CUDA combine's first kernel)."""
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    return pos


def _combine_plain(y, top_w, experts, order, *, down_b=None, bias=None,
                   shared=None) -> torch.Tensor:
    """``combine_experts`` in torch ops: each token's k rows gathered
    through ``expert_positions`` and added at f32 in top-k order, then
    the bias and the shared expert."""
    T, k = top_w.shape
    pos = expert_positions(order).reshape(T, k)
    e = experts.reshape(T, k)
    acc = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    for j in range(k):
        r = y[pos[:, j]].float()
        if down_b is not None:
            r = r + down_b.float()[e[:, j]]
        acc = acc + top_w[:, j:j + 1] * r
    if bias is not None:
        acc = acc + bias.float()
    if shared is not None:
        acc = acc + shared.float()
    return acc.to(y.dtype)


def _lib():
    import ctypes
    from . import _cuda
    lib = _cuda.load("moe_combine")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_combine_launch.argtypes = ([p] * 4 + [i] + [p] * 5 + [i] * 4
                                           + [p])
        lib.moe_combine_launch.restype = i
        lib.moe_error_string.argtypes = [i]
        lib.moe_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


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
