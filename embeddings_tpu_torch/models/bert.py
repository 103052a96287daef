"""BERT encoder forward of the PyTorch port — the port of
``embeddings_tpu/models/bert.py`` for the post-LN BERT families (plain
BERT, RoBERTa and DistilBERT, ALBERT with its factorized embeddings and
one shared layer, MPNet with its relative-position bias, jina-bert-v2
with ALiBi and a GeGLU MLP, nomic-bert with RoPE and SwiGLU or, in
nomic-embed-text-v2-moe, a mixture-of-experts FFN at every odd layer,
RoFormer with interleaved RoPE): embedding sum + LayerNorm (+ ALBERT's
projection), N layers of {prefix-masked multi-head self-attention,
residual + LN, GELU or gated FFN, residual + LN}; and for the pre-norm
ModernBERT stack (``encoder_layer_pre``: RoPE with a global and a local
theta, global attention every n-th layer and a sliding window on the
others, GeGLU, a final norm) and the Qwen2 decoder embedders on the same
pre-norm stack (RMSNorm, grouped-query attention, SwiGLU, causal or
bidirectional attention, last-token pooling), and DeepSeek-V2 there too
(the port's own: MLA, ``mla_context``; a leading dense layer, then MoE
layers of gated experts with a shared expert, ``_moe_half_pre``); then
pooling (cls / mean / max / lasttoken), SentenceTransformers Dense layers
and the L2 norm.

``encode_tokens`` runs right-padded batches; ``encode_packed`` runs
token-packed rows (``runtime/packing.py``: several sentences per row,
segment ids, per-segment positions, a pooling matrix); ``score_pairs``
puts a cross-encoder's classification head on ``encode_tokens``' CLS
rows.

The JAX package scans one compiled layer body over stacked parameters;
here a Python loop walks the layers eagerly (``layer_views``: ALBERT's
one stored layer, num_hidden_layers times). ``use_kernels`` picks the
path: True runs quantized matmuls through ``ops.qmatmul.qmatmul`` (K1, or
K3 with ``int8``) and attention through the fused kernels the JAX
package's route rule picks (``attention_route_name``) — prefix-masked K2
for padded batches, K7 with a family's logit bias, K6 for long rows and
ALiBi past K7's cap, the banded K6w on ModernBERT's local layers, the
causal K6c on causal Qwen2 rows, segment-masked K4 or its block-skipping
K5 for packed rows — on a CUDA
tensor, their plain versions on a CPU tensor;
False runs the plain f32 reference math (dequantize + matmul, the int8
emulation with ``int8``, exact-erf GELU, additive-mask einsum attention
with the family bias and the causal triangle folded into the mask), the
JAX package's XLA fallback. ``int8`` is
``EngineConfig.int8_compute``, passed down explicitly.

Chained int8 (``_int8_chain_ok``: int8 with the kernels, a post-LN
encoder with fused qkv, a plain MLP and four quantized weights): the
link set of ``ops.linear.chain_links`` makes producers emit int8 rows
that the next matmul reads as they are — "attn" the whole-row (K2e) or
segmented (K4e) attention, "ln" the two residual-LN matmuls (the layer
then carries (x, xq)), "ffn" the FFN-up matmul. The int8-scores switch
(``ops.attention.int8_scores_mode``) puts K2 on its int8 branch (K2i8).
``encode_tokens`` / ``encode_packed`` read both switches once at entry
and pass them down as arguments; by default (no links, scores "off") the
forward is the unchained one.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..config import BertConfig
from ..ops import attention as attn_ops
from ..ops.linear import ActQ, _reshape_actq, active_chain_links, linear, \
    linear_residual_ln, quantize_act
from ..ops.quant import QuantizedTensor, gather_rows
from ..ops.rotary import apply_rotary, apply_rotary_qkv, rope_tables, \
    rope_tables_for, yarn_mscale, yarn_tables, yarn_tables_for
from ..utils.spans import span
from .params import check_supported, layer as layer_params

Params = dict[str, Any]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm over the last axis (no mean subtraction, no bias), computed
    in f32 — the Qwen2 decoder block's norm."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def embed(params: Params, config: BertConfig, token_ids: torch.Tensor,
          type_ids: torch.Tensor | None = None,
          position_ids: torch.Tensor | None = None) -> torch.Tensor:
    """word + token-type + position embedding sum, then LayerNorm. A
    quantized word table dequantizes only the gathered rows.
    position_ids [B, L] overrides the default 0..L-1 (token-packed rows
    restart positions at each segment). ALiBi and rotary models have no
    position table; a tree without an embedding norm returns the bare
    sum."""
    L = token_ids.shape[1]
    emb = params["embeddings"]
    ids = token_ids.long()
    if isinstance(emb["word"], QuantizedTensor):
        x = gather_rows(emb["word"], ids)
    else:
        x = emb["word"][ids]
    if type_ids is None:
        x = x + emb["token_type"][0]
    else:
        x = x + emb["token_type"][type_ids.long()]
    if "position" in emb:
        off = config.position_offset
        if position_ids is None:
            x = x + emb["position"][off:off + L]
        else:
            x = x + emb["position"][position_ids.long() + off]
    if "ln" not in emb:
        return x
    return layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"],
                      config.layer_norm_eps)


def _project_embeddings(params: Params, x: torch.Tensor) -> torch.Tensor:
    """ALBERT's factorized embeddings (and RoFormer's): project [B, L, Ee]
    -> [B, L, E] before the encoder (HF's embedding_hidden_mapping_in), a
    dense product. No-op for models without a projection."""
    proj = params["embeddings"].get("proj")
    if proj is None:
        return x
    return linear(x, proj["w"], proj["b"])


def layer_views(params: Params, config: BertConfig):
    """The layers a forward applies, in order (views, no copies): with
    ``shared_layers`` (ALBERT) the one stored layer num_hidden_layers
    times, in a mixture-of-experts tree dense[0], moe[0], dense[1], ...
    (``params.layer``), else each stacked layer — the JAX package's
    ``_scan_layers``."""
    if config.shared_layers:
        shared = layer_params(params, 0)
        return [shared] * config.num_hidden_layers
    return [layer_params(params, i, config.first_k_dense_replace)
            for i in range(config.num_hidden_layers)]


def _relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5/MPNet bidirectional relative-position bucketing, the JAX
    package's f32 arithmetic step for step: half the buckets for each
    sign; within a sign, exact buckets up to num_buckets/4, then
    log-spaced out to max_distance. Where the exact value is an integer
    one f32 ulp moves a pair into the next bucket, so the f32 operations
    keep the JAX package's order, and the divisors are tensors: CUDA
    turns a division by a Python scalar into a reciprocal multiply."""
    n = -rel
    half = num_buckets // 2
    ret = torch.where(n < 0, half, 0)
    n = n.abs()
    max_exact = half // 2
    f32 = dict(dtype=torch.float32, device=rel.device)
    x = torch.log(n.clamp_min(1).to(torch.float32)
                  / torch.tensor(float(max_exact), **f32))
    x = x / torch.tensor(math.log(max_distance / max_exact), **f32)
    x = x * torch.tensor(float(half - max_exact), **f32)
    val_if_large = (max_exact + x.to(torch.int32)).clamp_max(half - 1)
    return ret + torch.where(n < max_exact, n, val_if_large)


def relative_attention_bias(table: torch.Tensor, position_ids: torch.Tensor,
                            config: BertConfig) -> torch.Tensor:
    """MPNet relative position bias: [num_buckets, H] table -> additive
    [B, H, Lq, Lk] f32 attention-logit bias (position_ids [B, L], or
    [1, L] for 0..L-1). The bucket of every distance in [-(P-1), P-1], P
    the largest position + 1, is computed once on the CPU (the arithmetic
    the tests hold to the JAX package's) and gathered on the table's
    device."""
    P = int(position_ids.max()) + 1
    buckets = _relative_position_bucket(
        torch.arange(-(P - 1), P), config.relative_attention_num_buckets,
        config.relative_attention_max_distance).to(table.device)
    pos = position_ids.to(table.device).long()
    rel = pos[:, None, :] - pos[:, :, None]              # [B, L, L]
    values = table.float()[buckets[rel + (P - 1)]]       # [B, L, L, H]
    return values.permute(0, 3, 1, 2)


def alibi_attention_bias(slopes: torch.Tensor,
                         position_ids: torch.Tensor) -> torch.Tensor:
    """Symmetric (encoder) ALiBi: additive [B, H, Lq, Lk] f32 bias
    ``-slope_h * |pos_i - pos_j|`` (position_ids [B, L] or [1, L])."""
    pos = position_ids.to(slopes.device).long()
    dist = (pos[:, None, :] - pos[:, :, None]).abs()      # [B, L, L]
    return (-slopes.float()[None, :, None, None]
            * dist[:, None].to(torch.float32))


def _logit_bias(params: Params, config: BertConfig,
                position_ids: torch.Tensor) -> torch.Tensor | None:
    """The family's additive attention-logit bias ([B|1, H, L, L] f32),
    or None: MPNet's bucketed relative-position table or jina-bert-v2's
    ALiBi penalty. Both depend on positions only, so callers compute it
    once per forward for all layers."""
    rel = params.get("rel_bias")
    if rel is not None:
        return relative_attention_bias(rel, position_ids, config)
    slopes = params.get("alibi_slopes")
    if slopes is not None:
        return alibi_attention_bias(slopes, position_ids)
    return None


def attention_route_name(L: int, E: int, *, segmented: bool = False,
                         attn_window: int = 0, bias: bool = False,
                         alibi: bool = False, local_window: bool = False,
                         causal: bool = False, mla: bool = False) -> str:
    """The fused kernel ``_fused_attn_dispatch`` picks — the JAX
    package's ``attention_route_name`` for the routes the port has:
    "cond(stream|windowed)" for ModernBERT's alternating layers (a local
    layer takes K6w, a global one the route below); "fused_bias" (K7)
    with a logit-bias operand; for packed rows "segmented_blockskip" (K5)
    when the window skips at least two key blocks, else "segmented" (K4);
    "stream_alibi" (K6, in-kernel ALiBi); "stream_causal" (K6c, at every
    length; "stream_causal_mla" at MLA's head widths, the port's own);
    "stream" (K6) for rows whose whole K/V would not fit the TPU's VMEM
    (``whole_row_fits``: L >= 1920 at E=768, L >= 1024 at E=1536); else
    "whole_row" (K2)."""
    if mla:
        if not causal:
            raise ValueError("MLA's kernel route is the causal one")
        return "stream_causal_mla"
    if local_window:
        return "cond(stream|windowed)"
    if bias:
        return "fused_bias"
    if segmented:
        nK = L // attn_ops.BQ
        if (L > attn_ops.BQ and L % attn_ops.BQ == 0
                and 0 < attn_window <= nK - 2):
            return "segmented_blockskip"
        return "segmented"
    if alibi:
        return "stream_alibi"
    if causal:
        return "stream_causal"
    if not attn_ops.whole_row_fits(L, E):
        return "stream"
    return "whole_row"


def _fused_attn_dispatch(qkv2d, lengths, segments, B, L, H, D,
                         attn_window=0, ranges=None, bias=None, alibi=None,
                         local_window=None, causal=False, emit_int8=False,
                         int8_scores=False):
    """The route's kernel on qkv2d. ``emit_int8``: the whole-row (K2) and
    segmented (K4) routes return the context as an ActQ, quantized in the
    kernel (where ``emit_supported``); other routes return it in the
    compute dtype, and the o-projection quantizes its rows itself.
    ``int8_scores``: K2 runs its int8 branch (the whole-row route only)."""
    kw = dict(B=B, L=L, H=H, D=D)
    emit = "only" if emit_int8 and attn_ops.emit_supported(H) else "no"
    if local_window is not None:
        # ModernBERT's alternating layers, picked per layer here where the
        # JAX package runs a lax.cond: a local layer takes the banded
        # kernel, a global one falls through to the global route
        is_global, window = local_window
        if not is_global:
            return attn_ops.fused_attention_window(qkv2d, lengths,
                                                   window=window, **kw)
    route = attention_route_name(L, H * D, segmented=segments is not None,
                                 attn_window=attn_window,
                                 bias=bias is not None,
                                 alibi=alibi is not None, causal=causal)
    if route == "fused_bias":
        # the family bias (MPNet relative positions, ALiBi on short rows)
        return attn_ops.fused_attention_bias(qkv2d, lengths, bias, **kw)
    if route == "segmented_blockskip":
        # long packed rows with a known small window: only key blocks
        # sharing a segment with the query block are computed
        return attn_ops.fused_attention_segmented_blockskip(
            qkv2d, segments, window=attn_window, ranges=ranges, **kw)
    if route == "segmented":
        out = attn_ops.fused_attention_segmented(qkv2d, segments,
                                                 emit_quantized=emit, **kw)
        return ActQ(*out) if emit == "only" else out
    if route in ("stream_alibi", "stream_causal", "stream"):
        # the streaming kernel's mask modes: in-kernel ALiBi, causal (the
        # decoder embedders: K6c), or plain
        return attn_ops.fused_attention_stream(
            qkv2d, lengths, BK=attn_ops.pick_bk(L), alibi_slopes=alibi,
            causal=causal, **kw)
    out = attn_ops.fused_attention(qkv2d, lengths, emit_quantized=emit,
                                   int8_scores=int8_scores, **kw)
    return ActQ(*out) if emit == "only" else out


def fused_attention_ok(L: int, H: int, D: int, use_kernels: bool,
                       lengths, segments, alibi=None,
                       local_window=None, causal: bool = False,
                       lane: int = attn_ops.LANE,
                       dv: int | None = None) -> bool:
    """Does attention take a fused kernel (else the einsum path)? The
    JAX package's ``_attn_kernels_ok`` for the port's routes; with a
    ``local_window`` both of its kernels must take the shape (the banded
    one's rule, 128-key blocks, covers the global route's). ``lane``: the
    rule on H*D — the JAX package's 128 lanes, or under tensor
    parallelism the kernels' own (``attn_ops.KERNEL_LANE``). ``dv``: MLA's
    value width beside q and k heads D wide, which only the causal
    streaming kernel takes (prefix lengths, no family bias)."""
    if not use_kernels or (lengths is None and segments is None):
        return False
    if dv is not None and dv != D:
        return (causal and segments is None and alibi is None
                and local_window is None
                and attn_ops.stream_supported(L, H, D, attn_ops.pick_bk(L),
                                              lane, dv))
    if segments is not None:
        return attn_ops.supported(L, H, D, lane)
    if local_window is not None:
        return attn_ops.stream_supported(L, H, D, attn_ops.BQ, lane)
    if (alibi is not None or causal
            or not attn_ops.whole_row_fits(L, H * D)):
        return attn_ops.stream_supported(L, H, D, attn_ops.pick_bk(L), lane)
    return attn_ops.supported(L, H, D, lane)


def attention_context(layer: Params, config: BertConfig, x: torch.Tensor,
                      mask_bias: torch.Tensor | None,
                      lengths: torch.Tensor | None = None, *,
                      segments: torch.Tensor | None = None,
                      attn_window: int = 0, ranges=None,
                      bias: torch.Tensor | None = None,
                      alibi: torch.Tensor | None = None,
                      rope: tuple[torch.Tensor, torch.Tensor] | None = None,
                      local_window: tuple[bool, int] | None = None,
                      causal: bool = False,
                      use_kernels: bool = True,
                      int8: bool = False, xq: ActQ | None = None,
                      emit_int8: bool = False,
                      int8_scores: bool = False,
                      lane: int = attn_ops.LANE) -> torch.Tensor | ActQ:
    """Masked multi-head self-attention up to (not including) the output
    projection: [B, L, E] -> [B, L, E] context (under tensor parallelism
    [B, L, E/tp]: the head count comes from the projection's width, and
    ``lane`` is ``fused_attention_ok``'s). With prefix ``lengths``
    (or packed ``segments``), ``use_kernels`` and a shape the fused
    kernels take, attention reads the fused qkv projection in place (the
    kernel ``attention_route_name`` picks: ``bias`` is K7's
    ``prepare_attention_bias`` operand, ``alibi`` K6's slopes, ``ranges``
    K5's ``block_ranges``, each computed once per forward;
    ``local_window`` = (is_global, window) picks K6w on ModernBERT's local
    layers; ``causal`` K6c); otherwise the additive-mask einsum path,
    with ``mask_bias`` [B, 1 or H, 1 or L, L] (the family bias, the
    sliding window or the causal triangle already folded in). ``rope`` =
    (cos, sin) rotates q and k before either path. With grouped-query
    attention (k/v narrower than q, never fused) each K/V head is
    repeated over its group of query heads before the concat, so the
    kernels read the [B*L, 3E] layout they always do. Chained int8: ``xq``
    (x's int8 rows) feeds the fused qkv projection in place of x, and
    ``emit_int8`` returns the context as an ActQ where the route's kernel
    emits (``_fused_attn_dispatch``); ``int8_scores`` runs K2's int8
    branch."""
    B, L, _ = x.shape
    D = config.head_dim
    a = layer["attn"]
    mode = dict(use_kernels=use_kernels, int8=int8)
    if "qkv" in a:
        qkv = linear(xq if xq is not None else x, a["qkv"]["w"],
                     a["qkv"]["b"], **mode)                 # [B, L, 3E]
    else:
        q, k, v = (linear(x, a[n]["w"], a[n]["b"], **mode)
                   for n in ("q", "k", "v"))
        if k.shape[-1] != q.shape[-1]:
            # HF repeat_kv order: query head h reads K/V head h // rep
            rep = q.shape[-1] // k.shape[-1]
            k, v = (t.reshape(B, L, -1, D).repeat_interleave(rep, dim=2)
                    .reshape(B, L, -1) for t in (k, v))
        qkv = torch.cat([q, k, v], -1)
    El = qkv.shape[-1] // 3
    H = El // D
    if rope is not None:
        qkv = apply_rotary_qkv(qkv, *rope, H=H, D=D,
                               interleaved=config.rotary_interleaved)
    if fused_attention_ok(L, H, D, use_kernels, lengths, segments, alibi,
                          local_window, causal, lane):
        ctx = _fused_attn_dispatch(qkv.reshape(B * L, 3 * El), lengths,
                                   segments, B, L, H, D, attn_window, ranges,
                                   bias, alibi, local_window, causal,
                                   emit_int8, int8_scores)
        if isinstance(ctx, ActQ):
            return _reshape_actq(ctx, B, L)
        return ctx.reshape(B, L, El)
    q = qkv[..., :El].reshape(B, L, H, D)
    k = qkv[..., El:2 * El].reshape(B, L, H, D)
    v = qkv[..., 2 * El:].reshape(B, L, H, D)
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(D)) + mask_bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhlm,bmhd->blhd", probs.float(), v.float())
    return ctx.to(x.dtype).reshape(B, L, El)


def _act(config: BertConfig) -> str:
    """The config's hidden activation as ``ops.linear`` names it (exact
    GELU unless the config says otherwise)."""
    return {"gelu_tanh": "gelu_tanh", "silu": "silu", "relu": "relu"}.get(
        config.hidden_act, "gelu")


def _ffn_hidden(m: Params, x: torch.Tensor | ActQ, config: BertConfig, *,
                use_kernels: bool = True, int8: bool = False,
                emit: str = "no"):
    """act(up(x)), or act(gate(x)) * up(x) for a gated MLP (jina's
    GeGLU): the activation fused into the up (gate) projection's kernel
    epilogue, the product a torch multiply in the compute dtype. x may be
    an ActQ; emit="only" returns the hidden as an ActQ quantized in the up
    projection's epilogue (plain MLPs only)."""
    act = _act(config)
    mode = dict(use_kernels=use_kernels, int8=int8)
    if "gate" in m:
        if emit != "no":
            raise ValueError("a gated MLP does not chain int8 emission")
        return (linear(x, m["gate"]["w"], m["gate"]["b"], act=act, **mode)
                * linear(x, m["up"]["w"], m["up"]["b"], **mode))
    return linear(x, m["up"]["w"], m["up"]["b"], act=act, emit=emit, **mode)


def mla_softmax_scale(config: BertConfig) -> float:
    """MLA's softmax scale: qk_head_dim^-0.5, times mscale(factor,
    mscale_all_dim)^2 under YaRN (DeepSeek-V2's ``softmax_scale``)."""
    scale = config.qk_head_dim ** -0.5
    rs = dict(config.rope_scaling)
    if rs.get("mscale_all_dim"):
        m = yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
        scale = scale * m * m
    return scale


def mla_rope(config: BertConfig, positions: torch.Tensor):
    """MLA's (cos, sin) over the rotated qk_rope_head_dim: YaRN's tables
    where the config scales RoPE, else plain RoPE; positions [L] (cached
    per L) or [B, L] (packed rows)."""
    dim, base = config.qk_rope_head_dim, config.rotary_base
    if not config.rope_scaling:
        return _rope(positions, dim, base)
    if positions.dim() == 1:
        return yarn_tables_for(positions.shape[0], dim, base,
                               config.rope_scaling, positions.device)
    return tuple(t.to(positions.device) for t in yarn_tables(
        positions, dim, base, config.rope_scaling))


def mla_qkv(a: Params, config: BertConfig, xn: torch.Tensor,
            rope: tuple[torch.Tensor, torch.Tensor], *,
            use_kernels: bool = True, int8: bool = False) -> torch.Tensor:
    """Multi-head latent attention's rows, [B, L, H*(2*Dq + dv)]: q | k |
    v with q and k heads Dq = nope + rope wide and v heads dv wide (the
    layout the MLA kernel reads). q = xn Wq per head [q_n | q_r];
    [c | k_r] = xn Wkva, c RMS-normed, [k_n | v] = c Wkvb per head; q_r
    and k_r rotated by ``rope`` over interleaved pairs (HF's view(d/2,
    2).transpose and rotate_half give the same dot products), the one
    k_r written into every head's K. The projections run as ``linear``
    (K1 on the card); the rest under the span ``mla_latent``."""
    B, L, _ = xn.shape
    H, r = config.num_attention_heads, config.kv_lora_rank
    dn, dv = config.qk_nope_head_dim, config.v_head_dim
    Dq = config.qk_head_dim
    mode = dict(use_kernels=use_kernels, int8=int8)
    q = linear(xn, a["q"]["w"], a["q"]["b"], **mode).reshape(B, L, H, Dq)
    kva = linear(xn, a["kv_a"]["w"], a["kv_a"]["b"], **mode)
    with span("mla_latent"):
        c = rms_norm(kva[..., :r], a["latent"]["ln"]["scale"],
                     config.layer_norm_eps)
        kv = linear(c, a["kv_b"]["w"], a["kv_b"]["b"], **mode).reshape(
            B, L, H, dn + dv)
        qkv = torch.empty(B, L, H * (2 * Dq + dv), dtype=xn.dtype,
                          device=xn.device)
        qh = qkv[..., :H * Dq].view(B, L, H, Dq)
        kh = qkv[..., H * Dq:2 * H * Dq].view(B, L, H, Dq)
        qh[..., :dn] = q[..., :dn]
        qh[..., dn:] = apply_rotary(q[..., dn:], *rope, interleaved=True)
        kh[..., :dn] = kv[..., :dn]
        kh[..., dn:] = apply_rotary(kva[..., None, r:], *rope,
                                    interleaved=True)
        qkv[..., 2 * H * Dq:].view(B, L, H, dv).copy_(kv[..., dn:])
    return qkv


def mla_context(layer: Params, config: BertConfig, xn: torch.Tensor,
                mask_bias: torch.Tensor | None,
                lengths: torch.Tensor | None,
                rope: tuple[torch.Tensor, torch.Tensor], *,
                use_kernels: bool = True,
                int8: bool = False) -> torch.Tensor:
    """MLA up to (not including) the output projection: [B, L, E] ->
    [B, L, H*dv]. Causal rows with prefix ``lengths`` at a shape the
    kernel takes run the MLA kernel (``fused_attention_stream`` with
    ``dv``: K6c at MLA's widths, route "stream_causal_mla"); otherwise the
    einsum path, ``mask_bias`` carrying the pads (and the causal triangle)
    and the softmax at ``mla_softmax_scale``."""
    B, L, _ = xn.shape
    H, Dq, dv = (config.num_attention_heads, config.qk_head_dim,
                 config.v_head_dim)
    qkv = mla_qkv(layer["attn"], config, xn, rope, use_kernels=use_kernels,
                  int8=int8)
    scale = mla_softmax_scale(config)
    if fused_attention_ok(L, H, Dq, use_kernels, lengths, None,
                          causal=config.causal, dv=dv):
        return attn_ops.fused_attention_stream(
            qkv.reshape(B * L, -1), lengths, B=B, L=L, H=H, D=Dq,
            BK=attn_ops.pick_bk(L), causal=True, dv=dv,
            scale=scale).reshape(B, L, H * dv)
    q, k, v = qkv.split([H * Dq, H * Dq, H * dv], -1)
    scores = torch.einsum("blhd,bmhd->bhlm",
                          q.reshape(B, L, H, Dq).float(),
                          k.reshape(B, L, H, Dq).float())
    probs = torch.softmax(scores * scale + mask_bias, dim=-1).to(xn.dtype)
    ctx = torch.einsum("bhlm,bmhd->blhd", probs.float(),
                       v.reshape(B, L, H, dv).float())
    return ctx.to(xn.dtype).reshape(B, L, H * dv)


def _moe_half_pre(m: Params, config: BertConfig, x: torch.Tensor, *,
                  use_kernels: bool = True,
                  int8: bool = False) -> torch.Tensor:
    """The pre-norm MoE FFN half (DeepSeek-V2): x + moe(RMSNorm(x)), the
    routed experts through ``ops.moe.moe_ffn_ragged`` (sorted, grouped
    products, one host read) with the shared expert added there, over
    every slot of [B, L, E], padding included, as the post-LN half."""
    from ..ops.moe import moe_ffn_ragged
    B, L, E = x.shape
    hn = _norm(config, x, m["ln"])
    y = moe_ffn_ragged(hn.reshape(B * L, E), m, top_k=config.moe_top_k,
                       act=_act(config),
                       normalize_topk=config.moe_normalize_topk,
                       scaling=config.routed_scaling_factor,
                       use_kernels=use_kernels, int8=int8)
    return x + y.reshape(B, L, E)


def encoder_layer(layer: Params, config: BertConfig, x: torch.Tensor,
                  mask_bias: torch.Tensor | None,
                  lengths: torch.Tensor | None = None, *,
                  segments: torch.Tensor | None = None,
                  attn_window: int = 0, ranges=None,
                  bias: torch.Tensor | None = None,
                  alibi: torch.Tensor | None = None,
                  rope: tuple[torch.Tensor, torch.Tensor] | None = None,
                  use_kernels: bool = True,
                  int8: bool = False, xq: ActQ | None = None,
                  links: frozenset = frozenset(),
                  int8_scores: bool = False, causal: bool = False,
                  tp_axis=None):
    """One post-LN encoder block. The two residual + LayerNorm steps run
    in the o-proj and FFN-down matmuls' epilogue (``linear_residual_ln``).
    ``int8``: every quantized matmul in the int8 mode; with no ``links``
    each consumer quantizes its own input rows. ``links`` (chained int8,
    only where ``_int8_chain_ok``): "attn" — the attention emits the
    context int8-only for the o-projection; "ln" — both residual-LN
    matmuls also emit their output, ``xq`` carries x's int8 rows into the
    qkv and up projections, and the block returns (x, xq); "ffn" — FFN-up
    emits int8-only for FFN-down. ``rope``: the rotary families' (cos,
    sin) tables (nomic-bert, RoFormer). ``causal``: attention attends j <=
    i in the kernel (K6c, or K6ca with ``alibi``). A layer whose MLP has a
    router (nomic-v2-moe's odd layers) ends in ``_moe_half``.

    Under Megatron tensor parallelism (``tp_axis``, a
    ``parallel.sharding.ModelAxis``; no links) ``layer`` is the list of
    the model-axis shards' layers, and ``mask_bias``, ``lengths``,
    ``segments``, ``ranges``, ``bias`` and ``rope`` are lists of the
    shards' own (on their devices; ``bias`` the shard's heads); x is
    replicated, on the axis's first device. Each shard attends over its
    H/tp heads (q, k and v apart, concatenated), then the o-proj and
    FFN-down matmuls are row-parallel (``_row_parallel_residual_ln``)."""
    eps = config.layer_norm_eps
    mode = dict(use_kernels=use_kernels, int8=int8)
    if tp_axis is not None:
        kw = dict(attn_window=attn_window, alibi=alibi,
                  int8_scores=int8_scores, causal=causal,
                  lane=attn_ops.KERNEL_LANE, **mode)
        ctxs = [attention_context(
            lay, config, tp_axis.on(j, x), mask_bias[j], lengths[j],
            segments=segments[j], ranges=ranges[j], bias=bias[j],
            rope=rope[j], **kw) for j, lay in enumerate(layer)]
        a0, m0 = layer[0]["attn"], layer[0]["mlp"]
        x = _row_parallel_residual_ln(
            ctxs, [lay["attn"]["o"]["w"] for lay in layer], a0["o"]["b"],
            x, a0["ln"], eps, tp_axis, **mode)
        if "router" in m0:
            # expert parallelism on the model axis: x is replicated, each
            # shard holds Ex/tp experts, one sum joins them
            return _moe_half([lay["mlp"] for lay in layer], config, x, eps,
                             ep_axis=tp_axis, ep_tokens="replicated")
        hs = [_ffn_hidden(lay["mlp"], tp_axis.on(j, x), config, **mode)
              for j, lay in enumerate(layer)]
        return _row_parallel_residual_ln(
            hs, [lay["mlp"]["down"]["w"] for lay in layer], m0["down"]["b"],
            x, m0["ln"], eps, tp_axis, **mode)
    a, m = layer["attn"], layer["mlp"]
    ln_emit = "both" if "ln" in links else "no"
    ctx = attention_context(layer, config, x, mask_bias, lengths,
                            segments=segments, attn_window=attn_window,
                            ranges=ranges, bias=bias, alibi=alibi, rope=rope,
                            xq=xq, emit_int8="attn" in links,
                            int8_scores=int8_scores, causal=causal, **mode)
    out = linear_residual_ln(ctx, a["o"]["w"], a["o"]["b"], x,
                             a["ln"]["scale"], a["ln"]["bias"], eps,
                             emit=ln_emit, **mode)
    x, xq = out if ln_emit == "both" else (out, None)
    if "router" in m:  # the MoE FFN half (nomic-v2-moe's odd layers)
        return _moe_half(m, config, x, eps)
    h = _ffn_hidden(m, xq if xq is not None else x, config,
                    emit="only" if "ffn" in links else "no", **mode)
    return linear_residual_ln(h, m["down"]["w"], m["down"]["b"], x,
                              m["ln"]["scale"], m["ln"]["bias"], eps,
                              emit=ln_emit, **mode)


def _row_parallel_residual_ln(hs: list, ws: list, b: torch.Tensor,
                              residual: torch.Tensor, ln: Params, eps: float,
                              tp_axis, *, use_kernels: bool = True,
                              int8: bool = False) -> torch.Tensor:
    """Megatron row-parallel linear + residual + LayerNorm: shard j's
    input hs[j] [..., K/tp] times its K/tp rows ws[j] (K1 / K3 with no
    epilogue), the partial products summed over the model axis in their
    dtype, then bias, residual and LayerNorm as torch ops on the
    replicated result. The fused residual-LN epilogue cannot run here:
    the sum comes between the matmul and the LayerNorm."""
    mode = dict(use_kernels=use_kernels, int8=int8)
    y = tp_axis.psum([linear(h, w, None, **mode) for h, w in zip(hs, ws)])
    y = y + b.to(y.dtype)
    return layer_norm(residual + y, ln["scale"], ln["bias"], eps)


def _moe_half(m: Params | list, config: BertConfig, x: torch.Tensor,
              eps: float, ep_axis=None,
              ep_tokens: str = "sharded") -> torch.Tensor:
    """The post-LN MoE FFN half: LayerNorm(x + moe(x)) over every slot of
    [B, L, E], padding included, as the JAX package routes them. The
    experts are dense torch products (``ops.moe``), never a kernel of the
    port: ``moe_dispatch`` "ragged" or "auto" (one device) runs the
    sorted, grouped products; "dense" every expert on every token.
    Expert parallelism (``ep_axis``; ``m`` the list of the axis's shards'
    MoE params) always runs the dense schedule (``moe_ffn``), as the JAX
    package's "auto" does; stacks that already hold every expert (the
    replicated fallback) run once, on one device, with no sum."""
    from ..ops.moe import moe_ffn, moe_ffn_ragged
    if ep_axis is not None and m[0]["up"]["w"].shape[0] == \
            config.num_experts:
        m, ep_axis = m[0], None  # every expert local: nothing to sum
    B, L, E = x.shape
    act = _act(config)
    kw = dict(top_k=config.moe_top_k, act=act,
              normalize_topk=config.moe_normalize_topk)
    if ep_axis is not None:
        y = moe_ffn(x.reshape(B * L, E), m, ep_axis=ep_axis,
                    ep_tokens=ep_tokens, **kw)
        m = m[0]  # the LayerNorm is replicated
    else:
        ffn = (moe_ffn_ragged if config.moe_dispatch in ("ragged", "auto")
               else moe_ffn)
        y = ffn(x.reshape(B * L, E), m, **kw)
    return layer_norm(x + y.reshape(B, L, E), m["ln"]["scale"],
                      m["ln"]["bias"], eps)


def _int8_chain_ok(params: Params, config: BertConfig, *,
                   use_kernels: bool, int8: bool, tp_axis=None) -> bool:
    """The JAX package's gate for the chained int8 path: the int8 mode
    with the kernels, no tensor parallelism, a post-LN encoder with fused
    qkv and a plain MLP (no gate, no experts), and all four matmul
    weights quantized. Shapes are not checked here: the linear ops
    dequantize an ActQ where int8 does not engage. The (dense, moe) tree
    of an MoE model never chains."""
    if not (int8 and use_kernels) or config.norm_style == "pre" \
            or tp_axis is not None:
        return False
    layers = params.get("layers")
    if not isinstance(layers, dict) or "dense" in layers \
            or config.num_hidden_layers < 1:
        return False
    lay = layer_params(params, 0)
    a, m = lay.get("attn", {}), lay.get("mlp", {})
    if "qkv" not in a or "gate" in m or "router" in m:
        return False
    try:
        ws = (a["qkv"]["w"], a["o"]["w"], m["up"]["w"], m["down"]["w"])
    except KeyError:
        return False
    return all(isinstance(w, QuantizedTensor) for w in ws)


def _shard_layers(params, config: BertConfig, tp_axis) -> list:
    """``layer_views``; under tensor parallelism (params the list of the
    shards' trees) each layer as the list of its shards' layers."""
    if tp_axis is None:
        return layer_views(params, config)
    return [list(lays) for lays in zip(*(layer_views(p, config)
                                         for p in params))]


def _post_ln_stack(params: Params, config: BertConfig, x: torch.Tensor,
                   mask_bias, lengths, links: frozenset, tp_axis=None,
                   **kw) -> torch.Tensor:
    """The post-LN layers; with the "ln" link each layer reads and
    returns (x, xq), the first xq ``quantize_act`` of the embedding
    output."""
    if tp_axis is not None:
        for lays in _shard_layers(params, config, tp_axis):
            x = encoder_layer(lays, config, x, mask_bias, lengths,
                              tp_axis=tp_axis, **kw)
        return x
    if "ln" not in links:
        for lay in layer_views(params, config):
            x = encoder_layer(lay, config, x, mask_bias, lengths,
                              links=links, **kw)
        return x
    xq = quantize_act(x)
    for lay in layer_views(params, config):
        x, xq = encoder_layer(lay, config, x, mask_bias, lengths, xq=xq,
                              links=links, **kw)
    return x


def _rope(positions: torch.Tensor, dim: int, base: float):
    """(cos, sin) on the positions' device: for 0 .. L-1 ([L] positions)
    built once per (L, base) on the CPU; per packed row ([B, L]) built
    for this call."""
    if positions.dim() == 1:
        return rope_tables_for(positions.shape[0], dim, base,
                               positions.device)
    return tuple(t.to(positions.device)
                 for t in rope_tables(positions, dim, base))


def _prenorm_scan_args(config: BertConfig, positions: torch.Tensor):
    """The pre-norm (ModernBERT) stack's per-layer flags and local RoPE
    tables: ([(is_global, ln_apply)] per layer, rope_l, windowed). rope_l
    is None when the local theta equals the global one (the caller reuses
    the global tables); windowed says whether any layer is local. Layer
    0's attention norm is ModernBERT's identity (the embedding LayerNorm
    precedes it). positions: [L], or [B, L] for packed rows."""
    NL = config.num_hidden_layers
    n = max(1, config.global_attn_every_n_layers)
    skip0 = 1 if config.first_attn_norm_identity else 0
    flags = [(i % n == 0, i >= skip0) for i in range(NL)]
    rope_l = None
    if (config.position_embedding_type == "rotary"
            and config.local_rotary_base
            and config.local_rotary_base != config.rotary_base):
        rope_l = _rope(positions, config.head_dim, config.local_rotary_base)
    windowed = config.local_attention_window > 0 and n > 1 and NL > 1
    return flags, rope_l, windowed


def _window_bias(positions: torch.Tensor, window: int,
                 mask_value: float) -> torch.Tensor:
    """The einsum path's sliding-window mask: 0 where |i - j| <= window
    // 2, else mask_value; [B|1, 1, L, L] f32 (positions [L] or [B, L])."""
    p = positions if positions.dim() == 2 else positions[None]
    dist = (p[:, None, :] - p[:, :, None]).abs()
    return torch.where(dist <= window // 2, 0.0,
                       mask_value).float()[:, None]


def _norm(config: BertConfig, x: torch.Tensor, ln: Params) -> torch.Tensor:
    """The config's normalization: RMSNorm (Qwen2; the slot's bias is
    zeros and unread) or LayerNorm."""
    if config.norm_type == "rmsnorm":
        return rms_norm(x, ln["scale"], config.layer_norm_eps)
    return layer_norm(x, ln["scale"], ln["bias"], config.layer_norm_eps)


def encoder_layer_pre(layer: Params, config: BertConfig, x: torch.Tensor,
                      mask_bias: torch.Tensor | None,
                      lengths: torch.Tensor | None = None, *,
                      ln_apply: bool = True,
                      rope: tuple[torch.Tensor, torch.Tensor] | None = None,
                      local_window: tuple[bool, int] | None = None,
                      use_kernels: bool = True,
                      int8: bool = False,
                      int8_scores: bool = False,
                      tp_axis=None) -> torch.Tensor:
    """One pre-norm block (ModernBERT, Qwen2, DeepSeek-V2): x += Wo
    attn(norm(x)); x += Wdown glu(norm(x)), the norms RMSNorm for Qwen2
    and DeepSeek-V2, whose attention is MLA (``mla_context``; ``rope``
    then MLA's tables) and whose MoE layers end in ``_moe_half_pre``.
    ``ln_apply``
    False skips ModernBERT's layer-0 identity attention norm;
    ``local_window`` = (is_global, window) routes the attention (K6w on a
    local layer) when the kernels take the shape, else ``mask_bias``
    carries the window; a causal config's attention takes K6c, or the
    einsum path with the triangle in ``mask_bias``. The residual adds stay
    outside the matmuls, in the activation dtype, as in the JAX package
    (no post-LN to fuse into an epilogue): o-proj and down run K1 with its
    plain ``bias`` epilogue. Under tensor parallelism (``tp_axis``: the
    layer, ``mask_bias``, ``lengths`` and ``rope`` as in
    ``encoder_layer``) o-proj and down are row-parallel, their bias
    added after the sum (``_row_parallel_add``)."""
    mode = dict(use_kernels=use_kernels, int8=int8)
    if tp_axis is not None:
        a0, m0 = layer[0]["attn"], layer[0]["mlp"]
        xn = _norm(config, x, a0["ln"]) if ln_apply else x
        ctxs = [attention_context(
            lay, config, tp_axis.on(j, xn), mask_bias[j], lengths[j],
            rope=rope[j], local_window=local_window, causal=config.causal,
            int8_scores=int8_scores, lane=attn_ops.KERNEL_LANE, **mode)
            for j, lay in enumerate(layer)]
        x = _row_parallel_add(ctxs, [lay["attn"]["o"] for lay in layer],
                              x, tp_axis, **mode)
        hn = _norm(config, x, m0["ln"])
        hs = [_ffn_hidden(lay["mlp"], tp_axis.on(j, hn), config, **mode)
              for j, lay in enumerate(layer)]
        return _row_parallel_add(hs, [lay["mlp"]["down"] for lay in layer],
                                 x, tp_axis, **mode)
    a, m = layer["attn"], layer["mlp"]
    xn = _norm(config, x, a["ln"]) if ln_apply else x
    if config.mla:
        ctx = mla_context(layer, config, xn, mask_bias, lengths, rope,
                          **mode)
    else:
        ctx = attention_context(layer, config, xn, mask_bias, lengths,
                                rope=rope, local_window=local_window,
                                causal=config.causal,
                                int8_scores=int8_scores, **mode)
    x = x + linear(ctx, a["o"]["w"], a["o"]["b"], **mode)
    if "router" in m:  # DeepSeek-V2's MoE layers
        return _moe_half_pre(m, config, x, **mode)
    hn = _norm(config, x, m["ln"])
    return x + linear(_ffn_hidden(m, hn, config, **mode), m["down"]["w"],
                      m["down"]["b"], **mode)


def _row_parallel_add(hs: list, lins: list, res: torch.Tensor, tp_axis, *,
                      use_kernels: bool = True,
                      int8: bool = False) -> torch.Tensor:
    """The pre-norm block's row-parallel residual add: the shards'
    partial products (no epilogue) summed over the model axis, then the
    bias at f32 and the residual add in the activation dtype, as the JAX
    package's ``residual_add``."""
    y = tp_axis.psum([linear(h, lin["w"], None, use_kernels=use_kernels,
                             int8=int8) for h, lin in zip(hs, lins)])
    y = y.float() + lins[0]["b"].float()
    return res + y.to(res.dtype)


def _prenorm_stack(params: Params, config: BertConfig, x: torch.Tensor,
                   mask_bias, lengths, rope, positions,
                   mask_value: float, int8_scores: bool = False,
                   tp_axis=None, **mode) -> torch.Tensor:
    """The pre-norm layers: with prefix ``lengths`` and a shape the
    kernels take, each local layer runs K6w and each global one the
    global route (the JAX package's ``window_kernel`` gate, closed under
    tensor parallelism as there); otherwise every layer, global ones too,
    takes the einsum path with the window folded into a local layer's
    mask. Under tensor parallelism ``mask_bias``, ``lengths`` and
    ``rope`` are the shards' lists (``encoder_layer``)."""
    if tp_axis is not None and config.mla:
        raise NotImplementedError("MLA runs on one device (no tensor "
                                  "parallelism)")
    flags, rope_l, windowed = _prenorm_scan_args(config, positions)
    rope_l = rope if rope_l is None else rope_l
    L = x.shape[1]
    window = config.local_attention_window
    window_kernel = windowed and tp_axis is None and fused_attention_ok(
        L, config.num_attention_heads, config.head_dim,
        mode["use_kernels"], lengths, None, local_window=(True, window))
    mb_local = mask_bias
    if windowed and not window_kernel:
        wb = _window_bias(positions.to(x.device), window, mask_value)
        if tp_axis is None:
            mb_local, lengths = mask_bias + wb, None
        else:
            mb_local = [mb + wb.to(mb.device) for mb in mask_bias]
            lengths = [None] * len(tp_axis.devices)
    if tp_axis is not None and rope_l is not rope:
        rope_l = tp_axis.place(rope_l)
    for lay, (is_global, ln_apply) in zip(
            _shard_layers(params, config, tp_axis), flags):
        x = encoder_layer_pre(
            lay, config, x,
            mask_bias if is_global else mb_local, lengths,
            ln_apply=ln_apply, rope=rope if is_global else rope_l,
            local_window=(is_global, window) if window_kernel else None,
            int8_scores=int8_scores, tp_axis=tp_axis, **mode)
    return x


def encode_tokens(params: Params, config: BertConfig,
                  token_ids: torch.Tensor, attention_mask: torch.Tensor, *,
                  pooling: str | None = None,
                  normalize: bool | None = None,
                  mask_value: float = -1e9,
                  compute_dtype: torch.dtype | None = None,
                  prefix_mask: bool = True,
                  return_hidden: bool = False,
                  type_ids: torch.Tensor | None = None,
                  use_kernels: bool = True,
                  int8: bool = False, tp_axis=None) -> torch.Tensor:
    """Full forward: token ids + mask -> pooled, normalized embeddings.

    token_ids, attention_mask: integer [B, L] on the parameters' device
    (mask 1 for real tokens, 0 for pads). prefix_mask=True promises each
    mask row is 1s then 0s (the engine's right-padded batches): the fused
    attention kernel then masks by row length; pass False for other masks
    to take the additive-mask einsum path. compute_dtype: the activation
    dtype inside the encoder (None keeps the embedding dtype, f32).
    int8: quantized matmuls in the int8 mode. A family logit bias (MPNet,
    ALiBi) is computed once here and shared by all layers: as K7's
    operand while it takes the shape, as K6's in-kernel ALiBi past that,
    else folded into the einsum path's mask. A causal config (Qwen2)
    attends j <= i: in K6c, or with the triangle folded into the einsum
    path's mask; a causal ALiBi config takes K6ca wherever the streamed
    kernel takes the shape, else the einsum path with both folded in. The
    post-LN stack hands ``causal`` to attention, where the JAX package's
    does not: its kernel route would drop the triangle that its einsum
    path applies. The chained-int8 links and the int8-scores mode are read
    here, once (see the module docstring).

    tp_axis (a ``parallel.sharding.ModelAxis``): Megatron tensor
    parallelism over one data row; ``params`` is then the list of this
    process's shards' trees of the axis (``parallel.sharding.
    shard_params``), ids and mask on the first one's device, where the
    replicated activations and the result live. The JAX package's gates:
    no in-kernel ALiBi (the bias of each shard's heads, as K7's operand
    or in the mask), no chained int8, no K6w window route.
    Returns [B, E'] float32 (or the [B, L, E] hidden states)."""
    check_supported(config)
    shards = params if tp_axis is not None else [params]
    p0 = shards[0]  # its replicated leaves: embeddings, norms, heads
    pooling = pooling or config.pooling
    normalize = (config.normalize_embeddings if normalize is None
                 else normalize)
    mask = attention_mask.float()
    mask_bias = ((1.0 - mask) * mask_value)[:, None, None, :]  # [B,1,1,L]

    x = embed(p0, config, token_ids, type_ids)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    x = _project_embeddings(p0, x)  # ALBERT factorized embeddings
    lengths = (attention_mask.sum(1, dtype=torch.int32)
               if prefix_mask else None)

    tp = 1 if tp_axis is None else tp_axis.size
    n_local = len(shards)  # this process's shards of the axis
    lane = attn_ops.LANE if tp_axis is None else attn_ops.KERNEL_LANE
    bias = alibi = None
    masks = None  # under TP: each shard's mask with its heads' bias
    L = token_ids.shape[1]
    H, D = config.num_attention_heads // tp, config.head_dim
    if "alibi_slopes" in p0 or p0.get("rel_bias") is not None:
        if ("alibi_slopes" in p0 and prefix_mask and use_kernels
                and tp_axis is None
                and (config.causal or not attn_ops.bias_supported(L, H, D))
                and attn_ops.stream_supported(L, H, D, attn_ops.pick_bk(L))):
            # ALiBi past K7's cap, and causal ALiBi at every length (K7
            # has no causal mode): K6 / K6ca compute the penalty from
            # positions, so no O(L^2) bias array exists
            alibi = p0["alibi_slopes"]
        else:
            pos0 = torch.arange(L, device=token_ids.device)[None]
            # each shard's heads' bias on its own device
            fbs = [_logit_bias(p, config, pos0 if tp_axis is None
                               else tp_axis.on(j, pos0))
                   for j, p in enumerate(shards)]
            if (prefix_mask and use_kernels and not config.causal
                    and attn_ops.bias_supported(L, fbs[0].shape[1], D,
                                                lane)):
                bias = [attn_ops.prepare_attention_bias(fb, L)
                        for fb in fbs]
            else:
                masks = [mask_bias.to(fb.device) + fb for fb in fbs]
                lengths = None  # [B, H, L, L], einsum path
            if tp_axis is None:
                bias, mask_bias = (None if bias is None else bias[0],
                                   mask_bias if masks is None else masks[0])
    if config.mla:
        D, dv = config.qk_head_dim, config.v_head_dim
    else:
        dv = None
    if config.causal and not fused_attention_ok(
            L, H, D, use_kernels, lengths, None, causal=True, lane=lane,
            dv=dv):
        # the einsum path's triangle (K6c masks in-kernel)
        cb = _causal_bias(L, mask_value, token_ids.device)
        mask_bias = mask_bias + cb
        if masks is not None:
            masks = [mb + cb.to(mb.device) for mb in masks]
    positions = torch.arange(L, device=token_ids.device)
    rope = None
    if config.mla:
        rope = mla_rope(config, positions)
    elif config.position_embedding_type == "rotary":
        # position-only: computed once, shared by every layer
        rope = _rope(positions, config.head_dim, config.rotary_base)
    mode = dict(use_kernels=use_kernels, int8=int8)
    i8s = attn_ops.use_int8_scores(int8)
    if tp_axis is not None:
        # each shard's own per-position arguments, on its device
        place = tp_axis.place
        mask_bias = masks if masks is not None else place(mask_bias)
        bias = bias if bias is not None else [None] * n_local
        lengths, rope = place(lengths), place(rope)
    if config.norm_style == "pre":
        x = _prenorm_stack(shards if tp_axis is not None else params,
                           config, x, mask_bias, lengths, rope, positions,
                           mask_value, int8_scores=i8s, tp_axis=tp_axis,
                           **mode)
    else:
        extra = {} if tp_axis is None else dict(
            segments=[None] * n_local, ranges=[None] * n_local)
        x = _post_ln_stack(shards if tp_axis is not None else params,
                           config, x, mask_bias, lengths,
                           _links(params, config, mode, tp_axis), bias=bias,
                           alibi=alibi, rope=rope, int8_scores=i8s,
                           causal=config.causal, tp_axis=tp_axis, **extra,
                           **mode)
    if "final_ln" in p0:  # ModernBERT's and Qwen2's final norm
        x = _norm(config, x, p0["final_ln"])
    if return_hidden:
        return x.float()

    xf = x.float()
    if pooling == "mean":
        denom = mask.sum(1, keepdim=True).clamp_min(1.0)
        pooled = torch.einsum("ble,bl->be", xf, mask) / denom
    elif pooling == "cls":
        pooled = xf[:, 0]
    elif pooling == "max":
        pooled = torch.where(mask[:, :, None] > 0, xf,
                             torch.full_like(xf, -math.inf)).amax(1)
    elif pooling == "lasttoken":
        idx = (mask.sum(1).long() - 1).clamp_min(0)
        pooled = xf[torch.arange(xf.shape[0], device=xf.device), idx]
    else:
        raise ValueError(f"unknown pooling: {pooling}")

    return _finish(p0, config, pooled, normalize)


def score_pairs(params: Params, config: BertConfig,
                token_ids: torch.Tensor, attention_mask: torch.Tensor,
                type_ids: torch.Tensor | None = None, *,
                mask_value: float = -1e9,
                compute_dtype: torch.dtype | None = None,
                use_kernels: bool = True,
                int8: bool = False) -> torch.Tensor:
    """Cross-encoder relevance scoring: (query, document) pair tokens ->
    logits [B] (single-label heads: bge-reranker, ms-marco
    cross-encoders) or [B, num_labels].

    The head rides on the CLS position of the same forward the embedding
    path runs (``encode_tokens(..., return_hidden=True)``): BERT style
    applies the model pooler (tanh(dense(cls))) then the classifier;
    RoBERTa style (bge-reranker) classifier.dense (tanh) then
    classifier.out_proj, as HF's BertForSequenceClassification and
    RobertaClassificationHead do. The head is two f32 products on the CLS
    rows, outside the kernels, as in the JAX package. type_ids: [B, L]
    segment ids (0 = query span, 1 = document span) for BERT-family pair
    encoding; None for the RoBERTa family (one type)."""
    head = params.get("cls_head")
    if head is None:
        raise ValueError("this checkpoint has no classification head "
                         "(cls_head) — not a cross-encoder/reranker")
    x = encode_tokens(params, config, token_ids, attention_mask,
                      mask_value=mask_value, compute_dtype=compute_dtype,
                      return_hidden=True, type_ids=type_ids,
                      use_kernels=use_kernels, int8=int8)
    cls = x[:, 0].float()
    mid = head.get("pooler") or head.get("dense")
    if mid is not None:
        cls = torch.tanh(cls @ mid["w"].float() + mid["b"].float())
    logits = cls @ head["out"]["w"].float() + head["out"]["b"].float()
    return logits[:, 0] if logits.shape[-1] == 1 else logits


def encode_packed(params: Params, config: BertConfig,
                  token_ids: torch.Tensor, seg_ids: torch.Tensor,
                  position_ids: torch.Tensor, pool_weights: torch.Tensor, *,
                  normalize: bool | None = None, mask_value: float = -1e9,
                  compute_dtype: torch.dtype | None = None,
                  attn_window: int = 0, use_kernels: bool = True,
                  int8: bool = False, tp_axis=None) -> torch.Tensor:
    """Forward over token-packed rows (``runtime/packing.py``).

    token_ids:    int [B, L], several sentences back to back per row.
    seg_ids:      int [B, L], segment index per token, -1 for pads.
    position_ids: int [B, L], restarting at 0 per segment.
    pool_weights: f32 [B, S, L], the mean (1/len) or CLS (a single 1)
                  pooling row per segment slot; all-zero for empty slots.
    attn_window:  the static key-block window for K5
                  (``packing.max_block_span``); 0 means the full row.
    tp_axis:      Megatron tensor parallelism, as in ``encode_tokens``
                  (``params`` the list of the shards' trees; each shard
                  runs K4 / K5 on its heads).
    A family logit bias (MPNet, ALiBi) comes from the per-segment
    positions and is folded into the einsum path's mask, as the JAX
    package does: the segmented kernels have no bias operand. Causal rows
    (Qwen2) fold the row-global triangle into that mask too: segments are
    contiguous and ascending, so it is each segment's own causal mask.
    Returns [B, S, E'] float32, one embedding per (row, segment slot);
    empty slots stay zero vectors."""
    check_supported(config)
    shards = params if tp_axis is not None else [params]
    p0 = shards[0]
    normalize = (config.normalize_embeddings if normalize is None
                 else normalize)
    B, L = token_ids.shape
    tp = 1 if tp_axis is None else tp_axis.size
    n_local = len(shards)  # this process's shards of the axis
    lane = attn_ops.LANE if tp_axis is None else attn_ops.KERNEL_LANE
    seg = seg_ids.to(torch.int32).contiguous()
    # each shard's heads' bias on its own device
    biases = [_logit_bias(p, config, position_ids if tp_axis is None
                          else tp_axis.on(j, position_ids))
              for j, p in enumerate(shards)]
    prenorm = config.norm_style == "pre"
    # the pre-norm stack and causal rows run packed rows on the einsum
    # path, as in JAX (the segmented kernels have no causal mode)
    segments = (seg if biases[0] is None and not prenorm
                and not config.causal else None)
    mask_bias = ranges = None
    if not fused_attention_ok(L, config.num_attention_heads // tp,
                              config.head_dim, use_kernels, None, segments,
                              lane=lane):
        # within-segment attention for the einsum path: [B, 1, L, L]
        same = seg[:, :, None] == seg[:, None, :]
        mask_bias = torch.where(same & (seg >= 0)[:, None, :], 0.0,
                                mask_value).float()[:, None]
        # cross-segment pairs are masked anyway
        mask_bias = [mask_bias if b is None else mask_bias.to(b.device) + b
                     for b in biases]
        if config.causal:
            mask_bias = [mb + _causal_bias(L, mask_value, mb.device)
                         for mb in mask_bias]
    elif attention_route_name(L, config.hidden_size, segmented=True,
                              attn_window=attn_window) \
            == "segmented_blockskip":
        ranges = attn_ops.block_ranges(seg, L)  # the same for every layer
    x = embed(p0, config, token_ids, position_ids=position_ids)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    x = _project_embeddings(p0, x)
    rope = None
    if config.mla:
        rope = mla_rope(config, position_ids)
    elif config.position_embedding_type == "rotary":
        # per-row tables: positions restart at each segment
        rope = _rope(position_ids, config.head_dim, config.rotary_base)
    mode = dict(use_kernels=use_kernels, int8=int8)
    if tp_axis is None:
        mask_bias = None if mask_bias is None else mask_bias[0]
        layers = params
    else:
        place = tp_axis.place
        mask_bias = ([None] * n_local if mask_bias is None else
                     [tp_axis.on(j, mb) for j, mb in enumerate(mask_bias)])
        segments, ranges, rope = place(segments), place(ranges), place(rope)
        layers = shards
    if prenorm:
        x = _prenorm_stack(layers, config, x, mask_bias,
                           None if tp_axis is None else [None] * n_local,
                           rope,
                           position_ids, mask_value, tp_axis=tp_axis, **mode)
    else:
        x = _post_ln_stack(layers, config, x, mask_bias,
                           None if tp_axis is None else [None] * n_local,
                           _links(params, config, mode, tp_axis),
                           segments=segments, attn_window=attn_window,
                           ranges=ranges, rope=rope, tp_axis=tp_axis,
                           **({} if tp_axis is None
                              else dict(bias=[None] * n_local)), **mode)
    if "final_ln" in p0:
        x = _norm(config, x, p0["final_ln"])
    pooled = torch.einsum("bsl,ble->bse", pool_weights.float(), x.float())
    return _finish(p0, config, pooled, normalize)


def _links(params: Params, config: BertConfig, mode: dict,
           tp_axis=None) -> frozenset:
    """The chained-int8 links this forward runs: the switch's set where
    ``_int8_chain_ok``, else none."""
    if not _int8_chain_ok(params, config, tp_axis=tp_axis, **mode):
        return frozenset()
    return active_chain_links()


def _causal_bias(L: int, mask_value: float, device) -> torch.Tensor:
    """[1, 1, L, L] f32: 0 where key j <= query i, else mask_value."""
    i = torch.arange(L, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0,
                       mask_value).float()[None, None]


def _finish(params: Params, config: BertConfig, pooled: torch.Tensor,
            normalize: bool) -> torch.Tensor:
    """ST Dense layers, then the L2 norm."""
    pooled = _apply_st_dense(params, config, pooled)
    if normalize:
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        pooled = pooled / norm.clamp_min(1e-12)
    return pooled


def _apply_st_dense(params: Params, config: BertConfig,
                    pooled: torch.Tensor) -> torch.Tensor:
    """SentenceTransformers Dense modules, in module order, at f32."""
    stack = params.get("st_dense")
    if not stack:
        return pooled
    for i, act in enumerate(config.st_dense_acts):
        d = stack[str(i)]
        pooled = pooled @ d["w"].float()
        if "b" in d:
            pooled = pooled + d["b"].float()
        if act == "tanh":
            pooled = torch.tanh(pooled)
    return pooled
