"""BERT encoder forward of the PyTorch port — the port of
``embeddings_tpu/models/bert.py`` for the plain post-LN BERT family:
embedding sum + LayerNorm, N layers of {prefix-masked multi-head
self-attention, residual + LN, GELU FFN, residual + LN}, pooling
(cls / mean / max / lasttoken), SentenceTransformers Dense layers and the
L2 norm.

``encode_tokens`` runs right-padded batches; ``encode_packed`` runs
token-packed rows (``runtime/packing.py``: several sentences per row,
segment ids, per-segment positions, a pooling matrix).

The JAX package scans one compiled layer body over stacked parameters;
here a Python loop walks the layers eagerly. ``use_kernels`` picks the
path: True runs quantized matmuls through ``ops.qmatmul.qmatmul`` (K1, or
K3 with ``int8``) and attention through the fused kernels —
prefix-masked K2 for padded batches, segment-masked K4 or its
block-skipping K5 for packed rows — on a CUDA tensor, their plain versions
on a CPU tensor; False runs the plain f32 reference math (dequantize +
matmul, the int8 emulation with ``int8``, exact-erf GELU, additive-mask
einsum attention), the JAX package's XLA fallback. ``int8`` is
``EngineConfig.int8_compute``, passed down explicitly; the chained-int8
links (emission epilogues) are not ported, which is the JAX package's
default of no links.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..config import BertConfig
from ..ops import attention as attn_ops
from ..ops.linear import linear, linear_residual_ln
from ..ops.quant import QuantizedTensor, gather_rows
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


def embed(params: Params, config: BertConfig, token_ids: torch.Tensor,
          type_ids: torch.Tensor | None = None,
          position_ids: torch.Tensor | None = None) -> torch.Tensor:
    """word + token-type + position embedding sum, then LayerNorm. A
    quantized word table dequantizes only the gathered rows.
    position_ids [B, L] overrides the default 0..L-1 (token-packed rows
    restart positions at each segment)."""
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
    off = config.position_offset
    if position_ids is None:
        x = x + emb["position"][off:off + L]
    else:
        x = x + emb["position"][position_ids.long() + off]
    return layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"],
                      config.layer_norm_eps)


def attention_route(L: int, segmented: bool, attn_window: int) -> str:
    """The fused kernel ``_fused_attn_dispatch`` picks: "segmented_blockskip"
    (K5) for packed rows longer than one 128-block whose window skips at
    least two key blocks, "segmented" (K4) for other packed rows,
    "prefix" (K2) for padded batches — the JAX package's rule."""
    if not segmented:
        return "prefix"
    nK = L // attn_ops.BQ
    if L > attn_ops.BQ and L % attn_ops.BQ == 0 and 0 < attn_window <= nK - 2:
        return "segmented_blockskip"
    return "segmented"


def _fused_attn_dispatch(qkv2d, lengths, segments, B, L, H, D,
                         attn_window=0, ranges=None):
    route = attention_route(L, segments is not None, attn_window)
    if route == "segmented_blockskip":
        # long packed rows with a known small window: only key blocks
        # sharing a segment with the query block are computed
        return attn_ops.fused_attention_segmented_blockskip(
            qkv2d, segments, B=B, L=L, H=H, D=D, window=attn_window,
            ranges=ranges)
    if route == "segmented":
        return attn_ops.fused_attention_segmented(qkv2d, segments, B=B, L=L,
                                                  H=H, D=D)
    return attn_ops.fused_attention(qkv2d, lengths, B=B, L=L, H=H, D=D)


def fused_attention_ok(L: int, H: int, D: int, use_kernels: bool,
                       lengths, segments) -> bool:
    """Does attention take a fused kernel (else the einsum path)?"""
    return (use_kernels and (lengths is not None or segments is not None)
            and attn_ops.supported(L, H, D))


def attention_context(layer: Params, config: BertConfig, x: torch.Tensor,
                      mask_bias: torch.Tensor | None,
                      lengths: torch.Tensor | None = None, *,
                      segments: torch.Tensor | None = None,
                      attn_window: int = 0, ranges=None,
                      use_kernels: bool = True,
                      int8: bool = False) -> torch.Tensor:
    """Masked multi-head self-attention up to (not including) the output
    projection: [B, L, E] -> [B, L, E] context. With prefix ``lengths``
    (or packed ``segments``), ``use_kernels`` and a shape ``supported`` by
    the fused kernels, attention reads the fused qkv projection in place
    (K2, or K4/K5; ``ranges`` is K5's ``block_ranges``, computed once per
    forward); otherwise the additive-mask einsum path, with ``mask_bias``
    [B, 1, 1 or L, L]."""
    B, L, _ = x.shape
    D = config.head_dim
    a = layer["attn"]
    if "qkv" in a:
        qkv = linear(x, a["qkv"]["w"], a["qkv"]["b"],
                     use_kernels=use_kernels, int8=int8)  # [B, L, 3E]
    else:
        qkv = torch.cat([linear(x, a[n]["w"], a[n]["b"],
                                use_kernels=use_kernels, int8=int8)
                         for n in ("q", "k", "v")], -1)
    El = qkv.shape[-1] // 3
    H = El // D
    if fused_attention_ok(L, H, D, use_kernels, lengths, segments):
        ctx = _fused_attn_dispatch(qkv.reshape(B * L, 3 * El), lengths,
                                   segments, B, L, H, D, attn_window, ranges)
        return ctx.reshape(B, L, El)
    q = qkv[..., :El].reshape(B, L, H, D)
    k = qkv[..., El:2 * El].reshape(B, L, H, D)
    v = qkv[..., 2 * El:].reshape(B, L, H, D)
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(D)) + mask_bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhlm,bmhd->blhd", probs.float(), v.float())
    return ctx.to(x.dtype).reshape(B, L, El)


def _ffn_hidden(m: Params, x: torch.Tensor, config: BertConfig, *,
                use_kernels: bool = True, int8: bool = False) -> torch.Tensor:
    """act(up(x)), the activation fused into the up-projection's kernel."""
    act = {"gelu_tanh": "gelu_tanh", "silu": "silu", "relu": "relu"}.get(
        config.hidden_act, "gelu")
    return linear(x, m["up"]["w"], m["up"]["b"], act=act,
                  use_kernels=use_kernels, int8=int8)


def encoder_layer(layer: Params, config: BertConfig, x: torch.Tensor,
                  mask_bias: torch.Tensor | None,
                  lengths: torch.Tensor | None = None, *,
                  segments: torch.Tensor | None = None,
                  attn_window: int = 0, ranges=None,
                  use_kernels: bool = True,
                  int8: bool = False) -> torch.Tensor:
    """One post-LN encoder block. The two residual + LayerNorm steps run
    in the o-proj and FFN-down matmuls' epilogue (``linear_residual_ln``).
    ``int8``: every quantized matmul in the int8 mode; each consumer
    quantizes its own input rows (no chained links)."""
    a, m = layer["attn"], layer["mlp"]
    eps = config.layer_norm_eps
    mode = dict(use_kernels=use_kernels, int8=int8)
    ctx = attention_context(layer, config, x, mask_bias, lengths,
                            segments=segments, attn_window=attn_window,
                            ranges=ranges, **mode)
    x = linear_residual_ln(ctx, a["o"]["w"], a["o"]["b"], x,
                           a["ln"]["scale"], a["ln"]["bias"], eps, **mode)
    h = _ffn_hidden(m, x, config, **mode)
    return linear_residual_ln(h, m["down"]["w"], m["down"]["b"], x,
                              m["ln"]["scale"], m["ln"]["bias"], eps, **mode)


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
                  int8: bool = False) -> torch.Tensor:
    """Full forward: token ids + mask -> pooled, normalized embeddings.

    token_ids, attention_mask: integer [B, L] on the parameters' device
    (mask 1 for real tokens, 0 for pads). prefix_mask=True promises each
    mask row is 1s then 0s (the engine's right-padded batches): the fused
    attention kernel then masks by row length; pass False for other masks
    to take the additive-mask einsum path. compute_dtype: the activation
    dtype inside the encoder (None keeps the embedding dtype, f32).
    int8: quantized matmuls in the int8 mode.
    Returns [B, E'] float32 (or the [B, L, E] hidden states)."""
    check_supported(config)
    pooling = pooling or config.pooling
    normalize = (config.normalize_embeddings if normalize is None
                 else normalize)
    mask = attention_mask.float()
    mask_bias = ((1.0 - mask) * mask_value)[:, None, None, :]  # [B,1,1,L]

    x = embed(params, config, token_ids, type_ids)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    lengths = (attention_mask.sum(1, dtype=torch.int32)
               if prefix_mask else None)
    for i in range(config.num_hidden_layers):
        x = encoder_layer(layer_params(params, i), config, x, mask_bias,
                          lengths, use_kernels=use_kernels, int8=int8)
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

    return _finish(params, config, pooled, normalize)


def encode_packed(params: Params, config: BertConfig,
                  token_ids: torch.Tensor, seg_ids: torch.Tensor,
                  position_ids: torch.Tensor, pool_weights: torch.Tensor, *,
                  normalize: bool | None = None, mask_value: float = -1e9,
                  compute_dtype: torch.dtype | None = None,
                  attn_window: int = 0, use_kernels: bool = True,
                  int8: bool = False) -> torch.Tensor:
    """Forward over token-packed rows (``runtime/packing.py``).

    token_ids:    int [B, L], several sentences back to back per row.
    seg_ids:      int [B, L], segment index per token, -1 for pads.
    position_ids: int [B, L], restarting at 0 per segment.
    pool_weights: f32 [B, S, L], the mean (1/len) or CLS (a single 1)
                  pooling row per segment slot; all-zero for empty slots.
    attn_window:  the static key-block window for K5
                  (``packing.max_block_span``); 0 means the full row.
    Returns [B, S, E'] float32, one embedding per (row, segment slot);
    empty slots stay zero vectors."""
    check_supported(config)
    normalize = (config.normalize_embeddings if normalize is None
                 else normalize)
    B, L = token_ids.shape
    seg = seg_ids.to(torch.int32).contiguous()
    mask_bias = ranges = None
    if not fused_attention_ok(L, config.num_attention_heads,
                              config.head_dim, use_kernels, None, seg):
        # within-segment attention for the einsum path: [B, 1, L, L]
        same = seg[:, :, None] == seg[:, None, :]
        mask_bias = torch.where(same & (seg >= 0)[:, None, :], 0.0,
                                mask_value).float()[:, None]
    elif attention_route(L, True, attn_window) == "segmented_blockskip":
        ranges = attn_ops.block_ranges(seg, L)  # the same for every layer
    x = embed(params, config, token_ids, position_ids=position_ids)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for i in range(config.num_hidden_layers):
        x = encoder_layer(layer_params(params, i), config, x, mask_bias,
                          segments=seg, attn_window=attn_window,
                          ranges=ranges, use_kernels=use_kernels, int8=int8)
    pooled = torch.einsum("bsl,ble->bse", pool_weights.float(), x.float())
    return _finish(params, config, pooled, normalize)


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
