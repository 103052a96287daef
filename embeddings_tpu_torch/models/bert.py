"""BERT encoder forward of the PyTorch port — the port of
``embeddings_tpu/models/bert.py`` for the plain post-LN BERT family:
embedding sum + LayerNorm, N layers of {prefix-masked multi-head
self-attention, residual + LN, GELU FFN, residual + LN}, pooling
(cls / mean / max / lasttoken), SentenceTransformers Dense layers and the
L2 norm.

The JAX package scans one compiled layer body over stacked parameters;
here a Python loop walks the layers eagerly. ``use_kernels`` picks the
path: True runs quantized matmuls through ``ops.qmatmul.qmatmul`` (K1) and
prefix-masked attention through ``ops.attention.fused_attention`` (K2) —
the kernels on a CUDA tensor, their plain versions on a CPU tensor; False
runs the plain f32 reference math (dequantize + matmul, exact-erf GELU,
additive-mask einsum attention), the JAX package's XLA fallback.
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
          type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """word + token-type + position embedding sum, then LayerNorm. A
    quantized word table dequantizes only the gathered rows."""
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
    x = x + emb["position"][off:off + L]
    return layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"],
                      config.layer_norm_eps)


def attention_context(layer: Params, config: BertConfig, x: torch.Tensor,
                      mask_bias: torch.Tensor,
                      lengths: torch.Tensor | None = None, *,
                      use_kernels: bool = True) -> torch.Tensor:
    """Pad-masked multi-head self-attention up to (not including) the
    output projection: [B, L, E] -> [B, L, E] context. With prefix
    ``lengths``, ``use_kernels`` and a shape ``supported`` by the fused
    kernel, attention reads the fused qkv projection in place (K2);
    otherwise the additive-mask einsum path."""
    B, L, _ = x.shape
    D = config.head_dim
    a = layer["attn"]
    if "qkv" in a:
        qkv = linear(x, a["qkv"]["w"], a["qkv"]["b"],
                     use_kernels=use_kernels)             # [B, L, 3E]
    else:
        qkv = torch.cat([linear(x, a[n]["w"], a[n]["b"],
                                use_kernels=use_kernels)
                         for n in ("q", "k", "v")], -1)
    El = qkv.shape[-1] // 3
    H = El // D
    if (lengths is not None and use_kernels
            and attn_ops.supported(L, H, D)):
        ctx = attn_ops.fused_attention(qkv.reshape(B * L, 3 * El), lengths,
                                       B=B, L=L, H=H, D=D)
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
                use_kernels: bool = True) -> torch.Tensor:
    """act(up(x)), the activation fused into the up-projection's kernel."""
    act = {"gelu_tanh": "gelu_tanh", "silu": "silu", "relu": "relu"}.get(
        config.hidden_act, "gelu")
    return linear(x, m["up"]["w"], m["up"]["b"], act=act,
                  use_kernels=use_kernels)


def encoder_layer(layer: Params, config: BertConfig, x: torch.Tensor,
                  mask_bias: torch.Tensor,
                  lengths: torch.Tensor | None = None, *,
                  use_kernels: bool = True) -> torch.Tensor:
    """One post-LN encoder block. The two residual + LayerNorm steps run
    in the o-proj and FFN-down matmuls' epilogue (``linear_residual_ln``)."""
    a, m = layer["attn"], layer["mlp"]
    eps = config.layer_norm_eps
    ctx = attention_context(layer, config, x, mask_bias, lengths,
                            use_kernels=use_kernels)
    x = linear_residual_ln(ctx, a["o"]["w"], a["o"]["b"], x,
                           a["ln"]["scale"], a["ln"]["bias"], eps,
                           use_kernels=use_kernels)
    h = _ffn_hidden(m, x, config, use_kernels=use_kernels)
    return linear_residual_ln(h, m["down"]["w"], m["down"]["b"], x,
                              m["ln"]["scale"], m["ln"]["bias"], eps,
                              use_kernels=use_kernels)


def encode_tokens(params: Params, config: BertConfig,
                  token_ids: torch.Tensor, attention_mask: torch.Tensor, *,
                  pooling: str | None = None,
                  normalize: bool | None = None,
                  mask_value: float = -1e9,
                  compute_dtype: torch.dtype | None = None,
                  prefix_mask: bool = True,
                  return_hidden: bool = False,
                  type_ids: torch.Tensor | None = None,
                  use_kernels: bool = True) -> torch.Tensor:
    """Full forward: token ids + mask -> pooled, normalized embeddings.

    token_ids, attention_mask: integer [B, L] on the parameters' device
    (mask 1 for real tokens, 0 for pads). prefix_mask=True promises each
    mask row is 1s then 0s (the engine's right-padded batches): the fused
    attention kernel then masks by row length; pass False for other masks
    to take the additive-mask einsum path. compute_dtype: the activation
    dtype inside the encoder (None keeps the embedding dtype, f32).
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
                          lengths, use_kernels=use_kernels)
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
