"""Pieces the plain references share: the q4_0 codec, LayerNorm, masked
attention, rotary tables, pooling and the batching of sequences by
length. Plain ``torch`` in float32 with TF32 off; nothing here imports
the program.
"""

from __future__ import annotations

import math

import torch

QK = 32  # ggml's q4_0 block


def no_tf32() -> None:
    """float32 products stay float32 on the card (TF32 would round their
    inputs to 10 bits of mantissa)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q4_0_roundtrip(w: torch.Tensor) -> torch.Tensor:
    """ggml Q4_0 along the last axis, in blocks of 32, then back to
    float32: d = the block's signed absmax / -8, q = clamp(floor(x / d +
    8.5), 0, 15) - 8, w' = q * d (a block of zeros stays zero)."""
    *lead, K = w.shape
    if K % QK:
        raise ValueError(f"last axis {K} is not a multiple of {QK}")
    blocks = w.float().reshape(*lead, K // QK, QK)
    idx = blocks.abs().argmax(-1, keepdim=True)
    d = torch.take_along_dim(blocks, idx, -1) / -8.0
    safe = torch.where(d == 0, torch.ones_like(d), d)
    inv = torch.where(d != 0, 1.0 / safe, torch.zeros_like(d))
    scaled = blocks * inv
    q = torch.clamp(torch.floor(scaled + 8.5), 0.0, 15.0) - 8.0
    return (q * d).reshape(*lead, K)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU: HF's "gelu"."""
    return torch.nn.functional.gelu(x, approximate="none")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_ok: torch.Tensor) -> torch.Tensor:
    """Softmax attention [B, L, H, D] -> [B, L, H, D]; ``key_ok`` [B, L]
    is True on a sequence's own tokens, so pads take no part."""
    D = q.shape[-1]
    s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(D)
    s = s.masked_fill(~key_ok[:, None, None, :], float("-inf"))
    return torch.einsum("bhlm,bmhd->blhd", torch.softmax(s, -1), v)


def rotary(x: torch.Tensor, base: float) -> torch.Tensor:
    """Half-split rotary embedding (GPT-NeoX / nomic-bert) of [B, L, H, D]
    at positions 0 .. L-1: pair (j, j + D/2) turns by pos * base^(-2j/D)."""
    L, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = base ** (-torch.arange(half, dtype=torch.float64,
                                 device=x.device) * 2 / D)
    ang = torch.arange(L, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def pool(x: torch.Tensor, key_ok: torch.Tensor, how: str,
         normalize: bool) -> torch.Tensor:
    """CLS or mean pooling over a sequence's own tokens, then the L2 norm."""
    if how == "cls":
        out = x[:, 0]
    elif how == "mean":
        m = key_ok.float()
        out = (x * m[..., None]).sum(1) / m.sum(1, keepdim=True)
    else:
        raise ValueError(f"unknown pooling {how!r}")
    if normalize:
        out = torch.nn.functional.normalize(out, dim=-1)
    return out


def batched(seqs: list, fn, device, max_tokens: int = 16384) -> torch.Tensor:
    """Run ``fn(ids [B, L], key_ok [B, L]) -> [B, E]`` over sequences
    grouped by length, each group padded to its longest member with
    ``key_ok`` marking the real tokens; returns [len(seqs), E] in input
    order."""
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    out = [None] * len(seqs)
    start = 0
    while start < len(order):
        L = len(seqs[order[start]])
        end = start + 1
        while end < len(order):
            L2 = len(seqs[order[end]])
            if (end - start + 1) * L2 > max_tokens:
                break
            L, end = L2, end + 1
        idx = order[start:end]
        ids = torch.zeros(len(idx), L, dtype=torch.long)
        ok = torch.zeros(len(idx), L, dtype=torch.bool)
        for r, i in enumerate(idx):
            n = len(seqs[i])
            ids[r, :n] = torch.as_tensor(seqs[i], dtype=torch.long)
            ok[r, :n] = True
        emb = fn(ids.to(device), ok.to(device))
        for r, i in enumerate(idx):
            out[i] = emb[r]
        start = end
    return torch.stack(out)
