"""Prefix-masked fused multi-head attention over the fused QKV projection
— the PyTorch port of ``embeddings_tpu/ops/attention.py:fused_attention``.

``fused_attention`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/attention.cu`` (K2) or raises; on a CPU tensor
it runs ``fused_attention_ref``, the plain PyTorch version that repeats
the kernel's arithmetic step by step (q pre-scaled by log2(e)/sqrt(D) and
rounded to the compute dtype, exp2 of the clamped scores with no
max-subtraction, probabilities rounded to the compute dtype before both
the PV product and the denominator, 1e-30 floor on the denominator).

The segmented, block-skipping, streamed, biased and context-parallel
kernels (K4-K8b), and the int8-score and emission options, are not
ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch

LANE = 128
LOG2E = 1.4426950408889634
BQ = 128  # query rows per block of the JAX kernel past 512 (shape rule)
_CLAMP_LO = -100.0
# head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)


def _clamp_hi(n_keys: int) -> float:
    """Upper score clamp: n_keys * 2^hi <= 2^127, so neither exp2 nor the
    f32 denominator can overflow at any row length."""
    return float(127 - math.ceil(math.log2(max(n_keys, 2))))


def supported(L: int, H: int, D: int) -> bool:
    """Shapes the fused kernel takes (the JAX package's rule, restricted
    to the head dims the CUDA kernel is built for)."""
    return (D in KERNEL_HEAD_DIMS and L % 8 == 0 and (H * D) % LANE == 0
            and (L <= 512 or L % BQ == 0))


def _scale(D: int) -> float:
    """log2(e)/sqrt(D), the factor folded into q (as the kernel's f32)."""
    return (1.0 / (D ** 0.5)) * LOG2E


def fused_attention_ref(qkv: torch.Tensor, lengths: torch.Tensor, *,
                        B: int, L: int, H: int, D: int) -> torch.Tensor:
    """The plain PyTorch version of K2 (same arguments as
    ``fused_attention``)."""
    dt = qkv.dtype
    x = qkv.reshape(B, L, 3, H, D).permute(2, 0, 3, 1, 4)  # 3,B,H,L,D
    q, k, v = x[0], x[1], x[2]
    qs = (q.float() * _scale(D)).to(dt)
    s = qs.float() @ k.float().transpose(-1, -2)           # [B,H,L,L] f32
    s = s.clamp(_CLAMP_LO, _clamp_hi(L))
    key_ok = (torch.arange(L, device=qkv.device)[None, :]
              < lengths.to(qkv.device)[:, None])           # [B, L]
    p = torch.where(key_ok[:, None, None, :], torch.exp2(s),
                    torch.zeros((), device=qkv.device)).to(dt).float()
    o = p @ v.float()
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (o * (1.0 / denom)).to(dt)
    return out.permute(0, 2, 1, 3).reshape(B * L, H * D)


def fused_attention(qkv: torch.Tensor, lengths: torch.Tensor, *, B: int,
                    L: int, H: int, D: int) -> torch.Tensor:
    """qkv [B*L, 3*H*D] (columns [q | k | v], heads contiguous), lengths
    [B] int32 -> context [B*L, H*D] in qkv's dtype. Keys at positions
    >= lengths[b] get probability exactly 0; a row with length 0 gives 0.

    A CUDA tensor launches K2 (``csrc/attention.cu``; bf16 qkv, int32
    lengths on the same device). A CPU tensor runs ``fused_attention_ref``.
    """
    E = H * D
    if tuple(qkv.shape) != (B * L, 3 * E):
        raise ValueError(f"qkv {tuple(qkv.shape)} != {(B * L, 3 * E)}")
    if not supported(L, H, D):
        raise ValueError(f"fused_attention does not take L={L} H={H} D={D}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B]={B}, got {tuple(lengths.shape)}")
    if qkv.device.type == "cpu":
        return fused_attention_ref(qkv, lengths, B=B, L=L, H=H, D=D)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not "
                         f"{qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA fused_attention takes bf16, got "
                        f"{qkv.dtype}")
    if lengths.dtype != torch.int32 or lengths.device != qkv.device:
        raise TypeError("lengths must be int32 on qkv's device")
    if not (qkv.is_contiguous() and lengths.is_contiguous()) \
            or qkv.data_ptr() % 16:
        raise ValueError("qkv and lengths must be contiguous (qkv 16-byte "
                         "aligned)")
    out = torch.empty((B * L, E), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return out
    lib = _lib()
    status = lib.attn_launch(
        qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, L, H, D,
        _scale(D), _clamp_hi(L),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    from ._cuda import check
    check(status, lib.attn_error_string, "fused_attention")
    fused_attention.launches += 1
    return out


# launch counter: every successful K2 launch adds one; callers reset it
# to 0 around the run they measure
fused_attention.launches = 0


def _lib() -> ctypes.CDLL:
    from . import _cuda
    lib = _cuda.load("attention")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_launch.argtypes = [p, p, p, i, i, i, i, f, f, p]
        lib.attn_launch.restype = i
        lib.attn_error_string.argtypes = [i]
        lib.attn_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
