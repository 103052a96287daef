"""Fused dequantize + matmul + epilogue for blockwise-quantized weights —
the PyTorch port of ``embeddings_tpu/ops/qmatmul.py`` (bf16 mode).

``qmatmul`` is the wrapper: on a CUDA tensor it launches the hand-written
kernel ``csrc/qmatmul.cu`` (K1) or raises; on a CPU tensor it runs
``qmatmul_ref``, the plain PyTorch version that repeats the kernel's
arithmetic step by step:

- the weight is dequantized to bf16 with the TPU kernel's rounding:
  ``bf16(bf16(level) * bf16(scale))``, then ``+ bf16(min)`` rounded again
  for q4_1 (nf4 levels are the NF4 table rounded to bf16);
- x is rounded to bf16 even when it is f32 (the TPU kernel's dot always
  takes bf16 operands), products accumulate in f32;
- epilogues run at f32: bias, GELU in its tanh form (for both "bias_gelu"
  and "bias_gelu_tanh", as in the kernel), SiLU, residual + LayerNorm;
- one cast to ``out_dtype`` (x's dtype by default).

The int8 tensor-core mode (``int8_compute``) and the quantized-output
emission (``emit_quantized``) belong to kernel K3 and are not ported yet.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .quant import NF4_TABLE, PACK4_KINDS, QK, _unpack_g64

EPILOGUES = ("none", "bias", "bias_gelu", "bias_gelu_tanh", "bias_silu",
             "bias_residual_ln")
_KIND_ID = {"q4_0": 0, "q4_1": 1, "q8_0": 2, "nf4": 3}


def _resolve(x, codes, scales, mins, bias, kind, epilogue, residual,
             ln_scale, ln_bias, packed, int8_compute, emit_quantized):
    """Validate the call (both paths) and return (M, K, N, epilogue)."""
    if int8_compute:
        raise NotImplementedError(
            "int8_compute (kernel K3, the int8 tensor-core mode) is not "
            "ported yet")
    if emit_quantized != "no":
        raise NotImplementedError(
            "emit_quantized (the int8 emission epilogue) is not ported yet")
    if kind not in _KIND_ID:
        raise ValueError(f"unknown quant kind {kind!r}")
    if packed and kind not in PACK4_KINDS:
        raise ValueError(f"{kind} codes cannot be nibble-packed")
    if epilogue is None:
        epilogue = "none" if bias is None else "bias"
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    M, K = x.shape
    K2, N = codes.shape
    if packed:
        K2 *= 2
    if K != K2 or K % (64 if packed else QK):
        raise ValueError(f"x {tuple(x.shape)} does not match codes "
                         f"{tuple(codes.shape)} (packed={packed})")
    if tuple(scales.shape) != (K // QK, N):
        raise ValueError(f"scales {tuple(scales.shape)} != {(K // QK, N)}")
    if kind == "q4_1" and (mins is None or tuple(mins.shape) != (K // QK, N)):
        raise ValueError("q4_1 needs mins [K/32, N]")
    if epilogue == "bias_residual_ln" and (
            residual is None or ln_scale is None or ln_bias is None
            or tuple(residual.shape) != (M, N)):
        raise ValueError("bias_residual_ln needs residual [M, N], ln_scale "
                         "and ln_bias")
    return M, K, N, epilogue


def dequantize_bf16(codes: torch.Tensor, scales: torch.Tensor,
                    mins: torch.Tensor | None, kind: str,
                    packed: bool) -> torch.Tensor:
    """Codes -> bf16 weight [K, N] with the kernel's rounding steps."""
    c = _unpack_g64(codes) if packed else codes
    K, N = c.shape
    if kind == "nf4":
        table = torch.from_numpy(NF4_TABLE).to(torch.bfloat16).float()
        lv = table.to(c.device)[c.to(torch.int64) + 8]
    else:
        lv = c.to(torch.float32)
    lv = lv.reshape(K // QK, QK, N)
    s = scales.to(torch.bfloat16).float()[:, None, :]
    w = (lv * s).to(torch.bfloat16)
    if kind == "q4_1":
        m = mins.to(torch.bfloat16).float()[:, None, :]
        w = (w.float() + m).to(torch.bfloat16)
    return w.reshape(K, N)


def gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    """GELU, tanh form, in the TPU kernel's order of operations."""
    c = 0.7978845608028654  # sqrt(2 / pi)
    return v * (0.5 * (1.0 + torch.tanh(c * (v + 0.044715 * (v * v * v)))))


def qmatmul_ref(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                mins: torch.Tensor | None = None,
                bias: torch.Tensor | None = None, *, kind: str = "q4_0",
                epilogue: str | None = None,
                residual: torch.Tensor | None = None,
                ln_scale: torch.Tensor | None = None,
                ln_bias: torch.Tensor | None = None, ln_eps: float = 1e-12,
                packed: bool = False, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of K1 (same arguments as ``qmatmul``)."""
    _, _, N, epilogue = _resolve(x, codes, scales, mins, bias, kind,
                                 epilogue, residual, ln_scale, ln_bias,
                                 packed, False, "no")
    w = dequantize_bf16(codes, scales, mins, kind, packed)
    acc = x.to(torch.bfloat16).float() @ w.float()
    if epilogue != "none":
        if bias is not None:
            acc = acc + bias.float()
    if epilogue in ("bias_gelu", "bias_gelu_tanh"):
        acc = gelu_tanh(acc)
    elif epilogue == "bias_silu":
        acc = acc * torch.sigmoid(acc)
    elif epilogue == "bias_residual_ln":
        y = acc + residual.float()
        mean = y.mean(-1, keepdim=True)
        var = (y - mean).square().mean(-1, keepdim=True)
        acc = ((y - mean) * torch.rsqrt(var + ln_eps) * ln_scale.float()
               + ln_bias.float())
    return acc.to(out_dtype or x.dtype)


def qmatmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
            mins: torch.Tensor | None = None,
            bias: torch.Tensor | None = None, *, kind: str = "q4_0",
            epilogue: str | None = None,
            residual: torch.Tensor | None = None,
            ln_scale: torch.Tensor | None = None,
            ln_bias: torch.Tensor | None = None, ln_eps: float = 1e-12,
            packed: bool = False, out_dtype=None,
            int8_compute: bool = False,
            emit_quantized: str = "no") -> torch.Tensor:
    """x [M, K] @ dequant(codes [K, N] | packed [K/2, N], scales [K//32, N])
    -> epilogue -> [M, N] in out_dtype (x.dtype by default).

    epilogue: "none" | "bias" | "bias_gelu" | "bias_gelu_tanh" |
    "bias_silu" | "bias_residual_ln" (LayerNorm(residual + x@w + bias)
    over the full row); None picks "bias" when a bias is given.

    A CUDA tensor launches K1 (``csrc/qmatmul.cu``): x, residual and the
    output are bf16 there, codes int8/uint8, scales, mins, bias and the
    LayerNorm parameters f32. A CPU tensor runs ``qmatmul_ref``."""
    M, K, N, epilogue = _resolve(x, codes, scales, mins, bias, kind,
                                 epilogue, residual, ln_scale, ln_bias,
                                 packed, int8_compute, emit_quantized)
    if x.device.type == "cpu":
        return qmatmul_ref(x, codes, scales, mins, bias, kind=kind,
                           epilogue=epilogue, residual=residual,
                           ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
                           packed=packed, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul runs on cuda or cpu, not {x.device}")
    out_dtype = out_dtype or x.dtype
    if x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise TypeError("the CUDA qmatmul takes bf16 x and writes bf16 "
                        f"(got x {x.dtype}, out {out_dtype})")
    if N % 8:
        raise ValueError(f"the CUDA qmatmul needs N % 8 == 0, got N={N}")
    want = torch.uint8 if packed else torch.int8
    f32 = dict(dtype=torch.float32, device=x.device)
    if bias is None:
        bias = torch.zeros(N, **f32)
    tensors = {"x": (x, torch.bfloat16), "codes": (codes, want),
               "scales": (scales, torch.float32), "bias": (bias, torch.float32)}
    if kind == "q4_1":
        tensors["mins"] = (mins, torch.float32)
    if epilogue == "bias_residual_ln":
        tensors.update(residual=(residual, torch.bfloat16),
                       ln_scale=(ln_scale, torch.float32),
                       ln_bias=(ln_bias, torch.float32))
        if tuple(ln_scale.shape) != (N,) or tuple(ln_bias.shape) != (N,):
            raise ValueError("ln_scale and ln_bias must be [N]")
    if tuple(bias.shape) != (N,):
        raise ValueError(f"bias must be [N]={N}, got {tuple(bias.shape)}")
    for name, (t, dtype) in tensors.items():
        if t.device != x.device or t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on {x.device}, got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    lib = _lib()
    ptr = {name: t.data_ptr() for name, (t, _) in tensors.items()}
    status = lib.qmm_launch(
        ptr["x"], ptr["codes"], ptr["scales"], ptr.get("mins"), ptr["bias"],
        ptr.get("residual"), ptr.get("ln_scale"), ptr.get("ln_bias"),
        out.data_ptr(), M, N, K, _KIND_ID[kind], int(packed),
        EPILOGUES.index(epilogue), float(ln_eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    from ._cuda import check
    check(status, lib.qmm_error_string, "qmatmul")
    qmatmul.launches += 1
    qmatmul.shapes[(K, N, epilogue)] += 1
    return out


# launch counters: every successful K1 launch adds one (total and per
# (K, N, epilogue)); callers reset them to 0 around the run they measure
qmatmul.launches = 0
qmatmul.shapes = collections.Counter()


def _lib() -> ctypes.CDLL:
    from . import _cuda
    lib = _cuda.load("qmatmul")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                   i, ctypes.c_float, p]
        lib.qmm_launch.restype = i
        lib.qmm_error_string.argtypes = [i]
        lib.qmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
