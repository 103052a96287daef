"""Fused dequantize + matmul + epilogue for blockwise-quantized weights —
the PyTorch port of ``embeddings_tpu/ops/qmatmul.py`` (bf16 and int8
modes).

``qmatmul`` is the wrapper: on a CUDA tensor it launches a hand-written
kernel from ``csrc/qmatmul.cu`` or raises; on a CPU tensor it runs the
kernel's plain PyTorch version, which repeats its arithmetic step by step.

bf16 mode, kernel K1, plain version ``qmatmul_ref``:

- the weight is dequantized to bf16 with the TPU kernel's rounding:
  ``bf16(bf16(level) * bf16(scale))``, then ``+ bf16(min)`` rounded again
  for q4_1 (nf4 levels are the NF4 table rounded to bf16);
- x is rounded to bf16 even when it is f32 (the TPU kernel's dot always
  takes bf16 operands), products accumulate in f32;
- epilogues run at f32: bias, GELU in its tanh form (for both "bias_gelu"
  and "bias_gelu_tanh", as in the kernel), SiLU, residual + LayerNorm;
- one cast to ``out_dtype`` (x's dtype by default).

int8 mode (``int8_compute=True``), kernel K3 (``qmatmul_int8``), plain
version ``qmatmul_int8_ref``, the arithmetic of the TPU's ``_qmm_int8``:

- the weight dequantizes in f32 (``level * scale (+ min)``) and is
  requantized per column: ``cs = max(colmax, 1e-12) * (1/127)``,
  ``w8 = round(w * (1/cs))`` (``requantize_weight``);
- x, as given (not first rounded to bf16), is quantized per row the same
  way (``quantize_rows``);
- s8 x s8 -> s32 product, then ``acc * cs``, then ``acc * sx + bias``,
  then K1's epilogues without a second bias add.

int8 engages only where the JAX package's kernel engages it
(``int8_engages``); elsewhere the call runs K1 with JAX's warning. The
quantized-output emission (``emit_quantized``) is not ported yet.
"""

from __future__ import annotations

import collections
import ctypes
import logging

import torch

from .quant import NF4_TABLE, PACK4_KINDS, QK, QuantizedTensor, \
    _unpack_g64, dequantize

EPILOGUES = ("none", "bias", "bias_gelu", "bias_gelu_tanh", "bias_silu",
             "bias_residual_ln")
_KIND_ID = {"q4_0": 0, "q4_1": 1, "q8_0": 2, "nf4": 3}

log = logging.getLogger("embeddings_tpu_torch.qmatmul")


def _resolve(x, codes, scales, mins, bias, kind, epilogue, residual,
             ln_scale, ln_bias, packed, emit_quantized):
    """Validate the call (both paths) and return (M, K, N, epilogue)."""
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
                                 packed, "no")
    w = dequantize_bf16(codes, scales, mins, kind, packed)
    acc = x.to(torch.bfloat16).float() @ w.float()
    if epilogue != "none" and bias is not None:
        acc = acc + bias.float()
    return _epilogue(acc, epilogue, residual, ln_scale, ln_bias,
                     ln_eps).to(out_dtype or x.dtype)


def _epilogue(acc, epilogue, residual, ln_scale, ln_bias, ln_eps):
    """The activation / residual-LayerNorm part of the epilogue (the bias
    is already in ``acc``), at f32 — the TPU's ``_apply_epilogue``."""
    if epilogue in ("bias_gelu", "bias_gelu_tanh"):
        return gelu_tanh(acc)
    if epilogue == "bias_silu":
        return acc * torch.sigmoid(acc)
    if epilogue == "bias_residual_ln":
        y = acc + residual.float()
        mean = y.mean(-1, keepdim=True)
        var = (y - mean).square().mean(-1, keepdim=True)
        return ((y - mean) * torch.rsqrt(var + ln_eps) * ln_scale.float()
                + ln_bias.float())
    return acc


def int8_engages(K: int, N: int, packed: bool = False) -> bool:
    """Does the int8 mode run at this weight shape? The JAX package's rule
    (its ``int8_engages`` and the lane check in ``qmatmul``) without the
    TPU's VMEM budget: lane-aligned N (a multiple of 128), K % 32 == 0,
    and K % 64 == 0 when the codes are packed."""
    return N % 128 == 0 and K % 32 == 0 and (not packed or K % 64 == 0)


def _quantize_f32(v: torch.Tensor, dim: int):
    """Symmetric int8 over ``dim``: scale = max(absmax, 1e-12) * (1/127),
    q = round(v * (1/scale)), half to even (|v| <= absmax, so q lands in
    [-127, 127] without a clip). Returns (q int8, scale f32 with ``dim``
    kept)."""
    s = v.abs().amax(dim, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    return torch.round(v * (1.0 / s)).to(torch.int8), s


def quantize_rows(x: torch.Tensor):
    """x [..., K] (any float dtype, used as given) -> (q int8 [..., K],
    row scales f32 [..., 1])."""
    return _quantize_f32(x.float(), -1)


def requantize_weight(codes: torch.Tensor, scales: torch.Tensor,
                      mins: torch.Tensor | None, kind: str, packed: bool):
    """Quantized weight -> (w8 int8 [K, N], cs f32 [1, N]), dequantized in
    f32, requantized to per-column symmetric int8 (the TPU kernel's
    two-pass requantization of its weight tile)."""
    w = dequantize(QuantizedTensor(codes, scales, mins, kind, -2, packed))
    return _quantize_f32(w, 0)


def int_dot(q: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """s8 x s8 -> s32 product, returned as f32 (int32 -> f32 rounding).
    Computed in f64, where every sum of int8 products up to K = 2^20 is
    exact, so it runs on any device."""
    return (q.double() @ w8.double()).float()


def qmatmul_int8_ref(x: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor, mins: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None, *, kind: str = "q4_0",
                     epilogue: str | None = None,
                     residual: torch.Tensor | None = None,
                     ln_scale: torch.Tensor | None = None,
                     ln_bias: torch.Tensor | None = None,
                     ln_eps: float = 1e-12, packed: bool = False,
                     out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of K3 (same arguments as ``qmatmul``)."""
    _, _, _, epilogue = _resolve(x, codes, scales, mins, bias, kind,
                                 epilogue, residual, ln_scale, ln_bias,
                                 packed, "no")
    w8, cs = requantize_weight(codes, scales, mins, kind, packed)
    q, sx = quantize_rows(x)
    acc = int_dot(q, w8) * cs
    if epilogue != "none" and bias is not None:
        acc = acc * sx + bias.float()
    else:
        acc = acc * sx
    return _epilogue(acc, epilogue, residual, ln_scale, ln_bias,
                     ln_eps).to(out_dtype or x.dtype)


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
    LayerNorm parameters f32. A CPU tensor runs ``qmatmul_ref``.

    int8_compute: the int8 tensor-core mode, ``qmatmul_int8`` (K3, or
    ``qmatmul_int8_ref`` on a CPU tensor), where ``int8_engages``; other
    shapes run the bf16 mode with a warning, as in the JAX package."""
    M, K, N, epilogue = _resolve(x, codes, scales, mins, bias, kind,
                                 epilogue, residual, ln_scale, ln_bias,
                                 packed, emit_quantized)
    kw = dict(kind=kind, epilogue=epilogue, residual=residual,
              ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
              packed=packed, out_dtype=out_dtype)
    if int8_compute:
        if int8_engages(K, N, packed):
            return qmatmul_int8(x, codes, scales, mins, bias, **kw)
        log.warning("int8_compute requested but (K=%d, N=%d) has a ragged "
                    "lane count - falling back to bf16 compute for this "
                    "matmul", K, N)
    if x.device.type == "cpu":
        return qmatmul_ref(x, codes, scales, mins, bias, **kw)
    ptr, out = _cuda_operands("qmatmul", x, codes, scales, mins, bias, M, N,
                              **kw)
    if M == 0:
        return out
    lib = _lib()
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


def qmatmul_int8(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                 mins: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None, *, kind: str = "q4_0",
                 epilogue: str | None = None,
                 residual: torch.Tensor | None = None,
                 ln_scale: torch.Tensor | None = None,
                 ln_bias: torch.Tensor | None = None, ln_eps: float = 1e-12,
                 packed: bool = False, out_dtype=None) -> torch.Tensor:
    """The int8 mode of ``qmatmul`` (same arguments and tensor types).

    A CUDA tensor launches K3 (``csrc/qmatmul.cu``): three kernels on the
    current stream — the weight's per-column requantization into an int8
    [N, K] scratch, the rows' quantization into an int8 [M, K] scratch,
    and the s8 x s8 -> s32 tensor-core product with the rescale and the
    epilogue. A CPU tensor runs ``qmatmul_int8_ref``."""
    M, K, N, epilogue = _resolve(x, codes, scales, mins, bias, kind,
                                 epilogue, residual, ln_scale, ln_bias,
                                 packed, "no")
    kw = dict(kind=kind, epilogue=epilogue, residual=residual,
              ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
              packed=packed, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return qmatmul_int8_ref(x, codes, scales, mins, bias, **kw)
    ptr, out = _cuda_operands("qmatmul_int8", x, codes, scales, mins, bias,
                              M, N, **kw)
    if M == 0:
        return out
    dev = x.device
    w8t = torch.empty((N, K), dtype=torch.int8, device=dev)
    q = torch.empty((M, K), dtype=torch.int8, device=dev)
    cs = torch.empty(N, dtype=torch.float32, device=dev)
    sx = torch.empty(M, dtype=torch.float32, device=dev)
    lib = _lib()
    status = lib.qmm_int8_launch(
        ptr["x"], ptr["codes"], ptr["scales"], ptr.get("mins"), ptr["bias"],
        ptr.get("residual"), ptr.get("ln_scale"), ptr.get("ln_bias"),
        w8t.data_ptr(), cs.data_ptr(), q.data_ptr(), sx.data_ptr(),
        out.data_ptr(), M, N, K, _KIND_ID[kind], int(packed),
        EPILOGUES.index(epilogue), float(ln_eps),
        torch.cuda.current_stream(dev).cuda_stream)
    from ._cuda import check
    check(status, lib.qmm_error_string, "qmatmul_int8")
    qmatmul_int8.launches += 1
    qmatmul_int8.shapes[(K, N, epilogue)] += 1
    return out


# launch counters: every successful K1 (K3) launch adds one, in total and
# per (K, N, epilogue); callers reset them to 0 around the run they measure
qmatmul.launches = 0
qmatmul.shapes = collections.Counter()
qmatmul_int8.launches = 0
qmatmul_int8.shapes = collections.Counter()


def _cuda_operands(what, x, codes, scales, mins, bias, M, N, *, kind,
                   epilogue, residual, ln_scale, ln_bias, ln_eps, packed,
                   out_dtype):
    """Check a CUDA call's tensors (device, dtype, shape, contiguity,
    alignment) and allocate its bf16 output. Returns (pointers, out)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    out_dtype = out_dtype or x.dtype
    if x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise TypeError(f"the CUDA {what} takes bf16 x and writes bf16 "
                        f"(got x {x.dtype}, out {out_dtype})")
    if N % 8:
        raise ValueError(f"the CUDA {what} needs N % 8 == 0, got N={N}")
    want = torch.uint8 if packed else torch.int8
    if bias is None:
        bias = torch.zeros(N, dtype=torch.float32, device=x.device)
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
    ptr = {name: t.data_ptr() for name, (t, _) in tensors.items()}
    return ptr, torch.empty((M, N), dtype=torch.bfloat16, device=x.device)


def _lib() -> ctypes.CDLL:
    from . import _cuda
    lib = _cuda.load("qmatmul")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.qmm_launch.argtypes = [p] * 9 + [i] * 6 + [f, p]
        lib.qmm_launch.restype = i
        lib.qmm_int8_launch.argtypes = [p] * 13 + [i] * 6 + [f, p]
        lib.qmm_int8_launch.restype = i
        lib.qmm_error_string.argtypes = [i]
        lib.qmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
