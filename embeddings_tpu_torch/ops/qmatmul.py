"""Fused dequantize + matmul + epilogue for blockwise-quantized weights —
the PyTorch port of ``embeddings_tpu/ops/qmatmul.py`` (bf16 and int8
modes, pre-quantized input, quantized-output emission).

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
  way (``quantize_rows``) — or, pre-quantized (K3x), x is int8 with its
  row scales ``x_scale`` [M] and is read as it is;
- s8 x s8 -> s32 product, then ``acc * cs``, then ``acc * sx + bias``,
  then K1's epilogues without a second bias add.

On the card K3 is K1's wgmma kernel instantiated for int8 operands
(``k3_tile`` picks its tile as ``k1_tile`` does K1's), and the
requantized weight is made once per weight, not once per call
(``requantize_int8``, kept on the ``QuantizedTensor`` by
``keep_int8_weight`` when the Engine is built with ``int8_compute``; a
call on a weight without it requantizes for that call). The JAX package
requantizes each weight tile on every call; the values are the same.

Emission (``emit_quantized``, K1e / K3e, the TPU's ``_emit``): "both"
also returns the f32 epilogue output quantized per row, ``so =
max(max|acc_row|, 1e-12) * (1/127)``, ``o8 = round(acc * (1/so))``, as
``(out, o8 [M, N] int8, so [M, 1] f32)``; "only" returns ``(o8, so)``.

int8 engages only where the JAX package's kernel engages it
(``int8_engages``); elsewhere the call runs K1 with JAX's warning, and an
int8 x there is refused (JAX asserts). Emission takes every shape the
kernels take (``emit_fits``), in either mode.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import logging

import numpy as np
import torch

from .quant import EMITS, NF4_TABLE, PACK4_KINDS, QK, QuantizedTensor, \
    _unpack_g64, count_launch, dequantize, emit_result, quantize_sym

EPILOGUES = ("none", "bias", "bias_gelu", "bias_gelu_tanh", "bias_silu",
             "bias_residual_ln")
_KIND_ID = {"q4_0": 0, "q4_1": 1, "q8_0": 2, "nf4": 3}
# K1's output tile: BN columns; BM rows of 256, or 128 where 256 would
# leave SMs idle; the residual-LayerNorm epilogue runs ceil(N / BN) blocks
# of one row tile as a thread-block cluster, at most K1_CLUSTER_MAX, and
# 256 rows only up to K1_CLUSTER_BM256 blocks (shared memory)
K1_BN, K1_CLUSTER_MAX, K1_CLUSTER_BM256 = 128, 16, 8


def _wgmma_tile(M: int, N: int, epilogue: str,
                num_sms: int) -> tuple[int, int]:
    """(BM, cluster size) of the wgmma kernel (K1 and K3): see
    ``k1_tile``."""
    n_tiles = -(-N // K1_BN)
    if epilogue == "bias_residual_ln":
        if n_tiles > K1_CLUSTER_MAX:
            raise ValueError(
                f"the CUDA qmatmul's residual-LayerNorm epilogue takes rows "
                f"of at most {K1_CLUSTER_MAX * K1_BN} columns (one cluster "
                f"of {K1_CLUSTER_MAX} blocks), got N={N}")
        if n_tiles > K1_CLUSTER_BM256:
            return 128, n_tiles
        # row tiles of whole clusters, and the clusters the card holds
        cs, units, slots = n_tiles, -(-M // 256), max(1, num_sms // n_tiles)
    else:
        cs, units, slots = 1, -(-M // 256) * n_tiles, num_sms
    return (256 if units >= 2 * slots else 128), cs


def _route_name(bm: int, cs: int, epilogue: str) -> str:
    return f"bm{bm}" + (f"_cluster{cs}" if epilogue == "bias_residual_ln"
                        else "")


def k1_tile(M: int, N: int, epilogue: str, num_sms: int) -> tuple[int, int]:
    """K1's tile for an [M, K] x [K, N] call on a card of ``num_sms`` SMs:
    (BM, cluster size). BM = 256 halves the weight dequantization per
    multiply-add against 128, but where its tiles (row tiles of whole
    clusters, for the LayerNorm epilogue) make fewer than two waves of
    the card, BM = 128 fills it instead (context parallelism's shards).
    The cluster is 1 except with the residual-LayerNorm epilogue, whose
    rows are one cluster of ceil(N / 128) blocks; clusters of more than 8
    blocks take 128 rows (a block of 256 would not fit shared memory), and
    rows wider than 16 blocks are refused."""
    return _wgmma_tile(M, N, epilogue, num_sms)


def k1_route(M: int, N: int, epilogue: str, num_sms: int) -> str:
    """The name of K1's tile configuration for a call (``k1_tile``), as
    counted in ``qmatmul.routes``."""
    return _route_name(*k1_tile(M, N, epilogue, num_sms), epilogue)


def k3_tile(M: int, N: int, epilogue: str, num_sms: int) -> tuple[int, int]:
    """K3's tile (BM, cluster size): K1's kernel with int8 operands, so
    K1's shared-memory budget and cluster rules hold unchanged and the
    same choice of rows follows. BM = 256 halves the weight tile's reads
    per product against 128 (K1's reason, its dequantization, is gone: the
    weight arrives requantized), and 128 fills the card where 256 would
    leave fewer than two waves."""
    return _wgmma_tile(M, N, epilogue, num_sms)


def k3_route(M: int, N: int, epilogue: str, num_sms: int) -> str:
    """The name of K3's tile configuration for a call (``k3_tile``), as
    counted in ``qmatmul_int8.routes``: the kernel
    ``qmm_wgmma_kernel<4, false, BM, LN>``."""
    return _route_name(*k3_tile(M, N, epilogue, num_sms), epilogue)

log = logging.getLogger("embeddings_tpu_torch.qmatmul")


def _resolve(x, codes, scales, mins, bias, kind, epilogue, residual,
             ln_scale, ln_bias, packed, emit_quantized, x_scale=None):
    """Validate the call (both paths) and return (M, K, N, epilogue)."""
    if emit_quantized not in EMITS:
        raise ValueError(f"emit_quantized must be one of {EMITS}, got "
                         f"{emit_quantized!r}")
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
    if (x.dtype == torch.int8) != (x_scale is not None):
        raise ValueError("an int8 x comes with its row scales x_scale [M], "
                         "and only an int8 x does")
    if x_scale is not None and x_scale.numel() != M:
        raise ValueError(f"x_scale must hold {M} row scales, got "
                         f"{tuple(x_scale.shape)}")
    if emit_quantized != "no" and not emit_fits(K, N, packed):
        raise ValueError(f"emission does not take K={K} N={N} "
                         f"(packed={packed}): see emit_fits")
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
                packed: bool = False, out_dtype=None,
                emit_quantized: str = "no"):
    """The plain PyTorch version of K1 and K1e (same arguments as
    ``qmatmul``)."""
    _, _, N, epilogue = _resolve(x, codes, scales, mins, bias, kind,
                                 epilogue, residual, ln_scale, ln_bias,
                                 packed, emit_quantized)
    w = dequantize_bf16(codes, scales, mins, kind, packed)
    acc = x.to(torch.bfloat16).float() @ w.float()
    if epilogue != "none" and bias is not None:
        acc = acc + bias.float()
    acc = _epilogue(acc, epilogue, residual, ln_scale, ln_bias, ln_eps)
    return _emit(acc, emit_quantized, out_dtype or x.dtype)


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


def _emit(acc: torch.Tensor, emit: str, out_dtype):
    """The TPU's ``_emit``: the f32 epilogue output as ``out_dtype``,
    and/or its per-row int8 quantization (``quantize_rows``) with the
    [M, 1] f32 row scales."""
    if emit == "no":
        return acc.to(out_dtype)
    o8, so = quantize_rows(acc)
    if emit == "only":
        return o8, so
    return acc.to(out_dtype), o8, so


def int8_engages(K: int, N: int, packed: bool = False) -> bool:
    """Does the int8 mode run at this weight shape? The JAX package's rule
    (its ``int8_engages`` and the lane check in ``qmatmul``) without the
    TPU's VMEM budget: lane-aligned N (a multiple of 128), K % 32 == 0,
    and K % 64 == 0 when the codes are packed."""
    return N % 128 == 0 and K % 32 == 0 and (not packed or K % 64 == 0)


def emit_fits(K: int, N: int, packed: bool = False) -> bool:
    """Can the kernels emit the output quantized at this weight shape?
    The port's own rule: every shape K1 and K3 take (N % 8 == 0, K % 32
    == 0, K % 64 == 0 when the codes are packed) — the residual-LayerNorm
    epilogue quantizes in its full-row walk, the others through an f32
    staging buffer and a second launch. The JAX package's rule also asks
    N % 128 == 0 and its VMEM budget; where int8 does not engage, the
    port emits from K1 (K1e)."""
    return N % 8 == 0 and K % 32 == 0 and (not packed or K % 64 == 0)


def quantize_rows(x: torch.Tensor):
    """x [..., K] (any float dtype, used as given) -> (q int8 [..., K],
    row scales f32 [..., 1])."""
    return quantize_sym(x.float(), -1)


def requantize_weight(codes: torch.Tensor, scales: torch.Tensor,
                      mins: torch.Tensor | None, kind: str, packed: bool):
    """Quantized weight -> (w8 int8 [K, N], cs f32 [1, N]), dequantized in
    f32, requantized to per-column symmetric int8 (the TPU kernel's
    two-pass requantization of its weight tile)."""
    w = dequantize(QuantizedTensor(codes, scales, mins, kind, -2, packed))
    return quantize_sym(w, 0)


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
                     out_dtype=None, x_scale: torch.Tensor | None = None,
                     emit_quantized: str = "no"):
    """The plain PyTorch version of K3, K3x and K3e (same arguments as
    ``qmatmul``; an int8 x comes with ``x_scale`` and writes bf16 by
    default, as in the JAX package)."""
    M, _, _, epilogue = _resolve(x, codes, scales, mins, bias, kind,
                                 epilogue, residual, ln_scale, ln_bias,
                                 packed, emit_quantized, x_scale)
    w8, cs = requantize_weight(codes, scales, mins, kind, packed)
    if x_scale is not None:
        q, sx = x, x_scale.reshape(M, 1).float()
        out_dtype = out_dtype or torch.bfloat16
    else:
        q, sx = quantize_rows(x)
    acc = int_dot(q, w8) * cs
    if epilogue != "none" and bias is not None:
        acc = acc * sx + bias.float()
    else:
        acc = acc * sx
    acc = _epilogue(acc, epilogue, residual, ln_scale, ln_bias, ln_eps)
    return _emit(acc, emit_quantized, out_dtype or x.dtype)


def qmatmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
            mins: torch.Tensor | None = None,
            bias: torch.Tensor | None = None, *, kind: str = "q4_0",
            epilogue: str | None = None,
            residual: torch.Tensor | None = None,
            ln_scale: torch.Tensor | None = None,
            ln_bias: torch.Tensor | None = None, ln_eps: float = 1e-12,
            packed: bool = False, out_dtype=None,
            int8_compute: bool = False, x_scale: torch.Tensor | None = None,
            emit_quantized: str = "no", int8_weight=None):
    """x [M, K] @ dequant(codes [K, N] | packed [K/2, N], scales [K//32, N])
    -> epilogue -> [M, N] in out_dtype (x.dtype by default).

    epilogue: "none" | "bias" | "bias_gelu" | "bias_gelu_tanh" |
    "bias_silu" | "bias_residual_ln" (LayerNorm(residual + x@w + bias)
    over the full row); None picks "bias" when a bias is given.

    A CUDA tensor launches K1 (``csrc/qmatmul.cu``, its tile by
    ``k1_tile``): x, residual and the output are bf16 there, codes
    int8/uint8, scales, mins, bias and the LayerNorm parameters f32; the
    residual-LayerNorm epilogue takes N <= 2,048 there. A CPU tensor runs
    ``qmatmul_ref``.

    int8_compute: the int8 tensor-core mode, ``qmatmul_int8`` (K3, or
    ``qmatmul_int8_ref`` on a CPU tensor), where ``int8_engages``; other
    shapes run the bf16 mode with a warning, as in the JAX package. x may
    then be int8 with its row scales ``x_scale`` [M] (pre-quantized, K3x;
    the output is bf16 unless ``out_dtype`` says otherwise); an int8 x at a
    shape where int8 does not engage raises. ``int8_weight``: the weight's
    kept requantization ``(w8t [N, K] int8, cs [N] f32)`` from
    ``requantize_int8`` (see ``qmatmul_int8``).

    emit_quantized: "no" | "both" | "only" (K1e / K3e, where
    ``emit_fits``): also, or instead, return the epilogue output
    quantized per row — ``(out, o8, so)`` or ``(o8, so)``, o8 int8
    [M, N], so f32 [M, 1]."""
    M, K, N, epilogue = _resolve(x, codes, scales, mins, bias, kind,
                                 epilogue, residual, ln_scale, ln_bias,
                                 packed, emit_quantized, x_scale)
    kw = dict(kind=kind, epilogue=epilogue, residual=residual,
              ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
              packed=packed, out_dtype=out_dtype,
              emit_quantized=emit_quantized)
    if x.dtype == torch.int8 and not (int8_compute
                                      and int8_engages(K, N, packed)):
        raise ValueError(f"a pre-quantized int8 x needs int8_compute at a "
                         f"shape where it engages (K={K}, N={N}); "
                         f"dequantize it first")
    if int8_compute:
        if int8_engages(K, N, packed):
            return qmatmul_int8(x, codes, scales, mins, bias,
                                x_scale=x_scale, int8_weight=int8_weight,
                                **kw)
        log.warning("int8_compute requested but (K=%d, N=%d) has a ragged "
                    "lane count - falling back to bf16 compute for this "
                    "matmul", K, N)
    if x.device.type == "cpu":
        return qmatmul_ref(x, codes, scales, mins, bias, **kw)
    held, out = _cuda_operands("qmatmul", x, codes, scales, mins, bias, M,
                               N, **kw)
    bm, _ = k1_tile(M, N, epilogue, _sm_count(x.device))
    em = _emit_operands(x.device, M, N, epilogue, emit_quantized)
    if M == 0:
        return _emit_result(out, em, emit_quantized)
    lib = _lib()
    from ._cuda import check, on_device
    with on_device("qmatmul", x.device, out=out, **held, **em):
        status = lib.qmm_launch(
            *(_ptr(held.get(k)) for k in ("x", "codes", "scales", "mins")),
            *_epilogue_ptrs(held), _ptr(out), *_emit_ptrs(em), M, N, K,
            _KIND_ID[kind], int(packed), EPILOGUES.index(epilogue),
            EMITS.index(emit_quantized), bm, float(ln_eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    check(status, lib.qmm_error_string, "qmatmul")
    _count(qmatmul, (K, N, epilogue), emit_quantized)
    qmatmul.routes[k1_route(M, N, epilogue, _sm_count(x.device))] += 1
    return _emit_result(out, em, emit_quantized)


def qmatmul_int8(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                 mins: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None, *, kind: str = "q4_0",
                 epilogue: str | None = None,
                 residual: torch.Tensor | None = None,
                 ln_scale: torch.Tensor | None = None,
                 ln_bias: torch.Tensor | None = None, ln_eps: float = 1e-12,
                 packed: bool = False, out_dtype=None,
                 x_scale: torch.Tensor | None = None,
                 emit_quantized: str = "no", int8_weight=None):
    """The int8 mode of ``qmatmul`` (same arguments and tensor types).

    A CUDA tensor launches K3 (``csrc/qmatmul.cu``) on the current
    stream: the rows' quantization (``quantize_rows_int8``; none for an
    int8 x with ``x_scale``: K3x), then K1's wgmma kernel instantiated for
    int8 operands (tile by ``k3_tile``, counted in ``routes``) with the
    rescale and the epilogue (and its emission, K3e: in the LayerNorm
    cluster, or through ``emit_rows_kernel`` after the others). The weight
    is read as ``int8_weight``, its kept requantization ``(w8t [N, K]
    int8, cs [N] f32)`` (``keep_int8_weight``); without it the call
    requantizes the weight first (``requantize_int8``, one more launch).
    A CPU tensor runs ``qmatmul_int8_ref``, which requantizes."""
    M, K, N, epilogue = _resolve(x, codes, scales, mins, bias, kind,
                                 epilogue, residual, ln_scale, ln_bias,
                                 packed, emit_quantized, x_scale)
    if int8_weight is not None and (
            tuple(int8_weight[0].shape) != (N, K)
            or tuple(int8_weight[1].shape) != (N,)):
        raise ValueError(f"int8_weight must be (w8t [N, K]={(N, K)}, cs "
                         f"[N]), got {tuple(int8_weight[0].shape)}, "
                         f"{tuple(int8_weight[1].shape)}")
    kw = dict(kind=kind, epilogue=epilogue, residual=residual,
              ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
              packed=packed, out_dtype=out_dtype,
              emit_quantized=emit_quantized)
    if x.device.type == "cpu":
        return qmatmul_int8_ref(x, codes, scales, mins, bias,
                                x_scale=x_scale, **kw)
    prequant = x_scale is not None
    held, out = _cuda_operands("qmatmul_int8", x, codes, scales, mins,
                               bias, M, N, **kw)
    em = _emit_operands(x.device, M, N, epilogue, emit_quantized)
    if M == 0:
        return _emit_result(out, em, emit_quantized)
    dev = x.device
    w8t, cs = (int8_weight if int8_weight is not None
               else requantize_int8(codes, scales, mins, kind=kind,
                                    packed=packed))
    for name, t, dtype in (("w8t", w8t, torch.int8), ("cs", cs,
                                                       torch.float32)):
        if t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise TypeError(f"int8_weight's {name} must be contiguous "
                            f"{dtype}, 16-byte aligned")
    if prequant:
        sx = x_scale.reshape(M)
        if sx.dtype != torch.float32 or not sx.is_contiguous():
            raise TypeError("x_scale must be contiguous f32")
        q = x
    else:
        q, sx = quantize_rows_int8(x)
    bm, _ = k3_tile(M, N, epilogue, _sm_count(dev))
    lib = _lib()
    from ._cuda import check, on_device
    epi = {k: held.get(k) for k in _EPILOGUE_OPERANDS}
    with on_device("qmatmul_int8", dev, q=q, sx=sx, w8t=w8t, cs=cs, out=out,
                   **epi, **em):
        status = lib.qmm_int8_launch(
            q.data_ptr(), sx.data_ptr(), w8t.data_ptr(), cs.data_ptr(),
            *_epilogue_ptrs(held), _ptr(out), *_emit_ptrs(em), M, N, K,
            EPILOGUES.index(epilogue), EMITS.index(emit_quantized), bm,
            float(ln_eps), torch.cuda.current_stream(dev).cuda_stream)
    check(status, lib.qmm_error_string, "qmatmul_int8")
    _count(qmatmul_int8, (K, N, epilogue), emit_quantized, prequant)
    qmatmul_int8.routes[k3_route(M, N, epilogue, _sm_count(dev))] += 1
    if prequant:
        qmatmul_int8.x8_launches += 1
    return _emit_result(out, em, emit_quantized)


def requantize_int8(codes: torch.Tensor, scales: torch.Tensor,
                    mins: torch.Tensor | None, *, kind: str,
                    packed: bool):
    """A quantized weight [K, N] -> K3's operand: (w8t [N, K] int8,
    contiguous along K, cs [N] f32), ``requantize_weight``'s values
    transposed. A CUDA tensor launches ``requant_kernel`` (counted in
    ``launches``); a CPU tensor runs ``requantize_weight``."""
    K, N = codes.shape
    K *= 2 if packed else 1
    if codes.device.type == "cpu":
        w8, cs = requantize_weight(codes, scales, mins, kind, packed)
        return w8.t().contiguous(), cs.reshape(N)
    if K % (64 if packed else QK) or tuple(scales.shape) != (K // QK, N):
        raise ValueError(f"codes {tuple(codes.shape)} / scales "
                         f"{tuple(scales.shape)} are no [K, N] weight "
                         f"(packed={packed})")
    for name, t in (("codes", codes), ("scales", scales), ("mins", mins)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kind == "q4_1" and mins is None:
        raise ValueError("q4_1 needs mins [K/32, N]")
    dev = codes.device
    w8t = torch.empty((N, K), dtype=torch.int8, device=dev)
    cs = torch.empty(N, dtype=torch.float32, device=dev)
    lib = _lib()
    from ._cuda import check, on_device
    with on_device("requantize_int8", dev, scales=scales, mins=mins):
        status = lib.qmm_requant_launch(
            codes.data_ptr(), scales.data_ptr(), _ptr(mins), w8t.data_ptr(),
            cs.data_ptr(), N, K, _KIND_ID[kind], int(packed),
            torch.cuda.current_stream(dev).cuda_stream)
    check(status, lib.qmm_error_string, "requantize_int8")
    requantize_int8.launches += 1
    return w8t, cs


def quantize_rows_int8(x: torch.Tensor):
    """x [M, K] -> K3's row operand: (q [M, K] int8, sx [M] f32),
    ``quantize_rows``' values. A CUDA tensor (bf16) launches
    ``quant_rows_kernel`` (counted in ``launches``); a CPU tensor runs
    ``quantize_rows``."""
    M, K = x.shape
    if x.device.type == "cpu":
        q, sx = quantize_rows(x)
        return q, sx.reshape(M)
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise TypeError(f"the CUDA row quantization takes contiguous bf16 "
                        f"(16-byte aligned), got {x.dtype}")
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty(M, dtype=torch.float32, device=x.device)
    if M == 0:
        return q, sx
    lib = _lib()
    from ._cuda import check, on_device
    with on_device("quantize_rows_int8", x.device):
        status = lib.qmm_quant_rows_launch(
            x.data_ptr(), q.data_ptr(), sx.data_ptr(), M, K,
            torch.cuda.current_stream(x.device).cuda_stream)
    check(status, lib.qmm_error_string, "quantize_rows_int8")
    quantize_rows_int8.launches += 1
    return q, sx


def keep_int8_weight(qt: QuantizedTensor) -> QuantizedTensor:
    """Requantize a [K, N] (or layer-stacked [..., K, N]) matmul weight
    for K3 once and keep it on ``qt.int8``: (w8t [..., N, K] int8, cs
    [..., N] f32), on the weight's device (``requantize_int8`` per
    layer). Slicing the weight (``qt.map``) slices them along. Returns
    qt."""
    if qt.block_axis != -2:
        raise ValueError("keep_int8_weight takes a [K, N] matmul weight")
    lead = qt.codes.shape[:-2]
    parts = []
    for idx in np.ndindex(*lead):
        one = qt.map(lambda t, i=idx: t[i])
        parts.append(requantize_int8(one.codes, one.scales, one.mins,
                                     kind=qt.kind, packed=qt.packed))
    K, N = qt.shape[-2:]
    qt.int8 = (torch.stack([w for w, _ in parts]).reshape(*lead, N, K),
               torch.stack([c for _, c in parts]).reshape(*lead, N))
    return qt


def _count(fn, shape, emit: str, x8: bool = False) -> None:
    count_launch(fn, emit)
    fn.shapes[shape] += 1
    fn.modes[(*shape, emit, x8)] += 1


# launch counters: every successful K1 (K3) launch adds one, in total,
# per (K, N, epilogue) in ``shapes`` and per (K, N, epilogue, emit, int8
# x) in ``modes``, and one to both_launches / only_launches when it emits
# (K1e / K3e); ``routes`` counts K1's (K3's) launches by tile
# configuration (``k1_route``, ``k3_route``); K3's x8_launches counts the
# launches on a pre-quantized int8 x (K3x, no row quantization); K3's
# weight requantizations and row quantizations count on their wrappers.
# Callers reset them to 0 around the run they measure.
qmatmul.launches = 0
qmatmul.shapes = collections.Counter()
qmatmul.modes = collections.Counter()
qmatmul.routes = collections.Counter()
qmatmul.both_launches = qmatmul.only_launches = 0
qmatmul_int8.launches = 0
qmatmul_int8.shapes = collections.Counter()
qmatmul_int8.modes = collections.Counter()
qmatmul_int8.both_launches = qmatmul_int8.only_launches = 0
qmatmul_int8.x8_launches = 0
qmatmul_int8.routes = collections.Counter()
requantize_int8.launches = 0
quantize_rows_int8.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _emit_operands(dev, M, N, epilogue, emit) -> dict:
    """The emission outputs (o8 int8 [M, N], os f32 [M]) and, for the
    tiled epilogues, the f32 staging [M, N] and partial row maxima
    [ceil(N/128), M] of a CUDA call; empty without emission."""
    if emit == "no":
        return {}
    em = {"o8": torch.empty((M, N), dtype=torch.int8, device=dev),
          "os": torch.empty((M, 1), dtype=torch.float32, device=dev)}
    if epilogue != "bias_residual_ln":
        em["stg"] = torch.empty((M, N), dtype=torch.float32, device=dev)
        em["part"] = torch.empty((-(-N // 128), M), dtype=torch.float32,
                                 device=dev)
    return em


# the epilogue's operands of both launches, in their argument order
_EPILOGUE_OPERANDS = ("bias", "residual", "ln_scale", "ln_bias")


def _epilogue_ptrs(held: dict) -> list:
    return [_ptr(held.get(k)) for k in _EPILOGUE_OPERANDS]


def _emit_ptrs(em: dict) -> list:
    return [_ptr(em.get(k)) for k in ("o8", "os", "stg", "part")]


def _emit_result(out, em: dict, emit: str):
    return emit_result(out, em.get("o8"), em.get("os"), emit)


def _cuda_operands(what, x, codes, scales, mins, bias, M, N, *, kind,
                   epilogue, residual, ln_scale, ln_bias, ln_eps, packed,
                   out_dtype, emit_quantized):
    """Check a CUDA call's tensors (dtype, shape, contiguity,
    alignment) and allocate its bf16 output (none with emission "only").
    Returns (the tensors by name, out); their devices are checked at the
    launch (``_cuda.on_device``)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    prequant = x.dtype == torch.int8
    out_dtype = out_dtype or (torch.bfloat16 if prequant else x.dtype)
    if x.dtype not in (torch.bfloat16, torch.int8) \
            or out_dtype != torch.bfloat16:
        raise TypeError(f"the CUDA {what} takes bf16 (or pre-quantized "
                        f"int8) x and writes bf16 (got x {x.dtype}, out "
                        f"{out_dtype})")
    if N % 8:
        raise ValueError(f"the CUDA {what} needs N % 8 == 0, got N={N}")
    want = torch.uint8 if packed else torch.int8
    if bias is None:
        bias = torch.zeros(N, dtype=torch.float32, device=x.device)
    tensors = {"x": (x, x.dtype), "codes": (codes, want),
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
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = (None if emit_quantized == "only" else
           torch.empty((M, N), dtype=torch.bfloat16, device=x.device))
    return {name: t for name, (t, _) in tensors.items()}, out


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib() -> ctypes.CDLL:
    from . import _cuda
    lib = _cuda.load("qmatmul")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.qmm_launch.argtypes = [p] * 13 + [i] * 8 + [f, p]
        lib.qmm_launch.restype = i
        lib.qmm_int8_launch.argtypes = [p] * 13 + [i] * 6 + [f, p]
        lib.qmm_int8_launch.restype = i
        lib.qmm_requant_launch.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.qmm_requant_launch.restype = i
        lib.qmm_quant_rows_launch.argtypes = [p] * 3 + [i] * 2 + [p]
        lib.qmm_quant_rows_launch.restype = i
        lib.qmm_error_string.argtypes = [i]
        lib.qmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
