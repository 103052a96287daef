"""Linear op with quantization-aware dispatch — the PyTorch port of
``embeddings_tpu/ops/linear.py`` (bf16 and int8 modes; the chained-int8
links are not ported).

``linear`` is the single entry point the model code calls. It routes:

- quantized weights (``QuantizedTensor``) with ``use_kernels`` to
  ``ops.qmatmul.qmatmul``: kernel K1 (K3 with ``int8``) on a CUDA tensor,
  its plain version on a CPU tensor (the same arithmetic);
- quantized weights without ``use_kernels`` to the plain f32 reference
  math the JAX package uses off the TPU: dequantize, f32 matmul (with
  ``int8``, ``_int8_emulated_dot``), exact-erf GELU;
- dense weights to ``torch.matmul`` at f32 (a plain product, left to the
  library as the JAX package leaves it to XLA).

``int8`` is an explicit argument, passed down from the Engine's
``EngineConfig.int8_compute``; the JAX package reads a trace-time global.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .qmatmul import _quantize_f32, int_dot, qmatmul, quantize_rows
from .quant import QuantizedTensor, dequantize


class ActQ(NamedTuple):
    """A per-row int8-quantized activation: q [..., K] int8 plus row scales
    s [..., 1] f32 (value = q * s)."""
    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):  # the logical (dequantized) dtype
        return torch.bfloat16


def quantize_act(x: torch.Tensor) -> ActQ:
    """Rowwise symmetric int8 quantization of an activation (round half
    to even; |x| <= row absmax, so no clip is needed)."""
    return ActQ(*quantize_rows(x))


def _int8_emulated_dot(x2d: torch.Tensor | ActQ,
                       wd: torch.Tensor) -> torch.Tensor:
    """The plain f32 emulation of the int8 mode (the JAX package's
    ``_int8_emulated_dot``): per-column symmetric int8 weights on top of
    the dequantized f32 values, per-row int8 activations (or the given
    ones for an ActQ), s8 x s8 -> s32, rescale ``acc * sx * cs``. The
    requantization multiplies by the reciprocal, as the kernel does."""
    w8, cs = _quantize_f32(wd.float(), 0)
    q, sx = (x2d.q, x2d.s.float()) if isinstance(x2d, ActQ) \
        else quantize_rows(x2d)
    return int_dot(q, w8) * sx * cs

# model activation name -> fused kernel epilogue (relu has none: the bias
# runs fused and relu applies after, as in the JAX package)
_EPILOGUE = {None: None, "relu": None, "gelu": "bias_gelu",
             "gelu_tanh": "bias_gelu_tanh", "silu": "bias_silu"}


def _activate(y: torch.Tensor, act: str | None) -> torch.Tensor:
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return torch.relu(y)
    if act is not None:
        return F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    return y


def quantized_matmul(x2d: torch.Tensor, w: QuantizedTensor,
                     b: torch.Tensor | None = None, act: str | None = None,
                     *, use_kernels: bool = True,
                     int8: bool = False) -> torch.Tensor:
    """[M, K] @ quantized [K, N] (+bias, +act) -> [M, N] in x2d.dtype."""
    if w.block_axis != -2:
        raise ValueError("quantized_matmul expects a [K, N] matmul weight")
    if use_kernels:
        out = qmatmul(x2d, w.codes, w.scales, w.mins, b, kind=w.kind,
                      epilogue=_EPILOGUE[act], packed=w.packed,
                      out_dtype=x2d.dtype, int8_compute=int8)
        return torch.relu(out) if act == "relu" else out
    if int8:
        y = _int8_emulated_dot(x2d, dequantize(w))
    else:
        y = x2d.float() @ dequantize(w)
    if b is not None:
        y = y + b.float()
    return _activate(y, act).to(x2d.dtype)


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None,
           act: str | None = None, *, use_kernels: bool = True,
           int8: bool = False) -> torch.Tensor:
    """y = act(x @ w + b) with w dense [K, N] or a QuantizedTensor.
    x: [..., K] -> [..., N] in x.dtype; bias added at f32. ``int8``: the
    int8 mode for a quantized weight (a dense weight ignores it)."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    if isinstance(w, QuantizedTensor):
        out = quantized_matmul(x.reshape(-1, K), w, b, act,
                               use_kernels=use_kernels, int8=int8)
        return out.reshape(*lead, out.shape[-1])
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return _activate(y, act).to(x.dtype)


def linear_residual_ln(x: torch.Tensor, w, b: torch.Tensor,
                       residual: torch.Tensor, ln_scale: torch.Tensor,
                       ln_bias: torch.Tensor, eps: float, *,
                       use_kernels: bool = True,
                       int8: bool = False) -> torch.Tensor:
    """LayerNorm(residual + x @ w + b) — the post-attention / post-FFN
    step. For a quantized weight with ``use_kernels`` the residual add and
    the LayerNorm run in K1's (K3's) epilogue; otherwise the composed ops.
    x: [..., K], residual [..., N] -> [..., N] in x.dtype."""
    if isinstance(w, QuantizedTensor) and w.block_axis == -2 and use_kernels:
        lead = x.shape[:-1]
        K, N = x.shape[-1], residual.shape[-1]
        M = math.prod(lead)
        out = qmatmul(x.reshape(M, K), w.codes, w.scales, w.mins, b,
                      kind=w.kind, epilogue="bias_residual_ln",
                      residual=residual.reshape(M, N).to(x.dtype),
                      ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=eps,
                      packed=w.packed, out_dtype=x.dtype, int8_compute=int8)
        return out.reshape(*lead, N)
    from ..models.bert import layer_norm  # late import: avoids a cycle
    y = linear(x, w, b, use_kernels=use_kernels, int8=int8)
    return layer_norm(residual + y, ln_scale, ln_bias, eps)
