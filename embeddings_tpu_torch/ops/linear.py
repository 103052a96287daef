"""Linear op with quantization-aware dispatch — the PyTorch port of
``embeddings_tpu/ops/linear.py`` (bf16 and int8 modes, and the chained-
int8 activations: ``ActQ`` inputs, emission, the link switch).

``linear`` is the single entry point the model code calls. It routes:

- quantized weights (``QuantizedTensor``) with ``use_kernels`` to
  ``ops.qmatmul.qmatmul``: kernel K1 (K3 with ``int8``, reading the
  weight's kept int8 requantization ``w.int8`` where the Engine made one)
  on a CUDA tensor, its plain version on a CPU tensor (the same
  arithmetic);
- quantized weights without ``use_kernels`` to the plain f32 reference
  math the JAX package uses off the TPU: dequantize, f32 matmul (with
  ``int8``, ``_int8_emulated_dot``), exact-erf GELU;
- dense weights to ``torch.matmul`` at f32 (a plain product, left to the
  library as the JAX package leaves it to XLA).

``int8`` is an explicit argument, passed down from the Engine's
``EngineConfig.int8_compute``; the JAX package reads a trace-time global.

Chained int8 (the JAX package's ``_CHAIN_LINKS``): an input may be an
``ActQ`` (int8 rows + row scales, produced once by the previous kernel's
emission or ``quantize_act``), which the int8 kernel reads as it is (K3x);
``emit`` asks the kernel for its output quantized too ("both") or
instead ("only"). The JAX package's two safety nets are kept as shape
rules: an ``ActQ`` at a shape where int8 does not engage is dequantized
back to rows (the kernel then runs in bf16 and emits from K1), and on a
CPU tensor a shape the emission does not take (``emit_fits``) runs the
plain path and quantizes with ``quantize_act``. A CUDA tensor always
takes the kernels, which raise at a shape they do not take. The link set
is a process-wide
switch (``set_chain_links`` / ``chain_links``, none by default as in the
JAX package) that the model reads once per forward.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .qmatmul import emit_fits, int8_engages, int_dot, qmatmul, \
    quantize_rows
from .quant import QuantizedTensor, dequantize, quantize_sym


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
    to even; |x| <= row absmax, so no clip is needed). Counted in
    ``quantize_act.calls``."""
    quantize_act.calls += 1
    return ActQ(*quantize_rows(x))


quantize_act.calls = 0

LINKS = frozenset({"attn", "ln", "ffn"})
# The chained-int8 link set, the JAX package's switch and default (none):
#   "attn": the whole-row / segmented attention kernels emit the context
#           int8-only, read by the o-projection;
#   "ln":   the two residual-LN matmuls also emit their output ("both"),
#           read by the next qkv / up projection;
#   "ffn":  the FFN-up matmul emits its activation int8-only, read by the
#           down projection.
_CHAIN_LINKS = frozenset()


def set_chain_links(links) -> None:
    global _CHAIN_LINKS
    links = frozenset(links)
    if not links <= LINKS:
        raise ValueError(f"unknown chain links {sorted(links - LINKS)}; "
                         f"the links are {sorted(LINKS)}")
    _CHAIN_LINKS = links


@contextlib.contextmanager
def chain_links(links):
    """Scoped override of the chained-int8 link set."""
    global _CHAIN_LINKS
    prev = _CHAIN_LINKS
    set_chain_links(links)
    try:
        yield
    finally:
        _CHAIN_LINKS = prev


def chain_link_on(name: str) -> bool:
    return name in _CHAIN_LINKS


def active_chain_links() -> frozenset:
    """The link set in force (a forward reads it once, at entry)."""
    return _CHAIN_LINKS


def _int8_emulated_dot(x2d: torch.Tensor | ActQ,
                       wd: torch.Tensor) -> torch.Tensor:
    """The plain f32 emulation of the int8 mode (the JAX package's
    ``_int8_emulated_dot``): per-column symmetric int8 weights on top of
    the dequantized f32 values, per-row int8 activations (or the given
    ones for an ActQ), s8 x s8 -> s32, rescale ``acc * sx * cs``. The
    requantization multiplies by the reciprocal, as the kernel does."""
    w8, cs = quantize_sym(wd.float(), 0)
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


def _dequant_act(x: ActQ, dtype) -> torch.Tensor:
    """The safety net: an ActQ's rows back as values (q * s) in dtype."""
    return (x.q.float() * x.s).to(dtype)


def _on_card(x: torch.Tensor | ActQ) -> bool:
    """Is x on a device with the kernels (not the CPU)? There the kernel
    path is taken at every shape and raises where no kernel takes it."""
    return (x.q if isinstance(x, ActQ) else x).device.type != "cpu"


def quantized_matmul(x2d: torch.Tensor | ActQ, w: QuantizedTensor,
                     b: torch.Tensor | None = None, act: str | None = None,
                     *, use_kernels: bool = True, int8: bool = False,
                     emit: str = "no", out_dtype=None):
    """[M, K] @ quantized [K, N] (+bias, +act) -> [M, N] in x2d.dtype (bf16
    for an ActQ). x2d may be an ActQ; emit "both" returns (y, ActQ), "only"
    an ActQ (both need an epilogue the kernel has: not relu)."""
    if w.block_axis != -2:
        raise ValueError("quantized_matmul expects a [K, N] matmul weight")
    prequant = isinstance(x2d, ActQ)
    M, K = x2d.shape
    N = w.shape[1]
    out_dtype = out_dtype or (torch.bfloat16 if prequant else x2d.dtype)
    if emit != "no" and act == "relu":
        raise ValueError("relu has no kernel epilogue to emit from")
    if use_kernels and (emit == "no" or _on_card(x2d)
                        or emit_fits(K, N, w.packed)):
        i8 = (int8 or prequant) and int8_engages(K, N, w.packed)
        if prequant and not i8:
            x2d, prequant = _dequant_act(x2d, out_dtype), False
        out = qmatmul(x2d.q if prequant else x2d, w.codes, w.scales, w.mins,
                      b, kind=w.kind, epilogue=_EPILOGUE[act],
                      packed=w.packed, out_dtype=out_dtype,
                      int8_compute=i8 or int8,
                      x_scale=x2d.s.reshape(M) if prequant else None,
                      emit_quantized=emit, int8_weight=w.int8)
        if emit == "no":
            return torch.relu(out) if act == "relu" else out
        if emit == "only":
            return ActQ(*out)
        return out[0], ActQ(out[1], out[2])
    if int8 or prequant:
        y = _int8_emulated_dot(x2d, dequantize(w))
    else:
        y = x2d.float() @ dequantize(w)
    if b is not None:
        y = y + b.float()
    y = _activate(y, act)
    if emit == "no":
        return y.to(out_dtype)
    yq = quantize_act(y)
    return yq if emit == "only" else (y.to(out_dtype), yq)


def _reshape_actq(a: ActQ, *lead) -> ActQ:
    return ActQ(a.q.reshape(*lead, a.q.shape[-1]), a.s.reshape(*lead, 1))


def linear(x: torch.Tensor | ActQ, w, b: torch.Tensor | None = None,
           act: str | None = None, *, use_kernels: bool = True,
           int8: bool = False, emit: str = "no"):
    """y = act(x @ w + b) with w dense [K, N] or a QuantizedTensor.
    x: [..., K] (or an ActQ) -> [..., N] in x.dtype; bias added at f32.
    ``int8``: the int8 mode for a quantized weight (a dense weight ignores
    it). ``emit``: as ``quantized_matmul`` (quantized weights only)."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    if isinstance(w, QuantizedTensor):
        x2d = _reshape_actq(x, -1) if isinstance(x, ActQ) \
            else x.reshape(-1, K)
        out = quantized_matmul(x2d, w, b, act, use_kernels=use_kernels,
                               int8=int8, emit=emit)
        if emit == "only":
            return _reshape_actq(out, *lead)
        if emit == "both":
            return (out[0].reshape(*lead, out[0].shape[-1]),
                    _reshape_actq(out[1], *lead))
        return out.reshape(*lead, out.shape[-1])
    if isinstance(x, ActQ) or emit != "no":
        raise ValueError("a dense weight takes neither an ActQ nor emit")
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return _activate(y, act).to(x.dtype)


def linear_residual_ln(x: torch.Tensor | ActQ, w, b: torch.Tensor,
                       residual: torch.Tensor, ln_scale: torch.Tensor,
                       ln_bias: torch.Tensor, eps: float, *,
                       use_kernels: bool = True, int8: bool = False,
                       emit: str = "no"):
    """LayerNorm(residual + x @ w + b) — the post-attention / post-FFN
    step. For a quantized weight with ``use_kernels`` the residual add and
    the LayerNorm run in K1's (K3's) epilogue; otherwise the composed ops.
    x: [..., K] or an ActQ, residual [..., N] -> [..., N] in x.dtype (bf16
    for an ActQ, the residual cast to it as in the JAX package). emit
    "both": also the output as an ActQ, quantized in the kernel's
    LayerNorm walk (or by ``quantize_act`` on the composed path)."""
    prequant = isinstance(x, ActQ)
    lead = x.shape[:-1]
    K, N = x.shape[-1], residual.shape[-1]
    out_dtype = torch.bfloat16 if prequant else x.dtype
    if emit not in ("no", "both"):
        raise ValueError(f"linear_residual_ln emits 'no' or 'both', not "
                         f"{emit!r}")
    if isinstance(w, QuantizedTensor) and w.block_axis == -2 and use_kernels \
            and (emit == "no" or _on_card(x) or emit_fits(K, N, w.packed)):
        M = math.prod(lead)
        i8 = (int8 or prequant) and int8_engages(K, N, w.packed)
        if prequant and not i8:
            x, prequant = _dequant_act(x, out_dtype), False
        out = qmatmul(x.q.reshape(M, K) if prequant else x.reshape(M, K),
                      w.codes, w.scales, w.mins, b, kind=w.kind,
                      epilogue="bias_residual_ln",
                      residual=residual.reshape(M, N).to(out_dtype),
                      ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=eps,
                      packed=w.packed, out_dtype=out_dtype,
                      int8_compute=i8 or int8,
                      x_scale=x.s.reshape(M) if prequant else None,
                      emit_quantized=emit, int8_weight=w.int8)
        if emit == "both":
            return (out[0].reshape(*lead, N),
                    _reshape_actq(ActQ(out[1], out[2]), *lead))
        return out.reshape(*lead, N)
    from ..models.bert import layer_norm  # late import: avoids a cycle
    y = linear(x, w, b, use_kernels=use_kernels, int8=int8)
    out = layer_norm(residual + y, ln_scale, ln_bias, eps)
    if emit == "both":
        return out, _reshape_actq(quantize_act(out.reshape(-1, N)), *lead)
    return out
