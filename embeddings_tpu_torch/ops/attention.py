"""Fused multi-head attention over the fused QKV projection — the
PyTorch port of ``embeddings_tpu/ops/attention.py``: the prefix-masked
``fused_attention`` (K2), its logit-biased variant
``fused_attention_bias`` (K7: MPNet's relative-position bias, ALiBi on
short rows) and its key-streamed variant ``fused_attention_stream`` (K6:
long rows, in-kernel ALiBi; with ``causal=True`` K6c, the Qwen2 decoder
embedders) with its banded mode ``fused_attention_window`` (K6w:
ModernBERT's sliding-window layers), and, for token-packed rows, the
segment-masked ``fused_attention_segmented`` (K4) and its block-skipping
variant ``fused_attention_segmented_blockskip`` (K5); and for context
parallelism (``parallel/context.py``) the rectangular
``fused_attention_cp`` (K8a: a shard's local queries against the
all-gathered K/V) and its key-streamed variant
``fused_attention_cp_stream`` (K8b).

Each wrapper launches its mask mode of a hand-written kernel on a CUDA
tensor, or raises: K2 with its emission K2e and its int8 scores K2i8 (a
kernel of its own in the same library, with or without emission), K4 and
its emission K4e, K5, K7, K6, K6c, K6ca, K6w, K8a and K8b all run on the
Hopper library ``csrc/attention_sm90.cu`` (wgmma, a TMA ring), and so does
K6c at DeepSeek-V2's MLA widths (``fused_attention_stream(dv=, scale=)``:
q and k heads 192 wide, v 128, the port's own);
``attention_kernel`` names the route, and the ``routes`` counters of
``fused_attention``, ``fused_attention_segmented``,
``fused_attention_segmented_blockskip``, ``fused_attention_bias``,
``fused_attention_stream``, ``fused_attention_window``,
``fused_attention_cp`` and ``fused_attention_cp_stream`` count the
launches by route. On a CPU tensor each wrapper runs its plain PyTorch
version, which repeats the kernel's arithmetic step by step: exp2 of the clamped scores with no max-subtraction, probabilities
rounded to the compute dtype before both the PV product and the
denominator, 1e-30 floor on the denominator (pad query rows stay finite).
K2 pre-scales q by log2(e)/sqrt(D) and rounds it to the compute dtype;
K4-K7 scale the f32 scores after the dot, as their TPU kernels do.

K2 and K4 also emit the context per-row quantized to int8
(``emit_quantized``, K2e / K4e: the TPU's ``_emit_int8_rows``, floor
1e-30; "both" quantizes the compute-dtype context it returns, "only" the
f32 one), and K2 runs its int8-scores branch (``int8_scores``, K2i8),
switched by ``set_int8_scores_mode`` / ``int8_scores_mode`` as in the JAX
package ("auto" follows the int8 compute mode, ``use_int8_scores``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import math

import torch

from .quant import EMITS, count_launch as _count, emit_result as \
    _emit_result, quantize_sym

# the JAX package's lane rule on a row's width H*D (the TPU's 128 lanes),
# kept in the routes so the port picks the JAX package's kernels; the
# Hopper kernels' own rule is any whole number of heads (every width in
# KERNEL_HEAD_DIMS is a multiple of 32): the wrappers check that one, and
# a tensor-parallel shard's route too (bge's 3 local heads at tp=4 are 192
# wide)
LANE = 128
KERNEL_LANE = 32
LOG2E = 1.4426950408889634
# query rows per block of the JAX kernel past 512 (shape rule), and the
# query/key block of the block-skipping kernel K5
BQ = 128
_CLAMP_LO = -100.0
# head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)
# (q and k, v) head widths of multi-head latent attention (DeepSeek-V2's
# MLA: 128 + 64 rotated, 128) the causal streaming mode is instantiated
# for
MLA_HEAD_DIMS = ((192, 128),)


def _clamp_hi(n_keys: int) -> float:
    """Upper score clamp: n_keys * 2^hi <= 2^127, so neither exp2 nor the
    f32 denominator can overflow at any row length."""
    return float(127 - math.ceil(math.log2(max(n_keys, 2))))


def supported(L: int, H: int, D: int, lane: int = LANE) -> bool:
    """Shapes the fused kernel takes (the JAX package's rule, restricted
    to the head dims the CUDA kernel is built for); ``lane``: the rule on
    H*D (``LANE``, or the kernels' own ``KERNEL_LANE``)."""
    return (D in KERNEL_HEAD_DIMS and L % 8 == 0 and (H * D) % lane == 0
            and (L <= 512 or L % BQ == 0))


def _scale(D: int) -> float:
    """log2(e)/sqrt(D), the factor folded into q (as the kernel's f32)."""
    return (1.0 / (D ** 0.5)) * LOG2E


def _split_heads(qkv, B, L, H, D, dv=None):
    """qkv [B*L, 3*H*D] -> q, k, v views [B, H, L, D]; with ``dv`` (MLA)
    qkv [B*L, H*(2D + dv)] -> q, k [B, H, L, D] and v [B, H, L, dv]."""
    if dv is not None:
        q, k, v = qkv.reshape(B, L, -1).split([H * D, H * D, H * dv], -1)
        return tuple(t.reshape(B, L, H, -1).transpose(1, 2)
                     for t in (q, k, v))
    x = qkv.reshape(B, L, 3, H, D).permute(2, 0, 3, 1, 4)  # 3,B,H,L,D
    return x[0], x[1], x[2]


def _merge_heads(o, p_sum, dt, B, L, H, D):
    """o [B, H, L, D] / max(p_sum, 1e-30) (the f32 reciprocal, as the
    kernels) -> context [B*L, H*D] in dt."""
    return _merge_f32(o, p_sum, B, L, H, D).to(dt)


def _prefix_probs(s, lengths, k0, hi, dt, causal=False):
    """Clamped scores s [B, H, L, Lk] of keys k0 .. k0+Lk-1 -> exp2,
    keys j >= lengths[b] (and, with ``causal``, keys j > i for query row
    i) set to exactly 0, rounded to the compute dtype (f32 holding dt
    values)."""
    s = s.clamp(_CLAMP_LO, hi)
    kpos = k0 + torch.arange(s.shape[-1], device=s.device)
    ok = (kpos[None, :] < lengths.to(s.device)[:, None])[:, None, None, :]
    if causal:
        qpos = torch.arange(s.shape[-2], device=s.device)
        ok = ok & (kpos[None, :] <= qpos[:, None])             # [L, Lk]
    return torch.where(ok, torch.exp2(s),
                       torch.zeros((), device=s.device)).to(dt).float()


# the most heads an emitting launch takes (emit_supported)
EMIT_MAX_HEADS = 16
LOG2_127 = 6.9886846867721655

# int8 attention scores: "auto" follows the int8 compute mode, "on" /
# "off" force it. The JAX package's switch and default ("off"); encode
# reads it once per forward (``use_int8_scores``).
_INT8_SCORES = "off"


def set_int8_scores_mode(mode: str) -> None:
    global _INT8_SCORES
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"int8 scores mode must be auto, on or off, got "
                         f"{mode!r}")
    _INT8_SCORES = mode


@contextlib.contextmanager
def int8_scores_mode(mode: str):
    """Scoped override of the int8-scores mode."""
    global _INT8_SCORES
    prev = _INT8_SCORES
    set_int8_scores_mode(mode)
    try:
        yield
    finally:
        _INT8_SCORES = prev


def use_int8_scores(int8: bool) -> bool:
    """Does K2 run its int8-scores branch? "auto" follows ``int8`` (the
    forward's int8 compute mode, ``EngineConfig.int8_compute``)."""
    if _INT8_SCORES != "auto":
        return _INT8_SCORES == "on"
    return bool(int8)


def emit_supported(H: int) -> bool:
    """Can the attention kernels emit at H heads? The port's rule, H <=
    16: the shapes the emitting paths take (bge's 12 heads, the tests'
    16). The kernels (K2e, K4e, K2i8) run every head of a query tile in
    one block and need no cap of their own; the rule keeps every emitting
    path, and the plain versions, on the same shapes."""
    return H <= EMIT_MAX_HEADS


def _emit_int8_rows(ctx: torch.Tensor):
    """The TPU's ``_emit_int8_rows``: per-row symmetric int8 of a full
    [M, E] context, so = max(max|row|, 1e-30) * (1/127), o8 = round(ctx *
    (1/so)). Returns (o8 int8 [M, E], so f32 [M, 1])."""
    return quantize_sym(ctx, -1, 1e-30)


def _emit_ctx(ctx: torch.Tensor, dt, emit: str):
    """The context (f32 values) as the kernels return it: ``dt`` alone,
    or with its emission ("both": of the dt-rounded context, as the TPU
    quantizes its output block; "only": of the f32 context, its staging
    scratch)."""
    if emit == "no":
        return ctx.to(dt)
    if emit == "only":
        return _emit_int8_rows(ctx.float())
    out = ctx.to(dt)
    return (out, *_emit_int8_rows(out.float()))


def _merge_f32(o, p_sum, B, L, H, D):
    """o [B, H, L, D] / max(p_sum, 1e-30) -> f32 context [B*L, H*D]
    (``_merge_heads`` before its cast)."""
    denom = p_sum.clamp_min(1e-30)
    return (o * (1.0 / denom)).permute(0, 2, 1, 3).reshape(B * L, H * D)


def _int8_scores_ctx(qkv, lengths, B, L, H, D):
    """The TPU's int8-scores branch of ``_attn_kernel`` (f32 context):
    q, k per row and v per column (all L rows, pads included) symmetric
    int8 with the floor 1e-30; s = (s32 * (sq * s2)) * sk, masked keys
    -1e30; p8 = round(exp2(s - m + log2 127)), m the row max; out = (acc *
    sv) * (127 / max(127 * sum p8, 1)). Integer products exact (f64)."""
    q, k, v = (t.float() for t in _split_heads(qkv, B, L, H, D))
    (q8, sq), (k8, sk), (v8, sv) = (quantize_sym(q, -1, 1e-30),
                                    quantize_sym(k, -1, 1e-30),
                                    quantize_sym(v, -2, 1e-30))
    s32 = (q8.double() @ k8.double().transpose(-1, -2)).float()
    s = (s32 * (sq * _scale(D))) * sk.transpose(-1, -2)
    kpos = torch.arange(L, device=qkv.device)
    ok = (kpos[None, :] < lengths.to(qkv.device)[:, None])[:, None, None, :]
    s = torch.where(ok, s, torch.full((), -1e30, device=qkv.device))
    m = s.amax(-1, keepdim=True)
    p8 = torch.round(torch.exp2((s - m) + LOG2_127))
    acc = (p8.double() @ v8.double()).float()
    den = (p8.double().sum(-1, keepdim=True) * 127).float().clamp_min(1.0)
    o = (acc * sv) * (127.0 / den)
    return o.permute(0, 2, 1, 3).reshape(B * L, H * D)


def fused_attention_ref(qkv: torch.Tensor, lengths: torch.Tensor, *,
                        B: int, L: int, H: int, D: int,
                        emit_quantized: str = "no",
                        int8_scores: bool = False):
    """The plain PyTorch version of K2, K2e and K2i8 (same arguments as
    ``fused_attention``)."""
    dt = qkv.dtype
    if int8_scores:
        return _emit_ctx(_int8_scores_ctx(qkv, lengths, B, L, H, D), dt,
                         emit_quantized)
    q, k, v = _split_heads(qkv, B, L, H, D)
    qs = (q.float() * _scale(D)).to(dt)
    s = qs.float() @ k.float().transpose(-1, -2)           # [B,H,L,L] f32
    p = _prefix_probs(s, lengths, 0, _clamp_hi(L), dt)
    return _emit_ctx(_merge_f32(p @ v.float(), p.sum(-1, keepdim=True),
                                B, L, H, D), dt, emit_quantized)


def fused_attention(qkv: torch.Tensor, lengths: torch.Tensor, *, B: int,
                    L: int, H: int, D: int, emit_quantized: str = "no",
                    int8_scores: bool = False):
    """qkv [B*L, 3*H*D] (columns [q | k | v], heads contiguous), lengths
    [B] int32 -> context [B*L, H*D] in qkv's dtype. Keys at positions
    >= lengths[b] get probability exactly 0; a row with length 0 gives 0.

    emit_quantized: "no" | "both" | "only" (K2e, where ``emit_supported``)
    — also, or instead, return the context per-row quantized: ``(ctx, o8,
    so)`` or ``(o8, so)``, o8 int8 [B*L, H*D], so f32 [B*L, 1].
    int8_scores: both products in int8 (K2i8; see ``_int8_scores_ctx``).

    A CUDA tensor launches K2 (bf16 qkv, int32 lengths on the same
    device) on ``csrc/attention_sm90.cu``: mode 0 (with emission, K2e:
    every head of a query tile in one block, the last sequence first) or,
    with int8 scores, K2i8 (``attn90_i8_kernel``, every head of a query
    tile in one block with or without emission); counted by route in
    ``routes``, in ``launches``, and apart in ``both_launches`` /
    ``only_launches`` (emission) and ``i8s_launches`` (int8 scores). A CPU
    tensor runs ``fused_attention_ref``."""
    _check_prefix("fused_attention", supported(L, H, D, KERNEL_LANE), qkv,
                  lengths, B, L, H, D)
    _check_emit(emit_quantized, H)
    kw = dict(B=B, L=L, H=H, D=D, emit_quantized=emit_quantized,
              int8_scores=int8_scores)
    if qkv.device.type == "cpu":
        return fused_attention_ref(qkv, lengths, **kw)
    _check_cuda(qkv, lengths)
    out, o8, os = _outputs(qkv, B * L, H * D, emit_quantized)
    if B:
        route = _launch("fused_attention", MODE_PREFIX, qkv, out, B, L, H, D,
                        _clamp_hi(L), lengths=lengths, o8=o8, os=os,
                        emit=emit_quantized, i8s=int8_scores)
        _count(fused_attention, emit_quantized)
        fused_attention.routes[route] += 1
        if int8_scores:
            fused_attention.i8s_launches += 1
    return _emit_result(out, o8, os, emit_quantized)


def _check_emit(emit: str, H: int) -> None:
    if emit not in EMITS:
        raise ValueError(f"emit_quantized must be one of {EMITS}, got "
                         f"{emit!r}")
    if emit != "no" and not emit_supported(H):
        raise ValueError(f"attention emission takes at most "
                         f"{EMIT_MAX_HEADS} heads, got {H}")


def _outputs(qkv, M, E, emit):
    """A CUDA call's outputs: the context (none with "only"), and with
    emission o8 int8 [M, E] and os f32 [M, 1]."""
    dev = qkv.device
    out = (None if emit == "only" else
           torch.empty((M, E), dtype=qkv.dtype, device=dev))
    if emit == "no":
        return out, None, None
    return (out, torch.empty((M, E), dtype=torch.int8, device=dev),
            torch.empty((M, 1), dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# K7: prefix-masked attention with an additive logit bias
# ---------------------------------------------------------------------------

def _query_block_bias(L: int) -> int:
    """The JAX bias kernel's query rows per grid step (kept for
    ``bias_supported``'s rule)."""
    return L if L <= 256 else BQ


def bias_supported(L: int, H: int, D: int, lane: int = LANE) -> bool:
    """``supported`` + the JAX package's cap on its bias tile: [H, Lq, L]
    f32 at most 8 MB. The cap is the TPU's VMEM budget, kept so the port
    routes as the JAX package does (L <= 1280 at H=12); the CUDA kernel
    streams the bias through shared memory in 128 x 128 tiles and has no
    such limit."""
    return (supported(L, H, D, lane)
            and H * _query_block_bias(L) * L * 4 <= 8 * 1024 * 1024)


def prepare_attention_bias(bias: torch.Tensor, L: int) -> torch.Tensor:
    """[1, H, L, L] additive logit bias -> K7's operand: [H, L, L] f32,
    contiguous, pre-scaled by log2(e) (the kernel's exponent is base-2).
    Batch-independent, so a forward computes it once for all its layers.
    (The TPU kernel takes a block-major [nQ, H, Lq, L] layout for its
    grid; a CUDA block reads its query rows of [H, L, L] in place.)"""
    if bias.dim() != 4 or bias.shape[0] != 1 \
            or tuple(bias.shape[2:]) != (L, L):
        raise ValueError(f"bias must be [1, H, {L}, {L}], got "
                         f"{tuple(bias.shape)}")
    return (bias[0].float() * LOG2E).contiguous()


def fused_attention_bias_ref(qkv: torch.Tensor, lengths: torch.Tensor,
                             bias: torch.Tensor, *, B: int, L: int, H: int,
                             D: int) -> torch.Tensor:
    """The plain PyTorch version of K7 (same arguments as
    ``fused_attention_bias``): s = (q.k) * s2 + bias in f32 (q not
    pre-rounded), clamped after the bias add."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, B, L, H, D)
    s = (q.float() @ k.float().transpose(-1, -2)) * _scale(D)
    s = s + bias.to(qkv.device)[None]
    p = _prefix_probs(s, lengths, 0, _clamp_hi(L), dt)
    return _merge_heads(p @ v.float(), p.sum(-1, keepdim=True), dt,
                        B, L, H, D)


def fused_attention_bias(qkv: torch.Tensor, lengths: torch.Tensor,
                         bias: torch.Tensor, *, B: int, L: int, H: int,
                         D: int) -> torch.Tensor:
    """``fused_attention`` + an additive attention-logit bias (MPNet's
    relative-position table, jina-bert-v2's ALiBi on short rows). bias:
    [H, L, L] f32 from ``prepare_attention_bias`` (log2-scaled,
    batch-independent). A CUDA tensor launches K7
    (``csrc/attention_sm90.cu``, mode 3: the bias by TMA beside the K/V
    tiles; a bias larger than half of L2 runs the blocks of one (query
    block, head) together over the batch; counted in ``launches`` and by
    kernel in ``routes``); a CPU
    tensor runs ``fused_attention_bias_ref``."""
    _check_prefix("fused_attention_bias",
                  bias_supported(L, H, D, KERNEL_LANE), qkv, lengths, B, L,
                  H, D)
    if tuple(bias.shape) != (H, L, L) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be f32 [H, L, L]={(H, L, L)}, got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if qkv.device.type == "cpu":
        return fused_attention_bias_ref(qkv, lengths, bias, B=B, L=L, H=H,
                                        D=D)
    _check_cuda(qkv, lengths)
    if not bias.is_contiguous() or bias.data_ptr() % 16:
        raise ValueError("bias must be contiguous (16-byte aligned)")
    out = torch.empty((B * L, H * D), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return out
    route = _launch("fused_attention_bias", MODE_BIAS, qkv, out, B, L, H,
                    D, _clamp_hi(L), lengths=lengths, bias=bias)
    fused_attention_bias.launches += 1
    fused_attention_bias.routes[route] += 1
    return out


# ---------------------------------------------------------------------------
# K6: prefix-masked attention streamed over key blocks (plain and ALiBi)
# ---------------------------------------------------------------------------

def stream_supported(L: int, H: int, D: int, BK: int = 512,
                     lane: int = LANE, dv: int | None = None) -> bool:
    """Shapes the streaming kernel carries (the JAX package's rule:
    128-row query blocks, key blocks of BK, lane-tiled E; restricted to
    the head dims the CUDA kernel is built for). With ``dv`` (MLA, value
    heads of another width than D) the (D, dv) pairs of
    ``MLA_HEAD_DIMS``."""
    if dv is not None and dv != D:
        return ((D, dv) in MLA_HEAD_DIMS and L % BQ == 0 and L % BK == 0)
    return (D in KERNEL_HEAD_DIMS and (H * D) % lane == 0
            and L % BQ == 0 and L % BK == 0)


def pick_bk(L: int) -> int:
    """The JAX package's key-block size: the largest of 512, 256, 128
    dividing L."""
    for bk in (512, 256, 128):
        if L % bk == 0:
            return bk
    return BQ


def whole_row_fits(L: int, E: int) -> bool:
    """The JAX package's rule for when whole-row bf16 K/V fits the TPU's
    VMEM (double-buffered k and v plus 4 MB of tiles within 15 MB; past it,
    L > 1877 at E=768, dispatch streams key blocks). It is the TPU's
    budget, kept only so the port picks the same route and numerics as
    the JAX package: the CUDA kernels stream key tiles at every
    length."""
    return 4 * L * E * 2 + 4 * 1024 * 1024 <= 15 * 1024 * 1024


def fused_attention_stream_ref(qkv: torch.Tensor, lengths: torch.Tensor,
                               *, B: int, L: int, H: int, D: int,
                               BK: int = 512, alibi_slopes=None,
                               causal: bool = False, dv: int | None = None,
                               scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of K6, K6c and K6ca (same arguments as
    ``fused_attention_stream``). It walks every key block of BK as the TPU
    grid does (the causal walk too), so its scores take O(L * BK) memory,
    not O(L^2): s = (q.k) * s2 in f32, minus slope_h * (|i-j| * log2(e))
    with ALiBi, clamped with the bound sized to all L keys; with
    ``causal`` keys j > i add exact zeros; block sums add up with no
    rescaling."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, B, L, H, D, dv)
    Dv = v.shape[-1]
    s2 = _scale(D) if scale is None else _s2(scale)
    dev = qkv.device
    hi = _clamp_hi(L)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev)[None, :, None, None]
    qf = q.float()
    pos = torch.arange(L, device=dev)
    o = torch.zeros(B, H, L, Dv, device=dev)
    den = torch.zeros(B, H, L, 1, device=dev)
    for k0 in range(0, L, BK):
        ks = slice(k0, k0 + BK)
        s = (qf @ k[:, :, ks].float().transpose(-1, -2)) * s2
        if slopes is not None:
            dist = (pos[:, None] - pos[None, ks]).abs().float() * LOG2E
            s = s - slopes * dist
        p = _prefix_probs(s, lengths, k0, hi, dt, causal)
        o += p @ v[:, :, ks].float()
        den += p.sum(-1, keepdim=True)
    return _merge_heads(o, den, dt, B, L, H, Dv)


def _s2(scale: float) -> float:
    """A softmax scale as the kernels' log2-domain factor (f32)."""
    return float(torch.tensor(scale * LOG2E, dtype=torch.float32))


def fused_attention_stream(qkv: torch.Tensor, lengths: torch.Tensor, *,
                           B: int, L: int, H: int, D: int, BK: int = 512,
                           alibi_slopes=None, causal: bool = False,
                           dv: int | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """Prefix-masked attention for long rows, as ``fused_attention`` but
    with the scores scaled after the dot (q not pre-rounded) and the
    clamp sized to L keys; ``alibi_slopes`` ([H] f32 tensor or floats)
    adds jina-bert-v2's -slope_h * |i-j| from positions inside the
    kernel, so no O(L^2) bias array exists; ``causal`` also drops keys
    j > i (the decoder embedders; the clamp stays sized to L keys). BK
    is the JAX kernel's key block (``pick_bk``): it fixes the shapes
    taken and the plain version's walk. A CUDA tensor launches K6
    (``csrc/attention_sm90.cu``, stream or ALiBi mode; counted by route in
    ``routes``) or, with ``causal``,
    K6c (causal mode), counted apart in ``causal_launches``, or with
    ``causal`` and ``alibi_slopes`` together K6ca (causal ALiBi mode),
    counted in ``causal_alibi_launches``; a CPU tensor runs
    ``fused_attention_stream_ref``.

    Multi-head latent attention (DeepSeek-V2's MLA): ``dv`` value heads of
    another width than the D of q and k, qkv [B*L, H*(2D + dv)] holding
    q | k | v (q at h*D, k at H*D + h*D, v at 2H*D + h*dv) and the context
    [B*L, H*dv]; ``scale`` the softmax scale (default 1/sqrt(D)). Only
    the causal mode takes it (K6c at the (D, dv) of ``MLA_HEAD_DIMS``),
    counted in ``causal_launches`` and in ``mla_launches``."""
    if dv is not None and dv != D:
        return _stream_mla(qkv, lengths, B, L, H, D, dv, BK, alibi_slopes,
                           causal, scale)
    if scale is not None:
        raise ValueError("a softmax scale other than 1/sqrt(D) is MLA's")
    _check_prefix(f"fused_attention_stream (BK={BK})",
                  stream_supported(L, H, D, BK, KERNEL_LANE), qkv, lengths,
                  B, L, H, D)
    if alibi_slopes is not None and len(alibi_slopes) != H:
        raise ValueError(f"{len(alibi_slopes)} ALiBi slopes for {H} heads")
    if qkv.device.type == "cpu":
        return fused_attention_stream_ref(qkv, lengths, B=B, L=L, H=H, D=D,
                                          BK=BK, alibi_slopes=alibi_slopes,
                                          causal=causal)
    _check_cuda(qkv, lengths)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=qkv.device).contiguous()
    out = torch.empty((B * L, H * D), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return out
    if causal:
        mode = MODE_CAUSAL if slopes is None else MODE_CAUSAL_ALIBI
    else:
        mode = MODE_STREAM if slopes is None else MODE_ALIBI
    route = _launch("fused_attention_stream", mode, qkv, out, B, L, H, D,
                    _clamp_hi(L), lengths=lengths, slopes=slopes)
    fused_attention_stream.routes[route] += 1
    if causal and slopes is not None:
        fused_attention_stream.causal_alibi_launches += 1
    elif causal:
        fused_attention_stream.causal_launches += 1
    else:
        fused_attention_stream.launches += 1
    return out


def _stream_mla(qkv, lengths, B, L, H, D, dv, BK, alibi_slopes, causal,
                scale) -> torch.Tensor:
    """``fused_attention_stream`` with value heads dv wide (MLA)."""
    if not causal or alibi_slopes is not None:
        raise ValueError("MLA's value width takes the causal mode alone")
    if tuple(qkv.shape) != (B * L, H * (2 * D + dv)):
        raise ValueError(f"qkv {tuple(qkv.shape)} != "
                         f"{(B * L, H * (2 * D + dv))}")
    if not stream_supported(L, H, D, BK, KERNEL_LANE, dv):
        raise ValueError(f"fused_attention_stream (BK={BK}) does not take "
                         f"L={L} H={H} D={D} dv={dv}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B]={B}, got "
                         f"{tuple(lengths.shape)}")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    if qkv.device.type == "cpu":
        return fused_attention_stream_ref(qkv, lengths, B=B, L=L, H=H, D=D,
                                          BK=BK, causal=True, dv=dv,
                                          scale=scale)
    _check_cuda(qkv, lengths)
    out = torch.empty((B * L, H * dv), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return out
    route = _launch("fused_attention_stream", MODE_CAUSAL, qkv, out, B, L,
                    H, D, _clamp_hi(L), lengths=lengths, dv=dv,
                    s2=_s2(scale))
    fused_attention_stream.routes[route] += 1
    fused_attention_stream.causal_launches += 1
    fused_attention_stream.mla_launches += 1
    return out


# ---------------------------------------------------------------------------
# K6w: banded (sliding-window) attention, K6's span + window mode
# ---------------------------------------------------------------------------

def window_span(window: int) -> int:
    """128-key blocks the JAX grid walks on each side of a query block:
    ceil((window // 2) / 128)."""
    return -(-(window // 2) // BQ)


def band_half(window: int, L: int) -> int:
    """K6w's W, the band's half width the kernel takes: window // 2,
    capped at L (|i - j| < L in a row of L, so the band is the same)."""
    return min(window // 2, L)


def band_tiles(q0: int, rows: int, W: int, length: int) -> tuple[int, int]:
    """The 128-key tiles K6w walks for query rows q0 .. q0 + rows - 1 of a
    sequence of ``length`` keys, as the kernel computes them
    (``band_tiles`` in ``csrc/attention_sm90.cu``): (first tile, count),
    the tiles that hold a key of q0 - W .. q0 + rows - 1 + W below
    ``length``; count 0 where none does. A 128-row query block walks its
    range (rows=128); each of its two consumer warpgroups (rows=64) the
    part its own rows need."""
    lo, hi = max(0, q0 - W), min(length, q0 + rows + W)
    if lo >= hi:
        return lo // BQ, 0
    return lo // BQ, (hi - 1) // BQ - lo // BQ + 1


def fused_attention_window_ref(qkv: torch.Tensor, lengths: torch.Tensor, *,
                               B: int, L: int, H: int, D: int,
                               window: int) -> torch.Tensor:
    """The plain PyTorch version of K6w (same arguments as
    ``fused_attention_window``). It walks the JAX grid: each 128-row query
    block visits its 2*span+1 key blocks of 128 (steps past either end
    clamp to a valid block and mask to zero), all query blocks of a step
    at once, so no [B, H, L, L] array exists. When the band covers every
    key block the JAX package walks them all and keeps the |i-j| mask,
    and drops that mask when window // 2 >= L - 1 (the same sum).
    s = (q.k) * s2 in f32, clamp sized to all L keys."""
    dt, dev = qkv.dtype, qkv.device
    nQ = L // BQ
    span = window_span(window)
    W = min(2 * span + 1, nQ)
    banded = W < nQ
    half = window // 2
    use_mask = banded or half < L - 1
    q, k, v = _split_heads(qkv, B, L, H, D)
    qb = q.float().reshape(B, H, nQ, BQ, D)
    kb, vb = k.reshape(B, H, nQ, BQ, D), v.reshape(B, H, nQ, BQ, D)
    hi = _clamp_hi(L)
    lens = lengths.to(dev)[:, None, None, None, None]
    iq = torch.arange(nQ, device=dev)
    r = torch.arange(BQ, device=dev)
    qpos = (iq[:, None] * BQ + r)[:, :, None]               # [nQ, BQ, 1]
    o = torch.zeros(B, H, nQ, BQ, D, device=dev)
    den = torch.zeros(B, H, nQ, BQ, 1, device=dev)
    for step in range(W):
        raw = iq - span + step if banded else torch.full_like(iq, step)
        blk = raw.clamp(0, nQ - 1)                            # [nQ]
        kpos = (blk[:, None] * BQ + r)[:, None, :]            # [nQ, 1, BQ]
        ok = (kpos < lens) & ((raw >= 0) & (raw < nQ))[:, None, None]
        if use_mask:
            ok = ok & ((qpos - kpos).abs() <= half)
        kk, vv = kb[:, :, blk].float(), vb[:, :, blk].float()
        s = (qb @ kk.transpose(-1, -2)) * _scale(D)
        p = torch.where(ok, torch.exp2(s.clamp(_CLAMP_LO, hi)),
                        torch.zeros((), device=dev)).to(dt).float()
        o += p @ vv
        den += p.sum(-1, keepdim=True)
    return _merge_heads(o.reshape(B, H, L, D), den.reshape(B, H, L, 1), dt,
                        B, L, H, D)


def fused_attention_window(qkv: torch.Tensor, lengths: torch.Tensor, *,
                           B: int, L: int, H: int, D: int,
                           window: int) -> torch.Tensor:
    """Banded (sliding-window) prefix-masked attention, ModernBERT's local
    layers: query i attends key j iff j < lengths[b] and |i - j| <=
    window // 2; scores scaled after the dot, clamp sized to L keys (as
    ``fused_attention_stream``). Work is O(L * window), not O(L^2). Takes
    the shapes of the JAX package's ``fused_attention_window``
    (``stream_supported(L, H, D, 128)``). A CUDA tensor launches K6w
    (``csrc/attention_sm90.cu``, mode 6: each 128-row query block walks
    the key tiles ``band_tiles`` gives, W = ``band_half(window, L)``),
    counted in ``launches`` and by route in ``routes``; a CPU tensor runs
    ``fused_attention_window_ref``."""
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    _check_prefix("fused_attention_window",
                  stream_supported(L, H, D, BQ, KERNEL_LANE), qkv, lengths,
                  B, L, H, D)
    if qkv.device.type == "cpu":
        return fused_attention_window_ref(qkv, lengths, B=B, L=L, H=H, D=D,
                                          window=window)
    _check_cuda(qkv, lengths)
    out = torch.empty((B * L, H * D), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return out
    route = _launch("fused_attention_window", MODE_BAND, qkv, out, B, L, H,
                    D, _clamp_hi(L), lengths=lengths, W=band_half(window, L))
    fused_attention_window.launches += 1
    fused_attention_window.routes[route] += 1
    return out


# ---------------------------------------------------------------------------
# K8a, K8b: context parallelism's local queries against the gathered K/V
# ---------------------------------------------------------------------------

def _cp_heads(q, kv, B, Lc, L, H, D):
    """q [B*Lc, H*D] and kv [B*L, 2*H*D] (k | v) -> q [B, H, Lc, D], k
    and v [B, H, L, D] views."""
    kvh = kv.reshape(B, L, 2, H, D).permute(2, 0, 3, 1, 4)
    return q.reshape(B, Lc, H, D).transpose(1, 2), kvh[0], kvh[1]


def fused_attention_cp_ref(q: torch.Tensor, kv: torch.Tensor,
                           lengths: torch.Tensor, *, B: int, Lc: int, L: int,
                           H: int, D: int) -> torch.Tensor:
    """The plain PyTorch version of K8a (same arguments as
    ``fused_attention_cp``): the whole [Lc, L] score row of each head in
    one f32 product, as the TPU's ``_attn_kernel_cp`` does: s = (q.k) * s2,
    clamped with the bound sized to the L gathered keys."""
    dt = q.dtype
    qh, k, v = _cp_heads(q, kv, B, Lc, L, H, D)
    s = (qh.float() @ k.float().transpose(-1, -2)) * _scale(D)
    p = _prefix_probs(s, lengths, 0, _clamp_hi(L), dt)
    return _merge_heads(p @ v.float(), p.sum(-1, keepdim=True), dt, B, Lc,
                        H, D)


def fused_attention_cp_stream_ref(q: torch.Tensor, kv: torch.Tensor,
                                  lengths: torch.Tensor, *, B: int, Lc: int,
                                  L: int, H: int, D: int,
                                  BK: int = 512) -> torch.Tensor:
    """The plain PyTorch version of K8b (same arguments as
    ``fused_attention_cp_stream``): K8a's sums taken over the gathered
    keys in blocks of BK, as the TPU grid walks them (and as
    ``fused_attention_stream_ref`` does), with no rescaling."""
    dt = q.dtype
    qh, k, v = _cp_heads(q, kv, B, Lc, L, H, D)
    qf, hi = qh.float(), _clamp_hi(L)
    o = torch.zeros(B, H, Lc, D, device=q.device)
    den = torch.zeros(B, H, Lc, 1, device=q.device)
    for k0 in range(0, L, BK):
        ks = slice(k0, k0 + BK)
        s = (qf @ k[:, :, ks].float().transpose(-1, -2)) * _scale(D)
        p = _prefix_probs(s, lengths, k0, hi, dt)
        o += p @ v[:, :, ks].float()
        den += p.sum(-1, keepdim=True)
    return _merge_heads(o, den, dt, B, Lc, H, D)


def fused_attention_cp(q: torch.Tensor, kv: torch.Tensor,
                       lengths: torch.Tensor, *, B: int, Lc: int, L: int,
                       H: int, D: int) -> torch.Tensor:
    """Context-parallel attention: q [B*Lc, H*D], this shard's Lc local
    query rows of each sequence (a column slice of the local fused
    projection is taken in place: any row stride, unit column stride), kv
    [B*L, 2*H*D] the all-gathered [k | v] of the whole row, lengths [B]
    int32 prefix lengths of the gathered row -> context [B*Lc, H*D] in q's
    dtype. Scores scaled after the dot, clamp sized to the L gathered keys
    (the TPU's ``_attn_kernel_cp``). Takes ``supported(L, H, D)`` and Lc %
    8 == 0. A CUDA tensor launches K8a (``csrc/attention_sm90.cu``, mode 4
    in its CP operand layout), counted in ``launches`` and by kernel in
    ``routes``; a CPU tensor runs ``fused_attention_cp_ref``."""
    _check_cp("fused_attention_cp", supported(L, H, D) and Lc % 8 == 0, q,
              kv, lengths, B, Lc, L, H, D)
    if q.device.type == "cpu":
        return fused_attention_cp_ref(q, kv, lengths, B=B, Lc=Lc, L=L, H=H,
                                      D=D)
    return _launch_cp(fused_attention_cp, q, kv, lengths, B, Lc, L, H, D)


def fused_attention_cp_stream(q: torch.Tensor, kv: torch.Tensor,
                              lengths: torch.Tensor, *, B: int, Lc: int,
                              L: int, H: int, D: int,
                              BK: int = 512) -> torch.Tensor:
    """``fused_attention_cp`` past the whole-row rule: the same contract,
    with the gathered K/V taken in key blocks of BK (the TPU's
    ``_attn_kernel_cp_stream``; BK fixes the shapes taken, as in
    ``fused_attention_stream``). Takes ``stream_supported(L, H, D, BK)``
    and Lc % 128 == 0. A CUDA tensor launches K8b (the same CUDA path as
    K8a: the kernel streams 128-key tiles at every length), counted in
    ``launches`` and by kernel in ``routes``; a CPU tensor runs
    ``fused_attention_cp_stream_ref``."""
    _check_cp(f"fused_attention_cp_stream (BK={BK})",
              stream_supported(L, H, D, BK) and Lc % BQ == 0, q, kv,
              lengths, B, Lc, L, H, D)
    if q.device.type == "cpu":
        return fused_attention_cp_stream_ref(q, kv, lengths, B=B, Lc=Lc, L=L,
                                             H=H, D=D, BK=BK)
    return _launch_cp(fused_attention_cp_stream, q, kv, lengths, B, Lc, L,
                      H, D)


def _check_cp(what, takes, q, kv, lengths, B, Lc, L, H, D) -> None:
    """The CP wrappers' operand shapes: q [B*Lc, E], kv [B*L, 2E], lengths
    [B]; ``takes``: the kernel's shape rule."""
    E = H * D
    if tuple(q.shape) != (B * Lc, E):
        raise ValueError(f"q {tuple(q.shape)} != {(B * Lc, E)}")
    if tuple(kv.shape) != (B * L, 2 * E):
        raise ValueError(f"kv {tuple(kv.shape)} != {(B * L, 2 * E)}")
    if not takes:
        raise ValueError(f"{what} does not take Lc={Lc} L={L} H={H} D={D}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B]={B}, got "
                         f"{tuple(lengths.shape)}")


def _launch_cp(wrapper, q, kv, lengths, B, Lc, L, H, D) -> torch.Tensor:
    """K8a / K8b on the card: bf16 q (unit column stride, row stride a
    multiple of 8, 16-byte aligned) and kv (contiguous), int32 lengths,
    all on one device; counted on ``wrapper``."""
    _check_cuda(kv, lengths)
    if q.dtype != kv.dtype:
        raise TypeError("q and kv must both be bf16")
    if q.stride(1) != 1 or q.stride(0) % 8 or q.data_ptr() % 16:
        raise ValueError("q needs unit column stride, a row stride that is "
                         "a multiple of 8 and 16-byte alignment")
    out = torch.empty((B * Lc, H * D), dtype=q.dtype, device=q.device)
    if B and Lc:
        route = _launch(wrapper.__name__, MODE_STREAM, kv, out, B, L, H, D,
                        _clamp_hi(L), lengths=lengths, cp=(q, Lc))
        wrapper.launches += 1
        wrapper.routes[route] += 1
    return out


# mask modes of csrc/attention_sm90.cu (0-8; 0 and 1 also with emission, 0
# also with int8 scores, 4 also in the CP layout)
MODE_PREFIX, MODE_SEGMENT, MODE_WINDOW = 0, 1, 2
MODE_BIAS, MODE_STREAM, MODE_ALIBI, MODE_BAND, MODE_CAUSAL = 3, 4, 5, 6, 7
MODE_CAUSAL_ALIBI = 8
# the modes the Hopper library emits in (K2e, K4e; K2i8 with int8 scores)
SM90_EMIT_MODES = (MODE_PREFIX, MODE_SEGMENT)


def attention_kernel(mode: int, D: int, emit: str = "no", cp: bool = False,
                     i8s: bool = False, dv: int | None = None) -> str:
    """The hand-written kernel an attention launch takes: "sm90"
    (``csrc/attention_sm90.cu``: wgmma, a TMA ring) for every mode:
    modes 0-8 (K2, K4, K5, K7, K6 plain and ALiBi, K6w, K6c, K6ca), modes
    0 and 1 with emission (K2e, K4e), mode 0 with int8 scores under every
    emission (K2i8, its own kernel in that library), mode 4 in the CP
    operand layout (K8a, K8b) and mode 7 with MLA's value width ``dv``.
    Raises on what no kernel takes. No fallback: a failed build or a
    refused launch raises."""
    if mode not in range(9):
        raise ValueError(f"no attention mode {mode}")
    if dv is not None and dv != D:
        if (D, dv) not in MLA_HEAD_DIMS or mode != MODE_CAUSAL \
                or emit != "no" or cp or i8s:
            raise ValueError(f"MLA's widths (D={D}, dv={dv}) take mode "
                             f"{MODE_CAUSAL} alone, at {MLA_HEAD_DIMS}")
        return "sm90"
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the attention kernels take D in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if emit not in EMITS:
        raise ValueError(f"emit must be one of {EMITS}, got {emit!r}")
    if cp and (mode != MODE_STREAM or emit != "no" or i8s):
        raise ValueError("the CP layout is mode 4's, without emission or "
                         "int8 scores")
    if i8s and mode != MODE_PREFIX:
        raise ValueError("int8 scores are mode 0's (K2i8)")
    if emit != "no" and mode not in SM90_EMIT_MODES:
        raise ValueError(f"mode {mode} does not emit")
    return "sm90"


def sm90_warpgroups(L: int) -> int:
    """Consumer warpgroups of a Hopper-kernel block (64 query rows each):
    one where a row fits in 64 queries (K2's and K7's short rows), else
    two (the kernel's host code makes the same choice)."""
    return 1 if L <= 64 else 2


def emit_scratch_shape(B: int, L: int, H: int, D: int, emit: str):
    """The f32 scratch an emitting Hopper launch needs: [B*L, H*D] for
    "only" (each block writes its rows' f32 context there head by head
    and reads it back to quantize it; the kernel leaves it undefined),
    none for "both" (it reads back its bf16 output) or "no"."""
    return (B * L, H * D) if emit == "only" else None


def _launch(what, mode, qkv, out, B, L, H, D, hi, *, lengths=None,
            seg=None, kbs=None, kbe=None, bias=None, slopes=None,
            W=0, o8=None, os=None, emit="no", i8s=False, cp=None, dv=None,
            s2=None) -> str:
    """One attention launch on the route ``attention_kernel`` picks;
    returns the route. The fused layout reads q, k and v as column slices
    of qkv [B*L, 3E]; with ``cp`` = (q, Lc) mode 4 reads the CP layout
    instead: q rows of q's stride and qkv as the gathered kv [B*L, 2E];
    with ``dv`` (MLA, mode 7) qkv [B*L, H*(2D + dv)] and the log2-domain
    scale ``s2``."""
    from ._cuda import check, on_device
    route = attention_kernel(mode, D, emit, cp is not None, i8s, dv)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _lib90()
    with on_device(what, qkv.device, lengths=lengths, seg=seg, kbs=kbs,
                   kbe=kbe, bias=bias, slopes=slopes, out=out, o8=o8, os=os,
                   q=None if cp is None else cp[0]):
        if dv is not None:
            status = lib.attn90_mla_launch(
                qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, L, H,
                D, dv, s2, hi, stream)
        elif cp is not None:
            q, Lc = cp
            status = lib.attn90_cp_launch(
                q.data_ptr(), qkv.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), B, Lc, L, H, D, q.stride(0), _scale(D), hi,
                stream)
        elif emit == "no" and not i8s:
            status = lib.attn90_launch(
                qkv.data_ptr(), *map(ptr, (lengths, seg, kbs, kbe, slopes,
                                           bias, out)),
                mode, B, L, H, D, W, _scale(D), hi, stream)
        else:
            # K2e / K4e / K2i8; the f32 scratch of "only" is freed after
            # the launch: the allocator reuses it only for work queued
            # behind it on this stream
            shape = emit_scratch_shape(B, L, H, D, emit)
            scratch = (None if shape is None else
                       torch.empty(shape, dtype=torch.float32,
                                   device=qkv.device))
            if i8s:
                status = lib.attn90_i8_launch(
                    qkv.data_ptr(), *map(ptr, (lengths, out, o8, os,
                                               scratch)),
                    EMITS.index(emit), B, L, H, D, _scale(D), stream)
            else:
                status = lib.attn90_emit_launch(
                    qkv.data_ptr(), *map(ptr, (lengths, seg, out, o8, os,
                                               scratch)),
                    mode, EMITS.index(emit), B, L, H, D, _scale(D), hi,
                    stream)
    check(status, lib.attn90_error_string, what)
    return route


def _check_prefix(what, takes, qkv, lengths, B, L, H, D) -> None:
    """The prefix-masked wrappers' operand shapes (K2, K6, K7): qkv
    [B*L, 3*H*D], lengths [B]; ``takes``: the kernel's shape rule."""
    E = H * D
    if tuple(qkv.shape) != (B * L, 3 * E):
        raise ValueError(f"qkv {tuple(qkv.shape)} != {(B * L, 3 * E)}")
    if not takes:
        raise ValueError(f"{what} does not take L={L} H={H} D={D}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B]={B}, got "
                         f"{tuple(lengths.shape)}")


def _check_segments(qkv, seg_ids, B, L, H, D) -> None:
    E = H * D
    if tuple(qkv.shape) != (B * L, 3 * E):
        raise ValueError(f"qkv {tuple(qkv.shape)} != {(B * L, 3 * E)}")
    if tuple(seg_ids.shape) != (B, L):
        raise ValueError(f"seg_ids must be [B, L]={(B, L)}, got "
                         f"{tuple(seg_ids.shape)}")
    if not supported(L, H, D, KERNEL_LANE):
        raise ValueError(f"segmented attention does not take L={L} H={H} "
                         f"D={D}")


def _check_cuda(qkv, *ints) -> None:
    """The CUDA wrappers' operand rules: bf16 qkv, int32 tables, all
    contiguous (qkv 16-byte aligned); the devices are checked at the
    launch (``_cuda.on_device``)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA attention takes bf16, got {qkv.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"index tables must be int32, got {t.dtype}")
    if not all(t.is_contiguous() for t in (qkv, *ints)) \
            or qkv.data_ptr() % 16:
        raise ValueError("qkv and the index tables must be contiguous "
                         "(qkv 16-byte aligned)")


def _segment_probs(q, k, seg_q, seg_k, s2, hi, dt):
    """Scores of one query block against one key block, scaled after the
    dot in f32, clamped, exp2, masked to same-segment non-pad keys, and
    rounded to the compute dtype. q [B,H,Lq,D], k [B,H,Lk,D], seg_q
    [B,Lq], seg_k [B,Lk] -> p [B,H,Lq,Lk] (f32 holding dt values)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * s2
    s = s.clamp(_CLAMP_LO, hi)
    ok = (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_k >= 0)[:, None, :]
    return torch.where(ok[:, None], torch.exp2(s),
                       torch.zeros((), device=q.device)).to(dt).float()


def fused_attention_segmented_ref(qkv: torch.Tensor, seg_ids: torch.Tensor,
                                  *, B: int, L: int, H: int, D: int,
                                  emit_quantized: str = "no"):
    """The plain PyTorch version of K4 and K4e (same arguments as
    ``fused_attention_segmented``)."""
    q, k, v = _split_heads(qkv, B, L, H, D)
    seg = seg_ids.to(qkv.device)
    p = _segment_probs(q, k, seg, seg, _scale(D), _clamp_hi(L), qkv.dtype)
    return _emit_ctx(_merge_f32(p @ v.float(), p.sum(-1, keepdim=True),
                                B, L, H, D), qkv.dtype, emit_quantized)


def fused_attention_segmented(qkv: torch.Tensor, seg_ids: torch.Tensor, *,
                              B: int, L: int, H: int, D: int,
                              emit_quantized: str = "no"):
    """Segment-masked attention for token-packed rows: qkv [B*L, 3*H*D] as
    in ``fused_attention``, seg_ids int32 [B, L] (-1 on pads). Query i
    attends key j iff seg[i] == seg[j] and seg[j] >= 0; a pad query row
    gives 0. ``emit_quantized`` as in ``fused_attention`` (K4e). A CUDA
    tensor launches K4 or, with emission, K4e (``csrc/attention_sm90.cu``,
    mode 1: a block runs every head of its query tile); counted as K2 is,
    and by route in ``routes``; a CPU tensor runs
    ``fused_attention_segmented_ref``."""
    _check_segments(qkv, seg_ids, B, L, H, D)
    _check_emit(emit_quantized, H)
    if qkv.device.type == "cpu":
        return fused_attention_segmented_ref(qkv, seg_ids, B=B, L=L, H=H,
                                             D=D,
                                             emit_quantized=emit_quantized)
    _check_cuda(qkv, seg_ids)
    out, o8, os = _outputs(qkv, B * L, H * D, emit_quantized)
    if B:
        route = _launch("fused_attention_segmented", MODE_SEGMENT, qkv, out,
                        B, L, H, D, _clamp_hi(L), seg=seg_ids, o8=o8, os=os,
                        emit=emit_quantized)
        _count(fused_attention_segmented, emit_quantized)
        fused_attention_segmented.routes[route] += 1
    return _emit_result(out, o8, os, emit_quantized)


def block_ranges(seg_ids: torch.Tensor, L: int):
    """[B, L] segment ids -> (kbs, kbe) int32 [B, L/BQ]: the first and last
    (inclusive) key block overlapping each query block's segment span.
    All-pad query blocks get (nK, -1), an empty range."""
    B = seg_ids.shape[0]
    nQ = L // BQ
    seg = seg_ids.to(torch.int64)
    segb = seg.reshape(B, nQ, BQ)
    valid = segb >= 0
    smin = torch.where(valid, segb, 1 << 30).amin(-1)         # [B, nQ]
    smax = torch.where(valid, segb, -1).amax(-1)
    s = seg[:, None, :]                                        # [B, 1, L]
    in_span = (s >= smin[..., None]) & (s <= smax[..., None]) & (s >= 0)
    pos = torch.arange(L, device=seg.device)[None, None, :]
    first = torch.where(in_span, pos, L).amin(-1)             # [B, nQ]
    last = torch.where(in_span, pos, -1).amax(-1)
    # floor division: an all-pad block's last = -1 gives kbe = -1
    return ((first // BQ).to(torch.int32).contiguous(),
            (last // BQ).to(torch.int32).contiguous())


def _window(L: int, window: int) -> int:
    """The key-block cap W: the window when 0 < window <= L/BQ, else the
    full row (the JAX package's rule)."""
    nK = L // BQ
    return window if 0 < window <= nK else nK


def fused_attention_segmented_blockskip_ref(
        qkv: torch.Tensor, seg_ids: torch.Tensor, *, B: int, L: int, H: int,
        D: int, window: int = 0) -> torch.Tensor:
    """The plain PyTorch version of K5 (same arguments as
    ``fused_attention_segmented_blockskip``): each 128-query block visits
    key blocks kbs .. min(kbs + W - 1, kbe) only; blocks past the cap W
    are dropped, not widened."""
    nK = L // BQ
    W = _window(L, window)
    hi = _clamp_hi(min(W * BQ, L))
    q, k, v = _split_heads(qkv, B, L, H, D)
    seg = seg_ids.to(qkv.device)
    kbs, kbe = block_ranges(seg, L)
    o = torch.zeros(B, H, L, D, device=qkv.device)
    den = torch.zeros(B, H, L, 1, device=qkv.device)
    for qb in range(nK):
        qs = slice(qb * BQ, (qb + 1) * BQ)
        for w in range(W):
            kb = torch.clamp(kbs[:, qb] + w, max=nK - 1)        # [B]
            live = (kbs[:, qb] + w <= kbe[:, qb])               # [B]
            idx = (kb[:, None] * BQ
                   + torch.arange(BQ, device=qkv.device)).long()  # [B, BQ]
            kk = torch.take_along_dim(k, idx[:, None, :, None], dim=2)
            vv = torch.take_along_dim(v, idx[:, None, :, None], dim=2)
            sk = torch.take_along_dim(seg, idx, dim=1)
            sk = torch.where(live[:, None], sk, -1)  # a step past kbe: no keys
            p = _segment_probs(q[:, :, qs], kk, seg[:, qs], sk, _scale(D),
                               hi, qkv.dtype)
            o[:, :, qs] += p @ vv.float()
            den[:, :, qs] += p.sum(-1, keepdim=True)
    return _merge_heads(o, den, qkv.dtype, B, L, H, D)


def fused_attention_segmented_blockskip(
        qkv: torch.Tensor, seg_ids: torch.Tensor, *, B: int, L: int, H: int,
        D: int, window: int = 0, ranges=None) -> torch.Tensor:
    """Block-skipping ``fused_attention_segmented`` for packed rows with
    L % 128 == 0: each 128-query block attends only key blocks kbs ..
    min(kbs + W - 1, kbe) (``block_ranges``), W = window when 0 < window
    <= L/128, else L/128; the score clamp is sized to min(W*128, L) keys.
    Attention cost is O(L * W*128) instead of O(L^2). ``ranges``: the
    (kbs, kbe) of ``block_ranges(seg_ids, L)`` when the caller already has
    them (a model computes them once for all its layers). A CUDA tensor
    launches K5 (``csrc/attention_sm90.cu``, mode 2: every head of a
    128-row query block in one block, its key tiles kbs .. only); counted
    in ``launches`` and by route in ``routes``; a CPU tensor runs
    ``fused_attention_segmented_blockskip_ref``."""
    _check_segments(qkv, seg_ids, B, L, H, D)
    if L % BQ:
        raise ValueError(f"the block-skipping kernel needs L % {BQ} == 0")
    if qkv.device.type == "cpu":
        return fused_attention_segmented_blockskip_ref(
            qkv, seg_ids, B=B, L=L, H=H, D=D, window=window)
    kbs, kbe = ranges if ranges is not None else block_ranges(seg_ids, L)
    _check_cuda(qkv, seg_ids, kbs, kbe)
    out = torch.empty((B * L, H * D), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return out
    W = _window(L, window)
    route = _launch("fused_attention_segmented_blockskip", MODE_WINDOW, qkv,
                    out, B, L, H, D, _clamp_hi(min(W * BQ, L)), seg=seg_ids,
                    kbs=kbs, kbe=kbe, W=W)
    fused_attention_segmented_blockskip.launches += 1
    fused_attention_segmented_blockskip.routes[route] += 1
    return out


# launch counters: every successful K2 / K4 / K5 / K6 / K6w / K7 / K8a /
# K8b launch adds one (K6c to fused_attention_stream.causal_launches, K6ca
# to its causal_alibi_launches); K2 and K4 also count their emitting
# launches (K2e / K4e) in both_launches and only_launches, K2 its
# int8-scores launches (K2i8) in i8s_launches; every wrapper's launches
# also count by kernel in ``routes`` ("sm90", attention_kernel); callers
# reset them to 0 around the run they measure
fused_attention.launches = 0
fused_attention.routes = collections.Counter()
fused_attention_segmented.routes = collections.Counter()
fused_attention_stream.routes = collections.Counter()
fused_attention.both_launches = fused_attention.only_launches = 0
fused_attention.i8s_launches = 0
fused_attention_segmented.both_launches = 0
fused_attention_segmented.only_launches = 0
fused_attention_bias.launches = 0
fused_attention_bias.routes = collections.Counter()
fused_attention_stream.launches = 0
fused_attention_stream.causal_launches = 0
fused_attention_stream.causal_alibi_launches = 0
fused_attention_stream.mla_launches = 0
fused_attention_window.launches = 0
fused_attention_window.routes = collections.Counter()
fused_attention_segmented.launches = 0
fused_attention_segmented_blockskip.launches = 0
fused_attention_segmented_blockskip.routes = collections.Counter()
fused_attention_cp.launches = 0
fused_attention_cp_stream.launches = 0
fused_attention_cp.routes = collections.Counter()
fused_attention_cp_stream.routes = collections.Counter()


def _lib90() -> ctypes.CDLL:
    from . import _cuda
    lib = _cuda.load("attention_sm90")
    if not getattr(lib, "_typed", False):
        type_lib90(lib)
    return lib


def type_lib90(lib: ctypes.CDLL) -> None:
    """Set the Hopper attention library's C signatures (also those of a
    variant build, ``tools/attention_ab.py``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attn90_launch.argtypes = [p] * 8 + [i] * 6 + [f, f, p]
    lib.attn90_launch.restype = i
    lib.attn90_i8_launch.argtypes = [p] * 6 + [i] * 5 + [f, p]
    lib.attn90_i8_launch.restype = i
    lib.attn90_emit_launch.argtypes = [p] * 7 + [i] * 6 + [f, f, p]
    lib.attn90_emit_launch.restype = i
    lib.attn90_cp_launch.argtypes = [p] * 4 + [i] * 6 + [f, f, p]
    lib.attn90_cp_launch.restype = i
    lib.attn90_mla_launch.argtypes = [p] * 3 + [i] * 5 + [f, f, p]
    lib.attn90_mla_launch.restype = i
    lib.attn90_error_string.argtypes = [i]
    lib.attn90_error_string.restype = ctypes.c_char_p
    lib._typed = True
