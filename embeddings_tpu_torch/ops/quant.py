"""Blockwise weight-only quantization (Q4_0 / Q4_1 / Q8_0 / NF4), ggml
semantics — the PyTorch port of ``embeddings_tpu/ops/quant.py``.

The numpy codecs are copies of the JAX package's (bit-identical codes and
scales), the legacy ggml ``.bin`` block codecs (``pack_ggml_*`` /
``unpack_ggml_*``) among them; ``QuantizedTensor`` holds torch tensors,
and ``dequantize`` / ``gather_rows`` are torch.

Layout: for a weight W[K, N] used as ``x @ W`` (K = contraction axis),
``codes`` is int8 [K, N] (int4-valued for Q4), ``scales``/``mins`` are
f32 [K//32, N]. q4 codes can be stored two per byte (group-64 nibble
layout, ``pack_codes_g64``) for the true 4-bit footprint; the CUDA
dequant-matmul kernel (ops/qmatmul.py) unpacks them in shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

QK = 32  # ggml block size

# 4-bit NormalFloat (QLoRA): quantiles of N(0, 1) normalized to [-1, 1].
NF4_TABLE = np.asarray([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], dtype=np.float32)
# decision boundaries (midpoints) for nearest-level encoding
_NF4_EDGES = (NF4_TABLE[1:] + NF4_TABLE[:-1]) / 2.0

# kinds whose 4-bit codes can nibble-pack (group-64 layout)
PACK4_KINDS = ("q4_0", "q4_1", "nf4")


class QuantizedTensor:
    """A quantized 2-D weight (plus optional leading layer-stack dims).

    Logical value = dequant(codes, scales, mins). ``block_axis`` -2: a
    matmul weight [K, N] blocked along K; -1: an embedding table [V, E]
    blocked along E. ``packed``: q4 codes stored two per byte as uint8
    [..., K/2, N] (or [..., V, E/2] for a table) in the group-64 layout.
    ``int8``: None, or the int8 mode's kept requantization of a matmul
    weight, (w8t [..., N, K] int8, cs [..., N] f32)
    (``ops.qmatmul.keep_int8_weight``).
    """

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor,
                 mins: torch.Tensor | None, kind: str, block_axis: int = -2,
                 packed: bool = False, int8=None):
        self.codes = codes
        self.scales = scales
        self.mins = mins
        self.kind = kind
        self.block_axis = block_axis
        self.packed = packed
        self.int8 = int8

    @property
    def shape(self) -> tuple[int, ...]:
        s = tuple(self.codes.shape)
        if self.packed:
            if self.block_axis == -2:
                return (*s[:-2], s[-2] * 2, s[-1])
            return (*s[:-1], s[-1] * 2)
        return s

    def map(self, fn) -> "QuantizedTensor":
        """Apply ``fn`` to codes, scales and mins, and to the kept int8
        weight (e.g. ``.to(device)`` or a layer index)."""
        return QuantizedTensor(fn(self.codes), fn(self.scales),
                               None if self.mins is None else fn(self.mins),
                               self.kind, self.block_axis, self.packed,
                               None if self.int8 is None
                               else tuple(fn(t) for t in self.int8))

    def __repr__(self) -> str:
        return (f"QuantizedTensor(kind={self.kind}, shape={self.shape}, "
                f"codes={self.codes.dtype}, packed={self.packed})")


# ---------------------------------------------------------------------------
# Group-64 nibble packing: within each group of 64 weight rows, byte row r
# holds weight row r (low nibble) and r+32 (high nibble) of the group.
# ---------------------------------------------------------------------------

def pack_codes_g64(codes: np.ndarray) -> np.ndarray:
    """int8 [..., K, N] in [-8, 7] -> uint8 [..., K/2, N]."""
    *lead, K, N = codes.shape
    if K % 64:
        raise ValueError(f"group-64 packing needs K % 64 == 0, got {K}")
    u = (np.asarray(codes).astype(np.int16) + 8).astype(np.uint8)
    g = u.reshape(*lead, K // 64, 2, 32, N)
    return (g[..., 0, :, :] | (g[..., 1, :, :] << 4)).reshape(
        *lead, K // 2, N)


def unpack_codes_g64(packed: np.ndarray) -> np.ndarray:
    """uint8 [..., K/2, N] -> int8 [..., K, N] in [-8, 7]."""
    p = np.asarray(packed)
    *lead, Kh, N = p.shape
    g = p.reshape(*lead, Kh // 32, 32, N)
    out = np.empty((*lead, Kh // 32, 2, 32, N), np.int8)
    out[..., 0, :, :] = (g & 0x0F).astype(np.int8) - 8
    out[..., 1, :, :] = (g >> 4).astype(np.int8) - 8
    return out.reshape(*lead, Kh * 2, N)


def pack_q4(qt: QuantizedTensor) -> QuantizedTensor:
    """Pack an int8-coded q4 weight to the 4-bit layout (no-op for other
    kinds or when the block axis is not a multiple of 64), along its own
    block axis so scales stay aligned."""
    if qt.packed or qt.kind not in PACK4_KINDS:
        return qt
    codes = qt.codes.cpu().numpy()
    if qt.block_axis == -2:
        if codes.shape[-2] % 64 != 0:
            return qt
        packed = pack_codes_g64(codes)
    else:
        if codes.shape[-1] % 64 != 0:
            return qt
        packed = np.swapaxes(
            pack_codes_g64(np.swapaxes(codes, -1, -2)), -1, -2)
    return QuantizedTensor(
        torch.from_numpy(np.ascontiguousarray(packed)).to(qt.codes.device),
        qt.scales, qt.mins, qt.kind, qt.block_axis, packed=True)


def codes_int8(qt: QuantizedTensor) -> np.ndarray:
    """The int8 code array (numpy, on the host) regardless of storage
    packing."""
    c = qt.codes.cpu().numpy()
    if not qt.packed:
        return c
    if qt.block_axis == -2:
        return unpack_codes_g64(c)
    return np.swapaxes(unpack_codes_g64(np.swapaxes(c, -1, -2)), -1, -2)


def _check_shape(w: np.ndarray) -> None:
    if w.shape[-2] % QK != 0:
        raise ValueError(
            f"contraction dim {w.shape[-2]} not a multiple of QK={QK} "
            f"(the reference requires ne[0] % 64 == 0, bert.cpp:730)")


def quantize_q4_0(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ggml Q4_0: d = signed-absmax / -8; q = clamp(x/d + 8.5, 0, 15).
    Returns (codes int8 [..., K, N] in [-8, 7], scales f32 [..., K//32, N])."""
    _check_shape(w)
    *lead, K, N = w.shape
    blocks = w.reshape(*lead, K // QK, QK, N).astype(np.float32)
    idx = np.abs(blocks).argmax(axis=-2, keepdims=True)
    maxv = np.take_along_axis(blocks, idx, axis=-2)  # signed value of absmax
    d = maxv / -8.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.floor(blocks * inv + 8.5), 0.0, 15.0).astype(np.int8) - 8
    return (q.reshape(*lead, K, N),
            d.squeeze(-2).astype(np.float32))


def quantize_q4_1(w: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ggml Q4_1 (affine): d=(max-min)/15, q=clamp((x-min)/d+.5, 0, 15)."""
    _check_shape(w)
    *lead, K, N = w.shape
    blocks = w.reshape(*lead, K // QK, QK, N).astype(np.float32)
    mn = blocks.min(axis=-2, keepdims=True)
    mx = blocks.max(axis=-2, keepdims=True)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.floor((blocks - mn) * inv + 0.5), 0.0, 15.0).astype(np.int8)
    return (q.reshape(*lead, K, N),
            d.squeeze(-2).astype(np.float32),
            mn.squeeze(-2).astype(np.float32))


def quantize_nf4(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """4-bit NormalFloat with a per-block MSE-searched scale over a small
    absmax-relative grid. Returns (codes int8 [..., K, N] in [-8, 7],
    scales f32 [..., K//32, N]); dequant = NF4_TABLE[codes + 8] * d."""
    _check_shape(w)
    *lead, K, N = w.shape
    blocks = w.reshape(*lead, K // QK, QK, N).astype(np.float32)
    amax = np.abs(blocks).max(axis=-2, keepdims=True)
    base = np.maximum(amax, 1e-30)
    best_err = np.full(base.shape, np.inf, np.float32)
    best_q = np.zeros(blocks.shape, np.int8)
    best_d = base.copy()
    for f in np.linspace(0.72, 1.04, 9, dtype=np.float32):
        d = base * f
        x = np.clip(blocks / d, -1.0, 1.0)
        q = np.searchsorted(_NF4_EDGES, x.ravel()).reshape(
            x.shape).astype(np.int8)
        err = ((NF4_TABLE[q] * d - blocks) ** 2).sum(-2, keepdims=True)
        better = err < best_err
        best_err = np.where(better, err, best_err)
        best_q = np.where(better, q, best_q)
        best_d = np.where(better, d, best_d)
    return ((best_q - 8).reshape(*lead, K, N),
            np.where(amax > 0, best_d, 0.0).squeeze(-2).astype(np.float32))


def quantize_q8_0(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ggml Q8_0: d = absmax/127, q = roundf(x/d) int8 (half away from
    zero, like C roundf)."""
    _check_shape(w)
    *lead, K, N = w.shape
    blocks = w.reshape(*lead, K // QK, QK, N).astype(np.float32)
    amax = np.abs(blocks).max(axis=-2, keepdims=True)
    d = amax / 127.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    v = blocks * inv
    q = (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int8)
    return q.reshape(*lead, K, N), d.squeeze(-2).astype(np.float32)


def quantize(w: np.ndarray, kind: str, *, block_axis: int = -2,
             pack4: bool = False) -> QuantizedTensor:
    """Quantize a weight array to a QuantizedTensor (CPU torch tensors).

    block_axis=-2: blocks along the contraction axis of an [K, N] matmul
    weight. block_axis=-1: blocks along the feature axis of an embedding
    table [V, E]."""
    w = np.asarray(w)
    if block_axis not in (-2, -1):
        raise ValueError("block_axis must be -2 or -1")
    if block_axis == -1:
        w = np.swapaxes(w, -1, -2)
    mins = None
    if kind == "q4_0":
        q, d = quantize_q4_0(w)
    elif kind == "q4_1":
        q, d, mins = quantize_q4_1(w)
        # Center codes to [-8, 7] and fold the shift into mins:
        # q*d + m == (q-8)*d + (m + 8d).
        q = q - 8
        mins = mins + 8.0 * d
    elif kind == "q8_0":
        q, d = quantize_q8_0(w)
    elif kind == "nf4":
        q, d = quantize_nf4(w)
    else:
        raise ValueError(f"unknown quant kind: {kind}")
    if block_axis == -1:
        q = np.swapaxes(q, -1, -2)
        d = np.swapaxes(d, -1, -2)
        if mins is not None:
            mins = np.swapaxes(mins, -1, -2)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    qt = QuantizedTensor(t(q), t(d), None if mins is None else t(mins),
                         kind, block_axis)
    return pack_q4(qt) if pack4 else qt


def _unpack_g64(packed: torch.Tensor) -> torch.Tensor:
    """torch group-64 unpack along axis -2: uint8 [..., K/2, N] -> int8."""
    *lead, Kh, N = packed.shape
    g = packed.reshape(*lead, Kh // 32, 1, 32, N).to(torch.int32)
    lo = (g & 0x0F) - 8
    hi = (g >> 4) - 8
    return torch.cat([lo, hi], dim=-3).reshape(*lead, Kh * 2, N).to(
        torch.int8)


def _unpack_g64_last(packed: torch.Tensor) -> torch.Tensor:
    """Group-64 unpack along the LAST axis (embedding-table layout)."""
    *lead, Eh = packed.shape
    g = packed.reshape(*lead, Eh // 32, 1, 32).to(torch.int32)
    lo = (g & 0x0F) - 8
    hi = (g >> 4) - 8
    return torch.cat([lo, hi], dim=-2).reshape(*lead, Eh * 2).to(torch.int8)


def _levels(codes: torch.Tensor, kind: str) -> torch.Tensor:
    """int codes -> f32 level values (NF4 table lookup for nf4)."""
    if kind == "nf4":
        table = torch.from_numpy(NF4_TABLE).to(codes.device)
        return table[codes.to(torch.int64) + 8]
    return codes.to(torch.float32)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """Plain (non-fused) dequantization to f32."""
    codes, scales, mins = qt.codes, qt.scales, qt.mins
    if qt.packed:
        codes = (_unpack_g64(codes) if qt.block_axis == -2
                 else _unpack_g64_last(codes))
    if qt.block_axis == -1:
        codes = codes.transpose(-1, -2)
        scales = scales.transpose(-1, -2)
        mins = None if mins is None else mins.transpose(-1, -2)
    *lead, K, N = codes.shape
    c = _levels(codes, qt.kind).reshape(*lead, K // QK, QK, N)
    w = c * scales.to(torch.float32)[..., :, None, :]
    if qt.kind == "q4_1":
        w = w + mins.to(torch.float32)[..., :, None, :]
    w = w.reshape(*lead, K, N)
    if qt.block_axis == -1:
        w = w.transpose(-1, -2)
    return w.contiguous()


def gather_rows(qt: QuantizedTensor, ids: torch.Tensor) -> torch.Tensor:
    """Dequantizing row gather for a block_axis=-1 embedding table [V, E]:
    gathers the codes and per-row-block scales for ``ids`` and
    dequantizes only those rows (f32)."""
    if qt.block_axis != -1:
        raise ValueError("gather_rows expects an embedding-layout table")
    c = qt.codes[ids]                  # [..., E] or packed [..., E/2]
    if qt.packed:
        c = _unpack_g64_last(c)
    c = _levels(c, qt.kind)
    s = qt.scales[ids].to(torch.float32)          # [..., E//QK]
    E = c.shape[-1]
    w = c.reshape(*c.shape[:-1], E // QK, QK) * s[..., None]
    if qt.kind == "q4_1":
        w = w + qt.mins[ids].to(torch.float32)[..., None]
    return w.reshape(*w.shape[:-2], E)


def dequantize_np(codes: np.ndarray, scales: np.ndarray,
                  mins: np.ndarray | None, kind: str) -> np.ndarray:
    """NumPy dequant (for offline tools / parity tests)."""
    *lead, K, N = codes.shape
    if kind == "nf4":
        c = NF4_TABLE[codes.astype(np.int32) + 8]
    else:
        c = codes.astype(np.float32)
    c = c.reshape(*lead, K // QK, QK, N)
    s = scales[..., :, None, :]
    w = c * s
    if kind == "q4_1":
        w = w + mins[..., :, None, :]
    return w.reshape(*lead, K, N)


# ---------------------------------------------------------------------------
# ggml bit-level pack/unpack (block structs), for the legacy .bin format.
# Layout per ggml block_q4_0: {f32 d; uint8 qs[16]} where qs[j] holds
# values 2j (low nibble) and 2j+1 (high nibble) of the 32-value block.
# ---------------------------------------------------------------------------

def pack_ggml_q4_0(codes: np.ndarray, scales: np.ndarray) -> bytes:
    """codes int8 [K, N] in [-8,7] + scales [K//32, N] -> ggml row-major
    block stream for the *transposed* [N, K] ggml tensor (ggml stores
    ne[0]=K contiguous per output row)."""
    K, N = codes.shape
    q = (codes.astype(np.int16) + 8).astype(np.uint8).T.reshape(N, K // QK, QK)
    lo, hi = q[..., 0::2], q[..., 1::2]
    packed = (lo | (hi << 4)).astype(np.uint8)          # [N, K//32, 16]
    d = scales.T.astype(np.float32)                     # [N, K//32]
    nb = K // QK
    rec = np.zeros(N * nb, dtype=np.dtype([("d", "<f4"),
                                           ("qs", "u1", (QK // 2,))]))
    rec["d"] = d.reshape(-1)
    rec["qs"] = packed.reshape(N * nb, QK // 2)
    return rec.tobytes()


def unpack_ggml_q4_0(buf: bytes, K: int, N: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of pack_ggml_q4_0: ggml block stream -> (codes [K,N], scales)."""
    nb = K // QK
    rec = np.dtype([("d", "<f4"), ("qs", "u1", (QK // 2,))])
    arr = np.frombuffer(buf, dtype=rec, count=N * nb).reshape(N, nb)
    d = arr["d"].astype(np.float32)                     # [N, nb]
    qs = arr["qs"]                                      # [N, nb, 16]
    q = np.empty((N, nb, QK), dtype=np.int8)
    q[..., 0::2] = (qs & 0x0F).astype(np.int8) - 8
    q[..., 1::2] = (qs >> 4).astype(np.int8) - 8
    return q.reshape(N, K).T.copy(), d.T.copy()


def pack_ggml_q4_1(codes_raw: np.ndarray, scales: np.ndarray,
                   mins_raw: np.ndarray) -> bytes:
    """ggml block_q4_1: {f32 d; f32 m; uint8 qs[16]}. Takes RAW ggml
    semantics: codes in [0, 15] and unfolded mins (as quantize_q4_1
    returns), for a [K, N] weight -> stream for the transposed ggml
    tensor."""
    K, N = codes_raw.shape
    q = codes_raw.astype(np.uint8).T.reshape(N, K // QK, QK)
    lo, hi = q[..., 0::2], q[..., 1::2]
    packed = (lo | (hi << 4)).astype(np.uint8)
    d = scales.T.astype(np.float32)
    m = mins_raw.T.astype(np.float32)
    nb = K // QK
    rec = np.zeros(N * nb, dtype=np.dtype([("d", "<f4"), ("m", "<f4"),
                                           ("qs", "u1", (QK // 2,))]))
    rec["d"] = d.reshape(-1)
    rec["m"] = m.reshape(-1)
    rec["qs"] = packed.reshape(N * nb, QK // 2)
    return rec.tobytes()


def unpack_ggml_q4_1(buf: bytes, K: int, N: int
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of pack_ggml_q4_1, returned in QuantizedTensor convention:
    CENTERED codes in [-8, 7] and FOLDED mins (m + 8d), so
    dequant = codes*d + mins."""
    nb = K // QK
    rec = np.dtype([("d", "<f4"), ("m", "<f4"), ("qs", "u1", (QK // 2,))])
    arr = np.frombuffer(buf, dtype=rec, count=N * nb).reshape(N, nb)
    d = arr["d"].astype(np.float32)
    m = arr["m"].astype(np.float32) + 8.0 * d   # fold the centering shift
    qs = arr["qs"]
    q = np.empty((N, nb, QK), dtype=np.int8)
    q[..., 0::2] = (qs & 0x0F).astype(np.int8) - 8
    q[..., 1::2] = (qs >> 4).astype(np.int8) - 8
    return q.reshape(N, K).T.copy(), d.T.copy(), m.T.copy()


def pack_ggml_q8_0(codes: np.ndarray, scales: np.ndarray) -> bytes:
    """ggml block_q8_0: {f32 d; int8 qs[32]}."""
    K, N = codes.shape
    q = codes.T.reshape(N, K // QK, QK).astype(np.int8)
    d = scales.T.astype(np.float32)
    nb = K // QK
    rec = np.zeros(N * nb, dtype=np.dtype([("d", "<f4"),
                                           ("qs", "i1", (QK,))]))
    rec["d"] = d.reshape(-1)
    rec["qs"] = q.reshape(N * nb, QK)
    return rec.tobytes()


def unpack_ggml_q8_0(buf: bytes, K: int, N: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    nb = K // QK
    rec = np.dtype([("d", "<f4"), ("qs", "i1", (QK,))])
    arr = np.frombuffer(buf, dtype=rec, count=N * nb).reshape(N, nb)
    return (arr["qs"].reshape(N, K).T.astype(np.int8).copy(),
            arr["d"].astype(np.float32).T.copy())


def nibble_histogram(codes: np.ndarray) -> np.ndarray:
    """16-bucket histogram of 4-bit codes, matching the reference's
    quantization stats printout (quantize.cpp:229-261)."""
    vals = np.asarray(codes).astype(np.int32).ravel() + 8
    return np.bincount(np.clip(vals, 0, 15), minlength=16)


# ---------------------------------------------------------------------------
# symmetric per-row (per-column) int8, and the emission helpers shared by
# the matmul (K1e / K3e) and attention (K2e / K4e) wrappers
# ---------------------------------------------------------------------------

EMITS = ("no", "both", "only")


def quantize_sym(v: torch.Tensor, dim: int, floor: float = 1e-12):
    """Symmetric int8 of f32 ``v`` over ``dim``: scale = max(absmax,
    floor) * (1/127), q = round(v * (1/scale)), half to even (|v| <=
    absmax, so q lands in [-127, 127] without a clip). Returns (q int8,
    scale f32 with ``dim`` kept)."""
    s = v.abs().amax(dim, keepdim=True).clamp_min(floor) * (1.0 / 127.0)
    return torch.round(v * (1.0 / s)).to(torch.int8), s


def emit_result(out, o8, os, emit: str):
    """A wrapper's result in emit mode ``emit``: ``out``, ``(out, o8,
    os)`` ("both") or ``(o8, os)`` ("only")."""
    if emit == "no":
        return out
    return (o8, os) if emit == "only" else (out, o8, os)


def count_launch(fn, emit: str) -> None:
    """One launch of ``fn``'s kernel: adds one to ``fn.launches`` and, when
    it emits, to ``fn.both_launches`` or ``fn.only_launches``."""
    fn.launches += 1
    if emit != "no":
        setattr(fn, f"{emit}_launches", getattr(fn, f"{emit}_launches") + 1)
