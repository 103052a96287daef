"""Reader/writer for GGUF model files (BERT architecture) — the PyTorch
port of ``embeddings_tpu/models/gguf_io.py``: the name maps, the numpy
block codecs and the container code are copies of the JAX package's; a
quantized tensor read from a file becomes a ``QuantizedTensor`` of CPU
torch tensors (``torch.from_numpy`` of the decoded arrays).

The reference pins a pre-GGUF 2023 ggml and its README's own TODO is
"Update to the latest ggml lib and gguf format" — modern llama.cpp-era
embedding checkpoints (bge/nomic/MiniLM GGUFs) use this container. This
module implements GGUF v3 from the public spec so those files load
directly into the engine, and so our checkpoints can be exported for
llama.cpp-ecosystem tooling.

Layout (little-endian throughout):

  u32 magic 'GGUF' (0x46554747), u32 version (3),
  u64 n_tensors, u64 n_kv,
  n_kv x { string key, u32 vtype, value },
  n_tensors x { string name, u32 n_dims, u64 ne[n_dims] (ne[0] innermost),
                u32 ggml_type, u64 offset (into the data section) },
  pad to `general.alignment` (default 32),
  tensor data (each tensor offset aligned).

Strings are u64-length-prefixed UTF-8. Arrays are { u32 elem_vtype,
u64 n, elems }.

Quantized blocks (current ggml, different from the legacy .bin era that
ggml_io handles): Q4_0 = { f16 d; u8 qs[16] } per 32 elements with LOW
nibbles = elements 0..15 and HIGH nibbles = 16..31 (the legacy format
used f32 d and adjacent-pair nibbles); Q4_1 = { f16 d; f16 m; u8 qs[16] };
Q8_0 = { f16 d; i8 qs[32] }. K-quants (q4_K/q5_K/q6_K, the formats most
published llama.cpp-era embedding GGUFs actually ship) are read via
dequantize-on-load into dense f32 — pass dtype= to load_model to
re-quantize onto the engine's own kernels.

BERT tensor names follow llama.cpp's bert arch (token_embd.weight,
blk.N.attn_q.weight, ...) — mapped to/from HF state-dict names below.
Reads additionally cover llama.cpp's nomic-bert arch (fused attn_qkv
split on load, ffn_gate, RoPE theta from {arch}.rope.freq_base) and
jina-bert-v2 (ALiBi + gated MLP) — the two non-bert encoder arches
published embedding GGUFs actually use.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np
import torch

from ..config import BertConfig
from ..ops import quant as Q

MAGIC = 0x46554747  # 'GGUF'
VERSION = 3
ALIGNMENT = 32

# GGUF metadata value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL = range(8)
T_STRING, T_ARRAY, T_U64, T_I64, T_F64 = 8, 9, 10, 11, 12

# ggml tensor types
GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q4_1 = 0, 1, 2, 3
GGML_Q8_0 = 8
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
GGML_TYPE_NAMES = {GGML_F32: "f32", GGML_F16: "f16", GGML_Q4_0: "q4_0",
                   GGML_Q4_1: "q4_1", GGML_Q8_0: "q8_0",
                   GGML_Q4_K: "q4_K", GGML_Q5_K: "q5_K", GGML_Q6_K: "q6_K"}
DTYPE_TO_GGML = {"f32": GGML_F32, "f16": GGML_F16, "q4_0": GGML_Q4_0,
                 "q4_1": GGML_Q4_1, "q8_0": GGML_Q8_0,
                 "q4_K": GGML_Q4_K, "q5_K": GGML_Q5_K, "q6_K": GGML_Q6_K}

QK = Q.QK  # 32-element blocks

# llama.cpp bert-arch tensor name <-> HF state-dict name
_STATIC_NAMES = {
    "token_embd.weight": "embeddings.word_embeddings.weight",
    "token_types.weight": "embeddings.token_type_embeddings.weight",
    "position_embd.weight": "embeddings.position_embeddings.weight",
    "token_embd_norm.weight": "embeddings.LayerNorm.weight",
    "token_embd_norm.bias": "embeddings.LayerNorm.bias",
    # reranker classification head (llama.cpp CLS / CLS_OUT — the
    # bge-reranker GGUF convention: cls = tanh'd dense, cls.output =
    # the scoring projection). A lone cls without cls.output is left
    # unattached (the loader only builds a head it can run faithfully).
    "cls.weight": "classifier.dense.weight",
    "cls.bias": "classifier.dense.bias",
    "cls.output.weight": "classifier.out_proj.weight",
    "cls.output.bias": "classifier.out_proj.bias",
}
_BLOCK_NAMES = {
    "attn_q": "attention.self.query",
    "attn_k": "attention.self.key",
    "attn_v": "attention.self.value",
    "attn_output": "attention.output.dense",
    "attn_output_norm": "attention.output.LayerNorm",
    "ffn_up": "intermediate.dense",
    "ffn_down": "output.dense",
    "layer_output_norm": "output.LayerNorm",
    # nomic-bert / jina-bert-v2 arches (plain bert never ships these):
    # gated-MLP gate half, and nomic's fused Wqkv (split on read)
    "ffn_gate": "intermediate.gate",
    "attn_qkv": "attention.self.qkv",
    # nomic-bert-moe (nomic-embed-text-v2-moe) expert tensors: router
    # [n_embd, n_expert] and per-expert up/down stacks; re-laid into
    # the HF NomicExpertMLP w1/w2 form after the read loop
    "ffn_gate_inp": "moe.router",
    "ffn_up_exps": "moe.up_exps",
    "ffn_down_exps": "moe.down_exps",
}


def gguf_to_hf_name(name: str) -> str | None:
    """llama.cpp bert tensor name -> HF name (None = unknown/skip)."""
    if name in _STATIC_NAMES:
        return _STATIC_NAMES[name]
    if name.startswith("blk."):
        _, i, rest = name.split(".", 2)
        stem, _, suffix = rest.rpartition(".")
        hf = _BLOCK_NAMES.get(stem)
        if hf is not None and suffix in ("weight", "bias"):
            return f"encoder.layer.{i}.{hf}.{suffix}"
    return None


_STATIC_NAMES_INV = {v: k for k, v in _STATIC_NAMES.items()}


def hf_to_gguf_name(name: str) -> str | None:
    if name in _STATIC_NAMES_INV:
        return _STATIC_NAMES_INV[name]
    if name.startswith("encoder.layer."):
        parts = name.split(".")
        i = parts[2]
        suffix = parts[-1]
        hf_stem = ".".join(parts[3:-1])
        for g, h in _BLOCK_NAMES.items():
            if h == hf_stem:
                return f"blk.{i}.{g}.{suffix}"
    return None


# ---------------------------------------------------------------------------
# GGUF-era block codecs (vectorized; note the layout differs from the
# legacy .bin codecs in ops/quant.py)
# ---------------------------------------------------------------------------

def q4_0_to_bytes(a: np.ndarray) -> bytes:
    """f32 [R, K] (K innermost, K%32==0) -> GGUF Q4_0 block stream."""
    R, K = a.shape
    nb = K // QK
    blocks = a.reshape(R * nb, QK).astype(np.float32)
    idx = np.abs(blocks).argmax(axis=-1, keepdims=True)
    maxv = np.take_along_axis(blocks, idx, axis=-1)
    # llama.cpp quantize_row_q4_0_ref: codes come from the FULL-precision
    # scale; only the stored d is rounded to f16 (bit-parity with
    # llama.cpp-quantized artifacts, same reason as the q8_0 roundf fix)
    df = (maxv / -8.0).astype(np.float32)
    d = df.astype(np.float16)
    inv = np.where(df != 0.0, 1.0 / np.where(df == 0.0, 1.0, df), 0.0)
    q = np.clip(np.floor(blocks * inv + 8.5), 0.0, 15.0).astype(np.uint8)
    lo, hi = q[:, :QK // 2], q[:, QK // 2:]
    qs = (lo | (hi << 4)).astype(np.uint8)          # [R*nb, 16]
    rec = np.zeros(R * nb, dtype=np.dtype([("d", "<f2"),
                                           ("qs", "u1", (QK // 2,))]))
    rec["d"] = d[:, 0]
    rec["qs"] = qs
    return rec.tobytes()


def q4_0_from_bytes(buf: bytes, R: int, K: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """GGUF Q4_0 stream -> (codes int8 [R, K] in [-8, 7], scales f32
    [R, K//32])."""
    nb = K // QK
    rec = np.dtype([("d", "<f2"), ("qs", "u1", (QK // 2,))])
    arr = np.frombuffer(buf, dtype=rec, count=R * nb).reshape(R, nb)
    d = arr["d"].astype(np.float32)
    qs = arr["qs"]
    codes = np.empty((R, nb, QK), np.int8)
    codes[..., :QK // 2] = (qs & 0x0F).astype(np.int8) - 8
    codes[..., QK // 2:] = (qs >> 4).astype(np.int8) - 8
    return codes.reshape(R, K), d


def q4_1_to_bytes(a: np.ndarray) -> bytes:
    R, K = a.shape
    nb = K // QK
    blocks = a.reshape(R * nb, QK).astype(np.float32)
    mn = blocks.min(axis=-1, keepdims=True)
    mx = blocks.max(axis=-1, keepdims=True)
    # full-precision d/min for the codes, f16 only for storage
    # (llama.cpp quantize_row_q4_1_ref parity)
    df = ((mx - mn) / 15.0).astype(np.float32)
    d = df.astype(np.float16)
    m = mn.astype(np.float16)
    inv = np.where(df != 0.0, 1.0 / np.where(df == 0.0, 1.0, df), 0.0)
    q = np.clip(np.floor((blocks - mn) * inv + 0.5),
                0.0, 15.0).astype(np.uint8)
    lo, hi = q[:, :QK // 2], q[:, QK // 2:]
    rec = np.zeros(R * nb, dtype=np.dtype([("d", "<f2"), ("m", "<f2"),
                                           ("qs", "u1", (QK // 2,))]))
    rec["d"] = d[:, 0]
    rec["m"] = m[:, 0]
    rec["qs"] = (lo | (hi << 4)).astype(np.uint8)
    return rec.tobytes()


def q4_1_from_bytes(buf: bytes, R: int, K: int):
    """Returns the repo-wide QuantizedTensor q4_1 convention: CENTERED
    codes in [-8, 7] with FOLDED mins (m + 8d), matching
    ops.quant.unpack_ggml_q4_1 — pack_codes_g64 and the kernels assume
    centered codes, so raw [0, 15] codes would overflow the nibble
    packing and silently corrupt the weights."""
    nb = K // QK
    rec = np.dtype([("d", "<f2"), ("m", "<f2"), ("qs", "u1", (QK // 2,))])
    arr = np.frombuffer(buf, dtype=rec, count=R * nb).reshape(R, nb)
    d = arr["d"].astype(np.float32)
    m = arr["m"].astype(np.float32) + 8.0 * d   # fold the centering shift
    qs = arr["qs"]
    codes = np.empty((R, nb, QK), np.int8)
    codes[..., :QK // 2] = (qs & 0x0F).astype(np.int8) - 8
    codes[..., QK // 2:] = (qs >> 4).astype(np.int8) - 8
    return codes.reshape(R, K), d, m


def q8_0_to_bytes(a: np.ndarray) -> bytes:
    R, K = a.shape
    nb = K // QK
    blocks = a.reshape(R * nb, QK).astype(np.float32)
    amax = np.abs(blocks).max(axis=-1, keepdims=True)
    d = (amax / 127.0).astype(np.float16)
    df = d.astype(np.float32)
    inv = np.where(df != 0.0, 1.0 / np.where(df == 0.0, 1.0, df), 0.0)
    v = blocks * inv
    # half-away-from-zero like C roundf (llama.cpp quantize_row_q8_0)
    q = (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int8)
    rec = np.zeros(R * nb, dtype=np.dtype([("d", "<f2"),
                                           ("qs", "i1", (QK,))]))
    rec["d"] = d[:, 0]
    rec["qs"] = q
    return rec.tobytes()


def q8_0_from_bytes(buf: bytes, R: int, K: int):
    nb = K // QK
    rec = np.dtype([("d", "<f2"), ("qs", "i1", (QK,))])
    arr = np.frombuffer(buf, dtype=rec, count=R * nb).reshape(R, nb)
    return arr["qs"].reshape(R, K).copy(), arr["d"].astype(np.float32)


_BLOCK_BYTES = {GGML_Q4_0: 2 + 16, GGML_Q4_1: 4 + 16, GGML_Q8_0: 2 + 32}
# K-quants: 256-element super-blocks (llama.cpp k_quants)
QK_K = 256
_KBLOCK_BYTES = {GGML_Q4_K: 2 + 2 + 12 + 128,      # 144
                 GGML_Q5_K: 2 + 2 + 12 + 32 + 128,  # 176
                 GGML_Q6_K: 128 + 64 + 16 + 2}      # 210


def _tensor_nbytes(ggml_type: int, ne: tuple[int, ...]) -> int:
    nel = int(np.prod(ne))
    if ggml_type == GGML_F32:
        return nel * 4
    if ggml_type == GGML_F16:
        return nel * 2
    if ggml_type in _KBLOCK_BYTES:
        return nel // QK_K * _KBLOCK_BYTES[ggml_type]
    if ggml_type not in _BLOCK_BYTES:
        raise ValueError(
            f"unsupported ggml tensor type {ggml_type} (supported: "
            f"{sorted(GGML_TYPE_NAMES.values())})")
    return nel // QK * _BLOCK_BYTES[ggml_type]


# ---------------------------------------------------------------------------
# K-quant codecs (q4_K / q5_K / q6_K): most published llama.cpp-era
# BGE/MiniLM/nomic embedding GGUFs ship as q4_K_M / q5_K / q6_K mixes.
# Decoded (dequantized) to dense f32 on load; load_model(dtype=...) can
# then re-quantize to the engine's own Q4_0/Q8_0 kernels. Layouts follow
# llama.cpp's dequantize_row_q{4,5,6}_K. The encoders exist for fixture
# generation and re-export; they use direct (non-search) scale fitting,
# decode-compatible with llama.cpp but not bit-identical to its
# error-minimizing quantizers.
# ---------------------------------------------------------------------------

def _unpack_scale_min_k4(s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """llama.cpp get_scale_min_k4: 8 x (6-bit scale, 6-bit min) packed in
    12 bytes. s: [..., 12] uint8 -> (sc [..., 8], mn [..., 8])."""
    sc = np.empty(s.shape[:-1] + (8,), np.uint8)
    mn = np.empty_like(sc)
    sc[..., 0:4] = s[..., 0:4] & 63
    mn[..., 0:4] = s[..., 4:8] & 63
    sc[..., 4:8] = (s[..., 8:12] & 0x0F) | ((s[..., 0:4] >> 6) << 4)
    mn[..., 4:8] = (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)
    return sc, mn


def _pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_scale_min_k4. sc/mn: [..., 8] uint8 (<= 63)."""
    s = np.zeros(sc.shape[:-1] + (12,), np.uint8)
    s[..., 0:4] = (sc[..., 0:4] & 63) | ((sc[..., 4:8] >> 4) << 6)
    s[..., 4:8] = (mn[..., 0:4] & 63) | ((mn[..., 4:8] >> 4) << 6)
    s[..., 8:12] = (sc[..., 4:8] & 0x0F) | ((mn[..., 4:8] & 0x0F) << 4)
    return s


_Q4K_REC = np.dtype([("d", "<f2"), ("dmin", "<f2"),
                     ("scales", "u1", (12,)), ("qs", "u1", (128,))])
_Q5K_REC = np.dtype([("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
                     ("qh", "u1", (32,)), ("qs", "u1", (128,))])
_Q6K_REC = np.dtype([("ql", "u1", (128,)), ("qh", "u1", (64,)),
                     ("scales", "i1", (16,)), ("d", "<f2")])


def q4_K_from_bytes(buf: bytes, R: int, K: int) -> np.ndarray:
    """GGUF Q4_K stream -> dense f32 [R, K]. Per llama.cpp
    dequantize_row_q4_K: x = d*sc*q - dmin*m over 8 sub-blocks of 32."""
    n = R * K // QK_K
    arr = np.frombuffer(buf, dtype=_Q4K_REC, count=n)
    d = arr["d"].astype(np.float32)
    dmin = arr["dmin"].astype(np.float32)
    sc, mn = _unpack_scale_min_k4(arr["scales"])
    qs = arr["qs"]
    out = np.empty((n, QK_K), np.float32)
    for j in range(4):  # 4 chunks of 64 values = 32 bytes each
        q = qs[:, j * 32:(j + 1) * 32]
        d1 = d * sc[:, 2 * j]
        m1 = dmin * mn[:, 2 * j]
        d2 = d * sc[:, 2 * j + 1]
        m2 = dmin * mn[:, 2 * j + 1]
        out[:, j * 64:j * 64 + 32] = (d1[:, None] * (q & 0x0F)
                                      - m1[:, None])
        out[:, j * 64 + 32:j * 64 + 64] = (d2[:, None] * (q >> 4)
                                           - m2[:, None])
    return out.reshape(R, K)


def q5_K_from_bytes(buf: bytes, R: int, K: int) -> np.ndarray:
    """GGUF Q5_K stream -> dense f32 [R, K] (5-bit: low nibble + qh bit)."""
    n = R * K // QK_K
    arr = np.frombuffer(buf, dtype=_Q5K_REC, count=n)
    d = arr["d"].astype(np.float32)
    dmin = arr["dmin"].astype(np.float32)
    sc, mn = _unpack_scale_min_k4(arr["scales"])
    qs, qh = arr["qs"], arr["qh"]
    out = np.empty((n, QK_K), np.float32)
    for j in range(4):
        ql = qs[:, j * 32:(j + 1) * 32]
        u1, u2 = 1 << (2 * j), 2 << (2 * j)
        lo = (ql & 0x0F) + ((qh & u1) != 0) * np.uint8(16)
        hi = (ql >> 4) + ((qh & u2) != 0) * np.uint8(16)
        d1 = d * sc[:, 2 * j]
        m1 = dmin * mn[:, 2 * j]
        d2 = d * sc[:, 2 * j + 1]
        m2 = dmin * mn[:, 2 * j + 1]
        out[:, j * 64:j * 64 + 32] = d1[:, None] * lo - m1[:, None]
        out[:, j * 64 + 32:j * 64 + 64] = d2[:, None] * hi - m2[:, None]
    return out.reshape(R, K)


def q6_K_from_bytes(buf: bytes, R: int, K: int) -> np.ndarray:
    """GGUF Q6_K stream -> dense f32 [R, K]: x = d * scales[l/16] * q,
    q in [-32, 31] (4 low bits in ql + 2 high bits in qh)."""
    n = R * K // QK_K
    arr = np.frombuffer(buf, dtype=_Q6K_REC, count=n)
    d = arr["d"].astype(np.float32)[:, None]
    out = np.empty((n, QK_K), np.float32)
    for h in range(2):  # two 128-value halves
        ql = arr["ql"][:, h * 64:(h + 1) * 64]
        qh = arr["qh"][:, h * 32:(h + 1) * 32]
        sc = arr["scales"][:, h * 8:(h + 1) * 8].astype(np.float32)
        q1 = ((ql[:, :32] & 0x0F) | (((qh >> 0) & 3) << 4)).astype(
            np.int8) - 32
        q2 = ((ql[:, 32:] & 0x0F) | (((qh >> 2) & 3) << 4)).astype(
            np.int8) - 32
        q3 = ((ql[:, :32] >> 4) | (((qh >> 4) & 3) << 4)).astype(
            np.int8) - 32
        q4 = ((ql[:, 32:] >> 4) | (((qh >> 6) & 3) << 4)).astype(
            np.int8) - 32
        base = h * 128
        for k, q in enumerate((q1, q2, q3, q4)):
            s = np.repeat(sc[:, 2 * k:2 * k + 2], 16, axis=1)
            out[:, base + 32 * k:base + 32 * (k + 1)] = d * s * q
    return out.reshape(R, K)


def _fit_sub_scales(x: np.ndarray, nmax: int):
    """Per-sub-block (d_sub, m_sub) for the x = d*q - m form with
    q in [0, nmax], refined by a few alternating-least-squares rounds
    (requantize q, then refit d/m by regression) — recovers most of the
    gap to llama.cpp's scale-search quantizer without the search."""
    mn = np.minimum(x.min(axis=-1), 0.0)
    mx = np.maximum(x.max(axis=-1), 0.0)
    d, m = (mx - mn) / nmax, -mn
    for _ in range(5):
        q = np.clip(np.rint((x + m[..., None])
                            / np.where(d == 0, 1, d)[..., None]),
                    0, nmax)
        qm, xm = q.mean(-1), x.mean(-1)
        var = (q * q).mean(-1) - qm * qm
        cov = (q * x).mean(-1) - qm * xm
        d_new = np.where(var > 1e-12, cov / np.maximum(var, 1e-12), d)
        d_new = np.maximum(d_new, 0.0)
        m_new = np.maximum(d_new * qm - xm, 0.0)
        d, m = d_new, m_new
    return d, m


def _q45_K_to_bytes(a: np.ndarray, five_bit: bool) -> bytes:
    R, K = a.shape
    n = R * K // QK_K
    blocks = a.reshape(n, 8, 32).astype(np.float32)
    nmax = 31 if five_bit else 15
    d_sub, m_sub = _fit_sub_scales(blocks, nmax)       # [n, 8]
    d = np.maximum(d_sub.max(axis=-1), 1e-30) / 63.0   # [n]
    dmin = np.maximum(m_sub.max(axis=-1), 1e-30) / 63.0
    df = d.astype(np.float16).astype(np.float32)
    dmf = dmin.astype(np.float16).astype(np.float32)
    sc = np.clip(np.rint(d_sub / np.where(df == 0, 1, df)[:, None]),
                 0, 63).astype(np.uint8)
    mn = np.clip(np.rint(m_sub / np.where(dmf == 0, 1, dmf)[:, None]),
                 0, 63).astype(np.uint8)
    eff_d = df[:, None] * sc                            # [n, 8]
    eff_m = dmf[:, None] * mn
    q = np.clip(np.rint((blocks + eff_m[:, :, None])
                        / np.where(eff_d == 0, 1, eff_d)[:, :, None]),
                0, nmax).astype(np.uint8)               # [n, 8, 32]
    q = q.reshape(n, 4, 64)                             # chunk of 64
    lo_src, hi_src = q[:, :, :32], q[:, :, 32:]
    if five_bit:
        qs = ((lo_src & 0x0F) | ((hi_src & 0x0F) << 4)).reshape(n, 128)
        qh = np.zeros((n, 32), np.uint8)
        for j in range(4):
            qh |= ((lo_src[:, j] >> 4) & 1) << (2 * j)
            qh |= ((hi_src[:, j] >> 4) & 1) << (2 * j + 1)
        rec = np.zeros(n, dtype=_Q5K_REC)
        rec["qh"] = qh
    else:
        qs = (lo_src | (hi_src << 4)).reshape(n, 128)
        rec = np.zeros(n, dtype=_Q4K_REC)
    rec["d"] = d.astype(np.float16)
    rec["dmin"] = dmin.astype(np.float16)
    rec["scales"] = _pack_scale_min_k4(sc, mn)
    rec["qs"] = qs
    return rec.tobytes()


def q4_K_to_bytes(a: np.ndarray) -> bytes:
    return _q45_K_to_bytes(a, five_bit=False)


def q5_K_to_bytes(a: np.ndarray) -> bytes:
    return _q45_K_to_bytes(a, five_bit=True)


def q6_K_to_bytes(a: np.ndarray) -> bytes:
    R, K = a.shape
    n = R * K // QK_K
    groups = a.reshape(n, 16, 16).astype(np.float32)    # 16 groups of 16
    amax = np.abs(groups).max(axis=-1)                  # [n, 16]
    d_sub = amax / 31.0
    for _ in range(5):  # ALS refinement: x ~ d*q, q in [-32, 31]
        q = np.clip(np.rint(groups
                            / np.where(d_sub == 0, 1, d_sub)[..., None]),
                    -32, 31)
        num = (q * groups).sum(-1)
        den = (q * q).sum(-1)
        d_sub = np.where(den > 0, num / np.maximum(den, 1e-12), d_sub)
        d_sub = np.maximum(d_sub, 0.0)
    d = np.maximum(d_sub.max(axis=-1), 1e-30) / 127.0   # [n]
    df = d.astype(np.float16).astype(np.float32)
    sc = np.clip(np.rint(d_sub / np.where(df == 0, 1, df)[:, None]),
                 -128, 127).astype(np.int8)             # [n, 16]
    eff = df[:, None] * sc.astype(np.float32)
    q = np.clip(np.rint(groups / np.where(eff == 0, 1, eff)[:, :, None]),
                -32, 31).astype(np.int8)                # [n, 16, 16]
    q = (q.reshape(n, QK_K) + 32).astype(np.uint8)      # biased [0, 63]
    rec = np.zeros(n, dtype=_Q6K_REC)
    for h in range(2):
        half = q[:, h * 128:(h + 1) * 128]
        q1, q2 = half[:, :32], half[:, 32:64]
        q3, q4 = half[:, 64:96], half[:, 96:128]
        rec["ql"][:, h * 64:h * 64 + 32] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
        rec["ql"][:, h * 64 + 32:h * 64 + 64] = ((q2 & 0x0F)
                                                 | ((q4 & 0x0F) << 4))
        rec["qh"][:, h * 32:(h + 1) * 32] = ((q1 >> 4) | ((q2 >> 4) << 2)
                                             | ((q3 >> 4) << 4)
                                             | ((q4 >> 4) << 6))
    rec["scales"] = sc
    rec["d"] = d.astype(np.float16)
    return rec.tobytes()


# ---------------------------------------------------------------------------
# Metadata primitives
# ---------------------------------------------------------------------------

def _w_str(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


_SCALAR_FMT = {T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
               T_U32: "<I", T_I32: "<i", T_F32: "<f", T_BOOL: "<?",
               T_U64: "<Q", T_I64: "<q", T_F64: "<d"}


def _w_value(f: BinaryIO, vtype: int, v: Any) -> None:
    if vtype == T_STRING:
        _w_str(f, v)
    elif vtype == T_ARRAY:
        etype, items = v
        f.write(struct.pack("<IQ", etype, len(items)))
        for it in items:
            _w_value(f, etype, it)
    else:
        f.write(struct.pack(_SCALAR_FMT[vtype], v))


def _r_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _r_value(f: BinaryIO, vtype: int) -> Any:
    if vtype == T_STRING:
        return _r_str(f)
    if vtype == T_ARRAY:
        etype, n = struct.unpack("<IQ", f.read(12))
        return [_r_value(f, etype) for _ in range(n)]
    fmt = _SCALAR_FMT[vtype]
    (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
    return v


# ---------------------------------------------------------------------------
# Write
# ---------------------------------------------------------------------------

def _pooling_type_enum(pooling: str) -> int:
    """llama.cpp pooling enum: 1=mean, 2=cls; there is NO max value, so
    exporting a max-pooled model warns (the file will reload as mean)."""
    if pooling == "max":
        import logging
        logging.getLogger("embeddings_tpu_torch.gguf").warning(
            "GGUF bert.pooling_type cannot represent max pooling; the "
            "exported file will reload with mean pooling — pass "
            "pooling='max' explicitly when loading it")
        return 0
    return {"mean": 1, "cls": 2}.get(pooling, 1)


def write_gguf(path: str | Path, params: dict, config: BertConfig,
               vocab_tokens: list[str], dtype: str = "f32", *,
               name: str = "embeddings_tpu bert export") -> None:
    """Write a parameter tree as a GGUF v3 BERT model.

    dtype (f32|f16|q4_0|q4_1|q8_0) applies to 2-D '.weight' tensors, the
    same selection rule as the legacy pipeline (convert-to-ggml.py:93-98,
    quantize.cpp:154-167); everything else stays f32.
    """
    from .params import to_hf_state_dict
    sd = to_hf_state_dict(params)
    ggml_type = DTYPE_TO_GGML[dtype]

    specials = {"[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"}
    tok_types = [3 if t in specials or
                 (t.startswith("[unused") and t.endswith("]")) else 1
                 for t in vocab_tokens]

    def tok_id(tok: str, default: int) -> int:
        try:
            return vocab_tokens.index(tok)
        except ValueError:
            return default

    kv: list[tuple[str, int, Any]] = [
        ("general.architecture", T_STRING, "bert"),
        ("general.name", T_STRING, name),
        ("general.alignment", T_U32, ALIGNMENT),
        ("general.file_type", T_U32,
         {GGML_F32: 0, GGML_F16: 1, GGML_Q4_0: 2, GGML_Q4_1: 3,
          GGML_Q8_0: 7, GGML_Q4_K: 15, GGML_Q5_K: 17,
          GGML_Q6_K: 18}[ggml_type]),
        *([("general.quantization_version", T_U32, 2)]  # GGML_QNT_VERSION
          if ggml_type not in (GGML_F32, GGML_F16) else []),
        ("bert.context_length", T_U32, config.max_position_embeddings),
        # llama.cpp writes pooling_type for embedding models (1=mean,
        # 2=cls); loaders that check it would otherwise default to none.
        # The enum has no MAX value — _warn_unrepresentable_pooling
        # says so instead of silently round-tripping max into mean.
        ("bert.pooling_type", T_U32,
         _pooling_type_enum(config.pooling)),
        ("bert.embedding_length", T_U32, config.hidden_size),
        ("bert.feed_forward_length", T_U32, config.intermediate_size),
        ("bert.block_count", T_U32, config.num_hidden_layers),
        ("bert.attention.head_count", T_U32, config.num_attention_heads),
        ("bert.attention.layer_norm_epsilon", T_F32, config.layer_norm_eps),
        ("bert.vocab_size", T_U32, config.vocab_size),
        ("tokenizer.ggml.model", T_STRING, "bert"),
        ("tokenizer.ggml.tokens", T_ARRAY, (T_STRING, vocab_tokens)),
        ("tokenizer.ggml.token_type", T_ARRAY, (T_I32, tok_types)),
        ("tokenizer.ggml.unknown_token_id", T_U32,
         tok_id("[UNK]", config.unk_token_id)),
        ("tokenizer.ggml.padding_token_id", T_U32,
         tok_id("[PAD]", config.pad_token_id)),
        ("tokenizer.ggml.cls_token_id", T_U32,
         tok_id("[CLS]", config.cls_token_id)),
        # llama.cpp's historical spelling
        ("tokenizer.ggml.seperator_token_id", T_U32,
         tok_id("[SEP]", config.sep_token_id)),
    ]

    # assemble tensor payloads (name, ne, type, bytes)
    tensors: list[tuple[str, tuple[int, ...], int, bytes]] = []
    for hf_name, arr in sd.items():
        gname = hf_to_gguf_name(hf_name)
        if gname is None:
            continue
        arr = np.ascontiguousarray(arr, np.float32)
        ne = arr.shape[::-1]  # ne[0] innermost
        ttype = ggml_type
        if (ttype in (GGML_Q4_K, GGML_Q5_K)
                and gname == "token_embd.weight"):
            # llama.cpp's Q4_K_M / Q5_K_M mixes keep the embedding table
            # at q6_K: table quantization perturbs every activation
            # directly, and the table is read once per token (not per
            # matmul), so the extra bits cost nothing at run time
            ttype = GGML_Q6_K
        blk = QK_K if ttype in _KBLOCK_BYTES else QK
        quantize_this = (ttype != GGML_F32 and arr.ndim == 2
                         and hf_name.endswith(".weight")
                         and ne[0] % blk == 0)
        if not quantize_this:
            tensors.append((gname, ne, GGML_F32, arr.tobytes()))
        elif ttype == GGML_F16:
            tensors.append((gname, ne, GGML_F16,
                            arr.astype(np.float16).tobytes()))
        else:
            enc = {GGML_Q4_0: q4_0_to_bytes, GGML_Q4_1: q4_1_to_bytes,
                   GGML_Q8_0: q8_0_to_bytes, GGML_Q4_K: q4_K_to_bytes,
                   GGML_Q5_K: q5_K_to_bytes,
                   GGML_Q6_K: q6_K_to_bytes}[ttype]
            tensors.append((gname, ne, ttype, enc(arr)))

    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", MAGIC, VERSION,
                            len(tensors), len(kv)))
        for key, vtype, v in kv:
            _w_str(f, key)
            f.write(struct.pack("<I", vtype))
            _w_value(f, vtype, v)
        offset = 0
        for gname, ne, ttype, data in tensors:
            _w_str(f, gname)
            f.write(struct.pack("<I", len(ne)))
            f.write(struct.pack(f"<{len(ne)}Q", *ne))
            f.write(struct.pack("<IQ", ttype, offset))
            offset += len(data)
            offset += (-offset) % ALIGNMENT
        pos = f.tell()
        f.write(b"\x00" * ((-pos) % ALIGNMENT))
        for _, _, _, data in tensors:
            f.write(data)
            f.write(b"\x00" * ((-len(data)) % ALIGNMENT))


# ---------------------------------------------------------------------------
# Read
# ---------------------------------------------------------------------------

def read_gguf(path: str | Path, *, dequant: bool = False):
    """Parse a GGUF BERT file -> (state_dict, BertConfig, metadata dict).

    state_dict maps HF names to f32 arrays (or QuantizedTensor in the
    ggml [K, N] orientation for quantized 2-D weights when dequant=False
    — ready for ggml_io.build_params_from_sd). metadata holds the raw KV
    pairs (tokenizer.ggml.tokens etc.).
    """
    with open(path, "rb") as f:
        magic, version, n_tensors, n_kv = struct.unpack("<IIQQ", f.read(24))
        if magic != MAGIC:
            raise ValueError(f"bad GGUF magic {magic:#x}")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        meta: dict[str, Any] = {}
        for _ in range(n_kv):
            key = _r_str(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            meta[key] = _r_value(f, vtype)
        arch = meta.get("general.architecture", "bert")
        if arch not in ("bert", "nomic-bert", "nomic-bert-moe",
                        "jina-bert-v2"):
            # other encoder arches would silently produce wrong
            # embeddings through this forward — refuse instead
            raise ValueError(
                f"unsupported GGUF architecture {arch!r} (supported: "
                f"bert, nomic-bert (RoPE), nomic-bert-moe (RoPE+MoE), "
                f"jina-bert-v2 (ALiBi))")
        infos = []
        for _ in range(n_tensors):
            tname = _r_str(f)
            (n_dims,) = struct.unpack("<I", f.read(4))
            ne = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
            ttype, offset = struct.unpack("<IQ", f.read(12))
            infos.append((tname, ne, ttype, offset))
        align = int(meta.get("general.alignment", ALIGNMENT))
        pos = f.tell()
        data_start = pos + ((-pos) % align)

        sd: dict[str, Any] = {}
        for tname, ne, ttype, offset in infos:
            hf_name = gguf_to_hf_name(tname)
            if hf_name is None:
                continue  # pooler etc.
            f.seek(data_start + offset)
            raw = f.read(_tensor_nbytes(ttype, ne))
            shape = tuple(int(x) for x in ne[::-1])  # numpy shape
            if ttype == GGML_F32:
                sd[hf_name] = np.frombuffer(raw, "<f4").reshape(
                    shape).astype(np.float32)
            elif ttype == GGML_F16:
                sd[hf_name] = np.frombuffer(raw, "<f2").reshape(
                    shape).astype(np.float32)
            elif ttype in (GGML_Q4_K, GGML_Q5_K, GGML_Q6_K):
                # K-quants dequantize to dense f32 on load (no native
                # K-quant kernel; load_model(dtype=...) re-quantizes to
                # the engine's Q4_0/Q8_0 kernels when asked)
                K = int(ne[0])
                R = int(np.prod(ne[1:])) if len(ne) > 1 else 1
                dec = {GGML_Q4_K: q4_K_from_bytes,
                       GGML_Q5_K: q5_K_from_bytes,
                       GGML_Q6_K: q6_K_from_bytes}[ttype]
                sd[hf_name] = dec(raw, R, K).reshape(shape)
            elif ttype in (GGML_Q4_0, GGML_Q4_1, GGML_Q8_0):
                K = int(ne[0])
                R = int(np.prod(ne[1:])) if len(ne) > 1 else 1
                if ttype == GGML_Q4_0:
                    codes, d = q4_0_from_bytes(raw, R, K)
                    qt = Q.QuantizedTensor(_j(codes.T), _j(d.T), None,
                                           "q4_0", -2)
                elif ttype == GGML_Q8_0:
                    codes, d = q8_0_from_bytes(raw, R, K)
                    qt = Q.QuantizedTensor(_j(codes.T), _j(d.T), None,
                                           "q8_0", -2)
                else:
                    codes, d, m = q4_1_from_bytes(raw, R, K)
                    qt = Q.QuantizedTensor(_j(codes.T), _j(d.T), _j(m.T),
                                           "q4_1", -2)
                if (dequant or ".qkv." in hf_name or ".moe." in hf_name
                        or hf_name.startswith("classifier.")):
                    # fused nomic Wqkv must split into q/k/v below,
                    # MoE router/expert stacks load dense (experts are
                    # never run quantized, models/params.quantize_params),
                    # and classifier-head tensors stay dense (tiny; the
                    # stacked-quant installer only covers layer weights)
                    # — f32 (load_model(dtype=...) re-quantizes)
                    sd[hf_name] = Q.dequantize(qt).numpy().T.reshape(shape)
                else:
                    sd[hf_name] = qt  # [K, R] = transposed vs HF
            else:
                raise ValueError(
                    f"unsupported ggml tensor type {ttype} ({tname})")

    # nomic-bert fused Wqkv: split thirds along the output axis (HF
    # [out, in] orientation; llama.cpp stacks q|k|v like nomic's torch
    # checkpoint, models/params._translate_nomic)
    for k in [k for k in sd if ".attention.self.qkv." in k]:
        v = sd[k]
        third = v.shape[0] // 3
        for j, nm in enumerate(("query", "key", "value")):
            sd[k.replace(".qkv.", f".{nm}.")] = v[j * third:(j + 1) * third]
        del sd[k]
    # nomic-bert-moe expert stacks -> HF NomicExpertMLP w1/w2 layout
    # (what params._build_moe_layers consumes). ggml ne for ffn_up_exps
    # is {n_embd, n_ff, n_expert} -> numpy [E, I, D] (rows are expert
    # output neurons, applied as x @ w1_e.T — identical to HF w1);
    # ffn_down_exps is {n_ff, n_embd, n_expert} -> numpy [E, D, I],
    # the per-expert transpose of HF w2 (h @ w2_e).
    for k in [k for k in sd if ".moe.up_exps." in k
              or ".moe.down_exps." in k]:
        v = np.asarray(sd[k])
        del sd[k]
        if ".up_exps." in k:
            Ex, I, D = v.shape
            sd[k.replace(".up_exps.weight", ".w1")] = v.reshape(Ex * I, D)
        else:
            Ex, D, I = v.shape
            sd[k.replace(".down_exps.weight", ".w2")] = \
                np.ascontiguousarray(v.transpose(0, 2, 1)).reshape(
                    Ex * I, D)
    if arch != "bert":
        # biasless tensors (jina gated_layers, nomic variants):
        # synthesize zeros so the shared stacking code stays uniform
        def _out_dim(v) -> int:
            if isinstance(v, Q.QuantizedTensor):
                return int(v.shape[-1])        # ggml [K, N] orientation
            return int(v.shape[0])             # HF [out, in] / [out]

        for k in [k for k in sd if k.endswith(".weight")
                  and not k.endswith("_embeddings.weight")]:
            sd.setdefault(k[:-len("weight")] + "bias",
                          np.zeros(_out_dim(sd[k]), np.float32))

    p = arch
    arch_over: dict[str, Any] = {}
    if arch == "nomic-bert":
        arch_over = dict(
            position_embedding_type="rotary",
            rotary_base=float(meta.get(f"{p}.rope.freq_base", 1000.0)),
            hidden_act="silu")
    elif arch == "nomic-bert-moe":
        # nomic-embed-text-v2-moe: rotary like nomic-bert, ungated GELU
        # FFNs, MoE every 2nd layer (llama.cpp LLM_ARCH_NOMIC_BERT_MOE:
        # il % moe_every_n_layers == 1 -> build_moe_ffn, GELU)
        arch_over = dict(
            position_embedding_type="rotary",
            rotary_base=float(meta.get(f"{p}.rope.freq_base", 1000.0)),
            hidden_act="gelu",
            num_experts=int(meta.get(f"{p}.expert_count", 8)),
            moe_top_k=int(meta.get(f"{p}.expert_used_count", 2)),
            moe_every_n_layers=int(
                meta.get(f"{p}.moe_every_n_layers", 2)))
    elif arch == "jina-bert-v2":
        arch_over = dict(position_embedding_type="alibi",
                         hidden_act="gelu")
    if any(".intermediate.gate." in k for k in sd):
        arch_over["gated_mlp"] = True
    required = [f"{p}.embedding_length", f"{p}.block_count",
                f"{p}.feed_forward_length"]
    missing = [k for k in required if k not in meta]
    if missing:
        raise ValueError(f"GGUF file is missing required {arch} "
                         f"hparams: {missing}")
    n_head = int(meta.get(f"{p}.attention.head_count", 12))
    config = BertConfig(
        vocab_size=int(meta.get(f"{p}.vocab_size",
                                len(meta.get("tokenizer.ggml.tokens", []))
                                or 30522)),
        hidden_size=int(meta[f"{p}.embedding_length"]),
        num_hidden_layers=int(meta[f"{p}.block_count"]),
        num_attention_heads=n_head,
        intermediate_size=int(meta[f"{p}.feed_forward_length"]),
        max_position_embeddings=int(meta.get(f"{p}.context_length", 512)),
        layer_norm_eps=float(
            meta.get(f"{p}.attention.layer_norm_epsilon", 1e-12)),
        # llama.cpp pooling_type enum: 1=mean, 2=cls (0=none -> our mean
        # default, matching the reference's mean-pool-everything)
        pooling={2: "cls"}.get(int(meta.get(f"{p}.pooling_type", 1)),
                               "mean"),
        **arch_over,
    )
    return sd, config, meta


def _j(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _tokenizer_from_gguf(meta: dict):
    """Build the right tokenizer for a GGUF's tokenizer.ggml.model:

    - "bert" (or absent): WordPiece — BERT/MiniLM/BGE files
    - "t5": sentencepiece Unigram — XLM-R-voc files (multilingual-e5,
      bge-m3, nomic-embed-text-v2-moe); the exact Precompiled charsmap
      normalizer is applied when the file carries one
    - "gpt2": byte-level BPE — RoBERTa/jina/Qwen2-voc files, with the
      pre-tokenizer regex picked from tokenizer.ggml.pre
    """
    model = meta.get("tokenizer.ggml.model", "bert")
    tokens = meta.get("tokenizer.ggml.tokens")
    if not tokens:
        raise ValueError("GGUF file has no tokenizer.ggml.tokens")
    if model in ("t5", "unigram"):
        from ..tokenizer.unigram import UnigramTokenizer, _parse_charsmap
        scores = meta.get("tokenizer.ggml.scores") or [0.0] * len(tokens)
        unk = int(meta.get("tokenizer.ggml.unknown_token_id", 0))
        norm = "nfkc"
        blob = meta.get("tokenizer.ggml.precompiled_charsmap")
        if blob:
            if not isinstance(blob, (bytes, bytearray)):
                blob = bytes(int(b) & 0xFF for b in blob)
            op = _parse_charsmap(bytes(blob), "gguf")
            if op is not None:
                norm = [op]
        return UnigramTokenizer(
            list(zip(tokens, (float(s) for s in scores))), unk_id=unk,
            normalizer=norm)
    if model == "gpt2":
        from ..tokenizer.bpe import (_GPT2_PATTERN, _QWEN2_PATTERN,
                                     ByteLevelBPETokenizer)
        merges = [tuple(m.split(" ", 1))
                  for m in meta.get("tokenizer.ggml.merges", [])]
        pre = meta.get("tokenizer.ggml.pre", "gpt-2")
        pattern = _QWEN2_PATTERN if "qwen" in pre else _GPT2_PATTERN
        return ByteLevelBPETokenizer(
            {t: i for i, t in enumerate(tokens)}, merges, pattern=pattern)
    if model not in ("bert", "wordpiece"):
        raise ValueError(f"unsupported tokenizer.ggml.model {model!r} "
                         f"(supported: bert, t5, gpt2)")
    from ..tokenizer import WordPieceTokenizer, WordPieceVocab
    return WordPieceTokenizer(WordPieceVocab.from_tokens(tokens))


def load_gguf_model(path: str | Path):
    """.gguf -> (params pytree, BertConfig, tokenizer)."""
    import dataclasses
    from .ggml_io import build_params_from_sd
    sd, config, meta = read_gguf(path, dequant=False)
    tok = _tokenizer_from_gguf(meta)
    ids = {}
    for key, field in (("unknown_token_id", "unk_token_id"),
                       ("padding_token_id", "pad_token_id"),
                       ("cls_token_id", "cls_token_id"),
                       ("bos_token_id", "cls_token_id"),
                       ("seperator_token_id", "sep_token_id"),
                       ("separator_token_id", "sep_token_id"),
                       ("eos_token_id", "sep_token_id")):
        v = meta.get(f"tokenizer.ggml.{key}")
        if v is not None:
            ids.setdefault(field, int(v))
    config = dataclasses.replace(config, **ids)
    params = build_params_from_sd(sd, config)
    return params, config, tok
