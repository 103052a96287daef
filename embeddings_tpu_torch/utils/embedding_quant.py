"""Output-embedding quantization for vector-database storage — a copy of
``embeddings_tpu/utils/embedding_quant.py`` (numpy only).

Embedding stores routinely hold int8 or binary vectors (4x / 32x
smaller indexes, Hamming pre-ranking); SentenceTransformers exposes
this as ``encode(..., precision=...)``. This module mirrors those
semantics for the engine/server output path:

- ``int8`` / ``uint8``: per-dimension affine quantization against
  calibration ranges (min/max per dim). Ranges come from an explicit
  ``ranges`` array or are calibrated from the batch itself (fine for
  one-shot corpus encodes; persist ranges for incremental indexing).
- ``binary`` / ``ubinary``: sign bits packed 8-per-byte (int8 offset
  -128 for ``binary``, matching SentenceTransformers), for
  Hamming-distance search.

Quantization here is lossy compression of the OUTPUT vectors — unlike
the weight quantization in ``ops/quant.py`` it never touches the model.
"""

from __future__ import annotations

import numpy as np

PRECISIONS = ("float32", "int8", "uint8", "binary", "ubinary")


def calibration_ranges(embeddings: np.ndarray) -> np.ndarray:
    """[2, dim] per-dimension (min, max) over a calibration set."""
    e = np.asarray(embeddings, np.float32)
    return np.stack([e.min(axis=0), e.max(axis=0)])


def quantize_embeddings(embeddings: np.ndarray, precision: str,
                        ranges: np.ndarray | None = None) -> np.ndarray:
    """Quantize [N, dim] float embeddings to the requested precision.

    int8/uint8 use ``ranges`` ([2, dim]; defaults to per-batch
    calibration). binary returns int8 in {-128, 127} bit-packed to
    [N, dim/8] (+pad); ubinary the same as uint8 bytes.
    """
    e = np.asarray(embeddings, np.float32)
    if precision == "float32":
        return e
    if precision in ("int8", "uint8"):
        if ranges is None:
            ranges = calibration_ranges(e)
        lo, hi = np.asarray(ranges, np.float32)
        span = np.maximum(hi - lo, 1e-12)
        x = (e - lo) / span                       # [0, 1]
        if precision == "uint8":
            return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
        return np.clip(np.rint(x * 255.0) - 128, -128, 127).astype(np.int8)
    if precision in ("binary", "ubinary"):
        bits = np.packbits((e > 0).astype(np.uint8), axis=-1)
        if precision == "ubinary":
            return bits
        return (bits.astype(np.int16) - 128).astype(np.int8)
    raise ValueError(f"precision must be one of {PRECISIONS}, "
                     f"got {precision!r}")


def hamming_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distances between packed binary embeddings
    ([N, B] x [M, B] uint8/int8 from quantize_embeddings) -> [N, M]."""
    au = np.asarray(a).astype(np.int16).astype(np.uint8)
    bu = np.asarray(b).astype(np.int16).astype(np.uint8)
    x = au[:, None, :] ^ bu[None, :, :]
    return np.unpackbits(x, axis=-1).sum(-1)
