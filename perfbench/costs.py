"""The yardstick's arithmetic: the H100's peaks, the operations and bytes
of one launch of each hand-written kernel, and the operations of a whole
forward. A frozen copy of ``chip_smoke.py``'s ``k1_cost`` and
``bound_ms`` (and of its peaks), so that a change to the program cannot
move the bounds it is measured against.
"""

from __future__ import annotations

from typing import Iterable

# NVIDIA H100 SXM data sheet, dense rates: bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time the chip could take: the larger of the operations
    at peak and the bytes at peak bandwidth, with which of the two."""
    t_ops = flops / peak * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def k1_cost(Mx: int, K: int, N: int, epilogue: str | None,
            kind: str = "q4_0", packed: bool = True) -> tuple[float, float]:
    """(flops, bytes) of one K1 call (``csrc/qmatmul.cu``): each input
    read once, the output written once (the codes: nibbles when packed,
    else one byte each; f32 scales, q4_1's f32 mins, and the bias)."""
    codes = K // 2 * N if packed else K * N
    mins = K // 32 * N * 4 if kind == "q4_1" else 0
    nbytes = (Mx * K * 2 + codes + K // 32 * N * 4 + mins + N * 4
              + Mx * N * 2)
    if epilogue == "bias_residual_ln":
        nbytes += Mx * N * 2 + 2 * N * 4
    return 2.0 * Mx * K * N, float(nbytes)


def attention_cost(lengths: Iterable[int], hidden: int, slots: int,
                   segmented: bool) -> tuple[float, float]:
    """(flops, bytes) of one attention launch over one layer of a forward:
    the two products over the (query, key) pairs these inputs need (each
    sequence or packed segment attends within itself, pads take no
    part), and each operand read once: the real rows of the bf16 q | k | v
    projection, the real rows of the bf16 context written, and the int32
    row lengths (or, packed, the [slots] int32 segment ids)."""
    lengths = list(lengths)
    pairs = sum(n * n for n in lengths)
    rows = sum(lengths)
    meta = 4 * slots if segmented else 4 * len(lengths)
    return 4.0 * hidden * pairs, float(rows * 4 * hidden * 2 + meta)


def model_flops(lengths: Iterable[int], cfg: dict) -> float:
    """The operations a forward needs for these sequences at the model's
    published widths: per layer the q | k | v and output projections, the
    FFN (or, in a mixture-of-experts layer, the router and the top-k
    experts' two products) and attention over each sequence's own pairs.
    ``cfg`` is the configuration file's ``model``."""
    E, F = cfg["hidden_size"], cfg["intermediate_size"]
    NL = cfg["num_hidden_layers"]
    ex, k = cfg.get("num_experts", 0), cfg.get("moe_top_k", 0)
    n_moe = NL // 2 if ex else 0
    per_token_dense = 2.0 * (3 * E * E + E * E + 2 * E * F)
    per_token_moe = 2.0 * (3 * E * E + E * E + E * ex + k * 2 * E * F)
    total = 0.0
    for n in lengths:
        total += n * ((NL - n_moe) * per_token_dense
                      + n_moe * per_token_moe)
        total += NL * 4.0 * E * n * n
    return total
