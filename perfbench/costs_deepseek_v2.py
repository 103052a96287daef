"""The yardstick's arithmetic for DeepSeek-V2 (MLA and its experts): the
operations of a whole forward, and the operations and bytes of one launch
of the MLA attention kernel. ``costs.py``'s ``model_flops`` and
``attention_cost`` are BERT's; the peaks and ``bound_ms`` are shared.

``widths`` is the reference's ``widths`` of the configuration.
"""

from __future__ import annotations

from typing import Iterable


def token_flops(widths: dict) -> dict[str, float]:
    """Operations a token needs outside attention's pairs, in multiply-
    adds counted twice: MLA's projections a layer (q, kv_a, kv_b, o), a
    leading dense SwiGLU layer's FFN, and an MoE layer's router, top-k
    routed SwiGLU experts and shared SwiGLU."""
    E, H = widths["hidden_size"], widths["num_attention_heads"]
    dn, dr, dv = (widths["qk_nope_head_dim"], widths["qk_rope_head_dim"],
                  widths["v_head_dim"])
    r, F, I = (widths["kv_lora_rank"], widths["intermediate_size"],
               widths["moe_intermediate_size"])
    Ex, k, ns = (widths["num_experts"], widths["moe_top_k"],
                 widths["n_shared_experts"])
    mla = 2.0 * (E * H * (dn + dr) + E * (r + dr) + r * H * (dn + dv)
                 + H * dv * E)
    return {"mla_projections": mla,
            "dense_ffn": 2.0 * 3 * E * F,
            "moe_ffn": 2.0 * (E * Ex + k * 3 * E * I + 3 * E * ns * I)}


def pair_flops(widths: dict) -> float:
    """Operations of one (query, key) pair of one layer over every head:
    the scores' dot (q and k heads nope + rope wide) and the product with
    v."""
    H = widths["num_attention_heads"]
    Dq = widths["qk_nope_head_dim"] + widths["qk_rope_head_dim"]
    return 2.0 * H * (Dq + widths["v_head_dim"])


def causal_pairs(n: int) -> int:
    """(query, key) pairs of a causal row of n tokens: n(n+1)/2."""
    return n * (n + 1) // 2


def model_flops(lengths: Iterable[int], widths: dict) -> float:
    """The operations a forward needs for these sequences' real tokens
    at the model's published widths (no padding): every layer's MLA
    projections and causal pairs, the leading dense layers' FFN and the
    MoE layers' FFN."""
    t = token_flops(widths)
    NL = widths["num_hidden_layers"]
    k = widths["first_k_dense_replace"]
    per_token = (NL * t["mla_projections"] + k * t["dense_ffn"]
                 + (NL - k) * t["moe_ffn"])
    pf = pair_flops(widths)
    return sum(n * per_token + NL * pf * causal_pairs(n) for n in lengths)


def mla_attention_cost(lengths: Iterable[int], B: int,
                       widths: dict) -> tuple[float, float]:
    """(flops, bytes) of one MLA kernel launch over one layer of a
    forward: the causal pairs of each sequence's own tokens, and each
    operand read once: the real rows of the bf16 q | k | v (H * (2 Dq +
    dv) wide), the real rows of the bf16 context written (H * dv), the
    [B] int32 lengths."""
    lengths = list(lengths)
    H = widths["num_attention_heads"]
    Dq = widths["qk_nope_head_dim"] + widths["qk_rope_head_dim"]
    dv = widths["v_head_dim"]
    rows = sum(lengths)
    flops = pair_flops(widths) * sum(causal_pairs(n) for n in lengths)
    nbytes = rows * H * (2 * Dq + dv) * 2 + rows * H * dv * 2 + 4 * B
    return flops, float(nbytes)
