"""ALiBi (Attention with Linear Biases) head slopes — the PyTorch port's
own copy of ``embeddings_tpu/ops/alibi.py``.

The jina-bert-v2 family replaces BERT's learned position table with a
symmetric penalty on the attention logits: ``bias[h, i, j] = -slope_h *
|i - j|``. Slopes follow the ALiBi paper's geometric schedule: for ``n`` a
power of two, ``slope_i = 2^(-8(i+1)/n)``; otherwise the closest lower
power of two's schedule is extended with every other slope of the ``2n``
schedule (Press et al., "Train Short, Test Long", ICLR 2022).
"""

from __future__ import annotations

import math


def alibi_slopes(n_heads: int) -> list[float]:
    """Per-head ALiBi slopes, in head order, as Python floats."""

    def pow2(n: int) -> list[float]:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if n_heads < 1:
        raise ValueError(f"n_heads must be >= 1, got {n_heads}")
    if math.log2(n_heads).is_integer():
        return pow2(n_heads)
    closest = 2 ** math.floor(math.log2(n_heads))
    return (pow2(closest)
            + alibi_slopes(2 * closest)[0::2][: n_heads - closest])
