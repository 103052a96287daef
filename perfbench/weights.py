"""Seeded random weights under a checkpoint's own tensor names, made on the
device in three large draws (one for the matrices, one for the biases,
one for the LayerNorms), as float32: what the configuration's loader
reads from a checkpoint before it quantizes. The same seed gives the same
tensors on every run, so the reference can make them again after the
window instead of holding them through it.
"""

from __future__ import annotations

import math

import torch

STD = 0.02  # the families' initializer_range


def make(spec: list, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for a ``checkpoint_spec``:
    matrices N(0, 0.02), biases N(0, 0.02), LayerNorm scales 1 + N(0,
    0.05) and shifts N(0, 0.02)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    out: dict[str, torch.Tensor] = {}
    for kinds, scale, shift in ((("matrix",), STD, 0.0),
                                (("bias", "ln_bias"), STD, 0.0),
                                (("ln_scale",), 0.05, 1.0)):
        group = [(n, s) for n, s, k in spec if k in kinds]
        total = sum(math.prod(s) for _, s in group)
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=torch.float32)
        flat.mul_(scale).add_(shift)
        at = 0
        for name, shape in group:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape)
            at += n
    return out
