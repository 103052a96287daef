"""Rotary position embeddings (RoPE) — the port of
``embeddings_tpu/ops/rotary.py`` (ModernBERT, nomic-bert, RoFormer) —
and YaRN's scaled frequencies (DeepSeek-V2's MLA, the port's own).

Each head's query and key vectors are rotated pairwise by angles that
depend on the position, so there is no position table. Two pairing
conventions exist:

- interleaved (RoFormer, GPT-J): pairs (x0, x1), (x2, x3), ...
- half-split (GPT-NeoX, nomic-bert, ModernBERT): pairs (x0, x_{D/2}), ...

The rotation is elementwise, so it is plain torch code: the JAX package
leaves it to XLA too, outside any Pallas kernel. The tables follow the
JAX package's f32 order (``inv_freq = base ** (-arange(half) / half)``,
``ang = pos * inv_freq``) and are built on the CPU: XLA's f32 power is
correctly rounded at these sizes, so the power is taken in f64 and
rounded once, which gives its bits; at positions near 8,192 one ulp of
``inv_freq`` would move an angle by 1e-3. cos and sin of the f32 angle
are likewise taken in f64 and rounded once.
"""

from __future__ import annotations

import functools
import math

import torch


def _inv_freq(dim: int, base: float) -> torch.Tensor:
    half = dim // 2
    e = -torch.arange(half, dtype=torch.float32) / half
    return (torch.tensor(float(base), dtype=torch.float64)
            ** e.double()).float()


def rope_tables(positions: torch.Tensor, dim: int, base: float = 10000.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary dimension ``dim`` (a head's D).

    positions: integer [...] ([L], or [B, L] for packed rows whose
    positions restart per segment). Returns (cos, sin), each f32
    [..., dim // 2] on the CPU: frequency j rotates pair j by
    pos * base^(-2j/dim)."""
    ang = positions.cpu().float()[..., None] * _inv_freq(dim, base)
    # cos/sin of the f32 angle taken in f64 and rounded once, so the
    # tables do not depend on which f32 cos/sin the CPU build picks (at
    # angles near 8,191 one has differed from XLA's by 1.5e-4)
    a = ang.double()
    return torch.cos(a).float(), torch.sin(a).float()


@functools.lru_cache(maxsize=32)
def _cached_tables(L: int, dim: int, base: float):
    return rope_tables(torch.arange(L), dim, base)


def rope_tables_for(L: int, dim: int, base: float, device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The tables of positions 0 .. L-1, computed once per (L, dim, base)
    on the CPU and moved to ``device``."""
    return tuple(t.to(device) for t in _cached_tables(L, dim, float(base)))


def yarn_inv_freq(dim: int, base: float, scaling: dict) -> torch.Tensor:
    """YaRN's frequencies (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``)
    for a rotated width ``dim``, f64 [dim // 2]: with f_extra_i =
    base^(-2i/dim) and f_inter_i = f_extra_i / factor, pair i takes
    f_inter_i * ramp_i + f_extra_i * (1 - ramp_i), ramp_i = clamp((i -
    low) / (high - low), 0, 1), where low = floor(corr(beta_fast)) and
    high = ceil(corr(beta_slow)), clamped to [0, dim - 1], and corr(r) =
    dim * ln(original_max_position_embeddings / (2 pi r)) / (2 ln base)."""
    factor = float(scaling["factor"])
    orig = float(scaling["original_max_position_embeddings"])

    def corr(rot: float) -> float:
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))
    low = max(math.floor(corr(float(scaling.get("beta_fast", 32)))), 0)
    high = min(math.ceil(corr(float(scaling.get("beta_slow", 1)))), dim - 1)
    if low == high:
        high += 0.001  # HF's guard against a zero-width ramp
    i = torch.arange(dim // 2, dtype=torch.float64)
    extra = float(base) ** (-2 * i / dim)
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    return extra / factor * ramp + extra * (1 - ramp)


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude factor: 0.1 * mscale * ln(scale) + 1 (1 at scale
    <= 1)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_tables(positions: torch.Tensor, dim: int, base: float,
                scaling: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """YaRN's (cos, sin) for integer ``positions`` [...] ([L], or [B, L]
    for packed rows), each f32 [..., dim // 2] on the CPU: the angle and
    its cos / sin taken in f64 and rounded once, both scaled by
    mscale(factor, mscale) / mscale(factor, mscale_all_dim).
    ``scaling``: the config's ``rope_scaling`` pairs."""
    sc = dict(scaling)
    ang = positions.cpu().double()[..., None] * yarn_inv_freq(dim, base, sc)
    f = float(sc["factor"])
    m = yarn_mscale(f, float(sc.get("mscale", 1))) / yarn_mscale(
        f, float(sc.get("mscale_all_dim", 0)))
    return (torch.cos(ang) * m).float(), (torch.sin(ang) * m).float()


@functools.lru_cache(maxsize=32)
def _yarn_cached(L: int, dim: int, base: float, scaling: tuple):
    return yarn_tables(torch.arange(L), dim, base, scaling)


def yarn_tables_for(L: int, dim: int, base: float, scaling: tuple, device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``yarn_tables`` of positions 0 .. L-1, computed once per (L, dim,
    base, scaling) on the CPU and moved to ``device``."""
    return tuple(t.to(device)
                 for t in _yarn_cached(L, dim, float(base), scaling))


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 interleaved: bool = False) -> torch.Tensor:
    """Rotate [..., L, H, D] by per-position angles, in f32, back to x's
    dtype. cos/sin are [L, D/2] or [B, L, D/2]: no head axis (one is
    inserted here so they broadcast over heads)."""
    cos = cos.to(x.device)[..., None, :]
    sin = sin.to(x.device)[..., None, :]
    xf = x.float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x.shape)
    else:
        half = x.shape[-1] // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rotary_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     H: int, D: int, interleaved: bool = False
                     ) -> torch.Tensor:
    """Rotate the q and k thirds of a fused [B, L, 3*H*D] projection (v
    passes through), keeping the [q | k | v] columns the fused attention
    kernels read."""
    B, L, _ = qkv.shape
    E = H * D
    q = apply_rotary(qkv[..., :E].reshape(B, L, H, D), cos, sin,
                     interleaved).reshape(B, L, E)
    k = apply_rotary(qkv[..., E:2 * E].reshape(B, L, H, D), cos, sin,
                     interleaved).reshape(B, L, E)
    return torch.cat([q, k, qkv[..., 2 * E:]], dim=-1)
