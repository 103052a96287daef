"""The port's fused attention (kernel K2) against the JAX package.

``fused_attention_ref`` (the plain PyTorch version the port runs on a CPU
tensor) is held against ``embeddings_tpu.ops.attention.fused_attention``
in Pallas interpret mode on the same numpy-seeded qkv and lengths, lengths
that include 0 (an all-pad row) and the full row; at L=200 the lengths
sit on the CUDA kernel's 64-query and 128-key tile edges ({0, 1, 63, 64,
65, 127, 128, 129, L}). E is a multiple of 128, as the JAX ``supported``
rule needs (so H=2 at D=32 is not a case). f32: both compute the same
expression, differing by f32 summation order (1e-5). bf16: both round q·s2
and p to bf16 at the same points, so the output agrees to about one bf16
ulp; a probability whose f32 value sits on a bf16 rounding boundary can
round the other way, hence 2^-6 relative plus 2e-3 absolute.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.ops import attention as jattn

from embeddings_tpu_torch.ops import attention as tattn

CASES = [(3, 16, 2, 64), (2, 32, 4, 32), (2, 24, 1, 128), (2, 64, 2, 64),
         (9, 200, 4, 32), (9, 200, 2, 64)]
# lengths on the Hopper kernel's tile edges (64 queries, 128 keys)
EDGES = (0, 1, 63, 64, 65, 127, 128, 129)


def _inputs(B, L, H, D, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B * L, 3 * H * D), dtype=np.float32)
    if B == len(EDGES) + 1:
        return qkv, np.array(EDGES + (L,), np.int32)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[0] = 0
    lengths[-1] = L
    return qkv, lengths


@pytest.mark.parametrize("B,L,H,D", CASES)
def test_fused_attention_ref_matches_jax_f32(B, L, H, D):
    qkv, lengths = _inputs(B, L, H, D, seed=L + H)
    ref = np.asarray(jattn.fused_attention(
        jnp.asarray(qkv), jnp.asarray(lengths), B=B, L=L, H=H, D=D,
        interpret=True))
    got = tattn.fused_attention_ref(torch.from_numpy(qkv),
                                    torch.from_numpy(lengths),
                                    B=B, L=L, H=H, D=D)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the all-pad row is exactly zero and finite
    assert np.all(got.numpy().reshape(B, L, -1)[0] == 0)


@pytest.mark.parametrize("B,L,H,D", CASES[:2] + CASES[4:])
def test_fused_attention_ref_matches_jax_bf16(B, L, H, D):
    qkv, lengths = _inputs(B, L, H, D, seed=7)
    ref = np.asarray(jattn.fused_attention(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(lengths), B=B, L=L,
        H=H, D=D, interpret=True).astype(jnp.float32))
    got = tattn.fused_attention(torch.from_numpy(qkv).to(torch.bfloat16),
                                torch.from_numpy(lengths), B=B, L=L, H=H,
                                D=D)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -6,
                               atol=2e-3)


def test_clamp_and_supported_match_jax():
    for n in (2, 16, 100, 256, 512, 1024):
        assert tattn._clamp_hi(n) == jattn._clamp_hi(n)
    for L, H, D in [(16, 2, 64), (24, 1, 128), (20, 2, 64), (16, 1, 64),
                    (1024, 12, 64), (520, 12, 64)]:
        assert tattn.supported(L, H, D) == jattn.supported(L, H, D)


def test_fused_attention_rejects_bad_shapes():
    qkv = torch.zeros(2 * 16, 3 * 128)
    with pytest.raises(ValueError):
        tattn.fused_attention(qkv, torch.zeros(2, dtype=torch.int32),
                              B=2, L=16, H=2, D=32)   # E mismatch
    with pytest.raises(ValueError):
        tattn.fused_attention(torch.zeros(2 * 20, 3 * 128),
                              torch.zeros(2, dtype=torch.int32),
                              B=2, L=20, H=2, D=64)   # L % 8 != 0


# every (mode, emit, CP layout, int8 scores) a wrapper passes to _launch:
# K2 with and without emission (K2e) and int8 scores (K2i8), K4 with and
# without emission (K4e), K5, K7, K6 plain and ALiBi, K6w, K6c, K6ca, and
# mode 4 in the CP layout (K8a, K8b)
WRAPPER_LAUNCHES = (
    [(0, emit, False, i8s) for emit in ("no", "both", "only")
     for i8s in (False, True)]
    + [(1, emit, False, False) for emit in ("no", "both", "only")]
    + [(mode, "no", False, False) for mode in (2, 3, 4, 5, 6, 7, 8)]
    + [(4, "no", True, False)])


@pytest.mark.parametrize("D", tattn.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("mode,emit,cp,i8s", WRAPPER_LAUNCHES)
def test_attention_kernel_routes(mode, emit, cp, i8s, D):
    """The Hopper library takes every launch: modes 0-8 without emission
    (K2, K4, K5, K7, K6, K6w, K6c, K6ca), 0 and 1 with it (K2e, K4e),
    mode 0 with int8 scores under every emission (K2i8), and mode 4 in
    the CP layout (K8a, K8b)."""
    assert tattn.attention_kernel(mode, D, emit, cp, i8s) == "sm90"
    assert tattn.sm90_warpgroups(64) == 1 and tattn.sm90_warpgroups(72) == 2


@pytest.mark.parametrize("emit,shape", [("only", (512, 768)), ("both", None),
                                        ("no", None)])
def test_emit_scratch_shape(emit, shape):
    """Only "only" emission takes an f32 scratch, [B*L, H*D]."""
    assert tattn.emit_scratch_shape(2, 256, 12, 64, emit) == shape


def test_attention_kernel_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError):
        tattn.attention_kernel(9, 64)
    with pytest.raises(ValueError):  # the CP layout is mode 4's alone
        tattn.attention_kernel(0, 64, cp=True)
    with pytest.raises(ValueError):
        tattn.attention_kernel(0, 16)
    with pytest.raises(ValueError):
        tattn.attention_kernel(0, 64, "half")
    with pytest.raises(ValueError):  # int8 scores are mode 0's (K2i8)
        tattn.attention_kernel(1, 64, i8s=True)
    with pytest.raises(ValueError):  # only modes 0 and 1 emit
        tattn.attention_kernel(2, 64, "only")
