"""The port's logit-biased (K7) and key-streamed (K6) attention against the
JAX package.

``fused_attention_bias_ref`` and ``fused_attention_stream_ref`` (the plain
PyTorch versions the port runs on a CPU tensor) are held against
``embeddings_tpu.ops.attention.fused_attention_bias`` and
``fused_attention_stream`` in Pallas interpret mode on the same
numpy-seeded qkv and lengths (an all-pad row, ragged rows, a full row).
K7 takes an MPNet-like table bias and ALiBi's bias, also at L=200 and
L=384 with lengths on the Hopper kernel's tile edges (128 queries, 128
keys); K6 its plain and ALiBi modes at BK 128, 256 and 512, and at L=384
with lengths on the CUDA kernel's 128-key tile edges ({0, 1, 63, 64, 65,
127, 128, 129, L}). Each side builds its own bias operand from
the same [1, H, L, L] array (the port's layout is [H, L, L], the TPU's
[nQ, H, Lq, L]): the outputs are compared, not the operand.

Tolerances: f32 max abs 1e-5 at unit-scale inputs (the same expression,
differing by f32 summation order and, for ALiBi, by whether the
multiply-subtract is contracted). bf16: both round p to bf16 at the same
point, so one bf16 ulp; a probability on a rounding boundary may flip,
hence 2^-6 relative + 2e-3 absolute, as K2's test.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.models import bert as jbert
from embeddings_tpu.ops import attention as jattn
from embeddings_tpu.ops.alibi import alibi_slopes as jax_slopes

from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.ops.alibi import alibi_slopes


# lengths on the Hopper kernel's tile edges (128 keys)
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


def _bias(kind, L, H, seed):
    """[1, H, L, L] f32: a random table bias (MPNet-like scale) or ALiBi."""
    if kind == "table":
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((1, H, L, L), dtype=np.float32)
                * np.float32(2.0))
    slopes = jnp.asarray(jax_slopes(H), jnp.float32)
    return np.array(jbert.alibi_attention_bias(slopes, jnp.arange(L)[None]))


def _jax_bias(qkv, lengths, bias, B, L, H, D, dtype):
    b4 = jattn.prepare_attention_bias(jnp.asarray(bias), L)
    out = jattn.fused_attention_bias(
        jnp.asarray(qkv, dtype), jnp.asarray(lengths), b4, B=B, L=L, H=H,
        D=D, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port_bias(qkv, lengths, bias, B, L, H, D, dtype):
    tb = tattn.prepare_attention_bias(torch.from_numpy(bias), L)
    assert tuple(tb.shape) == (H, L, L) and tb.dtype == torch.float32
    out = tattn.fused_attention_bias(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(lengths), tb,
        B=B, L=L, H=H, D=D)
    assert out.dtype == dtype
    return out.float().numpy()


# the last three: 9 rows (lengths EDGES and L) at the Hopper kernel's
# edges, L=200 (ragged, under two 128-row query blocks) and L=384
K7_CASES = [(3, 16, 2, 64), (2, 32, 4, 32), (2, 24, 1, 128),
            (2, 384, 1, 128), (9, 200, 2, 64), (9, 384, 2, 64),
            (9, 384, 4, 32)]


@pytest.mark.parametrize("kind", ["table", "alibi"])
@pytest.mark.parametrize("B,L,H,D", K7_CASES)
def test_bias_ref_matches_jax_f32(B, L, H, D, kind):
    qkv, lengths = _inputs(B, L, H, D, seed=L + H)
    bias = _bias(kind, L, H, seed=L)
    ref = _jax_bias(qkv, lengths, bias, B, L, H, D, jnp.float32)
    got = _port_bias(qkv, lengths, bias, B, L, H, D, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.all(got.reshape(B, L, -1)[0] == 0)  # the all-pad row


@pytest.mark.parametrize("kind", ["table", "alibi"])
@pytest.mark.parametrize("B,L,H,D", K7_CASES[:2])
def test_bias_ref_matches_jax_bf16(B, L, H, D, kind):
    qkv, lengths = _inputs(B, L, H, D, seed=7)
    bias = _bias(kind, L, H, seed=8)
    ref = _jax_bias(qkv, lengths, bias, B, L, H, D, jnp.bfloat16)
    got = _port_bias(qkv, lengths, bias, B, L, H, D, torch.bfloat16)
    np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2e-3)


def _jax_stream(qkv, lengths, B, L, H, D, BK, alibi, dtype):
    out = jattn.fused_attention_stream(
        jnp.asarray(qkv, dtype), jnp.asarray(lengths), B=B, L=L, H=H, D=D,
        BK=BK, alibi_slopes=tuple(jax_slopes(H)) if alibi else None,
        interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port_stream(qkv, lengths, B, L, H, D, BK, alibi, dtype):
    slopes = (torch.tensor(alibi_slopes(H), dtype=torch.float32) if alibi
              else None)
    out = tattn.fused_attention_stream(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(lengths), B=B,
        L=L, H=H, D=D, BK=BK, alibi_slopes=slopes)
    assert out.dtype == dtype
    return out.float().numpy()


K6_CASES = [(2, 512, 2, 64, 128), (2, 512, 2, 64, 256),
            (2, 512, 2, 64, 512), (3, 256, 4, 32, 128),
            (2, 256, 1, 128, 256), (9, 384, 4, 32, 128),
            (9, 384, 2, 64, 128)]


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("B,L,H,D,BK", K6_CASES)
def test_stream_ref_matches_jax_f32(B, L, H, D, BK, alibi):
    qkv, lengths = _inputs(B, L, H, D, seed=L + BK)
    ref = _jax_stream(qkv, lengths, B, L, H, D, BK, alibi, jnp.float32)
    got = _port_stream(qkv, lengths, B, L, H, D, BK, alibi, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.all(got.reshape(B, L, -1)[0] == 0)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("B,L,H,D,BK", [K6_CASES[0], K6_CASES[3],
                                        K6_CASES[6]])
def test_stream_ref_matches_jax_bf16(B, L, H, D, BK, alibi):
    qkv, lengths = _inputs(B, L, H, D, seed=11)
    ref = _jax_stream(qkv, lengths, B, L, H, D, BK, alibi, jnp.bfloat16)
    got = _port_stream(qkv, lengths, B, L, H, D, BK, alibi, torch.bfloat16)
    np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2e-3)


def test_stream_ref_is_the_whole_row_math():
    """Walking key blocks changes nothing but f32 summation order: the
    plain K6 at BK 128 equals the unblocked ALiBi math (the plain K7 with
    the same ALiBi bias, which scales and adds in the other order) to f32
    noise, and is independent of BK."""
    B, L, H, D = 2, 512, 4, 32
    qkv, lengths = _inputs(B, L, H, D, seed=3)
    a = _port_stream(qkv, lengths, B, L, H, D, 128, True, torch.float32)
    b = _port_stream(qkv, lengths, B, L, H, D, 512, True, torch.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    bias = _bias("alibi", L, H, 0)
    tb = tattn.prepare_attention_bias(torch.from_numpy(bias), L)
    c = tattn.fused_attention_bias_ref(
        torch.from_numpy(qkv), torch.from_numpy(lengths), tb, B=B, L=L, H=H,
        D=D).numpy()
    np.testing.assert_allclose(a, c, rtol=0, atol=1e-5)


def test_shape_rules_match_jax():
    for L in (16, 24, 128, 256, 384, 512, 640, 1024, 1280, 1408, 1536,
              1792, 1877, 1920, 2048, 4096, 8192):
        assert tattn._query_block_bias(L) == jattn._query_block_bias(L)
        assert tattn.pick_bk(L) == jattn.pick_bk(L)
        for E in (128, 384, 512, 768, 1024):
            assert tattn.whole_row_fits(L, E) == jattn.whole_row_fits(L, E)
        for H, D in ((1, 128), (2, 64), (4, 32), (12, 64), (16, 64),
                     (3, 32)):
            assert tattn.bias_supported(L, H, D) == \
                jattn.bias_supported(L, H, D), (L, H, D)
            for BK in (128, 256, 512):
                assert tattn.stream_supported(L, H, D, BK) == \
                    jattn.stream_supported(L, H, D, BK), (L, H, D, BK)
    # the port's kernel is built for D in (32, 64, 128) only
    assert jattn.stream_supported(256, 8, 16, 128)
    assert not tattn.stream_supported(256, 8, 16, 128)


def test_wrappers_reject_bad_operands():
    qkv = torch.zeros(2 * 128, 3 * 128)
    lens = torch.full((2,), 128, dtype=torch.int32)
    with pytest.raises(ValueError):   # bias not [H, L, L]
        tattn.fused_attention_bias(qkv, lens, torch.zeros(2, 128, 64),
                                   B=2, L=128, H=2, D=64)
    with pytest.raises(ValueError):   # past the JAX package's bias cap
        tattn.fused_attention_bias(
            torch.zeros(4096, 3 * 768), torch.ones(1, dtype=torch.int32),
            torch.zeros(12, 4096, 4096), B=1, L=4096, H=12, D=64)
    with pytest.raises(ValueError):   # L % BK != 0
        tattn.fused_attention_stream(qkv, lens, B=2, L=128, H=2, D=64,
                                     BK=256)
    with pytest.raises(ValueError):   # one slope per head
        tattn.fused_attention_stream(qkv, lens, B=2, L=128, H=2, D=64,
                                     BK=128, alibi_slopes=[0.5])
    with pytest.raises(ValueError):
        tattn.prepare_attention_bias(torch.zeros(2, 2, 16, 16), 16)


def test_port_bias_builders_match_jax():
    """The port's ALiBi and MPNet bias arrays equal the JAX package's, for
    0..L-1 and for packed rows whose positions restart per segment."""
    from embeddings_tpu.config import BertConfig as JaxConfig
    from embeddings_tpu_torch.config import BertConfig
    H = 12
    pos = np.array([[0, 1, 2, 3, 0, 1, 2, 0], [0, 1, 2, 3, 4, 5, 6, 7]],
                   np.int32)
    pos1 = np.arange(300, dtype=np.int32)[None]
    slopes = np.asarray(jax_slopes(H), np.float32)
    table = np.random.default_rng(0).standard_normal((32, H),
                                                     dtype=np.float32)
    kw = dict(relative_attention_num_buckets=32)
    for p in (pos, pos1):
        want = np.asarray(jbert.alibi_attention_bias(jnp.asarray(slopes),
                                                     jnp.asarray(p)))
        got = tbert.alibi_attention_bias(torch.from_numpy(slopes),
                                         torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.asarray(jbert.relative_attention_bias(
            jnp.asarray(table), jnp.asarray(p), JaxConfig(**kw)))
        got = tbert.relative_attention_bias(
            torch.from_numpy(table), torch.from_numpy(p),
            BertConfig(**kw)).numpy()
        np.testing.assert_array_equal(got, want)
