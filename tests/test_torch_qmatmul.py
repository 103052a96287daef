"""The port's fused dequant-matmul (kernel K1) against the JAX package.

``qmatmul_ref`` (the plain PyTorch version the port runs on a CPU tensor)
is held against ``embeddings_tpu.ops.qmatmul.qmatmul`` run in Pallas
interpret mode, over kind x packed x all six epilogues, on the same
numpy-seeded inputs and the same quantized codes. Both round x and the
dequantized weight to bf16 with the same steps and accumulate in f32, so
f32 outputs agree to f32 summation-order noise (tolerance 1e-5 relative
to the output scale). The CUDA kernel itself is checked on the card by
chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from embeddings_tpu.ops.quant import quantize as jax_quantize

from embeddings_tpu_torch.models.params import from_jax_params
from embeddings_tpu_torch.ops import linear as tlinear
from embeddings_tpu_torch.ops.qmatmul import (EPILOGUES, qmatmul,
                                              qmatmul_ref)

M, K, N = 16, 128, 256
KINDS = [("q4_0", False), ("q4_0", True), ("q4_1", False), ("q4_1", True),
         ("q8_0", False), ("nf4", False), ("nf4", True)]


def _inputs(kind, packed, epilogue, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    w = rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.05)
    bias = rng.standard_normal(N, dtype=np.float32) * np.float32(0.1)
    res = rng.standard_normal((M, N), dtype=np.float32)
    lns = 1.0 + rng.standard_normal(N, dtype=np.float32) * np.float32(0.1)
    lnb = rng.standard_normal(N, dtype=np.float32) * np.float32(0.1)
    qt = jax_quantize(w, kind, pack4=packed)
    extra = {}
    if epilogue == "bias_residual_ln":
        extra = dict(residual=res, ln_scale=lns, ln_bias=lnb)
    return x, qt, bias, extra


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("kind,packed", KINDS)
def test_qmatmul_ref_matches_jax_interpret(kind, packed, epilogue):
    x, qt, bias, extra = _inputs(kind, packed, epilogue)
    assert qt.packed == packed
    ref = np.asarray(jax_qmatmul(
        jnp.asarray(x), qt.codes, qt.scales, qt.mins, jnp.asarray(bias),
        kind=kind, epilogue=epilogue, packed=packed, interpret=True,
        **{k: jnp.asarray(v) for k, v in extra.items()}))
    tq = from_jax_params(qt)
    got = qmatmul_ref(torch.from_numpy(x), tq.codes, tq.scales, tq.mins,
                      torch.from_numpy(bias), kind=kind, epilogue=epilogue,
                      packed=packed,
                      **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert got.dtype == torch.float32 and got.shape == (M, N)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * scale)


def test_qmatmul_bf16_output_matches_jax():
    """bf16 x -> bf16 output: the two round the same f32 values, so they
    agree to one bf16 ulp (2^-8 relative) of the output."""
    x, qt, bias, extra = _inputs("q4_0", True, "bias_gelu", seed=1)
    ref = np.asarray(jax_qmatmul(
        jnp.asarray(x, jnp.bfloat16), qt.codes, qt.scales, qt.mins,
        jnp.asarray(bias), kind="q4_0", epilogue="bias_gelu", packed=True,
        interpret=True).astype(jnp.float32))
    tq = from_jax_params(qt)
    got = qmatmul(torch.from_numpy(x).to(torch.bfloat16), tq.codes,
                  tq.scales, tq.mins, torch.from_numpy(bias), kind="q4_0",
                  epilogue="bias_gelu", packed=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


def test_qmatmul_wrapper_routes_cpu_to_ref():
    """On a CPU tensor the wrapper runs the plain version (no launch)."""
    x, qt, bias, _ = _inputs("q4_0", True, "bias")
    tq = from_jax_params(qt)
    before = qmatmul.launches
    a = qmatmul(torch.from_numpy(x), tq.codes, tq.scales, None,
                torch.from_numpy(bias), packed=True)
    b = qmatmul_ref(torch.from_numpy(x), tq.codes, tq.scales, None,
                    torch.from_numpy(bias), packed=True)
    assert torch.equal(a, b) and qmatmul.launches == before


@pytest.mark.parametrize("opt", [dict(int8_compute=True),
                                 dict(int8_compute=True,
                                      emit_quantized="both")])
def test_qmatmul_unported_modes_raise(opt):
    """Both once-unported modes now run on a CPU tensor: the int8 mode
    as K3's plain version, and the quantized-output emission as its
    plain version (the output, its int8 rows and their scales)."""
    from embeddings_tpu_torch.ops.qmatmul import qmatmul_int8_ref
    x, qt, bias, _ = _inputs("q4_0", False, "bias")
    tq = from_jax_params(qt)
    args = (torch.from_numpy(x), tq.codes, tq.scales, None,
            torch.from_numpy(bias))
    emit = opt.get("emit_quantized", "no")
    got = qmatmul(*args, **opt)
    want = qmatmul_int8_ref(*args, emit_quantized=emit)
    if emit == "no":
        assert torch.equal(got, want)
        return
    assert len(got) == 3 and got[1].dtype == torch.int8
    assert got[2].shape == (M, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("act", [None, "gelu", "relu"])
def test_linear_plain_path_matches_jax_fallback(act):
    """use_kernels=False is the JAX package's XLA fallback: dequantize,
    f32 matmul, exact-erf GELU (f32 summation-order tolerance)."""
    import importlib
    jlin = importlib.import_module("embeddings_tpu.ops.linear")
    x, qt, bias, _ = _inputs("q4_1", True, "bias", seed=2)
    x3 = x.reshape(2, 8, K)
    ref = np.asarray(jlin.linear(jnp.asarray(x3), qt, jnp.asarray(bias),
                                 act=act))
    got = tlinear.linear(torch.from_numpy(x3), from_jax_params(qt),
                         torch.from_numpy(bias), act=act, use_kernels=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_linear_residual_ln_matches_jax_interpret():
    """The fused residual + LayerNorm route (K1's plain version) against
    the JAX kernel in interpret mode, through the linear wrappers."""
    import importlib
    jlin = importlib.import_module("embeddings_tpu.ops.linear")
    x, qt, bias, extra = _inputs("q4_0", True, "bias_residual_ln", seed=3)
    ref = np.asarray(jlin.linear_residual_ln(
        jnp.asarray(x), qt, jnp.asarray(bias),
        jnp.asarray(extra["residual"]), jnp.asarray(extra["ln_scale"]),
        jnp.asarray(extra["ln_bias"]), 1e-12, interpret=True))
    got = tlinear.linear_residual_ln(
        torch.from_numpy(x), from_jax_params(qt), torch.from_numpy(bias),
        torch.from_numpy(extra["residual"]),
        torch.from_numpy(extra["ln_scale"]),
        torch.from_numpy(extra["ln_bias"]), 1e-12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * 4)


# K1's tile (``k1_tile``) on an H100's 132 SMs at every K1 shape the
# families' main paths launch: (M, N, epilogue) -> (BM, cluster size).
# bge-base / MPNet / jina / packed at 32,768 tokens, ModernBERT's plain
# epilogues, Qwen2 at 16,384 slots (k and v: N = 256, too few tiles for
# 256 rows), bge-large's LayerNorm at N = 1,024, and context parallelism's
# shards (bge: M = 16 x 256; nomic: M = 4 x 512), where BM = 128 fills the
# card.
K1_TILES = [
    (32768, 2304, "bias", (256, 1)), (32768, 768, "bias_residual_ln",
                                      (256, 6)),
    (32768, 3072, "bias_gelu", (256, 1)), (32768, 3072, "bias", (256, 1)),
    (32768, 1536, "bias_residual_ln", (128, 12)),
    (32768, 768, "bias", (256, 1)), (32768, 1152, "bias_gelu", (256, 1)),
    (32768, 1152, "bias", (256, 1)), (16384, 1536, "bias", (256, 1)),
    (16384, 256, "bias", (128, 1)), (16384, 8960, "bias_silu", (256, 1)),
    (16384, 8960, "bias", (256, 1)), (32768, 1024, "bias_residual_ln",
                                      (256, 8)),
    (4096, 2304, "bias", (256, 1)), (4096, 768, "bias_residual_ln", (128, 6)),
    (4096, 3072, "bias_gelu", (256, 1)), (2048, 2304, "bias", (128, 1)),
    (2048, 768, "bias_residual_ln", (128, 6)), (2048, 3072, "bias",
                                                (128, 1)),
    (40, 136, "bias_residual_ln", (128, 2)), (40, 136, "none", (128, 1))]


@pytest.mark.parametrize("M,N,epilogue,want", K1_TILES)
def test_k1_tile_choice(M, N, epilogue, want):
    from embeddings_tpu_torch.ops.qmatmul import k1_route, k1_tile
    assert k1_tile(M, N, epilogue, 132) == want
    bm, cs = want
    assert k1_route(M, N, epilogue, 132) == (
        f"bm{bm}_cluster{cs}" if epilogue == "bias_residual_ln"
        else f"bm{bm}")


def test_k1_tile_refuses_rows_past_one_cluster():
    """A residual-LayerNorm row over 16 x 128 columns is refused by name;
    2,048 columns is one cluster of 16 blocks, of 128 rows (past 8 blocks
    a block of 256 rows does not fit shared memory)."""
    from embeddings_tpu_torch.ops.qmatmul import k1_tile
    assert k1_tile(32768, 2048, "bias_residual_ln", 132) == (128, 16)
    with pytest.raises(ValueError, match="at most 2048 columns"):
        k1_tile(32768, 2056, "bias_residual_ln", 132)
    assert k1_tile(32768, 2056, "bias", 132) == (256, 1)
