"""K3 on Hopper (the int8 mode as an int8 instantiation of K1's kernel)
against the JAX package, on the CPU.

(a) The int8 weight K3 keeps per weight (``keep_int8_weight``: w8t [N, K]
    int8, cs [N] f32, per layer of a stack) equals ``requantize_weight``'s
    (w8, cs) bit for bit, and so a numpy recomputation from the JAX
    package's ``dequantize``: every kind, packed and not. The Engine in
    int8 mode keeps one on every matmul weight it builds; the layer
    slices the forward takes carry them along.
(b) ``qmatmul_int8_ref`` (what the card kernel is held against) matches
    ``embeddings_tpu.ops.qmatmul.qmatmul(int8_compute=True)`` in Pallas
    interpret mode at the new kernel's tile edges: K = 96 and 160 (not a
    multiple of its 128-value chunk), N = 136 (one partial 128-column
    tile), M = 40 and 257 (ragged against both row tiles), with K3x (int8
    x with its row scales) and K3e ("both", "only") on the tiled and the
    residual-LayerNorm epilogues. The JAX kernel takes neither M % 8 != 0
    nor an N that is no multiple of 128 in int8: rows are independent, so
    its x is padded with zero rows; columns are independent outside
    LayerNorm, so its weight carries zero columns up to N = 256 (a zero
    column adds 0 to every row's absmax under these epilogues). LayerNorm
    normalizes over the whole row, so its cases take N = 256.
    Tolerance 1e-5 of the output scale (the int8 operands and s32 sums
    are identical; the rescale and epilogue differ by f32 order), codes
    within one step, as tests/test_torch_emit.py.
(c) ``k3_tile`` / ``k3_route`` at bge's four shapes and the LayerNorm
    cluster widths N = 768, 1,536 and 2,048.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from embeddings_tpu.ops.quant import dequantize as jax_dequantize
from embeddings_tpu.ops.quant import quantize as jax_quantize

from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.models.params import from_jax_params
from embeddings_tpu_torch.ops.qmatmul import (k1_tile, k3_route, k3_tile,
                                              keep_int8_weight,
                                              qmatmul_int8_ref, quantize_rows,
                                              requantize_int8,
                                              requantize_weight)
from embeddings_tpu_torch.ops.quant import QuantizedTensor

from tests.test_torch_model import small_q4  # noqa: F401  (fixture)

KINDS = [("q4_0", False), ("q4_0", True), ("q4_1", False), ("q4_1", True),
         ("q8_0", False), ("nf4", False), ("nf4", True)]


def _numpy_int8(w: np.ndarray):
    """The int8 requantization of an f32 weight [K, N] in numpy: multiply
    by the f32 reciprocal of the column scale, round half to even."""
    cs = np.maximum(np.abs(w).max(0), np.float32(1e-12)) \
        * np.float32(1.0 / 127.0)
    return np.round(w * (np.float32(1.0) / cs)).astype(np.int8), cs


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kind,packed", KINDS)
def test_kept_int8_weight_is_bit_identical(kind, packed, stacked):
    rng = np.random.default_rng(3)
    shape = (3, 128, 256) if stacked else (128, 256)
    w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.05)
    qt = jax_quantize(w, kind, pack4=packed)
    tq = keep_int8_weight(from_jax_params(qt))
    w8t, cs = tq.int8
    assert w8t.dtype == torch.int8 and cs.dtype == torch.float32
    assert tuple(w8t.shape) == shape[:-2] + (256, 128)
    assert tuple(cs.shape) == shape[:-2] + (256,)
    wd = np.asarray(jax_dequantize(qt), np.float32).reshape(-1, 128, 256)
    for i in range(wd.shape[0]):
        layer = tq.map(lambda t, i=i: t[i]) if stacked else tq
        want8, want_cs = _numpy_int8(wd[i])
        np.testing.assert_array_equal(layer.int8[0].numpy(), want8.T)
        np.testing.assert_array_equal(layer.int8[1].numpy(), want_cs)
        rw8, rcs = requantize_weight(layer.codes, layer.scales, layer.mins,
                                     kind, packed)
        assert torch.equal(layer.int8[0], rw8.t())
        assert torch.equal(layer.int8[1], rcs.reshape(-1))
        # the wrapper's CPU path is the plain version, transposed
        one = requantize_int8(layer.codes, layer.scales, layer.mins,
                              kind=kind, packed=packed)
        assert torch.equal(one[0], layer.int8[0])
        assert torch.equal(one[1], layer.int8[1])


@pytest.mark.parametrize("int8", [True, False])
def test_engine_keeps_int8_weights(small_q4, small_vocab, int8):
    """An Engine built with int8_compute keeps every matmul weight's int8
    requantization (equal to requantize_weight's, layer by layer); the
    layer slices of a forward carry it; without int8 none is kept."""
    from embeddings_tpu_torch.config import EngineConfig
    from embeddings_tpu_torch.runtime.engine import Engine
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    _, _, cfg, tp = small_q4
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab))
    eng = Engine(tp, cfg, tok, EngineConfig(int8_compute=int8),
                 device="cpu")
    layers = eng.params["layers"]
    ws = [layers["attn"]["qkv"]["w"], layers["attn"]["o"]["w"],
          layers["mlp"]["up"]["w"], layers["mlp"]["down"]["w"]]
    assert all(isinstance(w, QuantizedTensor) for w in ws)
    if not int8:
        assert all(w.int8 is None for w in ws)
        return
    for i in range(cfg.num_hidden_layers):
        for w in P.layer(eng.params, i)["attn"]["o"]["w"], \
                P.layer(eng.params, i)["mlp"]["down"]["w"]:
            rw8, rcs = requantize_weight(w.codes, w.scales, w.mins, w.kind,
                                         w.packed)
            assert torch.equal(w.int8[0], rw8.t())
            assert torch.equal(w.int8[1], rcs.reshape(-1))
    # the caller's tree is not changed
    assert all(w.int8 is None for w in (tp["layers"]["mlp"]["up"]["w"],))


# (M, K, N, epilogue, emit, int8 x): the tile edges
EDGE_CASES = [
    (40, 96, 136, "bias", "no", False),
    (257, 160, 136, "bias_gelu", "no", False),
    (40, 160, 136, "bias_gelu", "only", True),
    (257, 96, 136, "bias_silu", "both", False),
    (257, 160, 136, "none", "no", True),
    (40, 96, 256, "bias_residual_ln", "both", True),
    (257, 160, 256, "bias_residual_ln", "no", False),
    (257, 96, 256, "bias_residual_ln", "both", False),
]


def _pad_rows(a: np.ndarray, rows: int, value=0) -> np.ndarray:
    pad = np.full((rows - a.shape[0],) + a.shape[1:], value, a.dtype)
    return np.concatenate([a, pad])


@pytest.mark.parametrize("M,K,N,epilogue,emit,x8", EDGE_CASES)
def test_int8_ref_matches_jax_at_k3_edges(M, K, N, epilogue, emit, x8):
    rng = np.random.default_rng(M + K + N)
    NJ = 256  # the JAX kernel's N: zero columns past N
    x = rng.standard_normal((M, K), dtype=np.float32)
    w = rng.standard_normal((K, NJ), dtype=np.float32) * np.float32(0.05)
    w[:, N:] = 0.0
    bias = rng.standard_normal(NJ, dtype=np.float32) * np.float32(0.1)
    bias[N:] = 0.0
    extra = {}
    if epilogue == "bias_residual_ln":
        extra = dict(
            residual=rng.standard_normal((M, N), dtype=np.float32),
            ln_scale=1.0 + rng.standard_normal(N, dtype=np.float32)
            * np.float32(0.1),
            ln_bias=rng.standard_normal(N, dtype=np.float32)
            * np.float32(0.1))
    qt = jax_quantize(w, "q4_0")
    tq = from_jax_params(qt)
    cols = slice(None, N)
    codes, scales = tq.codes[:, cols].contiguous(), \
        tq.scales[:, cols].contiguous()
    MJ = -(-M // 8) * 8  # the JAX kernel's rows: zero rows past M
    kw = dict(kind="q4_0", epilogue=epilogue)
    tx = torch.from_numpy(x)
    jx, jkw, tkw = jnp.asarray(_pad_rows(x, MJ)), {}, {}
    if x8:
        q, sx = quantize_rows(tx)
        tx = q
        tkw["x_scale"] = sx
        jx = jnp.asarray(_pad_rows(q.numpy(), MJ))
        jkw["x_scale"] = jnp.asarray(_pad_rows(sx.numpy().reshape(M), MJ,
                                               1.0))
    got = qmatmul_int8_ref(tx, codes, scales, None,
                           torch.from_numpy(bias[cols].copy()),
                           out_dtype=torch.float32, emit_quantized=emit,
                           **kw, **tkw, **{k: torch.from_numpy(v)
                                    for k, v in extra.items()})
    ref = jax_qmatmul(
        jx, qt.codes, qt.scales, None, jnp.asarray(bias), int8_compute=True,
        out_dtype=jnp.float32, emit_quantized=emit, interpret=True, **kw,
        **jkw, **{k: jnp.asarray(_pad_rows(v, MJ) if v.ndim == 2 else v)
                  for k, v in extra.items()})
    got = got if emit != "no" else (got,)
    ref = ref if emit != "no" else (ref,)
    if emit == "only":
        got, ref = (None, *got), (None, *ref)
    out, o8, so = (list(got) + [None, None])[:3]
    rout, ro8, rso = (list(ref) + [None, None])[:3]
    if out is not None:
        r = np.asarray(rout)[:M, :N]
        assert out.shape == (M, N) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())
    if emit != "no":
        d = np.abs(o8.numpy().astype(int)
                   - np.asarray(ro8)[:M, :N].astype(int))
        assert d.max() <= 1
        np.testing.assert_allclose(so.numpy().reshape(M),
                                   np.asarray(rso).reshape(-1)[:M],
                                   rtol=1e-5)


# (M, N, epilogue) -> K3's tile on a 132-SM card: bge's four shapes at
# B=128, L=256, the LayerNorm cluster widths, and a CP shard's rows
TILE_CASES = [
    (32768, 2304, "bias", (256, 1), "bm256"),
    (32768, 768, "bias_residual_ln", (256, 6), "bm256_cluster6"),
    (32768, 3072, "bias_gelu", (256, 1), "bm256"),
    (32768, 1536, "bias_residual_ln", (128, 12), "bm128_cluster12"),
    (32768, 2048, "bias_residual_ln", (128, 16), "bm128_cluster16"),
    (4096, 768, "bias_residual_ln", (128, 6), "bm128_cluster6"),
    (256, 2304, "bias", (128, 1), "bm128"),
]


@pytest.mark.parametrize("M,N,epilogue,tile,route", TILE_CASES)
def test_k3_tile_and_route(M, N, epilogue, tile, route):
    assert k3_tile(M, N, epilogue, 132) == tile
    assert k3_route(M, N, epilogue, 132) == route
    # K1's kernel on int8 operands: the same rule as K1's
    assert k3_tile(M, N, epilogue, 132) == k1_tile(M, N, epilogue, 132)


def test_k3_tile_refuses_too_wide_layernorm():
    with pytest.raises(ValueError, match="at most 2048"):
        k3_tile(256, 2176, "bias_residual_ln", 132)
