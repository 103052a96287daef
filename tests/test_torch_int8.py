"""The port's int8 compute mode (kernel K3) against the JAX package.

(a) ``qmatmul_int8_ref`` (the plain version the port runs on a CPU tensor)
    against ``embeddings_tpu.ops.qmatmul.qmatmul(int8_compute=True)`` in
    Pallas interpret mode, over kind x packed x all six epilogues. Both
    requantize the weight per column and x per row with the same f32 steps,
    so the int8 operands and the s32 sums are identical; the rescale and
    the epilogue differ by f32 rounding order only (tolerance 1e-5 of the
    output scale).
(b) the intermediates: ``requantize_weight`` and ``quantize_rows`` are bit
    for bit a numpy recomputation from the JAX package's ``dequantize``.
(c) ``quantize_act`` and ``_int8_emulated_dot`` against JAX's.
(d) the model in int8 mode: ``encode_tokens`` through the kernels' plain
    versions against JAX through its Pallas kernels in interpret mode
    under ``int8_mode(True)``, and the plain path against JAX's emulated
    path. An activation whose f32 value differs by summation-order noise
    can round to the neighbouring int8 level, so these compare at
    cosine >= 0.9999 (f32) and 0.999 (bf16) rather than elementwise.
(e) the Engine in int8 mode on the CPU against the JAX Engine.
"""

import functools
import importlib
import logging

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.ops.qmatmul import int8_engages as jax_int8_engages
from embeddings_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from embeddings_tpu.ops.quant import dequantize as jax_dequantize
from embeddings_tpu.ops.quant import quantize as jax_quantize

from embeddings_tpu_torch.models.params import from_jax_params
from embeddings_tpu_torch.ops import linear as tlinear
from embeddings_tpu_torch.ops.qmatmul import (EPILOGUES, int8_engages,
                                              qmatmul, qmatmul_int8,
                                              qmatmul_int8_ref, qmatmul_ref,
                                              quantize_rows,
                                              requantize_weight)

from tests.test_torch_model import small_q4  # noqa: F401  (fixture)

jlin = importlib.import_module("embeddings_tpu.ops.linear")

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
def test_qmatmul_int8_ref_matches_jax_interpret(kind, packed, epilogue):
    x, qt, bias, extra = _inputs(kind, packed, epilogue)
    ref = np.asarray(jax_qmatmul(
        jnp.asarray(x), qt.codes, qt.scales, qt.mins, jnp.asarray(bias),
        kind=kind, epilogue=epilogue, packed=packed, int8_compute=True,
        interpret=True, **{k: jnp.asarray(v) for k, v in extra.items()}))
    tq = from_jax_params(qt)
    got = qmatmul_int8_ref(torch.from_numpy(x), tq.codes, tq.scales,
                           tq.mins, torch.from_numpy(bias), kind=kind,
                           epilogue=epilogue, packed=packed,
                           **{k: torch.from_numpy(v)
                              for k, v in extra.items()})
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kind,packed", KINDS)
def test_int8_operands_bit_identical_to_numpy(kind, packed):
    """w8 / cs and q / sx equal a numpy recomputation from the JAX
    package's f32 ``dequantize``: multiply by the f32 reciprocal, round
    half to even."""
    x, qt, _, _ = _inputs(kind, packed, "bias", seed=1)
    w = np.asarray(jax_dequantize(qt), np.float32)
    cs = np.maximum(np.abs(w).max(0, keepdims=True), np.float32(1e-12)) \
        * np.float32(1.0 / 127.0)
    w8 = np.round(w * (np.float32(1.0) / cs)).astype(np.int8)
    sx = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-12)) \
        * np.float32(1.0 / 127.0)
    q = np.round(x * (np.float32(1.0) / sx)).astype(np.int8)
    tq = from_jax_params(qt)
    tw8, tcs = requantize_weight(tq.codes, tq.scales, tq.mins, kind, packed)
    tq8, tsx = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tw8.numpy(), w8)
    np.testing.assert_array_equal(tcs.numpy(), cs)
    np.testing.assert_array_equal(tq8.numpy(), q)
    np.testing.assert_array_equal(tsx.numpy(), sx)


def test_quantize_act_and_emulated_dot_match_jax():
    x, qt, _, _ = _inputs("q4_1", True, "none", seed=2)
    jq = jlin.quantize_act(jnp.asarray(x))
    tq = tlinear.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))
    wd = np.array(jax_dequantize(qt), np.float32)
    for xin, tin in ((jnp.asarray(x), torch.from_numpy(x)), (jq, tq)):
        ref = np.asarray(jlin._int8_emulated_dot(xin, jnp.asarray(wd)))
        got = tlinear._int8_emulated_dot(tin, torch.from_numpy(wd))
        # the same s32 sums, (acc * sx) * cs in f32 on both sides
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


def test_int8_engages_matches_jax_rule():
    for k, n, packed in [(128, 256, False), (128, 256, True), (96, 128, True),
                         (96, 128, False), (128, 576, False),
                         (768, 2304, True), (3072, 768, True),
                         (768, 3072, True), (64, 136, False)]:
        assert int8_engages(k, n, packed) == jax_int8_engages(
            k, n, 256, packed), (k, n, packed)


def test_int8_falls_back_to_bf16_with_warning(caplog):
    """N = 136 is not lane-aligned: the int8 request runs the bf16 mode
    (K1's plain version here), with the JAX package's warning."""
    rng = np.random.default_rng(3)
    qt = from_jax_params(jax_quantize(
        rng.standard_normal((128, 136), dtype=np.float32), "q4_0"))
    x = torch.from_numpy(rng.standard_normal((8, 128), dtype=np.float32))
    before = qmatmul_int8.launches
    with caplog.at_level(logging.WARNING):
        got = qmatmul(x, qt.codes, qt.scales, int8_compute=True)
    assert "ragged lane count" in caplog.text
    assert torch.equal(got, qmatmul_ref(x, qt.codes, qt.scales))
    assert qmatmul_int8.launches == before  # CPU tensors launch nothing


def test_linear_routes_int8():
    """linear / linear_residual_ln with int8: the kernels' plain version
    (use_kernels) equals qmatmul_int8_ref; the plain path equals the JAX
    fallback's emulated int8 (f32 noise)."""
    x, qt, bias, extra = _inputs("q4_0", True, "bias_residual_ln", seed=4)
    tq = from_jax_params(qt)
    tx, tb = torch.from_numpy(x), torch.from_numpy(bias)
    got = tlinear.linear(tx, tq, tb, act="gelu", int8=True)
    want = qmatmul_int8_ref(tx, tq.codes, tq.scales, None, tb,
                            epilogue="bias_gelu", packed=True)
    assert torch.equal(got, want)
    res, lns, lnb = (torch.from_numpy(extra[k])
                     for k in ("residual", "ln_scale", "ln_bias"))
    with jlin.int8_mode(True):
        ref = np.asarray(jlin.linear_residual_ln(
            jnp.asarray(x), qt, jnp.asarray(bias),
            jnp.asarray(extra["residual"]), jnp.asarray(extra["ln_scale"]),
            jnp.asarray(extra["ln_bias"]), 1e-12))
    plain = tlinear.linear_residual_ln(tx, tq, tb, res, lns, lnb, 1e-12,
                                       use_kernels=False, int8=True)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# the model and the Engine in int8 mode
# ---------------------------------------------------------------------------

def _jax_kernels_int8(jp, jcfg, ids, mask, **kw):
    """JAX forward through its Pallas kernels in interpret mode, int8."""
    from embeddings_tpu.models import bert as jbert
    jattn = importlib.import_module("embeddings_tpu.ops.attention")
    orig = jattn.fused_attention
    jattn.fused_attention = functools.partial(orig, interpret=True)
    try:
        with jlin.pallas_mode("always"), jlin.interpret_mode(), \
                jlin.int8_mode(True):
            return np.asarray(jbert.encode_tokens(
                jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), **kw))
    finally:
        jattn.fused_attention = orig


def _batch(seed, B=3, L=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 256, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 10:] = 0
    mask[2, 1:] = 0
    return ids, mask


def _port(tp, cfg, ids, mask, int8=True, **kw):
    from embeddings_tpu_torch.models import bert as tbert
    return tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                               torch.from_numpy(mask), int8=int8,
                               **kw).numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_tokens_int8_matches_jax_kernels(small_q4, dtype):
    jcfg, jp, cfg, tp = small_q4
    ids, mask = _batch(5)
    if dtype == "f32":
        ref = _jax_kernels_int8(jp, jcfg, ids, mask)
        got = _port(tp, cfg, ids, mask)
        cos = 0.9999
        # elementwise, at a tolerance the non-int8 forward fails (it sits
        # ~5e-3 off the int8 reference): every layer took the int8 route
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        no8 = _port(tp, cfg, ids, mask, int8=False)
        assert np.abs(no8 - ref).max() > 1e-3
    else:
        ref = _jax_kernels_int8(jp, jcfg, ids, mask,
                                compute_dtype="bfloat16")
        got = _port(tp, cfg, ids, mask, compute_dtype=torch.bfloat16)
        cos = 0.999
    assert got.shape == (3, 128) and np.isfinite(got).all()
    assert (got * ref).sum(-1).min() >= cos


def test_encode_tokens_int8_plain_matches_jax_emulation(small_q4):
    from embeddings_tpu.models import bert as jbert
    jcfg, jp, cfg, tp = small_q4
    ids, mask = _batch(6)
    with jlin.int8_mode(True):
        ref = np.asarray(jbert.encode_tokens(jp, jcfg, jnp.asarray(ids),
                                             jnp.asarray(mask)))
    got = _port(tp, cfg, ids, mask, use_kernels=False)
    assert (got * ref).sum(-1).min() >= 0.9999
    # the int8 mode really ran: it moves the result off the f32 mode's
    # (by its quantization error, a little)
    f32 = _port(tp, cfg, ids, mask, int8=False, use_kernels=False)
    cos = (f32 * got).sum(-1)
    assert cos.min() >= 0.99 and np.abs(f32 - got).max() > 1e-4


def test_engine_int8_cpu_matches_jax_engine(small_q4, small_vocab,
                                            our_tokenizer):
    from embeddings_tpu.config import EngineConfig as JaxEC
    from embeddings_tpu.runtime.engine import Engine as JaxEngine
    from embeddings_tpu_torch.config import EngineConfig
    from embeddings_tpu_torch.runtime.engine import Engine
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    jcfg, jp, cfg, tp = small_q4
    texts = ["hello world", "the quick brown fox", "a", "hello world",
             "jumps over the lazy dog " * 3]
    ec = dict(batch_size=4, max_seq_len=64, int8_compute=True)
    ref = JaxEngine(jp, jcfg, our_tokenizer, JaxEC(**ec)).encode_batch(texts)
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab))
    got = Engine(tp, cfg, tok, EngineConfig(**ec),
                 device="cpu").encode_batch(texts)
    assert (got * ref).sum(-1).min() >= 0.999
    np.testing.assert_array_equal(got[0], got[3])
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-5)
    plain = Engine(tp, cfg, tok, EngineConfig(use_pallas="never", **ec),
                   device="cpu").encode_batch(texts)
    assert (plain * ref).sum(-1).min() >= 0.9999
