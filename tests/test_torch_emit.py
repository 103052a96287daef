"""The port's chained-int8 kernel modes against the JAX package, on the CPU.

(a) Emission (K1e / K3e) and pre-quantized input (K3x):
    ``qmatmul_int8_ref`` / ``qmatmul_ref`` with ``emit_quantized`` against
    ``embeddings_tpu.ops.qmatmul.qmatmul`` in Pallas interpret mode, over
    kind x packed x {bias, bias_gelu, bias_residual_ln} x {both, only},
    with x bf16 and with x int8 + its row scales (the JAX package's
    ``quantize_act``). The f32 epilogue outputs differ by summation order
    only, so the codes are equal or one step apart where a value sits on
    a rounding midpoint (at most 1% of the codes), the row scales agree to
    rtol 1e-6, and the bf16 output ("both") to one bf16 ulp.
(b) Attention emission (K2e / K4e) and int8 scores (K2i8):
    ``fused_attention_ref`` / ``fused_attention_segmented_ref`` against
    JAX's kernels in interpret mode, with a len-0 row and pad rows, in
    f32 and bf16, and K2i8 at L=64, 640 and 1,024 (JAX's blocked-query
    route). Emission codes: equal or one step off (bf16 contexts round
    the same f32 values; f32 contexts differ by summation order). K2i8:
    every product is integer, so the outputs differ only where exp2's last
    bit moves a probability p8 across a rounding midpoint: at most one p8
    step, which moves an output by at most max|v| / 127.
(c) The safety nets as shape rules: an ActQ at a shape where int8 does
    not engage is dequantized, and an emission there comes from K1 (K1e);
    on a CPU tensor an emission at a shape ``emit_fits`` does not take
    runs the plain path and ``quantize_act``, while a tensor off the CPU
    takes the kernel path, which refuses the shape.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.ops import attention as jattn
from embeddings_tpu.ops.qmatmul import emit_fits as jax_emit_fits
from embeddings_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from embeddings_tpu.ops.quant import quantize as jax_quantize

from embeddings_tpu_torch.models.params import from_jax_params
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.ops import linear as tlin
from embeddings_tpu_torch.ops.qmatmul import emit_fits, qmatmul, \
    qmatmul_int8_ref, qmatmul_ref

jlin = importlib.import_module("embeddings_tpu.ops.linear")

M, K, N = 16, 128, 256
KINDS = [("q4_0", False), ("q4_0", True), ("q4_1", False), ("q4_1", True),
         ("q8_0", False), ("nf4", False), ("nf4", True)]
EMIT_EPILOGUES = ("bias", "bias_gelu", "bias_residual_ln")


def _inputs(kind, packed, epilogue, seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    w = rng.standard_normal((K, n), dtype=np.float32) * np.float32(0.05)
    bias = rng.standard_normal(n, dtype=np.float32) * np.float32(0.1)
    extra = {}
    if epilogue == "bias_residual_ln":
        extra = dict(
            residual=rng.standard_normal((M, n), dtype=np.float32),
            ln_scale=1.0 + rng.standard_normal(n, dtype=np.float32) * 0.1,
            ln_bias=rng.standard_normal(n, dtype=np.float32) * 0.1)
    return x, jax_quantize(w, kind, pack4=packed), bias, extra


def _np(t):
    t = t.float() if isinstance(t, torch.Tensor) else t
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32) if t.dtype != np.int8 else t)


def assert_codes(got8, gots, ref8, refs, frac=0.01):
    """Codes equal or one step apart (at most ``frac`` of them one step
    off); row scales at rtol 1e-6. Returns the count one step off."""
    g8, r8 = np.asarray(got8, np.int32), np.asarray(ref8, np.int32)
    d = np.abs(g8 - r8)
    assert d.max() <= 1, d.max()
    off = int((d == 1).sum())
    assert off <= max(1, frac * d.size), (off, d.size)
    np.testing.assert_allclose(_np(gots), _np(refs), rtol=1e-6, atol=0)
    assert _np(gots).shape == (g8.shape[0], 1)
    return off


def _check_emission(got, ref, emit):
    """got: the port's tuple (torch), ref: JAX's (arrays)."""
    if emit == "both":
        np.testing.assert_allclose(_np(got[0]), _np(ref[0]), rtol=2 ** -8,
                                   atol=1e-6)
        got, ref = got[1:], ref[1:]
    return assert_codes(got[0].numpy(), got[1], np.asarray(ref[0]), ref[1])


@pytest.mark.parametrize("emit", ["both", "only"])
@pytest.mark.parametrize("epilogue", EMIT_EPILOGUES)
@pytest.mark.parametrize("kind,packed", KINDS)
def test_int8_emission_matches_jax(kind, packed, epilogue, emit):
    """K3e's plain version on bf16 x, and K3x + K3e's on int8 x with its
    row scales, against JAX's int8 kernel in interpret mode."""
    x, qt, bias, extra = _inputs(kind, packed, epilogue,
                                 seed=EMIT_EPILOGUES.index(epilogue))
    tq = from_jax_params(qt)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    tx = {k: torch.from_numpy(v) for k, v in extra.items()}
    if "residual" in jx:
        jx["residual"] = jx["residual"].astype(jnp.bfloat16)
        tx["residual"] = tx["residual"].to(torch.bfloat16)
    common = dict(kind=kind, epilogue=epilogue, packed=packed,
                  emit_quantized=emit)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax_qmatmul(xb, qt.codes, qt.scales, qt.mins, jnp.asarray(bias),
                      int8_compute=True, interpret=True, **common, **jx)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    got = qmatmul(tb, tq.codes, tq.scales, tq.mins, torch.from_numpy(bias),
                  int8_compute=True, **common, **tx)
    _check_emission(got, ref, emit)
    # pre-quantized x: JAX's quantize_act rows, read as they are
    jq = jlin.quantize_act(xb)
    ref = jax_qmatmul(jq.q, qt.codes, qt.scales, qt.mins, jnp.asarray(bias),
                      int8_compute=True, x_scale=jq.s, out_dtype=jnp.bfloat16,
                      interpret=True, **common, **jx)
    got = qmatmul(torch.from_numpy(np.array(jq.q)), tq.codes, tq.scales,
                  tq.mins, torch.from_numpy(bias), int8_compute=True,
                  x_scale=torch.from_numpy(np.array(jq.s)).reshape(M),
                  **common, **tx)
    _check_emission(got, ref, emit)


@pytest.mark.parametrize("emit", ["both", "only"])
@pytest.mark.parametrize("epilogue", EMIT_EPILOGUES)
@pytest.mark.parametrize("kind,packed", [("q4_0", True), ("q8_0", False)])
def test_bf16_emission_matches_jax(kind, packed, epilogue, emit):
    """K1e's plain version (bf16 compute) against JAX's bf16 kernel."""
    x, qt, bias, extra = _inputs(kind, packed, epilogue, seed=9)
    tq = from_jax_params(qt)
    common = dict(kind=kind, epilogue=epilogue, packed=packed,
                  emit_quantized=emit)
    ref = jax_qmatmul(jnp.asarray(x), qt.codes, qt.scales, qt.mins,
                      jnp.asarray(bias), interpret=True, **common,
                      **{k: jnp.asarray(v) for k, v in extra.items()})
    got = qmatmul_ref(torch.from_numpy(x), tq.codes, tq.scales, tq.mins,
                      torch.from_numpy(bias), **common,
                      **{k: torch.from_numpy(v) for k, v in extra.items()})
    if emit == "both":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=0, atol=1e-5 * np.abs(ref[0]).max())
        got, ref = got[1:], ref[1:]
    assert_codes(got[0].numpy(), got[1], np.asarray(ref[0]), ref[1])


def test_emit_fits_matches_jax_lane_rule():
    """At bge-base's shapes both rules take the emission. The port's own
    rule also takes what JAX's lane rule (N % 128) or its VMEM budget
    (N = 4,096 unpacked) refuses, wherever its kernels run (N % 8 == 0),
    and refuses N % 8 != 0 and a K the kernels do not take. An emission
    the rule refuses raises."""
    for k, n, packed in [(768, 768, True), (768, 3072, True),
                         (3072, 768, True)]:
        assert emit_fits(k, n, packed) and jax_emit_fits(k, n, 256, packed)
    for k, n, packed in [(1024, 4096, False), (128, 136, False),
                         (128, 200, True)]:
        assert emit_fits(k, n, packed), (k, n, packed)
        assert not jax_emit_fits(k, n, 256, packed)
    for k, n, packed in [(128, 132, False), (96, 128, True), (48, 128, False)]:
        assert not emit_fits(k, n, packed), (k, n, packed)
    x, qt, bias, _ = _inputs("q4_0", False, "bias", n=132)
    tq = from_jax_params(qt)
    with pytest.raises(ValueError):
        qmatmul_int8_ref(torch.from_numpy(x), tq.codes, tq.scales,
                         emit_quantized="only")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_inputs(B, L, H, D, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B * L, 3 * H * D), dtype=np.float32)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 0, L
    return qkv, lengths


def _seg_inputs(B, L, H, D, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B * L, 3 * H * D), dtype=np.float32)
    seg = np.full((B, L), -1, np.int32)
    for b in range(B):
        pos = 0
        for s in range(3):
            n = int(rng.integers(3, L // 4))
            seg[b, pos:pos + n] = s
            pos += n
    return qkv, seg


def _tensors(qkv, dt):
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    return jnp.asarray(qkv, jdt), torch.from_numpy(qkv).to(tdt)


def _ctx_check(got, ref, dt):
    if dt == "bf16":
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2 ** -6,
                                   atol=2e-3)
    else:
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("emit", ["both", "only"])
def test_attention_emission_matches_jax(emit, dt):
    """K2e's plain version: the context (with "both") and its int8 rows,
    floor 1e-30 (the len-0 row: codes 0, scale 1e-30/127)."""
    B, L, H, D = 3, 32, 2, 64
    qkv, lengths = _attn_inputs(B, L, H, D, seed=3)
    jq, tq = _tensors(qkv, dt)
    kw = dict(B=B, L=L, H=H, D=D, emit_quantized=emit)
    ref = jattn.fused_attention(jq, jnp.asarray(lengths), interpret=True,
                                **kw)
    got = tattn.fused_attention(tq, torch.from_numpy(lengths), **kw)
    if emit == "both":
        _ctx_check(got[0], ref[0], dt)
        got, ref = got[1:], ref[1:]
    assert_codes(got[0].numpy(), got[1], np.asarray(ref[0]), ref[1])
    assert (got[0].numpy().reshape(B, L, -1)[0] == 0).all()
    np.testing.assert_allclose(got[1].numpy().reshape(B, L)[0],
                               np.float32(1e-30) * np.float32(1 / 127),
                               rtol=1e-6)


@pytest.mark.parametrize("emit", ["both", "only"])
def test_segmented_emission_matches_jax(emit):
    """K4e's plain version on packed rows with pads (bf16)."""
    B, L, H, D = 2, 64, 2, 64
    qkv, seg = _seg_inputs(B, L, H, D, seed=4)
    jq, tq = _tensors(qkv, "bf16")
    kw = dict(B=B, L=L, H=H, D=D, emit_quantized=emit)
    ref = jattn.fused_attention_segmented(jq, jnp.asarray(seg),
                                          interpret=True, **kw)
    got = tattn.fused_attention_segmented(tq, torch.from_numpy(seg), **kw)
    if emit == "both":
        _ctx_check(got[0], ref[0], "bf16")
        got, ref = got[1:], ref[1:]
    assert_codes(got[0].numpy(), got[1], np.asarray(ref[0]), ref[1])
    pad = (seg < 0).reshape(-1)
    assert (got[0].numpy()[pad] == 0).all()


@pytest.mark.parametrize("emit", ["both", "only"])
@pytest.mark.parametrize("H,D", [(2, 64), (4, 32), (1, 128)])
def test_segmented_emission_tile_edges_match_jax(H, D, emit):
    """K4e's plain version where the Hopper kernel's 128-key tiles meet
    the data (bf16, L=256): row 0's second segment runs over keys
    100..179, across the tile edge at 128; row 1 ends in 24 pads. Codes
    within one step. The scales of "both" at rtol 1e-6 (both quantize the
    same bf16 context). Those of "only" quantize the f32 context, whose
    probabilities each framework rounds to bf16 from its own exp2: one
    rounding flip moves the context by up to 2^-8 of one key's share, so
    the row absmax (127 * scale), a maximum of the context, is held at
    the context's own tolerance."""
    B, L = 2, 256
    rng = np.random.default_rng(D + H)
    qkv = rng.standard_normal((B * L, 3 * H * D), dtype=np.float32)
    seg = np.full((B, L), -1, np.int32)
    seg[0, :100], seg[0, 100:180], seg[0, 180:] = 0, 1, 2
    seg[1, :L // 2], seg[1, L // 2:L - 24] = 0, 1
    jq, tq = _tensors(qkv, "bf16")
    kw = dict(B=B, L=L, H=H, D=D, emit_quantized=emit)
    ref = jattn.fused_attention_segmented(jq, jnp.asarray(seg),
                                          interpret=True, **kw)
    got = tattn.fused_attention_segmented(tq, torch.from_numpy(seg), **kw)
    if emit == "both":
        _ctx_check(got[0], ref[0], "bf16")
        assert_codes(got[1].numpy(), got[2], np.asarray(ref[1]), ref[2])
        got = got[1:]
    else:
        d = np.abs(got[0].numpy().astype(np.int32)
                   - np.asarray(ref[0]).astype(np.int32))
        assert d.max() <= 1 and (d == 1).sum() <= 0.01 * d.size
        assert tuple(got[1].shape) == (B * L, 1)
        _ctx_check(got[1] * 127, np.asarray(ref[1]) * 127, "bf16")
    pad = (seg < 0).reshape(-1)
    assert (got[0].numpy()[pad] == 0).all()
    np.testing.assert_allclose(got[1].numpy().reshape(-1)[pad],
                               np.float32(1e-30) * np.float32(1 / 127),
                               rtol=1e-6)


def _p8_step_atol(qkv, B, L, H, D):
    """One p8 step of K2i8 moves an output by at most max|v| / 127 (the
    row's largest probability is 127, so the denominator is at least
    127 * 127)."""
    v = qkv.reshape(B, L, 3, H * D)[:, :, 2]
    return float(np.abs(v).max()) / 127


@pytest.mark.parametrize("dt,B,L", [("f32", 3, 64), ("bf16", 3, 64),
                                    ("f32", 2, 640), ("bf16", 3, 1024)])
def test_int8_scores_match_jax(dt, B, L):
    """K2i8's plain version: within one p8 step of JAX's int8 branch
    (max|v|/127, plus one bf16 ulp of the output in bf16), the len-0 row
    finite (every key at p8 = 127: the mean of v over the row), and
    away from the bf16 softmax (the int8 branch really ran)."""
    H, D = 2, 64
    qkv, lengths = _attn_inputs(B, L, H, D, seed=L)
    jq, tq = _tensors(qkv, dt)
    kw = dict(B=B, L=L, H=H, D=D)
    ref = _np(jattn.fused_attention(jq, jnp.asarray(lengths),
                                    int8_scores=True, interpret=True, **kw))
    got = _np(tattn.fused_attention(tq, torch.from_numpy(lengths),
                                    int8_scores=True, **kw))
    step = _p8_step_atol(_np(tq), B, L, H, D)
    rtol = 2 ** -8 if dt == "bf16" else 0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=step + 1e-6)
    assert np.isfinite(got).all()
    row0 = got.reshape(B, L, -1)[0]
    assert np.abs(row0).max() > 0 and np.allclose(row0, row0[:1], atol=1e-6)
    plain = _np(tattn.fused_attention(tq, torch.from_numpy(lengths), **kw))
    assert np.abs(plain - got).max() > 1e-3


def test_int8_scores_with_only_emission_matches_jax():
    """K2i8 + K2e "only": the f32 int8-scores context quantized."""
    B, L, H, D = 3, 64, 2, 64
    qkv, lengths = _attn_inputs(B, L, H, D, seed=5)
    jq, tq = _tensors(qkv, "bf16")
    kw = dict(B=B, L=L, H=H, D=D, emit_quantized="only", int8_scores=True)
    ref = jattn.fused_attention(jq, jnp.asarray(lengths), interpret=True,
                                **kw)
    got = tattn.fused_attention(tq, torch.from_numpy(lengths), **kw)
    assert_codes(got[0].numpy(), got[1], np.asarray(ref[0]), ref[1])


def test_attention_emission_head_rule():
    """Emission takes at most 16 heads (one thread-block cluster)."""
    assert tattn.emit_supported(16) and not tattn.emit_supported(17)
    qkv = torch.zeros(2 * 8, 3 * 17 * 32)
    with pytest.raises(ValueError):
        tattn.fused_attention(qkv, torch.ones(2, dtype=torch.int32), B=2,
                              L=8, H=17, D=32, emit_quantized="only")


# ---------------------------------------------------------------------------
# the linear ops' safety nets
# ---------------------------------------------------------------------------

def test_actq_at_a_ragged_shape_is_dequantized():
    """N = 136 cannot run int8: the ActQ's rows come back as values and
    the call runs the bf16 mode, as the JAX package's safety net does."""
    x, qt, bias, _ = _inputs("q4_0", False, "bias", seed=6, n=136)
    tq = from_jax_params(qt)
    xq = tlin.quantize_act(torch.from_numpy(x))
    got = tlin.quantized_matmul(xq, tq, torch.from_numpy(bias))
    want = qmatmul_ref((xq.q.float() * xq.s).to(torch.bfloat16), tq.codes,
                       tq.scales, None, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    jq = jlin.ActQ(jnp.asarray(xq.q.numpy()), jnp.asarray(xq.s.numpy()))
    with jlin.pallas_mode("always"):
        ref = jlin.quantized_matmul(jq, qt, jnp.asarray(bias),
                                    interpret=True)
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=2 ** -8,
                               atol=1e-5)


@pytest.mark.parametrize("emit", ["both", "only"])
def test_actq_emission_at_a_ragged_shape_runs_k1e(emit):
    """N = 136 cannot run int8 but the kernels emit there: the ActQ's rows
    are dequantized and K1 emits (K1e's plain version, bf16 compute), in
    the matmul and in the residual-LayerNorm step."""
    x, qt, bias, extra = _inputs("q4_0", False, "bias_residual_ln", seed=8,
                                 n=136)
    tq = from_jax_params(qt)
    xq = tlin.quantize_act(torch.from_numpy(x).to(torch.bfloat16))
    rows = (xq.q.float() * xq.s).to(torch.bfloat16)
    tb = torch.from_numpy(bias)
    before = tlin.quantize_act.calls
    got = tlin.quantized_matmul(xq, tq, tb, act="gelu", int8=True, emit=emit)
    want = qmatmul_ref(rows, tq.codes, tq.scales, None, tb,
                       epilogue="bias_gelu", emit_quantized=emit)
    if emit == "both":
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1:]
    assert torch.equal(got.q, want[0]) and torch.equal(got.s, want[1])
    res = torch.from_numpy(extra["residual"]).to(torch.bfloat16)
    lns, lnb = (torch.from_numpy(extra[k]) for k in ("ln_scale", "ln_bias"))
    out, oq = tlin.linear_residual_ln(xq, tq, tb, res, lns, lnb, 1e-12,
                                      int8=True, emit="both")
    want = qmatmul_ref(rows, tq.codes, tq.scales, None, tb,
                       epilogue="bias_residual_ln", residual=res,
                       ln_scale=lns, ln_bias=lnb, emit_quantized="both")
    assert torch.equal(out, want[0])
    assert torch.equal(oq.q, want[1]) and torch.equal(oq.s, want[2])
    assert tlin.quantize_act.calls == before


@pytest.mark.parametrize("emit", ["both", "only"])
def test_emission_off_the_cpu_takes_the_kernel_path(emit):
    """Off the CPU there is no plain fallback: at N = 132, which no
    kernel emission takes, the kernel path refuses the call (here on the
    meta device, before any launch) rather than quantizing with
    ``quantize_act``."""
    _, qt, bias, extra = _inputs("q4_0", False, "bias_residual_ln", seed=7,
                                 n=132)
    tq = from_jax_params(qt)
    meta = type(tq)(*(None if t is None else t.to("meta")
                      for t in (tq.codes, tq.scales, tq.mins)),
                    tq.kind, tq.block_axis, tq.packed)
    x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
    b = torch.from_numpy(bias).to("meta")
    before = tlin.quantize_act.calls
    with pytest.raises(ValueError, match="emission does not take"):
        tlin.quantized_matmul(x, meta, b, act="gelu", emit=emit)
    res = torch.empty((M, 132), dtype=torch.bfloat16, device="meta")
    ln = torch.from_numpy(extra["ln_scale"]).to("meta")
    with pytest.raises(ValueError, match="emission does not take"):
        tlin.linear_residual_ln(tlin.ActQ(torch.empty((M, K), dtype=torch.int8,
                                                      device="meta"),
                                          torch.empty((M, 1), device="meta")),
                                meta, b, res, ln, ln, 1e-12, int8=True,
                                emit="both")
    assert tlin.quantize_act.calls == before


@pytest.mark.parametrize("emit", ["both", "only"])
def test_emission_at_a_ragged_shape_runs_the_plain_path(emit):
    """On a CPU tensor, N = 132 has no kernel emission: the plain path
    computes the output and ``quantize_act`` quantizes it — the JAX
    package's non-kernel path, which the same call reaches there."""
    x, qt, bias, _ = _inputs("q4_0", False, "bias", seed=7, n=132)
    tq = from_jax_params(qt)
    before = tlin.quantize_act.calls
    got = tlin.quantized_matmul(torch.from_numpy(x), tq,
                                torch.from_numpy(bias), act="gelu",
                                emit=emit)
    assert tlin.quantize_act.calls == before + 1
    with jlin.pallas_mode("always"):
        ref = jlin.quantized_matmul(jnp.asarray(x), qt, jnp.asarray(bias),
                                    act="gelu", emit=emit, interpret=True)
    if emit == "both":
        np.testing.assert_allclose(got[0].numpy(), _np(ref[0]), rtol=0,
                                   atol=1e-5)
        got, ref = got[1], ref[1]
    assert_codes(got.q.numpy(), got.s, np.asarray(ref.q), ref.s)
