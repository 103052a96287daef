"""Causal attention with ALiBi (K6ca: the streamed K6 kernel with both
masks) in the port against the JAX package, on the CPU.

(a) ``fused_attention_stream(causal=True, alibi_slopes=...)`` (K6ca's
    plain version on a CPU tensor) against JAX's ``fused_attention_stream``
    with the same arguments in Pallas interpret mode: H = 2 and 4, BK =
    128 and 256, ragged lengths including rows shorter than one 64-key
    tile and an empty row, and at L=384 lengths on the CUDA kernel's
    128-key tile edges ({0, 1, 63, 64, 65, 127, 128, 129, L}). f32 at
    atol 1e-5 with the len-0 row exactly 0
    (the same expression, summed in another f32 order); bf16 at rtol
    2^-6 / atol 2e-3 (one probability on a bf16 rounding boundary may
    flip), as K6c's tests.
(b) A 2-layer ``BertConfig(position_embedding_type="alibi", causal=True,
    gated_mlp=True)`` forward, q4_0 packed and dense f32, through the
    weight handoff (``from_jax_params``), K7's cap lowered in both
    packages so the port's rows take the streamed route: the port, whose
    every layer calls ``fused_attention_stream`` with the causal flag and
    the slopes (K6ca's plain version), against JAX's einsum path, which
    folds the ALiBi bias and the causal triangle into its mask. JAX's own
    kernel route does not serve this config causally: its post-LN stack
    does not hand ``causal`` to attention, and its stream kernel then
    runs without the triangle it folded for the einsum path; the test
    shows that too. Cosine >= 0.9999 and max abs (unit vectors) 2e-4 in
    f32, as the families' tests, 5e-3 with q4_0 (the port's kernel path
    rounds the matmuls' operands to bf16, JAX's einsum path does not). The route name is JAX's
    ("stream_alibi"), and changing a row's last token moves only its last
    position's hidden state.
"""

import functools
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JaxConfig
from embeddings_tpu.models import params as JP
from embeddings_tpu.ops import attention as jattn

from embeddings_tpu_torch.config import BertConfig
from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.ops.alibi import alibi_slopes

jlin = importlib.import_module("embeddings_tpu.ops.linear")
jbert = importlib.import_module("embeddings_tpu.models.bert")

# ---------------------------------------------------------------------------
# (a) the kernel's plain version against JAX's Pallas kernel
# ---------------------------------------------------------------------------

B = 5
# lengths on the Hopper kernel's tile edges (128 keys), at L=384
EDGES = (0, 1, 63, 64, 65, 127, 128, 129)


def _inputs(L, H, D, seed):
    """qkv and lengths: full, ragged, shorter than one 64-key tile (40 and
    1), empty; at L=384 the tile edges and L (B = len(lengths))."""
    lengths = EDGES + (L,) if L == 384 else (L, L - 37, 40, 1, 0)
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((len(lengths) * L, 3 * H * D),
                              dtype=np.float32)
    return qkv, np.array(lengths, np.int32)


def _jax(qkv, lengths, L, H, D, BK, dtype):
    out = jattn.fused_attention_stream(
        jnp.asarray(qkv, dtype), jnp.asarray(lengths), B=len(lengths), L=L,
        H=H, D=D, BK=BK, causal=True, alibi_slopes=tuple(alibi_slopes(H)),
        interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(qkv, lengths, L, H, D, BK, dtype):
    out = tattn.fused_attention_stream(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(lengths),
        B=len(lengths), L=L, H=H, D=D, BK=BK, causal=True,
        alibi_slopes=alibi_slopes(H))
    assert out.dtype == dtype
    return out.float().numpy()


CASES = [(256, 2, 64, 128), (256, 2, 64, 256), (256, 4, 32, 128),
         (512, 4, 32, 256), (384, 4, 32, 128), (384, 2, 64, 128)]


@pytest.mark.parametrize("L,H,D,BK", CASES)
def test_causal_alibi_matches_jax_f32(L, H, D, BK):
    qkv, lengths = _inputs(L, H, D, seed=L + H)
    ref = _jax(qkv, lengths, L, H, D, BK, jnp.float32)
    got = _port(qkv, lengths, L, H, D, BK, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    zero = list(lengths).index(0)
    assert np.all(got.reshape(len(lengths), L, -1)[zero] == 0)  # len 0


@pytest.mark.parametrize("L,H,D,BK", [CASES[0], CASES[2], CASES[5]])
def test_causal_alibi_matches_jax_bf16(L, H, D, BK):
    qkv, lengths = _inputs(L, H, D, seed=7 * H)
    ref = _jax(qkv, lengths, L, H, D, BK, jnp.bfloat16)
    got = _port(qkv, lengths, L, H, D, BK, torch.bfloat16)
    np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2e-3)


def test_causal_alibi_is_both_masks():
    """Dense math: key j of query i adds exp2(clamp(s - slope_h * |i-j| *
    log2(e))) iff j < len and j <= i, the clamp sized to all L keys; the
    first query row of a sequence is its first value row."""
    L, H, D = 256, 2, 64
    qkv, lengths = _inputs(L, H, D, seed=3)
    t, lens = torch.from_numpy(qkv), torch.from_numpy(lengths)
    slopes = alibi_slopes(H)
    got = tattn.fused_attention_stream(t, lens, B=B, L=L, H=H, D=D, BK=128,
                                       causal=True, alibi_slopes=slopes)
    q, k, v = tattn._split_heads(t, B, L, H, D)
    i = torch.arange(L)
    dist = (i[:, None] - i[None, :]).abs().float() * tattn.LOG2E
    s = (q @ k.transpose(-1, -2)) * tattn._scale(D) - \
        torch.as_tensor(slopes)[None, :, None, None] * dist
    ok = (i[None, :] <= i[:, None]) & (i[None, None, :] < lens[:, None, None])
    p = torch.where(ok[:, None], torch.exp2(s.clamp(-100,
                                                    tattn._clamp_hi(L))),
                    torch.zeros(()))
    want = tattn._merge_heads(p @ v, p.sum(-1, keepdim=True), torch.float32,
                              B, L, H, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    E = H * D
    np.testing.assert_allclose(got[0].numpy(), qkv[0, 2 * E:], rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# (b) a causal ALiBi model's forward
# ---------------------------------------------------------------------------

CONFIG = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=256, pooling="mean",
              max_position_embeddings=512, position_embedding_type="alibi",
              gated_mlp=True, causal=True)


@functools.lru_cache(maxsize=None)
def _models(kind):
    """JAX init with trained-scale weights (std 0.1), q4_0 packed or
    dense, q/k/v fused; the port's tree from the JAX one."""
    jcfg = JaxConfig(**CONFIG)
    jp = JP.init_params(jcfg, 0)
    rng = np.random.default_rng(1)
    for group in ("attn", "mlp"):
        for lin in jp["layers"][group].values():
            if "w" in lin:
                lin["w"] = jnp.asarray(rng.standard_normal(
                    lin["w"].shape, dtype=np.float32) * 0.1)
    if kind == "q4_0":
        jp = JP.pack_q4_params(JP.quantize_params(jp, "q4_0"))
    jp = JP.fuse_qkv(jp)
    return jcfg, jp, BertConfig(**CONFIG), P.from_jax_params(jp)


def _batch(L, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 256, (3, L)).astype(np.int32)
    mask = np.ones((3, L), np.int32)
    mask[1, L // 3:] = 0
    mask[2, 1:] = 0
    return ids, mask


# max abs error on unit vectors: f32 is the same arithmetic in another
# summation order; q4_0's matmuls in the port's kernel path take bf16
# operands (K1's rounding), JAX's einsum path multiplies in f32
ATOL = {"f32": 2e-4, "q4_0": 5e-3}


@pytest.mark.parametrize("kind", ["q4_0", "f32"])
def test_causal_alibi_forward_matches_jax(monkeypatch, kind):
    L = 128
    jcfg, jp, cfg, tp = _models(kind)
    ids, mask = _batch(L, seed=11)
    # K7's cap lowered in both packages: the streamed route at a CPU size
    monkeypatch.setattr(jattn, "bias_supported", lambda *a: False)
    monkeypatch.setattr(tattn, "bias_supported", lambda *a: False)
    with jlin.pallas_mode("never"):
        ref = np.asarray(jbert.encode_tokens(jp, jcfg, jnp.asarray(ids),
                                             jnp.asarray(mask)))
    jcalls = []
    jstream = jattn.fused_attention_stream

    def jspy(*a, **kw):
        jcalls.append(kw.get("causal"))
        return jstream(*a, **kw, interpret=True)

    with monkeypatch.context() as m:
        m.setattr(jattn, "fused_attention_stream", jspy)
        with jlin.pallas_mode("always"), jlin.interpret_mode():
            jkern = np.asarray(jbert.encode_tokens(
                jp, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    calls = []
    tstream = tattn.fused_attention_stream

    def tspy(*a, **kw):
        calls.append((kw.get("causal"), kw.get("alibi_slopes")))
        return tstream(*a, **kw)

    monkeypatch.setattr(tattn, "fused_attention_stream", tspy)
    got = tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    H = cfg.num_attention_heads
    assert len(calls) == cfg.num_hidden_layers
    for causal, slopes in calls:
        assert causal is True
        np.testing.assert_allclose(np.asarray(slopes, np.float32),
                                   alibi_slopes(H), rtol=0, atol=0)
    assert got.shape == (3, 128) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= ATOL[kind]
    assert (got * ref).sum(-1).min() >= 0.9999
    # JAX's kernel route: the stream kernel without the causal flag, and
    # an answer other than its einsum path's
    assert jcalls and not any(jcalls)
    assert np.abs(jkern - ref).max() > 1e-2
    E, D = cfg.hidden_size, cfg.head_dim
    want = jbert.attention_route_name(L, H, D, E, False, 0, False, False,
                                      True, True)
    assert tbert.attention_route_name(L, E, alibi=True, causal=True) == \
        want == "stream_alibi"


def test_causal_alibi_forward_sees_only_the_past(monkeypatch):
    """Causality end to end: changing the last real token of a row moves
    only that row's last position's hidden state; the earlier positions
    stay bit-identical."""
    monkeypatch.setattr(tattn, "bias_supported", lambda *a: False)
    _, _, cfg, tp = _models("f32")
    ids, mask = _batch(128, seed=4)
    ids2 = ids.copy()
    ids2[0, -1] = (ids2[0, -1] + 1) % 256 or 5
    h = [tbert.encode_tokens(tp, cfg, torch.from_numpy(i),
                             torch.from_numpy(mask),
                             return_hidden=True).numpy() for i in (ids, ids2)]
    np.testing.assert_array_equal(h[0][0, :-1], h[1][0, :-1])
    assert np.abs(h[0][0, -1] - h[1][0, -1]).max() > 0
