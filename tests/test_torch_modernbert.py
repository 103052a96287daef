"""ModernBERT (and the rotary nomic-bert) in the port against the JAX
package, on the CPU.

(a) ``rope_tables`` / ``apply_rotary[_qkv]`` equal JAX's in both pairing
    conventions (max abs 1e-6 in f32; the inverse frequencies equal JAX's
    bit for bit, so angles agree up to position 8,191).
(b) ``fused_attention_window_ref`` (K6w's plain version) against JAX's
    ``fused_attention_window`` in Pallas interpret mode, banded and
    degenerate walks, ragged rows with an all-pad row: f32 at atol 1e-5
    with the all-pad row exactly 0, bf16 at rtol 2^-6 / atol 2e-3 (K6's
    tolerances: the same expression in another summation order; one bf16
    probability may flip).
(c) ``encode_tokens`` for a tiny ModernBERT (E=128, H=2, 4 layers, 0 and
    3 global, window 128, L=512), q4_0 packed + fused qkv and dense f32,
    through the kernels' plain versions against JAX through its Pallas
    kernels in interpret mode; global layers on K2, and on K6 plain
    (``whole_row_fits`` patched in the port, ``force_stream_mode`` in JAX).
    f32: max abs 2e-4 (dense) or 2e-3 (q4_0, see ``ATOL``) and cosine >=
    0.9999; bf16 activations: cosine >= 0.999. Packed rows (einsum in
    both) at cosine >= 0.9999.
(d) The einsum route at L=16/32 (kernels asked for, L % 128 != 0): every
    layer takes the einsum path with the window in the mask, as in JAX.
(e) Route names and kernels-ok over a grid with ``local_window``, and the
    dispatch at E=768, H=12, 6 layers (kernels stubbed): 2 global calls
    (K2 at L=1,024, K6 at 2,048) and 4 banded ones.
(f) An HF ModernBERT directory written offline by ``transformers`` loads
    in both packages and encodes the same vectors (f32, q4_0), matching
    HF's hidden states.
(g) The port's byte-level BPE gives JAX's ids.
(h) ``check_supported`` takes ModernBERT, nomic-bert and Qwen2's RMSNorm,
    GQA and causal attention, and refuses mixture-of-experts layers and a
    K/V head count that does not divide the query heads.
(i) The trained rotary fixture (nomic-bert: post-LN, RoPE, SwiGLU) in both
    packages on its long STS texts, f32 and q4_0.
"""

import dataclasses
import functools
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JaxConfig
from embeddings_tpu.models import params as JP
from embeddings_tpu.ops import attention as jattn
from embeddings_tpu.ops import rotary as jrot
from embeddings_tpu.runtime import packing as jpacking

from embeddings_tpu_torch.config import KNOWN_MODELS, BertConfig, \
    EngineConfig
from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.ops import rotary as trot
from embeddings_tpu_torch.runtime.engine import load_model

jlin = importlib.import_module("embeddings_tpu.ops.linear")
jbert = importlib.import_module("embeddings_tpu.models.bert")

ROOT = Path(__file__).resolve().parent.parent
ROTARY_FIXTURE = ROOT / "benchmarks" / "fixtures" / "tiny_trained_rotary"
KERNELS = ("fused_attention", "fused_attention_stream",
           "fused_attention_window")

TINY = dict(vocab_size=256, hidden_size=128, num_hidden_layers=4,
            num_attention_heads=2, intermediate_size=256,
            max_position_embeddings=1024, position_embedding_type="rotary",
            rotary_base=160000.0, local_rotary_base=10000.0,
            global_attn_every_n_layers=3, local_attention_window=128,
            gated_mlp=True, norm_style="pre", first_attn_norm_identity=True,
            layer_norm_eps=1e-5, type_vocab_size=1, pooling="cls")

# max abs error of f32-activation embeddings (unit vectors, E=128) against
# JAX. Dense weights: summation-order noise. q4_0: both packages' K1 round
# its f32 input to bf16, so a one-ulp difference upstream (LayerNorm,
# softmax, RoPE) can flip one operand's rounding, which moves an output by
# about 2^-8 * |x| * |w| ~ 4e-4 at these weights; the pre-norm residual
# stream carries it to the end (JAX against itself with one norm scale
# moved one ulp: 1.5e-4; the port against JAX: up to 6.3e-4 on padded
# batches, 1.2e-3 on one element of a packed row; cosine >= 0.9999).
ATOL = {"f32": 2e-4, "q4_0": 2e-3}


# ---------------------------------------------------------------------------
# (a) RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("D,base", [(64, 160000.0), (64, 10000.0),
                                    (32, 1000.0), (128, 10000.0)])
def test_rotary_matches_jax(D, base, interleaved):
    L, B, H = 8192, 2, 3
    pos = np.arange(L)
    jc, js = jrot.rope_tables(jnp.asarray(pos), D, base)
    tc, ts = trot.rope_tables(torch.from_numpy(pos), D, base)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    # inverse frequencies bit for bit (one ulp moves an angle at 8,191)
    half = D // 2
    want = np.asarray(base ** (-jnp.arange(0, half, dtype=jnp.float32)
                               / half))
    np.testing.assert_array_equal(trot._inv_freq(D, base).numpy(), want)
    rng = np.random.default_rng(D)
    x = rng.standard_normal((1, 64, H, D), dtype=np.float32)
    sl = slice(L - 64, L)   # the positions where libraries part
    got = trot.apply_rotary(torch.from_numpy(x), tc[sl], ts[sl], interleaved)
    ref = jrot.apply_rotary(jnp.asarray(x), jc[sl], js[sl], interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # packed rows: per-row positions [B, L]
    ppos = rng.integers(0, 300, (B, 40))
    qkv = rng.standard_normal((B, 40, 3 * H * D), dtype=np.float32)
    got = trot.apply_rotary_qkv(torch.from_numpy(qkv),
                                *trot.rope_tables(torch.from_numpy(ppos), D,
                                                  base),
                                H=H, D=D, interleaved=interleaved)
    ref = jrot.apply_rotary_qkv(jnp.asarray(qkv),
                                *jrot.rope_tables(jnp.asarray(ppos), D, base),
                                H=H, D=D, interleaved=interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # the cached device tables are the same numbers
    c, s = trot.rope_tables_for(L, D, base, "cpu")
    assert torch.equal(c, tc) and torch.equal(s, ts)


# ---------------------------------------------------------------------------
# (b) K6w's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _inputs(B, L, H, D, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B * L, 3 * H * D), dtype=np.float32)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[-1] = L - 37 if B == 1 else L
    if B > 1:
        lengths[0] = 0
    return qkv, lengths


def _jax_window(qkv, lengths, B, L, H, D, window, dtype):
    out = jattn.fused_attention_window(
        jnp.asarray(qkv, dtype), jnp.asarray(lengths), B=B, L=L, H=H, D=D,
        window=window, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port_window(qkv, lengths, B, L, H, D, window, dtype):
    out = tattn.fused_attention_window(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(lengths), B=B, L=L,
        H=H, D=D, window=window)
    assert out.dtype == dtype
    return out.float().numpy()


K6W_CASES = [(2, 128, 4, 32, 8), (2, 256, 2, 64, 128), (2, 384, 2, 64, 128),
             (2, 512, 2, 64, 128), (1, 1024, 2, 64, 384), (2, 512, 2, 64, 8)]


@pytest.mark.parametrize("B,L,H,D,window", K6W_CASES)
def test_window_ref_matches_jax_f32(B, L, H, D, window):
    qkv, lengths = _inputs(B, L, H, D, seed=L + window)
    ref = _jax_window(qkv, lengths, B, L, H, D, window, jnp.float32)
    got = _port_window(qkv, lengths, B, L, H, D, window, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if B > 1:
        assert np.all(got.reshape(B, L, -1)[0] == 0)  # the all-pad row


@pytest.mark.parametrize("B,L,H,D,window", [K6W_CASES[0], K6W_CASES[3],
                                            K6W_CASES[5]])
def test_window_ref_matches_jax_bf16(B, L, H, D, window):
    qkv, lengths = _inputs(B, L, H, D, seed=11)
    ref = _jax_window(qkv, lengths, B, L, H, D, window, jnp.bfloat16)
    got = _port_window(qkv, lengths, B, L, H, D, window, torch.bfloat16)
    np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2e-3)


def test_window_ref_is_the_banded_math():
    """The block walk changes only the summation order: K6w's plain version
    equals dense prefix attention with the |i-j| <= w//2 band in the mask
    (the same exp2/clamp math), and with a window past the row it equals
    K6 plain."""
    B, L, H, D = 2, 512, 2, 64
    qkv, lengths = _inputs(B, L, H, D, seed=5)
    t, lens = torch.from_numpy(qkv), torch.from_numpy(lengths)
    for window in (8, 128, 300):
        got = tattn.fused_attention_window(t, lens, B=B, L=L, H=H, D=D,
                                           window=window)
        q, k, v = tattn._split_heads(t, B, L, H, D)
        s = (q @ k.transpose(-1, -2)) * tattn._scale(D)
        i = torch.arange(L)
        band = (i[:, None] - i[None, :]).abs() <= window // 2
        ok = band & (i[None, None, :] < lens[:, None, None])
        p = torch.where(ok[:, None], torch.exp2(s.clamp(-100,
                                                        tattn._clamp_hi(L))),
                        torch.zeros(()))
        want = tattn._merge_heads(p @ v, p.sum(-1, keepdim=True),
                                  torch.float32, B, L, H, D)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
    wide = tattn.fused_attention_window(t, lens, B=B, L=L, H=H, D=D,
                                        window=2 * L)
    plain = tattn.fused_attention_stream(t, lens, B=B, L=L, H=H, D=D, BK=128)
    np.testing.assert_allclose(wide.numpy(), plain.numpy(), rtol=0,
                               atol=1e-6)


def test_window_wrapper_rejects_bad_operands():
    qkv = torch.zeros(2 * 128, 3 * 128)
    lens = torch.full((2,), 128, dtype=torch.int32)
    with pytest.raises(ValueError):   # L % 128 != 0
        tattn.fused_attention_window(torch.zeros(2 * 64, 3 * 128), lens,
                                     B=2, L=64, H=2, D=64, window=8)
    with pytest.raises(ValueError):
        tattn.fused_attention_window(qkv, lens, B=2, L=128, H=2, D=64,
                                     window=0)
    with pytest.raises(ValueError):   # lengths not [B]
        tattn.fused_attention_window(qkv, lens[:1], B=2, L=128, H=2, D=64,
                                     window=8)
    assert tattn.window_span(128) == 1 and tattn.window_span(384) == 2
    assert tattn.window_span(8) == 1 and tattn.window_span(512) == 2


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 127, 128, 129, "L"])
@pytest.mark.parametrize("L", [128, 384, 1024, 8192])
@pytest.mark.parametrize("window", [8, 128, 384, 2048])
def test_band_tiles_are_the_band(window, L, length):
    """K6w's key-tile range (``band_tiles``, the kernel's arithmetic, at
    W = ``band_half(window, L)``) for every 128-row query block and every
    64-row consumer warpgroup, against a brute-force band-and-length mask
    of the block's rows: every valid (i, j) pair (j < length, |i - j| <=
    window // 2) lies in a tile of the range, every tile outside it holds
    none, and so does no tile at the range's ends (the range is exactly
    the tiles that hold one)."""
    n = L if length == "L" else min(length, L)
    W = tattn.band_half(window, L)
    half = window // 2
    tiles = torch.arange(L // 128)
    # each row i's valid keys are one interval, max(0, i - half) ..
    # min(n, i + half + 1) - 1, so the tiles it touches are one range
    i = torch.arange(L)
    lo, hi = (i - half).clamp_min(0), (i + half + 1).clamp_max(n)
    row_tiles = ((tiles >= lo[:, None] // 128)
                 & (tiles <= (hi[:, None] - 1) // 128) & (lo < hi)[:, None])
    if L <= 1024:
        # that closed form against the brute-force pair mask [L, L]
        j = torch.arange(L)
        ok = ((i[:, None] - j[None, :]).abs() <= half) & (j < n)
        assert torch.equal(row_tiles, ok.reshape(L, L // 128, 128).any(2))
    for rows in (128, 64):
        # every query block at once: [blocks, rows, tiles] -> [blocks, tiles]
        q0s = range(0, L, rows)
        held = row_tiles.reshape(len(q0s), rows, L // 128).any(1)
        ranges = [tattn.band_tiles(q0, rows, W, n) for q0 in q0s]
        for first, count in ranges:
            assert count >= 0 and first + count <= L // 128
        walked = torch.stack([(tiles >= first) & (tiles < first + count)
                              for first, count in ranges])
        bad = (walked != held).any(1).nonzero().flatten().tolist()
        assert not bad, [(rows, q0s[b], ranges[b],
                          held[b].nonzero().flatten().tolist())
                         for b in bad[:3]]


# ---------------------------------------------------------------------------
# (c) encode_tokens against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

def _jax_params(kind, **over):
    """JAX init with trained-scale weights (std 0.1), q4_0 packed or
    dense, q/k/v fused."""
    jcfg = JaxConfig(**{**TINY, **over})
    jp = JP.init_params(jcfg, 0)
    rng = np.random.default_rng(1)
    for group in ("attn", "mlp"):
        for name, lin in jp["layers"][group].items():
            if "w" in lin:
                lin["w"] = jnp.asarray(rng.standard_normal(
                    lin["w"].shape, dtype=np.float32) * 0.1)
    if kind == "q4_0":
        jp = JP.pack_q4_params(JP.quantize_params(jp, "q4_0"))
    return jcfg, JP.fuse_qkv(jp)


@functools.lru_cache(maxsize=None)
def _models(kind):
    jcfg, jp = _jax_params(kind)
    return jcfg, jp, BertConfig(**TINY), P.from_jax_params(jp)


def _batch(B, L, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 256, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L // 3:] = 0
    if B > 2:
        mask[2, 1:] = 0
    return ids, mask


def _jax_kernels(monkeypatch, jp, jcfg, ids, mask, **kw):
    """JAX forward through its Pallas kernels in interpret mode."""
    with monkeypatch.context() as m:
        for name in KERNELS:
            m.setattr(jattn, name, functools.partial(getattr(jattn, name),
                                                     interpret=True))
        with jlin.pallas_mode("always"), jlin.interpret_mode():
            return np.asarray(jbert.encode_tokens(
                jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), **kw))


def _spy_port(monkeypatch):
    """Count the port's attention wrapper calls, by wrapper name."""
    calls = []
    for name in KERNELS:
        orig = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, functools.partial(
            lambda *a, _n=name, _f=orig, **k: calls.append(_n) or _f(*a, **k)))
    return calls


def _port(tp, cfg, ids, mask, **kw):
    return tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                               torch.from_numpy(mask), **kw).numpy()


@pytest.mark.parametrize("kind", ["q4_0", "f32"])
@pytest.mark.parametrize("glob", ["fused_attention", "fused_attention_stream"])
def test_encode_tokens_matches_jax_kernels_f32(monkeypatch, kind, glob):
    jcfg, jp, cfg, tp = _models(kind)
    ids, mask = _batch(3, 512, seed=3)
    with monkeypatch.context() as m:
        if glob == "fused_attention_stream":
            m.setattr(tattn, "whole_row_fits", lambda *a, **k: False)
            with jattn.force_stream_mode():
                ref = _jax_kernels(m, jp, jcfg, ids, mask)
        else:
            ref = _jax_kernels(m, jp, jcfg, ids, mask)
        calls = _spy_port(m)
        got = _port(tp, cfg, ids, mask)
    w = "fused_attention_window"
    assert calls == [glob, w, w, glob]
    assert got.shape == (3, 128) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= ATOL[kind]
    assert (got * ref).sum(-1).min() >= 0.9999


def test_encode_tokens_matches_jax_kernels_bf16(monkeypatch):
    jcfg, jp, cfg, tp = _models("q4_0")
    ids, mask = _batch(3, 512, seed=5)
    ref = _jax_kernels(monkeypatch, jp, jcfg, ids, mask,
                       compute_dtype="bfloat16")
    got = _port(tp, cfg, ids, mask, compute_dtype=torch.bfloat16)
    assert (got * ref).sum(-1).min() >= 0.999


def test_window_matters():
    """The local layers' window changes the output (a test at these sizes
    would pass with the window ignored otherwise)."""
    _, _, cfg, tp = _models("f32")
    ids, mask = _batch(2, 512, seed=4)
    got = _port(tp, cfg, ids, mask)
    wide = _port(tp, dataclasses.replace(cfg, local_attention_window=0),
                 ids, mask)
    assert np.abs(got - wide).max() > 1e-3


def test_encode_tokens_plain_path_matches_jax_default():
    """The port's plain path (use_kernels=False: einsum with the window in
    the mask) is the JAX package's XLA fallback arithmetic."""
    jcfg, jp, cfg, tp = _models("q4_0")
    ids, mask = _batch(3, 256, seed=6)
    ref = np.asarray(jbert.encode_tokens(jp, jcfg, jnp.asarray(ids),
                                         jnp.asarray(mask)))
    got = _port(tp, cfg, ids, mask, use_kernels=False)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_encode_packed_matches_jax(monkeypatch):
    """Packed ModernBERT rows: per-segment positions drive both RoPE
    tables and the window; einsum attention in both packages."""
    jcfg, jp, cfg, tp = _models("q4_0")
    rng = np.random.default_rng(9)
    toks = [list(rng.integers(5, 256, int(k)))
            for k in rng.integers(4, 60, 20)]
    b = jpacking.plan_packing([len(t) for t in toks], 128, 8, max_segs=8)[0]
    arrays = jpacking.materialize(b, toks, 0, "cls")
    with jlin.pallas_mode("always"), jlin.interpret_mode():
        ref = np.asarray(jbert.encode_packed(
            jp, jcfg, *(jnp.asarray(a) for a in arrays[:4])))
    calls = _spy_port(monkeypatch)
    got = tbert.encode_packed(tp, cfg, *(torch.from_numpy(np.asarray(a))
                                         for a in arrays[:4])).numpy()
    assert calls == []
    assert min(float((got[r, s] * ref[r, s]).sum())
               for r, s, _ in arrays[4]) >= 0.9999
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL["q4_0"])


# ---------------------------------------------------------------------------
# (d) the einsum route where L % 128 != 0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [16, 32])
def test_short_buckets_take_einsum_like_jax(monkeypatch, L):
    jcfg, jp, cfg, tp = _models("q4_0")
    ids, mask = _batch(3, L, seed=L)
    ref = _jax_kernels(monkeypatch, jp, jcfg, ids, mask)
    calls = _spy_port(monkeypatch)
    got = _port(tp, cfg, ids, mask)
    assert calls == []   # not K2 on the global layers either
    assert np.abs(got - ref).max() <= ATOL["q4_0"]
    assert (got * ref).sum(-1).min() >= 0.9999


# ---------------------------------------------------------------------------
# (e) routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("force", [False, True])
def test_route_names_match_jax(monkeypatch, force):
    if force:
        monkeypatch.setattr(tattn, "whole_row_fits", lambda *a, **k: False)
    for L in (16, 128, 256, 512, 1024, 1792, 1920, 2048, 8192):
        for E in (128, 768):
            for seg, w in ((False, 0), (True, 0), (True, 3)):
                for local in (False, True):
                    for bias in (False, True):
                        with jattn.force_stream_mode(force):
                            want = jbert.attention_route_name(
                                L, E // 64, 64, E, seg, w, bias, local,
                                False, False)
                        got = tbert.attention_route_name(
                            L, E, segmented=seg, attn_window=w, bias=bias,
                            local_window=local)
                        assert got == want, (L, E, seg, w, local, bias)


def test_kernels_ok_matches_jax():
    """``fused_attention_ok`` against JAX's ``_attn_kernels_ok`` at the
    head dims the port's kernels are built for, with and without a local
    window."""
    for L in (16, 24, 128, 256, 384, 512, 520, 1024, 1920, 2048, 8192):
        for H, D in ((2, 64), (4, 32), (12, 64), (1, 128), (2, 128)):
            for seg in (None, "s"):
                for local in (None, (1.0, 128)):
                    want = (jbert._attn_kernels_ok(L, H, D, seg, local,
                                                   None)
                            and D in tattn.KERNEL_HEAD_DIMS)
                    got = tbert.fused_attention_ok(
                        L, H, D, True, None if seg else "lengths", seg,
                        None, local)
                    assert got == want, (L, H, D, seg, local)


WIDE = dict(TINY, vocab_size=64, hidden_size=768, num_hidden_layers=6,
            num_attention_heads=12, intermediate_size=128,
            max_position_embeddings=2048)


@pytest.mark.parametrize("L,glob", [(1024, "fused_attention"),
                                    (2048, "fused_attention_stream")])
def test_dispatch_at_real_width(monkeypatch, L, glob):
    """Which kernel each layer dispatches at E=768, H=12 (kernels
    stubbed): layers 0 and 3 global, 1, 2, 4, 5 banded; JAX's lax.cond
    traces the same two kernels."""
    jcfg, cfg = JaxConfig(**WIDE), BertConfig(**WIDE)
    jp = JP.init_params(jcfg, 0)
    tp = P.from_jax_params(jp)
    ids = np.full((1, L), 7, np.int32)
    mask = np.ones((1, L), np.int32)
    want = set()
    for name in KERNELS:
        monkeypatch.setattr(jattn, name, functools.partial(
            lambda qkv, *a, _n=name, **k: want.add(_n)
            or jnp.zeros((qkv.shape[0], qkv.shape[1] // 3), qkv.dtype)))
    with jlin.pallas_mode("always"):
        jbert.encode_tokens(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    calls = []
    for name in KERNELS:
        monkeypatch.setattr(tattn, name, functools.partial(
            lambda qkv, *a, _n=name, **k: calls.append(_n)
            or torch.zeros(qkv.shape[0], qkv.shape[1] // 3)))
    _port(tp, cfg, ids, mask)
    w = "fused_attention_window"
    assert calls == [glob, w, w, glob, w, w]
    assert set(calls) == want == {glob, w}


# ---------------------------------------------------------------------------
# (f), (g) an HF ModernBERT directory and its BPE tokenizer
# ---------------------------------------------------------------------------

SPECIALS = ["[PAD]", "[CLS]", "[SEP]", "[UNK]", "[MASK]"]
CORPUS = ["The quick brown fox jumps over the lazy dog.",
          "Sentence embeddings are useful for retrieval and clustering!",
          "I don't think it's over; they've said they'll win.",
          "Numbers: 123 4567 3.14159 and symbols <>|&^~",
          "hello world", "walking talking reading writing"]
PROMPTS = CORPUS + ["", " leading space", "trailing space ", "éè ü ß",
                    "你好", "emoji \U0001f600 end", "tab\tnew\nline",
                    "a" * 200, ("word " * 120).strip()]


@pytest.fixture(scope="module")
def hf_modernbert_dir(tmp_path_factory):
    """config.json + pytorch_model.bin + a trained byte-level BPE
    tokenizer.json with ModernBERT's [CLS]-style specials."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import ModernBertConfig, ModernBertModel
    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(CORPUS * 3, trainers.BpeTrainer(
        vocab_size=320, min_frequency=1, show_progress=False,
        special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    hf_cfg = ModernBertConfig(
        vocab_size=320, hidden_size=128, num_hidden_layers=4,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=512, global_attn_every_n_layers=3,
        local_attention=16, global_rope_theta=160000.0,
        local_rope_theta=10000.0, pad_token_id=0, cls_token_id=1,
        sep_token_id=2, attention_dropout=0.0, mlp_dropout=0.0,
        embedding_dropout=0.0)
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = ModernBertModel(hf_cfg).eval()
    d = tmp_path_factory.mktemp("modernbert")
    (d / "config.json").write_text(json.dumps(
        {**hf_cfg.to_dict(), "model_type": "modernbert"}))
    torch.save(model.state_dict(), d / "pytorch_model.bin")
    tok.save(str(d / "tokenizer.json"))
    return d, model


def test_bpe_ids_match_jax(hf_modernbert_dir):
    from embeddings_tpu.tokenizer import tokenizer_from_dir as jax_tok
    from embeddings_tpu_torch.tokenizer import ByteLevelBPETokenizer, \
        tokenizer_from_dir
    d, _ = hf_modernbert_dir
    ours, ref = tokenizer_from_dir(d), jax_tok(d)
    assert isinstance(ours, ByteLevelBPETokenizer)
    assert (ours.cls_id, ours.sep_id, ours.pad_id, ours.unk_id) == \
        (ref.cls_id, ref.sep_id, ref.pad_id, ref.unk_id) == (1, 2, 0, 3)
    assert len(ours.merge_ranks) > 0
    for p in PROMPTS:
        assert ours.encode(p) == ref.encode(p), p
        assert ours.encode(p, max_len=16) == ref.encode(p, max_len=16), p
        assert ours.decode(ours.encode(p)) == ref.decode(ref.encode(p))


@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_hf_modernbert_dir_matches_jax(hf_modernbert_dir, dtype):
    from embeddings_tpu.runtime.engine import load_model as jax_load
    d, model = hf_modernbert_dir
    je = jax_load(d, dtype=dtype)
    te = load_model(d, dtype=dtype, device="cpu")
    assert te.config.norm_style == "pre" and "final_ln" in te.params
    assert "position" not in te.params["embeddings"]
    # einsum (L=16) and kernel (L=128: K2 + K6w) buckets
    assert te.warmup(batch_sizes=(2,), seq_lens=(16, 128)) == 2
    texts = ["hello world", "the lazy dog", "hello world",
             " ".join(CORPUS * 2)]      # the last one: the L=512 bucket
    for t in texts:
        assert te.tokenize(t) == je.tokenize(t)
    assert 256 < len(te.tokenize(texts[-1])) <= 512
    ref = je.encode_batch(texts)
    got = te.encode_batch(texts)
    np.testing.assert_array_equal(got[0], got[2])
    if dtype == "f32":
        # the L=512 row runs the kernels' plain versions (exp2/clamp), the
        # JAX default path the softmax einsum: f32 noise
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        # and HF's own forward, CLS-pooled... HF pools nothing: compare
        # hidden states at the JAX package's tolerance
        ids = np.asarray([te.tokenize(texts[-1])], np.int64)
        with torch.no_grad():
            want = model(input_ids=torch.from_numpy(ids)
                         ).last_hidden_state[0].numpy()
        h = tbert.encode_tokens(te.params, te.config, torch.from_numpy(ids),
                                torch.ones_like(torch.from_numpy(ids)),
                                return_hidden=True)[0].numpy()
        np.testing.assert_allclose(h, want, atol=3e-4, rtol=1e-3)
    else:
        # bf16 operands + tanh GELU (port's K1) vs f32 + erf (JAX fallback)
        assert (got * ref).sum(-1).min() >= 0.999
        plain = load_model(d, dtype=dtype, device="cpu",
                           engine_config=EngineConfig(use_pallas="never",
                                                      max_seq_len=512))
        np.testing.assert_allclose(plain.encode_batch(texts), ref, rtol=0,
                                   atol=2e-5)


def test_weights_across_from_jax():
    """from_jax_params carries a JAX ModernBERT tree unchanged: codes,
    scales, norms and final_ln, through quantize + pack + fuse."""
    jcfg = JaxConfig(**TINY)
    jp = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(
        JP.init_params(jcfg, 3), "q4_0")))
    tp = P.from_jax_params(jp)
    assert set(tp) == set(jp) and "final_ln" in tp
    for a, b in ((tp["layers"]["attn"]["qkv"]["w"],
                  jp["layers"]["attn"]["qkv"]["w"]),
                 (tp["layers"]["mlp"]["gate"]["w"],
                  jp["layers"]["mlp"]["gate"]["w"])):
        np.testing.assert_array_equal(a.codes.numpy(), np.asarray(b.codes))
        np.testing.assert_array_equal(a.scales.numpy(), np.asarray(b.scales))
        assert a.packed and b.packed
    np.testing.assert_array_equal(tp["final_ln"]["scale"].numpy(),
                                  np.asarray(jp["final_ln"]["scale"]))
    # and the port's own quantize/pack/fuse of the same dense tree
    dense = P.from_jax_params(JP.init_params(jcfg, 3))
    mine = P.fuse_qkv(P.pack_q4_params(P.quantize_params(dense, "q4_0")))
    assert torch.equal(mine["layers"]["attn"]["qkv"]["w"].codes,
                       tp["layers"]["attn"]["qkv"]["w"].codes)
    assert "final_ln" in mine and "position" not in mine["embeddings"]
    init = P.init_params(BertConfig(**TINY), 0)
    assert "final_ln" in init and "position" not in init["embeddings"]


# ---------------------------------------------------------------------------
# (h) check_supported
# ---------------------------------------------------------------------------

def test_check_supported():
    P.check_supported(BertConfig(**KNOWN_MODELS["gte-modernbert-base"]))
    P.check_supported(BertConfig(**KNOWN_MODELS["nomic-embed-text-v1.5"]))
    base = BertConfig(**TINY)
    for over in (dict(norm_type="rmsnorm"), dict(num_key_value_heads=1),
                 dict(causal=True)):
        P.check_supported(dataclasses.replace(base, **over))
    P.check_supported(BertConfig(**KNOWN_MODELS["gte-Qwen2-1.5B-instruct"]))
    with pytest.raises(NotImplementedError, match="num_key_value_heads"):
        P.check_supported(dataclasses.replace(base, num_attention_heads=3,
                                              num_key_value_heads=2))
    moe = BertConfig(**KNOWN_MODELS["nomic-embed-text-v2-moe"])
    P.check_supported(moe)  # the MoE interleave runs since it was ported
    with pytest.raises(NotImplementedError, match="num_experts"):
        P.check_supported(dataclasses.replace(moe, moe_every_n_layers=3))


# ---------------------------------------------------------------------------
# (i) the trained rotary fixture (nomic-bert)
# ---------------------------------------------------------------------------

def _rotary_texts(n):
    rows = (ROTARY_FIXTURE / "sts-test-long.tsv").read_text().splitlines()
    return [r.split("\t")[1] for r in rows[:n]]


@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_trained_rotary_fixture_matches_jax(monkeypatch, dtype):
    from embeddings_tpu.runtime.engine import load_model as jax_load
    texts = _rotary_texts(3)
    je = jax_load(ROTARY_FIXTURE / "model", dtype=dtype)
    te = load_model(ROTARY_FIXTURE / "model", dtype=dtype, device="cpu")
    assert te.config.position_embedding_type == "rotary"
    assert te.config.gated_mlp and te.config.hidden_act == "silu"
    assert te.config.pooling == je.config.pooling == "mean"
    for t in texts:
        assert te.tokenize(t) == je.tokenize(t)
        assert len(te.tokenize(t)) > 512   # past the 512 bucket
    ref = je.encode_batch(texts)
    calls = _spy_port(monkeypatch)
    got = te.encode_batch(texts)
    assert set(calls) == {"fused_attention"}  # RoPE, then K2's plain version
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    else:
        assert (got * ref).sum(-1).min() >= 0.999
        plain = load_model(ROTARY_FIXTURE / "model", dtype=dtype,
                           device="cpu", engine_config=EngineConfig(
                               use_pallas="never", max_seq_len=2048))
        np.testing.assert_allclose(plain.encode_batch(texts), ref, rtol=0,
                                   atol=2e-5)
