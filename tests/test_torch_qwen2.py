"""The Qwen2 decoder embedders (gte-Qwen2: RMSNorm pre-norm blocks,
grouped-query attention, SwiGLU, RoPE, causal or bidirectional attention,
last-token pooling) in the port against the JAX package, on the CPU.

(a) ``fused_attention_stream_ref(causal=True)`` (K6c's plain version)
    against JAX's ``fused_attention_stream(causal=True)`` in Pallas
    interpret mode, D=64 and 128, L=256 and 512, lengths {L, L-37, 1, 0},
    and D=32 and 64 at L=384 with lengths on the CUDA kernel's 128-key
    tile edges ({0, 1, 63, 64, 65, 127, 128, 129, L}):
    f32 at atol 1e-5 with the len-0 row exactly 0 (the same expression in
    another f32 summation order), bf16 at rtol 2^-6 / atol 2e-3 (one
    probability on a bf16 rounding boundary may flip), as K6's tests; the
    triangular math directly, and with ALiBi slopes against JAX's
    (``tests/test_torch_causal_alibi.py`` holds K6ca further).
(b) ``rms_norm`` against JAX's (f32 at 1e-6; bf16 output within one ulp).
(c) Grouped-query attention: ``attention_context`` with separate q/k/v of
    unequal width against JAX's, on the einsum path and on the kernel
    routes (K6c, K2), f32 at rtol 1e-5 / atol 1e-5 (context values up to
    ~5); HF ``repeat_kv`` order checked directly.
(d) Trees: ``init_params`` (GQA K/V widths, no embedding norm, final
    norm), ``fuse_qkv`` leaving a GQA tree unfused, ``from_jax_params`` on
    a q4_0 GQA tree, ``_translate_qwen2`` with and without the ``model.``
    prefix against JAX's ``from_hf_state_dict``.
(e) ``encode_tokens``, causal and bidirectional, dense f32 and q4_0, the
    last-token pooled embeddings and the hidden states (``return_hidden``)
    against JAX's: at E=64 with 4 heads of 16 (einsum in both), E=128
    with 4 heads of 32 and E=256 with 2 heads of 128 at L=256 (K6c, K2 and
    K6 plain, JAX through its Pallas kernels in interpret mode), at the
    max abs errors ``ATOL`` (pooled) and ``HIDDEN_ATOL`` state, and
    cosine >= 0.9999.
(f) ``encode_packed`` with causal rows against JAX's (einsum in both).
(g) The dispatch at L=256: the causal forward calls
    ``fused_attention_stream(causal=True)`` on every layer, as JAX does
    with ``_use_pallas`` patched, and their outputs agree.
(h) Route names and kernels-ok with ``causal`` over a grid.
(i) An HF Qwen2 directory written offline by ``transformers.Qwen2Model``
    with Qwen2's byte-level BPE: ``load_model`` wraps eos only, tokenizes
    and encodes as the JAX package does, and matches HF's hidden states.
"""

import dataclasses
import functools
import importlib
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JaxConfig
from embeddings_tpu.models import params as JP
from embeddings_tpu.ops import attention as jattn
from embeddings_tpu.runtime import packing as jpacking

from embeddings_tpu_torch.config import KNOWN_MODELS, BertConfig
from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.runtime.engine import load_model

jlin = importlib.import_module("embeddings_tpu.ops.linear")
jbert = importlib.import_module("embeddings_tpu.models.bert")

VOCAB = 288
# max abs error of the pooled unit vectors and of the hidden states
# (after the final RMSNorm, elements up to ~4) against JAX. Dense f32:
# summation-order noise (measured 2e-7 pooled, 5e-6 hidden). q4_0: K1
# rounds its f32 input to bf16 in both packages, so a one-ulp difference
# upstream flips one operand's rounding and the residual stream carries
# it (measured 3.8e-4 pooled; 0.013 hidden, where one bf16 ulp of an
# element of 4 is 0.016)
ATOL = {"f32": 2e-5, "q4_0": 2e-3}
HIDDEN_ATOL = {"f32": 5e-5, "q4_0": 3e-2}

QWEN2_REGEX = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
               r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
               r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def qwen2_dict(**over):
    """An HF Qwen2 config.json (tests/test_qwen2.py's shape by default:
    E=64, 4 heads, 2 K/V heads, FFN 96, 3 layers)."""
    d = dict(model_type="qwen2", vocab_size=VOCAB, hidden_size=64,
             num_hidden_layers=3, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=96,
             max_position_embeddings=1024, rope_theta=1000000.0,
             rms_norm_eps=1e-6, hidden_act="silu", eos_token_id=2,
             bos_token_id=None, pad_token_id=0)
    d.update(over)
    return d


# the three widths: einsum (D=16), the kernel routes at D=32 and D=128
SHAPES = {"E64": {},
          "E128": dict(hidden_size=128, num_attention_heads=4,
                       num_key_value_heads=2),
          "E256": dict(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=1)}


# ---------------------------------------------------------------------------
# (a) K6c's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

# lengths on the Hopper kernel's tile edges (128 keys), at L=384
EDGES = (0, 1, 63, 64, 65, 127, 128, 129)


def _causal_inputs(L, H, D, seed):
    """qkv and lengths {L, L-37, 1, 0}, or at L=384 the tile edges and L
    (B = len(lengths))."""
    lengths = EDGES + (L,) if L == 384 else (L, L - 37, 1, 0)
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((len(lengths) * L, 3 * H * D),
                              dtype=np.float32)
    return qkv, np.array(lengths, np.int32)


def _jax_causal(qkv, lengths, L, H, D, BK, dtype):
    out = jattn.fused_attention_stream(
        jnp.asarray(qkv, dtype), jnp.asarray(lengths), B=len(lengths), L=L,
        H=H, D=D, BK=BK, causal=True, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port_causal(qkv, lengths, L, H, D, BK, dtype):
    out = tattn.fused_attention_stream(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(lengths),
        B=len(lengths), L=L, H=H, D=D, BK=BK, causal=True)
    assert out.dtype == dtype
    return out.float().numpy()


K6C_CASES = [(256, 2, 64, 256), (512, 2, 64, 512), (256, 1, 128, 256),
             (512, 1, 128, 128), (384, 4, 32, 128), (384, 2, 64, 128)]


@pytest.mark.parametrize("L,H,D,BK", K6C_CASES)
def test_causal_ref_matches_jax_f32(L, H, D, BK):
    qkv, lengths = _causal_inputs(L, H, D, seed=L + D)
    ref = _jax_causal(qkv, lengths, L, H, D, BK, jnp.float32)
    got = _port_causal(qkv, lengths, L, H, D, BK, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    zero = list(lengths).index(0)
    assert np.all(got.reshape(len(lengths), L, -1)[zero] == 0)  # len 0


@pytest.mark.parametrize("L,H,D,BK", [K6C_CASES[0], K6C_CASES[2],
                                      K6C_CASES[5]])
def test_causal_ref_matches_jax_bf16(L, H, D, BK):
    qkv, lengths = _causal_inputs(L, H, D, seed=11)
    ref = _jax_causal(qkv, lengths, L, H, D, BK, jnp.bfloat16)
    got = _port_causal(qkv, lengths, L, H, D, BK, torch.bfloat16)
    np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2e-3)


def test_causal_ref_is_the_triangular_math():
    """The block walk changes only the summation order: K6c's plain
    version equals dense prefix attention with j <= i in the mask, and
    query row 0 of a sequence is its first value row."""
    L, H, D = 256, 2, 64
    qkv, lengths = _causal_inputs(L, H, D, seed=5)
    t, lens = torch.from_numpy(qkv), torch.from_numpy(lengths)
    got = tattn.fused_attention_stream(t, lens, B=4, L=L, H=H, D=D, BK=128,
                                       causal=True)
    q, k, v = tattn._split_heads(t, 4, L, H, D)
    s = (q @ k.transpose(-1, -2)) * tattn._scale(D)
    i = torch.arange(L)
    ok = (i[None, :] <= i[:, None]) & (i[None, None, :] < lens[:, None, None])
    p = torch.where(ok[:, None], torch.exp2(s.clamp(-100,
                                                    tattn._clamp_hi(L))),
                    torch.zeros(()))
    want = tattn._merge_heads(p @ v, p.sum(-1, keepdim=True), torch.float32,
                              4, L, H, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    E = H * D
    np.testing.assert_allclose(got[0].numpy(), qkv[0, 2 * E:], rtol=0,
                               atol=1e-6)
    # causal with ALiBi (K6ca's plain version) takes both masks, as the
    # JAX package's kernel does
    slopes = (0.5, 0.25)
    got = tattn.fused_attention_stream(t, lens, B=4, L=L, H=H, D=D, BK=128,
                                       causal=True, alibi_slopes=slopes)
    ref = jattn.fused_attention_stream(
        jnp.asarray(qkv), jnp.asarray(lengths), B=4, L=L, H=H, D=D, BK=128,
        causal=True, alibi_slopes=slopes, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# (b) RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 40, 256), dtype=np.float32) * 3
    scale = 1 + rng.standard_normal(256, dtype=np.float32) * 0.1
    ref = np.asarray(jbert.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                                    1e-6).astype(jnp.float32))
    got = tbert.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.from_numpy(scale), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -8  # one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# (c) grouped-query attention
# ---------------------------------------------------------------------------

def _configs(shape="E64", **over):
    d = qwen2_dict(**{**SHAPES[shape], **over})
    return JaxConfig.from_hf_dict(d), BertConfig.from_hf_dict(d)


def _gqa_layer(jcfg, seed):
    """One layer of a JAX GQA tree with trained-scale (std 0.1) q/k/v
    weights and nonzero biases, so heads differ."""
    jp = JP.init_params(jcfg, 0)
    rng = np.random.default_rng(seed)
    layer = {"attn": {}}
    for n in ("q", "k", "v"):
        w = jp["layers"]["attn"][n]["w"][0]
        layer["attn"][n] = {
            "w": rng.standard_normal(w.shape, dtype=np.float32) * 0.1,
            "b": rng.standard_normal(w.shape[1], dtype=np.float32) * 0.1}
    return layer


@pytest.mark.parametrize("shape,L,route", [
    ("E64", 24, "einsum"), ("E128", 256, "stream_causal"),
    ("E128", 256, "whole_row"), ("E256", 256, "stream_causal")])
def test_gqa_attention_matches_jax(monkeypatch, shape, L, route):
    causal = route != "whole_row"
    jcfg, cfg = _configs(shape)
    jcfg = dataclasses.replace(jcfg, causal=causal)
    cfg = dataclasses.replace(cfg, causal=causal)
    layer = _gqa_layer(jcfg, seed=L)
    E = cfg.hidden_size
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, L, E), dtype=np.float32)
    lengths = np.array([L, L // 2], np.int32)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    mb = ((1.0 - mask) * -1e9)[:, None, None, :]
    if causal:
        i = np.arange(L)
        mb = mb + np.where(i[None, :] <= i[:, None], 0.0, -1e9)[None, None]
    kernels = route != "einsum"
    with monkeypatch.context() as m:
        for name in ("fused_attention", "fused_attention_stream"):
            m.setattr(jattn, name, functools.partial(getattr(jattn, name),
                                                     interpret=True))
        with jlin.pallas_mode("always" if kernels else "never"):
            ref = np.asarray(jbert.attention_context(
                layer, jcfg, jnp.asarray(x), jnp.asarray(mb, jnp.float32),
                jnp.asarray(lengths) if kernels else None, causal=causal))
    tl = {"attn": {n: {k: torch.from_numpy(v) for k, v in d.items()}
                   for n, d in layer["attn"].items()}}
    assert tbert.attention_route_name(L, E, causal=causal) == route \
        or not kernels
    got = tbert.attention_context(
        tl, cfg, torch.from_numpy(x), torch.from_numpy(mb).float(),
        torch.from_numpy(lengths) if kernels else None, causal=causal)
    real = mask.astype(bool)
    # f32 summation order at context values up to ~5 (E=256)
    np.testing.assert_allclose(got.numpy()[real], ref[real], rtol=1e-5,
                               atol=1e-5)


def test_gqa_repeat_is_hf_order():
    """With one K/V head per pair of query heads, query heads 0 and 1 read
    K/V head 0, heads 2 and 3 read head 1 (HF ``repeat_kv``; a tiled
    repeat would give head 1 K/V head 1)."""
    _, cfg = _configs("E128", causal=False)
    D, L = cfg.head_dim, 8
    E, Ekv = cfg.hidden_size, 2 * cfg.head_dim
    kv = torch.zeros(E, Ekv)
    kv[:Ekv, :] = torch.eye(Ekv)  # K/V head g reads x[:, g*D:(g+1)*D]
    layer = {"attn": {"q": {"w": torch.zeros(E, E), "b": torch.zeros(E)},
                      "k": {"w": kv, "b": torch.zeros(Ekv)},
                      "v": {"w": kv, "b": torch.zeros(Ekv)}}}
    x = torch.randn(1, L, E, generator=torch.Generator().manual_seed(0))
    mb = torch.zeros(1, 1, 1, L)
    ctx = tbert.attention_context(layer, cfg, x, mb).reshape(1, L, 4, D)
    # q = 0: uniform attention, so each head's context is the mean of its
    # K/V head's values
    vmean = x.mean(1)[0]
    for h in range(4):
        g = h // 2
        np.testing.assert_allclose(ctx[0, 0, h].numpy(),
                                   vmean[g * D:(g + 1) * D].numpy(),
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# (d) parameter trees
# ---------------------------------------------------------------------------

def test_init_params_gqa_tree():
    cfg = BertConfig(**KNOWN_MODELS["gte-Qwen2-1.5B-instruct"])
    small = dataclasses.replace(cfg, vocab_size=64, num_hidden_layers=2,
                                intermediate_size=64)
    P.check_supported(small)
    tp = P.init_params(small, 0)
    D, kv = small.head_dim, small.num_key_value_heads
    assert (D, kv) == (128, 2)
    attn = tp["layers"]["attn"]
    assert tuple(attn["q"]["w"].shape) == (2, 1536, 1536)
    assert tuple(attn["k"]["w"].shape) == (2, 1536, kv * D)
    assert tuple(attn["v"]["b"].shape) == (2, kv * D)
    assert "ln" not in tp["embeddings"] and "position" not in tp["embeddings"]
    assert "final_ln" in tp
    jtp = JP.init_params(JaxConfig(**small.to_dict()), 0)
    assert _shapes(tp) == _shapes(jtp)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


def test_fuse_qkv_leaves_gqa_unfused():
    """The repair: a GQA tree keeps its separate q/k/v (the parent port
    concatenated unequal widths, which the forward then split in
    thirds)."""
    jcfg, cfg = _configs("E128")
    tp = P.init_params(cfg, 0)
    fused = P.fuse_qkv(P.pack_q4_params(P.quantize_params(tp, "q4_0")))
    assert "qkv" not in fused["layers"]["attn"]
    assert {"q", "k", "v"} <= set(fused["layers"]["attn"])
    jp = JP.fuse_qkv(JP.init_params(jcfg, 0))
    assert "qkv" not in jp["layers"]["attn"]
    # an MHA tree still fuses
    mha = P.init_params(dataclasses.replace(cfg, num_key_value_heads=4), 0)
    assert "qkv" in P.fuse_qkv(mha)["layers"]["attn"]


def test_from_jax_params_carries_gqa_tree():
    jcfg, _ = _configs("E256")
    jp = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(
        JP.init_params(jcfg, 3), "q4_0")))
    tp = P.from_jax_params(jp)
    k = tp["layers"]["attn"]["k"]
    assert k["w"].packed and tuple(k["b"].shape) == (3, 128)
    np.testing.assert_array_equal(k["w"].codes.numpy(),
                                  np.asarray(jp["layers"]["attn"]["k"]["w"]
                                             .codes))
    np.testing.assert_array_equal(tp["final_ln"]["scale"].numpy(),
                                  np.asarray(jp["final_ln"]["scale"]))
    assert "ln" not in tp["embeddings"]


def _hf_state_dict(cfg_dict, seed):
    """A synthetic Qwen2Model state dict (numpy, HF names and [out, in]
    layout, random norms and biases)."""
    rng = np.random.default_rng(seed)
    E, F = cfg_dict["hidden_size"], cfg_dict["intermediate_size"]
    Ekv = cfg_dict["num_key_value_heads"] * E // cfg_dict[
        "num_attention_heads"]

    def r(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.1

    sd = {"embed_tokens.weight": r(cfg_dict["vocab_size"], E),
          "norm.weight": 1 + r(E)}
    for i in range(cfg_dict["num_hidden_layers"]):
        p = f"layers.{i}."
        sd.update({
            p + "self_attn.q_proj.weight": r(E, E),
            p + "self_attn.q_proj.bias": r(E),
            p + "self_attn.k_proj.weight": r(Ekv, E),
            p + "self_attn.k_proj.bias": r(Ekv),
            p + "self_attn.v_proj.weight": r(Ekv, E),
            p + "self_attn.v_proj.bias": r(Ekv),
            p + "self_attn.o_proj.weight": r(E, E),
            p + "input_layernorm.weight": 1 + r(E),
            p + "post_attention_layernorm.weight": 1 + r(E),
            p + "mlp.gate_proj.weight": r(F, E),
            p + "mlp.up_proj.weight": r(F, E),
            p + "mlp.down_proj.weight": r(E, F),
            p + "self_attn.rotary_emb.inv_freq": r(8)})
    return sd


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("prefix", ["", "model."])
def test_translate_qwen2_matches_jax(prefix):
    d = qwen2_dict()
    sd = {prefix + k: v for k, v in _hf_state_dict(d, 4).items()}
    if prefix:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    jcfg, cfg = JaxConfig.from_hf_dict(d), BertConfig.from_hf_dict(d)
    ref = _flat(JP.from_hf_state_dict(sd, jcfg))
    got = _flat(P.from_hf_state_dict(sd, cfg))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["/layers/attn/k/w"].shape == (3, 64, 32)
    np.testing.assert_array_equal(
        got["/layers/attn/q/b"][1], sd[prefix + "layers.1.self_attn.q_proj.bias"])
    assert not got["/layers/attn/o/b"].any()


# ---------------------------------------------------------------------------
# (e) encode_tokens against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(shape, kind):
    """JAX GQA tree with trained-scale (std 0.1) matmul weights, q4_0
    packed or dense, and the port's copy of it."""
    jcfg, cfg = _configs(shape)
    jp = JP.init_params(jcfg, 0)
    rng = np.random.default_rng(1)
    for group in ("attn", "mlp"):
        for lin in jp["layers"][group].values():
            if "w" in lin:
                lin["w"] = jnp.asarray(rng.standard_normal(
                    lin["w"].shape, dtype=np.float32) * 0.1)
                lin["b"] = jnp.asarray(rng.standard_normal(
                    lin["b"].shape, dtype=np.float32) * 0.02)
    if kind == "q4_0":
        jp = JP.pack_q4_params(JP.quantize_params(jp, "q4_0"))
    jp = JP.fuse_qkv(jp)
    return jcfg, jp, cfg, P.from_jax_params(jp)


def _batch(B, L, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, VOCAB, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L // 3:] = 0
    mask[2, 1:] = 0
    return ids, mask


KERNELS = ("fused_attention", "fused_attention_stream")


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
    calls = []
    for name in KERNELS:
        orig = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, functools.partial(
            lambda *a, _n=name, _f=orig, **k: calls.append(
                (_n, bool(k.get("causal")))) or _f(*a, **k)))
    return calls


ENCODE_CASES = [
    # shape, L, causal, force_stream -> the port's attention call per layer
    ("E64", 24, True, False, None),
    ("E64", 24, False, False, None),
    ("E128", 256, True, False, ("fused_attention_stream", True)),
    ("E128", 256, False, False, ("fused_attention", False)),
    ("E256", 256, True, False, ("fused_attention_stream", True)),
    ("E256", 256, False, True, ("fused_attention_stream", False)),
]


@pytest.mark.parametrize("kind", ["f32", "q4_0"])
@pytest.mark.parametrize("shape,L,causal,force,call", ENCODE_CASES)
def test_encode_tokens_matches_jax(monkeypatch, shape, L, causal, force,
                                   call, kind):
    jcfg, jp, cfg, tp = _models(shape, kind)
    jcfg = dataclasses.replace(jcfg, causal=causal)
    cfg = dataclasses.replace(cfg, causal=causal)
    ids, mask = _batch(3, L, seed=L + causal)
    with monkeypatch.context() as m:
        if force:
            m.setattr(tattn, "whole_row_fits", lambda *a, **k: False)
        with jattn.force_stream_mode(force):
            ref = _jax_kernels(m, jp, jcfg, ids, mask)
            ref_h = _jax_kernels(m, jp, jcfg, ids, mask, return_hidden=True)
        calls = _spy_port(m)
        got = tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                                  torch.from_numpy(mask)).numpy()
        got_h = tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                                    torch.from_numpy(mask),
                                    return_hidden=True).numpy()
    assert calls == ([call] * 2 * cfg.num_hidden_layers if call else [])
    assert got.shape == (3, cfg.hidden_size) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= ATOL[kind]
    assert (got * ref).sum(-1).min() >= 0.9999
    real = mask.astype(bool)
    assert np.abs(got_h[real] - ref_h[real]).max() <= HIDDEN_ATOL[kind]
    # last-token pooling reads the last real position's hidden state
    last = got_h[np.arange(3), mask.sum(1) - 1]
    np.testing.assert_allclose(
        got, last / np.linalg.norm(last, axis=-1, keepdims=True), atol=1e-6)


def test_causal_matters():
    """Causal attention is live: an earlier position does not see a later
    token's change, a later one does, and the bidirectional form
    differs."""
    _, _, cfg, tp = _models("E128", "f32")
    ids, mask = _batch(3, 256, seed=9)
    mask[:] = 1
    ids2 = ids.copy()
    ids2[0, 100] = (ids2[0, 100] + 1) % VOCAB
    h = [tbert.encode_tokens(tp, cfg, torch.from_numpy(i),
                             torch.from_numpy(mask),
                             return_hidden=True).numpy()
         for i in (ids, ids2)]
    np.testing.assert_allclose(h[0][0, :100], h[1][0, :100], atol=1e-5)
    assert np.abs(h[0][0, 100:] - h[1][0, 100:]).max() > 1e-3
    bidir = tbert.encode_tokens(tp, dataclasses.replace(cfg, causal=False),
                                torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
    causal = tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                                 torch.from_numpy(mask)).numpy()
    assert np.abs(bidir - causal).max() > 1e-3


@pytest.mark.parametrize("causal", [True, False])
def test_encode_tokens_plain_path_matches_jax_default(causal):
    """use_kernels=False (the einsum with the triangle in the mask) is the
    JAX package's XLA fallback arithmetic."""
    jcfg, jp, cfg, tp = _models("E128", "q4_0")
    jcfg = dataclasses.replace(jcfg, causal=causal)
    cfg = dataclasses.replace(cfg, causal=causal)
    ids, mask = _batch(3, 256, seed=6)
    ref = np.asarray(jbert.encode_tokens(jp, jcfg, jnp.asarray(ids),
                                         jnp.asarray(mask)))
    got = tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                              torch.from_numpy(mask),
                              use_kernels=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_encode_tokens_bf16_matches_jax(monkeypatch):
    jcfg, jp, cfg, tp = _models("E256", "q4_0")
    ids, mask = _batch(3, 256, seed=5)
    ref = _jax_kernels(monkeypatch, jp, jcfg, ids, mask,
                       compute_dtype="bfloat16")
    got = tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                              torch.from_numpy(mask),
                              compute_dtype=torch.bfloat16).numpy()
    assert (got * ref).sum(-1).min() >= 0.999


# ---------------------------------------------------------------------------
# (f) packed causal rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["E64", "E128"])
def test_encode_packed_matches_jax(monkeypatch, shape):
    jcfg, jp, cfg, tp = _models(shape, "q4_0")
    rng = np.random.default_rng(9)
    toks = [list(rng.integers(5, VOCAB, int(k)))
            for k in rng.integers(3, 40, 14)]
    b = jpacking.plan_packing([len(t) for t in toks], 128, 4, max_segs=8)[0]
    arrays = jpacking.materialize(b, toks, 0, "lasttoken")
    with jlin.pallas_mode("always"), jlin.interpret_mode():
        ref = np.asarray(jbert.encode_packed(
            jp, jcfg, *(jnp.asarray(a) for a in arrays[:4])))
    calls = _spy_port(monkeypatch)
    got = tbert.encode_packed(tp, cfg, *(torch.from_numpy(np.asarray(a))
                                         for a in arrays[:4])).numpy()
    assert calls == []   # no segmented kernel has a causal mode
    assert min(float((got[r, s] * ref[r, s]).sum())
               for r, s, _ in arrays[4]) >= 0.9999
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL["q4_0"])
    # a packed segment is encoded as if alone
    r, s, i = arrays[4][0]
    one = tbert.encode_tokens(tp, cfg, torch.tensor([toks[i]]),
                              torch.ones(1, len(toks[i]), dtype=torch.int32)
                              ).numpy()[0]
    assert float((got[r, s] * one).sum()) >= 0.9999


# ---------------------------------------------------------------------------
# (g) the dispatch at L=256
# ---------------------------------------------------------------------------

def test_forward_dispatches_causal_stream_kernel(monkeypatch):
    """tests/test_qwen2.py's check, in both packages: every layer of the
    causal forward at L=256 calls fused_attention_stream(causal=True)."""
    from unittest import mock
    jcfg, jp, cfg, tp = _models("E128", "f32")
    ids = np.random.default_rng(0).integers(5, VOCAB, (2, 256)).astype(
        np.int32)
    mask = np.ones((2, 256), np.int32)
    jcalls = []
    orig = jattn.fused_attention_stream

    def spy(*a, **kw):
        jcalls.append(kw)
        return orig(*a, **kw, interpret=True)

    with mock.patch.object(jlin, "_use_pallas", lambda: True), \
            mock.patch.object(jattn, "fused_attention_stream", spy):
        ref = np.asarray(jbert.encode_tokens(jp, jcfg, jnp.asarray(ids),
                                             jnp.asarray(mask)))
    assert jcalls and all(kw.get("causal") for kw in jcalls)
    calls = _spy_port(monkeypatch)
    got = tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    assert calls == [("fused_attention_stream", True)] * 3
    assert (got * ref).sum(-1).min() > 0.9999
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL["f32"])


# ---------------------------------------------------------------------------
# (h) routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("force", [False, True])
def test_route_names_match_jax(monkeypatch, force):
    if force:
        monkeypatch.setattr(tattn, "whole_row_fits", lambda *a, **k: False)
    for L in (16, 128, 256, 512, 896, 1024, 1920, 2048, 4096, 8192):
        for E in (128, 768, 1536):
            for seg in (False, True):
                for alibi in (False, True):
                    for causal in (False, True):
                        with jattn.force_stream_mode(force):
                            want = jbert.attention_route_name(
                                L, E // 128, 128, E, seg, 0, False, False,
                                alibi, causal)
                        got = tbert.attention_route_name(
                            L, E, segmented=seg, alibi=alibi, causal=causal)
                        assert got == want, (L, E, seg, alibi, causal)
    # gte-Qwen2-1.5B: K2 up to 896 tokens, K6 beyond; causal K6c throughout
    assert tbert.attention_route_name(896, 1536) == \
        ("stream" if force else "whole_row")
    assert tbert.attention_route_name(1024, 1536) == "stream"
    assert tbert.attention_route_name(512, 1536, causal=True) == \
        "stream_causal"


def test_kernels_ok_matches_jax():
    for L in (16, 24, 128, 256, 384, 512, 896, 1024, 4096):
        for H, D in ((2, 64), (4, 32), (12, 128), (1, 128), (4, 16)):
            for causal in (False, True):
                want = (jbert._attn_kernels_ok(L, H, D, None, None, None,
                                               causal)
                        and D in tattn.KERNEL_HEAD_DIMS)
                got = tbert.fused_attention_ok(L, H, D, True, "lengths",
                                               None, causal=causal)
                assert got == want, (L, H, D, causal)


# ---------------------------------------------------------------------------
# (i) an HF Qwen2 directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_qwen2_dir(tmp_path_factory):
    """config.json + pytorch_model.bin (transformers.Qwen2Model) +
    tokenizer.json (byte-level BPE with Qwen2's Split regex and
    <|endoftext|>), as tests/test_qwen2.py writes it."""
    from transformers import Qwen2Config, Qwen2Model
    from embeddings_tpu_torch.tokenizer.bpe import bytes_to_unicode
    d = tmp_path_factory.mktemp("qwen2")
    alphabet = sorted(set(bytes_to_unicode().values()))
    vocab = {t: i for i, t in enumerate(alphabet)}
    vocab["<|endoftext|>"] = eos = len(vocab)
    cfg = qwen2_dict(eos_token_id=eos, pad_token_id=None)
    hf_cfg = Qwen2Config(**{k: v for k, v in cfg.items()
                            if k != "model_type"}, attention_dropout=0.0)
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = Qwen2Model(hf_cfg).eval()
    (d / "config.json").write_text(json.dumps(cfg))
    torch.save(model.state_dict(), d / "pytorch_model.bin")
    (d / "tokenizer.json").write_text(json.dumps({
        "model": {"type": "BPE", "vocab": vocab, "merges": []},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_REGEX},
             "behavior": "Isolated"},
            {"type": "ByteLevel", "add_prefix_space": False,
             "use_regex": False}]},
        "added_tokens": [{"content": "<|endoftext|>", "id": eos}]}))
    return d, model


@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_hf_qwen2_dir_matches_jax(hf_qwen2_dir, dtype):
    from embeddings_tpu.runtime.engine import load_model as jax_load
    from embeddings_tpu_torch.tokenizer import ByteLevelBPETokenizer
    d, model = hf_qwen2_dir
    je = jax_load(d, dtype=dtype)
    te = load_model(d, dtype=dtype, device="cpu")
    assert isinstance(te.tokenizer, ByteLevelBPETokenizer)
    # the repair: eos appended alone, no <s> wrap
    assert te.tokenizer.special_style == je.tokenizer.special_style \
        == "eos_only"
    assert te.config.causal and te.config.pooling == "lasttoken"
    assert "qkv" not in te.params["layers"]["attn"]
    toks = te.tokenize("ab 12")
    assert toks == je.tokenize("ab 12") and toks[-1] == te.tokenizer.sep_id
    assert len(te.tokenize("123")) == 3 + 1   # digits split one by one
    texts = ["hello world", "abc", "hello world", "a longer text " * 20]
    ref = je.encode_batch(texts)
    got = te.encode_batch(texts)
    np.testing.assert_array_equal(got[0], got[2])
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-5)
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        ids = np.asarray([te.tokenize("hello world")], np.int64)
        with torch.no_grad():
            want = model(input_ids=torch.from_numpy(ids)
                         ).last_hidden_state[0].numpy()
        h = tbert.encode_tokens(te.params, te.config, torch.from_numpy(ids),
                                torch.ones_like(torch.from_numpy(ids)),
                                return_hidden=True)[0].numpy()
        np.testing.assert_allclose(h, want, atol=3e-4, rtol=1e-3)
    else:
        # bf16 operands in the port's K1 vs the JAX default's f32 matmuls
        assert (got * ref).sum(-1).min() >= 0.999
    packed = te.encode_batch_packed(texts)
    assert (packed * got).sum(-1).min() >= 0.9999
