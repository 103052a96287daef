"""The port's mixture-of-experts path (nomic-embed-text-v2-moe:
``embeddings_tpu_torch/ops/moe.py``, the (dense, moe) tree of
``models/params.py``, ``models/bert._moe_half``) against the JAX package,
on the CPU.

(a) Routing: ``route_probs`` / ``route_topk`` equal JAX's (1e-6, with and
    without ``normalize_topk``); on a tie (a zero router: every
    probability 1/E) ``route_topk`` keeps all experts in both packages
    and the ragged path picks experts 0 and 1, as ``lax.top_k`` does
    (``torch.topk`` would not).
(b) The FFN: ``moe_ffn`` and ``moe_ffn_ragged`` against JAX's for E in
    {4, 8} and k in {1, 2} (1e-5); ragged equals dense over (k, act,
    normalize) (1e-5); a one-expert MoE model equals the dense model built
    from the same weights (1e-5). The combine's plain version (the CUDA
    kernel's arithmetic) equals the index_add_ formula it replaced to f32
    order (bit for bit at k = 1), at k in {1, 2, 6} with and without each
    optional operand; ``expert_positions`` inverts the sort; the launch
    counter stays 0 on the CPU.
(c) The tree: ``from_hf_state_dict``'s (dense, moe) tree equals JAX's
    leaf for leaf, ``init_params``' has its layout; ``quantize_params`` quantizes the same leaves (the
    attention and the dense half; experts and router dense), ``fuse_qkv``
    fuses each half, casts keep the router f32; a JAX ``.npz`` of an MoE
    tree loads in the port; ``from_jax_params`` carries the tree.
(d) The forward: ``encode_tokens`` / ``encode_packed`` of a 4-layer MoE
    config in f32 (1e-5) and q4_0 (the plain path 2e-5 to JAX's default
    path, the kernels' plain versions 2e-3 to JAX's Pallas path in
    interpret mode); ``moe_dispatch`` dense / ragged / auto agree.
(e) Files: ``tiny_trained_moe`` through both packages' ``load_model``
    (f32 1e-4, q4_0 2e-3, bucketed and packed); a hand-built
    nomic-bert-moe GGUF read by both packages (same tree, same forward).
(f) Refusals: CP (``Engine(mesh=)`` too), ``to_hf_state_dict`` and the
    GGUF writer refuse an MoE tree; ``check_supported`` keeps JAX's layout rule; the int8 mode runs
    an MoE tree unchained.
"""

import dataclasses
import functools
import importlib
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JaxConfig
from embeddings_tpu.models import bert as jbert, gguf_io as JF, \
    params as JP
from embeddings_tpu.ops import moe as jmoe
from embeddings_tpu.runtime import packing as jpacking
from embeddings_tpu.runtime.engine import load_model as jax_load

from embeddings_tpu_torch.config import BertConfig
from embeddings_tpu_torch.models import bert as tbert, gguf_io as TF, \
    params as P
from embeddings_tpu_torch.ops import moe as tmoe
from embeddings_tpu_torch.ops.qmatmul import int8_engages
from embeddings_tpu_torch.ops.quant import QuantizedTensor
from embeddings_tpu_torch.runtime.engine import load_model

from .test_moe import MOE_HF_DICT, _moe_state_dict, _write_moe_gguf

jlin = importlib.import_module("embeddings_tpu.ops.linear")
jattn = importlib.import_module("embeddings_tpu.ops.attention")

ROOT = Path(__file__).resolve().parent.parent
MOE_FIXTURE = ROOT / "benchmarks" / "fixtures" / "tiny_trained_moe" / "model"
TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog",
         "a b c d e f g h", "hello world", "zebra " * 40]


def _w(rng, *shape, std=0.1):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _single_moe(rng, D, I, Ex):
    """One MoE FFN's numpy leaves (as JAX's tests/test_moe.py draws them)."""
    return {"router": {"w": _w(rng, D, Ex)},
            "up": {"w": _w(rng, Ex, D, I), "b": _w(rng, Ex, I)},
            "down": {"w": _w(rng, Ex, I, D), "b": _w(rng, Ex, D)},
            "bias": _w(rng, D)}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict (a QuantizedTensor is one leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# (a) routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
def test_route_topk_matches_jax(normalize):
    rng = np.random.default_rng(0)
    x, rw, rb = _w(rng, 97, 32, std=1.0), _w(rng, 32, 8), _w(rng, 8)
    ref = np.asarray(jmoe.route_topk(jnp.asarray(x), jnp.asarray(rw),
                                     jnp.asarray(rb), top_k=2,
                                     normalize=normalize))
    got = tmoe.route_topk(torch.from_numpy(x), torch.from_numpy(rw),
                          torch.from_numpy(rb), top_k=2,
                          normalize=normalize).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert ((got > 0).sum(-1) == 2).all()
    probs = tmoe.route_probs(torch.from_numpy(x), torch.from_numpy(rw),
                             torch.from_numpy(rb)).numpy()
    np.testing.assert_allclose(probs, np.asarray(jmoe._route_probs(
        jnp.asarray(x), jnp.asarray(rw), jnp.asarray(rb))), atol=1e-6)


def test_tie_rule_matches_lax_top_k():
    """A zero router gives every expert 1/8: ``route_topk`` keeps all 8 in
    both packages; the ragged route takes experts 0 and 1 (lax.top_k's
    lower-index-first rule), so its output equals JAX's, which a plain
    ``torch.topk`` (experts 6 and 5 on this CPU) would not give."""
    rng = np.random.default_rng(1)
    D, I, Ex = 16, 24, 8
    moe = _single_moe(rng, D, I, Ex)
    moe["router"]["w"] = np.zeros((D, Ex), np.float32)
    x = _w(rng, 33, D, std=1.0)
    tx = torch.from_numpy(x)
    keep = tmoe.route_topk(tx, torch.from_numpy(moe["router"]["w"]), None,
                           top_k=2).numpy()
    jkeep = np.asarray(jmoe.route_topk(jnp.asarray(x),
                                       jnp.asarray(moe["router"]["w"]),
                                       None, top_k=2))
    assert (keep > 0).all() and (jkeep > 0).all()
    probs = tmoe.route_probs(tx, torch.from_numpy(moe["router"]["w"]), None)
    _, idx = tmoe.topk_lower_first(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx.numpy() == [0, 1]).all()
    # ties among some experts only: rounded random probabilities
    p = np.round(np.random.default_rng(2).random((200, 8)), 1).astype(
        np.float32)
    np.testing.assert_array_equal(
        tmoe.topk_lower_first(torch.from_numpy(p), 3)[1].numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(p), 3)[1]))
    got = tmoe.moe_ffn_ragged(tx, _as(moe, torch.from_numpy), top_k=2,
                              act="gelu").numpy()
    ref = np.asarray(jmoe.moe_ffn_ragged(jnp.asarray(x), moe, top_k=2,
                                         act="gelu"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# (b) the FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Ex", [4, 8])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_moe_ffn_matches_jax(Ex, k, dispatch):
    rng = np.random.default_rng(Ex * 10 + k)
    moe = _single_moe(rng, 32, 48, Ex)
    x = _w(rng, 97, 32, std=1.0)
    jfn, tfn = {"dense": (jmoe.moe_ffn, tmoe.moe_ffn),
                "ragged": (jmoe.moe_ffn_ragged, tmoe.moe_ffn_ragged)}[
        dispatch]
    ref = np.asarray(jfn(jnp.asarray(x), moe, top_k=k, act="gelu"))
    got = tfn(torch.from_numpy(x), _as(moe, torch.from_numpy), top_k=k,
              act="gelu").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,act,norm", [(2, "gelu", False),
                                        (1, "gelu", False),
                                        (3, "silu", True),
                                        (8, "relu", False)])
def test_ragged_equals_dense(k, act, norm):
    rng = np.random.default_rng(k)
    moe = _as(_single_moe(rng, 32, 48, 8), torch.from_numpy)
    x = torch.from_numpy(_w(rng, 97, 32, std=1.0))
    reads, gemms = tmoe.moe_ffn_ragged.host_reads, \
        tmoe.moe_ffn_ragged.expert_gemms
    got = tmoe.moe_ffn_ragged(x, moe, top_k=k, act=act, normalize_topk=norm)
    ref = tmoe.moe_ffn(x, moe, top_k=k, act=act, normalize_topk=norm)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    # one host read a call; two products per non-empty expert
    assert tmoe.moe_ffn_ragged.host_reads == reads + 1
    assert gemms + 2 <= tmoe.moe_ffn_ragged.expert_gemms <= gemms + 16


def test_single_expert_equals_dense_model():
    """One expert, top-1: every token's weight is exactly 1, so the MoE
    model equals the dense model built from the same weights."""
    E, F, NL, V = 32, 64, 4, 64
    kw = dict(vocab_size=V, hidden_size=E, num_hidden_layers=NL,
              num_attention_heads=2, intermediate_size=F,
              max_position_embeddings=32)
    dense_cfg = BertConfig(**kw)
    dp = P.init_params(dense_cfg, 3)
    odd = P.map_tree(lambda t: t[1::2], dp["layers"])
    mp = {"embeddings": dp["embeddings"], "layers": {
        "dense": P.map_tree(lambda t: t[0::2], dp["layers"]),
        "moe": {"attn": odd["attn"], "mlp": {
            "router": {"w": torch.zeros(NL // 2, E, 1)},
            "up": {"w": odd["mlp"]["up"]["w"][:, None],
                   "b": odd["mlp"]["up"]["b"][:, None]},
            "down": {"w": odd["mlp"]["down"]["w"][:, None],
                     "b": odd["mlp"]["down"]["b"][:, None]},
            "ln": odd["mlp"]["ln"]}}}}
    moe_cfg = BertConfig(**kw, num_experts=1, moe_top_k=1,
                         moe_every_n_layers=2)
    ids = torch.from_numpy(np.random.default_rng(4).integers(5, V, (3, 16)))
    mask = torch.ones(3, 16, dtype=torch.int64)
    ref = tbert.encode_tokens(dp, dense_cfg, ids, mask)
    got = tbert.encode_tokens(mp, moe_cfg, ids, mask)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def _combine_case(k, T=61, D=24, E=8, seed=0):
    """A combine's inputs: each token routed to k distinct experts of E,
    experts 2 and 5 never (no rows), weights on a 1/8 grid (ties);
    y [T*k, D] in expert order."""
    rng = np.random.default_rng(seed + k)
    live = [e for e in range(E) if e not in (2, 5)]
    top_e = torch.from_numpy(np.stack([rng.permutation(live)[:k]
                                       for _ in range(T)]))
    top_w = torch.from_numpy(
        rng.integers(1, 8, (T, k)).astype(np.float32) / 8)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    y = torch.from_numpy(_w(rng, T * k, D, std=1.0))
    extras = {"down_b": torch.from_numpy(_w(rng, E, D)),
              "bias": torch.from_numpy(_w(rng, D)),
              "shared": torch.from_numpy(_w(rng, T, D, std=1.0))}
    return y, top_w, flat_e, order, extras


def _combine_index_add(y, top_w, experts, order, down_b=None, bias=None,
                       shared=None):
    """The combine as ``moe_ffn_ragged`` wrote it before the one-pass
    version: f32 rows, the bias and the weights gathered through the
    sort, an ``index_add_`` onto the tokens."""
    T, k = top_w.shape
    r = y.float()
    if down_b is not None:
        r = r + down_b.float()[experts[order]]
    r = r * top_w.reshape(-1)[order][:, None]
    out = torch.zeros(T, y.shape[1], dtype=torch.float32)
    out.index_add_(0, order // k, r)
    if bias is not None:
        out = out + bias.float()
    if shared is not None:
        out += shared.float()
    return out.to(y.dtype)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("down_b", [False, True])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_combine_plain_equals_index_add(k, down_b, bias, shared):
    """``_combine_plain`` (the CUDA combine's plain version: k gathered
    rows added in top-k order) against the index_add_ formula: equal to
    f32 summation order, and bit for bit at k = 1 (one term a token)."""
    y, top_w, flat_e, order, extras = _combine_case(k)
    kw = {name: t for name, t in extras.items()
          if {"down_b": down_b, "bias": bias, "shared": shared}[name]}
    got = tmoe._combine_plain(y, top_w, flat_e, order, **kw)
    ref = _combine_index_add(y, top_w, flat_e, order, **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    if k == 1:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    # the CPU entry is the plain version; bf16 rows come back in bf16
    assert torch.equal(tmoe.combine_experts(y, top_w, flat_e, order, **kw),
                       got)
    bf = {n: t.to(torch.bfloat16) if n == "shared" else t
          for n, t in kw.items()}
    got16 = tmoe.combine_experts(y.to(torch.bfloat16), top_w, flat_e, order,
                                 **bf)
    ref16 = _combine_index_add(y.to(torch.bfloat16), top_w, flat_e, order,
                               **bf)
    assert got16.dtype == torch.bfloat16
    assert ((got16.float() - ref16.float()).abs()
            <= 2 ** -7 * ref16.float().abs() + 1e-6).all()


@pytest.mark.parametrize("k", [1, 2, 6])
def test_expert_positions_invert_the_sort(k):
    """pos = ``expert_positions(order)`` sends pair (t, j) to its sorted
    row: order[pos] is the identity, the row there carries token t and
    expert top_e[t, j], and every expert's rows are contiguous."""
    y, top_w, flat_e, order, _ = _combine_case(k)
    T = top_w.shape[0]
    pos = tmoe.expert_positions(order)
    n = T * k
    assert torch.equal(order[pos], torch.arange(n))
    assert torch.equal((order // k)[pos].reshape(T, k),
                       torch.arange(T)[:, None].expand(T, k))
    assert torch.equal(flat_e[order][pos], flat_e)
    assert (flat_e[order].diff() >= 0).all()


def test_combine_counts_no_launch_on_the_cpu():
    """On the CPU ``moe_ffn_ragged`` runs the plain combine: the launch
    counter stays 0, for nomic's layout (down bias, output bias) and a
    shared expert's."""
    rng = np.random.default_rng(7)
    moe = _as(_single_moe(rng, 32, 48, 8), torch.from_numpy)
    x = torch.from_numpy(_w(rng, 97, 32, std=1.0))
    tmoe.moe_ffn_ragged(x, moe, top_k=2, act="gelu")
    shared = {n: {"w": torch.from_numpy(_w(rng, *s)), "b": None}
              for n, s in (("gate", (32, 16)), ("up", (32, 16)),
                           ("down", (16, 32)))}
    tmoe.moe_ffn_ragged(x, {**moe, "shared": shared}, top_k=2, act="silu")
    assert tmoe.moe_ffn_ragged.combines == 0


# ---------------------------------------------------------------------------
# (c) the tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_trees():
    """(jax cfg, jax tree, port cfg, port tree) of MOE_HF_DICT (4 layers,
    E=64, 4 experts, top-2) from one HF-named state dict."""
    sd = _moe_state_dict(np.random.default_rng(7), MOE_HF_DICT)
    jcfg = JaxConfig.from_hf_dict(MOE_HF_DICT)
    cfg = BertConfig.from_hf_dict(MOE_HF_DICT)
    return jcfg, JP.from_hf_state_dict(sd, jcfg), cfg, \
        P.from_hf_state_dict(sd, cfg)


def _assert_same_tree(got, ref, exact=True):
    g, r = _leaves(got), _leaves(ref)
    assert set(g) == set(r)
    for k, v in r.items():
        if hasattr(v, "codes"):
            assert isinstance(g[k], QuantizedTensor), k
            assert (g[k].kind, g[k].block_axis, g[k].packed) == (
                v.kind, v.block_axis, v.packed), k
            np.testing.assert_array_equal(g[k].codes.numpy(),
                                          np.asarray(v.codes), err_msg=k)
            np.testing.assert_array_equal(_np(g[k].scales), _np(v.scales),
                                          err_msg=k)
            continue
        assert not isinstance(g[k], QuantizedTensor), k
        assert tuple(g[k].shape) == tuple(np.shape(v)), k
        assert str(g[k].dtype).split(".")[-1] == str(v.dtype), k
        if exact:
            np.testing.assert_array_equal(_np(g[k]), _np(v), err_msg=k)


def test_from_hf_state_dict_matches_jax(moe_trees):
    jcfg, jp, cfg, tp = moe_trees
    assert cfg.to_dict() == jcfg.to_dict()
    assert set(tp["layers"]) == {"dense", "moe"}
    assert tp["layers"]["moe"]["mlp"]["up"]["w"].shape == (2, 4, 64, 128)
    _assert_same_tree(tp, jp)
    # from_jax_params carries the tree as it is
    _assert_same_tree(P.from_jax_params(jp), jp)
    # layer i is dense[i // 2] (even) or moe[i // 2] (odd)
    views = tbert.layer_views(tp, cfg)
    assert ["router" in v["mlp"] for v in views] == [False, True] * 2
    assert views[3]["attn"]["q"]["w"].data_ptr() == \
        tp["layers"]["moe"]["attn"]["q"]["w"][1].data_ptr()


def test_init_params_moe_layout_matches_jax(moe_trees):
    """``init_params``' MoE layout has JAX's leaves, shapes and dtypes
    (the values differ: numpy against jax.random), and it runs."""
    jcfg, _, cfg, _ = moe_trees
    tp = P.init_params(cfg, 0)
    _assert_same_tree(tp, JP.init_params(jcfg, rng=0), exact=False)
    ids, mask = _batch(5)
    assert np.isfinite(_port(tp, cfg, ids, mask)).all()


def test_quantize_fuse_cast_walk_the_moe_tree(moe_trees):
    jcfg, jp, cfg, tp = moe_trees
    jq = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(jp, "q4_0")))
    tq = P.fuse_qkv(P.pack_q4_params(P.quantize_params(tp, "q4_0")))
    _assert_same_tree(tq, jq)
    for half in ("dense", "moe"):
        assert "qkv" in tq["layers"][half]["attn"]
        assert tq["layers"][half]["attn"]["qkv"]["w"].packed
    moe = tq["layers"]["moe"]["mlp"]
    assert not any(isinstance(v, QuantizedTensor)
                   for v in _leaves(moe).values())
    # the packed q4 weights unpack, the int8 weights are kept, bytes add up
    back = P.unpack_q4_params(tq)
    assert not back["layers"]["dense"]["mlp"]["up"]["w"].packed
    assert P.param_bytes(back) > P.param_bytes(tq)
    P.keep_int8_weights(tq)
    for k, v in _leaves(tq["layers"]).items():
        if isinstance(v, QuantizedTensor):
            assert (v.int8 is not None) == int8_engages(*v.shape[-2:],
                                                        v.packed), k
    # bf16: the router stays f32, as in JAX
    tb, jb = P.cast_params(tp, "bf16"), JP.cast_params(jp, "bf16")
    _assert_same_tree(tb, jb, exact=False)
    assert tb["layers"]["moe"]["mlp"]["router"]["w"].dtype == torch.float32
    assert tb["layers"]["moe"]["mlp"]["up"]["w"].dtype == torch.bfloat16


def test_load_native_reads_jax_moe_checkpoint(moe_trees, tmp_path):
    jcfg, jp, cfg, tp = moe_trees
    jq = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(jp, "q4_0")))
    JP.save_native(tmp_path / "m.npz", jq, jcfg)
    params, config = P.load_native(tmp_path / "m.npz")
    assert config.num_experts == 4
    _assert_same_tree(params, jq)
    ids, mask = _batch()
    want = _port(P.from_jax_params(jq), cfg, ids, mask)
    np.testing.assert_array_equal(_port(params, config, ids, mask), want)
    P.save_native(tmp_path / "p.npz", params, config)
    again, _ = P.load_native(tmp_path / "p.npz")
    np.testing.assert_array_equal(_port(again, config, ids, mask), want)


# ---------------------------------------------------------------------------
# (d) the forward
# ---------------------------------------------------------------------------

def _batch(seed=0, B=3, L=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 96, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    mask[2, 1:] = 0
    return ids, mask


def _port(tp, cfg, ids, mask, **kw):
    return tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                               torch.from_numpy(mask), **kw).numpy()


def _jax(jp, jcfg, fn, arrays, kernels=False):
    """JAX's forward: its default path, or its Pallas path in interpret
    mode."""
    orig = jattn.fused_attention
    if kernels:
        jattn.fused_attention = functools.partial(orig, interpret=True)
    try:
        with jlin.pallas_mode("always" if kernels else "never"), \
                jlin.interpret_mode(kernels):
            return np.asarray(fn(jp, jcfg, *(jnp.asarray(a)
                                              for a in arrays)))
    finally:
        jattn.fused_attention = orig


@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_encode_tokens_matches_jax(moe_trees, dtype):
    jcfg, jp, cfg, tp = moe_trees
    if dtype == "q4_0":
        jp = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(jp, dtype)))
        tp = P.from_jax_params(jp)
    ids, mask = _batch(1)
    ref = _jax(jp, jcfg, jbert.encode_tokens, (ids, mask))
    got = _port(tp, cfg, ids, mask, use_kernels=False)
    assert got.shape == (3, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 if dtype == "f32" else 2e-5)
    kref = _jax(jp, jcfg, jbert.encode_tokens, (ids, mask), kernels=True)
    kgot = _port(tp, cfg, ids, mask)
    assert np.abs(kgot - kref).max() <= (1e-5 if dtype == "f32" else 2e-3)


@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_encode_packed_matches_jax(moe_trees, dtype):
    """Packed rows (pad slots routed like tokens, as in JAX) against
    JAX's ``encode_packed``; each segment equals its bucketed row."""
    jcfg, jp, cfg, tp = moe_trees
    if dtype == "q4_0":
        jp = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(jp, dtype)))
        tp = P.from_jax_params(jp)
    rng = np.random.default_rng(9)
    toks = [list(rng.integers(5, 96, int(k)))
            for k in rng.integers(3, 20, 10)]
    b = jpacking.plan_packing([len(t) for t in toks], 48, 8, max_segs=8)[0]
    arrays = jpacking.materialize(b, toks, 0, "mean")
    assert (np.asarray(arrays[1]) < 0).any()  # pad slots in the rows
    ref = _jax(jp, jcfg, jbert.encode_packed, arrays[:4])
    got = tbert.encode_packed(tp, cfg, *(torch.from_numpy(np.asarray(a))
                                         for a in arrays[:4]),
                              use_kernels=False).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 if dtype == "f32" else 2e-5)
    for r, s, i in arrays[4]:
        ids = np.asarray([toks[i]], np.int32)
        one = _port(tp, cfg, ids, np.ones_like(ids), pooling="mean",
                    use_kernels=False)
        assert np.abs(got[r, s] - one[0]).max() <= 1e-5
    kref = _jax(jp, jcfg, jbert.encode_packed, arrays[:4], kernels=True)
    kgot = tbert.encode_packed(tp, cfg, *(torch.from_numpy(np.asarray(a))
                                          for a in arrays[:4])).numpy()
    assert np.abs(kgot - kref).max() <= (1e-5 if dtype == "f32" else 2e-3)


def test_moe_dispatch_paths_agree(moe_trees):
    """``moe_dispatch`` dense, ragged and auto (ragged on one device)
    give the same embeddings, in both packages."""
    jcfg, jp, cfg, tp = moe_trees
    ids, mask = _batch(2)
    outs = {d: _port(tp, dataclasses.replace(cfg, moe_dispatch=d), ids,
                     mask) for d in ("dense", "ragged", "auto")}
    np.testing.assert_allclose(outs["ragged"], outs["dense"], atol=1e-5)
    np.testing.assert_array_equal(outs["auto"], outs["ragged"])
    ref = _jax(jp, dataclasses.replace(jcfg, moe_dispatch="dense"),
               jbert.encode_tokens, (ids, mask))
    np.testing.assert_allclose(outs["dense"], ref, atol=1e-5)


# ---------------------------------------------------------------------------
# (e) files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_load_model_trained_moe_matches_jax(dtype):
    je = jax_load(MOE_FIXTURE, dtype=dtype)
    te = load_model(MOE_FIXTURE, dtype=dtype, device="cpu")
    assert te.config.num_experts == 4 and te.config.moe_top_k == 2
    assert [te.tokenize(t) for t in TEXTS] == \
        [je.tokenize(t) for t in TEXTS]
    tol = 1e-4 if dtype == "f32" else 2e-3
    got, ref = te.encode_batch(TEXTS), np.asarray(je.encode_batch(TEXTS))
    assert np.abs(got - ref).max() <= tol
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-5)
    np.testing.assert_array_equal(got[0], got[3])
    packed = te.encode_batch_packed(TEXTS)
    assert np.abs(packed - np.asarray(je.encode_batch_packed(TEXTS))
                  ).max() <= tol
    assert np.abs(packed - got).max() <= 1e-4


def test_moe_gguf_matches_jax(tmp_path):
    """A hand-built nomic-bert-moe GGUF (JAX's tests/test_moe.py writer):
    the same tree in both packages, the same forward, and the forward of
    the HF-loaded tree (the GGUF has no shared expert bias: zeroed)."""
    rng = np.random.default_rng(5)
    sd = _moe_state_dict(rng, MOE_HF_DICT)
    for i in range(1, MOE_HF_DICT["n_layer"], 2):
        sd[f"encoder.layers.{i}.mlp.experts.bias"] = np.zeros(
            MOE_HF_DICT["n_embd"], np.float32)
    path = tmp_path / "moe.gguf"
    _write_moe_gguf(path, sd, MOE_HF_DICT,
                    [f"tok{j}" for j in range(MOE_HF_DICT["vocab_size"])])
    tp, cfg, _ = TF.load_gguf_model(path)
    jp, jcfg, _ = JF.load_gguf_model(path)
    assert cfg.to_dict() == jcfg.to_dict() and cfg.num_experts == 4
    _assert_same_tree(tp, jp)
    ids, mask = _batch(3)
    ref = _jax(jp, jcfg, jbert.encode_tokens, (ids, mask))
    got = _port(tp, cfg, ids, mask)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    hf = P.from_hf_state_dict(sd, BertConfig.from_hf_dict(MOE_HF_DICT))
    np.testing.assert_allclose(got, _port(hf, cfg, ids, mask), atol=1e-5)


# ---------------------------------------------------------------------------
# (f) refusals and modes
# ---------------------------------------------------------------------------

def test_moe_refusals(moe_trees, tmp_path):
    from embeddings_tpu_torch.parallel import make_cp_forward, make_mesh_cp
    jcfg, jp, cfg, tp = moe_trees
    mesh = make_mesh_cp(1, 2, [torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        make_cp_forward(cfg, mesh)
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        load_model(MOE_FIXTURE, mesh=mesh)  # Engine(mesh=) gives it too
    with pytest.raises(ValueError, match="mixture-of-experts"):
        P.to_hf_state_dict(tp)
    with pytest.raises(ValueError, match="mixture-of-experts"):
        TF.write_gguf(tmp_path / "x.gguf", tp, cfg, ["a"] * 96)
    # expert parallelism is ported: a layer's experts split over a
    # two-shard axis give the one-device result
    from embeddings_tpu_torch.parallel import ModelAxis
    m = P.layer(tp, 1)["mlp"]
    halves = [{**m, "up": {k: v[r * 2:(r + 1) * 2]
                           for k, v in m["up"].items()},
               "down": {k: v[r * 2:(r + 1) * 2]
                        for k, v in m["down"].items()}} for r in range(2)]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 64)).astype(np.float32))
    ref = tmoe.moe_ffn(x, m, top_k=2, act="gelu")
    got = tmoe.moe_ffn(x, halves, top_k=2, act="gelu",
                       ep_axis=ModelAxis([torch.device("cpu")] * 2),
                       ep_tokens="replicated")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    for over in (dict(moe_every_n_layers=3), dict(num_hidden_layers=3),
                 dict(shared_layers=True)):
        with pytest.raises(NotImplementedError, match="num_experts"):
            P.check_supported(dataclasses.replace(cfg, **over))
    P.check_supported(cfg)


def test_int8_mode_runs_moe_unchained():
    """The int8 mode on an MoE tree: K3's plain version on the attention
    and dense-half weights (kept int8), the experts dense; the chained
    links never engage (``_int8_chain_ok`` is False on the tree)."""
    from embeddings_tpu_torch.ops.linear import chain_links
    e8 = load_model(MOE_FIXTURE, dtype="q4_0", int8_compute=True,
                    device="cpu")
    assert not tbert._int8_chain_ok(e8.params, e8.config, use_kernels=True,
                                    int8=True)
    assert e8.params["layers"]["dense"]["attn"]["qkv"]["w"].int8 is not None
    ref = load_model(MOE_FIXTURE, dtype="q4_0", device="cpu").encode_batch(
        TEXTS)
    got = e8.encode_batch(TEXTS)
    assert (got * ref).sum(-1).min() >= 0.99
    with chain_links({"attn", "ln", "ffn"}):
        np.testing.assert_array_equal(e8.encode_batch(TEXTS), got)
