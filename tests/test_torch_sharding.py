"""Data and Megatron tensor parallelism of the port
(``embeddings_tpu_torch/parallel/sharding.py``, ``bert``'s ``tp_axis``,
``moe_ffn``'s ``ep_axis``) on meshes that name the CPU dp x tp times,
against the JAX package's ``shard_map`` forwards on its 8 virtual CPU
devices (``tests/conftest.py``):

(a) ``make_mesh``, ``param_pspecs`` and ``adapt_packed_params`` against
    JAX's; the refusals word for word;
(b) ``make_sharded_forward`` and ``make_sharded_packed_forward`` against
    JAX's at (dp, tp) in {(8, 1), (4, 2), (2, 4), (1, 8)}, f32, q4_0 and
    q4_0 packed, on the plain path (both packages' XLA-fallback
    arithmetic: 3e-5 max abs on unit vectors); the kernel route (the
    kernels' plain versions at shard shapes: K1 with no epilogue on K/tp
    rows, K2 on H/tp heads) against the port's one-device kernel route;
(c) the families: rotary gated, MPNet's head-split bias, jina's ALiBi,
    the pre-norm stack, MoE (both expert-parallel schedules against JAX's
    ``shard_map(moe_ffn, ep_axis=...)``, and a TP forward whose MoE
    halves split the experts, one or two a shard);
(d) ``Engine(mesh=make_mesh(...))``, ``load_model(mesh=)``, the int8
    mode's per-shard K3 weights, the packed Engine path and the CLI's
    ``--dp`` / ``--tp``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JConfig
from embeddings_tpu.models import params as JP
from embeddings_tpu.ops.quant import QuantizedTensor as JQT
from embeddings_tpu import parallel as jpar
from embeddings_tpu.parallel import sharding as jsh

from embeddings_tpu_torch.config import BertConfig, EngineConfig
from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.ops import linear as tlin
from embeddings_tpu_torch.ops import moe as tmoe
from embeddings_tpu_torch.parallel import (ModelAxis, adapt_packed_params,
                                           make_mesh, make_sharded_forward,
                                           make_sharded_packed_forward,
                                           param_pspecs, shard_params)
from embeddings_tpu_torch.parallel.sharding import SPMD_REFUSAL
from embeddings_tpu_torch.runtime.engine import Engine, load_model

from .test_moe import MOE_HF_DICT, _moe_state_dict

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CPU = torch.device("cpu")
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
# bge-shaped, 8 heads of 32 so that tp = 8 keeps a whole head a shard
WIDE = dict(vocab_size=256, hidden_size=256, num_hidden_layers=2,
            num_attention_heads=8, intermediate_size=512,
            max_position_embeddings=32)


def _mesh(dp, tp):
    return make_mesh(dp, tp, [CPU] * (dp * tp))


def _batch(seed=1, B=8, L=16, V=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, V, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, 10:] = 0
    mask[3, 4:] = 0
    return ids, mask


def _trees(kw, dtype, seed=0):
    """(jax cfg, jax tree, port cfg) with weights of trained scale."""
    jcfg = JConfig(**kw)
    jp = JP.init_params(jcfg, rng=seed)
    if dtype != "f32":
        jp = JP.quantize_params(jp, "q4_0")
        if dtype == "packed":
            jp = JP.pack_q4_params(jp)
    return jcfg, jp, BertConfig(**kw)


def _jax_sharded(jp, jcfg, dp, tp, ids, mask, packed=False, **kw):
    mesh = jpar.make_mesh(dp=dp, tp=tp)
    if packed:
        jp = jsh.adapt_packed_params(jp, mesh)
    return np.asarray(jpar.make_sharded_forward(jcfg, mesh, **kw)(
        jpar.shard_params(jp, jcfg, mesh), jnp.asarray(ids),
        jnp.asarray(mask)))


def _port_sharded(jp, cfg, dp, tp, ids, mask, packed=False, **kw):
    mesh = _mesh(dp, tp)
    tp_tree = P.from_jax_params(jp)
    if packed:
        tp_tree = adapt_packed_params(tp_tree, mesh)
    return make_sharded_forward(cfg, mesh, **kw)(tp_tree, ids, mask).numpy()


# ---------------------------------------------------------------------------
# (a) meshes, specs, packing, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", MESHES)
def test_make_mesh(dp, tp):
    mesh = _mesh(dp, tp)
    assert dict(mesh.shape) == {"data": dp, "model": tp} == dict(
        jpar.make_mesh(dp=dp, tp=tp).shape)
    assert dict(make_mesh(None, tp, [CPU] * 8).shape) == dict(mesh.shape)
    with pytest.raises(ValueError) as ours:
        make_mesh(3, tp, [CPU] * 8)
    with pytest.raises(ValueError) as jx:
        jpar.make_mesh(dp=3, tp=tp)
    assert str(ours.value) == str(jx.value)


def test_make_mesh_without_a_card_fails_loudly(monkeypatch):
    """No CUDA device: the default mesh and a mesh that names "cuda"
    raise (so ``Engine(mesh=...)`` never falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 2, [torch.device("cuda")] * 2)


def _spec_axis(jspec):
    """A JAX PartitionSpec -> the axis it splits over "model" (or None)."""
    axes = [i for i, a in enumerate(jspec) if a == "model"]
    return axes[0] if axes else None


def _compare_specs(ours, theirs):
    if isinstance(theirs, JQT):
        for part in ([theirs.codes, theirs.scales]
                     + ([] if theirs.mins is None else [theirs.mins])):
            assert ours.axis == _spec_axis(part)
    elif isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _compare_specs(ours[k], theirs[k])
    else:
        assert ours.axis == _spec_axis(theirs), (ours, theirs)


@pytest.mark.parametrize("family,dtype,tp", [
    ("bge", "q4_0", 8), ("bge", "packed", 4), ("bge_narrow", "q4_0", 4),
    ("mpnet", "f32", 2), ("alibi", "f32", 4), ("moe", "f32", 2),
    ("moe", "f32", 8)])
def test_param_pspecs_match_jax(family, dtype, tp):
    """Column / row / head / expert splits and the all-or-nothing and
    group-64 fallbacks, leaf for leaf as JAX's PartitionSpecs."""
    jcfg, jp, _ = FAMILIES[family](dtype)
    mesh = _mesh(8 // tp, tp)
    _compare_specs(param_pspecs(P.from_jax_params(jp), mesh),
                   jsh.param_pspecs(jp, jpar.make_mesh(dp=8 // tp, tp=tp)))


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_adapt_packed_params_matches_jax(tp):
    """Only the row-parallel weights whose shards would split group-64
    packs unpack, to JAX's int8 codes."""
    jcfg, jp, _ = _trees(WIDE, "packed")
    theirs = jsh.adapt_packed_params(jp, jpar.make_mesh(dp=8 // tp, tp=tp))
    ours = adapt_packed_params(P.from_jax_params(jp), _mesh(8 // tp, tp))
    for grp, name in (("attn", "q"), ("attn", "o"), ("mlp", "up"),
                      ("mlp", "down")):
        a, b = ours["layers"][grp][name]["w"], theirs["layers"][grp][name]["w"]
        assert a.packed == b.packed, (tp, grp, name)
        np.testing.assert_array_equal(a.codes.numpy(), np.asarray(b.codes))
    assert ours["layers"]["attn"]["o"]["w"].packed == (tp < 8)


def test_refusals_word_for_word():
    """tp that cannot shard a quantized weight: JAX's ValueError, word for
    word, from the bucketed and the packed forwards; a fused tree;
    spmd='gspmd' (the JAX package's kernel-free cross-check) and an
    unknown spmd are refused when the forward is made."""
    cfg_kw = dict(WIDE, hidden_size=32, num_attention_heads=1,
                  intermediate_size=64)
    jcfg, jp, cfg = _trees(cfg_kw, "q4_0")
    ids, mask = _batch()
    with pytest.raises(ValueError, match="cannot shard") as jx:
        _jax_sharded(jp, jcfg, 4, 2, ids, mask)
    with pytest.raises(ValueError) as ours:
        _port_sharded(jp, cfg, 4, 2, ids, mask)
    assert str(ours.value) == str(jx.value)
    sp = shard_params(P.from_jax_params(jp), cfg, _mesh(4, 2))
    with pytest.raises(ValueError) as ours_packed:
        make_sharded_packed_forward(cfg, _mesh(4, 2))(
            sp, ids, np.where(mask > 0, 0, -1), np.zeros_like(ids),
            np.zeros((8, 1, 16), np.float32))
    assert str(ours_packed.value) == str(jx.value)
    with pytest.raises(ValueError, match="fuse_qkv"):
        shard_params(P.fuse_qkv(P.from_jax_params(jp)), cfg, _mesh(4, 2))
    for spmd in ("gspmd", "pjit"):
        with pytest.raises(ValueError) as refused:
            make_sharded_forward(cfg, _mesh(4, 2), spmd=spmd)
        assert str(refused.value) == SPMD_REFUSAL.format(spmd=spmd)
        assert "spmd='shard_map' only" in str(refused.value)


def test_shard_params_slices_once_and_shares():
    """Shard j holds the j-th contiguous slice; replicated leaves are one
    tensor for every shard of a device; the slices joined along their
    split axis give the tree back."""
    jcfg, jp, cfg = _trees(WIDE, "packed")
    tree = P.from_jax_params(jp)
    sp = shard_params(tree, cfg, _mesh(2, 4))
    assert len(sp.distinct_trees()) == 4
    up = [sp.tree(1, j)["layers"]["mlp"]["up"]["w"] for j in range(4)]
    assert all(w.codes.is_contiguous() and w.codes.shape[-1] == 128
               for w in up)
    o = sp.tree(0, 2)["layers"]["attn"]["o"]["w"]
    np.testing.assert_array_equal(
        o.codes.numpy(), tree["layers"]["attn"]["o"]["w"].codes[
            :, 64:96].numpy())
    assert sp.tree(0, 1)["embeddings"]["word"] is \
        sp.tree(1, 3)["embeddings"]["word"]
    assert sp.tree(0, 1)["layers"]["attn"]["o"]["b"] is \
        sp.tree(0, 0)["layers"]["attn"]["o"]["b"]
    for grp, name in (("attn", "q"), ("attn", "o"), ("mlp", "down")):
        axis = sp.specs["layers"][grp][name]["w"].axis
        for part in ("codes", "scales"):
            back = torch.cat([getattr(sp.tree(0, j)["layers"][grp][name]
                                      ["w"], part) for j in range(4)], axis)
            np.testing.assert_array_equal(
                back.numpy(),
                getattr(tree["layers"][grp][name]["w"], part).numpy())


# ---------------------------------------------------------------------------
# (b) the sharded forwards against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "q4_0", "packed"])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_forward_matches_jax(dtype, dp, tp):
    jcfg, jp, cfg = _trees(WIDE, dtype)
    ids, mask = _batch()
    packed = dtype == "packed"
    ref = _jax_sharded(jp, jcfg, dp, tp, ids, mask, packed=packed)
    got = _port_sharded(jp, cfg, dp, tp, ids, mask, packed=packed,
                        use_kernels=False)
    assert got.shape == (8, 256)
    assert np.abs(got - ref).max() <= 3e-5


class _Calls:
    """Records the kernel wrappers' calls (their plain versions on the
    CPU): qmatmul by epilogue, the attention wrappers by head count."""

    def __init__(self, monkeypatch):
        self.mm, self.attn = [], []
        orig_mm = tlin.qmatmul

        def mm(*a, **kw):
            # the epilogue qmatmul resolves: "bias" or "none" when unnamed
            epi = kw.get("epilogue") or ("none" if a[4] is None
                                         else "bias")
            self.mm.append((epi, a[0].shape[-1]))
            return orig_mm(*a, **kw)
        monkeypatch.setattr(tlin, "qmatmul", mm)
        for name in ("fused_attention", "fused_attention_bias",
                     "fused_attention_segmented"):
            orig = getattr(tattn, name)

            def attn(*a, _o=orig, _n=name, **kw):
                self.attn.append((_n, kw["H"]))
                return _o(*a, **kw)
            monkeypatch.setattr(tattn, name, attn)


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 8)])
def test_kernel_route_at_shard_shapes(dp, tp, monkeypatch):
    """use_kernels: every shard's q, k, v, up through K1 and its o, down
    through K1 with no epilogue on K/tp rows (6 a layer a shard), and K2
    on its H/tp heads (one a layer a shard; at tp >= 4 a shard is 64 or
    32 wide, past JAX's 128-lane rule, within the kernels' own): the
    one-device kernel route's embeddings, and JAX's within its plain
    path's cosine."""
    jcfg, jp, cfg = _trees(WIDE, "packed")
    ids, mask = _batch(2)
    calls = _Calls(monkeypatch)
    got = _port_sharded(jp, cfg, dp, tp, ids, mask, packed=True)
    NL, H = 2, 8
    assert sorted(set(calls.attn)) == [("fused_attention", H // tp)]
    assert len(calls.attn) == NL * dp * tp
    assert len(calls.mm) == 6 * NL * dp * tp
    assert sum(e == "none" for e, _ in calls.mm) == 2 * NL * dp * tp
    single = tbert.encode_tokens(
        P.from_jax_params(jp), cfg, torch.from_numpy(ids),
        torch.from_numpy(mask)).numpy()
    assert np.abs(got - single).max() <= 1e-5
    ref = _jax_sharded(jp, jcfg, dp, tp, ids, mask, packed=True)
    assert (got * ref).sum(-1).min() >= 0.999


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_packed_forward_matches_jax(dp, tp):
    """Packed rows over "data", TP within each row: JAX's
    make_sharded_packed_forward on the same arrays."""
    from embeddings_tpu_torch.runtime.packing import materialize, \
        plan_packing
    jcfg, jp, cfg = _trees(WIDE, "q4_0")
    rng = np.random.default_rng(5)
    toks = [list(rng.integers(5, 256, n)) for n in (5, 9, 3, 12, 7, 4, 6,
                                                      10, 2, 8, 11, 3)]
    b = plan_packing([len(t) for t in toks], 16, 8, max_segs=4)[0]
    b.batch = 8
    ids, seg, pos, pool, _ = materialize(b, toks, 0, "cls")
    arrays = (ids, seg, pos, pool)
    jm = jpar.make_mesh(dp=dp, tp=tp)
    ref = np.asarray(jsh.make_sharded_packed_forward(jcfg, jm)(
        jpar.shard_params(jp, jcfg, jm), *map(jnp.asarray, arrays)))
    got = make_sharded_packed_forward(cfg, _mesh(dp, tp), use_kernels=False)(
        P.from_jax_params(jp), *arrays).numpy()
    assert np.abs(got - ref).max() <= 3e-5


# ---------------------------------------------------------------------------
# (c) the families
# ---------------------------------------------------------------------------

def _bge(dtype):
    return _trees(WIDE, dtype)


def _bge_narrow(dtype):
    return _trees(dict(WIDE, hidden_size=128, num_attention_heads=4,
                       intermediate_size=256), dtype)


def _rotary(dtype):
    return _trees(dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=8, intermediate_size=128,
                       max_position_embeddings=32,
                       position_embedding_type="rotary", rotary_base=1000.0,
                       gated_mlp=True, hidden_act="silu"), dtype)


def _mpnet(dtype):
    return _trees(dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=256,
                       max_position_embeddings=40,
                       relative_attention_num_buckets=32), dtype)


def _alibi(dtype):
    return _trees(dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=256,
                       max_position_embeddings=64,
                       position_embedding_type="alibi", gated_mlp=True,
                       hidden_act="gelu"), dtype)


def _prenorm(dtype):
    return _trees(dict(vocab_size=256, hidden_size=128, num_hidden_layers=3,
                       num_attention_heads=4, intermediate_size=256,
                       max_position_embeddings=64,
                       position_embedding_type="rotary",
                       rotary_base=160000.0, local_rotary_base=10000.0,
                       global_attn_every_n_layers=3,
                       local_attention_window=8, gated_mlp=True,
                       norm_style="pre", first_attn_norm_identity=True,
                       layer_norm_eps=1e-5, type_vocab_size=1,
                       pooling="cls"), dtype)


def _moe(dtype):
    sd = _moe_state_dict(np.random.default_rng(7), MOE_HF_DICT)
    jcfg = JConfig.from_hf_dict(MOE_HF_DICT)
    jp = JP.from_hf_state_dict(sd, jcfg)
    if dtype != "f32":
        jp = JP.quantize_params(jp, "q4_0")
    return jcfg, jp, BertConfig.from_hf_dict(MOE_HF_DICT)


FAMILIES = {"bge": _bge, "bge_narrow": _bge_narrow, "rotary": _rotary,
            "mpnet": _mpnet, "alibi": _alibi, "prenorm": _prenorm,
            "moe": _moe}


@pytest.mark.parametrize("family,dp,tp", [
    ("rotary", 2, 4), ("mpnet", 4, 2), ("alibi", 2, 4), ("prenorm", 4, 2),
    ("moe", 4, 2), ("moe", 2, 4)])
def test_family_sharded_forward_matches_jax(family, dp, tp):
    """RoPE per local head, MPNet's table and jina's slopes split by head,
    the pre-norm block's bias after the sum and its window in the mask,
    and the MoE halves' experts split over the model axis, against JAX
    on the plain path."""
    jcfg, jp, cfg = FAMILIES[family]("f32")
    ids, mask = _batch(3, V=cfg.vocab_size)
    ref = _jax_sharded(jp, jcfg, dp, tp, ids, mask)
    got = _port_sharded(jp, cfg, dp, tp, ids, mask, use_kernels=False)
    assert np.abs(got - ref).max() <= 3e-5


def test_mpnet_kernel_route_splits_the_bias(monkeypatch):
    """MPNet at tp = 2 on the kernel route: K7 on each shard's 2 heads with
    its half of the table, as the one-device K7 forward."""
    jcfg, jp, cfg = _mpnet("q4_0")
    ids, mask = _batch(4)
    calls = _Calls(monkeypatch)
    got = _port_sharded(jp, cfg, 4, 2, ids, mask)
    assert set(calls.attn) == {("fused_attention_bias", 2)}
    single = tbert.encode_tokens(
        P.from_jax_params(jp), cfg, torch.from_numpy(ids),
        torch.from_numpy(mask)).numpy()
    assert np.abs(got - single).max() <= 1e-5


def _expert_shards(m, n):
    e = m["up"]["w"].shape[0] // n
    return [{**m, "up": {k: v[r * e:(r + 1) * e] for k, v in
                         m["up"].items()},
             "down": {k: v[r * e:(r + 1) * e] for k, v in
                      m["down"].items()}} for r in range(n)]


@pytest.mark.parametrize("ep_tokens", ["sharded", "replicated"])
def test_moe_ffn_expert_parallel_matches_jax(ep_tokens):
    """Both EP schedules against JAX's ``shard_map(moe_ffn, ep_axis)`` on
    4 devices (``tests/test_moe.py``'s shapes): 4 experts, one a
    shard."""
    from jax.sharding import Mesh as JMesh, PartitionSpec as Sp
    from embeddings_tpu.ops.moe import moe_ffn as jmoe_ffn
    from .test_moe import _single_moe_params, shard_map
    D, Ex, T = 32, 4, 64
    jm = _single_moe_params(np.random.default_rng(8), D, 48, Ex)
    x = np.random.default_rng(9).standard_normal((T, D)).astype(np.float32)
    mesh = JMesh(np.array(jax.devices()[:4]), ("ep",))
    pspecs = {"router": {"w": Sp()}, "up": {"w": Sp("ep"), "b": Sp("ep")},
              "down": {"w": Sp("ep"), "b": Sp("ep")}, "bias": Sp()}
    tok = Sp("ep") if ep_tokens == "sharded" else Sp()
    f = shard_map(lambda xs, ms: jmoe_ffn(xs, ms, top_k=2, act="gelu",
                                          ep_axis="ep", ep_tokens=ep_tokens),
                  mesh=mesh, in_specs=(tok, pspecs), out_specs=tok,
                  check_vma=False)
    ref = np.asarray(jax.jit(f)(jnp.asarray(x), jm))
    m = P.from_jax_params(jm)
    axis = ModelAxis([CPU] * 4)
    xt = torch.from_numpy(x)
    xin = list(xt.chunk(4)) if ep_tokens == "sharded" else xt
    got = tmoe.moe_ffn(xin, _expert_shards(m, 4), top_k=2, act="gelu",
                       ep_axis=axis, ep_tokens=ep_tokens)
    got = torch.cat(got) if ep_tokens == "sharded" else got
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    one = tmoe.moe_ffn(xt, m, top_k=2, act="gelu").numpy()
    np.testing.assert_allclose(got.numpy(), one, atol=1e-5)


# ---------------------------------------------------------------------------
# (d) the Engine, load_model and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tok(small_vocab):
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    return WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab))


TEXTS = ["hello world", "the quick brown fox", "a b c", "hello world",
         "embedding model", "fox fox fox", "new old big small", "x"]


def test_engine_with_mesh(tok, small_vocab):
    """Engine(mesh=make_mesh(4, 2)): the single-device embeddings (the
    tree sharded once; batch fields rounded to dp on a private copy),
    packed too."""
    kw = dict(WIDE, vocab_size=len(small_vocab))
    params = P.pack_q4_params(P.quantize_params(
        P.init_params(BertConfig(**kw), 0), "q4_0"))
    cfg = BertConfig(**kw)
    ec = EngineConfig(seq_buckets=(16,), max_seq_len=16, batch_size=6,
                      batch_buckets=(1, 2, 4))
    before = (ec.batch_size, ec.batch_buckets)
    eng = Engine(params, cfg, tok, ec, device="cpu", mesh=_mesh(4, 2))
    assert (ec.batch_size, ec.batch_buckets) == before
    assert eng.engine_config.batch_size == 8
    assert eng.params["layers"]["attn"]["q"]["w"].codes.shape[-1] == 128
    single = Engine(params, cfg, tok, ec, device="cpu")
    a, b = eng.encode_batch(TEXTS), single.encode_batch(TEXTS)
    assert np.abs(a - b).max() <= 1e-5
    c = eng.encode_batch_packed(TEXTS, row_len=16)
    assert np.abs(c - single.encode_batch_packed(TEXTS, row_len=16)).max() \
        <= 1e-5


def test_engine_int8_keeps_each_shards_weights(tok, small_vocab):
    """int8_compute under a mesh: each shard requantizes its own slices
    (K3's kept weights, [N/tp, K] and [N, K/tp]), as the JAX kernel
    requantizes the shard it is given; the embeddings stay within the
    int8 mode's cosine of the one-device int8 Engine."""
    kw = dict(WIDE, vocab_size=len(small_vocab))
    params = P.pack_q4_params(P.quantize_params(
        P.init_params(BertConfig(**kw), 0), "q4_0"))
    ec = EngineConfig(seq_buckets=(16,), max_seq_len=16, batch_size=8,
                      batch_buckets=(8,), int8_compute=True)
    eng = Engine(params, BertConfig(**kw), tok, ec, device="cpu",
                 mesh=_mesh(2, 2))
    t = eng._mesh_params.tree(1, 1)["layers"]
    assert t["attn"]["q"]["w"].int8[0].shape == (2, 128, 256)
    assert t["attn"]["o"]["w"].int8[0].shape == (2, 256, 128)
    single = Engine(params, BertConfig(**kw), tok, ec, device="cpu")
    a, b = eng.encode_batch(TEXTS), single.encode_batch(TEXTS)
    assert (a * b).sum(-1).min() >= 0.999


def test_load_model_with_mesh_keeps_packed_selectively(small_vocab,
                                                       tmp_path):
    """load_model(mesh=) at tp=4: attn.o (K=256: 32 packed rows a shard)
    stays packed, and at tp=8 (16) unpacks, as JAX's load_model does; the
    embeddings equal the one-device Engine's."""
    from embeddings_tpu.runtime.engine import load_model as jload
    kw = dict(WIDE, vocab_size=len(small_vocab))
    jcfg = JConfig(**kw)
    JP.save_native(str(tmp_path / "m.npz"), JP.pack_q4_params(
        JP.quantize_params(JP.init_params(jcfg, rng=0), "q4_0")), jcfg)
    (tmp_path / "vocab.txt").write_text("\n".join(small_vocab))
    ec = EngineConfig(seq_buckets=(16,), max_seq_len=16, batch_size=8,
                      batch_buckets=(8,))
    single = load_model(tmp_path / "m.npz", dtype="q4_0", engine_config=ec,
                        device="cpu").encode_batch(TEXTS)
    for tp in (4, 8):
        eng = load_model(tmp_path / "m.npz", dtype="q4_0",
                         engine_config=ec, mesh=_mesh(8 // tp, tp))
        jeng = jload(tmp_path / "m.npz", dtype="q4_0", engine_config=ec,
                     mesh=jpar.make_mesh(dp=8 // tp, tp=tp))
        o = eng.params["layers"]["attn"]["o"]["w"]
        assert o.packed == jeng.params["layers"]["attn"]["o"]["w"].packed \
            == (tp == 4)
        assert np.abs(eng.encode_batch(TEXTS) - single).max() <= 1e-5


def test_cli_dp_tp(tmp_path, small_vocab, capsys):
    """--dp 2 --tp 2 builds make_mesh(2, 2) naming --device four times:
    the single-device embeddings."""
    from embeddings_tpu_torch.cli import main
    cfg = BertConfig(**dict(WIDE, vocab_size=len(small_vocab)))
    P.save_native(tmp_path / "m.npz", P.init_params(cfg, 0), cfg)
    (tmp_path / "vocab.txt").write_text("\n".join(small_vocab))
    outs = []
    for extra in ([], ["--dp", "2", "--tp", "2"]):
        argv = ["encode", "-m", str(tmp_path / "m.npz"), "--format", "json",
                "--device", "cpu", *extra]
        for t in TEXTS[:3]:
            argv += ["-p", t]
        assert main(argv) == 0
        outs.append(np.asarray(json.loads(capsys.readouterr().out)[
            "embeddings"]))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5)
