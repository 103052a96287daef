"""Context parallelism of the PyTorch port against the JAX package, on the
CPU: the CP attention kernels' plain versions (K8a, K8b) against the
Pallas kernels in interpret mode, and the port's ``make_cp_forward`` on a
mesh of CPU devices against JAX's ``make_cp_forward`` on the 8 virtual
CPU devices (``tests/conftest.py``), on the same numpy-seeded weights
(``params.from_jax_params``) and batches.

Tolerances. The kernels in f32: the same expression in both, apart from
f32 summation order (1e-5). In bf16 both round the scores' probabilities
to bf16 at the same points; a probability whose f32 value sits on a bf16
rounding boundary can round the other way, and the output is rounded to
bf16: 2^-6 relative plus 2e-3 absolute (as K2's bf16 test). The forwards:
the einsum route at JAX's own ``atol=2e-5, rtol=1e-5`` (its CP tests'
bound against its single-device forward); the kernel route the same (both
sides f32, the plain versions repeat the TPU kernels' arithmetic); q4_0
at JAX's ``atol=2e-4, rtol=1e-3`` for quantized CP.
"""

import dataclasses
import importlib
import logging
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JConfig
from embeddings_tpu.models import params as JP
from embeddings_tpu.ops import attention as jattn
from embeddings_tpu.parallel import context as jctx
# the module (``embeddings_tpu.ops.linear`` the attribute is the function)
jlinear = importlib.import_module("embeddings_tpu.ops.linear")

from embeddings_tpu_torch.config import BertConfig, EngineConfig
from embeddings_tpu_torch.models import bert, params as P
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, \
    Mesh, context as C, make_cp_forward, make_mesh_cp
from embeddings_tpu_torch.runtime.engine import Engine
from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
    WordPieceVocab

CPU = torch.device("cpu")
ATOL, RTOL = 2e-5, 1e-5
MESHES = [(4, 2), (2, 4), (1, 8)]
SMALL = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=64)
# E = 128 (2 heads of 64): the shapes the CP kernels take
WIDE = dict(SMALL, hidden_size=128, num_attention_heads=2)
# ALBERT: factorized embeddings (32 wide) and one shared layer, at the
# width the CP kernels take
ALBERT = dict(WIDE, num_hidden_layers=3, embedding_size=32,
              shared_layers=True, hidden_act="gelu_tanh")
ROTARY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=128,
              max_position_embeddings=64, position_embedding_type="rotary",
              rotary_base=1000.0, gated_mlp=True, hidden_act="silu")


@pytest.fixture(scope="module")
def jax_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    return devs


@pytest.fixture(scope="module")
def jax_forwards(jax_devices):
    """JAX's jitted CP forwards, shared by the tests: (key, build) ->
    forward, compiled on first use."""
    cache = {}

    def get(key, build):
        if key not in cache:
            cache[key] = build()
        return cache[key]
    return get


def _models(kw, seed=0):
    jcfg = JConfig(**kw)
    jp = JP.init_params(jcfg, rng=seed)
    return jcfg, jp, BertConfig(**kw), P.from_jax_params(jp)


@pytest.fixture(scope="module")
def small():
    return _models(SMALL)


@pytest.fixture(scope="module")
def wide():
    return _models(WIDE)


def _batch(vocab, rng, B=8, L=32):
    ids = rng.integers(5, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, L * 5 // 8:] = 0   # pads ending inside the last seq shard
    mask[1, 7:] = 0            # pads starting inside the first shard
    return ids, mask


def _port_cp(cfg, tp, ids, mask, dp, sp, **kw):
    fwd = make_cp_forward(cfg, make_mesh_cp(dp, sp, [CPU] * (dp * sp)),
                          **kw)
    return fwd(tp, ids, mask).numpy()


def _jax_cp(jcfg, jp, ids, mask, dp, sp, jax_devices, jax_forwards,
            key=None):
    fwd = jax_forwards(key or (repr(jcfg), dp, sp), lambda: jctx
                       .make_cp_forward(jcfg, jctx.make_mesh_cp(
                           dp=dp, sp=sp, devices=jax_devices[:dp * sp])))
    return np.asarray(fwd(jp, jnp.asarray(ids), jnp.asarray(mask)))


# ---------------------------------------------------------------------------
# K8a, K8b: the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _cp_inputs(B, Lc, L, H, D, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    E = H * D
    q = (rng.standard_normal((B * Lc, E)) * scale).astype(np.float32)
    kv = (rng.standard_normal((B * L, 2 * E)) * scale).astype(np.float32)
    lengths = np.array([max(1, L - 5 * b) for b in range(B)], np.int32)
    return q, kv, lengths


def _jax_cp_attn(stream, q, kv, lengths, dtype, **kw):
    fn = (jattn.fused_attention_cp_stream if stream
          else jattn.fused_attention_cp)
    out = fn(jnp.asarray(q, dtype), jnp.asarray(kv, dtype),
             jnp.asarray(lengths), interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


# JAX's shapes (tests/test_attention.py): K8a (B, Lc, L, H, D), K8b
# (Lc, L, BK) at B=2, H=2, D=64; and around the Hopper kernel's tiles (64
# query rows, 128 keys): K8a at Lc = 8 and 72 against L = 200 keys (not a
# multiple of 128; the second row's length 195 ends inside a key tile),
# K8b over three key tiles of 128
K8A_CASES = [(2, 16, 64, 2, 64), (1, 64, 64, 2, 64), (3, 8, 32, 4, 32),
             (2, 8, 200, 2, 64), (2, 72, 200, 2, 64)]
K8B_CASES = [(128, 256, 128), (128, 512, 256), (256, 256, 128),
             (128, 384, 128)]


@pytest.mark.parametrize("B,Lc,L,H,D", K8A_CASES)
def test_cp_attention_matches_jax_f32(B, Lc, L, H, D):
    q, kv, lengths = _cp_inputs(B, Lc, L, H, D, seed=L + Lc)
    ref = _jax_cp_attn(False, q, kv, lengths, jnp.float32, B=B, Lc=Lc, L=L,
                       H=H, D=D)
    args = (torch.from_numpy(q), torch.from_numpy(kv),
            torch.from_numpy(lengths))
    got = tattn.fused_attention_cp(*args, B=B, Lc=Lc, L=L, H=H, D=D)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    plain = tattn.fused_attention_cp_ref(*args, B=B, Lc=Lc, L=L, H=H, D=D)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("Lc,L,BK", K8B_CASES)
def test_cp_stream_attention_matches_jax_f32(Lc, L, BK):
    B, H, D = 2, 2, 64
    q, kv, _ = _cp_inputs(B, Lc, L, H, D, seed=L + BK, scale=0.5)
    lengths = np.array([L, L - 77], np.int32)
    kw = dict(B=B, Lc=Lc, L=L, H=H, D=D, BK=BK)
    ref = _jax_cp_attn(True, q, kv, lengths, jnp.float32, **kw)
    args = (torch.from_numpy(q), torch.from_numpy(kv),
            torch.from_numpy(lengths))
    got = tattn.fused_attention_cp_stream(*args, **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    plain = tattn.fused_attention_cp_stream_ref(*args, **kw)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    # the streamed sums meet the whole-row ones (JAX's own check)
    whole = tattn.fused_attention_cp_ref(*args, B=B, Lc=Lc, L=L, H=H, D=D)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("stream,case", [(False, K8A_CASES[0]),
                                         (False, K8A_CASES[2]),
                                         (True, (2, 128, 256, 2, 64))])
def test_cp_attention_matches_jax_bf16(stream, case):
    B, Lc, L, H, D = case
    q, kv, lengths = _cp_inputs(B, Lc, L, H, D, seed=7)
    lengths[0] = 0                      # a len-0 row: exactly zero
    kw = dict(B=B, Lc=Lc, L=L, H=H, D=D, **({"BK": 128} if stream else {}))
    ref = _jax_cp_attn(stream, q, kv, lengths, jnp.bfloat16, **kw)
    fn = (tattn.fused_attention_cp_stream if stream
          else tattn.fused_attention_cp)
    got = fn(torch.from_numpy(q).bfloat16(), torch.from_numpy(kv).bfloat16(),
             torch.from_numpy(lengths), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -6,
                               atol=2e-3)
    assert np.all(got.float().numpy().reshape(B, Lc, -1)[0] == 0)


@pytest.mark.parametrize("Lc,L", [(16, 64), (8, 200), (72, 200)])
def test_cp_attention_reads_q_in_place(Lc, L):
    """q may be a column view of the local fused projection [B*Lc, 3E]
    (row stride 3E): the result equals that of a contiguous copy (row
    stride E), and JAX's on that copy."""
    B, H, D = 2, 2, 64
    E = H * D
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B * Lc, 3 * E),
                                               dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((B * L, 2 * E),
                                              dtype=np.float32))
    lengths = torch.tensor([L, 20], dtype=torch.int32)
    view = qkv[:, :E]
    assert view.stride() == (3 * E, 1)
    kw = dict(B=B, Lc=Lc, L=L, H=H, D=D)
    got = tattn.fused_attention_cp(view, kv, lengths, **kw).numpy()
    np.testing.assert_array_equal(
        got, tattn.fused_attention_cp(view.contiguous(), kv, lengths,
                                      **kw).numpy())
    ref = _jax_cp_attn(False, view.contiguous().numpy(), kv.numpy(),
                       lengths.numpy(), jnp.float32, **kw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_cp_attention_shape_rules():
    z = torch.zeros
    lens = z(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not take"):   # Lc % 8
        tattn.fused_attention_cp(z(2 * 12, 128), z(2 * 64, 256), lens, B=2,
                                 Lc=12, L=64, H=2, D=64)
    with pytest.raises(ValueError, match="does not take"):   # Lc % 128
        tattn.fused_attention_cp_stream(z(2 * 64, 128), z(2 * 256, 256),
                                        lens, B=2, Lc=64, L=256, H=2, D=64,
                                        BK=128)
    with pytest.raises(ValueError, match="kv"):
        tattn.fused_attention_cp(z(2 * 16, 128), z(2 * 64, 128), lens, B=2,
                                 Lc=16, L=64, H=2, D=64)
    for Lc, L in [(16, 64), (8, 1024), (256, 2048)]:
        assert C.cp_route_name(Lc, L, 12, 64) == (
            "cp" if jattn.whole_row_fits(L, 768) else "cp_stream")
    assert C.cp_route_name(8, 2048, 12, 64) == "einsum"   # Lc % 128
    assert C.cp_route_name(16, 64, 4, 16) == "einsum"     # D=16


# ---------------------------------------------------------------------------
# make_cp_forward against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,sp", MESHES)
@pytest.mark.parametrize("pooling", ["mean", "cls", "max"])
def test_cp_forward_matches_jax(small, jax_devices, jax_forwards, dp, sp,
                                pooling):
    jcfg, jp, cfg, tp = small
    jcfg = dataclasses.replace(jcfg, pooling=pooling)
    cfg = dataclasses.replace(cfg, pooling=pooling)
    ids, mask = _batch(cfg.vocab_size, np.random.default_rng(0))
    ref = _jax_cp(jcfg, jp, ids, mask, dp, sp, jax_devices, jax_forwards)
    got = _port_cp(cfg, tp, ids, mask, dp, sp)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    # and the port's single-device forward
    single = bert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, single, atol=ATOL, rtol=RTOL)


@pytest.fixture
def jax_kernels():
    """JAX's Pallas route on the CPU: ``_use_pallas`` patched on, the CP
    kernels in interpret mode; yields the names of the kernels called."""
    calls = []

    def spy(fn, name):
        def call(*a, **kw):
            calls.append(name)
            return fn(*a, **kw, interpret=True)
        return call

    with mock.patch.object(jlinear, "_use_pallas", lambda: True), \
            mock.patch.object(jattn, "fused_attention_cp",
                              spy(jattn.fused_attention_cp, "cp")), \
            mock.patch.object(jattn, "fused_attention_cp_stream",
                              spy(jattn.fused_attention_cp_stream,
                                  "cp_stream")):
        yield calls


@pytest.fixture
def port_calls():
    """The port's CP kernel calls (their plain versions on the CPU)."""
    calls = []

    def spy(fn, name):
        def call(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return call

    with mock.patch.object(tattn, "fused_attention_cp",
                           spy(tattn.fused_attention_cp, "cp")), \
            mock.patch.object(tattn, "fused_attention_cp_stream",
                              spy(tattn.fused_attention_cp_stream,
                                  "cp_stream")):
        yield calls


@pytest.mark.parametrize("dp,sp,pooling", [(2, 4, "mean"), (1, 8, "cls"),
                                           (4, 2, "max")])
def test_cp_forward_kernel_route_matches_jax(wide, jax_devices, jax_kernels,
                                             port_calls, dp, sp, pooling):
    """E=128: both packages take K8a on every layer of every shard (L=64,
    Lc = 64/sp); the port's plain versions against JAX's Pallas kernels
    in interpret mode."""
    jcfg, jp, cfg, tp = wide
    jcfg = dataclasses.replace(jcfg, pooling=pooling)
    cfg = dataclasses.replace(cfg, pooling=pooling)
    ids, mask = _batch(cfg.vocab_size, np.random.default_rng(4), L=64)
    fwd = jctx.make_cp_forward(jcfg, jctx.make_mesh_cp(
        dp=dp, sp=sp, devices=jax_devices[:dp * sp]))
    ref = np.asarray(fwd(jp, jnp.asarray(ids), jnp.asarray(mask)))
    got = _port_cp(cfg, tp, ids, mask, dp, sp)
    assert set(jax_kernels) == {"cp"}
    assert port_calls == ["cp"] * (cfg.num_hidden_layers * dp * sp)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_cp_forward_forced_stream_route(wide, jax_devices, jax_kernels,
                                        port_calls):
    """Past the whole-row rule (patched in both packages, as JAX's
    test_cp_forward_streams_past_whole_row does): K8b on every layer."""
    jcfg, jp, cfg, tp = _models(dict(WIDE, max_position_embeddings=512))
    rng = np.random.default_rng(5)
    ids = rng.integers(5, cfg.vocab_size, (2, 256)).astype(np.int32)
    mask = np.ones((2, 256), np.int32)
    mask[1, 130:] = 0
    with mock.patch.object(jattn, "whole_row_fits", lambda *a, **k: False), \
            mock.patch.object(tattn, "whole_row_fits",
                              lambda *a, **k: False):
        fwd = jctx.make_cp_forward(jcfg, jctx.make_mesh_cp(
            dp=1, sp=2, devices=jax_devices[:2]))
        ref = np.asarray(fwd(jp, jnp.asarray(ids), jnp.asarray(mask)))
        got = _port_cp(cfg, tp, ids, mask, 1, 2)
    assert set(jax_kernels) == {"cp_stream"}
    assert port_calls == ["cp_stream"] * (cfg.num_hidden_layers * 2)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_cp_forward_einsum_route_without_kernels(wide, port_calls):
    """``use_kernels=False``: the einsum path at every shape."""
    _, _, cfg, tp = wide
    ids, mask = _batch(cfg.vocab_size, np.random.default_rng(6), L=64)
    got = _port_cp(cfg, tp, ids, mask, 2, 4, use_kernels=False)
    assert port_calls == []
    kern = _port_cp(cfg, tp, ids, mask, 2, 4)
    np.testing.assert_allclose(got, kern, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fused", [False, True])
def test_cp_forward_fused_and_unfused_trees(small, jax_devices,
                                            jax_forwards, fused):
    """CP takes the tree as given: q/k/v apart (the JAX Engine's CP
    branch does not fuse) or fused."""
    jcfg, jp, cfg, tp = small
    if fused:
        jp, tp = JP.fuse_qkv(jp), P.fuse_qkv(tp)
        assert "qkv" in tp["layers"]["attn"]
    ids, mask = _batch(cfg.vocab_size, np.random.default_rng(1))
    ref = _jax_cp(jcfg, jp, ids, mask, 2, 4, jax_devices, jax_forwards)
    got = _port_cp(cfg, tp, ids, mask, 2, 4)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_cp_forward_q4_0(small, jax_devices, jax_forwards):
    jcfg, jp, cfg, _ = small
    jq = JP.quantize_params(jp, "q4_0")
    tq = P.from_jax_params(jq)
    ids, mask = _batch(cfg.vocab_size, np.random.default_rng(2))
    ref = _jax_cp(jcfg, jq, ids, mask, 2, 4, jax_devices, jax_forwards)
    got = _port_cp(cfg, tq, ids, mask, 2, 4)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_cp_forward_global_positions(small):
    """Each shard embeds global positions: zeroing the position table
    changes the result (the offset positions on later shards count)."""
    _, _, cfg, tp = small
    rng = np.random.default_rng(3)
    ids = rng.integers(5, cfg.vocab_size, (4, 32)).astype(np.int32)
    mask = np.ones((4, 32), np.int32)
    got = _port_cp(cfg, tp, ids, mask, 1, 8)
    single = bert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, single, atol=ATOL, rtol=RTOL)
    tp2 = dict(tp, embeddings=dict(
        tp["embeddings"], position=torch.zeros_like(
            tp["embeddings"]["position"])))
    assert not np.allclose(got, _port_cp(cfg, tp2, ids, mask, 1, 8))


def test_cp_forward_rotary_gated(jax_devices, jax_forwards):
    """RoPE (half-split) + SwiGLU: q and k rotated at each shard's global
    positions before the gather."""
    jcfg, jp, cfg, tp = _models(ROTARY)
    assert "position" not in tp["embeddings"]
    ids, mask = _batch(cfg.vocab_size, np.random.default_rng(5), B=4)
    ref = _jax_cp(jcfg, jp, ids, mask, 2, 4, jax_devices, jax_forwards)
    got = _port_cp(cfg, tp, ids, mask, 2, 4)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("change,match", [
    (dict(relative_attention_num_buckets=16), "relative bias"),
    (dict(position_embedding_type="alibi"), "ALiBi"),
    (dict(norm_style="pre"), "post-LN bidirectional"),
    (dict(causal=True), "post-LN bidirectional")])
def test_cp_refusals_match_jax(change, match):
    kw = dict(SMALL, **change)
    cpu_mesh = make_mesh_cp(2, 4, [CPU] * 8)
    with pytest.raises(ValueError, match=match) as port_err:
        make_cp_forward(BertConfig(**kw), cpu_mesh)
    with pytest.raises(ValueError) as jax_err:
        jctx.make_cp_forward(JConfig(**kw), jctx.make_mesh_cp(
            dp=2, sp=4, devices=jax.devices()[:8]))
    assert str(port_err.value) == str(jax_err.value)


def test_cp_refuses_what_the_port_does_not_map():
    """Mixture-of-experts layers stay refused (the JAX package's CP layer
    has no router branch, so it cannot run them either); shared layers
    and factorized embeddings (ALBERT), once refused here, run
    (``test_cp_forward_albert_matches_jax``)."""
    cfg = BertConfig(**dict(SMALL, num_experts=4, moe_every_n_layers=2))
    with pytest.raises(NotImplementedError, match="num_experts"):
        make_cp_forward(cfg, make_mesh_cp(2, 4, [CPU] * 8))
    albert = BertConfig(**ALBERT)
    make_cp_forward(albert, make_mesh_cp(2, 4, [CPU] * 8))


@pytest.mark.parametrize("dp,sp,pooling", [(2, 4, "mean"), (1, 8, "cls")])
def test_cp_forward_albert_matches_jax(jax_devices, jax_kernels, port_calls,
                                       dp, sp, pooling):
    """ALBERT (E=128, tables 32 wide and their projection, one shared
    layer applied 3 times): the port's CP forward against JAX's, both on
    the CP kernel route (K8a on every application of the layer, on every
    shard; JAX's in interpret mode), and against the single-device
    forward."""
    jcfg, jp, cfg, tp = _models(dict(ALBERT, pooling=pooling))
    assert tp["layers"]["mlp"]["up"]["w"].shape[0] == 1
    assert tp["embeddings"]["proj"]["w"].shape == (32, 128)
    ids, mask = _batch(cfg.vocab_size, np.random.default_rng(6), L=64)
    fwd = jctx.make_cp_forward(jcfg, jctx.make_mesh_cp(
        dp=dp, sp=sp, devices=jax_devices[:dp * sp]))
    ref = np.asarray(fwd(jp, jnp.asarray(ids), jnp.asarray(mask)))
    got = _port_cp(cfg, tp, ids, mask, dp, sp)
    assert set(jax_kernels) == {"cp"}
    assert port_calls == ["cp"] * (cfg.num_hidden_layers * dp * sp)
    assert got.shape == (8, 128) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    single = bert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, single, atol=ATOL, rtol=RTOL)


def test_mesh_rules(monkeypatch):
    mesh = make_mesh_cp(2, 2, ["cpu"] * 4)
    assert isinstance(mesh, Mesh)
    assert dict(mesh.shape) == {DATA_AXIS: 2, SEQ_AXIS: 2}
    assert list(mesh.shape) == [DATA_AXIS, SEQ_AXIS]
    assert MODEL_AXIS == "model" and SEQ_AXIS == jctx.SEQ_AXIS
    assert mesh.distinct_devices() == [CPU]
    assert make_mesh_cp(sp=2, devices=[CPU] * 6).shape[DATA_AXIS] == 3
    with pytest.raises(ValueError, match="device count"):
        make_mesh_cp(2, 3, [CPU] * 4)
    tree = {"w": torch.ones(2)}
    reps = mesh.replicate(tree)
    assert list(reps) == [CPU] and reps[CPU]["w"] is tree["w"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_cp(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_cp(1, 1, [torch.device("cuda")])


def test_cp_forward_shape_rules(small):
    _, _, cfg, tp = small
    fwd = make_cp_forward(cfg, make_mesh_cp(2, 4, [CPU] * 8))
    ids, mask = _batch(cfg.vocab_size, np.random.default_rng(0), B=5)
    with pytest.raises(ValueError, match="divide"):
        fwd(tp, ids, mask)
    with pytest.raises(ValueError, match="unknown pooling"):
        make_cp_forward(cfg, make_mesh_cp(2, 4, [CPU] * 8),
                        pooling="lasttoken")


# ---------------------------------------------------------------------------
# the Engine on a CP mesh
# ---------------------------------------------------------------------------

TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog", "a",
         "this is a test sentence"] * 2


@pytest.fixture(scope="module")
def engines(small_vocab):
    """A port Engine on a 2 x 4 CPU mesh and the single-device one, on
    the same weights (JAX's test_engine_with_cp_mesh shapes)."""
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab))
    cfg = BertConfig(**dict(SMALL, vocab_size=len(small_vocab)))
    tp = P.from_jax_params(JP.init_params(
        JConfig(**dict(SMALL, vocab_size=len(small_vocab))), rng=0))
    ec = EngineConfig(seq_buckets=(16, 32), max_seq_len=32, batch_size=8,
                      batch_buckets=(2, 4, 8))
    cp = Engine(tp, cfg, tok, ec, device="cpu",
                mesh=make_mesh_cp(2, 4, [CPU] * 8))
    single = Engine(tp, cfg, tok, ec, device="cpu")
    return cp, single


def test_engine_with_cp_mesh(engines):
    cp, single = engines
    assert cp.device == CPU and cp.mesh is not None
    assert "qkv" not in cp.params["layers"]["attn"]        # kept as given
    assert "qkv" in single.params["layers"]["attn"]
    assert cp.engine_config.batch_buckets == (2, 4, 8)
    np.testing.assert_allclose(cp.encode_batch(TEXTS),
                               single.encode_batch(TEXTS), atol=ATOL,
                               rtol=RTOL)
    # an odd batch rounds up to the data-axis size
    np.testing.assert_allclose(cp.encode(TEXTS[:3]),
                               single.encode(TEXTS[:3]), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="data-axis"):
        cp.forward(np.zeros((3, 16), np.int32), np.ones((3, 16), np.int32))


def test_engine_cp_mesh_rounds_buckets(small, small_vocab):
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab))
    _, _, cfg, tp = small
    cfg = dataclasses.replace(cfg, vocab_size=len(small_vocab))
    tp = dict(tp, embeddings=dict(tp["embeddings"], word=tp["embeddings"][
        "word"][:len(small_vocab)]))
    ec = EngineConfig(seq_buckets=(8, 12, 16, 32), max_seq_len=32,
                      batch_size=6, batch_buckets=(1, 2, 3, 4, 6))
    eng = Engine(tp, cfg, tok, ec, device="cpu",
                 mesh=make_mesh_cp(4, 2, [CPU] * 8))
    assert eng.engine_config.batch_size == 8
    assert eng.engine_config.batch_buckets == (4,)
    assert eng.engine_config.seq_buckets == (8, 12, 16, 32)
    eng2 = Engine(tp, cfg, tok, ec, device="cpu",
                  mesh=make_mesh_cp(1, 8, [CPU] * 8))
    assert eng2.engine_config.seq_buckets == (8, 16, 32)
    assert ec.batch_size == 6                    # the caller's is untouched


def test_engine_cp_packed_falls_back_to_bucketed(engines, caplog):
    cp, _ = engines
    with caplog.at_level(logging.WARNING):
        packed = cp.encode_batch_packed(TEXTS)
    assert "falling back to bucketed" in caplog.text
    np.testing.assert_array_equal(packed, cp.encode_batch(TEXTS))


def test_load_model_with_cp_mesh():
    """load_model(mesh=) on the trained fixture (E=128, D=32: K8a's plain
    version on every shard) meets the single-device load at JAX's CP
    bound."""
    from pathlib import Path
    from embeddings_tpu_torch import load_model
    path = (Path(__file__).resolve().parent.parent / "benchmarks"
            / "fixtures" / "tiny_trained" / "model")
    mesh = make_mesh_cp(2, 2, [CPU] * 4)
    cp = load_model(path, dtype="q4_0", mesh=mesh)
    single = load_model(path, dtype="q4_0", device="cpu")
    assert cp.mesh is mesh and cp.device == CPU
    np.testing.assert_allclose(cp.encode_batch(TEXTS),
                               single.encode_batch(TEXTS), atol=ATOL,
                               rtol=RTOL)
