"""The logit-bias families of the port (MPNet, jina-bert-v2) against the
JAX package, on the CPU.

(a) MPNet's relative-position bucket table equals JAX's to the integer
    for every distance in [-L, L]; the ALiBi slopes equal JAX's exactly.
(b) ``encode_tokens`` for tiny MPNet and jina configs (q4_0 packed + fused
    qkv, and dense f32) through the kernels' plain versions against JAX
    through its Pallas kernels in interpret mode: MPNet and short jina
    rows take K7, jina rows past K7's cap take K6 with in-kernel ALiBi
    (the cap is lowered in both packages to reach that route at a CPU
    size), and a plain BERT whose rows do not fit whole takes K6 plain
    (``whole_row_fits`` patched in the port, ``force_stream_mode`` in
    JAX); RoBERTa, DistilBERT, RoFormer and ALBERT (its one layer applied
    three times) take K2 on every layer application. f32: max abs 2e-4
    on unit vectors and cosine >= 0.9999 (the same arithmetic,
    summation-order noise); bf16 activations: cosine >= 0.999.
(c) ``encode_packed`` for both families against JAX's (both fold the bias
    into the einsum path's mask): cosine >= 0.9999 per segment.
(d) The route each package dispatches, spied at real widths (E=768) over
    boundary lengths, and ``attention_route_name`` over a grid of flags.
(e) The trained ``tiny_trained_alibi`` fixture and an HF-format MPNet
    directory load in both packages and encode the same vectors.
"""

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
from embeddings_tpu.ops.alibi import alibi_slopes as jax_slopes
from embeddings_tpu.runtime import packing as jpacking

from embeddings_tpu_torch.config import BertConfig, EngineConfig
from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.ops.alibi import alibi_slopes
from embeddings_tpu_torch.runtime.engine import load_model

jlin = importlib.import_module("embeddings_tpu.ops.linear")
jbert = importlib.import_module("embeddings_tpu.models.bert")

ROOT = Path(__file__).resolve().parent.parent
ALIBI_FIXTURE = ROOT / "benchmarks" / "fixtures" / "tiny_trained_alibi"
KERNELS = ("fused_attention", "fused_attention_bias",
           "fused_attention_stream")

TINY = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256, pooling="mean")
FAMILIES = {
    "mpnet": dict(TINY, max_position_embeddings=130, type_vocab_size=1,
                  position_offset=2, relative_attention_num_buckets=32),
    "jina": dict(TINY, max_position_embeddings=512,
                 position_embedding_type="alibi", gated_mlp=True),
    "bert": dict(TINY, max_position_embeddings=512, num_attention_heads=2),
    # the encoder families that run on K1 and K2 alone: RoBERTa's position
    # offset, DistilBERT's one token-type row, RoFormer's interleaved RoPE,
    # ALBERT's factorized embeddings and one shared layer
    "roberta": dict(TINY, max_position_embeddings=130, type_vocab_size=1,
                    position_offset=2),
    "distilbert": dict(TINY, max_position_embeddings=512, type_vocab_size=1),
    "roformer": dict(TINY, max_position_embeddings=512,
                     position_embedding_type="rotary",
                     rotary_interleaved=True),
    "albert": dict(TINY, max_position_embeddings=512, num_hidden_layers=3,
                   embedding_size=64, shared_layers=True,
                   hidden_act="gelu_tanh"),
}
ENCODERS = ["roberta", "distilbert", "roformer", "albert"]


# ---------------------------------------------------------------------------
# (a) bucket table and slopes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (32, 256),
                                                      (64, 128)])
def test_bucket_table_matches_jax(num_buckets, max_distance):
    L = 1200
    rel = np.arange(-L, L + 1)
    want = np.asarray(jbert._relative_position_bucket(
        jnp.asarray(rel), num_buckets, max_distance))
    got = tbert._relative_position_bucket(
        torch.from_numpy(rel), num_buckets, max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    # the distances whose exact value is an integer are in the table
    assert {16, 32, 64} <= set(abs(int(r)) for r in rel)


def test_alibi_slopes_match_jax():
    for n in range(1, 33):
        assert alibi_slopes(n) == jax_slopes(n), n
    cfg = BertConfig(**FAMILIES["jina"])
    jp = JP.init_params(JaxConfig(**FAMILIES["jina"]), 0)
    np.testing.assert_array_equal(
        P.init_params(cfg, 0)["alibi_slopes"].numpy(),
        np.asarray(jp["alibi_slopes"]))


# ---------------------------------------------------------------------------
# (b) encode_tokens against JAX's kernels in interpret mode
# ---------------------------------------------------------------------------

def _jax_params(family, kind):
    """JAX init with trained-scale weights (std 0.1) and a unit-scale
    relative-bias table, q4_0 packed or dense, q/k/v fused."""
    jcfg = JaxConfig(**FAMILIES[family])
    jp = JP.init_params(jcfg, 0)
    rng = np.random.default_rng(1)
    for group in ("attn", "mlp"):
        for name, lin in jp["layers"][group].items():
            if "w" in lin:
                lin["w"] = jnp.asarray(rng.standard_normal(
                    lin["w"].shape, dtype=np.float32) * 0.1)
    if "rel_bias" in jp:
        jp["rel_bias"] = jnp.asarray(rng.standard_normal(
            jp["rel_bias"].shape, dtype=np.float32))
    if kind == "q4_0":
        jp = JP.pack_q4_params(JP.quantize_params(jp, "q4_0"))
    return jcfg, JP.fuse_qkv(jp)


@functools.lru_cache(maxsize=None)
def _models(family, kind):
    jcfg, jp = _jax_params(family, kind)
    return jcfg, jp, BertConfig(**FAMILIES[family]), P.from_jax_params(jp)


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
    for name in KERNELS:
        monkeypatch.setattr(jattn, name, functools.partial(
            getattr(jattn, name), interpret=True))
    with jlin.pallas_mode("always"), jlin.interpret_mode():
        out = np.asarray(jbert.encode_tokens(jp, jcfg, jnp.asarray(ids),
                                             jnp.asarray(mask), **kw))
    monkeypatch.undo()
    return out


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
@pytest.mark.parametrize("family,L,route", [
    ("mpnet", 64, "fused_attention_bias"),
    ("jina", 64, "fused_attention_bias"),
    ("jina", 128, "fused_attention_stream"),
    ("bert", 256, "fused_attention_stream")]
    + [(family, 64, "fused_attention") for family in ENCODERS])
def test_encode_tokens_matches_jax_kernels_f32(monkeypatch, family, L, route,
                                               kind):
    jcfg, jp, cfg, tp = _models(family, kind)
    ids, mask = _batch(3, L, seed=L)
    with monkeypatch.context() as m:
        if family == "jina" and L == 128:
            # K7's cap lowered in both packages: the long-row ALiBi route
            m.setattr(jattn, "bias_supported", lambda *a: False)
            m.setattr(tattn, "bias_supported", lambda *a: False)
        if family == "bert":
            m.setattr(tattn, "whole_row_fits", lambda *a, **k: False)
            with jattn.force_stream_mode():
                ref = _jax_kernels(monkeypatch, jp, jcfg, ids, mask)
        else:
            ref = _jax_kernels(monkeypatch, jp, jcfg, ids, mask)
        calls = _spy_port(m)
        got = _port(tp, cfg, ids, mask)
    assert calls == [route] * cfg.num_hidden_layers
    assert got.shape == (3, 128) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2e-4
    assert (got * ref).sum(-1).min() >= 0.9999


@pytest.mark.parametrize("family", ["mpnet", "jina"] + ENCODERS)
def test_encode_tokens_matches_jax_kernels_bf16(monkeypatch, family):
    jcfg, jp, cfg, tp = _models(family, "q4_0")
    ids, mask = _batch(3, 64, seed=5)
    ref = _jax_kernels(monkeypatch, jp, jcfg, ids, mask,
                       compute_dtype="bfloat16")
    got = _port(tp, cfg, ids, mask, compute_dtype=torch.bfloat16)
    assert (got * ref).sum(-1).min() >= 0.999


@pytest.mark.parametrize("family", ["mpnet", "jina"] + ENCODERS)
def test_encode_tokens_plain_path_matches_jax_default(family):
    """The port's plain path (bias folded into the einsum mask) IS the
    JAX package's XLA fallback arithmetic."""
    jcfg, jp, cfg, tp = _models(family, "q4_0")
    ids, mask = _batch(3, 48, seed=6)
    ref = np.asarray(jbert.encode_tokens(jp, jcfg, jnp.asarray(ids),
                                         jnp.asarray(mask)))
    got = _port(tp, cfg, ids, mask, use_kernels=False)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# (c) encode_packed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["mpnet", "jina"])
def test_encode_packed_matches_jax(monkeypatch, family):
    jcfg, jp, cfg, tp = _models(family, "q4_0")
    rng = np.random.default_rng(9)
    toks = [list(rng.integers(5, 256, int(k)))
            for k in rng.integers(4, 40, 20)]
    b = jpacking.plan_packing([len(t) for t in toks], 64, 8, max_segs=8)[0]
    arrays = jpacking.materialize(b, toks, 0, "mean")
    mapping = arrays[4]
    with jlin.pallas_mode("always"), jlin.interpret_mode():
        ref = np.asarray(jbert.encode_packed(
            jp, jcfg, *(jnp.asarray(a) for a in arrays[:4])))
    calls = _spy_port(monkeypatch)
    got = tbert.encode_packed(tp, cfg, *(torch.from_numpy(np.asarray(a))
                                         for a in arrays[:4])).numpy()
    assert calls == []  # the segmented kernels have no bias operand
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert min(float((got[r, s] * ref[r, s]).sum())
               for r, s, _ in mapping) >= 0.9999
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


# ---------------------------------------------------------------------------
# (d) routes
# ---------------------------------------------------------------------------

WIDE = dict(vocab_size=64, hidden_size=768, num_hidden_layers=1,
            num_attention_heads=12, intermediate_size=64)
WIDE_FAMILIES = {
    "bert": dict(WIDE, max_position_embeddings=2048),
    "mpnet": dict(WIDE, max_position_embeddings=514, type_vocab_size=1,
                  position_offset=2, relative_attention_num_buckets=32),
    "jina": dict(WIDE, max_position_embeddings=8192,
                 position_embedding_type="alibi", gated_mlp=True),
}


def _spy_jax(monkeypatch):
    calls = []
    for name in KERNELS:
        monkeypatch.setattr(jattn, name, functools.partial(
            lambda qkv, *a, _n=name, **k: calls.append(
                (_n, k.get("alibi_slopes") is not None))
            or jnp.zeros((qkv.shape[0], qkv.shape[1] // 3), qkv.dtype)))
    return calls


@pytest.mark.parametrize("family,L", [
    ("bert", 256), ("bert", 1792), ("bert", 1920), ("bert", 1880),
    ("mpnet", 128), ("mpnet", 512), ("jina", 1024), ("jina", 1280),
    ("jina", 1408), ("jina", 2048), ("jina", 1400)])
def test_dispatch_matches_jax_at_real_width(monkeypatch, family, L):
    """Which kernel each package dispatches (stubbed: the spies return
    zeros) for one E=768 layer at boundary lengths: jina takes K7 up to
    1280 and K6 ALiBi from 1408, a plain BERT K2 up to 1792 and K6 from
    1920, other lengths the einsum path in both."""
    jcfg = JaxConfig(**WIDE_FAMILIES[family])
    cfg = BertConfig(**WIDE_FAMILIES[family])
    jp = JP.init_params(jcfg, 0)
    tp = P.from_jax_params(jp)
    ids = np.full((1, L), 7, np.int32)
    mask = np.ones((1, L), np.int32)
    want = _spy_jax(monkeypatch)
    with jlin.pallas_mode("always"):
        jbert.encode_tokens(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    calls = []
    for name in KERNELS:
        monkeypatch.setattr(tattn, name, functools.partial(
            lambda qkv, *a, _n=name, **k: calls.append(
                (_n, k.get("alibi_slopes") is not None))
            or torch.zeros(qkv.shape[0], qkv.shape[1] // 3)))
    _port(tp, cfg, ids, mask)
    assert calls == want, (family, L)
    expect = {("bert", 1920): "fused_attention_stream",
              ("jina", 1408): "fused_attention_stream",
              ("jina", 2048): "fused_attention_stream",
              ("bert", 1880): None, ("jina", 1400): None}.get(
        (family, L), "fused_attention_bias" if family != "bert"
        else "fused_attention")
    assert [c[0] for c in calls] == ([expect] if expect else [])


ROUTE_GRID = [(L, E, seg, w, bias, alibi)
              for L in (16, 128, 256, 512, 640, 1024, 1280, 1408, 1792,
                        1877, 1920, 2048, 4096, 8192)
              for E in (128, 384, 768, 1024)
              for seg, w in ((False, 0), (True, 0), (True, 3), (True, 6))
              for bias, alibi in ((False, False), (True, False),
                                  (False, True))]


@pytest.mark.parametrize("force", [False, True])
def test_route_names_match_jax(monkeypatch, force):
    """``attention_route_name`` over (L, E, packed, window, bias, ALiBi),
    and with the stream repair forced: ``whole_row_fits`` patched in the
    port, ``force_stream_mode`` in the JAX package."""
    if force:
        monkeypatch.setattr(tattn, "whole_row_fits", lambda *a, **k: False)
    for L, E, seg, w, bias, alibi in ROUTE_GRID:
        with jattn.force_stream_mode(force):
            want = jbert.attention_route_name(L, E // 64, 64, E, seg, w,
                                              bias, False, alibi, False)
        got = tbert.attention_route_name(L, E, segmented=seg, attn_window=w,
                                         bias=bias, alibi=alibi)
        assert got == want, (L, E, seg, w, bias, alibi)
    assert tbert.attention_route_name(1920, 768) == "stream"
    assert tbert.attention_route_name(1792, 768) == \
        ("stream" if force else "whole_row")


def test_kernels_ok_matches_jax():
    """``fused_attention_ok`` against JAX's ``_attn_kernels_ok`` at the
    head dims the port's kernels are built for."""
    for L in (16, 24, 128, 256, 512, 520, 1024, 1408, 1792, 1880, 1920,
              4096, 8192):
        for H, D in ((2, 64), (4, 32), (12, 64), (1, 128), (3, 32)):
            for seg in (None, "s"):
                for alibi in (None, (0.5,) * H):
                    want = jbert._attn_kernels_ok(L, H, D, seg, None, alibi)
                    got = tbert.fused_attention_ok(
                        L, H, D, True, None if seg else "lengths", seg,
                        alibi)
                    assert got == want, (L, H, D, seg, alibi)


# ---------------------------------------------------------------------------
# (e) checkpoints through both packages' load_model
# ---------------------------------------------------------------------------

def _long_texts(n):
    rows = (ALIBI_FIXTURE / "sts-test-long.tsv").read_text().splitlines()
    return [r.split("\t")[1] for r in rows[:n]]


@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_trained_alibi_fixture_matches_jax(monkeypatch, dtype):
    from embeddings_tpu.runtime.engine import load_model as jax_load
    texts = _long_texts(4)
    je = jax_load(ALIBI_FIXTURE / "model", dtype=dtype)
    te = load_model(ALIBI_FIXTURE / "model", dtype=dtype, device="cpu")
    assert te.config.position_embedding_type == "alibi"
    assert te.config.gated_mlp and te.config.pooling == je.config.pooling
    assert "position" not in te.params["embeddings"]
    for t in texts:
        assert te.tokenize(t) == je.tokenize(t)
        assert len(te.tokenize(t)) > 512  # long rows: the L=1024 bucket
    ref = je.encode_batch(texts)
    calls = _spy_port(monkeypatch)
    got = te.encode_batch(texts)
    assert set(calls) == {"fused_attention_bias"}
    if dtype == "f32":
        # exp2/clamp kernel math vs the softmax einsum: f32 noise
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        # K6's ALiBi route on the same trained weights
        monkeypatch.setattr(tattn, "bias_supported", lambda *a: False)
        calls.clear()
        got6 = te.encode_batch(texts)
        assert set(calls) == {"fused_attention_stream"}
        np.testing.assert_allclose(got6, ref, rtol=0, atol=2e-5)
    else:
        # bf16 operands + tanh GELU (port) vs f32 + erf (JAX fallback)
        assert (got * ref).sum(-1).min() >= 0.999
        plain = load_model(ALIBI_FIXTURE / "model", dtype=dtype,
                           device="cpu", engine_config=EngineConfig(
                               use_pallas="never", max_seq_len=2048))
        np.testing.assert_allclose(plain.encode_batch(texts), ref, rtol=0,
                                   atol=2e-5)


def test_hf_mpnet_dir_matches_jax(tmp_path):
    """An HF-format MPNet directory (mpnet.* names, <s>/</s> WordPiece
    specials, 1_Pooling) through both packages' load_model."""
    from transformers import MPNetConfig, MPNetModel
    from embeddings_tpu.runtime.engine import load_model as jax_load
    hf_cfg = MPNetConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=256,
                         max_position_embeddings=130,
                         relative_attention_num_buckets=32, pad_token_id=1,
                         bos_token_id=0, eos_token_id=2)
    torch.manual_seed(0)
    model = MPNetModel(hf_cfg).eval()
    d = tmp_path / "mpnet"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(
        {**hf_cfg.to_dict(), "model_type": "mpnet"}))
    torch.save({"mpnet." + k: v for k, v in model.state_dict().items()},
               d / "pytorch_model.bin")
    tokens = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
    tokens += list("abcdefghijklmnopqrstuvwxyz")
    tokens += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    tokens += ["hello", "world", "##ing"]
    (d / "vocab.txt").write_text("\n".join(tokens) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": True, "cls_token": "<s>", "sep_token": "</s>",
         "unk_token": "<unk>", "pad_token": "<pad>", "mask_token": "<mask>"}))
    (d / "1_Pooling").mkdir()
    (d / "1_Pooling" / "config.json").write_text(json.dumps(
        {"pooling_mode_mean_tokens": True}))
    je = jax_load(d)
    te = load_model(d, device="cpu")
    assert te.config.relative_attention_num_buckets == 32
    assert te.config.position_offset == 2 and te.max_seq_len == 128
    assert te.tokenizer.cls_id == 0 and te.tokenizer.sep_id == 2
    assert te.config.pooling == "mean"
    np.testing.assert_array_equal(te.params["rel_bias"].numpy(),
                                  np.asarray(je.params["rel_bias"]))
    texts = ["hello world", "walking", "hello world", "a b c " * 30]
    for t in texts:
        assert te.tokenize(t) == je.tokenize(t)
    ref = je.encode_batch(texts)
    got = te.encode_batch(texts)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got[0], got[2])
    # and the HF model itself, mean-pooled
    toks = te.tokenize("hello world")
    with torch.no_grad():
        h = model(input_ids=torch.tensor([toks])).last_hidden_state[0]
    want = h.mean(0).numpy()
    assert float((got[0] * want).sum() / np.linalg.norm(want)) > 0.9999
