"""The port's chained int8 forward against the JAX package, on the CPU.

(a) ``encode_tokens`` under each of the 8 link subsets of {attn, ln, ffn}
    with int8 scores off, and all links with them on, in bf16 compute,
    through the kernels' plain versions, against JAX's chained forward
    through its Pallas kernels in interpret mode (``pallas_mode
    ("always")``, ``interpret_mode()``, ``int8_mode(True)``, the same
    ``chain_links`` and ``int8_scores_mode``): min cosine >= 0.9999 (bf16
    rounding flips compound over the layers, as in the unchained bf16
    test). The wrapped plain versions record, per subset, which matmuls
    read int8 x and which emitted, and what the attention emitted, so a
    link that silently did nothing fails.
(b) f32 compute: JAX's layer scan needs its carry to keep its dtype, and
    a chained matmul writes bf16 (the JAX package's rule for an int8 x),
    so JAX runs no chained f32 forward; one layer runs in both. Each
    subset's ``encoder_layer`` on the same f32 input against JAX's
    ``encoder_layer(chain=True)``: cosine >= 0.9999 per row, and the "ln"
    link's carried int8 rows equal or one step off.
(c) ``encode_packed`` with every link: K4's plain version emits "only".
(d) ``_int8_chain_ok`` against JAX's gate on six trees; the switches
    (validation, scoped restore, defaults, "auto" following int8).
"""

import contextlib
import functools
import importlib
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JaxConfig
from embeddings_tpu.models import bert as jbert
from embeddings_tpu.models import params as JP
from embeddings_tpu.runtime import packing as jpacking

from embeddings_tpu_torch.config import BertConfig
from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.ops import linear as tlin
from embeddings_tpu_torch.ops import qmatmul as tqmm

from tests.test_torch_model import SMALL, small_q4  # noqa: F401 (fixture)

jlin = importlib.import_module("embeddings_tpu.ops.linear")
jattn = importlib.import_module("embeddings_tpu.ops.attention")

SUBSETS = [tuple(c) for n in range(4)
           for c in itertools.combinations(("attn", "ffn", "ln"), n)]
IDS = ["+".join(s) or "none" for s in SUBSETS]


@contextlib.contextmanager
def _jax_chain(links, scores=False):
    """JAX through its kernels in interpret mode, int8, with the links."""
    names = ("fused_attention", "fused_attention_segmented")
    orig = {n: getattr(jattn, n) for n in names}
    for n in names:
        setattr(jattn, n, functools.partial(orig[n], interpret=True))
    try:
        with jlin.pallas_mode("always"), jlin.interpret_mode(), \
                jlin.int8_mode(True), jlin.chain_links(links), \
                jattn.int8_scores_mode("on" if scores else "off"):
            yield
    finally:
        for n in names:
            setattr(jattn, n, orig[n])


@contextlib.contextmanager
def _recording(monkeypatch):
    """Record each plain-version call: ("mm", int8 x, emit, epilogue) for
    K3, ("attn", emit, int8 scores) for K2 and K4."""
    calls = []
    mm, fa, seg = (tqmm.qmatmul_int8_ref, tattn.fused_attention_ref,
                   tattn.fused_attention_segmented_ref)

    def rec_mm(x, *a, **k):
        calls.append(("mm", x.dtype == torch.int8,
                      k.get("emit_quantized", "no"), k.get("epilogue")))
        return mm(x, *a, **k)

    def rec_fa(*a, **k):
        calls.append(("attn", k.get("emit_quantized", "no"),
                      k.get("int8_scores", False)))
        return fa(*a, **k)

    def rec_seg(*a, **k):
        calls.append(("attn", k.get("emit_quantized", "no"), False))
        return seg(*a, **k)
    monkeypatch.setattr(tqmm, "qmatmul_int8_ref", rec_mm)
    monkeypatch.setattr(tattn, "fused_attention_ref", rec_fa)
    monkeypatch.setattr(tattn, "fused_attention_segmented_ref", rec_seg)
    yield calls


def expected_calls(links, scores, n_layers):
    """The plain-version calls of one chained forward, layer by layer:
    qkv reads int8 x with "ln"; the attention emits "only" with "attn";
    o-proj reads int8 x with "attn" and emits "both" with "ln"; up reads
    int8 x with "ln" and emits "only" with "ffn"; down reads int8 x with
    "ffn" and emits "both" with "ln"."""
    ln, attn, ffn = ("ln" in links), ("attn" in links), ("ffn" in links)
    both = "both" if ln else "no"
    layer = [("mm", ln, "no", "bias"),
             ("attn", "only" if attn else "no", scores),
             ("mm", attn, both, "bias_residual_ln"),
             ("mm", ln, "only" if ffn else "no", "bias_gelu"),
             ("mm", ffn, both, "bias_residual_ln")]
    return layer * n_layers


def _batch(seed=5, B=3, L=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 256, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 10:] = 0
    mask[2, 1:] = 0
    return ids, mask


@pytest.mark.parametrize("links,scores",
                         [(s, False) for s in SUBSETS]
                         + [(("attn", "ffn", "ln"), True)],
                         ids=IDS + ["attn+ffn+ln-scores_on"])
def test_encode_tokens_chain_matches_jax_bf16(small_q4, monkeypatch, links,
                                              scores):
    jcfg, jp, cfg, tp = small_q4
    ids, mask = _batch()
    with _jax_chain(links, scores):
        ref = np.asarray(jbert.encode_tokens(
            jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
            compute_dtype="bfloat16"))
    before = tlin.quantize_act.calls
    with _recording(monkeypatch) as calls, tlin.chain_links(links), \
            tattn.int8_scores_mode("on" if scores else "off"):
        got = tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                                  torch.from_numpy(mask), int8=True,
                                  compute_dtype=torch.bfloat16).numpy()
    assert calls == expected_calls(links, scores, cfg.num_hidden_layers)
    # the "ln" link quantizes the embedding output once, nothing else does
    assert tlin.quantize_act.calls - before == int("ln" in links)
    assert got.shape == (3, 128) and np.isfinite(got).all()
    assert (got * ref).sum(-1).min() >= 0.9999


def _layer_inputs(seed=11, B=3, L=32, E=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, E), dtype=np.float32)
    _, mask = _batch()
    lengths = mask.sum(1).astype(np.int32)
    mask_bias = ((1.0 - mask) * -1e9).astype(np.float32)[:, None, None, :]
    return x, lengths, mask_bias


@pytest.mark.parametrize("links", SUBSETS, ids=IDS)
def test_encoder_layer_chain_matches_jax_f32(small_q4, links):
    jcfg, jp, cfg, tp = small_q4
    x, lengths, mask_bias = _layer_inputs()
    jlayer = jax.tree_util.tree_map(lambda t: t[0], jp["layers"])
    with _jax_chain(links):
        jxq = jlin.quantize_act(jnp.asarray(x)) if "ln" in links else None
        ref = jbert.encoder_layer(jlayer, jcfg, jnp.asarray(x),
                                  jnp.asarray(mask_bias),
                                  jnp.asarray(lengths), xq=jxq, chain=True)
    tx = torch.from_numpy(x)
    txq = tlin.quantize_act(tx) if "ln" in links else None
    got = tbert.encoder_layer(P.layer(tp, 0), cfg, tx,
                              torch.from_numpy(mask_bias),
                              torch.from_numpy(lengths), xq=txq,
                              links=frozenset(links), int8=True)
    if "ln" in links:
        (got, gq), (ref, rq) = got, ref
        d = np.abs(gq.q.numpy().astype(np.int32)
                   - np.asarray(rq.q).astype(np.int32))
        assert d.max() <= 1 and (d == 1).mean() <= 0.01
        np.testing.assert_allclose(gq.s.numpy(), np.asarray(rq.s),
                                   rtol=1e-5)
    g = got.float().numpy().reshape(-1, x.shape[-1])
    r = np.asarray(ref, np.float32).reshape(-1, x.shape[-1])
    # a chained matmul writes bf16, as JAX's does for an int8 x
    assert got.dtype == (torch.bfloat16 if links else torch.float32)
    assert ref.dtype == (jnp.bfloat16 if links else jnp.float32)
    cos = (g * r).sum(-1) / (np.linalg.norm(g, axis=-1)
                             * np.linalg.norm(r, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


def test_encode_packed_chain_matches_jax(small_q4, monkeypatch):
    """All links on packed rows (row_len 16: K4 emits "only")."""
    jcfg, jp, cfg, tp = small_q4
    rng = np.random.default_rng(3)
    toks = [list(rng.integers(5, 256, int(k)))
            for k in rng.integers(4, 17, 24)]
    b = jpacking.plan_packing([len(t) for t in toks], 16, 8, max_segs=2)[0]
    ids, seg, pos, pool, mapping = jpacking.materialize(b, toks, 0, "cls")
    links = ("attn", "ffn", "ln")
    with _jax_chain(links):
        ref = np.asarray(jbert.encode_packed(
            jp, jcfg, *(jnp.asarray(a) for a in (ids, seg, pos, pool)),
            compute_dtype="bfloat16"))
    with _recording(monkeypatch) as calls, tlin.chain_links(links):
        got = tbert.encode_packed(
            tp, cfg, *(torch.from_numpy(a) for a in (ids, seg, pos, pool)),
            int8=True, compute_dtype=torch.bfloat16).numpy()
    assert calls == expected_calls(links, False, cfg.num_hidden_layers)
    assert min(float((got[r, s] * ref[r, s]).sum())
               for r, s, _ in mapping) >= 0.9999


def _gate_trees():
    """(name, JAX config kwargs, tree transform) for the gate test."""
    def q4_fused(jp):
        return JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(jp, "q4_0")))
    return [
        ("post_ln", {}, q4_fused),
        ("pre_norm", dict(norm_style="pre"), q4_fused),
        ("gated_mlp", dict(gated_mlp=True, hidden_act="silu"), q4_fused),
        ("gqa", dict(num_key_value_heads=1), q4_fused),
        ("dense", {}, JP.fuse_qkv),
        ("not_fused", {},
         lambda jp: JP.pack_q4_params(JP.quantize_params(jp, "q4_0"))),
    ]


@pytest.mark.parametrize("name,kw,make", _gate_trees(),
                         ids=[t[0] for t in _gate_trees()])
def test_int8_chain_ok_matches_jax_gate(name, kw, make):
    jcfg = JaxConfig(**{**SMALL, **kw})
    jp = make(JP.init_params(jcfg, 0))
    cfg = BertConfig(**{**SMALL, **kw})
    tp = P.from_jax_params(jp)
    with jlin.int8_mode(True), jlin.interpret_mode():
        want = jbert._int8_chain_ok(jp, jcfg, None)
    assert want == (name == "post_ln")
    assert tbert._int8_chain_ok(tp, cfg, use_kernels=True, int8=True) \
        == want
    # the gate also needs the int8 mode and the kernels, as JAX's does
    assert not tbert._int8_chain_ok(tp, cfg, use_kernels=True, int8=False)
    assert not tbert._int8_chain_ok(tp, cfg, use_kernels=False, int8=True)


def test_chain_switches():
    assert tlin.active_chain_links() == frozenset()   # JAX's default
    assert tattn._INT8_SCORES == jattn._INT8_SCORES == "off"
    with pytest.raises(ValueError):
        tlin.set_chain_links({"attn", "bogus"})
    with pytest.raises(RuntimeError):
        with tlin.chain_links({"attn", "ln"}):
            assert tlin.chain_link_on("ln") and not tlin.chain_link_on("ffn")
            raise RuntimeError("scoped")
    assert tlin.active_chain_links() == frozenset()   # restored
    with pytest.raises(ValueError):
        tattn.set_int8_scores_mode("sometimes")
    for mode, want in (("on", (True, True)), ("off", (False, False)),
                       ("auto", (True, False))):
        with tattn.int8_scores_mode(mode), jattn.int8_scores_mode(mode):
            assert (tattn.use_int8_scores(True),
                    tattn.use_int8_scores(False)) == want
            with jlin.int8_mode(True):
                assert jattn.use_int8_scores() == want[0]
            with jlin.int8_mode(False):
                assert jattn.use_int8_scores() == want[1]
    assert tattn._INT8_SCORES == "off"


def test_default_forward_is_unchained(small_q4, monkeypatch):
    """No links and scores "off" by default: the int8 forward runs what it
    ran before the chain existed (every matmul quantizes its own rows)."""
    jcfg, jp, cfg, tp = small_q4
    ids, mask = _batch(6)
    with _recording(monkeypatch) as calls:
        tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                            torch.from_numpy(mask), int8=True)
    assert calls == expected_calls((), False, cfg.num_hidden_layers)
