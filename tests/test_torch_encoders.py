"""DistilBERT, RoBERTa, RoFormer and ALBERT in the port against the JAX
package, on the CPU, from HF models built with ``transformers`` at the
shapes of ``tests/test_distilbert.py``, ``test_roberta.py``,
``test_rotary.py`` (RoFormer, interleaved RoPE; also with a factorized
embedding, ``embeddings_project``) and ``test_albert.py``.

(a) ``from_hf_state_dict`` maps each state dict, bare and under its
    backbone prefix, to the JAX package's tree leaf for leaf; the port's
    ``_strip_prefix`` returns JAX's dict key for key (a classifier head
    carried across).
(b) ``encode_tokens`` in f32 (dense weights): the port's plain path and
    its kernel path (the kernels' plain versions on the CPU) against
    JAX's default path and its Pallas path in interpret mode, max abs
    <= 1e-5, pooled and hidden; and against the HF model itself (JAX's
    own tests' 2e-4 / 1e-3).
(c) q4_0 packed with fused qkv: the port's kernel path against JAX's
    Pallas path in interpret mode, max abs <= 2e-3 (the documented q4_0
    tolerance); its plain path against JAX's default path, 1e-5.
(d) ALBERT: its one layer is applied num_hidden_layers times (1 layer
    against 4 differ, in both packages alike); the native ``.npz`` round
    trip keeps ``proj`` and the one-deep stack, across the packages.
(e) RoBERTa token-packed (positions restart at the offset per segment)
    against JAX's ``encode_packed``, each segment against its own
    bucketed row.
(f) Each family's HF directory loads through the port's ``load_model``
    and encodes as JAX's does (RoBERTa with byte-level BPE, ALBERT with
    its Unigram tokenizer.json).
"""

import dataclasses
import functools
import importlib
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

transformers = pytest.importorskip("transformers")

from embeddings_tpu.config import BertConfig as JaxConfig
from embeddings_tpu.models import params as JP
from embeddings_tpu.ops import attention as jattn
from embeddings_tpu.runtime import packing as jpacking

from embeddings_tpu_torch.config import BertConfig
from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.runtime.engine import load_model

from tests.test_torch_faults import assert_same_tree

jlin = importlib.import_module("embeddings_tpu.ops.linear")
jbert = importlib.import_module("embeddings_tpu.models.bert")

FAMILIES = ("distilbert", "roberta", "roformer", "roformer_proj", "albert")
PREFIX = {"distilbert": "distilbert.", "roberta": "roberta.",
          "roformer": "roformer.", "roformer_proj": "roformer.",
          "albert": "albert."}


def _hf_model(family):
    """(HF model, its config dict) at the JAX tests' shapes, seed 0."""
    t = transformers
    common = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    if family == "distilbert":
        cfg = t.DistilBertConfig(vocab_size=256, dim=64, n_layers=3,
                                 n_heads=4, hidden_dim=128,
                                 max_position_embeddings=64, dropout=0.0,
                                 attention_dropout=0.0)
        cls = t.DistilBertModel
    elif family == "roberta":
        cfg = t.RobertaConfig(vocab_size=262, hidden_size=64,
                              num_hidden_layers=3, num_attention_heads=4,
                              intermediate_size=128,
                              max_position_embeddings=66, type_vocab_size=1,
                              pad_token_id=1, bos_token_id=0, eos_token_id=2,
                              **common)
        cls = t.RobertaModel
    elif family.startswith("roformer"):
        cfg = t.RoFormerConfig(
            vocab_size=256,
            embedding_size=32 if family == "roformer_proj" else 64,
            hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, max_position_embeddings=64,
            hidden_act="gelu", **common)
        cls = t.RoFormerModel
    else:
        cfg = t.AlbertConfig(vocab_size=220, embedding_size=32,
                             hidden_size=64, num_hidden_layers=4,
                             num_attention_heads=4, intermediate_size=128,
                             max_position_embeddings=64, type_vocab_size=2,
                             classifier_dropout_prob=0.0, **common)
        cls = t.AlbertModel
    torch.manual_seed(0)
    return cls(cfg).eval(), cfg.to_dict()


@functools.lru_cache(maxsize=None)
def _family(family):
    """(HF model, HF state dict as numpy, JAX config, port config)."""
    model, d = _hf_model(family)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return (model, sd, JaxConfig.from_hf_dict(d), BertConfig.from_hf_dict(d))


@functools.lru_cache(maxsize=None)
def _trees(family):
    """The f32 trees from the same state dict: (JAX's, the port's)."""
    _, sd, jcfg, cfg = _family(family)
    return JP.from_hf_state_dict(sd, jcfg), P.from_hf_state_dict(sd, cfg)


@functools.lru_cache(maxsize=None)
def _q4_trees(family):
    """q4_0 packed + fused qkv: JAX's tree and the port's copy of it, and
    the port's own quantization of its f32 tree."""
    jp, tp = _trees(family)
    jq = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(jp, "q4_0")))
    own = P.fuse_qkv(P.pack_q4_params(P.quantize_params(tp, "q4_0")))
    return jq, P.from_jax_params(jq), own


def _batch(family, B=3, L=24, seed=0):
    vocab = _family(family)[3].vocab_size
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 16:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 1 if family == "roberta" else 0
    return ids, mask


def _jax(jp, jcfg, ids, mask, kernels=False, **kw):
    """JAX's forward: its default (XLA) path, or its Pallas path with
    every kernel in interpret mode."""
    if not kernels:
        return np.asarray(jbert.encode_tokens(
            jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), **kw))
    orig = jattn.fused_attention
    jattn.fused_attention = functools.partial(orig, interpret=True)
    try:
        with jlin.pallas_mode("always"), jlin.interpret_mode():
            return np.asarray(jbert.encode_tokens(
                jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), **kw))
    finally:
        jattn.fused_attention = orig


def _port(tp, cfg, ids, mask, **kw):
    return tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                               torch.from_numpy(mask), **kw).numpy()


# ---------------------------------------------------------------------------
# (a) the mappings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefixed", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_hf_state_dict_maps_to_jax_tree(family, prefixed):
    _, sd, jcfg, cfg = _family(family)
    if prefixed:
        sd = {PREFIX[family] + k: v for k, v in sd.items()}
    tree = P.from_hf_state_dict(sd, cfg)
    assert_same_tree(tree, JP.from_hf_state_dict(sd, jcfg))
    NL = 1 if family == "albert" else cfg.num_hidden_layers
    assert tree["layers"]["attn"]["q"]["w"].shape[0] == NL
    assert ("proj" in tree["embeddings"]) == (
        family in ("albert", "roformer_proj"))
    assert ("position" in tree["embeddings"]) == (
        not family.startswith("roformer"))


@pytest.mark.parametrize("family", FAMILIES)
def test_strip_prefix_matches_jax(family):
    """The port's ``_strip_prefix`` returns JAX's dict key for key, with a
    cross-encoder's classifier head (outside the backbone prefix) carried
    across."""
    _, sd, _, _ = _family(family)
    rng = np.random.default_rng(1)
    sd = {**{PREFIX[family] + k: v for k, v in sd.items()},
          "classifier.weight": rng.standard_normal((2, 64)),
          "classifier.bias": np.zeros(2)}
    got = P._strip_prefix(dict(sd))
    want = JP._strip_prefix(dict(sd))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert "classifier.weight" in got


# ---------------------------------------------------------------------------
# (b) f32 and (c) q4_0 encode_tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_encode_tokens_f32_matches_jax(family):
    model, _, jcfg, cfg = _family(family)
    jp, tp = _trees(family)
    ids, mask = _batch(family)
    ref = _jax(jp, jcfg, ids, mask)
    assert np.abs(_jax(jp, jcfg, ids, mask, kernels=True) - ref).max() \
        <= 1e-5
    for use_kernels in (False, True):
        got = _port(tp, cfg, ids, mask, use_kernels=use_kernels)
        assert got.shape == (3, 64) and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-5, use_kernels
    hidden = _port(tp, cfg, ids, mask, return_hidden=True)
    jhidden = _jax(jp, jcfg, ids, mask, return_hidden=True)
    m = mask.astype(bool)
    assert np.abs(hidden[m] - jhidden[m]).max() <= 1e-5
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask).long()
                     ).last_hidden_state.numpy()
    np.testing.assert_allclose(hidden[m], want[m], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_encode_tokens_q4_0_matches_jax(family):
    _, _, jcfg, cfg = _family(family)
    jq, tq, own = _q4_trees(family)
    assert_same_tree(own, JP.fuse_qkv(JP.pack_q4_params(
        JP.quantize_params(_trees(family)[0], "q4_0"))))
    assert not isinstance(tq["embeddings"].get("proj", {}).get("w"),
                          P.QuantizedTensor)
    ids, mask = _batch(family, seed=1)
    ref = _jax(jq, jcfg, ids, mask, kernels=True)
    got = _port(tq, cfg, ids, mask)
    assert got.shape == (3, 64) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2e-3
    plain = _port(tq, cfg, ids, mask, use_kernels=False)
    assert np.abs(plain - _jax(jq, jcfg, ids, mask)).max() <= 1e-5


# ---------------------------------------------------------------------------
# (d) ALBERT's depth and its native checkpoint
# ---------------------------------------------------------------------------

def test_albert_depth_actually_applied():
    """The one stored layer runs num_hidden_layers times: 1 layer against
    4 differ, and each equals JAX's at its depth."""
    _, _, jcfg, cfg = _family("albert")
    jp, tp = _trees("albert")
    ids = np.arange(5, 13, dtype=np.int32)[None]
    mask = np.ones((1, 8), np.int32)
    outs = []
    for n in (4, 1):
        got = _port(tp, dataclasses.replace(cfg, num_hidden_layers=n), ids,
                    mask, return_hidden=True)
        ref = _jax(jp, dataclasses.replace(jcfg, num_hidden_layers=n), ids,
                   mask, return_hidden=True)
        assert np.abs(got - ref).max() <= 1e-5
        outs.append(got)
    assert not np.allclose(outs[0], outs[1], atol=1e-3)


def test_albert_native_roundtrip(tmp_path):
    """save_native / load_native keep proj and the one-deep stack, q4_0
    included; a file either package writes loads in the other."""
    _, _, jcfg, cfg = _family("albert")
    jq, tq, _ = _q4_trees("albert")
    P.save_native(tmp_path / "port.npz", tq, cfg)
    back, cfg2 = P.load_native(tmp_path / "port.npz")
    assert cfg2.shared_layers and cfg2.embedding_size == 32
    assert back["layers"]["mlp"]["up"]["w"].shape[0] == 1
    assert_same_tree(back, P.map_tree(lambda t: t.numpy(), tq))
    jback, jcfg2 = JP.load_native(tmp_path / "port.npz")
    assert jcfg2.shared_layers
    np.testing.assert_array_equal(np.asarray(jback["embeddings"]["proj"]["w"]),
                                  tq["embeddings"]["proj"]["w"].numpy())
    JP.save_native(tmp_path / "jax.npz", jq, jcfg)
    tback, _ = P.load_native(tmp_path / "jax.npz")
    assert_same_tree(tback, P.map_tree(lambda t: t.numpy(), tq))
    ids, mask = _batch("albert", seed=2)
    np.testing.assert_array_equal(_port(tback, cfg, ids, mask),
                                  _port(tq, cfg, ids, mask))


# ---------------------------------------------------------------------------
# (e) packed RoBERTa
# ---------------------------------------------------------------------------

def _jax_packed(jp, jcfg, arrays, kernels):
    """JAX's ``encode_packed``: its default path, or its Pallas path with
    the quantized matmuls in interpret mode."""
    with jlin.pallas_mode("always" if kernels else "never"), \
            jlin.interpret_mode(kernels):
        return np.asarray(jbert.encode_packed(
            jp, jcfg, *(jnp.asarray(a) for a in arrays)))


def test_roberta_packed_matches_jax():
    """Packed rows restart positions at the offset (2) per segment: the
    port's ``encode_packed`` against JAX's, f32 (1e-5) and q4_0 (its plain
    path 1e-5 to JAX's default path, its kernel path 2e-3 to JAX's
    interpret path); each segment equals its own bucketed row."""
    _, _, jcfg, cfg = _family("roberta")
    assert cfg.position_offset == 2
    rng = np.random.default_rng(9)
    toks = [list(rng.integers(5, 262, int(k)))
            for k in rng.integers(3, 30, 12)]
    b = jpacking.plan_packing([len(t) for t in toks], 64, 8, max_segs=8)[0]
    arrays = jpacking.materialize(b, toks, 1, "mean")
    ins = [torch.from_numpy(np.asarray(a)) for a in arrays[:4]]
    for q4, (jp, tp) in ((False, _trees("roberta")),
                         (True, _q4_trees("roberta")[:2])):
        ref = _jax_packed(jp, jcfg, arrays[:4], kernels=False)
        got = tbert.encode_packed(tp, cfg, *ins, use_kernels=False).numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-5
        for r, s, i in arrays[4]:
            ids = np.asarray([toks[i]], np.int32)
            one = _port(tp, cfg, ids, np.ones_like(ids), pooling="mean",
                        use_kernels=False)
            assert np.abs(got[r, s] - one[0]).max() <= 1e-5
        kref = _jax_packed(jp, jcfg, arrays[:4], kernels=True)
        kgot = tbert.encode_packed(tp, cfg, *ins).numpy()
        assert np.abs(kgot - kref).max() <= (2e-3 if q4 else 1e-5)


# ---------------------------------------------------------------------------
# (f) HF directories through load_model
# ---------------------------------------------------------------------------

def _write_dir(tmp_path, family, small_vocab):
    """An HF directory of the family's model: its config and weights,
    WordPiece vocab.txt (DistilBERT, RoFormer), the byte-level BPE files
    (RoBERTa) or a trained Unigram tokenizer.json (ALBERT)."""
    model, d = _hf_model(family)
    out = tmp_path / family
    out.mkdir()
    model.save_pretrained(out)
    if family == "albert":
        from tokenizers import (Tokenizer, models, normalizers,
                                pre_tokenizers, trainers)
        tok = Tokenizer(models.Unigram())
        tok.normalizer = normalizers.Sequence(
            [normalizers.NFKD(), normalizers.Lowercase(),
             normalizers.StripAccents()])
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        trainer = trainers.UnigramTrainer(
            vocab_size=200, show_progress=False,
            special_tokens=["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"],
            unk_token="<unk>")
        tok.train_from_iterator(["hello world", "the quick brown fox",
                                 "albert shares layers"] * 5, trainer)
        tok.save(str(out / "tokenizer.json"))
    elif family == "roberta":
        from embeddings_tpu_torch.tokenizer.bpe import bytes_to_unicode
        alphabet = sorted(set(bytes_to_unicode().values()))
        tokens = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"] + alphabet
        (out / "vocab.json").write_text(json.dumps(
            {t: i for i, t in enumerate(tokens)}))
        (out / "merges.txt").write_text("#version: 0.2\n")
    else:
        (out / "vocab.txt").write_text("\n".join(small_vocab))
    return out


@pytest.mark.parametrize("family", ["distilbert", "roberta", "roformer",
                                    "albert"])
def test_load_model_dir_matches_jax(tmp_path, family, small_vocab):
    from embeddings_tpu.runtime.engine import load_model as jax_load
    from embeddings_tpu_torch.tokenizer import UnigramTokenizer
    d = _write_dir(tmp_path, family, small_vocab)
    te = load_model(d, device="cpu")
    je = jax_load(d)
    if family == "albert":
        assert isinstance(te.tokenizer, UnigramTokenizer)
        assert te.config.shared_layers and te.n_embd == 64
    texts = ["hello world", "the quick brown fox", "hello world"]
    for t in texts:
        assert te.tokenize(t) == je.tokenize(t)
    got, ref = te.encode_batch(texts), je.encode_batch(texts)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0], got[2])
    q4 = load_model(d, dtype="q4_0", device="cpu").encode_batch(texts)
    assert float((q4 * got).sum(-1).min()) > 0.98
    packed = te.encode_batch_packed(texts, row_len=32)
    assert float((packed * got).sum(-1).min()) > 0.9999
