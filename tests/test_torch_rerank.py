"""Cross-encoder rerank and XLM-R in the port against the JAX package, on
the CPU, from HF models built offline with ``transformers`` at the shapes
of ``tests/test_rerank.py`` and ``tests/test_xlm_roberta.py``.

(a) ``from_hf_state_dict`` builds both head styles as JAX does (BERT:
    pooler -> classifier; RoBERTa: classifier.dense -> out_proj), and an
    embedding checkpoint builds none.
(b) ``score_pairs`` against JAX's: f32 dense weights, the port's kernel
    path (the kernels' plain versions here) against JAX's default path,
    max abs 1e-5; q4_0 packed with fused qkv, against JAX's Pallas path
    in interpret mode, rtol 1e-3 + atol 1e-6 on the logits (random-init
    heads give logits of |x| ~ 1e-2, so the documented 2e-3 absolute
    would hold nothing), and both against the HF model.
(c) ``Engine.rerank`` equals JAX's ``Engine.rerank`` end to end (WordPiece
    pairs with token types; XLM-R's Unigram pairs), and keeps JAX's
    refusals: no head, a mesh, a tokenizer without pair encoding.
(d) A GGUF reranker's ``cls`` / ``cls.output`` head loads and scores as
    JAX's; a lone ``cls`` builds no head.
(e) XLM-R: the config is RoBERTa's family, the engine matches HF torch
    end to end, and the tokenizer's specials reach the config.
"""

import functools
import importlib
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from embeddings_tpu.config import BertConfig as JaxConfig, \
    EngineConfig as JaxEngineConfig
from embeddings_tpu.models import bert as jbert, gguf_io as JF, \
    params as JP
from embeddings_tpu.runtime.engine import load_model as jax_load

from embeddings_tpu_torch.config import BertConfig, EngineConfig
from embeddings_tpu_torch.models import bert as tbert, params as P
from embeddings_tpu_torch.runtime.engine import Engine, load_model

from .test_gguf_io import _arch_weights, _write_raw_gguf
from .test_xlm_roberta import L_MAX, VOCAB as XLMR_VOCAB, _train_unigram

jlin = importlib.import_module("embeddings_tpu.ops.linear")
jattn = importlib.import_module("embeddings_tpu.ops.attention")

VOCAB, HIDDEN = 96, 64
QUERY = "hello relevant"
DOCS = ["relevant document", "hello world", "abc", "relevant world",
        "hello hello relevant document world"]


def _hf_reranker(style: str):
    """(HF model, state dict) of a 2-layer reranker: BERT style (seed 0)
    or XLM-R style (seed 1), as tests/test_rerank.py builds them."""
    common = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128, num_labels=1,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  classifier_dropout=0.0)
    if style == "bert":
        hf = transformers.BertConfig(max_position_embeddings=64, **common)
        torch.manual_seed(0)
        model = transformers.BertForSequenceClassification(hf).eval()
    else:
        hf = transformers.XLMRobertaConfig(
            max_position_embeddings=66, pad_token_id=1, bos_token_id=0,
            eos_token_id=2, **common)
        torch.manual_seed(1)
        model = transformers.XLMRobertaForSequenceClassification(hf).eval()
    return model, {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def rerankers():
    """{style: (HF model, jax cfg, jax params, port cfg, port params)}."""
    out = {}
    for style in ("bert", "xlmr"):
        model, sd = _hf_reranker(style)
        d = model.config.to_dict()
        jcfg, cfg = JaxConfig.from_hf_dict(d), BertConfig.from_hf_dict(d)
        out[style] = (model, jcfg, JP.from_hf_state_dict(sd, jcfg), cfg,
                      P.from_hf_state_dict(sd, cfg))
    return out


def _pairs(cfg, style, seed=0, B=3, L=14):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, VOCAB, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    mask[2, 6:] = 0
    ids[mask == 0] = cfg.pad_token_id
    types = np.zeros((B, L), np.int32)
    if style == "bert":
        for b in range(B):
            types[b, 5: mask[b].sum()] = 1  # the document span
    return ids, mask, types


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree.float() if isinstance(
            tree, torch.Tensor) else tree, np.float32)


# ---------------------------------------------------------------------------
# (a) the head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["bert", "xlmr"])
def test_head_matches_jax(rerankers, style):
    _, _, jp, _, tp = rerankers[style]
    keys = {"bert": {"pooler", "out"}, "xlmr": {"dense", "out"}}[style]
    assert set(tp["cls_head"]) == set(jp["cls_head"]) == keys
    assert tuple(tp["cls_head"]["out"]["w"].shape) == (HIDDEN, 1)
    got, ref = dict(_leaves(tp["cls_head"])), dict(_leaves(jp["cls_head"]))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_embedding_checkpoint_has_no_head():
    hf = transformers.BertConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                                 num_hidden_layers=1, num_attention_heads=4,
                                 intermediate_size=64,
                                 max_position_embeddings=32)
    torch.manual_seed(0)
    m = transformers.BertModel(hf).eval()  # a pooler, no classifier
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    cfg = BertConfig.from_hf_dict(hf.to_dict())
    assert "pooler.dense.weight" in sd
    assert "cls_head" not in P.from_hf_state_dict(sd, cfg)
    assert "cls_head" not in JP.from_hf_state_dict(
        sd, JaxConfig.from_hf_dict(hf.to_dict()))


# ---------------------------------------------------------------------------
# (b) score_pairs
# ---------------------------------------------------------------------------

def _jax_scores(jp, jcfg, ids, mask, types, kernels):
    orig = jattn.fused_attention
    if kernels:
        jattn.fused_attention = functools.partial(orig, interpret=True)
    try:
        with jlin.pallas_mode("always" if kernels else "never"), \
                jlin.interpret_mode(kernels):
            return np.asarray(jbert.score_pairs(
                jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                jnp.asarray(types)))
    finally:
        jattn.fused_attention = orig


@pytest.mark.parametrize("style", ["bert", "xlmr"])
@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_score_pairs_matches_jax(rerankers, style, dtype):
    model, jcfg, jp, cfg, tp = rerankers[style]
    ids, mask, types = _pairs(cfg, style, seed=2)
    if dtype == "q4_0":
        jp = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(jp, "q4_0")))
        tp = P.from_jax_params(jp)
        assert "cls_head" in tp  # the head survives quantization, dense
    got = tbert.score_pairs(tp, cfg, torch.from_numpy(ids),
                            torch.from_numpy(mask),
                            torch.from_numpy(types)).numpy()
    assert got.shape == (3,) and np.isfinite(got).all()
    ref = _jax_scores(jp, jcfg, ids, mask, types, kernels=dtype != "f32")
    if dtype == "f32":
        assert np.abs(got - ref).max() <= 1e-5
    else:  # logits of |x| ~ 1e-2 here: relative, as well as absolute
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask).long(),
                   token_type_ids=torch.from_numpy(types).long()
                   ).logits.numpy()[:, 0]
    # HF torch: JAX's own tests' 2e-4 / 1e-3 in f32; JAX's 0.3 for q4_0
    np.testing.assert_allclose(got, hf, **(
        dict(atol=2e-4, rtol=1e-3) if dtype == "f32" else dict(atol=0.3)))


# ---------------------------------------------------------------------------
# (c) Engine.rerank
# ---------------------------------------------------------------------------

def _write_bert_dir(tmp_path, model):
    d = tmp_path / "reranker"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(model.config.to_dict()))
    torch.save(model.state_dict(), d / "pytorch_model.bin")
    tokens = ["[PAD]", "[CLS]", "[SEP]", "[UNK]", "[MASK]"]
    tokens += list("abcdefghijklmnopqrstuvwxyz")
    tokens += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    tokens += ["hello", "world", "relevant", "document"]
    (d / "vocab.txt").write_text("\n".join(tokens) + "\n")
    return d


def _write_xlmr_dir(tmp_path):
    d = tmp_path / "xlmr_reranker"
    d.mkdir()
    hf = transformers.XLMRobertaConfig(
        vocab_size=XLMR_VOCAB, hidden_size=HIDDEN, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=L_MAX, type_vocab_size=1, pad_token_id=1,
        bos_token_id=0, eos_token_id=2, num_labels=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        classifier_dropout=0.0)
    torch.manual_seed(3)
    model = transformers.XLMRobertaForSequenceClassification(hf).eval()
    (d / "config.json").write_text(json.dumps(hf.to_dict()))
    torch.save(model.state_dict(), d / "pytorch_model.bin")
    _train_unigram(d)
    return d, model


@pytest.mark.parametrize("style,dtype", [("bert", "f32"), ("bert", "q8_0"),
                                         ("xlmr", "f32")])
def test_engine_rerank_matches_jax(rerankers, tmp_path, style, dtype):
    if style == "bert":
        model = rerankers["bert"][0]
        d = _write_bert_dir(tmp_path, model)
    else:
        d, model = _write_xlmr_dir(tmp_path)
    te = load_model(d, dtype=dtype, device="cpu",
                    engine_config=EngineConfig(use_pallas="never",
                                               max_seq_len=60))
    je = jax_load(d, dtype=dtype,
                  engine_config=JaxEngineConfig(use_pallas="never",
                                                max_seq_len=60))
    got = te.rerank(QUERY, DOCS, batch_size=2)
    ref = je.rerank(QUERY, DOCS, batch_size=2)
    assert got.shape == (len(DOCS),) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the kernel path (the kernels' plain versions on the CPU)
    kgot = load_model(d, dtype=dtype, device="cpu").rerank(QUERY, DOCS)
    assert np.abs(kgot - got).max() <= (1e-5 if dtype == "f32" else 2e-3)
    if dtype == "f32":  # and the HF model on the same pair tokens
        ids, types = te.tokenizer.encode_pair(QUERY, DOCS[0],
                                              max_len=te.max_seq_len)
        with torch.no_grad():
            hf = model(input_ids=torch.tensor([ids]),
                       token_type_ids=torch.tensor([types])
                       ).logits.numpy()[0, 0]
        np.testing.assert_allclose(got[0], hf, atol=3e-4, rtol=1e-3)


def test_rerank_refusals(rerankers):
    from embeddings_tpu_torch.parallel import make_mesh_cp
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    _, _, _, cfg, tp = rerankers["bert"]
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(
        ["[PAD]", "[CLS]", "[SEP]", "[UNK]", "a"]))
    ec = EngineConfig(seq_buckets=(16,), max_seq_len=16, batch_size=2,
                      batch_buckets=(1, 2))
    bare = {k: v for k, v in tp.items() if k != "cls_head"}
    with pytest.raises(ValueError, match="classification head"):
        Engine(bare, cfg, tok, ec, device="cpu").rerank("q", ["d"])
    with pytest.raises(ValueError, match="classification head"):
        tbert.score_pairs(bare, cfg, torch.ones(1, 4, dtype=torch.int32),
                          torch.ones(1, 4, dtype=torch.int32))
    mesh = make_mesh_cp(1, 2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="single-device"):
        Engine(tp, cfg, tok, ec, mesh=mesh).rerank("q", ["d"])

    class NoPairs:
        pad_id, cls_id, sep_id, unk_id = 0, 1, 2, 3

        def encode(self, text, max_len=None):
            return [1, 2]

    with pytest.raises(ValueError, match="NoPairs has no pair encoding"):
        Engine(tp, cfg, NoPairs(), ec, device="cpu").rerank("q", ["d"])


# ---------------------------------------------------------------------------
# (d) a GGUF reranker
# ---------------------------------------------------------------------------

def _reranker_gguf(path, small_vocab, head: bool = True):
    w = _arch_weights(7)
    V, E, I = 64, 64, 96
    t = {"token_embd.weight": w(V, E), "token_types.weight": w(2, E),
         "position_embd.weight": w(64, E),
         "token_embd_norm.weight": 1.0 + 0.1 * w(E),
         "token_embd_norm.bias": 0.1 * w(E),
         "cls.weight": w(E, E), "cls.bias": 0.1 * w(E),
         "cls.output.weight": w(1, E), "cls.output.bias": 0.1 * w(1)}
    if not head:
        del t["cls.output.weight"], t["cls.output.bias"]
    for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
        t[f"blk.0.{nm}.weight"] = w(E, E)
        t[f"blk.0.{nm}.bias"] = 0.1 * w(E)
    for nm in ("attn_output_norm", "layer_output_norm"):
        t[f"blk.0.{nm}.weight"] = 1.0 + 0.1 * w(E)
        t[f"blk.0.{nm}.bias"] = 0.1 * w(E)
    t["blk.0.ffn_up.weight"], t["blk.0.ffn_up.bias"] = w(I, E), 0.1 * w(I)
    t["blk.0.ffn_down.weight"], t["blk.0.ffn_down.bias"] = (w(E, I),
                                                            0.1 * w(E))
    _write_raw_gguf(path, "bert",
                    dict(embedding_length=E, block_count=1,
                         feed_forward_length=I, context_length=64,
                         vocab_size=V,
                         **{"attention.head_count": 4,
                            "attention.layer_norm_epsilon": 1e-12}),
                    [(k, v, JF.GGML_F32) for k, v in t.items()],
                    small_vocab[:V])


def test_gguf_reranker_head_matches_jax(tmp_path, small_vocab):
    path = tmp_path / "reranker.gguf"
    _reranker_gguf(path, small_vocab)
    te = load_model(path, device="cpu")
    je = jax_load(path)
    assert set(te.params["cls_head"]) == {"dense", "out"}
    docs = ["hello world", "water", "fire", "hello hello world"]
    got, ref = te.rerank("hello world", docs), je.rerank("hello world", docs)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    half = tmp_path / "halfhead.gguf"
    _reranker_gguf(half, small_vocab, head=False)
    assert "cls_head" not in load_model(half, device="cpu").params


# ---------------------------------------------------------------------------
# (e) XLM-R (tests/test_xlm_roberta.py's three behaviours)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xlmr_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("xlmr")
    hf = transformers.XLMRobertaConfig(
        vocab_size=XLMR_VOCAB, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=L_MAX, type_vocab_size=1, pad_token_id=1,
        bos_token_id=0, eos_token_id=2, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    model = transformers.XLMRobertaModel(hf).eval()
    (d / "config.json").write_text(json.dumps(hf.to_dict()))
    torch.save(model.state_dict(), d / "pytorch_model.bin")
    _train_unigram(d)
    return d, model


def test_xlmr_config_is_roberta_family():
    cfg = BertConfig.from_hf_dict(dict(
        model_type="xlm-roberta", vocab_size=XLMR_VOCAB, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=L_MAX, type_vocab_size=1, pad_token_id=1))
    assert cfg.position_offset == 2
    assert (cfg.cls_token_id, cfg.sep_token_id, cfg.pad_token_id) == (0, 2, 1)


@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_xlmr_engine_matches_torch_and_jax(xlmr_dir, dtype):
    from embeddings_tpu_torch.tokenizer import UnigramTokenizer
    d, model = xlmr_dir
    eng = load_model(d, dtype=dtype, device="cpu")
    assert isinstance(eng.tokenizer, UnigramTokenizer)
    assert eng.config.position_offset == 2
    texts = ["hello world", "the quick brown fox", "hello world",
             "multilingual text here again"]
    emb = eng.encode_batch(texts)
    assert np.allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
    assert float((emb[0] * emb[2]).sum()) > 0.999999
    je = jax_load(d, dtype=dtype)
    for t in texts:
        assert eng.tokenize(t) == je.tokenize(t)
    ref = je.encode_batch(texts)
    if dtype == "f32":
        np.testing.assert_allclose(emb, ref, rtol=0, atol=1e-5)
        toks = eng.tokenize("hello world")
        with torch.no_grad():
            h = model(input_ids=torch.tensor([toks])
                      ).last_hidden_state.numpy()
        hf = h.mean(1)[0]
        assert float((emb[0] * hf / np.linalg.norm(hf)).sum()) > 0.9999
    else:
        # bf16 operands + tanh GELU (the kernels' plain versions) against
        # JAX's f32 fallback, as tests/test_torch_model.py holds q4_0
        assert (emb * ref).sum(-1).min() >= 0.999
    np.testing.assert_allclose(eng.encode_batch_packed(texts), emb,
                               rtol=0, atol=1e-5)


def test_xlmr_tokenizer_specials_flow_into_config(xlmr_dir):
    d, _ = xlmr_dir
    eng = load_model(d, device="cpu")
    assert eng.tokenizer.pad_id == 1 and eng.config.pad_token_id == 1
    assert eng.tokenize("hello")[0] == 0    # <s>
    assert eng.tokenize("hello")[-1] == 2   # </s>
