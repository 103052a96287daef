"""The port's copies of the Unigram tokenizer, the sentencepiece ``.model``
reader and the precompiled charsmap against the JAX package's modules, on
the inputs ``tests/test_unigram_tokenizer.py``, ``test_spm_model.py`` and
``test_charsmap.py`` build: the token ids (and every special id, the
normalized text, the parsed proto fields and the refusals) must be equal.
Then an ALBERT directory with a raw ``spiece.model`` loads through the
port's ``load_model(..., device="cpu")`` and encodes as JAX's does.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")
pb2 = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")

from embeddings_tpu.tokenizer import charsmap as jcharsmap
from embeddings_tpu.tokenizer import spm as jspm
from embeddings_tpu.tokenizer import tokenizer_from_dir as jax_from_dir
from embeddings_tpu.tokenizer.unigram import UnigramTokenizer as JaxUnigram

from embeddings_tpu_torch.tokenizer import UnigramTokenizer, charsmap, spm, \
    tokenizer_from_dir

from tests.test_charsmap import CASES, MAPPING, build_charsmap
from tests.test_spm_model import ACCENT_PROMPTS, _build_proto, _train_vocab
from tests.test_unigram_tokenizer import CORPUS, PROMPTS

ALBERT_SPECIALS = ["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"]
SPECIAL_IDS = ("cls_id", "sep_id", "pad_id", "unk_id", "mask_id")


def _texts(seed: int = 11) -> list[str]:
    """The JAX tests' prompts, accent prompts, and random ASCII and
    random-codepoint strings from their seeds."""
    rng = np.random.default_rng(seed)
    chars = np.array(list("etaoin shrdlu xyzq. 0129"))
    out = PROMPTS + ACCENT_PROMPTS + [s.lower() for s in PROMPTS]
    out += ["".join(rng.choice(chars, size=int(rng.integers(0, 50))))
            for _ in range(100)]
    for _ in range(60):
        cps = rng.integers(0x20, 0x3000, size=int(rng.integers(1, 25)))
        out.append("".join(chr(c) for c in cps
                           if not (0xD800 <= c <= 0xDFFF)))
    return out


def assert_same_tokenizer(port, ref, texts=None):
    """Equal special ids, ids for every text (bare, wrapped, batched and
    truncated) and decoded text."""
    assert type(port).__name__ == type(ref).__name__
    for a in SPECIAL_IDS:
        assert getattr(port, a, None) == getattr(ref, a, None), a
    assert port.pieces == ref.pieces
    texts = _texts() if texts is None else texts
    for t in texts:
        ids = port.tokenize_to_ids(t)
        assert ids == ref.tokenize_to_ids(t), repr(t)
        assert port.encode(t) == ref.encode(t), repr(t)
        assert port.encode(t, max_len=8) == ref.encode(t, max_len=8)
        assert port.decode(ids) == ref.decode(ids)
    assert port.encode_batch(texts[:20]) == ref.encode_batch(texts[:20])


def _rust_unigram(normalizer, specials, vocab_size=300):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizer
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.train_from_iterator(CORPUS * 5, trainers.UnigramTrainer(
        vocab_size=vocab_size, show_progress=False, special_tokens=specials,
        unk_token="<unk>"))
    return tok


def _tokenizer_json(kind: str, path):
    """A tokenizer.json of the JAX tests: XLM-R style (NFKC), ALBERT style
    (Replace + NFKD + Lowercase + StripAccents), or a hand-made vocab
    under a Precompiled charsmap normalizer."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers
    if kind == "nfkc":
        tok = _rust_unigram(normalizers.NFKC(),
                            ["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    elif kind == "albert":
        tok = _rust_unigram(normalizers.Sequence([
            normalizers.Replace("``", '"'), normalizers.NFKD(),
            normalizers.Lowercase(), normalizers.StripAccents()]),
            ALBERT_SPECIALS, vocab_size=200)
    else:
        vocab = [("<unk>", 0.0), ("▁", -2.0), ("▁hE", -1.0),
                 ("llo", -1.5), ("▁A", -1.2), ("E", -3.0),
                 ("▁...", -1.1), ("fi", -2.5), ("lE", -2.2),
                 ("y", -2.0), ("▁worl", -1.4), ("d", -2.8)]
        tok = Tokenizer(models.Unigram(vocab, unk_id=0, byte_fallback=False))
        tok.normalizer = normalizers.Precompiled(build_charsmap(MAPPING))
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.save(str(path))
    return tok


@pytest.mark.parametrize("kind", ["nfkc", "albert", "precompiled"])
def test_tokenizer_json_matches_jax(tmp_path, kind):
    path = tmp_path / "tokenizer.json"
    rust = _tokenizer_json(kind, path)
    port = UnigramTokenizer.from_tokenizer_json(path)
    assert_same_tokenizer(port, JaxUnigram.from_tokenizer_json(path),
                          texts=_texts() + CASES)
    # and the rust oracle itself, as the JAX tests hold JAX's
    for t in PROMPTS + CASES:
        assert port.tokenize_to_ids(t) == rust.encode(
            t, add_special_tokens=False).ids, repr(t)


@pytest.fixture(scope="module")
def sp_vocab():
    return _train_vocab(["<unk>", "<s>", "</s>"])


@pytest.mark.parametrize("style", ["plain", "xlm-roberta", "albert"])
def test_sentencepiece_model_matches_jax(tmp_path, sp_vocab, style):
    if style == "albert":
        proto = _build_proto(_train_vocab(ALBERT_SPECIALS),
                             controls=("<pad>", "[CLS]", "[SEP]", "[MASK]"),
                             unk_id=1)
        kw = dict(style="albert", do_lower_case=True, keep_accents=False)
    else:
        proto = _build_proto(sp_vocab, controls=("<s>", "</s>"), unk_id=0)
        kw = {} if style == "plain" else dict(style=style)
    path = tmp_path / "spiece.model"
    path.write_bytes(proto)
    port = UnigramTokenizer.from_sentencepiece_model(path, **kw)
    ref = JaxUnigram.from_sentencepiece_model(path, **kw)
    assert port.normalizer == ref.normalizer
    assert port.prepend_scheme == ref.prepend_scheme
    assert_same_tokenizer(port, ref)


def test_parse_model_matches_jax(sp_vocab):
    """Every field the reader returns, and the refusals of a truncated
    proto and of a BPE model type."""
    from dataclasses import asdict
    proto = _build_proto(sp_vocab, controls=("<s>", "</s>"), unk_id=0,
                         pad_id=-1, charsmap=build_charsmap(MAPPING))
    assert asdict(spm.parse_model(proto)) == asdict(jspm.parse_model(proto))
    assert (spm.MODEL_UNIGRAM, spm.MODEL_BPE, spm.PIECE_UNKNOWN,
            spm.PIECE_CONTROL) == (jspm.MODEL_UNIGRAM, jspm.MODEL_BPE,
                                   jspm.PIECE_UNKNOWN, jspm.PIECE_CONTROL)
    for bad in (proto[:len(proto) // 2], b"\x0a\xff"):
        with pytest.raises(Exception) as port_err:
            spm.parse_model(bad)
        with pytest.raises(Exception) as jax_err:
            jspm.parse_model(bad)
        assert type(port_err.value) is type(jax_err.value)
        assert str(port_err.value) == str(jax_err.value)


def test_charsmap_matches_jax():
    """The normalized text of the charsmap tests' cases and of random
    strings over the mapping's keys; a malformed blob is refused alike."""
    blob = build_charsmap(MAPPING)
    port = charsmap.PrecompiledCharsmap(blob)
    ref = jcharsmap.PrecompiledCharsmap(blob)
    rng = np.random.default_rng(7)
    alphabet = list(MAPPING) + list("ab ́\U0001f3fd")
    texts = CASES + ["".join(rng.choice(alphabet, size=int(n)))
                     for n in rng.integers(0, 12, 200)]
    for t in texts:
        assert port.normalize(t) == ref.normalize(t), repr(t)
    for bad in (b"", b"\x01\x00\x00", blob[:7]):
        with pytest.raises(Exception) as port_err:
            charsmap.PrecompiledCharsmap(bad)
        with pytest.raises(Exception) as jax_err:
            jcharsmap.PrecompiledCharsmap(bad)
        assert str(port_err.value) == str(jax_err.value)


def test_tokenizer_from_dir_matches_jax(tmp_path, sp_vocab):
    """The Unigram branches of ``tokenizer_from_dir``: a Unigram
    tokenizer.json, a raw sentencepiece.bpe.model under an XLM-R config
    (fairseq remap) and a spiece.model under an ALBERT config (lowercase,
    no accents); tokenizer.json wins over a model file beside it."""
    dirs = {}
    for name, fname, model_type, proto in (
            ("xlmr", "sentencepiece.bpe.model", "xlm-roberta",
             _build_proto(sp_vocab, controls=("<s>", "</s>"), unk_id=0)),
            ("albert", "spiece.model", "albert",
             _build_proto(_train_vocab(ALBERT_SPECIALS),
                          controls=("<pad>", "[CLS]", "[SEP]", "[MASK]"),
                          unk_id=1))):
        d = dirs[name] = tmp_path / name
        d.mkdir()
        (d / fname).write_bytes(proto)
        (d / "config.json").write_text(json.dumps({"model_type": model_type}))
    d = dirs["json"] = tmp_path / "json"
    d.mkdir()
    _tokenizer_json("nfkc", d / "tokenizer.json")
    (d / "spiece.model").write_bytes(b"garbage that must not be read")
    for name, d in dirs.items():
        port = tokenizer_from_dir(d)
        assert isinstance(port, UnigramTokenizer), name
        assert_same_tokenizer(port, jax_from_dir(d), texts=PROMPTS)
    assert tokenizer_from_dir(dirs["xlmr"]).unk_id == 3
    assert "lowercase" in tokenizer_from_dir(dirs["albert"]).normalizer
    with pytest.raises(FileNotFoundError, match="sentencepiece"):
        tokenizer_from_dir(tmp_path)


def test_albert_spiece_dir_loads(tmp_path):
    """An ALBERT directory that ships only spiece.model (as albert-base-v2
    does) loads through the port's ``load_model`` on the CPU, its
    tokenizer the Unigram one with ALBERT's specials, and encodes as the
    JAX package's ``load_model`` does."""
    import torch
    from transformers import AlbertConfig, AlbertModel
    from embeddings_tpu.runtime.engine import load_model as jax_load
    from embeddings_tpu_torch import load_model
    vocab = _train_vocab(ALBERT_SPECIALS)
    hf = AlbertConfig(vocab_size=len(vocab), embedding_size=32,
                      hidden_size=64, num_hidden_layers=4,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=64, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    d = tmp_path / "albert"
    AlbertModel(hf).eval().save_pretrained(d)
    (d / "spiece.model").write_bytes(_build_proto(
        vocab, controls=("<pad>", "[CLS]", "[SEP]", "[MASK]"), unk_id=1))
    te = load_model(d, device="cpu")
    je = jax_load(d)
    assert isinstance(te.tokenizer, UnigramTokenizer)
    assert (te.tokenizer.cls_id, te.tokenizer.sep_id,
            te.tokenizer.pad_id) == (2, 3, 0)
    assert te.config.shared_layers and te.config.embedding_size == 32
    texts = ["The quick brown fox", "Naïve Café", "The quick brown fox"]
    for t in texts:
        assert te.tokenize(t) == je.tokenize(t)
    got = te.encode_batch(texts)
    np.testing.assert_allclose(got, je.encode_batch(texts), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got[0], got[2])
