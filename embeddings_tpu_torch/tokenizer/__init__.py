"""Tokenizers of the PyTorch port: copies of the JAX package's pure-Python
WordPiece (``embeddings_tpu.tokenizer.wordpiece``), byte-level BPE
(``embeddings_tpu.tokenizer.bpe``, which needs the ``regex`` package) and
Unigram with its sentencepiece ``.model`` reader and precompiled
charsmap (``unigram``, ``spm``, ``charsmap``); ``native``, the ctypes
binding to the C++ tokenizers in ``native/``, which it builds at first
use."""

import json
from pathlib import Path

from .bpe import ByteLevelBPETokenizer
from .unigram import UnigramTokenizer
from .wordpiece import (WordPieceTokenizer, WordPieceVocab, normalize,
                        pre_tokenize)

__all__ = ["WordPieceTokenizer", "WordPieceVocab", "ByteLevelBPETokenizer",
           "UnigramTokenizer", "normalize", "pre_tokenize",
           "tokenizer_from_dir"]


def tokenizer_from_dir(model_dir):
    """The tokenizer of an HF model directory: WordPiece for vocab.txt
    (the BERT family), byte-level BPE for vocab.json + merges.txt or a
    tokenizer.json whose model is BPE (RoBERTa, ModernBERT), Unigram for a
    tokenizer.json whose model is Unigram or a raw sentencepiece
    ``.model`` file (ALBERT, XLM-R)."""
    model_dir = Path(model_dir)
    if (model_dir / "vocab.txt").exists():
        return WordPieceTokenizer.from_pretrained(model_dir)
    if ((model_dir / "vocab.json").exists()
            and (model_dir / "merges.txt").exists()):
        return ByteLevelBPETokenizer.from_pretrained(model_dir)
    tj = model_dir / "tokenizer.json"
    if tj.exists():
        with open(tj, encoding="utf-8") as f:
            kind = (json.load(f).get("model") or {}).get("type")
        if kind == "BPE":
            return ByteLevelBPETokenizer.from_pretrained(model_dir)
        if kind == "Unigram":
            return UnigramTokenizer.from_pretrained(model_dir)
        raise ValueError(
            f"unsupported tokenizer.json model type {kind!r} in "
            f"{model_dir} (WordPiece via vocab.txt, byte-level BPE, "
            f"and Unigram are supported)")
    if any((model_dir / n).exists()
           for n in ("spiece.model", "sentencepiece.bpe.model",
                     "tokenizer.model")):
        # a raw sentencepiece model; its style comes from config.json
        return UnigramTokenizer.from_pretrained(model_dir)
    raise FileNotFoundError(
        f"no tokenizer files in {model_dir} (vocab.txt, vocab.json + "
        f"merges.txt, tokenizer.json, or a sentencepiece .model file)")
