"""Tokenizers of the PyTorch port: copies of the JAX package's pure-Python
WordPiece (``embeddings_tpu.tokenizer.wordpiece``) and byte-level BPE
(``embeddings_tpu.tokenizer.bpe``, which needs the ``regex`` package).
Unigram and the native C++ fast tokenizer are not ported yet."""

import json
from pathlib import Path

from .bpe import ByteLevelBPETokenizer
from .wordpiece import (WordPieceTokenizer, WordPieceVocab, normalize,
                        pre_tokenize)

__all__ = ["WordPieceTokenizer", "WordPieceVocab", "ByteLevelBPETokenizer",
           "normalize", "pre_tokenize", "tokenizer_from_dir"]


def tokenizer_from_dir(model_dir):
    """The tokenizer of an HF model directory: WordPiece for vocab.txt
    (the BERT family), byte-level BPE for vocab.json + merges.txt or a
    tokenizer.json whose model is BPE (RoBERTa, ModernBERT)."""
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
        raise ValueError(
            f"tokenizer.json model type {kind!r} in {model_dir}: the "
            f"PyTorch port reads WordPiece (vocab.txt) and byte-level BPE")
    raise FileNotFoundError(
        f"no tokenizer files in {model_dir} (vocab.txt, vocab.json + "
        f"merges.txt, or a BPE tokenizer.json)")
