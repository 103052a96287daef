"""Tokenizers of the PyTorch port: the pure-Python WordPiece path (a copy
of ``embeddings_tpu.tokenizer.wordpiece``). BPE, Unigram and the native
C++ fast tokenizer are not ported yet."""

from pathlib import Path

from .wordpiece import (WordPieceTokenizer, WordPieceVocab, normalize,
                        pre_tokenize)

__all__ = ["WordPieceTokenizer", "WordPieceVocab", "normalize",
           "pre_tokenize", "tokenizer_from_dir"]


def tokenizer_from_dir(model_dir):
    """WordPiece tokenizer for an HF model directory that ships
    ``vocab.txt`` (the BERT family)."""
    model_dir = Path(model_dir)
    if (model_dir / "vocab.txt").exists():
        return WordPieceTokenizer.from_pretrained(model_dir)
    raise FileNotFoundError(
        f"no vocab.txt in {model_dir} (the PyTorch port reads WordPiece "
        f"vocabularies only)")
