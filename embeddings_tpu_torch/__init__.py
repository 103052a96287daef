"""embeddings_tpu_torch — the PyTorch/CUDA port of ``embeddings_tpu``.

The same engine (WordPiece tokenization, the BERT encoder over
blockwise-quantized weights, pooling and L2 norm, bucketed batching, the
TCP service) in PyTorch, with the JAX package's Pallas TPU kernels
rewritten by hand in CUDA C++ for the H100 (``csrc/``, built with ``nvcc``
at first use). Entry points run on the GPU unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"

from .config import KNOWN_MODELS, BertConfig, EngineConfig
from .runtime.engine import Engine, load_model
from .tokenizer import WordPieceTokenizer, WordPieceVocab

__all__ = ["BertConfig", "EngineConfig", "KNOWN_MODELS", "Engine",
           "load_model", "WordPieceTokenizer", "WordPieceVocab"]
