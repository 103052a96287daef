"""Operators of the PyTorch port: quantization codecs, the quantized
linear dispatch, and the hand-written CUDA kernels (``qmatmul`` K1,
``fused_attention`` K2) with their plain PyTorch versions."""
