"""Operators of the PyTorch port: quantization codecs, the quantized
linear dispatch, and the hand-written CUDA kernels (``qmatmul`` K1,
``qmatmul_int8`` K3, ``fused_attention`` K2,
``fused_attention_segmented`` K4, ``fused_attention_segmented_blockskip``
K5, ``fused_attention_stream`` K6, ``fused_attention_bias`` K7) with
their plain PyTorch versions, and the ALiBi slopes."""
