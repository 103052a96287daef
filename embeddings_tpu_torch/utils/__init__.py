"""Utilities of the PyTorch port: device timing on CUDA events
(``benchmarking``) and output-embedding quantization for vector stores
(``embedding_quant``)."""

from .benchmarking import device_time_us, wallclock_throughput

__all__ = ["device_time_us", "wallclock_throughput"]
