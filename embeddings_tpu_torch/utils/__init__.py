"""Utilities of the PyTorch port: device timing on CUDA events
(``benchmarking``), output-embedding quantization for vector stores
(``embedding_quant``) and the profiler spans at the port's layer
boundaries (``spans``)."""

from .benchmarking import device_time_us, wallclock_throughput

__all__ = ["device_time_us", "wallclock_throughput"]
