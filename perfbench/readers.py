"""What several metric readers share, and how a reader is found. Each
metric of ``BENCHMARK.json`` has its reader in ``metrics/<name>.py``: a
function ``read(rec)`` from the run's record to one number, or None where
the run holds nothing to read.

The record: ``setup_s``, ``window_s``, ``latencies_s`` and ``tokens``
(one a completed call), ``widths`` (the model's), and ``trace`` (None
untraced; else the traced stretch: ``window_s``, ``busy_s``,
``device_ops`` [{name, start, end, span}] in µs, and ``forwards``
[{packed, B, L, lengths, k1: {(K, N, epilogue): launches}, attention:
launches}]).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

METRICS = Path(__file__).resolve().parent / "metrics"
# the port's hand-written kernels, by the name the profiler gives them
HANDWRITTEN = ("qmm_wgmma_kernel", "attn_sm90_kernel", "attn90_i8_kernel",
               "emit_rows_kernel", "requant_kernel", "quant_rows_kernel")
K1 = "qmm_wgmma_kernel"
ATTENTION = "attn_sm90_kernel"


def load(metrics: Path, name: str):
    """``read`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name}", metrics / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def same_as(name: str):
    """The reader of metric ``name``, for a metric that reads the same
    quantity in other cells under a name of its own."""
    return load(METRICS, name)


def op_ms(ops) -> float:
    """The device milliseconds of ``ops``."""
    return sum(o["end"] - o["start"] for o in ops) / 1e3


def kernel_ms(trace: dict, kernel: str) -> float:
    """The device milliseconds of the operations named ``kernel``."""
    return op_ms(o for o in trace["device_ops"] if kernel in o["name"])
