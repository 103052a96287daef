"""Spans at the port's layer boundaries, on the ``torch.profiler`` clock
that the device trace uses.

``span(name, args)`` opens a host range of the profiler that is running
(``Engine.profile``, the CLI's ``--profile``, or any
``torch.profiler.profile`` around a call); with no profiler running it
returns one shared no-op context, so a span then costs one flag check.
Nothing is kept or written: the spans exist only inside a profiler
session.

A span is recorded as a plain host op (``RecordScope.FUNCTION``, through
``torch._C._profiler._RecordFunctionFast``), not as a user annotation
(``torch.profiler.record_function``): the profiler draws a device-side
copy of a user annotation across the kernels launched inside it, idle
gaps included, which a reader of the device's timeline would take for
busy time. ``args`` (ints and bools) are kept where the profiler records
inputs (``record_shapes=True``): as the event's ``kwinputs`` and in the
Chrome trace's ``args``.

  engine.call       Engine.encode_toks / encode_toks_packed / rerank: the
                    root of one call's spans
  engine.tokenize   the tokenizing list of encode_batch / _packed
  engine.plan       plan_batches / plan_packing
  engine.pad        pad_batch (and a rerank batch's token types)
  engine.pack       materialize, max_block_span, _bucket_window
  engine.upload     a batch's host-to-device copies
  model.forward     the call that enqueues the model's operations; args
                    rows, row_len, tokens (real ones), packed
  engine.readback   the device-to-host copy, where the host waits
  engine.scatter    the writes into the call's output
  moe_dispatch, moe_expert_gemm, moe_expert_ops   ``ops.moe``'s ragged
                    MoE FFN (router to index_add_, the expert products,
                    their casts and activation; a shared expert's products
                    and activation under moe_expert_gemm)
  mla_latent        ``models.bert``'s MLA half between its projections and
                    attention: the latent's RMSNorm, the kv_b product, the
                    rotation and the building of q | k | v
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

NAMES = ("engine.call", "engine.tokenize", "engine.plan", "engine.pad",
         "engine.pack", "engine.upload", "model.forward", "engine.readback",
         "engine.scatter", "moe_dispatch", "moe_expert_gemm",
         "moe_expert_ops", "mla_latent")

_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a profiler is running (callers compute a span's args only
    then)."""
    return _profiler._is_profiler_enabled


def span(name: str, args: dict | None = None):
    """A host range ``name`` (one of ``NAMES``) with ``args``, while a
    profiler runs; else a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if args is None:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, [], args)
