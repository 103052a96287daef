"""Device-time measurement of the PyTorch port — the counterpart of
``embeddings_tpu/utils/benchmarking.py`` on CUDA events.

``device_time_us`` keeps the JAX package's slope method: run the op
``lo`` and ``hi`` times back to back (each call consumes a full
reduction of the last one's output, so no call is independent of the one
before it) and divide the time difference by the call difference, so a
fixed per-measurement cost cancels. On the card the times come from two
CUDA events around the calls, with one synchronisation after every
measurement is enqueued and none inside the loop; ``profiled_device_time_us``
sums the device kernels of a ``torch.profiler`` trace. Given CPU
tensors, all three functions time on the host clock.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def _on_cuda(args: Sequence) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def kernel_name(name: str) -> str:
    """A demangled CUDA kernel name without its return type and
    namespaces: 'void (anonymous namespace)::qmm_wgmma_kernel<4,
    true>(Args)' -> 'qmm_wgmma_kernel<4, true>(Args)'."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min([i for i in (name.find("<"), name.find("(")) if i >= 0]
              or [len(name)])
    return name[name.rfind("::", 0, cut) + 2:] if "::" in name[:cut] \
        else name


def device_time_us(body: Callable, args: Sequence, *, lo: int = 50,
                   hi: int = 200, reps: int = 3) -> float:
    """Per-call time (microseconds) of ``body(x, *args[1:])``, where x is
    ``args[0]`` (a tensor) and body returns a tensor: the slope between
    ``lo`` and ``hi`` chained calls, the best of ``reps`` for each."""
    x, rest = args[0], tuple(args[1:])

    def run(iters: int) -> torch.Tensor:
        xc = x
        for _ in range(iters):
            fb = body(xc, *rest).float().sum()
            # feed a runtime zero back into the input: the next call
            # depends on every element of this one's output
            if xc.dtype.is_floating_point:
                xc = xc * (1.0 + fb.to(xc.dtype) * 1e-30)
            else:
                xc = xc + (fb * 1e-30).to(xc.dtype)
        return xc

    cuda = _on_cuda(args)
    runs = []  # (iters, start, end): events on the card, seconds on the host
    with torch.inference_mode():
        for iters in (lo, hi):
            for _ in range(reps):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    run(iters)
                    end.record()
                else:
                    start = time.perf_counter()
                    run(iters)
                    end = time.perf_counter()
                runs.append((iters, start, end))
    if cuda:
        torch.cuda.synchronize()
    best = {lo: float("inf"), hi: float("inf")}
    for iters, start, end in runs:
        s = start.elapsed_time(end) / 1e3 if cuda else end - start
        best[iters] = min(best[iters], s)
    return max((best[hi] - best[lo]) / (hi - lo) * 1e6, 1e-3)


def profiled_device_time_us(fn: Callable, args: Sequence, *,
                            reps: int = 10,
                            name_prefix: str | None = None) -> float:
    """Per-call device time (microseconds) of ``fn(*args)`` from a
    ``torch.profiler`` trace of ``reps`` calls after a warm-up call: the
    summed durations of the device kernels, only those whose name
    (``kernel_name``: no return type, no namespaces) starts with
    ``name_prefix`` when it is given (the port's kernels:
    ``qmm_wgmma_kernel``, ``attn_sm90_kernel``, ``attn90_i8_kernel``,
    ``quant_rows_kernel``, ...). On CPU tensors: the host-clock time per
    call (``name_prefix`` is not used)."""
    fn(*args)
    if not _on_cuda(args):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) / reps * 1e6
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # idle gaps at both edges: the tracer drops kernels whose device
        # timestamps fall before the window's start on the host clock
        time.sleep(0.02)
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
        time.sleep(0.02)
    total = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if name_prefix is None or \
                kernel_name(e.name).startswith(name_prefix):
            total += e.time_range.elapsed_us()
    return total / reps


def wallclock_throughput(fn: Callable, n_items: int, *, warmup: int = 2,
                         reps: int = 3) -> tuple[float, float]:
    """(seconds_per_call, items_per_second) for an end-to-end callable —
    includes host work and dispatch; use for serving-style numbers."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best, n_items / best
