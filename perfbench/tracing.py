"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
few whole requests of the window, reduced to what the per-layer readers
take: the device operations inside the stretch (each with the span that
launched it), the stretch's length, the device's busy time, and a
breakdown of the device's time and of its idle gaps by what the host was
doing.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

STRETCH = "perfbench.traced"
# the spans whose kernels a reader may ask for: the port's MoE spans
SPANS = ("moe_dispatch", "moe_expert_gemm", "moe_expert_ops")
# the benchmark's own host spans: a request, and an Engine forward in it
OUTER = ("perfbench.request", "engine.forward")
# what the host does in a gap inside one of them and in no op
GAP_LABELS = {"perfbench.request": "host: in the Engine call, outside a "
              "forward (plan, pad or pack, read-back, scatter)",
              "engine.forward": "host: in a forward, between ops"}
# the tracer keeps a kernel only if its device time falls inside the
# profile on the host's clock, and the two clocks can disagree by a
# fraction of a millisecond: idle gaps at both edges keep every kernel of
# the stretch inside it
EDGE_S = 0.02


class Stretch:
    """Profile ``run()`` calls (each a whole request, ending in its host
    read-back) until ``seconds`` have passed; ``reduce()`` afterwards."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None

    def run(self, step) -> int:
        """Call ``step()`` under the profiler until the stretch is over;
        returns the number of calls."""
        n = 0
        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            time.sleep(EDGE_S)
            with record_function(STRETCH):
                t0 = time.perf_counter()
                while True:
                    step()
                    n += 1
                    if time.perf_counter() - t0 >= self.seconds:
                        break
            if cuda:
                torch.cuda.synchronize()
            time.sleep(EDGE_S)
        self.prof = prof
        return n

    def reduce(self, skip=()) -> dict:
        return reduce_events(self.prof.events(), skip)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events, skip=()) -> dict:
    """The traced stretch from the profiler's events (µs): ``window``
    (start, end) of the stretch's span; ``device_ops``: every device
    operation inside it as {name, start, end, span}, clipped to the
    window, ``span`` the innermost of ``SPANS`` around the host op that
    launched it; ``busy_us``, the union of their intervals; ``breakdown``:
    device seconds by operation name and idle seconds by the host's
    innermost op at each gap's middle (top 10 each). ``skip`` names the
    device-side copies of host spans to leave out."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    marks = [e for e in cpu if e.name == STRETCH]
    if not marks:
        raise RuntimeError("the trace holds no traced stretch")
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    runtime = {e.id: e for e in cpu if e.name.startswith("cu")}
    ignore = set(SPANS) | set(OUTER) | {STRETCH} | set(skip)
    ops = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name in ignore or e.name.startswith("ProfilerStep"):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        launch = runtime.get(e.id)
        ops.append({"name": e.name, "start": a, "end": b,
                    "span": _span(launch.cpu_parent if launch else None)})
    busy = _union([(o["start"], o["end"]) for o in ops])
    busy_us = sum(b - a for a, b in busy)
    by_name = collections.Counter()
    for o in ops:
        by_name[_short(o["name"])] += (o["end"] - o["start"]) / 1e6
    gaps = collections.Counter()
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu if e.name != STRETCH), key=lambda t: t[0])
    starts = [h[0] for h in host]
    outer = [h for h in host if h[2] in OUTER]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_host_label(host, starts, outer, (a + b) / 2)] += \
                (b - a) / 1e6
    return {"window": (w0, w1), "window_s": (w1 - w0) / 1e6,
            "busy_s": busy_us / 1e6, "device_ops": ops,
            "breakdown": {
                "device_ops": [[k, v] for k, v in by_name.most_common(10)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(10)]}}


def _span(op) -> str | None:
    while op is not None:
        if op.name in SPANS:
            return op.name
        op = op.cpu_parent
    return None


def _short(name: str) -> str:
    """A kernel's name without its parameter list, at most 120 letters."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].removeprefix("void ")[:120]


def _host_label(host: list, starts: list, outer: list, t: float) -> str:
    """The innermost host op covering time t (the latest-started one that
    has not ended, among the last few hundred to start; else the
    innermost of the long spans ``OUTER``, by ``GAP_LABELS``), or "host:
    between requests"."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):
        if host[j][1] >= t:
            return GAP_LABELS.get(host[j][2], host[j][2])
    inside = [h for h in outer if h[0] <= t <= h[1]]
    return GAP_LABELS[max(inside)[2]] if inside else \
        "host: between requests"
