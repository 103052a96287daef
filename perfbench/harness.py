"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by its name: ``BENCHMARK.json`` names the cell's configuration
file and traffic mix, ``traffic/<mix>.json`` holds the mix,
``limits/<cell>.json`` the correctness limits, ``metrics/<metric>.py``
the reader of each metric and ``reference/<family>.py`` the plain
reference that the configuration file names.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from . import compare, readers, tracing, weights
from .traffic import WARMUP, Traffic

BENCH_DIR = "perfbench"
WHOLE_FROM = 8  # the first whole request compared is one of the first 8
FORBIDDEN = ("jax", "jaxlib", "flax", "embeddings_tpu")


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with the files it names."""
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    @property
    def model(self) -> dict:
        return self.config["model"]

    def reference(self):
        return importlib.import_module(
            f"{BENCH_DIR}.reference.{self.model['reference']}")


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    base = root / BENCH_DIR

    def applies(m: dict) -> bool:
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in names]
    return Cell(name, wl["chips"],
                json.loads((root / conf["file"]).read_text()),
                json.loads((base / "traffic" / f"{wl['traffic']}.json")
                           .read_text()),
                json.loads((base / "limits" / f"{name}.json").read_text()),
                e2e, layer, root)


def reader(root: Path, metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    return readers.load(root / BENCH_DIR / "metrics", metric)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(sd: dict) -> dict:
    """The state dict as numpy arrays on the host (one copy a tensor)."""
    return {k: v.cpu().numpy() for k, v in sd.items()}


def prepare(cell: Cell, seed: int, device, int8_compute: bool = False):
    """Weights from the seed, the Engine built from them, the traffic, and
    the warm-up: the mix's ``warmup_requests`` requests, drawn from a
    stream of their own, so that the window's shapes (every request holds
    the same lengths, so the same buckets or packed rows) have run and
    the window's own inputs have not. Returns (engine, traffic, seconds
    by phase)."""
    from . import program
    ref = cell.reference()
    t = {}
    t0 = time.perf_counter()
    if device.type == "cuda":
        program.build_kernels()
    t["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = _to_host(weights.make(ref.checkpoint_spec(cell.model["hf_config"]),
                               seed, device))
    t["weights_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = program.build_engine(cell.model, sd, device, int8_compute)
    del sd
    _sync(device)
    t["engine_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    traffic = Traffic(cell.mix, cell.model["tokens"], seed)
    t["traffic_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    call = entry(engine, cell.mix)
    for i in range(cell.mix["warmup_requests"]):
        call(traffic.request(i, WARMUP))
    _sync(device)
    t["warmup_s"] = time.perf_counter() - t0
    return engine, traffic, t


def settle() -> None:
    """Before a window: collect, then freeze what set-up left (the Engine's
    host tables, the warm-up's lists), so that the garbage collector's
    passes in the window scan only what the requests make."""
    gc.collect()
    gc.freeze()


def entry(engine, mix: dict):
    """The Engine entry the window drives, with the mix's arguments."""
    fn = getattr(engine, mix["entry"])
    kw = mix.get("engine_args", {})
    return lambda toks: fn(toks, **kw)


@dataclasses.dataclass
class Window:
    latencies_s: list
    tokens: list
    whole: list         # (request, served embeddings) of whole requests
    samples: list       # (token ids, served embedding) of single rows
    attempted: int
    failed: int
    window_s: float
    trace: dict | None = None


def drive(engine, traffic: Traffic, mix: dict, seed: int, seconds: float,
          trace: bool) -> Window:
    """The closed loop: one client makes a request (fresh inputs, see
    ``traffic``) and sends it, after the previous one has returned, for
    ``seconds`` (the last one started finishes inside the window). A
    request's latency runs from the call into the Engine to the return of
    its host array; making the request is outside it, inside the window. For the comparison, every answer of two whole
    requests is kept (one of the first ``WHOLE_FROM`` drawn from the
    seed, and the window's last), and from every request a few rows drawn
    from the seed and its longest. With ``trace``, a stretch of whole
    requests after ``trace.after_s`` of the window runs under the
    profiler, with the Engine's forwards recorded."""
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        raise ValueError("the harness drives a closed loop of one client")
    call = entry(engine, mix)
    pick = np.random.default_rng([seed, 1])
    k = mix["check_rows_per_request"]
    first = int(pick.integers(WHOLE_FROM))
    lat, toks, whole, samples = [], [], [], []
    last = None
    failed = 0
    i = 0
    traced = contextlib.nullcontext

    def one():
        nonlocal i, failed, last
        req = traffic.request(i)
        with traced():
            t0 = time.perf_counter()
            try:
                out = call(req)
            except Exception:  # a failed request counts, the loop goes on
                traceback.print_exc(file=sys.stderr)
                out = None
            t1 = time.perf_counter()
        i += 1
        if out is None:
            failed += 1
            return t1
        lat.append(t1 - t0)
        toks.append(traffic.tokens)
        if i - 1 == first:
            whole.append((req, out))
        else:
            last = (req, out)
        rows = set(pick.choice(len(req), size=min(k, len(req)),
                               replace=False).tolist())
        rows.add(max(range(len(req)), key=lambda r: len(req[r])))
        samples.extend((req[r], out[r].copy()) for r in sorted(rows))
        return t1

    t_first = time.perf_counter()
    deadline = t_first + seconds
    trace_at = t_first + min(mix["trace"]["after_s"], seconds / 3)
    t_end = t_first
    rec = None
    while t_end < deadline or (trace and rec is None):
        if trace and rec is None and time.perf_counter() >= trace_at:
            from . import program
            recorder = program.ForwardRecorder(engine)
            stretch = tracing.Stretch(mix["trace"]["stretch_s"])
            traced = lambda: record_function("perfbench.request")  # noqa
            with recorder.active():
                stretch.run(one)
            traced = contextlib.nullcontext
            rec = {"stretch": stretch, "forwards": recorder.forwards,
                   "counters": recorder.counters()}
            t_end = time.perf_counter()
            continue
        t_end = one()
    if last is not None:
        whole.append(last)
    window = Window(lat, toks, whole, samples, i, failed, t_end - t_first)
    if rec is not None:
        window.trace = {**rec.pop("stretch").reduce(), **rec}
    return window


def compared_rows(mix: dict, seed: int, win: Window) -> list:
    """(token ids, served embedding) of every row the reference checks:
    every answer of the window's whole requests, then a seeded draw of
    ``check_rows`` of the single rows, the window's longest sequence
    always among them."""
    rows = [(seq, out[r]) for req, out in win.whole
            for r, seq in enumerate(req)]
    samples = win.samples
    if not samples:
        return rows
    pick = np.random.default_rng([seed, 2])
    longest = max(range(len(samples)), key=lambda r: len(samples[r][0]))
    others = [r for r in range(len(samples)) if r != longest]
    take = pick.choice(len(others), replace=False, size=min(
        mix["check_rows"] - 1, len(others)))
    return rows + [samples[r] for r in [longest] + [
        others[j] for j in sorted(take.tolist())]]


def reference(cell: Cell, seed: int, rows: list, device):
    """The reference over ``rows``, from the same seed's weights made
    again: (served [N, E], reference [N, E])."""
    ref = cell.reference()
    hf = cell.model["hf_config"]
    sd = weights.make(ref.checkpoint_spec(hf), seed, device)
    head = {"pooling": cell.model["pooling"],
            "normalize": cell.model["normalize"]}
    want = ref.encode(sd, hf, head, [seq for seq, _ in rows], device)
    got = np.stack([emb for _, emb in rows])
    return got, want.cpu().numpy()


def check(cell: Cell, seed: int, rows: list, device) -> dict:
    """The compared numbers of ``rows`` (see ``reference``)."""
    return compare.numbers(*reference(cell, seed, rows, device))


def release(device) -> None:
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def record(cell: Cell, setup_s: float, win: Window) -> dict:
    """What the metric readers take."""
    ref = cell.reference()
    return {"setup_s": setup_s, "window_s": win.window_s,
            "latencies_s": win.latencies_s, "tokens": win.tokens,
            "widths": ref.widths(cell.model["hf_config"]),
            "trace": win.trace}


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX and the JAX package (compared whole: the port's name begins with
    the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, out=sys.stdout) -> int:
    """One run; prints the result line. ``t_start`` is the process's start
    on the ``time.time()`` clock."""
    engine, traffic, phases = prepare(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    settle()
    setup_s = time.time() - t_start
    win = drive(engine, traffic, cell.mix, seed, seconds, trace)
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    del engine
    release(device)
    rec = record(cell, setup_s, win)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(cell.root, m["name"])(rec)
        if value is None:  # BENCHMARK.json lists it for this cell
            print(f"refusing to report: metric {m['name']} read nothing in "
                  f"{cell.name}, which BENCHMARK.json lists it for",
                  file=sys.stderr)
            return 5
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t0 = time.perf_counter()
    rows = compared_rows(cell.mix, seed, win)
    values = check(cell, seed, rows, device)
    ref_s = time.perf_counter() - t0
    compared = compare.judge(values, cell.limits)
    correct = compare.passed(compared) and win.failed == 0 \
        and win.attempted > 0
    bad = forbidden_modules()
    if bad:
        print(f"refusing to report: loaded {', '.join(bad)}",
              file=sys.stderr)
        return 4
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics,
              "device": device_info}
    if trace and win.trace is not None:
        device_info["busy_s"] = win.trace["busy_s"]
        device_info["window_s"] = win.trace["window_s"]
        result["breakdown"] = win.trace["breakdown"]
    result["compared"] = compared
    lat = sorted(win.latencies_s) or [0.0]
    print(json.dumps({"setup_phases_s": phases, "setup_s": setup_s,
                      "window_s": win.window_s, "reference_s": ref_s,
                      "latency_ms": {q: lat[int(f * (len(lat) - 1))] * 1e3
                                     for q, f in (("min", 0), ("p50", .5),
                                                  ("p90", .9), ("max", 1))},
                      "latencies_ms": [round(x * 1e3, 1)
                                       for x in win.latencies_s],
                      "values": values,
                      "traced": None if win.trace is None else {
                          "forwards": len(win.trace["forwards"]),
                          **win.trace["counters"]},
                      "rows_compared": len(rows)}),
          file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, root: Path, t_start: float) -> int:
    args = parse(argv)
    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), t_start)
