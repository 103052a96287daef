"""A later change adds a traffic mix, a per-layer metric or a cell as
files alone: the harness finds each by its name, and a run reports the
new metric; and a run's result line has the contract's keys."""

import io
import json
import time

import numpy as np
import pytest
import torch

from perfbench import harness


def test_a_new_mix_metric_and_cell_are_found_by_name(tiny_root):
    bench_dir = tiny_root / "perfbench"
    mix = json.loads((bench_dir / "traffic" / "passages-256.json")
                     .read_text())
    mix.update(request_size=16, lengths=dict(mix["lengths"], median=20))
    (bench_dir / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "dummy.requests.py").write_text(
        "def read(rec):\n"
        "    tr = rec['trace']\n"
        "    return float(len(tr['forwards'])) if tr else None\n")
    (bench_dir / "limits" / "bge-base.dummy.json").write_text(
        (bench_dir / "limits" / "bge-base.passages.json").read_text())
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "bge-base.dummy",
                               "config": "bge-base-en-v1.5",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("tokens_per_s", "request_p95_ms"):
            m["workloads"].append("bge-base.dummy")
    bench["per_layer"].append({"name": "dummy.requests", "unit": "count",
                               "better": "higher", "source": "device_trace",
                               "layer": "engine", "moves": "tokens_per_s",
                               "workloads": ["bge-base.dummy"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(tiny_root, "bge-base.dummy")
    assert cell.mix["request_size"] == 16
    assert [m["name"] for m in cell.per_layer] == ["dummy.requests"]
    out = io.StringIO()
    assert harness.run_cell(cell, 7, 1.0, True, torch.device("cpu"),
                            time.time(), out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "compared"]
    assert line["correct"] is True
    assert line["metrics"]["dummy.requests"]["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s",
                                   "window_s"}


def test_untraced_run_reports_the_end_to_end_metrics(tiny_root):
    cell = harness.load_cell(tiny_root, "bge-base.queries-packed")
    out = io.StringIO()
    assert harness.run_cell(cell, 2**31 + 5, 1.0, False,
                            torch.device("cpu"), time.time(), out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line["metrics"]) == {"queries.tokens_per_s",
                                    "queries.request_p95_ms", "setup_s"}
    assert line["correct"] and line["attempted"] > 0 and not line["failed"]


def test_a_listed_metric_that_reads_nothing_refuses_the_run(tiny_root):
    """A metric BENCHMARK.json lists for the cell whose reader finds
    nothing (as when a change routes the forwards around what it reads)
    fails the run: no result line, a non-zero exit."""
    (tiny_root / "perfbench" / "metrics" / "setup_s.py").write_text(
        "def read(rec):\n    return None\n")
    cell = harness.load_cell(tiny_root, "bge-base.passages")
    out = io.StringIO()
    assert harness.run_cell(cell, 11, 1.0, False, torch.device("cpu"),
                            time.time(), out=out) == 5
    assert out.getvalue() == ""


def test_a_stretch_with_no_recorded_forward_fails(tiny_root, monkeypatch):
    """The recorder wraps Engine._forward and _forward_packed; an entry
    that no longer calls them fails the traced run instead of leaving
    its per-layer metrics out."""
    from embeddings_tpu_torch.runtime.engine import Engine
    monkeypatch.setattr(Engine, "encode_toks",
                        lambda self, toks, **kw: np.zeros(
                            (len(toks), self.n_embd), np.float32))
    cell = harness.load_cell(tiny_root, "bge-base.passages")
    with pytest.raises(RuntimeError, match="no Engine forward"):
        harness.run_cell(cell, 13, 1.0, True, torch.device("cpu"),
                         time.time(), out=io.StringIO())
