"""BENCHMARK.json keeps to the benchmark's contract: its keys, names and
units, each cell's metrics, and the files each entry names."""

import json
import re

import pytest

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"])
        assert LINE.match(c["source"]) and c["reduced"] == []
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and LINE.match(w["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
    assert layer and all(m["moves"] in e2e for m in layer)
    assert any("mfu" in m["name"] for m in layer)
