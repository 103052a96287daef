"""The command itself: it refuses to run, and prints no result, without
the card the cell asks for, and without the program beside it."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from .conftest import ROOT


def _run(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "bge-base.passages", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_json_names_files_under_paths():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["perfbench"]
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
