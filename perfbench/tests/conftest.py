"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark
with its configurations cut to a tiny width, depth and vocabulary, its
mixes to a few small requests, run with the port's plain CPU path."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "bert": dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                 num_attention_heads=2, vocab_size=512,
                 max_position_embeddings=128),
    "nomic_bert": dict(n_embd=128, n_inner=256, n_layer=2, n_head=2,
                       vocab_size=512, num_experts=4),
}


def make_tiny_root(dest: Path) -> Path:
    """``dest`` holding BENCHMARK.json and a tiny copy of perfbench/."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dest / "perfbench" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        m = c["model"]
        m["hf_config"].update(TINY[m["reference"]])
        m["tokens"]["draw"] = [max(m["tokens"]["draw"][0], 4) % 256, 500]
        m["engine"] = {"batch_size": 16, "max_seq_len": 128}
        path.write_text(json.dumps(c))
    for path in (dest / "perfbench" / "traffic").glob("*.json"):
        m = json.loads(path.read_text())
        m["request_size"] = 128 if m["entry"].endswith("packed") else 32
        m.update(warmup_requests=1, check_rows=24, check_rows_per_request=4)
        m["lengths"]["max"] = min(m["lengths"]["max"], 128)
        path.write_text(json.dumps(m))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
