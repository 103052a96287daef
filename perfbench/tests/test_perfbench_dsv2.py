"""The DeepSeek-V2 cell's pieces on the CPU at a tiny size: the plain
reference against the port, the configuration file against what the
harness reads, the two new readers on a recorded forward, and
``costs_deepseek_v2``'s arithmetic against a hand count."""

import json
import time

import numpy as np
import pytest
import torch

from perfbench import compare, costs, costs_deepseek_v2, harness, weights
from perfbench.readers import load

from .conftest import ROOT

CELL = "dsv2-lite.long-docs"
CPU = torch.device("cpu")


def _tiny_cell(tiny_root):
    cell = harness.load_cell(tiny_root, CELL)
    assert cell.model["reference"] == "deepseek_v2"
    return cell


def test_configuration_file():
    """The catalog's keys at the file's top level, the same ones the
    harness reads under model.hf_config; only the depth is cut."""
    c = json.loads((ROOT / "perfbench/configs/deepseek-v2-lite.json")
                   .read_text())
    hf = c["model"]["hf_config"]
    assert c["reduced"] == ["num_hidden_layers"]
    assert {k: c[k] for k in hf} == hf
    assert hf["num_hidden_layers"] == 12 and hf["first_k_dense_replace"] == 1
    assert (hf["hidden_size"], hf["n_routed_experts"],
            hf["num_experts_per_tok"], hf["moe_intermediate_size"],
            hf["kv_lora_rank"], hf["vocab_size"]) == (2048, 64, 6, 1408,
                                                      512, 102400)
    tok = c["model"]["tokens"]
    assert tok["draw"][1] <= tok["cls"] < tok["sep"] < hf["vocab_size"]


def test_reference_agrees_with_the_port(tiny_root):
    """Served by the Engine (bf16 inputs to the q4_0 products, f32
    activations) against the f32 reference: a cosine gap under 1e-4 (read
    ~1e-5); a reference on other weights is far outside it."""
    from perfbench import program
    cell = _tiny_cell(tiny_root)
    ref = cell.reference()
    hf = cell.model["hf_config"]
    sd = weights.make(ref.checkpoint_spec(hf), 42, CPU)
    engine = program.build_engine(
        cell.model, {k: v.numpy() for k, v in sd.items()}, CPU)
    rng = np.random.default_rng(1)
    tok = cell.model["tokens"]
    seqs = [[tok["cls"], *rng.integers(*tok["draw"], n).tolist(),
             tok["sep"]] for n in (3, 40, 100, 126)]
    got = engine.encode_toks(seqs)
    head = {"pooling": "lasttoken", "normalize": True}
    want = ref.encode(sd, hf, head, seqs, CPU).numpy()
    assert compare.numbers(got, want)["cos_gap_max"] < 1e-4
    other = ref.encode(weights.make(ref.checkpoint_spec(hf), 43, CPU), hf,
                       head, seqs, CPU).numpy()
    assert compare.numbers(got, other)["cos_gap_mean"] > 1e-2


def test_a_run_on_the_cpu_is_correct(tiny_root):
    import io
    cell = _tiny_cell(tiny_root)
    out = io.StringIO()
    assert harness.run_cell(cell, 2**31 + 99, 1.0, False, CPU, time.time(),
                            out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line["metrics"]) == {"moe.tokens_per_s",
                                    "moe.request_p95_ms", "setup_s"}
    assert line["correct"] and line["attempted"] > 0


def _recorded(tiny_root):
    """A recorded stretch of the tiny cell on the CPU, with one MLA
    kernel op of 1 ms a layer and forward added (the CPU has none), and
    the record the readers take."""
    cell = _tiny_cell(tiny_root)
    engine, traffic, _ = harness.prepare(cell, 5, CPU)
    win = harness.drive(engine, traffic, cell.mix, 5, 0.3, True)
    tr = win.trace
    NL = cell.model["hf_config"]["num_hidden_layers"]
    ops = [{"name": "void attn_sm90_kernel_mla<192, 128>(x)",
            "start": 1000.0 * i, "end": 1000.0 * (i + 1), "span": None}
           for i in range(NL * len(tr["forwards"]))]
    win.trace = {**tr, "device_ops": tr["device_ops"] + ops}
    return cell, harness.record(cell, 1.0, win)


def test_readers_on_a_recorded_forward(tiny_root):
    cell, rec = _recorded(tiny_root)
    tr, w = rec["trace"], rec["widths"]
    fw = tr["forwards"]
    assert fw and all(f["L"] % 128 == 0 for f in fw)
    mfu = load(ROOT / "perfbench/metrics", "dsv2.device.mfu")(rec)
    flops = costs_deepseek_v2.model_flops(
        [n for f in fw for n in f["lengths"]], w)
    assert mfu == pytest.approx(
        100 * flops / (tr["window_s"] * costs.PEAK_BF16_FLOPS))
    roof = load(ROOT / "perfbench/metrics",
                "dsv2.kernels.attention_roofline")(rec)
    bound = sum(w["num_hidden_layers"] * costs.bound_ms(
        *costs_deepseek_v2.mla_attention_cost(f["lengths"], f["B"], w))[0]
        for f in fw)
    ms = w["num_hidden_layers"] * len(fw) * 1.0
    assert roof == pytest.approx(100 * bound / ms)
    # a BERT cell's widths (the parent's readers) or no kernel: nothing
    bert = {**rec, "widths": {"hidden_size": 64}}
    assert load(ROOT / "perfbench/metrics", "dsv2.device.mfu")(bert) is None
    none = {**rec, "trace": {**tr, "device_ops": []}}
    assert load(ROOT / "perfbench/metrics",
                "dsv2.kernels.attention_roofline")(none) is None


def test_costs_against_a_hand_count():
    """One causal row of 3 tokens at DeepSeek-V2-Lite's widths, counted
    by hand in multiply-adds times two."""
    c = json.loads((ROOT / "perfbench/configs/deepseek-v2-lite.json")
                   .read_text())
    from perfbench.reference import deepseek_v2
    w = deepseek_v2.widths(c["model"]["hf_config"])
    proj = 2 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    dense = 2 * 3 * 2048 * 10944
    moe = 2 * (2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816)
    pairs = 1 + 2 + 3
    per_pair = 2 * 16 * (192 + 128)
    want = 3 * (12 * proj + dense + 11 * moe) + 12 * pairs * per_pair
    assert costs_deepseek_v2.model_flops([3], w) == want
    assert proj == 27_525_120 and moe == 138_674_176
    flops, nbytes = costs_deepseek_v2.mla_attention_cost([3, 0], 2, w)
    assert flops == pairs * per_pair
    assert nbytes == 3 * 16 * (2 * 192 + 128) * 2 + 3 * 16 * 128 * 2 + 8
