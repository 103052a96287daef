"""Each metric reader on a synthetic record whose answer is known, and
the trace reduction on synthetic profiler events."""

import types

import pytest
import torch

from perfbench import costs, tracing
from perfbench.harness import reader
from .conftest import ROOT

K1 = "void (anonymous namespace)::qmm_wgmma_kernel<4, false>(x)"
ATT = "void attn_sm90_kernel<64, 6, 2, 0, 0>(y)"


def _op(name, start, end, span=None):
    return {"name": name, "start": start, "end": end, "span": span}


def _record():
    fw = [{"packed": False, "B": 4, "L": 8, "lengths": [8, 4, 2],
           "k1": {(768, 2304, "bias"): 2}, "attention": 2},
          {"packed": True, "B": 2, "L": 16, "lengths": [10, 6, 16],
           "k1": {(768, 768, "bias_residual_ln"): 1}, "attention": 1}]
    ops = [_op(K1, 0, 100), _op(ATT, 100, 150), _op("mm_kernel", 200, 300,
                                                     "moe_expert_gemm"),
           _op("index_add", 300, 350, "moe_dispatch"),
           _op("copy", 350, 400)]
    trace = {"window_s": 800e-6, "busy_s": 400e-6, "device_ops": ops,
             "forwards": fw}
    return {"setup_s": 12.5, "window_s": 2.0,
            "latencies_s": [i / 100 for i in range(1, 101)],
            "tokens": [1000] * 100,
            "widths": {"hidden_size": 768, "intermediate_size": 3072,
                       "num_hidden_layers": 12}, "trace": trace}


def read(name, rec):
    return reader(ROOT, name)(rec)


def test_end_to_end_readers():
    rec = _record()
    assert read("tokens_per_s", rec) == 100 * 1000 / 2.0
    assert read("queries.tokens_per_s", rec) == 100 * 1000 / 2.0
    assert read("moe.tokens_per_s", rec) == 100 * 1000 / 2.0
    assert read("moe.request_p95_ms", rec) == pytest.approx(950.0)
    assert read("request_p95_ms", rec) == pytest.approx(950.0)
    assert read("setup_s", rec) == 12.5


def test_pad_share():
    slots, real = 4 * 8 + 2 * 16, 14 + 32
    assert read("engine.pad_share", _record()) == \
        pytest.approx(100 * (1 - real / slots))


def test_device_shares():
    rec = _record()
    assert read("device.idle_share", rec) == pytest.approx(50.0)
    # everything but K1 and the attention kernel: 200 of 400 busy us
    assert read("model.torch_ops_share", rec) == pytest.approx(50.0)
    assert read("model.moe_share", rec) == pytest.approx(37.5)


def test_moe_share_reads_nothing_without_moe_spans():
    rec = _record()
    for o in rec["trace"]["device_ops"]:
        o["span"] = None
    assert read("model.moe_share", rec) is None


def test_rooflines():
    rec = _record()
    k1 = 2 * costs.bound_ms(*costs.k1_cost(32, 768, 2304, "bias"))[0] \
        + costs.bound_ms(*costs.k1_cost(32, 768, 768,
                                        "bias_residual_ln"))[0]
    assert read("kernels.qmatmul_roofline", rec) == \
        pytest.approx(100 * k1 / 0.1)
    att = 2 * costs.bound_ms(*costs.attention_cost(
        [8, 4, 2], 768, 32, False))[0] + costs.bound_ms(
        *costs.attention_cost([10, 6, 16], 768, 32, True))[0]
    assert read("kernels.attention_roofline", rec) == \
        pytest.approx(100 * att / 0.05)


def test_mfu():
    rec = _record()
    flops = costs.model_flops([8, 4, 2, 10, 6, 16], rec["widths"])
    assert read("device.mfu", rec) == \
        pytest.approx(100 * flops / (800e-6 * costs.PEAK_BF16_FLOPS))


@pytest.mark.parametrize("name", ["engine.pad_share", "model.torch_ops_share",
                                  "kernels.qmatmul_roofline",
                                  "kernels.attention_roofline",
                                  "device.idle_share", "device.mfu"])
def test_per_layer_readers_read_nothing_untraced(name):
    assert read("queries." + name, dict(_record(), trace=None)) is None
    assert read("moe." + name, dict(_record(), trace=None)) is None
    assert read(name, dict(_record(), trace=None)) is None


def _event(name, start, end, device, eid=0, parent=None):
    return types.SimpleNamespace(
        name=name, id=eid, cpu_parent=parent,
        time_range=types.SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU))


def test_reduce_events():
    stretch = _event(tracing.STRETCH, 100, 1100, False)
    req = _event("perfbench.request", 110, 1090, False)
    span = _event("moe_dispatch", 150, 250, False, parent=req)
    op = _event("aten::index_add_", 160, 200, False, parent=span)
    launch = _event("cudaLaunchKernel", 170, 180, False, eid=7, parent=op)
    events = [stretch, req, span, op, launch,
              _event("indexFunc", 400, 500, True, eid=7),
              _event(K1, 50, 200, True, eid=8),        # clipped to 100
              _event(ATT, 450, 700, True, eid=9),      # overlaps the first
              _event("Memcpy DtoH", 1050, 1200, True, eid=10),
              _event("moe_dispatch", 400, 500, True)]  # a span's copy
    rec = tracing.reduce_events(events)
    assert rec["window_s"] == pytest.approx(1000e-6)
    # busy: [100, 200] + [400, 700] + [1050, 1100]
    assert rec["busy_s"] == pytest.approx(450e-6)
    spans = {o["name"]: o["span"] for o in rec["device_ops"]}
    assert spans["indexFunc"] == "moe_dispatch" and spans[ATT] is None
    names = [n for n, _ in rec["breakdown"]["device_ops"]]
    assert "qmm_wgmma_kernel<4, false>" in names
    gaps = dict(rec["breakdown"]["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(550e-6)
    assert gaps[tracing.GAP_LABELS["perfbench.request"]] == \
        pytest.approx(550e-6)
