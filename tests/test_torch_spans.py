"""The port's profiler spans (``embeddings_tpu_torch.utils.spans``), on the
CPU, with the tiny trained fixtures (a WordPiece BERT, given a random
classification head for rerank, and the MoE model).

(a) Under ``torch.profiler``, ``encode_toks``, ``encode_toks_packed`` and
    ``rerank`` each open one ``engine.call`` with plan, pad or pack,
    upload, ``model.forward``, read-back and scatter under it, once a
    batch; each upload closes before its forward opens, and
    ``model.forward``'s args are the batch that forward ran. Under a data
    mesh the same, the shards' copies inside the forward.
(b) With no profiler running, no range is entered (``record_function``
    and the spans' recorder patched to count), and the embeddings equal,
    bit for bit, those of a profiled call.
(c) ``NAMES`` lists every span the port emits. Each is a plain host op,
    not a user annotation, so the profiler draws no device-side copy of
    it across the kernels it launched.
(d) The benchmark's trace reduction (``perfbench.tracing``) names the
    device's idle gaps by the port's spans and counts none of them as
    device time.
(e) A DeepSeek-V2 forward (a tiny random one) opens ``mla_latent`` inside
    ``model.forward`` once a layer, and its shared expert's products run
    under ``moe_expert_gemm``.
"""

import collections
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from embeddings_tpu_torch import load_model
from embeddings_tpu_torch.parallel import make_mesh
from embeddings_tpu_torch.runtime.engine import Engine
from embeddings_tpu_torch.utils import spans
from embeddings_tpu_torch.utils.spans import NAMES

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "benchmarks" / "fixtures"
TEXTS = ["hello world", "profile me please", "a", "the quick brown fox "
         "jumps over the lazy dog again and again", "spans on the host",
         "one more sentence of a few words", "b c", "hello"]
QUERY = "hello world"
CPU = torch.autograd.DeviceType.CPU


@pytest.fixture(scope="module")
def engine():
    eng = load_model(FIXTURES / "tiny_trained" / "model", dtype="q4_0",
                     device="cpu")
    g = torch.Generator().manual_seed(0)
    eng.params["cls_head"] = {
        "out": {"w": torch.randn(eng.config.hidden_size, 1, generator=g),
                "b": torch.zeros(1)}}
    return eng


@pytest.fixture(scope="module")
def moe_engine():
    return load_model(FIXTURES / "tiny_trained_moe" / "model",
                      dtype="q4_0", device="cpu")


@pytest.fixture(scope="module")
def dsv2_engine():
    """DeepSeek-V2 at a tiny width (MLA, one dense and two MoE layers
    with a shared expert) from the benchmark reference's random weights."""
    from embeddings_tpu_torch import BertConfig, EngineConfig
    from embeddings_tpu_torch.models import params as P
    from perfbench import weights
    from perfbench.reference import deepseek_v2 as ref
    from perfbench.conftest import TINY_DEEPSEEK_V2
    hf = json.loads((ROOT / "perfbench" / "configs" /
                     "deepseek-v2-lite.json").read_text())["model"][
        "hf_config"]
    hf = {**hf, **TINY_DEEPSEEK_V2, "vocab_size": DSV2_EOS + 1}
    sd = weights.make(ref.checkpoint_spec(hf), 7, torch.device("cpu"))
    cfg = BertConfig.from_hf_dict(hf)
    tree = P.from_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    ids = types.SimpleNamespace(cls_id=DSV2_EOS - 1, sep_id=DSV2_EOS,
                                pad_id=DSV2_EOS, unk_id=DSV2_EOS)
    return Engine(P.quantize_params(tree, "q4_0"), cfg, ids,
                  EngineConfig(batch_size=4, max_seq_len=64), device="cpu")


DSV2_EOS = 100001
DSV2_TOKS = [[DSV2_EOS - 1, 5, 6, 7, DSV2_EOS], [DSV2_EOS - 1, 9, DSV2_EOS]]


@pytest.fixture(scope="module")
def toks(engine):
    return [engine.tokenize(t) for t in TEXTS]


# entry -> (the call, the forward it runs, the index of the mask or the
# segment ids among that forward's arguments after ids, packed, the span
# that prepares a batch)
ENTRIES = {
    "encode_toks": (lambda e, t: e.encode_toks(t, batch_size=4),
                    "_forward", 0, False, "engine.pad"),
    "encode_toks_packed": (lambda e, t: e.encode_toks_packed(
        t, row_len=16, batch_rows=2), "_forward_packed", 0, True,
        "engine.pack"),
    "rerank": (lambda e, t: e.rerank(QUERY, TEXTS, batch_size=4),
               "_forward_pairs", 1, False, "engine.pad"),
}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.device_type == CPU]


def _ancestor(event, name):
    event = event.cpu_parent
    while event is not None and event.name != name:
        event = event.cpu_parent
    return event


def _record_forwards(eng, method, real_at, packed, monkeypatch):
    """Patch ``eng``'s forward ``method`` to record each batch's args as
    ``model.forward`` should carry them."""
    seen = []
    fn = getattr(Engine, method).__get__(eng)

    def call(ids, *rest):
        real = rest[real_at]
        seen.append({"rows": ids.shape[0], "row_len": ids.shape[1],
                     "tokens": int(((real >= 0) if packed
                                    else (real != 0)).sum()),
                     "packed": packed})
        return fn(ids, *rest)
    monkeypatch.setattr(eng, method, call)
    return seen


def _by_name(events):
    by = collections.defaultdict(list)
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.name in NAMES:
            by[e.name].append(e)
    return by


def _check_call(events, seen, prep, upload=True):
    roots = [e for e in events if e.name == "engine.call"]
    assert len(roots) == 1 and _ancestor(roots[0], "engine.call") is None
    by = _by_name(events)
    phases = ["engine.plan", prep, "model.forward", "engine.readback",
              "engine.scatter"] + (["engine.upload"] if upload else [])
    for name in phases:
        assert by[name], name
        assert all(_ancestor(e, "engine.call") is roots[0]
                   for e in by[name]), name
    n = len(seen)
    assert n >= 2 and len(by["engine.plan"]) == 1
    for name in phases[1:]:
        assert len(by[name]) == n, name
    assert [dict(e.kwinputs) for e in by["model.forward"]] == seen
    if upload:
        for up, fw in zip(by["engine.upload"], by["model.forward"]):
            assert up.time_range.end <= fw.time_range.start
    else:
        assert not by["engine.upload"]


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_call_spans(engine, toks, entry, monkeypatch):
    call, method, real_at, packed, prep = ENTRIES[entry]
    seen = _record_forwards(engine, method, real_at, packed, monkeypatch)
    _, events = _profiled(lambda: call(engine, toks))
    _check_call(events, seen, prep)


@pytest.mark.parametrize("entry", ["encode_toks", "encode_toks_packed"])
def test_call_spans_under_a_mesh(toks, entry, monkeypatch):
    mesh = make_mesh(2, 1, [torch.device("cpu")] * 2)
    eng = load_model(FIXTURES / "tiny_trained" / "model", dtype="q4_0",
                     mesh=mesh)
    call, method, real_at, packed, prep = ENTRIES[entry]
    seen = _record_forwards(eng, method, real_at, packed, monkeypatch)
    _, events = _profiled(lambda: call(eng, toks))
    _check_call(events, seen, prep, upload=False)


def _every_entry(engine, moe_engine, toks):
    ids = np.asarray([toks[0] + [0] * (8 - len(toks[0]))], np.int32)
    mask = (np.arange(8) < len(toks[0])).astype(np.int32)[None]
    return [call(engine, toks) for call, *_ in ENTRIES.values()] + [
        engine.encode_batch(TEXTS), engine.encode_batch_packed(TEXTS),
        engine.forward(ids, mask), moe_engine.encode_toks(toks)]


def test_no_range_without_a_profiler(engine, moe_engine, toks,
                                     monkeypatch):
    entered = collections.Counter()

    class Counting:
        def __init__(self, name, *args):
            entered[name] += 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(spans, "_RecordFunctionFast", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    _every_entry(engine, moe_engine, toks)
    assert not entered
    # the control: with a profiler running, the spans go through the patch
    with profile(activities=[ProfilerActivity.CPU]):
        _every_entry(engine, moe_engine, toks)
    assert entered["engine.call"] >= 4 and entered["model.forward"] >= 4
    assert entered["moe_expert_gemm"] > 0


def test_embeddings_equal_with_spans_on_and_off(engine, moe_engine, toks):
    off = _every_entry(engine, moe_engine, toks)
    on, _ = _profiled(lambda: _every_entry(engine, moe_engine, toks))
    assert len(on) == len(off) == 7
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_names_list_every_span(engine, moe_engine, toks, dsv2_engine):
    _, events = _profiled(lambda: (_every_entry(engine, moe_engine, toks),
                                   dsv2_engine.encode_toks(DSV2_TOKS)))
    port = {e.name for e in events
            if e.name.startswith(("engine.", "model.", "moe_", "mla_"))}
    assert port == set(NAMES)
    for e in events:
        if e.name.startswith(("moe_", "mla_")):
            assert _ancestor(e, "model.forward") is not None
        if e.name == "engine.tokenize":  # encode_batch tokenizes first
            assert _ancestor(e, "model.forward") is None


def test_deepseek_v2_span_tree(dsv2_engine, monkeypatch):
    """``mla_latent`` once a layer inside each ``model.forward``; every
    product of the shared expert under ``moe_expert_gemm``."""
    from embeddings_tpu_torch.ops import moe
    linear = moe.linear

    def marked(*args, **kw):
        with record_function("test.shared_linear"):
            return linear(*args, **kw)
    monkeypatch.setattr(moe, "linear", marked)
    _, events = _profiled(lambda: dsv2_engine.encode_toks(DSV2_TOKS,
                                                          batch_size=1))
    forwards = [e for e in events if e.name == "model.forward"]
    latent = [e for e in events if e.name == "mla_latent"]
    NL = dsv2_engine.config.num_hidden_layers
    assert len(forwards) == 2 and len(latent) == 2 * NL
    assert all(_ancestor(e, "model.forward") in forwards for e in latent)
    shared = [e for e in events if e.name == "test.shared_linear"]
    # gate, up and down a MoE layer a forward
    assert len(shared) == 3 * 2 * (NL - 1)
    assert all(_ancestor(e, "moe_expert_gemm") is not None for e in shared)


def test_spans_are_host_ops_not_user_annotations(engine, toks):
    def run():
        with record_function("user.range"):
            engine.encode_toks(toks)
    _, events = _profiled(run)
    user = [e for e in events if e.name == "user.range"]
    assert len(user) == 1 and user[0].is_user_annotation  # the control
    ours = [e for e in events if e.name in NAMES]
    assert ours and not any(e.is_user_annotation for e in ours)
    assert {e.scope for e in ours} == {0}  # RecordScope::FUNCTION


def test_span_args_only_while_profiling(engine, toks, monkeypatch):
    calls = []
    fn = spans.span

    def span(name, args=None):
        calls.append((name, args))
        return fn(name, args)
    monkeypatch.setattr("embeddings_tpu_torch.runtime.engine.span", span)
    engine.encode_toks(toks)
    assert calls and all(a is None for _, a in calls)
    assert spans.span("engine.call") is spans.span("model.forward")


# -- the benchmark's trace reduction over the port's spans ------------------

def _event(name, start, end, device=False, eid=0, parent=None):
    return types.SimpleNamespace(
        name=name, id=eid, cpu_parent=parent,
        time_range=types.SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if device else CPU))


def test_benchmark_names_idle_gaps_by_the_ports_spans():
    from perfbench import tracing
    assert set(tracing.SPANS) <= set(NAMES)  # the MoE spans it reads
    stretch = _event(tracing.STRETCH, 0, 1000)
    req = _event("perfbench.request", 10, 990)
    call = _event("engine.call", 20, 980, parent=req)
    plan = _event("engine.plan", 30, 205, parent=call)
    pack = _event("engine.pack", 205, 400, parent=call)
    upload = _event("engine.upload", 400, 420, parent=call)
    copy = _event("cudaMemcpyAsync", 405, 410, eid=1, parent=upload)
    fwd = _event("model.forward", 420, 700, parent=call)
    moe = _event("moe_dispatch", 430, 440, parent=fwd)
    launch = _event("cudaLaunchKernel", 433, 436, eid=2, parent=moe)
    readback = _event("engine.readback", 700, 900, parent=call)
    back = _event("cudaMemcpyAsync", 701, 899, eid=3, parent=readback)
    scatter = _event("engine.scatter", 900, 970, parent=call)
    events = [stretch, req, call, plan, pack, upload, copy, fwd, moe, launch,
              readback, back, scatter,
              _event("Memcpy HtoD", 405, 415, True, eid=1),
              _event("indexFunc", 450, 880, True, eid=2),
              _event("Memcpy DtoH", 885, 895, True, eid=3)]
    rec = tracing.reduce_events(events)
    # busy: [405, 415] + [450, 880] + [885, 895]; the spans add nothing
    assert rec["busy_s"] == pytest.approx(450e-6)
    assert {o["name"]: o["span"] for o in rec["device_ops"]}["indexFunc"] \
        == "moe_dispatch"
    gaps = dict(rec["breakdown"]["idle_gaps"])
    # each gap by the innermost host op at its middle: 202.5, 432.5 (before
    # the launch), 882.5 (in the read-back's copy), 947.5
    assert gaps == pytest.approx({"engine.plan": 405e-6,
                                  "moe_dispatch": 35e-6,
                                  "cudaMemcpyAsync": 5e-6,
                                  "engine.scatter": 105e-6})
    assert not set(gaps) & set(tracing.GAP_LABELS.values())
