"""The plain references against the port's plain CPU path at a tiny
size (the BERT block, and nomic-bert's with its experts), and the
reference's q4_0 codec against the port's."""


import numpy as np
import pytest
import torch

from perfbench import compare, weights
from perfbench.harness import load_cell
from perfbench.reference.common import q4_0_roundtrip

CELLS = ["bge-base.passages", "nomic-v2-moe.passages",
         "bge-base.queries-packed"]


def test_codec_matches_the_port():
    from embeddings_tpu_torch.ops.quant import dequantize_np, quantize
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 96), dtype=np.float32) * np.float32(0.02)
    w[:32, 0] = 0.0  # a block of zeros
    qt = quantize(w, "q4_0")  # blocks along K (axis -2)
    port = dequantize_np(qt.codes.numpy(), qt.scales.numpy(), None, "q4_0")
    ours = q4_0_roundtrip(torch.from_numpy(w.T.copy())).numpy().T
    np.testing.assert_array_equal(ours, port)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(tiny_root, name):
    """Served by the Engine (the plain versions of the kernels, bf16 inputs
    to the products) against the reference in f32: within a cosine gap of
    1e-6; a reference on other weights is far outside it."""
    from perfbench import program
    cell = load_cell(tiny_root, name)
    ref = cell.reference()
    hf = cell.model["hf_config"]
    cpu = torch.device("cpu")
    sd = weights.make(ref.checkpoint_spec(hf), 42, cpu)
    engine = program.build_engine(
        cell.model, {k: v.numpy() for k, v in sd.items()}, cpu)
    rng = np.random.default_rng(1)
    lo, hi = cell.model["tokens"]["draw"]
    seqs = [[cell.model["tokens"]["cls"], *rng.integers(lo, hi, n).tolist(),
             cell.model["tokens"]["sep"]] for n in (3, 9, 30, 61, 100)]
    got = getattr(engine, cell.mix["entry"])(seqs,
                                             **cell.mix.get("engine_args", {}))
    head = {"pooling": cell.model["pooling"],
            "normalize": cell.model["normalize"]}
    want = ref.encode(sd, hf, head, seqs, cpu).numpy()
    assert compare.numbers(got, want)["cos_gap_max"] < 1e-6
    other = ref.encode(weights.make(ref.checkpoint_spec(hf), 43, cpu), hf,
                       head, seqs, cpu).numpy()
    assert compare.numbers(got, other)["cos_gap_mean"] > 1e-2


def test_reference_batching_is_exact():
    """Sequences padded together give what each gives alone."""
    from perfbench.reference import common
    calls = []

    def fn(ids, ok):
        calls.append(ids.shape)
        return (ids * ok).sum(1, keepdim=True).float()
    seqs = [[1, 2], [3, 4, 5], [6]]
    out = common.batched(seqs, fn, "cpu", max_tokens=6)
    assert out[:, 0].tolist() == [3.0, 12.0, 6.0]
    assert all(b * l <= 6 for b, l in calls)
