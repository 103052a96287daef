"""A run drives the timed path with a fault planted underneath, past the
look for a card, and ``correct`` comes out false; without the fault it
comes out true. Faults an embedding cell on one card can have: an answer
altered where it is produced; half of a batch left out, its rows given
the mean of the rest; a forward that hands back its previous result (its
state unchanged). The cell's own limits are the ones held.

At this tiny width a model at its initial scale (weights of std 0.02)
gives nearly the same CLS row for every input (1 - cos 5e-5 between
distinct passages), so a stale or swapped answer would pass unseen; at
bge-base's width the rows are 5e-3 to 1e-2 apart. The tiny model here
takes weights of std 0.1, at which its rows are 2e-2 to 8e-2 apart."""

import io
import json
import time

import numpy as np
import pytest
import torch

from perfbench import harness, program, weights
from embeddings_tpu_torch.runtime.engine import Engine

CELLS = ["bge-base.passages", "nomic-v2-moe.passages",
         "bge-base.queries-packed"]


def altered(fn):
    def call(*args):
        out = fn(*args).clone()
        out[0] = out[0].roll(1, -1)  # row 0 (packed: its first slots)
        return out
    return call


def half_left_out(fn):
    def call(ids, *rest):
        h = max(1, ids.shape[0] // 2)
        out = fn(ids[:h], *(r[:h] if isinstance(r, np.ndarray) else r
                            for r in rest))
        fill = out.mean(0, keepdim=True).expand(ids.shape[0] - h,
                                                *out.shape[1:])
        return torch.cat([out, fill])
    return call


def stale(fn):
    held = []

    def call(*args):
        out = fn(*args)
        if held and held[0].shape == out.shape:
            return held[0]
        held[:] = [out]
        return out
    return call


FAULTS = {"altered": altered, "half_left_out": half_left_out,
          "stale": stale}


def run(root, name, monkeypatch, fault=None) -> dict:
    monkeypatch.setattr(weights, "STD", 0.1)
    build = program.build_engine

    def broken(*args, **kw):
        eng = build(*args, **kw)
        if fault is not None:
            eng._forward = fault(Engine._forward.__get__(eng))
            eng._forward_packed = fault(Engine._forward_packed.__get__(eng))
        return eng
    monkeypatch.setattr(program, "build_engine", broken)
    out = io.StringIO()
    cell = harness.load_cell(root, name)
    assert harness.run_cell(cell, 2**32 + 3, 1.0, False, torch.device("cpu"),
                            time.time(), out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_root, monkeypatch, name):
    assert run(tiny_root, name, monkeypatch)["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny_root, monkeypatch, name, fault):
    line = run(tiny_root, name, monkeypatch, FAULTS[fault])
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["compared"].values())
