"""The traffic generator: the same seed gives the same requests, every
request the same lengths and fresh ids, and the lengths follow the mix
file."""

import json
import math
import statistics

import numpy as np
import pytest

from perfbench.traffic import WARMUP, WINDOW, Traffic, pool_lengths
from .conftest import ROOT

MIXES = sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json"))
TOKENS = {"cls": 101, "sep": 102, "draw": [999, 30522]}


def _mix(name):
    return json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = _mix(name)
    a, b = Traffic(mix, TOKENS, 2**31 + 11), Traffic(mix, TOKENS, 2**31 + 11)
    assert all(a.request(i) == b.request(i) for i in range(3))
    assert a.request(0, WARMUP) == b.request(0, WARMUP)


@pytest.mark.parametrize("name", MIXES)
def test_every_request_the_same_lengths_and_fresh_ids(name):
    """Every request of every seed holds the same lengths, in another
    order, and no request repeats another's ids: not the window's, not
    the warm-up's, not another seed's."""
    mix = _mix(name)
    reqs = [t.request(i, s) for t in (Traffic(mix, TOKENS, 5),
                                      Traffic(mix, TOKENS, 2**33 + 7))
            for i in range(3) for s in (WINDOW, WARMUP)]
    lens = [[len(q) for q in r] for r in reqs]
    assert all(sorted(x) == sorted(lens[0]) for x in lens)
    assert len({tuple(x) for x in lens}) == len(lens)
    bodies = {tuple(r[0][1:-1]) for r in reqs}
    assert len(bodies) == len(reqs)
    t = Traffic(mix, TOKENS, 5)
    assert t.tokens == sum(lens[0]) == sum(map(len, t.request(7)))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_the_mix(name):
    mix = _mix(name)
    lg = mix["lengths"]
    req = Traffic(mix, TOKENS, 3).request(0)
    assert len(req) == mix["request_size"]
    lens = np.array([len(s) for s in req])
    assert lens.min() >= lg["min"] and lens.max() <= lg["max"]
    assert abs(np.median(lens) - lg["median"]) <= 1
    # the log-normal's mean, exp(sigma^2 / 2) times its median, less the
    # clipped tail
    mean = lg["median"] * math.exp(lg["sigma"] ** 2 / 2)
    assert 0.9 * mean < lens.mean() < 1.02 * mean
    # log-lengths spread as sigma says (the clipping narrows it a little)
    assert 0.85 * lg["sigma"] < np.log(lens).std() < 1.05 * lg["sigma"]


def test_sequences_are_framed_and_drawn_from_the_range():
    mix = _mix("passages-512")
    t = Traffic(mix, TOKENS, 1)
    for s in t.request(0):
        assert s[0] == 101 and s[-1] == 102
        assert all(999 <= x < 30522 for x in s[1:-1])


def test_pool_lengths_are_quantiles():
    lens = pool_lengths({"dist": "lognormal", "median": 100, "sigma": 0.5,
                         "min": 1, "max": 10**6}, 1001)
    assert lens[500] == 100
    z = statistics.NormalDist().inv_cdf(900.5 / 1001)
    assert lens[900] == round(100 * math.exp(0.5 * z))
