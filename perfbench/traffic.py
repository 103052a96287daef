"""The one traffic generator: a mix file's parameters in, requests of
token-id sequences out.

Every request holds the same multiset of sequence lengths: the
``request_size`` lengths at evenly spaced quantiles of the mix's clipped
log-normal, so the work of a request, and of a run, does not depend on
the seed. Request ``i`` of a stream is made when it is asked for, from
(seed, stream, i): the lengths in another order and fresh token ids
(uniform over the configuration's ``draw`` range, between its CLS and SEP
ids). No request repeats another, so the window never sends input that
set-up or an earlier call has run; the warm-up draws from a stream of its
own.
"""

from __future__ import annotations

import statistics

import numpy as np

WINDOW, WARMUP = 0, 1  # the streams


def pool_lengths(lengths: dict, n: int) -> np.ndarray:
    """n lengths at the quantiles (i + 0.5) / n of a log-normal with the
    given median and sigma, rounded and clipped to [min, max]."""
    if lengths["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {lengths['dist']!r}")
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    raw = lengths["median"] * np.exp(lengths["sigma"] * z)
    return np.clip(np.rint(raw), lengths["min"], lengths["max"]).astype(
        np.int64)


class Traffic:
    """The requests of one run: ``request(i)`` is the i-th request of the
    closed loop (a list of token-id lists); every request holds
    ``tokens`` real tokens."""

    def __init__(self, mix: dict, tokens: dict, seed: int):
        self.mix = mix
        self.seed = seed
        self.lengths = pool_lengths(mix["lengths"], mix["request_size"])
        self.tokens = int(self.lengths.sum())
        self._cls, self._sep = tokens["cls"], tokens["sep"]
        self._draw = tokens["draw"]

    def request(self, i: int, stream: int = WINDOW) -> list[list[int]]:
        rng = np.random.default_rng([self.seed, stream, i])
        lens = rng.permutation(self.lengths)
        ids = rng.integers(*self._draw, size=self.tokens, dtype=np.int64)
        ends = np.cumsum(lens)
        starts = ends - lens
        ids[starts] = self._cls
        ids[ends - 1] = self._sep
        flat = ids.tolist()
        return [flat[a:b] for a, b in zip(starts.tolist(), ends.tolist())]
