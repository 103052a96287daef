"""Batch planning: length-sorted micro-batching with bucketed padding.

The reference's entire batching strategy is ``bert_encode_batch``
(its bert.cpp:1374-1444): tokenize everything, argsort by token
count ascending, chunk into fixed-size batches, scatter results back. That
minimizes padding waste but gives every chunk a different max-length —
free for ggml (graph rebuilt per shape), but every new shape costs a
compile (XLA) or a fresh graph capture and allocator churn here.

This version keeps the length sorting but snaps each chunk's sequence
length to a small closed set of buckets (powers of two up to max_seq_len),
and optionally snaps the tail chunk's batch size to batch buckets, so the
number of distinct padded shapes is bounded by |seq_buckets| x |batch_buckets|.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


def pick_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value (buckets sorted ascending)."""
    if not buckets:
        raise ValueError("empty bucket set")
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"value {value} exceeds largest bucket {buckets[-1]}")


def extend_buckets(buckets: Sequence[int], cover: int) -> tuple[int, ...]:
    """Buckets extended by doubling so the largest one >= cover (the
    result is never empty: an empty input yields at least (1,))."""
    bb = sorted(set(int(b) for b in buckets))
    if not bb:
        bb = [1]
    b = bb[-1]
    while b < cover:
        b = min(b * 2, cover)
        bb.append(b)
    return tuple(bb)


@dataclass(frozen=True)
class BatchPlan:
    """One device batch: original indices + padded shape to run."""
    indices: tuple[int, ...]   # positions in the caller's input list
    batch: int                 # padded batch size (>= len(indices))
    seq: int                   # padded sequence length bucket


def plan_batches(lengths: Sequence[int], batch_size: int,
                 seq_buckets: Sequence[int],
                 batch_buckets: Sequence[int] | None = None) -> list[BatchPlan]:
    """Length-sorted chunking (bert.cpp:1424-1442 semantics) with bucketed
    shapes. Returns plans covering every input index exactly once."""
    n = len(lengths)
    if n == 0:
        return []
    order = sorted(range(n), key=lambda i: lengths[i])  # ascending, like ref
    plans: list[BatchPlan] = []
    for start in range(0, n, batch_size):
        chunk = order[start:start + batch_size]
        seq = pick_bucket(max(lengths[i] for i in chunk), seq_buckets)
        b = len(chunk)
        if batch_buckets is not None:
            b = pick_bucket(b, batch_buckets)
        plans.append(BatchPlan(tuple(chunk), b, seq))
    return plans


def pad_batch(token_lists: Sequence[Sequence[int]], batch: int, seq: int,
              pad_id: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack token lists into padded (ids, mask) int32 arrays of shape
    [batch, seq]. Rows beyond len(token_lists) are all-pad (mask 0)."""
    ids = np.full((batch, seq), pad_id, np.int32)
    mask = np.zeros((batch, seq), np.int32)
    for i, toks in enumerate(token_lists):
        L = min(len(toks), seq)
        ids[i, :L] = toks[:L]
        mask[i, :L] = 1
    return ids, mask
