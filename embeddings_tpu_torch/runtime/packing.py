"""Token-level packing: many sentences per device row — the port's own
copy of ``embeddings_tpu/runtime/packing.py`` (numpy only).

Bucketed padding (batching.py) wastes tensor-core cycles whenever
sentences are much shorter than the efficient device sequence length — the
card prefers a few long rows over many short ones. Packing places multiple
sentences back-to-back in one [L] row; correctness is preserved by

- segment ids: attention is masked to within-segment pairs (the packed
  analogue of the reference's pad mask, bert.cpp:957-961),
- per-segment position ids: each sentence's positions restart at 0,
- pooling-by-matmul: a host-built [S, L] weight matrix (1/len over the
  segment for mean pooling, a single 1 at the segment start for CLS)
  pools every segment in one einsum — the generalization of the
  reference's 1/len pooling-matmul trick (bert.cpp:905-922, 1087-1089).

The planner is best-fit-decreasing: sentences sorted by length, each
placed into the open row with the tightest remaining capacity that still
fits, rows grouped into device batches. The caller fixes the row length
and the segments per row, so the set of shapes stays small. The plan and
the rows are built as arrays: the planner's loop runs once per (row, run
of equal lengths) placement over plain integers, and ``materialize``
writes a batch with flat indexing, never once per sentence.
"""

from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..ops.attention import BQ


@dataclass(frozen=True)
class Segment:
    sentence: int   # index into the caller's input list
    start: int      # token offset within the row
    length: int


@dataclass
class PackedBatch:
    """One device batch of packed rows: its segments as arrays, ordered
    by row and, within a row, by slot."""
    sentence: np.ndarray        # [M] index into the caller's input list
    row: np.ndarray             # [M] row within the batch
    slot: np.ndarray            # [M] segment slot within its row
    start: np.ndarray           # [M] token offset within the row
    length: np.ndarray          # [M]
    n_rows: int                 # rows that hold segments
    batch: int                  # padded row count
    seq: int                    # row length
    n_seg: int                  # padded max segments per row

    @property
    def rows(self) -> list[list[Segment]]:
        """Per row: its segments (built from the arrays on each read)."""
        rows: list[list[Segment]] = [[] for _ in range(self.n_rows)]
        for i, r, a, n in zip(self.sentence.tolist(), self.row.tolist(),
                              self.start.tolist(), self.length.tolist()):
            rows[r].append(Segment(i, a, n))
        return rows


def plan_packing(lengths: Sequence[int], row_len: int, batch_rows: int,
                 max_segs: int) -> list[PackedBatch]:
    """Best-fit-decreasing packing of sentence lengths into rows of
    row_len tokens, grouped into batches of at most batch_rows rows.

    Sentences are taken longest first (a stable sort: equal lengths in
    input order); each goes to the open row with the smallest remaining
    capacity that fits it, the lowest row index among equal capacities,
    else opens a row. Open rows are kept as integer keys capacity * K +
    row in a sorted list (a naive first-fit scan is O(n*rows) — hours of
    host time on retrieval-scale corpora). A run of equal lengths is
    placed a row at a time: the row that takes one sentence of the run
    stays the tightest fit for the next until it is full, so it takes
    as many as fit at once, with the same result as one at a time.

    max_segs caps segments per row AND pins every batch's n_seg to that
    exact value — serving needs one stable (rows, n_seg, row_len) shape
    family (each new shape is a fresh set of allocations)."""
    lengths = np.asarray(lengths, np.int64)
    if (lengths <= 0).any():
        raise ValueError("plan_packing requires positive token counts "
                         "(a zero-length sentence has no pooling target)")
    if not len(lengths):
        return []
    order = np.argsort(-lengths, kind="stable")
    ns = np.minimum(lengths[order], row_len)
    edges = np.flatnonzero(ns[1:] != ns[:-1]) + 1
    run_n = ns[np.r_[0, edges]].tolist()
    run_k = np.diff(np.r_[0, edges, len(ns)]).tolist()
    K = len(ns) + 1
    open_rows: list[int] = []  # capacity * K + row, sorted
    used: list[int] = []       # per row: tokens placed
    count: list[int] = []      # per row: segments placed
    # one placement: q sentences of the run into row r from token u, slot s
    pr, pq, pu, ps = [], [], [], []
    for n, k in zip(run_n, run_k):
        while k:
            j = bisect.bisect_left(open_rows, n * K)
            if j < len(open_rows):
                cap, r = divmod(open_rows.pop(j), K)  # tightest fit
                s, u = count[r], used[r]
            else:
                cap, r, s, u = row_len, len(used), 0, 0
                used.append(0)
                count.append(0)
            q = min(cap // n, max_segs - s, k)
            pr.append(r)
            pq.append(q)
            pu.append(u)
            ps.append(s)
            count[r] = s + q
            used[r] = u + q * n
            cap -= q * n
            if cap and s + q < max_segs:
                bisect.insort(open_rows, cap * K + r)
            k -= q
    pq = np.asarray(pq)
    j = np.arange(len(ns)) - np.repeat(np.cumsum(pq) - pq, pq)
    row = np.repeat(pr, pq)
    slot = np.repeat(ps, pq) + j
    start = np.repeat(pu, pq) + j * ns
    by_row = np.argsort(row * max_segs + slot)
    sentence, row, slot, start, ns = (a[by_row] for a in
                                      (order, row, slot, start, ns))
    n_rows = len(used)
    batches = []
    for b0 in range(0, n_rows, batch_rows):
        at = slice(*np.searchsorted(row, [b0, b0 + batch_rows]))
        nr = min(batch_rows, n_rows - b0)
        batches.append(PackedBatch(sentence[at], row[at] - b0, slot[at],
                                   start[at], ns[at], nr, nr, row_len,
                                   max_segs))
    return batches


def max_block_span(seg: np.ndarray) -> int:
    """Host-side: the largest number of BQ-sized key blocks any query
    block's segment span covers (the static `window` for
    ops.attention.fused_attention_segmented_blockskip). seg is the
    [B, L] segment-id array from materialize (-1 = pad). Vectorized
    numpy mirror of ops.attention.block_ranges — this runs per batch on
    the encode hot path."""
    B, L = seg.shape
    if L % BQ or B == 0:
        return 0
    n = L // BQ
    segb = seg.reshape(B, n, BQ)
    valid = segb >= 0
    big = np.int64(1) << 30
    smin = np.where(valid, segb, big).min(-1)          # [B, n]
    smax = np.where(valid, segb, -1).max(-1)
    s = seg[:, None, :]                                # [B, 1, L]
    in_span = (s >= smin[..., None]) & (s <= smax[..., None]) & (s >= 0)
    pos = np.arange(L)[None, None, :]
    first = np.where(in_span, pos, L).min(-1)          # [B, n]
    last = np.where(in_span, pos, -1).max(-1)
    has = smax >= 0
    spans = np.where(has, last // BQ - first // BQ + 1, 1)
    return int(max(1, spans.max()))


def materialize(batch: PackedBatch, toks: Sequence[Sequence[int]],
                pad_id: int, pooling: str = "mean",
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                           np.ndarray]:
    """Build the device arrays for one packed batch.

    Returns (ids [B,L] i32, seg_ids [B,L] i32 with -1 pads,
    pos_ids [B,L] i32, pool_w [B, n_seg, L] f32,
    mapping [M, 3] i64: (row, seg_slot, sentence_idx) per segment, in
    row then slot order)."""
    if pooling not in ("mean", "cls", "lasttoken"):
        raise ValueError(f"packing supports mean/cls/lasttoken pooling, "
                         f"not {pooling}")
    B, L, S = batch.batch, batch.seq, batch.n_seg
    row, slot, start, n = batch.row, batch.slot, batch.start, batch.length
    ids = np.full((B, L), pad_id, np.int32)
    seg = np.full((B, L), -1, np.int32)
    pos = np.zeros((B, L), np.int32)
    pool = np.zeros((B, S, L), np.float32)
    sent = batch.sentence.tolist()
    # the segments' tokens back to back, in row then slot order: the
    # order of their places in the flattened [B, L] arrays
    flat = np.fromiter(itertools.chain.from_iterable(
        map(toks.__getitem__, sent)), np.int32)
    if len(flat) != n.sum():  # a sentence longer than its segment
        flat = np.fromiter(itertools.chain.from_iterable(
            toks[i][:k] for i, k in zip(sent, n.tolist())), np.int32)
    within = np.arange(len(flat)) - np.repeat(np.cumsum(n) - n, n)
    at = np.repeat(row * L + start, n) + within
    ids.reshape(-1)[at] = flat
    seg.reshape(-1)[at] = np.repeat(slot, n)
    pos.reshape(-1)[at] = within
    first = (row * S + slot) * L + start  # each segment's first place
    if pooling == "mean":
        pool.reshape(-1)[np.repeat(first, n) + within] = np.repeat(
            (1.0 / n).astype(np.float32), n)
    elif pooling == "cls":
        pool.reshape(-1)[first] = 1.0
    else:
        pool.reshape(-1)[first + n - 1] = 1.0
    mapping = np.stack([row, slot, batch.sentence], 1)
    return ids, seg, pos, pool, mapping
