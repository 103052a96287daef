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
and the segments per row, so the set of shapes stays small.
"""

from __future__ import annotations

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
    """One device batch of packed rows."""
    rows: list[list[Segment]]   # per row: its segments
    batch: int                  # padded row count
    seq: int                    # row length
    n_seg: int                  # padded max segments per row


def plan_packing(lengths: Sequence[int], row_len: int, batch_rows: int,
                 max_segs: int) -> list[PackedBatch]:
    """Best-fit-decreasing packing of sentence lengths into rows of
    row_len tokens, grouped into batches of at most batch_rows rows.

    O(n log n): open rows are kept in a capacity-sorted list and each
    sentence goes to the tightest row that fits (a naive first-fit scan
    is O(n*rows) — hours of host time on retrieval-scale corpora).

    max_segs caps segments per row AND pins every batch's n_seg to that
    exact value — serving needs one stable (rows, n_seg, row_len) shape
    family (each new shape is a fresh set of allocations)."""
    import bisect
    if any(n <= 0 for n in lengths):
        raise ValueError("plan_packing requires positive token counts "
                         "(a zero-length sentence has no pooling target)")
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    rows: list[list[Segment]] = []
    used: list[int] = []
    # open rows sorted by remaining capacity: list of (capacity, row_idx)
    open_rows: list[tuple[int, int]] = []
    for i in order:
        n = min(lengths[i], row_len)
        j = bisect.bisect_left(open_rows, (n, -1))
        if j < len(open_rows):
            cap, r = open_rows.pop(j)  # tightest row that still fits
            rows[r].append(Segment(i, used[r], n))
            used[r] += n
            if cap - n > 0 and len(rows[r]) < max_segs:
                bisect.insort(open_rows, (cap - n, r))
        else:
            rows.append([Segment(i, 0, n)])
            used.append(n)
            if row_len - n > 0 and max_segs > 1:
                bisect.insort(open_rows, (row_len - n, len(rows) - 1))
    batches = []
    for start in range(0, len(rows), batch_rows):
        chunk = rows[start:start + batch_rows]
        batches.append(PackedBatch(chunk, len(chunk), row_len, max_segs))
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
                           list[tuple[int, int, int]]]:
    """Build the device arrays for one packed batch.

    Returns (ids [B,L] i32, seg_ids [B,L] i32 with -1 pads,
    pos_ids [B,L] i32, pool_w [B, n_seg, L] f32,
    mapping [(row, seg_slot, sentence_idx), ...])."""
    B, L, S = batch.batch, batch.seq, batch.n_seg
    ids = np.full((B, L), pad_id, np.int32)
    seg = np.full((B, L), -1, np.int32)
    pos = np.zeros((B, L), np.int32)
    pool = np.zeros((B, S, L), np.float32)
    mapping: list[tuple[int, int, int]] = []
    for r, segments in enumerate(batch.rows):
        for s, sg in enumerate(segments):
            sl = slice(sg.start, sg.start + sg.length)
            ids[r, sl] = toks[sg.sentence][: sg.length]
            seg[r, sl] = s
            pos[r, sl] = np.arange(sg.length)
            if pooling == "mean":
                pool[r, s, sl] = 1.0 / sg.length
            elif pooling == "cls":
                pool[r, s, sg.start] = 1.0
            elif pooling == "lasttoken":
                pool[r, s, sg.start + sg.length - 1] = 1.0
            else:
                raise ValueError(
                    f"packing supports mean/cls/lasttoken pooling, "
                    f"not {pooling}")
            mapping.append((r, s, sg.sentence))
    return ids, seg, pos, pool, mapping
