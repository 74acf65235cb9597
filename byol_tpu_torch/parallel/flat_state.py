"""Resident flat update state and its bucketed all-gather (counterpart of
byol_tpu/parallel/flat_state.py).

The port's update state is resident and flat from the start
(training/state.py): params, gradients, momentum and target are fp32
buffers in the fused update's segment layout, and every parameter is a
view of its buffer, so ``--flat-resident on`` has no pack or carve to
add.  What it changes, under ``--zero1 on``, is the all-gather that
refills the params and the target after the sharded update: in buckets
of at most ``--flat-bucket-mb`` MiB (:func:`plan_buckets`, JAX's greedy
plan over the port's layout: whole segments, an oversized one alone)
instead of one collective over the whole buffer.
"""
from __future__ import annotations

from typing import List, Tuple

from byol_tpu_torch.ops.fused_update import LANES, SegmentMap

DEFAULT_BUCKET_MB = 64

# (first row, end row, segment indices)
Bucket = Tuple[int, int, Tuple[int, ...]]


def plan_buckets(seg: SegmentMap, bucket_mb: int) -> Tuple[Bucket, ...]:
    """Greedy contiguous groups of whole segments of at most ``bucket_mb``
    MiB of fp32 each, in row units of the flat buffer; a segment larger
    than the budget gets a bucket of its own (never split)."""
    if bucket_mb < 1:
        raise ValueError(f"bucket_mb must be >= 1, got {bucket_mb}")
    budget = bucket_mb * (1 << 20)
    buckets: List[Bucket] = []
    cur: List[int] = []
    cur_start = 0
    for i, (start, padded) in enumerate(zip(seg.starts, seg.padded)):
        end = start + padded
        if cur and (end - cur_start) * 4 > budget:
            buckets.append(_bucket(seg, cur_start, cur))
            cur, cur_start = [], start
        cur.append(i)
    if cur:
        buckets.append(_bucket(seg, cur_start, cur))
    return tuple(buckets)


def _bucket(seg: SegmentMap, start: int, idx: List[int]) -> Bucket:
    end = seg.starts[idx[-1]] + seg.padded[idx[-1]]
    return start // LANES, end // LANES, tuple(idx)
