"""Pad-to-power-of-two batch buckets: the serving shape vocabulary.

A copy of byol_tpu/serving/buckets.py.  A dynamic batcher produces a
different row count every flush; every coalesced batch is padded up to the
smallest power-of-two bucket that holds it, so the engine warms at most
``len(spec.sizes)`` shapes (kernel build, cuBLAS/cuDNN algorithm choice)
and steady-state serving meets no new shape (serving/engine.py counts
them in ``compile_count``).

Power-of-two spacing bounds the padding waste at <2x in the worst case
(average much lower — the meter's ``fill_ratio`` reports the realized
waste), while keeping the shape count logarithmic in ``max_batch``.
``min_bucket`` floors the vocabulary: a higher floor trades padding waste
for fewer shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """The bucket vocabulary: powers of two in [min_bucket, max_bucket]."""

    min_bucket: int = 8
    max_bucket: int = 64

    def __post_init__(self) -> None:
        if not _is_pow2(self.min_bucket) or not _is_pow2(self.max_bucket):
            raise ValueError(
                f"bucket bounds must be powers of two, got "
                f"[{self.min_bucket}, {self.max_bucket}]")
        if self.min_bucket > self.max_bucket:
            raise ValueError(
                f"min_bucket {self.min_bucket} > max_bucket "
                f"{self.max_bucket}")

    @property
    def sizes(self) -> Tuple[int, ...]:
        """Every bucket, ascending — the engine's full program vocabulary."""
        out, b = [], self.min_bucket
        while b <= self.max_bucket:
            out.append(b)
            b *= 2
        return tuple(out)

    def bucket_for(self, rows: int) -> int:
        """The ONE bucket that serves ``rows``: smallest size >= rows.

        Total (over the vocabulary) and deterministic, so every request
        count maps to exactly one warmed shape.
        """
        if rows < 1:
            raise ValueError(f"a batch needs at least one row, got {rows}")
        if rows > self.max_bucket:
            raise ValueError(
                f"{rows} rows exceed the largest bucket "
                f"{self.max_bucket}; the batcher must flush below it")
        for b in self.sizes:
            if rows <= b:
                return b
        raise AssertionError("unreachable: rows <= max_bucket")
