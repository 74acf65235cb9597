"""Peaks of the card and the least time each hand-written kernel's work
can take there, from shapes alone.

The bound of a call is max(bytes / bandwidth, FLOPs / peak), counting each
input byte read once and each output byte written once.  The arithmetic
is that of the port's kernel table (PERF.md, section 6, as of slice 15),
copied here so that a later change cannot move it; the tests hold it to
that table's numbers.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM5 80GB data sheet: dense bf16 tensor-core FLOP/s and HBM3
# bytes/s, at the full 700 W power limit
PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12
LANES = 128                    # the flat buffers pad each leaf to this


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def flat_elements(shapes: Iterable[Tuple[int, ...]]) -> int:
    """Elements of a flat fp32 buffer holding these leaves, each padded to
    a multiple of 128."""
    return sum(-(-math.prod(s) // LANES) * LANES for s in shapes)


def k1a_bytes(n: int) -> float:
    """The fused update's norms: params and gradients read once (fp32)."""
    return 2 * 4 * n


def k1b_bytes(n: int) -> float:
    """The fused update's apply: gradients, params, momentum and target
    read, params, momentum and target written, once each (fp32)."""
    return 7 * 4 * n


def k2_bytes(batch: int, height: int, width: int, size: int) -> float:
    """Both views of a uint8 batch: the images read once, two float32
    views written once."""
    return batch * height * width * 3 + 2 * batch * size * size * 3 * 4


def k3_cost(batch: int, heads: int, seq: int, head_dim: int
            ) -> Dict[str, float]:
    """Attention of one layer in bf16: q, k, v read and o written once;
    QK^T and PV at 2 FLOPs a multiply-add."""
    return {"bytes": 4 * batch * heads * seq * head_dim * 2,
            "flops": 4 * batch * heads * seq * seq * head_dim}


def k3_bound_s(batch: int, heads: int, seq: int, head_dim: int) -> float:
    c = k3_cost(batch, heads, seq, head_dim)
    return bound_s(c["bytes"], c["flops"])
