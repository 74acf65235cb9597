"""Mixed-precision dtype policy (counterpart of byol_tpu/core/precision.py).

Compute in bfloat16; parameters, statistics and outputs stay float32 (the
layers cast their float32 parameters to the compute dtype, models/layers.py).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype) if x.is_floating_point() else x


FP32 = Policy()
BF16 = Policy(compute_dtype=torch.bfloat16)


def get_policy(half: bool) -> Policy:
    """Map the ``--half`` flag to a policy."""
    return BF16 if half else FP32
