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


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is in float64: the statistics, losses
    and metrics the JAX package computes in fp32 (a float64 net, as the
    tests build one, keeps float64 throughout)."""
    return x if x.dtype == torch.float64 else x.float()

