"""Optimizer factory (counterpart of byol_tpu/optim/factory.py), cut to the
``lars_momentum`` chain: the default, and the one the fused update kernels
implement.  Every other registry entry raises (ROADMAP.md, section 1
item 5)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from byol_tpu_torch.optim import lars as lars_lib
from byol_tpu_torch.optim import schedules as sched_lib

# the 'momentum' decay (reference main.py:311), also the one the fused
# kernel ticks
MOMENTUM_DECAY = 0.9


def is_lars_optimizer(opt_name: str) -> bool:
    return opt_name.lower().strip().startswith("lars_")


def fused_update_unsupported_reason(opt_name: str,
                                    clip: float = 0.0) -> Optional[str]:
    """Why ``--fused-update on`` cannot serve this optimizer config, or
    None when the fused kernels compute exactly the chain."""
    full = opt_name.lower().strip()
    if not is_lars_optimizer(full):
        return (f"optimizer {opt_name!r} does not build the LARS wrapper "
                "chain; the fused kernel implements wd fold-in + trust "
                "ratio + momentum (use lars_momentum)")
    if full.split("_")[-1] != "momentum":
        return (f"inner optimizer {full.split('_')[-1]!r} is not the sgd-"
                "momentum trace the fused kernel ticks (use lars_momentum)")
    if clip > 0.0:
        return ("--clip > 0 value-clips gradients before LARS; the fused "
                "kernel does not replicate the clip")
    return None


@dataclasses.dataclass(frozen=True)
class LarsMomentum:
    """The unfused lars_momentum chain (wd fold-in, trust ratio, trace)."""

    weight_decay: float
    momentum_decay: float = MOMENTUM_DECAY
    trust_coefficient: float = lars_lib.TRUST_COEFFICIENT_DEFAULT
    eps: float = lars_lib.LARS_EPS_DEFAULT

    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor],
               momentum: Sequence[torch.Tensor], *, lr: float,
               adapted: Sequence[bool]) -> torch.Tensor:
        return lars_lib.lars_momentum_update(
            params, grads, momentum, lr=lr, weight_decay=self.weight_decay,
            momentum_decay=self.momentum_decay, adapted=adapted,
            trust_coefficient=self.trust_coefficient, eps=self.eps)


def build_optimizer(opt_name: str, *, base_lr: float, global_batch_size: int,
                    weight_decay: float, total_units: int, warmup_units: int,
                    lr_schedule_kind: str = "cosine",
                    steps_per_epoch: Optional[int] = None,
                    clip: float = 0.0
                    ) -> Tuple[LarsMomentum, sched_lib.Schedule]:
    """The chain and its lr schedule; schedule units are steps, or epochs
    with ``steps_per_epoch`` set (the epoch staircase)."""
    full = opt_name.lower().strip()
    if full != "lars_momentum":
        raise NotImplementedError(
            f"optimizer {opt_name!r} is not ported to byol_tpu_torch yet; "
            "only lars_momentum is (ROADMAP.md, section 1 item 5)")
    if clip > 0.0:
        raise NotImplementedError(
            "--clip > 0 is not ported to byol_tpu_torch yet (ROADMAP.md, "
            "section 1 item 5)")
    lr = sched_lib.linear_scaled_lr(base_lr, global_batch_size, "momentum")
    schedule = sched_lib.warmup_cosine(lr, warmup_units, total_units,
                                       kind=lr_schedule_kind)
    if steps_per_epoch is not None:
        schedule = sched_lib.epoch_granular(schedule, steps_per_epoch)
    return LarsMomentum(weight_decay=weight_decay), schedule
