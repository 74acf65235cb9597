"""Optimizer factory / registry (counterpart of byol_tpu/optim/factory.py).

The registry is JAX's: rmsprop, adam, adadelta, sgd, momentum (0.9), lamb
and lbfgs, each bare or as ``lars_<base>`` (LARS around the base, eps 0),
behind an optional value clip (``clip > 0``).  The lr is scaled to the
global batch (lr * batch / 256) for sgd and momentum only.  Bare ``lars``
and unknown names raise as JAX raises.  :class:`~byol_tpu_torch.optim.
transforms.Chain` runs the chain on flat buffers; :class:`LarsMomentum`
is the lars_momentum chain leaf by leaf, the plain version the fused
kernels (``--fused-update on``, lars_momentum with clip 0 only) are held
against."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from byol_tpu_torch.optim import lars as lars_lib
from byol_tpu_torch.optim import schedules as sched_lib
from byol_tpu_torch.optim.transforms import BASES, MOMENTUM_DECAY, Chain

__all__ = ["MOMENTUM_DECAY", "Chain", "LarsMomentum", "build_optimizer",
           "fused_update_unsupported_reason", "is_lars_optimizer"]


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
    """The lars_momentum chain (wd fold-in, trust ratio, trace), leaf by
    leaf: the reference the fused kernels are held against."""

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
                    clip: float = 0.0,
                    trust_coefficient: float = lars_lib.TRUST_COEFFICIENT_DEFAULT,
                    lars_eps: float = lars_lib.LARS_EPS_DEFAULT
                    ) -> Tuple[Chain, sched_lib.Schedule]:
    """The chain and its lr schedule; schedule units are steps, or epochs
    with ``steps_per_epoch`` set (the epoch staircase)."""
    full = opt_name.lower().strip()
    if full == "lars":
        raise ValueError(
            "bare 'lars' is a wrapper, not an optimizer; use lars_<base>, "
            "e.g. 'lars_momentum' (the reference default, main.py:88-89)")
    is_lars = is_lars_optimizer(full)
    name = full.split("_")[-1] if is_lars else full
    if name not in BASES:
        raise ValueError(f"unknown optimizer {name!r}")
    lr = sched_lib.linear_scaled_lr(base_lr, global_batch_size, name)
    schedule = sched_lib.warmup_cosine(lr, warmup_units, total_units,
                                       kind=lr_schedule_kind)
    if steps_per_epoch is not None:
        schedule = sched_lib.epoch_granular(schedule, steps_per_epoch)
    return Chain(name=full, base=name, lars=is_lars,
                 weight_decay=weight_decay, clip=clip,
                 trust_coefficient=trust_coefficient, eps=lars_eps), schedule
