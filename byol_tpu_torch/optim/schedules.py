"""Learning-rate and EMA schedules (counterpart of byol_tpu/optim/schedules.py).

Host-side pure functions ``count -> value``: the step counters live on the
host, so the train step hands the kernels plain floats and never reads a
device scalar back.  The arithmetic is float32, as the JAX schedules' is.

- :func:`warmup_cosine`: linear warmup (the first unit runs at factor 0),
  then cosine annealing to 0 over ``total - warmup`` units, or a constant
  (``kind='fixed'``);
- :func:`epoch_granular`: the reference's per-epoch staircase (Quirk Q5);
- :func:`linear_scaled_lr`: lr * batch / 256 for the sgd/momentum family
  (the factory passes the registry's base name: ``lars_adam`` -> adam,
  unscaled);
- :func:`cosine_ema_decay`: tau(k) = 1 - (1 - tau0) (cos(pi k / K) + 1) / 2.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_F = np.float32


def warmup_cosine(base_lr: float, warmup_units: int, total_units: int,
                  kind: str = "cosine") -> Schedule:
    if kind not in ("fixed", "cosine"):
        raise NotImplementedError(f"lr schedule {kind!r} not implemented")
    warmup = max(int(warmup_units), 0)
    span = max(int(total_units) - warmup, 1)

    def schedule(count: int) -> float:
        t = _F(count)
        if warmup > 0 and t < warmup:
            factor = t / _F(max(warmup, 1))
        elif kind == "fixed":
            factor = _F(1.0)
        else:
            factor = _F(0.5) * (_F(1.0) + np.cos(
                _F(np.pi) * (t - _F(warmup)) / _F(span)))
        return float(_F(base_lr) * _F(factor))

    return schedule


def epoch_granular(schedule: Schedule, steps_per_epoch: int) -> Schedule:
    """Consume step counts, advance only at epoch boundaries."""
    def wrapped(count: int) -> float:
        return schedule(int(count) // max(steps_per_epoch, 1))
    return wrapped


def linear_scaled_lr(base_lr: float, global_batch_size: int,
                     opt_name: str) -> float:
    if opt_name in ("sgd", "momentum"):
        return base_lr * (global_batch_size / 256.0)
    return base_lr


def cosine_ema_decay(step: int, total_steps: int,
                     base_decay: float = 0.996) -> float:
    k = _F(step)
    frac = (np.cos(_F(np.pi) * k / _F(total_steps)) + _F(1.0)) / _F(2.0)
    return float(_F(1.0) - (_F(1.0) - _F(base_decay)) * _F(frac))
