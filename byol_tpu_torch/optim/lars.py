"""LARS around sgd-momentum (counterpart of byol_tpu/optim/lars.py).

The order is the reference's, and it matters:

1. weight decay is folded into the gradient BEFORE the trust ratio
   (``g + wd * p``), on adapted leaves only;
2. adapted leaves (``ndim > 1``: kernels; biases and BN parameters are
   excluded) are scaled by ``trust_coef * |p| / (|g| + eps)``, or by 1
   unless both norms are > 0;
3. the inner optimizer is optax's ``trace``: ``m' = g + mu * m``, and the
   update is ``p' = p - lr * m'``.

:func:`lars_momentum_update` is that chain in plain torch ops, leaf by
leaf, in place: the plain version the fused kernels (ops/fused_update.py)
are held against.  The train step's unfused path runs LARS around any
base on the flat buffers (optim/transforms.py).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

TRUST_COEFFICIENT_DEFAULT = 1e-3
LARS_EPS_DEFAULT = 0.0


def default_exclusion_mask(params: Sequence[torch.Tensor]) -> List[bool]:
    """True where LARS adaptation and weight decay apply (ndim > 1)."""
    return [p.dim() > 1 for p in params]


def trust_ratio_from_norms(param_norm: torch.Tensor, grad_norm: torch.Tensor,
                           trust_coefficient: float = TRUST_COEFFICIENT_DEFAULT,
                           eps: float = LARS_EPS_DEFAULT) -> torch.Tensor:
    """Steps 2-3 on precomputed norms, elementwise; ``grad_norm`` is of the
    post-weight-decay gradient."""
    ratio = trust_coefficient * param_norm / (grad_norm + eps)
    return torch.where((param_norm > 0.0) & (grad_norm > 0.0), ratio,
                       torch.ones_like(ratio))


@torch.no_grad()
def lars_momentum_update(params: Sequence[torch.Tensor],
                         grads: Sequence[torch.Tensor],
                         momentum: Sequence[torch.Tensor], *,
                         lr: float, weight_decay: float,
                         momentum_decay: float, adapted: Sequence[bool],
                         trust_coefficient: float = TRUST_COEFFICIENT_DEFAULT,
                         eps: float = LARS_EPS_DEFAULT) -> torch.Tensor:
    """One lars_momentum step on float32 leaves, in place on ``params`` and
    ``momentum``; returns the applied trust ratios of the adapted leaves,
    in leaf order (ones(1) if no leaf is adapted)."""
    ratios = []
    for p, g, m, use in zip(params, grads, momentum, adapted):
        u = g
        if use:
            if weight_decay > 0.0:
                u = g + weight_decay * p
            ratio = trust_ratio_from_norms(torch.linalg.vector_norm(p),
                                           torch.linalg.vector_norm(u),
                                           trust_coefficient, eps)
            u = u * ratio
            ratios.append(ratio)
        m.mul_(momentum_decay).add_(u)
        p.add_(m, alpha=-lr)
    if not ratios:
        return torch.ones(1, device=params[0].device)
    return torch.stack(ratios)
