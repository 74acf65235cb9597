"""BYOL regression objective (counterpart of byol_tpu/objectives/byol_loss.py).

- ``"paper"``: per-row l2 normalisation, loss_i = -2 <x_i/|x_i|, y_i/|y_i|>;
- ``"reference"``: -2 * sum(x*y, -1) / (|X|_F * |Y|_F), whole-tensor
  Frobenius norms (Quirk Q2); padded rows are zeroed before the norms.
  With ``sync`` (the train step inside a process group of world > 1) the
  norms span every rank's rows, the global batch's, as in JAX's GSPMD
  step: the squared norms are all-reduced, differentiably.

Everything in float32 (float64 for a float64 net); the targets never
carry a gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from byol_tpu_torch.core.precision import at_least_fp32
from byol_tpu_torch.objectives.metrics import masked_mean
from byol_tpu_torch.parallel.collectives import psum


def _frobenius(x: torch.Tensor, sync: bool) -> torch.Tensor:
    if not sync:
        return torch.linalg.vector_norm(x)
    return psum(torch.stack([(x * x).sum()])).sqrt()[0]


def regression_loss(x: torch.Tensor, y: torch.Tensor,
                    norm_mode: str = "paper",
                    mask: Optional[torch.Tensor] = None,
                    sync: bool = False) -> torch.Tensor:
    """Per-sample negative scaled dot product, shape (B,)."""
    x, y = at_least_fp32(x), at_least_fp32(y)
    if norm_mode == "paper":
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-12)
        return -2.0 * (x * y).sum(dim=-1)
    if norm_mode == "reference":
        if mask is not None:
            x, y = x * mask[:, None], y * mask[:, None]
        return (-2.0 * (x * y).sum(dim=-1)
                / (_frobenius(x, sync) * _frobenius(y, sync)))
    raise ValueError(f"unknown norm_mode {norm_mode!r}")


def loss_function(online_prediction1, online_prediction2,
                  target_projection1, target_projection2,
                  norm_mode: str = "paper",
                  mask: Optional[torch.Tensor] = None,
                  sync: bool = False) -> torch.Tensor:
    """Symmetrised BYOL loss, a scalar (mean over the valid rows; the
    rank's rows under ``sync``, whose mean over the ranks is the global
    batch's)."""
    t1, t2 = target_projection1.detach(), target_projection2.detach()
    loss_ab = regression_loss(online_prediction1, t2, norm_mode, mask=mask,
                              sync=sync)
    loss_ba = regression_loss(online_prediction2, t1, norm_mode, mask=mask,
                              sync=sync)
    return masked_mean(loss_ab + loss_ba, mask)
