"""Probe losses and metrics (counterpart of byol_tpu/objectives/metrics.py).

All in float32; ``mask`` (B,) in {0, 1} restricts a mean to the valid rows
of a padded eval batch.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from byol_tpu_torch.core.precision import at_least_fp32


def masked_mean(values: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return values.mean()
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    per = F.cross_entropy(at_least_fp32(logits), labels.long(),
                          reduction="none")
    return masked_mean(per, mask)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  topk: Sequence[int] = (1, 5),
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracies in PERCENT."""
    maxk = min(max(topk), logits.shape[-1])
    pred = logits.float().topk(maxk, dim=-1).indices            # (B, maxk)
    correct = pred == labels.long()[:, None]
    return tuple(
        masked_mean(correct[:, :min(k, maxk)].any(dim=-1).float(), mask)
        * 100.0 for k in topk)
