"""Projector / predictor MLP heads and the linear probe.

Counterpart of byol_tpu/models/heads.py: ``Dense(in -> hidden) ->
BatchNorm -> ReLU -> Dense(hidden -> out)``, with the flax-semantics
:class:`~byol_tpu_torch.models.layers.BatchNorm` (momentum 0.9 as flax
counts it, eps 1e-5, the biased variance in the running update, float32
statistics and output).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from byol_tpu_torch.models.layers import BatchNorm, Dense


class MLPHead(nn.Module):
    def __init__(self, in_features: int, hidden_size: int = 4096,
                 output_size: int = 256, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = 0.9) -> None:
        super().__init__()
        self.dtype = dtype
        self.dense1 = Dense(in_features, hidden_size, dtype)
        self.bn = BatchNorm(hidden_size, momentum=bn_momentum)
        self.dense2 = Dense(hidden_size, output_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.dense1(x)))
        return self.dense2(x).to(self.dtype)


class LinearProbe(nn.Module):
    """Linear classifier on detached representations."""

    def __init__(self, in_features: int, num_classes: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.classifier = Dense(in_features, num_classes, dtype)

    def forward(self, representation: torch.Tensor) -> torch.Tensor:
        return self.classifier(representation.detach())
