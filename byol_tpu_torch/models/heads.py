"""Projector / predictor MLP heads and the linear probe.

Counterpart of byol_tpu/models/heads.py: ``Dense(in -> hidden) ->
BatchNorm -> ReLU -> Dense(hidden -> out)``, with the flax-semantics
:class:`~byol_tpu_torch.models.layers.BatchNorm` (momentum 0.9 as flax
counts it, eps 1e-5, the biased variance in the running update, float32
statistics and output).

Over a model axis of M > 1 (parallel/partitioning.py) an ``MLPHead`` is
model index i's shard of the whole head, Megatron's column-then-row
split: ``dense1`` holds hidden / M rows, ``bn`` hidden / M features
(synced over the data axis only: each feature lives on one model rank),
``dense2`` hidden / M input columns, and the input enters through
``copy_to_model`` (its gradient summed over the model ranks).  The
partial products of ``dense2`` are summed over the model axis in at least
fp32 (``reduce_from_model``), and ``dense2``'s bias, whole on every rank,
is added once, after the sum.  At M = 1 it is the plain head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from byol_tpu_torch.core.precision import at_least_fp32
from byol_tpu_torch.models.layers import BatchNorm, Dense
from byol_tpu_torch.parallel.collectives import (copy_to_model,
                                                 reduce_from_model)


class MLPHead(nn.Module):
    def __init__(self, in_features: int, hidden_size: int = 4096,
                 output_size: int = 256, dtype: torch.dtype = torch.float32,
                 bn_momentum: float = 0.9, model_size: int = 1,
                 model_index: int = 0) -> None:
        super().__init__()
        self.dtype = dtype
        self.model_size, self.model_index = model_size, model_index
        local = hidden_size // model_size
        self.dense1 = Dense(in_features, local, dtype)
        self.bn = BatchNorm(local, momentum=bn_momentum)
        self.dense2 = Dense(local, output_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = self.model_size > 1
        x = F.relu(self.bn(self.dense1(copy_to_model(x) if split else x)))
        if not split:
            return self.dense2(x).to(self.dtype)
        out = reduce_from_model(at_least_fp32(self.dense2(x, False)))
        return self.dense2.add_bias(out).to(self.dtype)


class LinearProbe(nn.Module):
    """Linear classifier on detached representations."""

    def __init__(self, in_features: int, num_classes: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.classifier = Dense(in_features, num_classes, dtype)

    def forward(self, representation: torch.Tensor) -> torch.Tensor:
        return self.classifier(representation.detach())
