"""Layers with flax.linen's conventions, which the JAX models are built of.

- :class:`Dense` / :class:`Conv` keep float32 parameters and compute in
  their ``dtype``: input, kernel and bias are cast to it, as flax does with
  ``Dense(dtype=...)``.  :func:`store_in_compute_dtype` casts the stored
  kernels once for inference; the numbers are the same, since flax casts
  them at every use.
- :class:`LayerNorm` has flax's eps 1e-6 (torch's default is 1e-5) and
  computes in float32 under a lower compute dtype.
- :func:`init_params` draws flax's default initializers (lecun_normal
  kernels, zero biases, unit LayerNorm/BatchNorm scales) from an explicit
  ``torch.Generator``: the same distributions, not the same bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# stddev of a unit normal truncated to [-2, 2]: lecun_normal divides by it
# so that the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Linear):
    """``nn.Dense``: kernel ``(out, in)`` here, ``(in, out)`` in flax."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def reset_parameters(self) -> None:   # init_params draws them
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Conv2d):
    """``nn.Conv`` with VALID padding on an NCHW tensor."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_channels, out_channels, kernel, stride=stride)
        self.dtype = dtype

    def reset_parameters(self) -> None:   # init_params draws them
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(dtype=...)``: fp32 statistics, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(dim, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` with flax's default initializers,
    in module order.  Modules with their own parameters (the ViT's cls token
    and position embedding) define ``init_own_params(generator)``."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.reset_parameters()
        if hasattr(m, "init_own_params"):
            m.init_own_params(generator)


def store_in_compute_dtype(module: nn.Module) -> nn.Module:
    """Cast every Dense/Conv parameter to its layer's compute dtype, once."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            m.to(m.dtype)
    return module
