"""Weight-initialization registry (counterpart of byol_tpu/models/init.py):
``--weight-initialization`` names a scheme, None keeps the defaults.

Applied after the net is built, in place: every Dense and Conv kernel (the
flax ``kernel`` leaves, all of rank >= 2) is drawn again from the named
initializer; biases, LayerNorm and BatchNorm parameters keep their values.
The fans are flax's, from the kernel's FLAX shape: HWIO for a conv, (in,
out) for a Dense, never torch's OIHW or (out, in).  The kernels are drawn
in the JAX tree's order from one generator (the ``weight_init`` stream):
the same distributions as flax's initializers, not the same bits.

As in the JAX package, the EMA target (and the Polyak average) is made
from the FINAL params: call this before ``create_train_state``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from byol_tpu_torch.models.layers import _TRUNC_STD, Conv, Dense

# (flax shape, generator) -> a kernel in the flax shape
Initializer = Callable[[Tuple[int, ...], torch.Generator], torch.Tensor]


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """flax ``_compute_fans``: in axis -2, out axis -1, the rest the
    receptive field."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def variance_scaling(scale: float, mode: str, distribution: str
                     ) -> Initializer:
    """flax ``variance_scaling``: variance ``scale / fan``, fan by ``mode``
    (fan_in, fan_avg); a normal cut at +-2 sigma and rescaled by 0.8796
    so the cut draw keeps that variance, or a uniform."""
    def init(shape, gen):
        fan_in, fan_out = _fans(shape)
        fan = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
        variance = scale / fan
        out = torch.empty(shape)
        if distribution == "truncated_normal":
            std = math.sqrt(variance) / _TRUNC_STD
            return nn.init.trunc_normal_(out, std=std, a=-2 * std,
                                         b=2 * std, generator=gen)
        limit = math.sqrt(3 * variance)
        return nn.init.uniform_(out, -limit, limit, generator=gen)
    return init


def truncated_normal(stddev: float) -> Initializer:
    """flax ``truncated_normal(stddev)``: ``stddev`` times a unit normal
    cut at +-2, with no rescale."""
    def init(shape, gen):
        return nn.init.trunc_normal_(torch.empty(shape), std=stddev,
                                     a=-2 * stddev, b=2 * stddev,
                                     generator=gen)
    return init


def orthogonal(shape: Tuple[int, ...], gen: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal()``: the (fan, out) matrix (the flax shape with its
    last axis as the columns) has orthonormal columns, or orthonormal rows
    when it is wider than tall; the QR of a normal draw, signs fixed by
    R's diagonal."""
    cols = shape[-1]
    rows = math.prod(shape) // cols
    a = torch.randn(max(rows, cols), min(rows, cols), generator=gen,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.float().reshape(shape)


REGISTRY: Dict[str, Initializer] = {
    "xavier_uniform": variance_scaling(1.0, "fan_avg", "uniform"),
    "xavier_normal": variance_scaling(1.0, "fan_avg", "truncated_normal"),
    "kaiming_uniform": variance_scaling(2.0, "fan_in", "uniform"),
    "kaiming_normal": variance_scaling(2.0, "fan_in", "truncated_normal"),
    "orthogonal": orthogonal,
    "truncated_normal": truncated_normal(0.02),
    "lecun_normal": variance_scaling(1.0, "fan_in", "truncated_normal"),
}


def available() -> tuple:
    return tuple(sorted(REGISTRY))


def flax_shape(weight: torch.Tensor) -> Tuple[int, ...]:
    """The flax shape of a port kernel: OIHW -> HWIO, (out, in) -> (in,
    out)."""
    if weight.ndim == 4:
        o, i, h, w = weight.shape
        return (h, w, i, o)
    return tuple(weight.shape[::-1])


def to_torch_layout(kernel: torch.Tensor) -> torch.Tensor:
    """A kernel in its flax shape -> the port's layout."""
    if kernel.ndim == 4:
        return kernel.permute(3, 2, 0, 1)
    return kernel.T


@torch.no_grad()
def apply_weight_init(net: nn.Module, generator: torch.Generator,
                      method: Optional[str]) -> nn.Module:
    """Draw every Dense and Conv kernel of ``net`` again with the named
    initializer, in the JAX tree's order (parameter names sorted per
    level); None leaves the net as it is."""
    if method is None:
        return net
    if method not in REGISTRY:
        raise ValueError(f"unknown weight initialization {method!r}; "
                         f"available: {available()}")
    init = REGISTRY[method]
    kernels = {f"{name}.weight": m.weight
               for name, m in net.named_modules()
               if isinstance(m, (Dense, Conv))}
    for name in sorted(kernels, key=lambda n: tuple(n.split("."))):
        weight = kernels[name]
        drawn = init(flax_shape(weight), generator)
        weight.copy_(to_torch_layout(drawn))
    return net
