"""Layers with flax.linen's conventions, which the JAX models are built of.

- :class:`Dense` / :class:`Conv` keep float32 parameters and compute in
  their ``dtype``: input, kernel and bias are cast to it, as flax does with
  ``Dense(dtype=...)``.  :func:`store_in_compute_dtype` casts the stored
  kernels once for inference; the numbers are the same, since flax casts
  them at every use.
- :class:`LayerNorm` has flax's eps 1e-6 (torch's default is 1e-5) and
  computes in float32 under a lower compute dtype.
- :class:`BatchNorm` has flax's semantics, not torch's: statistics in
  float32, momentum 0.9 as flax counts it (torch's 0.1), eps 1e-5, the
  BIASED batch variance in the running update (torch's own update uses the
  unbiased one), and a switch that normalises with batch statistics
  without updating the running ones (the target network's forward).
  Train mode on a CUDA bf16 channels-last input runs it, with the ReLU and
  the residual add that follow it in a ResNet, as the fused kernels of
  ``ops/batch_norm.py``.
  Inside a process group whose data axis is > 1 (or with ``sync`` set)
  the train-mode statistics are the global batch's, as under JAX's GSPMD
  step (the data group's: the ranks of a sequence group hold the same
  rows): flax's ``_compute_stats`` (E[x] and E[x^2] all-reduced in one
  collective, the variance max(0, E[x^2] - E[x]^2)) with the gradient
  flowing through the all-reduce; not ``nn.SyncBatchNorm``, whose running
  variance is the unbiased one.  In a remat recompute
  (core/remat.py::recomputing) the same ops run and the running
  statistics are left alone: they move once per forward, as under flax's
  ``nn.remat``.
- :func:`init_params` draws flax's initializers (lecun_normal kernels, or
  he_normal for the ResNet convs; zero biases; unit LayerNorm/BatchNorm
  scales, or zero where a block's last BN is zero-initialised) from an
  explicit ``torch.Generator``: the same distributions, not the same bits.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from byol_tpu_torch.core.precision import at_least_fp32
from byol_tpu_torch.core.remat import recomputing
from byol_tpu_torch.ops import batch_norm as bn_ops
from byol_tpu_torch.parallel.collectives import psum
from byol_tpu_torch.parallel.mesh import DATA_AXIS, axis_size

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

    def forward(self, x: torch.Tensor, with_bias: bool = True
                ) -> torch.Tensor:
        """``with_bias=False`` leaves the bias to :meth:`add_bias` (a
        row-parallel layer adds it once, after the sum of its partial
        products)."""
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        self.bias.to(dt) if with_bias else None)

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y + self.bias.to(self.dtype)


class Conv(nn.Conv2d):
    """``nn.Conv`` on an NCHW tensor: symmetric explicit ``padding`` (0 is
    flax's VALID, and its SAME for the ResNet's 1x1 convs), an optional
    bias, and the flax initializer named by ``kernel_init``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int, dtype: torch.dtype = torch.float32, *,
                 padding: int = 0, use_bias: bool = True,
                 kernel_init: str = "lecun_normal") -> None:
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding, bias=use_bias)
        self.dtype = dtype
        self.kernel_init = kernel_init

    def reset_parameters(self) -> None:   # init_params draws them
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias,
                        stride=self.stride, padding=self.padding)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(dtype=...)``: statistics in at least fp32 (a float64
    net keeps float64), output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(dim, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(at_least_fp32(x), self.normalized_shape,
                            self.weight, self.bias, self.eps).to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over dim 1 of an (N, C, ...) tensor.

    - Train mode normalises with the batch statistics (biased variance) and,
      when ``update_stats`` is set, moves the running statistics by
      ``new = momentum * old + (1 - momentum) * batch`` with the BIASED
      batch variance, in place.  ``update_stats=False`` is the target
      network's forward: batch statistics, running statistics untouched.
    - Eval mode normalises with the running statistics.
    - Statistics and the output are float32 whatever the input dtype (flax
      promotes a bf16 input against its float32 scale).
    - ``sync`` (None: when the data axis is > 1): train-mode statistics
      over every data rank's rows (:meth:`_synced`).  At a data axis of 1
      the class keeps the one-device code path.  JAX's
      ``convert_to_sync_bn`` changes nothing here, as in JAX, where GSPMD
      syncs the statistics either way.
    - ``relu`` / ``residual``: the ReLU and residual add that follow the
      norm in a ResNet block.  In train mode on a CUDA bf16 channels-last
      input whose statistics are not synced, the norm, the add and the
      ReLU run as the fused kernels of ``ops/batch_norm.py`` (fp32
      statistics, the same running-statistics rule), stored in bf16 when
      ``cast_to`` says every consumer casts to bf16, else fp32.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, zero_init: bool = False) -> None:
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.zero_init = zero_init            # init_params: scale 0, not 1
        self.update_stats = True
        self.sync: Optional[bool] = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_init else 1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, *, relu: bool = False,
                residual: Optional[torch.Tensor] = None,
                cast_to: Optional[torch.dtype] = None,
                copy_to: Optional[torch.dtype] = None):
        """The norm, then ``+ residual`` and ReLU where asked (a ResNet
        block's tail).  ``cast_to``: the dtype every consumer of the output
        casts it to first (the next conv's compute dtype), which the fused
        path may store it in.  ``copy_to``: the dtype some consumers cast
        the (float32) output to; the call then returns ``(y, copy)``, the
        copy the output in that dtype where the fused path stored one, else
        None (those consumers cast ``y`` themselves).  A train-mode call on
        an input that ``ops/batch_norm.py::fusable`` accepts, with the
        statistics not synced, takes the fused kernels; every other call
        runs :meth:`unfused`."""
        if self.training and not self._sync() and bn_ops.fusable(x):
            bf16 = torch.bfloat16
            copy_dtype = bf16 if copy_to == bf16 else None
            out = bn_ops.train_norm(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, residual=residual, relu=relu,
                out_dtype=bf16 if cast_to == bf16 else torch.float32,
                copy_dtype=copy_dtype, momentum=self.momentum, eps=self.eps,
                update=self.update_stats and not recomputing())
            if copy_to is not None and copy_dtype is None:
                return out, None
            return out
        if bn_ops.on_card(x):
            bn_ops.UNFUSED_CUDA_CALLS += 1
        y = self.unfused(x, relu=relu, residual=residual)
        return y if copy_to is None else (y, None)

    def _sync(self) -> bool:
        return (self.sync if self.sync is not None
                else axis_size(DATA_AXIS) > 1)

    def unfused(self, x: torch.Tensor, *, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The module's own path, float32 output: the norm, ``y +
        residual``, ``F.relu``, each as its own op."""
        y = self._norm(x)
        if residual is not None:
            y = y + residual
        return F.relu(y) if relu else y

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        x = at_least_fp32(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        if self._sync():
            return self._synced(x)
        if not self.update_stats:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        # torch's batch_norm moves running stats with the UNBIASED variance;
        # with momentum 1 into scratch buffers it hands back the batch mean
        # and unbiased variance exactly, and the biased one is n-1/n of it
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        if recomputing():
            # a remat recompute runs the same ops; the statistics moved once
            return y
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=(1.0 - m) * (n - 1) / n)
        return y

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the global batch: per-channel sums of x and x^2
        all-reduced (differentiable), flax's mean and biased variance, and
        the running statistics ticked with them."""
        c = x.shape[1]
        axes = [d for d in range(x.ndim) if d != 1]
        count = x.numel() // c * axis_size(DATA_AXIS)
        sums = psum(torch.stack([x.sum(axes), (x * x).sum(axes)]))
        mean = sums[0] / count
        var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        shape = (1, c) + (1,) * (x.ndim - 2)
        mul = self.weight * torch.rsqrt(var + self.eps)
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        if self.update_stats and not recomputing():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y


def _trunc_normal_(w: torch.Tensor, scale: float, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax ``variance_scaling(scale, 'fan_in', 'truncated_normal')``."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


_KERNEL_INIT_SCALE = {"lecun_normal": 1.0, "he_normal": 2.0}


def he_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``he_normal`` on an (out, in, kh, kw) kernel."""
    _trunc_normal_(w, 2.0, w[0].numel(), generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` with flax's default initializers,
    in module order.  Modules with their own parameters (the ViT's cls token
    and position embedding) define ``init_own_params(generator)``."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            # fan_in = kh * kw * cin for a conv, in for a Dense
            scale = _KERNEL_INIT_SCALE[getattr(m, "kernel_init",
                                               "lecun_normal")]
            _trunc_normal_(m.weight, scale, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, BatchNorm)):
            m.reset_parameters()
        if hasattr(m, "init_own_params"):
            m.init_own_params(generator)


def store_in_compute_dtype(module: nn.Module) -> nn.Module:
    """Cast every Dense/Conv parameter to its layer's compute dtype, once."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            m.to(m.dtype)
    return module
