"""Where the reference rounds, and how.

The systems under test compute their convolutions and matrix products in
bfloat16 over float32 weights.  The reference computes them in float32
with TF32 off (:func:`strict_fp32`).  The control computes them from
operands rounded to float8 e4m3, each tensor scaled so that its largest
magnitude maps to e4m3's largest finite value (448): the next precision
below bfloat16, the step a later change might be tempted to take.  The
rounding passes the gradient straight through, so the control trains with
the same autograd graph as the reference.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())          # straight-through gradient


class Cast:
    """Rounds the operands of a convolution or a matrix product."""

    def __init__(self, name: str) -> None:
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "fp32" else _fp8_round(x)


FP32 = Cast("fp32")
FP8 = Cast("fp8")


@contextlib.contextmanager
def strict_fp32():
    """float32 products without TF32 inside, the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
