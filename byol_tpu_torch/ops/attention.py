"""Attention ops: the pluggable compute seam for the ViT path.

Counterpart of byol_tpu/ops/attention.py.  All implementations share one
signature::

    fn(q, k, v) -> out      # (B, H, S, D) x3 -> (B, H, S, D)

  ``dense``  plain PyTorch softmax attention;
  ``flash``  the hand-written CUDA kernel (ops/flash_attention.py);
  ``ring``   sequence-parallel attention over the mesh's ``sequence``
             axis (parallel/ring_attention.py).
"""
from __future__ import annotations

from typing import Callable

import torch

from byol_tpu_torch.core.precision import at_least_fp32


def dense_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Standard softmax attention. (B, H, S, D) -> (B, H, S, D).

    Softmax statistics in (at least) fp32 regardless of compute dtype,
    matmuls in the input dtype — as the JAX ``dense_attention``."""
    scale = q.shape[-1] ** -0.5
    scores = at_least_fp32(torch.matmul(q, k.transpose(-1, -2)) * scale)
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return torch.matmul(weights.to(v.dtype), v)


def get_attention_fn(impl: str) -> Callable:
    if impl == "dense":
        return dense_attention
    if impl == "flash":
        from byol_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention
    if impl == "ring":
        from byol_tpu_torch.parallel.ring_attention import ring_attention
        return ring_attention
    raise ValueError(f"unknown attention impl {impl!r}; "
                     f"known: dense, flash, ring")
