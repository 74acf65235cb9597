"""The layers that the encoders (families/) and BYOL's heads (nets.py)
share, as functions of a weight dict ``{name: tensor}``.

Each takes float32 activations and computes in float32, except where
``cast`` rounds the operands of a convolution or a matrix product
(precision.py).  BatchNorm uses the batch's statistics (biased variance,
eps 1e-5), as training does.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def bn(x, w: Weights, name: str):
    return F.batch_norm(x, None, None, w[f"{name}.weight"], w[f"{name}.bias"],
                        training=True, eps=1e-5)


def linear(x, w: Weights, name: str, cast):
    return F.linear(cast(x), cast(w[f"{name}.weight"]), w[f"{name}.bias"])


def conv(x, w: Weights, name: str, cast, stride=1, padding=0):
    return F.conv2d(cast(x), cast(w[f"{name}.weight"]), stride=stride,
                    padding=padding)


def ln(x, w: Weights, name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], eps=eps)


def attention(x, w: Weights, name: str, heads: int, cast):
    """Multi-head self-attention over all of ``x``'s (B, S, D) tokens:
    ``{name}.qkv`` and ``{name}.proj``, softmax in float32."""
    b, s, d = x.shape
    qkv = linear(x, w, f"{name}.qkv", cast).reshape(b, s, 3, heads,
                                                    d // heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scores = torch.matmul(cast(q), cast(k).transpose(-1, -2)) / math.sqrt(
        d // heads)
    out = torch.matmul(cast(torch.softmax(scores, dim=-1)), cast(v))
    return linear(out.transpose(1, 2).reshape(b, s, d), w, f"{name}.proj",
                  cast)
