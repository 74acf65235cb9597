"""Random weights from the seed, made on the device in one draw.

Every leaf of more than one dimension is a normal draw scaled to std
``sqrt(gain / fan_in)`` (fan_in: the product of all but the first
dimension; gain 2 for convolutions where the configuration says so, as He
et al. initialise a ReLU network, else 1), or std ``embedding_std`` for
the leaves the configuration lists as embeddings.  One-dimensional leaves
named ``*.weight`` are the norms' scales (ones); the others are biases
(zeros).  The leaves are filled in sorted name order from one normal draw
of a generator on the device, so the same seed and the same names give
the same weights, whatever order a network keeps its leaves in.
A one-dimensional scale whose name ends in a suffix of the configuration's
``scales`` takes that value instead of 1 (a residual branch's last norm
started small, as the ResNet paper's successors do, so that a deep
BatchNorm network's gradients at initialisation do not explode).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def stream_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of one run."""
    words = [int(b) for b in tag.encode()]
    hi, lo = np.random.SeedSequence([seed, *words]).generate_state(2)
    return (int(hi) << 31) ^ int(lo)


def _std(name: str, shape, init) -> float:
    if name in init.get("embeddings", ()):
        return init["embedding_std"]
    gain = init["conv_gain"] if len(shape) == 4 else 1.0
    return math.sqrt(gain / math.prod(shape[1:]))


def make(seed: int, shapes: Mapping[str, Tuple[int, ...]], init,
         device) -> Dict[str, torch.Tensor]:
    names = sorted(shapes)
    big = [n for n in names if len(shapes[n]) > 1]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "weights"))
    flat = torch.randn(sum(math.prod(shapes[n]) for n in big),
                       generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for n in big:
        k = math.prod(shapes[n])
        out[n] = flat[at:at + k].view(shapes[n]).mul_(_std(n, shapes[n],
                                                           init))
        at += k
    for n in names:
        if len(shapes[n]) == 1:
            fill = 1.0 if n.endswith(".weight") else 0.0
            for suffix, value in init.get("scales", {}).items():
                if n.endswith(suffix):
                    fill = value
            out[n] = torch.full(shapes[n], fill, device=device)
    return out
