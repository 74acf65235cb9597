"""Device selection for the entry points: the card, or the CPU on request.

There is no silent CPU fallback: a run that did not ask for the CPU and
finds no card fails here, before it builds anything.
"""
from __future__ import annotations

import torch


def resolve_device(no_cuda: bool = False) -> torch.device:
    if no_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass --no-cuda (device='cpu') to run "
            "on the CPU")
    return torch.device("cuda")
