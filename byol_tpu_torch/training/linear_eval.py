"""The frozen-encoder core that serving wraps.

Counterpart of the part of byol_tpu/training/linear_eval.py the serve path
uses: :func:`frozen_representation_fn` (images -> fp32 representations,
compute in the trained dtype) and its input contract :func:`_prep_inputs`,
with a copy of ``normalize_images`` from byol_tpu/training/steps.py.  The
offline linear-eval protocol comes with a later slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from byol_tpu_torch.core.precision import Policy, get_policy

# ImageNet channel statistics (torchvision convention) behind the
# ``normalize_inputs`` switch
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """Standardize NHWC [0,1] pixels with the ImageNet mean/std; non-RGB
    inputs use the channel-averaged statistics."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    if x.shape[-1] != len(IMAGENET_MEAN):
        mean, std = mean.mean(), std.mean()
    return (x - mean) / std


def _prep_inputs(x: torch.Tensor, policy: Policy,
                 normalize: bool) -> torch.Tensor:
    """Cast to the trained compute dtype and, with ``normalize``, apply the
    same ImageNet standardization the train step used."""
    xc = policy.cast_to_compute(x)
    return normalize_images(xc) if normalize else xc


def frozen_representation_fn(net, *, half: bool = False,
                             normalize: bool = False) -> Callable:
    """``images (B, H, W, C) -> (B, D)`` fp32 representations of ``net``'s
    backbone, in eval mode and without autograd.  ``net`` holds its weights
    (where the JAX function takes ``params``/``batch_stats``)."""
    policy = get_policy(half)
    net.eval()

    def represent(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return net.represent(_prep_inputs(x, policy, normalize)).float()

    return represent
