"""Wiring: resolved config -> net (counterpart of byol_tpu/training/build.py,
the part the serve path uses)."""
from __future__ import annotations

from typing import Optional

import torch

from byol_tpu_torch.core.config import ResolvedConfig
from byol_tpu_torch.core.precision import get_policy
from byol_tpu_torch.models.byol_net import BYOLNet, build_byol_net
from byol_tpu_torch.models.registry import get_spec


def build_net(rcfg: ResolvedConfig,
              generator: Optional[torch.Generator] = None) -> BYOLNet:
    """The BYOL net on the CPU, its weights drawn from ``generator``
    (default: one seeded with ``cfg.device.seed``)."""
    cfg = rcfg.cfg
    extra = {}
    if not get_spec(cfg.model.arch).has_batchnorm:   # ViT-family knobs
        extra = {"attn_impl": cfg.model.attn_impl,
                 "pooling": cfg.model.pooling}
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.device.seed)
    return build_byol_net(
        cfg.model.arch,
        num_classes=rcfg.output_size,
        head_latent_size=cfg.model.head_latent_size,
        projection_size=cfg.model.projection_size,
        dtype=get_policy(cfg.device.half).compute_dtype,
        image_size=rcfg.input_shape[0],
        generator=generator,
        **extra)
