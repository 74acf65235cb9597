"""The BYOL network: backbone + projector + predictor + linear probe.

Counterpart of byol_tpu/models/byol_net.py, with the same submodule names
(``backbone``, ``projector``, ``predictor``, ``probe``), so a flax tree
converts key for key.  :meth:`BYOLNet.represent` runs the backbone alone:
the JAX ``frozen_representation_fn`` computes the heads too and XLA drops
them as unused; here they are simply not run.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from byol_tpu_torch.models.heads import LinearProbe, MLPHead
from byol_tpu_torch.models.layers import init_params


class BYOLNet(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int,
                 head_latent_size: int = 4096, projection_size: int = 256,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        feat = backbone.feature_dim
        self.backbone = backbone
        self.projector = MLPHead(feat, head_latent_size, projection_size,
                                 dtype)
        self.predictor = MLPHead(projection_size, head_latent_size,
                                 projection_size, dtype)
        self.probe = LinearProbe(feat, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        representation = self.backbone(x)
        projection = self.projector(representation)
        prediction = self.predictor(projection)
        return {"representation": representation,
                "projection": projection,
                "prediction": prediction}

    def represent(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)

    def classify(self, representation: torch.Tensor) -> torch.Tensor:
        return self.probe(representation)


def build_byol_net(arch: str, *, num_classes: int, head_latent_size: int,
                   projection_size: int, generator: torch.Generator,
                   dtype=torch.float32, image_size: int = 224,
                   **backbone_kwargs) -> BYOLNet:
    """Build on the CPU and draw the weights from ``generator``; the caller
    moves the net to its device."""
    from byol_tpu_torch.models.registry import get_backbone
    backbone, _ = get_backbone(arch, dtype=dtype, image_size=image_size,
                               **backbone_kwargs)
    net = BYOLNet(backbone, num_classes=num_classes,
                  head_latent_size=head_latent_size,
                  projection_size=projection_size, dtype=dtype)
    init_params(net, generator)
    return net
