"""The BYOL network: backbone + projector + predictor + linear probe.

Counterpart of byol_tpu/models/byol_net.py, with the same submodule names
(``backbone``, ``projector``, ``predictor``, ``probe``), so a flax tree
converts key for key.  :meth:`BYOLNet.represent` runs the backbone alone:
the JAX ``frozen_representation_fn`` computes the heads too and XLA drops
them as unused; here they are simply not run.

:func:`shard_heads` makes a net tensor-parallel over the model axis
(parallel/partitioning.py): the projector and the predictor become the
model index's shards of the heads the net holds whole, so a net drawn
whole from the seed on every rank, then sharded, holds exactly the slices
of the one-rank net's weights.
"""
from __future__ import annotations

from typing import Dict, Tuple

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
        # (size, index) of the model axis the heads are split over
        self.model_axis: Tuple[int, int] = (1, 0)

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


@torch.no_grad()
def shard_heads(net: BYOLNet, size: int, index: int) -> BYOLNet:
    """Replace ``net``'s whole projector and predictor by model index
    ``index``'s shards of them over a model axis of ``size``, in place:
    every split leaf (parallel/partitioning.py::tp_dim) holds its slice of
    the whole one, the rest a copy.  ``size`` 1 leaves the net as it is."""
    from byol_tpu_torch.parallel.partitioning import shard_leaf, tp_dim
    if size == 1:
        return net
    if net.model_axis != (1, 0):
        raise ValueError(f"the heads are split already {net.model_axis}")
    for name in ("predictor", "projector"):         # the JAX tree's order
        whole = getattr(net, name)
        shards = {}
        for key, value in sorted(whole.state_dict().items()):
            dim = tp_dim(f"{name}.{key}", value.ndim)
            shards[key] = (value if dim is None else shard_leaf(
                value, dim, size, index, f"{name}.{key}"))
        part = MLPHead(whole.dense1.in_features, whole.dense1.out_features,
                       whole.dense2.out_features, whole.dtype,
                       bn_momentum=whole.bn.momentum, model_size=size,
                       model_index=index)
        part.to(device=whole.dense1.weight.device,
                dtype=whole.dense1.weight.dtype)
        for key, value in part.state_dict().items():
            value.copy_(shards[key])
        part.train(whole.training)
        setattr(net, name, part)
    net.model_axis = (size, index)
    return net
