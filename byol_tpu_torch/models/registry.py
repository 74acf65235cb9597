"""Backbone registry (counterpart of byol_tpu/models/registry.py).

Each entry yields a module whose ``forward(x)`` maps NHWC images to pooled
features, its feature dimension, and whether it holds BatchNorm: the
ResNets (every name of the JAX registry) and the ViTs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

# the JAX registry's ResNet names
RESNETS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnet200", "resnet50w2", "resnet200w2", "wide_resnet50_2",
           "wide_resnet101_2")


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    factory: Callable[..., nn.Module]    # (dtype, image_size, **kw) -> module
    feature_dim: int
    has_batchnorm: bool = True


_REGISTRY: Dict[str, BackboneSpec] = {}


def register(name: str, spec: BackboneSpec) -> None:
    if name in _REGISTRY:
        raise ValueError(f"backbone {name!r} already registered")
    _REGISTRY[name] = spec


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_spec(name: str) -> BackboneSpec:
    if name not in _REGISTRY:
        raise ValueError(f"unknown arch {name!r}; available: {available()}")
    return _REGISTRY[name]


def get_backbone(name: str, *, dtype=torch.float32, image_size: int = 224,
                 **kwargs) -> Tuple[nn.Module, int]:
    spec = get_spec(name)
    return (spec.factory(dtype=dtype, image_size=image_size, **kwargs),
            spec.feature_dim)


def _register_resnets() -> None:
    from byol_tpu_torch.models import resnet as resnet_lib
    for name in RESNETS:
        def factory(dtype=torch.float32, image_size=224, _n=name, **kw):
            # kw passes the ResNet knobs through: small_inputs,
            # zero_init_residual, stem (the input size is free)
            del image_size
            return resnet_lib.make_resnet(_n, dtype=dtype, **kw)
        register(name, BackboneSpec(
            factory=factory,
            feature_dim=resnet_lib.feature_dim(name)))


def _register_vit() -> None:
    from byol_tpu_torch.models import vit as vit_lib
    for name, (width, depth, heads, patch) in {
            "vit_b16": (768, 12, 12, 16),
            "vit_l16": (1024, 24, 16, 16),
            "vit_s16": (384, 12, 6, 16),
    }.items():
        def factory(dtype=torch.float32, image_size=224, _w=width, _d=depth,
                    _h=heads, _p=patch, **kw):
            # kw passes the ViT knobs through: attn_impl, pooling, remat
            return vit_lib.ViT(width=_w, depth=_d, num_heads=_h, patch_size=_p,
                               dtype=dtype, image_size=image_size, **kw)
        register(name, BackboneSpec(factory=factory, feature_dim=width,
                                    has_batchnorm=False))


_register_resnets()
_register_vit()
