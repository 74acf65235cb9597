"""Immutable, typed configuration: the part the serving path reads.

Counterpart of byol_tpu/core/config.py, cut to the groups and fields the
serve path reads; every default is the JAX package's.  Later slices add
the training groups and the rest of ``resolve()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class TaskConfig:
    batch_size: int = 4096                    # GLOBAL batch
    image_size_override: Optional[int] = 224


@_frozen
class ModelConfig:
    arch: str = "resnet50"
    projection_size: int = 256
    head_latent_size: int = 4096              # projector/predictor hidden
    attn_impl: str = "dense"                  # ViT attention: dense | flash
    pooling: str = "cls"                      # ViT feature pooling: cls | gap


@_frozen
class DeviceConfig:
    seed: int = 1234
    half: bool = True                         # bf16 compute policy


@_frozen
class ParityConfig:
    normalize_inputs: bool = False            # ImageNet standardization


@_frozen
class Config:
    task: TaskConfig = TaskConfig()
    model: ModelConfig = ModelConfig()
    device: DeviceConfig = DeviceConfig()
    parity: ParityConfig = ParityConfig()

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


@_frozen
class ResolvedConfig:
    """Config + the derived quantities the serve path needs."""

    cfg: Config
    input_shape: Tuple[int, int, int]         # (H, W, C): NHWC, as the JAX side
    output_size: int                          # number of classes (probe width)


def resolve(cfg: Config, *, output_size: int,
            input_shape: Tuple[int, int, int]) -> ResolvedConfig:
    return ResolvedConfig(cfg=cfg, input_shape=tuple(input_shape),
                          output_size=output_size)
