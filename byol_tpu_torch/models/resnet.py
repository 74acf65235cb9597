"""ResNet backbones (counterpart of byol_tpu/models/resnet.py).

Same module names, fields and wiring as the flax ResNet, so a converted
flax tree loads with ``load_state_dict(strict=True)``:

- the public input is NHWC, as on the JAX side; it becomes a
  channels_last NCHW view once, at the stem (no copy);
- convs carry no bias and he_normal kernels; the 3x3 convs pad 1 and the
  1x1 convs (downsample included) pad 0, which is what flax's SAME gives a
  1x1 kernel; the 7x7/2 stem pads 3 and the 3x3/2 max-pool pads 1;
- every BatchNorm is :class:`~byol_tpu_torch.models.layers.BatchNorm`
  (flax semantics, float32 statistics AND output): as in flax, the block
  outputs, the residual sums and the pooled features are float32, and each
  conv casts its input to the compute dtype;
- each BatchNorm is handed the ReLU and the residual add that follow it
  (the stem's ReLU; bn1 and bn2's; the block's add and ReLU on its last
  BatchNorm, the downsample branch's output as the residual), so that in
  training on the card they run inside the fused kernels
  (``ops/batch_norm.py``); bn1 and bn2 feed only a conv, so they may store
  the bf16 the conv casts to (``cast_to``); everything else stays fp32;
- a block takes and returns ``(x, x_copy)``: the fp32 block output and,
  where the fused kernels stored one, its bf16 copy (``copy_to``), which
  the next block's first conv reads in place of its own cast (None: it
  casts); the downsample conv casts for itself, so the two convs'
  gradients meet in fp32, as before;
- ``zero_init_residual`` zeroes each block's last BN scale;
- a block has a downsample branch exactly where flax's shape test finds
  one: a stride or a width change;
- each block's output is tagged ``block_out`` and each block runs under
  the remat policy (core/remat.py::wrap_block) that ``remat`` and
  ``remat_policy`` resolve to, as the flax ResNet wraps its block class;
  ``remat_policy`` is an attribute (core/remat.py::set_remat_policy).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from byol_tpu_torch.core import remat as remat_lib
from byol_tpu_torch.models.layers import BatchNorm, Conv, he_normal_


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, *,
          padding: int = 0, dtype=torch.float32) -> Conv:
    return Conv(cin, cout, kernel, stride, dtype, padding=padding,
                use_bias=False, kernel_init="he_normal")


class SpaceToDepthStem(nn.Module):
    """The 7x7/2 stem conv computed as a 4x4/1 conv on space-to-depth
    input: the same numbers as the plain stem and the same ``(width, C, 7,
    7)`` parameter (flax's ``(7, 7, C, width)``), rearranged at apply time
    exactly as ``byol_tpu/models/resnet.py::SpaceToDepthStem`` does."""

    def __init__(self, in_channels: int, width: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.width, self.dtype = width, dtype
        self.weight = nn.Parameter(torch.empty(width, in_channels, 7, 7))

    @torch.no_grad()
    def init_own_params(self, generator: torch.Generator) -> None:
        he_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in, NCHW (channels_last) out."""
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            raise ValueError(
                f"space_to_depth stem needs even spatial dims, got {(h, w)}")
        dt = self.dtype
        k = self.weight.to(dt).permute(2, 3, 1, 0)            # HWIO
        k = F.pad(k, (0, 0, 0, 0, 1, 0, 1, 0))                # (8, 8, C, O)
        k = k.reshape(4, 2, 4, 2, c, self.width).permute(0, 2, 1, 3, 4, 5)
        k = k.reshape(4, 4, 4 * c, self.width).permute(3, 2, 0, 1)
        x = x.to(dt).reshape(b, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        x = F.pad(x.permute(0, 3, 1, 2), (2, 1, 2, 1))
        return F.conv2d(x, k.contiguous())


class BasicBlock(nn.Module):
    """2x conv3x3 residual block (resnet18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 zero_init_last_bn: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride, padding=1, dtype=dtype)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, padding=1, dtype=dtype)
        self.bn2 = BatchNorm(filters, zero_init=zero_init_last_bn)
        self.has_downsample = stride != 1 or cin != filters
        if self.has_downsample:
            self.downsample_conv = _conv(cin, filters, 1, stride, dtype=dtype)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x: torch.Tensor, x_copy: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        y = self.bn1(self.conv1(x if x_copy is None else x_copy), relu=True,
                     cast_to=self.conv2.dtype)
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        out, out_copy = self.bn2(self.conv2(y), residual=residual, relu=True,
                                 copy_to=self.conv1.dtype)
        return remat_lib.tag_block_out(out), out_copy


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) residual block (resnet50+).
    ``inner_multiplier`` widens the two inner convs only (torchvision's
    wide_resnet convention)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 zero_init_last_bn: bool = True,
                 dtype: torch.dtype = torch.float32,
                 inner_multiplier: int = 1) -> None:
        super().__init__()
        inner = filters * inner_multiplier
        out = filters * self.expansion
        self.conv1 = _conv(cin, inner, 1, dtype=dtype)
        self.bn1 = BatchNorm(inner)
        self.conv2 = _conv(inner, inner, 3, stride, padding=1, dtype=dtype)
        self.bn2 = BatchNorm(inner)
        self.conv3 = _conv(inner, out, 1, dtype=dtype)
        self.bn3 = BatchNorm(out, zero_init=zero_init_last_bn)
        self.has_downsample = stride != 1 or cin != out
        if self.has_downsample:
            self.downsample_conv = _conv(cin, out, 1, stride, dtype=dtype)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor, x_copy: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        y = self.bn1(self.conv1(x if x_copy is None else x_copy), relu=True,
                     cast_to=self.conv2.dtype)
        y = self.bn2(self.conv2(y), relu=True, cast_to=self.conv3.dtype)
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        out, out_copy = self.bn3(self.conv3(y), residual=residual, relu=True,
                                 copy_to=self.conv1.dtype)
        return remat_lib.tag_block_out(out), out_copy


class ResNet(nn.Module):
    """Feature extractor: ``(B, H, W, C) -> (B, feature_dim)``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 width: int = 64, dtype: torch.dtype = torch.float32,
                 small_inputs: bool = False,
                 zero_init_residual: bool = True, stem: str = "conv",
                 inner_multiplier: int = 1, in_channels: int = 3,
                 remat: bool = False, remat_policy: str = "none") -> None:
        super().__init__()
        self.remat_policy = remat_lib.resolve_policy_name(remat,
                                                          remat_policy)
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}; 'conv' | "
                             "'space_to_depth'")
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls, self.width, self.dtype = block_cls, width, dtype
        self.small_inputs = small_inputs
        if small_inputs:                      # CIFAR stem: 3x3/1, no pool
            self.stem_conv = _conv(in_channels, width, 3, padding=1,
                                   dtype=dtype)
        elif stem == "space_to_depth":
            self.stem_conv = SpaceToDepthStem(in_channels, width, dtype)
        else:
            self.stem_conv = _conv(in_channels, width, 7, 2, padding=3,
                                   dtype=dtype)
        self.stem_bn = BatchNorm(width)
        wide_kw = ({"inner_multiplier": inner_multiplier}
                   if inner_multiplier != 1 else {})
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                filters = width * 2 ** i
                self.add_module(f"stage{i + 1}_block{j + 1}", block_cls(
                    cin, filters, stride,
                    zero_init_last_bn=zero_init_residual, dtype=dtype,
                    **wide_kw))
                cin = filters * block_cls.expansion

    @property
    def feature_dim(self) -> int:
        return (self.width * 2 ** (len(self.stage_sizes) - 1)
                * self.block_cls.expansion)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.stem_conv, SpaceToDepthStem):
            x = self.stem_conv(x)
        else:
            # NHWC -> channels_last NCHW: a view, no copy
            x = self.stem_conv(x.permute(0, 3, 1, 2))
        # float32 out: the max-pool's output is a residual of a BasicBlock
        x = self.stem_bn(x, relu=True)
        if not self.small_inputs:
            x = F.max_pool2d(x, 3, 2, padding=1)
        x_copy = None
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                x, x_copy = remat_lib.wrap_block(
                    getattr(self, f"stage{i + 1}_block{j + 1}"),
                    self.remat_policy)(x, x_copy)
        return x.mean(dim=(2, 3)).to(self.dtype)   # global average pool


STAGE_SIZES = {
    "resnet18": [2, 2, 2, 2],
    "resnet34": [3, 4, 6, 3],
    "resnet50": [3, 4, 6, 3],
    "resnet101": [3, 4, 23, 3],
    "resnet152": [3, 8, 36, 3],
    "resnet200": [3, 24, 36, 3],
}
BASIC = {"resnet18", "resnet34"}


def resnet_layout(name: str):
    """``(stage_sizes, block_cls, width, inner_multiplier)`` of a registry
    name.  ``resnetNNw2`` widens every layer (feature dim doubles);
    ``wide_resnetNN_2`` widens only the bottleneck inner convs (torchvision
    names, feature dim 2048)."""
    width, inner_multiplier = 64, 1
    if name.startswith("wide_") and name.endswith("_2"):
        base = name[len("wide_"):-len("_2")]
        if base in BASIC or base not in STAGE_SIZES:
            raise ValueError(f"unknown wide arch {name!r}; wide variants "
                             "exist for bottleneck resnets only")
        inner_multiplier = 2
    else:
        base = name.replace("w2", "")
        if base not in STAGE_SIZES:
            raise ValueError(f"unknown resnet arch {name!r}; known: "
                             f"{sorted(STAGE_SIZES)} (+'w2' suffix, + "
                             "torchvision 'wide_resnetNN_2' names)")
        if name.endswith("w2"):
            width = 128
    block = BasicBlock if base in BASIC else Bottleneck
    return STAGE_SIZES[base], block, width, inner_multiplier


def feature_dim(name: str) -> int:
    stages, block, width, _ = resnet_layout(name)
    return width * 2 ** (len(stages) - 1) * block.expansion


def make_resnet(name: str, *, dtype=torch.float32, small_inputs: bool = False,
                zero_init_residual: bool = True,
                stem: str = "conv", remat: bool = False,
                remat_policy: str = "none") -> ResNet:
    stages, block, width, inner_multiplier = resnet_layout(name)
    return ResNet(stage_sizes=stages, block_cls=block, width=width,
                  dtype=dtype, small_inputs=small_inputs,
                  zero_init_residual=zero_init_residual, stem=stem,
                  inner_multiplier=inner_multiplier, remat=remat,
                  remat_policy=remat_policy)
