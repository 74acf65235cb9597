"""ResNet (``family: resnet``): the bottleneck network of He et al. 2015
(arXiv 1512.03385; v1.5: the stride on the 3x3 convolution), 7x7/2 stem
with a 3x3/2 max-pool, no convolution bias, BatchNorm on the batch
statistics, global average pooling.

``arch``: ``stage_sizes`` (blocks a stage) and ``width`` (the stem's
channels; stage ``i`` has ``width * 2**i`` filters and 4x that out).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from reference.layers import Weights, bn, conv


def param_shapes(arch, image_size: int) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    w = arch["width"]

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    out["backbone.stem_conv.weight"] = (w, 3, 7, 7)
    norm("backbone.stem_bn", w)
    cin = w
    for i, n in enumerate(arch["stage_sizes"]):
        filters = w * 2 ** i
        for j in range(n):
            p = f"backbone.stage{i + 1}_block{j + 1}"
            stride = 2 if i > 0 and j == 0 else 1
            cout = 4 * filters
            out[f"{p}.conv1.weight"] = (filters, cin, 1, 1)
            norm(f"{p}.bn1", filters)
            out[f"{p}.conv2.weight"] = (filters, filters, 3, 3)
            norm(f"{p}.bn2", filters)
            out[f"{p}.conv3.weight"] = (cout, filters, 1, 1)
            norm(f"{p}.bn3", cout)
            if stride != 1 or cin != cout:
                out[f"{p}.downsample_conv.weight"] = (cout, cin, 1, 1)
                norm(f"{p}.downsample_bn", cout)
            cin = cout
    return out


def feature_dim(arch) -> int:
    return arch["width"] * 2 ** (len(arch["stage_sizes"]) - 1) * 4


def represent(w: Weights, images: torch.Tensor, arch, cast) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)
    x = F.relu(bn(conv(x, w, "backbone.stem_conv", cast, 2, 3), w,
                  "backbone.stem_bn"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for i, n in enumerate(arch["stage_sizes"]):
        for j in range(n):
            p = f"backbone.stage{i + 1}_block{j + 1}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(bn(conv(x, w, f"{p}.conv1", cast), w, f"{p}.bn1"))
            y = F.relu(bn(conv(y, w, f"{p}.conv2", cast, stride, 1), w,
                          f"{p}.bn2"))
            y = bn(conv(y, w, f"{p}.conv3", cast), w, f"{p}.bn3")
            if f"{p}.downsample_conv.weight" in w:
                x = bn(conv(x, w, f"{p}.downsample_conv", cast, stride), w,
                       f"{p}.downsample_bn")
            x = F.relu(y + x)
    return x.mean(dim=(2, 3))
