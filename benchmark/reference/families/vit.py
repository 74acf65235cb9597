"""ViT (``family: vit``): the Vision Transformer of Dosovitskiy et al. 2020
(arXiv 2010.11929), pre-LN, with a class token, learned position
embeddings, LayerNorm eps 1e-6, the tanh GELU, and the class token's
final LayerNorm output as the representation.

``arch``: ``width``, ``depth``, ``heads``, ``mlp_dim``, ``patch``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from reference.layers import Weights, attention, linear, ln

LN_EPS = 1e-6


def param_shapes(arch, image_size: int) -> Dict[str, Tuple[int, ...]]:
    d, p = arch["width"], arch["patch"]
    seq = (image_size // p) ** 2 + 1
    out: Dict[str, Tuple[int, ...]] = {
        "backbone.patch_embed.weight": (d, 3, p, p),
        "backbone.patch_embed.bias": (d,),
        "backbone.cls_token": (1, 1, d),
        "backbone.pos_embedding": (1, seq, d),
        "backbone.ln_final.weight": (d,), "backbone.ln_final.bias": (d,)}
    for i in range(arch["depth"]):
        b = f"backbone.block{i}"
        for name, shape in (("ln1", None), ("ln2", None),
                            ("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                            ("mlp.fc1", (arch["mlp_dim"], d)),
                            ("mlp.fc2", (d, arch["mlp_dim"]))):
            if shape is None:
                out[f"{b}.{name}.weight"] = (d,)
                out[f"{b}.{name}.bias"] = (d,)
            else:
                out[f"{b}.{name}.weight"] = shape
                out[f"{b}.{name}.bias"] = (shape[0],)
    return out


def feature_dim(arch) -> int:
    return arch["width"]


def represent(w: Weights, images: torch.Tensor, arch, cast) -> torch.Tensor:
    p, d = arch["patch"], arch["width"]
    x = F.conv2d(cast(images.permute(0, 3, 1, 2)),
                 cast(w["backbone.patch_embed.weight"]),
                 w["backbone.patch_embed.bias"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([w["backbone.cls_token"].expand(x.shape[0], 1, d), x], 1)
    x = x + w["backbone.pos_embedding"]
    for i in range(arch["depth"]):
        b = f"backbone.block{i}"
        x = x + attention(ln(x, w, f"{b}.ln1", LN_EPS), w, f"{b}.attn",
                          arch["heads"], cast)
        h = F.gelu(linear(ln(x, w, f"{b}.ln2", LN_EPS), w, f"{b}.mlp.fc1",
                          cast), approximate="tanh")
        x = x + linear(h, w, f"{b}.mlp.fc2", cast)
    return ln(x, w, "backbone.ln_final", LN_EPS)[:, 0]
