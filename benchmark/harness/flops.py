"""Model FLOPs from a configuration's shapes, 2 per multiply-add, counting
only convolutions and matrix products (what the tensor cores run)."""
from __future__ import annotations

from typing import Dict


def resnet_forward_macs(arch, image_size: int) -> Dict[str, float]:
    """``{'stem': ..., 'backbone': ...}`` multiply-adds of one image."""
    w = arch["width"]
    s = image_size // 2                       # after the 7x7/2 stem
    stem = s * s * w * 3 * 49
    s //= 2                                   # after the max-pool
    macs, cin = stem, w
    for i, n in enumerate(arch["stage_sizes"]):
        f = w * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            so = s // stride
            macs += s * s * cin * f           # 1x1 at the input's size
            macs += so * so * f * f * 9       # 3x3, strided
            macs += so * so * f * 4 * f       # 1x1 up
            if stride != 1 or cin != 4 * f:
                macs += so * so * cin * 4 * f
            cin, s = 4 * f, so
    return {"stem": float(stem), "backbone": float(macs)}


def vit_forward_macs(arch, image_size: int) -> Dict[str, float]:
    d, p = arch["width"], arch["patch"]
    patches = (image_size // p) ** 2
    seq = patches + 1
    per_layer = seq * (4 * d * d + 2 * d * arch["mlp_dim"]) + 2 * seq * seq * d
    stem = patches * d * 3 * p * p
    return {"stem": float(stem),
            "backbone": float(stem + arch["depth"] * per_layer)}


def byol_flops(backbone: Dict[str, float], feat: int, heads,
               num_classes: int) -> Dict[str, float]:
    """Per image: ``forward``, the encoder alone (what serving runs), and
    ``train``: the online network's forward and backward (2 forwards) on
    both views, the image gradient of the first layer left out, the
    target's forward of encoder and projector on both views, and the
    probe's forward and weight gradient on both views."""
    hid, proj = heads["head_latent_size"], heads["projection_size"]
    projector = feat * hid + hid * proj
    predictor = proj * hid + hid * proj
    probe = feat * num_classes
    enc = backbone["backbone"]
    online = 2 * (3 * (enc + projector + predictor) - backbone["stem"])
    target = 2 * (enc + projector)
    train = online + target + 2 * 2 * probe
    return {"forward": 2 * enc, "train": 2 * train}
