"""The encoders and BYOL's heads as functions of a weight dict.

``arch`` is the configuration file's ``arch`` group.  A ResNet
(``family: resnet``) is the bottleneck network of He et al. (v1.5: the
stride on the 3x3 convolution), 7x7/2 stem with a 3x3/2 max-pool, no
convolution bias, BatchNorm on the batch statistics (biased variance, eps
1e-5), global average pooling.  A ViT (``family: vit``) is pre-LN, with a
class token, learned position embeddings, LayerNorm eps 1e-6, the tanh
GELU, and the class token's final LayerNorm output as the representation.
Heads (BYOL section 3.3): Linear(in, hidden) -> BatchNorm -> ReLU ->
Linear(hidden, out); the probe is a Linear on the detached
representation.

Images come in NHWC in [0, 1]; every function here takes them as float32
and computes in float32, except where ``cast`` rounds the operands of a
convolution or a matrix product (precision.py).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


# ---- shapes --------------------------------------------------------------

def _resnet_shapes(arch) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    w = arch["width"]

    def bn(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    out["backbone.stem_conv.weight"] = (w, 3, 7, 7)
    bn("backbone.stem_bn", w)
    cin = w
    for i, n in enumerate(arch["stage_sizes"]):
        filters = w * 2 ** i
        for j in range(n):
            p = f"backbone.stage{i + 1}_block{j + 1}"
            stride = 2 if i > 0 and j == 0 else 1
            cout = 4 * filters
            out[f"{p}.conv1.weight"] = (filters, cin, 1, 1)
            bn(f"{p}.bn1", filters)
            out[f"{p}.conv2.weight"] = (filters, filters, 3, 3)
            bn(f"{p}.bn2", filters)
            out[f"{p}.conv3.weight"] = (cout, filters, 1, 1)
            bn(f"{p}.bn3", cout)
            if stride != 1 or cin != cout:
                out[f"{p}.downsample_conv.weight"] = (cout, cin, 1, 1)
                bn(f"{p}.downsample_bn", cout)
            cin = cout
    return out


def _vit_shapes(arch, image_size: int) -> Dict[str, Tuple[int, ...]]:
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
    if arch["family"] == "resnet":
        return arch["width"] * 2 ** (len(arch["stage_sizes"]) - 1) * 4
    return arch["width"]


def param_shapes(conf) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of every trained parameter of the BYOL net that
    the configuration ``conf`` describes."""
    arch, heads = conf["arch"], conf["heads"]
    out = (_resnet_shapes(arch) if arch["family"] == "resnet"
           else _vit_shapes(arch, conf["image_size"]))
    feat, hid, proj = (feature_dim(arch), heads["head_latent_size"],
                       heads["projection_size"])
    for head, cin in (("projector", feat), ("predictor", proj)):
        out[f"{head}.dense1.weight"] = (hid, cin)
        out[f"{head}.dense1.bias"] = (hid,)
        out[f"{head}.bn.weight"] = (hid,)
        out[f"{head}.bn.bias"] = (hid,)
        out[f"{head}.dense2.weight"] = (proj, hid)
        out[f"{head}.dense2.bias"] = (proj,)
    out["probe.classifier.weight"] = (conf["num_classes"], feat)
    out["probe.classifier.bias"] = (conf["num_classes"],)
    return out


# ---- layers --------------------------------------------------------------

def _bn(x, w: Weights, name: str):
    return F.batch_norm(x, None, None, w[f"{name}.weight"], w[f"{name}.bias"],
                        training=True, eps=1e-5)


def _linear(x, w: Weights, name: str, cast):
    return F.linear(cast(x), cast(w[f"{name}.weight"]), w[f"{name}.bias"])


def _conv(x, w: Weights, name: str, cast, stride=1, padding=0):
    return F.conv2d(cast(x), cast(w[f"{name}.weight"]), stride=stride,
                    padding=padding)


# ---- encoders ------------------------------------------------------------

def resnet(w: Weights, images: torch.Tensor, arch, cast) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, w, "backbone.stem_conv", cast, 2, 3), w,
                   "backbone.stem_bn"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for i, n in enumerate(arch["stage_sizes"]):
        for j in range(n):
            p = f"backbone.stage{i + 1}_block{j + 1}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(_bn(_conv(x, w, f"{p}.conv1", cast), w, f"{p}.bn1"))
            y = F.relu(_bn(_conv(y, w, f"{p}.conv2", cast, stride, 1), w,
                           f"{p}.bn2"))
            y = _bn(_conv(y, w, f"{p}.conv3", cast), w, f"{p}.bn3")
            if f"{p}.downsample_conv.weight" in w:
                x = _bn(_conv(x, w, f"{p}.downsample_conv", cast, stride), w,
                        f"{p}.downsample_bn")
            x = F.relu(y + x)
    return x.mean(dim=(2, 3))


def _attention(x, w: Weights, name: str, heads: int, cast):
    b, s, d = x.shape
    qkv = _linear(x, w, f"{name}.qkv", cast).reshape(b, s, 3, heads,
                                                     d // heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scores = torch.matmul(cast(q), cast(k).transpose(-1, -2)) / math.sqrt(
        d // heads)
    out = torch.matmul(cast(torch.softmax(scores, dim=-1)), cast(v))
    return _linear(out.transpose(1, 2).reshape(b, s, d), w, f"{name}.proj",
                   cast)


def _ln(x, w: Weights, name: str):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], eps=1e-6)


def vit(w: Weights, images: torch.Tensor, arch, cast) -> torch.Tensor:
    p, d = arch["patch"], arch["width"]
    x = F.conv2d(cast(images.permute(0, 3, 1, 2)),
                 cast(w["backbone.patch_embed.weight"]),
                 w["backbone.patch_embed.bias"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([w["backbone.cls_token"].expand(x.shape[0], 1, d), x], 1)
    x = x + w["backbone.pos_embedding"]
    for i in range(arch["depth"]):
        b = f"backbone.block{i}"
        x = x + _attention(_ln(x, w, f"{b}.ln1"), w, f"{b}.attn",
                           arch["heads"], cast)
        h = F.gelu(_linear(_ln(x, w, f"{b}.ln2"), w, f"{b}.mlp.fc1", cast),
                   approximate="tanh")
        x = x + _linear(h, w, f"{b}.mlp.fc2", cast)
    return _ln(x, w, "backbone.ln_final")[:, 0]


def represent(w: Weights, images: torch.Tensor, conf, cast) -> torch.Tensor:
    arch = conf["arch"]
    fn = resnet if arch["family"] == "resnet" else vit
    return fn(w, images, arch, cast)


def head(w: Weights, x: torch.Tensor, name: str, cast) -> torch.Tensor:
    h = F.relu(_bn(_linear(x, w, f"{name}.dense1", cast), w, f"{name}.bn"))
    return _linear(h, w, f"{name}.dense2", cast)


def probe(w: Weights, representation: torch.Tensor, cast) -> torch.Tensor:
    return _linear(representation.detach(), w, "probe.classifier", cast)
