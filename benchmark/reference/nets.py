"""BYOL's network as functions of a weight dict: an encoder of the
configuration's family, BYOL's heads and the linear probe.

``arch`` is the configuration file's ``arch`` group.  The encoder of
family ``f`` is ``families/<f>.py``, found by that name; it defines
``param_shapes(arch, image_size)`` (the ``backbone.*`` leaves),
``feature_dim(arch)`` and ``represent(w, images, arch, cast)`` (NHWC
images to (B, feature_dim)).  A new family comes in as a new file there.
Heads (BYOL section 3.3): Linear(in, hidden) -> BatchNorm -> ReLU ->
Linear(hidden, out); the probe is a Linear on the detached
representation.

Images come in NHWC in [0, 1]; every function here takes them as float32
and computes in float32, except where ``cast`` rounds the operands of a
convolution or a matrix product (precision.py).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from reference.layers import Weights, bn, linear


def family(arch):
    """The module of the encoder family ``arch["family"]``:
    ``families/<family>.py``."""
    name = f"reference.families.{arch['family']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no reference encoder for family "
                         f"{arch['family']!r}: families/{arch['family']}.py "
                         f"does not exist") from None


def feature_dim(arch) -> int:
    return family(arch).feature_dim(arch)


def param_shapes(conf) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of every trained parameter of the BYOL net that
    the configuration ``conf`` describes."""
    arch, heads = conf["arch"], conf["heads"]
    out = family(arch).param_shapes(arch, conf["image_size"])
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


def represent(w: Weights, images: torch.Tensor, conf, cast) -> torch.Tensor:
    arch = conf["arch"]
    return family(arch).represent(w, images, arch, cast)


def head(w: Weights, x: torch.Tensor, name: str, cast) -> torch.Tensor:
    h = F.relu(bn(linear(x, w, f"{name}.dense1", cast), w, f"{name}.bn"))
    return linear(h, w, f"{name}.dense2", cast)


def probe(w: Weights, representation: torch.Tensor, cast) -> torch.Tensor:
    return linear(representation.detach(), w, "probe.classifier", cast)
