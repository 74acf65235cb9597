"""BYOL's training step (Grill et al. 2020, algorithm 1 with the LARS
optimizer of its section 3.3) from a weight dict, and the embedding that a
frozen encoder serves.

One optimizer step on a batch of ``B`` uint8 images split into ``k``
strided microbatches (microbatch i holds rows i, i + k, ...):

- for each microbatch, both views from its draws (augment.py); the target
  network (the EMA weights) computes both views' projections on their
  batch statistics, without a gradient; the online network computes both
  views' predictions; the loss is the symmetric regression loss
  ``2 - 2 cos`` without the constant, summed over the two pairings and
  averaged over the rows, plus the cross-entropy of a linear probe on the
  detached representations of both views; its gradient is added up;
- the gradient is divided by k (the mean over the microbatches);
- LARS with momentum 0.9: on leaves of more than one dimension, weight
  decay ``g + wd p`` and the trust ratio ``1e-3 |p| / |g + wd p|`` (1
  unless both norms are positive); ``m = 0.9 m + u``; ``p -= lr m``, with
  the learning rate ``lr * B / 256`` under a linear warmup (factor 0 on
  the first step) and a cosine decay;
- the target ``t = tau t + (1 - tau) p`` with ``tau = 1 - (1 - tau0)
  (cos(pi k / K) + 1) / 2``; a Polyak average ``q = d q + (1 - d) p``.

BatchNorm's running statistics are not kept: every forward of a training
step normalises with the batch statistics.

The two views' losses are separable (the targets carry no gradient and
the probe sees detached representations), so each view's graph is freed
before the other's forward: the memory of one view of one microbatch.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from reference import augment, nets

Weights = Dict[str, torch.Tensor]


def _regression(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = pred / (pred.norm(dim=-1, keepdim=True) + 1e-12)
    t = target / (target.norm(dim=-1, keepdim=True) + 1e-12)
    return -2.0 * (p * t).sum(dim=-1)


def lr_at(count: int, conf) -> float:
    """The learning rate of the ``count``-th optimizer step (from 0)."""
    opt = conf["optimizer"]
    warmup = warmup_steps(conf)
    total = opt["epochs"] * (conf["dataset"]["train_samples"]
                             // conf["batch_size"])
    base = opt["lr"] * conf["batch_size"] / 256.0
    if count < warmup:
        return base * count / warmup
    return base * 0.5 * (1.0 + math.cos(math.pi * (count - warmup)
                                        / max(total - warmup, 1)))


def tau_at(step: int, conf) -> float:
    opt = conf["optimizer"]
    total = opt["epochs"] * (conf["dataset"]["train_samples"]
                             // conf["batch_size"])
    return 1.0 - (1.0 - opt["base_decay"]) * (
        math.cos(math.pi * step / total) + 1.0) / 2.0


def _microbatch_grads(online: Weights, target: Weights, images, labels,
                      draws, conf, cast) -> torch.Tensor:
    """Adds one microbatch's gradient to ``online``'s ``.grad``; returns
    its loss."""
    size = conf["image_size"]
    v1, v2 = (augment.view(images, d, size) for d in draws)
    with torch.no_grad():
        t1, t2 = (nets.head(target, nets.represent(target, v, conf, cast),
                            "projector", cast) for v in (v1, v2))
    b = images.shape[0]
    total = 0.0
    for v, other in ((v1, t2), (v2, t1)):
        rep = nets.represent(online, v, conf, cast)
        pred = nets.head(online, nets.head(online, rep, "projector", cast),
                         "predictor", cast)
        logits = nets.probe(online, rep, cast)
        loss = (_regression(pred, other).mean()
                + F.cross_entropy(logits, labels, reduction="sum") / (2 * b))
        loss.backward()
        total += float(loss.detach())
    return total


def warmup_steps(conf) -> int:
    opt = conf["optimizer"]
    return opt["warmup_epochs"] * (conf["dataset"]["train_samples"]
                                   // conf["batch_size"])


def train_steps(weights: Weights, batches: Sequence[Dict[str, torch.Tensor]],
                draws: Callable[[int, int], tuple], conf, cast,
                start: int = 0, rows: slice = slice(None)
                ) -> Dict[str, object]:
    """Runs ``len(batches)`` optimizer steps from ``weights`` (the target
    and the Polyak average start as copies), the first of them the
    ``start``-th of the schedules, and returns what a check compares: each
    step's loss, each leaf's first gradient norm, each leaf's change over
    all the steps of the parameters, the target and (under ``polyak_ema``)
    the Polyak average, and each leaf's momentum norm after them.

    ``draws(step, microbatch)`` gives both views' draws of a microbatch.
    ``rows`` keeps only those rows of each microbatch (a planted fault:
    half of the batch left out)."""
    opt = conf["optimizer"]
    k = opt["accum_steps"]
    online = {n: w.detach().clone().requires_grad_(True)
              for n, w in weights.items()}
    target = {n: w.detach().clone() for n, w in weights.items()}
    momentum = {n: torch.zeros_like(w) for n, w in weights.items()}
    polyak = {n: w.detach().clone() for n, w in weights.items()}
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for step, batch in enumerate(batches):
        for w in online.values():
            w.grad = None
        loss = 0.0
        for i in range(k):
            images = batch["images"][i::k][rows]
            labels = batch["label"][i::k][rows]
            d = tuple(tuple(f[rows] for f in v) for v in draws(step, i))
            loss += _microbatch_grads(online, target, images, labels, d,
                                      conf, cast)
        losses.append(loss / k)
        lr, tau = lr_at(start + step, conf), tau_at(start + step, conf)
        with torch.no_grad():
            grads = {n: w.grad / k for n, w in online.items()}
            if step == 0:
                norms = torch.stack([g.norm() for g in grads.values()])
                first_grad = dict(zip(grads, norms.tolist()))
            for n, p in online.items():
                u = grads[n]
                if p.ndim > 1:
                    u = u + opt["weight_decay"] * p
                    pn, un = p.norm(), u.norm()
                    ratio = torch.where((pn > 0) & (un > 0),
                                        1e-3 * pn / un, torch.ones_like(pn))
                    u = u * ratio
                momentum[n].mul_(0.9).add_(u)
                p.sub_(lr * momentum[n])
                target[n].mul_(tau).add_(p, alpha=1.0 - tau)
                if opt["polyak_ema"] > 0:
                    polyak[n].mul_(opt["polyak_ema"]).add_(
                        p, alpha=1.0 - opt["polyak_ema"])

    def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return dict(zip(leaves, torch.stack(
            [x.norm() for x in leaves.values()]).tolist()))

    with torch.no_grad():
        out = {"loss": losses, "first_grad": first_grad,
               "change": norms({n: online[n] - weights[n] for n in online}),
               "target_change": norms({n: target[n] - weights[n]
                                       for n in target}),
               "momentum": norms(momentum)}
        if opt["polyak_ema"] > 0:
            out["polyak_change"] = norms({n: polyak[n] - weights[n]
                                          for n in polyak})
    return out


@torch.no_grad()
def embed(weights: Weights, images: torch.Tensor, conf, cast,
          block: int = 32) -> torch.Tensor:
    """The frozen encoder's representation of float32 NHWC images in
    [0, 1], ``block`` images at a time."""
    return torch.cat([nets.represent(weights, images[i:i + block], conf,
                                     cast)
                      for i in range(0, images.shape[0], block)])
