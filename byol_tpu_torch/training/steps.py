"""BYOL train and eval steps (counterpart of byol_tpu/training/steps.py),
for ``accum_steps == 1``.

One train step, as the JAX step computes it:

0. under ``augment_in_step`` the batch is raw uint8 images, and both views
   are made here on the device from draws that depend only on (aug_seed,
   step): through kernel K2 (ops/fused_augment.py) under
   ``fused_augment``, else through the unfused chain
   (data/device_augment.py);
1. both views are cast to the compute dtype (and standardised under
   ``normalize_inputs``);
2. the TARGET network runs both views outside autograd, in train mode on
   batch statistics, updating no running statistics;
3. the ONLINE network runs view 1, then view 2 (each ticks the running
   statistics in turn), or both in one forward under ``fuse_views``;
4. loss = the symmetric BYOL loss + the linear probe's cross-entropy on
   the detached representations of both views against the doubled labels;
5. backward: the gradients land, in float32, in the state's flat gradient
   buffer (every ``.grad`` is a view of it);
6. the update: with ``fused_update`` the kernels K1a + K1b
   (ops/fused_update.py) do the LARS chain and the EMA tick in one pass
   over the flat buffers; without it, the unfused chain
   (optim/lars.py) and the EMA tick in plain torch ops.  The EMA averages
   the post-update params, or the pre-update ones under
   ``ema_update_mode='reference_pre'``.

lr and tau are computed on the host from the schedule count and
``ema_step``, the augmentation draws on the host's generator; the step
reads nothing back from the device.  It returns the
metrics as device scalars.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from byol_tpu_torch.core.precision import FP32, Policy
from byol_tpu_torch.data import device_augment
from byol_tpu_torch.objectives.byol_loss import loss_function
from byol_tpu_torch.objectives.metrics import cross_entropy, topk_accuracy
from byol_tpu_torch.ops import fused_augment as fused_aug_lib
from byol_tpu_torch.ops import fused_update as fused_lib
from byol_tpu_torch.optim.factory import MOMENTUM_DECAY, LarsMomentum
from byol_tpu_torch.optim.schedules import cosine_ema_decay
from byol_tpu_torch.training.linear_eval import normalize_images
from byol_tpu_torch.training.state import TrainState

Metrics = Dict[str, torch.Tensor]
# (step, batch, height, width) -> both views' draws, on the CPU
DrawViews = Callable[[int, int, int, int],
                     Tuple[device_augment.ViewParams,
                           device_augment.ViewParams]]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    total_train_steps: int
    base_decay: float = 0.996
    norm_mode: str = "paper"               # Quirk Q2
    fuse_views: bool = False
    ema_update_mode: str = "post"          # 'post' | 'reference_pre'
    normalize_inputs: bool = False         # Quirk Q3
    fused_update: bool = False             # K1a + K1b instead of the chain
    augment_in_step: bool = False          # batch = raw uint8 images
    fused_augment: bool = False            # K2 instead of the unfused chain
    image_size: int = 0                    # view size under augment_in_step
    color_jitter_strength: float = 1.0
    aug_seed: int = 0                      # seed of the in-step draws


def _views(view1, view2, policy: Policy, normalize: bool):
    aug1 = policy.cast_to_compute(view1)
    aug2 = policy.cast_to_compute(view2)
    if normalize:
        aug1, aug2 = normalize_images(aug1), normalize_images(aug2)
    return aug1, aug2


def _forward_views(net, aug1: torch.Tensor, aug2: torch.Tensor, fuse: bool):
    if fuse:
        n = aug1.shape[0]
        out = net(torch.cat([aug1, aug2]))
        return ({k: v[:n] for k, v in out.items()},
                {k: v[n:] for k, v in out.items()})
    return net(aug1), net(aug2)


def make_train_step(tx: LarsMomentum, scfg: StepConfig,
                    lr_schedule: Callable[[int], float],
                    policy: Policy = FP32,
                    draw_views: Optional[DrawViews] = None
                    ) -> Callable[[TrainState, Metrics], Metrics]:
    """``train_step(state, batch) -> metrics``; updates ``state`` in place.

    ``batch`` = {'view1', 'view2': (B, H, W, C) float [0, 1], 'label':
    (B,) int} on the state's device, or under ``augment_in_step``
    {'images': (B, H, W, C) uint8, 'label'}.  ``draw_views`` gives the
    step's draws (default: ``device_augment.step_views`` of ``aug_seed``);
    tests pass draws made elsewhere through it."""
    if scfg.ema_update_mode not in ("post", "reference_pre"):
        raise ValueError(
            f"unknown ema_update_mode {scfg.ema_update_mode!r}")
    if scfg.augment_in_step and scfg.image_size <= 0:
        raise ValueError(
            "augment_in_step requires image_size > 0 (the augment target "
            f"size), got {scfg.image_size}")
    if scfg.fused_augment and not scfg.augment_in_step:
        raise ValueError(
            "fused_augment=True requires augment_in_step=True: the "
            "kernel fuses the IN-STEP augmentation path (raw uint8 "
            "batches); loader placement has no in-step chain to fuse")
    if draw_views is None:
        def draw_views(step, b, h, w):
            return device_augment.step_views(scfg.aug_seed, step, b, h, w,
                                             scfg.color_jitter_strength)
    ema_pre = scfg.ema_update_mode == "reference_pre"
    layout = None                   # the kernels' device-side segment map

    def augment(state: TrainState, images: torch.Tensor):
        """Both views of the raw batch, made on its device."""
        b, h, w = images.shape[:3]
        views = device_augment.to_device(draw_views(state.step, b, h, w),
                                         images.device)
        two_view = (fused_aug_lib.fused_two_view if scfg.fused_augment
                    else device_augment.two_view)
        return two_view(images, scfg.image_size, views,
                        strength=scfg.color_jitter_strength)

    def update(state: TrainState, lr: float, tau: float) -> torch.Tensor:
        nonlocal layout
        if scfg.fused_update:
            if layout is None or layout.seg is not state.seg:
                layout = fused_lib.FusedLayout.build(
                    state.seg, tx.weight_decay, state.params.device)
            return fused_lib.fused_lars_ema_update_buffers(
                state.params, state.grads, state.momentum, state.target,
                layout, lr=lr, tau=tau, momentum_decay=MOMENTUM_DECAY,
                trust_coefficient=tx.trust_coefficient, eps=tx.eps,
                ema_pre=ema_pre)
        if ema_pre:
            state.target.mul_(tau).add_(state.params, alpha=1.0 - tau)
        trust = tx.update(state.leaves(state.params),
                          state.leaves(state.grads),
                          state.leaves(state.momentum), lr=lr,
                          adapted=state.seg.adapted)
        if not ema_pre:
            state.target.mul_(tau).add_(state.params, alpha=1.0 - tau)
        return trust

    def train_step(state: TrainState, batch) -> Metrics:
        labels = batch["label"]
        if scfg.augment_in_step:
            view1, view2 = augment(state, batch["images"])
        else:
            view1, view2 = batch["view1"], batch["view2"]
        aug1, aug2 = _views(view1, view2, policy, scfg.normalize_inputs)
        with torch.no_grad():
            state.target_net.train()
            tgt1, tgt2 = _forward_views(state.target_net, aug1, aug2,
                                        scfg.fuse_views)
        net = state.net
        net.train()
        state.grads.zero_()
        on1, on2 = _forward_views(net, aug1, aug2, scfg.fuse_views)
        byol_loss = loss_function(on1["prediction"], on2["prediction"],
                                  tgt1["projection"], tgt2["projection"],
                                  norm_mode=scfg.norm_mode)
        logits = net.classify(torch.cat([on1["representation"],
                                         on2["representation"]]))
        cls_labels = torch.cat([labels, labels])
        cls_loss = cross_entropy(logits, cls_labels)
        total = byol_loss + cls_loss
        total.backward()
        with torch.no_grad():
            top1, top5 = topk_accuracy(logits, cls_labels)
            lr = lr_schedule(state.count)
            tau = cosine_ema_decay(state.ema_step, scfg.total_train_steps,
                                   scfg.base_decay)
            update(state, lr, tau)
        state.count += 1
        state.step += 1
        state.ema_step += 1
        return {"loss_mean": total.detach(),
                "byol_loss_mean": byol_loss.detach(),
                "linear_loss_mean": cls_loss.detach(),
                "top1_mean": top1, "top5_mean": top5}

    return train_step


def make_eval_step(scfg: StepConfig, policy: Policy = FP32
                   ) -> Callable[[TrainState, Metrics], Metrics]:
    """Eval: the full BYOL loss, the probe on view-1 representations with
    un-doubled labels, BatchNorm on the running statistics, nothing
    updated.  An optional ``mask`` (B,) restricts every metric to the valid
    rows of a padded batch; ``_weight`` is the number of those rows."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Metrics:
        aug1, aug2 = _views(batch["view1"], batch["view2"], policy,
                            scfg.normalize_inputs)
        labels = batch["label"]
        mask = batch.get("mask")
        state.net.eval()
        state.target_net.eval()
        on1, on2 = _forward_views(state.net, aug1, aug2, scfg.fuse_views)
        tgt1, tgt2 = _forward_views(state.target_net, aug1, aug2,
                                    scfg.fuse_views)
        byol_loss = loss_function(on1["prediction"], on2["prediction"],
                                  tgt1["projection"], tgt2["projection"],
                                  norm_mode=scfg.norm_mode, mask=mask)
        logits = state.net.classify(on1["representation"])
        cls_loss = cross_entropy(logits, labels, mask=mask)
        top1, top5 = topk_accuracy(logits, labels, mask=mask)
        weight = (mask.sum() if mask is not None
                  else torch.tensor(float(labels.shape[0]),
                                    device=labels.device))
        return {"loss_mean": byol_loss + cls_loss,
                "byol_loss_mean": byol_loss, "linear_loss_mean": cls_loss,
                "top1_mean": top1, "top5_mean": top5, "_weight": weight}

    return eval_step
