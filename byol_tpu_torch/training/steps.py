"""BYOL train and eval steps (counterpart of byol_tpu/training/steps.py).

One train step, as the JAX step computes it:

0. under ``augment_in_step`` the batch is raw uint8 images, and both views
   are made here on the device from draws that depend only on (aug_seed,
   step, microbatch): through kernel K2 (ops/fused_augment.py) under
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
6. the update: with ``fused_update`` (lars_momentum at clip 0 only) the
   kernels K1a + K1b (ops/fused_update.py) do the LARS chain and the EMA
   tick in one pass over the flat buffers; without it, the optimizer's
   chain (optim/transforms.py: any registry entry, behind an optional
   value clip; the split K1a gives LARS and LAMB their per-leaf norms) on
   the flat buffers and the EMA tick in plain torch ops.  The EMA averages
   the post-update params, or the pre-update ones under
   ``ema_update_mode='reference_pre'``.  Under ``polyak_ema`` a Polyak
   average of the post-update params ticks after it, a plain torch op on
   its flat buffer.

Gradient accumulation (``accum_steps`` k > 1) splits the batch into k
STRIDED microbatches (microbatch i takes rows i, i+k, ...) and runs steps
0-5 once per microbatch: each backward adds its microbatch's gradients to
the flat buffer, which is zeroed once per optimizer step and divided by k
after the last microbatch, and each microbatch's graph and views are
freed before the next one's forward.  Metrics are the mean over the
microbatches.  Then ONE update (step 6): the counters, the lr schedule and
tau see optimizer steps.  ``accum_bn_mode`` sets the BatchNorm running
statistics:

- ``average``: every microbatch starts from the step's input statistics;
  the statistics written are the mean of the k ticked results;
- ``microbatch``: the statistics tick k times in sequence;
- ``global``: exact big-batch semantics.  The JAX step syncs every
  BatchNorm over the vmapped microbatches; here the k microbatches,
  concatenated in microbatch order (views made per microbatch), run as
  ONE batch.  It costs the big batch's memory, as in JAX.

Telemetry (``telemetry`` 'epoch' | 'step'): each microbatch's forward
also computes the collapse signature of its stop-grad target projections
(``health.collapse_stats`` of both views' rows; under 'global' one value
per microbatch's row chunk), mean-accumulated like the metrics; after the
update the step packs the health vector (observability/health.py) into
``metrics['health']``: the averaged gradient's norm (before any clip),
the applied update's (``lr |m'|`` under ``fused_update``, the chain's own
update's otherwise), the post-step params', the params' distance to the
ticked target, the trust ratios the update applied (K1a's own under
``fused_update``, LARS's for a ``lars_*`` chain, ones(1) for a bare one),
the non-finite count of gradient and loss, and the loss.  With
``telemetry='off'`` none of it runs and ``metrics`` has today's five
keys.

Data parallel (parallel/): inside a process group every rank runs this
step on its data rank's rows of the global batch (``L = global / D`` for
the mesh's data axis of D; the ranks of a sequence group hold the same
rows and share the step's work only inside ring attention), and the
step computes what the JAX package's GSPMD step computes on the global
batch, where every mean over the batch is a global mean over the data
axis (never the world, which would count a sequence group's rows N
times):

- BatchNorm statistics span the data ranks at D > 1
  (models/layers.py::BatchNorm), and so do the reference loss's
  Frobenius norms (objectives/byol_loss.py), both differentiably;
- under step placement each rank draws for the GLOBAL microbatch and
  keeps its data rank's rows, so its views are the rows JAX makes at the
  same global positions (data rank d's strided microbatch i is block d
  of the global microbatch i, given ``L % k == 0``);
- ONE all-reduce (mean over the data axis) of the flat gradient buffer
  per optimizer step,
  after the last microbatch's backward (not DDP: the gradients already
  sit in one flat buffer), or under ZeRO-1 its reduce-scatter and the
  sharded update (parallel/zero1.py);
- the metrics are all-reduced to their global means, and the health
  vector's norms and collapse signature are the global batch's.

Tensor parallel (``--model-parallel`` M > 1): the ranks of a model group
hold the same rows and the same draws, and the state's heads are their
shards (models/heads.py), so each rank's forward gives the whole
projections and predictions and its backward the replicated leaves'
whole gradients; the data-axis collectives above run over the data group
(the ranks of one model index).  The unfused chain's per-leaf norms and
dots and the health vector's norms and counts are summed over the model
group, each replicated leaf counted once (parallel/partitioning.py::
ModelShards).  The metrics are the data axis's: the model ranks hold the
same ones.  ``fused_update`` is refused there, as in JAX.

Without a process group (one card) none of these collectives runs, and the
step is the one-device step it always was.

lr and tau are computed on the host from the schedule count and
``ema_step``, the augmentation draws on the host's generator; the step
reads nothing back from the device.  It returns the
metrics as device scalars.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from byol_tpu_torch.core.config import FUSED_UPDATE_MODEL_PARALLEL
from byol_tpu_torch.core.precision import FP32, Policy, at_least_fp32
from byol_tpu_torch.data import device_augment
from byol_tpu_torch.objectives.byol_loss import loss_function
from byol_tpu_torch.objectives.metrics import cross_entropy, topk_accuracy
from byol_tpu_torch.observability import health as health_lib
from byol_tpu_torch.ops import fused_augment as fused_aug_lib
from byol_tpu_torch.ops import fused_update as fused_lib
from byol_tpu_torch.optim.factory import (MOMENTUM_DECAY, Chain,
                                          fused_update_unsupported_reason)
from byol_tpu_torch.optim.schedules import cosine_ema_decay
from byol_tpu_torch.parallel import collectives, mesh
from byol_tpu_torch.training.linear_eval import normalize_images
from byol_tpu_torch.training.state import TrainState

Metrics = Dict[str, torch.Tensor]
# (step, batch, height, width, microbatch) -> both views' draws, on the CPU
DrawViews = Callable[[int, int, int, int, int],
                     Tuple[device_augment.ViewParams,
                           device_augment.ViewParams]]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    total_train_steps: int
    base_decay: float = 0.996
    norm_mode: str = "paper"               # Quirk Q2
    fuse_views: bool = False
    polyak_ema: float = 0.0                # Polyak decay; 0 = off
    ema_update_mode: str = "post"          # 'post' | 'reference_pre'
    accum_steps: int = 1                   # microbatches per optimizer step
    accum_bn_mode: str = "average"         # 'average'|'microbatch'|'global'
    normalize_inputs: bool = False         # Quirk Q3
    fused_update: bool = False             # K1a + K1b instead of the chain
    augment_in_step: bool = False          # batch = raw uint8 images
    fused_augment: bool = False            # K2 instead of the unfused chain
    image_size: int = 0                    # view size under augment_in_step
    color_jitter_strength: float = 1.0
    aug_seed: int = 0                      # seed of the in-step draws
    telemetry: str = "off"                 # 'off' | 'epoch' | 'step'
    # the chain is lars_<base> (factory.is_lars_optimizer): its trust
    # ratios are the health vector's, ones(1) otherwise
    lars_in_chain: bool = True
    # --check-numerics: backward under autograd's anomaly mode, and the
    # loss and the updated params checked for non-finite values each step
    check_numerics: bool = False


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


def microbatch_split(x: torch.Tensor, k: int) -> List[torch.Tensor]:
    """``(B, ...)`` -> k strided views: microbatch i takes rows i, i+k, ...
    (the JAX step's ``_microbatch_split``)."""
    b = x.shape[0]
    if b % k:
        raise ValueError(f"batch {b} not divisible by accum_steps {k}")
    return [x[i::k] for i in range(k)]


def make_train_step(tx: Chain, scfg: StepConfig,
                    lr_schedule: Callable[[int], float],
                    policy: Policy = FP32,
                    draw_views: Optional[DrawViews] = None
                    ) -> Callable[[TrainState, Metrics], Metrics]:
    """``train_step(state, batch) -> metrics``; updates ``state`` in place.

    ``batch`` = {'view1', 'view2': (B, H, W, C) float [0, 1], 'label':
    (B,) int} on the state's device, or under ``augment_in_step``
    {'images': (B, H, W, C) uint8, 'label'}.  ``draw_views`` gives each
    microbatch's draws (default: ``device_augment.step_views`` of
    ``aug_seed``); tests pass draws made elsewhere through it."""
    if scfg.ema_update_mode not in ("post", "reference_pre"):
        raise ValueError(
            f"unknown ema_update_mode {scfg.ema_update_mode!r}")
    if scfg.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {scfg.accum_steps}")
    if scfg.accum_bn_mode not in ("average", "microbatch", "global"):
        raise ValueError(f"unknown accum_bn_mode {scfg.accum_bn_mode!r}")
    if scfg.telemetry not in ("off", "epoch", "step"):
        raise ValueError(f"unknown telemetry {scfg.telemetry!r}")
    telemetry = scfg.telemetry != "off"
    if scfg.augment_in_step and scfg.image_size <= 0:
        raise ValueError(
            "augment_in_step requires image_size > 0 (the augment target "
            f"size), got {scfg.image_size}")
    if scfg.fused_augment:
        if not scfg.augment_in_step:
            raise ValueError(
                "fused_augment=True requires augment_in_step=True: the "
                "kernel fuses the IN-STEP augmentation path (raw uint8 "
                "batches); loader placement has no in-step chain to fuse")
        if scfg.accum_bn_mode == "global" and scfg.accum_steps > 1:
            raise ValueError(
                "fused_augment=True with accum_bn_mode='global': the JAX "
                "oracle cannot run the kernel under its microbatch vmap, "
                "and the port keeps its refusal — use 'average' or "
                "'microbatch'")
    if scfg.lars_in_chain != tx.lars:
        raise ValueError(f"StepConfig.lars_in_chain={scfg.lars_in_chain} "
                         f"for optimizer {tx.name!r}")
    if scfg.fused_update:
        reason = fused_update_unsupported_reason(tx.name, tx.clip)
        if reason is not None:
            raise ValueError(f"fused_update=True: {reason}")
    if draw_views is None:
        def draw_views(step, b, h, w, microbatch):
            return device_augment.step_views(scfg.aug_seed, step, b, h, w,
                                             scfg.color_jitter_strength,
                                             microbatch)
    ema_pre = scfg.ema_update_mode == "reference_pre"
    layout = None                   # the kernels' device-side segment map
    shards = None                   # the model axis's counted rows (M > 1)
    rank, world = mesh.process_info()
    grouped = mesh.is_initialized()
    synced = world > 1              # global statistics change the arithmetic

    def two_views(state: TrainState, part: Mapping[str, torch.Tensor],
                  microbatch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both views of one microbatch: made here on its device from its
        raw images and its draws, or the batch's own under loader
        placement."""
        if "images" not in part:
            return part["view1"], part["view2"]
        # a strided microbatch is not contiguous; K2 reads a dense batch
        images = part["images"].contiguous()
        b, h, w = images.shape[:3]
        # the global microbatch's draws; this rank's rows are block r
        drawn = draw_views(state.step, b * world, h, w, microbatch)
        if world > 1:
            drawn = tuple(device_augment.ViewParams(
                *(f[rank * b:(rank + 1) * b] for f in v)) for v in drawn)
        views = device_augment.to_device(drawn, images.device)
        two_view = (fused_aug_lib.fused_two_view if scfg.fused_augment
                    else device_augment.two_view)
        return two_view(images, scfg.image_size, views,
                        strength=scfg.color_jitter_strength)

    def forward_backward(state: TrainState, part: Mapping[str, torch.Tensor],
                         microbatch: int, chunks: int = 1) -> Metrics:
        """Forward and backward of one microbatch (the whole batch when
        k = 1): its gradients are ADDED to ``state.grads``; returns its
        metrics, detached.  Its views and graph die with this call.
        ``chunks`` > 1 ('global'): the batch is that many microbatches in
        order, and the BYOL loss is their mean, as in JAX, where each
        microbatch's loss sees its own rows (the reference loss's norms
        span the rows it is given)."""
        aug1, aug2 = _views(*two_views(state, part, microbatch), policy,
                            scfg.normalize_inputs)
        with torch.no_grad():
            state.target_net.train()
            tgt1, tgt2 = _forward_views(state.target_net, aug1, aug2,
                                        scfg.fuse_views)
        net = state.net
        net.train()
        on1, on2 = _forward_views(net, aug1, aug2, scfg.fuse_views)
        byol_loss = torch.stack([
            loss_function(*rows, norm_mode=scfg.norm_mode, sync=synced)
            for rows in zip(
                *(t.chunk(chunks) for t in (on1["prediction"],
                                            on2["prediction"],
                                            tgt1["projection"],
                                            tgt2["projection"])))]).mean()
        logits = net.classify(torch.cat([on1["representation"],
                                         on2["representation"]]))
        cls_labels = torch.cat([part["label"], part["label"]])
        cls_loss = cross_entropy(logits, cls_labels)
        total = byol_loss + cls_loss
        if scfg.check_numerics:
            backward_checked(total, state.step)
        else:
            total.backward()
        with torch.no_grad():
            top1, top5 = topk_accuracy(logits, cls_labels)
        metrics = {"loss_mean": total.detach(),
                   "byol_loss_mean": byol_loss.detach(),
                   "linear_loss_mean": cls_loss.detach(),
                   "top1_mean": top1, "top5_mean": top5}
        if telemetry:
            # each microbatch's collapse signature on its own rows, as
            # JAX's per-microbatch step computes it; the leading underscore
            # keeps the pair out of the grapher's *_mean filter
            with torch.no_grad():
                # the global microbatch's rows (all-gathered at world > 1)
                gather = collectives.all_gather if synced else (lambda x: x)
                stats = [health_lib.collapse_stats(torch.cat(
                    [gather(r.contiguous()) for r in rows]))
                    for rows in zip(tgt1["projection"].chunk(chunks),
                                    tgt2["projection"].chunk(chunks))]
            metrics["_collapse_feature_std"] = torch.stack(
                [f for f, _ in stats]).mean()
            metrics["_collapse_cosine_mean"] = torch.stack(
                [c for _, c in stats]).mean()
        return metrics

    def accumulate(state: TrainState, batch: Mapping[str, torch.Tensor]
                   ) -> Metrics:
        """'average' / 'microbatch': one forward and backward per strided
        microbatch; the mean gradient is left in ``state.grads``."""
        k = scfg.accum_steps
        average = scfg.accum_bn_mode == "average"
        stats = list(state.batch_stats().values())
        if average:
            start = [s.clone() for s in stats]
            ticked = [torch.zeros_like(s) for s in stats]
        parts = {name: microbatch_split(v, k) for name, v in batch.items()}
        sums: Metrics = {}
        for i in range(k):
            if average and i:
                torch._foreach_copy_(stats, start)
            m = forward_backward(state, {name: v[i] for name, v in
                                         parts.items()}, i)
            sums = m if i == 0 else {n: sums[n] + v for n, v in m.items()}
            if average:
                torch._foreach_add_(ticked, stats)
        if average:
            torch._foreach_div_(ticked, k)
            torch._foreach_copy_(stats, ticked)
        state.grads.div_(k)
        return {n: v / k for n, v in sums.items()}

    def big_batch(state: TrainState, batch: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """'global': the k microbatches concatenated in microbatch order,
        each one's views made from its own draws."""
        k = scfg.accum_steps
        parts = {name: microbatch_split(v, k) for name, v in batch.items()}
        views = [two_views(state, {name: v[i] for name, v in parts.items()},
                           i) for i in range(k)]
        return {"view1": torch.cat([v[0] for v in views]),
                "view2": torch.cat([v[1] for v in views]),
                "label": torch.cat(parts["label"])}

    def update(state: TrainState, lr: float, tau: float
               ) -> Tuple[torch.Tensor, Callable[[], torch.Tensor]]:
        """The update and the EMA tick, in place; -> (the trust vector,
        the norm of the update applied: ``lr |m'|`` of the fused kernels'
        ``-lr m'``, the chain's own update's otherwise)."""
        nonlocal layout, shards
        z = state.zero1
        if z is not None:
            if scfg.fused_update:
                trust = z.update(
                    state.params, state.grads, state.momentum, state.target,
                    lr=lr, tau=tau, momentum_decay=MOMENTUM_DECAY,
                    trust_coefficient=tx.trust_coefficient, eps=tx.eps,
                    ema_pre=ema_pre)
                return trust, lambda: abs(lr) * z.global_sq_norm(
                    state.momentum).sqrt()
            trust, u = z.update_chain(
                tx, state.params, state.grads, state.opt, state.opt_counts,
                state.target, lr=lr, tau=tau, ema_pre=ema_pre)
            return trust, lambda: z.global_sq_norm(u).sqrt()
        if grouped:
            collectives.grad_allreduce_mean(state.grads)
        if layout is None or layout.seg is not state.seg:
            layout = fused_lib.FusedLayout.build(
                state.seg, tx.weight_decay, state.params.device)
            shards = state.model_shards()
        if scfg.fused_update:
            trust = fused_lib.fused_lars_ema_update_buffers(
                state.params, state.grads, state.momentum, state.target,
                layout, lr=lr, tau=tau, momentum_decay=MOMENTUM_DECAY,
                trust_coefficient=tx.trust_coefficient, eps=tx.eps,
                ema_pre=ema_pre)
            return trust, lambda: abs(lr) * health_lib.global_norm(
                state.momentum)
        if ema_pre:
            state.target.mul_(tau).add_(state.params, alpha=1.0 - tau)
        u, trust = tx.update(state.params, state.grads, state.opt,
                             state.opt_counts, lr=lr, layout=layout,
                             model=shards)
        state.params.add_(u)
        if not ema_pre:
            state.target.mul_(tau).add_(state.params, alpha=1.0 - tau)
        norm = (health_lib.global_norm if shards is None
                else shards.global_norm)
        return trust, lambda: norm(u)

    def train_step(state: TrainState, batch) -> Metrics:
        if scfg.polyak_ema > 0.0 and state.polyak is None:
            raise ValueError("polyak_ema > 0 needs a train state made with "
                             "polyak_ema > 0 (it has no Polyak buffer)")
        if state.optimizer != tx.name:
            raise ValueError(f"the train state holds the state of optimizer "
                             f"{state.optimizer!r}, and the step runs "
                             f"{tx.name!r}")
        if scfg.fused_update and state.model_axis[0] > 1:
            raise ValueError(FUSED_UPDATE_MODEL_PARALLEL)
        state.grads.zero_()
        if scfg.accum_steps == 1:
            metrics = forward_backward(state, batch, 0)
        elif scfg.accum_bn_mode == "global":
            metrics = forward_backward(state, big_batch(state, batch), 0,
                                       chunks=scfg.accum_steps)
        else:
            metrics = accumulate(state, batch)
        if grouped:
            # global means: the ranks hold equal row counts
            with torch.no_grad():
                names = sorted(metrics)
                vec = collectives.psum_(torch.stack(
                    [at_least_fp32(metrics[n]).reshape(()) for n in names]))
                metrics = dict(zip(names, (vec / world).unbind()))
        with torch.no_grad():
            lr = lr_schedule(state.count)
            tau = cosine_ema_decay(state.ema_step, scfg.total_train_steps,
                                   scfg.base_decay)
            trust, update_norm = update(state, lr, tau)
            if scfg.polyak_ema > 0.0:
                d = scfg.polyak_ema
                state.polyak.mul_(d).add_(state.params, alpha=1.0 - d)
            if telemetry:
                metrics = dict(metrics)
                collapse = (metrics.pop("_collapse_feature_std"),
                            metrics.pop("_collapse_cosine_mean"))
                # under ZeRO-1 the mean gradient and the update live on
                # the ranks' ranges, under TP on the model ranks' shards
                grad_stats, norm = None, health_lib.global_norm
                if state.zero1 is not None:
                    grad_stats = state.zero1.grad_stats()
                elif shards is not None:
                    grad_stats = (shards.global_norm(state.grads),
                                  shards.nonfinite_count(state.grads))
                    norm = shards.global_norm
                metrics["health"] = health_lib.health_stats(
                    grads=state.grads, params=state.params,
                    target_params=state.target, loss=metrics["loss_mean"],
                    collapse=collapse, trust_ratios=trust,
                    update_norm=update_norm(), grad_stats=grad_stats,
                    norm=norm)
        if scfg.check_numerics:
            check_finite(state.step, loss=metrics["loss_mean"],
                         params=state.params)
        state.count += 1
        state.step += 1
        state.ema_step += 1
        return metrics

    return train_step


def backward_checked(loss: torch.Tensor, step: int) -> None:
    """``loss.backward()`` under ``torch.autograd.detect_anomaly(check_nan=
    True)`` (``--check-numerics``, the port's ``jax_debug_nans``): a
    backward function that returns a non-finite value raises
    FloatingPointError naming the step."""
    with torch.autograd.detect_anomaly(check_nan=True):
        try:
            loss.backward()
        except RuntimeError as e:
            if "nan" not in str(e).lower():
                raise
            raise FloatingPointError(
                f"--check-numerics: step {step}: {e}") from e


def check_finite(step: int, **tensors: torch.Tensor) -> None:
    """Raise FloatingPointError naming the step and the tensors with a
    non-finite value (one readback of a few flags)."""
    flags = torch.stack([torch.isfinite(t).all() for t in tensors.values()])
    bad = [name for name, ok in zip(tensors, flags.tolist()) if not ok]
    if bad:
        raise FloatingPointError(f"--check-numerics: step {step}: "
                                 f"non-finite {', '.join(bad)}")


def make_eval_step(scfg: StepConfig, policy: Policy = FP32
                   ) -> Callable[[TrainState, Metrics], Metrics]:
    """Eval: the full BYOL loss, the probe on view-1 representations with
    un-doubled labels, BatchNorm on the running statistics, nothing
    updated; the online forward and the probe use the Polyak params when
    ``polyak_ema`` is on.  An optional ``mask`` (B,) restricts every metric
    to the valid rows of a padded batch; ``_weight`` is the number of those
    rows."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Metrics:
        aug1, aug2 = _views(batch["view1"], batch["view2"], policy,
                            scfg.normalize_inputs)
        labels = batch["label"]
        mask = batch.get("mask")
        online = state.net
        if scfg.polyak_ema > 0.0:
            if state.polyak_net is None:
                raise ValueError("polyak_ema > 0 needs a train state made "
                                 "with polyak_ema > 0 (it has no Polyak "
                                 "net)")
            online = state.polyak_net
        online.eval()
        state.target_net.eval()
        on1, on2 = _forward_views(online, aug1, aug2, scfg.fuse_views)
        tgt1, tgt2 = _forward_views(state.target_net, aug1, aug2,
                                    scfg.fuse_views)
        byol_loss = loss_function(on1["prediction"], on2["prediction"],
                                  tgt1["projection"], tgt2["projection"],
                                  norm_mode=scfg.norm_mode, mask=mask)
        logits = online.classify(on1["representation"])
        cls_loss = cross_entropy(logits, labels, mask=mask)
        top1, top5 = topk_accuracy(logits, labels, mask=mask)
        weight = (mask.sum() if mask is not None
                  else torch.tensor(float(labels.shape[0]),
                                    device=labels.device))
        return {"loss_mean": byol_loss + cls_loss,
                "byol_loss_mean": byol_loss, "linear_loss_mean": cls_loss,
                "top1_mean": top1, "top5_mean": top5, "_weight": weight}

    return eval_step
