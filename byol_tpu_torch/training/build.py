"""Wiring: resolved config -> net, train state, steps (counterpart of
byol_tpu/training/build.py), on this rank's device, laid out by the
compile plan (parallel/compile_plan.py: the data axis, ZeRO-1).  Over a
model axis of M > 1 every rank draws the whole net from the seed and
keeps its model index's shards of the heads (models/byol_net.py::
shard_heads), so a run at M holds exactly the slices of the one-rank
run's weights.  Both backbone families take the remat policy; a
names-based one is checked for its block_out tags by one dry forward
(core/remat.py), as JAX's build traces its forward."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from byol_tpu_torch.core import remat as remat_lib
from byol_tpu_torch.core.config import ResolvedConfig
from byol_tpu_torch.core.precision import get_policy
from byol_tpu_torch.core.rng import split_named
from byol_tpu_torch.models.byol_net import (BYOLNet, build_byol_net,
                                            shard_heads)
from byol_tpu_torch.models.init import apply_weight_init
from byol_tpu_torch.models.registry import get_spec
from byol_tpu_torch.optim.factory import build_optimizer, is_lars_optimizer
from byol_tpu_torch.parallel import partitioning
from byol_tpu_torch.parallel.compile_plan import CompilePlan
from byol_tpu_torch.training.state import TrainState, create_train_state
from byol_tpu_torch.training.steps import (StepConfig, make_eval_step,
                                           make_train_step)


def build_net(rcfg: ResolvedConfig,
              generator: Optional[torch.Generator] = None) -> BYOLNet:
    """The BYOL net on the CPU, its weights drawn from ``generator``
    (default: the ``params`` stream of ``cfg.device.seed``).  Inputs of at
    most 64 px get the CIFAR stem, as in the JAX package."""
    cfg = rcfg.cfg
    extra = {"remat": cfg.model.remat, "remat_policy": cfg.model.remat_policy}
    if get_spec(cfg.model.arch).has_batchnorm:
        extra.update(small_inputs=rcfg.input_shape[0] <= 64,
                     zero_init_residual=cfg.parity.zero_init_residual,
                     stem=cfg.model.stem)
    else:                                        # ViT-family knobs
        extra.update(attn_impl=cfg.model.attn_impl, pooling=cfg.model.pooling)
    if generator is None:
        generator = split_named(cfg.device.seed, ("params",))["params"]
    return build_byol_net(
        cfg.model.arch,
        num_classes=rcfg.output_size,
        head_latent_size=cfg.model.head_latent_size,
        projection_size=cfg.model.projection_size,
        dtype=get_policy(cfg.device.half).compute_dtype,
        image_size=rcfg.input_shape[0],
        generator=generator,
        **extra)


def build_tx(rcfg: ResolvedConfig):
    """The optimizer's chain (``--optimizer``, ``--clip``) and its lr
    schedule: warmup in epochs,
    step-granular by default, the epoch staircase under
    ``schedule_granularity='epoch'``."""
    cfg = rcfg.cfg
    epoch_granular = cfg.parity.schedule_granularity == "epoch"
    return build_optimizer(
        cfg.optim.optimizer,
        base_lr=cfg.optim.lr,
        global_batch_size=rcfg.global_batch_size,
        weight_decay=cfg.regularizer.weight_decay,
        total_units=(cfg.task.epochs if epoch_granular
                     else rcfg.total_train_steps),
        warmup_units=(cfg.optim.warmup if epoch_granular
                      else cfg.optim.warmup * rcfg.steps_per_train_epoch),
        lr_schedule_kind=cfg.optim.lr_update_schedule,
        steps_per_epoch=(rcfg.steps_per_train_epoch if epoch_granular
                         else None),
        clip=cfg.optim.clip)


def step_config(rcfg: ResolvedConfig) -> StepConfig:
    cfg = rcfg.cfg
    base_decay = cfg.model.base_decay
    polyak = cfg.regularizer.polyak_ema
    ref_b = cfg.model.ema_scaling_reference_batch
    if ref_b > 0:
        # EMA scaling rule (arXiv 2307.13813): tau -> tau^kappa, for every
        # model EMA: the target's decay and the Polyak average's
        kappa = rcfg.global_batch_size / ref_b
        base_decay = float(base_decay ** kappa)
        if polyak > 0.0:
            polyak = float(polyak ** kappa)
    return StepConfig(
        total_train_steps=rcfg.total_train_steps,
        base_decay=base_decay,
        norm_mode=cfg.parity.loss_norm_mode,
        fuse_views=cfg.model.fuse_views,
        polyak_ema=polyak,
        ema_update_mode=cfg.parity.ema_update_mode,
        accum_steps=cfg.optim.accum_steps,
        accum_bn_mode=cfg.optim.accum_bn_mode,
        normalize_inputs=cfg.parity.normalize_inputs,
        fused_update=cfg.optim.fused_update == "on",
        augment_in_step=cfg.task.augment_placement == "step",
        fused_augment=cfg.task.fused_augment == "on",
        image_size=rcfg.input_shape[0],
        color_jitter_strength=cfg.regularizer.color_jitter_strength,
        aug_seed=cfg.device.seed,
        telemetry=cfg.device.telemetry,
        lars_in_chain=is_lars_optimizer(cfg.optim.optimizer),
        check_numerics=cfg.device.check_numerics)


def validate_remat_tags(net: BYOLNet, rcfg: ResolvedConfig, device,
                        batch: int = 2) -> None:
    """A names-based remat policy must see a block_out tag in the
    backbone's forward, or :class:`~byol_tpu_torch.core.remat.RematTagError`
    (one dry forward without autograd, in eval mode: no statistic
    moves)."""
    cfg = rcfg.cfg
    policy_name = remat_lib.resolve_policy_name(cfg.model.remat,
                                                cfg.model.remat_policy)
    if policy_name not in remat_lib.NAMES_BASED_POLICIES:
        return
    was_training = net.backbone.training
    net.backbone.eval()
    try:
        remat_lib.assert_tags_in_forward(
            net.backbone, torch.zeros((batch,) + tuple(rcfg.input_shape),
                                      device=device),
            policy_name=policy_name)
    finally:
        net.backbone.train(was_training)


def setup_training(rcfg: ResolvedConfig, device,
                   generator: Optional[torch.Generator] = None,
                   plan: Optional[CompilePlan] = None
                   ) -> Tuple[BYOLNet, TrainState, Callable, Callable,
                              Callable[[int], float]]:
    """Returns (net, state, train_step, eval_step, lr_schedule): the net
    built on ``device``, its kernels drawn again under
    ``--weight-initialization`` (from the ``weight_init`` stream of
    ``cfg.device.seed``), its heads cut to the laid-out model axis's
    shards, and flattened into the train state, which
    ``plan`` (default: one rank, no ZeRO-1) prepares: rank 0's weights on
    every rank, and under ZeRO-1 the optimizer's state cut to the rank's
    range."""
    cfg = rcfg.cfg
    size, index = partitioning.model_axis()
    if size != cfg.device.model_parallel:
        raise ValueError(
            f"--model-parallel {cfg.device.model_parallel} on a mesh whose "
            f"model axis is {size}: lay the world out first "
            "(parallel/mesh.py::init_mesh)")
    policy = get_policy(cfg.device.half)
    net = build_net(rcfg, generator)
    if cfg.model.weight_initialization:
        apply_weight_init(
            net, split_named(cfg.device.seed, ("weight_init",))["weight_init"],
            cfg.model.weight_initialization)
    net = shard_heads(net, size, index).to(device)
    validate_remat_tags(net, rcfg, device)
    plan = plan if plan is not None else CompilePlan()
    state = create_train_state(net, ema_init_mode=cfg.parity.ema_init_mode,
                               polyak_ema=cfg.regularizer.polyak_ema,
                               pad_rows_to=plan.pad_rows_to,
                               optimizer=cfg.optim.optimizer)
    plan.prepare(state, weight_decay=cfg.regularizer.weight_decay)
    tx, schedule = build_tx(rcfg)
    scfg = step_config(rcfg)
    return (net, state, make_train_step(tx, scfg, schedule, policy),
            make_eval_step(scfg, policy), schedule)
