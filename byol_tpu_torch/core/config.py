"""Immutable, typed configuration (counterpart of byol_tpu/core/config.py).

Every group, field and default is the JAX package's, so a config means the
same run in both packages.  :func:`resolve` derives the same quantities the
same way (steps per epoch with drop-remainder, total train steps, the
per-replica counts that feed the EMA tau schedule).  It also refuses, with
a message that names ROADMAP.md, the values whose code paths the port does
not have yet: a refused flag never trains with silently different math.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class TaskConfig:
    task: str = "image_folder"
    data_dir: str = "./data"
    batch_size: int = 4096                    # GLOBAL batch
    epochs: int = 3000
    download: bool = False
    image_size_override: Optional[int] = 224
    log_dir: str = "./runs"
    uid: str = ""
    grapher: str = "both"
    data_backend: str = "tf"
    augment_placement: str = "loader"         # loader | step
    fused_augment: str = "off"                # K2: off | on
    num_synth_samples: int = 0
    valid_fraction: float = 0.0


@_frozen
class ModelConfig:
    arch: str = "resnet50"
    representation_size: int = 2048           # derived from the registry
    projection_size: int = 256
    head_latent_size: int = 4096              # projector/predictor hidden
    base_decay: float = 0.996                 # EMA tau_0
    ema_scaling_reference_batch: int = 0
    weight_initialization: Optional[str] = None
    model_dir: str = ".models"
    fuse_views: bool = False                  # both views in one forward
    remat: bool = False
    remat_policy: str = "none"
    stem: str = "conv"                        # ResNet: conv | space_to_depth
    attn_impl: str = "dense"                  # ViT attention: dense | flash
    pooling: str = "cls"                      # ViT feature pooling: cls | gap


@_frozen
class RegularizerConfig:
    color_jitter_strength: float = 1.0
    aug_spec: str = "reference"
    weight_decay: float = 1e-6
    polyak_ema: float = 0.0
    convert_to_sync_bn: bool = True


@_frozen
class OptimConfig:
    clip: float = 0.0                         # grad VALUE clip
    lr: float = 0.2                           # base LR before linear scaling
    lr_update_schedule: str = "cosine"        # fixed | cosine
    warmup: int = 10                          # warmup epochs
    optimizer: str = "lars_momentum"
    early_stop: bool = False
    accum_steps: int = 1
    accum_bn_mode: str = "average"
    fused_update: str = "off"                 # K1a + K1b: off | on


@_frozen
class DeviceConfig:
    num_replicas: int = 8                     # data-parallel size
    workers_per_replica: int = 2
    distributed_master: str = ""
    distributed_rank: int = 0
    distributed_port: int = 29300
    debug_step: bool = False                  # one minibatch per epoch
    seed: int = 1234
    check_numerics: bool = False
    telemetry: str = "off"
    telemetry_interval: int = 50
    nan_policy: str = "warn"
    spans: str = "on"
    fault_at_step: int = 0
    save_on_signal: bool = True
    watchdog_timeout: float = 0.0
    shard_eval: bool = False
    half: bool = True                         # bf16 compute policy
    model_parallel: int = 1
    sequence_parallel: int = 1
    dcn_data_parallel: int = 1
    zero1: str = "off"
    flat_resident: str = "off"
    flat_bucket_mb: int = 64


@_frozen
class ParityConfig:
    loss_norm_mode: str = "paper"             # paper | reference (Quirk Q2)
    ema_init_mode: str = "copy"               # copy | reference (Quirk Q1)
    schedule_granularity: str = "step"        # step | epoch (Quirk Q5)
    normalize_inputs: bool = False            # ImageNet standardization
    ema_update_mode: str = "post"             # post | reference_pre
    zero_init_residual: bool = True           # zero the last BN scale


@_frozen
class Config:
    task: TaskConfig = TaskConfig()
    model: ModelConfig = ModelConfig()
    regularizer: RegularizerConfig = RegularizerConfig()
    optim: OptimConfig = OptimConfig()
    device: DeviceConfig = DeviceConfig()
    parity: ParityConfig = ParityConfig()

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        # strict JSON: a NaN in a config field is a bug worth a ValueError,
        # not a bare NaN token in the serialized config
        return json.dumps(self.to_dict(), indent=2, sort_keys=True,
                          allow_nan=False)


@_frozen
class ResolvedConfig:
    """Config + derived quantities, computed once."""

    cfg: Config
    input_shape: Tuple[int, int, int]         # (H, W, C): NHWC, as the JAX side
    num_train_samples: int                    # per-replica
    num_test_samples: int
    output_size: int                          # number of classes (probe width)
    steps_per_train_epoch: int                # drop-remainder
    total_train_steps: int
    batch_size_per_replica: int
    representation_size: int
    num_valid_samples: int = 0                # per-replica

    @property
    def global_batch_size(self) -> int:
        return self.cfg.task.batch_size

    @property
    def accum_steps(self) -> int:
        return self.cfg.optim.accum_steps

    @property
    def microbatch_size(self) -> int:
        return self.cfg.task.batch_size // self.cfg.optim.accum_steps


# JAX's refusals of what does not compose with --model-parallel > 1
# (byol_tpu/core/config.py::resolve), word for word
ZERO1_MODEL_PARALLEL = (
    "--zero1 on does not compose with --model-parallel > 1 (tensor "
    "parallelism already shards those optimizer-state leaves over the "
    "'model' axis)")
FUSED_UPDATE_MODEL_PARALLEL = (
    "--fused-update on does not compose with --model-parallel > 1 (tensor "
    "parallelism shards head opt-state leaves over 'model'; the fused "
    "kernel's flat buffer would un-shard them every step)")
FLAT_RESIDENT_MODEL_PARALLEL = (
    "--flat-resident on lays the update state out over the data axis; it "
    "does not compose with --model-parallel > 1")
FUSED_AUGMENT_MESH = (
    "--fused-augment on spans the data axis only (the kernel's shard_map "
    "augments each chip's batch shard); model/sequence-parallel meshes are "
    "not yet supported — run those with --fused-augment off")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to byol_tpu_torch yet (ROADMAP.md, {item})")


def refuse_unported(cfg: Config) -> None:
    """The values whose code paths the port does not have yet (the CLI
    asks before it builds anything; ``resolve`` asks again)."""
    if cfg.device.dcn_data_parallel > 1:
        raise _not_ported(
            "--dcn-data-parallel > 1 (NCCL builds its own rings over NVLink "
            "and InfiniBand; the port's data axis is one process group)",
            "section 1 item 10")


def resolve(cfg: Config, *, num_train_samples: int, num_test_samples: int,
            output_size: int, input_shape: Tuple[int, int, int],
            representation_size: Optional[int] = None,
            num_valid_samples: int = 0) -> ResolvedConfig:
    """Derive the load-bearing quantities exactly as the JAX package does:

    - per-replica batch = global batch // num_replicas;
    - per-replica train (valid) samples = samples // num_replicas;
    - steps_per_train_epoch = per-replica samples // per-replica batch;
    - total_train_steps = epochs * steps_per_train_epoch.
    """
    n_rep = cfg.device.num_replicas
    if cfg.task.batch_size % n_rep != 0:
        raise ValueError(f"global batch {cfg.task.batch_size} not divisible "
                         f"by num_replicas {n_rep}")
    accum = cfg.optim.accum_steps
    if accum < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum}")
    if cfg.task.batch_size % (accum * n_rep) != 0:
        raise ValueError(
            f"global batch {cfg.task.batch_size} not divisible by "
            f"accum_steps x num_replicas = {accum} x {n_rep}: each "
            f"replica's {cfg.task.batch_size // n_rep} rows must split "
            f"into {accum} strided microbatches, so that JAX's strided "
            "microbatch i of the global batch is the union over the "
            "replicas of their own microbatch i")
    for value, allowed, what in (
            (cfg.optim.accum_bn_mode, ("average", "microbatch", "global"),
             "accum_bn_mode"),
            (cfg.task.augment_placement, ("loader", "step"),
             "augment_placement"),
            (cfg.device.telemetry, ("off", "epoch", "step"), "telemetry"),
            (cfg.device.nan_policy, ("warn", "halt"), "nan_policy"),
            (cfg.device.spans, ("on", "off"), "spans"),
            (cfg.device.zero1, ("off", "on"), "zero1"),
            (cfg.optim.fused_update, ("off", "on"), "fused_update"),
            (cfg.device.flat_resident, ("off", "on"), "flat_resident"),
            (cfg.task.fused_augment, ("off", "on"), "fused_augment")):
        if value not in allowed:
            raise ValueError(f"unknown {what} {value!r}; "
                             + " | ".join(repr(a) for a in allowed))
    if cfg.device.telemetry_interval < 1:
        raise ValueError(f"telemetry_interval must be >= 1, got "
                         f"{cfg.device.telemetry_interval}")
    tp = cfg.device.model_parallel > 1
    if cfg.device.zero1 == "on" and tp:
        raise ValueError(ZERO1_MODEL_PARALLEL)
    if cfg.optim.fused_update == "on":
        # the kernels implement exactly the lars_momentum chain
        from byol_tpu_torch.optim.factory import (
            fused_update_unsupported_reason)
        reason = fused_update_unsupported_reason(cfg.optim.optimizer,
                                                 cfg.optim.clip)
        if reason is not None:
            raise ValueError(f"--fused-update on: {reason}")
        if tp:
            raise ValueError(FUSED_UPDATE_MODEL_PARALLEL)
    # the port lays the resident buffers out for any chain; with the TP
    # heads it refuses them as JAX does
    if cfg.device.flat_resident == "on" and tp:
        raise ValueError(FLAT_RESIDENT_MODEL_PARALLEL)
    if cfg.device.flat_bucket_mb < 1:
        raise ValueError(f"flat_bucket_mb must be >= 1, got "
                         f"{cfg.device.flat_bucket_mb}")
    if cfg.task.fused_augment == "on":
        if cfg.task.augment_placement != "step":
            raise ValueError(
                "--fused-augment on requires --augment-placement step: "
                "the kernel fuses the IN-STEP augmentation path (raw "
                "uint8 batches augmented inside the accumulation scan); "
                "with loader placement there is no in-step chain to fuse")
        if cfg.optim.accum_bn_mode == "global" and accum > 1:
            raise ValueError(
                "--fused-augment on does not compose with --accum-bn-mode "
                "global: the global oracle vmaps microbatches, and the "
                "augment kernel's pallas_call/shard_map cannot run under "
                "that vmap — use 'average' or 'microbatch'")
        if tp or cfg.device.sequence_parallel > 1:
            raise ValueError(FUSED_AUGMENT_MESH)
    if cfg.device.nan_policy == "halt" and cfg.device.telemetry == "off":
        raise ValueError("--nan-policy halt requires --telemetry epoch|step")
    refuse_unported(cfg)
    from byol_tpu_torch.core.remat import resolve_policy_name
    resolve_policy_name(cfg.model.remat, cfg.model.remat_policy)  # fail fast
    per_replica_batch = cfg.task.batch_size // n_rep
    per_replica_train = num_train_samples // n_rep
    steps_per_epoch = per_replica_train // per_replica_batch
    if steps_per_epoch == 0:
        raise ValueError(
            f"steps_per_train_epoch is 0: {per_replica_train} per-replica "
            f"samples < per-replica batch {per_replica_batch}")
    rep_size = representation_size
    if rep_size is None:
        try:
            from byol_tpu_torch.models.registry import get_spec
            rep_size = get_spec(cfg.model.arch).feature_dim
        except ValueError:
            rep_size = cfg.model.representation_size
    return ResolvedConfig(
        cfg=cfg,
        input_shape=tuple(input_shape),
        num_train_samples=per_replica_train,
        num_test_samples=num_test_samples,
        output_size=output_size,
        steps_per_train_epoch=steps_per_epoch,
        total_train_steps=cfg.task.epochs * steps_per_epoch,
        batch_size_per_replica=per_replica_batch,
        representation_size=rep_size,
        num_valid_samples=num_valid_samples // n_rep,
    )


def run_name(cfg: Config) -> str:
    """Deterministic run name from the config and its uid: the directory
    under ``model_dir`` that holds the run's checkpoints.  The JAX package
    names the same flags the same way, so both packages' runs of one
    config share a directory (the checkpoint store refuses the other
    package's checkpoints)."""
    digest = hashlib.sha1(cfg.to_json().encode()).hexdigest()[:8]
    uid = cfg.task.uid or "byol"
    return f"{uid}_{cfg.model.arch}_b{cfg.task.batch_size}_{digest}"
