"""``python -m byol_tpu_torch [flags]``: BYOL pretraining (counterpart of
byol_tpu/cli.py).  Every flag of the JAX package's parser is here, with
its spelling, default and choices, and maps to the same ``Config`` field.
What the port has no code path for is refused with a message naming
ROADMAP.md: ``--dcn-data-parallel`` above 1 (before anything is built);
``--download`` when nonzero is refused too (the port reads local files
only).  ``--profile-port P`` lets another shell or machine capture a
trace of the live run (observability/profiling.py): each rank listens on
all interfaces at P plus its local rank, and ``python -m byol_tpu_torch
capture HOST:PORT DURATION_MS --log-dir DIR`` fetches the next whole
steps' trace.
``--remat`` and ``--remat-policy`` checkpoint each residual or encoder
block under JAX's named policies (core/remat.py); ``--sequence-parallel
N`` lays the world out as (data, sequence, model) and shards ViT
attention over the sequence groups under ``--attn-impl ring``
(parallel/ring_attention.py); ``--model-parallel M`` splits the projector
and predictor heads over the model groups (parallel/partitioning.py),
with the unfused update only, as in JAX.
``--visdom-url``/``--visdom-port`` parse, warn and fall back to
``--grapher``, as in JAX.  ``--optimizer`` takes the JAX registry
(rmsprop, adam, adadelta, sgd, momentum, lamb, lbfgs, each bare or as
``lars_<base>``) behind ``--clip``; ``--check-numerics`` runs the backward
under autograd's anomaly mode and checks the loss and params each step.

It runs on the card unless ``--no-cuda`` asks for the CPU; a one-process
launch first probes the card in a killable subprocess
(core/preflight.py), and with no card, a wedged one, and no ``--no-cuda``
it exits 2 before building anything.  Checkpoints go to
``--model-dir/<run name>``, and a relaunch with the same flags resumes
there; on SIGTERM the run checkpoints and exits 143 (``--no-save-on-signal``
turns that off), and ``--fault-at-step N`` exits at step N without saving.
Data parallel over torch.distributed, one process per card: launch with
``torchrun --nproc_per_node N -m byol_tpu_torch ...`` (rank r drives
``cuda:LOCAL_RANK``), or give each process the JAX CLI's
``--distributed-master HOST[:PORT] --distributed-rank R --num-processes
N``.  The data axis is the world size (``--num-replicas 0``, JAX's
default, resolves it as JAX resolves it to the devices it finds).
``--zero1 on`` shards the weight update (parallel/zero1.py),
``--flat-resident on`` gathers its params in ``--flat-bucket-mb``
buckets; ``--shard-eval`` shards the test split.  A failed rendezvous or
collective exits nonzero.

Every run writes ``<--log-dir>/<run name>/run.jsonl`` (the JAX event
schema), ``trace.json`` (the span flight recorder, ``--spans on``) and the
grapher's ``metrics.jsonl``; ``python -m byol_tpu_torch report
<run.jsonl>`` renders its goodput waterfall.  ``--telemetry step|epoch``
adds the health records, and ``--nan-policy halt`` stops the run at a
non-finite gradient or loss with a ``state_dump`` in the log.

``--linear-eval`` runs the offline linear-evaluation protocol after
training (training/linear_eval.py: the frozen encoder's features of the
train and test splits, a fresh linear probe, top-1/5), on the loader the
run trained from, and prints JAX's ``linear_eval(offline):`` line.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from byol_tpu_torch.core.config import (Config, DeviceConfig, ModelConfig,
                                        OptimConfig, ParityConfig,
                                        RegularizerConfig, TaskConfig)
from byol_tpu_torch.parallel.mesh import world_size


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m byol_tpu_torch",
        description="BYOL pretraining on CUDA cards (PyTorch port)")
    p.add_argument("--task", type=str, default="image_folder",
                   help="image_folder | cifar10 | cifar100 | mnist | "
                        "fashion_mnist | digits | fake | synth")
    p.add_argument("--data-dir", type=str, default="./data",
                   help="where the datasets' files are (read only; "
                        "nothing is downloaded)")
    p.add_argument("--download", type=int, default=0,
                   help="refused when nonzero: the port reads local files "
                        "only")
    p.add_argument("--num-synth-samples", type=int, default=0,
                   help="dataset size for --task synth (test = 1/10th); "
                        "0 = default 20000")
    p.add_argument("--valid-fraction", type=float, default=0.0,
                   help="hold out this fraction of train as a validation "
                        "split, evaluated each epoch; image_folder also "
                        "accepts an on-disk valid/ root, which wins")
    p.add_argument("--uid", type=str, default="",
                   help="prefix of the run name (the checkpoint directory)")
    p.add_argument("--log-dir", type=str, default="./runs",
                   help="run.jsonl, trace.json and the grapher's metrics "
                        "go to <log-dir>/<run name>")
    p.add_argument("--grapher", type=str, default="both",
                   choices=("tensorboard", "jsonl", "both", "null"),
                   help="metric writer(s); 'both' writes metrics.jsonl "
                        "alone where the tensorboard package is missing")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--epochs", type=int, default=3000)
    p.add_argument("--image-size-override", type=int, default=224)
    p.add_argument("--arch", type=str, default="resnet50")
    p.add_argument("--representation-size", type=int, default=None,
                   help="derived from the arch registry unless overridden")
    p.add_argument("--projection-size", type=int, default=256)
    p.add_argument("--head-latent-size", type=int, default=4096)
    p.add_argument("--base-decay", type=float, default=0.996)
    p.add_argument("--ema-scaling-reference-batch", type=int, default=0,
                   help="scale tau as tau^(batch/this) so target-EMA "
                        "dynamics stay batch-size invariant (the EMA "
                        "scaling rule, arXiv 2307.13813); 0 = off")
    p.add_argument("--weight-initialization", type=str, default=None,
                   help="draw every Dense/Conv kernel again with this "
                        "scheme (models/init.py); default: keep flax's")
    p.add_argument("--polyak-ema", type=float, default=0.0,
                   help="Polyak average of the params with this decay, "
                        "used by eval; 0 = off")
    p.add_argument("--model-dir", type=str, default=".models",
                   help="checkpoints go to <model-dir>/<run name>")
    p.add_argument("--weight-decay", type=float, default=1e-6)
    p.add_argument("--clip", type=float, default=0.0,
                   help="value-clip the mean gradient to [-clip, clip] "
                        "before the optimizer; 0 = off")
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--lr-update-schedule", type=str, default="cosine",
                   choices=("fixed", "cosine"))
    p.add_argument("--warmup", type=int, default=10, help="warmup epochs")
    p.add_argument("--optimizer", type=str, default="lars_momentum",
                   help="rmsprop | adam | adadelta | sgd | momentum | lamb | "
                        "lbfgs, or lars_<one of them> (LARS around it)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each batch into this "
                        "many strided microbatches, one update per batch; "
                        "--batch-size stays the effective batch and every "
                        "count is in optimizer steps.  1 = off")
    p.add_argument("--accum-bn-mode", type=str, default="average",
                   choices=("average", "microbatch", "global"),
                   help="BN statistics under accumulation: 'average' = one "
                        "tick from the microbatches' mean, 'microbatch' = k "
                        "sequential ticks, 'global' = exact big-batch "
                        "semantics (costs the big batch's memory)")
    p.add_argument("--early-stop", action="store_true",
                   help="stop after 10 epochs without a better test loss "
                        "and restore the best checkpoint")
    p.add_argument("--fused-update", type=str, default="off",
                   choices=("off", "on"),
                   help="'on': the LARS+EMA update runs as the fused "
                        "kernels K1a + K1b (ops/fused_update.py); requires "
                        "--optimizer lars_momentum with --clip 0")
    p.add_argument("--augment-placement", type=str, default="loader",
                   choices=("loader", "step"),
                   help="where two-view train augmentation runs: 'loader' "
                        "= the train iterator yields float32 views; 'step' "
                        "= the loader ships raw uint8 batches and the train "
                        "step augments them on the device")
    p.add_argument("--fused-augment", type=str, default="off",
                   choices=("off", "on"),
                   help="'on': the in-step augmentation runs as the fused "
                        "kernel K2 (ops/fused_augment.py); requires "
                        "--augment-placement step")
    p.add_argument("--color-jitter-strength", type=float, default=1.0)
    p.add_argument("--aug-spec", type=str, default="reference",
                   choices=("reference", "paper"),
                   help="'reference' = the symmetric reference stack; "
                        "'paper' = BYOL's asymmetric recipe (solarize + "
                        "asymmetric blur); 'paper' needs --data-backend tf")
    p.add_argument("--data-backend", type=str, default="tf",
                   choices=("tf", "native", "device"),
                   help="who makes the train views under loader placement: "
                        "'tf' = the torch host path on DataLoader workers, "
                        "'native' = the C++ host pipeline, 'device' = the "
                        "card from host draws")
    p.add_argument("--workers-per-replica", type=int, default=2,
                   help="DataLoader workers (tf) or C++ threads (native)")
    p.add_argument("--debug-step", action="store_true",
                   help="one minibatch per epoch")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--check-numerics", action="store_true",
                   help="fail fast on NaN/inf: the backward runs under "
                        "torch.autograd.detect_anomaly(check_nan=True), and "
                        "the loss and the updated params are checked every "
                        "step (FloatingPointError naming the step); prefer "
                        "--telemetry with --nan-policy, which adds no sync")
    p.add_argument("--fault-at-step", type=int, default=0,
                   help="fault injection: exit at step N without saving "
                        "(tests checkpoint/resume)")
    p.add_argument("--save-on-signal",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="on SIGTERM (a preemption notice) checkpoint at "
                        "the next step and exit 143")
    p.add_argument("--telemetry", type=str, default="off",
                   choices=("off", "epoch", "step"),
                   help="training-health telemetry (observability/"
                        "health.py): 'off' runs the step without it; "
                        "'epoch' reads one health record per epoch after "
                        "the epoch's readback; 'step' reads one every "
                        "--telemetry-interval steps, one interval late, "
                        "adding no sync of its own to the step loop")
    p.add_argument("--telemetry-interval", type=int, default=50,
                   help="optimizer steps between sampled health records "
                        "under --telemetry step")
    p.add_argument("--nan-policy", type=str, default="warn",
                   choices=("warn", "halt"),
                   help="response to a non-finite gradient/loss in the "
                        "health vector: 'warn' records an anomaly event; "
                        "'halt' dumps step/state metadata to the run log "
                        "and raises (requires --telemetry)")
    p.add_argument("--spans", type=str, default="on", choices=("on", "off"),
                   help="host-side span flight recorder: 'on' times every "
                        "hot-loop phase, emits goodput/span_stats events "
                        "into run.jsonl and writes trace.json; 'off' "
                        "records nothing")
    p.add_argument("--watchdog-timeout", type=float, default=0.0,
                   help="seconds without progress before dumping all "
                        "thread stacks and exiting (0 = off)")
    p.add_argument("--linear-eval", action="store_true",
                   help="after training, run the OFFLINE linear-evaluation "
                        "protocol (frozen encoder + fresh probe: the BYOL "
                        "paper's metric)")
    p.add_argument("--convert-to-sync-bn",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="accepted as in the JAX package, where it changes "
                        "nothing: BatchNorm statistics are the global "
                        "batch's at any world size > 1")
    # the data axis (byol_tpu/cli.py's device group)
    p.add_argument("--num-replicas", type=int, default=0,
                   help="data-axis size; 0 = the world size")
    p.add_argument("--num-processes", type=int, default=0,
                   help="the world size for an explicit rendezvous "
                        "(--distributed-master); torchrun sets its own")
    p.add_argument("--distributed-master", type=str, default="",
                   help="HOST or HOST:PORT of rank 0's rendezvous (without "
                        "torchrun)")
    p.add_argument("--distributed-rank", type=int, default=0)
    p.add_argument("--distributed-port", type=int, default=29300)
    p.add_argument("--shard-eval", action="store_true",
                   help="shard the test set across ranks (default: every "
                        "rank holds it whole and the batches are dealt)")
    p.add_argument("--zero1", type=str, default=None, choices=("off", "on"),
                   help="ZeRO-1: 'on' shards the optimizer's state and the "
                        "EMA target's update over the data axis (reduce-"
                        "scatter of the gradient, the update on each rank's "
                        "range: K1a split + K1b under --fused-update on, "
                        "the optimizer's chain otherwise, all-gather of the "
                        "params)")
    p.add_argument("--fsdp", action="store_true",
                   help=argparse.SUPPRESS)  # deprecated alias: --zero1 on
    p.add_argument("--flat-resident", type=str, default="off",
                   choices=("off", "on"),
                   help="the update state is resident and flat already; "
                        "'on' all-gathers the ZeRO-1 params in buckets of "
                        "--flat-bucket-mb")
    p.add_argument("--flat-bucket-mb", type=int, default=64,
                   help="bucket budget in MiB of gathered bytes "
                        "(--flat-resident on)")
    p.add_argument("--dcn-data-parallel", type=int, default=1,
                   help="accepted at 1; > 1 is refused (NCCL builds its "
                        "own rings)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks per model group (the tensor-parallel "
                        "projector and predictor heads); the data axis is "
                        "the world over this")
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="ranks per sequence group (ring attention); the "
                        "data axis is the world over this")
    p.add_argument("--remat", action="store_true",
                   help="per-block rematerialization (alias for "
                        "--remat-policy full)")
    p.add_argument("--remat-policy", type=str, default="none",
                   choices=("none", "full", "nothing", "dots",
                            "dots_no_batch", "save_block_out",
                            "offload_block_out"),
                   help="named per-block checkpoint policy (wins over "
                        "--remat)")
    p.add_argument("--fuse-views", action="store_true",
                   help="one encoder call for both views (changes BN batch "
                        "statistics vs the reference)")
    p.add_argument("--stem", type=str, default="conv",
                   choices=("conv", "space_to_depth"),
                   help="ResNet stem: space_to_depth computes the 7x7/2 "
                        "conv as a 4x4/1 conv on a 2x2 space-to-depth "
                        "input (the same numbers and checkpoints)")
    p.add_argument("--attn-impl", type=str, default="dense",
                   choices=("dense", "flash", "ring"),
                   help="ViT attention: dense, ring (sequence-parallel "
                        "over --sequence-parallel ranks), or flash (kernel "
                        "K3, forward only: serving)")
    p.add_argument("--pooling", type=str, default="cls",
                   choices=("cls", "gap"), help="ViT feature pooling")
    p.add_argument("--loss-norm-mode", type=str, default="paper",
                   choices=("paper", "reference"), help="Quirk Q2 switch")
    p.add_argument("--ema-init-mode", type=str, default="copy",
                   choices=("copy", "reference"), help="Quirk Q1 switch")
    p.add_argument("--schedule-granularity", type=str, default="step",
                   choices=("step", "epoch"), help="Quirk Q5 switch")
    p.add_argument("--ema-update-mode", type=str, default="post",
                   choices=("post", "reference_pre"),
                   help="'post' = paper (EMA of post-update params); "
                        "'reference_pre' = reference (EMA of the pre-update "
                        "params)")
    p.add_argument("--normalize-inputs",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="Quirk Q3 switch: standardize pixels with the "
                        "ImageNet mean/std inside the step")
    p.add_argument("--zero-init-residual",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="zero-init each residual block's last BN scale; "
                        "--no-zero-init-residual matches the reference's "
                        "torchvision init")
    p.add_argument("--profile-port", type=int, default=0,
                   help="serve on-demand trace captures of the live run "
                        "on this port plus the local rank (0=off); fetch "
                        "one with python -m byol_tpu_torch capture "
                        "HOST:PORT DURATION_MS --log-dir DIR")
    # the reference's visdom flags parse for drop-in compatibility; the
    # backend is dropped, and setting them warns and falls back to
    # --grapher
    p.add_argument("--visdom-url", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--visdom-port", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--half", action="store_true", default=True,
                   help="bf16 compute (the default)")
    p.add_argument("--no-half", dest="half", action="store_false")
    p.add_argument("--no-cuda", action="store_true",
                   help="run on the CPU")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    # --fsdp is the pre-ZeRO-1 spelling of --zero1 on; an explicit
    # --zero1 off beside it is a contradiction, not an override
    if args.fsdp and args.zero1 == "off":
        raise SystemExit(
            "cli: --fsdp is the deprecated alias for --zero1 on; it "
            "conflicts with the explicit --zero1 off also passed")
    zero1 = "on" if args.fsdp else (args.zero1 or "off")
    return Config(
        task=TaskConfig(task=args.task, data_dir=args.data_dir,
                        batch_size=args.batch_size, epochs=args.epochs,
                        download=bool(args.download), uid=args.uid,
                        log_dir=args.log_dir, grapher=args.grapher,
                        image_size_override=args.image_size_override,
                        data_backend=args.data_backend,
                        augment_placement=args.augment_placement,
                        fused_augment=args.fused_augment,
                        num_synth_samples=args.num_synth_samples,
                        valid_fraction=args.valid_fraction),
        model=ModelConfig(arch=args.arch,
                          representation_size=(args.representation_size
                                               or 2048),
                          projection_size=args.projection_size,
                          head_latent_size=args.head_latent_size,
                          base_decay=args.base_decay,
                          ema_scaling_reference_batch=(
                              args.ema_scaling_reference_batch),
                          weight_initialization=args.weight_initialization,
                          model_dir=args.model_dir, remat=args.remat,
                          remat_policy=args.remat_policy,
                          fuse_views=args.fuse_views, stem=args.stem,
                          attn_impl=args.attn_impl, pooling=args.pooling),
        regularizer=RegularizerConfig(
            weight_decay=args.weight_decay,
            color_jitter_strength=args.color_jitter_strength,
            aug_spec=args.aug_spec, polyak_ema=args.polyak_ema,
            convert_to_sync_bn=args.convert_to_sync_bn),
        optim=OptimConfig(clip=args.clip, lr=args.lr,
                          lr_update_schedule=args.lr_update_schedule,
                          warmup=args.warmup, optimizer=args.optimizer,
                          early_stop=args.early_stop,
                          accum_steps=args.accum_steps,
                          accum_bn_mode=args.accum_bn_mode,
                          fused_update=args.fused_update),
        # the data axis: what the sequence and model axes leave of the world
        device=DeviceConfig(num_replicas=args.num_replicas or max(
                                world_size() // max(args.sequence_parallel
                                                    * args.model_parallel,
                                                    1), 1),
                            workers_per_replica=args.workers_per_replica,
                            distributed_master=args.distributed_master,
                            distributed_rank=args.distributed_rank,
                            distributed_port=args.distributed_port,
                            shard_eval=args.shard_eval,
                            model_parallel=args.model_parallel,
                            sequence_parallel=args.sequence_parallel,
                            dcn_data_parallel=args.dcn_data_parallel,
                            zero1=zero1,
                            flat_resident=args.flat_resident,
                            flat_bucket_mb=args.flat_bucket_mb,
                            debug_step=args.debug_step,
                            seed=args.seed, half=args.half,
                            check_numerics=args.check_numerics,
                            fault_at_step=args.fault_at_step,
                            save_on_signal=args.save_on_signal,
                            telemetry=args.telemetry,
                            telemetry_interval=args.telemetry_interval,
                            nan_policy=args.nan_policy, spans=args.spans,
                            watchdog_timeout=args.watchdog_timeout),
        parity=ParityConfig(
            loss_norm_mode=args.loss_norm_mode,
            ema_init_mode=args.ema_init_mode,
            schedule_granularity=args.schedule_granularity,
            normalize_inputs=args.normalize_inputs,
            ema_update_mode=args.ema_update_mode,
            zero_init_residual=args.zero_init_residual))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.visdom_url or args.visdom_port:
        print("byol_tpu_torch: the visdom backend is not supported; "
              f"metrics go to --grapher={args.grapher} under --log-dir",
              file=sys.stderr)
    from byol_tpu_torch.parallel import mesh
    # the killable probe precedes every CUDA call of this process: against
    # a wedged GPU runtime the first one blocks forever in native code.  Not
    # for a multi-process launch, whose ranks would all probe the cards at
    # once (JAX skips multi-host runs)
    multi = (bool(args.distributed_master) or mesh.launched_by_torchrun()
             or mesh.is_initialized())
    if not args.no_cuda and not multi:
        from byol_tpu_torch.core import preflight
        if not preflight.preflight_backend():
            print("byol_tpu_torch: accelerator backend unreachable "
                  "(diagnosis above); pass --no-cuda to run on CPU, or "
                  "retry when a probe matmul succeeds.", file=sys.stderr)
            return 2
    try:
        device = mesh.local_device(args.no_cuda)
    except RuntimeError as e:
        print(f"byol_tpu_torch: {e}", file=sys.stderr)
        return 2
    # the rendezvous precedes the config: --num-replicas 0 reads the world
    # size (as the JAX CLI initializes before config_from_args); a failed
    # one raises and the process exits nonzero
    mesh.initialize_distributed(
        device, master=args.distributed_master,
        rank=args.distributed_rank, world_size=args.num_processes,
        port=args.distributed_port)
    try:
        return _run(args, device)
    finally:
        mesh.shutdown()


def _run(args: argparse.Namespace, device) -> int:
    from byol_tpu_torch.core.config import refuse_unported
    from byol_tpu_torch.parallel import mesh
    cfg = config_from_args(args)
    try:
        refuse_unported(cfg)
        # the loader shards over the data axis of the laid-out mesh
        mesh.init_mesh(cfg.device.sequence_parallel,
                       cfg.device.model_parallel)
    except (ValueError, NotImplementedError) as e:
        print(f"byol_tpu_torch: {e}", file=sys.stderr)
        return 2
    server = None
    if args.profile_port:
        from byol_tpu_torch.observability import profiling
        # one process per card (JAX: one per host), so each rank listens
        # on its own port
        port = args.profile_port + mesh.local_rank()
        try:
            server = profiling.start_server(port,
                                            cuda=device.type == "cuda")
        except OSError as e:
            print(f"byol_tpu_torch: --profile-port: cannot listen on port "
                  f"{port}: {e}", file=sys.stderr)
            return 2
        print(f"profile: rank {server.rank} listening on {server.host}:"
              f"{server.port} (all interfaces); capture with python -m "
              f"byol_tpu_torch capture {server.host}:{server.port} "
              f"DURATION_MS --log-dir DIR", flush=True)
    try:
        return _train(args, cfg, device)
    finally:
        if server is not None:
            server.stop()


def _train(args: argparse.Namespace, cfg, device) -> int:
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.training.trainer import fit
    # SystemExit (143 after a SIGTERM checkpoint, or --fault-at-step) is
    # not caught here: it is the process's exit
    try:
        # one loader serves both training and the optional linear eval:
        # at ImageNet scale building it twice doubles the startup scan
        loader = get_loader(cfg, device=device)
        result = fit(cfg, device=device, loader=loader)
    except (ValueError, NotImplementedError) as e:
        print(f"byol_tpu_torch: {e}", file=sys.stderr)
        return 2
    primary = mesh.is_primary()
    if primary:
        print(f"done: epoch {result.epoch}, test loss "
              f"{result.test_metrics.get('loss_mean', float('nan')):.4f}, "
              f"{result.step_ms:.1f} ms/step, {result.images_per_sec:.1f} "
              f"img/s on {device}" + (f" x {mesh.world_size()} ranks"
                                      if mesh.is_initialized() else ""),
              flush=True)
    if args.linear_eval:
        from byol_tpu_torch.observability.watchdog import Watchdog
        from byol_tpu_torch.training.linear_eval import \
            run_linear_eval_from_cfg
        # the trainer's watchdog stopped with fit(); the extraction's
        # readbacks are blocking windows of their own
        with Watchdog(cfg.device.watchdog_timeout) as wd:
            le = run_linear_eval_from_cfg(cfg, result.state, loader=loader,
                                          seed=cfg.device.seed, watchdog=wd)
        if primary:
            print(f"linear_eval(offline): top1 {le.top1:.2f} "
                  f"top5 {le.top5:.2f} (train acc {le.train_acc:.2f}, "
                  f"{le.num_train} train / {le.num_test} test)", flush=True)
    return 0
