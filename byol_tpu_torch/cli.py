"""``python -m byol_tpu_torch [flags]``: BYOL pretraining (counterpart of
byol_tpu/cli.py).  The flags keep the JAX package's spellings and defaults;
this slice reads the ones below, the rest of the JAX surface comes later
(ROADMAP.md, section 1 item 15).  ``--download`` is refused when nonzero:
the port reads local files only.

It runs on the card unless ``--no-cuda`` asks for the CPU; with no card and
no ``--no-cuda`` it exits 2 before building anything.  Checkpoints go to
``--model-dir/<run name>``, and a relaunch with the same flags resumes
there; on SIGTERM the run checkpoints and exits 143 (``--no-save-on-signal``
turns that off), and ``--fault-at-step N`` exits at step N without saving.
The data axis is 1 (one card), as the JAX CLI's ``--num-replicas 0``
resolves it on a one-device host, so both name a run of the same flags
alike.

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
                                        OptimConfig, RegularizerConfig,
                                        TaskConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m byol_tpu_torch",
        description="BYOL pretraining on one CUDA card (PyTorch port)")
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
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--warmup", type=int, default=10, help="warmup epochs")
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
                        "kernels K1a + K1b (ops/fused_update.py)")
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
    p.add_argument("--half", action="store_true", default=True,
                   help="bf16 compute (the default)")
    p.add_argument("--no-half", dest="half", action="store_false")
    p.add_argument("--no-cuda", action="store_true",
                   help="run on the CPU")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
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
                          projection_size=args.projection_size,
                          head_latent_size=args.head_latent_size,
                          base_decay=args.base_decay,
                          ema_scaling_reference_batch=(
                              args.ema_scaling_reference_batch),
                          weight_initialization=args.weight_initialization,
                          model_dir=args.model_dir),
        regularizer=RegularizerConfig(
            weight_decay=args.weight_decay,
            color_jitter_strength=args.color_jitter_strength,
            aug_spec=args.aug_spec, polyak_ema=args.polyak_ema),
        optim=OptimConfig(lr=args.lr, warmup=args.warmup,
                          early_stop=args.early_stop,
                          accum_steps=args.accum_steps,
                          accum_bn_mode=args.accum_bn_mode,
                          fused_update=args.fused_update),
        device=DeviceConfig(num_replicas=1,
                            workers_per_replica=args.workers_per_replica,
                            debug_step=args.debug_step,
                            seed=args.seed, half=args.half,
                            fault_at_step=args.fault_at_step,
                            save_on_signal=args.save_on_signal,
                            telemetry=args.telemetry,
                            telemetry_interval=args.telemetry_interval,
                            nan_policy=args.nan_policy, spans=args.spans,
                            watchdog_timeout=args.watchdog_timeout))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from byol_tpu_torch.core.preflight import resolve_device
    try:
        device = resolve_device(args.no_cuda)
    except RuntimeError as e:
        print(f"byol_tpu_torch: {e}", file=sys.stderr)
        return 2
    cfg = config_from_args(args)
    from byol_tpu_torch.data.loader import get_loader
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
    print(f"done: epoch {result.epoch}, test loss "
          f"{result.test_metrics.get('loss_mean', float('nan')):.4f}, "
          f"{result.step_ms:.1f} ms/step, {result.images_per_sec:.1f} img/s "
          f"on {device}", flush=True)
    if args.linear_eval:
        from byol_tpu_torch.observability.watchdog import Watchdog
        from byol_tpu_torch.training.linear_eval import \
            run_linear_eval_from_cfg
        # the trainer's watchdog stopped with fit(); the extraction's
        # readbacks are blocking windows of their own
        with Watchdog(cfg.device.watchdog_timeout) as wd:
            le = run_linear_eval_from_cfg(cfg, result.state, loader=loader,
                                          seed=cfg.device.seed, watchdog=wd)
        print(f"linear_eval(offline): top1 {le.top1:.2f} "
              f"top5 {le.top5:.2f} (train acc {le.train_acc:.2f}, "
              f"{le.num_train} train / {le.num_test} test)", flush=True)
    return 0
