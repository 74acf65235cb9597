"""The training loop (counterpart of byol_tpu/training/trainer.py), cut
to what one device needs:

- the epoch loop runs exactly ``steps_per_train_epoch`` optimizer steps
  (wrapping the loader if it runs short), or one under ``debug_step``;
- the train batches come through :func:`prefetch_to_device`: a producer
  thread makes batch N+1 (on the host, or on the card under
  ``data_backend='device'``) and copies it while step N runs; the first
  batch of a run is held to the input contract (``_range_check``);
- one eval pass per epoch on the test split, and on the valid split when
  the loader has one, a microbatch (the train batch when ``accum_steps``
  is 1) at a time, each padded to that size with a validity mask (one
  shape, pad rows out of every metric);
- one line per epoch: loss, BYOL and linear-probe losses, top-1/5, wall
  ms per step and images per second, then the same metrics on the test
  set; then the input pipeline's line (``input[Epoch N]``: H2D MiB per
  step, starved steps, fill) and, with a valid split, a ``valid`` line;
- a checkpoint per epoch through :class:`ModelSaver` under
  ``model_dir/run_name(cfg)``, on the test loss, with burn-in
  ``0.1 * epochs`` and patience 10; early stop (``early_stop``) restores
  the best state and evaluates it again; a relaunch of a stopped run
  restores the best state, evaluates it and trains nothing;
- a relaunch resumes from the last checkpoint.  Data order is a function
  of (seed, epoch) and the in-step augmentation draws of (seed, step), so a
  checkpoint taken mid-epoch resumes exactly: the relaunch re-enters that
  epoch and skips the batches its steps already took;
- SIGTERM (a preemption notice) checkpoints the state at the next step
  boundary as last, never best, and exits 143; ``fault_at_step`` exits
  without saving.

The metrics stay on the device during an epoch and are read back once at
its end, after a synchronise, so the step time is the device's as well as
the host's.  Telemetry and spans are not ported yet (ROADMAP.md, section 1
item 13).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from byol_tpu_torch.checkpoint import ModelSaver
from byol_tpu_torch.core.config import Config, resolve, run_name
from byol_tpu_torch.data.loader import LoaderBundle, get_loader, pad_batch
from byol_tpu_torch.data.prefetch import prefetch_to_device
from byol_tpu_torch.observability.meters import (InputPipelineMeter,
                                                 input_log_line)
from byol_tpu_torch.training.build import setup_training
from byol_tpu_torch.training.state import (TrainState, canonical_state,
                                           load_canonical)


@dataclasses.dataclass
class FitResult:
    state: TrainState
    epoch: int
    train_metrics: Dict[str, float]
    test_metrics: Dict[str, float]
    step_losses: List[float]        # every optimizer step's loss, in order
    step_ms: float                  # wall ms per step, last epoch
    images_per_sec: float           # last epoch
    stopped_early: bool = False
    test_losses: List[float] = dataclasses.field(default_factory=list)
    valid_metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    valid_losses: List[float] = dataclasses.field(default_factory=list)
    input_pipeline: Dict[str, float] = dataclasses.field(
        default_factory=dict)       # the last epoch's InputPipelineMeter


def _range_check(batch, input_shape) -> None:
    """The input contract: raw (B, H, W, C) uint8 images under step
    placement, else views in [0, 1]."""
    if "images" in batch:
        images = batch["images"]
        if images.dtype != np.uint8 or images.ndim != 4 or \
                images.shape[-1] != input_shape[-1]:
            raise ValueError(f"batch images must be (B, H, W, "
                             f"{input_shape[-1]}) uint8, got {images.dtype} "
                             f"{images.shape}")
        return
    for key in ("view1", "view2"):
        lo, hi = float(batch[key].min()), float(batch[key].max())
        if lo < 0.0 or hi > 1.0:
            raise ValueError(f"batch {key} out of [0,1]: min={lo} max={hi}")


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _epoch_batches(loader: LoaderBundle, steps: int) -> Iterator:
    """Exactly ``steps`` batches, wrapping to the loader's start."""
    produced = since_reset = 0
    it = iter(loader.train_loader)
    while produced < steps:
        batch = next(it, None)
        if batch is None:
            if since_reset == 0:
                raise ValueError("train loader yielded no batches")
            it, since_reset = iter(loader.train_loader), 0
            continue
        since_reset += 1
        produced += 1
        yield batch


class _Sums:
    """Device-side running sums of step metrics, weighted per batch."""

    def __init__(self) -> None:
        self.sums: Dict[str, torch.Tensor] = {}
        self.weight: Optional[torch.Tensor] = None
        self.count = 0

    def update(self, metrics: Dict[str, torch.Tensor]) -> None:
        w = metrics.get("_weight")
        for k, v in metrics.items():
            if k == "_weight":
                continue
            v = v * w if w is not None else v
            self.sums[k] = self.sums[k] + v if k in self.sums else v
        if w is not None:
            self.weight = w if self.weight is None else self.weight + w
        self.count += 1

    def result(self) -> Dict[str, float]:
        denom = (float(self.weight) if self.weight is not None
                 else float(self.count))
        return {k: float(v) / denom for k, v in self.sums.items()}


def _fmt(m: Dict[str, float]) -> str:
    return (f"loss {m['loss_mean']:.4f} (byol {m['byol_loss_mean']:.4f}, "
            f"linear {m['linear_loss_mean']:.4f}) top1 {m['top1_mean']:.2f} "
            f"top5 {m['top5_mean']:.2f}")


def fit(cfg: Config, *, device, loader: Optional[LoaderBundle] = None,
        verbose: bool = True) -> FitResult:
    """Train per the config on ``device``, resuming from the run's last
    checkpoint if it has one; returns the final state and the last epoch's
    metrics.  ``step_losses`` and ``test_losses`` hold what this call
    ran."""
    # one device: the data axis is 1 (the JAX trainer sizes it to the
    # devices it finds)
    cfg = cfg.replace(device=dataclasses.replace(cfg.device, num_replicas=1))
    if loader is None:
        loader = get_loader(cfg, device=device)
    rcfg = resolve(cfg, num_train_samples=loader.num_train_samples,
                   num_test_samples=loader.num_test_samples,
                   output_size=loader.output_size,
                   input_shape=loader.input_shape,
                   num_valid_samples=loader.num_valid_samples)
    saver = ModelSaver(
        os.path.join(cfg.model.model_dir, run_name(cfg)),
        early_stop=cfg.optim.early_stop,
        burn_in_interval=int(0.1 * cfg.task.epochs),
        larger_is_better=False,
        max_early_stop_steps=10)
    try:
        return _fit(cfg, rcfg, saver, device, loader, verbose)
    finally:
        saver.close()             # raises if the last write failed


def _fit(cfg: Config, rcfg, saver: ModelSaver, device,
         loader: LoaderBundle, verbose: bool) -> FitResult:
    _, state, train_step, eval_step, _ = setup_training(rcfg, device)
    if verbose:
        print(f"model: {cfg.model.arch}, {state.seg.num_segments} parameter "
              f"leaves, {sum(state.seg.sizes) / 1e6:.2f}M params, "
              f"fused_update={cfg.optim.fused_update}, "
              f"half={cfg.device.half}, on {device}", flush=True)
        if rcfg.accum_steps > 1:
            # every count above the step (state.step, steps per epoch, the
            # lr schedule's count, tau, images/s) is in optimizer steps
            print(f"grad accumulation: {rcfg.accum_steps} microbatches of "
                  f"{rcfg.microbatch_size} (global) per optimizer step, "
                  f"bn_mode={cfg.optim.accum_bn_mode}, effective batch "
                  f"{rcfg.global_batch_size}", flush=True)
    batch_size = rcfg.global_batch_size
    # eval runs a microbatch at a time, each padded to one shape: the same
    # row-weighted means as one padded batch, with the train step's memory
    eval_rows = rcfg.microbatch_size

    def run_eval(batches=None) -> Dict[str, float]:
        sums = _Sums()
        for batch in batches if batches is not None else loader.test_loader:
            for start in range(0, len(batch["label"]), eval_rows):
                rows = {k: v[start:start + eval_rows]
                        for k, v in batch.items()}
                sums.update(eval_step(state, _to_device(
                    pad_batch(rows, eval_rows), device)))
            if cfg.device.debug_step:
                break
        return sums.result()

    if saver.stopped_early:
        # the run already stopped early (the durable marker): evaluate the
        # best state and train nothing
        tree, init_epoch = saver.restore(best=True)
        load_canonical(state, tree)
        test_metrics = run_eval()
        if verbose:
            print(f"run already early-stopped at best epoch "
                  f"{init_epoch - 1}; nothing to train", flush=True)
        return FitResult(state=state, epoch=init_epoch - 1, train_metrics={},
                         test_metrics=test_metrics, step_losses=[],
                         step_ms=0.0, images_per_sec=0.0, stopped_early=True)
    init_epoch = resume_skip = 0
    if saver.has_checkpoint():
        # plain resume continues from LAST: best would discard the training
        # after it and reset the persisted patience on every relaunch
        tree, init_epoch = saver.restore(best=False)
        load_canonical(state, tree)
        saved_epoch = init_epoch - 1
        if not cfg.device.debug_step:
            # a preemption checkpoint lands mid-epoch: re-enter that epoch
            # and skip the batches its steps already took
            done_in_epoch = state.step % rcfg.steps_per_train_epoch
            if done_in_epoch:
                init_epoch -= 1
                resume_skip = done_in_epoch
        if verbose:
            print(f"resumed from the checkpoint of epoch {saved_epoch} at "
                  f"step {state.step} "
                  f"(best loss {saver.best_metric}"
                  + (f", re-entering epoch {init_epoch} at batch "
                     f"{resume_skip}" if resume_skip else "") + ")",
                  flush=True)
    resume_epoch = init_epoch

    preempted = threading.Event()
    # a handler can be installed from the main thread only; elsewhere
    # SIGTERM keeps whatever the process has
    installed = (cfg.device.save_on_signal and threading.current_thread()
                 is threading.main_thread())
    if installed:
        old_sigterm = signal.signal(signal.SIGTERM,
                                    lambda signum, frame: preempted.set())
    epoch = init_epoch

    def maybe_preempt_save() -> None:
        if not preempted.is_set():
            return
        # the epoch is partly trained: saved as last, never best; the
        # relaunch finds step % steps_per_epoch != 0 and resumes exactly
        saver.store.save(epoch, canonical_state(state), is_best=False)
        saver.store.wait()
        print(f"SIGTERM: checkpointed epoch {epoch} at step {state.step}; "
              "exiting 143 for requeue", flush=True)
        raise SystemExit(143)

    step_losses: List[float] = []
    test_losses: List[float] = []
    valid_losses: List[float] = []
    train_metrics: Dict[str, float] = {}
    test_metrics: Dict[str, float] = {}
    valid_metrics: Dict[str, float] = {}
    step_ms = images_per_sec = 0.0
    stopped = checked = False

    def tapped(skip: int) -> Iterator:
        """The epoch's batches after the ``skip`` a resume re-enters past,
        the run's first one held to the input contract.  Runs in the
        prefetch thread."""
        nonlocal checked
        for i, batch in enumerate(
                _epoch_batches(loader, rcfg.steps_per_train_epoch)):
            if i < skip:
                continue
            if not checked:
                _range_check(batch, rcfg.input_shape)
                checked = True
            yield batch

    meter = InputPipelineMeter()
    try:
        for epoch in range(init_epoch, cfg.task.epochs):
            loader.set_all_epochs(epoch)
            skip = resume_skip if epoch == resume_epoch else 0
            acc, losses = _Sums(), []
            meter = InputPipelineMeter()
            _sync(device)
            t0 = time.perf_counter()
            with contextlib.closing(prefetch_to_device(
                    tapped(skip), device, meter=meter)) as batches:
                for batch in batches:
                    metrics = train_step(state, batch)
                    acc.update(metrics)
                    losses.append(metrics["loss_mean"])
                    maybe_preempt_save()
                    if (cfg.device.fault_at_step
                            and state.step == cfg.device.fault_at_step):
                        # fault injection: die mid-epoch without saving, as
                        # a lost worker does; a relaunch resumes from the
                        # last checkpoint
                        raise SystemExit(f"fault injected at step "
                                         f"{state.step} (--fault-at-step)")
                    if cfg.device.debug_step:
                        break
            _sync(device)
            elapsed = time.perf_counter() - t0
            train_metrics = acc.result()
            step_losses.extend(float(x) for x in losses)
            step_ms = elapsed * 1e3 / len(losses)
            images_per_sec = batch_size * len(losses) / elapsed
            # the readback and eval windows are long: a notice landing in
            # them must not wait for the next epoch's first step
            maybe_preempt_save()

            test_metrics = run_eval()
            test_losses.append(test_metrics["loss_mean"])
            maybe_preempt_save()
            if verbose:
                print(f"epoch {epoch}: train {_fmt(train_metrics)}, "
                      f"{len(losses)} steps, {step_ms:.1f} ms/step, "
                      f"{images_per_sec:.1f} img/s | test "
                      f"{_fmt(test_metrics)}", flush=True)
                print(input_log_line(epoch, meter), flush=True)
            if loader.make_valid_iter is not None:
                # early stop keys off the TEST loss, as in the JAX trainer
                valid_metrics = run_eval(loader.valid_loader)
                valid_losses.append(valid_metrics["loss_mean"])
                maybe_preempt_save()
                if verbose:
                    print(f"epoch {epoch}: valid {_fmt(valid_metrics)}",
                          flush=True)
            if saver(test_metrics["loss_mean"], epoch, canonical_state(state)):
                tree, _ = saver.restore(best=True)
                load_canonical(state, tree)
                test_metrics = run_eval()
                stopped = True
                if verbose:
                    print(f"early stop at epoch {epoch}; restored best "
                          f"(loss {saver.best_metric:.4f})", flush=True)
                break
    finally:
        if installed:
            # None: the old handler was not installed from Python
            signal.signal(signal.SIGTERM, old_sigterm if old_sigterm
                          is not None else signal.SIG_DFL)
    return FitResult(state=state, epoch=epoch, train_metrics=train_metrics,
                     test_metrics=test_metrics, step_losses=step_losses,
                     step_ms=step_ms, images_per_sec=images_per_sec,
                     stopped_early=stopped, test_losses=test_losses,
                     valid_metrics=valid_metrics, valid_losses=valid_losses,
                     input_pipeline=meter.result())
