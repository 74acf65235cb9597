"""The training loop (counterpart of byol_tpu/training/trainer.py), cut
to what one device and this slice need:

- the epoch loop runs exactly ``steps_per_train_epoch`` optimizer steps
  (wrapping the loader if it runs short), or one under ``debug_step``;
- one eval pass per epoch, every batch padded to the train batch with a
  validity mask (one shape, pad rows out of every metric);
- one line per epoch: loss, BYOL and linear-probe losses, top-1/5, wall
  ms per step and images per second, then the same metrics on the test set.

The metrics stay on the device during an epoch and are read back once at
its end, after a synchronise, so the step time is the device's as well as
the host's.  Checkpointing, telemetry, spans and preemption handling are
not ported yet (ROADMAP.md, section 1 items 8 and 13).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from byol_tpu_torch.core.config import Config, resolve
from byol_tpu_torch.data.loader import LoaderBundle, get_loader, pad_batch
from byol_tpu_torch.training.build import setup_training
from byol_tpu_torch.training.state import TrainState


@dataclasses.dataclass
class FitResult:
    state: TrainState
    epoch: int
    train_metrics: Dict[str, float]
    test_metrics: Dict[str, float]
    step_losses: List[float]        # every optimizer step's loss, in order
    step_ms: float                  # wall ms per step, last epoch
    images_per_sec: float           # last epoch


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
    """Train per the config on ``device``; returns the final state and the
    last epoch's metrics."""
    # one device: the data axis is 1 (the JAX trainer sizes it to the
    # devices it finds)
    cfg = cfg.replace(device=dataclasses.replace(cfg.device, num_replicas=1))
    if loader is None:
        loader = get_loader(cfg)
    rcfg = resolve(cfg, num_train_samples=loader.num_train_samples,
                   num_test_samples=loader.num_test_samples,
                   output_size=loader.output_size,
                   input_shape=loader.input_shape)
    _, state, train_step, eval_step, _ = setup_training(rcfg, device)
    if verbose:
        print(f"model: {cfg.model.arch}, {state.seg.num_segments} parameter "
              f"leaves, {sum(state.seg.sizes) / 1e6:.2f}M params, "
              f"fused_update={cfg.optim.fused_update}, "
              f"half={cfg.device.half}, on {device}", flush=True)
    batch_size = rcfg.global_batch_size
    step_losses: List[float] = []
    train_metrics: Dict[str, float] = {}
    test_metrics: Dict[str, float] = {}
    step_ms = images_per_sec = 0.0
    epoch = 0
    for epoch in range(cfg.task.epochs):
        loader.set_all_epochs(epoch)
        acc, losses = _Sums(), []
        _sync(device)
        t0 = time.perf_counter()
        for batch in _epoch_batches(loader, rcfg.steps_per_train_epoch):
            if epoch == 0 and not losses:
                _range_check(batch, rcfg.input_shape)
            metrics = train_step(state, _to_device(batch, device))
            acc.update(metrics)
            losses.append(metrics["loss_mean"])
            if cfg.device.debug_step:
                break
        _sync(device)
        elapsed = time.perf_counter() - t0
        train_metrics = acc.result()
        step_losses.extend(float(x) for x in losses)
        step_ms = elapsed * 1e3 / len(losses)
        images_per_sec = batch_size * len(losses) / elapsed

        test = _Sums()
        for batch in loader.test_loader:
            test.update(eval_step(state, _to_device(
                pad_batch(batch, batch_size), device)))
            if cfg.device.debug_step:
                break
        test_metrics = test.result()
        if verbose:
            print(f"epoch {epoch}: train {_fmt(train_metrics)}, "
                  f"{len(losses)} steps, {step_ms:.1f} ms/step, "
                  f"{images_per_sec:.1f} img/s | test {_fmt(test_metrics)}",
                  flush=True)
    return FitResult(state=state, epoch=epoch, train_metrics=train_metrics,
                     test_metrics=test_metrics, step_losses=step_losses,
                     step_ms=step_ms, images_per_sec=images_per_sec)
