"""Epoch metric accumulation, the epoch log lines, input-pipeline health
and step timing (counterpart of byol_tpu/observability/meters.py).

:class:`MetricAccumulator` sums the step metrics on the device and reads
them back once, at the epoch's end.  :class:`StepTimer` gives images/s
over synchronised intervals, MFU, and the step-time tail of an epoch.

:func:`byol_tpu_torch.data.prefetch.prefetch_to_device` feeds the input
meter:
its producer records the bytes each batch ships to the device and the
queue depth it leaves, its consumer how long the trainer blocked for the
next batch.  A wait above ``starvation_threshold_s`` is a STARVED step:
the card sat idle because the host could not keep up.  The first wait of
an epoch is the pipeline's fill, kept apart from starvation.

The producer thread writes the byte and depth fields, the consumer thread
the wait fields; no field is written by both, and they are read at the
epoch boundary, after the iteration ended.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


class MetricAccumulator:
    """Device-side running sums of step metrics, read back at the epoch's
    end (no host sync per step).

    A metric dict holding ``_weight`` (the valid rows of a padded eval
    batch) is accumulated as a weighted mean: each metric is a mean over
    ``_weight`` rows, so the epoch value is sum(metric * w) / sum(w).
    ``_weight`` never appears in ``result()``."""

    def __init__(self) -> None:
        self._sum: Dict[str, torch.Tensor] = {}
        self._weight: Optional[torch.Tensor] = None
        self.count = 0

    def update(self, metrics: Dict[str, Any]) -> None:
        w = metrics.get("_weight")
        for k, v in metrics.items():
            if k == "_weight":
                continue
            v = v * w if w is not None else v
            self._sum[k] = self._sum[k] + v if k in self._sum else v
        if w is not None:
            self._weight = w if self._weight is None else self._weight + w
        self.count += 1

    def result(self) -> Dict[str, float]:
        """The epoch means, as Python floats (one readback)."""
        denom = (float(self._weight) if self._weight is not None
                 else float(self.count))
        return {k: float(v) / denom for k, v in self._sum.items()}

    def all_reduce(self, keys: Sequence[str], device) -> None:
        """Sum the running sums and weights over the data axis's ranks,
        each of which accumulated its own batches (eval); a rank that had
        none adds zeros.  Every rank then holds the global means."""
        from byol_tpu_torch.parallel.collectives import psum_
        zero = torch.zeros((), device=device)
        weight = self._weight if self._weight is not None else (
            torch.tensor(float(self.count), device=device))
        vec = psum_(torch.stack([self._sum.get(k, zero).float().reshape(())
                                 for k in keys] + [weight.float()]))
        self._sum = dict(zip(keys, vec[:-1].unbind()))
        self._weight = vec[-1]

    def total_weight(self) -> Optional[float]:
        """Total valid rows when the metrics carried ``_weight``."""
        return float(self._weight) if self._weight is not None else None


def epoch_log_line(prefix: str, epoch: int, num_samples: int,
                   elapsed_s: float, metrics: Dict[str, Any]) -> str:
    """The reference's one-line epoch summary (the JAX package's format):
    prefix, epoch, samples, seconds, loss, top1/top5."""
    def get(k):
        v = metrics.get(k)
        return float(v) if v is not None else float("nan")
    return (f"{prefix}[Epoch {epoch}][{num_samples} samples]"
            f"[{elapsed_s:.2f} sec]: loss: {get('loss_mean'):.4f}\t"
            f"byol: {get('byol_loss_mean'):.4f}\t"
            f"linear: {get('linear_loss_mean'):.4f}\t"
            f"top1: {get('top1_mean'):.4f}\ttop5: {get('top5_mean'):.4f}")


class InputPipelineMeter:
    def __init__(self, starvation_threshold_s: float = 0.005) -> None:
        self.starvation_threshold_s = starvation_threshold_s
        self.h2d_bytes = 0           # bytes shipped to the device (producer)
        self.batches_produced = 0
        self._depth_sum = 0          # queue depth samples (producer)
        self.wait_seconds = 0.0      # consumer block time, total
        self.starved_seconds = 0.0   # consumer block time above threshold
        self.starved_steps = 0
        self.batches_consumed = 0
        self.first_fill_seconds = 0.0

    # ---- producer side ----------------------------------------------------
    def record_produced(self, nbytes: int, queue_depth: int) -> None:
        self.h2d_bytes += int(nbytes)
        self._depth_sum += int(queue_depth)
        self.batches_produced += 1

    # ---- consumer side ----------------------------------------------------
    def record_first_fill(self, seconds: float) -> None:
        """The epoch's first wait: producer start-up plus batch 1."""
        self.first_fill_seconds += seconds
        self.batches_consumed += 1

    def record_wait(self, seconds: float) -> None:
        self.wait_seconds += seconds
        if seconds > self.starvation_threshold_s:
            self.starved_seconds += seconds
            self.starved_steps += 1
        self.batches_consumed += 1

    # ---- epoch-boundary readout -------------------------------------------
    def h2d_bytes_per_step(self) -> float:
        return (self.h2d_bytes / self.batches_produced
                if self.batches_produced else 0.0)

    def avg_queue_depth(self) -> float:
        return (self._depth_sum / self.batches_produced
                if self.batches_produced else 0.0)

    def result(self) -> Dict[str, float]:
        return {"h2d_bytes_per_step": self.h2d_bytes_per_step(),
                "input_starved_seconds": self.starved_seconds,
                "input_starved_steps": float(self.starved_steps),
                "input_wait_seconds": self.wait_seconds,
                "input_first_fill_seconds": self.first_fill_seconds,
                "prefetch_queue_depth": self.avg_queue_depth()}


def input_log_line(epoch: int, meter: InputPipelineMeter) -> str:
    """One-line input-pipeline summary next to the train epoch line (the
    JAX package's format)."""
    return (f"input[Epoch {epoch}]"
            f"[{meter.batches_consumed} batches]: "
            f"h2d: {meter.h2d_bytes_per_step() / 2 ** 20:.2f} MiB/step\t"
            f"starved: {meter.starved_seconds:.2f} sec "
            f"({meter.starved_steps} steps)\t"
            f"fill: {meter.first_fill_seconds:.2f} sec\t"
            f"queue depth: {meter.avg_queue_depth():.2f}")


class StepTimer:
    """images/s per card measured over synchronised intervals, MFU, and
    the step-time tail.

    ``record_epoch`` takes an elapsed time that ends after the epoch's
    synchronise and metric readback, so the rate is end to end.
    ``tick()`` stamps one optimizer step without synchronising: on a CUDA
    device it records a timing event on the current stream (the card's
    clock at the point the step's work ends), on the CPU a host timestamp;
    the intervals are read at the epoch's end, after the synchronise.  On
    the card they are the device's step times, where the JAX package's
    dispatch-to-dispatch intervals converge to them only under
    backpressure."""

    def __init__(self, global_batch: int, n_chips: int = 1,
                 device: Any = "cpu"):
        self.global_batch = global_batch
        self.n_chips = max(n_chips, 1)
        self._cuda = torch.device(device).type == "cuda"
        self._rate = 0.0
        self._flops_per_sample: Optional[float] = None
        self._peak_tflops: Optional[float] = None
        # bounded: a pathological epoch must not grow host memory
        self._ticks: "deque[Any]" = deque(maxlen=1 << 16)

    def set_flops(self, flops_per_sample: Optional[float],
                  peak_tflops: Optional[float]) -> None:
        """Arm MFU reporting (observability.flops); either None disarms."""
        self._flops_per_sample = flops_per_sample
        self._peak_tflops = peak_tflops

    @property
    def flops_per_sample(self) -> Optional[float]:
        return self._flops_per_sample

    def mfu(self) -> Optional[float]:
        from byol_tpu_torch.observability.flops import mfu as _mfu
        return _mfu(self._rate, self._flops_per_sample, self._peak_tflops)

    def record_epoch(self, steps: int, elapsed_s: float) -> None:
        """One epoch's synchronised (steps, wall-clock) measurement."""
        if steps > 0 and elapsed_s > 0.0:
            self._rate = (self.global_batch * steps / elapsed_s
                          / self.n_chips)

    def images_per_sec_per_chip(self) -> float:
        """Most recent epoch's rate (0.0 before the first epoch ends)."""
        return self._rate

    # ---- step-time tail ---------------------------------------------------
    def tick(self) -> None:
        """Stamp the end of one optimizer step (no synchronise)."""
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._ticks.append(event)
        else:
            self._ticks.append(time.perf_counter())

    def reset_ticks(self) -> None:
        """Start a fresh epoch window."""
        self._ticks.clear()

    def _intervals(self) -> np.ndarray:
        ticks = list(self._ticks)
        if self._cuda:
            ticks[-1].synchronize()
            return np.asarray([a.elapsed_time(b) / 1e3
                               for a, b in zip(ticks, ticks[1:])])
        return np.diff(np.asarray(ticks, np.float64))

    def epoch_step_quantiles(self) -> Optional[Dict[str, float]]:
        """p50/p99/max of this epoch's step intervals, or None below 3
        intervals (a tail of one or two samples is noise)."""
        if len(self._ticks) < 4:
            return None
        d = self._intervals()
        return {"step_time_p50_s": float(np.percentile(d, 50)),
                "step_time_p99_s": float(np.percentile(d, 99)),
                "step_time_max_s": float(d.max())}
