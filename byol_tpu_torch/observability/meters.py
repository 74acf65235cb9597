"""Input-pipeline health (counterpart of ``InputPipelineMeter`` and
``input_log_line`` in byol_tpu/observability/meters.py).

:func:`byol_tpu_torch.data.prefetch.prefetch_to_device` feeds the meter:
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

from typing import Dict


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
