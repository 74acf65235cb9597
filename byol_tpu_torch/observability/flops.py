"""FLOP count and MFU (counterpart of byol_tpu/observability/flops.py).

One convention: a multiply-add is 2 FLOPs, as in the quoted peaks.

- :func:`chip_peak_tflops`: NVIDIA's data-sheet dense BF16 tensor-core
  peak of the card, keyed by substrings of ``torch.cuda.get_device_name``;
  None for any other card and for the CPU.
- :func:`counting`: counts the FLOPs of the code it encloses under
  ``torch.utils.flop_counter.FlopCounterMode`` (the counterpart of JAX's
  ``cost_analysis_flops``; torch eager has no lowering to analyse).  The
  trainer runs the first real optimizer step of a fit inside it, forward
  and backward, so no extra step runs.  The counter sees aten operators
  only: the hand kernels K1a, K1b and K2 are ctypes calls and count 0, as
  Pallas calls count 0 in XLA's cost analysis; elementwise and reduction
  operators count 0 too, as FlopCounterMode counts only matmuls,
  convolutions and attention.
  It also counts the FLOPs of the tensor-parallel heads
  (parallel/partitioning.py::TP_MODULES), whose matmuls each rank runs
  1/M of.
- :func:`mfu`: model FLOPs utilisation of one card.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

# dense BF16 peak TFLOP/s, keyed by lower-case substrings of the device
# name; the first match wins (NVL and PCIe before the SXM names)
PEAK_BF16_TFLOPS = (
    ("h100 nvl", 835.0),
    ("h100 pcie", 756.0),
    ("h100 80gb hbm3", 989.4),     # SXM5
    ("h100 sxm", 989.4),
)


def chip_peak_tflops(device_name: Optional[str] = None) -> Optional[float]:
    """Peak of the named card (default: CUDA device 0), None if unknown
    or no card."""
    if device_name is None:
        import torch
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    name = device_name.lower()
    for key, peak in PEAK_BF16_TFLOPS:
        if key in name:
            return peak
    return None


class FlopCount:
    """What :func:`counting` saw: ``total`` FLOPs once the block ends,
    and ``split`` of them in the named submodules."""

    def __init__(self) -> None:
        self.total: Optional[float] = None
        self.split = 0.0


@contextlib.contextmanager
def counting() -> Iterator[FlopCount]:
    """Count the FLOPs of the enclosed code; ``total`` is None when the
    counter saw none.  ``split`` sums those of the root module's
    tensor-parallel children (``BYOLNet.projector``, of every BYOLNet
    run)."""
    from torch.utils.flop_counter import FlopCounterMode

    from byol_tpu_torch.parallel.partitioning import TP_MODULES
    out = FlopCount()
    mode = FlopCounterMode(display=False)
    with mode:
        yield out
    total = float(mode.get_total_flops())
    out.total = total if total > 0 else None
    out.split = float(sum(
        sum(ops.values()) for name, ops in mode.get_flop_counts().items()
        if name.count(".") == 1 and name.split(".")[1] in TP_MODULES))


def mfu(images_per_sec_per_chip: float, flops_per_sample: Optional[float],
        peak_tflops: Optional[float]) -> Optional[float]:
    """Model FLOPs utilisation of one card; None when either term is
    unknown (CPU runs, an unknown card)."""
    if not flops_per_sample or not peak_tflops or \
            images_per_sec_per_chip <= 0:
        return None
    return images_per_sec_per_chip * flops_per_sample / (peak_tflops * 1e12)
