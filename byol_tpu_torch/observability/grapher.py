"""Metric writer (counterpart of byol_tpu/observability/grapher.py, the
``helpers.grapher.Grapher`` contract):

  Grapher('both', logdir=..., run_name=...)
  .add_scalar(key, value, step); .add_image(key, grid, step)
  .add_text(key, text, step); .save(); .close()

Plotting rules of ``register_plots`` / ``register_images``: only keys
ending ``_mean`` / ``_scalar`` are plotted as scalars, only ``_img`` /
``_imgs`` as images (the first <= 64 samples, downscaled to <= 64 px).

Backends: ``tensorboard`` (``torch.utils.tensorboard.SummaryWriter``),
``jsonl`` (``metrics.jsonl``, strict JSON through ``events.sanitize``),
``both`` (the default) and ``null``.  The one difference from the JAX
package: where ``torch.utils.tensorboard`` does not import (its
``tensorboard`` package is not installed), ``both`` writes the jsonl and
prints one line naming the missing package, and ``tensorboard`` alone
raises.
"""
from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import Any, Dict

import numpy as np

from byol_tpu_torch.observability.events import sanitize

_SCALAR_RE = re.compile(r".*(_mean|_scalar)$")
_IMAGE_RE = re.compile(r".*_imgs?$")
BACKENDS = ("tensorboard", "jsonl", "both", "null")


def is_scalar_key(key: str) -> bool:
    return bool(_SCALAR_RE.match(key))


def is_image_key(key: str) -> bool:
    return bool(_IMAGE_RE.match(key))


def _summary_writer(logdir: str, required: bool):
    """A SummaryWriter, or None (with one printed line) when the
    tensorboard package is missing and the backend can do without it."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        if required:
            raise
        print(f"grapher: tensorboard backend unavailable ({e}); writing "
              "metrics.jsonl only", file=sys.stderr)
        return None
    return SummaryWriter(log_dir=logdir)


class Grapher:
    """Facade over one of the writer backends (one process writes: the
    port runs on one card)."""

    def __init__(self, backend: str = "both", *, logdir: str = "runs",
                 run_name: str = "byol"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown grapher backend {backend!r}")
        self.backend = backend
        self.logdir = os.path.join(logdir, run_name)
        self._tb = None
        self._jsonl = None
        if self.backend in ("tensorboard", "both"):
            os.makedirs(self.logdir, exist_ok=True)
            self._tb = _summary_writer(self.logdir,
                                       required=self.backend == "tensorboard")
        if self.backend in ("jsonl", "both"):
            os.makedirs(self.logdir, exist_ok=True)
            self._jsonl = open(os.path.join(self.logdir, "metrics.jsonl"),
                               "a", buffering=1)

    # -- primitive writes --------------------------------------------------
    def add_scalar(self, key: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(key, float(value), step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"t": time.time(), "step": step,
                 key: sanitize(float(value))}, allow_nan=False) + "\n")

    def add_image(self, key: str, grid: np.ndarray, step: int) -> None:
        """grid: (H, W, C) float [0,1]."""
        if self._tb is not None:
            self._tb.add_image(key, np.asarray(grid), step,
                               dataformats="HWC")

    def add_text(self, key: str, text: str, step: int = 0) -> None:
        if self._tb is not None:
            self._tb.add_text(key, text, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"t": time.time(), "step": step, key: text},
                allow_nan=False) + "\n")

    def save(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        self.save()
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()

    # -- the reference's plotting rules --------------------------------------
    def register_plots(self, metrics: Dict[str, Any], step: int,
                       prefix: str = "train") -> None:
        """Post every ``*_mean`` / ``*_scalar`` entry as ``<prefix>_<key>``."""
        for key, value in metrics.items():
            if is_scalar_key(key):
                self.add_scalar(f"{prefix}_{key}", float(value), step)

    def register_images(self, images: Dict[str, Any], step: int,
                        prefix: str = "train", max_samples: int = 64,
                        max_px: int = 64) -> None:
        """Post ``*_img(s)`` batches as grids: the first <= 64 samples,
        downscaled to <= 64 px."""
        for key, batch in images.items():
            if not is_image_key(key):
                continue
            arr = np.asarray(batch)
            if arr.ndim != 4:
                continue
            grid = make_grid(arr[:max_samples], max_px=max_px)
            self.add_image(f"{prefix}_{key}", grid, step)


def make_grid(batch: np.ndarray, max_px: int = 64) -> np.ndarray:
    """(N, H, W, C) [0,1] -> one square-ish (H', W', C) grid image."""
    n, h, w, c = batch.shape
    if max(h, w) > max_px:  # nearest-neighbour downscale, host-side
        stride = int(np.ceil(max(h, w) / max_px))
        batch = batch[:, ::stride, ::stride, :]
        n, h, w, c = batch.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), batch.dtype)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = batch[i]
    return np.clip(grid, 0.0, 1.0)
