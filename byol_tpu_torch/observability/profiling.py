"""Profiling hooks on torch.profiler (counterpart of
byol_tpu/observability/profiling.py):

- ``trace(logdir)``: capture a host + CUDA trace of the enclosed code and
  write it as a Chrome-trace JSON under ``logdir`` (open it in
  ``chrome://tracing`` or https://ui.perfetto.dev);
- ``annotate(name)``: a named host region (``record_function``) that shows
  up in a captured trace beside the card's kernels;
- ``start_server(port)``: JAX's on-demand capture server has no torch
  counterpart; it raises rather than quietly doing nothing.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


def start_server(port: int = 9999):
    """On-demand capture of a live run: not available under torch."""
    raise NotImplementedError(
        f"profiling.start_server({port}): torch.profiler has no on-demand "
        "capture server (jax.profiler.start_server's role); wrap the steps "
        "in profiling.trace(logdir) instead (ROADMAP.md, section 1)")


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a host (+ CUDA, when a card is present) trace of the
    enclosed code into ``logdir/trace_<pid>_<time>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region in the profiler timeline."""
    return torch.profiler.record_function(name)
