"""Closed-loop multi-stream load generator — ONE driver for smoke runs.

A copy of byol_tpu/serving/net/loadgen.py.  ``--smoke`` and
``chip_smoke.py`` need the same thing: N client threads, each submitting
single-image requests back-to-back (closed loop: a stream's next request
waits for its last answer, the load shape a well-behaved upstream service
produces), until a shared request budget is spent.  It ACCOUNTS rather
than assumes: every stream failure or timeout is counted, sampled, and
surfaced, so a smoke run where half the requests died cannot exit 0 on the
strength of the half that lived.

The generator is transport-agnostic: ``embed_fn(stream_idx, images)`` is
the whole contract.  Client-side latency is sampled HERE (perf_counter
around each call).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np

# keep the first few failure reprs — enough to diagnose, bounded so a
# 100%-failure hammer run cannot hoard every traceback string
_MAX_ERRORS = 8


@dataclasses.dataclass
class LoadgenResult:
    """What a closed-loop run actually did — failures included."""

    requested: int
    completed: int = 0
    failed: int = 0
    elapsed_s: float = 0.0
    errors: List[str] = dataclasses.field(default_factory=list)
    latencies_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        """The smoke gate: every requested request completed, none
        failed or timed out."""
        return self.failed == 0 and self.completed == self.requested

    def percentile_ms(self, q: float) -> float:
        if not self.latencies_s:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_s,
                                              np.float64), q)) * 1e3

    def throughput(self) -> float:
        return (self.completed / self.elapsed_s
                if self.elapsed_s > 0 else float("nan"))

    def summary(self) -> str:
        return (f"loadgen: {self.completed}/{self.requested} ok, "
                f"{self.failed} failed, "
                f"p50 {self.percentile_ms(50):.2f}ms "
                f"p99 {self.percentile_ms(99):.2f}ms, "
                f"{self.throughput():.1f} req/s"
                + (f"; first errors: {self.errors}"
                   if self.errors else ""))


def run_closed_loop(
        embed_fn: Callable[[int, np.ndarray], np.ndarray],
        input_shape, n_requests: int, n_streams: int, *,
        seed: int = 0,
        make_images: Optional[Callable[[int], np.ndarray]] = None,
        stream_setup: Optional[Callable[[int], None]] = None,
) -> LoadgenResult:
    """Drive ``n_requests`` single-image requests from ``n_streams``
    closed-loop threads through ``embed_fn``; returns the full account.

    ``make_images(stream_idx)`` overrides the default synthetic image
    (seeded per stream — identical inputs across transports, so parity
    checks can compare answers, not just counts).  ``stream_setup`` runs
    once per stream thread before its first request (e.g. dialing a
    per-stream EmbedClient).  A failing request is COUNTED and the
    stream keeps going: partial failure is a result, not an abort — the
    caller decides whether it is fatal (``result.ok``).
    """
    result = LoadgenResult(requested=n_requests)
    budget = {"left": n_requests}
    lock = threading.Lock()

    def default_images(idx: int) -> np.ndarray:
        rng = np.random.RandomState(seed + idx)
        return rng.rand(1, *input_shape).astype(np.float32)

    images_of = make_images or default_images

    def stream(idx: int) -> None:
        try:
            if stream_setup is not None:
                stream_setup(idx)
            img = images_of(idx)
        except Exception as e:  # noqa: BLE001 — a stream that cannot
            with lock:          # even start fails its share loudly
                while budget["left"] > 0:
                    budget["left"] -= 1
                    result.failed += 1
                if len(result.errors) < _MAX_ERRORS:
                    result.errors.append(f"stream {idx} setup: {e!r}")
            return
        while True:
            with lock:
                if budget["left"] <= 0:
                    return
                budget["left"] -= 1
            t0 = time.perf_counter()
            try:
                embed_fn(idx, img)
            except Exception as e:  # noqa: BLE001 — counted, not fatal
                with lock:
                    result.failed += 1
                    if len(result.errors) < _MAX_ERRORS:
                        result.errors.append(repr(e)[:200])
            else:
                lat = time.perf_counter() - t0
                with lock:
                    result.completed += 1
                    result.latencies_s.append(lat)

    threads = [threading.Thread(target=stream, args=(i,), daemon=True,
                                name=f"loadgen-{i}")
               for i in range(max(1, n_streams))]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    result.elapsed_s = time.perf_counter() - t_start
    return result
