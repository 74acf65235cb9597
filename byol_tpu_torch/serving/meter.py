"""ServingMeter: the latency-path health surface.

A copy of byol_tpu/serving/meter.py.  Per window it collects:

- request/row/batch counts and achieved rows/sec;
- p50/p99 request latency (enqueue -> result ready, the full user-visible
  path: queue wait + coalesce wait + staging + embed + readback);
- batch **fill ratio** (rows / bucket rows): the padding waste the
  power-of-two vocabulary costs;
- queue depth at enqueue (backpressure proximity);
- the mean per-request lifecycle phase durations (``phase_ms``);
- with the HTTP front end (serving/net/server.py), the additive ``wire``
  block: answers by status and the mean read/parse/wait/write durations.

Thread-safety: producers (client and handler threads) and the consumer
(the service worker) record under one lock.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional

import numpy as np

# latency ring capacity: enough for a stats window at serving rates without
# unbounded growth on a long-lived process (percentiles are per-window —
# the window resets on every emit/snapshot(reset=True))
_RING = 65536


def _ms(seconds: float) -> float:
    return seconds * 1e3


class ServingMeter:
    """Windowed serving stats; ``snapshot()`` reads, ``emit()`` logs."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._latencies = collections.deque(maxlen=_RING)
        self._requests = 0
        self._rows = 0
        self._batches = 0
        self._bucket_rows = 0       # sum of padded bucket sizes dispatched
        self._depth_sum = 0         # queue depth sampled at each enqueue
        self._depth_samples = 0
        self._window_start = None   # first record in the current window
        # per-request lifecycle phase sums (batcher.LIFECYCLE_PHASES
        # deltas: coalesce/stage/dispatch/readback/deliver) — the latency
        # BREAKDOWN behind the p50/p99 headline
        self._phase_s: Dict[str, float] = {}
        self._phase_requests = 0
        # wire layer (HTTP front end): status histogram + phase sums
        self._wire_status: Dict[str, int] = {}
        self._wire_phase_s: Dict[str, float] = {}
        self._wire_requests = 0
        # lifetime totals (never reset): the run_end summary
        self.total_requests = 0
        self.total_batches = 0
        self.total_wire_requests = 0

    # ---- producer side (client threads) -----------------------------------
    def record_enqueue(self, queue_depth: int) -> None:
        with self._lock:
            self._depth_sum += int(queue_depth)
            self._depth_samples += 1

    # ---- consumer side (the service worker) -------------------------------
    def record_batch(self, rows: int, bucket: int, t_now: float) -> None:
        with self._lock:
            if self._window_start is None:
                self._window_start = t_now
            self._batches += 1
            self._rows += int(rows)
            self._bucket_rows += int(bucket)
            self.total_batches += 1

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies.append(float(seconds))
            self._requests += 1
            self.total_requests += 1

    def record_lifecycle(self, phases: Dict[str, float]) -> None:
        """Accumulate one request's phase-duration dict
        (``Request.lifecycle()``) into the window's breakdown."""
        with self._lock:
            for phase, seconds in phases.items():
                self._phase_s[phase] = (self._phase_s.get(phase, 0.0)
                                        + float(seconds))
            self._phase_requests += 1

    # ---- wire side (the HTTP front end's handler threads) ------------------
    def record_wire(self, status: int, phases: Dict[str, float]) -> None:
        """Account one HTTP answer: final status + the wire phase
        durations (server.WIRE_PHASES deltas) it reached.  EVERY answer
        counts — a window full of 4xx is exactly the window worth
        seeing, and the status histogram is how serve_stats says so."""
        with self._lock:
            key = str(int(status))
            self._wire_status[key] = self._wire_status.get(key, 0) + 1
            for phase, seconds in phases.items():
                self._wire_phase_s[phase] = (
                    self._wire_phase_s.get(phase, 0.0) + float(seconds))
            self._wire_requests += 1
            self.total_wire_requests += 1

    # ---- readout ----------------------------------------------------------
    def snapshot(self, t_now: float, *, reset: bool = True
                 ) -> Dict[str, float]:
        """The current window's stats dict.  Empty windows report NaN
        percentiles rather than a fake zero latency."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            elapsed = (t_now - self._window_start
                       if self._window_start is not None else 0.0)
            out = {
                "requests": float(self._requests),
                "rows": float(self._rows),
                "batches": float(self._batches),
                "p50_ms": (_ms(float(np.percentile(lat, 50)))
                           if lat.size else float("nan")),
                "p99_ms": (_ms(float(np.percentile(lat, 99)))
                           if lat.size else float("nan")),
                "mean_ms": (_ms(float(lat.mean()))
                            if lat.size else float("nan")),
                "fill_ratio": (self._rows / self._bucket_rows
                               if self._bucket_rows else float("nan")),
                "queue_depth": (self._depth_sum / self._depth_samples
                                if self._depth_samples else 0.0),
                "rows_per_sec": (self._rows / elapsed
                                 if elapsed > 0 else float("nan")),
            }
            if self._phase_requests:
                out["phase_ms"] = {
                    k: _ms(v / self._phase_requests)
                    for k, v in sorted(self._phase_s.items())}
            if self._wire_requests:
                # the front door's tax on top of phase_ms: wait spans the
                # whole in-process path, so a wire request's latency is
                # about read + parse + wait + write
                out["wire"] = {
                    "http_requests": float(self._wire_requests),
                    "status": dict(sorted(self._wire_status.items())),
                    "phase_ms": {
                        k: _ms(v / self._wire_requests)
                        for k, v in sorted(self._wire_phase_s.items())},
                }
            if reset:
                self._latencies.clear()
                self._requests = self._rows = self._batches = 0
                self._bucket_rows = 0
                self._depth_sum = self._depth_samples = 0
                self._phase_s = {}
                self._phase_requests = 0
                self._wire_status = {}
                self._wire_phase_s = {}
                self._wire_requests = 0
                self._window_start = None
            return out

    def emit(self, events: Optional[Any], t_now: float, *,
             reset: bool = True, **extra: Any) -> Dict[str, float]:
        """Emit one ``serve_stats`` event (when ``events`` is given) and
        return the snapshot; ``extra`` carries engine-side fields the meter
        cannot know (compile_count)."""
        snap = self.snapshot(t_now, reset=reset)
        if events is not None:
            events.emit("serve_stats", **snap, **extra)
        return snap


def serve_log_line(snap: Dict[str, float]) -> str:
    """One-line human summary of a stats window."""
    return (f"serve[{int(snap['requests'])} req / "
            f"{int(snap['batches'])} batches]: "
            f"p50 {snap['p50_ms']:.2f} ms\tp99 {snap['p99_ms']:.2f} ms\t"
            f"fill {snap['fill_ratio']:.2f}\t"
            f"queue {snap['queue_depth']:.2f}\t"
            f"{snap['rows_per_sec']:.1f} rows/s")
