"""Asynchronous telemetry sink: lagged health readback and anomaly rules
(counterpart of byol_tpu/observability/telemetry.py).

The train step computes the packed health vector on the card
(observability/health.py); this module is the host side that reads it back
WITHOUT synchronising the step loop:

- ``offer(step, vec)`` samples every ``interval``-th optimizer step.  A
  vector on the card starts a non-blocking copy into pinned host memory
  and records a CUDA event after it on the current stream; nothing reads
  it yet.  Only samples OLDER than the newest one are read: by then at
  least ``interval`` further steps were enqueued, and the wait on the
  sample's event finds its copy (almost surely) done.  The newest vector
  is never converted, synchronised or read in ``offer``.
- ``hold(step, vec)`` / ``drain()`` serve ``--telemetry epoch``: the
  trainer holds the newest vector and drains once at the epoch boundary,
  after the epoch's readback has synchronised anyway.

There is no fallback: if the pinned buffer or the event cannot be made,
the error propagates and the run fails.  A vector on the CPU (the tests)
is read as it is.

Anomaly rules run over a ring of processed records:

- ``nonfinite``: ``nonfinite_count > 0``.  Under ``nan_policy='halt'`` the
  sink emits the anomaly and a ``halt`` event and raises
  :class:`NanHaltError` (the trainer adds a ``state_dump``);
- ``collapse``: target-projection per-feature std below
  ``collapse_feature_std`` or mean pairwise cosine above
  ``collapse_cosine``;
- ``step_time_spike``: seconds per optimizer step (from the offer
  timestamps) above ``step_time_spike`` x the ring's median.
"""
from __future__ import annotations

import sys
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from byol_tpu_torch.observability import health as health_lib
from byol_tpu_torch.observability.events import RunLog

NAN_POLICIES = ("warn", "halt")


class NanHaltError(RuntimeError):
    """A non-finite gradient/loss surfaced under ``--nan-policy halt``."""

    def __init__(self, step: int, record: Dict[str, float]):
        self.step = step
        self.record = record
        super().__init__(
            f"non-finite values in gradients/loss at optimizer step {step} "
            f"(nonfinite_count={record.get('nonfinite_count')}, "
            f"loss={record.get('loss')}); halting per --nan-policy halt")


class _Staged:
    """A vector on its way to the host: a pinned copy and the CUDA event
    recorded after the copy was enqueued."""

    __slots__ = ("host", "ready")

    def __init__(self, vec: torch.Tensor):
        self.host = torch.empty(vec.shape, dtype=vec.dtype,
                                pin_memory=True)
        self.host.copy_(vec, non_blocking=True)
        self.ready = torch.cuda.Event()
        self.ready.record(torch.cuda.current_stream(vec.device))

    def read(self) -> np.ndarray:
        self.ready.synchronize()
        return self.host.numpy()


def _stage(vec: Any) -> Any:
    if torch.is_tensor(vec) and vec.device.type == "cuda":
        return _Staged(vec)
    return vec


def _read(staged: Any) -> np.ndarray:
    if isinstance(staged, _Staged):
        return np.asarray(staged.read(), np.float32)
    if torch.is_tensor(staged):
        # a CPU vector, or a held one read at the epoch boundary (after the
        # epoch's readback synchronised)
        return staged.detach().cpu().numpy().astype(np.float32)
    return np.asarray(staged, np.float32)


class TelemetrySink:
    """Lagged readback + anomaly detection over the health vector.

    ``events`` (a RunLog, optional): every processed sample is emitted as
    a ``step`` event and every tripped rule as an ``anomaly`` event.
    ``records`` is the ring of processed samples (HEALTH_FIELDS +
    ``step`` / ``sec_per_step``); ``anomalies`` holds every anomaly of the
    run.
    """

    def __init__(self, interval: int = 50, *, nan_policy: str = "warn",
                 events: Optional[RunLog] = None, ring: int = 128,
                 collapse_feature_std: float = 1e-3,
                 collapse_cosine: float = 0.995,
                 step_time_spike: float = 3.0,
                 verbose: bool = True) -> None:
        if interval < 1:
            raise ValueError(f"telemetry interval must be >= 1: {interval}")
        if nan_policy not in NAN_POLICIES:
            raise ValueError(
                f"unknown nan_policy {nan_policy!r}; one of {NAN_POLICIES}")
        self.interval = interval
        self.nan_policy = nan_policy
        self.events = events
        self.collapse_feature_std = collapse_feature_std
        self.collapse_cosine = collapse_cosine
        self.step_time_spike = step_time_spike
        self.verbose = verbose
        self.records: Deque[Dict[str, float]] = deque(maxlen=ring)
        self.anomalies: List[Dict[str, Any]] = []
        # (step, staged vector, offer wall time) awaiting readback
        self._pending: Deque[Tuple[int, Any, float]] = deque()
        self._held: Optional[Tuple[int, Any, float]] = None

    # ---- hot-loop side ----------------------------------------------------
    def offer(self, step: int, vec: Any,
              wall: Optional[float] = None) -> List[Dict[str, Any]]:
        """'step' mode: sample every ``interval``-th step; process only
        samples at least one interval old.  Returns the anomalies found in
        the samples processed by THIS call.  ``wall`` overrides the
        timestamp (tests)."""
        if step % self.interval:
            return []
        self._pending.append(
            (step, _stage(vec),
             time.perf_counter() if wall is None else wall))
        out: List[Dict[str, Any]] = []
        while len(self._pending) > 1:
            out.extend(self._process(*self._pending.popleft()))
        return out

    def hold(self, step: int, vec: Any,
             wall: Optional[float] = None) -> None:
        """'epoch' mode: remember the newest vector without reading it;
        :meth:`drain` at the epoch boundary turns it into one record."""
        self._held = (step, vec,
                      time.perf_counter() if wall is None else wall)

    def drain(self) -> List[Dict[str, Any]]:
        """Process everything outstanding (epoch boundary / shutdown);
        returns the anomalies found (and halt still raises)."""
        out: List[Dict[str, Any]] = []
        while self._pending:
            out.extend(self._process(*self._pending.popleft()))
        if self._held is not None:
            held, self._held = self._held, None
            out.extend(self._process(*held))
        # an epoch boundary: the gap to the next epoch's first sample spans
        # eval and checkpoint, not training, so that sample gets no
        # sec_per_step (else every epoch would raise a step_time_spike)
        if self.records:
            self.records[-1].pop("_wall", None)
        return out

    # ---- readback + rules -------------------------------------------------
    def _process(self, step: int, staged: Any,
                 wall: float) -> List[Dict[str, Any]]:
        rec: Dict[str, float] = {"step": float(step),
                                 **health_lib.unpack(_read(staged))}
        prev = self.records[-1] if self.records else None
        if prev is not None and "_wall" in prev and step > prev["step"]:
            rec["sec_per_step"] = ((wall - prev["_wall"])
                                   / (step - prev["step"]))
        rec["_wall"] = wall
        anomalies = self._rules(step, rec)
        self.records.append(rec)
        public = {k: v for k, v in rec.items() if not k.startswith("_")}
        if self.events is not None:
            self.events.emit("step", step=step, health=public,
                             anomalies=[a["rule"] for a in anomalies])
            for a in anomalies:
                self.events.emit("anomaly", **a)
        self.anomalies.extend(anomalies)
        if self.verbose:
            for a in anomalies:
                print(f"telemetry: ANOMALY {a['rule']} at step {step}: "
                      f"{a['detail']}", file=sys.stderr)
        if rec["nonfinite_count"] > 0 and self.nan_policy == "halt":
            if self.events is not None:
                self.events.emit("halt", step=step, reason="nonfinite",
                                 health=public)
            raise NanHaltError(step, public)
        return anomalies

    def _rules(self, step: int,
               rec: Dict[str, float]) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []

        def anomaly(rule: str, detail: str) -> None:
            out.append({"step": step, "rule": rule, "detail": detail,
                        "health": {k: v for k, v in rec.items()
                                   if not k.startswith("_")}})

        if rec["nonfinite_count"] > 0:
            anomaly("nonfinite",
                    f"{rec['nonfinite_count']:.0f} non-finite value(s) in "
                    f"gradients/loss (loss={rec['loss']})")
        if (rec["collapse_feature_std"] < self.collapse_feature_std
                or rec["collapse_cosine_mean"] > self.collapse_cosine):
            anomaly("collapse",
                    "target projections collapsing: feature_std="
                    f"{rec['collapse_feature_std']:.3e} (< "
                    f"{self.collapse_feature_std}) or cosine_mean="
                    f"{rec['collapse_cosine_mean']:.4f} (> "
                    f"{self.collapse_cosine})")
        sec = rec.get("sec_per_step")
        history = [r["sec_per_step"] for r in self.records
                   if "sec_per_step" in r]
        if sec is not None and len(history) >= 5:
            med = float(np.median(history))
            if med > 0 and sec > self.step_time_spike * med:
                anomaly("step_time_spike",
                        f"{sec:.3f}s/step vs ring median {med:.3f}s "
                        f"(x{sec / med:.1f} > x{self.step_time_spike})")
        return out
