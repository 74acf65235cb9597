"""A device trace of a sub-window, reduced to what the metrics read.

:class:`Capture` runs ``torch.profiler`` (host and device activity) and
marks the sub-window with a ``bench/window`` annotation, whose host start
also ties the trace's clock to ``time.perf_counter``.  :func:`reduce`
reads the raw events once: the device's kernels, copies and sets, clipped
to the sub-window; their union (busy time); device time and calls by kind
(kinds.py); and the idle gaps between them, each named
by the benchmark's or the program's host span that was open when the gap
began (the innermost one, across threads).  No trace is written to disk.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from harness.kinds import kind

WINDOW = "bench/window"


class Trace(NamedTuple):
    perf_start: float                    # the sub-window's start, perf clock
    window_s: float
    busy_s: float
    kind_s: Dict[str, float]             # device seconds by kind
    kind_calls: Dict[str, int]           # device events by kind
    gaps: List[Tuple[str, float]]        # longest idle gaps, named


def attach() -> None:
    """One empty profiling session: the first start of a process attaches
    CUPTI, which takes seconds, so a traced run pays it in set-up, before
    its CUDA graphs are captured and before its window."""
    import torch
    import torch.profiler as tp
    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Capture:
    def __init__(self) -> None:
        self._prof = None
        self._mark = None
        self.perf_start = 0.0

    def start(self) -> None:
        import torch.profiler as tp
        self._prof = tp.profile(activities=[tp.ProfilerActivity.CPU,
                                            tp.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = tp.record_function(WINDOW)
        self._mark.__enter__()
        self.perf_start = time.perf_counter()

    def stop(self) -> None:
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def events(self):
        return self._prof.profiler.kineto_results.events()


def _is_device_work(evt, cuda_type) -> bool:
    """A kernel, copy or set on the card: not the device-side copy of a
    host annotation, which spans the kernels under it."""
    return (evt.device_type() == cuda_type and not evt.is_user_annotation()
            and evt.name() != WINDOW)


def reduce(capture: Capture, spans=(), top: int = 10) -> Trace:
    from torch.autograd import DeviceType
    evts = capture.events()
    marks = [e for e in evts if e.name() == WINDOW
             and e.device_type() == DeviceType.CPU]
    if not marks:
        raise RuntimeError("the trace holds no bench/window annotation")
    w0, w1 = marks[0].start_ns(), marks[0].end_ns()
    work = []
    kind_s: Dict[str, float] = {}
    kind_calls: Dict[str, int] = {}
    for e in evts:
        if not _is_device_work(e, DeviceType.CUDA):
            continue
        a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if b <= a:
            continue
        work.append((a, b))
        k = kind(e.name())
        kind_s[k] = kind_s.get(k, 0.0) + (b - a) / 1e9
        kind_calls[k] = kind_calls.get(k, 0) + 1
    work.sort()
    busy, gaps, edge = 0, [], w0
    for a, b in work:
        if a > edge:
            gaps.append((edge, a))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    if w1 > edge:
        gaps.append((edge, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_open_span(spans, capture.perf_start + (g0 - w0) / 1e9),
              (g1 - g0) / 1e9) for g0, g1 in gaps[:top]]
    return Trace(perf_start=capture.perf_start, window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, kind_s=kind_s,
                 kind_calls=kind_calls, gaps=named)


def _open_span(spans, t: float) -> str:
    best: Optional[object] = None
    for s in spans:
        if s.t0 <= t < s.t1 and (best is None or s.t0 > best.t0):
            best = s
    return "host: " + (best.name if best is not None else "no span open")


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    ops = sorted(trace.kind_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[n, s] for n, s in trace.gaps[:top]]}
