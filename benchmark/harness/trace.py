"""A device trace of a sub-window, reduced to what the metrics read.

:class:`Capture` runs ``torch.profiler`` (host and device activity) and
marks the sub-window with a ``bench/window`` annotation, whose host start
also ties the trace's clock to ``time.perf_counter``.  :func:`reduce`
reads the raw events once:

- the device's kernels, copies and sets that the host launched inside the
  sub-window, each counted whole, by kind (kinds.py), by raw name and in
  their union (``launched_busy_s``).  A
  device event is tied to its launch by its correlation id, which the CUDA
  runtime or driver call that launched it (``cudaLaunchKernel``,
  ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...) shares; it counts when
  that call's host start lies inside ``bench/window``.  The card's clock
  and the host's may disagree by tens of milliseconds, so clipping the
  device's events to the host's window would cut the last kernels short
  or drop them, and an event launched before the window would count;
- the union of the device's events, clipped to the sub-window (busy
  time), and the idle gaps between them, each named by the benchmark's or
  the program's host span that was open when the gap began (the innermost
  one, across threads).

No trace is written to disk.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from harness.kinds import kind

WINDOW = "bench/window"
_API = re.compile(r"cu(da)?[A-Z]")     # the CUDA runtime's and driver's calls


class Trace(NamedTuple):
    perf_start: float                    # the sub-window's start, perf clock
    window_s: float
    busy_s: float                        # device union, clipped to it
    # the device events launched inside the sub-window, each whole
    launched_busy_s: float               # their union
    kind_s: Dict[str, float]             # device seconds by kind
    kind_calls: Dict[str, int]           # device events by kind
    name_s: Dict[str, float]             # device seconds by raw name
    name_calls: Dict[str, int]           # device events by raw name
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


def _launches(evts, cpu_type) -> Dict[int, int]:
    """Host start of each CUDA runtime or driver call, by correlation id.
    The profiler numbers its host operators in a series of their own, so
    a call is told from an operator by its API name (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ...)."""
    return {e.correlation_id(): e.start_ns() for e in evts
            if e.device_type() == cpu_type and not e.is_user_annotation()
            and _API.match(e.name())}


def reduce(capture: Capture, spans=(), top: int = 10) -> Trace:
    from torch.autograd import DeviceType
    evts = capture.events()
    marks = [e for e in evts if e.name() == WINDOW
             and e.device_type() == DeviceType.CPU]
    if not marks:
        raise RuntimeError("the trace holds no bench/window annotation")
    w0, w1 = marks[0].start_ns(), marks[0].end_ns()
    launched = _launches(evts, DeviceType.CPU)
    work, launched_work = [], []
    kind_s: Dict[str, float] = {}
    kind_calls: Dict[str, int] = {}
    name_s: Dict[str, float] = {}
    name_calls: Dict[str, int] = {}
    for e in evts:
        if not _is_device_work(e, DeviceType.CUDA):
            continue
        a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if b > a:
            work.append((a, b))
        if not w0 <= launched.get(e.correlation_id(), -1) <= w1:
            continue
        launched_work.append((e.start_ns(), e.end_ns()))
        name, s = e.name(), (e.end_ns() - e.start_ns()) / 1e9
        k = kind(name)
        kind_s[k] = kind_s.get(k, 0.0) + s
        kind_calls[k] = kind_calls.get(k, 0) + 1
        name_s[name] = name_s.get(name, 0.0) + s
        name_calls[name] = name_calls.get(name, 0) + 1
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
    return Trace(perf_start=capture.perf_start, window_s=(w1 - w0) / 1e9,
                 busy_s=busy / 1e9,
                 launched_busy_s=_union_ns(launched_work) / 1e9,
                 kind_s=kind_s, kind_calls=kind_calls,
                 name_s=name_s, name_calls=name_calls, gaps=named)


def _union_ns(intervals) -> int:
    total, edge = 0, 0
    for a, b in sorted(intervals):
        if b > edge:
            total += b - max(a, edge)
            edge = b
    return total


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
