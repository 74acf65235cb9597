"""The per-layer metrics that read the serving worker's spans
(layer_metrics/serve_*.py over harness/program_spans.py), on hand-made
spans of two threads: the values worked out by hand, the spans outside
the window and those of the sender left out, and None without a trace or
on a program that records none of the spans read."""
import pytest

from conftest import BENCH
from harness import registry
from harness.spans import Span
from harness.trace import Trace

W, S = 101, 202                         # the worker's and the sender's
SETUP_DONE, PERF_START = 2.0, 10.0      # the window: 8 s

# name, start, end, attributes; seconds on the perf clock
WORKER = [
    # before the window: left out
    ("serve/wait", 1.0, 1.9, {}),
    ("serve/coalesce", 1.9, 1.95, {}),
    ("serve/batch", 1.95, 1.96, {"batch": 7, "requests": 64}),
    ("serve/stage", 1.951, 1.955, {"batch": 7, "rows": 64}),
    ("serve/assemble", 1.95, 1.955, {"batch": 7}),
    ("serve/dispatch", 1.955, 1.96, {"batch": 7}),
    ("serve/readback", 1.96, 1.97, {"batch": 7}),
    ("serve/sync", 1.96, 1.965, {"batch": 7}),
    ("serve/deliver", 1.97, 1.99, {"batch": 7}),
    # in the window: batch 8
    ("serve/wait", 2.0, 3.0, {}),
    ("serve/coalesce", 3.0, 3.004, {}),
    ("serve/batch", 3.004, 3.010,
     {"batch": 8, "requests": 5, "trace_ids": [1, 2, 3, 4, 5]}),
    ("serve/assemble", 3.004, 3.005, {"batch": 8}),
    ("serve/stage", 3.005, 3.008, {"batch": 8, "rows": 5}),
    ("serve/stage_wait", 3.005, 3.0055, {"batch": 8}),
    ("serve/stage_copy", 3.0055, 3.0075, {"batch": 8}),
    ("serve/h2d", 3.0075, 3.008, {"batch": 8}),
    ("serve/dispatch", 3.008, 3.010, {"batch": 8}),
    # batch 9, staged while batch 8 is in flight
    ("serve/coalesce", 3.010, 3.016, {}),
    ("serve/batch", 3.016, 3.020, {"batch": 9, "requests": 6}),
    ("serve/assemble", 3.016, 3.0165, {"batch": 9}),
    ("serve/stage", 3.0165, 3.0185, {"batch": 9, "rows": 7}),
    ("serve/stage_copy", 3.017, 3.018, {"batch": 9}),
    ("serve/dispatch", 3.019, 3.020, {"batch": 9}),
    ("serve/readback", 3.020, 3.026, {"batch": 8}),
    ("serve/sync", 3.020, 3.024, {"batch": 8}),
    ("serve/d2h", 3.024, 3.026, {"batch": 8}),
    ("serve/deliver", 3.026, 3.027, {"batch": 8}),
    ("serve/readback", 3.027, 3.030, {"batch": 9}),
    ("serve/sync", 3.027, 3.028, {"batch": 9}),
    ("serve/d2h", 3.028, 3.030, {"batch": 9}),
    ("serve/deliver", 3.030, 3.033, {"batch": 9}),
    ("serve/wait", 3.033, 4.033, {}),
    # in the profiled sub-window: left out
    ("serve/wait", 10.0, 11.0, {}),
    ("serve/coalesce", 11.0, 11.5, {}),
    ("serve/batch", 11.5, 11.6, {"batch": 10, "requests": 64}),
    ("serve/stage", 11.5, 11.55, {"batch": 10, "rows": 64}),
    ("serve/dispatch", 11.5, 11.6, {"batch": 10}),
    ("serve/readback", 11.7, 11.8, {"batch": 10}),
    ("serve/sync", 11.7, 11.8, {"batch": 10}),
    ("serve/deliver", 11.8, 11.9, {"batch": 10}),
]
# the sender's thread opened no serve/dispatch: left out
SENDER = [
    ("bench/submit", 3.001, 3.002, {}),
    ("serve/backpressure", 4.0, 5.0, {}),
    ("serve/wait", 5.0, 6.0, {}),
    ("serve/coalesce", 6.0, 7.0, {}),
    ("serve/stage", 7.0, 7.1, {"batch": 8, "rows": 64}),
    ("serve/sync", 6.0, 7.0, {"batch": 8}),
]

EXPECTED = {
    "serve_wait_pct": 100.0 * 2.0 / 8.0,
    "serve_coalesce_ms": (4.0 + 6.0) / 2,
    "serve_batch_rows": (5 + 7) / 2,
    "serve_copy_ms": ((1.0 + 2.0) + (0.5 + 1.0)) / 2,
    "serve_hold_ms": ((3.020 - 3.010) + (3.027 - 3.020)) * 1e3 / 2,
    "serve_sync_ms": (4.0 + 1.0) / 2,
    "serve_d2h_ms": (2.0 + 2.0) / 2,
    "serve_deliver_ms": (1.0 + 3.0) / 2,
}


def _spans(rows, thread):
    return [Span(n, thread, t0, t1, a) for n, t0, t1, a in rows]


def _ctx(spans, traced=True):
    trace = Trace(perf_start=PERF_START, window_s=3.0, busy_s=0.5,
                  launched_busy_s=0.5, kind_s={}, kind_calls={},
                  name_s={}, name_calls={}, gaps=[]) if traced else None
    return {"out": {"setup_done": SETUP_DONE}, "trace": trace,
            "spans": spans}


def _read(name, ctx):
    return registry.layer_metric({"bench_dir": str(BENCH)}, name)(ctx)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reads_the_worker_in_the_window(name):
    spans = _spans(WORKER, W) + _spans(SENDER, S)
    assert _read(name, _ctx(spans)) == pytest.approx(EXPECTED[name],
                                                     rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_without_a_trace(name):
    assert _read(name, _ctx(_spans(WORKER, W), traced=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_on_a_program_without_the_spans(name):
    """The spans a worker recorded before it had wait, coalesce and
    deliver spans and batch numbers."""
    old = [Span("serve/batch", W, 3.0, 3.01, {"trace_ids": [1]}),
           Span("serve/stage", W, 3.0, 3.005, {"bucket": 8, "rows": 1}),
           Span("serve/dispatch", W, 3.005, 3.01, {"bucket": 8}),
           Span("serve/readback", W, 3.02, 3.03, {"bucket": 8})]
    assert _read(name, _ctx(old)) is None
