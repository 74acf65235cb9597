"""The port's flight recorder, goodput accounting and Chrome-trace export
(byol_tpu_torch/observability/spans.py, goodput.py), held against the JAX
package's (the cases of JAX tests/test_spans.py).

- SpanRecorder: names, durations, order, per-thread depth, the ring bound
  and ``dropped``, ``records(since_seq)``, the NULL recorder (one shared
  no-op) and the module default.
- Goodput: the same spans give the port's and JAX's ``attribute`` the same
  partition, which sums to wall time exactly; only depth-0 spans count;
  windows are contiguous; ``fold`` / ``final`` emit goodput and span_stats
  events JAX's reader accepts.
- Export: valid Chrome-trace JSON.
- prefetch_to_device opens ``input/fill`` then ``input/wait`` spans in
  the consumer's thread.
"""
import json
import threading
import time

import pytest

from byol_tpu.observability import goodput as jax_goodput
from byol_tpu.observability.events import read_events as jax_read_events
from byol_tpu_torch.data.prefetch import prefetch_to_device
from byol_tpu_torch.observability import goodput as goodput_lib
from byol_tpu_torch.observability import spans as spans_lib
from byol_tpu_torch.observability.events import RunLog


def _spin(rec, name, seconds, **attrs):
    with rec.span(name, **attrs):
        time.sleep(seconds)


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------

def test_span_records_name_duration_and_order():
    rec = spans_lib.SpanRecorder()
    with rec.span("train/dispatch", step=3):
        time.sleep(0.01)
    with rec.span("input/wait"):
        pass
    first, second = rec.records()
    assert (first.name, second.name) == ("train/dispatch", "input/wait")
    assert first.seconds >= 0.009 and first.t1 <= second.t0
    assert first.attrs == {"step": 3} and second.attrs is None
    assert first.seq < second.seq


def test_nesting_tracks_depth_and_inner_closes_first():
    rec = spans_lib.SpanRecorder()
    with rec.span("outer"):
        with rec.span("inner"):
            pass
    inner, outer = rec.records()
    assert (inner.name, inner.depth) == ("inner", 1)
    assert (outer.name, outer.depth) == ("outer", 0)
    with rec.span("again"):
        pass
    assert rec.records()[-1].depth == 0


def test_depth_is_per_thread():
    rec = spans_lib.SpanRecorder()
    started, release = threading.Event(), threading.Event()

    def other():
        with rec.span("thread/outer"):
            started.set()
            release.wait(5)

    t = threading.Thread(target=other)
    t.start()
    started.wait(5)
    with rec.span("main/top"):            # depth 0 despite the other's
        pass
    release.set()
    t.join(5)
    depths = {r.name: r.depth for r in rec.records()}
    assert depths == {"main/top": 0, "thread/outer": 0}


def test_exception_still_closes_and_records():
    rec = spans_lib.SpanRecorder()
    with pytest.raises(RuntimeError):
        with rec.span("eval/run"):
            raise RuntimeError("boom")
    assert [r.name for r in rec.records()] == ["eval/run"]
    with rec.span("next"):
        pass
    assert rec.records()[-1].depth == 0


def test_ring_bound_evicts_oldest_and_counts_dropped():
    rec = spans_lib.SpanRecorder(capacity=4)
    for i in range(10):
        with rec.span(f"s{i}"):
            pass
    assert [r.name for r in rec.records()] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6
    with pytest.raises(ValueError):
        spans_lib.SpanRecorder(capacity=0)


def test_records_since_seq():
    rec = spans_lib.SpanRecorder()
    for name in ("a", "b", "c"):
        with rec.span(name):
            pass
    mark = rec.records()[0].seq
    assert [r.name for r in rec.records(since_seq=mark)] == ["b", "c"]
    assert rec.last_seq() == rec.records()[-1].seq
    rec.clear()
    assert rec.records() == [] and rec.last_seq() == -1


def test_null_recorder_records_nothing():
    null = spans_lib.NULL
    assert not null.enabled
    cm1, cm2 = null.span("a"), null.span("b", x=1)
    assert cm1 is cm2                       # one shared no-op
    with cm1:
        pass
    assert null.records() == [] and null.dropped == 0
    assert null.last_seq() == -1


def test_module_default_recorder():
    assert spans_lib.get_default() is spans_lib.NULL
    rec = spans_lib.SpanRecorder()
    spans_lib.set_default(rec)
    try:
        with spans_lib.span("x/y"):
            pass
    finally:
        spans_lib.set_default(spans_lib.NULL)
    assert [r.name for r in rec.records()] == ["x/y"]


# ---------------------------------------------------------------------------
# goodput
# ---------------------------------------------------------------------------

def test_attribute_is_jax_attribute_and_sums_to_wall():
    rec = spans_lib.SpanRecorder()
    _spin(rec, "train/dispatch", 0.02)
    _spin(rec, "input/wait", 0.005)
    with rec.span("startup/compile"):
        _spin(rec, "telemetry/readback", 0.002)     # nested: not badput
    _spin(rec, "eval/run", 0.005)
    _spin(rec, "checkpoint/save", 0.002)
    _spin(rec, "other/thing", 0.001)
    records = rec.records()
    wall = records[-1].t1 - records[0].t0 + 0.01
    got = goodput_lib.attribute(records, wall)
    want = jax_goodput.attribute(records, wall)
    assert got == want
    wall, productive, badput = got
    assert productive + sum(badput.values()) == pytest.approx(wall,
                                                              rel=1e-12)
    assert badput["telemetry_readback"] == 0.0
    assert badput["startup_compile"] >= 0.002
    assert goodput_lib.BADPUT_BUCKETS == jax_goodput.BADPUT_BUCKETS
    assert goodput_lib.span_stats(records) == jax_goodput.span_stats(
        records)


def test_windows_are_contiguous_and_final_totals(tmp_path):
    rec = spans_lib.SpanRecorder()
    meter = goodput_lib.GoodputMeter(rec)
    path = str(tmp_path / "run.jsonl")
    with RunLog(path) as log:
        for _ in range(3):
            _spin(rec, "train/dispatch", 0.002)
        p0 = meter.fold(scope="epoch", epoch=0, events=log,
                        images_per_sec_per_chip=100.0)
        _spin(rec, "checkpoint/save", 0.005)
        p1 = meter.fold(scope="epoch", epoch=1, events=log, mfu=0.05)
        time.sleep(0.005)
        run = meter.final(events=log, halted=True)
    assert run["wall_seconds"] >= p0["wall_seconds"] + p1["wall_seconds"]
    assert run["productive_seconds"] == pytest.approx(
        p0["productive_seconds"] + p1["productive_seconds"], rel=1e-9)
    assert run["badput"]["checkpoint"] == pytest.approx(
        p1["badput"]["checkpoint"], rel=1e-9)
    got = list(jax_read_events(path))         # identity checked per line
    assert [e["kind"] for e in got] == ["goodput", "span_stats", "goodput",
                                        "span_stats", "goodput"]
    assert got[0]["images_per_sec_per_chip"] == 100.0
    assert got[2]["mfu"] == 0.05
    assert got[-1]["scope"] == "run" and got[-1]["halted"] is True
    assert got[-1]["windows"] == 3
    assert got[1]["spans"]["train/dispatch"]["count"] == 3


# ---------------------------------------------------------------------------
# export and prefetch
# ---------------------------------------------------------------------------

def test_exported_file_is_valid_chrome_trace(tmp_path):
    rec = spans_lib.SpanRecorder()
    with rec.span("train/dispatch", step=1):
        with rec.span("serve/stage", trace_ids=[1, 2], x=float("nan")):
            pass
    path = str(tmp_path / "deep" / "trace.json")
    assert spans_lib.export_chrome_trace(rec.records(), path) == 2
    with open(path) as f:
        trace = json.load(f)
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert [e["name"] for e in xs] == ["train/dispatch", "serve/stage"]
    for e in xs:
        assert {"name", "cat", "ts", "dur", "pid", "tid"} <= set(e)
    assert xs[1]["args"] == {"trace_ids": [1, 2], "x": "NaN"}
    assert xs[0]["cat"] == "train"
    assert any(e.get("ph") == "M" for e in trace["traceEvents"])


def test_prefetch_opens_fill_then_wait_spans():
    rec = spans_lib.SpanRecorder()
    batches = [{"x": [float(i)]} for i in range(4)]
    got = list(prefetch_to_device(iter(batches), "cpu", recorder=rec))
    assert [float(b["x"][0]) for b in got] == [0.0, 1.0, 2.0, 3.0]
    names = [r.name for r in rec.records()]
    # one wait per batch and one for the end of the source
    assert names == ["input/fill"] + ["input/wait"] * 4
    me = threading.get_ident()
    assert all(r.tid == me and r.depth == 0 for r in rec.records())
