"""The port's telemetry sink, meters, FLOP accounting, watchdog, grapher and
profiling hooks (byol_tpu_torch/observability/), held against the JAX
package's where it has the same function.

- TelemetrySink: sampling every ``interval`` steps, one interval of lag
  (the newest vector is never read: a vector whose conversion raises
  until it is one interval old passes through ``offer``), hold/drain, the
  nonfinite / collapse / step_time_spike rules, the epoch-boundary
  timebase reset, halt, and its events read back by JAX's strict reader
  (the cases of JAX tests/test_telemetry.py, on hand vectors).  On a card,
  a CUDA vector goes through a pinned copy and an event (marked ``cuda``).
- MetricAccumulator, epoch_log_line: JAX's numbers and text.
- StepTimer: rate, MFU and the step-time tail from host ticks (CUDA event
  ticks on a card, marked ``cuda``).
- flops: the H100 peak table, no TPU peak, ``mfu`` as JAX computes it.
- Watchdog, Grapher (jsonl, tensorboard, 'both' without the tensorboard
  package), profiling (annotate, trace, start_server's refusal).
"""
import json
import time

import numpy as np
import pytest
import torch

from byol_tpu.observability import flops as jax_flops
from byol_tpu.observability import health as jax_health
from byol_tpu.observability import meters as jax_meters
from byol_tpu.observability.events import read_events as jax_read_events
from byol_tpu_torch.observability import flops, health, meters, profiling
from byol_tpu_torch.observability.events import RunLog
from byol_tpu_torch.observability.grapher import Grapher, make_grid
from byol_tpu_torch.observability.telemetry import NanHaltError, TelemetrySink
from byol_tpu_torch.observability.watchdog import Watchdog


def _vec(**overrides):
    vals = {"grad_norm": 1.0, "update_norm": 0.1, "param_norm": 10.0,
            "ema_drift": 0.5, "ema_drift_rel": 0.05, "trust_min": 1e-4,
            "trust_median": 1e-3, "trust_max": 2e-3,
            "collapse_feature_std": 0.5, "collapse_cosine_mean": 0.1,
            "nonfinite_count": 0.0, "loss": 2.0}
    vals.update(overrides)
    return health.pack(vals)


class _Unready:
    """A vector whose host conversion raises until released: stands for
    a device value the sink must not touch while it is the newest."""

    def __init__(self, vec):
        self.vec = vec
        self.ready = False

    def __array__(self, dtype=None, copy=None):
        if not self.ready:
            raise AssertionError("the newest vector was read")
        return np.asarray(self.vec.numpy(), dtype)


# ---------------------------------------------------------------------------
# the sink
# ---------------------------------------------------------------------------

class TestTelemetrySink:
    def test_lagged_readback(self):
        """Samples are read only once a NEWER sample exists."""
        sink = TelemetrySink(2, verbose=False)
        v2, v4 = _vec(loss=2.0), _vec(loss=1.5)
        assert sink.offer(1, _vec()) == []          # off-interval: ignored
        assert sink.offer(2, v2) == []
        assert list(sink.records) == []             # newest stays pending
        sink.offer(4, v4)
        assert [r["step"] for r in sink.records] == [2.0]
        assert sink.records[0]["loss"] == 2.0
        sink.drain()
        assert [r["step"] for r in sink.records] == [2.0, 4.0]

    def test_newest_vector_is_never_converted(self):
        sink = TelemetrySink(1, verbose=False)
        first, second = _Unready(_vec(loss=3.0)), _Unready(_vec(loss=2.0))
        sink.offer(1, first)                         # not read
        first.ready = True                           # one interval old
        sink.offer(2, second)                        # reads only the first
        assert [r["loss"] for r in sink.records] == [3.0]
        second.ready = True
        sink.drain()
        assert [r["loss"] for r in sink.records] == [3.0, 2.0]

    def test_epoch_mode_hold_keeps_only_latest(self):
        sink = TelemetrySink(1, verbose=False)
        stale = _Unready(_vec(loss=3.0))
        sink.hold(1, stale)                          # replaced, never read
        sink.hold(2, _vec(loss=2.5))
        assert len(sink.records) == 0
        sink.drain()
        assert [r["step"] for r in sink.records] == [2.0]

    def test_nan_warn_records_anomaly_without_raising(self):
        sink = TelemetrySink(1, nan_policy="warn", verbose=False)
        sink.offer(1, _vec(nonfinite_count=3.0, loss=float("nan")))
        anomalies = sink.drain()
        assert [a["rule"] for a in anomalies] == ["nonfinite"]
        assert sink.anomalies

    def test_nan_halt_raises_with_the_record(self):
        sink = TelemetrySink(1, nan_policy="halt", verbose=False)
        sink.offer(1, _vec(nonfinite_count=1.0))
        with pytest.raises(NanHaltError) as err:
            sink.drain()
        assert err.value.step == 1
        assert err.value.record["nonfinite_count"] == 1.0

    def test_collapse_rule(self):
        sink = TelemetrySink(1, verbose=False)
        sink.offer(1, _vec(collapse_feature_std=1e-6,
                           collapse_cosine_mean=0.9999))
        assert [a["rule"] for a in sink.drain()] == ["collapse"]

    def test_step_time_spike_rule(self):
        sink = TelemetrySink(1, verbose=False)
        anomalies = []
        for i, w in enumerate([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 16.0]):
            anomalies += sink.offer(i + 1, _vec(), wall=w)
        anomalies += sink.drain()
        assert [a["rule"] for a in anomalies] == ["step_time_spike"]
        assert anomalies[0]["step"] == 8

    def test_epoch_boundary_gap_is_not_a_spike(self):
        sink = TelemetrySink(1, verbose=False)
        anomalies = []
        for i, w in enumerate([0.0, 1.0, 2.0, 3.0, 4.0, 5.0]):
            anomalies += sink.offer(i + 1, _vec(), wall=w)
        anomalies += sink.drain()                    # epoch boundary
        anomalies += sink.offer(7, _vec(), wall=105.0)
        anomalies += sink.offer(8, _vec(), wall=106.0)
        anomalies += sink.drain()
        assert anomalies == []
        rec7 = next(r for r in sink.records if r["step"] == 7.0)
        assert "sec_per_step" not in rec7

    def test_validates_ctor_args(self):
        with pytest.raises(ValueError):
            TelemetrySink(0)
        with pytest.raises(ValueError):
            TelemetrySink(1, nan_policy="explode")

    def test_events_read_back_by_the_jax_reader(self, tmp_path):
        path = str(tmp_path / "run.jsonl")
        with RunLog(path) as log:
            sink = TelemetrySink(1, nan_policy="halt", events=log,
                                 verbose=False)
            sink.offer(1, _vec())
            sink.offer(2, _vec(nonfinite_count=2.0, loss=float("inf")))
            with pytest.raises(NanHaltError):
                sink.drain()
        got = list(jax_read_events(path))
        assert [e["kind"] for e in got] == ["step", "step", "anomaly",
                                            "halt"]
        assert set(got[0]["health"]) == set(jax_health.HEALTH_FIELDS) | {
            "step"}
        assert got[1]["health"]["loss"] == "Infinity"   # strict JSON

    @pytest.mark.cuda
    def test_cuda_vector_goes_through_a_pinned_copy(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        from byol_tpu_torch.observability import telemetry
        sink = TelemetrySink(1, verbose=False)
        vecs = [_vec(loss=float(i)).cuda() for i in range(3)]
        for i, v in enumerate(vecs):
            sink.offer(i + 1, v)
        staged = sink._pending[-1][1]
        assert isinstance(staged, telemetry._Staged)
        assert staged.host.is_pinned()
        sink.drain()
        assert [r["loss"] for r in sink.records] == [0.0, 1.0, 2.0]


# ---------------------------------------------------------------------------
# meters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_metric_accumulator_matches_jax(weighted):
    rng = np.random.RandomState(0)
    steps = []
    for _ in range(3):
        m = {"loss_mean": np.float32(rng.rand()),
             "top1_mean": np.float32(rng.rand())}
        if weighted:
            m["_weight"] = np.float32(rng.randint(1, 9))
        steps.append(m)
    ours, theirs = meters.MetricAccumulator(), jax_meters.MetricAccumulator()
    for m in steps:
        ours.update({k: torch.tensor(v) for k, v in m.items()})
        theirs.update({k: np.asarray(v) for k, v in m.items()})
    got, want = ours.result(), theirs.result()
    assert sorted(got) == sorted(want) == ["loss_mean", "top1_mean"]
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6)
    assert ours.count == theirs.count == 3
    assert ours.total_weight() == theirs.total_weight()


def test_epoch_log_line_is_jax_text():
    m = {"loss_mean": 1.25, "byol_loss_mean": -0.5, "top1_mean": 0.125}
    assert meters.epoch_log_line("train", 3, 4096, 12.5, m) == \
        jax_meters.epoch_log_line("train", 3, 4096, 12.5, m)


def test_step_timer_rate_mfu_and_tail():
    timer = meters.StepTimer(global_batch=64, n_chips=1)
    assert timer.images_per_sec_per_chip() == 0.0 and timer.mfu() is None
    timer.record_epoch(10, 2.0)
    assert timer.images_per_sec_per_chip() == 320.0
    timer.set_flops(1e9, 989.4)
    assert timer.mfu() == pytest.approx(320.0 * 1e9 / 989.4e12)
    assert timer.mfu() == jax_flops.mfu(320.0, 1e9, 989.4)
    assert timer.flops_per_sample == 1e9
    for _ in range(3):
        timer.tick()
    assert timer.epoch_step_quantiles() is None      # 2 intervals: noise
    for _ in range(5):
        time.sleep(0.002)
        timer.tick()
    q = timer.epoch_step_quantiles()
    assert 0.0 <= q["step_time_p50_s"] <= q["step_time_p99_s"] <= \
        q["step_time_max_s"]
    assert q["step_time_max_s"] >= 0.0015
    timer.reset_ticks()
    assert timer.epoch_step_quantiles() is None


@pytest.mark.cuda
def test_step_timer_ticks_are_device_events():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    timer = meters.StepTimer(8, device="cuda")
    x = torch.randn(2048, 2048, device="cuda")
    for _ in range(5):
        x = x @ x / 2048.0
        timer.tick()
    assert all(isinstance(t, torch.cuda.Event) for t in timer._ticks)
    q = timer.epoch_step_quantiles()
    assert q["step_time_p50_s"] > 0.0


# ---------------------------------------------------------------------------
# flops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4), ("NVIDIA H100 SXM5 80GB", 989.4),
    ("NVIDIA H100 PCIe", 756.0), ("NVIDIA H100 NVL", 835.0),
    ("NVIDIA A100-SXM4-80GB", None), ("cpu", None),
    ("TPU v5 lite", None), ("TPU v4", None)])
def test_chip_peak_is_the_h100_data_sheet(name, peak):
    assert flops.chip_peak_tflops(name) == peak


def test_mfu_is_jax_mfu():
    for args in ((787.0, 65.4e9, 989.4), (0.0, 1e9, 989.4),
                 (10.0, None, 989.4), (10.0, 1e9, None)):
        assert flops.mfu(*args) == jax_flops.mfu(*args)


def test_counting_counts_matmuls_and_convolutions():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    w = torch.randn(3, 2, 3, 3)
    with flops.counting() as counted:
        a @ b
        torch.nn.functional.conv2d(torch.randn(1, 2, 5, 5), w)
    assert counted.total == 2 * 8 * 16 * 4 + 2 * (3 * 3 * 3 * 2 * 3 * 3)
    with flops.counting() as none:
        a + a
    assert none.total is None


# ---------------------------------------------------------------------------
# watchdog, grapher, profiling
# ---------------------------------------------------------------------------

def test_watchdog_dumps_stacks_on_stall(tmp_path):
    path = tmp_path / "wd.txt"
    with open(path, "w") as f:
        wd = Watchdog(0.3, exit=False, file=f)
        wd.pet()
        time.sleep(1.0)
        wd.stop()
    text = path.read_text()
    assert "Timeout" in text and "Thread" in text


def test_watchdog_disabled_and_petted_paths(tmp_path):
    path = tmp_path / "wd.txt"
    with open(path, "w") as f:
        off = Watchdog(0.0, file=f)
        assert not off.enabled
        off.pet()
        off.stop()
        with Watchdog(0.5, exit=False, file=f) as wd:
            for _ in range(4):
                time.sleep(0.1)
                wd.pet()
    assert path.read_text() == ""


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_grapher_jsonl_follows_the_plotting_rules(tmp_path):
    g = Grapher("jsonl", logdir=str(tmp_path), run_name="r")
    g.register_plots({"loss_mean": 1.5, "lr_scalar": 0.1, "other": 3.0},
                     step=2)
    g.add_scalar("nan_scalar", float("nan"), 3)
    g.add_text("config", "{}", 0)
    g.close()
    lines = _jsonl(tmp_path / "r" / "metrics.jsonl")
    assert lines[0]["train_loss_mean"] == 1.5 and lines[0]["step"] == 2
    assert lines[1]["train_lr_scalar"] == 0.1
    assert lines[2]["nan_scalar"] == "NaN"      # strict JSON
    assert lines[3]["config"] == "{}" and len(lines) == 4


def test_grapher_both_without_tensorboard_writes_jsonl(tmp_path, capsys,
                                                       monkeypatch):
    """Where the tensorboard package is missing, 'both' (the default)
    writes the jsonl and says so in one line; 'tensorboard' raises."""
    import builtins
    real_import = builtins.__import__

    def no_tb(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_tb)
    g = Grapher("both", logdir=str(tmp_path), run_name="r")
    g.add_scalar("x_scalar", 1.0, 0)
    g.close()
    assert _jsonl(tmp_path / "r" / "metrics.jsonl")[0]["x_scalar"] == 1.0
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "tensorboard" in err
    with pytest.raises(ImportError):
        Grapher("tensorboard", logdir=str(tmp_path), run_name="t")
    with pytest.raises(ValueError, match="backend"):
        Grapher("visdom", logdir=str(tmp_path))


def test_grapher_tensorboard_writes_events(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    g = Grapher("both", logdir=str(tmp_path), run_name="r")
    g.add_scalar("x_scalar", 1.0, 0)
    g.register_images({"aug1_imgs": np.random.rand(5, 8, 8, 3)}, 0)
    g.close()
    files = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert "metrics.jsonl" in files
    assert any(f.startswith("events.out.tfevents") for f in files)


def test_make_grid_is_jax_grid():
    from byol_tpu.observability.grapher import make_grid as jax_make_grid
    batch = np.random.RandomState(0).rand(10, 128, 128, 3)
    grid = make_grid(batch, max_px=64)
    assert grid.shape == (3 * 64, 4 * 64, 3)
    np.testing.assert_array_equal(grid, jax_make_grid(batch, max_px=64))


def test_profiling_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("byol/region"):
            torch.ones(4) @ torch.ones(4)
    (trace,) = tmp_path.iterdir()
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "byol/region" in names


def test_profiling_start_server_refuses():
    with pytest.raises(NotImplementedError, match="trace"):
        profiling.start_server(9999)
