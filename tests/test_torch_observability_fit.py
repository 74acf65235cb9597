"""A whole port fit with its observability on, held against the JAX
package's tools.

The fits are fp32 ResNet-18 at 32 px, heads 64/32, fake data, batch 16 =
2 microbatches of 8 (``average``), both views made in the step through
K2's plain version and the update through K1's: the main path's
configuration, cut to size, with ``--telemetry step --telemetry-interval 1
--nan-policy halt --spans on --grapher jsonl``, on one torch thread.

- The fit's ``run.jsonl`` passes JAX's ``scripts/validate_events.py
  --require goodput,span_stats`` (run as a subprocess), renders through
  JAX's ``report.render`` with exit status 0, and the port's report gives
  the same text apart from the version field.  It holds a ``step`` record
  for every optimizer step with finite health and ordered trust
  statistics, the train and test ``epoch`` events, a checkpoint per epoch,
  the goodput partition per epoch and for the run, and the Chrome trace
  and ``metrics.jsonl`` lie beside it.
- A batch with a NaN in view 1 (loader placement) halts the fit with
  NanHaltError after ``anomaly``, ``halt``, ``state_dump`` and a goodput
  ``final`` with ``halted`` reached the log.
- FLOP count: FlopCounterMode's FLOPs per sample of one step against JAX
  ``flops.cost_analysis_flops`` of the same step (ResNet-18, 32 px, heads
  64/32, batch 8, fp32).  Measured at batch 8 and 32: 1.145-1.147
  (FlopCounterMode counts 8.88 GFLOP a sample, XLA 7.74-7.76; JAX's own
  test finds XLA's
  count ~0.88 of a hand table with backward = 2 x forward, and
  FlopCounterMode sits on that table), so the band is 1.10-1.20.  A fit
  whose first step runs under the counter gives losses and state bitwise
  equal to a fit without it.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.observability import flops as jax_flops
from byol_tpu.observability import report as jax_report
from byol_tpu_torch.core.config import (Config, DeviceConfig, ModelConfig,
                                        OptimConfig, TaskConfig, run_name)
from byol_tpu_torch.data.loader import get_loader
from byol_tpu_torch.observability import flops, report
from byol_tpu_torch.observability.events import read_events
from byol_tpu_torch.observability.health import HEALTH_FIELDS
from byol_tpu_torch.observability.telemetry import NanHaltError
from byol_tpu_torch.training.trainer import fit
from tests.test_torch_health import _batch, _r18_sides
from tests.test_torch_train_step import _torch_batch

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4                       # 2 epochs of 2 steps


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cfg(root, **device):
    root = Path(root)
    return Config(
        task=TaskConfig(task="fake", batch_size=16, epochs=2,
                        image_size_override=32, augment_placement="step",
                        fused_augment="on", grapher="jsonl",
                        log_dir=str(root / "logs")),
        model=ModelConfig(arch="resnet18", head_latent_size=64,
                          projection_size=32, model_dir=str(root / "models")),
        optim=OptimConfig(lr=0.05, warmup=1, fused_update="on",
                          accum_steps=2),
        device=DeviceConfig(**{**dict(
            num_replicas=1, half=False, seed=7, telemetry="step",
            telemetry_interval=1, nan_policy="halt", spans="on"), **device}))


def _log_dir(cfg):
    return Path(cfg.task.log_dir) / run_name(cfg)


def _fit(cfg, **kw):
    return fit(cfg, device="cpu", loader=get_loader(cfg, num_fake_samples=32),
               verbose=False, **kw)


def test_fit_writes_the_jax_run_log(tmp_path, one_thread):
    """One fit, every record of it: the log against JAX's validator and
    renderer, its events, the trace and the grapher's lines beside it."""
    cfg = _cfg(tmp_path)
    result = _fit(cfg)
    log = _log_dir(cfg) / "run.jsonl"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "validate_events.py"),
         "--require", "goodput,span_stats", str(log)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "goodput=3" in proc.stdout and f"step={STEPS}" in proc.stdout
    evs = list(read_events(str(log)))

    # the report: JAX's text, apart from the version field
    got, rc = report.render(evs)
    want, jrc = jax_report.render(evs)
    assert rc == jrc == 0
    assert got.replace(f"torch={torch.__version__}", "jax=None") == want
    assert "startup_compile" in got and "Anomaly timeline" in got

    # the events
    kinds = [e["kind"] for e in evs]
    assert kinds[0] == "run_header" and kinds[-1] == "run_end"
    header = evs[0]
    assert header["jax_version"] is None and header["backend"] == "cpu"
    assert header["torch_version"] == torch.__version__
    assert header["config"]["device"]["telemetry"] == "step"
    steps = [e for e in evs if e["kind"] == "step"]
    assert [e["step"] for e in steps] == list(range(1, STEPS + 1))
    for e in steps:
        h = e["health"]
        assert set(HEALTH_FIELDS) <= set(h)
        assert all(np.isfinite(h[k]) for k in HEALTH_FIELDS)
        assert h["nonfinite_count"] == 0.0
        assert h["trust_min"] <= h["trust_median"] <= h["trust_max"]
    np.testing.assert_allclose([e["health"]["loss"] for e in steps],
                               result.step_losses, rtol=1e-6)
    assert "anomaly" not in kinds and result.anomalies == 0
    epochs = [(e["epoch"], e["split"]) for e in evs if e["kind"] == "epoch"]
    assert epochs == [(0, "train"), (0, "test"), (1, "train"), (1, "test")]
    train = next(e for e in evs if e["kind"] == "epoch")
    assert "input_pipeline" in train and "loss_mean" in train["metrics"]
    assert [e["epoch"] for e in evs if e["kind"] == "checkpoint"] == [0, 1]
    goodputs = [e for e in evs if e["kind"] == "goodput"]
    assert [e["scope"] for e in goodputs] == ["epoch", "epoch", "run"]
    run = goodputs[-1]
    total = run["productive_seconds"] + sum(run["badput"].values())
    assert total == pytest.approx(run["wall_seconds"], rel=1e-9)
    assert run["badput"]["startup_compile"] > 0.0
    assert result.flops_per_sample and result.mfu is None   # no CPU peak

    # the trace and the grapher's lines beside the log
    with open(_log_dir(cfg) / "trace.json") as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"]
    assert names.count("startup/compile") == 1
    assert names.count("train/dispatch") == STEPS - 1
    for name in ("startup/build", "input/fill", "train/epoch_readback",
                 "telemetry/readback", "telemetry/drain", "eval/run",
                 "checkpoint/save"):
        assert name in names, name
    stats = next(e for e in evs if e["kind"] == "span_stats")["spans"]
    assert stats["startup/compile"]["count"] == 1
    with open(_log_dir(cfg) / "metrics.jsonl") as f:
        keys = {k for line in f for k in json.loads(line)}
    assert {"train_loss_mean", "test_loss_mean", "lr_scalar",
            "images_per_sec_per_chip"} <= keys


def test_nan_batch_halts_with_a_state_dump(tmp_path, one_thread):
    cfg = _cfg(tmp_path)
    cfg = cfg.replace(task=dataclasses.replace(
        cfg.task, augment_placement="loader", fused_augment="off",
        data_backend="native"))
    loader = get_loader(cfg, num_fake_samples=32)

    def nan_iter(epoch, _base=loader.make_train_iter):
        for i, batch in enumerate(_base(epoch)):
            if i == 1:
                batch = dict(batch)
                v = np.array(batch["view1"])
                v[0, 0, 0, 0] = np.nan   # passes the [0, 1] range check
                batch["view1"] = v
            yield batch
    loader = dataclasses.replace(loader, make_train_iter=nan_iter)
    with pytest.raises(NanHaltError) as err:
        fit(cfg, device="cpu", loader=loader, verbose=False)
    assert err.value.step == 2
    evs = list(read_events(str(_log_dir(cfg) / "run.jsonl")))
    kinds = [e["kind"] for e in evs]
    assert kinds.index("anomaly") < kinds.index("halt") < kinds.index(
        "state_dump")
    dump = next(e for e in evs if e["kind"] == "state_dump")
    assert dump["reason"] == "nonfinite" and dump["step"] == 2
    assert dump["health"]["nonfinite_count"] > 0
    assert {"state_step", "ema_step", "lr"} <= set(dump)
    final = [e for e in evs if e["kind"] == "goodput"][-1]
    assert final["scope"] == "run" and final["halted"] is True
    assert (_log_dir(cfg) / "trace.json").exists()
    assert "run_end" not in kinds


def test_flop_count_against_jax_cost_analysis(one_thread):
    rows = 8
    kw = dict(accum_steps=1, accum_bn_mode="average", telemetry="off")
    jstate, jstep, port = _r18_sides(dict(kw, fused_update=False), rows)
    batch = _batch(rows, 0)
    want = jax_flops.cost_analysis_flops(
        jstep, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, step = port(True)
    with flops.counting() as counted:
        step(state, _torch_batch(batch))
    ratio = counted.total / want
    assert 1.10 < ratio < 1.20, (counted.total / rows, want / rows)


def test_fit_under_the_counter_is_bitwise_a_fit_without(tmp_path,
                                                        one_thread,
                                                        monkeypatch):
    """The first step's FLOP count changes nothing the step computes."""
    import contextlib

    def short(root):
        cfg = _cfg(root, spans="off")
        return cfg.replace(task=dataclasses.replace(cfg.task, epochs=1))
    counted = _fit(short(tmp_path / "counted"))

    @contextlib.contextmanager
    def no_counter():
        yield flops.FlopCount()
    monkeypatch.setattr(flops, "counting", no_counter)
    plain = _fit(short(tmp_path / "plain"))
    assert counted.flops_per_sample and plain.flops_per_sample is None
    assert len(plain.step_losses) == 2
    assert plain.step_losses == counted.step_losses
    for name in ("params", "momentum", "target"):
        assert torch.equal(getattr(plain.state, name),
                           getattr(counted.state, name)), name
    for key, value in plain.state.batch_stats().items():
        assert torch.equal(value, counted.state.batch_stats()[key]), key
