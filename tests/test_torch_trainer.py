"""The port's training lifecycle on the CPU: checkpoint per epoch, exact
mid-epoch resume after SIGTERM, --fault-at-step, the durable early-stop
marker, the CLI's exit code 143, and serving a trained checkpoint.

The runs are fp32, a resnet18 at 16 px, batch 8, 32 fake samples (4 steps
an epoch), with the in-step augmentation through K2's plain version and
the update through K1's: the main path's configuration, cut to size."""
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from byol_tpu_torch.checkpoint import CheckpointStore, ModelSaver
from byol_tpu_torch.core.config import (Config, DeviceConfig, ModelConfig,
                                        OptimConfig, TaskConfig, run_name)
from byol_tpu_torch.data.loader import LoaderBundle, get_loader
from byol_tpu_torch.training.state import canonical_state
from byol_tpu_torch.training.trainer import fit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS_PER_EPOCH = 4


def _cfg(model_dir, **device):
    return Config(
        task=TaskConfig(task="fake", batch_size=8, epochs=2,
                        image_size_override=16, augment_placement="step",
                        fused_augment="on", grapher="jsonl",
                        log_dir=os.path.join(str(model_dir), "logs")),
        model=ModelConfig(arch="resnet18", head_latent_size=32,
                          projection_size=16, model_dir=str(model_dir)),
        optim=OptimConfig(lr=0.05, warmup=1, fused_update="on"),
        device=DeviceConfig(num_replicas=1, half=False, seed=7, **device))


def _loader(cfg):
    return get_loader(cfg, num_fake_samples=8 * STEPS_PER_EPOCH)


def _run_dir(cfg):
    return os.path.join(cfg.model.model_dir, run_name(cfg))


def _meta(cfg):
    with open(os.path.join(_run_dir(cfg), "meta.json")) as f:
        return json.load(f)


def _assert_states_bitwise(a, b):
    for name in ("params", "target", "momentum"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    sa, sb = a.batch_stats(), b.batch_stats()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    assert (a.step, a.count, a.ema_step) == (b.step, b.count, b.ema_step)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every fit of this file runs on one torch thread, restored after (a
    module autouse fixture, so the module fixtures' fits see it too): the
    tiny net gains nothing from more, and under a parallel test run every
    extra OpenMP team oversubscribes the cores the other tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Two epochs, eight steps, never interrupted."""
    cfg = _cfg(tmp_path_factory.mktemp("full"))
    return cfg, fit(cfg, device="cpu", loader=_loader(cfg), verbose=False)


def test_uninterrupted_run_checkpoints_each_epoch(uninterrupted):
    cfg, full = uninterrupted
    assert len(full.step_losses) == 2 * STEPS_PER_EPOCH
    assert full.state.step == 2 * STEPS_PER_EPOCH and not full.stopped_early
    store = CheckpointStore(_run_dir(cfg))
    assert store.epochs() == (0, 1)
    tree, epoch = store.restore()
    store.close()
    assert (epoch, tree["step"]) == (1, full.state.step)
    meta = _meta(cfg)
    assert [h["metric"] for h in meta["history"]] == full.test_losses
    assert meta["last_epoch"] == 1 and meta["larger_is_better"] is False


def test_sigterm_mid_epoch_then_relaunch_equals_uninterrupted(
        uninterrupted, tmp_path):
    """SIGTERM after the first batch of epoch 0: the run checkpoints
    mid-epoch at the step s where the notice reached it and exits 143;
    the relaunch re-enters epoch 0 at batch s and ends bit for bit where
    the uninterrupted run ended, with the same losses, test losses and
    metadata.  The loader runs ahead of the steps in the prefetch thread,
    so s is the first step boundary after the signal: 1 or later."""
    assert threading.current_thread() is threading.main_thread()
    full_cfg, full = uninterrupted
    cfg = _cfg(tmp_path)
    base = _loader(cfg)

    def signalling(epoch):
        for i, batch in enumerate(base.make_train_iter(epoch)):
            yield batch
            if epoch == 0 and i == 0:
                signal.raise_signal(signal.SIGTERM)   # preemption notice

    loader = dataclasses.replace(base, make_train_iter=signalling)
    with pytest.raises(SystemExit) as exc:
        fit(cfg, device="cpu", loader=loader, verbose=False)
    assert exc.value.code == 143
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # restored
    store = CheckpointStore(_run_dir(cfg))
    tree, epoch = store.restore()
    store.close()
    s = tree["step"]
    assert epoch == 0 and 1 <= s < STEPS_PER_EPOCH

    resumed = fit(cfg, device="cpu", loader=_loader(cfg), verbose=False)
    assert resumed.step_losses == full.step_losses[s:]
    assert resumed.test_losses == full.test_losses
    _assert_states_bitwise(resumed.state, full.state)
    assert _meta(cfg) == _meta(full_cfg)


def test_fault_at_step_then_resume_from_last_epoch(uninterrupted, tmp_path):
    """--fault-at-step 6 exits in epoch 1 without saving; the relaunch
    resumes from epoch 0's checkpoint (step 4) and ends where the
    uninterrupted run ended.  The run name hashes every flag, the fault's
    too (as the JAX package's does), so the relaunch without it finds the
    faulted run's directory under its own name."""
    _, full = uninterrupted
    faulty = _cfg(tmp_path, fault_at_step=6)
    with pytest.raises(SystemExit, match="fault injected at step 6"):
        fit(faulty, device="cpu", loader=_loader(faulty), verbose=False)
    assert _meta(faulty)["last_epoch"] == 0
    cfg = _cfg(tmp_path)
    shutil.move(_run_dir(faulty), _run_dir(cfg))
    resumed = fit(cfg, device="cpu", loader=_loader(cfg), verbose=False)
    assert resumed.step_losses == full.step_losses[STEPS_PER_EPOCH:]
    _assert_states_bitwise(resumed.state, full.state)


def test_early_stop_marker_is_durable(uninterrupted, tmp_path):
    """A run whose saver recorded the stop restores its BEST checkpoint on
    relaunch, evaluates it and trains nothing, though a later (last)
    checkpoint exists."""
    full_cfg, full = uninterrupted
    cfg = _cfg(tmp_path)
    shutil.copytree(_run_dir(full_cfg), _run_dir(cfg))
    best = _meta(cfg)["best_epoch"]
    last = canonical_state(full.state)
    last["step"] = 999
    saver = ModelSaver(_run_dir(cfg), early_stop=True, max_early_stop_steps=1)
    assert saver(float("inf"), 2, last)                 # stall -> stop
    saver.close()
    assert _meta(cfg)["stopped_early"] is True
    result = fit(cfg, device="cpu", loader=_loader(cfg), verbose=False)
    assert result.stopped_early and result.step_losses == []
    assert result.epoch == best
    assert result.state.step == STEPS_PER_EPOCH * (best + 1)
    assert np.isfinite(result.test_metrics["loss_mean"])


def test_cli_exits_143_on_sigterm(tmp_path):
    """``python -m byol_tpu_torch``: SIGTERM during training checkpoints
    and exits 143."""
    cmd = [sys.executable, "-m", "byol_tpu_torch", "--no-cuda", "--task",
           "fake", "--arch", "resnet18", "--image-size-override", "16",
           "--batch-size", "8", "--epochs", "1000", "--debug-step",
           "--no-half", "--warmup", "0", "--head-latent-size", "32",
           "--projection-size", "16", "--model-dir", str(tmp_path / "m"),
           "--log-dir", str(tmp_path / "logs"), "--grapher", "jsonl"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env,
                            cwd=str(tmp_path))
    try:
        for line in proc.stdout:
            if line.startswith("epoch 0:"):
                proc.send_signal(signal.SIGTERM)
                break
        out = proc.stdout.read()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert rc == 143, out
    assert "SIGTERM: checkpointed epoch" in out
    (run,) = os.listdir(tmp_path / "m")
    assert CheckpointStore(str(tmp_path / "m" / run)).epochs()


SERVE_FLAGS = ["--arch", "resnet18", "--image-size-override", "16",
               "--head-latent-size", "32", "--projection-size", "16",
               "--no-half", "--num-classes", "10"]


def test_serve_from_checkpoint_matches_the_trained_state(uninterrupted,
                                                         capsys, tmp_path):
    """``serve --no-cuda --checkpoint``: the served embeddings are the
    trained state's frozen representations (fp32, 1e-5), the CLI's smoke
    passes, and it does not say it serves random weights."""
    from byol_tpu_torch.serving import cli as serve_cli
    from byol_tpu_torch.serving.service import ServeConfig, build_service
    from byol_tpu_torch.training.linear_eval import frozen_representation_fn
    cfg, full = uninterrupted
    assert serve_cli.main(["--no-cuda", "--checkpoint", _run_dir(cfg),
                           "--smoke", "8", "--smoke-streams", "2",
                           "--max-batch", "8", "--log-dir", str(tmp_path)]
                          + SERVE_FLAGS) == 0
    assert "RANDOM" not in capsys.readouterr().err
    serve_cfg = serve_cli.config_from_args(
        serve_cli.build_serve_parser().parse_args(SERVE_FLAGS))
    service = build_service(serve_cfg, ServeConfig(min_bucket=8,
                                                   max_bucket=8),
                            checkpoint_dir=_run_dir(cfg), device="cpu")
    rows = np.random.RandomState(0).rand(8, 16, 16, 3).astype(np.float32)
    got = service.engine.embed(rows)
    want = frozen_representation_fn(full.state.net, half=False)(
        torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
