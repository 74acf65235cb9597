"""The port's input pipeline as a whole (byol_tpu_torch/data/loader.py and
the trainer's use of it) against the JAX package's.

- ``data_backend='native'``: ``get_loader`` of both packages gives bitwise
  equal train, test, valid and train-eval batches over two epochs, and two
  train steps of the port on those batches, from one converted state,
  match JAX ``make_train_step`` at the step tests' fp32 1e-4.
- ``tf`` (the torch host path) and ``device``: every train batch of an
  epoch is the epoch's permutation minus the remainder, view1 differs from
  view2 in every row, and the host path's batches do not depend on the
  number of DataLoader workers.
- The valid split is JAX's; ``fit`` evaluates it every epoch; a SIGTERM
  mid-epoch and a relaunch under loader placement give the uninterrupted
  run's losses and state bit for bit.

Sizes: 32 fake images at 32 px (16 px for the fits), batch 8.
"""
import contextlib
import dataclasses
import io
import signal
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.core import config as jax_config
from byol_tpu.data import loader as jax_loader
from byol_tpu_torch.checkpoint import CheckpointStore
from byol_tpu_torch.core import config as torch_config
from byol_tpu_torch.data import loader as torch_loader
from tests.test_torch_train_step import (METRICS, PARITY, TOL, _jax_side,
                                         _assert_states_match, _torch_batch,
                                         _torch_side)

N, SIZE, BATCH, SEED = 32, 32, 8, 7


def _cfgs(**task):
    """The same config in both packages."""
    out = []
    for lib in (jax_config, torch_config):
        out.append(lib.Config(
            task=lib.TaskConfig(task="fake", batch_size=BATCH,
                                image_size_override=SIZE, **task),
            device=lib.DeviceConfig(num_replicas=1, seed=SEED)))
    return out


def _np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        a, b = _np(a), _np(b)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def native_pair(tmp_path_factory):
    """Both packages' native loaders, the JAX one on a private build of its
    library (tests/test_torch_native_aug.py says why): a broken shared
    build would move it to tf.data with a printed line, and its batches
    would not be the native ones."""
    from byol_tpu.data import native_aug as jax_native
    from tests.test_torch_native_aug import private_jax_native
    with private_jax_native(tmp_path_factory):
        jax_native.load()                # raises with the build's error
        jcfg, cfg = _cfgs(data_backend="native", valid_fraction=0.25)
        yield (jax_loader.get_loader(jcfg, num_fake_samples=N),
               torch_loader.get_loader(cfg, num_fake_samples=N))


def test_native_batches_bitwise_equal_jax(native_pair):
    theirs, ours = native_pair
    for field in ("input_shape", "num_train_samples", "num_test_samples",
                  "num_valid_samples", "output_size"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert (ours.num_train_samples, ours.num_valid_samples) == (24, 8)
    for epoch in (0, 1):
        for make in ("make_train_iter", "make_test_iter", "make_valid_iter",
                     "make_train_eval_iter"):
            _assert_batches_equal(getattr(ours, make)(epoch),
                                  getattr(theirs, make)(epoch))
    # the epoch reshuffles and redraws
    a, b = (next(ours.make_train_iter(e))["view1"] for e in (0, 1))
    assert not np.array_equal(a, b)


def test_two_steps_on_native_batches_match_jax(native_pair):
    """Two steps of the tiny BYOL net of test_torch_train_step from one
    converted state on the loader's first two train batches."""
    _, ours = native_pair
    kw = dict(PARITY, fused_update=True, ema_update_mode="reference_pre")
    _, jstate, jstep, _ = _jax_side(False, kw, "reference")
    state, step, _ = _torch_side(False, kw, jstate)
    batches = list(ours.make_train_iter(0))[:2]
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        got = step(state, _torch_batch(batch))
        for key in METRICS:
            np.testing.assert_allclose(float(got[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
    _assert_states_match(state, jstate)


@pytest.mark.parametrize("n,fraction,seed", [(32, 0.25, 7), (101, 0.1, 0),
                                             (10, 0.0, 3), (57, 0.5, 1234)])
def test_carve_valid_split_matches_jax(n, fraction, seed):
    for a, b in zip(torch_loader.carve_valid_split(n, fraction, seed),
                    jax_loader.carve_valid_split(n, fraction, seed)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        torch_loader.carve_valid_split(n, 1.0, seed)


def test_resolve_num_valid_samples_matches_jax(native_pair):
    theirs, ours = native_pair
    jcfg, cfg = _cfgs(data_backend="native", valid_fraction=0.25)
    kw = lambda b: dict(num_train_samples=b.num_train_samples,
                        num_test_samples=b.num_test_samples,
                        output_size=b.output_size, input_shape=b.input_shape,
                        num_valid_samples=b.num_valid_samples)
    got = torch_config.resolve(cfg, **kw(ours))
    want = jax_config.resolve(jcfg, **kw(theirs))
    assert got.num_valid_samples == want.num_valid_samples == 8
    assert got.steps_per_train_epoch == want.steps_per_train_epoch == 3


def _host_loader(backend, workers=0, spec="reference", **task):
    _, cfg = _cfgs(data_backend=backend, **task)
    cfg = cfg.replace(
        device=dataclasses.replace(cfg.device, workers_per_replica=workers),
        regularizer=dataclasses.replace(cfg.regularizer, aug_spec=spec))
    return torch_loader.get_loader(cfg, num_fake_samples=N + 4)


@pytest.mark.parametrize("backend", ["tf", "native", "device"])
def test_loader_placement_views_differ_in_every_row(backend, capsys):
    """Fault 3.1: under loader placement every backend makes two
    different views of each image; an epoch is its permutation minus the
    remainder."""
    bundle = _host_loader(backend)
    assert f"data_backend='{backend}'" in capsys.readouterr().out
    for epoch in (0, 1):
        order = torch_loader.epoch_batches(N + 4, BATCH, SEED, epoch, True)
        batches = list(bundle.make_train_iter(epoch))
        assert len(batches) == N // BATCH == len(order)
        seen = np.concatenate(order)      # the permutation minus the rest
        assert len(set(seen.tolist())) == N and set(seen) <= set(range(N + 4))
        for batch, take in zip(batches, order):
            v1, v2 = np.asarray(batch["view1"]), np.asarray(batch["view2"])
            assert v1.shape == v2.shape == (BATCH, SIZE, SIZE, 3)
            assert v1.dtype == np.float32
            assert 0.0 <= min(v1.min(), v2.min())
            assert max(v1.max(), v2.max()) <= 1.0
            assert all(not np.array_equal(a, b) for a, b in zip(v1, v2))
            assert np.array_equal(np.asarray(batch["label"]),
                                  _fake_labels()[take])


def _fake_labels():
    from byol_tpu_torch.data.readers import load_fake
    return load_fake(N + 4, SIZE, seed=SEED)[1].astype(np.int32)


def test_tf_path_paper_spec_and_eval_resize():
    bundle = _host_loader("tf", spec="paper")
    ref = _host_loader("tf")
    a, b = next(bundle.make_train_iter(0)), next(ref.make_train_iter(0))
    assert np.array_equal(a["label"], b["label"])
    assert not np.array_equal(a["view2"], b["view2"])
    test = next(ref.make_test_iter(0))
    assert np.array_equal(test["view1"], test["view2"])


def test_tf_path_batches_do_not_depend_on_workers():
    """Two spawned DataLoader workers give the batches of none.  The
    iteration runs in a thread with a time limit of its own."""
    got = {}

    def collect(workers):
        bundle = _host_loader("tf", workers=workers)
        got[workers] = [_np(b) for e in (0, 1)
                        for b in bundle.make_train_iter(e)]

    collect(0)
    thread = threading.Thread(target=collect, args=(2,), daemon=True)
    thread.start()
    thread.join(timeout=240)
    assert not thread.is_alive(), "DataLoader workers did not finish in 240 s"
    _assert_batches_equal(got[2], got[0])


def test_device_backend_draws_from_seed_epoch_and_batch():
    a = [_np(b) for b in _host_loader("device").make_train_iter(1)]
    b = [_np(b) for b in _host_loader("device").make_train_iter(1)]
    _assert_batches_equal(a, b)
    c = next(_host_loader("device").make_train_iter(2))
    assert not np.array_equal(c["view1"], a[0]["view1"])


def test_backend_resolution_and_refusals(monkeypatch, capsys):
    from byol_tpu_torch.data import native_aug
    monkeypatch.setattr(native_aug, "available", lambda: False)
    _host_loader("native")
    out = capsys.readouterr().out
    assert "falling back to the torch host path" in out
    assert "data_backend='tf'" in out
    monkeypatch.undo()
    with pytest.raises(ValueError, match="tf data backend only"):
        _host_loader("native", spec="paper")
    with pytest.raises(ValueError, match="--download is refused"):
        _host_loader("tf", download=True)
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="unknown task"):
        torch_loader.get_loader(cfg.replace(
            task=dataclasses.replace(cfg.task, task="nope")))


# --------------------------------------------------------------------------
# fit under loader placement: the valid split and exact resume
# --------------------------------------------------------------------------

def _fit_cfg(model_dir):
    return torch_config.Config(
        task=torch_config.TaskConfig(task="fake", batch_size=8, epochs=2,
                                     image_size_override=16,
                                     data_backend="native",
                                     valid_fraction=0.25, grapher="jsonl",
                                     log_dir=str(model_dir / "logs")),
        model=torch_config.ModelConfig(arch="resnet18", head_latent_size=32,
                                       projection_size=16,
                                       model_dir=str(model_dir)),
        optim=torch_config.OptimConfig(lr=0.05, warmup=1,
                                       fused_update="on"),
        device=torch_config.DeviceConfig(num_replicas=1, half=False, seed=7))


def _fit_loader(cfg):
    return torch_loader.get_loader(cfg, num_fake_samples=32)


@pytest.fixture(scope="module")
def one_thread():
    """The fits below run on one torch thread, restored after: the tiny
    net gains nothing from more, and under a parallel test run every
    extra OpenMP team oversubscribes the cores the other tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory, one_thread):
    """-> (config, FitResult, what the run printed)."""
    from byol_tpu_torch.training.trainer import fit
    cfg = _fit_cfg(tmp_path_factory.mktemp("full"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fit(cfg, device="cpu", loader=_fit_loader(cfg))
    return cfg, result, out.getvalue()


def test_fit_evaluates_the_valid_split_each_epoch(uninterrupted):
    _, full, printed = uninterrupted
    lines = printed.splitlines()
    for epoch in (0, 1):
        assert any(x.startswith(f"epoch {epoch}: valid loss") for x in lines)
        assert any(x.startswith(f"input[Epoch {epoch}][3 batches]")
                   for x in lines)
    assert len(full.step_losses) == 2 * 3
    assert len(full.valid_losses) == 2
    assert all(np.isfinite(full.valid_losses))
    assert full.valid_metrics["loss_mean"] == full.valid_losses[-1]
    assert full.input_pipeline["h2d_bytes_per_step"] == 2 * 8 * 16 * 16 * \
        3 * 4 + 8 * 4


def test_sigterm_then_relaunch_under_loader_placement(uninterrupted,
                                                      tmp_path, one_thread):
    from byol_tpu_torch.core.config import run_name
    from byol_tpu_torch.training.trainer import fit
    assert threading.current_thread() is threading.main_thread()
    _, full, _ = uninterrupted
    cfg = _fit_cfg(tmp_path)
    base = _fit_loader(cfg)

    def signalling(epoch):
        for i, batch in enumerate(base.make_train_iter(epoch)):
            yield batch
            if epoch == 1 and i == 0:
                signal.raise_signal(signal.SIGTERM)

    with pytest.raises(SystemExit) as exc:
        fit(cfg, device="cpu", verbose=False,
            loader=dataclasses.replace(base, make_train_iter=signalling))
    assert exc.value.code == 143
    store = CheckpointStore(str(tmp_path / run_name(cfg)))
    tree, epoch = store.restore()
    store.close()
    s = tree["step"]
    assert epoch == 1 and 3 < s < 6
    resumed = fit(cfg, device="cpu", loader=_fit_loader(cfg), verbose=False)
    assert resumed.step_losses == full.step_losses[s:]
    assert resumed.test_losses == full.test_losses[1:]
    assert resumed.valid_losses == full.valid_losses[1:]
    for name in ("params", "target", "momentum"):
        assert torch.equal(getattr(resumed.state, name),
                           getattr(full.state, name)), name
