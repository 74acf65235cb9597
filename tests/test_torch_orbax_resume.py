"""The port's readers of a ``byol_tpu`` run directory: the trainer
resumes from the JAX package's orbax checkpoint and writes its own beside
it, the store never prunes, replaces or writes into an orbax checkpoint,
and serving reads only the ``params`` and ``batch_stats`` leaves, its
embeddings held against JAX's ``frozen_representation_fn`` at the
serving tolerance (fp32 1e-4, tests/test_torch_serving.py).

The run directory's checkpoint is written by ``byol_tpu``'s own
``CheckpointStore`` for the tiny net (tests/torch_ranks.py::tiny_net),
registered under an arch name of its own so the port's CLIs build it.
"""
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.training.linear_eval import frozen_representation_fn
from byol_tpu_torch.checkpoint import CheckpointStore, ocdbt, orbax_fixture
from byol_tpu_torch.cli import build_parser, config_from_args
from byol_tpu_torch.cli import main as train_main
from byol_tpu_torch.core.config import run_name
from byol_tpu_torch.models import registry
from byol_tpu_torch.models import resnet as torch_resnet
from byol_tpu_torch.serving.cli import main as serve_main
from byol_tpu_torch.serving.service import ServeConfig, build_service
from tests.test_torch_orbax import jax_tiny_net, jax_tiny_state, save_jax
from tests.torch_ranks import WIDTH

ARCH = "resnet_tiny_orbax_test"
SIZE = 16
STEP, EMA_STEP = 7, 9


@pytest.fixture(scope="module")
def tiny_arch():
    if ARCH not in registry.available():
        registry.register(ARCH, registry.BackboneSpec(
            factory=lambda dtype, image_size, **kw: torch_resnet.ResNet(
                stage_sizes=[1, 1], block_cls=torch_resnet.Bottleneck,
                width=WIDTH, dtype=dtype, **kw),
            feature_dim=WIDTH * 2 * 4))
    return ARCH


def _argv(tmp_path, *extra):
    return ["--no-cuda", "--task", "fake", "--arch", ARCH,
            "--image-size-override", str(SIZE), "--batch-size", "8",
            "--epochs", "2", "--debug-step", "--no-half", "--warmup", "0",
            "--head-latent-size", "32", "--projection-size", "16",
            "--workers-per-replica", "0",
            "--model-dir", str(tmp_path / "models"),
            "--log-dir", str(tmp_path / "logs"), *extra]


def _run_dir(argv):
    cfg = config_from_args(build_parser().parse_args(argv))
    return cfg, os.path.join(cfg.model.model_dir, run_name(cfg))


def _listing(path):
    """{file: sha256} under ``path``."""
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_trainer_resumes_a_jax_run_and_writes_beside_it(tiny_arch, tmp_path,
                                                        capsys):
    """JAX's ckpt-0 at step 7 / ema_step 9: the port's CLI resumes there,
    trains epoch 1 (one step under --debug-step) and writes ckpt-1/state.pt
    at step 8 / ema_step 10; the orbax checkpoint is untouched."""
    argv = _argv(tmp_path)
    _, run_dir = _run_dir(argv)
    ckpt0 = save_jax(run_dir, jax_tiny_state(step=STEP, ema_step=EMA_STEP))
    before = _listing(ckpt0)
    assert train_main(argv) == 0
    out = capsys.readouterr().out
    assert (f"resumed from the checkpoint of epoch 0 at step {STEP} (the JAX "
            "package's orbax checkpoint") in out
    assert "epoch 1:" in out and "epoch 0:" not in out
    store = CheckpointStore(run_dir)
    assert store.epochs() == (0, 1)
    assert (store.kind(0), store.kind(1)) == ("orbax", "torch")
    tree, epoch = store.restore()
    store.close()
    assert epoch == 1 and (tree["step"], tree["ema_step"]) == (
        STEP + 1, EMA_STEP + 1)
    assert all(torch.isfinite(v).all() for v in tree["params"].values())
    assert _listing(ckpt0) == before
    assert sorted(os.listdir(run_dir)) == ["ckpt-0", "ckpt-1", "meta.json"]


def _small_orbax(path, seed):
    rng = np.random.RandomState(seed)
    orbax_fixture.write_checkpoint(
        str(path), {"w": rng.rand(40, 30).astype(np.float32),
                    "step": np.int32(seed)}, seed=seed)


def test_prune_and_resave_never_touch_an_orbax_checkpoint(tmp_path):
    """Pruning skips orbax epochs; the port's checkpoint of an epoch an
    orbax one holds goes to ckpt-<epoch>.torch, which shadows it."""
    for e in (0, 1):
        _small_orbax(tmp_path / f"ckpt-{e}", e)
    before = _listing(tmp_path)
    store = CheckpointStore(str(tmp_path))
    assert store.epochs() == (0, 1) and store.kind(0) == "orbax"
    tree = {"w": torch.full((2,), 3.0), "format": 1}
    for e in (1, 2, 3, 4):
        store.save(e, dict(tree, epoch=e), keep=1)
    store.wait()
    names = sorted(os.listdir(tmp_path))
    # the port's 1 (ckpt-1.torch) and 2 pruned, 3 and 4 kept; both orbax
    # checkpoints untouched
    assert names == ["ckpt-0", "ckpt-1", "ckpt-3", "ckpt-4", "meta.json"]
    store.save(1, dict(tree, epoch=11), keep=5)
    store.wait()
    assert os.path.isfile(tmp_path / "ckpt-1.torch" / "state.pt")
    assert store.kind(1) == "torch"
    back, epoch = store.restore(epoch=1)
    assert (back["epoch"], epoch) == (11, 1)
    # JAX's ckpt-1 gone: the epoch's next save still goes to its shadow
    os.rename(tmp_path / "ckpt-1", tmp_path / "moved-1")
    store.save(1, dict(tree, epoch=12), keep=5)
    store.wait()
    assert not os.path.exists(tmp_path / "ckpt-1")
    assert store.restore(epoch=1)[0]["epoch"] == 12
    os.rename(tmp_path / "moved-1", tmp_path / "ckpt-1")
    store.close()
    after = _listing(tmp_path)
    for name, digest in before.items():
        assert after[name] == digest, name


def test_epochs_refuse_what_neither_package_committed(tmp_path):
    junk = tmp_path / "junk" / "ckpt-3"
    junk.mkdir(parents=True)
    (junk / "notes.txt").write_text("mine")
    with pytest.raises(ValueError, match="not a checkpoint of either"):
        CheckpointStore(str(tmp_path / "junk"))
    half = tmp_path / "half" / "ckpt-2"
    _small_orbax(half, 2)
    os.remove(half / "_CHECKPOINT_METADATA")
    with pytest.raises(ValueError, match="uncommitted orbax write"):
        CheckpointStore(str(tmp_path / "half"))
    assert os.path.isfile(junk / "notes.txt")
    assert os.path.isfile(half / "manifest.ocdbt")


def _serve_cfg(tmp_path):
    from byol_tpu_torch.serving.cli import build_serve_parser
    from byol_tpu_torch.serving.cli import config_from_args as serve_config
    return serve_config(build_serve_parser().parse_args(
        ["--arch", ARCH, "--image-size-override", str(SIZE), "--no-half",
         "--head-latent-size", "32", "--projection-size", "16",
         "--no-cuda"]))


def test_serving_reads_only_weights_and_matches_jax(tiny_arch, tmp_path,
                                                    capsys):
    state = jax_tiny_state(seed=6)
    run_dir = tmp_path / "jax_run"
    ckpt = save_jax(run_dir, state)
    store = CheckpointStore(str(run_dir))
    weights, _ = store.restore(weights_only=True)
    store.close()
    keys = ocdbt.OcdbtStore(ckpt).keys()
    wanted = [k for k in keys if k.split(b".")[0] in (b"params",
                                                      b"batch_stats")]
    assert store.last_read["keys_read"] == len(wanted)
    assert store.last_read["keys_total"] == len(keys) > 2 * len(wanted)
    assert set(weights) == {"params", "batch_stats"}

    cfg = _serve_cfg(tmp_path)
    rows = np.random.RandomState(1).rand(8, SIZE, SIZE, 3).astype(np.float32)
    want = np.asarray(frozen_representation_fn(
        jax_tiny_net(), state.params, state.batch_stats)(jnp.asarray(rows)))
    with build_service(cfg, ServeConfig(min_bucket=8, max_bucket=8),
                       checkpoint_dir=str(run_dir), device="cpu") as svc:
        got = svc.embed(rows, timeout=120)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    line = capsys.readouterr().out
    assert (f"{len(wanted)} of {len(keys)} keys" in line
            and "params and batch_stats only" in line)
    rc = serve_main(["--arch", ARCH, "--image-size-override", str(SIZE),
                     "--no-half", "--head-latent-size", "32",
                     "--projection-size", "16", "--no-cuda", "--checkpoint",
                     str(run_dir), "--smoke", "8", "--max-batch", "8",
                     "--log-dir", str(tmp_path / "serve_logs")])
    assert rc == 0
    assert f"{len(wanted)} of {len(keys)} keys" in capsys.readouterr().out
