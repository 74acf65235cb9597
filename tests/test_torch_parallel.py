"""The port's data axis (byol_tpu_torch/parallel/, the per-rank loader
shards, the synced BatchNorm) held against the JAX package.

No processes where none are needed: the loader shards are built here for
each rank of worlds 2 and 4 (``get_loader(process=(rank, world))``)
beside the JAX loader with its process index and count patched, and must
equal it batch for batch where both make the same arrays (the shards, the
eval transforms, the native image_folder views).  The lockstep protocol,
the synced BatchNorm and the collectives run two ranks as OS processes
over gloo (tests/torch_ranks.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from byol_tpu.cli import build_parser as jax_parser
from byol_tpu.core import config as jax_config
from byol_tpu.data import loader as jax_loader
from byol_tpu_torch.cli import build_parser, config_from_args
from byol_tpu_torch.core import config as torch_config
from byol_tpu_torch.data import loader as torch_loader
from byol_tpu_torch.data import native_aug
from byol_tpu_torch.observability.events import validate_event
from byol_tpu_torch.parallel import collectives, mesh
from byol_tpu_torch.parallel.compile_plan import build_plan
from byol_tpu_torch.parallel.lockstep import lockstep_iter
from tests.test_torch_imagefolder import _write_tree
from tests.torch_ranks import run_ranks
from tests.torch_ranks import one_torch_thread  # noqa: F401

N, BATCH, SIZE, SEED = 64, 8, 16, 5


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native library from a private build
    (tests/test_torch_native_aug.py says why)."""
    from byol_tpu.data import native_aug as jax_native_aug
    from tests.test_torch_native_aug import private_jax_native
    with private_jax_native(tmp_path_factory):
        jax_native_aug.load()
        yield jax_native_aug


def _as_rank(monkeypatch, index, count):
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: count)


def _cfgs(task="fake", shard_eval=False, **more):
    out = []
    for lib in (jax_config, torch_config):
        out.append(lib.Config(
            task=lib.TaskConfig(task=task, batch_size=BATCH,
                                image_size_override=SIZE, **more),
            device=lib.DeviceConfig(num_replicas=1, seed=SEED,
                                    workers_per_replica=0,
                                    shard_eval=shard_eval)))
    return out


def _equal_batches(ours, theirs, keys=("view1", "view2", "label")):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for k in keys:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("count", [2, 4])
def test_array_shards_match_jax(count, jax_native, monkeypatch):
    x = np.arange(N * 3).reshape(N, 3)
    y = np.arange(N)
    for index in range(count):
        for a, b in zip(torch_loader.shard_arrays(x, y, index, count),
                        jax_loader._shard_arrays(x, y, index, count)):
            assert np.array_equal(a, b)
    for shard_eval in (False, True):
        jcfg, cfg = _cfgs(data_backend="native", valid_fraction=0.25,
                          shard_eval=shard_eval)
        for index in range(count):
            _as_rank(monkeypatch, index, count)
            theirs = jax_loader.get_loader(jcfg, num_fake_samples=N,
                                           shard_eval=shard_eval)
            ours = torch_loader.get_loader(cfg, num_fake_samples=N,
                                           process=(index, count))
            assert ours.eval_sharded == theirs.eval_sharded == shard_eval
            assert (ours.num_train_samples, ours.num_valid_samples,
                    ours.num_test_samples) == (
                theirs.num_train_samples, theirs.num_valid_samples,
                theirs.num_test_samples)
            for make in ("make_test_iter", "make_valid_iter",
                         "make_train_eval_iter"):
                _equal_batches(getattr(ours, make)(1),
                               getattr(theirs, make)(1))
            # the train shard and its order; rank 0's views are JAX's, the
            # others' mix the rank into the stream seed (JAX's image_folder
            # rule), which JAX's array path leaves out
            _equal_batches(ours.make_train_iter(0), theirs.make_train_iter(0),
                           ("label",) if index else
                           ("view1", "view2", "label"))
            assert len(next(ours.make_train_iter(0))["label"]) == \
                BATCH // count


@pytest.mark.parametrize("count", [2, 4])
def test_image_folder_shards_match_jax(count, jax_native, monkeypatch,
                                       tmp_path):
    root = str(tmp_path)
    _write_tree(root, (("train", 8), ("test", 4)))
    for backend in ("tf", "native"):
        if backend == "native" and not (native_aug.has_jpeg()
                                        and jax_native.has_jpeg()):
            continue
        jcfg, cfg = _cfgs("image_folder", shard_eval=True, data_dir=root,
                          data_backend=backend, valid_fraction=0.25)
        seen = []
        for index in range(count):
            _as_rank(monkeypatch, index, count)
            theirs = jax_loader.get_loader(jcfg, shard_eval=True)
            ours = torch_loader.get_loader(cfg, process=(index, count))
            assert (ours.num_train_samples, ours.num_valid_samples) == (
                theirs.num_train_samples, theirs.num_valid_samples)
            keys = (("view1", "view2", "label") if backend == "native"
                    else ("label",))
            # eval batches in file order: the shard's labels
            for make in ("make_test_iter", "make_valid_iter"):
                _equal_batches(getattr(ours, make)(0),
                               getattr(theirs, make)(0), ("label",))
            if backend == "native":
                _equal_batches(ours.make_train_iter(0),
                               theirs.make_train_iter(0), keys)
            seen.extend(np.concatenate([b["label"] for b in
                                        ours.make_test_iter(0)]).tolist())
        # the ranks' test shards partition the split
        assert sorted(seen) == [0] * 4 + [1] * 4


def test_lockstep_on_uneven_shards_and_a_raising_rank(tmp_path):
    assert list(lockstep_iter(iter(range(3)), lambda: "pad")) == [0, 1, 2]
    uneven = run_ranks("lockstep", dict(counts=[3, 1]), 2, tmp_path / "a")
    assert [r["seen"] for r in uneven] == [[0, 1, 2], [0, "pad", "pad"]]
    assert all(r["error"] is None for r in uneven)
    failing = run_ranks("lockstep", dict(counts=[3, 3], raise_on=1,
                                         raise_at=1), 2, tmp_path / "b",
                        timeout=60)
    assert [r["seen"] for r in failing] == [[0], [0]]
    assert failing[1]["error"].startswith("OSError")
    assert failing[0]["error"].startswith("RuntimeError")
    assert "rank(s) [1]" in failing[0]["error"]


def test_describe_has_jax_fields_and_validates():
    from byol_tpu.parallel.compile_plan import build_plan as jax_build_plan
    from byol_tpu.parallel.mesh import MeshSpec, build_mesh
    want = jax_build_plan(build_mesh(MeshSpec(data=2),
                                     devices=jax.devices()[:2]),
                          zero1=True, flat_resident=True).describe()
    got = build_plan(2, zero1=True, flat_resident=True).describe()
    assert got == want
    validate_event({"v": 1, "kind": "run_header", "t": 0.0, "config": {},
                    "jax_version": None, "backend": "cpu",
                    "sharding_plan": got})
    assert build_plan().describe()["zero1"] == "off"


def _resolve(cfg):
    return torch_config.resolve(cfg, num_train_samples=256,
                                num_test_samples=32, output_size=10,
                                input_shape=(16, 16, 3))


def test_refusals_name_their_reasons():
    cfg = torch_config.Config(
        task=torch_config.TaskConfig(batch_size=16),
        optim=torch_config.OptimConfig(fused_update="on"),
        device=torch_config.DeviceConfig(num_replicas=2))
    dev = lambda **kw: cfg.replace(device=dataclasses.replace(cfg.device,
                                                             **kw))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _resolve(dev(dcn_data_parallel=2))
    # 16 rows over 2 ranks: 8 a rank, not 3 strided microbatches
    with pytest.raises(ValueError, match="strided microbatches"):
        _resolve(cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                       accum_steps=3)))
    unfused = cfg.replace(optim=dataclasses.replace(
        cfg.optim, fused_update="off", optimizer="lamb"))
    # accepted now: ZeRO-1 and the resident layout, with the fused update
    # and (the port's state is flat for every chain) with any unfused
    # chain, and a DCN axis of 1
    assert _resolve(dev(zero1="on", flat_resident="on",
                        flat_bucket_mb=8)).batch_size_per_replica == 8
    assert _resolve(unfused.replace(device=dataclasses.replace(
        cfg.device, zero1="on", flat_resident="on"))).cfg.optim.optimizer \
        == "lamb"
    # the sequence axis, remat and the TP heads are ported; a DCN axis
    # stays refused
    for flags in (["--sequence-parallel", "2"], ["--remat"],
                  ["--model-parallel", "2"]):
        parsed = config_from_args(build_parser().parse_args(
            ["--batch-size", "16"] + flags))
        assert _resolve(parsed).cfg == parsed
    for flags in (["--dcn-data-parallel", "2"],):
        parsed = config_from_args(build_parser().parse_args(
            ["--batch-size", "16"] + flags))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            _resolve(parsed)


FLAGS = ("--num-replicas", "--num-processes", "--distributed-master",
         "--distributed-rank", "--distributed-port", "--shard-eval",
         "--zero1", "--flat-resident", "--flat-bucket-mb",
         "--dcn-data-parallel", "--convert-to-sync-bn", "--model-parallel",
         "--sequence-parallel", "--remat")


@pytest.mark.parametrize("flag", FLAGS)
def test_cli_flag_has_jax_default_and_choices(flag):
    def action(parser):
        return next(a for a in parser._actions if flag in a.option_strings)
    ours, theirs = action(build_parser()), action(jax_parser())
    assert (ours.default, ours.choices, ours.type, ours.nargs) == (
        theirs.default, theirs.choices, theirs.type, theirs.nargs)


def test_mesh_without_a_process_group_is_one_rank():
    assert not mesh.is_initialized()
    assert mesh.process_info() == (0, 1) and mesh.is_primary()
    assert mesh.MeshSpec().shape == {"data": 1, "sequence": 1, "model": 1}
    assert mesh.local_rows(16) == 16
    batch = {"x": np.arange(8)}
    assert np.array_equal(mesh.shard_batch(batch, 1, 2)["x"], [4, 5, 6, 7])
    x = torch.ones(3, requires_grad=True)
    assert collectives.psum(x) is x and collectives.all_gather(x) is x
    assert mesh.initialize_distributed("cpu") is False
    assert mesh.mesh_shape() == {"data": 1, "sequence": 1, "model": 1}
    # the ring shift of a one-rank sequence axis is the identity
    assert collectives.ppermute_shift(x) is x
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch({"x": np.arange(7)}, 0, 2)


SYNC_ARGV = ["--no-cuda", "--arch", "resnet18", "--image-size-override",
             "16", "--batch-size", "16", "--no-half", "--head-latent-size",
             "32", "--projection-size", "16", "--no-convert-to-sync-bn"]


def test_two_rank_batchnorm_statistics_are_global_with_sync_flag_off(
        tmp_path):
    """``convert_to_sync_bn`` changes nothing, as in JAX: with it off, two
    ranks' train-mode forward normalises with the global batch's
    statistics and ticks the running ones with them."""
    from tests.torch_ranks import bn_stats
    x = np.random.RandomState(0).randn(16, 16, 16, 3).astype(np.float32)
    assert config_from_args(build_parser().parse_args(
        SYNC_ARGV)).regularizer.convert_to_sync_bn is False
    ranks = run_ranks("bn_stats", dict(argv=SYNC_ARGV, x=x), 2, tmp_path)
    one = bn_stats(dict(argv=SYNC_ARGV, x=x))       # one rank, every row
    np.testing.assert_allclose(
        torch.cat([r["out"] for r in ranks]).numpy(), one["out"].numpy(),
        rtol=1e-4, atol=1e-5)
    for name, want in one["stats"].items():
        for r in ranks:
            np.testing.assert_allclose(r["stats"][name].numpy(),
                                       want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_sigterm_on_one_rank_checkpoints_once_and_every_rank_exits_143(
        tmp_path):
    from byol_tpu_torch.checkpoint.checkpointer import CheckpointStore
    model_dir = tmp_path / "models"
    argv = ["--no-cuda", "--task", "fake", "--arch", "resnet18",
            "--image-size-override", "16", "--batch-size", "16",
            "--epochs", "1", "--no-half", "--fused-update", "on",
            "--warmup", "0", "--head-latent-size", "32",
            "--projection-size", "16", "--workers-per-replica", "0",
            "--grapher", "null", "--spans", "off",
            "--model-dir", str(model_dir), "--log-dir", str(tmp_path / "l")]
    run_ranks("fit_sigterm", dict(argv=argv, at=3), 2, tmp_path,
              expect_rc=143)
    (run_dir,) = [str(p) for p in model_dir.iterdir()]
    store = CheckpointStore(run_dir)
    assert list(store.epochs()) == [0]
    tree, _ = store.restore(best=False)
    store.close()
    # saved at a step boundary mid-epoch (32 steps an epoch): as last
    assert 0 < tree["step"] < 32
