"""The port's checkpoint store, ModelSaver, canonical state tree and run
name, held against the JAX package's (byol_tpu/checkpoint/,
byol_tpu/core/config.py::run_name) on the same inputs."""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu import checkpoint as jax_ckpt
from byol_tpu.cli import build_parser as jax_parser
from byol_tpu.cli import config_from_args as jax_config_from_args
from byol_tpu.core import config as jax_config
from byol_tpu.models import resnet as jax_resnet
from byol_tpu.models.byol_net import BYOLNet as JaxBYOLNet
from byol_tpu.observability.events import sanitize as jax_sanitize
from byol_tpu.optim.factory import build_optimizer as jax_build_optimizer
from byol_tpu.optim.factory import extract_sgdm_state
from byol_tpu.training.state import create_train_state as jax_create_state
from byol_tpu_torch import checkpoint as torch_ckpt
from byol_tpu_torch.cli import build_parser, config_from_args
from byol_tpu_torch.convert import train_state_from_flax
from byol_tpu_torch.core import config as torch_config
from byol_tpu_torch.models import resnet as torch_resnet
from byol_tpu_torch.models.byol_net import BYOLNet
from byol_tpu_torch.observability.events import sanitize
from byol_tpu_torch.training.state import (canonical_state,
                                           create_train_state,
                                           load_canonical, load_converted)

NAN, INF = float("nan"), float("inf")


# --------------------------------------------------------------------------
# the two packages behind one interface: a tree of one value, a saver, a
# store, and what a restore gives back
# --------------------------------------------------------------------------

class _Jax:
    saver, store = jax_ckpt.ModelSaver, jax_ckpt.CheckpointStore

    @staticmethod
    def tree(value):
        return {"w": jnp.full((2,), float(value))}

    @staticmethod
    def restore_best(saver):
        state, nxt = saver.restore({"w": jnp.zeros((2,))}, best=True)
        return float(np.asarray(state["w"])[0]), nxt

    @staticmethod
    def restore(store, **kw):
        state, epoch = store.restore(
            jax_ckpt.abstract_like({"w": jnp.zeros((2,))}), **kw)
        return float(np.asarray(state["w"])[0]), epoch

    @staticmethod
    def wait(store):
        store._ckptr.wait_until_finished()


class _Torch:
    saver, store = torch_ckpt.ModelSaver, torch_ckpt.CheckpointStore

    @staticmethod
    def tree(value):
        return {"w": torch.full((2,), float(value))}

    @staticmethod
    def restore_best(saver):
        tree, nxt = saver.restore(best=True)
        return float(tree["w"][0]), nxt

    @staticmethod
    def restore(store, **kw):
        tree, epoch = store.restore(**kw)
        return float(tree["w"][0]), epoch

    @staticmethod
    def wait(store):
        store.wait()


IMPLS = {"jax": _Jax, "torch": _Torch}


def _ckpt_dirs(directory):
    return sorted(n for n in os.listdir(directory) if n.startswith("ckpt-"))


def _raw_meta(directory):
    with open(os.path.join(directory, "meta.json")) as f:
        return json.load(f)


# (ModelSaver keywords, test metric per epoch, epoch of a relaunch or None)
SEQUENCES = {
    "burn_in": (dict(burn_in_interval=2), [0.5, 0.4, 0.6, 0.3, 0.7], None),
    "improvement": ({}, [1.0, 0.8, 0.6, 0.4], None),
    "patience_exhausted": (dict(early_stop=True, max_early_stop_steps=2),
                           [1.0, 0.5, 0.7, 0.6, 0.9, 0.1], None),
    "larger_is_better": (dict(larger_is_better=True),
                         [0.1, 0.3, 0.2, 0.4, 0.35], None),
    "nan_metric": (dict(early_stop=True, max_early_stop_steps=3),
                   [NAN, 0.5, NAN, 0.4, INF], None),
    "restart_mid_sequence": (dict(early_stop=True, max_early_stop_steps=3),
                             [0.5, 0.6, 0.7, 0.8, 0.2, 0.9], 3),
}


def _drive(impl, directory, kw, metrics, restart_at):
    saver = impl.saver(directory, **kw)
    returns = []
    for epoch, metric in enumerate(metrics):
        if epoch == restart_at:
            saver.close()
            saver = impl.saver(directory, **kw)
        returns.append(saver(metric, epoch, impl.tree(epoch)))
        if returns[-1]:
            break
    attrs = (saver.best_metric, saver.stall_count, saver.stopped_early)
    impl.wait(saver.store)
    before_restore = (_raw_meta(directory), _ckpt_dirs(directory))
    restored = impl.restore_best(saver)
    after = (_raw_meta(directory), _ckpt_dirs(directory))
    saver.close()
    return returns, attrs, before_restore, restored, after


def _same(a, b):
    """Equality that takes NaN as equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_model_saver_matches_jax(case, tmp_path):
    """Return values, meta.json, the surviving ckpt-* and the best restore
    are the JAX ModelSaver's, case for case."""
    kw, metrics, restart_at = SEQUENCES[case]
    want = _drive(_Jax, str(tmp_path / "jax"), kw, metrics, restart_at)
    got = _drive(_Torch, str(tmp_path / "torch"), kw, metrics, restart_at)
    assert got[0] == want[0]                       # __call__ returns
    assert _same(got[1], want[1])                  # best, stall, stopped
    assert got[2] == want[2]                       # meta.json, ckpt-* dirs
    assert got[3] == want[3]                       # best value, next epoch
    assert got[4] == want[4]                       # after restore(best)


def _two_saves_then_lose_the_last(impl, directory):
    store = impl.store(directory)
    store.save(0, impl.tree(0))
    store.save(1, impl.tree(1), metric=0.1, is_best=True)
    impl.wait(store)
    import shutil
    shutil.rmtree(os.path.join(directory, "ckpt-1"))
    return store


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_restore_falls_back_when_meta_points_at_missing_ckpt(impl, tmp_path):
    """meta.json names a checkpoint that never reached the disk: last and
    best both fall back to the newest on disk (tests/test_checkpoint.py's
    case, both packages)."""
    impl = IMPLS[impl]
    store = _two_saves_then_lose_the_last(impl, str(tmp_path / "c"))
    assert store.read_meta()["last_epoch"] == 1
    assert impl.restore(store) == (0.0, 0)
    assert impl.restore(store, best=True) == (0.0, 0)
    store.close()


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_best_fallback_picks_best_surviving_metric(impl, tmp_path):
    impl = IMPLS[impl]
    directory = str(tmp_path / "bf")
    store = impl.store(directory)
    vals = {0: 0.5, 1: 0.2, 2: 0.9, 3: 0.1}
    for e, m in vals.items():
        store.save(e, impl.tree(e), metric=m,
                   is_best=(m == min(list(vals.values())[:e + 1])), keep=10)
    impl.wait(store)
    import shutil
    shutil.rmtree(os.path.join(directory, "ckpt-3"))     # lose the best
    assert impl.restore(store, best=True) == (1.0, 1)    # 0.2 of survivors
    store.close()


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_explicit_epoch_restore_never_substitutes(impl, tmp_path):
    impl = IMPLS[impl]
    store = impl.store(str(tmp_path / "ex"))
    store.save(0, impl.tree(0))
    impl.wait(store)
    with pytest.raises(Exception):
        impl.restore(store, epoch=7)
    assert impl.restore(store, epoch=0) == (0.0, 0)
    store.close()


def test_failed_write_raises_at_the_wait(tmp_path):
    """A write that fails on the writer thread is not swallowed: the next
    wait (here the next save) raises it, and nothing is published."""
    store = torch_ckpt.CheckpointStore(str(tmp_path / "w"))
    import threading
    store.save(0, {"w": torch.zeros(2), "lock": threading.Lock()})
    with pytest.raises(TypeError):
        store.save(1, {"w": torch.ones(2)})
    assert store.epochs() == ()
    store.close()


# --------------------------------------------------------------------------
# the canonical tree
# --------------------------------------------------------------------------

SIZE, CLASSES, HEAD, PROJ = 16, 10, 32, 16


def _tiny_resnet18(module, dtype):
    """resnet18's layout (BasicBlock, 2-2-2-2) at width 8."""
    return module.ResNet(stage_sizes=[2, 2, 2, 2],
                         block_cls=module.BasicBlock, width=8,
                         small_inputs=True, zero_init_residual=False,
                         dtype=dtype)


def _jax_state_as_numpy(polyak_ema=0.0):
    """A tiny JAX TrainState's structure (traced with eval_shape, no
    compile), filled with random values, as a state after some steps has
    them: momentum, target, Polyak params (under ``polyak_ema``),
    statistics and counters all distinct."""
    net = JaxBYOLNet(backbone=_tiny_resnet18(jax_resnet, jnp.float32),
                     num_classes=CLASSES, head_latent_size=HEAD,
                     projection_size=PROJ)
    tx, _ = jax_build_optimizer("lars_momentum", base_lr=0.2,
                                global_batch_size=8, weight_decay=1e-6,
                                total_units=10, warmup_units=0)

    def make():
        variables = net.init({"params": jax.random.PRNGKey(3)},
                             jnp.zeros((2, SIZE, SIZE, 3)), train=True,
                             method="warmup")
        return jax_create_state(variables, tx, polyak_ema=polyak_ema)
    rng = np.random.RandomState(0)
    state = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(s.dtype)
        if jnp.issubdtype(s.dtype, jnp.floating) else np.zeros(s.shape,
                                                               s.dtype),
        jax.eval_shape(make))
    trace, _ = extract_sgdm_state(state.opt_state)
    return {"params": state.params, "batch_stats": state.batch_stats,
            "target_params": state.target_params, "momentum": trace,
            "polyak_params": state.polyak_params,
            "count": 37, "step": 37, "ema_step": 41}


def _torch_state(seed, polyak_ema=0.0):
    gen = torch.Generator().manual_seed(seed)
    net = BYOLNet(_tiny_resnet18(torch_resnet, torch.float32),
                  num_classes=CLASSES, head_latent_size=HEAD,
                  projection_size=PROJ)
    from byol_tpu_torch.models.layers import init_params
    init_params(net, gen)
    return create_train_state(net, polyak_ema=polyak_ema)


def _assert_bitwise(a, b):
    assert (a.polyak is None) == (b.polyak is None)
    for name in ("params", "target", "momentum") + (
            () if a.polyak is None else ("polyak",)):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    sa, sb = a.batch_stats(), b.batch_stats()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert (a.step, a.count, a.ema_step) == (b.step, b.count, b.ema_step)


def test_canonical_round_trip_is_bitwise(tmp_path):
    """JAX TrainState -> train_state_from_flax -> load_converted -> save ->
    restore -> load_canonical into a state from another seed: every buffer,
    statistic and counter comes back bit for bit, and the parameters stay
    views of the flat buffers."""
    src = _torch_state(0)
    load_converted(src, train_state_from_flax(_jax_state_as_numpy(),
                                              like=src.net.state_dict()))
    tree = canonical_state(src)
    assert tree["step"] == 37 and tree["ema_step"] == 41
    for key in ("params", "target", "momentum"):
        assert list(tree[key]) == list(src.names)
        for name, shape in zip(src.names, src.shapes):
            assert tree[key][name].shape == shape
            assert tree[key][name].device.type == "cpu"
    # the tree is a copy: a later in-place update does not reach it
    live = src.params.clone()
    before = tree["params"][src.names[0]].clone()
    src.params.add_(1.0)
    assert torch.equal(tree["params"][src.names[0]], before)
    src.params.copy_(live)

    store = torch_ckpt.CheckpointStore(str(tmp_path / "rt"))
    store.save(0, tree)
    restored, epoch = store.restore()
    store.close()
    dst = _torch_state(1)
    assert not torch.equal(dst.params, src.params)
    load_canonical(dst, restored)
    assert epoch == 0
    _assert_bitwise(src, dst)
    first = dict(dst.net.named_parameters())[dst.names[0]]
    assert first.data_ptr() == dst.params.data_ptr()
    with pytest.raises(ValueError, match="format"):
        load_canonical(dst, dict(restored, format=2))


def test_polyak_round_trip_is_bitwise_and_its_absence_is_named(tmp_path):
    """A state with a Polyak average: JAX's ``polyak_params`` carried across
    by ``train_state_from_flax``, saved and restored bit for bit, and kept
    a view-backed flat buffer.  A tree without ``polyak`` (a format-1 tree
    of a run without it) loads into a state without Polyak and is refused,
    naming the key, by a state that needs it; a tree with ``polyak`` is
    refused by a state without one."""
    src = _torch_state(0, polyak_ema=0.99)
    load_converted(src, train_state_from_flax(
        _jax_state_as_numpy(polyak_ema=0.99), like=src.net.state_dict()))
    tree = canonical_state(src)
    assert tree["format"] == 1 and list(tree["polyak"]) == list(src.names)
    assert not torch.equal(src.polyak, src.params)
    store = torch_ckpt.CheckpointStore(str(tmp_path / "polyak"))
    store.save(0, tree)
    restored, _ = store.restore()
    store.close()
    dst = _torch_state(1, polyak_ema=0.99)
    load_canonical(dst, restored)
    _assert_bitwise(src, dst)
    first = dict(dst.polyak_net.named_parameters())[dst.names[0]]
    assert first.data_ptr() == dst.polyak.data_ptr()

    plain = _torch_state(2)
    without = canonical_state(plain)
    assert "polyak" not in without and without["format"] == 1
    load_canonical(_torch_state(3), without)
    with pytest.raises(ValueError, match="'polyak'"):
        load_canonical(dst, without)
    with pytest.raises(ValueError, match="polyak"):
        load_canonical(plain, restored)


def test_orbax_checkpoint_is_refused_and_nothing_deleted(tmp_path, capsys):
    """The JAX package's orbax ckpt-0 under the port's run directory, of a
    tree that is not a TrainState: the store and the ModelSaver list it as
    an orbax epoch, the training CLI refuses it, naming the leaf it cannot
    place, and nothing is deleted."""
    argv = ["--no-cuda", "--task", "fake", "--arch", "resnet18",
            "--image-size-override", "16", "--batch-size", "8", "--epochs",
            "2", "--no-half", "--head-latent-size", "32",
            "--projection-size", "16", "--model-dir", str(tmp_path)]
    cfg = config_from_args(build_parser().parse_args(argv))
    directory = str(tmp_path / torch_config.run_name(cfg))
    store = jax_ckpt.CheckpointStore(directory)
    store.save(0, {"w": jnp.zeros((2,))}, metric=1.0, is_best=True)
    store.close()

    def listing():
        return sorted(os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
                      for f in fs)
    before = listing()
    assert any("ckpt-0" in p for p in before)
    store = torch_ckpt.CheckpointStore(directory)
    assert store.epochs() == (0,) and store.kind(0) == "orbax"
    store.close()
    saver = torch_ckpt.ModelSaver(directory)
    assert saver.has_checkpoint() and saver.best_metric == 1.0
    saver.close()
    from byol_tpu_torch.cli import main
    assert main(argv) == 2
    assert "[('w',)] cannot be placed in a TrainState" in \
        capsys.readouterr().err
    assert listing() == before


# --------------------------------------------------------------------------
# config serialisation and run names
# --------------------------------------------------------------------------

ARGVS = {
    "defaults": [],
    "headline": ["--task", "fake", "--arch", "resnet50",
                 "--image-size-override", "224", "--batch-size", "64",
                 "--epochs", "2", "--fused-update", "on",
                 "--augment-placement", "step", "--fused-augment", "on",
                 "--model-dir", "/tmp/m"],
    "data": ["--task", "cifar10", "--data-dir", "/data/c10",
             "--data-backend", "native", "--aug-spec", "paper",
             "--valid-fraction", "0.25", "--workers-per-replica", "6",
             "--num-synth-samples", "100", "--download", "0"],
    "accum": ["--task", "synth", "--num-synth-samples", "8192", "--arch",
              "resnet50", "--image-size-override", "224", "--batch-size",
              "4096", "--accum-steps", "16", "--accum-bn-mode", "average",
              "--augment-placement", "step", "--fused-augment", "on",
              "--fused-update", "on", "--polyak-ema", "0.99", "--epochs",
              "1", "--weight-initialization", "orthogonal",
              "--ema-scaling-reference-batch", "256"],
    "lifecycle": ["--uid", "exp1", "--arch", "resnet18", "--batch-size",
                  "8", "--early-stop", "--fault-at-step", "5",
                  "--no-save-on-signal", "--no-half", "--seed", "7", "--lr",
                  "0.05", "--warmup", "1", "--debug-step"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_run_name_matches_jax(case):
    """The same flags name the same run in both packages (the JAX CLI on
    one device: its --num-replicas 0 resolves to 1 there)."""
    argv = ARGVS[case]
    ours = config_from_args(build_parser().parse_args(argv))
    theirs = jax_config_from_args(
        jax_parser().parse_args(argv + ["--num-replicas", "1"]))
    assert ours.to_dict() == theirs.to_dict()
    assert ours.to_json() == theirs.to_json()
    assert torch_config.run_name(ours) == jax_config.run_name(theirs)


def test_config_json_is_strict_and_sanitize_matches_jax():
    bad = torch_config.Config(optim=torch_config.OptimConfig(lr=NAN))
    with pytest.raises(ValueError):
        bad.to_json()
    payload = {"a": [1.0, NAN, INF, -INF], "b": (np.float32(2.5),),
               "c": np.array([NAN, 1.0]), "d": "NaN", "e": 3}
    assert sanitize(payload) == jax_sanitize(payload)
    assert json.dumps(sanitize(payload), allow_nan=False)


# --------------------------------------------------------------------------
# the optimizer registry's state in the canonical tree
# --------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """One torch thread for the test, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_optimizer_state_resumes_exactly(optimizer, tmp_path, one_thread):
    """Two steps, the canonical tree through the store, a fresh state and
    the third step: bit for bit the state of three uninterrupted steps,
    the optimizer's buffers (lbfgs's memories as (10, *shape) per name)
    and counts included."""
    from tests.test_torch_accum import _batches
    from tests.test_torch_ddp_step import assert_trees_equal
    from tests.torch_ranks import seeded_tree, train
    spec = dict(canonical=seeded_tree(optimizer), optimizer=optimizer,
                base_lr=0.01, batches=_batches("views", 3, 5, 8),
                scfg=dict(normalize_inputs=True, norm_mode="reference"))
    whole = train(spec)["state"]
    first = train(dict(spec, batches=spec["batches"][:2]))["state"]
    store = torch_ckpt.CheckpointStore(str(tmp_path / optimizer))
    store.save(0, first)
    restored, _ = store.restore()
    store.close()
    assert restored["optimizer"] == optimizer
    assert restored["opt_counts"] == ({"count": 2})
    resumed = train(dict(spec, canonical=restored,
                         batches=spec["batches"][2:]))["state"]
    assert_trees_equal(resumed, whole)
    assert (resumed["step"], resumed["count"]) == (3, 3)
    if optimizer == "lbfgs":
        memory = whole["diff_params_memory"]["backbone.stem_conv.weight"]
        assert memory.shape == (10,) + tuple(
            whole["params"]["backbone.stem_conv.weight"].shape)
        assert memory[:2].abs().sum() > 0 and not memory[2:].any()
        assert whole["weights_memory"].shape == (10,)


def test_format1_lars_momentum_tree_loads_and_another_optimizer_refuses():
    """A tree as PRs 5-10 wrote it (format 1, no ``optimizer`` or
    ``opt_counts``: lars_momentum's momentum) still loads bit for bit;
    a tree of one optimizer is refused by a state of another, naming
    both."""
    from tests.torch_ranks import seeded_tree
    src = _torch_state(0)
    gen = torch.Generator().manual_seed(4)
    for leaf in src.leaves(src.momentum):     # the padding stays 0
        leaf.normal_(generator=gen)
    legacy = canonical_state(src)
    del legacy["optimizer"], legacy["opt_counts"]
    assert legacy["format"] == 1 and "momentum" in legacy
    dst = _torch_state(1)
    load_canonical(dst, legacy)
    _assert_bitwise(src, dst)
    adam = _torch_state(2)
    adam_state = create_train_state(adam.net, optimizer="adam")
    with pytest.raises(ValueError, match="'lars_momentum'.*'adam'"):
        load_canonical(adam_state, legacy)
    with pytest.raises(ValueError, match="'adam'.*'lbfgs'"):
        from tests.torch_ranks import seeded_net
        load_canonical(create_train_state(seeded_net(), optimizer="lbfgs"),
                       seeded_tree("adam"))
