"""The port's tensor-parallel heads (``--model-parallel``), held against the
JAX package's rules and step and against the port's own one-rank step.

Ranks are OS processes over gloo (tests/torch_ranks.py): one world of 2
(model 2) and one of 4 (data 2 x model 2, then sequence 2 x model 2),
each running its parts in one spawn, once per test session.

- The rules: the port's split dim of every leaf of the tiny BYOL trees
  (ResNet and ViT, params and statistics) is JAX's ``leaf_pspec`` on the
  matching flax path, read through the (out, in) layout of ``Dense``.
- Model 2 against JAX: three fp32 steps of the tiny ResNet from one JAX
  ``TrainState`` (``train_state_from_flax``, 32 rows a batch, the
  reference loss, the unfused lars_momentum chain) against JAX's
  one-device ``make_train_step``: metrics and state at 1e-4, the model
  ranks bit for bit equal.
- Model 2 against model 1, float64, three steps from one seeded state
  (the target a copy of the params: under the reference init the
  target's projections are 0.004 of the online ones', and the rounding
  noise of the zero-gradient head biases moves the loss), for
  lars_momentum, lamb, lbfgs and lars_lbfgs at clip 0.01: every state
  leaf at rtol 1e-9, atol 1e-11, the metrics and the health vector at
  rtol 1e-9.  The atol covers the three Dense biases that feed a
  BatchNorm, whose gradient is 0 in exact arithmetic (rounding noise,
  which adam's division scales up): measured, lamb's worst such bias
  past rtol by 4.6e-12, every other leaf of every chain within 3e-15.
  Summing the replicated leaves' partials on both model ranks moves the
  health vector's norms and lbfgs's dots, so such a reduce fails here.
- More worlds: data 2 x model 2 against one rank; the tiny ViT at
  sequence 2 x model 2 with ring attention against one rank's dense
  step (float64, rtol 1e-9, atol 1e-13 as the ring test holds it).
- Checkpoints: a model-2 checkpoint holds the whole leaves, restores at
  model 1 and at model 2 to the tree saved, and each rank's shards at
  step 0 are the slices of the whole tree; ``from_flax`` with ``shard``
  gives those slices; ``load_canonical`` and ``load_converted`` take
  whole trees only and refuse a tree already cut to a shard's shapes.
- The FLOP count: the heads' share (``flops.counting().split``) is
  what a model rank runs 1/M of, so the count of a rank at model 2 plus
  one more shard's heads is the count at model 1.
- The CLI: ``--no-cuda --model-parallel 2`` trains over two gloo ranks,
  its run header's mesh carries ``model: 2``, and its step against the
  one-rank CLI run (fp32, 1e-4).
- Refusals with JAX's texts: ``--zero1``, ``--fused-update``,
  ``--flat-resident`` and ``--fused-augment on`` with model 2, a world
  that model x sequence does not divide, and a hidden size the model axis
  does not divide.
- The loader's rows and the step's draws are shared within a model group
  and split across the data axis.
"""
import ast
import dataclasses
import inspect
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu_torch.convert import from_flax, train_state_from_flax
from byol_tpu_torch.models.byol_net import shard_heads
from byol_tpu_torch.parallel import partitioning
from byol_tpu_torch.training.state import canonical_state, create_train_state
from tests.test_torch_accum import _batches
from tests.test_torch_ddp_step import (assert_tree_matches,
                                       assert_trees_equal, tree_keys)
from tests.test_torch_train_step import METRICS, TOL, _as_numpy, _jax_side
from tests.torch_ranks import one_torch_thread  # noqa: F401
from tests.torch_ranks import (run_ranks_once, seeded_net, tiny_net,
                               tiny_vit_net)
from tests.torch_ranks import train as train_job

STEPS = 3
SCFG = dict(normalize_inputs=True, norm_mode="reference", fused_update=False)
F64 = dict(SCFG, telemetry="step")
# (optimizer, clip, base lr): the float64 chains against model 1
CHAINS = [("lars_momentum", 0.0, 2.0), ("lamb", 0.0, 0.01),
          ("lbfgs", 0.0, 2.0), ("lars_lbfgs", 0.01, 0.01)]
F64_TOL = dict(rtol=1e-9, atol=1e-11)
VIT = dict(pooling="gap", attn_impl="ring")


def _copy_tree(optimizer, dtype=torch.float64):
    """The canonical tree of the seeded tiny net with the target a copy of
    the params."""
    return canonical_state(create_train_state(
        seeded_net(dtype), ema_init_mode="copy", optimizer=optimizer))


def _f64_spec(optimizer, clip, base_lr, **extra):
    return dict(dict(canonical=_copy_tree(optimizer), scfg=F64,
                     dtype=torch.float64, optimizer=optimizer, clip=clip,
                     base_lr=base_lr,
                     batches=_batches("views", STEPS, 21, 8), model=2),
                **extra)


def _cli_argv(root, model):
    return ["--no-cuda", "--task", "fake", "--arch", "resnet18",
            "--image-size-override", "16", "--batch-size", "8",
            "--epochs", "1", "--debug-step", "--no-half", "--warmup", "0",
            "--head-latent-size", "32", "--projection-size", "16",
            "--workers-per-replica", "0", "--grapher", "jsonl",
            "--loss-norm-mode", "reference",
            "--model-parallel", str(model),
            "--model-dir", os.path.join(root, f"m{model}"),
            "--log-dir", os.path.join(root, f"l{model}")]


def _jax_arm():
    """JAX's one-device fp32 run, its converted start and the batches."""
    _, jstate, jstep, _ = _jax_side(False, SCFG, "reference")
    converted = train_state_from_flax(_as_numpy(jstate),
                                      like=tiny_net().state_dict())
    batches = _batches("views", STEPS, 21, 32)
    return jstate, jstep, converted, batches


@pytest.fixture(scope="module")
def jax_arm():
    return _jax_arm()


def _shared_dir(tmp_path_factory, name):
    """A directory the ranks write to that every test worker reads: the
    ranks run once a session (``run_ranks_once``), in one worker."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return tmp_path_factory.mktemp(name)
    root = tmp_path_factory.getbasetemp().parent / name
    root.mkdir(exist_ok=True)
    return root


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_arm):
    root = _shared_dir(tmp_path_factory, "tp2_files")
    _, _, converted, batches = jax_arm
    parts = [("train", dict(converted=converted, scfg=SCFG, batches=batches,
                            model=2))]
    ckpt = str(root / "ckpt")
    # the first chain's rank 0 checkpoints its state
    parts += [("train", _f64_spec(*chain, **({"save_to": ckpt} if i == 0
                                             else {})))
              for i, chain in enumerate(CHAINS)]
    parts.append(("restore", dict(load_from=ckpt, dtype=torch.float64,
                                  model=2)))
    parts.append(("fit_cli", dict(argv=_cli_argv(str(root), 2), model=2)))
    parts.append(("mesh_error", dict(layout=(1, 3))))
    spec = {"model": 2, "parts": parts}
    return {"root": root, "ckpt": ckpt,
            "results": run_ranks_once("tp2", "multi", spec, 2,
                                      tmp_path_factory, timeout=240.0)}


def _vit_tree():
    from byol_tpu_torch.models.layers import init_params
    net = tiny_vit_net(torch.float64, pooling="gap")
    init_params(net, torch.Generator().manual_seed(0))
    return canonical_state(create_train_state(net.double(),
                                              ema_init_mode="reference"))


def _vit_views(n=2, rows=8, seed=3):
    rng = np.random.RandomState(seed)
    return [{"view1": rng.rand(rows, 32, 32, 3),
             "view2": rng.rand(rows, 32, 32, 3),
             "label": rng.randint(0, 10, rows).astype(np.int64)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.RandomState(11)
    raw = [{"images": rng.randint(0, 256, (8, 40, 40, 3)).astype(np.uint8),
            "label": rng.randint(0, 10, 8).astype(np.int64)}]
    argv = ["--no-cuda", "--task", "fake", "--arch", "resnet18",
            "--image-size-override", "32", "--batch-size", "8",
            "--model-parallel", "2", "--workers-per-replica", "0"]
    aug = dict(SCFG, augment_in_step=True, image_size=32, aug_seed=13)
    vit_spec = dict(canonical=_vit_tree(), batches=_vit_views(),
                    scfg=dict(norm_mode="reference", fused_update=False),
                    dtype=torch.float64, vit=VIT, sequence=2, model=2)
    spec = {"model": 2, "parts": [
        ("train", _f64_spec(*CHAINS[0])),
        ("train", vit_spec),
        ("step_inputs", dict(canonical=_copy_tree("lars_momentum"),
                             batches=raw, scfg=aug, dtype=torch.float64,
                             model=2, argv=argv))]}
    return {"vit_spec": vit_spec,
            "results": run_ranks_once("tp4", "multi", spec, 4,
                                      tmp_path_factory, timeout=240.0)}


# -- the rules -------------------------------------------------------------

def _flax_to_torch(names):
    """A flax path (collection first) -> the port's leaf name, as
    ``convert.from_flax`` names it."""
    collection, *mods, leaf = names
    rename = ({"mean": "running_mean", "var": "running_var"}
              if collection == "batch_stats" else
              {"kernel": "weight", "scale": "weight"})
    return ".".join(mods + [rename.get(leaf, leaf)])


def _want_dim(spec, ndim, leaf):
    """JAX's PartitionSpec -> the split dim in the port's layout."""
    axes = list(spec) + [None] * (ndim - len(spec))
    if "model" not in axes:
        return None
    k = axes.index("model")
    return 1 - k if (leaf == "kernel" and ndim == 2) else k


@pytest.mark.parametrize("family", ["resnet", "vit"])
def test_split_dims_are_jax_leaf_pspec(family):
    from byol_tpu.parallel.partitioning import _path_names, leaf_pspec
    from tests.test_torch_train_step import _jax_net as jax_resnet_net
    from tests.test_torch_vit_train import _jax_net as jax_vit_net
    from byol_tpu_torch.models.layers import init_params
    if family == "resnet":
        jnet, net, size = jax_resnet_net(jnp.float32), tiny_net(), 32
    else:
        jnet, net, size = jax_vit_net("cls"), tiny_vit_net(), 32
    init_params(net, torch.Generator().manual_seed(0))
    variables = jnet.init({"params": jax.random.PRNGKey(0)},
                          jnp.zeros((2, size, size, 3)), train=True,
                          method="warmup")
    own = net.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(dict(variables))[0]
    split = set()
    for path, leaf in leaves:
        names = _path_names(path)
        name = _flax_to_torch(names)
        assert name in own, name
        got = partitioning.tp_dim(name, own[name].ndim)
        assert got == _want_dim(leaf_pspec(path, leaf), leaf.ndim,
                                names[-1]), name
        if got is not None:
            split.add(name)
    assert len(leaves) == len(own)
    # the heads' dense1 weight and bias, bn's four, dense2's weight, twice
    assert len(split) == 2 * 7
    sharded = shard_heads(net, 2, 1).state_dict()
    for name, value in own.items():
        dim = partitioning.tp_dim(name, value.ndim)
        want = (value if dim is None else
                value.narrow(dim, value.shape[dim] // 2,
                             value.shape[dim] // 2))
        assert torch.equal(sharded[name], want), name


def test_from_flax_with_shard_gives_the_slices():
    from tests.test_torch_train_step import _jax_net as jax_resnet_net
    variables = jax.device_get(jax_resnet_net(jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 32, 32, 3)),
        train=True, method="warmup"))
    whole = from_flax(variables["params"], variables["batch_stats"])
    for index in range(2):
        like = shard_heads(tiny_net(), 2, index).state_dict()
        got = from_flax(variables["params"], variables["batch_stats"],
                        like=like, shard=(2, index))
        for name, value in whole.items():
            dim = partitioning.tp_dim(name, value.ndim)
            want = (value if dim is None else partitioning.shard_leaf(
                value, dim, 2, index))
            assert torch.equal(got[name], want), name


# -- model 2 against JAX ----------------------------------------------------

def test_model_2_matches_jax_one_device(world2, jax_arm):
    jstate, jstep, _, batches = jax_arm
    ranks = [r[0] for r in world2["results"]]
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {key: jnp.asarray(v)
                                    for key, v in batch.items()})
        for key in METRICS:
            np.testing.assert_allclose(ranks[0]["metrics"][i][key],
                                       float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
    assert_tree_matches(ranks[0]["state"], train_state_from_flax(
        _as_numpy(jstate)), **TOL)
    assert_trees_equal(ranks[0]["state"], ranks[1]["state"])
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


# -- model 2 against model 1 ------------------------------------------------

def _assert_close_trees(got, want, err, **tol):
    assert set(tree_keys(got)) == set(tree_keys(want))
    for key in tree_keys(want):
        if torch.is_tensor(want[key]):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       err_msg=f"{err} {key}", **tol)
            continue
        for name, value in want[key].items():
            assert got[key][name].shape == value.shape, (key, name)
            np.testing.assert_allclose(got[key][name].numpy(),
                                       value.numpy(),
                                       err_msg=f"{err} {key} {name}", **tol)
    for field in ("count", "step", "ema_step", "opt_counts", "optimizer"):
        assert got[field] == want[field], field


@pytest.mark.parametrize("chain", CHAINS, ids=[c[0] for c in CHAINS])
def test_model_2_equals_model_1_float64(world2, chain):
    want = train_job(_f64_spec(*chain, model=1))
    index = 1 + CHAINS.index(chain)
    for r in range(2):
        got = world2["results"][r][index]
        _assert_close_trees(got["state"], want["state"], f"rank {r}",
                            **F64_TOL)
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert np.isfinite(w["health"]).all()
            np.testing.assert_allclose(g["health"], w["health"], rtol=1e-9,
                                       err_msg=f"rank {r} step {i}")
            for key in METRICS:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-9,
                                           err_msg=f"rank {r} step {i}")
    assert_trees_equal(world2["results"][0][index]["state"],
                       world2["results"][1][index]["state"])


def test_data_2_by_model_2_equals_one_rank_float64(world4):
    want = train_job(_f64_spec(*CHAINS[0], model=1))
    for r in range(4):
        got = world4["results"][r][0]
        _assert_close_trees(got["state"], want["state"], f"rank {r}",
                            **F64_TOL)
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["health"], w["health"], rtol=1e-9)


def test_vit_sequence_2_by_model_2_ring_equals_one_rank_dense(world4):
    spec = dict(world4["vit_spec"], vit=dict(pooling="gap",
                                             attn_impl="dense"),
                sequence=1, model=1)
    want = train_job(spec)
    for r in range(4):
        got = world4["results"][r][1]
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for key in ("loss_mean", "byol_loss_mean", "linear_loss_mean"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-9,
                                           err_msg=f"rank {r} step {i}")
        for key in ("params", "target", "momentum"):
            for name, value in want["state"][key].items():
                np.testing.assert_allclose(
                    got["state"][key][name].numpy(), value.numpy(),
                    rtol=1e-9, atol=1e-13, err_msg=f"rank {r} {key} {name}")


# -- checkpoints ------------------------------------------------------------

def test_model_2_checkpoint_restores_at_model_1_and_2(world2):
    from byol_tpu_torch.checkpoint.checkpointer import CheckpointStore
    from tests.torch_ranks import tiny_state
    results = world2["results"]
    saved_run = results[0][1]
    store = CheckpointStore(world2["ckpt"])
    tree, _ = store.restore()
    store.close()
    # the checkpoint holds the whole leaves, as the gathered tree
    assert_trees_equal(tree, saved_run["state"])
    want = train_job(_f64_spec(*CHAINS[0], model=1))
    _assert_close_trees(tree, want["state"], "saved", **F64_TOL)
    # at model 1 (no process group here) and at model 2 (the ranks)
    state, plan = tiny_state(canonical=tree, dtype=torch.float64)
    assert state.model_axis == (1, 0)
    assert_trees_equal(plan.to_canonical(state), tree)
    for r in range(2):
        restored = results[r][5]
        assert_trees_equal(restored["state"], tree)
        for name, shard in restored["local"].items():
            dim = partitioning.tp_dim(name, shard.ndim)
            assert torch.equal(shard, partitioning.shard_leaf(
                tree["params"][name], dim, 2, r)), name


def test_each_rank_starts_from_the_slices_of_the_whole_tree(world2):
    tree = _copy_tree("lars_momentum")
    for r in range(2):
        local = world2["results"][r][1]["local0"]
        assert len(local) == 10          # the params among the 14 leaves
        for name, shard in local.items():
            dim = partitioning.tp_dim(name, shard.ndim)
            assert torch.equal(shard, partitioning.shard_leaf(
                tree["params"][name], dim, 2, r)), name


def _sliced(tree, dims):
    """``tree``'s split leaves cut to model index 0's shard of 2."""
    return {name: (value if name not in dims else
                   partitioning.shard_leaf(value, dims[name], 2, 0))
            for name, value in tree.items()}


@pytest.mark.parametrize("loader", ["canonical", "converted"])
def test_loads_take_whole_trees_only(loader, request):
    """A state at model 2 keeps its slices of a whole tree, and refuses a
    tree whose split leaves are already the shard's shapes (a whole tree
    of a head half as wide has them too)."""
    from byol_tpu_torch.training.state import load_canonical, load_converted
    if loader == "canonical":
        dtype, whole = torch.float64, _copy_tree("lars_momentum")
        load, trees = load_canonical, ("params", "target", "momentum",
                                       "batch_stats")
    else:
        dtype, whole = torch.float32, request.getfixturevalue("jax_arm")[2]
        load, trees = load_converted, ("params", "target", "momentum",
                                       "buffers")
    net = tiny_net(dtype)
    state = create_train_state(shard_heads(
        net.double() if dtype == torch.float64 else net, 2, 0))
    dims = state.split_dims()
    load(state, whole)
    local = {**state.tree(state.params), **state.batch_stats()}
    for name, dim in dims.items():
        src = whole["params"].get(name, whole[trees[-1]].get(name))
        assert torch.equal(local[name].cpu(), partitioning.shard_leaf(
            torch.as_tensor(src), dim, 2, 0)), name
    cut = dict(whole, **{key: _sliced(whole[key], dims) for key in trees})
    with pytest.raises(ValueError, match="has shape"):
        load(create_train_state(shard_heads(
            tiny_net(dtype).to(dtype), 2, 0)), cut)


def test_flop_count_splits_the_heads():
    from byol_tpu_torch.observability import flops
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 16, 16, 3)
                         ).float()
    counts = []
    for size in (1, 2):
        # no process group: the split heads' collectives are identities
        net = shard_heads(seeded_net(), size, 0)
        with flops.counting() as counted:
            out = net(x)
            (out["prediction"].sum() + out["projection"].sum()).backward()
        counts.append(counted)
    one, two = counts
    assert one.split > 0 and one.total > one.split
    assert two.split == one.split / 2
    # the trainer's model FLOPs at M = 2: the rank's count plus (M - 1)
    # more shards of the heads
    assert two.total + (2 - 1) * two.split == one.total


# -- the CLI -----------------------------------------------------------------

def test_cli_trains_over_two_model_ranks(world2, tmp_path):
    from tests.torch_ranks import fit_cli
    got = [world2["results"][r][6] for r in range(2)]
    want = fit_cli({"argv": _cli_argv(str(tmp_path), 1)})
    assert len(got[0]["losses"]) == len(want["losses"]) == 1
    assert_trees_equal(got[0]["state"], got[1]["state"])
    np.testing.assert_allclose(got[0]["losses"], want["losses"], **TOL)
    _assert_close_trees(got[0]["state"], want["state"], "cli", **TOL)
    run_log = [os.path.join(dp, f) for dp, _, fs in
               os.walk(world2["root"] / "l2") for f in fs
               if f == "run.jsonl"]
    assert len(run_log) == 1
    with open(run_log[0]) as f:
        header = json.loads(f.readline())
    assert header["mesh_shape"] == {"data": 1, "sequence": 1, "model": 2}
    assert header["sharding_plan"]["mesh_shape"]["model"] == 2



# -- refusals ---------------------------------------------------------------

def _jax_literal(fragment):
    """The message of the ``raise ValueError`` in JAX's ``resolve`` whose
    text holds ``fragment`` (a branch JAX itself cannot reach)."""
    from byol_tpu.core import config as jax_config
    tree = ast.parse(inspect.getsource(jax_config.resolve).lstrip())
    for node in ast.walk(tree):
        if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call):
            arg = node.exc.args[0] if node.exc.args else None
            if isinstance(arg, ast.Constant) and fragment in arg.value:
                return arg.value
    raise AssertionError(f"no raise with {fragment!r} in JAX's resolve")


REFUSED = {
    "zero1": dict(device=dict(zero1="on")),
    "fused_update": dict(optim=dict(fused_update="on")),
    "fused_augment": dict(task=dict(augment_placement="step",
                                    fused_augment="on")),
}


def _config(mod, overrides):
    cfg = mod.Config()
    overrides = dict(overrides)
    overrides["device"] = dict(overrides.get("device", {}),
                               model_parallel=2)
    for section, values in overrides.items():
        cfg = cfg.replace(**{section: dataclasses.replace(
            getattr(cfg, section), **values)})
    return cfg


RESOLVE_224 = dict(num_train_samples=8192, num_test_samples=10,
                   output_size=10, input_shape=(224, 224, 3))


@pytest.mark.parametrize("what", sorted(REFUSED) + ["flat_resident"])
def test_model_parallel_refusals_have_jax_text(what):
    from byol_tpu.core import config as jax_config
    from byol_tpu_torch.core import config as torch_config
    if what == "flat_resident":
        # JAX refuses --flat-resident on without --fused-update on first,
        # and the fused update with model > 1 before this text; the port
        # takes the resident layout with any chain and refuses it here
        overrides = dict(device=dict(flat_resident="on"))
        want = _jax_literal("--flat-resident on lays")
    else:
        overrides = REFUSED[what]
        with pytest.raises(ValueError) as jax_err:
            jax_config.resolve(_config(jax_config, overrides), **RESOLVE_224)
        want = str(jax_err.value)
    with pytest.raises(ValueError) as got:
        torch_config.resolve(_config(torch_config, overrides), **RESOLVE_224)
    assert str(got.value) == want
    assert "model" in want


def test_a_world_model_x_sequence_does_not_divide_is_refused(world2):
    from byol_tpu.core.config import Config, DeviceConfig
    from byol_tpu.training.trainer import fit as jax_fit
    with pytest.raises(ValueError) as want:
        jax_fit(Config(device=DeviceConfig(model_parallel=3)))
    pattern = (r"model_parallel x sequence_parallel = (\d+) does not divide "
               r"the (\d+) available devices")
    assert re.fullmatch(pattern, str(want.value))
    for r in range(2):
        got = world2["results"][r][7]
        assert re.fullmatch(pattern, got).groups() == ("3", "2"), got


def test_a_hidden_size_the_model_axis_does_not_divide_is_refused():
    """JAX's ``device_put`` refuses the head leaf of 33 rows over a model
    axis of 2 with "... which implies that the global size of its
    dimension 0 should be divisible by 2, but it is equal to 33 (full
    shape: (33,))" (the predictor's BatchNorm bias, the first split leaf
    in the tree's order); the port refuses the same leaf in the same
    words."""
    from byol_tpu_torch.models.byol_net import BYOLNet
    from byol_tpu_torch.models.resnet import Bottleneck, ResNet
    net = BYOLNet(ResNet(stage_sizes=[1, 1], block_cls=Bottleneck, width=8,
                         small_inputs=True, zero_init_residual=False),
                  num_classes=10, head_latent_size=33, projection_size=16)
    with pytest.raises(ValueError) as got:
        shard_heads(net, 2, 0)
    assert str(got.value).endswith(
        "which implies that the global size of its dimension 0 should be "
        "divisible by 2, but it is equal to 33 (full shape: (33,))")
    assert "predictor.bn.bias" in str(got.value)


# -- the loader --------------------------------------------------------------

def test_loader_rows_and_draws_are_shared_within_a_model_group(world4):
    got = [r[2] for r in world4["results"]]
    # rank = 2 d + m: ranks 2 d and 2 d + 1 form model group d
    for d in range(2):
        a, b = got[2 * d], got[2 * d + 1]
        assert set(a["loader"]) == {"view1", "view2", "label"}
        for key in a["loader"]:
            assert np.array_equal(a["loader"][key], b["loader"][key])
        for x, y in zip(a["images"], b["images"]):
            assert np.array_equal(x, y)
        assert len(a["draws"]) == 1
        for sa, sb in zip(a["draws"], b["draws"]):
            for va, vb in zip(sa, sb):
                for fa, fb in zip(va, vb):
                    assert torch.equal(fa, fb)
    assert not np.array_equal(got[0]["loader"]["view1"],
                              got[2]["loader"]["view1"])
    assert not torch.equal(got[0]["draws"][0][0][0], got[2]["draws"][0][0][0])
