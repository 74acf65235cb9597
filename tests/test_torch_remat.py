"""The port's rematerialization policies (byol_tpu_torch/core/remat.py)
held against the JAX package's names, errors and step.

- Every name and its resolution against JAX's ``validate_policy`` and
  ``resolve_policy_name``, errors included.
- Each policy changes nothing: one step of the tiny ResNet (whose blocks
  hold BatchNorms) and one of the tiny ViT give params, momentum, target
  and BatchNorm running statistics BITWISE equal to ``none``'s (bitwise
  momentum after one step from one state is bitwise gradients).  This is
  the double-update trap: a recompute that ticked the statistics again
  would move them.  At two gloo ranks, with the BatchNorms synced over the
  data axis, ``full`` and ``dots`` equal ``none`` bitwise too, as does
  ``full`` under ``--accum-steps 2`` in ``average`` mode.
- A names-based policy over a block without a ``block_out`` tag raises
  :class:`RematTagError` with JAX's text.
- One ViT step under ``dots`` matches JAX's step under ``dots`` at 1e-4
  (JAX's remat is numerically inert too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from byol_tpu.core import remat as jax_remat
from byol_tpu_torch.core import remat
from tests.torch_ranks import one_torch_thread  # noqa: F401
from tests.torch_ranks import run_ranks, seeded_tree, tiny_vit_net
from tests.torch_ranks import train as train_job

SCFG = dict(norm_mode="reference", normalize_inputs=True, fused_update=True)


def _batches(n=1, rows=8, seed=2):
    rng = np.random.RandomState(seed)
    return [{"view1": rng.rand(rows, 32, 32, 3).astype(np.float32),
             "view2": rng.rand(rows, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, 10, rows).astype(np.int64)}
            for _ in range(n)]


def _vit_tree():
    from byol_tpu_torch.models.layers import init_params
    from byol_tpu_torch.training.state import (canonical_state,
                                               create_train_state)
    net = tiny_vit_net(pooling="cls")
    init_params(net, torch.Generator().manual_seed(0))
    return canonical_state(create_train_state(net, ema_init_mode="reference"))


def _assert_bitwise(got, want, err):
    for key in ("params", "target", "momentum", "batch_stats"):
        for name, w in want[key].items():
            assert torch.equal(got[key][name], w), f"{err} {key} {name}"


@pytest.mark.parametrize("name", remat.POLICY_NAMES + ("dot", ""))
def test_names_and_resolution_match_jax(name):
    assert remat.POLICY_NAMES == jax_remat.POLICY_NAMES
    assert remat.NAMES_BASED_POLICIES == jax_remat.NAMES_BASED_POLICIES
    if name not in jax_remat.POLICY_NAMES:
        with pytest.raises(ValueError) as want:
            jax_remat.validate_policy(name)
        with pytest.raises(ValueError) as got:
            remat.validate_policy(name)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError) as got:
            remat.resolve_policy_name(True, name)
        assert str(got.value) == str(want.value)
        return
    assert remat.validate_policy(name) == jax_remat.validate_policy(name)
    for flag in (False, True):
        assert remat.resolve_policy_name(flag, name) == \
            jax_remat.resolve_policy_name(flag, name)


@pytest.fixture(scope="module")
def trees():
    return {"resnet": seeded_tree(), "vit": _vit_tree()}


@pytest.fixture(scope="module")
def none_states(trees):
    # a module fixture runs before the autouse one-thread fixture: the
    # baseline must see the tests' thread count (the summation order)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {arch: train_job(_spec(arch, trees, "none"))["state"]
                for arch in trees}
    finally:
        torch.set_num_threads(threads)


def _spec(arch, trees, policy, **extra):
    return dict(dict(canonical=trees[arch], batches=_batches(), scfg=SCFG,
                     remat_policy=policy,
                     vit=dict(pooling="cls") if arch == "vit" else None),
                **extra)


@pytest.mark.parametrize("arch", ["resnet", "vit"])
@pytest.mark.parametrize("policy", remat.POLICY_NAMES[1:])
def test_policy_step_is_bitwise_none(arch, policy, trees, none_states):
    got = train_job(_spec(arch, trees, policy))["state"]
    _assert_bitwise(got, none_states[arch], policy)


def test_full_with_accumulation_average_is_bitwise_none(trees):
    accum = dict(SCFG, accum_steps=2, accum_bn_mode="average")
    want = train_job(_spec("resnet", trees, "none", scfg=accum))["state"]
    got = train_job(_spec("resnet", trees, "full", scfg=accum))["state"]
    _assert_bitwise(got, want, "full, accum 2 average")


def test_synced_batchnorm_at_two_ranks_moves_once(trees, tmp_path):
    """The trap under ``sync``: the recompute all-reduces the statistics
    again for the gradient, and must not tick the running ones."""
    parts = [("train", dict(_spec("resnet", trees, p), batches=_batches(2)))
             for p in ("none", "full", "dots")]
    results = run_ranks("multi", {"parts": parts}, 2, tmp_path)
    for r, (none, full, dots) in enumerate(results):
        _assert_bitwise(full["state"], none["state"], f"rank {r} full")
        _assert_bitwise(dots["state"], none["state"], f"rank {r} dots")
    # the statistics are the global batch's: equal on both ranks
    for name, w in results[0][0]["state"]["batch_stats"].items():
        assert torch.equal(results[1][0]["state"]["batch_stats"][name], w)


class _Untagged(nn.Module):
    """A backbone whose block output carries no block_out tag."""

    def __init__(self, policy):
        super().__init__()
        self.block = nn.Linear(4, 4)
        self.remat_policy = policy

    def forward(self, x):
        return remat.wrap_block(self.block, self.remat_policy)(x)


@pytest.mark.parametrize("policy", remat.NAMES_BASED_POLICIES)
def test_names_based_policy_without_a_tag_raises_jax_error(policy):
    with pytest.raises(jax_remat.RematTagError) as want:
        jax_remat.assert_tags_in_trace(lambda x: x * 2, jnp.ones(2),
                                       policy_name=policy)
    with pytest.raises(remat.RematTagError) as got:
        remat.assert_tags_in_forward(_Untagged(policy), torch.ones(2, 4),
                                     policy_name=policy)
    assert str(got.value) == str(want.value)
    assert remat.assert_tags_in_forward(_Untagged("dots"), torch.ones(2, 4),
                                        policy_name="dots") == 0
    # the real backbones carry one tag per block
    net = tiny_vit_net(remat_policy=policy)
    assert remat.assert_tags_in_forward(
        net.backbone, torch.zeros(2, 32, 32, 3), policy_name=policy) == 2


def test_dots_step_matches_jax_dots_step():
    """One ViT step under ``dots`` in both packages (the tiny ViT's blocks
    hold no BatchNorm, so no ill-conditioned BatchNorm-parameter gradient
    stands between the two frameworks' fp32 roundings)."""
    from tests.test_torch_vit_train import run_case
    run_case("gap", True, "loader", remat_policy="dots", steps=1)
