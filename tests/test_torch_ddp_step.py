"""Data-parallel training in the port, held against the JAX package.

Two ranks (OS processes over gloo, tests/torch_ranks.py) each run the
port's train step on their half of every global batch; the oracle is the
JAX package's ONE-device step on the whole global batch (the helpers of
tests/test_torch_train_step.py), which is what its GSPMD step computes on
a mesh: every mean over the batch is a global mean.  (The JAX arms through
``shard_map`` fail under this JAX version, ROADMAP.md section 3.5.)  Three
steps from one JAX ``TrainState`` must give rank 0 JAX's per-step metrics
and its params, momentum, target, BatchNorm statistics and counters, fp32
at 1e-4, and rank 1 rank 0's state bit for bit.  A global microbatch is 32
rows (16 a rank): on fewer, the BatchNorm-parameter gradients of the tiny
net drift past 1e-4 from JAX's by rounding alone
(tests/test_torch_accum.py).  The five arms cover loader and step
placement (K2's plain version on JAX's draws for the global microbatch),
``accum_steps`` 1 and 2 in all three BatchNorm modes, the fused update
(K1a/K1b's plain versions) and the unfused chain, and both loss norms.

The ``paper`` arm holds its per-step metrics to JAX's at 1e-4 and its
ranks to each other bit for bit, not its state: under the per-row paper
loss the tiny net's state is ill-conditioned in fp32.  Scaling one view by
1 + 1e-7 (one ulp) moves the momentum after ONE step by 2.2e-5 under
``paper`` against 2.6e-6 under ``reference``, so the rounding of any other
summation order (JAX's, or the port's own one-device step against its
two-rank one) moves BatchNorm-parameter momenta by 1.6e-4 after one step
and by ~1e-2 after three.  The reference arms hold the state, and the
paper loss has no cross-rank term of its own: its rows' mean is the one
thing data parallelism touches, which the metrics hold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu_torch.convert import train_state_from_flax
from tests.test_torch_accum import _batches
from tests.test_torch_augment import jax_step_views
from tests.test_torch_train_step import (METRICS, SIZE, TOL, _as_numpy,
                                         _jax_side)
from tests.torch_ranks import run_ranks, tiny_net
from tests.torch_ranks import one_torch_thread  # noqa: F401

MICRO, RAW, AUG_SEED, WORLD, STEPS = 32, 40, 13, 2, 3
BASE = dict(normalize_inputs=True)

# name -> (step config, batch kind)
ARMS = {
    "loader-k1-fused-paper": (dict(norm_mode="paper", fused_update=True),
                              "views"),
    "loader-k2-average-unfused-reference": (
        dict(norm_mode="reference", accum_steps=2, accum_bn_mode="average",
             fused_update=False), "views"),
    "step-k2plain-k1-fused": (
        dict(norm_mode="reference", fused_update=True, fused_augment=True),
        "images"),
    "step-k2plain-k2-microbatch-fused": (
        dict(norm_mode="reference", accum_steps=2,
             accum_bn_mode="microbatch", fused_update=True,
             fused_augment=True), "images"),
    "loader-k2-global-unfused": (
        dict(norm_mode="reference", accum_steps=2, accum_bn_mode="global",
             fused_update=False), "views"),
}


def assert_tree_matches(got, want, **tol):
    """A canonical tree against ``train_state_from_flax``'s."""
    for key in ("params", "momentum", "target"):
        for name, value in got[key].items():
            np.testing.assert_allclose(value.numpy(),
                                       want[key][name].numpy(),
                                       err_msg=f"{key} {name}", **tol)
    for name, value in got["batch_stats"].items():
        np.testing.assert_allclose(value.numpy(),
                                   want["buffers"][name].numpy(),
                                   err_msg=name, **tol)
    assert (got["count"], got["step"], got["ema_step"]) == (
        want["count"], want["step"], want["ema_step"])


def tree_keys(tree):
    """The keys of a canonical tree that hold tensors: params, target,
    the optimizer's state (lars_momentum's momentum when it names none),
    Polyak's when there, and the BatchNorm statistics."""
    from byol_tpu_torch.training.state import opt_fields
    return (["params", "target", "batch_stats"]
            + list(opt_fields(tree.get("optimizer", "lars_momentum")))
            + (["polyak"] if "polyak" in tree else []))


def assert_trees_equal(a, b):
    """Two ranks' canonical trees, bit for bit."""
    assert set(tree_keys(a)) == set(tree_keys(b))
    for key in tree_keys(a):
        if torch.is_tensor(a[key]):
            assert torch.equal(a[key], b[key]), key
            continue
        for name, value in a[key].items():
            assert torch.equal(value, b[key][name]), f"{key} {name}"
    assert a.get("opt_counts", {}) == b.get("opt_counts", {})


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_two_ranks_match_jax_one_device(arm, tmp_path):
    extra, kind = ARMS[arm]
    k = extra.get("accum_steps", 1)
    kw = dict(BASE, **extra)
    draws = None
    if kind == "images":
        kw.update(augment_in_step=True, image_size=SIZE, aug_seed=AUG_SEED)
        jax_draw = jax_step_views(AUG_SEED)
        draws = {(s, i): tuple(tuple(v) for v in jax_draw(
                     s, MICRO, RAW, RAW, i))
                 for s in range(STEPS) for i in range(k)}
    _, jstate, jstep, _ = _jax_side(False, kw, "reference")
    converted = train_state_from_flax(_as_numpy(jstate),
                                      like=tiny_net().state_dict())
    batches = _batches(kind, STEPS, 21, MICRO * k)
    ranks = run_ranks("train", dict(converted=converted, scfg=kw,
                                    batches=batches, draws=draws),
                      WORLD, tmp_path)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {key: jnp.asarray(v)
                                    for key, v in batch.items()})
        for key in METRICS:
            np.testing.assert_allclose(ranks[0]["metrics"][i][key],
                                       float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
    want = train_state_from_flax(_as_numpy(jstate))
    if kw["norm_mode"] == "paper":
        got = ranks[0]["state"]
        assert (got["count"], got["step"], got["ema_step"]) == (
            want["count"], want["step"], want["ema_step"])
    else:
        assert_tree_matches(ranks[0]["state"], want, **TOL)
    assert_trees_equal(ranks[0]["state"], ranks[1]["state"])
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


# the paper loss's state at two ranks against one device, in float64;
# the atol covers the Dense biases that feed a BatchNorm (test docstring)
PAPER_F64_TOL = dict(rtol=1e-9, atol=1e-14)


def test_paper_loss_state_at_two_ranks_equals_one_device_float64(tmp_path):
    """The ``paper`` loss at world 2 (ROADMAP.md section 3.9): the port's
    two-rank step over gloo against its own one-device step on the same
    global batches, the unfused lars_momentum chain, both in float64 on
    the CPU from one seeded state: params, momentum, target, BatchNorm
    statistics and counters at rtol 1e-9 after 3 steps.  In fp32 the
    per-row paper loss amplifies the rounding of another summation order
    to ~1e-2 in three steps (the module docstring); in float64 the same
    amplification leaves the two runs far inside 1e-9.  (The fused path
    cannot take part: K1a's plain version rounds its row partials in
    fp32.)

    Measured (this CPU, torch 2.x): every leaf agrees within 1.0e-10
    relative elementwise (4e-13 of its largest magnitude), except the
    biases of the three Dense layers that feed a BatchNorm
    (``projector.dense1``, ``projector.dense2``, ``predictor.dense1``):
    the BatchNorm cancels them, so their gradient is 0 in exact
    arithmetic and they hold rounding noise of 1e-20 to 4e-15 whose
    relative error is meaningless (~100 %).  Hence atol 1e-14, from
    their measured largest difference, 4.5e-15 (the momentum of
    ``projector.dense1.bias``)."""
    from tests.torch_ranks import seeded_tree, train
    kw = dict(BASE, norm_mode="paper", fused_update=False)
    spec = dict(canonical=seeded_tree(dtype=torch.float64), scfg=kw,
                dtype=torch.float64,
                batches=_batches("views", STEPS, 21, MICRO))
    one = train(spec)
    ranks = run_ranks("train", spec, WORLD, tmp_path)
    assert_trees_equal(ranks[0]["state"], ranks[1]["state"])
    got, want = ranks[0]["state"], one["state"]
    assert got["params"]["backbone.stem_conv.weight"].dtype == torch.float64
    for key in tree_keys(want):
        for name, value in want[key].items():
            np.testing.assert_allclose(got[key][name].numpy(), value.numpy(),
                                       err_msg=f"{key} {name}",
                                       **PAPER_F64_TOL)
    assert (got["count"], got["step"], got["ema_step"]) == (
        want["count"], want["step"], want["ema_step"]) == (STEPS, STEPS,
                                                           STEPS + 1)
    # the grouped step all-reduces its metrics as fp32
    for i in range(STEPS):
        for key in METRICS:
            assert ranks[0]["metrics"][i][key] == pytest.approx(
                one["metrics"][i][key], rel=1e-6)

