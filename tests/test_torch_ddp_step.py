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


def assert_trees_equal(a, b):
    """Two ranks' canonical trees, bit for bit."""
    for key in ("params", "momentum", "target", "batch_stats"):
        for name, value in a[key].items():
            assert torch.equal(value, b[key][name]), f"{key} {name}"


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
