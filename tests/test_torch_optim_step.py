"""The port's train step with the optimizer registry's other chains, held
against the JAX package's.

The tiny BYOL net of tests/test_torch_train_step.py (standardised inputs,
the reference loss) starts in both packages from one JAX
``TrainState`` of the chain, carried across by
``convert.train_state_from_flax`` with its optax state, and takes three
steps on the same numpy batches with ``--optimizer`` lars_adam, lamb,
lbfgs, lars_lbfgs and sgd with ``--clip``, unfused.  Per-step metrics,
params, target, every optimizer-state tree and count, BatchNorm
statistics and the counters agree at 1e-4, fp32; so does the health
vector (``telemetry='step'``) of one LARS chain (lars_lbfgs: LARS's
applied trust ratios) and one bare chain (sgd with clip: ones(1), the
norm of the update the chain applied, the gradient's before the clip).

Adam divides every element by its own running scale, so it passes the
two frameworks' gradient rounding straight into the update: on this net
the port's own fp32 gradient differs from its float64 gradient by 0.1-0.2
% of each backbone leaf's largest element (BatchNorm's backward cancels),
JAX's by as much, and an element whose gradient lies within that noise of
0 takes an update of either sign, up to lr.  Hence 16 px views and batch
64 (fewer positions per BatchNorm channel than 32 px), the target
starting as a copy of the params (under the reference init the target's
projections are 0.004 of the online ones', and the projector biases,
whose gradients are rounding noise, moved the loss by 0.4 % in one
lars_adam step), and for lars_adam's params, target and BatchNorm
statistics a bound on the share of elements past 1e-4, 1 %, beside a
bound on the worst param and target, 6 lr (a flip at every step).
Measured: 21 of the 12,210 params (0.17 %) past 1e-4, the worst 1.75e-3
(one flip at lr 1e-3), the target (an EMA) all within 2.2e-5, 2 of the
624 statistics (0.32 %, the running means behind a flipped kernel
element) past 1e-4, the worst 3.4e-4; at 32 px, and at lr 5e-4, other
elements flipped.  Its
metrics, optimizer state and counters are held at 1e-4 like the rest;
the chains themselves are held against optax at 1e-5 on identical
gradients in tests/test_torch_optimizers.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byol_tpu.core.precision import get_policy as jax_policy
from byol_tpu.optim.factory import build_optimizer as jax_build_optimizer
from byol_tpu.optim.factory import is_lars_optimizer
from byol_tpu.training import steps as jax_steps
from byol_tpu.training.state import create_train_state as jax_create_state
from byol_tpu_torch.convert import train_state_from_flax
from byol_tpu_torch.optim.factory import build_optimizer
from byol_tpu_torch.training import steps as torch_steps
from byol_tpu_torch.training.state import (canonical_state,
                                           create_train_state, load_converted)
from tests.test_torch_ddp_step import tree_keys
from tests.test_torch_train_step import (CLASSES, METRICS, TOL, _jax_net,
                                         _torch_batch)
from tests.torch_ranks import one_torch_thread  # noqa: F401
from tests.torch_ranks import tiny_net

WD, BATCH, SIZE, TOTAL = 1e-3, 64, 16, 24
PARITY = dict(normalize_inputs=True, norm_mode="reference",
              fused_update=False)
# optimizer -> (base lr, clip, telemetry)
CHAINS = {"lars_adam": (1e-3, 0.0, "off"), "lamb": (1e-3, 0.0, "off"),
          "lbfgs": (1e-2, 0.0, "off"), "sgd": (2.0, 0.01, "step"),
          "lars_lbfgs": (1e-2, 0.0, "step")}


def jax_opt_state(opt_state):
    """optax's chain state -> ``{optax field: tree or int}`` (the
    ``opt_state`` train_state_from_flax reads) and the schedule count,
    located by node type."""
    fields, counts = {}, []

    def walk(node):
        if isinstance(node, optax.ScaleByScheduleState):
            counts.append(int(node.count))
        elif isinstance(node, (optax.TraceState, optax.ScaleByAdamState,
                               optax.ScaleByRmsState,
                               optax.ScaleByAdaDeltaState,
                               optax.ScaleByLBFGSState)):
            for name in node._fields:
                value = getattr(node, name)
                fields[name] = (int(value) if name == "count"
                                else jax.device_get(value))
        elif isinstance(node, tuple):
            for child in node:
                walk(child)

    walk(opt_state)
    (count,) = counts
    return fields, count


def jax_as_numpy(state, optimizer):
    fields, count = jax_opt_state(state.opt_state)
    get = jax.device_get
    return {"params": get(state.params), "batch_stats": get(state.batch_stats),
            "target_params": get(state.target_params),
            "optimizer": optimizer, "opt_state": fields, "count": count,
            "step": int(state.step), "ema_step": int(state.ema_step)}


def batches(n, seed):
    rng = np.random.RandomState(seed)
    return [{"view1": rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
             "view2": rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
             "label": rng.randint(0, CLASSES, BATCH).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("optimizer", sorted(CHAINS))
def test_three_steps_match_jax(optimizer):
    base_lr, clip, telemetry = CHAINS[optimizer]
    opt = dict(base_lr=base_lr, global_batch_size=BATCH, weight_decay=WD,
               total_units=TOTAL, warmup_units=0, clip=clip)
    kw = dict(PARITY, telemetry=telemetry)
    # JAX
    variables = _jax_net(jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, SIZE, SIZE, 3)),
        train=True, method="warmup")
    tx, sched = jax_build_optimizer(optimizer, **opt)
    jstate = jax_create_state(variables, tx, ema_init_mode="copy")
    jstep = jax.jit(jax_steps.make_train_step(
        _jax_net(jnp.float32), tx,
        jax_steps.StepConfig(total_train_steps=TOTAL, weight_decay=WD,
                             lars_in_chain=is_lars_optimizer(optimizer),
                             **kw),
        jax_policy(False), lr_schedule=sched))
    # the port, from JAX's state
    net = tiny_net()
    state = create_train_state(net, optimizer=optimizer)
    load_converted(state, train_state_from_flax(
        jax_as_numpy(jstate, optimizer), like=net.state_dict()))
    ttx, tsched = build_optimizer(optimizer, **opt)
    step = torch_steps.make_train_step(ttx, torch_steps.StepConfig(
        total_train_steps=TOTAL, lars_in_chain=ttx.lars, **kw), tsched)
    for i, batch in enumerate(batches(3, seed=7)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        got = step(state, _torch_batch(batch))
        for key in METRICS:
            np.testing.assert_allclose(float(got[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
        if telemetry != "off":
            np.testing.assert_allclose(
                got["health"].numpy(), np.asarray(jm["health"]),
                err_msg=f"step {i} health", **TOL)
    want = train_state_from_flax(jax_as_numpy(jstate, optimizer))
    tree = canonical_state(state)
    assert tree["optimizer"] == optimizer
    assert tree["opt_counts"] == want["opt_counts"]
    assert (tree["count"], tree["step"], tree["ema_step"]) == (
        want["count"], want["step"], want["ema_step"]) == (3, 3, 3)
    for key in tree_keys(tree):
        ref = want["buffers"] if key == "batch_stats" else want[key]
        got_leaves = tree[key] if isinstance(tree[key], dict) else {
            key: tree[key]}
        ref_leaves = ref if isinstance(ref, dict) else {key: ref}
        assert set(got_leaves) == set(ref_leaves), key
        if optimizer == "lars_adam" and key in ("params", "target",
                                                "batch_stats"):
            assert_adam_params_close(got_leaves, ref_leaves, base_lr, key)
            continue
        for name, value in got_leaves.items():
            np.testing.assert_allclose(value.numpy(),
                                       ref_leaves[name].numpy(),
                                       err_msg=f"{key} {name}", **TOL)


def assert_adam_params_close(got, want, lr, key):
    """All but at most 1 % of the elements at 1e-4; no param or target
    further than the 6 lr that sign flips at all three steps could give
    (the module docstring)."""
    a = np.concatenate([got[n].numpy().ravel() for n in sorted(got)])
    b = np.concatenate([want[n].numpy().ravel() for n in sorted(got)])
    off = ~np.isclose(a, b, **TOL)
    assert off.mean() <= 1e-2, (key, int(off.sum()), a.size)
    if key != "batch_stats":
        assert np.abs(a - b).max() <= 6 * lr, (key, np.abs(a - b).max())


def test_check_numerics_adds_nothing_and_names_the_step():
    """``--check-numerics``: a finite step is bit for bit the unchecked
    one; a NaN in the views raises FloatingPointError naming the step
    (from the backward under anomaly mode, or the loss check)."""
    from tests.torch_ranks import seeded_tree, tiny_state
    tx, sched = build_optimizer("lars_momentum", base_lr=0.1,
                                global_batch_size=8, weight_decay=WD,
                                total_units=TOTAL, warmup_units=0)
    tree = seeded_tree()
    states = []
    for checked in (False, True):
        state, _ = tiny_state(canonical=tree)
        step = torch_steps.make_train_step(tx, torch_steps.StepConfig(
            total_train_steps=TOTAL, check_numerics=checked, **PARITY),
            sched)
        step(state, _torch_batch(batches(1, seed=3)[0]))
        states.append(canonical_state(state))
    from tests.test_torch_ddp_step import assert_trees_equal
    assert_trees_equal(*states)
    bad = batches(1, seed=4)[0]
    bad["view1"][0] = np.nan
    with pytest.raises(FloatingPointError, match="step 1"):
        step(state, _torch_batch(bad))

