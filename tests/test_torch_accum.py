"""Gradient accumulation in the port's train step, held against the JAX
package's.

The tiny BYOL net of tests/test_torch_train_step.py (a two-stage width-8
ResNet, heads 32/16, 10 classes, 32 px) starts in both packages from ONE
JAX ``TrainState``; three accumulated steps on the same numpy batches of k
microbatches of 32 rows must give the same per-step metrics and the same
params, momentum, target, Polyak average, BatchNorm statistics and
counters, fp32 at 1e-4 (another summation order in every conv, matmul and
norm).  Microbatches are 32 rows because the BatchNorm-parameter gradients
of this tiny net are ill-conditioned on few rows, with or without
accumulation: with k = 1 the momentum after three steps on batches of 8
drifts from JAX's by up to 9e-4, on 16 rows by up to 7e-5, on 32 by under
4e-5 (tests/test_torch_train_step.py explains the cause).  The cases cover
``accum_steps`` 2 and 4 in each ``accum_bn_mode`` under loader placement,
step placement on JAX's per-microbatch draws ``augment_keys(seed, step,
k)[i]`` with K2's plain version (JAX's kernel in interpret mode) and with
the unfused chain, the fused update (K1a/K1b's plain versions here) and
the unfused chain, and Polyak's eval metrics.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.cli import build_parser as jax_parser
from byol_tpu.core import config as jax_config
from byol_tpu.training import steps as jax_steps
from byol_tpu_torch.cli import build_parser
from byol_tpu_torch.core import config as torch_config
from byol_tpu_torch.core.rng import augment_generator, stream_seed
from byol_tpu_torch.data import device_augment as aug
from byol_tpu_torch.training import steps as torch_steps
from tests.test_torch_augment import jax_step_views
from tests.test_torch_train_step import (CLASSES, METRICS, PARITY, SIZE, TOL,
                                         _assert_states_match, _jax_side,
                                         _torch_batch, _torch_side)

MICRO, RAW, AUG_SEED = 32, 40, 13


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread, restored after: the tiny net gains nothing from
    more, and under a parallel test run every extra OpenMP team
    oversubscribes the cores the other tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)

# name -> (step config, batch kind): loader placement ('views') or raw
# uint8 images ('images'); each accum_bn_mode at k = 2 and 4, each with the
# fused update (the kernels' plain versions) and the unfused chain once
CASES = {
    "average-2": (dict(accum_steps=2, accum_bn_mode="average",
                       fused_update=True, polyak_ema=0.9), "views"),
    "average-4": (dict(accum_steps=4, accum_bn_mode="average",
                       fused_update=False), "views"),
    "microbatch-2": (dict(accum_steps=2, accum_bn_mode="microbatch",
                          fused_update=False), "views"),
    "microbatch-4": (dict(accum_steps=4, accum_bn_mode="microbatch",
                          fused_update=True), "views"),
    "global-2": (dict(accum_steps=2, accum_bn_mode="global",
                      fused_update=True), "views"),
    "global-4": (dict(accum_steps=4, accum_bn_mode="global",
                      fused_update=False, polyak_ema=0.9), "views"),
    # step placement: K2's plain version, then the unfused chain
    "step-k2-average-2": (dict(accum_steps=2, accum_bn_mode="average",
                               fused_update=True, fused_augment=True),
                          "images"),
    "step-chain-global-2": (dict(accum_steps=2, accum_bn_mode="global",
                                 fused_update=False), "images"),
}


def _batches(kind, n, seed, rows):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "views":
            b = {"view1": rng.rand(rows, SIZE, SIZE, 3).astype(np.float32),
                 "view2": rng.rand(rows, SIZE, SIZE, 3).astype(np.float32)}
        else:
            b = {"images": rng.randint(0, 256, (rows, RAW, RAW, 3)).astype(
                np.uint8)}
        b["label"] = rng.randint(0, CLASSES, rows).astype(np.int32)
        out.append(b)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_accumulated_steps_match_jax(case):
    extra, kind = CASES[case]
    extra = dict(extra)
    polyak = extra.pop("polyak_ema", 0.0)
    kw = dict(PARITY, **extra)
    if polyak:
        kw["polyak_ema"] = polyak
    draw = None
    if kind == "images":
        kw.update(augment_in_step=True, image_size=SIZE, aug_seed=AUG_SEED)
        draw = jax_step_views(AUG_SEED)
    jnet, jstate, jstep, jscfg = _jax_side(False, kw, "reference",
                                           polyak_ema=polyak)
    state, step, scfg = _torch_side(False, kw, jstate, draw_views=draw)
    batches = _batches(kind, 3, 21, MICRO * extra["accum_steps"])
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        got = step(state, _torch_batch(batch))
        for key in METRICS:
            np.testing.assert_allclose(float(got[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
    _assert_states_match(state, jstate)
    assert state.step == 3 and state.count == 3
    if not polyak:
        return
    # eval reads the Polyak params for the online forward and the probe
    batch = dict(_batches("views", 1, 5, 16)[0], mask=np.array(
        [1] * 12 + [0] * 4, np.float32))
    want = jax.jit(jax_steps.make_eval_step(
        _jax_side(False, dict(PARITY), "reference")[0], jscfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = torch_steps.make_eval_step(scfg)(state, _torch_batch(batch))
    for key in METRICS + ("_weight",):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   err_msg=key, **TOL)
    plain = torch_steps.make_eval_step(
        dataclasses.replace(scfg, polyak_ema=0.0))(state, _torch_batch(batch))
    assert float(plain["loss_mean"]) != float(got["loss_mean"])


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_strided_split_covers_the_batch(k):
    x = torch.arange(16 * 3).reshape(16, 3)
    parts = torch_steps.microbatch_split(x, k)
    want = np.asarray(jax_steps._microbatch_split(jnp.asarray(x.numpy()), k))
    assert len(parts) == k
    for i, part in enumerate(parts):
        np.testing.assert_array_equal(part.numpy(), want[i])
        np.testing.assert_array_equal(part[:, 0].numpy() // 3,
                                      np.arange(i, 16, k))
    rows = torch.cat(parts)[:, 0] // 3
    assert sorted(rows.tolist()) == list(range(16))
    with pytest.raises(ValueError, match="not divisible"):
        torch_steps.microbatch_split(x[:15], 2 if k == 1 else k)


def test_microbatch_draws_keep_microbatch_0_and_differ_per_microbatch():
    # microbatch 0 draws what every step drew before accumulation
    old = torch.Generator().manual_seed(stream_seed(5, "augment/17/0"))
    assert torch.equal(torch.rand(8, generator=augment_generator(5, 17)),
                       torch.rand(8, generator=old))
    a0 = aug.step_views(5, 17, 8, RAW, RAW)
    assert all(torch.equal(x, y) for x, y in
               zip(a0[0], aug.step_views(5, 17, 8, RAW, RAW, microbatch=0)[0]))
    a1 = aug.step_views(5, 17, 8, RAW, RAW, microbatch=1)
    again = aug.step_views(5, 17, 8, RAW, RAW, microbatch=1)
    assert all(torch.equal(x, y) for x, y in zip(a1[1], again[1]))
    assert not torch.equal(a0[0].y0, a1[0].y0)
    assert not torch.equal(a1[0].y0, aug.step_views(5, 18, 8, RAW, RAW,
                                                    microbatch=1)[0].y0)


def test_average_and_microbatch_share_the_gradient():
    """The modes differ only in the running statistics they write: the
    train forward normalises with batch statistics, so the mean gradient
    of one step is the same in both, bit for bit on one device."""
    grads, stats = {}, {}
    batch = _torch_batch(_batches("views", 1, 3, 4 * MICRO)[0])
    for mode in ("average", "microbatch"):
        kw = dict(PARITY, accum_steps=4, accum_bn_mode=mode)
        _, jstate, _, _ = _jax_side(False, kw, "reference")
        state, step, _ = _torch_side(False, kw, jstate)
        step(state, batch)
        grads[mode] = state.grads.clone()
        stats[mode] = torch.cat(list(state.batch_stats().values()))
    assert torch.equal(grads["average"], grads["microbatch"])
    assert not torch.equal(stats["average"], stats["microbatch"])


def test_global_matches_one_big_step():
    """Under the paper loss (per-row norms), 'global' is the k = 1 step on
    the same rows in another order: the same metrics up to fp32 summation
    order.  (Its gradient and state are held against JAX's 'global' in the
    cases above: the BatchNorm-parameter gradients move by ~1e-3 under a
    mere reordering of the rows, see the module docstring.)"""
    batch = _torch_batch(_batches("views", 1, 4, 4 * MICRO)[0])
    out = {}
    for k in (1, 4):
        kw = dict(PARITY, norm_mode="paper", accum_steps=k,
                  accum_bn_mode="global")
        _, jstate, _, _ = _jax_side(False, kw, "reference")
        state, step, _ = _torch_side(False, kw, jstate)
        out[k] = step(state, batch)
    for key in METRICS:
        np.testing.assert_allclose(float(out[4][key]), float(out[1][key]),
                                   err_msg=key, **TOL)


def test_step_refuses_what_jax_refuses():
    from byol_tpu_torch.optim.factory import build_optimizer
    tx, sched = build_optimizer("lars_momentum", base_lr=0.2,
                                global_batch_size=8, weight_decay=0.0,
                                total_units=4, warmup_units=0)
    bad = [dict(accum_steps=0), dict(accum_bn_mode="sometimes"),
           dict(accum_steps=2, accum_bn_mode="global", augment_in_step=True,
                fused_augment=True, image_size=SIZE)]
    for kw in bad:
        with pytest.raises(ValueError):
            torch_steps.make_train_step(
                tx, torch_steps.StepConfig(total_train_steps=4, **kw), sched)
    kw = dict(accum_steps=2, accum_bn_mode="global", augment_in_step=True,
              fused_augment=True, image_size=SIZE)
    with pytest.raises(ValueError):
        jax_steps.make_train_step(None, None, jax_steps.StepConfig(
            total_train_steps=4, **kw))


@pytest.mark.parametrize("mode", ["average", "microbatch", "global"])
def test_resolve_accepts_accumulation(mode):
    """accum_steps > 1 resolves as in JAX: batch, steps and microbatch in
    effective-batch units; fused_augment with 'global' is refused by both."""
    def cfg(mod, **task):
        return mod.Config(
            task=mod.TaskConfig(batch_size=4096, epochs=3, **task),
            optim=mod.OptimConfig(accum_steps=16, accum_bn_mode=mode,
                                  fused_update="on"),
            device=mod.DeviceConfig(num_replicas=1))
    kw = dict(num_train_samples=8192, num_test_samples=819, output_size=10,
              input_shape=(224, 224, 3))
    got = torch_config.resolve(cfg(torch_config), **kw)
    want = jax_config.resolve(cfg(jax_config), **kw)
    assert (got.microbatch_size, got.accum_steps, got.steps_per_train_epoch,
            got.total_train_steps) == (want.microbatch_size, want.accum_steps,
                                       want.steps_per_train_epoch,
                                       want.total_train_steps) == (
        256, 16, 2, 6)
    step = dict(augment_placement="step", fused_augment="on")
    if mode == "global":
        for mod in (torch_config, jax_config):
            with pytest.raises(ValueError, match="global"):
                mod.resolve(cfg(mod, **step), **kw)
    else:
        assert torch_config.resolve(cfg(torch_config, **step),
                                    **kw).accum_steps == 16


FLAGS = ("--accum-steps", "--accum-bn-mode", "--polyak-ema",
         "--weight-initialization", "--ema-scaling-reference-batch")


@pytest.mark.parametrize("flag", FLAGS)
def test_cli_flag_has_jax_default_and_choices(flag):
    def action(parser):
        return next(a for a in parser._actions if flag in a.option_strings)
    ours, theirs = action(build_parser()), action(jax_parser())
    assert (ours.default, ours.choices, ours.type) == (
        theirs.default, theirs.choices, theirs.type)
