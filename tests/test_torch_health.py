"""The port's health vector (byol_tpu_torch/observability/health.py and the
train step's ``telemetry``) held against the JAX package's.

Pure functions: ``pack`` / ``unpack``, ``global_norm``, ``nonfinite_count``,
``collapse_stats`` (population std, collapsed input) and the median of an
even count, each against JAX's on the same numpy arrays.

The step: all 12 fields of ``metrics['health']`` from one optimizer step,
the port against JAX ``make_train_step(telemetry='step')`` from one JAX
``TrainState`` on the same batch, fp32, rtol 1e-4 (atol 1e-7 for fields
near 0), ``nonfinite_count`` exact.  The port runs with the fused update
(K1a/K1b's plain versions here; the trust statistics are K1a's own
ratios) and with the unfused chain; both are held against JAX's UNFUSED
step, never its fused one.  Cases: k = 1, 2 and 4, each
``accum_bn_mode`` at k = 2 and 4, on the tiny net of
tests/test_torch_train_step.py, and ResNet-18 (32 px, heads 64/32) at
k = 1.  Microbatches are 32 rows (BatchNorm-parameter gradients drift on
fewer, tests/test_torch_accum.py).  ResNet-18 is not used for the
accumulation cases: JAX's accumulation scan takes 76-148 s a step there
on the CPU ('global' at k = 2, a vmap, 14 s, agrees to 1.5e-5), and in
'average' at k = 2 its per-layer gradient norms are ill-conditioned
enough at 32 rows that the median trust ratio moves by 2.4e-4 between the
frameworks while every global norm agrees to 4e-6.

``--telemetry off``: every health function raises if called, and the step's
metrics have exactly the five keys they had before telemetry existed; the
state after a step with telemetry is bitwise the state after one without.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.models.byol_net import build_byol_net as jax_build_net
from byol_tpu.observability import health as jax_health
from byol_tpu.optim.factory import build_optimizer as jax_build_optimizer
from byol_tpu.training import steps as jax_steps
from byol_tpu.training.state import create_train_state as jax_create_state
from byol_tpu.core.precision import get_policy as jax_policy
from byol_tpu_torch.convert import train_state_from_flax
from byol_tpu_torch.models.byol_net import build_byol_net
from byol_tpu_torch.observability import health
from byol_tpu_torch.optim.factory import build_optimizer
from byol_tpu_torch.training import steps as torch_steps
from byol_tpu_torch.training.state import create_train_state, load_converted
from tests.test_torch_train_step import (CLASSES, METRICS, PARITY, SIZE,
                                         _as_numpy, _jax_side, _torch_batch,
                                         _torch_side)

MICRO = 32
RTOL, ATOL = 1e-4, 1e-7


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread, restored after (the tiny nets gain nothing from
    more, and under a parallel run extra OpenMP teams oversubscribe the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# pure functions against JAX's
# ---------------------------------------------------------------------------

def test_fields_are_jax_fields():
    assert health.HEALTH_FIELDS == jax_health.HEALTH_FIELDS


def test_pack_unpack_match_jax():
    vals = {k: float(i) * 0.5 - 1.0
            for i, k in enumerate(health.HEALTH_FIELDS)}
    got = health.pack(vals)
    want = np.asarray(jax_health.pack(vals))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert health.unpack(got) == jax_health.unpack(want) == pytest.approx(
        vals)


def test_pack_and_unpack_reject_layout_drift():
    vals = {k: 0.0 for k in health.HEALTH_FIELDS}
    with pytest.raises(ValueError, match="extra"):
        health.pack({**vals, "extra": 1.0})
    vals.pop("loss")
    with pytest.raises(ValueError, match="missing"):
        health.pack(vals)
    with pytest.raises(ValueError, match="slots"):
        health.unpack(np.zeros(len(health.HEALTH_FIELDS) - 1))


@pytest.mark.parametrize("n", [1, 2, 5, 6, 53])
def test_median_is_jnp_median(n):
    """An even count averages the two middle values (torch.median would
    return the lower one)."""
    x = np.random.RandomState(n).rand(n).astype(np.float32)
    got = float(health.median(torch.from_numpy(x)))
    assert got == float(jnp.median(jnp.asarray(x)))
    if n % 2 == 0 and n > 1:
        assert got != float(torch.from_numpy(x).median())


@pytest.mark.parametrize("rows", [1, 2, 8, 33])
def test_collapse_stats_match_jax(rows):
    """Population std (jnp.std, correction=0) and the closed-form mean
    pairwise cosine."""
    p = np.random.RandomState(rows).randn(rows, 16).astype(np.float32)
    got = health.collapse_stats(torch.from_numpy(p))
    want = jax_health.collapse_stats(jnp.asarray(p))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-7)
    if rows > 1:
        pop = float(torch.from_numpy(p).std(dim=0).mean())
        assert abs(float(got[0]) - pop) > 1e-6   # not the sample std


def test_collapse_stats_see_collapse_as_jax_does():
    row = np.random.RandomState(0).randn(1, 16).astype(np.float32)
    p = np.repeat(row, 12, axis=0)
    fstd, cos = health.collapse_stats(torch.from_numpy(p))
    jstd, jcos = jax_health.collapse_stats(jnp.asarray(p))
    assert float(fstd) == pytest.approx(0.0, abs=1e-6) and float(jstd) == \
        pytest.approx(0.0, abs=1e-6)
    np.testing.assert_allclose(float(cos), float(jcos), rtol=1e-5)
    assert float(cos) == pytest.approx(1.0, abs=1e-5)


def test_norms_and_counts_match_jax_on_leaves():
    rng = np.random.RandomState(1)
    leaves = [rng.randn(3, 4).astype(np.float32),
              rng.randn(7).astype(np.float32),
              rng.randn(2, 128).astype(np.float32)]
    leaves[0][1, 2] = np.nan
    leaves[2][0, 5] = -np.inf
    t = [torch.from_numpy(x) for x in leaves]
    assert float(health.nonfinite_count(t)) == float(
        jax_health.nonfinite_count(leaves)) == 2.0
    finite = [np.nan_to_num(x, posinf=0.0, neginf=0.0) for x in leaves]
    np.testing.assert_allclose(
        float(health.global_norm([torch.from_numpy(x) for x in finite])),
        float(jax_health.global_norm(finite)), rtol=1e-6)
    assert float(health.global_norm([])) == 0.0


def test_global_norm_of_a_long_flat_buffer_is_fp32_exact():
    """One vector_norm over 10^7 fp32 elements drifts by ~1e-3 on the CPU;
    the flat buffers' two-level reduction stays at fp32 rounding."""
    x = torch.from_numpy(np.random.RandomState(2).randn(
        1 << 23).astype(np.float32)) * 0.03
    want = float(x.double().square().sum().sqrt())
    assert float(health.global_norm(x)) == pytest.approx(want, rel=1e-6)


def test_health_stats_match_jax_on_trees():
    """The port takes the update's norm where JAX takes the update tree."""
    rng = np.random.RandomState(3)
    shapes = [(3, 4), (4,), (2, 5)]
    g, p, t, u = ([rng.randn(*s).astype(np.float32) for s in shapes]
                  for _ in range(4))
    proj = rng.randn(8, 6).astype(np.float32)
    trust = rng.rand(4).astype(np.float32)
    tt = lambda xs: [torch.from_numpy(x) for x in xs]   # noqa: E731
    got = health.health_stats(
        grads=tt(g), update_norm=health.global_norm(tt(u)), params=tt(p),
        target_params=tt(t), loss=torch.tensor(1.5),
        collapse=health.collapse_stats(torch.from_numpy(proj)),
        trust_ratios=torch.from_numpy(trust))
    want = jax_health.health_stats(
        grads=g, updates=u, params=p, target_params=t, loss=jnp.float32(1.5),
        collapse=jax_health.collapse_stats(jnp.asarray(proj)),
        trust_ratios=jnp.asarray(trust))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the step's health vector against JAX's unfused step
# ---------------------------------------------------------------------------

def _batch(rows, seed):
    rng = np.random.RandomState(seed)
    return {"view1": rng.rand(rows, SIZE, SIZE, 3).astype(np.float32),
            "view2": rng.rand(rows, SIZE, SIZE, 3).astype(np.float32),
            "label": rng.randint(0, CLASSES, rows).astype(np.int32)}


def _assert_health_matches(got, want, case):
    got = health.unpack(got)
    want = jax_health.unpack(np.asarray(want))
    assert got["nonfinite_count"] == want["nonfinite_count"] == 0.0, case
    for field in health.HEALTH_FIELDS:
        np.testing.assert_allclose(got[field], want[field], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{case} {field}")


def _r18_sides(kw, rows):
    """ResNet-18 (CIFAR stem at 32 px, heads 64/32) in both packages from
    one flax init: -> (JAX state, jitted JAX step, a function making a
    port (state, step) for a given fused_update)."""
    global_bn = kw["accum_steps"] > 1 and kw["accum_bn_mode"] == "global"
    net_kw = dict(num_classes=CLASSES, head_latent_size=64,
                  projection_size=32)
    variables = jax_build_net(
        "resnet18", small_inputs=True, zero_init_residual=False,
        **net_kw).init({"params": jax.random.PRNGKey(0)},
                       jnp.zeros((2, SIZE, SIZE, 3)), train=True,
                       method="warmup")
    jnet = jax_build_net(
        "resnet18", small_inputs=True, zero_init_residual=False,
        bn_axis_name=jax_steps.ACCUM_AXIS if global_bn else None, **net_kw)
    opt = dict(base_lr=2.0, global_batch_size=rows, weight_decay=1e-3,
               total_units=24, warmup_units=0)
    tx, sched = jax_build_optimizer("lars_momentum", **opt)
    jstate = jax_create_state(variables, tx, ema_init_mode="copy")
    jstep = jax.jit(jax_steps.make_train_step(
        jnet, tx, jax_steps.StepConfig(total_train_steps=24,
                                       weight_decay=1e-3, **kw),
        jax_policy(False), lr_schedule=sched))

    def port(fused):
        net = build_byol_net("resnet18", generator=torch.Generator(),
                             image_size=SIZE, small_inputs=True,
                             zero_init_residual=False, **net_kw)
        state = create_train_state(net)
        load_converted(state, train_state_from_flax(
            _as_numpy(jstate), like=net.state_dict()))
        ttx, tsched = build_optimizer("lars_momentum", **opt)
        return state, torch_steps.make_train_step(
            ttx, torch_steps.StepConfig(total_train_steps=24,
                                        **dict(kw, fused_update=fused)),
            tsched)
    return jstate, jstep, port


# name -> (net, accum_steps, accum_bn_mode)
CASES = {
    "tiny-k1": ("tiny", 1, "average"),
    "tiny-average-2": ("tiny", 2, "average"),
    "tiny-microbatch-2": ("tiny", 2, "microbatch"),
    "tiny-global-2": ("tiny", 2, "global"),
    "tiny-average-4": ("tiny", 4, "average"),
    "tiny-microbatch-4": ("tiny", 4, "microbatch"),
    "tiny-global-4": ("tiny", 4, "global"),
    "resnet18-k1": ("resnet18", 1, "average"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_health_matches_jax_unfused(case):
    net, k, mode = CASES[case]
    rows = MICRO * k
    kw = dict(PARITY, accum_steps=k, accum_bn_mode=mode, telemetry="step")
    batch = _batch(rows, seed=k)
    if net == "tiny":
        _, jstate, jstep, _ = _jax_side(False, dict(kw, fused_update=False),
                                        "copy")

        def port(fused):
            state, step, _ = _torch_side(False, dict(kw, fused_update=fused),
                                         jstate)
            return state, step
    else:
        jstate, jstep, port = _r18_sides(dict(kw, fused_update=False), rows)
    _, jm = jstep(jstate, {n: jnp.asarray(v) for n, v in batch.items()})
    assert set(jm) == set(METRICS) | {"health"}
    for fused in (False, True):
        state, step = port(fused)
        got = step(state, _torch_batch(batch))
        assert set(got) == set(METRICS) | {"health"}
        _assert_health_matches(got["health"], jm["health"],
                               f"{case} fused={fused}")
        # the loss slot is the step's loss
        assert float(got["health"][-1]) == float(got["loss_mean"])


def test_fused_trust_stats_are_k1a_ratios(monkeypatch):
    """Under the fused update the trust slots are min / median / max of
    the very vector K1a's wrapper returned: reported equals applied."""
    from byol_tpu_torch.ops import fused_update as fused_lib
    seen = []
    real = fused_lib.fused_lars_ema_update_buffers

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out.clone())
        return out
    monkeypatch.setattr(fused_lib, "fused_lars_ema_update_buffers", spy)
    kw = dict(PARITY, fused_update=True, telemetry="step")
    _, jstate, _, _ = _jax_side(False, kw, "copy")
    state, step, _ = _torch_side(False, kw, jstate)
    vec = health.unpack(step(state, _torch_batch(_batch(MICRO, 5)))[
        "health"])
    (trust,) = seen
    assert trust.numel() == sum(state.seg.adapted) > 1
    assert (vec["trust_min"], vec["trust_median"], vec["trust_max"]) == (
        float(trust.min()), float(health.median(trust)), float(trust.max()))
    assert vec["trust_min"] <= vec["trust_median"] <= vec["trust_max"]


def test_off_step_runs_no_health_and_keeps_todays_keys(monkeypatch):
    """The counterpart of JAX's test_off_never_traces_health: under
    telemetry 'off' no health function is called, the metrics keep their
    five keys, and the state after the step is bitwise the state after
    a step with telemetry on (the diagnostics never feed back)."""
    kw = dict(PARITY, fused_update=True, accum_steps=2)
    _, jstate, _, _ = _jax_side(False, kw, "copy")
    batch = _torch_batch(_batch(2 * MICRO, 6))
    on_state, on_step, _ = _torch_side(False, dict(kw, telemetry="step"),
                                       jstate)
    on = on_step(on_state, batch)

    def boom(*a, **k):
        raise AssertionError("a health function ran under telemetry off")
    for fn in ("health_stats", "collapse_stats", "global_norm",
               "nonfinite_count", "pack", "median"):
        monkeypatch.setattr(health, fn, boom)
    off_state, off_step, _ = _torch_side(False, kw, jstate)
    off = off_step(off_state, batch)
    assert sorted(off) == sorted(METRICS)
    for key in METRICS:
        assert torch.equal(off[key], on[key]), key
    for name in ("params", "grads", "momentum", "target"):
        assert torch.equal(getattr(off_state, name),
                           getattr(on_state, name)), name


def test_step_refuses_unknown_telemetry():
    tx, sched = build_optimizer("lars_momentum", base_lr=0.2,
                                global_batch_size=8, weight_decay=0.0,
                                total_units=4, warmup_units=0)
    with pytest.raises(ValueError, match="telemetry"):
        torch_steps.make_train_step(tx, dataclasses.replace(
            torch_steps.StepConfig(total_train_steps=4),
            telemetry="always"), sched)
