"""The port's BYOL train step held against the JAX package's.

A tiny BYOL net (ResNet with two Bottleneck stages of width 8 and the CIFAR
stem, heads 32/16, 10 classes) at 32 px, batch 8, starts in both packages
from ONE JAX ``TrainState``, carried across by
``convert.train_state_from_flax``.  Three steps on the same numpy batches
must give the same per-step metrics and the same params, momentum, target,
BatchNorm statistics and counters, fp32 at 1e-4 (another summation order
in every conv, matmul and norm); one bf16 step's loss agrees at 3e-2 (bf16
rounds at other points in the two frameworks).  The JAX steps are jitted
once per case: about four compilations in all.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.core import config as jax_config
from byol_tpu.core.precision import get_policy as jax_policy
from byol_tpu.models import resnet as jax_resnet
from byol_tpu.models.byol_net import BYOLNet as JaxBYOLNet
from byol_tpu.objectives import byol_loss as jax_loss
from byol_tpu.objectives import metrics as jax_metrics
from byol_tpu.optim import schedules as jax_sched
from byol_tpu.optim.factory import build_optimizer as jax_build_optimizer
from byol_tpu.optim.factory import extract_sgdm_state
from byol_tpu.training import steps as jax_steps
from byol_tpu.training.state import create_train_state as jax_create_state
from byol_tpu_torch.convert import train_state_from_flax
from byol_tpu_torch.core import config as torch_config
from byol_tpu_torch.core.precision import get_policy
from byol_tpu_torch.models import resnet as torch_resnet
from byol_tpu_torch.models.byol_net import BYOLNet
from byol_tpu_torch.objectives import byol_loss as torch_loss
from byol_tpu_torch.objectives import metrics as torch_metrics
from byol_tpu_torch.optim import schedules as torch_sched
from byol_tpu_torch.optim.factory import build_optimizer
from byol_tpu_torch.training import steps as torch_steps
from byol_tpu_torch.training.state import create_train_state, load_converted

BATCH, SIZE, CLASSES, HEAD, PROJ = 8, 32, 10, 32, 16
WD, BASE_LR, TOTAL = 1e-3, 2.0, 24         # lr = 2 * 8 / 256 = 0.0625
METRICS = ("loss_mean", "byol_loss_mean", "linear_loss_mean", "top1_mean",
           "top5_mean")
TOL = dict(rtol=1e-4, atol=1e-4)


# the three-step state comparisons hold the BatchNorm-parameter gradients
# of the tiny net at 1e-4, which one thread's summation order moves past
# (the module docstring's ill-conditioning): they keep torch's default
# thread count, every other test runs on one thread
DEFAULT_THREADS = ("test_three_steps_match_jax",)


@pytest.fixture(autouse=True)
def one_thread(request, monkeypatch):
    """One torch thread, restored after, and in the environment that
    spawned loader workers inherit: under a parallel test run every extra
    OpenMP team oversubscribes the cores the other tests share."""
    if request.node.originalname in DEFAULT_THREADS:
        yield
        return
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"view1": rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
             "view2": rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
             "label": rng.randint(0, CLASSES, BATCH).astype(np.int32)}
            for _ in range(n)]


def _jax_net(dtype, bn_axis_name=None):
    backbone = jax_resnet.ResNet(stage_sizes=[1, 1],
                                 block_cls=jax_resnet.Bottleneck, width=8,
                                 small_inputs=True, zero_init_residual=False,
                                 dtype=dtype, bn_axis_name=bn_axis_name)
    return JaxBYOLNet(backbone=backbone, num_classes=CLASSES,
                      head_latent_size=HEAD, projection_size=PROJ,
                      dtype=dtype, bn_axis_name=bn_axis_name)


def _jax_side(half, scfg_kw, ema_init_mode, polyak_ema=0.0):
    """-> (net, state, jitted train step, StepConfig).  Under
    ``accum_bn_mode='global'`` the step's net syncs its BatchNorms over the
    microbatch axis; the variables come from the same net without it (the
    same tree, and init needs no axis bound)."""
    dtype = jnp.bfloat16 if half else jnp.float32
    variables = _jax_net(dtype).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, SIZE, SIZE, 3)),
        train=True, method="warmup")
    global_bn = (scfg_kw.get("accum_steps", 1) > 1
                 and scfg_kw.get("accum_bn_mode") == "global")
    net = _jax_net(dtype, jax_steps.ACCUM_AXIS if global_bn else None)
    tx, sched = jax_build_optimizer(
        "lars_momentum", base_lr=BASE_LR, global_batch_size=BATCH,
        weight_decay=WD, total_units=TOTAL, warmup_units=0)
    state = jax_create_state(variables, tx, ema_init_mode=ema_init_mode,
                             polyak_ema=polyak_ema)
    scfg = jax_steps.StepConfig(total_train_steps=TOTAL, weight_decay=WD,
                                **scfg_kw)
    step = jax.jit(jax_steps.make_train_step(
        net, tx, scfg, jax_policy(half), lr_schedule=sched))
    return net, state, step, scfg


def _as_numpy(state):
    trace, count = extract_sgdm_state(state.opt_state)
    get = jax.device_get
    return {"params": get(state.params), "batch_stats": get(state.batch_stats),
            "target_params": get(state.target_params),
            "momentum": get(trace), "count": int(count),
            "step": int(state.step), "ema_step": int(state.ema_step),
            "polyak_params": get(state.polyak_params)}


def _torch_side(half, scfg_kw, jax_state, draw_views=None):
    dtype = torch.bfloat16 if half else torch.float32
    backbone = torch_resnet.ResNet(stage_sizes=[1, 1],
                                   block_cls=torch_resnet.Bottleneck, width=8,
                                   small_inputs=True, zero_init_residual=False,
                                   dtype=dtype)
    net = BYOLNet(backbone, num_classes=CLASSES, head_latent_size=HEAD,
                  projection_size=PROJ, dtype=dtype)
    state = create_train_state(net,
                               polyak_ema=scfg_kw.get("polyak_ema", 0.0))
    load_converted(state, train_state_from_flax(_as_numpy(jax_state),
                                                like=net.state_dict()))
    tx, sched = build_optimizer(
        "lars_momentum", base_lr=BASE_LR, global_batch_size=BATCH,
        weight_decay=WD, total_units=TOTAL, warmup_units=0)
    scfg = torch_steps.StepConfig(total_train_steps=TOTAL, **scfg_kw)
    return state, torch_steps.make_train_step(
        tx, scfg, sched, get_policy(half), draw_views=draw_views), scfg


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_states_match(state, jax_state):
    want = train_state_from_flax(_as_numpy(jax_state))
    bufs = [("params", state.params), ("momentum", state.momentum),
            ("target", state.target)]
    assert ("polyak" in want) == (state.polyak is not None)
    if state.polyak is not None:
        bufs.append(("polyak", state.polyak))
    for key, buf in bufs:
        for name, got in state.tree(buf).items():
            np.testing.assert_allclose(got.numpy(), want[key][name].numpy(),
                                       err_msg=f"{key} {name}", **TOL)
    for name, got in state.batch_stats().items():
        np.testing.assert_allclose(got.numpy(), want["buffers"][name].numpy(),
                                   err_msg=name, **TOL)
    assert (state.count, state.step, state.ema_step) == (
        want["count"], want["step"], want["ema_step"])


# Both cases standardise the inputs and use the reference loss and EMA
# init: with raw [0, 1] pixels, or with the paper loss against a target that
# starts as an exact copy, the BatchNorm-parameter gradients of this tiny
# net are ill-conditioned (the next BatchNorm all but cancels them, and one
# ReLU input within float32 rounding of 0 moves them by ~0.5 %), so the two
# frameworks' rounding alone drifts the state past 1e-4 while the losses
# still agree to 1e-6.  The paper loss and the copy init are held against
# JAX in the loss test and the bf16 step below.
PARITY = dict(normalize_inputs=True, norm_mode="reference")
CASES = {
    # the unfused chain, EMA of the post-update params; eval afterwards
    "unfused": (dict(PARITY, fused_update=False), "reference"),
    # the kernels' path, EMA of the pre-update params
    "fused": (dict(PARITY, fused_update=True,
                   ema_update_mode="reference_pre"), "reference"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(case):
    scfg_kw, ema_init_mode = CASES[case]
    jnet, jstate, jstep, jscfg = _jax_side(False, scfg_kw, ema_init_mode)
    state, step, scfg = _torch_side(False, scfg_kw, jstate)
    assert state.ema_step == (1 if ema_init_mode == "reference" else 0)
    for i, batch in enumerate(_batches(3, seed=1)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        got = step(state, _torch_batch(batch))
        for key in METRICS:
            np.testing.assert_allclose(float(got[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
    _assert_states_match(state, jstate)
    if case != "unfused":
        return
    # eval on a padded batch: running stats, probe on view 1, masked means
    batch = dict(_batches(1, seed=5)[0], mask=np.array(
        [1] * 6 + [0] * 2, np.float32))
    want = jax.jit(jax_steps.make_eval_step(jnet, jscfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = torch_steps.make_eval_step(scfg)(state, _torch_batch(batch))
    for key in METRICS + ("_weight",):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   err_msg=key, **TOL)


RAW, AUG_SEED = 40, 13


@pytest.mark.parametrize("fused_augment", [False, True])
def test_three_augmented_steps_match_jax(fused_augment):
    """In-step augmentation from raw uint8 40 px batches to 32 px views,
    the unfused chain or K2's plain version, on JAX's draws of each
    step's ``augment_keys`` (JAX's fused path runs its Pallas kernel in
    interpret mode)."""
    from tests.test_torch_augment import jax_step_views
    kw = dict(PARITY, fused_update=True, augment_in_step=True,
              fused_augment=fused_augment, image_size=SIZE,
              aug_seed=AUG_SEED)
    _, jstate, jstep, _ = _jax_side(False, kw, "reference")
    state, step, _ = _torch_side(False, kw, jstate,
                                 draw_views=jax_step_views(AUG_SEED))
    rng = np.random.RandomState(9)
    for i in range(3):
        batch = {"images": rng.randint(0, 256, (BATCH, RAW, RAW, 3)).astype(
                     np.uint8),
                 "label": rng.randint(0, CLASSES, BATCH).astype(np.int32)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        got = step(state, _torch_batch(batch))
        for key in METRICS:
            np.testing.assert_allclose(float(got[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
    _assert_states_match(state, jstate)


def test_bf16_step_loss_matches_jax():
    kw = dict(fused_update=True, fuse_views=True)
    _, jstate, jstep, _ = _jax_side(True, kw, "copy")
    state, step, _ = _torch_side(True, kw, jstate)
    batch = _batches(1, seed=3)[0]
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = step(state, _torch_batch(batch))
    np.testing.assert_allclose(float(got["loss_mean"]), float(jm["loss_mean"]),
                               rtol=3e-2, atol=3e-2)
    assert state.grads.dtype == torch.float32
    assert torch.count_nonzero(state.grads) > 0


def test_target_forward_leaves_running_stats_and_grads_are_views():
    _, jstate, _, _ = _jax_side(False, dict(fused_update=True), "copy")
    state, step, _ = _torch_side(False, dict(fused_update=True), jstate)
    for name, p in state.net.named_parameters():
        assert p.grad is not None and p.data_ptr() >= state.params.data_ptr()
    stats = {k: v.clone() for k, v in state.batch_stats().items()}
    x = torch.rand(BATCH, SIZE, SIZE, 3)
    with torch.no_grad():
        state.target_net.train()
        state.target_net(x)
    for k, v in state.batch_stats().items():
        assert torch.equal(v, stats[k]), k
    p0, t0 = state.params.clone(), state.target.clone()
    step(state, _torch_batch(_batches(1, seed=7)[0]))
    assert not torch.equal(state.params, p0)
    tau = torch_sched.cosine_ema_decay(0, TOTAL)
    torch.testing.assert_close(state.target, tau * t0 + (1 - tau) *
                               state.params, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("batch,replicas,samples,epochs", [
    (4096, 8, 50_000, 3000), (64, 1, 512, 3), (8, 1, 30, 2),
    (256, 4, 1000, 10), (48, 2, 1000, 7)])
def test_resolve_matches_jax(batch, replicas, samples, epochs):
    def cfg(mod):
        return mod.Config(
            task=mod.TaskConfig(batch_size=batch, epochs=epochs),
            device=mod.DeviceConfig(num_replicas=replicas),
            optim=mod.OptimConfig(fused_update="on"))
    kw = dict(num_train_samples=samples, num_test_samples=samples // 10,
              output_size=10, input_shape=(32, 32, 3), num_valid_samples=33)
    want = jax_config.resolve(cfg(jax_config), **kw)
    got = torch_config.resolve(cfg(torch_config), **kw)
    for field in dataclasses.fields(got):
        if field.name != "cfg":
            assert getattr(got, field.name) == getattr(want, field.name), \
                field.name
    assert dataclasses.asdict(got.cfg) == {
        k: v for k, v in dataclasses.asdict(want.cfg).items()}


def _overridden(mod, overrides):
    cfg = mod.Config()
    for section, values in overrides.items():
        cfg = cfg.replace(**{section: dataclasses.replace(
            getattr(cfg, section), **values)})
    return cfg


RESOLVE_224 = dict(num_train_samples=8192, num_test_samples=10,
                   output_size=10, input_shape=(224, 224, 3))


@pytest.mark.parametrize("overrides", [
    # --zero1 on and --flat-resident on are ported (parallel/), with and
    # without the fused update, and so are remat, the sequence axis and
    # the TP heads; what stays refused: a DCN data axis
    dict(device=dict(dcn_data_parallel=2))])
def test_resolve_refuses_what_is_not_ported(overrides):
    cfg = _overridden(torch_config, overrides)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch_config.resolve(cfg, **RESOLVE_224)


@pytest.mark.parametrize("overrides", [
    dict(model=dict(remat_policy="save_block_out")),
    dict(model=dict(remat_policy="dots")), dict(model=dict(remat=True)),
    dict(device=dict(sequence_parallel=2)),
    dict(device=dict(model_parallel=2))])
def test_resolve_accepts_remat_and_sequence_parallel(overrides):
    want = jax_config.resolve(_overridden(jax_config, overrides),
                              **RESOLVE_224)
    got = torch_config.resolve(_overridden(torch_config, overrides),
                               **RESOLVE_224)
    for field in dataclasses.fields(got):
        if field.name != "cfg":
            assert getattr(got, field.name) == getattr(want, field.name), \
                field.name
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)


def test_losses_metrics_and_schedules_match_jax():
    rng = np.random.RandomState(0)
    x, y = rng.randn(2, 6, 16).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    logits = rng.randn(6, 10).astype(np.float32)
    labels = rng.randint(0, 10, 6)
    t = torch.from_numpy
    for mode in ("paper", "reference"):
        for m in (None, mask):
            want = jax_loss.loss_function(x, y, y, x, norm_mode=mode,
                                          mask=None if m is None else m)
            got = torch_loss.loss_function(t(x), t(y), t(y), t(x),
                                           norm_mode=mode,
                                           mask=None if m is None else t(m))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for m in (None, mask):
        tm = None if m is None else t(m)
        np.testing.assert_allclose(
            float(torch_metrics.cross_entropy(t(logits), t(labels), tm)),
            float(jax_metrics.cross_entropy(logits, labels, m)), rtol=1e-5)
        for got, want in zip(
                torch_metrics.topk_accuracy(t(logits), t(labels), mask=tm),
                jax_metrics.topk_accuracy(logits, labels, mask=m)):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for kind in ("cosine", "fixed"):
        for warmup in (0, 10):
            want = jax_sched.warmup_cosine(0.3, warmup, 100, kind)
            got = torch_sched.warmup_cosine(0.3, warmup, 100, kind)
            stair = torch_sched.epoch_granular(got, 7)
            jstair = jax_sched.epoch_granular(want, 7)
            for c in (0, 1, 5, 10, 11, 57, 99, 100):
                np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6)
                np.testing.assert_allclose(stair(c), float(jstair(c)),
                                           rtol=1e-6)
    for k in (0, 1, 12, 24):
        np.testing.assert_allclose(
            torch_sched.cosine_ema_decay(k, 24, 0.99),
            float(jax_sched.cosine_ema_decay(k, 24, 0.99)), rtol=1e-7)
    assert torch_sched.linear_scaled_lr(0.2, 512, "momentum") == \
        jax_sched.linear_scaled_lr(0.2, 512, "momentum")


CPU_DRIVE = ["--no-cuda", "--task", "fake", "--arch", "resnet18",
             "--image-size-override", "32", "--batch-size", "8", "--epochs",
             "2", "--debug-step", "--no-half", "--fused-update", "on",
             "--warmup", "0", "--head-latent-size", "32",
             "--projection-size", "16"]


def test_cli_trains_on_the_cpu(capsys, tmp_path):
    from byol_tpu_torch.cli import main
    # a fresh --model-dir: the run checkpoints there, and a relaunch in a
    # directory holding its checkpoints would resume and train nothing
    assert main(CPU_DRIVE + ["--model-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    epochs = [line for line in out.splitlines() if line.startswith("epoch ")]
    assert len(epochs) == 2 and all("test loss" in e for e in epochs)
    assert ("loader: data_backend='tf' runs the torch host path" in out
            and out.rstrip().splitlines()[-1].startswith("done: epoch 1"))


def test_cli_without_no_cuda_needs_a_card(capsys):
    from byol_tpu_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for machines without")
    assert main(CPU_DRIVE[1:]) == 2
    assert "--no-cuda" in capsys.readouterr().err


def test_named_streams_are_independent_and_reproducible():
    from byol_tpu_torch.core.rng import split_named
    a = split_named(7, ("params", "weight_init"))
    b = split_named(7, ("weight_init", "params"))
    draw = lambda g: torch.randn(4, generator=g)
    assert torch.equal(draw(a["params"]), draw(b["params"]))
    assert not torch.equal(draw(split_named(7, ("params",))["params"]),
                           draw(split_named(8, ("params",))["params"]))
    assert not torch.equal(draw(a["weight_init"]),
                           draw(split_named(7, ("params",))["params"]))
