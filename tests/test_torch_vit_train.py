"""ViT BYOL training in the port held against the JAX package's step.

A tiny BYOL net over a tiny ViT (width 32, depth 2, 4 heads, patch 8, 32
px; heads 32/16, 10 classes) starts in both packages from ONE JAX
``TrainState`` (``convert.train_state_from_flax``).  Three steps at batch
8 give the same per-step metrics, health vectors (``telemetry='step'``)
and params, target and momentum, fp32 at 1e-4 (another summation order in
every matmul and norm).  The cases cover ``cls`` and ``gap`` pooling, the
fused update (K1a + K1b's plain versions) on and off, and loader and step
placement (K2's plain version, or the unfused chain, on JAX's draws of
each step, JAX's kernel in interpret mode).  JAX's side runs its unfused
chain: the port's fused update is held to the same math (as the health
tests do).  The LARS mask of the ViT's flat layout equals JAX's
``ndim > 1`` leaf for leaf: ``cls_token``, ``pos_embedding`` and the
patch kernel adapted, LayerNorm scales and biases and every bias not.

One leaf is held at 1e-3: the ``cls_token``'s state on the loader case.
It starts at zero (flax's init), so its first LARS trust ratio is 1 and
its later ones divide by a norm that the first update made; both
frameworks' fp32 steps land 2.3e-4 (the port) and 3.2e-4 (JAX) from a
float64 run of the port's step, and 2.4e-4 from each other, while every
other leaf agrees to 1e-4 and the ``pos_embedding`` to 4.2e-7 of
float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.models import vit as jax_vit
from byol_tpu.models.byol_net import BYOLNet as JaxBYOLNet
from byol_tpu.optim.factory import build_optimizer as jax_build_optimizer
from byol_tpu.optim.lars import default_exclusion_mask
from byol_tpu.training import steps as jax_steps
from byol_tpu.training.state import create_train_state as jax_create_state
from byol_tpu_torch.convert import from_flax, train_state_from_flax
from byol_tpu_torch.core.precision import get_policy
from byol_tpu_torch.optim.factory import build_optimizer
from byol_tpu_torch.training import steps as torch_steps
from byol_tpu_torch.training.state import create_train_state, load_converted
from tests.test_torch_train_step import _as_numpy
from tests.torch_ranks import one_torch_thread  # noqa: F401
from tests.torch_ranks import tiny_vit_net

BATCH, SIZE, RAW, CLASSES, HEAD, PROJ = 8, 32, 40, 10, 32, 16
WD, BASE_LR, TOTAL, AUG_SEED = 1e-3, 2.0, 24, 13
METRICS = ("loss_mean", "byol_loss_mean", "linear_loss_mean", "top1_mean",
           "top5_mean")
TOL = dict(rtol=1e-4, atol=1e-4)
# the zero-initialised cls token's state (module docstring)
ILL_CONDITIONED = {"backbone.cls_token": dict(rtol=1e-3, atol=1e-3)}
BASE = dict(norm_mode="reference", normalize_inputs=True, telemetry="step")

# name -> (pooling, port's fused update, placement)
CASES = {
    "cls-unfused-loader": ("cls", False, "loader"),
    "gap-fused-loader": ("gap", True, "loader"),
    "cls-fused-step-k2": ("cls", True, "k2"),
    "gap-unfused-step-chain": ("gap", False, "chain"),
}


def _jax_net(pooling, remat_policy="none"):
    backbone = jax_vit.ViT(width=32, depth=2, num_heads=4, patch_size=8,
                           pooling=pooling, remat_policy=remat_policy)
    return JaxBYOLNet(backbone=backbone, num_classes=CLASSES,
                      head_latent_size=HEAD, projection_size=PROJ)


def _batches(placement, seed=1):
    rng = np.random.RandomState(seed)
    if placement == "loader":
        return [{"view1": rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
                 "view2": rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
                 "label": rng.randint(0, CLASSES, BATCH).astype(np.int32)}
                for _ in range(3)]
    return [{"images": rng.randint(0, 256, (BATCH, RAW, RAW, 3)).astype(
                 np.uint8),
             "label": rng.randint(0, CLASSES, BATCH).astype(np.int32)}
            for _ in range(3)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_vit_steps_match_jax(case):
    run_case(*CASES[case])


def run_case(pooling, fused, placement, remat_policy="none", steps=3):
    """``steps`` steps of both packages from one state, both nets under
    ``remat_policy``, held as the module docstring says."""
    from tests.test_torch_augment import jax_step_views
    kw = dict(BASE)
    if placement != "loader":
        kw.update(augment_in_step=True, image_size=SIZE, aug_seed=AUG_SEED,
                  fused_augment=placement == "k2")
    jnet = _jax_net(pooling, remat_policy)
    variables = jnet.init({"params": jax.random.PRNGKey(0)},
                          jnp.zeros((2, SIZE, SIZE, 3)), train=True,
                          method="warmup")
    jtx, jsched = jax_build_optimizer(
        "lars_momentum", base_lr=BASE_LR, global_batch_size=BATCH,
        weight_decay=WD, total_units=TOTAL, warmup_units=0)
    jstate = jax_create_state(variables, jtx, ema_init_mode="reference")
    jstep = jax.jit(jax_steps.make_train_step(
        jnet, jtx, jax_steps.StepConfig(total_train_steps=TOTAL,
                                        weight_decay=WD, **kw),
        lr_schedule=jsched))

    net = tiny_vit_net(pooling=pooling, remat_policy=remat_policy)
    state = create_train_state(net)
    load_converted(state, train_state_from_flax(_as_numpy(jstate),
                                                like=net.state_dict()))
    # the LARS mask: JAX's ndim > 1, leaf for leaf
    mask = from_flax(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        default_exclusion_mask(variables["params"]), variables["params"]))
    assert {n: bool(a) for n, a in zip(state.names, state.seg.adapted)} == \
        {n: bool(mask[n].flatten()[0]) for n in state.names}
    assert dict(zip(state.names, state.seg.adapted))[
        "backbone.pos_embedding"]
    tx, sched = build_optimizer(
        "lars_momentum", base_lr=BASE_LR, global_batch_size=BATCH,
        weight_decay=WD, total_units=TOTAL, warmup_units=0)
    step = torch_steps.make_train_step(
        tx, torch_steps.StepConfig(total_train_steps=TOTAL,
                                   fused_update=fused, **kw),
        sched, get_policy(False),
        draw_views=(None if placement == "loader"
                    else jax_step_views(AUG_SEED)))
    for i, batch in enumerate(_batches(placement)[:steps]):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        got = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in METRICS:
            np.testing.assert_allclose(float(got[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
        np.testing.assert_allclose(got["health"].numpy(),
                                   np.asarray(jm["health"]),
                                   err_msg=f"step {i} health", **TOL)
    want = train_state_from_flax(_as_numpy(jstate))
    for key, buf in (("params", state.params), ("momentum", state.momentum),
                     ("target", state.target)):
        for name, got in state.tree(buf).items():
            np.testing.assert_allclose(got.numpy(), want[key][name].numpy(),
                                       err_msg=f"{key} {name}",
                                       **ILL_CONDITIONED.get(name, TOL))
    assert (state.count, state.step, state.ema_step) == (
        want["count"], want["step"], want["ema_step"])
