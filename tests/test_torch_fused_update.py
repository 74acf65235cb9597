"""K1 (the fused LARS+EMA update) held against the JAX package.

On the CPU the wrappers run the kernels' plain versions; both the fused
plain path and the port's unfused lars_momentum chain are held against the
JAX Pallas kernels (``fused_lars_ema_update(..., interpret=True)``) and
against the optax lars_momentum chain plus the EMA tick, on one tree of
1-D, 2-D and 4-D leaves, for both EMA modes.  Tolerance 1e-5 (fp32 norms
summed in another order).  The kernels themselves run only on a card: the
``cuda`` test holds them against the plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byol_tpu.ops import fused_update as jax_fused
from byol_tpu.optim.factory import (MOMENTUM_DECAY, build_optimizer,
                                    extract_sgdm_state, replace_sgdm_state)
from byol_tpu_torch.ops import fused_update as fused_lib
from byol_tpu_torch.optim import lars as lars_lib

WD, TAU = 1e-4, 0.99
COUNT = 30                       # a schedule position past the warmup
TOL = dict(rtol=1e-5, atol=1e-6)


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"conv": (3, 3, 4, 8), "bias": (10,),
              "head": {"kernel": (8, 130), "scale": (8,)},
              "zero": {"kernel": (4, 4)}}     # an all-zero leaf: ratio 1
    draw = lambda s, k: (k * rng.randn(*s)).astype(np.float32)
    params = jax.tree_util.tree_map(lambda s: draw(s, 0.1), shapes,
                                    is_leaf=lambda x: isinstance(x, tuple))
    params["zero"]["kernel"][:] = 0.0
    others = [jax.tree_util.tree_map(lambda p: draw(p.shape, k), params)
              for k in (0.01, 0.05, 0.1)]
    return params, *others                   # params, grads, momentum, target


def _leaves(tree):
    return [torch.from_numpy(np.array(x)) for x in
            jax.tree_util.tree_leaves(tree)]


def _jax_chain():
    return build_optimizer("lars_momentum", base_lr=0.2,
                           global_batch_size=256, weight_decay=WD,
                           total_units=100, warmup_units=10)


LR = float(_jax_chain()[1](COUNT))


def _jax_optax_chain(params, grads, momentum, target, ema_pre):
    tx, _ = _jax_chain()
    st = replace_sgdm_state(tx.init(params), momentum,
                            jnp.asarray(COUNT, jnp.int32))
    updates, st = tx.update(grads, st, params)
    new_p = optax.apply_updates(params, updates)
    src = params if ema_pre else new_p
    new_t = jax.tree_util.tree_map(lambda t, p: TAU * t + (1 - TAU) * p,
                                   target, src)
    return new_p, extract_sgdm_state(st)[0], new_t


def _close(got_list, want_tree, what):
    for got, want in zip(got_list, jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=what, **TOL)


@pytest.mark.parametrize("ema_pre", [False, True])
def test_plain_versions_match_jax_kernels_and_optax_chain(ema_pre):
    params, grads, momentum, target = _tree()
    jp, jm, jt, jtrust = jax_fused.fused_lars_ema_update(
        params, grads, momentum, target, lr=LR, tau=TAU, weight_decay=WD,
        momentum_decay=MOMENTUM_DECAY, ema_pre=ema_pre, interpret=True)
    op, om, ot = _jax_optax_chain(params, grads, momentum, target, ema_pre)

    # the fused path (plain versions of K1a + K1b on the CPU), on the four
    # trees packed into the flat layout as JAX's transient path packs them
    leaves = _leaves(params)
    seg = fused_lib.segment_map_for(leaves)
    bufs = [fused_lib.pack_flat(_leaves(x), seg)
            for x in (params, grads, momentum, target)]
    trust = fused_lib.fused_lars_ema_update_buffers(
        *bufs, fused_lib.FusedLayout.build(seg, WD, "cpu"), lr=LR, tau=TAU,
        momentum_decay=MOMENTUM_DECAY, ema_pre=ema_pre)
    p, _, m, t = (fused_lib.unpack_flat(b, seg, [x.shape for x in leaves])
                  for b in bufs)
    # the unfused chain + EMA tick, on its own copies
    up, ug, um, ut = (_leaves(x) for x in (params, grads, momentum, target))
    old = [x.clone() for x in up]
    utrust = lars_lib.lars_momentum_update(
        up, ug, um, lr=LR, weight_decay=WD, momentum_decay=MOMENTUM_DECAY,
        adapted=lars_lib.default_exclusion_mask(up))
    for tt, src in zip(ut, old if ema_pre else up):
        tt.mul_(TAU).add_(src, alpha=1 - TAU)

    for name, (gp, gm, gt) in {"fused": (p, m, t),
                               "unfused": (up, um, ut)}.items():
        for want in ((jp, jm, jt), (op, om, ot)):
            _close(gp, want[0], f"{name} params")
            _close(gm, want[1], f"{name} momentum")
            _close(gt, want[2], f"{name} target")
    np.testing.assert_allclose(trust.numpy(), np.asarray(jtrust), **TOL)
    np.testing.assert_allclose(utrust.numpy(), np.asarray(jtrust), **TOL)
    assert trust.shape == (3,)      # conv, head kernel, zero kernel
    assert trust[-1].item() == 1.0  # zero param norm -> ratio 1


def test_segment_map_tiles_the_buffer_and_padding_stays_inert():
    params, grads, momentum, target = _tree(1)
    leaves = _leaves(params)
    seg = fused_lib.segment_map_for(leaves)
    assert seg.adapted == (False, True, True, False, True)
    assert all(p % 128 == 0 and p - s < 128
               for s, p in zip(seg.sizes, seg.padded))
    assert all(seg.starts[i + 1] == seg.starts[i] + seg.padded[i]
               for i in range(seg.num_segments - 1))
    assert sum(seg.padded) == seg.total == 128 * seg.num_rows
    ids = seg.row_segment_ids()
    assert ids.shape == (seg.num_rows,) and (np.diff(ids) >= 0).all()

    bufs = [fused_lib.pack_flat(_leaves(x), seg)
            for x in (params, grads, momentum, target)]
    pad = torch.ones(seg.total, dtype=torch.bool)
    for start, size in zip(seg.starts, seg.sizes):
        pad[start:start + size] = False
    layout = fused_lib.FusedLayout.build(seg, WD, "cpu")
    for _ in range(2):
        fused_lib.fused_lars_ema_update_buffers(
            *bufs, layout, lr=LR, tau=TAU, momentum_decay=MOMENTUM_DECAY)
    for buf in bufs:
        assert torch.count_nonzero(buf[pad]) == 0
    back = fused_lib.unpack_flat(bufs[0], seg, [x.shape for x in leaves])
    assert [tuple(b.shape) for b in back] == [tuple(x.shape) for x in leaves]
    assert back[0].data_ptr() == bufs[0].data_ptr()       # views, no copy


def test_wrappers_refuse_bad_buffers():
    leaves = _leaves(_tree()[0])
    seg = fused_lib.segment_map_for(leaves)
    layout = fused_lib.FusedLayout.build(seg, WD, "cpu")
    p = fused_lib.pack_flat(leaves, seg)
    with pytest.raises(ValueError, match="fp32"):
        fused_lib.segment_norms(p.double(), p.double(), layout)
    with pytest.raises(ValueError, match="elements"):
        fused_lib.segment_norms(p[:-128], p[:-128], layout)
    with pytest.raises(ValueError, match="scale"):
        fused_lib.fused_apply(p, p, p.clone(), p.clone(),
                              torch.ones(2), layout, lr=LR, tau=TAU,
                              momentum_decay=MOMENTUM_DECAY, ema_pre=False)
    with pytest.raises(ValueError, match="empty segment"):
        fused_lib.build_segment_map([4, 0], [True, False])


@pytest.mark.cuda
@pytest.mark.parametrize("ema_pre", [False, True])
def test_kernels_match_plain_versions_on_the_card(ema_pre):
    """K1a and K1b against their plain versions; K1a bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(the plain versions are tested above)")
    sizes = [3 * 3 * 64 * 64, 64, 2048 * 512, 512, 1000 * 2048, 1000]
    seg = fused_lib.build_segment_map(sizes, [s > 1000 for s in sizes])
    gen = torch.Generator(device="cuda").manual_seed(0)
    p, g, m, t = (torch.randn(seg.total, device="cuda", generator=gen)
                  * k for k in (0.1, 0.01, 0.05, 0.1))
    layout = fused_lib.FusedLayout.build(seg, WD, "cuda")
    scale, norms = fused_lib.segment_norms(p, g, layout)
    scale2, norms2 = fused_lib.segment_norms(p, g, layout)
    assert torch.equal(scale, scale2) and torch.equal(norms, norms2)
    ref_scale, ref_norms = fused_lib.segment_norms_reference(p, g, layout)
    torch.testing.assert_close(scale, ref_scale, **TOL)
    torch.testing.assert_close(norms, ref_norms, **TOL)
    ref = [x.clone() for x in (p, g, m, t)]
    fused_lib.fused_apply(p, g, m, t, scale, layout, lr=LR, tau=TAU,
                          momentum_decay=MOMENTUM_DECAY, ema_pre=ema_pre)
    fused_lib.fused_apply_reference(*ref, scale, layout, lr=LR, tau=TAU,
                                    momentum_decay=MOMENTUM_DECAY,
                                    ema_pre=ema_pre)
    torch.cuda.synchronize()
    for got, want in zip((p, m, t), (ref[0], ref[2], ref[3])):
        torch.testing.assert_close(got, want, **TOL)
