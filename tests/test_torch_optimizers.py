"""The port's optimizer registry held against the JAX package's (optax).

Every one of the 14 registry names at clip 0, and sgd, adam,
lars_momentum and lars_lamb at clip > 0, takes 3 steps on one seeded
tree of 4-D, 2-D and 1-D leaves with two all-zero leaves (one whose
gradient is zero too, one whose gradient is not), so that LARS's and
LAMB's zero-norm branches run.  The port's chain runs on the tree packed
into flat buffers (``optim/transforms.py``; the split K1a's plain versions
give LARS and LAMB their norms), JAX's is
``byol_tpu.optim.factory.build_optimizer``'s optax chain on the tree.
After each step the params, and after the last every optimizer-state
tree and count, must agree: fp32 rtol 1e-5, atol 1e-7 for the
elementwise chains (rmsprop, adam, adadelta, sgd, momentum, bare), rtol
1e-4, atol 1e-7 for the chains with norms or dots (every lars_*, lamb,
lbfgs), whose norms the two packages sum in other orders.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from byol_tpu.optim.factory import build_optimizer as jax_build_optimizer
from byol_tpu_torch.ops import fused_update as fused_lib
from byol_tpu_torch.optim import factory, transforms

WD, BASE_LR, BATCH, TOTAL = 1e-2, 1e-2, 512, 10
ELEMENTWISE = ("rmsprop", "adam", "adadelta", "sgd", "momentum")
NAMES = [p + b for p in ("", "lars_") for b in transforms.BASES]
CLIPPED = ("sgd", "adam", "lars_momentum", "lars_lamb")
CLIP = 0.05
STEPS = 3


def tolerance(name):
    if name in ELEMENTWISE:
        return dict(rtol=1e-5, atol=1e-7)
    return dict(rtol=1e-4, atol=1e-7)


SHAPES = {"conv": (3, 3, 4, 8), "dense": (12, 10), "bias": (10,),
          "bn_scale": (7,), "zero": (4, 6), "zero_init": (5, 3)}


def seeded_tree(seed=0):
    """-> (names, params, per-step gradients), numpy fp32."""
    rng = np.random.RandomState(seed)
    names = sorted(SHAPES)
    params = {n: (0.5 * rng.randn(*SHAPES[n])).astype(np.float32)
              for n in names}
    params["zero"][:] = 0.0
    params["zero_init"][:] = 0.0
    grads = []
    for _ in range(STEPS):
        g = {n: (0.1 * rng.randn(*SHAPES[n])).astype(np.float32)
             for n in names}
        g["zero"][:] = 0.0
        grads.append(g)
    return names, params, grads


def optax_fields(opt_state):
    """{port field name: leaf tree or count} out of an optax chain state,
    located by node type."""
    out = {}

    def walk(node):
        if isinstance(node, optax.TraceState):
            out["momentum"] = node.trace
        elif isinstance(node, optax.ScaleByAdamState):
            out.update(mu=node.mu, nu=node.nu, count=int(node.count))
        elif isinstance(node, optax.ScaleByRmsState):
            out["nu"] = node.nu
        elif isinstance(node, optax.ScaleByAdaDeltaState):
            out.update(e_g=node.e_g, e_x=node.e_x)
        elif isinstance(node, optax.ScaleByLBFGSState):
            for name in node._fields:
                value = getattr(node, name)
                out[transforms.FROM_OPTAX.get(name, name)] = (
                    int(value) if name == "count" else value)
        elif isinstance(node, tuple):
            for child in node:
                walk(child)

    walk(opt_state)
    return jax.device_get(out)


def run_jax(name, clip, params, grads):
    tx, _ = jax_build_optimizer(name, base_lr=BASE_LR,
                                global_batch_size=BATCH, weight_decay=WD,
                                total_units=TOTAL, warmup_units=0,
                                clip=clip)
    st = tx.init(params)
    history = []
    for g in grads:
        updates, st = tx.update(g, st, params)
        params = optax.apply_updates(params, updates)
        history.append(jax.device_get(params))
    return history, optax_fields(st)


class FlatTree:
    """The tree's leaves packed into a flat buffer in the segment layout."""

    def __init__(self, names, like):
        self.names = names
        self.shapes = [like[n].shape for n in names]
        self.seg = fused_lib.build_segment_map(
            [int(np.prod(s)) for s in self.shapes],
            [len(s) > 1 for s in self.shapes])

    def pack(self, tree, dtype=torch.float32):
        return fused_lib.pack_flat(
            [torch.from_numpy(np.asarray(tree[n])) for n in self.names],
            self.seg).to(dtype)

    def unpack(self, buf):
        return dict(zip(self.names, fused_lib.unpack_flat(
            buf, self.seg, self.shapes)))


def run_port(name, clip, names, params, grads):
    chain, sched = factory.build_optimizer(
        name, base_lr=BASE_LR, global_batch_size=BATCH, weight_decay=WD,
        total_units=TOTAL, warmup_units=0, clip=clip)
    flat = FlatTree(names, params)
    layout = fused_lib.FusedLayout.build(flat.seg, WD, "cpu")
    p = flat.pack(params)
    bufs, counts = chain.init(p)
    history, trusts = [], []
    for step, g in enumerate(grads):
        u, trust = chain.update(p, flat.pack(g), bufs, counts,
                                lr=sched(step), layout=layout)
        p.add_(u)
        history.append(flat.unpack(p.clone()))
        trusts.append(trust)
    return flat, history, bufs, counts, trusts


def assert_state_matches(flat, bufs, counts, want, tol, name):
    got_fields = {f for f, _ in transforms.STATE_FIELDS[
        name.split("_")[-1]]} | set(counts)
    assert got_fields == set(want), (got_fields, set(want))
    for field, value in want.items():
        if field in counts:
            assert counts[field] == value, field
            continue
        buf = bufs[field]
        if buf.dim() == 1 and buf.numel() == transforms.LBFGS_MEMORY:
            np.testing.assert_allclose(buf.numpy(), value, err_msg=field,
                                       **tol)
            continue
        rows = buf if buf.dim() == 2 else buf[None]
        for k, row in enumerate(rows):
            for leaf, got in flat.unpack(row).items():
                ref = np.asarray(value[leaf])
                ref = ref[k] if buf.dim() == 2 else ref
                np.testing.assert_allclose(got.numpy(), ref,
                                           err_msg=f"{field}[{k}] {leaf}",
                                           **tol)


CASES = [(n, 0.0) for n in NAMES] + [(n, CLIP) for n in CLIPPED]


@pytest.mark.parametrize("name,clip", CASES,
                         ids=[f"{n}-clip{c}" for n, c in CASES])
def test_chain_matches_optax(name, clip):
    names, params, grads = seeded_tree()
    want_hist, want_state = run_jax(name, clip, params, grads)
    flat, got_hist, bufs, counts, trusts = run_port(name, clip, names,
                                                    params, grads)
    tol = tolerance(name)
    for step, (got, want) in enumerate(zip(got_hist, want_hist)):
        for leaf in names:
            np.testing.assert_allclose(got[leaf].numpy(), want[leaf],
                                       err_msg=f"step {step} {leaf}", **tol)
    assert_state_matches(flat, bufs, counts, want_state, tol, name)
    # the all-zero leaf with a zero gradient never moves
    assert not got_hist[-1]["zero"].any()
    if name.startswith("lars_"):
        # one ratio per adapted leaf (conv, dense, zero, zero_init), 1 on
        # the zero leaves
        assert trusts[0].shape == (4,)
        assert trusts[0][names.index("zero") - 2] == 1.0
    else:
        assert torch.equal(trusts[0], torch.ones(1))


def test_sgd_and_momentum_scale_the_lr_and_the_rest_do_not():
    for name in NAMES:
        _, sched = factory.build_optimizer(
            name, base_lr=BASE_LR, global_batch_size=BATCH,
            weight_decay=WD, total_units=TOTAL, warmup_units=0)
        _, jsched = jax_build_optimizer(
            name, base_lr=BASE_LR, global_batch_size=BATCH,
            weight_decay=WD, total_units=TOTAL, warmup_units=0)
        scaled = name.split("_")[-1] in ("sgd", "momentum")
        assert sched(0) == pytest.approx(BASE_LR * (2.0 if scaled else 1.0))
        for count in (0, 3, 9):
            assert sched(count) == float(jsched(count)), (name, count)


@pytest.mark.parametrize("name,match", [
    ("lars", "bare 'lars'"), ("LARS ", "bare 'lars'"),
    ("adagrad", "unknown optimizer 'adagrad'"),
    ("lars_adagrad", "unknown optimizer 'adagrad'")])
def test_refuses_what_jax_refuses(name, match):
    kw = dict(base_lr=BASE_LR, global_batch_size=BATCH, weight_decay=WD,
              total_units=TOTAL, warmup_units=0)
    with pytest.raises(ValueError, match=match):
        jax_build_optimizer(name, **kw)
    with pytest.raises(ValueError, match=match):
        factory.build_optimizer(name, **kw)


@pytest.mark.parametrize("name,clip", [("adam", 0.0), ("lars_adam", 0.0),
                                       ("momentum", 0.0),
                                       ("lars_momentum", 0.1)])
def test_fused_update_refuses_every_other_chain(name, clip):
    """Only lars_momentum at clip 0 is what K1a + K1b compute: the reason
    is the JAX gate's, resolve() refuses with it, and so does the step."""
    import dataclasses

    from byol_tpu.optim.factory import \
        fused_update_unsupported_reason as jax_reason
    from byol_tpu_torch.core import config as torch_config
    from byol_tpu_torch.training import steps as torch_steps
    reason = factory.fused_update_unsupported_reason(name, clip)
    assert reason is not None and reason == jax_reason(name, clip)
    assert factory.fused_update_unsupported_reason("lars_momentum") is None
    cfg = torch_config.Config()
    cfg = cfg.replace(optim=dataclasses.replace(
        cfg.optim, optimizer=name, clip=clip, fused_update="on"))
    with pytest.raises(ValueError, match="--fused-update on"):
        torch_config.resolve(cfg, num_train_samples=8192,
                             num_test_samples=10, output_size=10,
                             input_shape=(224, 224, 3))
    chain, sched = factory.build_optimizer(
        name, base_lr=BASE_LR, global_batch_size=BATCH, weight_decay=WD,
        total_units=TOTAL, warmup_units=0, clip=clip)
    with pytest.raises(ValueError, match="fused_update"):
        torch_steps.make_train_step(chain, torch_steps.StepConfig(
            total_train_steps=TOTAL, fused_update=True,
            lars_in_chain=factory.is_lars_optimizer(name)), sched)


def test_reduce_hook_sees_every_cross_element_sum():
    """Two halves of the buffer updated separately, in two threads whose
    ``reduce`` adds both halves' sums (a two-rank world), give the whole
    buffer's update: the sharded update's contract, for the chains with
    norms or dots."""
    names, params, grads = seeded_tree(3)
    for name in ("lars_adam", "lamb", "lbfgs", "lars_lbfgs"):
        chain, sched = factory.build_optimizer(
            name, base_lr=BASE_LR, global_batch_size=BATCH,
            weight_decay=WD, total_units=TOTAL, warmup_units=0)
        flat = FlatTree(names, params)
        rows = flat.seg.num_rows
        whole = fused_lib.FusedLayout.build(flat.seg, WD, "cpu")
        halves = [fused_lib.FusedLayout.build(flat.seg, WD, "cpu", lo, hi)
                  for lo, hi in ((0, rows // 2), (rows // 2, rows))]
        cut = [slice(h.row_lo * 128, (h.row_lo + h.rows) * 128)
               for h in halves]
        kinds = dict(chain.state_fields)
        p = flat.pack(params)
        st, counts = chain.init(p)
        ps = [p[c].clone() for c in cut]
        sts = [{k: (v.clone() if kinds[k] == "vector" else
                    v[..., c].clone()) for k, v in st.items()} for c in cut]
        cs = [dict(counts), dict(counts)]
        for step, gt in enumerate(grads):
            g = flat.pack(gt)
            u, _ = chain.update(p, g, st, counts, lr=sched(step),
                                layout=whole)
            p.add_(u)
            outs = _lockstep_halves(chain, ps, [g[c] for c in cut], sts,
                                    cs, halves, sched(step))
            for half, (uh, _) in zip(ps, outs):
                half.add_(uh)
            np.testing.assert_allclose(torch.cat(ps).numpy(), p.numpy(),
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f"{name} step {step}")


def _lockstep_halves(chain, ps, gs, sts, cs, halves, lr):
    """Both halves' updates with the reduce of a two-rank world: each
    reduce waits for the other half's contribution (threads)."""
    import threading
    barrier = threading.Barrier(2)
    slots = [None, None]
    out = [None, None]
    errors = []

    def reduce_for(me):
        def reduce(x):
            slots[me] = x.clone()
            barrier.wait()
            total = slots[0] + slots[1]
            barrier.wait()
            x.copy_(total)
            return x
        return reduce

    def run(me):
        try:
            out[me] = chain.update(ps[me], gs[me], sts[me], cs[me], lr=lr,
                                   layout=halves[me],
                                   reduce=reduce_for(me))
        except BaseException as e:     # surfaced in the test's thread
            errors.append(e)
            barrier.abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    return out
