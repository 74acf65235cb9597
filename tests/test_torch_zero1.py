"""ZeRO-1 in the port (parallel/zero1.py, the split K1a of
ops/fused_update.py), held against its unsharded update.

The layout cases run in this process at worlds 2 and 4 (each rank's range
computed in turn, the all-reduce of the float64 sums done by hand): the
ranges tile the buffer, the ranks' plain sums add up to the whole
buffer's, the trust vector and the update are the whole-buffer ones.  The
data-parallel cases start two ranks as OS processes over gloo
(tests/torch_ranks.py): ``--zero1 on`` trains the tiny net to the state
and health vectors of ``--zero1 off`` at rtol 1e-5 (JAX's own bar for its
ZeRO-1 path, tests/test_zero1.py), with and without Polyak averaging and
with the bucketed gather of ``--flat-resident on``; a bucketed gather
equals the whole-buffer one; and a checkpoint written by a two-rank
``--zero1 on`` fit restores at world 1 with ``--zero1 off`` to the state
the fit ended with.  The same holds for the unfused chains of the
optimizer registry (lars_momentum, lars_adam, lamb, lbfgs with --clip):
their every cross-element sum is all-reduced, and ``--zero1 on`` gives
``--zero1 off``'s state, optimizer state included, at rtol 1e-5; a
two-rank lbfgs ZeRO-1 checkpoint restores at one rank without ZeRO-1,
lbfgs's memories included, bit for bit.
"""
import glob
import os

import numpy as np
import pytest
import torch

from byol_tpu_torch.checkpoint.checkpointer import CheckpointStore
from byol_tpu_torch.cli import build_parser, config_from_args
from byol_tpu_torch.core.config import resolve
from byol_tpu_torch.ops import fused_update as fu
from byol_tpu_torch.parallel import zero1 as zero1_lib
from byol_tpu_torch.parallel.flat_state import plan_buckets
from byol_tpu_torch.training.build import setup_training
from byol_tpu_torch.training.state import canonical_state, load_canonical
from tests.test_torch_accum import _batches
from tests.test_torch_ddp_step import assert_trees_equal, tree_keys
from tests.torch_ranks import run_ranks, seeded_tree, tiny_net
from tests.torch_ranks import one_torch_thread  # noqa: F401

# odd sizes: segments cut by the ranks' ranges, a row-count not divisible
# by the world, excluded (bias-like) segments among them
SIZES = [3 * 128 + 5, 17, 9 * 128, 260, 4 * 128 + 1, 33, 7 * 128 + 100]
ADAPTED = [True, False, True, False, True, False, True]
RTOL = dict(rtol=1e-5, atol=1e-7)


def _layout_case(world, seed=0):
    seg = fu.build_segment_map(SIZES, ADAPTED)
    gen = torch.Generator().manual_seed(seed)
    real = torch.zeros(seg.total, dtype=torch.bool)
    for start, size in zip(seg.starts, seg.sizes):
        real[start:start + size] = True
    p, g, m, t = (torch.randn(seg.total, generator=gen) * real * k
                  for k in (0.05, 1e-3, 1e-3, 0.05))
    ranges = [zero1_lib.rank_rows(seg.num_rows, world, r)
              for r in range(world)]
    return seg, p, g, m, t, [fu.FusedLayout.build(seg, 1e-4, "cpu", lo, hi)
                             for lo, hi in ranges]


@pytest.mark.parametrize("world", [2, 4])
def test_rank_ranges_tile_the_buffer(world):
    seg, *_, layouts = _layout_case(world)
    rows = []
    for lay in layouts:
        rows.extend(range(lay.row_lo, lay.row_lo + lay.rows))
        # local segments: in order, clipped to the range, global ids
        starts = lay.seg_row_start.tolist()
        assert starts[0] == 0 and starts[-1] == lay.rows
        for i, s in enumerate(lay.seg_ids.tolist()):
            seg_rows = lay.row_seg[starts[i]:starts[i + 1]].tolist()
            assert seg_rows and set(seg_rows) == {s}
    assert rows == list(range(seg.num_rows))
    assert zero1_lib.padded_rows(seg.num_rows, world) % world == 0


@pytest.mark.parametrize("world", [1, 2, 4])
def test_rank_sums_add_up_and_give_the_one_rank_update(world):
    seg, p, g, m, t, layouts = _layout_case(world)
    full = fu.FusedLayout.build(seg, 1e-4, "cpu")
    want_sums = fu.segment_sums_reference(p, g, full)
    sums = [fu.segment_sums_reference(p[lay.row_lo * 128:][:lay.total],
                                      g[lay.row_lo * 128:][:lay.total], lay)
            for lay in layouts]
    total = torch.stack(sums).sum(0)
    np.testing.assert_allclose(total.numpy(), want_sums.numpy(), rtol=1e-12)
    want_scale, _ = fu.segment_norms_reference(p, g, full)
    scale, _ = fu.segment_epilogue_reference(total, full)
    np.testing.assert_allclose(scale.numpy(), want_scale.numpy(), rtol=1e-6)
    if world == 1:
        # one rank's split path is the fused path, bit for bit
        assert torch.equal(scale, want_scale)
    # the whole update, rank by rank, the sums' all-reduce done by hand
    kw = dict(lr=0.3, tau=0.99, momentum_decay=0.9, ema_pre=False)
    want = [x.clone() for x in (p, m, t)]
    want_trust = fu.fused_lars_ema_update_buffers(
        want[0], g, want[1], want[2], full, **kw)
    got = [x.clone() for x in (p, m, t)]
    for lay in layouts:
        sl = slice(lay.row_lo * 128, lay.row_lo * 128 + lay.total)
        trust = fu.fused_lars_ema_update_zero1(
            got[0][sl], g[sl], got[1][sl], got[2][sl], lay,
            all_reduce=lambda _: total, **kw)
        np.testing.assert_allclose(trust.numpy(), want_trust.numpy(),
                                   rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_plan_buckets_keeps_segments_whole():
    seg = fu.build_segment_map([300_000, 50_000, 400_000, 10_000, 260_000],
                               [True] * 5)
    buckets = plan_buckets(seg, 1)
    assert [b[2] for b in buckets] == [(0,), (1,), (2,), (3,), (4,)]
    assert buckets[0][0] == 0 and buckets[-1][1] == seg.num_rows
    assert all(a[1] == b[0] for a, b in zip(buckets, buckets[1:]))
    assert plan_buckets(seg, 64) == ((0, seg.num_rows, (0, 1, 2, 3, 4)),)
    with pytest.raises(ValueError):
        plan_buckets(seg, 0)


def test_bucketed_gather_equals_the_whole_buffer_gather(tmp_path):
    sizes = [300_000, 50_000, 400_000, 10_000, 260_000]
    ranks = run_ranks("gather", dict(sizes=sizes, bucket_mb=1), 2, tmp_path)
    real = ranks[0]["real"]
    for out in ranks:
        assert out["buckets"] == 5
        # the buckets cover the segments; the padding rows past them stay
        # zeros in a train state, which needs no collective
        assert torch.equal(out["whole"][:real], out["bucketed"][:real])
        assert torch.equal(out["whole"], ranks[0]["whole"])
    per = ranks[0]["whole"].numel() // 2
    for r in range(2):
        assert torch.equal(ranks[0]["whole"][r * per:(r + 1) * per],
                           torch.arange(per, dtype=torch.float32)
                           + 1e6 * (r + 1))


def _train_spec(polyak):
    from tests.test_torch_ddp_step import _as_numpy, _jax_side
    from byol_tpu_torch.convert import train_state_from_flax
    scfg = dict(normalize_inputs=True, norm_mode="reference",
                fused_update=True, telemetry="step")
    if polyak:
        scfg["polyak_ema"] = 0.9
    _, jstate, _, _ = _jax_side(False, dict(scfg, telemetry="off"),
                                "reference", polyak_ema=polyak and 0.9)
    converted = train_state_from_flax(_as_numpy(jstate),
                                      like=tiny_net().state_dict())
    return dict(converted=converted, scfg=scfg,
                batches=_batches("views", 3, 21, 32))


@pytest.mark.parametrize("polyak", [False, True])
def test_zero1_on_equals_off_at_two_ranks(polyak, tmp_path):
    spec = _train_spec(polyak)
    out = {}
    for name, plan in (("off", {}), ("on", dict(zero1=True)),
                       ("resident", dict(zero1=True, flat_resident=True,
                                         bucket_mb=1))):
        out[name] = run_ranks("train", dict(spec, plan=plan), 2,
                              tmp_path / name)
    total = sum(v.numel() for v in out["off"][0]["state"]["params"].values())
    # ZeRO-1 keeps half the (padded) momentum a rank
    assert out["on"][0]["momentum_numel"] < out["off"][0]["momentum_numel"]
    assert out["on"][0]["momentum_numel"] * 2 >= total
    ref = out["off"][0]
    for name in ("on", "resident"):
        assert_trees_equal(out[name][0]["state"], out[name][1]["state"])
        for key in ("params", "momentum", "target", "batch_stats") + (
                ("polyak",) if polyak else ()):
            for leaf, value in out[name][0]["state"][key].items():
                np.testing.assert_allclose(
                    value.numpy(), ref["state"][key][leaf].numpy(),
                    err_msg=f"{name} {key} {leaf}", **RTOL)
        for step, (got, want) in enumerate(zip(out[name][0]["metrics"],
                                                ref["metrics"])):
            np.testing.assert_allclose(got["health"], want["health"],
                                       err_msg=f"{name} step {step}",
                                       **RTOL)
            assert got["loss_mean"] == pytest.approx(want["loss_mean"],
                                                     rel=1e-6)


ARGV = ["--no-cuda", "--task", "fake", "--arch", "resnet18",
        "--image-size-override", "16", "--batch-size", "16", "--epochs", "1",
        "--debug-step", "--no-half", "--fused-update", "on", "--warmup", "0",
        "--head-latent-size", "32", "--projection-size", "16",
        "--workers-per-replica", "0", "--grapher", "jsonl"]


def test_two_rank_zero1_checkpoint_restores_at_one_rank(tmp_path):
    model_dir, log_dir = tmp_path / "models", tmp_path / "logs"
    argv = ARGV + ["--zero1", "on", "--model-dir", str(model_dir),
                   "--log-dir", str(log_dir)]
    ranks = run_ranks("fit_cli", dict(argv=argv), 2, tmp_path)
    assert_trees_equal(ranks[0]["state"], ranks[1]["state"])
    (run_dir,) = glob.glob(str(model_dir / "*"))
    # rank 0 alone wrote the log: its header names the plan
    from byol_tpu_torch.observability.events import read_events
    (log,) = glob.glob(str(log_dir / "*" / "run.jsonl"))
    header = next(read_events(log))
    assert header["sharding_plan"]["zero1"] == "on"
    assert header["sharding_plan"]["mesh_shape"]["data"] == 2
    assert header["n_devices"] == 2
    # the checkpoint at world 1, --zero1 off
    cfg = config_from_args(build_parser().parse_args(
        ARGV + ["--model-dir", str(tmp_path / "w1")]))
    rcfg = resolve(cfg, num_train_samples=512, num_test_samples=128,
                   output_size=10, input_shape=(16, 16, 3))
    _, state, _, _, _ = setup_training(rcfg, "cpu")
    store = CheckpointStore(run_dir)
    tree, _ = store.restore(best=False)
    store.close()
    load_canonical(state, tree)
    assert state.zero1 is None
    assert_trees_equal(canonical_state(state), ranks[0]["state"])
    assert not os.path.exists(tmp_path / "w1")


# (optimizer, clip, base lr): the unfused chains under ZeRO-1
CHAINS = [("lars_momentum", 0.0, 2.0), ("lars_adam", 0.0, 2.0),
          ("lamb", 0.0, 0.01), ("lbfgs", 0.01, 0.01)]


@pytest.mark.parametrize("optimizer,clip,base_lr", CHAINS,
                         ids=[c[0] for c in CHAINS])
def test_unfused_chain_zero1_on_equals_off_at_two_ranks(optimizer, clip,
                                                        base_lr, tmp_path):
    spec = dict(canonical=seeded_tree(optimizer), optimizer=optimizer,
                clip=clip, base_lr=base_lr,
                scfg=dict(normalize_inputs=True, norm_mode="reference",
                          fused_update=False, telemetry="step"),
                batches=_batches("views", 3, 21, 32))
    out = {name: run_ranks("train", dict(spec, plan=plan), 2,
                           tmp_path / name)
           for name, plan in (("off", {}), ("on", dict(zero1=True)))}
    on, off = out["on"][0], out["off"][0]
    assert_trees_equal(on["state"], out["on"][1]["state"])
    # every buffer of the optimizer's state but a vector lives on the
    # rank's range
    for name, n in on["opt_numel"].items():
        if name != "weights_memory":
            assert n * 2 >= off["opt_numel"][name] > n, name
    assert on["state"]["opt_counts"] == off["state"]["opt_counts"]
    for key in tree_keys(off["state"]):
        want = off["state"][key]
        got = on["state"][key]
        for leaf, value in (want.items() if isinstance(want, dict)
                            else [(key, want)]):
            np.testing.assert_allclose(
                (got[leaf] if isinstance(got, dict) else got).numpy(),
                value.numpy(), err_msg=f"{key} {leaf}", **RTOL)
    for step, (g, w) in enumerate(zip(on["metrics"], off["metrics"])):
        assert np.isfinite(w["health"]).all()
        np.testing.assert_allclose(g["health"], w["health"],
                                   err_msg=f"step {step}", **RTOL)
        assert g["loss_mean"] == pytest.approx(w["loss_mean"], rel=1e-6)


def test_two_rank_lbfgs_zero1_checkpoint_restores_at_one_rank(tmp_path):
    """The tiny net's lbfgs state under ZeRO-1 at two ranks, checkpointed
    by rank 0 after 3 steps (its memories gathered from both ranges),
    restores into a one-rank state without ZeRO-1 bit for bit."""
    from tests.torch_ranks import tiny_state
    spec = dict(canonical=seeded_tree("lbfgs"), optimizer="lbfgs",
                clip=0.01, base_lr=0.01, plan=dict(zero1=True),
                scfg=dict(normalize_inputs=True, norm_mode="reference",
                          fused_update=False),
                batches=_batches("views", 3, 21, 32),
                save_to=str(tmp_path / "ckpt"))
    ranks = run_ranks("train", spec, 2, tmp_path)
    assert_trees_equal(ranks[0]["state"], ranks[1]["state"])
    store = CheckpointStore(str(tmp_path / "ckpt"))
    tree, _ = store.restore(best=False)
    store.close()
    assert tree["optimizer"] == "lbfgs" and tree["opt_counts"] == {
        "count": 3}
    state, plan = tiny_state(canonical=tree, optimizer="lbfgs")
    assert state.zero1 is None
    assert_trees_equal(plan.to_canonical(state), ranks[0]["state"])
    # two of the ten memory slots hold the steps' differences
    rows = state.opt["diff_params_memory"].abs().sum(dim=1)
    assert (rows > 0).sum() == 2 and state.opt["weights_memory"][:2].all()
