"""Ranks of a data-parallel world as OS processes, for the port's tests.

:func:`run_ranks` starts ``world`` processes of ``python -m
tests.torch_ranks``, each of which joins a gloo process group through a
``FileStore`` under the test's own directory (no port, so parallel test
workers never collide), runs one torch thread, calls a function of
:data:`JOBS` on a spec handed over in a file, and writes its result to a
file.  Every process has a deadline: a hang fails the test, never the
suite.  This module imports torch and the port only: the JAX oracle runs
in the test process.
"""
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread in the test process too, restored after (imported
    by the multi-rank test files): under a parallel test run every extra
    OpenMP team oversubscribes the cores the other tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)

# the tiny BYOL net of tests/test_torch_train_step.py
WIDTH, CLASSES, HEAD, PROJ = 8, 10, 32, 16
WD, BASE_LR, LR_BATCH, TOTAL = 1e-3, 2.0, 8, 24


def run_ranks(job: str, spec: Dict[str, Any], world: int, tmp_path: Path,
              timeout: float = 180.0, expect_rc: int = 0) -> List[Any]:
    """``JOBS[job](spec)`` on each of ``world`` ranks; their results in
    rank order (None for a rank that exited ``expect_rc`` != 0 as
    expected)."""
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    spec_path = tmp_path / f"{job}_spec.pt"
    torch.save(spec, spec_path)
    store = tmp_path / f"{job}_store"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = []
    for r in range(world):
        out = tmp_path / f"{job}_out{r}.pt"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_ranks", job, str(spec_path),
             str(store), str(r), str(world), str(out)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=timeout)
            logs.append(log)
            if p.returncode != expect_rc:
                failed.append((r, p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError(f"ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r} ---\n{log[-3000:]}" for r, log in
            enumerate(logs)))
    if expect_rc:
        return [None] * world
    return [torch.load(tmp_path / f"{job}_out{r}.pt", weights_only=False)
            for r in range(world)]


def run_ranks_once(name: str, job: str, spec: Dict[str, Any], world: int,
                   tmp_path_factory, **kw) -> List[Any]:
    """:func:`run_ranks` once per test session.  Under pytest-xdist every
    worker that runs a test of a module builds that module's fixtures, so
    the first worker runs the ranks and saves their results beside the
    workers' temp directories, and the others wait on a lock and read
    them."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return run_ranks(job, spec, world, tmp_path_factory.mktemp(name),
                         **kw)
    import fcntl
    root = tmp_path_factory.getbasetemp().parent
    done = root / f"{name}.pt"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                results = run_ranks(job, spec, world, root / name, **kw)
                torch.save(results, root / f"{name}.partial")
                os.replace(root / f"{name}.partial", done)
            return torch.load(done, weights_only=False)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def tiny_net(dtype=torch.float32):
    from byol_tpu_torch.models import resnet as torch_resnet
    from byol_tpu_torch.models.byol_net import BYOLNet
    backbone = torch_resnet.ResNet(stage_sizes=[1, 1],
                                   block_cls=torch_resnet.Bottleneck,
                                   width=WIDTH, small_inputs=True,
                                   zero_init_residual=False, dtype=dtype)
    return BYOLNet(backbone, num_classes=CLASSES, head_latent_size=HEAD,
                   projection_size=PROJ, dtype=dtype)


def seeded_net(dtype=torch.float32, seed=0):
    """The tiny net with flax's initializers drawn from ``seed``; a
    float64 net holds float64 parameters and statistics too."""
    from byol_tpu_torch.models.layers import init_params
    net = tiny_net(dtype)
    init_params(net, torch.Generator().manual_seed(seed))
    return net.double() if dtype == torch.float64 else net


def seeded_tree(optimizer="lars_momentum", dtype=torch.float32, seed=0):
    """The canonical tree of a fresh train state of :func:`seeded_net`
    (the target at 0.004 of the params, as JAX's ``reference`` init)."""
    from byol_tpu_torch.training.state import (canonical_state,
                                               create_train_state)
    return canonical_state(create_train_state(
        seeded_net(dtype, seed), ema_init_mode="reference",
        optimizer=optimizer))


def tiny_vit_net(dtype=torch.float32, *, pooling="cls", attn_impl="dense",
                 remat_policy="none"):
    """The tiny ViT BYOL net: width 32, depth 2, 4 heads, patch 8, 32 px
    (the JAX tests' ``vit_test`` at two blocks), heads 32/16, 10 classes."""
    from byol_tpu_torch.models.byol_net import BYOLNet
    from byol_tpu_torch.models.vit import ViT
    backbone = ViT(width=32, depth=2, num_heads=4, patch_size=8, dtype=dtype,
                   pooling=pooling, attn_impl=attn_impl,
                   remat_policy=remat_policy, image_size=32)
    return BYOLNet(backbone, num_classes=CLASSES, head_latent_size=HEAD,
                   projection_size=PROJ, dtype=dtype)


def tiny_state(converted=None, *, canonical=None, polyak_ema=0.0,
               zero1=False, flat_resident=False, bucket_mb=64,
               optimizer="lars_momentum", dtype=torch.float32, vit=None):
    """The tiny net's train state at this rank (the tiny ViT's with
    ``vit``, :func:`tiny_vit_net`'s keywords), its heads cut to the
    laid-out model axis's shards, laid out by the plan over the data
    axis, holding a whole ``converted`` (``convert.train_state_from_flax``)
    or ``canonical`` tree."""
    from byol_tpu_torch.models.byol_net import shard_heads
    from byol_tpu_torch.parallel import mesh, partitioning
    from byol_tpu_torch.parallel.compile_plan import build_plan
    from byol_tpu_torch.training.state import (create_train_state,
                                               load_converted)
    size, index = partitioning.model_axis()
    plan = build_plan(mesh.process_info()[1], zero1=zero1,
                      flat_resident=flat_resident, bucket_mb=bucket_mb,
                      model=size)
    net = tiny_net(dtype) if vit is None else tiny_vit_net(dtype, **vit)
    net = shard_heads(net.double() if dtype == torch.float64 else net,
                      size, index)
    state = create_train_state(net, polyak_ema=polyak_ema,
                               pad_rows_to=plan.pad_rows_to,
                               optimizer=optimizer)
    plan.prepare(state, weight_decay=WD)
    if canonical is not None:
        plan.from_canonical(state, canonical)
    else:
        load_converted(state, converted)
    return state, plan


def train(spec):
    """Steps of the tiny net (the tiny ViT under ``spec['vit']``, the
    blocks under ``spec['remat_policy']``) on this data rank's rows of each
    global batch (``spec['optimizer']``, default lars_momentum, at
    ``spec['clip']``);
    -> per-step metrics (host floats, the health vector as a list) and
    the canonical state, which rank 0 also checkpoints under
    ``spec['save_to']`` when given.  Without a process group: the
    one-device steps on the whole batches."""
    from byol_tpu_torch.data import device_augment as aug
    from byol_tpu_torch.optim.factory import (build_optimizer,
                                              is_lars_optimizer)
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.training import steps as torch_steps
    optimizer = spec.get("optimizer", "lars_momentum")
    state, plan = tiny_state(spec.get("converted"),
                             canonical=spec.get("canonical"),
                             polyak_ema=spec["scfg"].get("polyak_ema", 0.0),
                             optimizer=optimizer,
                             dtype=spec.get("dtype", torch.float32),
                             vit=spec.get("vit"), **spec.get("plan", {}))
    if spec.get("remat_policy"):
        from byol_tpu_torch.core.remat import set_remat_policy
        set_remat_policy(state.net, spec["remat_policy"])
    tx, sched = build_optimizer(
        optimizer, base_lr=spec.get("base_lr", BASE_LR),
        global_batch_size=LR_BATCH, weight_decay=WD, total_units=TOTAL,
        warmup_units=0, clip=spec.get("clip", 0.0))
    # this rank's shards of the split leaves before the first step
    local0 = {name: state.tree(state.params)[name].clone()
              for name in state.split_dims() if name in state.names}
    draw = None
    if spec.get("draws") is not None:
        table = spec["draws"]

        def draw(step, b, h, w, microbatch):
            views = table[(step, microbatch)]
            assert len(views[0][0]) == b, (len(views[0][0]), b)
            return tuple(aug.ViewParams(*v) for v in views)
    scfg = dict(dict(lars_in_chain=is_lars_optimizer(optimizer)),
                **spec["scfg"])
    step = torch_steps.make_train_step(
        tx, torch_steps.StepConfig(total_train_steps=TOTAL, **scfg),
        sched, draw_views=draw)
    metrics = []
    for batch in spec["batches"]:
        local = mesh.shard_batch(batch)
        got = step(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in local.items()})
        metrics.append({k: (v.tolist() if v.numel() > 1 else float(v))
                        for k, v in got.items()})
    tree = plan.to_canonical(state)
    if spec.get("save_to") and mesh.is_primary():
        from byol_tpu_torch.checkpoint.checkpointer import CheckpointStore
        store = CheckpointStore(spec["save_to"])
        store.save(0, tree)
        store.close()
    return {"metrics": metrics, "state": tree, "local0": local0,
            "opt_numel": {k: v.numel() for k, v in state.opt.items()},
            "momentum_numel": (state.momentum.numel()
                               if "momentum" in state.opt else None)}


def restore(spec):
    """The tiny net's state at this rank restored from the checkpoint
    under ``spec['load_from']`` (its optimizer ``spec['optimizer']``): ->
    its canonical tree and this rank's shards of the split leaves."""
    from byol_tpu_torch.checkpoint.checkpointer import CheckpointStore
    from byol_tpu_torch.parallel import mesh
    mesh.barrier()                      # rank 0's write is complete
    store = CheckpointStore(spec["load_from"])
    tree, _ = store.restore()
    store.close()
    state, plan = tiny_state(canonical=tree, dtype=spec["dtype"],
                             optimizer=spec.get("optimizer",
                                                "lars_momentum"))
    return {"state": plan.to_canonical(state),
            "local": {name: state.tree(state.params)[name].clone()
                      for name in state.split_dims()
                      if name in state.names}}


def mesh_error(spec):
    """The error laying the world out as ``spec['layout']`` (sequence,
    model) raises (None: it did not)."""
    from byol_tpu_torch.parallel import mesh
    try:
        mesh.init_mesh(*spec["layout"])
    except ValueError as e:
        return str(e)
    return None


def fit_cli(spec):
    """``fit`` of the port's CLI flags at this rank; -> its final metrics
    and canonical state."""
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.parallel.compile_plan import plan_from_cfg
    from byol_tpu_torch.training.trainer import fit
    cfg = config_from_args(build_parser().parse_args(spec["argv"]))
    result = fit(cfg, device=torch.device("cpu"), verbose=False)
    tree = plan_from_cfg(cfg, 1).to_canonical(result.state)
    return {"state": tree, "test": result.test_metrics,
            "losses": result.step_losses}


def fit_sigterm(spec):
    """``fit`` of the CLI flags, the last rank sending itself SIGTERM as
    its loader yields batch ``spec['at']``: every rank must checkpoint
    once and exit 143 (SystemExit out of this job)."""
    import signal

    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.training.trainer import fit
    cfg = config_from_args(build_parser().parse_args(spec["argv"]))
    loader = get_loader(cfg)
    make = loader.make_train_iter
    last = mesh.rank() == mesh.world_size() - 1

    def noticed(epoch):
        for i, batch in enumerate(make(epoch)):
            if last and i == spec["at"]:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch
    loader.make_train_iter = noticed
    fit(cfg, device=torch.device("cpu"), loader=loader, verbose=False)
    return {"finished": True}


def linear_eval(spec):
    """Linear-eval extraction and probe of a state made from the seed, at
    this rank; -> the features, labels, W and b."""
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.training import linear_eval as le
    from byol_tpu_torch.training.build import build_net, setup_training
    cfg = config_from_args(build_parser().parse_args(spec["argv"]))
    loader = get_loader(cfg)
    rcfg = resolve(cfg, num_train_samples=loader.num_train_samples,
                   num_test_samples=loader.num_test_samples,
                   output_size=loader.output_size,
                   input_shape=loader.input_shape)
    _, state, _, _, _ = setup_training(rcfg, "cpu")
    apply_fn = le.encoder_extractor_spmd(build_net(rcfg), state)
    host = mesh.local_rows(rcfg.global_batch_size)
    out = {}
    for split, it, dealt in (("train", loader.train_eval_loader, False),
                             ("test", loader.test_loader, True)):
        out[split] = le.extract_features_spmd(
            apply_fn, it, host_batch=host, replicated_data=dealt,
            sample_shape=loader.input_shape)
    w, b = le.train_linear_probe(*out["train"], loader.output_size,
                                 epochs=spec.get("epochs", 5), device="cpu")
    out["probe"] = (w, b)
    # the entry point the CLI's --linear-eval calls, on every rank
    out["result"] = le.run_linear_eval_from_cfg(
        cfg, state, loader=loader, epochs=spec.get("epochs", 5))
    return out


def lockstep(spec):
    """``lockstep_iter`` over ``spec['counts'][rank]`` batches, the rank
    ``spec['raise_on']`` raising at its ``spec['raise_at']``-th."""
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.parallel.lockstep import lockstep_iter
    rank = mesh.rank()

    def batches():
        for i in range(spec["counts"][rank]):
            if rank == spec.get("raise_on") and i == spec.get("raise_at"):
                raise OSError(f"unreadable file at batch {i}")
            yield i
    got = []
    try:
        for b in lockstep_iter(batches(), lambda: "pad"):
            got.append(b)
    except (OSError, RuntimeError) as e:
        return {"seen": got, "error": f"{type(e).__name__}: {e}"}
    return {"seen": got, "error": None}


def gather(spec):
    """Each rank writes its range of a buffer of ``spec['sizes']``
    segments; -> the buffer refilled by the whole-buffer all-gather and by
    the bucketed one (``spec['bucket_mb']``)."""
    from byol_tpu_torch.ops.fused_update import build_segment_map
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.parallel.zero1 import Zero1Context
    rank, world = mesh.process_info()
    seg = build_segment_map(spec["sizes"], [True] * len(spec["sizes"]))
    out = {}
    for name, mb in (("whole", None), ("bucketed", spec["bucket_mb"])):
        ctx = Zero1Context.build(seg, world=world, rank=rank,
                                 weight_decay=0.0, device="cpu",
                                 bucket_mb=mb)
        buf = torch.full((ctx.total_elements,), -1.0)
        own = ctx.shard_of(buf)
        own.copy_(torch.arange(own.numel(), dtype=torch.float32)
                  + 1e6 * (rank + 1))
        out[name] = ctx.gather(buf).clone()
    out["buckets"] = len(ctx.buckets)
    out["real"] = seg.total
    return out


def bn_stats(spec):
    """A train-mode forward of the CLI config's net on this rank's rows;
    -> its output rows and the BatchNorm running statistics."""
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.training.build import setup_training
    cfg = config_from_args(build_parser().parse_args(spec["argv"]))
    rcfg = resolve(cfg, num_train_samples=256, num_test_samples=32,
                   output_size=10, input_shape=spec["x"].shape[1:])
    _, state, _, _, _ = setup_training(rcfg, "cpu")
    state.net.train()
    x = mesh.shard_batch({"x": spec["x"]})["x"]
    with torch.no_grad():
        out = state.net(torch.from_numpy(x))["projection"]
    return {"out": out, "stats": {k: v.clone() for k, v in
                                  state.batch_stats().items()}}


def ring(spec):
    """Ring attention on this data rank's rows of ``spec['qkv']``: -> the
    output rows and the gradients of ``sum(out * spec['w'])`` by q, k, v
    (each rank holds its data rows; the ring runs over its sequence
    group)."""
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.parallel.ring_attention import ring_attention
    qkv = [torch.from_numpy(mesh.shard_batch({"x": a})["x"]).requires_grad_()
           for a in spec["qkv"]]
    w = torch.from_numpy(mesh.shard_batch({"x": spec["w"]})["x"])
    out = ring_attention(*qkv)
    (out * w).sum().backward()
    return {"out": out.detach(), "grads": [t.grad for t in qkv]}


def ring_error(spec):
    """The error the tiny ViT's ``spec['pooling']`` forward raises under
    ring attention at this mesh (None: it ran)."""
    net = tiny_vit_net(pooling=spec["pooling"], attn_impl="ring")
    try:
        net(torch.zeros(2, 32, 32, 3))
    except ValueError as e:
        return str(e)
    return None


def step_inputs(spec):
    """In-step augmented ViT steps (the unfused chain on the step's own
    draws) of ``spec['batches']`` from this data rank's rows: -> the raw
    images and the draws each step's views were made of, then the first
    train batch of the CLI loader of ``spec['argv']`` at this mesh."""
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.data import device_augment as aug
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.parallel import mesh
    seen = []
    to_device = aug.to_device

    def record(drawn, device):
        seen.append([[f.clone() for f in v] for v in drawn])
        return to_device(drawn, device)
    aug.to_device = record
    try:
        train(spec)
    finally:
        aug.to_device = to_device
    images = [mesh.shard_batch(b)["images"] for b in spec["batches"]]
    cfg = config_from_args(build_parser().parse_args(spec["argv"]))
    batch = next(iter(get_loader(cfg).make_train_iter(0)))
    return {"draws": seen, "images": images,
            "loader": {k: np.asarray(v) for k, v in batch.items()}}


def multi(spec):
    """Several jobs in one world, in order: ``spec['parts']`` = [(job,
    sub-spec)], each at the mesh of its ``sequence`` and ``model``
    (default 1)."""
    from byol_tpu_torch.parallel import mesh
    results = []
    for job, sub in spec["parts"]:
        mesh.init_mesh(sub.get("sequence", 1), sub.get("model", 1))
        results.append(JOBS[job](sub))
    return results


JOBS = {"train": train, "restore": restore, "mesh_error": mesh_error,
        "fit_cli": fit_cli, "fit_sigterm": fit_sigterm,
        "linear_eval": linear_eval,
        "lockstep": lockstep, "gather": gather, "bn_stats": bn_stats,
        "ring": ring, "ring_error": ring_error, "step_inputs": step_inputs,
        "multi": multi}


def main(argv):
    job, spec_path, store_path, rank, world, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from byol_tpu_torch.parallel import mesh
    mesh.initialize_distributed(
        "cpu", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout_s=120.0)
    try:
        spec = torch.load(spec_path, weights_only=False)
        mesh.init_mesh(spec.get("sequence", 1), spec.get("model", 1))
        result = JOBS[job](spec)
        torch.save(result, out)
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
