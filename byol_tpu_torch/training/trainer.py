"""The training loop (counterpart of byol_tpu/training/trainer.py), on
one card or data-parallel over a process group (parallel/mesh.py: one
process per card, each with its rows of every global batch):

- the epoch loop runs exactly ``steps_per_train_epoch`` optimizer steps
  (wrapping the loader if it runs short), or one under ``debug_step``;
- the train batches come through :func:`prefetch_to_device`: a producer
  thread makes batch N+1 (on the host, or on the card under
  ``data_backend='device'``) and copies it while step N runs; the first
  batch of a run is held to the input contract (``_range_check``);
- one eval pass per epoch on the test split, and on the valid split when
  the loader has one, a microbatch (the train batch when ``accum_steps``
  is 1) at a time, each padded to that size with a validity mask (one
  shape, pad rows out of every metric);
- one line per epoch: loss, BYOL and linear-probe losses, top-1/5, wall
  ms per step and images per second, then the same metrics on the test
  set; then the input pipeline's line (``input[Epoch N]``: H2D MiB per
  step, starved steps, fill) and, with a valid split, a ``valid`` line;
- a checkpoint per epoch through :class:`ModelSaver` under
  ``model_dir/run_name(cfg)``, on the test loss, with burn-in
  ``0.1 * epochs`` and patience 10; early stop (``early_stop``) restores
  the best state and evaluates it again; a relaunch of a stopped run
  restores the best state, evaluates it and trains nothing;
- a relaunch resumes from the last checkpoint.  Data order is a function
  of (seed, epoch) and the in-step augmentation draws of (seed, step), so a
  checkpoint taken mid-epoch resumes exactly: the relaunch re-enters that
  epoch and skips the batches its steps already took;
- SIGTERM (a preemption notice) checkpoints the state at the next step
  boundary as last, never best, and exits 143; ``fault_at_step`` exits
  without saving.

The metrics stay on the device during an epoch and are read back once at
its end, after a synchronise, so the step time is the device's as well as
the host's.

Data parallel, as the JAX trainer runs a multi-host mesh: the world is
laid out as (data, sequence, model) (parallel/mesh.py::init_mesh), the
data axis (``num_replicas``) is world / (sequence x model), the ranks of
one sequence group hold the same rows and run ring attention across
them, and the ranks of one model group hold the same rows and their
shards of the tensor-parallel heads; the compile plan
(parallel/compile_plan.py) lays out the state (ZeRO-1) and names itself in
the run header; rank 0 alone prints, logs, graphs and writes checkpoints,
every rank restores, and the ranks meet at a barrier around each write;
eval batches run through ``lockstep_iter`` (the test split, unsharded
unless ``--shard-eval``, dealt round-robin over the ranks) and the
metrics are summed over the ranks; a SIGTERM on any rank saves once and
every rank exits 143.

Observability, as the JAX trainer wires it (observability/):

- a span flight recorder (``--spans on``): ``startup/build``, the fit's
  first step as ``startup/compile`` (cuDNN autotuning, the first kernel
  library load, the FLOP count), later steps as ``train/dispatch``,
  ``input/fill|wait`` from the prefetch, ``train/epoch_readback`` around
  the synchronise and readback, ``telemetry/...``, ``eval/run`` and
  ``checkpoint/save``; a goodput window folds at each epoch's end and the
  run's totals at the end, and the ring goes to a Chrome trace;
- the run log ``log_dir/<run name>/run.jsonl`` in the JAX schema:
  ``run_header``, ``step`` records of the health vector, ``epoch`` events
  for train, test and valid, ``checkpoint``, ``anomaly`` / ``halt`` /
  ``state_dump``, ``goodput`` / ``span_stats`` and ``run_end``; the
  grapher's ``metrics.jsonl`` (and TensorBoard events) beside it;
- ``--telemetry step|epoch``: the step's health vector read back through
  the :class:`TelemetrySink` (every ``telemetry_interval`` steps with one
  interval of lag, or once an epoch); under ``--nan-policy halt`` a
  non-finite gradient or loss writes ``state_dump``, the goodput totals
  and the trace, closes the saver, and only then raises
  :class:`NanHaltError`;
- a watchdog (``--watchdog-timeout``) petted around every blocking
  window, and a :class:`StepTimer` for images/s, MFU (the first step's
  FLOPs counted by ``flops.counting``, the tensor-parallel heads' counted
  whole: the model's FLOPs over the world's cards, as JAX divides by
  ``jax.device_count()``) and the step-time tail;
- the grapher's ``config`` text at epoch 2 carries the SLURM id, the EC2
  instance id and the card's environment (utils/), as JAX's does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from byol_tpu_torch.checkpoint import ModelSaver
from byol_tpu_torch.core.config import Config, resolve, run_name
from byol_tpu_torch.data.loader import LoaderBundle, get_loader, pad_batch
from byol_tpu_torch.data.prefetch import prefetch_to_device
from byol_tpu_torch.observability import flops as flops_lib
from byol_tpu_torch.observability import goodput as goodput_lib
from byol_tpu_torch.observability import spans as spans_lib
from byol_tpu_torch.observability.events import RunLog, run_header_env
from byol_tpu_torch.observability.grapher import Grapher
from byol_tpu_torch.observability.meters import (InputPipelineMeter,
                                                 MetricAccumulator,
                                                 StepTimer, input_log_line)
from byol_tpu_torch.observability.telemetry import (NanHaltError,
                                                    TelemetrySink)
from byol_tpu_torch.observability.watchdog import Watchdog
from byol_tpu_torch.parallel import mesh
from byol_tpu_torch.parallel.compile_plan import CompilePlan, plan_from_cfg
from byol_tpu_torch.parallel.lockstep import any_rank, lockstep_iter
from byol_tpu_torch.training.build import setup_training
from byol_tpu_torch.training.state import TrainState
from byol_tpu_torch.utils import (get_aws_instance_id, get_gpu_env,
                                  get_slurm_id, number_of_parameters)

EVAL_METRICS = ("loss_mean", "byol_loss_mean", "linear_loss_mean",
                "top1_mean", "top5_mean")


@dataclasses.dataclass
class FitResult:
    state: TrainState
    epoch: int
    train_metrics: Dict[str, float]
    test_metrics: Dict[str, float]
    step_losses: List[float]        # every optimizer step's loss, in order
    step_ms: float                  # wall ms per step, last epoch
    images_per_sec: float           # last epoch
    stopped_early: bool = False
    test_losses: List[float] = dataclasses.field(default_factory=list)
    valid_metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    valid_losses: List[float] = dataclasses.field(default_factory=list)
    input_pipeline: Dict[str, float] = dataclasses.field(
        default_factory=dict)       # the last epoch's InputPipelineMeter
    mfu: Optional[float] = None     # last epoch, on a card of known peak
    flops_per_sample: Optional[float] = None   # the first step's count
    anomalies: int = 0              # telemetry anomalies of the run


def _range_check(batch, input_shape) -> None:
    """The input contract: raw (B, H, W, C) uint8 images under step
    placement, else views in [0, 1]."""
    if "images" in batch:
        images = batch["images"]
        if images.dtype != np.uint8 or images.ndim != 4 or \
                images.shape[-1] != input_shape[-1]:
            raise ValueError(f"batch images must be (B, H, W, "
                             f"{input_shape[-1]}) uint8, got {images.dtype} "
                             f"{images.shape}")
        return
    for key in ("view1", "view2"):
        lo, hi = float(batch[key].min()), float(batch[key].max())
        if lo < 0.0 or hi > 1.0:
            raise ValueError(f"batch {key} out of [0,1]: min={lo} max={hi}")


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _epoch_batches(loader: LoaderBundle, steps: int) -> Iterator:
    """Exactly ``steps`` batches, wrapping to the loader's start."""
    produced = since_reset = 0
    it = iter(loader.train_loader)
    while produced < steps:
        batch = next(it, None)
        if batch is None:
            if since_reset == 0:
                raise ValueError("train loader yielded no batches")
            it, since_reset = iter(loader.train_loader), 0
            continue
        since_reset += 1
        produced += 1
        yield batch


def _fmt(m: Dict[str, float]) -> str:
    return (f"loss {m['loss_mean']:.4f} (byol {m['byol_loss_mean']:.4f}, "
            f"linear {m['linear_loss_mean']:.4f}) top1 {m['top1_mean']:.2f} "
            f"top5 {m['top5_mean']:.2f}")


@dataclasses.dataclass
class _Observers:
    """What one fit records with: the span recorder and its goodput meter,
    the run log (disabled, not absent, where it could not open), the
    telemetry sink (None under ``--telemetry off``), the watchdog, the
    grapher and the step timer."""

    recorder: Any
    goodput: goodput_lib.GoodputMeter
    events: RunLog
    sink: Optional[TelemetrySink]
    watchdog: Watchdog
    grapher: Grapher
    timer: StepTimer
    log_dir: str                    # log_dir/<run name>
    plan: CompilePlan

    def export_trace(self) -> None:
        """The ring as a Chrome trace next to run.jsonl (spans on).  The
        trace is evidence, never a reason to kill the run."""
        if not self.recorder.enabled or not mesh.is_primary():
            return
        try:
            spans_lib.export_chrome_trace(
                self.recorder.records(),
                os.path.join(self.log_dir, "trace.json"))
        except OSError as e:
            print(f"spans: trace export failed ({e!r}); continuing",
                  file=sys.stderr)


def fit(cfg: Config, *, device, loader: Optional[LoaderBundle] = None,
        grapher: Optional[Grapher] = None,
        verbose: bool = True) -> FitResult:
    """Train per the config on ``device``, resuming from the run's last
    checkpoint if it has one; returns the final state and the last epoch's
    metrics.  ``step_losses`` and ``test_losses`` hold what this call
    ran.  ``grapher`` defaults to ``cfg.task.grapher`` under
    ``log_dir/<run name>``.  Inside a process group every rank calls it
    (parallel/mesh.py::initialize_distributed first)."""
    # the mesh (data, sequence, model) over the world, as the JAX trainer
    # lays out the devices it finds: the data axis is what the sequence
    # and model axes leave
    world = mesh.world_size()
    shape = mesh.init_mesh(cfg.device.sequence_parallel,
                           cfg.device.model_parallel)
    primary = mesh.is_primary()
    verbose = verbose and primary
    cfg = cfg.replace(device=dataclasses.replace(
        cfg.device, num_replicas=shape[mesh.DATA_AXIS]))
    if loader is None:
        loader = get_loader(cfg, device=device)
    rcfg = resolve(cfg, num_train_samples=loader.num_train_samples,
                   num_test_samples=loader.num_test_samples,
                   output_size=loader.output_size,
                   input_shape=loader.input_shape,
                   num_valid_samples=loader.num_valid_samples)
    recorder = (spans_lib.SpanRecorder() if cfg.device.spans == "on"
                else spans_lib.NULL)
    # the first goodput window opens before the model build, so startup
    # is attributed, not lost
    meter = goodput_lib.GoodputMeter(recorder)
    name = run_name(cfg)
    log_dir = os.path.join(cfg.task.log_dir, name)
    if grapher is None:
        grapher = Grapher(cfg.task.grapher if primary else "null",
                          logdir=cfg.task.log_dir, run_name=name)
    saver = ModelSaver(
        os.path.join(cfg.model.model_dir, name),
        early_stop=cfg.optim.early_stop,
        burn_in_interval=int(0.1 * cfg.task.epochs),
        larger_is_better=False,
        max_early_stop_steps=10)
    # best effort: an unopenable log directory or a full disk disables the
    # log with a warning, never the run
    plan = plan_from_cfg(cfg, cfg.device.num_replicas)
    events = RunLog(os.path.join(log_dir, "run.jsonl") if primary else None,
                    best_effort=True)
    events.emit("run_header", config=cfg.to_dict(), **run_header_env(device),
                run_name=name, n_devices=world,
                mesh_shape=plan.describe()["mesh_shape"],
                steps_per_train_epoch=rcfg.steps_per_train_epoch,
                global_batch_size=rcfg.global_batch_size,
                sharding_plan=plan.describe())
    sink = None
    if cfg.device.telemetry != "off":
        sink = TelemetrySink(cfg.device.telemetry_interval,
                             nan_policy=cfg.device.nan_policy,
                             events=events, verbose=verbose)
    obs = _Observers(recorder=recorder, goodput=meter, events=events,
                     sink=sink, watchdog=Watchdog(cfg.device.watchdog_timeout),
                     grapher=grapher,
                     timer=StepTimer(rcfg.global_batch_size, world, device),
                     log_dir=log_dir, plan=plan)
    try:
        return _fit(cfg, rcfg, saver, device, loader, verbose, obs)
    finally:
        obs.watchdog.stop()
        events.close()
        grapher.close()
        saver.close()             # raises if the last write failed


def _fit(cfg: Config, rcfg, saver: ModelSaver, device,
         loader: LoaderBundle, verbose: bool, obs: _Observers) -> FitResult:
    recorder, events, sink = obs.recorder, obs.events, obs.sink
    watchdog, grapher, timer = obs.watchdog, obs.grapher, obs.timer
    plan = obs.plan
    # the data axis's (d, D): eval batches are dealt over it, and the
    # ranks of a sequence group see the same ones
    rank, world = mesh.process_info()
    grouped = mesh.is_initialized()
    primary = mesh.is_primary()
    with recorder.span("startup/build"):
        _, state, train_step, eval_step, schedule = setup_training(
            rcfg, device, plan=plan)
    if verbose:
        # the whole tree's count (the split heads' leaves at full shape)
        whole = number_of_parameters(
            [torch.empty(s, device="meta") for s in state.whole_shapes()])
        print(f"model: {cfg.model.arch}, {state.seg.num_segments} parameter "
              f"leaves, {whole / 1e6:.2f}M params (main.py:447-449 "
              f"analog), optimizer={state.optimizer}"
              + (f" (clip {cfg.optim.clip})" if cfg.optim.clip else "")
              + f", fused_update={cfg.optim.fused_update}, "
              f"half={cfg.device.half}, on {device}", flush=True)
        if rcfg.accum_steps > 1:
            # every count above the step (state.step, steps per epoch, the
            # lr schedule's count, tau, images/s) is in optimizer steps
            print(f"grad accumulation: {rcfg.accum_steps} microbatches of "
                  f"{rcfg.microbatch_size} (global) per optimizer step, "
                  f"bn_mode={cfg.optim.accum_bn_mode}, effective batch "
                  f"{rcfg.global_batch_size}", flush=True)
        if grouped:
            print(f"data parallel: {world} ranks of "
                  f"{rcfg.batch_size_per_replica} rows"
                  + (f", sequence groups of {cfg.device.sequence_parallel}"
                     if cfg.device.sequence_parallel > 1 else "")
                  + (f", model groups of {cfg.device.model_parallel}"
                     if cfg.device.model_parallel > 1 else "")
                  + ", zero1="
                  f"{cfg.device.zero1}, flat_resident="
                  f"{cfg.device.flat_resident}", flush=True)
    batch_size = rcfg.global_batch_size
    # eval runs a microbatch at a time, each padded to one shape: the same
    # row-weighted means as one padded batch, with the train step's memory
    eval_rows = rcfg.microbatch_size

    def run_eval(batches=None, sharded=False) -> Dict[str, float]:
        """The eval metrics over a split.  Inside a process group the
        ranks hold their shards (``sharded``: the valid split, the test
        split under --shard-eval) or the whole split, whose batches are
        then dealt round-robin; they iterate in lockstep and their sums
        are added up."""
        # the eval loop and its readback are a blocking window
        watchdog.pet()
        acc = MetricAccumulator()
        src = batches if batches is not None else loader.test_loader
        if grouped:
            if not sharded:
                src = itertools.islice(src, rank, None, world)
            src = lockstep_iter(src, lambda: None)
        for batch in src:
            n = 0 if batch is None else len(batch["label"])  # None: a pad
            for start in range(0, n, eval_rows):
                rows = {k: v[start:start + eval_rows]
                        for k, v in batch.items()}
                acc.update(eval_step(state, _to_device(
                    pad_batch(rows, eval_rows), device)))
            if cfg.device.debug_step:
                break
        if grouped:
            acc.all_reduce(EVAL_METRICS, device)
        return acc.result()

    def checkpoint_tree():
        """The layout-free tree of the state (a collective under ZeRO-1,
        so every rank builds it)."""
        return plan.to_canonical(state)

    def restore(best: bool):
        """Every rank reads the checkpoint rank 0 wrote."""
        tree, epoch_ = saver.restore(best=best)
        plan.from_canonical(state, tree)
        return epoch_

    if saver.stopped_early:
        # the run already stopped early (the durable marker): evaluate the
        # best state and train nothing
        init_epoch = restore(best=True)
        test_metrics = run_eval(sharded=loader.eval_sharded)
        if verbose:
            print(f"run already early-stopped at best epoch "
                  f"{init_epoch - 1}; nothing to train", flush=True)
        events.emit("run_end", epoch=init_epoch - 1, stopped_early=True,
                    already_stopped=True)
        return FitResult(state=state, epoch=init_epoch - 1, train_metrics={},
                         test_metrics=test_metrics, step_losses=[],
                         step_ms=0.0, images_per_sec=0.0, stopped_early=True)
    init_epoch = resume_skip = 0
    if saver.has_checkpoint():
        # plain resume continues from LAST: best would discard the training
        # after it and reset the persisted patience on every relaunch
        init_epoch = restore(best=False)
        saved_epoch = init_epoch - 1
        if not cfg.device.debug_step:
            # a preemption checkpoint lands mid-epoch: re-enter that epoch
            # and skip the batches its steps already took
            done_in_epoch = state.step % rcfg.steps_per_train_epoch
            if done_in_epoch:
                init_epoch -= 1
                resume_skip = done_in_epoch
        if verbose:
            print(f"resumed from the checkpoint of epoch {saved_epoch} at "
                  f"step {state.step} "
                  f"(best loss {saver.best_metric}"
                  + (f", re-entering epoch {init_epoch} at batch "
                     f"{resume_skip}" if resume_skip else "") + ")",
                  flush=True)
    resume_epoch = init_epoch

    preempted = threading.Event()
    # a handler can be installed from the main thread only; elsewhere
    # SIGTERM keeps whatever the process has
    installed = (cfg.device.save_on_signal and threading.current_thread()
                 is threading.main_thread())
    if installed:
        old_sigterm = signal.signal(signal.SIGTERM,
                                    lambda signum, frame: preempted.set())
    epoch = init_epoch

    def maybe_preempt_save() -> None:
        # a notice on any rank stops every rank at the same step boundary
        if not (any_rank(preempted.is_set()) if grouped
                else preempted.is_set()):
            return
        # the epoch is partly trained: saved as last, never best; the
        # relaunch finds step % steps_per_epoch != 0 and resumes exactly
        tree = checkpoint_tree()
        if primary:
            saver.store.save(epoch, tree, is_best=False)
            saver.store.wait()
            print(f"SIGTERM: checkpointed epoch {epoch} at step "
                  f"{state.step}; exiting 143 for requeue", flush=True)
        mesh.barrier()
        raise SystemExit(143)

    def halt_dump(err: NanHaltError) -> None:
        """--nan-policy halt tripped: the post-mortem goes into the run log
        (state metadata, the goodput totals, the trace) and the saver is
        closed before the error propagates."""
        events.emit("state_dump", step=err.step, epoch=epoch,
                    state_step=state.step, ema_step=state.ema_step,
                    lr=float(schedule(state.count)), reason="nonfinite",
                    health=err.record, run_name=run_name(cfg))
        if recorder.enabled:
            obs.goodput.final(events=events, halted=True)
            obs.export_trace()
        events.close()
        watchdog.stop()
        saver.close()

    def telemetry(span: str, call) -> None:
        try:
            with recorder.span(span):
                call()
        except NanHaltError as e:
            halt_dump(e)
            raise

    step_losses: List[float] = []
    test_losses: List[float] = []
    valid_losses: List[float] = []
    train_metrics: Dict[str, float] = {}
    test_metrics: Dict[str, float] = {}
    valid_metrics: Dict[str, float] = {}
    step_ms = images_per_sec = 0.0
    stopped = checked = False
    first_step = True
    sample_batch: Dict[str, np.ndarray] = {}

    def tapped(skip: int) -> Iterator:
        """The epoch's batches after the ``skip`` a resume re-enters past,
        the run's first one held to the input contract and the epoch's
        first host views kept for the grapher.  Runs in the prefetch
        thread."""
        nonlocal checked
        for i, batch in enumerate(
                _epoch_batches(loader, rcfg.steps_per_train_epoch)):
            if i < skip:
                continue
            if not checked:
                _range_check(batch, rcfg.input_shape)
                checked = True
            if not sample_batch and isinstance(batch.get("view1"),
                                               np.ndarray):
                # a copy: a slice would keep the whole host batch alive
                sample_batch.update({k: np.array(batch[k][:64])
                                     for k in ("view1", "view2")})
            yield batch

    def train_one(batch) -> Dict[str, torch.Tensor]:
        """One optimizer step.  The fit's first carries cuDNN autotuning
        and the first kernel-library load, so it is startup, not
        productive time; its FLOPs are counted (MFU) as it runs."""
        nonlocal first_step
        if not first_step:
            with recorder.span("train/dispatch"):
                return train_step(state, batch)
        first_step = False
        with recorder.span("startup/compile"), \
                flops_lib.counting() as counted:
            metrics = train_step(state, batch)
        if counted.total:
            # the rank's rows: the count covers this process's work, and
            # the heads' split matmuls are 1/M of the model's
            model_flops = counted.total + (
                (cfg.device.model_parallel - 1) * counted.split)
            timer.set_flops(model_flops / rcfg.batch_size_per_replica,
                            flops_lib.chip_peak_tflops(
                                torch.cuda.get_device_name(device)
                                if torch.device(device).type == "cuda"
                                else "cpu"))
        return metrics

    meter = InputPipelineMeter()
    try:
        for epoch in range(init_epoch, cfg.task.epochs):
            loader.set_all_epochs(epoch)
            skip = resume_skip if epoch == resume_epoch else 0
            acc, losses = MetricAccumulator(), []
            meter = InputPipelineMeter()
            sample_batch.clear()
            timer.reset_ticks()
            watchdog.pet()
            with recorder.span("train/epoch_readback"):
                _sync(device)
            t0 = time.perf_counter()
            with contextlib.closing(prefetch_to_device(
                    tapped(skip), device, meter=meter,
                    recorder=recorder)) as batches:
                for batch in batches:
                    metrics = train_one(batch)
                    timer.tick()
                    if sink is not None:
                        # the health vector leaves the metrics, so the
                        # accumulator only ever sums scalars
                        vec = metrics.pop("health")
                        if cfg.device.telemetry == "step":
                            telemetry("telemetry/readback",
                                      lambda: sink.offer(state.step, vec))
                        else:
                            sink.hold(state.step, vec)
                    acc.update(metrics)
                    losses.append(metrics["loss_mean"])
                    maybe_preempt_save()
                    if (cfg.device.fault_at_step
                            and state.step == cfg.device.fault_at_step):
                        # fault injection: die mid-epoch without saving, as
                        # a lost worker does; a relaunch resumes from the
                        # last checkpoint
                        raise SystemExit(f"fault injected at step "
                                         f"{state.step} (--fault-at-step)")
                    if cfg.device.debug_step:
                        break
            # the host blocks here until the card has run every step it
            # was given: productive time, as in the JAX trainer
            watchdog.pet()
            with recorder.span("train/epoch_readback"):
                _sync(device)
                elapsed = time.perf_counter() - t0
                train_metrics = acc.result()
            watchdog.pet()
            timer.record_epoch(acc.count, elapsed)
            if sink is not None:
                # after the synchronise: the pending and held vectors are
                # ready, so draining them costs no wait
                telemetry("telemetry/drain", sink.drain)
            step_losses.extend(float(x) for x in losses)
            step_ms = elapsed * 1e3 / len(losses)
            images_per_sec = batch_size * len(losses) / elapsed
            # the readback and eval windows are long: a notice landing in
            # them must not wait for the next epoch's first step
            maybe_preempt_save()
            events.emit("epoch", epoch=epoch, split="train", step=state.step,
                        metrics=train_metrics, seconds=round(elapsed, 3),
                        input_pipeline=meter.result(),
                        images_per_sec_per_chip=(
                            timer.images_per_sec_per_chip()),
                        **(timer.epoch_step_quantiles() or {}))

            with recorder.span("eval/run", split="test"):
                test_metrics = run_eval(sharded=loader.eval_sharded)
            watchdog.pet()
            test_losses.append(test_metrics["loss_mean"])
            maybe_preempt_save()
            events.emit("epoch", epoch=epoch, split="test", step=state.step,
                        metrics=test_metrics)
            if verbose:
                print(f"epoch {epoch}: train {_fmt(train_metrics)}, "
                      f"{len(losses)} steps, {step_ms:.1f} ms/step, "
                      f"{images_per_sec:.1f} img/s | test "
                      f"{_fmt(test_metrics)}", flush=True)
                print(input_log_line(epoch, meter), flush=True)
            if loader.make_valid_iter is not None:
                # early stop keys off the TEST loss, as in the JAX trainer
                with recorder.span("eval/run", split="valid"):
                    valid_metrics = run_eval(loader.valid_loader,
                                             sharded=True)
                watchdog.pet()
                valid_losses.append(valid_metrics["loss_mean"])
                maybe_preempt_save()
                grapher.register_plots(valid_metrics, epoch, prefix="valid")
                events.emit("epoch", epoch=epoch, split="valid",
                            step=state.step, metrics=valid_metrics)
                if verbose:
                    print(f"epoch {epoch}: valid {_fmt(valid_metrics)}",
                          flush=True)

            grapher.register_plots(train_metrics, epoch, prefix="train")
            grapher.register_plots(test_metrics, epoch, prefix="test")
            grapher.add_scalar("lr_scalar", float(schedule(state.count)),
                               epoch)
            grapher.add_scalar("images_per_sec_per_chip",
                               timer.images_per_sec_per_chip(), epoch)
            for key, value in meter.result().items():
                grapher.add_scalar(f"{key}_scalar", value, epoch)
            epoch_mfu = timer.mfu()
            if epoch_mfu is not None:
                grapher.add_scalar("mfu_scalar", epoch_mfu, epoch)
            if sample_batch:
                grapher.register_images(
                    {"aug1_imgs": sample_batch["view1"],
                     "aug2_imgs": sample_batch["view2"]}, epoch,
                    prefix="train")
            if epoch == 2:
                # config + cluster identity posted once (main.py:773-779;
                # the reference also stamps the AWS instance id,
                # main.py:128-130)
                meta = {"slurm_id": get_slurm_id(),
                        "aws_instance_id": get_aws_instance_id(),
                        "gpu": get_gpu_env()}
                grapher.add_text("config", cfg.to_json() + "\n" + str(meta),
                                 epoch)
            grapher.save()

            watchdog.pet()
            with recorder.span("checkpoint/save", epoch=epoch):
                tree = checkpoint_tree()
                stop_now = (saver(test_metrics["loss_mean"], epoch, tree)
                            if primary else None)
                if grouped:
                    # rank 0's decision, after its write is complete
                    if primary:
                        saver.store.wait()
                    stop_now = mesh.broadcast_object(stop_now)
                    mesh.barrier()
            watchdog.pet()
            events.emit("checkpoint", epoch=epoch, step=state.step,
                        metric=test_metrics["loss_mean"],
                        best_metric=saver.best_metric,
                        early_stop=bool(stop_now))
            # close this epoch's wall-time window; spans off: no fold (an
            # empty ring would put the whole epoch in host_other)
            if recorder.enabled:
                obs.goodput.fold(scope="epoch", epoch=epoch, mfu=epoch_mfu,
                                 events=events, images_per_sec_per_chip=(
                                     timer.images_per_sec_per_chip()))
            if stop_now:
                restore(best=True)
                with recorder.span("eval/run", split="test_best"):
                    test_metrics = run_eval(sharded=loader.eval_sharded)
                stopped = True
                if verbose:
                    print(f"early stop at epoch {epoch}; restored best "
                          f"(loss {saver.best_metric:.4f})", flush=True)
                break
    finally:
        if installed:
            # None: the old handler was not installed from Python
            signal.signal(signal.SIGTERM, old_sigterm if old_sigterm
                          is not None else signal.SIG_DFL)
    watchdog.stop()
    # the run's goodput totals (what `python -m byol_tpu_torch report`
    # renders) and the flight recorder's trace
    if recorder.enabled:
        obs.goodput.final(events=events, mfu=timer.mfu())
        obs.export_trace()
    anomalies = len(sink.anomalies) if sink is not None else 0
    events.emit("run_end", epoch=epoch, stopped_early=stopped,
                images_per_sec_per_chip=timer.images_per_sec_per_chip(),
                anomalies=anomalies)
    return FitResult(state=state, epoch=epoch, train_metrics=train_metrics,
                     test_metrics=test_metrics, step_losses=step_losses,
                     step_ms=step_ms, images_per_sec=images_per_sec,
                     stopped_early=stopped, test_losses=test_losses,
                     valid_metrics=valid_metrics, valid_losses=valid_losses,
                     input_pipeline=meter.result(), mfu=timer.mfu(),
                     flops_per_sample=timer.flops_per_sample,
                     anomalies=anomalies)
