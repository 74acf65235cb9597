"""EmbeddingService: the user-facing front end over the frozen encoder.

Counterpart of byol_tpu/serving/service.py.  Wires the serving parts into
one object with a two-method API — ``submit(images) -> future`` and
``stop()``:

    client threads -> DynamicBatcher (bounded queue, coalesce, max-wait)
                   -> worker thread -> ServingEngine (bucket-padded embed,
                      pinned staging, on the card) -> per-request futures

plus a :class:`~byol_tpu_torch.serving.meter.ServingMeter` for queue depth,
fill ratio and the latency tail.

:func:`build_service` is the startup path: rebuild the encoder from a
Config, load its weights from one of the port's training checkpoints
(:func:`restore_params_for_serving`, the port's checkpoints or the JAX
package's orbax ones), from a flax parameter tree through
``convert.from_flax``, or draw random weights from the seed, and hand it
to the engine.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from byol_tpu_torch.observability import spans as spans_lib
from byol_tpu_torch.serving.batcher import (EMPTY, DynamicBatcher, Request,
                                            ServiceClosed)
from byol_tpu_torch.serving.buckets import BucketSpec
from byol_tpu_torch.serving.engine import ServingEngine
from byol_tpu_torch.serving.meter import ServingMeter


class EmbeddingService:
    """Batcher + engine + meter under one worker thread.

    ``pipeline`` ("on"/"off", default on): with "on" the worker keeps up
    to TWO batches alive between dispatch and readback — while the card
    computes batch *i*, the host coalesces, stages, and dispatches batch
    *i+1*.  The numerics and delivery ORDER are identical to "off" —
    batches still complete FIFO — only the host/device overlap changes;
    tests/test_torch_serving.py pins bitwise parity between the two modes.
    """

    def __init__(self, engine: ServingEngine, batcher: DynamicBatcher,
                 *, meter: Optional[ServingMeter] = None,
                 events: Optional[Any] = None,
                 stats_interval_s: float = 10.0,
                 recorder: Any = None,
                 pipeline: str = "on") -> None:
        if pipeline not in ("off", "on"):
            raise ValueError(
                f"pipeline must be 'off' or 'on', got {pipeline!r}")
        self.engine = engine
        self.batcher = batcher
        self.meter = meter if meter is not None else ServingMeter()
        self.events = events
        self.recorder = recorder if recorder is not None else spans_lib.NULL
        self.stats_interval_s = stats_interval_s
        self.pipeline = pipeline
        # max batches alive between dispatch and readback: 2 = double
        # buffering (one computing, one being staged/dispatched); 1 =
        # readback before the next batch
        self._max_inflight = 2 if pipeline == "on" else 1
        self._thread: Optional[threading.Thread] = None
        self._last_stats = time.perf_counter()
        # serializes stats emits: the worker (per batch) and the CLI's
        # interval loop both call _emit_stats
        self._stats_lock = threading.Lock()

    # ---- lifecycle --------------------------------------------------------
    def start(self, *, warmup: bool = True) -> "EmbeddingService":
        """Warm the bucket vocabulary (unless ``warmup=False``) and start
        the worker — before the queue opens for traffic."""
        if self._thread is not None:
            raise RuntimeError("service already started")
        if warmup:
            self.engine.warmup()
        self._thread = threading.Thread(target=self._run,
                                        name="embedding_service",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Close the queue, drain what was accepted, join the worker, and
        emit a final stats window — every request's future RESOLVES: with
        embeddings if the worker drained it, with ServiceClosed if its
        submit raced close() into the already-drained queue."""
        self.batcher.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.batcher.fail_pending(
            ServiceClosed("the service stopped before this request was "
                          "dispatched"))
        self._emit_stats(force=True)

    def __enter__(self) -> "EmbeddingService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- client API -------------------------------------------------------
    def submit(self, images: np.ndarray,
               timeout: Optional[float] = 1.0,
               trace_id=None) -> Request:
        """Enqueue ``(rows, H, W, C)`` images; returns the future.  Blocks
        up to ``timeout`` when the bounded queue is full, then raises
        :class:`~byol_tpu_torch.serving.batcher.Backpressure`.  The row
        shape is validated HERE, in the client's thread: a wrong-sized
        image is that client's ValueError, never a failure of the batch."""
        images = np.asarray(images)
        row_shape = images.shape[1:] if images.ndim == 4 else images.shape
        if tuple(row_shape) != self.engine.input_shape:
            raise ValueError(
                f"request rows of shape {tuple(row_shape)} do not match "
                f"the served model's input {self.engine.input_shape}")
        req = self.batcher.submit(images, timeout=timeout,
                                  trace_id=trace_id)
        self.meter.record_enqueue(self.batcher.depth())
        return req

    def embed(self, images: np.ndarray,
              timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        return self.submit(images).result(timeout)

    # ---- worker -----------------------------------------------------------
    def _run(self) -> None:
        # in-flight pipeline, FIFO: each entry is a dispatched batch whose
        # readback has not happened yet
        pending: "collections.deque" = collections.deque()
        while True:
            # block only when nothing is in flight: with a batch pending,
            # an idle queue means "read back now" — a closed-loop client
            # waiting on the pending batch will not submit again until it
            # is delivered (blocking would deadlock)
            batch = self.batcher.next_batch(block=not pending)
            if batch is None:           # closed AND drained
                break
            if batch is EMPTY:          # open, no traffic right now
                self._complete(*pending.popleft())
                continue
            timeline: dict = {}
            try:
                # any per-batch failure belongs to this batch's futures,
                # never to the worker thread (whose death would strand
                # the queue)
                with self.recorder.span(
                        "serve/batch",
                        trace_ids=[r.trace_id for r in batch]):
                    rows = (batch[0].images if len(batch) == 1 else
                            np.concatenate([r.images for r in batch],
                                           axis=0))
                    inflight = self.engine.dispatch(rows,
                                                    timeline=timeline)
            except Exception as e:  # noqa: BLE001 — relayed per request
                for r in batch:
                    r.set_error(e)
                continue
            pending.append((batch, inflight, timeline))
            while len(pending) >= self._max_inflight:
                self._complete(*pending.popleft())
        while pending:                  # drain: every dispatched batch
            self._complete(*pending.popleft())   # still delivers

    def _complete(self, batch, inflight, timeline: dict) -> None:
        """Read back one in-flight batch and resolve its futures, in
        dispatch order."""
        try:
            embeddings = self.engine.readback(inflight, timeline=timeline)
        except Exception as e:  # noqa: BLE001 — relayed per request
            for r in batch:
                r.set_error(e)
            return
        t_now = time.perf_counter()
        self.meter.record_batch(inflight.rows, inflight.bucket, t_now)
        lo = 0
        for r in batch:
            # lifecycle and latency recorded BEFORE set_result: a client
            # waking from result() must find its own sample counted
            r.marks.update(timeline)
            r.mark("deliver", t_now)
            self.meter.record_latency(r.latency(t_now))
            self.meter.record_lifecycle(r.lifecycle())
            # per-request COPY, not a view of the batch's buffer
            sl = embeddings[lo:lo + r.rows]
            r.set_result(sl if len(batch) == 1 else sl.copy())
            lo += r.rows
        self._emit_stats()

    def _emit_stats(self, force: bool = False) -> None:
        with self._stats_lock:
            t_now = time.perf_counter()
            if (not force
                    and t_now - self._last_stats < self.stats_interval_s):
                return
            self._last_stats = t_now
            self.meter.emit(self.events, t_now,
                            compile_count=self.engine.compile_count)


# --------------------------------------------------------------------------
# startup: config + weights -> a service
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-only knobs (the model knobs ride in the main Config)."""

    min_bucket: int = 8
    max_bucket: int = 64
    max_queue: int = 256
    max_wait_ms: float = 5.0
    num_classes: int = 10        # probe-head width the weights trained
    stats_interval_s: float = 10.0
    pipeline: str = "on"         # worker dispatch pipelining (off|on)


def _serving_rcfg(cfg, num_classes: int):
    """Resolve a Config without a loader: serving knows its input contract
    from the config alone (image size, channels, probe width).  The sample
    counts only have to satisfy resolve()'s divisibility checks."""
    from byol_tpu_torch.core.config import resolve
    size = cfg.task.image_size_override or 224
    return resolve(cfg, num_train_samples=cfg.task.batch_size,
                   num_test_samples=cfg.task.batch_size,
                   output_size=num_classes, input_shape=(size, size, 3))


def restore_params_for_serving(cfg, checkpoint_dir: str, *,
                               num_classes: int = 10, best: bool = False,
                               epoch: Optional[int] = None
                               ) -> Tuple[torch.nn.Module, int]:
    """``(net, epoch)``: the encoder of ``cfg`` on the CPU, with the
    parameters and BatchNorm statistics of a training checkpoint (the
    directory the trainer writes, ``model_dir/<run name>``): the last one,
    the best with ``best``, or ``epoch``.

    The checkpoint is read on the host and everything but the forward
    pass's weights is dropped there: the optimizer's state and the EMA
    target never reach the card.  Of the JAX package's orbax checkpoint
    only the ``params`` and ``batch_stats`` leaves are read, and a line
    says how many of its keys and bytes that took."""
    from byol_tpu_torch.checkpoint import CheckpointStore
    from byol_tpu_torch.training.build import build_net

    store = CheckpointStore(checkpoint_dir)
    try:
        tree, at_epoch = store.restore(epoch=epoch, best=best,
                                       weights_only=True)
    finally:
        store.close()
    if store.last_read is not None:
        r = store.last_read
        print(f"serve: read the orbax checkpoint of epoch {at_epoch}: "
              f"{r['keys_read']} of {r['keys_total']} keys, "
              f"{r['bytes_read'] / 1e6:.1f} MB in {r['seconds']:.2f}s "
              "(params and batch_stats only)", flush=True)
    weights = {**tree["params"], **tree["batch_stats"]}
    del tree
    net = build_net(_serving_rcfg(cfg, num_classes))
    # strict: every parameter and statistic of the net, shapes checked
    net.load_state_dict(weights, strict=True)
    return net, at_epoch


def build_service(cfg, serve_cfg: ServeConfig, *,
                  checkpoint_dir: str = "", best: bool = False,
                  params: Optional[Mapping[str, Any]] = None,
                  batch_stats: Optional[Mapping[str, Any]] = None,
                  device="cuda",
                  events: Optional[Any] = None,
                  recorder: Optional[Any] = None) -> EmbeddingService:
    """Config (+ weights) -> a constructed (NOT started) EmbeddingService
    on ``device`` (the card unless the caller asks for the CPU).

    ``checkpoint_dir`` names a training run's checkpoint directory
    (:func:`restore_params_for_serving`: the last checkpoint, or the best
    with ``best``).
    ``params``/``batch_stats`` are the numpy trees of
    ``jax.device_get(init_variables(...))`` (``convert.from_flax`` reads
    them).  With neither, the service serves a RANDOM-init encoder drawn
    from ``cfg.device.seed``: meaningless embeddings, identical compute —
    the smoke/bench path.
    """
    from byol_tpu_torch.convert import from_flax
    from byol_tpu_torch.core.preflight import resolve_device
    from byol_tpu_torch.models.layers import store_in_compute_dtype
    from byol_tpu_torch.training.build import build_net
    from byol_tpu_torch.training.linear_eval import frozen_representation_fn

    device = torch.device(device)
    if device.type == "cuda":
        resolve_device(no_cuda=False)   # raises without a card
    # bucket bounds validated BEFORE the model build: a bad --min-bucket/
    # --max-batch must cost an actionable error now
    buckets = BucketSpec(min_bucket=serve_cfg.min_bucket,
                         max_bucket=serve_cfg.max_bucket)
    rcfg = _serving_rcfg(cfg, serve_cfg.num_classes)
    if checkpoint_dir:
        if params is not None:
            raise ValueError("build_service: give checkpoint_dir or params, "
                             "not both")
        net, _ = restore_params_for_serving(
            cfg, checkpoint_dir, num_classes=serve_cfg.num_classes,
            best=best)
    else:
        net = build_net(rcfg)
        if params is not None:
            net.load_state_dict(from_flax(params, batch_stats,
                                          like=net.state_dict()),
                                strict=True)
    net = store_in_compute_dtype(net.to(device))
    represent = frozen_representation_fn(
        net, half=cfg.device.half, normalize=cfg.parity.normalize_inputs)
    engine = ServingEngine(represent, rcfg.input_shape, buckets,
                           device=device, recorder=recorder)
    batcher = DynamicBatcher(max_batch=serve_cfg.max_bucket,
                             max_queue=serve_cfg.max_queue,
                             max_wait_s=serve_cfg.max_wait_ms / 1e3)
    return EmbeddingService(engine, batcher, events=events,
                            stats_interval_s=serve_cfg.stats_interval_s,
                            recorder=recorder,
                            pipeline=serve_cfg.pipeline)
