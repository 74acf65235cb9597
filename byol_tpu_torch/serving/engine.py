"""ServingEngine: the frozen encoder per power-of-two bucket, on the card.

Counterpart of byol_tpu/serving/engine.py, with the same public surface
(``warmup``, ``dispatch``, ``readback``, ``embed``, ``compile_count``,
``describe``).  The JAX engine compiles one executable per bucket ahead of
time; on the card this engine captures one **CUDA graph** per bucket:

- :meth:`warmup` runs each bucket eagerly first (the kernel library's
  build, K3's shared-memory attribute, cuBLAS/cuDNN's algorithm choice),
  then captures it once into a ``torch.cuda.CUDAGraph`` that owns a static
  ``(bucket, H, W, C)`` input and a static output.  All buckets share one
  memory pool.  :attr:`compile_count` counts captures; after warmup it
  must not grow (a test pins it).  A capture that fails raises: nothing
  falls back to eager on the card.
- Request rows are assembled into a reusable per-bucket **pinned** host
  staging buffer and copied to the card in one ``non_blocking`` transfer on
  the current stream, straight into the graph's static input.  Each bucket
  keeps TWO buffers that alternate, and a buffer is rewritten only after
  the event recorded behind its last copy has completed: under the
  pipelined worker, batch ``i``'s copy may still be reading the buffer
  while the host stages batch ``i+1``.
- :meth:`dispatch` copies, replays the graph, and **clones** the static
  output into a tensor outside the graph pool before recording the batch's
  event, all on one stream: under ``--pipeline on`` batch ``i+1`` replays
  before batch ``i`` is read back, and a replay rewrites its static output
  (graphs sharing a pool may also reuse each other's output memory).  It
  returns without synchronising; :meth:`readback` waits on the batch's
  CUDA event, then copies D2H.
- A replay launches no kernel through the wrappers, so their ``LAUNCHES``
  counters do not tick.  The engine records, per bucket, the launches its
  capture made (read from the counters around the capture) and its
  replays; :meth:`describe` exposes both, so launches per batch can be
  derived.

``graphs=False`` keeps the card on the eager path (every batch runs the
encoder's kernels one by one): the yardstick the graphs are held against.
On the CPU (the tests) the engine is eager, without pinning or events.

Threading contract: :meth:`dispatch`/:meth:`readback`/:meth:`embed` are
called by ONE thread (the service worker).  Construction and warmup happen
before the worker starts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from byol_tpu_torch.observability import spans as spans_lib
from byol_tpu_torch.ops import flash_attention, fused_augment, fused_update
from byol_tpu_torch.serving.buckets import BucketSpec

# staging buffers per bucket: one being consumed by an in-flight batch,
# one free to write — matches the worker's pipeline depth of 2
_STAGING_SLOTS = 2
# eager runs of a bucket before its capture
_WARM_RUNS = 2


def kernel_launches() -> Dict[str, int]:
    """The port's kernel wrappers' launch counters, by kernel name."""
    return {"flash_attention": flash_attention.LAUNCHES,
            "segment_norms": fused_update.SEGMENT_NORMS_LAUNCHES,
            "fused_apply": fused_update.FUSED_APPLY_LAUNCHES,
            "two_view": fused_augment.LAUNCHES}


@dataclasses.dataclass
class _BucketGraph:
    """One bucket's captured encoder: replaying ``graph`` reads ``inp`` and
    writes ``out``."""

    graph: torch.cuda.CUDAGraph
    inp: torch.Tensor                    # (bucket, H, W, C) static input
    out: torch.Tensor                    # (bucket, D) static output
    launches: Dict[str, int]             # kernel launches of the capture
    replays: int = 0


@dataclasses.dataclass
class InFlightBatch:
    """A dispatched-but-not-read-back batch."""

    out: torch.Tensor                    # (bucket, D) on the engine's device
    rows: int                            # real rows in the batch
    bucket: int                          # padded bucket it ran at
    done: Optional[torch.cuda.Event]     # recorded after the batch's work


class ServingEngine:
    """Per-bucket warm shapes around one frozen representation fn."""

    def __init__(self, represent_fn: Callable[[torch.Tensor], torch.Tensor],
                 input_shape: Tuple[int, int, int], buckets: BucketSpec, *,
                 device: torch.device, recorder: Any = None,
                 graphs: bool = True) -> None:
        self.represent = represent_fn
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.graphs = graphs and self._cuda
        self._graphs: Dict[int, _BucketGraph] = {}
        self._pool = None                # the graphs' shared memory pool
        self.input_shape = tuple(input_shape)
        self.input_dtype = np.dtype(np.float32)     # [0, 1] pixels, as JAX
        self._torch_dtype = torch.float32
        self.buckets = buckets
        self._warm: set = set()
        self._staging: Dict[int, List[torch.Tensor]] = {}
        self._copied: Dict[int, List[Optional[torch.cuda.Event]]] = {}
        self._staging_flip: Dict[int, int] = {}
        self.compile_count = 0
        self.compile_seconds: Dict[int, float] = {}
        self._recorder = recorder if recorder is not None else spans_lib.NULL

    # ---- staging ----------------------------------------------------------
    def _stage(self, rows: np.ndarray, bucket: int,
               into: Optional[torch.Tensor] = None) -> torch.Tensor:
        """rows -> padded (bucket, H, W, C) batch on the engine's device,
        through the bucket's next pinned staging buffer (zeroed pad tail:
        stale rows of an earlier batch must never alias into this one);
        copied into ``into`` (a graph's static input) when given."""
        bufs = self._staging.get(bucket)
        if bufs is None:
            bufs = [torch.zeros((bucket,) + self.input_shape,
                                dtype=self._torch_dtype,
                                pin_memory=self._cuda)
                    for _ in range(_STAGING_SLOTS)]
            self._staging[bucket] = bufs
            self._copied[bucket] = [None] * _STAGING_SLOTS
            self._staging_flip[bucket] = 0
        flip = self._staging_flip[bucket]
        self._staging_flip[bucket] = (flip + 1) % _STAGING_SLOTS
        copied = self._copied[bucket][flip]
        if copied is not None:
            copied.synchronize()        # the buffer's last H2D has finished
        buf = bufs[flip]
        host = buf.numpy()
        n = rows.shape[0]
        host[:n] = rows
        if n < bucket:
            host[n:] = 0
        if not self._cuda:
            return buf
        staged = (buf.to(self.device, non_blocking=True) if into is None
                  else into.copy_(buf, non_blocking=True))
        event = torch.cuda.Event()
        event.record()
        self._copied[bucket][flip] = event
        return staged

    # ---- warmup -----------------------------------------------------------
    def _compile(self, bucket: int) -> None:
        """Run one bucket eagerly: builds the kernels at first use and lets
        cuBLAS/cuDNN pick their algorithms for this shape; under graphs,
        then capture it."""
        x = torch.zeros((bucket,) + self.input_shape, dtype=self._torch_dtype,
                        device=self.device)
        t0 = time.perf_counter()
        with self._recorder.span("startup/compile", bucket=bucket):
            if self.graphs:
                self._capture(bucket, x)
            else:
                self.represent(x)
            if self._cuda:
                torch.cuda.synchronize(self.device)
        self.compile_seconds[bucket] = time.perf_counter() - t0
        self._warm.add(bucket)
        self.compile_count += 1

    def _capture(self, bucket: int, static_in: torch.Tensor) -> None:
        """Warm ``bucket`` on a side stream, then capture it into a CUDA
        graph over ``static_in``; a failed capture raises."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(_WARM_RUNS):
                self.represent(static_in)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = kernel_launches()
        # thread_local: another thread's CUDA call must not invalidate the
        # capture, and this thread's own unsafe call still raises
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            static_out = self.represent(static_in)
        after = kernel_launches()
        self._graphs[bucket] = _BucketGraph(
            graph=graph, inp=static_in, out=static_out,
            launches={k: after[k] - before[k] for k in after
                      if after[k] != before[k]})

    def warmup(self) -> None:
        """Warm the full bucket vocabulary up front.  After this, a growing
        :attr:`compile_count` is a bug by contract."""
        for b in self.buckets.sizes:
            if b not in self._warm:
                self._compile(b)

    # ---- the hot path -----------------------------------------------------
    def dispatch(self, rows: np.ndarray,
                 timeline: Optional[Dict[str, float]] = None
                 ) -> InFlightBatch:
        """Stage ``(n, H, W, C)`` rows and launch the encoder on them;
        returns without waiting for the card.  Warms the bucket first only
        if warmup never touched it.  ``timeline`` receives the ``stage``
        and ``dispatch`` stamps (batcher.LIFECYCLE_PHASES)."""
        n = rows.shape[0]
        bucket = self.buckets.bucket_for(n)
        if bucket not in self._warm:
            self._compile(bucket)
        captured = self._graphs.get(bucket)
        with self._recorder.span("serve/stage", bucket=bucket, rows=n):
            staged = self._stage(rows, bucket,
                                 None if captured is None else captured.inp)
        if timeline is not None:
            timeline["stage"] = time.perf_counter()
        with self._recorder.span("serve/dispatch", bucket=bucket):
            if captured is None:
                out = self.represent(staged)
            else:
                captured.graph.replay()
                captured.replays += 1
                # the next replay rewrites the static output: this batch
                # keeps its own copy, ordered after the replay
                out = captured.out.clone()
            done = None
            if self._cuda:
                done = torch.cuda.Event()
                done.record()
        if timeline is not None:
            timeline["dispatch"] = time.perf_counter()
        return InFlightBatch(out=out, rows=n, bucket=bucket, done=done)

    def readback(self, inflight: InFlightBatch,
                 timeline: Optional[Dict[str, float]] = None
                 ) -> np.ndarray:
        """Wait for one in-flight batch, copy it to the host and undo the
        bucket padding -> ``(n, D)`` fp32 embeddings."""
        n, bucket = inflight.rows, inflight.bucket
        with self._recorder.span("serve/readback", bucket=bucket):
            if inflight.done is not None:
                inflight.done.synchronize()
            host = inflight.out.cpu().numpy()
        if timeline is not None:
            timeline["readback"] = time.perf_counter()
        # copy when padded: a [:n] VIEW would pin the full (bucket, D)
        # buffer for as long as any caller holds the result
        return host if n == bucket else host[:n].copy()

    def embed(self, rows: np.ndarray,
              timeline: Optional[Dict[str, float]] = None) -> np.ndarray:
        """Dispatch + immediate readback (the unpipelined path)."""
        return self.readback(self.dispatch(rows, timeline), timeline)

    def describe(self) -> Dict[str, Any]:
        return {
            "buckets": list(self.buckets.sizes),
            "input_shape": list(self.input_shape),
            "input_dtype": str(self.input_dtype),
            "compile_count": self.compile_count,
            "compile_seconds": {str(k): round(v, 3)
                                for k, v in self.compile_seconds.items()},
            "pinned_host_staging": self._cuda,
            "device": str(self.device),
            "graphs": self.graphs,
            "capture_launches": {str(b): dict(g.launches)
                                 for b, g in sorted(self._graphs.items())},
            "replays": {str(b): g.replays
                        for b, g in sorted(self._graphs.items())},
        }
