"""ServingEngine: the frozen encoder per power-of-two bucket, on the card.

Counterpart of byol_tpu/serving/engine.py, with the same public surface
(``warmup``, ``dispatch``, ``readback``, ``embed``, ``compile_count``,
``describe``).  PyTorch runs eagerly, so there is no executable to compile
per bucket; what a first call of a shape pays instead is the kernel build
and cuBLAS/cuDNN's algorithm choice.  So:

- :meth:`warmup` runs every bucket once and counts it in
  :attr:`compile_count`; after warmup the count must not grow (a test pins
  it).  CUDA graphs per bucket are later work.
- Request rows are assembled into a reusable per-bucket **pinned** host
  staging buffer and copied to the card in one ``non_blocking`` transfer on
  the current stream.  Each bucket keeps TWO buffers that alternate, and a
  buffer is rewritten only after the event recorded behind its last copy
  has completed: under the pipelined worker, batch ``i``'s copy may still
  be reading the buffer while the host stages batch ``i+1``.
- :meth:`dispatch` launches the work and returns without synchronising;
  :meth:`readback` waits on the batch's CUDA event, then copies D2H.

On the CPU (the tests) the same code runs without pinning or events.

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
from byol_tpu_torch.serving.buckets import BucketSpec

# staging buffers per bucket: one being consumed by an in-flight batch,
# one free to write — matches the worker's pipeline depth of 2
_STAGING_SLOTS = 2


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
                 device: torch.device, recorder: Any = None) -> None:
        self._represent = represent_fn
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
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
    def _stage(self, rows: np.ndarray, bucket: int) -> torch.Tensor:
        """rows -> padded (bucket, H, W, C) batch on the engine's device,
        through the bucket's next pinned staging buffer (zeroed pad tail:
        stale rows of an earlier batch must never alias into this one)."""
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
        staged = buf.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._copied[bucket][flip] = event
        return staged

    # ---- warmup -----------------------------------------------------------
    def _compile(self, bucket: int) -> None:
        """Run one bucket once: builds the kernels at first use and lets
        cuBLAS/cuDNN pick their algorithms for this shape."""
        x = torch.zeros((bucket,) + self.input_shape, dtype=self._torch_dtype,
                        device=self.device)
        t0 = time.perf_counter()
        with self._recorder.span("startup/compile", bucket=bucket):
            self._represent(x)
            if self._cuda:
                torch.cuda.synchronize(self.device)
        self.compile_seconds[bucket] = time.perf_counter() - t0
        self._warm.add(bucket)
        self.compile_count += 1

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
        with self._recorder.span("serve/stage", bucket=bucket, rows=n):
            staged = self._stage(rows, bucket)
        if timeline is not None:
            timeline["stage"] = time.perf_counter()
        with self._recorder.span("serve/dispatch", bucket=bucket):
            out = self._represent(staged)
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
        }
