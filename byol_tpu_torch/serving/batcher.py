"""Request-coalescing dynamic batcher: many small requests, one launch.

A copy of byol_tpu/serving/batcher.py (pure Python; the port imports
nothing of the JAX package).  An embed step at batch 1 wastes almost the
whole card — the same weights are read whether it encodes 1 image or 64,
so per-request dispatch leaves throughput on the floor exactly when
traffic is highest.  The batcher turns concurrent request streams into
coalesced batches:

- **bounded queue with backpressure**: ``submit`` blocks when ``max_queue``
  requests are already waiting and raises :class:`Backpressure` after its
  timeout — an overloaded service degrades by refusing work at the front
  door with a signal load balancers understand, never by growing an
  unbounded queue whose tail latency is infinite;
- **coalescing with a max-wait flush deadline**: the worker opens a batch
  with the first request it dequeues and keeps folding requests in until
  the batch would exceed ``max_batch`` rows or ``max_wait_s`` has elapsed
  since the batch opened — the knob that trades p50 latency (small waits)
  against fill ratio (big batches); a request that would overflow the
  open batch is carried into the next one, never split;
- the flushed row count is then padded UP to a power-of-two bucket
  (serving/buckets.py) by the engine, so coalescing policy and shape
  vocabulary stay independently tunable.

The batcher is pure host-side plumbing, so the policy is reusable for any
step function, not just the embed path.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

# Per-request lifecycle phases, in causal order.  Every completed request
# carries a monotonic-clock stamp for each (``Request.marks``): enqueue is
# stamped at submit, coalesce when its batch flushes, stage/dispatch/
# readback by the engine (batch-level, copied onto every member), deliver
# just before the future resolves.  serving/meter.py folds consecutive
# deltas into the ``phase_ms`` breakdown of ``serve_stats`` events.
LIFECYCLE_PHASES = ("enqueue", "coalesce", "stage", "dispatch",
                    "readback", "deliver")

# process-wide trace ids: the correlation key that follows one request
# through batcher -> engine spans -> future (span ``trace_ids`` attrs)
_TRACE_IDS = itertools.count(1)

# next_batch(block=False) answer for "open but no traffic right now" —
# distinct from None ("closed AND drained"), so a pipelined worker can
# use an idle moment to read back an in-flight batch instead of either
# blocking (deadlocks a closed-loop client waiting on that batch) or
# misreading quiet as shutdown
EMPTY = object()


class Backpressure(RuntimeError):
    """The bounded request queue stayed full past the submit timeout."""


class ServiceClosed(RuntimeError):
    """submit() after stop(): the service is draining, not accepting."""


class Request:
    """One embed request: ``rows`` images in, a future of embeddings out."""

    def __init__(self, images: np.ndarray, trace_id=None) -> None:
        self.images = images
        self.rows = int(images.shape[0])
        self.enqueued_at = time.perf_counter()
        # the caller may bring its own correlation key (the wire layer's
        # X-Request-Id becomes the serving trace id verbatim, so one id
        # follows a request from the client's log through the span ring)
        self.trace_id = next(_TRACE_IDS) if trace_id is None else trace_id
        self.marks: Dict[str, float] = {"enqueue": self.enqueued_at}
        self._done = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    # ---- service side -----------------------------------------------------
    def set_result(self, embeddings: np.ndarray) -> None:
        self._result = embeddings
        self._done.set()

    def set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    # ---- client side ------------------------------------------------------
    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the embeddings are ready; re-raises a service-side
        failure in the CLIENT thread (an embed error belongs to the
        requests in that batch, not to the worker loop)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"embed request ({self.rows} rows) not completed within "
                f"{timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def latency(self, t_now: float) -> float:
        return t_now - self.enqueued_at

    def mark(self, phase: str, t: Optional[float] = None) -> None:
        """Stamp one lifecycle phase (perf_counter clock)."""
        self.marks[phase] = time.perf_counter() if t is None else t

    def lifecycle(self) -> Dict[str, float]:
        """Phase durations (seconds) between consecutive STAMPED phases —
        the per-request latency breakdown.  A completed request covers
        the full LIFECYCLE_PHASES chain; a failed one carries whatever
        phases it reached."""
        out: Dict[str, float] = {}
        prev: Optional[float] = None
        for phase in LIFECYCLE_PHASES:
            t = self.marks.get(phase)
            if t is None:
                continue
            if prev is not None:
                out[phase] = t - prev
            prev = t
        return out


class DynamicBatcher:
    """Bounded request queue + coalescing policy (see module docstring)."""

    def __init__(self, *, max_batch: int, max_queue: int = 256,
                 max_wait_s: float = 0.005) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue[Request]" = queue.Queue(maxsize=max_queue)
        self._carry: Optional[Request] = None   # overflow from last flush
        self._closed = threading.Event()
        # orders every submit's {closed-check + put} against close(): a
        # put that passed the check always COMPLETES before close() can
        # return, so stop()'s post-join fail_pending provably sees every
        # raced request — without the lock a put landing between the
        # worker's exit and fail_pending would strand its future forever
        self._close_lock = threading.Lock()

    # ---- client side ------------------------------------------------------
    def submit(self, images: np.ndarray,
               timeout: Optional[float] = 1.0,
               trace_id=None) -> Request:
        """Enqueue one request; returns its future.

        ``images`` is ``(rows, H, W, C)``; a single image may be passed as
        ``(H, W, C)`` and is lifted to one row.  A request larger than
        ``max_batch`` is rejected outright — it could never flush.
        ``trace_id`` overrides the process-wide counter (the wire front
        end passes its X-Request-Id here).
        """
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4:
            raise ValueError(
                f"request images must be (rows, H, W, C) or (H, W, C), "
                f"got shape {images.shape}")
        if images.shape[0] < 1:
            raise ValueError("request carries zero rows")
        if images.shape[0] > self.max_batch:
            raise ValueError(
                f"request of {images.shape[0]} rows exceeds max_batch "
                f"{self.max_batch}; split it client-side")
        req = Request(images, trace_id=trace_id)
        # Nonblocking enqueue attempts under the lock, waiting OUTSIDE it:
        # holding the lock across a blocking full-queue wait would
        # serialize every saturated submitter (and close()) behind one
        # client's timeout.  Each put_nowait is atomic with the closed
        # check, so a request can only enter the queue while the batcher
        # is provably open — close() (which takes the same lock) then
        # strictly follows, and stop()'s fail_pending sees the request.
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        while True:
            with self._close_lock:
                if self._closed.is_set():
                    raise ServiceClosed("the serving queue is closed")
                try:
                    self._q.put_nowait(req)
                    return req
                except queue.Full:
                    pass
            if deadline is not None and time.perf_counter() >= deadline:
                raise Backpressure(
                    f"request queue full ({self._q.maxsize} waiting) for "
                    f"{timeout}s — the service is saturated; back off "
                    "and retry")
            time.sleep(0.002)

    def depth(self) -> int:
        return self._q.qsize()

    # ---- service side -----------------------------------------------------
    def close(self) -> None:
        """Stop accepting; the worker drains what is queued then exits.
        Taking the lock waits out any in-flight submit, so after close()
        returns, every accepted request is IN the queue (or already
        dispatched) — the precondition fail_pending relies on."""
        with self._close_lock:
            self._closed.set()

    def fail_pending(self, exc: BaseException) -> int:
        """Resolve every still-queued request with ``exc``; returns the
        count.  Called AFTER the worker has exited: a submit() racing
        close() (checked the flag, then put into the queue the worker had
        already drained) would otherwise leave a future nobody ever sets,
        and its client blocked forever."""
        failed = 0
        if self._carry is not None:
            self._carry.set_error(exc)
            self._carry = None
            failed += 1
        while True:
            try:
                self._q.get_nowait().set_error(exc)
                failed += 1
            except queue.Empty:
                return failed

    def next_batch(self, poll_s: float = 0.05, *,
                   block: bool = True) -> Optional[List[Request]]:
        """Dequeue one coalesced batch; ``None`` means closed AND drained.

        Policy: block for the first request (polling so close() is
        noticed), then keep folding requests in until ``max_batch`` rows
        are reached or ``max_wait_s`` has passed since the batch opened.
        A request that would overflow is carried — the flush never splits
        or reorders requests, so results map back trivially.

        ``block=False`` returns :data:`EMPTY` instead of waiting when no
        request is immediately available (and the batcher is open): the
        pipelined worker's "anything to overlap with?" probe.  A carried
        overflow request counts as immediately available.
        """
        first = self._carry
        self._carry = None
        while first is None:
            try:
                first = (self._q.get(timeout=poll_s) if block
                         else self._q.get_nowait())
            except queue.Empty:
                if self._closed.is_set():
                    return None
                if not block:
                    return EMPTY
        batch, rows = [first], first.rows
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if rows + nxt.rows > self.max_batch:
                self._carry = nxt
                break
            batch.append(nxt)
            rows += nxt.rows
        # the batch is final: stamp every member's coalesce phase with ONE
        # clock read (enqueue -> coalesce = queue wait + coalesce wait,
        # the batching policy's contribution to that request's latency)
        t_flush = time.perf_counter()
        for r in batch:
            r.mark("coalesce", t_flush)
        return batch
