"""Device prefetch (counterpart of byol_tpu/data/prefetch.py,
``prefetch_to_mesh``): while the card runs step N, a producer thread
makes batch N+1 on the host and copies it to the card.

On a CUDA device the producer copies each host tensor from pinned memory
on a side stream, records an event after the copies, and the consumer's
stream waits on that event before the batch is handed out;
``record_stream`` tells the caching allocator that the consumer's stream
uses the batch, so its memory is not reused before that work is done.  A
loader that makes its batches on the card (``data_backend='device'``)
runs that work in the producer thread, on the same side stream.  On the
CPU it is the same thread without streams.

The contract of the JAX function:

- batches come out in the iterator's order;
- at most ``size`` batches are staged beyond the one being consumed;
- an exception raised by the source iterator reaches the consumer after
  the batches produced before it, where a plain loop would have raised;
- closing the generator (``break``, ``.close()``) stops the producer and
  joins its thread.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from byol_tpu_torch.observability import spans as spans_lib
from byol_tpu_torch.observability.meters import InputPipelineMeter

_END = object()          # producer sentinel: source iterator exhausted


class _Failure:
    """Carries a producer-side exception across the queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def host_nbytes(batch) -> int:
    """Bytes one batch ships into the pipeline, from array metadata only
    (a loader that makes its views on the card is counted at the views'
    size, as the JAX meter counts them)."""
    return sum(v.numel() * v.element_size() if torch.is_tensor(v)
               else np.asarray(v).nbytes for v in batch.values())


def _to_device(value, device: torch.device) -> torch.Tensor:
    t = value if torch.is_tensor(value) else torch.from_numpy(
        np.asarray(value))
    if t.device == device or device.type != "cuda":
        return t
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def prefetch_to_device(iterator: Iterator, device, size: int = 2,
                       meter: Optional[InputPipelineMeter] = None,
                       recorder=spans_lib.NULL
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the iterator's batches (dicts of arrays or tensors) as
    dicts of tensors on ``device``, keeping up to ``size`` in flight.

    ``meter``: the producer records each batch's bytes and the queue depth
    it leaves; the consumer its wait for the next batch (the first one as
    the pipeline's fill).

    ``recorder`` (observability.spans.SpanRecorder): each consumer wait
    becomes an ``input/fill`` (first batch) or ``input/wait`` span, in the
    consumer's thread, so it never overlaps the trainer's other top-level
    spans; goodput.py counts it as ``input_wait``."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:     # "cuda" names the current card
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device) if cuda else None
    # the slots, not the queue, bound what is staged: the producer takes a
    # slot before it copies a batch, the consumer frees it on hand-out
    q: "queue.Queue" = queue.Queue()
    slots = threading.Semaphore(size)
    stop = threading.Event()

    def produce():
        try:
            with (torch.cuda.stream(side) if cuda
                  else contextlib.nullcontext()):
                for batch in iterator:
                    while not slots.acquire(timeout=0.1):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    staged = {k: _to_device(v, device)
                              for k, v in batch.items()}
                    ready = None
                    if cuda:
                        ready = torch.cuda.Event()
                        ready.record(side)
                    q.put((staged, ready))
                    if meter is not None:
                        meter.record_produced(host_nbytes(batch), q.qsize())
            item = _END
        except BaseException as e:   # noqa: BLE001 — relayed, not dropped
            item = _Failure(e)
        q.put(item)                  # unbounded queue: never blocks

    thread = threading.Thread(target=produce, name="prefetch_to_device",
                              daemon=True)
    thread.start()
    try:
        first = True
        while True:
            t0 = time.perf_counter()
            with recorder.span("input/fill" if first else "input/wait"):
                item = q.get()
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.exc
            if meter is not None:
                dt = time.perf_counter() - t0
                if first:
                    meter.record_first_fill(dt)
                else:
                    meter.record_wait(dt)
            first = False
            staged, ready = item
            if cuda:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for t in staged.values():
                    if t.device == device:
                        t.record_stream(stream)
            slots.release()
            yield staged
    finally:
        stop.set()
        thread.join(timeout=5.0)
