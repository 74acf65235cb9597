"""The port's ``prefetch_to_device`` and its input meter on the CPU: the
contract of the JAX ``prefetch_to_mesh`` (order, the in-flight bound, an
exception's position, no thread left after ``close()``) and the meter's
readout, with the JAX package's own meter fed the same records."""
import threading
import time

import numpy as np
import pytest
import torch

from byol_tpu.observability.meters import InputPipelineMeter as JaxMeter
from byol_tpu.observability.meters import input_log_line as jax_line
from byol_tpu_torch.data.prefetch import host_nbytes, prefetch_to_device
from byol_tpu_torch.observability.meters import (InputPipelineMeter,
                                                 input_log_line)


def _batches(n, log=None):
    for i in range(n):
        if log is not None:
            log.append(i)
        yield {"x": np.full((2, 3), i, np.float32),
               "label": np.array([i, i], np.int32)}


def _threads():
    return [t for t in threading.enumerate()
            if t.name == "prefetch_to_device"]


def test_order_and_tensors():
    meter = InputPipelineMeter()
    got = list(prefetch_to_device(_batches(7), "cpu", size=2, meter=meter))
    assert [int(b["x"][0, 0]) for b in got] == list(range(7))
    assert all(torch.is_tensor(b["x"]) and b["x"].dtype == torch.float32
               for b in got)
    assert meter.batches_produced == meter.batches_consumed == 7
    assert meter.h2d_bytes == 7 * (24 + 8) == 7 * host_nbytes(
        next(_batches(1)))


@pytest.mark.parametrize("size", [1, 2, 3])
def test_at_most_size_batches_staged(size):
    """The producer takes a slot before it stages a batch: pulled from the
    source minus handed out never exceeds size + 1 (one batch pulled and
    waiting for its slot)."""
    pulled = []
    gen = prefetch_to_device(_batches(20, pulled), "cpu", size=size)
    for i, _ in enumerate(gen):
        time.sleep(0.02)              # let the producer run as far as it may
        assert len(pulled) - (i + 1) <= size + 1, (i, len(pulled))
    assert len(pulled) == 20


def test_source_exception_comes_after_the_batches_before_it():
    def failing():
        yield from _batches(3)
        raise KeyError("source broke")

    seen = []
    with pytest.raises(KeyError, match="source broke"):
        for b in prefetch_to_device(failing(), "cpu", size=2):
            seen.append(int(b["x"][0, 0]))
    assert seen == [0, 1, 2]


def test_close_joins_the_producer():
    gen = prefetch_to_device(_batches(1000), "cpu", size=2)
    next(gen)
    assert _threads()
    gen.close()
    deadline = time.time() + 10
    while _threads() and time.time() < deadline:
        time.sleep(0.01)
    assert not _threads()


def test_size_must_be_positive():
    with pytest.raises(ValueError):
        next(prefetch_to_device(_batches(1), "cpu", size=0))


def test_meter_readout_matches_jax():
    ours, theirs = InputPipelineMeter(), JaxMeter()
    for meter in (ours, theirs):
        meter.record_produced(1 << 20, 2)
        meter.record_produced(3 << 20, 1)
        meter.record_first_fill(0.25)
        meter.record_wait(0.001)
        meter.record_wait(0.5)
    assert ours.result() == theirs.result()
    assert input_log_line(3, ours) == jax_line(3, theirs)
    assert ours.starved_steps == 1
