"""Lockstep iteration across ranks (counterpart of
byol_tpu/parallel/lockstep.py).

Per-rank eval shards can differ by a batch (interleaved image_folder
shards, the test batches dealt round-robin).  When each round of a loop
ends in a collective, a rank that drained its shard and left the loop
would leave the others blocked in the next one.  So every round, each
rank all-gathers one status (0 drained, 1 has data, 2 raised): the loop
runs while any rank has data, a drained rank yields ``pad_fn()``, and a
rank whose iterator raised fails every rank in the same round instead of
hanging them.  Without a process group this is plain iteration.
"""
from __future__ import annotations

from typing import Callable, Iterator, TypeVar

import numpy as np
import torch
import torch.distributed as dist

from byol_tpu_torch.parallel.mesh import (control_group, is_initialized,
                                          world_size)

T = TypeVar("T")


def all_status(status: int) -> np.ndarray:
    """One small status code per rank, gathered on the host (no device
    sync); shape (world,)."""
    if not is_initialized():
        return np.asarray([status])
    mine = torch.tensor([status], dtype=torch.int32)
    out = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(out, mine, group=control_group())
    return torch.cat(out).numpy()


def any_rank(flag: bool) -> bool:
    """True when ``flag`` is set on any rank."""
    return bool(all_status(int(flag)).any())


def lockstep_iter(batches: Iterator[T], pad_fn: Callable[[], T]
                  ) -> Iterator[T]:
    """Yield the local batches in lockstep with the other ranks; a rank
    that drained early yields ``pad_fn()`` until every rank has."""
    it = iter(batches)
    single = not is_initialized()
    while True:
        err = None
        try:
            batch = next(it, None)
        except Exception as e:
            batch, err = None, e
        if single:
            if err is not None:
                raise err
            if batch is None:
                return
            yield batch
            continue
        statuses = all_status(2 if err is not None
                              else (1 if batch is not None else 0))
        if (statuses == 2).any():
            if err is not None:
                raise err
            raise RuntimeError(
                f"iterator failed on rank(s) "
                f"{np.nonzero(statuses == 2)[0].tolist()}; failing in "
                "lockstep instead of deadlocking")
        if not (statuses == 1).any():
            return
        yield batch if batch is not None else pad_fn()
