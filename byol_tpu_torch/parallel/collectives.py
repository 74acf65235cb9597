"""Collectives over the data axis (counterpart of
byol_tpu/parallel/collectives.py).

Without a process group each is the identity of a one-rank world, so the
one-card paths need no group.  :func:`psum`, :func:`pmean` and
:func:`all_gather` are differentiable: the backward of a sum over ranks
sums the ranks' gradients (what ``torch.distributed.nn.functional``
computes; torch 2.13 deprecates that module, so the port keeps its own
two autograd functions).  The in-place helpers serve the flat buffers of
the train step: the gradient all-reduce, the ZeRO-1 reduce-scatter and
all-gathers.  A failed collective raises; nothing falls back.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from byol_tpu_torch.parallel.mesh import (DATA_AXIS, is_initialized, rank,
                                          world_size)

# torch 2.13 renames the two flat-tensor collectives (the old names warn)
_all_gather_flat = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)
_reduce_scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        out = x.new_empty((world_size() * x.shape[0],) + x.shape[1:])
        _all_gather_flat(out, x)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad.chunk(world_size())[rank()]


def psum(x: torch.Tensor, axis_name: str = DATA_AXIS) -> torch.Tensor:
    """Sum over the ranks, differentiable."""
    _axis(axis_name)
    return _AllReduceSum.apply(x) if is_initialized() else x


def pmean(x: torch.Tensor, axis_name: str = DATA_AXIS) -> torch.Tensor:
    return psum(x, axis_name) / world_size()


def all_gather(x: torch.Tensor, axis_name: str = DATA_AXIS, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``axis`` in rank order (JAX's
    ``tiled=True``), differentiable."""
    _axis(axis_name)
    if not tiled:
        raise NotImplementedError("all_gather(tiled=False) is not used by "
                                  "the port")
    if not is_initialized():
        return x
    moved = x.movedim(axis, 0)
    return _AllGather.apply(moved).movedim(0, axis)


def ppermute_shift(x: torch.Tensor, axis_name: str = "sequence",
                   shift: int = 1) -> torch.Tensor:
    raise NotImplementedError(
        "ppermute_shift (the ring-attention shift over the sequence axis) "
        "is not ported to byol_tpu_torch yet (ROADMAP.md, section 1 item 14)")


def axis_index(axis_name: str = DATA_AXIS) -> int:
    _axis(axis_name)
    return rank()


def psum_(x: torch.Tensor) -> torch.Tensor:
    """In-place sum over the ranks, no autograd; returns ``x``."""
    if is_initialized():
        dist.all_reduce(x)
    return x


def grad_allreduce_mean(buf: torch.Tensor) -> torch.Tensor:
    """In place: the mean of the ranks' ``buf`` (the flat gradient buffer,
    once an optimizer step).  A sum then a division by the world size:
    gloo has no AVG, and one rank's division by 1 is exact."""
    if is_initialized():
        dist.all_reduce(buf)
        buf.div_(world_size())
    return buf


def reduce_scatter_mean(out: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``out`` = this rank's chunk of the ranks' mean of ``buf`` (world
    equal chunks, in rank order)."""
    if not is_initialized():
        return out.copy_(buf)
    _reduce_scatter_flat(out, buf)
    return out.div_(world_size())


def all_gather_into(buf: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """``buf`` = the ranks' ``chunk`` in rank order; ``chunk`` may be this
    rank's own slice of ``buf`` (in place)."""
    if is_initialized():
        _all_gather_flat(buf, chunk)
    elif buf.data_ptr() != chunk.data_ptr():
        buf.copy_(chunk)
    return buf


def broadcast_(x: torch.Tensor, src: int) -> torch.Tensor:
    if is_initialized():
        dist.broadcast(x, src)
    return x


def _axis(axis_name: str) -> None:
    if axis_name != DATA_AXIS:
        raise NotImplementedError(
            f"axis {axis_name!r}: the port's mesh has the data axis only "
            "(ROADMAP.md, section 1 item 14)")
