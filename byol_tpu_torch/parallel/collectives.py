"""Collectives over the mesh's axes (counterpart of
byol_tpu/parallel/collectives.py).

Each takes JAX's ``axis_name`` (``data``, ``sequence`` or ``model``) and
runs over this rank's group along that axis (parallel/mesh.py); without a
process group, or along an axis of size 1, each is the identity of a
one-rank world, so the one-card paths need no group.  :func:`psum`,
:func:`pmean` and :func:`all_gather` are differentiable: the backward of a
sum over ranks sums the ranks' gradients (what
``torch.distributed.nn.functional`` computes; torch 2.13 deprecates that
module, so the port keeps its own autograd functions).
:func:`ppermute_shift` is JAX's ``lax.ppermute`` ring shift over the
sequence group (paired P2P sends and receives), whose backward shifts the
gradient back.  The in-place helpers serve the flat buffers of the train
step over the data axis: the gradient all-reduce, the ZeRO-1
reduce-scatter, all-gathers and broadcasts; in a world laid out over a
sequence or model axis whose data axis is 1 they run nothing.
:func:`copy_to_model` and :func:`reduce_from_model` are Megatron's pair
around a tensor-parallel block over the model axis: the identity forward
with a sum of the gradients backward, and a sum forward with the
identity backward (:func:`psum` sums in both directions, which would
multiply every gradient of the block by the model axis's size).  A failed
collective raises; nothing falls back.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from byol_tpu_torch.parallel import mesh
from byol_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                          SEQUENCE_AXIS, is_initialized)

# torch 2.13 renames the two flat-tensor collectives (the old names warn)
_all_gather_flat = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)
_reduce_scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.size, ctx.index = group, size, index
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0],) + x.shape[1:])
        _all_gather_flat(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.chunk(ctx.size)[ctx.index], None, None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, whose gradient is summed over the model axis's
    ranks: the input of a tensor-parallel block, which each rank feeds
    into its own shard."""
    if not _grouped(MODEL_AXIS):
        return x
    return _CopyToModel.apply(x, mesh.axis_group(MODEL_AXIS))


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model axis's ranks of their partial ``x``, whose
    gradient passes to each rank as it is: the output of a
    tensor-parallel block."""
    if not _grouped(MODEL_AXIS):
        return x
    return _ReduceFromModel.apply(x, mesh.axis_group(MODEL_AXIS))


def model_sum_(x: torch.Tensor) -> torch.Tensor:
    """In-place sum over the model axis's ranks, no autograd; the
    identity at a model axis of 1."""
    if _grouped(MODEL_AXIS):
        dist.all_reduce(x, group=mesh.axis_group(MODEL_AXIS))
    return x


def _data_grouped() -> bool:
    """The in-place data-axis helpers run: over a data axis of more than
    one rank, or in a world of one rank with a group (torchrun with one
    process), whose one-rank collectives are the larger worlds' code
    path on one card.  A lone data rank of a larger world (its ranks on
    the sequence or model axis) runs none: a sum over one rank is
    exact."""
    return is_initialized() and (mesh.axis_size(DATA_AXIS) > 1
                                 or mesh.world_size() == 1)


def _grouped(axis_name: str) -> bool:
    """A collective along ``axis_name`` has ranks to talk to: a process
    group, and (off the data axis, whose world-1 group keeps today's
    arithmetic) more than one rank along the axis."""
    size = mesh.axis_size(axis_name)
    if not is_initialized():
        return False
    return axis_name == DATA_AXIS or size > 1


def psum(x: torch.Tensor, axis_name: str = DATA_AXIS) -> torch.Tensor:
    """Sum over the axis's ranks, differentiable."""
    if not _grouped(axis_name):
        return x
    return _AllReduceSum.apply(x, mesh.axis_group(axis_name))


def pmean(x: torch.Tensor, axis_name: str = DATA_AXIS) -> torch.Tensor:
    return psum(x, axis_name) / mesh.axis_size(axis_name)


def all_gather(x: torch.Tensor, axis_name: str = DATA_AXIS, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The axis's ranks' ``x`` concatenated along ``axis`` in axis order
    (JAX's ``tiled=True``), differentiable; the backward sums the ranks'
    gradients and keeps this rank's block."""
    if not tiled:
        raise NotImplementedError("all_gather(tiled=False) is not used by "
                                  "the port")
    if not _grouped(axis_name):
        return x
    moved = x.movedim(axis, 0)
    return _AllGather.apply(moved, mesh.axis_group(axis_name),
                            mesh.axis_size(axis_name),
                            mesh.axis_index(axis_name)).movedim(0, axis)


def _shift(x: torch.Tensor, axis_name: str, shift: int) -> torch.Tensor:
    """``x`` of the rank ``shift`` places before this one along the axis:
    one send to the rank ``shift`` after and one receive, paired."""
    ranks, i = mesh.axis_ranks(axis_name), mesh.axis_index(axis_name)
    n = len(ranks)
    x = x.contiguous()
    out = torch.empty_like(x)
    group = mesh.axis_group(axis_name)
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _PPermuteShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, shift):
        ctx.axis_name, ctx.shift = axis_name, shift
        return _shift(x, axis_name, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.axis_name, -ctx.shift), None, None


def ppermute_shift(x: torch.Tensor, axis_name: str = SEQUENCE_AXIS,
                   shift: int = 1) -> torch.Tensor:
    """JAX's ``lax.ppermute(x, axis_name, [(j, (j + shift) % n)])``: rank j
    of the axis sends ``x`` to rank j + shift and returns what rank
    j - shift sent, differentiable (the backward shifts the gradient by
    ``-shift``).  The identity on an axis of size 1."""
    if not is_initialized() or mesh.axis_size(axis_name) == 1 \
            or shift % mesh.axis_size(axis_name) == 0:
        return x
    return _PPermuteShift.apply(x, axis_name, shift)


def axis_index(axis_name: str = DATA_AXIS) -> int:
    return mesh.axis_index(axis_name)


def psum_(x: torch.Tensor) -> torch.Tensor:
    """In-place sum over the data axis's ranks, no autograd; returns
    ``x``."""
    if _data_grouped():
        dist.all_reduce(x, group=mesh.axis_group(DATA_AXIS))
    return x


def grad_allreduce_mean(buf: torch.Tensor) -> torch.Tensor:
    """In place: the mean of the data ranks' ``buf`` (the flat gradient
    buffer, once an optimizer step).  A sum then a division by the data
    axis's size: gloo has no AVG, and one rank's division by 1 is
    exact."""
    if _data_grouped():
        dist.all_reduce(buf, group=mesh.axis_group(DATA_AXIS))
        buf.div_(mesh.axis_size(DATA_AXIS))
    return buf


def reduce_scatter_mean(out: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``out`` = this data rank's chunk of the data ranks' mean of ``buf``
    (equal chunks, in data order)."""
    if not is_initialized():
        return out.copy_(buf)
    _reduce_scatter_flat(out, buf, group=mesh.axis_group(DATA_AXIS))
    return out.div_(mesh.axis_size(DATA_AXIS))


def all_gather_into(buf: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """``buf`` = the data ranks' ``chunk`` in data order; ``chunk`` may be
    this rank's own slice of ``buf`` (in place)."""
    if is_initialized():
        _all_gather_flat(buf, chunk, group=mesh.axis_group(DATA_AXIS))
    elif buf.data_ptr() != chunk.data_ptr():
        buf.copy_(chunk)
    return buf


def broadcast_(x: torch.Tensor, src: int) -> torch.Tensor:
    """``x`` of data rank ``src`` on every rank of this data group."""
    if _data_grouped():
        dist.broadcast(x, mesh.axis_ranks(DATA_AXIS)[src],
                       group=mesh.axis_group(DATA_AXIS))
    return x
