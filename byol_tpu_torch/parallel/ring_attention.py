"""Ring attention over the sequence axis (counterpart of
byol_tpu/parallel/ring_attention.py).

Each rank of a sequence group keeps its block of S/N queries and its
block of K/V; the K/V blocks ROTATE around the group's ring (paired P2P
sends and receives, parallel/collectives.py::ppermute_shift, JAX's
``lax.ppermute``), and every rank folds each visiting block into an online
softmax for its queries: scores in the input dtype, then fp32 statistics
(float64 for a float64 net), ``NEG_INF = -1e30``, N steps.  The S x S
matrix never exists anywhere.  The ops are plain torch under autograd;
the backward of each shift is the opposite shift.

Two entry points, as in JAX:

- :func:`ring_attention_local`: the per-rank body on this rank's blocks;
- :func:`ring_attention`: the drop-in ``attn_impl='ring'`` function on the
  full (B, H, S, D) q, k and v, with JAX's divisibility check.

The layout mirrors what GSPMD gives JAX, where only attention is sharded
over ``sequence``: activations outside attention are replicated across
the sequence group (its ranks hold the same rows and the same weights).
:func:`ring_attention` cuts this rank's S/N block of q, k and v, runs the
ring, and all-gathers the blocks of the output over the group.  The cut
and the gather are a pair of autograd functions, each the other's
backward: the cut's backward all-gathers the blocks' gradients, the
gather's backward cuts this rank's block.  With that pair every rank of
the group ends the backward with the same full gradients, so its
parameters stay bit-identical with no all-reduce over ``sequence``.  A
plain slice, or an all-gather whose backward sums, would leave a partial
gradient on the attention branch and the full one on the residual branch;
summing those over the group would count the residual N times.

Without a process group, or at sequence 1, the ring takes one step: the
same online softmax over one block, with no communication.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from byol_tpu_torch.parallel import collectives, mesh
from byol_tpu_torch.parallel.mesh import SEQUENCE_AXIS

NEG_INF = -1e30


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis_name: str = SEQUENCE_AXIS) -> torch.Tensor:
    """Per-rank ring attention body.  q, k, v: (B, H, S_local, D), this
    rank's block of the sequence; -> the attention output of the local
    queries over the whole (ring-assembled) K/V."""
    n = mesh.axis_size(axis_name)
    scale = q.shape[-1] ** -0.5
    b, h, s_loc, d = q.shape
    # fp32 statistics (float64 for a float64 net)
    stat = torch.promote_types(q.dtype, torch.float32)
    m = q.new_full((b, h, s_loc, 1), NEG_INF, dtype=stat)
    l = q.new_zeros((b, h, s_loc, 1), dtype=stat)
    acc = q.new_zeros((b, h, s_loc, d), dtype=stat)
    # K and V travel together: one send and one receive a step
    kv = torch.stack([k, v])
    for i in range(n):
        k_cur, v_cur = kv[0], kv[1]
        s = torch.matmul(q, k_cur.transpose(-1, -2)) * scale
        s = s.to(stat)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next)
        alpha = torch.exp(m - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v_cur.dtype), v_cur).to(stat)
        acc = acc * alpha + pv
        m = m_next
        if i + 1 < n:
            # rotate to the next rank (JAX also rotates after the last
            # step, back to where the blocks started, and discards them)
            kv = collectives.ppermute_shift(kv, axis_name, 1)
    return (acc / l).to(q.dtype)


class _SequenceCut(torch.autograd.Function):
    """This rank's block of dim 2; the backward all-gathers the blocks'
    gradients over the sequence group."""

    @staticmethod
    def forward(ctx, x):
        n, i = mesh.axis_size(SEQUENCE_AXIS), mesh.axis_index(SEQUENCE_AXIS)
        return x.chunk(n, dim=2)[i].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_blocks(grad)


class _SequenceGather(torch.autograd.Function):
    """The group's blocks concatenated along dim 2; the backward cuts
    this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x):
        return _gather_blocks(x)

    @staticmethod
    def backward(ctx, grad):
        n, i = mesh.axis_size(SEQUENCE_AXIS), mesh.axis_index(SEQUENCE_AXIS)
        return grad.chunk(n, dim=2)[i].contiguous()


def _gather_blocks(x: torch.Tensor) -> torch.Tensor:
    n = mesh.axis_size(SEQUENCE_AXIS)
    x = x.contiguous()
    blocks = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(blocks, x, group=mesh.axis_group(SEQUENCE_AXIS))
    return torch.cat(blocks, dim=2)


def ring_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Drop-in attention fn: (B, H, S, D) x3 -> (B, H, S, D), the sequence
    dim sharded over the mesh's ``sequence`` axis inside the call.  S must
    divide evenly by the sequence axis's size."""
    sp = mesh.axis_size(SEQUENCE_AXIS)
    if q.shape[2] % sp != 0:
        raise ValueError(
            f"sequence length {q.shape[2]} not divisible by sequence-"
            f"parallel size {sp}")
    if sp == 1:
        return ring_attention_local(q, k, v)
    q, k, v = (_SequenceCut.apply(t) for t in (q, k, v))
    return _SequenceGather.apply(ring_attention_local(q, k, v))
