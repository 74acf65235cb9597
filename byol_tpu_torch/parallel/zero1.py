"""ZeRO-1: the weight update sharded over the data axis (counterpart of
byol_tpu/parallel/zero1.py).

The online params stay whole on every rank (every rank runs the forward),
and so does the Polyak average; the optimizer's state and the EMA target
(JAX's ``ZERO1_STATE_FIELDS``) are updated on a 1/W range per rank, and
the optimizer's state lives only there.  The layout is PyTorch's own
idiom, FSDP's flat parameter, not JAX's leaf-partitioned one: rank r owns
the contiguous rows ``[r R, (r + 1) R)`` of the flat buffers, ``R`` the
128-element row count padded to a multiple of the world and divided by
it.  The train state's buffers carry that padding (zeros, inert under
every norm and every elementwise step).  One optimizer step:

1. ``reduce_scatter`` of the flat gradient: each rank gets the ranks'
   mean over its range;
2. the update of the range.  Under ``--fused-update on`` (lars_momentum):
   K1a split on the range, an all-reduce of the (nseg, 2) float64
   per-segment sums, K1a's epilogue: the trust ratios of the whole
   buffer; then K1b on the range, writing the range's params, momentum
   and target (ops/fused_update.py::fused_lars_ema_update_zero1).  Without
   it, any chain of the registry on the range (optim/transforms.py), its
   every cross-element sum (LARS's and LAMB's per-segment sums, lbfgs's
   vdots) all-reduced, then the EMA tick of the range's target;
3. the params and the target are all-gathered whole again (in buckets
   under ``--flat-resident on``), ready for the next forward and for
   eval, as JAX gathers the target before its forward.

It computes JAX's function: the trust ratios and lbfgs's scalars depend
only on global sums, and the rest of the update is elementwise.  The
layout never reaches a checkpoint: ``canonical_state`` gathers the
optimizer's state and ``load_canonical`` keeps the rank's range
(training/state.py), so a checkpoint written at world N restores at world
M under either setting.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, MutableMapping, Optional, Tuple

import torch

from byol_tpu_torch.ops import fused_update as fused_lib
from byol_tpu_torch.ops.fused_update import LANES, FusedLayout, SegmentMap
from byol_tpu_torch.parallel import collectives
from byol_tpu_torch.parallel.flat_state import Bucket, plan_buckets

# the port's names of JAX's ("opt_state", "target_params")
ZERO1_STATE_FIELDS = ("opt", "target")


def rows_per_rank(num_rows: int, world: int) -> int:
    """``R``: the row count padded to a multiple of ``world``, over it."""
    return -(-num_rows // world)


def padded_rows(num_rows: int, world: int) -> int:
    return rows_per_rank(num_rows, world) * world


def rank_rows(num_rows: int, world: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s real rows ``[lo, hi)``; empty where the range is all
    padding."""
    per = rows_per_rank(num_rows, world)
    lo = min(rank * per, num_rows)
    return lo, min(lo + per, num_rows)


@dataclasses.dataclass
class Zero1Context:
    """One rank's share of the sharded update."""

    seg: SegmentMap
    world: int
    rank: int
    layout: FusedLayout                  # the rank's range of rows
    grad_shard: Optional[torch.Tensor]   # (R * 128,) reduce-scatter output
    buckets: Optional[Tuple[Bucket, ...]] = None   # --flat-resident on
    # the range's mean gradient of the last update (the health vector's)
    last_grad: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, seg: SegmentMap, *, world: int, rank: int,
              weight_decay: float, device, bucket_mb: Optional[int] = None
              ) -> "Zero1Context":
        lo, hi = rank_rows(seg.num_rows, world, rank)
        grad_shard = None
        if collectives.is_initialized():
            grad_shard = torch.zeros(
                rows_per_rank(seg.num_rows, world) * LANES,
                dtype=torch.float32, device=device)
        return cls(seg=seg, world=world, rank=rank,
                   layout=FusedLayout.build(seg, weight_decay, device, lo,
                                            hi),
                   grad_shard=grad_shard,
                   buckets=(plan_buckets(seg, bucket_mb)
                            if bucket_mb is not None else None))

    # -- sizes ---------------------------------------------------------------
    @property
    def shard_elements(self) -> int:
        """Elements of each rank's range, padding included."""
        return rows_per_rank(self.seg.num_rows, self.world) * LANES

    @property
    def total_elements(self) -> int:
        """Elements of a whole buffer, padding included."""
        return self.shard_elements * self.world

    def _range(self) -> slice:
        lo = self.layout.row_lo * LANES
        return slice(lo, lo + self.layout.total)

    # -- the update ----------------------------------------------------------
    def grad_range(self, grads: torch.Tensor) -> torch.Tensor:
        """The ranks' mean gradient over this rank's real rows."""
        if self.grad_shard is None:          # no process group: world 1
            return grads[self._range()]
        if self.grad_shard.dtype != grads.dtype:
            # a float64 state (a test's) reduces in float64
            self.grad_shard = self.grad_shard.to(grads.dtype)
        collectives.reduce_scatter_mean(self.grad_shard, grads)
        return self.grad_shard[:self.layout.total]

    def update(self, params: torch.Tensor, grads: torch.Tensor,
               momentum: torch.Tensor, target: torch.Tensor, *, lr: float,
               tau: float, momentum_decay: float, trust_coefficient: float,
               eps: float, ema_pre: bool) -> torch.Tensor:
        """The sharded fused update, then the params and the target
        gathered whole.  ``momentum`` is the rank's shard.  Returns the
        trust vector."""
        g = self.last_grad = self.grad_range(grads)
        rng = self._range()
        trust = fused_lib.fused_lars_ema_update_zero1(
            params[rng], g, momentum[:self.layout.total], target[rng],
            self.layout, lr=lr, tau=tau, momentum_decay=momentum_decay,
            trust_coefficient=trust_coefficient, eps=eps, ema_pre=ema_pre,
            all_reduce=collectives.psum_)
        self.gather(params)
        self.gather(target)
        return trust

    def update_chain(self, chain, params: torch.Tensor, grads: torch.Tensor,
                     opt: Dict[str, torch.Tensor],
                     counts: MutableMapping[str, int],
                     target: torch.Tensor, *, lr: float, tau: float,
                     ema_pre: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sharded unfused update: ``chain`` (optim/transforms.py) on
        the range, its sums all-reduced, the range's EMA tick, then the
        params and the target gathered whole.  ``opt`` holds the rank's
        shards.  Returns (trust vector, the range's applied update)."""
        g = self.last_grad = self.grad_range(grads)
        rng = self._range()
        n = self.layout.total
        p, t = params[rng], target[rng]
        if ema_pre:
            t.mul_(tau).add_(p, alpha=1.0 - tau)
        kinds = dict(chain.state_fields)
        u, trust = chain.update(
            p, g, {k: (v if kinds[k] == "vector" else v[..., :n])
                   for k, v in opt.items()},
            counts, lr=lr, layout=self.layout, reduce=collectives.psum_)
        p.add_(u)
        if not ema_pre:
            t.mul_(tau).add_(p, alpha=1.0 - tau)
        self.gather(params)
        self.gather(target)
        return trust, u

    # -- gathers -------------------------------------------------------------
    def gather(self, buf: torch.Tensor) -> torch.Tensor:
        """Refill the whole ``buf`` from every rank's range: one in-place
        all-gather, or under ``--flat-resident on`` one broadcast per
        owner of each bucket's rows (the ranks' ranges cut a bucket
        unevenly, and a collective of uneven pieces is a set of
        broadcasts)."""
        if not collectives.is_initialized():
            return buf
        per = self.shard_elements
        if self.buckets is None:
            return collectives.all_gather_into(
                buf, buf[self.rank * per:(self.rank + 1) * per])
        rows = per // LANES
        for lo, hi, _ in self.buckets:
            for r in range(lo // rows, (hi - 1) // rows + 1):
                a, b = max(lo, r * rows), min(hi, (r + 1) * rows)
                collectives.broadcast_(buf[a * LANES:b * LANES], r)
        return buf

    def gather_shard(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole buffer from the ranks' shards, ``(..., shard)`` ->
        ``(..., whole)`` (for a checkpoint: a collective, every rank
        calls it)."""
        if shard.dim() > 1:
            return torch.stack([self.gather_shard(row) for row in shard])
        full = torch.zeros(self.total_elements, dtype=shard.dtype,
                           device=shard.device)
        return collectives.all_gather_into(full, shard)

    def shard_of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's range of a whole buffer (along its last dim),
        padding included."""
        per = self.shard_elements
        return full[..., self.rank * per:(self.rank + 1) * per]

    def global_sq_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of squares over the ranks' ranges of a sharded tensor."""
        from byol_tpu_torch.observability.health import global_norm
        return collectives.psum_(global_norm(x).square())

    def grad_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(l2 norm, non-finite count) of the last update's mean gradient
        over every rank's range."""
        from byol_tpu_torch.observability.health import nonfinite_count
        g = self.last_grad
        return (self.global_sq_norm(g).sqrt(),
                collectives.psum_(nonfinite_count(g)))
