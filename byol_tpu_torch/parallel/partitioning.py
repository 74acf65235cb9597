"""Tensor parallelism over the ``model`` axis (counterpart of
byol_tpu/parallel/partitioning.py): Megatron's rules for the projector and
predictor heads, the widest matmuls outside the backbone.

JAX's rules, in flax's layout, and the dim each splits in the port's
(``Dense`` stores its kernel ``(out, in)``, flax ``(in, out)``):

  dense1 kernel (in, hidden)   P(None, 'model')  column-parallel  dim 0
  dense1 bias / BN leaves      P('model')        the hidden dim   dim 0
  dense2 kernel (hidden, out)  P('model', None)  row-parallel     dim 1
  dense2 bias                  P()               replicated       -

Column then row keeps the activation split over the hidden dim, with one
sum over the model axis at dense2's output (models/heads.py), which GSPMD
inserts in JAX.  Everything else is replicated.  The rules read leaf
names, so they serve the params, the target and Polyak trees, every
params-shaped field of the optimizer's state and the running statistics
alike.

Each rank holds its shard of a split leaf (:func:`shard_leaf`), the
slice ``[i n / M, (i + 1) n / M)`` of the dim for model index i, and a
checkpoint holds the leaf whole (:func:`gather_leaf`).  A hidden size that
the model axis does not divide is refused, as JAX's ``device_put``
refuses it, with the same phrase.

:class:`ModelShards` is what the update and the health vector need of the
layout.  A sum over the elements of a flat buffer (LARS's and LAMB's
per-leaf norms, lbfgs's dots, the health vector's norms and counts) sees
a split leaf's elements on every model rank and a replicated leaf's on
each of them; it keeps the replicated leaves' partials on model index 0
only, and sums over the model axis.  A replicated leaf counted on all M
ranks would scale its norms by sqrt(M): LARS's and LAMB's trust ratios,
ratios of two norms of one leaf, would not show it, but the health
vector's norms and lbfgs's dots, which mix split and replicated leaves,
would be wrong.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from byol_tpu_torch.ops.fused_update import LANES, SegmentMap
from byol_tpu_torch.parallel import collectives, mesh
from byol_tpu_torch.parallel.mesh import MODEL_AXIS

# the BYOL net's tensor-parallel children (models/byol_net.py)
TP_MODULES = ("projector", "predictor")


def tp_dim(name: str, ndim: int) -> Optional[int]:
    """The dim a leaf named ``name`` (a dotted torch path, e.g.
    ``projector.dense1.weight`` or ``predictor.bn.running_var``) splits
    over the model axis in the port's layout, None if it is replicated:
    JAX's ``leaf_pspec`` on the matching flax path."""
    parts = name.split(".")
    if not any(m in parts for m in TP_MODULES):
        return None
    if "dense1" in parts and ndim in (1, 2):
        return 0
    if "bn" in parts and ndim == 1:
        return 0                 # scale/bias/mean/var follow the hidden dim
    if "dense2" in parts and ndim == 2:
        return 1
    return None


def tp_dims(leaves: Iterable[Tuple[str, int]], size: int) -> Dict[str, int]:
    """``{name: dim}`` of the split leaves among ``(name, ndim)`` pairs at
    a model axis of ``size`` (none at 1)."""
    if size == 1:
        return {}
    dims = {name: tp_dim(name, ndim) for name, ndim in leaves}
    return {name: d for name, d in dims.items() if d is not None}


def shard_leaf(x: torch.Tensor, dim: int, size: int, index: int,
               name: str = "") -> torch.Tensor:
    """Model index ``index``'s shard of the whole leaf ``x`` (a view)."""
    n = x.shape[dim]
    if n % size:
        raise ValueError(
            f"the model axis of {size} splits {name or 'a leaf'} over its "
            f"dimension {dim}, which implies that the global size of its "
            f"dimension {dim} should be divisible by {size}, but it is "
            f"equal to {n} (full shape: {tuple(x.shape)})")
    per = n // size
    return x.narrow(dim, index * per, per)


@torch.no_grad()
def gather_leaf(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole leaf from the model ranks' shards ``x`` (a collective:
    every rank of the model group calls it), on ``x``'s device."""
    return collectives.all_gather(x.contiguous(), MODEL_AXIS, axis=dim)


def model_axis() -> Tuple[int, int]:
    """``(size, index)`` of the laid-out model axis."""
    return mesh.axis_size(MODEL_AXIS), mesh.axis_index(MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """Which rows of a flat buffer this rank counts in a sum over the
    model axis: every row of a split segment, and a replicated segment's
    on model index 0 only (the padding rows past the last segment on none;
    they hold zeros)."""

    keep_seg: torch.Tensor     # (nseg,) bool
    keep_rows: torch.Tensor    # (rows of the buffer,) bool

    @classmethod
    def build(cls, seg: SegmentMap, split: Sequence[bool], index: int,
              rows: int, device) -> "ModelShards":
        keep = [bool(s) or index == 0 for s in split]
        per_row = [k for k, p in zip(keep, seg.padded)
                   for _ in range(p // LANES)]
        per_row += [False] * (rows - len(per_row))
        return cls(keep_seg=torch.tensor(keep, device=device),
                   keep_rows=torch.tensor(per_row, device=device))

    def segments(self, sums: torch.Tensor) -> torch.Tensor:
        """(nseg, k) per-segment partials -> their sums over the model
        axis, each segment counted once."""
        kept = torch.where(self.keep_seg[:, None], sums,
                           torch.zeros((), dtype=sums.dtype,
                                       device=sums.device))
        return collectives.model_sum_(kept.contiguous())

    def _rows(self, per_row: torch.Tensor) -> torch.Tensor:
        """A buffer's (rows,) partials -> their kept sum (not reduced)."""
        zero = torch.zeros((), dtype=per_row.dtype, device=per_row.device)
        return torch.where(self.keep_rows, per_row, zero).sum()

    def dots(self, pairs) -> torch.Tensor:
        """``sum(x * y)`` of each pair of flat buffers over the whole
        tree, in float64 (lbfgs's vdots)."""
        return collectives.model_sum_(torch.stack([
            self._rows((x * y).view(-1, LANES).sum(1).double())
            for x, y in pairs]))

    def global_norm(self, tensors) -> torch.Tensor:
        """The health vector's l2 norm of flat buffers over the whole
        tree: row norms in at least fp32, the kept squares summed and then
        summed over the model axis."""
        leaves = [tensors] if torch.is_tensor(tensors) else list(tensors)
        sq = []
        for t in leaves:
            dt = torch.promote_types(t.dtype, torch.float32)
            rows = torch.linalg.vector_norm(t.reshape(-1, LANES), dim=1,
                                            dtype=dt)
            sq.append(self._rows(rows.square()))
        return collectives.model_sum_(torch.stack(sq).sum()).sqrt()

    def nonfinite_count(self, t: torch.Tensor) -> torch.Tensor:
        """Non-finite values of a flat buffer over the whole tree."""
        bad = (~torch.isfinite(t.reshape(-1, LANES))).sum(1)
        return collectives.model_sum_(self._rows(bad)).float()
