"""The optimizer chains on flat buffers: the port's copy of the optax 0.2.6
transforms that byol_tpu/optim/factory.py::_base_optimizer chains, and of
the LARS wrapper around them (byol_tpu/optim/lars.py).

Every transform runs on flat buffers in the fused update's
:class:`~byol_tpu_torch.ops.fused_update.SegmentMap` layout: the whole
buffer, or one rank's range of rows under ZeRO-1 (described by the
:class:`~byol_tpu_torch.ops.fused_update.FusedLayout` it is handed).  The
work is plain torch elementwise ops over the whole range, never a loop
over leaves.  Every sum across elements goes through a ``reduce`` hook,
the identity on one device and an in-place all-reduce
(``collectives.psum_``) under ZeRO-1:

- the per-leaf norms of LARS and LAMB are the split K1a's
  (``segment_sums`` of the range, ``reduce``, ``segment_epilogue``), the
  kernels on the card and their plain versions on the CPU;
- the vdots and norms of lbfgs are float64 sums of row partials, then
  ``reduce``, so a sharded update and a whole one agree to rounding;
- over a model axis of M > 1 (the tensor-parallel heads) ``model``
  (parallel/partitioning.py::ModelShards) sums them over the model ranks
  as well, each replicated leaf's partials counted once.

The semantics are optax's, each a known trap:

- ``rmsprop(decay=0.99, eps=1e-8)``: ``nu = 0.99 nu + 0.01 g^2``,
  ``u = g rsqrt(nu + eps)``: eps inside the root, no momentum, nu starts
  at 0 (not torch's RMSprop);
- ``adam``: b1 0.9, b2 0.999, eps 1e-8, its own count; the bias
  corrections ``1 - b^(count + 1)`` in float32, ``u = mu_hat /
  (sqrt(nu_hat) + eps)``;
- ``adadelta(rho=0.9, eps=1e-6)``: ``e_g`` first, ``u = sqrt(e_x + eps)
  / sqrt(e_g + eps) g`` with the previous ``e_x``, then ``e_x`` from u;
- ``sgd``: the lr scale alone; ``momentum``: ``trace(0.9)``, ``m = g +
  0.9 m``, no Nesterov;
- ``lamb``: ``scale_by_adam(eps=1e-6)``, ``add_decayed_weights(0)`` (the
  identity), ``scale_by_trust_ratio()``: ``|p| / |u|`` per leaf, or 1
  where either is 0, on EVERY leaf, biases and BatchNorm included;
- ``lbfgs``: ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``
  (optax's ``update_fn`` and ``_precondition_by_lbfgs``);
- then the lr scale, ``u = -lr u``;
- before the base: the value clip of the mean gradient under ``clip >
  0``, first; then for ``lars_<base>`` the weight decay folded into the
  gradient and LARS's trust scale, on adapted (``ndim > 1``) leaves; for a
  bare base with weight decay, ``g + wd p`` on adapted leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, MutableMapping, Tuple

import numpy as np
import torch

from byol_tpu_torch.ops import fused_update as fused_lib
from byol_tpu_torch.ops.fused_update import LANES, FusedLayout
from byol_tpu_torch.optim import lars as lars_lib

# the 'momentum' registry entry's decay (reference main.py:311), also the
# one the fused kernel ticks
MOMENTUM_DECAY = 0.9
RMSPROP_DECAY, RMSPROP_EPS = 0.99, 1e-8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LAMB_EPS = 1e-6
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6
LBFGS_MEMORY = 10

BASES = ("rmsprop", "adam", "adadelta", "sgd", "momentum", "lamb", "lbfgs")

# The state each base keeps, field -> kind: 'flat' holds one value per
# element of the buffer, 'stacked' LBFGS_MEMORY of them ((LBFGS_MEMORY, n)),
# 'vector' is one (LBFGS_MEMORY,) vector for the whole tree.  The names
# are optax's, but for the trace (``momentum``, the name checkpoints have
# carried since PR 5) and lbfgs's copies of the params and updates.
STATE_FIELDS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "rmsprop": (("nu", "flat"),),
    "adam": (("mu", "flat"), ("nu", "flat")),
    "adadelta": (("e_g", "flat"), ("e_x", "flat")),
    "sgd": (),
    "momentum": (("momentum", "flat"),),
    "lamb": (("mu", "flat"), ("nu", "flat")),
    "lbfgs": (("lbfgs_params", "flat"), ("lbfgs_updates", "flat"),
              ("diff_params_memory", "stacked"),
              ("diff_updates_memory", "stacked"),
              ("weights_memory", "vector")),
}
# the host-int counters of each base (optax's int32 ``count``)
COUNT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "adam": ("count",), "lamb": ("count",), "lbfgs": ("count",)}
# optax's field name -> the port's, where they differ
FROM_OPTAX = {"trace": "momentum", "params": "lbfgs_params",
              "updates": "lbfgs_updates"}

Reduce = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _dots(pairs, reduce: Reduce, model=None) -> torch.Tensor:
    """``sum(x * y)`` of each pair over the range: row partials in the
    buffers' dtype, summed in float64, then ``reduce``d, in one call
    (over the model axis too, given ``model``)."""
    if model is not None:
        return reduce(model.dots(pairs))
    return reduce(torch.stack([
        (x * y).view(-1, LANES).sum(1).double().sum() for x, y in pairs]))


def _segment_sums(p, g, layout: FusedLayout, reduce: Reduce, model
                  ) -> torch.Tensor:
    """The split K1a's first half, its sums ``reduce``d (and summed over
    the model axis, given ``model``) for the second."""
    sums = reduce(fused_lib.segment_sums(p, g, layout))
    return sums if model is None else model.segments(sums)


class _Derived:
    """What a chain derives from one layout, made once: the row ->
    segment index, the weight decay per row, and LAMB's layout (every
    segment adapted, no weight decay) over the same rows."""

    def __init__(self, layout: FusedLayout) -> None:
        self.layout = layout
        self.rows = layout.row_seg.long()
        self.wd_rows = layout.seg_wd[self.rows][:, None]
        self._lamb = None

    @property
    def lamb(self) -> FusedLayout:
        if self._lamb is None:
            lay = self.layout
            seg = dataclasses.replace(
                lay.seg, adapted=(True,) * lay.seg.num_segments)
            self._lamb = FusedLayout.build(seg, 0.0, lay.row_seg.device,
                                           lay.row_lo, lay.row_lo + lay.rows)
        return self._lamb

    def per_row(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """``x`` times its segment's entry of the (nseg,) ``scale``."""
        return (x.view(-1, LANES) * scale[self.rows][:, None]).view(-1)

    def decayed(self, g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """``g + wd p`` on adapted segments, ``g`` elsewhere (wd 0)."""
        return (g.view(-1, LANES) + self.wd_rows * p.view(-1, LANES)
                ).view(-1)


def _moment(buf: torch.Tensor, x: torch.Tensor, decay: float,
            order: int) -> torch.Tensor:
    """In place: ``buf = (1 - decay) x^order + decay buf`` (optax's
    ``update_moment``)."""
    term = x.square() if order == 2 else x.clone()
    return buf.mul_(decay).add_(term.mul_(1 - decay))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay^count`` in float32, as optax computes it."""
    one, d = np.float32(1.0), np.float32(decay)
    return float(one - d ** np.float32(count))


def _adam_direction(g, opt, counts, eps):
    mu, nu = opt["mu"], opt["nu"]
    _moment(mu, g, ADAM_B1, 1)
    _moment(nu, g, ADAM_B2, 2)
    counts["count"] += 1
    c = counts["count"]
    mu_hat = mu / _bias_correction(ADAM_B1, c)
    nu_hat = nu / _bias_correction(ADAM_B2, c)
    return mu_hat.div_(nu_hat.sqrt_().add_(eps))


def _lbfgs_direction(p, g, opt, counts, reduce: Reduce, model=None):
    """optax's ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``
    on the range: memories written at ``(count - 1) % 10``, the identity
    scale, then the two-loop recursion over ``(count % 10 + arange(10)) %
    10``.  Every vdot is a reduced float64 sum cast to the buffers' dtype,
    so the scalars stay on the device."""
    count = counts["count"]
    dt = g.dtype
    mem = LBFGS_MEMORY
    idx, prev = count % mem, (count - 1) % mem
    dpm, dum = opt["diff_params_memory"], opt["diff_updates_memory"]
    rhos = opt["weights_memory"]
    if count > 0:
        dp = p - opt["lbfgs_params"]
        du = g - opt["lbfgs_updates"]
    else:
        dp, du = torch.zeros_like(p), torch.zeros_like(g)
    sums = _dots([(du, dp), (du, du), (g, g)], reduce, model).to(dt)
    vdot, den, gg = sums.unbind()
    zero = torch.zeros((), dtype=dt, device=g.device)
    if count > 0:
        weight = torch.where(vdot == 0, zero, 1.0 / vdot)
        scale = torch.where(den > 0, vdot / den, torch.ones_like(den))
    else:
        # the first step: the capped reciprocal of the gradient's norm
        weight = zero
        scale = torch.clamp(1.0 / gg.sqrt(), max=1.0)
    dpm[prev].copy_(dp)
    dum[prev].copy_(du)
    rhos[prev] = weight
    order = [(idx + j) % mem for j in range(mem)]
    vec = g.clone()
    alphas = [None] * mem
    for j in reversed(range(mem)):
        i = order[j]
        alphas[j] = rhos[i] * _dots([(dpm[i], vec)], reduce,
                                    model).to(dt)[0]
        vec.addcmul_(dum[i], -alphas[j])
    vec.mul_(scale)
    for j in range(mem):
        i = order[j]
        beta = rhos[i] * _dots([(dum[i], vec)], reduce, model).to(dt)[0]
        vec.addcmul_(dpm[i], alphas[j] - beta)
    opt["lbfgs_params"].copy_(p)
    opt["lbfgs_updates"].copy_(g)
    counts["count"] = count + 1
    return vec


@dataclasses.dataclass(frozen=True)
class Chain:
    """One registry entry: ``[clip] -> (LARS | weight decay) -> base ->
    lr``, on flat buffers.  :meth:`init` makes its state, :meth:`update`
    takes one step on a range."""

    name: str                     # the full registry name, e.g. 'lars_adam'
    base: str
    lars: bool
    weight_decay: float
    clip: float = 0.0
    trust_coefficient: float = lars_lib.TRUST_COEFFICIENT_DEFAULT
    eps: float = lars_lib.LARS_EPS_DEFAULT
    _derived: Dict[int, _Derived] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def state_fields(self) -> Tuple[Tuple[str, str], ...]:
        return STATE_FIELDS[self.base]

    @property
    def count_fields(self) -> Tuple[str, ...]:
        return COUNT_FIELDS.get(self.base, ())

    def init(self, like: torch.Tensor) -> Tuple[Dict[str, torch.Tensor],
                                                 Dict[str, int]]:
        """Zero state for flat buffers like ``like``: (buffers, counts)."""
        n = like.numel()
        shapes = {"flat": (n,), "stacked": (LBFGS_MEMORY, n),
                  "vector": (LBFGS_MEMORY,)}
        bufs = {name: torch.zeros(shapes[kind], dtype=like.dtype,
                                  device=like.device)
                for name, kind in self.state_fields}
        return bufs, {name: 0 for name in self.count_fields}

    def _for(self, layout: FusedLayout) -> _Derived:
        d = self._derived.get(id(layout))
        if d is None or d.layout is not layout:
            d = self._derived[id(layout)] = _Derived(layout)
        return d

    @torch.no_grad()
    def update(self, p: torch.Tensor, g: torch.Tensor,
               opt: Mapping[str, torch.Tensor],
               counts: MutableMapping[str, int], *, lr: float,
               layout: FusedLayout, reduce: Reduce = identity,
               model=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step on the range ``layout`` describes.  ``p`` and ``g``
        hold the range's elements; ``opt`` the range's state buffers
        (written in place), ``counts`` the counters (ticked in place);
        ``model`` (a ``ModelShards``) when the buffers hold shards of
        tensor-parallel heads.
        Returns ``(u, trust)``: the update to add to ``p`` and the trust
        ratios LARS applied to the adapted segments in leaf order (ones(1)
        without LARS, or with nothing adapted).  ``g`` is left as it
        is."""
        d = self._for(layout)
        if self.clip > 0.0:
            g = g.clamp(-self.clip, self.clip)
        trust = torch.ones(1, device=p.device)
        if self.lars:
            # the split K1a's sums are of p and g + wd p (it folds the
            # layout's weight decay in itself)
            sums = _segment_sums(p, g, layout, reduce, model)
            scale, _ = fused_lib.segment_epilogue(
                sums, layout, self.trust_coefficient, self.eps)
            g = d.per_row(d.decayed(g, p), scale)
            trust = layout.trust_vector(scale)
        elif self.weight_decay > 0.0:
            g = d.decayed(g, p)
        base = self.base
        if base == "sgd":
            u = g
        elif base == "momentum":
            u = opt["momentum"].mul_(MOMENTUM_DECAY).add_(g)
        elif base == "rmsprop":
            nu = _moment(opt["nu"], g, RMSPROP_DECAY, 2)
            u = torch.rsqrt(nu + RMSPROP_EPS).mul_(g)
        elif base == "adam":
            u = _adam_direction(g, opt, counts, ADAM_EPS)
        elif base == "adadelta":
            e_g = _moment(opt["e_g"], g, ADADELTA_RHO, 2)
            u = (opt["e_x"] + ADADELTA_EPS).sqrt_().div_(
                (e_g + ADADELTA_EPS).sqrt_()).mul_(g)
            _moment(opt["e_x"], u, ADADELTA_RHO, 2)
        elif base == "lamb":
            u = _adam_direction(g, opt, counts, LAMB_EPS)
            lamb = d.lamb
            sums = _segment_sums(p, u, lamb, reduce, model)
            scale, _ = fused_lib.segment_epilogue(sums, lamb, 1.0, 0.0)
            u = d.per_row(u, scale)
        elif base == "lbfgs":
            u = _lbfgs_direction(p, g, opt, counts, reduce, model)
        else:
            raise ValueError(f"unknown optimizer {base!r}")
        return torch.mul(u, -lr), trust
