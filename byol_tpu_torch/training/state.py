"""Train state (counterpart of byol_tpu/training/state.py).

The online parameters, their gradients, the LARS momentum and the EMA
target (and, under ``polyak_ema``, the Polyak average) live as flat fp32
buffers in the fused update's
:class:`~byol_tpu_torch.ops.fused_update.SegmentMap` layout: one segment
per parameter leaf, in the JAX tree's order (module paths sorted
component by component, as ``jax.tree_util`` orders dict keys), each padded
to 128.  Every ``nn.Parameter`` of the online net, and its ``.grad``, is a
VIEW into its buffer, so the update kernels write parameters, momentum and
target in place with no pack or unpack per step (what ``--flat-resident
on`` does with one device in the JAX package).

The target network is a second :class:`BYOLNet` whose parameters are views
into the target buffer.  It holds no running statistics of its own: its
BatchNorms share the online ones' buffers and never update them.  In
train mode they normalise with batch statistics (the JAX step's target
forward, ``update_stats=False``); in eval mode they read the online
running statistics.  The Polyak net (``polyak_net``, eval only) is built
the same way over the Polyak buffer.

As in the JAX state:

- the EMA covers the FULL tree, heads and probe included;
- ``ema_step`` is its own counter (Quirk Q6);
- ``ema_init_mode='copy'`` starts the target as a copy of the params,
  ``'reference'`` as 0.004 * params with ``ema_step = 1`` (Quirk Q1).

``count`` is optax's schedule count (the lr schedule's argument); all three
counters are host ints, so the step reads no device scalar back.

The net must be on its device before :func:`create_train_state`: moving it
afterwards (``.to``) would replace the views with copies.  For the same
reason :func:`load_converted` and :func:`load_canonical` copy into the
existing views, in place.  :func:`canonical_state` is the checkpoint's
tree: each parameter in its own shape, so a checkpoint does not depend on
the padded layout.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from byol_tpu_torch.models.layers import BatchNorm
from byol_tpu_torch.ops.fused_update import (LANES, SegmentMap, pack_flat,
                                             segment_map_for, unpack_flat)


@dataclasses.dataclass
class TrainState:
    net: nn.Module                 # online; parameters are views of params
    target_net: nn.Module          # EMA; parameters are views of target
    seg: SegmentMap
    names: Tuple[str, ...]         # parameter names, in segment order
    shapes: Tuple[torch.Size, ...]  # their shapes
    params: torch.Tensor           # (seg.total,) fp32
    grads: torch.Tensor
    momentum: torch.Tensor
    target: torch.Tensor
    count: int = 0                 # lr schedule count
    step: int = 0                  # global optimizer step
    ema_step: int = 0              # tau schedule counter
    polyak: Optional[torch.Tensor] = None      # under polyak_ema > 0
    polyak_net: Optional[nn.Module] = None     # parameters: views of polyak
    # under --zero1 on: the rank's range (parallel/zero1.py::Zero1Context),
    # and ``momentum`` holds that range only
    zero1: Optional[Any] = None

    def leaves(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Views of ``buf`` in the parameters' shapes, in segment order."""
        return unpack_flat(buf, self.seg, self.shapes)

    def tree(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{parameter name: view of buf}``."""
        return dict(zip(self.names, self.leaves(buf)))

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_buffers())


def tree_order(names) -> Tuple[str, ...]:
    """Parameter names in JAX tree order: dict keys sorted per level."""
    return tuple(sorted(names, key=lambda n: tuple(n.split("."))))


def _bind(module: nn.Module, names: Sequence[str], shapes, buf: torch.Tensor,
          seg: SegmentMap, grads: Optional[torch.Tensor] = None) -> None:
    """Make each named parameter (and its ``.grad``) a view of the buffer."""
    params = dict(module.named_parameters())
    views = unpack_flat(buf, seg, shapes)
    grad_views = (unpack_flat(grads, seg, shapes) if grads is not None
                  else [None] * len(views))
    for name, view, grad in zip(names, views, grad_views):
        params[name].data = view
        if grad is not None:
            params[name].grad = grad


def _shadow_net(net: nn.Module, names: Sequence[str], shapes,
                buf: torch.Tensor, seg: SegmentMap) -> nn.Module:
    """A copy of ``net`` whose parameters are views of ``buf`` and whose
    BatchNorms share ``net``'s running statistics, never updating them."""
    shadow = copy.deepcopy(net)
    _bind(shadow, names, shapes, buf, seg)
    shadow.requires_grad_(False)
    for name, mod in shadow.named_modules():
        if isinstance(mod, BatchNorm):
            online = net.get_submodule(name)
            mod.running_mean = online.running_mean
            mod.running_var = online.running_var
            mod.update_stats = False
    return shadow


@torch.no_grad()
def create_train_state(net: nn.Module, *, ema_init_mode: str = "copy",
                       polyak_ema: float = 0.0,
                       pad_rows_to: int = 1) -> TrainState:
    """Flatten ``net`` (already on its device) into the flat buffers and
    build its target network (and, under ``polyak_ema > 0``, its Polyak
    net, starting as a copy of the params).  ``pad_rows_to``: the buffers
    hold a multiple of this many 128-element rows, zeros past the last
    segment (ZeRO-1 cuts them into equal ranges)."""
    if ema_init_mode not in ("copy", "reference"):
        raise ValueError(f"unknown ema_init_mode {ema_init_mode!r}")
    params = dict(net.named_parameters())
    names = tree_order(params)
    leaves = [params[n].detach() for n in names]
    shapes = tuple(p.shape for p in leaves)
    seg = segment_map_for(leaves)
    p_buf = pack_flat(leaves, seg)
    rows = -(-seg.num_rows // pad_rows_to) * pad_rows_to
    if rows != seg.num_rows:
        p_buf = torch.cat([p_buf, p_buf.new_zeros(
            (rows - seg.num_rows) * LANES)])
    g_buf = torch.zeros_like(p_buf)
    m_buf = torch.zeros_like(p_buf)
    t_buf = p_buf.clone() if ema_init_mode == "copy" else 0.004 * p_buf
    polyak = p_buf.clone() if polyak_ema > 0.0 else None
    # the shadows copy the net before its parameters become views
    target_net = _shadow_net(net, names, shapes, t_buf, seg)
    polyak_net = (None if polyak is None
                  else _shadow_net(net, names, shapes, polyak, seg))
    _bind(net, names, shapes, p_buf, seg, g_buf)
    return TrainState(net=net, target_net=target_net, seg=seg, names=names,
                      shapes=shapes, params=p_buf, grads=g_buf,
                      momentum=m_buf, target=t_buf,
                      ema_step=0 if ema_init_mode == "copy" else 1,
                      polyak=polyak, polyak_net=polyak_net)


def _buffers(state: TrainState,
             momentum: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
    """The named flat buffers a checkpoint carries, Polyak's when on, with
    ``momentum`` the whole momentum buffer (under ZeRO-1 the state holds
    its rank's range only)."""
    out = [("params", state.params), ("target", state.target),
           ("momentum", momentum)]
    if state.polyak is not None:
        out.append(("polyak", state.polyak))
    return out


@torch.no_grad()
def _load(state: TrainState, trees: Mapping[str, Mapping[str, Any]],
          stats: Mapping[str, Any], counters: Mapping[str, Any],
          what: str) -> None:
    """Copy named trees into the state's views and buffers, in place: the
    parameters stay views of the flat buffers the update kernels write."""
    if "polyak" in trees and state.polyak is None:
        raise ValueError(f"{what}: the tree carries polyak, and this state "
                         "has no Polyak average (polyak_ema is 0)")
    momentum = (state.momentum if state.zero1 is None
                else torch.zeros_like(state.params))
    for key, buf in _buffers(state, momentum):
        if key not in trees:
            raise ValueError(f"{what}: the tree has no {key!r}, which this "
                             "state needs")
        tree = state.tree(buf)
        if set(trees[key]) != set(tree):
            raise ValueError(f"{what}: {key} names differ at "
                             f"{sorted(set(trees[key]) ^ set(tree))[:4]}")
        for name, view in tree.items():
            src = trees[key][name]
            if tuple(src.shape) != tuple(view.shape):
                raise ValueError(f"{what}: {key} {name} has shape "
                                 f"{tuple(src.shape)}, the state "
                                 f"{tuple(view.shape)}")
            view.copy_(src)
    if state.zero1 is not None:
        # the rank keeps its range of the momentum
        state.momentum.copy_(state.zero1.shard_of(momentum))
    own = state.batch_stats()
    if set(stats) != set(own):
        raise ValueError(f"{what}: BatchNorm statistics differ at "
                         f"{sorted(set(stats) ^ set(own))}")
    for name, buf in own.items():
        buf.copy_(stats[name])
    state.count = int(counters["count"])
    state.step = int(counters["step"])
    state.ema_step = int(counters["ema_step"])


def load_converted(state: TrainState, converted: Mapping[str, Any]) -> None:
    """Copy a train state carried across by
    ``convert.train_state_from_flax`` into ``state``, in place."""
    _load(state, converted, converted["buffers"], converted,
          "load_converted")


# the version of canonical_state's tree; load_canonical refuses any other.
# ``polyak`` is in it only when the state has one, so a tree written
# before Polyak was ported is the same format
CANONICAL_FORMAT = 1


@torch.no_grad()
def canonical_state(state: TrainState) -> Dict[str, Any]:
    """The train state as a host tree that does not depend on the flat
    layout (as the JAX checkpoint does not depend on the mesh): ``params``,
    ``target``, ``momentum`` and, under ``polyak_ema``, ``polyak`` keyed by
    parameter name, each in its own shape; ``batch_stats``; the counters
    ``step``, ``count`` and ``ema_step``; and ``format``.  Gradients are
    not state: the step zeroes them.

    Every tensor is a CPU copy, complete when this returns: the update
    kernels write the flat buffers in place, so a later step cannot tear
    the tree while it is written."""
    out: Dict[str, Any] = {"format": CANONICAL_FORMAT, "step": state.step,
                           "count": state.count, "ema_step": state.ema_step}
    # under ZeRO-1 the whole momentum is gathered from the ranks' shards:
    # a collective, which every rank runs
    momentum = (state.momentum if state.zero1 is None
                else state.zero1.gather_momentum(state.momentum))
    for key, buf in _buffers(state, momentum):
        # one copy of the whole buffer, then views in the leaves' shapes
        out[key] = state.tree(buf.to("cpu", copy=True))
    out["batch_stats"] = {name: buf.to("cpu", copy=True)
                          for name, buf in state.batch_stats().items()}
    return out


def load_canonical(state: TrainState, tree: Mapping[str, Any]) -> None:
    """Copy a :func:`canonical_state` tree into ``state``, in place.  The
    tree carries ``polyak`` exactly when the state has a Polyak average."""
    if tree.get("format") != CANONICAL_FORMAT:
        raise ValueError(f"load_canonical: tree format "
                         f"{tree.get('format')!r}, this code reads "
                         f"{CANONICAL_FORMAT}")
    _load(state, tree, tree["batch_stats"], tree, "load_canonical")
