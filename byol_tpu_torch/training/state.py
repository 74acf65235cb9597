"""Train state (counterpart of byol_tpu/training/state.py).

The online parameters, their gradients, the LARS momentum and the EMA
target live as four flat fp32 buffers in the fused update's
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
running statistics.

As in the JAX state:

- the EMA covers the FULL tree, heads and probe included;
- ``ema_step`` is its own counter (Quirk Q6);
- ``ema_init_mode='copy'`` starts the target as a copy of the params,
  ``'reference'`` as 0.004 * params with ``ema_step = 1`` (Quirk Q1).

``count`` is optax's schedule count (the lr schedule's argument); all three
counters are host ints, so the step reads no device scalar back.

The net must be on its device before :func:`create_train_state`: moving it
afterwards (``.to``) would replace the views with copies.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from byol_tpu_torch.models.layers import BatchNorm
from byol_tpu_torch.ops.fused_update import (SegmentMap, pack_flat,
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


@torch.no_grad()
def create_train_state(net: nn.Module, *, ema_init_mode: str = "copy",
                       polyak_ema: float = 0.0) -> TrainState:
    """Flatten ``net`` (already on its device) into the four buffers and
    build its target network."""
    if polyak_ema > 0.0:
        raise NotImplementedError(
            "--polyak-ema > 0 is not ported to byol_tpu_torch yet "
            "(ROADMAP.md, section 1 item 6)")
    if ema_init_mode not in ("copy", "reference"):
        raise ValueError(f"unknown ema_init_mode {ema_init_mode!r}")
    target_net = copy.deepcopy(net)
    params = dict(net.named_parameters())
    names = tree_order(params)
    leaves = [params[n].detach() for n in names]
    shapes = tuple(p.shape for p in leaves)
    seg = segment_map_for(leaves)
    p_buf = pack_flat(leaves, seg)
    g_buf = torch.zeros_like(p_buf)
    m_buf = torch.zeros_like(p_buf)
    t_buf = p_buf.clone() if ema_init_mode == "copy" else 0.004 * p_buf
    _bind(net, names, shapes, p_buf, seg, g_buf)
    _bind(target_net, names, shapes, t_buf, seg)
    target_net.requires_grad_(False)
    for name, mod in target_net.named_modules():
        if isinstance(mod, BatchNorm):
            online = net.get_submodule(name)
            mod.running_mean = online.running_mean
            mod.running_var = online.running_var
            mod.update_stats = False
    return TrainState(net=net, target_net=target_net, seg=seg, names=names,
                      shapes=shapes, params=p_buf, grads=g_buf,
                      momentum=m_buf, target=t_buf,
                      ema_step=0 if ema_init_mode == "copy" else 1)


@torch.no_grad()
def load_converted(state: TrainState, converted: Mapping[str, Any]) -> None:
    """Copy a train state carried across by
    ``convert.train_state_from_flax`` into ``state``, in place."""
    for key, buf in (("params", state.params), ("target", state.target),
                     ("momentum", state.momentum)):
        tree = state.tree(buf)
        if set(converted[key]) != set(tree):
            raise ValueError(f"load_converted: {key} names differ at "
                             f"{sorted(set(converted[key]) ^ set(tree))[:4]}")
        for name, view in tree.items():
            view.copy_(converted[key][name])
    stats = state.batch_stats()
    if set(converted["buffers"]) != set(stats):
        raise ValueError("load_converted: BatchNorm statistics differ at "
                         f"{sorted(set(converted['buffers']) ^ set(stats))}")
    for name, buf in stats.items():
        buf.copy_(converted["buffers"][name])
    state.count = converted["count"]
    state.step = converted["step"]
    state.ema_step = converted["ema_step"]
