"""Train state (counterpart of byol_tpu/training/state.py).

The online parameters, their gradients, the optimizer's state (the LARS
momentum by default) and the EMA target (and, under ``polyak_ema``, the
Polyak average) live as flat fp32 buffers in the fused update's
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

The optimizer's state is named flat buffers (``opt``, the fields of
``optim/transforms.py::STATE_FIELDS``: ``momentum`` for the momentum
trace, ``mu`` and ``nu`` for adam and lamb, ...; lbfgs's memories are
``(10, n)``, its ``weights_memory`` one (10,) vector) and host-int counts
(``opt_counts``: adam's, lamb's and lbfgs's own ``count``).

The net must be on its device before :func:`create_train_state`: moving it
afterwards (``.to``) would replace the views with copies.  For the same
reason :func:`load_converted` and :func:`load_canonical` copy into the
existing views, in place.  :func:`canonical_state` is the checkpoint's
tree: each parameter in its own shape, so a checkpoint does not depend on
the padded layout.

Over a model axis of M > 1 the net's heads are its model index's shards
(models/byol_net.py::shard_heads), and so are the state's segments of
them: the :class:`SegmentMap` covers this rank's leaves.
:func:`canonical_state` gathers every split leaf whole over the model
group (a collective), so a checkpoint does not depend on M, and
:func:`load_converted` / :func:`load_canonical` take whole trees and keep
the rank's slices (parallel/partitioning.py).
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
from byol_tpu_torch.optim.transforms import (COUNT_FIELDS, LBFGS_MEMORY,
                                             STATE_FIELDS)
from byol_tpu_torch.parallel import partitioning

# the optimizer whose state a tree written before PR 11 holds
LEGACY_OPTIMIZER = "lars_momentum"


def optimizer_base(name: str) -> str:
    """The registry's base of an optimizer name (``lars_adam`` ->
    ``adam``)."""
    base = name.lower().strip().split("_")[-1]
    if base not in STATE_FIELDS:
        raise ValueError(f"unknown optimizer {base!r}")
    return base


def opt_fields(name: str) -> Dict[str, str]:
    """{state field: kind} of an optimizer (optim/transforms.py)."""
    return dict(STATE_FIELDS[optimizer_base(name)])


@dataclasses.dataclass
class TrainState:
    net: nn.Module                 # online; parameters are views of params
    target_net: nn.Module          # EMA; parameters are views of target
    seg: SegmentMap
    names: Tuple[str, ...]         # parameter names, in segment order
    shapes: Tuple[torch.Size, ...]  # their shapes
    params: torch.Tensor           # (seg.total,) fp32
    grads: torch.Tensor
    target: torch.Tensor
    optimizer: str = LEGACY_OPTIMIZER   # the registry name of the chain
    # the chain's state: named flat buffers, and its host-int counts
    opt: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    opt_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    count: int = 0                 # lr schedule count
    step: int = 0                  # global optimizer step
    ema_step: int = 0              # tau schedule counter
    polyak: Optional[torch.Tensor] = None      # under polyak_ema > 0
    polyak_net: Optional[nn.Module] = None     # parameters: views of polyak
    # under --zero1 on: the rank's range (parallel/zero1.py::Zero1Context),
    # and every buffer of ``opt`` but a 'vector' holds that range only
    zero1: Optional[Any] = None
    # (size, index) of the model axis the net's heads are split over
    model_axis: Tuple[int, int] = (1, 0)

    @property
    def momentum(self) -> torch.Tensor:
        """The momentum trace of the momentum chains (lars_momentum's
        state)."""
        return self.opt["momentum"]

    @momentum.setter
    def momentum(self, buf: torch.Tensor) -> None:
        self.opt["momentum"] = buf

    def leaves(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Views of ``buf`` in the parameters' shapes, in segment order."""
        return unpack_flat(buf, self.seg, self.shapes)

    def tree(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{parameter name: view of buf}``."""
        return dict(zip(self.names, self.leaves(buf)))

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_buffers())

    def split_dims(self) -> Dict[str, int]:
        """``{name: dim}`` of the parameters and running statistics split
        over the model axis (none at M = 1)."""
        leaves = [(n, len(s)) for n, s in zip(self.names, self.shapes)]
        leaves += [(n, b.ndim) for n, b in self.batch_stats().items()]
        return partitioning.tp_dims(leaves, self.model_axis[0])

    def whole_shapes(self) -> List[torch.Size]:
        """The parameters' shapes in the whole tree (the split ones times
        the model axis's size along their dim), in segment order."""
        dims = self.split_dims()
        out = []
        for name, shape in zip(self.names, self.shapes):
            shape = list(shape)
            if name in dims:
                shape[dims[name]] *= self.model_axis[0]
            out.append(torch.Size(shape))
        return out

    def model_shards(self) -> Optional["partitioning.ModelShards"]:
        """The rows a sum over the model axis counts here (None at
        M = 1)."""
        if self.model_axis[0] == 1:
            return None
        dims = self.split_dims()
        return partitioning.ModelShards.build(
            self.seg, [name in dims for name in self.names],
            self.model_axis[1], self.params.numel() // LANES,
            self.params.device)


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
                       polyak_ema: float = 0.0, pad_rows_to: int = 1,
                       optimizer: str = LEGACY_OPTIMIZER) -> TrainState:
    """Flatten ``net`` (already on its device) into the flat buffers and
    build its target network (and, under ``polyak_ema > 0``, its Polyak
    net, starting as a copy of the params), with the zero state of
    ``optimizer``'s chain.  ``pad_rows_to``: the buffers hold a multiple
    of this many 128-element rows, zeros past the last segment (ZeRO-1
    cuts them into equal ranges).  The buffers take the parameters'
    dtype: fp32, or float64 for a net made float64 (a test's)."""
    if ema_init_mode not in ("copy", "reference"):
        raise ValueError(f"unknown ema_init_mode {ema_init_mode!r}")
    fields = opt_fields(optimizer)
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
    n = p_buf.numel()
    shapes_of = {"flat": (n,), "stacked": (LBFGS_MEMORY, n),
                 "vector": (LBFGS_MEMORY,)}
    opt = {name: p_buf.new_zeros(shapes_of[kind])
           for name, kind in fields.items()}
    t_buf = p_buf.clone() if ema_init_mode == "copy" else 0.004 * p_buf
    polyak = p_buf.clone() if polyak_ema > 0.0 else None
    # the shadows copy the net before its parameters become views
    target_net = _shadow_net(net, names, shapes, t_buf, seg)
    polyak_net = (None if polyak is None
                  else _shadow_net(net, names, shapes, polyak, seg))
    _bind(net, names, shapes, p_buf, seg, g_buf)
    return TrainState(net=net, target_net=target_net, seg=seg, names=names,
                      shapes=shapes, params=p_buf, grads=g_buf,
                      target=t_buf, optimizer=optimizer.lower().strip(),
                      opt=opt,
                      opt_counts={c: 0 for c in COUNT_FIELDS.get(
                          optimizer_base(optimizer), ())},
                      ema_step=0 if ema_init_mode == "copy" else 1,
                      polyak=polyak, polyak_net=polyak_net,
                      model_axis=tuple(getattr(net, "model_axis", (1, 0))))


def _whole_opt(state: TrainState) -> Dict[str, torch.Tensor]:
    """The optimizer's buffers whole: under ZeRO-1 gathered from the
    ranks' ranges (a collective, which every rank runs)."""
    if state.zero1 is None:
        return dict(state.opt)
    kinds = opt_fields(state.optimizer)
    return {name: (buf if kinds[name] == "vector"
                   else state.zero1.gather_shard(buf))
            for name, buf in state.opt.items()}


def _stacked_tree(state: TrainState, buf: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """``{name: (LBFGS_MEMORY, *shape)}`` of a stacked buffer."""
    rows = [state.tree(row) for row in buf]
    return {name: torch.stack([r[name] for r in rows])
            for name in state.names}


@torch.no_grad()
def _load(state: TrainState, trees: Mapping[str, Any],
          stats: Mapping[str, Any], counters: Mapping[str, Any],
          what: str) -> None:
    """Copy named trees into the state's views and buffers, in place: the
    parameters stay views of the flat buffers the update kernels write.
    A tree without ``optimizer`` holds lars_momentum's state (every tree
    written before the registry was ported)."""
    optimizer = str(trees.get("optimizer", LEGACY_OPTIMIZER)).lower().strip()
    if optimizer != state.optimizer:
        raise ValueError(f"{what}: the tree holds the state of optimizer "
                         f"{optimizer!r}, and this state is of optimizer "
                         f"{state.optimizer!r}")
    if "polyak" in trees and state.polyak is None:
        raise ValueError(f"{what}: the tree carries polyak, and this state "
                         "has no Polyak average (polyak_ema is 0)")
    kinds = opt_fields(state.optimizer)
    # under ZeRO-1 a whole buffer is filled, then the rank keeps its range
    whole = {name: (buf if state.zero1 is None or kinds[name] == "vector"
                    else buf.new_zeros(buf.shape[:-1]
                                       + state.params.shape))
             for name, buf in state.opt.items()}
    flat = [("params", state.params), ("target", state.target)]
    flat += [(name, whole[name]) for name, kind in kinds.items()
             if kind == "flat"]
    if state.polyak is not None:
        flat.append(("polyak", state.polyak))
    split = _Split(state)
    for key, buf in flat:
        if key not in trees:
            raise ValueError(f"{what}: the tree has no {key!r}, which this "
                             "state needs")
        _copy_tree(state.tree(buf), trees[key], f"{what}: {key}", split)
    for name, kind in kinds.items():
        if name not in trees:
            raise ValueError(f"{what}: the tree has no {name!r}, which "
                             f"{state.optimizer}'s state needs")
        if kind == "vector":
            _copy_tree({name: whole[name]}, {name: trees[name]}, what)
        elif kind == "stacked":
            for k, row in enumerate(whole[name]):
                _copy_tree(state.tree(row), {
                    leaf: v[k] for leaf, v in trees[name].items()},
                    f"{what}: {name}[{k}]", split)
    if state.zero1 is not None:
        for name, buf in state.opt.items():
            if kinds[name] != "vector":
                buf.copy_(state.zero1.shard_of(whole[name]))
    own = state.batch_stats()
    if set(stats) != set(own):
        raise ValueError(f"{what}: BatchNorm statistics differ at "
                         f"{sorted(set(stats) ^ set(own))}")
    for name, buf in own.items():
        buf.copy_(split(name, stats[name], buf))
    counts = counters.get("opt_counts", {})
    if set(counts) != set(state.opt_counts):
        raise ValueError(f"{what}: optimizer counts {sorted(counts)}, "
                         f"{state.optimizer} keeps "
                         f"{sorted(state.opt_counts)}")
    state.opt_counts = {k: int(v) for k, v in counts.items()}
    state.count = int(counters["count"])
    state.step = int(counters["step"])
    state.ema_step = int(counters["ema_step"])


class _Split:
    """Whole leaves -> this rank's shards of the split ones (the identity
    at M = 1).  A tree already cut to a shard's shape is not whole: its
    slice has the wrong shape, and ``_copy_tree`` refuses it."""

    def __init__(self, state: TrainState) -> None:
        self.dims = state.split_dims()
        self.size, self.index = state.model_axis

    def __call__(self, name: str, value: Any, view: torch.Tensor) -> Any:
        dim = self.dims.get(name)
        if dim is None:
            return value
        return partitioning.shard_leaf(torch.as_tensor(value), dim,
                                       self.size, self.index, name)


def _copy_tree(views: Mapping[str, torch.Tensor], src: Mapping[str, Any],
               what: str, split: Optional[_Split] = None) -> None:
    if set(src) != set(views):
        raise ValueError(f"{what} names differ at "
                         f"{sorted(set(src) ^ set(views))[:4]}")
    for name, view in views.items():
        value = src[name]
        if split is not None:
            value = split(name, value, view)
        if tuple(value.shape) != tuple(view.shape):
            raise ValueError(f"{what} {name} has shape "
                             f"{tuple(value.shape)}, the state "
                             f"{tuple(view.shape)}")
        view.copy_(torch.as_tensor(value))


def load_converted(state: TrainState, converted: Mapping[str, Any]) -> None:
    """Copy a train state carried across by
    ``convert.train_state_from_flax`` into ``state``, in place."""
    _load(state, converted, converted["buffers"], converted,
          "load_converted")


# the version of canonical_state's tree; load_canonical refuses any other.
# ``polyak`` is in it only when the state has one, and a tree without
# ``optimizer`` holds lars_momentum's state, so a tree written before
# Polyak or the optimizer registry was ported is the same format
CANONICAL_FORMAT = 1


@torch.no_grad()
def canonical_state(state: TrainState) -> Dict[str, Any]:
    """The train state as a host tree that does not depend on the flat
    layout (as the JAX checkpoint does not depend on the mesh): ``params``,
    ``target``, each flat field of the optimizer's state (``momentum``,
    ``mu``, ...) and, under ``polyak_ema``, ``polyak`` keyed by parameter
    name, each in its own shape; lbfgs's memories as ``(10, *shape)`` per
    name and ``weights_memory`` as it is; ``optimizer`` (its registry
    name) and ``opt_counts``; ``batch_stats``; the counters ``step``,
    ``count`` and ``ema_step``; and ``format``.  Gradients are not state:
    the step zeroes them.

    Every tensor is a CPU copy, complete when this returns: the update
    kernels write the flat buffers in place, so a later step cannot tear
    the tree while it is written."""
    out: Dict[str, Any] = {"format": CANONICAL_FORMAT, "step": state.step,
                           "count": state.count, "ema_step": state.ema_step,
                           "optimizer": state.optimizer,
                           "opt_counts": dict(state.opt_counts)}
    kinds = opt_fields(state.optimizer)
    bufs = [("params", state.params), ("target", state.target)]
    if state.polyak is not None:
        bufs.append(("polyak", state.polyak))
    # one copy of each whole buffer, then views in the leaves' shapes; the
    # split leaves gathered whole over the model axis, in one order on
    # every rank
    dims = state.split_dims()
    for key, buf in bufs:
        out[key] = state.tree(buf.to("cpu", copy=True))
        _gather_split(out[key], state.tree(buf), dims)
    for name, buf in _whole_opt(state).items():
        host = buf.to("cpu", copy=True)
        out[name] = (state.tree(host) if kinds[name] == "flat" else
                     _stacked_tree(state, host) if kinds[name] == "stacked"
                     else host)
        if dims and kinds[name] == "flat":
            _gather_split(out[name], state.tree(buf), dims)
        elif dims and kinds[name] == "stacked":
            _gather_split(out[name], _stacked_tree(state, buf), dims, 1)
    out["batch_stats"] = {name: buf.to("cpu", copy=True)
                          for name, buf in state.batch_stats().items()}
    _gather_split(out["batch_stats"], state.batch_stats(), dims)
    return out


def _gather_split(host: Dict[str, torch.Tensor],
                  device: Mapping[str, torch.Tensor], dims: Mapping[str, int],
                  offset: int = 0) -> None:
    """Replace each split leaf of the host tree by the whole leaf,
    gathered from the device tree's shards (``offset``: leading dims of a
    stacked tree)."""
    for name, dim in dims.items():
        if name in host:
            host[name] = partitioning.gather_leaf(device[name],
                                                  dim + offset).cpu()


def load_canonical(state: TrainState, tree: Mapping[str, Any]) -> None:
    """Copy a :func:`canonical_state` tree into ``state``, in place.  The
    tree carries ``polyak`` exactly when the state has a Polyak average,
    and the state of the state's own optimizer (lars_momentum's when it
    names none)."""
    if tree.get("format") != CANONICAL_FORMAT:
        raise ValueError(f"load_canonical: tree format "
                         f"{tree.get('format')!r}, this code reads "
                         f"{CANONICAL_FORMAT}")
    _load(state, tree, tree["batch_stats"], tree, "load_canonical")
