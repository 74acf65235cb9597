"""flax parameter trees -> torch ``state_dict``.

:func:`from_flax` reads the nested dicts of numpy arrays that
``jax.device_get(init_variables(...))`` returns (``params`` and
``batch_stats``) and yields the state dict of the port's module with the
same names (module paths join with ``.``):

- conv kernel HWIO -> OIHW (the ResNet convs have no bias); Dense kernel
  ``(in, out)`` -> ``(out, in)``;
- LayerNorm ``scale/bias`` -> ``weight/bias``;
- BatchNorm ``scale/bias`` and ``mean/var`` -> ``weight/bias`` and
  ``running_mean/running_var``;
- any other leaf (the ViT's ``cls_token``, ``pos_embedding``) as it is.

It raises on a leaf it cannot place, on BatchNorm statistics without their
module, and, given the target's state dict as ``like``, on any key that
is missing, left over, or of another shape.  Given ``shard`` = (M, i), the
leaves of the tensor-parallel heads are model index i's slices of the
whole ones over a model axis of M (parallel/partitioning.py), the shapes
of a net whose heads are split (models/byol_net.py::shard_heads).

:func:`train_state_from_flax` carries a whole JAX ``TrainState`` across
(params, BN statistics, EMA target, the optimizer's state under optax's
field names, the Polyak params when there are any, schedule count,
``step`` and ``ema_step``), given as numpy nested dicts and ints: the
caller unpacks the optax state, so nothing here needs optax.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            out.update(_flatten(sub, path + "."))
        else:
            out[path] = sub
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_flax(params: Mapping[str, Any],
              batch_stats: Optional[Mapping[str, Any]] = None, *,
              like: Optional[Mapping[str, torch.Tensor]] = None,
              shard: Optional[Tuple[int, int]] = None
              ) -> Dict[str, torch.Tensor]:
    flat = _flatten(params)
    stats = _flatten(batch_stats or {})
    bn_modules = {k.rsplit(".", 1)[0] for k in stats}
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        module, _, name = path.rpartition(".")
        prefix = f"{module}." if module else ""
        arr = np.asarray(leaf)
        if name == "kernel":
            if arr.ndim == 4:                  # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:                # Dense (in, out) -> (out, in)
                arr = arr.T
            else:
                raise ValueError(f"from_flax: kernel {path} of rank "
                                 f"{arr.ndim}; expected 2 (Dense) or 4 (Conv)")
            sd[prefix + "weight"] = _tensor(arr)
        elif name == "scale":                  # LayerNorm / BatchNorm
            sd[prefix + "weight"] = _tensor(arr)
        else:                                  # bias, cls_token, pos_embedding
            sd[path] = _tensor(arr)
    for module in sorted(bn_modules):
        for flax_name, torch_name in (("mean", "running_mean"),
                                      ("var", "running_var")):
            key = f"{module}.{flax_name}"
            if key not in stats:
                raise ValueError(f"from_flax: batch_stats lacks {key}")
            sd[f"{module}.{torch_name}"] = _tensor(stats.pop(key))
        if f"{module}.weight" not in sd:
            raise ValueError(f"from_flax: batch_stats for {module} but no "
                             "BatchNorm scale in params")
    if stats:
        raise ValueError(f"from_flax: unconsumed batch_stats {sorted(stats)}")
    if shard is not None and shard[0] > 1:
        from byol_tpu_torch.parallel.partitioning import shard_leaf, tp_dim
        for key, t in sd.items():
            dim = tp_dim(key, t.ndim)
            if dim is not None:
                sd[key] = shard_leaf(t, dim, *shard, key).clone()
    if like is not None:
        missing = sorted(set(like) - set(sd))
        extra = sorted(set(sd) - set(like))
        if missing or extra:
            raise ValueError(f"from_flax: missing {missing}, unconsumed "
                             f"{extra}")
        for key, t in sd.items():
            if tuple(t.shape) != tuple(like[key].shape):
                raise ValueError(
                    f"from_flax: {key} has shape {tuple(t.shape)}, the "
                    f"target {tuple(like[key].shape)}")
    return sd


def _split_params_and_buffers(
        sd: Mapping[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A converted state dict -> (parameters, BatchNorm running stats)."""
    stats = ("running_mean", "running_var")
    params = {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1]
              not in stats}
    buffers = {k: v for k, v in sd.items() if k not in params}
    return params, buffers


def _stacked_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A tree whose leaves stack ``n`` trees along a leading axis (optax
    lbfgs's memories) -> ``{name: (n, *torch shape)}``, each slice
    converted like a params tree."""
    flat = _flatten(tree)
    n = {np.asarray(v).shape[0] for v in flat.values()}
    if len(n) != 1:
        raise ValueError(f"train_state_from_flax: stacked leaves of "
                         f"lengths {sorted(n)}")
    # from_flax takes the flattened paths as they are
    slices = [from_flax({k: np.asarray(v)[i] for k, v in flat.items()})
              for i in range(n.pop())]
    return {k: torch.stack([s[k] for s in slices]) for k in slices[0]}


def train_state_from_flax(state: Mapping[str, Any], *,
                          like: Optional[Mapping[str, torch.Tensor]] = None
                          ) -> Dict[str, Any]:
    """A JAX ``TrainState`` as numpy -> the port's train-state contents.

    ``state`` holds ``params``, ``batch_stats`` and ``target_params`` as
    nested dicts, the optimizer's state, optionally ``polyak_params``
    (None or absent: no Polyak average), and ``count`` (the schedule
    count), ``step`` and ``ema_step`` as ints.  The optimizer's state is
    either ``momentum`` (the lars_momentum trace tree) or ``opt_state``,
    ``{optax field: tree or int}`` under optax's field names (``trace``;
    ``mu``, ``nu``, ``count``; ``nu``; ``e_g``, ``e_x``; lbfgs's
    ``params``, ``updates``, ``diff_params_memory``,
    ``diff_updates_memory`` (each leaf stacked 10 deep), ``weights_memory``
    and ``count``), with ``optimizer`` its registry name.  Returns
    ``params``, ``target``, the optimizer's fields under the port's names
    (optim/transforms.py::STATE_FIELDS; stacked fields as ``(10, *shape)``
    per name) and, with Polyak params, ``polyak`` (torch-named parameter
    dicts, converted like the params), ``buffers`` (the running
    statistics), ``opt_counts``, ``optimizer`` when given, and the three
    counters as Python ints.  Every tree must have the params' structure.
    ``like`` (the online net's state dict) checks every key and shape.
    The trees are whole: ``training/state.py::load_converted`` keeps a
    model rank's slices of them.
    """
    from byol_tpu_torch.optim.transforms import FROM_OPTAX
    online = from_flax(state["params"], state.get("batch_stats"), like=like)
    params, buffers = _split_params_and_buffers(online)
    out: Dict[str, Any] = {"params": params, "buffers": buffers,
                           "opt_counts": {}}
    carried = [("target_params", "target", from_flax(state["target_params"]))]
    if "opt_state" in state:
        out["optimizer"] = state["optimizer"]
        for field, value in state["opt_state"].items():
            name = FROM_OPTAX.get(field, field)
            if field == "count":
                out["opt_counts"]["count"] = int(value)
            elif field == "weights_memory":
                out[name] = torch.from_numpy(
                    np.array(value, dtype=np.float32, copy=True))
            elif field.endswith("_memory"):
                carried.append((field, name, _stacked_from_flax(value)))
            else:
                carried.append((field, name, from_flax(value)))
    else:
        carried.append(("momentum", "momentum", from_flax(state["momentum"])))
    if state.get("polyak_params") is not None:
        carried.append(("polyak_params", "polyak",
                        from_flax(state["polyak_params"])))
    for key, name, tree in carried:
        if set(tree) != set(params):
            raise ValueError(
                f"train_state_from_flax: {key} does not have the params' "
                f"structure (differs at "
                f"{sorted(set(tree) ^ set(params))[:4]})")
        out[name] = tree
    for key in ("count", "step", "ema_step"):
        out[key] = int(state[key])
    return out
