"""The JAX package's orbax checkpoints as numpy trees, without orbax,
tensorstore or JAX.

A ``StandardCheckpointer`` save (byol_tpu/checkpoint/checkpointer.py)
is a directory holding:

- ``_CHECKPOINT_METADATA``, written when the save commits (a
  ``ckpt-<epoch>`` without it, or without ``manifest.ocdbt``, is an
  uncommitted write and is refused);
- ``_METADATA``: JSON whose ``tree_metadata`` gives each leaf's key path
  (``key_type`` 1 a sequence index, 2 a dict key or a namedtuple field)
  and value type (``None`` leaves are skipped on disk); ``use_ocdbt``
  must be true and ``use_zarr3`` false;
- an OCDBT store (checkpoint/ocdbt.py) where each array leaf, named by
  its key path joined with ``.``, is a zarr v2 array: ``<name>/.zarray``
  (shape, chunks, dtype, order, fill value, compressor zstd or none,
  dimension separator) and one key per chunk, ``<name>/0.0``
  (``<name>/0`` for a scalar).  Chunks are full-size at the edges; a
  missing chunk reads as the fill value.

:func:`read_tree` returns the nested tree (dicts; lists for sequences,
None at the positions of empty states), numpy arrays at the leaves and
torch ``bfloat16`` tensors for bf16 leaves (numpy has no bf16: the
uint16 bits are viewed as bf16); given ``keys``, only the leaves under
those key prefixes are read.  :func:`read_train_state` unpacks a JAX
``TrainState`` and its optax chain into what
``convert.train_state_from_flax`` takes.  JAX writes the canonical
layout of the state whatever its flags (ZeRO-1, resident buffers), so
nothing here depends on them.
"""
from __future__ import annotations

import ast
import json
import math
import os
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch

from byol_tpu_torch.checkpoint import zstd
from byol_tpu_torch.checkpoint.ocdbt import OcdbtStore

COMMIT_MARKER = "_CHECKPOINT_METADATA"
TREE_METADATA = "_METADATA"
MANIFEST = "manifest.ocdbt"
_ORBAX_FILES = (COMMIT_MARKER, TREE_METADATA, MANIFEST)

SEQUENCE, DICT = 1, 2          # _METADATA key types
# the fields of the optax states the registry's chains hold
# (optim/transforms.py::STATE_FIELDS under optax's names)
OPTAX_FIELDS = frozenset({"trace", "mu", "nu", "count", "e_g", "e_x",
                          "params", "updates", "diff_params_memory",
                          "diff_updates_memory", "weights_memory"})
TRAIN_STATE_FIELDS = ("step", "params", "batch_stats", "target_params",
                      "ema_step", "opt_state", "polyak_params",
                      "flat_shadow")

Prefix = Union[str, Sequence[str]]


def is_committed(path: str) -> bool:
    """An orbax checkpoint whose save committed."""
    return all(os.path.isfile(os.path.join(path, f))
               for f in (COMMIT_MARKER, MANIFEST))


def looks_like_orbax(path: str) -> bool:
    """A directory holding any of orbax's files (committed or not)."""
    return any(os.path.exists(os.path.join(path, f)) for f in _ORBAX_FILES)


def _leaf_entries(ckpt_dir: str) -> List[Tuple[Tuple[str, ...],
                                               Tuple[int, ...], Dict]]:
    if not is_committed(ckpt_dir):
        raise ValueError(f"{ckpt_dir} is not a committed orbax checkpoint "
                         f"(it needs {COMMIT_MARKER} and {MANIFEST}: an "
                         "uncommitted write lacks them)")
    with open(os.path.join(ckpt_dir, TREE_METADATA)) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{ckpt_dir}: not an OCDBT checkpoint (use_ocdbt is "
                         "false); orbax's per-leaf layout is not read here")
    if meta.get("use_zarr3", False):
        raise ValueError(f"{ckpt_dir}: zarr3 leaves are not read here (the "
                         "JAX package writes zarr v2)")
    out = []
    for name, entry in meta["tree_metadata"].items():
        keys = entry.get("key_metadata")
        if not keys:
            # the key path as orbax prints it, e.g. "('params', 'w')"
            path = tuple(str(k) for k in ast.literal_eval(name))
            types = (DICT,) * len(path)
        else:
            path = tuple(str(k["key"]) for k in keys)
            types = tuple(int(k["key_type"]) for k in keys)
        out.append((path, types, entry.get("value_metadata", {})))
    return out


def _selected(path: Tuple[str, ...], prefixes: Optional[List[Tuple[str,
                                                                   ...]]]
              ) -> bool:
    return prefixes is None or any(path[:len(p)] == p for p in prefixes)


def _prefixes(keys: Optional[Iterable[Prefix]]
              ) -> Optional[List[Tuple[str, ...]]]:
    if keys is None:
        return None
    return [tuple(k.split(".")) if isinstance(k, str) else
            tuple(str(x) for x in k) for k in keys]


def _fill(fill: Any, dtype: np.dtype, bf16: bool) -> np.ndarray:
    """The zarr fill value as one element of the stored dtype."""
    if fill is None:
        fill = 0
    if isinstance(fill, str):
        fill = {"NaN": math.nan, "Infinity": math.inf,
                "-Infinity": -math.inf}.get(fill, fill)
    if bf16:
        bits = torch.tensor(float(fill), dtype=torch.bfloat16).view(
            torch.int16).item()
        return np.array(bits & 0xFFFF, dtype)
    return np.array(fill, dtype)


class _Leaf:
    """One zarr v2 array: its metadata, its output and its chunk keys."""

    def __init__(self, path: Tuple[str, ...], name: str, zarray: bytes
                 ) -> None:
        self.path, self.name = path, name
        try:
            z = json.loads(zarray)
        except ValueError as e:
            raise ValueError(f"orbax: {path}: bad .zarray: {e}") from e
        if z.get("zarr_format") != 2:
            raise ValueError(f"orbax: {path}: zarr_format "
                             f"{z.get('zarr_format')}, this reader knows 2")
        if z.get("filters"):
            raise ValueError(f"orbax: {path}: zarr filters {z['filters']} "
                             "are not read here")
        comp = z.get("compressor")
        self.compressor = None if comp is None else comp.get("id")
        if self.compressor not in (None, "zstd"):
            raise ValueError(f"orbax: {path}: compressor {comp} (zstd or "
                             "none are read)")
        self.shape = tuple(int(s) for s in z["shape"])
        self.chunks = tuple(int(c) for c in z["chunks"])
        if len(self.chunks) != len(self.shape) or any(
                c <= 0 for c in self.chunks):
            raise ValueError(f"orbax: {path}: chunks {self.chunks} for shape "
                             f"{self.shape}")
        self.order = z.get("order", "C")
        if self.order not in ("C", "F"):
            raise ValueError(f"orbax: {path}: order {self.order!r}")
        self.bf16 = z["dtype"] == "bfloat16"
        self.dtype = np.dtype("<u2" if self.bf16 else z["dtype"])
        sep = z.get("dimension_separator", ".")
        self.fill = _fill(z.get("fill_value"), self.dtype, self.bf16)
        self.out = np.empty(self.shape, self.dtype)
        grid = [range(-(-s // c)) for s, c in zip(self.shape, self.chunks)]
        self.cells: Dict[bytes, Tuple[int, ...]] = {}
        for idx in np.ndindex(*[len(g) for g in grid]):
            key = sep.join(str(i) for i in idx) if idx else "0"
            self.cells[f"{name}/{key}".encode()] = idx
        self.done: set = set()

    def _region(self, idx: Tuple[int, ...]) -> Tuple[slice, ...]:
        return tuple(slice(i * c, min((i + 1) * c, s))
                     for i, c, s in zip(idx, self.chunks, self.shape))

    def put(self, key: bytes, value: bytes) -> None:
        idx = self.cells[key]
        nbytes = int(np.prod(self.chunks, dtype=np.int64)) * \
            self.dtype.itemsize
        region = self._region(idx)
        whole = self.chunks == self.shape and (
            self.order == "C" or len(self.shape) <= 1)
        dst = self.out.reshape(-1).view(np.uint8) if whole else \
            np.empty(nbytes, np.uint8)
        try:
            if self.compressor == "zstd":
                n = zstd.decompress(value, dst)
            else:
                n = min(len(value), nbytes)
                dst[:n] = np.frombuffer(value, np.uint8, n)
                n = len(value)
        except ValueError as e:
            raise ValueError(f"orbax: {self.path} chunk {key.decode()}: "
                             f"{e}") from e
        if n != nbytes:
            raise ValueError(f"orbax: {self.path} chunk {key.decode()} "
                             f"holds {n} bytes, a chunk of {self.chunks} "
                             f"{self.dtype} {nbytes}")
        if not whole:
            chunk = dst.view(self.dtype).reshape(self.chunks,
                                                 order=self.order)
            self.out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                           for r in region)]
        self.done.add(key)

    def result(self) -> Any:
        for key, idx in self.cells.items():
            if key not in self.done:
                self.out[self._region(idx)] = self.fill
        out = self.out
        if self.bf16:
            return torch.from_numpy(out.astype("=u2").view(np.int16)).view(
                torch.bfloat16)
        if not out.dtype.isnative:
            out = out.astype(out.dtype.newbyteorder("="))
        return out


def _assemble(leaves: List[Tuple[Tuple[str, ...], Tuple[int, ...], Any]]
              ) -> Dict[str, Any]:
    """Nested dicts from key paths; nodes whose children are sequence
    indices become lists (None where no leaf was saved)."""
    root: Dict[Any, Any] = {}
    kinds: Dict[int, int] = {}
    for path, types, value in leaves:
        node = root
        for depth, (key, kind) in enumerate(zip(path, types)):
            if kinds.setdefault(id(node), kind) != kind:
                raise ValueError(f"orbax: {path[:depth + 1]} mixes sequence "
                                 "indices and dict keys")
            k: Any = int(key) if kind == SEQUENCE else key
            if depth == len(path) - 1:
                if k in node:
                    raise ValueError(f"orbax: {path} is saved twice")
                node[k] = value
            else:
                if k in node and not isinstance(node[k], dict):
                    raise ValueError(f"orbax: {path[:depth + 1]} is both a "
                                     "leaf and a node")
                node = node.setdefault(k, {})

    def finish(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if kinds.get(id(node)) == SEQUENCE:
            out = [None] * (max(node) + 1 if node else 0)
            for i, v in node.items():
                out[i] = finish(v)
            return out
        return {k: finish(v) for k, v in node.items()}

    return finish(root)


def read_tree(ckpt_dir: str, keys: Optional[Iterable[Prefix]] = None, *,
              stats: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The checkpoint's tree as numpy (bf16 leaves as torch bf16).
    ``keys``: key-path prefixes (``"params"``, ``"opt_state.0"`` or
    tuples); only the leaves under them are read.  ``stats``, when given,
    receives the keys and bytes read, the bytes of the arrays they
    decode to, the store's key count and the seconds taken."""
    start = time.perf_counter()
    prefixes = _prefixes(keys)
    entries = [e for e in _leaf_entries(ckpt_dir)
               if _selected(e[0], prefixes)]
    store = OcdbtStore(ckpt_dir)
    arrays = [(path, ".".join(path)) for path, _, vm in entries
              if not (vm.get("skip_deserialize")
                      or vm.get("value_type") == "None")]
    zkeys = [f"{name}/.zarray".encode() for _, name in arrays]
    missing = [k for k in zkeys if k not in store.entries()]
    if missing:
        raise ValueError(f"orbax: {ckpt_dir}: no zarr array at "
                         f"{missing[:4]} (the OCDBT store does not hold "
                         "these leaves)")
    zarrays = store.read_many(zkeys)
    leaves: Dict[str, _Leaf] = {}
    owner: Dict[bytes, _Leaf] = {}
    for (path, name), zkey in zip(arrays, zkeys):
        leaf = _Leaf(path, name, zarrays[zkey])
        leaves[name] = leaf
        for key in leaf.cells:
            if key in store.entries():
                owner[key] = leaf
    for key, value in store.iter_many(list(owner)):
        owner[key].put(key, value)
    values = {name: leaf.result() for name, leaf in leaves.items()}
    tree = _assemble([(path, types, values.get(".".join(path)))
                      for path, types, _ in entries])
    if stats is not None:
        stats.update(keys_read=len(zkeys) + len(owner),
                     keys_total=len(store.entries()),
                     bytes_read=store.bytes_read,
                     array_bytes=sum(leaf.out.nbytes
                                     for leaf in leaves.values()),
                     leaves=len(arrays), seconds=time.perf_counter() - start)
    return tree


def _numpy(tree: Any) -> Any:
    """bf16 tensors -> float32 numpy (exact), containers kept."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _chain_fields(opt_state: Any, path: Tuple[str, ...] = ("opt_state",)
                 ) -> Tuple[Dict[str, Any], List[Any]]:
    """``({optax field: tree or leaf}, [schedule counts])`` of an optax
    chain state read from disk, where the node types are gone: a node
    whose keys are all optax state fields is a state (``{count}`` alone is
    a ScaleByScheduleState), anything else is walked through.  Raises on
    a leaf that belongs to no state, or a field held twice."""
    fields: Dict[str, Any] = {}
    counts: List[Any] = []

    def walk(node: Any, at: Tuple[str, ...]) -> None:
        if node is None:
            return
        if isinstance(node, list):
            for i, child in enumerate(node):
                walk(child, at + (str(i),))
        elif isinstance(node, dict):
            if node and set(node) <= OPTAX_FIELDS:
                if set(node) == {"count"}:
                    counts.append(node["count"])
                    return
                for k, v in node.items():
                    if k in fields:
                        raise ValueError(f"orbax: the optimizer state holds "
                                         f"{k!r} twice (again at {at})")
                    fields[k] = v
            else:
                for k, child in node.items():
                    walk(child, at + (k,))
        else:
            raise ValueError(f"orbax: the leaf at {at} cannot be placed in "
                             "an optax state")

    walk(opt_state, path)
    return fields, counts


def read_train_state(ckpt_dir: str, optimizer: str = "lars_momentum", *,
                     stats: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """A JAX ``TrainState`` checkpoint -> the dict
    ``convert.train_state_from_flax`` takes: ``params``, ``batch_stats``,
    ``target_params``, ``opt_state`` under optax's field names with
    ``optimizer`` (the registry name, which the chain's fields must
    match: optim/transforms.py::STATE_FIELDS), ``polyak_params`` (None
    without), and ``count`` (the schedule's), ``step`` and ``ema_step``
    as ints."""
    from byol_tpu_torch.optim.transforms import (COUNT_FIELDS, FROM_OPTAX,
                                                 STATE_FIELDS)
    from byol_tpu_torch.training.state import optimizer_base
    tree = _numpy(read_tree(ckpt_dir, stats=stats))
    extra = sorted(set(tree) - set(TRAIN_STATE_FIELDS))
    if extra:
        raise ValueError(f"orbax: {ckpt_dir}: the leaves under "
                         f"{[(k,) for k in extra]} cannot be placed in a "
                         "TrainState")
    for key in ("step", "params", "target_params", "ema_step", "opt_state"):
        if key not in tree:
            raise ValueError(f"orbax: {ckpt_dir}: no {(key,)} in the "
                             "checkpoint; not a TrainState")
    if tree.get("flat_shadow") is not None:
        raise ValueError(f"orbax: {ckpt_dir}: the leaf at ('flat_shadow',) "
                         "cannot be placed (a resident layout; JAX saves "
                         "the canonical one)")
    fields, counts = _chain_fields(tree["opt_state"])
    base = optimizer_base(optimizer)
    to_optax = {v: k for k, v in FROM_OPTAX.items()}
    want = {to_optax.get(name, name) for name, _ in STATE_FIELDS[base]}
    want |= set(COUNT_FIELDS.get(base, ()))
    if set(fields) != want or len(counts) != 1:
        raise ValueError(
            f"orbax: {ckpt_dir}: the optimizer state holds fields "
            f"{sorted(fields)} and {len(counts)} schedule count(s); "
            f"{optimizer!r} keeps {sorted(want)} and one schedule count")
    opt_state = {k: (int(v) if k == "count" else v)
                 for k, v in fields.items()}
    return {"params": tree["params"],
            "batch_stats": tree.get("batch_stats") or {},
            "target_params": tree["target_params"],
            "optimizer": optimizer.lower().strip(),
            "opt_state": opt_state,
            "polyak_params": tree.get("polyak_params"),
            "count": int(counts[0]), "step": int(tree["step"]),
            "ema_step": int(tree["ema_step"])}


def read_weights(ckpt_dir: str, *, stats: Optional[Dict[str, Any]] = None
                 ) -> Tuple[Mapping[str, Any], Mapping[str, Any]]:
    """``(params, batch_stats)`` of the checkpoint, reading no other
    leaf (what serving needs)."""
    tree = _numpy(read_tree(ckpt_dir, ("params", "batch_stats"),
                            stats=stats))
    if "params" not in tree:
        raise ValueError(f"orbax: {ckpt_dir}: no ('params',) in the "
                         "checkpoint")
    return tree["params"], tree.get("batch_stats") or {}
