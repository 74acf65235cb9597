"""A small writer of the JAX package's orbax checkpoint layout, for the
checks that need a JAX-written checkpoint where there is no JAX (the
card's machine): chip_smoke.py's orbax phase and the tests.  Nothing on
the trainer's or the server's path calls it; the port reads orbax
checkpoints and never writes them otherwise.

:func:`write_checkpoint` writes a nested tree (dicts, lists; numpy arrays
and None at the leaves) as ``StandardCheckpointer`` lays it out:
``_CHECKPOINT_METADATA``, ``_METADATA`` (each leaf's key path and value
type) and an OCDBT store (checkpoint/ocdbt.py) of one uncompressed
B+tree leaf node, where each array is a zarr v2 array of one chunk, the
chunk a zstd frame of raw blocks.  :func:`to_flax` lays a port state
dict out as flax's ``params``/``batch_stats`` (the inverse of
``convert.from_flax``), and :func:`train_state_tree` builds the JAX
``TrainState`` of a lars_momentum run around them; :func:`write_run`
adds the run directory's ``meta.json``.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from byol_tpu_torch.checkpoint import ocdbt, orbax, zstd

MAX_INLINE = 1024              # tensorstore's default max_inline_value_bytes
_BLOCK = 1 << 17               # zstd's largest block


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _column(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def zstd_raw_frame(data) -> List[bytes]:
    """A zstd frame (single segment, content size given) holding
    ``data`` in raw blocks, as a list of byte strings."""
    view = memoryview(data).cast("B")
    n = len(view)
    parts = [struct.pack("<IB", 0xFD2FB528, 0xE0), struct.pack("<Q", n)]
    pos = 0
    while True:
        size = min(n - pos, _BLOCK)
        last = pos + size >= n
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))
        parts.append(view[pos:pos + size])
        pos += size
        if last:
            return parts


def _envelope(magic: int, body: bytes) -> bytes:
    head = struct.pack(">I", magic)
    tail = _varint(0) + _varint(0) + body      # format 0, uncompressed
    length = len(head) + 8 + len(tail) + 4
    data = head + struct.pack("<Q", length) + tail
    return data + struct.pack("<I", zstd.crc32c(data))


def _file_table(paths: List[str]) -> bytes:
    """A data-file table of paths with no base path."""
    raw = [p.encode() for p in paths]
    shared = []
    for prev, cur in zip(raw, raw[1:]):
        k = 0
        while k < min(len(prev), len(cur)) and prev[k] == cur[k]:
            k += 1
        shared.append(k)
    suffix = [len(raw[0])] + [len(c) - k for c, k in zip(raw[1:], shared)]
    return (_varint(len(raw)) + _column(shared) + _column(suffix)
            + _column([0] * len(raw)) + raw[0]
            + b"".join(c[k:] for c, k in zip(raw[1:], shared)))


def _leaf_node(entries: List[Tuple[bytes, Any]], data_file: str) -> bytes:
    """One B+tree leaf: ``entries`` sorted (key, bytes or (offset,
    length) in ``data_file``)."""
    keys = [k for k, _ in entries]
    shared = []
    for prev, cur in zip(keys, keys[1:]):
        k = 0
        while k < min(len(prev), len(cur)) and prev[k] == cur[k]:
            k += 1
        shared.append(k)
    suffix = [len(keys[0])] + [len(c) - k for c, k in zip(keys[1:], shared)]
    lengths = [len(v) if isinstance(v, bytes) else v[1] for _, v in entries]
    kinds = [0 if isinstance(v, bytes) else 1 for _, v in entries]
    indirect = [v for _, v in entries if not isinstance(v, bytes)]
    body = (bytes([0]) + _file_table([data_file]) + _varint(len(entries))
            + _column(shared) + _column(suffix) + keys[0]
            + b"".join(c[k:] for c, k in zip(keys[1:], shared))
            + _column(lengths) + _column(kinds)
            + _column([0] * len(indirect)) + _column(o for o, _ in indirect)
            + b"".join(v for _, v in entries if isinstance(v, bytes)))
    return _envelope(ocdbt.BTREE_MAGIC, body)


def _manifest(uuid: bytes, node_file: str, node_len: int, num_keys: int,
              indirect_bytes: int, commit_ns: int) -> bytes:
    body = (uuid + _varint(0) + _varint(MAX_INLINE) + _varint(100000000)
            + bytes([4]) + _varint(0)                # arity 2^4, no compression
            + _file_table([node_file])
            + _varint(1) + _varint(1) + bytes([0])  # one version, gen 1, height 0
            + _varint(0) + _varint(0) + _varint(node_len)
            + _varint(num_keys) + _varint(node_len) + _varint(indirect_bytes)
            + struct.pack("<Q", commit_ns) + _varint(0))
    return _envelope(ocdbt.MANIFEST_MAGIC, body)


def _leaves(tree: Any, path=(), types=()):
    """``(key path, key types, leaf)`` of a nested tree, dict keys in
    sorted order as flax and orbax keep them."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),),
                               types + (orbax.DICT,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),),
                               types + (orbax.SEQUENCE,))
    else:
        yield path, types, tree


def write_checkpoint(ckpt_dir: str, tree: Any, *, seed: int = 0
                     ) -> Dict[str, int]:
    """Write ``tree`` as a committed orbax checkpoint at ``ckpt_dir``;
    returns the count of keys and the bytes of the arrays and of the
    files written."""
    os.makedirs(os.path.join(ckpt_dir, "d"), exist_ok=True)
    digest = hashlib.sha256(f"{seed}:{ckpt_dir}".encode()).hexdigest()
    data_file, node_file = f"d/{digest[:32]}", f"d/{digest[32:]}"
    tree_meta: Dict[str, Any] = {}
    entries: List[Tuple[bytes, Any]] = []
    array_bytes = offset = 0
    with open(os.path.join(ckpt_dir, data_file), "wb") as f:
        for path, types, leaf in _leaves(tree):
            key_meta = [{"key": k, "key_type": t}
                        for k, t in zip(path, types)]
            if leaf is None:
                tree_meta[str(path)] = {
                    "key_metadata": key_meta,
                    "value_metadata": {"value_type": "None",
                                       "skip_deserialize": True}}
                continue
            arr = np.asarray(leaf)
            arr = arr if arr.flags.c_contiguous else arr.copy(order="C")
            name = ".".join(path)
            zarray = json.dumps({
                "chunks": list(arr.shape),
                "compressor": {"id": "zstd", "level": 1},
                "dimension_separator": ".", "dtype": arr.dtype.str,
                "fill_value": None, "filters": None, "order": "C",
                "shape": list(arr.shape), "zarr_format": 2},
                separators=(",", ":")).encode()
            entries.append((f"{name}/.zarray".encode(), zarray))
            chunk_key = f"{name}/" + (".".join("0" * arr.ndim)
                                      if arr.ndim else "0")
            frame = zstd_raw_frame(arr.reshape(-1).view(np.uint8))
            size = sum(len(p) for p in frame)
            if size <= MAX_INLINE:
                value: Any = b"".join(bytes(p) for p in frame)
            else:
                for part in frame:
                    f.write(part)
                value = (offset, size)
                offset += size
            entries.append((chunk_key.encode(), value))
            array_bytes += arr.nbytes
            tree_meta[str(path)] = {
                "key_metadata": key_meta,
                "value_metadata": {"value_type": "jax.Array",
                                   "skip_deserialize": False,
                                   "write_shape": list(arr.shape)}}
    entries.sort(key=lambda e: e[0])
    node = _leaf_node(entries, data_file)
    with open(os.path.join(ckpt_dir, node_file), "wb") as f:
        f.write(node)
    uuid = bytes.fromhex(digest[:32])
    commit_ns = 1_700_000_000_000_000_000 + seed
    with open(os.path.join(ckpt_dir, orbax.MANIFEST), "wb") as f:
        f.write(_manifest(uuid, node_file, len(node), len(entries), offset,
                          commit_ns))
    with open(os.path.join(ckpt_dir, orbax.TREE_METADATA), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(ckpt_dir, orbax.COMMIT_MARKER), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "standard_checkpoint_handler.StandardCheckpointHandler",
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": commit_ns,
                   "commit_timestamp_nsecs": commit_ns,
                   "custom_metadata": {}}, f)
    return {"keys": len(entries), "array_bytes": array_bytes,
            "file_bytes": offset + len(node)}


def write_run(run_dir: str, epoch: int, tree: Any, *, metric: float,
              seed: int = 0) -> Dict[str, int]:
    """``ckpt-<epoch>`` and the ``meta.json`` the JAX store writes with
    it (the epoch as last and best)."""
    out = write_checkpoint(os.path.join(run_dir, f"ckpt-{epoch}"), tree,
                           seed=seed)
    with open(os.path.join(run_dir, "meta.json"), "w") as f:
        json.dump({"best_epoch": epoch, "best_metric": metric,
                   "history": [{"epoch": epoch, "metric": metric}],
                   "last_epoch": epoch}, f, indent=2, sort_keys=True)
    return out


def to_flax(state_dict: Mapping[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A port state dict (numpy or CPU tensors) -> flax's nested
    ``(params, batch_stats)``: the inverse of ``convert.from_flax``."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, value):
        *mods, leaf = path.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(value, dtype=np.float32, copy=True)

    for key, value in state_dict.items():
        value = np.asarray(value)
        module, _, name = key.rpartition(".")
        prefix = f"{module}." if module else ""
        if name in ("running_mean", "running_var"):
            put(stats, prefix + name[len("running_"):], value)
        elif name == "weight" and value.ndim == 4:      # OIHW -> HWIO
            put(params, prefix + "kernel", value.transpose(2, 3, 1, 0))
        elif name == "weight" and value.ndim == 2:      # (out, in) -> (in, out)
            put(params, prefix + "kernel", value.T)
        elif name == "weight":                          # BatchNorm / LayerNorm
            put(params, prefix + "scale", value)
        else:
            put(params, key, value)
    return params, stats


def train_state_tree(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any],
                     target: Mapping[str, Any], momentum: Mapping[str, Any],
                     *, step: int, ema_step: int, count: int
                     ) -> Dict[str, Any]:
    """The JAX ``TrainState`` of a lars_momentum run (no Polyak average,
    the canonical layout) as orbax saves it: the optax chain
    ``lars(sgd momentum)`` is a sequence of the masked weight decay's
    empty state, the trust ratio's empty state and the base chain's
    ``TraceState`` and ``ScaleByScheduleState``."""
    def i32(v):
        return np.array(v, dtype=np.int32)
    opt_state = [[{"inner_state": None}, None,
                  [{"trace": momentum}, {"count": i32(count)}]]]
    return {"step": i32(step), "params": params, "batch_stats": batch_stats,
            "target_params": target, "ema_step": i32(ema_step),
            "opt_state": opt_state, "polyak_params": None,
            "flat_shadow": None}
