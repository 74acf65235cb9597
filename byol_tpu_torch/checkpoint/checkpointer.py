"""The checkpoint store (counterpart of byol_tpu/checkpoint/checkpointer.py).

A directory of ``ckpt-<epoch>/`` checkpoints beside a ``meta.json`` that
tracks the last and the best epoch, with the JAX store's layout, metadata
keys and pruning.  Each checkpoint holds one file, ``state.pt``: the
``torch.save`` of a tree of CPU tensors and ints
(``training/state.py::canonical_state``), read back with
``torch.load(..., weights_only=True)``, which unpickles tensors and plain
containers only.

A save has two stages.  The caller hands over a tree that is already on
the host (the device-to-host copy is the caller's, and synchronous); the
file write then runs on one background thread, into ``ckpt-<epoch>.tmp/``,
moved into place when complete, so no reader ever sees a partial
checkpoint.  :meth:`epochs`, :meth:`save`, :meth:`restore`, :meth:`wait`
and :meth:`close` wait for the write in flight; a write that failed raises
there.

A ``ckpt-<epoch>`` directory without ``state.pt`` is not this store's: the
JAX package writes orbax checkpoints under the same names (a run of the
same flags has the same run name).  The store refuses such a directory
with an error naming it, before it deletes or writes anything.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from byol_tpu_torch.observability.events import sanitize

_STEP_RE = re.compile(r"^ckpt-(\d+)$")
_META = "meta.json"
_STATE = "state.pt"

# meta.json is strict JSON: non-finite metrics are written as strings by
# events.sanitize and read back as floats, under the keys that hold floats
_NONFINITE_STR = {"NaN": float("nan"), "Infinity": float("inf"),
                  "-Infinity": float("-inf")}
_NUMERIC_META_KEYS = frozenset({"metric", "best_metric"})


def _meta_restore(obj: Any, key: Optional[str] = None) -> Any:
    if isinstance(obj, dict):
        return {k: _meta_restore(v, k) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_meta_restore(v, key) for v in obj]
    if (key in _NUMERIC_META_KEYS and isinstance(obj, str)
            and obj in _NONFINITE_STR):
        return _NONFINITE_STR[obj]
    return obj


class CheckpointStore:
    """``ckpt-<epoch>/state.pt`` checkpoints and ``meta.json`` under
    ``directory``."""

    def __init__(self, directory: str) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._writer = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint_writer")
        self._pending: Optional[concurrent.futures.Future] = None
        self.epochs()                 # refuse a foreign directory now

    # -- metadata ----------------------------------------------------------
    def _meta_path(self) -> str:
        return os.path.join(self.directory, _META)

    def read_meta(self) -> Dict[str, Any]:
        try:
            with open(self._meta_path()) as f:
                return _meta_restore(json.load(f))
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def write_meta(self, meta: Dict[str, Any]) -> None:
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sanitize(meta), f, indent=2, sort_keys=True,
                      allow_nan=False)
        os.replace(tmp, self._meta_path())

    # -- checkpoints -------------------------------------------------------
    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt-{epoch}")

    def wait(self) -> None:
        """Wait for the write in flight; raise its error if it failed."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def epochs(self) -> Tuple[int, ...]:
        """The epochs on disk, in order.  Raises ValueError on a
        ``ckpt-<epoch>`` directory this store did not write."""
        self.wait()
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.directory, name)
            if not os.path.isfile(os.path.join(path, _STATE)):
                held = sorted(os.listdir(path))[:4]
                raise ValueError(
                    f"{path} is not a byol_tpu_torch checkpoint (no "
                    f"{_STATE}; it holds {held}: an orbax checkpoint of the "
                    "JAX package has the same name); move it away or use "
                    "another --model-dir or --uid")
            out.append(int(m.group(1)))
        return tuple(sorted(out))

    def save(self, epoch: int, tree: Any, *, metric: Optional[float] = None,
             is_best: bool = False, keep: int = 2) -> None:
        """Start writing ``tree`` (on the host already) as
        ``ckpt-<epoch>``, update the metadata and prune old non-best
        checkpoints.  Returns once the write is scheduled; it waits only
        for the previous write."""
        self.wait()
        self._prune(keep)  # before scheduling: never wait on the new write
        self._pending = self._writer.submit(self._write, epoch, tree)
        meta = self.read_meta()
        meta["last_epoch"] = epoch
        if metric is not None:
            meta.setdefault("history", []).append(
                {"epoch": epoch, "metric": float(metric)})
        if is_best:
            meta["best_epoch"] = epoch
            if metric is not None:
                meta["best_metric"] = float(metric)
        self.write_meta(meta)

    def _write(self, epoch: int, tree: Any) -> None:
        final = self._path(epoch)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)   # a crashed earlier write
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STATE), "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())      # on disk before the rename publishes it
        if os.path.isdir(final):
            # a re-save of the epoch (a preemption checkpoint, then the
            # epoch's own): rename(2) does not replace a non-empty directory
            old = final + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)

    def _prune(self, keep: int) -> None:
        best = self.read_meta().get("best_epoch")
        eps = [e for e in self.epochs() if e != best]
        for e in eps[:-keep] if keep else eps:
            shutil.rmtree(self._path(e))

    def restore(self, epoch: Optional[int] = None, *, best: bool = False
                ) -> Tuple[Dict[str, Any], int]:
        """``(tree, epoch)`` of the last checkpoint, the best with
        ``best``, or exactly ``epoch`` when given."""
        eps = self.epochs()
        if epoch is None:
            meta = self.read_meta()
            epoch = meta.get("best_epoch") if best else meta.get("last_epoch")
            # meta is written when a save is scheduled, so a crash before
            # the write completed leaves it naming a checkpoint that never
            # reached the disk: never trust it blindly
            if epoch is not None and epoch not in eps:
                print(f"checkpoint: meta points at missing ckpt-{epoch} "
                      f"(crash before the write completed?); falling back "
                      f"to the {'best-metric' if best else 'newest'} "
                      "checkpoint on disk")
                epoch = None
            if epoch is None:
                if not eps:
                    raise FileNotFoundError(
                        f"no checkpoints under {self.directory}")
                epoch = eps[-1]
                if best:
                    # the newest is typically the worst after a stall: take
                    # the best recorded metric among the survivors
                    history = {h["epoch"]: h["metric"]
                               for h in meta.get("history", [])
                               if h.get("metric") is not None}
                    scored = [e for e in eps if e in history]
                    if scored:
                        larger = bool(meta.get("larger_is_better", False))
                        epoch = (max if larger else min)(
                            scored, key=lambda e: history[e])
        # an explicitly requested epoch is never substituted: a missing one
        # raises FileNotFoundError here
        tree = torch.load(os.path.join(self._path(epoch), _STATE),
                          map_location="cpu", weights_only=True)
        return tree, int(epoch)

    def close(self) -> None:
        """Wait for the write in flight (raising its error) and stop the
        writer thread."""
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)
