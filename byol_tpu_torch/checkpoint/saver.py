"""Best-metric checkpointing and early stopping: the ModelSaver contract
(counterpart of byol_tpu/checkpoint/saver.py, with its semantics).

- called once per epoch with the test metric; returns True when training
  should stop (patience ``max_early_stop_steps`` exhausted under
  ``early_stop``);
- the first ``burn_in_interval`` epochs are saved as last, never as best,
  and count no stall;
- the best metric, the stall count and a durable ``stopped_early`` marker
  live in the store's metadata, so they survive a relaunch;
- :meth:`restore` from the best checkpoint resets the stall count (the
  rewound epochs are about to be trained again).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from byol_tpu_torch.checkpoint.checkpointer import CheckpointStore


class ModelSaver:
    def __init__(self, directory: str, *, early_stop: bool = False,
                 burn_in_interval: int = 0, larger_is_better: bool = False,
                 max_early_stop_steps: int = 10, keep: int = 2,
                 optimizer: str = "lars_momentum") -> None:
        self.store = CheckpointStore(directory, optimizer=optimizer)
        self.early_stop = early_stop
        self.burn_in_interval = burn_in_interval
        self.larger_is_better = larger_is_better
        self.max_early_stop_steps = max_early_stop_steps
        self.keep = keep
        meta = self.store.read_meta()
        self.best_metric: Optional[float] = meta.get("best_metric")
        self.stall_count: int = int(meta.get("stall_count", 0))
        self.stopped_early: bool = bool(meta.get("stopped_early", False))

    def _improved(self, metric: float) -> bool:
        if self.best_metric is None or math.isnan(self.best_metric):
            return True
        if self.larger_is_better:
            return metric > self.best_metric
        return metric < self.best_metric

    def __call__(self, metric: float, epoch: int, tree: Any) -> bool:
        """Record this epoch's metric and save ``tree`` (a host tree, as
        best if it improved after burn-in); return True when early stopping
        should trigger."""
        if epoch < self.burn_in_interval:
            # saved as last, so a preemption during burn-in resumes
            self.store.save(epoch, tree, metric=float(metric),
                            is_best=False, keep=self.keep)
            return False
        improved = self._improved(float(metric))
        if improved:
            self.best_metric = float(metric)
            self.stall_count = 0
        else:
            self.stall_count += 1
        self.store.save(epoch, tree, metric=float(metric),
                        is_best=improved, keep=self.keep)
        stop = bool(self.early_stop
                    and self.stall_count >= self.max_early_stop_steps)
        meta = self.store.read_meta()
        meta["stall_count"] = self.stall_count
        meta["best_metric"] = self.best_metric
        # restore(best=True) picks the best survivor by this direction if
        # the best checkpoint never reached the disk
        meta["larger_is_better"] = self.larger_is_better
        if stop:
            # a relaunch of a stopped run must not train again
            meta["stopped_early"] = True
        self.store.write_meta(meta)
        return stop

    def restore(self, *, best: bool = True) -> Tuple[Dict[str, Any], int]:
        """``(tree, next_epoch)`` from the best (default) or the last
        checkpoint."""
        tree, epoch = self.store.restore(best=best)
        if best:
            self.stall_count = 0
            meta = self.store.read_meta()
            meta["stall_count"] = 0
            self.store.write_meta(meta)
        return tree, epoch + 1

    def has_checkpoint(self) -> bool:
        return bool(self.store.epochs())

    def close(self) -> None:
        self.store.close()
