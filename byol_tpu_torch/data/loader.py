"""Dataset loader (counterpart of byol_tpu/data/loader.py), cut to the
synthetic tasks ``fake`` and ``synth``.

It keeps the JAX batch contract: dicts of numpy arrays ``{'view1',
'view2': (B, H, W, C) float32 in [0, 1], 'label': (B,) int64}``; train
batches are reshuffled per epoch from (seed, epoch) and drop the
remainder, test batches are in order and keep it.

Under ``augment_placement='step'`` the train batches are raw
``{'images': (B, H, W, C) uint8, 'label': (B,) int32}`` and the train
step makes both views on the device (training/steps.py).  Eval keeps the
host path; at ``fake``/``synth`` the raw size is the model size, so the
host resize is the identity.

Host augmentation is NOT ported yet (ROADMAP.md, section 1 item 9): under
loader placement both views are the un-augmented image.
:func:`get_loader` says which of the two it serves in one printed line.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from byol_tpu_torch.core.config import Config
from byol_tpu_torch.data import readers

Batch = Dict[str, np.ndarray]


@dataclasses.dataclass
class LoaderBundle:
    make_train_iter: Callable[[int], Iterator[Batch]]   # epoch -> batches
    make_test_iter: Callable[[int], Iterator[Batch]]
    input_shape: Tuple[int, int, int]
    num_train_samples: int
    num_test_samples: int
    output_size: int
    epoch: int = 0

    def set_all_epochs(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def train_loader(self) -> Iterator[Batch]:
        return self.make_train_iter(self.epoch)

    @property
    def test_loader(self) -> Iterator[Batch]:
        return self.make_test_iter(self.epoch)


def pad_batch(batch: Batch, target: int) -> Batch:
    """Pad a short batch to ``target`` rows and attach a validity ``mask``
    (1.0 = real row), so every eval batch has one shape."""
    n = len(next(iter(batch.values())))
    if n > target:
        raise ValueError(f"pad_batch: batch has {n} rows > target {target}")
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if n < target:
            v = np.concatenate([v, np.zeros((target - n,) + v.shape[1:],
                                            v.dtype)])
        out[k] = v
    mask = np.zeros((target,), np.float32)
    mask[:n] = 1.0
    out["mask"] = mask
    return out


def _pipeline(images: np.ndarray, labels: np.ndarray, *, batch_size: int,
              seed: int, train: bool) -> Callable[[int], Iterator[Batch]]:
    def make(epoch: int) -> Iterator[Batch]:
        idx = np.arange(len(labels))
        if train:
            np.random.RandomState(seed + epoch).shuffle(idx)
        n = len(idx)
        end = n - n % batch_size if train else n
        for lo in range(0, end, batch_size):
            take = idx[lo:lo + batch_size]
            view = images[take].astype(np.float32) / 255.0
            yield {"view1": view, "view2": view, "label": labels[take]}
    return make


def _raw_pipeline(images: np.ndarray, labels: np.ndarray, *,
                  batch_size: int, seed: int
                  ) -> Callable[[int], Iterator[Batch]]:
    """Step-placement train pipeline: raw uint8 batches reshuffled per
    epoch from (seed, epoch), remainder dropped; no host augmentation."""
    labels = labels.astype(np.int32)
    if images.dtype != np.uint8:
        raise ValueError(
            f"augment_placement='step' ships raw uint8 pixels; this dataset "
            f"holds {images.dtype} arrays")

    def make(epoch: int) -> Iterator[Batch]:
        idx = np.arange(len(labels))
        np.random.RandomState(seed + epoch).shuffle(idx)
        end = len(idx) - len(idx) % batch_size
        for lo in range(0, end, batch_size):
            take = idx[lo:lo + batch_size]
            yield {"images": images[take], "label": labels[take]}
    return make


def _check_placement(cfg: Config) -> str:
    """The placement checks of the JAX loader, before any data is made."""
    placement = cfg.task.augment_placement
    if placement not in ("loader", "step"):
        raise ValueError(f"unknown augment_placement {placement!r} "
                         f"('loader'|'step')")
    if placement == "step":
        if cfg.task.task == "image_folder":
            raise ValueError(
                "augment_placement='step' does not serve image_folder: "
                "decode is host-side and yields variable-size images; use "
                "the loader placement")
        if cfg.regularizer.aug_spec != "reference":
            raise ValueError(
                f"augment_placement='step' runs the canonical 'reference' "
                f"augmentation spec on device (got "
                f"aug_spec={cfg.regularizer.aug_spec!r})")
        if cfg.task.data_backend == "device":
            raise ValueError(
                "data_backend='device' (loader-dispatched on-chip augment) "
                "and augment_placement='step' (step-fused augment) are "
                "mutually exclusive; pick one")
    return placement


def get_loader(cfg: Config, *, num_fake_samples: int = 512,
               num_synth_samples: Optional[int] = None) -> LoaderBundle:
    task = cfg.task.task
    batch = cfg.task.batch_size
    size = cfg.task.image_size_override or 32
    placement = _check_placement(cfg)
    if task == "fake":
        x_tr, y_tr = readers.load_fake(num_fake_samples, size,
                                       seed=cfg.device.seed)
        x_te, y_te = readers.load_fake(max(num_fake_samples // 4, batch),
                                       size, seed=cfg.device.seed + 1)
    elif task == "synth":
        n = num_synth_samples or cfg.task.num_synth_samples or 20_000
        x_tr, y_tr = readers.load_synth(n, size, seed=cfg.device.seed,
                                        train=True)
        x_te, y_te = readers.load_synth(max(n // 10, batch), size,
                                        seed=cfg.device.seed, train=False)
    else:
        raise NotImplementedError(
            f"task {task!r} is not ported to byol_tpu_torch yet (ROADMAP.md, "
            "section 1 item 9); ported: 'fake', 'synth'")
    if placement == "step":
        print("loader: raw uint8 train batches; the train step makes both "
              "views on the device (augment_placement='step')", flush=True)
        make_train = _raw_pipeline(x_tr, y_tr, batch_size=batch,
                                   seed=cfg.device.seed)
    else:
        print("loader: host augmentation is not ported yet (ROADMAP.md, "
              "section 1 item 9); both views are the un-augmented image",
              flush=True)
        make_train = _pipeline(x_tr, y_tr, batch_size=batch,
                               seed=cfg.device.seed, train=True)
    return LoaderBundle(
        make_train_iter=make_train,
        make_test_iter=_pipeline(x_te, y_te, batch_size=batch,
                                 seed=cfg.device.seed, train=False),
        input_shape=(size, size, 3),
        num_train_samples=len(x_tr),
        num_test_samples=len(x_te),
        output_size=10)
