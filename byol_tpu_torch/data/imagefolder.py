"""ImageFolder trees (counterpart of byol_tpu/data/imagefolder.py): a class
per subdirectory under ``data_dir/train`` and ``data_dir/test``, and an
optional ``data_dir/valid``, the ImageNet layout the reference's default
task reads.

Two routes make the views:

- ``native``: the C++ pipeline decodes only the crop window of each JPEG
  with libjpeg and augments it (``native_aug.jpeg_augment_two_views``);
  a file it rejects (a PNG, a CMYK JPEG) goes through PIL and the array
  path on the same streams.  Its seeds are the JAX package's (the epoch
  folded into the seed, ``index_base`` the batch's offset), so its views
  equal the JAX package's native views bit for bit.  Without libjpeg the
  loader moves to ``tf`` with one printed line, as the JAX package does;
- ``tf``: PIL decodes the whole image and the torch host path
  (:mod:`augment`) crops and augments it on DataLoader workers, each view
  from the generator of (seed, epoch, file index, view).  It needs PIL.

An on-disk ``valid/`` root wins over ``valid_fraction``, which otherwise
holds out the JAX package's seeded split of the train files.

Data parallel, as the JAX loader shards per host: data rank r of w (the
mesh's data axis: a sequence group's ranks share r) reads the
files ``[r::w]`` of the train and valid lists (the valid split carved
first, the same on every rank), and of the test list only under
``shard_eval``; the native stream seed adds ``7_919 * r`` as JAX's does,
and the ``tf`` path keys each file's draws by its index in the unsharded
list.
"""
from __future__ import annotations

import concurrent.futures
import os
from typing import Callable, Iterator, List, Tuple

import numpy as np
import torch

from byol_tpu_torch.core.config import Config

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def scan_image_folder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """-> (paths, labels, class_names); classes sorted for determinism."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    paths, labels = [], []
    for li, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMG_EXTS):
                paths.append(os.path.join(cdir, fname))
                labels.append(li)
    return paths, labels, classes


class FileSource:
    """Images decoded by PIL from a list of paths (RGB uint8 HWC)."""

    def __init__(self, paths: List[str]):
        self.paths = list(paths)

    def __getitem__(self, i: int) -> np.ndarray:
        from PIL import Image
        with Image.open(self.paths[i]) as image:
            return np.array(image.convert("RGB"))


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def shard_files(paths: List[str], labels: List[int], index: int,
                count: int) -> Tuple[List[str], List[int]]:
    """Rank ``index``'s interleaved share of a file list (JAX's
    ``paths[index::count]``)."""
    return paths[index::count], labels[index::count]


def _native_iter(paths: List[str], labels: np.ndarray, *, batch_size: int,
                 size: int, train: bool, seed: int, strength: float,
                 workers: int, rank: int = 0
                 ) -> Callable[[int], Iterator[dict]]:
    """Files read on ``workers`` threads, one native call per batch."""
    from byol_tpu_torch.data import native_aug
    from byol_tpu_torch.data.loader import epoch_batches
    paths = np.asarray(paths)

    def make(epoch: int) -> Iterator[dict]:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            for i, take in enumerate(epoch_batches(len(labels), batch_size,
                                                   seed, epoch, train)):
                blobs = list(pool.map(_read, paths[take]))
                if train:
                    v1, v2 = native_aug.jpeg_augment_two_views(
                        blobs, size, color_jitter_strength=strength,
                        seed=seed + 1_000_003 * epoch + 7_919 * rank,
                        index_base=i * batch_size, num_threads=workers)
                else:
                    v1 = v2 = native_aug.jpeg_resize_batch(
                        blobs, size, num_threads=workers)
                yield {"view1": v1, "view2": v2, "label": labels[take]}

    return make


def image_folder_loader(cfg: Config, *, backend: str, device="cpu",
                        process: Tuple[int, int] = (0, 1)):
    """A LoaderBundle over the train/ and test/ (and valid/) roots;
    ``backend`` is ``'native'`` or ``'tf'``, as ``get_loader`` resolved
    it; ``process`` the data axis's ``(rank, world)``."""
    from byol_tpu_torch.data.loader import (LoaderBundle, carve_valid_split,
                                            host_pipeline)

    if backend == "tf":
        try:
            import PIL  # noqa: F401
        except ImportError as e:
            raise ValueError(
                "image_folder with data_backend='tf' decodes with PIL, which "
                "is not installed; install PIL, or use data_backend='native' "
                "with the native library's JPEG build (libjpeg)") from e
    size = cfg.task.image_size_override or 224
    seed = cfg.device.seed
    index, count = process
    batch = cfg.task.batch_size // count
    shard_eval = cfg.device.shard_eval and count > 1
    workers = cfg.device.workers_per_replica
    roots = {}
    for split in ("train", "test"):
        root = os.path.join(cfg.task.data_dir, split)
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"image_folder task expects {root}/<class>/<img>")
        roots[split] = scan_image_folder(root)
    tr_paths, tr_labels, classes = roots["train"]
    te_paths, te_labels, te_classes = roots["test"]
    if te_classes != classes:
        raise ValueError("train/ and test/ class sets differ")

    va_paths: List[str] = []
    va_labels: List[int] = []
    valid_root = os.path.join(cfg.task.data_dir, "valid")
    if os.path.isdir(valid_root):
        va_paths, va_labels, va_classes = scan_image_folder(valid_root)
        if va_classes != classes:
            raise ValueError("train/ and valid/ class sets differ")
    elif cfg.task.valid_fraction > 0:
        va_idx, tr_idx = carve_valid_split(len(tr_paths),
                                           cfg.task.valid_fraction, seed)
        va_paths = [tr_paths[i] for i in va_idx]
        va_labels = [tr_labels[i] for i in va_idx]
        tr_paths = [tr_paths[i] for i in tr_idx]
        tr_labels = [tr_labels[i] for i in tr_idx]

    n_train, n_test, n_valid = len(tr_paths), len(te_paths), len(va_paths)
    # each train file's index in the unsharded list keys its draws
    draw_index = np.arange(n_train)[index::count]
    tr_paths, tr_labels = shard_files(tr_paths, tr_labels, index, count)
    va_paths, va_labels = shard_files(va_paths, va_labels, index, count)
    if shard_eval:
        te_paths, te_labels = shard_files(te_paths, te_labels, index, count)

    def make_iter(paths, labels, train: bool):
        labels = np.asarray(labels, np.int32)
        if backend == "native":
            return _native_iter(paths, labels, batch_size=batch, size=size,
                                train=train, seed=seed,
                                strength=cfg.regularizer.color_jitter_strength,
                                workers=max(workers, 1), rank=index)
        return host_pipeline(
            FileSource(paths), labels, batch_size=batch, image_size=size,
            train=train, seed=seed,
            strength=cfg.regularizer.color_jitter_strength,
            spec=cfg.regularizer.aug_spec, workers=workers,
            pin_memory=torch.device(device).type == "cuda",
            draw_index=draw_index if train and count > 1 else None)

    return LoaderBundle(
        make_train_iter=make_iter(tr_paths, tr_labels, True),
        make_test_iter=make_iter(te_paths, te_labels, False),
        make_train_eval_iter=make_iter(tr_paths, tr_labels, False),
        make_valid_iter=(make_iter(va_paths, va_labels, False) if n_valid
                         else None),
        input_shape=(size, size, 3),
        num_train_samples=n_train,
        num_test_samples=n_test,
        num_valid_samples=n_valid,
        output_size=len(classes),
        eval_sharded=shard_eval)
