"""Dataset loader (counterpart of byol_tpu/data/loader.py).

It keeps the JAX batch contract: dicts ``{'view1', 'view2': (B, H, W, C)
float32 in [0, 1], 'label': (B,)}``; train batches are reshuffled per
epoch from (seed, epoch) and drop the remainder, eval batches are in order
and keep it.  Tasks: ``fake``, ``synth``, the array datasets of
:mod:`readers` (``cifar10``, ``cifar100``, ``mnist``, ``fashion_mnist``,
``digits``) and ``image_folder`` (:mod:`imagefolder`; the reference's
``multi_augment_image_folder`` and ``dali_multi_augment_image_folder``
names alias to it).

Under ``augment_placement='loader'`` the train views are made by one of
three backends:

- ``tf``: the torch host path, :mod:`augment` on CPU tensors, run on a
  ``torch.utils.data.DataLoader`` with ``workers_per_replica`` workers,
  spawned (fork is unsafe in a process with threads) and kept across
  epochs, batches pinned when the device is a card.  The eval transform
  of an in-memory dataset (one resize) runs in this process.  The value
  keeps the JAX package's name; no TensorFlow runs.  One deviation: the
  JAX tf.data path shuffles with ``Dataset.shuffle``, whose order cannot
  be made without TF, so this path shuffles as the JAX native path does,
  with ``RandomState(seed + epoch)``;
- ``native``: the C++ pipeline of :mod:`native_aug`, on
  ``workers_per_replica`` threads, whose views equal the JAX package's
  bit for bit.  Without a toolchain the loader says so in one line and
  moves to ``tf``, where the JAX package moves to tf.data;
- ``device``: the draws made on the host from (seed, epoch, batch)
  generators, the views on the card by the unfused chain
  (``device_augment.two_view``; not kernel K2, as the JAX package's
  ``two_view_batch`` is not its Pallas kernel).  Eval stays on ``tf``.

Under ``augment_placement='step'`` the train batches are raw ``{'images':
(B, H, W, C) uint8, 'label'}`` and the train step makes both views on the
device (training/steps.py).  Eval batches are resized to the model size
(``augment.test_resize``, or the native ``resize_batch``).

``valid_fraction > 0`` holds out the head of a seeded permutation of the
train split (:func:`carve_valid_split`, the JAX split), evaluated like the
test split.  :func:`get_loader` prints one line that says which path makes
the train views.

Data parallel (parallel/mesh.py), as the JAX loader shards per host, over
the mesh's data axis: data rank d of D reads batches of ``global / D``
rows from its contiguous shard of the train split (:func:`shard_arrays`,
JAX's ``_shard_arrays``) and of the valid split, which is carved
identically on every rank first; the test split stays whole unless
``shard_eval`` (JAX's Quirk Q9), and the trainer deals its batches over
the data ranks.  The ranks of one sequence group share d and read the
same rows.  A sample's host draws are keyed by its index in the unsharded
split, so the data ranks' views are independent; the native path mixes
the data index into its stream seed as the JAX image_folder path does
(``+ 7_919 * d``, nothing at d = 0).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from byol_tpu_torch.core import rng as rng_lib
from byol_tpu_torch.core.config import Config
from byol_tpu_torch.data import readers
from byol_tpu_torch.parallel import mesh

Batch = Dict[str, np.ndarray]
MakeIter = Callable[[int], Iterator[Batch]]


@dataclasses.dataclass
class LoaderBundle:
    make_train_iter: MakeIter                 # epoch -> batches
    make_test_iter: MakeIter
    input_shape: Tuple[int, int, int]
    num_train_samples: int
    num_test_samples: int
    output_size: int
    epoch: int = 0
    # the train split under the eval transform (resize only, in order)
    make_train_eval_iter: Optional[MakeIter] = None
    # the validation split, under the eval transform; None without one
    make_valid_iter: Optional[MakeIter] = None
    num_valid_samples: int = 0
    # the test split was sharded over the ranks at build time (shard_eval
    # with world > 1): eval and linear-eval extraction then need no dealing
    eval_sharded: bool = False

    def set_all_epochs(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def train_loader(self) -> Iterator[Batch]:
        return self.make_train_iter(self.epoch)

    @property
    def test_loader(self) -> Iterator[Batch]:
        return self.make_test_iter(self.epoch)

    @property
    def train_eval_loader(self) -> Iterator[Batch]:
        if self.make_train_eval_iter is None:
            raise ValueError("this LoaderBundle provides no train-eval "
                             "(resize-only train split) iterator")
        return self.make_train_eval_iter(self.epoch)

    @property
    def valid_loader(self) -> Iterator[Batch]:
        if self.make_valid_iter is None:
            raise ValueError(
                "this LoaderBundle has no validation split: set "
                "--valid-fraction > 0 (or provide a valid/ root for "
                "image_folder)")
        return self.make_valid_iter(self.epoch)


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


def carve_valid_split(n: int, fraction: float, seed: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (valid_indices, train_indices): the head of a seeded permutation
    is held out.  The JAX package's split, shared by the array and
    image_folder paths."""
    if not 0.0 <= fraction < 1.0:
        raise ValueError(f"valid_fraction must be in [0, 1), got {fraction}")
    n_valid = int(n * fraction)
    perm = np.random.RandomState(seed ^ 0x5eed).permutation(n)
    return perm[:n_valid], perm[n_valid:]


def shard_arrays(x: np.ndarray, y: np.ndarray, index: int, count: int):
    """Rank ``index``'s contiguous shard of ``count`` (JAX's
    ``_shard_arrays``, the DistributedSampler analog): the tail past
    ``count * (n // count)`` is dropped."""
    if count == 1:
        return x, y
    per = len(x) // count
    lo = index * per
    return x[lo:lo + per], y[lo:lo + per]


def epoch_batches(n: int, batch_size: int, seed: int, epoch: int,
                  train: bool) -> List[np.ndarray]:
    """The index batches of one epoch: train reshuffled from
    ``RandomState(seed + epoch)`` with the remainder dropped, eval in
    order with it kept."""
    idx = np.arange(n)
    if train:
        np.random.RandomState(seed + epoch).shuffle(idx)
    end = n - n % batch_size if train else n
    return [idx[lo:lo + batch_size] for lo in range(0, end, batch_size)]


# ---- the torch host path (data_backend='tf') ------------------------------

class ArraySource:
    """Images of an in-memory (N, H, W, C) uint8 array."""

    def __init__(self, images: np.ndarray):
        self.images = images

    def __getitem__(self, i: int) -> np.ndarray:
        return self.images[i]


class HostBatches(torch.utils.data.Dataset):
    """A map-style dataset whose items are whole batches: item ``(epoch,
    indices)`` -> the views of those images (two augmented views in train,
    ``test_resize`` in both slots in eval) and their labels, as CPU
    tensors.  Picklable, so DataLoader workers may be spawned."""

    def __init__(self, source, labels: np.ndarray, *, size: int,
                 train: bool, seed: int, strength: float, spec: str,
                 draw_index: Optional[np.ndarray] = None):
        self.source, self.labels = source, labels
        self.size, self.train, self.seed = size, train, seed
        self.strength, self.spec = strength, spec
        # each item's index in the unsharded split, which keys its draws
        self.draw_index = draw_index

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, item) -> Dict[str, torch.Tensor]:
        from byol_tpu_torch.data import augment
        epoch, take = item
        images = [self.source[int(i)] for i in take]
        if self.train:
            keys = (take if self.draw_index is None
                    else self.draw_index[np.asarray(take)])
            v1, v2 = (torch.from_numpy(v) for v in augment.two_views(
                images, keys, self.size, seed=self.seed, epoch=epoch,
                strength=self.strength, spec=self.spec))
        else:
            v1 = v2 = torch.stack([augment.test_resize(im, self.size)
                                   for im in images])
        return {"view1": v1, "view2": v2,
                "label": torch.from_numpy(self.labels[take])}


def _as_is(batch):
    return batch


class EpochOrder(torch.utils.data.Sampler):
    """The DataLoader's sampler: the ``(epoch, indices)`` items of
    :func:`epoch_batches` for the epoch last set."""

    def __init__(self, n: int, batch_size: int, seed: int, train: bool):
        self.n, self.batch_size, self.seed, self.train = (n, batch_size,
                                                          seed, train)
        self.epoch = 0

    def _batches(self):
        return epoch_batches(self.n, self.batch_size, self.seed, self.epoch,
                             self.train)

    def __iter__(self):
        return iter([(self.epoch, take) for take in self._batches()])

    def __len__(self) -> int:
        return len(self._batches())


def host_pipeline(source, labels: np.ndarray, *, batch_size: int,
                  image_size: int, train: bool, seed: int, strength: float,
                  spec: str, workers: int, pin_memory: bool,
                  draw_index: Optional[np.ndarray] = None) -> MakeIter:
    """Batches of :class:`HostBatches` through a DataLoader, one item per
    batch, in :func:`epoch_batches`'s order, as numpy arrays (over pinned
    memory when ``pin_memory``).  ``workers`` worker processes are
    spawned, never forked (fork is unsafe in a process with threads),
    at the first epoch, and kept for the next ones."""
    labels = np.asarray(labels, np.int32)
    order = EpochOrder(len(labels), batch_size, seed, train)
    loader = torch.utils.data.DataLoader(
        HostBatches(source, labels, size=image_size, train=train, seed=seed,
                    strength=strength, spec=spec, draw_index=draw_index),
        batch_size=None, sampler=order, collate_fn=_as_is,
        num_workers=workers, pin_memory=pin_memory,
        multiprocessing_context="spawn" if workers else None,
        persistent_workers=workers > 0)

    def make(epoch: int) -> Iterator[Batch]:
        order.epoch = epoch
        for batch in loader:
            yield {k: v.numpy() for k, v in batch.items()}

    return make


# ---- the native, device and raw paths --------------------------------------

def _native_pipeline(images: np.ndarray, labels: np.ndarray, *,
                     batch_size: int, image_size: int, train: bool,
                     seed: int, strength: float, num_threads: int,
                     rank: int = 0) -> MakeIter:
    """The C++ host pipeline: two views per image in train (the epoch
    folded into the stream seed, ``index_base`` the batch's offset in the
    epoch, as the JAX package passes them; ``+ 7_919 * rank`` apart per
    rank), resize only in eval."""
    from byol_tpu_torch.data import native_aug
    labels = labels.astype(np.int32)

    def make(epoch: int) -> Iterator[Batch]:
        for i, take in enumerate(epoch_batches(len(labels), batch_size, seed,
                                               epoch, train)):
            imgs = images[take]
            if train:
                v1, v2 = native_aug.augment_two_views(
                    imgs, image_size, color_jitter_strength=strength,
                    seed=seed + 1_000_003 * epoch + 7_919 * rank,
                    index_base=i * batch_size, num_threads=num_threads)
            else:
                v1 = v2 = native_aug.resize_batch(imgs, image_size,
                                                  num_threads=num_threads)
            yield {"view1": v1, "view2": v2, "label": labels[take]}

    return make


def _device_pipeline(images: np.ndarray, labels: np.ndarray, *,
                     batch_size: int, image_size: int, seed: int,
                     strength: float, device, rank: int = 0) -> MakeIter:
    """Train views made on ``device`` by the unfused chain from raw uint8
    batches; batch ``i`` of ``epoch`` draws from the generator of
    (seed, epoch, i), and of the rank past rank 0."""
    from byol_tpu_torch.data import device_augment as da
    labels = labels.astype(np.int32)
    device = torch.device(device)
    h, w = images.shape[1:3]

    def make(epoch: int) -> Iterator[Batch]:
        for i, take in enumerate(epoch_batches(len(labels), batch_size, seed,
                                               epoch, True)):
            gen = torch.Generator().manual_seed(rng_lib.stream_seed(
                seed, f"device_augment/{epoch}/{i}"
                + (f"/rank{rank}" if rank else "")))
            views = tuple(da.view_params(gen, len(take), h, w, strength)
                          for _ in range(2))
            raw = torch.from_numpy(images[take])
            if device.type == "cuda":
                raw = raw.pin_memory().to(device, non_blocking=True)
            v1, v2 = da.two_view(raw, image_size,
                                 da.to_device(views, device),
                                 strength=strength)
            yield {"view1": v1, "view2": v2, "label": labels[take]}

    return make


def _raw_pipeline(images: np.ndarray, labels: np.ndarray, *,
                  batch_size: int, seed: int) -> MakeIter:
    """Step-placement train pipeline: raw uint8 batches reshuffled per
    epoch from (seed, epoch), remainder dropped; no host augmentation."""
    labels = labels.astype(np.int32)
    if images.dtype != np.uint8:
        raise ValueError(
            f"augment_placement='step' ships raw uint8 pixels; this dataset "
            f"holds {images.dtype} arrays")

    def make(epoch: int) -> Iterator[Batch]:
        for take in epoch_batches(len(labels), batch_size, seed, epoch,
                                  True):
            yield {"images": images[take], "label": labels[take]}
    return make


# ---- get_loader ------------------------------------------------------------

def resolve_backend(cfg: Config, task: str) -> str:
    """The backend and placement checks of the JAX loader, before any data
    is read: the native backend moves to the torch host path (one printed
    line) where the JAX package moves to tf.data."""
    backend = cfg.task.data_backend
    if backend not in ("tf", "native", "device"):
        raise ValueError(f"unknown data_backend {backend!r} "
                         f"('tf'|'native'|'device')")
    if backend == "native":
        from byol_tpu_torch.data import native_aug
        if not native_aug.available():
            print("byol_tpu_torch: native data backend unavailable (no g++ "
                  "or the library does not load); falling back to the torch "
                  "host path (data_backend='tf')", flush=True)
            backend = "tf"
        elif task == "image_folder" and not native_aug.has_jpeg():
            print("byol_tpu_torch: native backend built without libjpeg; "
                  "image_folder falls back to PIL decode and the torch host "
                  "path (data_backend='tf')", flush=True)
            backend = "tf"
    if cfg.regularizer.aug_spec != "reference" and backend != "tf":
        raise ValueError(
            f"aug_spec={cfg.regularizer.aug_spec!r} is implemented on the "
            f"tf data backend only (got data_backend={backend!r})")
    placement = cfg.task.augment_placement
    if placement not in ("loader", "step"):
        raise ValueError(f"unknown augment_placement {placement!r} "
                         f"('loader'|'step')")
    if placement == "step":
        if task == "image_folder":
            raise ValueError(
                "augment_placement='step' does not serve image_folder: "
                "decode is host-side and yields variable-size images; use "
                "the loader placement")
        if cfg.regularizer.aug_spec != "reference":
            raise ValueError(
                f"augment_placement='step' runs the canonical 'reference' "
                f"augmentation spec on device (got "
                f"aug_spec={cfg.regularizer.aug_spec!r})")
        if backend == "device":
            raise ValueError(
                "data_backend='device' (loader-dispatched on-chip augment) "
                "and augment_placement='step' (step-fused augment) are "
                "mutually exclusive; pick one")
    if task == "image_folder" and backend == "device":
        raise ValueError(
            "data_backend='device' does not serve image_folder (decode "
            "is inherently host-side); use 'tf' or 'native'")
    return backend


def describe(backend: str, placement: str, workers: int) -> str:
    """The loader's one line on how the train views are made."""
    if placement == "step":
        return ("loader: raw uint8 train batches; the train step makes both "
                "views on the device (augment_placement='step')")
    return {
        "tf": f"loader: data_backend='tf' runs the torch host path "
              f"(DataLoader, {workers} workers): two augmented views per "
              f"image",
        "native": f"loader: data_backend='native' runs the C++ host "
                  f"pipeline ({max(workers, 1)} threads): two augmented "
                  f"views per image",
        "device": "loader: data_backend='device' draws on the host and "
                  "makes the two views on the device (the unfused chain)",
    }[backend]


def get_loader(cfg: Config, *, num_fake_samples: int = 512,
               num_synth_samples: Optional[int] = None,
               device="cpu", process: Optional[Tuple[int, int]] = None
               ) -> LoaderBundle:
    """Dispatch on ``cfg.task.task``; see the module docstring.

    ``device``: where the trainer runs (the ``device`` backend makes its
    views there; the host path pins its batches for a card).
    ``process``: ``(d, D)`` of the data axis, default the laid-out
    mesh's (``(0, 1)`` without a process group)."""
    task = cfg.task.task
    if task in ("multi_augment_image_folder",
                "dali_multi_augment_image_folder"):
        task = "image_folder"
    if cfg.task.download:
        raise ValueError(
            "--download is refused: byol_tpu_torch reads local files only; "
            f"place the dataset under --data-dir ({cfg.task.data_dir})")
    index, count = process if process is not None else mesh.process_info()
    if cfg.task.batch_size % count:
        raise ValueError(f"global batch {cfg.task.batch_size} not divisible "
                         f"by the data axis {count}")
    batch = cfg.task.batch_size // count
    shard_eval = cfg.device.shard_eval and count > 1
    backend = resolve_backend(cfg, task)
    placement = cfg.task.augment_placement
    workers = cfg.device.workers_per_replica
    seed = cfg.device.seed
    cj = cfg.regularizer.color_jitter_strength
    spec = cfg.regularizer.aug_spec
    pin = torch.device(device).type == "cuda"
    if index == 0:
        print(describe(backend, placement, workers), flush=True)
    if task == "image_folder":
        from byol_tpu_torch.data.imagefolder import image_folder_loader
        return image_folder_loader(cfg, backend=backend, device=device,
                                   process=(index, count))

    if num_synth_samples is None:
        num_synth_samples = cfg.task.num_synth_samples or 20_000
    if task == "fake":
        size = cfg.task.image_size_override or 32
        x_tr, y_tr = readers.load_fake(num_fake_samples, size, seed=seed)
        x_te, y_te = readers.load_fake(max(num_fake_samples // 4, batch),
                                       size, seed=seed + 1)
        n_classes = 10
    elif task == "synth":
        size = cfg.task.image_size_override or 32
        x_tr, y_tr = readers.load_synth(num_synth_samples, size, seed=seed,
                                        train=True)
        x_te, y_te = readers.load_synth(max(num_synth_samples // 10, batch),
                                        size, seed=seed, train=False)
        n_classes = 10
    elif task in readers.ARRAY_LOADERS:
        fn, n_classes = readers.ARRAY_LOADERS[task]
        x_tr, y_tr = fn(cfg.task.data_dir, train=True)
        x_te, y_te = fn(cfg.task.data_dir, train=False)
        size = cfg.task.image_size_override or x_tr.shape[1]
    else:
        raise ValueError(f"unknown task {task!r}")

    x_va = y_va = None
    n_valid = 0
    if cfg.task.valid_fraction > 0:
        va_idx, tr_idx = carve_valid_split(len(x_tr),
                                           cfg.task.valid_fraction, seed)
        n_valid = len(va_idx)
        x_va, y_va = x_tr[va_idx], y_tr[va_idx]
        x_tr, y_tr = x_tr[tr_idx], y_tr[tr_idx]

    n_train, n_test = len(x_tr), len(x_te)
    # the rank's shards; the valid split was carved above, the same on
    # every rank
    per = n_train // count
    draw_index = np.arange(index * per, (index + 1) * per)
    x_tr, y_tr = shard_arrays(x_tr, y_tr, index, count)
    if n_valid:
        x_va, y_va = shard_arrays(x_va, y_va, index, count)
    if shard_eval:
        x_te, y_te = shard_arrays(x_te, y_te, index, count)

    def host(images, labels, train):
        # the eval transform of an in-memory image is one resize: cheaper
        # in this process than a worker's start-up and a batch's transfer
        return host_pipeline(
            ArraySource(images), labels, batch_size=batch, image_size=size,
            train=train, seed=seed, strength=cj, spec=spec,
            workers=workers if train else 0, pin_memory=pin,
            draw_index=draw_index if train and count > 1 else None)

    def native(images, labels, train):
        return _native_pipeline(images, labels, batch_size=batch,
                                image_size=size, train=train, seed=seed,
                                strength=cj, num_threads=max(workers, 1),
                                rank=index)

    evaluate = native if backend == "native" else host
    if placement == "step":
        make_train = _raw_pipeline(x_tr, y_tr, batch_size=batch, seed=seed)
    elif backend == "device":
        make_train = _device_pipeline(x_tr, y_tr, batch_size=batch,
                                      image_size=size, seed=seed,
                                      strength=cj, device=device, rank=index)
    else:
        make_train = evaluate(x_tr, y_tr, True)
    return LoaderBundle(
        make_train_iter=make_train,
        make_test_iter=evaluate(x_te, y_te, False),
        make_train_eval_iter=evaluate(x_tr, y_tr, False),
        make_valid_iter=evaluate(x_va, y_va, False) if n_valid else None,
        input_shape=(size, size, 3),
        num_train_samples=n_train,
        num_test_samples=n_test,
        num_valid_samples=n_valid,
        output_size=n_classes,
        eval_sharded=shard_eval)

