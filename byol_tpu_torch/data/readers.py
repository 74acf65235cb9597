"""Array dataset readers (a copy of byol_tpu/data/readers.py, which is numpy
only): CIFAR-10/100, MNIST, Fashion-MNIST, the UCI digits, and the
synthetic ``fake`` and ``synth`` sets.  Images are uint8 NHWC, labels
int64.

The readers take the standard on-disk formats under ``data_dir`` and
nothing else: ``download=True`` is refused with the path where the archive
belongs (the JAX package fetches it; the port never opens a network
connection).
"""
from __future__ import annotations

import gzip
import os
import pickle
import tarfile
from typing import Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]


def _refuse_download(dest: str) -> None:
    raise RuntimeError(
        f"download is refused: byol_tpu_torch reads local files only; place "
        f"the archive at {dest}")


def _extract_cifar(data_dir: str, root: str, archive: str,
                   download: bool) -> None:
    tgz = os.path.join(data_dir, archive)
    if download:
        _refuse_download(tgz)
    if os.path.isdir(root):
        return
    if not os.path.exists(tgz):
        raise FileNotFoundError(f"{root} not found; place {archive} at {tgz}")
    with tarfile.open(tgz) as tar:
        tar.extractall(data_dir)  # noqa: S202


def load_cifar10(data_dir: str, train: bool, download: bool = False) -> Arrays:
    root = os.path.join(data_dir, "cifar-10-batches-py")
    _extract_cifar(data_dir, root, "cifar-10-python.tar.gz", download)
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    imgs, labels = [], []
    for n in names:
        with open(os.path.join(root, n), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"])
        labels.extend(d[b"labels"])
    x = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(labels, np.int64)


def load_cifar100(data_dir: str, train: bool,
                  download: bool = False) -> Arrays:
    root = os.path.join(data_dir, "cifar-100-python")
    _extract_cifar(data_dir, root, "cifar-100-python.tar.gz", download)
    with open(os.path.join(root, "train" if train else "test"), "rb") as f:
        d = pickle.load(f, encoding="bytes")
    x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(d[b"fine_labels"], np.int64)


def _load_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    ndim = data[3]
    dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _load_mnist_like(name: str, data_dir: str, train: bool,
                     download: bool) -> Arrays:
    root = os.path.join(data_dir, name)
    prefix = "train" if train else "t10k"
    if download:
        _refuse_download(os.path.join(root, f"{prefix}-*-idx*-ubyte.gz"))
    paths = []
    for f in (f"{prefix}-images-idx3-ubyte", f"{prefix}-labels-idx1-ubyte"):
        cands = [p for p in (os.path.join(root, f),
                             os.path.join(root, f + ".gz"))
                 if os.path.exists(p)]
        if not cands:
            raise FileNotFoundError(f"{os.path.join(root, f)}[.gz] not found")
        paths.append(cands[0])
    images = _load_idx(paths[0])[..., np.newaxis]          # N,28,28,1
    images = np.tile(images, (1, 1, 1, 3))                 # grayscale -> RGB
    return images, _load_idx(paths[1]).astype(np.int64)


def load_mnist(data_dir: str, train: bool, download: bool = False) -> Arrays:
    return _load_mnist_like("mnist", data_dir, train, download)


def load_fashion_mnist(data_dir: str, train: bool,
                       download: bool = False) -> Arrays:
    return _load_mnist_like("fashion_mnist", data_dir, train, download)


def load_fake(num_samples: int = 512, image_size: int = 32,
              num_classes: int = 10, seed: int = 0) -> Arrays:
    """Deterministic noise images: nothing to learn, real shapes."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, size=(num_samples, image_size, image_size, 3),
                    dtype=np.uint8)
    y = rng.randint(0, num_classes, size=(num_samples,)).astype(np.int64)
    return x, y


def load_synth(num_samples: int = 10_000, image_size: int = 32,
               num_classes: int = 10, seed: int = 0, train: bool = True
               ) -> Arrays:
    """A learnable procedural dataset: each class is a fixed smooth color
    template (4x4 noise upsampled bilinearly), each sample the template
    times a brightness gain plus a bias and pixel noise.  Templates depend
    only on (num_classes, image_size), so train and test share classes
    but not samples."""
    tmpl_rng = np.random.RandomState(123)           # class identity, fixed
    rng = np.random.RandomState(seed + (0 if train else 10_007))
    coarse = tmpl_rng.rand(num_classes, 4, 4, 3)
    xs = np.linspace(0, 3, image_size)
    i0 = np.clip(np.floor(xs).astype(int), 0, 2)
    frac = xs - i0

    def _up(t):                                     # bilinear 4x4 -> S x S
        t = (t[i0] * (1 - frac)[:, None, None]
             + t[i0 + 1] * frac[:, None, None])
        return (t[:, i0] * (1 - frac)[None, :, None]
                + t[:, i0 + 1] * frac[None, :, None])

    templates = np.stack([0.2 + 0.6 * _up(c) for c in coarse])
    y = rng.randint(0, num_classes, size=(num_samples,))
    gain = rng.uniform(0.6, 1.0, size=(num_samples, 1, 1, 1))
    bias = rng.uniform(-0.1, 0.1, size=(num_samples, 1, 1, 1))
    noise = rng.normal(0.0, 0.06, size=(num_samples, image_size,
                                        image_size, 3))
    x = np.clip(templates[y] * gain + bias + noise, 0.0, 1.0)
    return (x * 255).astype(np.uint8), y.astype(np.int64)


def load_digits_img(data_dir: str = "", train: bool = True,
                    download: bool = False) -> Arrays:
    """The UCI handwritten digits bundled with scikit-learn: 1,797 8x8
    grayscale digits, nearest-upsampled to 32x32 RGB uint8, split by a
    fixed seeded permutation (1,500 train / 297 test).  ``data_dir`` and
    ``download`` keep the ARRAY_LOADERS signature and are not read."""
    del data_dir, download
    try:
        from sklearn.datasets import load_digits as _sk_load
    except ImportError as e:
        raise RuntimeError(
            "--task digits needs scikit-learn (bundles the UCI digits "
            "images); it is not installed") from e
    d = _sk_load()
    x = (d.images / 16.0 * 255.0).astype(np.uint8)      # (1797, 8, 8)
    x = x.repeat(4, axis=1).repeat(4, axis=2)           # 8x8 -> 32x32
    x = np.tile(x[..., np.newaxis], (1, 1, 1, 3))       # grayscale -> RGB
    y = d.target.astype(np.int64)
    perm = np.random.RandomState(42).permutation(len(x))
    idx = perm[:1500] if train else perm[1500:]
    return np.ascontiguousarray(x[idx]), y[idx]


ARRAY_LOADERS = {
    "cifar10": (load_cifar10, 10),
    "cifar100": (load_cifar100, 100),
    "mnist": (load_mnist, 10),
    "fashion_mnist": (load_fashion_mnist, 10),
    "digits": (load_digits_img, 10),
}
