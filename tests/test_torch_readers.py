"""The port's array readers (byol_tpu_torch/data/readers.py) against the
JAX package's (byol_tpu/data/readers.py) on tiny files written in each
format under ``tmp_path``: CIFAR-10 batches as a directory and as the
tarball, CIFAR-100, MNIST idx and Fashion-MNIST idx.gz.  The arrays must
be bitwise equal, and ``download=True`` refused with the path where the
archive belongs."""
import gzip
import os
import pickle
import sys
import tarfile

import numpy as np
import pytest

from byol_tpu.data import readers as jax_readers
from byol_tpu_torch.data import readers

RNG = np.random.RandomState(0)


def _pickle(path, payload):
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _cifar10_dir(root, n=4):
    os.makedirs(root)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        _pickle(os.path.join(root, name), {
            b"data": RNG.randint(0, 256, (n, 3072), dtype=np.uint8),
            b"labels": RNG.randint(0, 10, n).tolist()})


def _idx(array, magic):
    head = bytes([0, 0, magic, array.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in array.shape)
    return head + array.astype(np.uint8).tobytes()


def _mnist_files(root, gz):
    os.makedirs(root)
    for prefix, n in (("train", 6), ("t10k", 3)):
        files = {f"{prefix}-images-idx3-ubyte":
                 _idx(RNG.randint(0, 256, (n, 28, 28)), 3),
                 f"{prefix}-labels-idx1-ubyte":
                 _idx(RNG.randint(0, 10, (n,)), 1)}
        for name, data in files.items():
            if gz:
                with gzip.open(os.path.join(root, name + ".gz"), "wb") as f:
                    f.write(data)
            else:
                with open(os.path.join(root, name), "wb") as f:
                    f.write(data)


def _same(ours, theirs):
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _both(task, data_dir, train):
    fn, classes = readers.ARRAY_LOADERS[task]
    jfn, jclasses = jax_readers.ARRAY_LOADERS[task]
    assert classes == jclasses
    return fn(str(data_dir), train=train), jfn(str(data_dir), train=train)


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_directory(tmp_path, train):
    _cifar10_dir(tmp_path / "cifar-10-batches-py")
    ours, theirs = _both("cifar10", tmp_path, train)
    _same(ours, theirs)
    assert ours[0].shape == ((20 if train else 4), 32, 32, 3)


def test_cifar10_tarball(tmp_path):
    src = tmp_path / "src"
    _cifar10_dir(src / "cifar-10-batches-py")
    for side in ("ours", "theirs"):
        os.makedirs(tmp_path / side)
        with tarfile.open(tmp_path / side / "cifar-10-python.tar.gz",
                          "w:gz") as tar:
            tar.add(src / "cifar-10-batches-py", "cifar-10-batches-py")
    ours = readers.load_cifar10(str(tmp_path / "ours"), train=True)
    theirs = jax_readers.load_cifar10(str(tmp_path / "theirs"), train=True)
    _same(ours, theirs)
    assert (tmp_path / "ours" / "cifar-10-batches-py").is_dir()


@pytest.mark.parametrize("train", [True, False])
def test_cifar100(tmp_path, train):
    root = tmp_path / "cifar-100-python"
    os.makedirs(root)
    for name, n in (("train", 5), ("test", 3)):
        _pickle(root / name, {
            b"data": RNG.randint(0, 256, (n, 3072), dtype=np.uint8),
            b"fine_labels": RNG.randint(0, 100, n).tolist(),
            b"coarse_labels": RNG.randint(0, 20, n).tolist()})
    _same(*_both("cifar100", tmp_path, train))


@pytest.mark.parametrize("task,gz", [("mnist", False),
                                     ("fashion_mnist", True)])
@pytest.mark.parametrize("train", [True, False])
def test_mnist_like(tmp_path, task, gz, train):
    _mnist_files(tmp_path / task, gz)
    ours, theirs = _both(task, tmp_path, train)
    _same(ours, theirs)
    assert ours[0].shape[1:] == (28, 28, 3)


def test_digits(monkeypatch):
    pytest.importorskip("sklearn")
    for train in (True, False):
        _same(readers.load_digits_img(train=train),
              jax_readers.load_digits_img(train=train))
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    for fn in (readers.load_digits_img, jax_readers.load_digits_img):
        with pytest.raises(RuntimeError, match="scikit-learn"):
            fn()


@pytest.mark.parametrize("task", ["cifar10", "cifar100", "mnist",
                                  "fashion_mnist"])
def test_download_is_refused_with_the_place(tmp_path, task):
    fn, _ = readers.ARRAY_LOADERS[task]
    with pytest.raises(RuntimeError, match="place the archive at "
                       + str(tmp_path)):
        fn(str(tmp_path), train=True, download=True)
    assert not os.listdir(tmp_path)


def test_missing_files_name_the_path(tmp_path):
    with pytest.raises(FileNotFoundError, match="cifar-10-python.tar.gz"):
        readers.load_cifar10(str(tmp_path), train=True)
    with pytest.raises(FileNotFoundError, match="train-images-idx3-ubyte"):
        readers.load_mnist(str(tmp_path), train=True)


def test_fake_and_synth_match_jax():
    _same(readers.load_fake(6, 8, seed=3), jax_readers.load_fake(6, 8,
                                                                 seed=3))
    for train in (True, False):
        _same(readers.load_synth(5, 12, seed=2, train=train),
              jax_readers.load_synth(5, 12, seed=2, train=train))
