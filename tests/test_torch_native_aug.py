"""The port's native C++ host pipeline (byol_tpu_torch/data/native_aug.py
over its copy of image_pipeline.cpp) against the JAX package's
(byol_tpu/data/native_aug.py) on the same inputs, seed and index_base:
bitwise equal views, at 1 and 4 threads; the fused JPEG path with its PIL
fallback when both libraries link libjpeg; and the port's build writes
under byol_tpu_torch/ only.

The JAX package builds its library in place with no lock
(byol_tpu/data/native_aug.py): on a fresh tree, parallel test workers
build it at once, and one can load another's half-written file ("file
too short"; reproduced with 6 processes).  That worker's JAX library is
then broken for good, and its loader moves to tf.data.  So every port test
that runs the JAX library loads a copy of its own
(:func:`private_jax_native`)."""
import contextlib
import io
import os
import re

import numpy as np
import pytest
from PIL import Image

from byol_tpu.data import native_aug as jax_native
from byol_tpu_torch.data import native_aug

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_PRIVATE_DIRS = []          # this process's build directory, made once


@contextlib.contextmanager
def private_jax_native(tmp_path_factory):
    """The JAX package's native library, built (once per test process)
    into a directory of this process and loaded from there until the
    block ends."""
    if not _PRIVATE_DIRS:
        _PRIVATE_DIRS.append(tmp_path_factory.mktemp("jax_native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", os.path.join(_PRIVATE_DIRS[0],
                                                    "libbyol_aug.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_error", None)
        yield


@pytest.fixture(scope="module", autouse=True)
def _private_jax_library(tmp_path_factory):
    with private_jax_native(tmp_path_factory):
        yield


def _images(n=5, h=40, w=48, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               dtype=np.uint8)


def _bitwise(ours, theirs):
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a, b)


def _code(path):
    """The source with its // comments removed."""
    with open(path) as f:
        return re.sub(r"//.*", "", f.read())


def test_the_source_is_a_copy():
    """Every line of code equals the JAX package's; only comments may
    differ (one no longer names a checkout path)."""
    ours = _code(native_aug.SRC)
    assert ours == _code(os.path.join(ROOT, "byol_tpu", "data", "native",
                                      "image_pipeline.cpp"))
    assert "extern \"C\"" in ours


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_two_views_and_resize_bitwise(threads, strength):
    imgs = _images()
    kw = dict(color_jitter_strength=strength, seed=1234 + 1_000_003,
              index_base=16, num_threads=threads)
    ours = native_aug.augment_two_views(imgs, 32, **kw)
    _bitwise(ours, jax_native.augment_two_views(imgs, 32, **kw))
    assert not np.array_equal(*ours)
    for size in (24, 64):
        _bitwise([native_aug.resize_batch(imgs, size, num_threads=threads)],
                 [jax_native.resize_batch(imgs, size, num_threads=threads)])


def _encoded(fmt, seed):
    buf = io.BytesIO()
    Image.fromarray(_images(1, 36, 44, seed)[0]).save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("threads", [1, 4])
def test_jpeg_pair_bitwise_with_the_pil_fallback(threads):
    if not (native_aug.has_jpeg() and jax_native.has_jpeg()):
        pytest.skip("a native library here was built without libjpeg")
    blobs = [_encoded("JPEG", 1), _encoded("PNG", 2), _encoded("JPEG", 3)]
    kw = dict(seed=77, index_base=5, num_threads=threads)
    ours = native_aug.jpeg_augment_two_views(blobs, 32, **kw)
    _bitwise(ours, jax_native.jpeg_augment_two_views(blobs, 32, **kw))
    assert all(v.max() > 0 for v in ours[0])      # the PNG went through PIL
    _bitwise([native_aug.jpeg_resize_batch(blobs, 24, num_threads=threads)],
             [jax_native.jpeg_resize_batch(blobs, 24, num_threads=threads)])


def _port_files_under(root):
    """Files the port's build names (its libraries and lock); the JAX
    package's own build writes ``libbyol_aug.so`` only."""
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.startswith(("libbyol_aug_jpeg_", "libbyol_aug_arrays_"))
            or f == "build.lock"]


def test_build_writes_under_the_port_only(tmp_path, monkeypatch):
    assert native_aug.BUILD_DIR.parent == native_aug.SRC.parent
    assert str(native_aug.BUILD_DIR).startswith(
        os.path.join(ROOT, "byol_tpu_torch") + os.sep)
    monkeypatch.setattr(native_aug, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_aug, "_lib", None)
    monkeypatch.setattr(native_aug, "_error", None)
    lib = native_aug.load()
    built = os.listdir(tmp_path / "_build")
    assert any(name.startswith("libbyol_aug_") for name in built), built
    assert lib._name.startswith(str(tmp_path))
    assert not _port_files_under(os.path.join(ROOT, "byol_tpu"))
