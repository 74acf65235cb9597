"""ctypes binding of the native C++ host augmentation (counterpart of
byol_tpu/data/native_aug.py): the port's ``data_backend='native'``.

``data/native/image_pipeline.cpp`` is a copy of the JAX package's source,
equal in every line of code (one comment no longer names a checkout
path): a multithreaded C++ pipeline that makes two augmented
float32 views of each uint8 image (and, built against libjpeg, decodes
only the crop window of a JPEG).  Each (seed, sample index, view) has its
own splitmix64 stream, so on the same images, seed and ``index_base`` the
port's views equal the JAX package's bit for bit.

- g++ builds the library at first use, never at import, into
  ``byol_tpu_torch/data/native/_build/`` (listed in .gitignore), under a
  name keyed by a hash of the source and the build flags; a file lock
  serialises concurrent builds.  The JPEG build (``-DBYOL_WITH_JPEG
  -ljpeg``) is tried first and the array-only build when it fails to
  build or to load, as the JAX package does.
- :func:`available` says whether a library could be built and loaded;
  the loader moves to the torch host path with one printed line when it
  cannot, where the JAX package moves to tf.data.
- Files the JPEG decoder rejects are decoded by PIL, when PIL imports,
  and augmented through the array path on the same streams.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import io
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "image_pipeline.cpp"
BUILD_DIR = SRC.parent / "_build"
BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
VARIANTS = (("jpeg", ("-DBYOL_WITH_JPEG",), ("-ljpeg",)),
            ("arrays", (), ()))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
u8p = ctypes.POINTER(ctypes.c_uint8)
f32p = ctypes.POINTER(ctypes.c_float)
u64p = ctypes.POINTER(ctypes.c_uint64)
i32p = ctypes.POINTER(ctypes.c_int32)


def library_path(variant: str) -> Path:
    flags = next(f + l for name, f, l in VARIANTS if name == variant)
    digest = hashlib.sha256(" ".join(BASE_FLAGS + flags).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libbyol_aug_{variant}_{digest.hexdigest()[:16]}.so"


def _build(variant: str) -> Path:
    """Compile one variant unless a build of this source exists."""
    out = library_path(variant)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if out.exists():            # another process built it meanwhile
            return out
        _, defines, libs = next(v for v in VARIANTS if v[0] == variant)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
        cmd = ["g++", *BASE_FLAGS, *defines, "-o", str(tmp), str(SRC), *libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:        # no g++
            raise RuntimeError(f"native build: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build ({variant}) failed: "
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    lib.byol_augment_two_views.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p,
        ctypes.c_int, ctypes.c_float, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int]
    lib.byol_augment_two_views.restype = None
    lib.byol_resize_batch.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_int]
    lib.byol_resize_batch.restype = None
    lib.byol_has_jpeg.argtypes = []
    lib.byol_has_jpeg.restype = ctypes.c_int
    if lib.byol_has_jpeg():
        lib.byol_jpeg_augment_two_views.argtypes = [
            u8p, u64p, u64p, ctypes.c_int, f32p, f32p, ctypes.c_int,
            ctypes.c_float, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
            i32p]
        lib.byol_jpeg_augment_two_views.restype = None
        lib.byol_jpeg_resize_batch.argtypes = [
            u8p, u64p, u64p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
            i32p]
        lib.byol_jpeg_resize_batch.restype = None


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises when neither
    variant builds and loads (the reason is kept for later calls)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        errors = []
        for variant, _, _ in VARIANTS:
            try:
                lib = ctypes.CDLL(str(_build(variant)))
            except (RuntimeError, OSError) as e:
                errors.append(f"{variant}: {e}")
                continue
            _declare(lib)
            _lib = lib
            return lib
        _error = "; ".join(errors)
        raise RuntimeError(_error)


def available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


def has_jpeg() -> bool:
    """True when the loaded library decodes JPEGs (the libjpeg build)."""
    return available() and bool(load().byol_has_jpeg())


def _threads(num_threads: Optional[int]) -> int:
    return num_threads or min(os.cpu_count() or 1, 16)


def _check_batch(images: np.ndarray) -> np.ndarray:
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) uint8, got {images.shape}")
    return np.ascontiguousarray(images, dtype=np.uint8)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def augment_two_views(images: np.ndarray, size: int, *,
                      color_jitter_strength: float = 1.0, seed: int = 0,
                      index_base: int = 0,
                      num_threads: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, H, W, 3) uint8 -> two (N, size, size, 3) float32 views in
    [0, 1]; image i draws from the streams of ``index_base + i``."""
    lib = load()
    images = _check_batch(images)
    n, h, w, _ = images.shape
    v1 = np.empty((n, size, size, 3), np.float32)
    v2 = np.empty((n, size, size, 3), np.float32)
    lib.byol_augment_two_views(
        _ptr(images, u8p), n, h, w, _ptr(v1, f32p), _ptr(v2, f32p), size,
        float(color_jitter_strength), seed & (2**64 - 1),
        index_base & (2**64 - 1), _threads(num_threads))
    return v1, v2


def resize_batch(images: np.ndarray, size: int, *,
                 num_threads: Optional[int] = None) -> np.ndarray:
    """The eval transform: (N, H, W, 3) uint8 -> (N, size, size, 3)
    float32, resize only."""
    lib = load()
    images = _check_batch(images)
    n, h, w, _ = images.shape
    out = np.empty((n, size, size, 3), np.float32)
    lib.byol_resize_batch(_ptr(images, u8p), n, h, w, _ptr(out, f32p), size,
                          _threads(num_threads))
    return out


def _pack_blobs(blobs) -> tuple:
    sizes = np.array([len(b) for b in blobs], np.uint64)
    offsets = np.zeros(len(blobs), np.uint64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    return np.frombuffer(b"".join(blobs), np.uint8), offsets, sizes


def _decode_fallback(data: bytes) -> Optional[np.ndarray]:
    """PIL decode of a file the C++ decoder flagged (not a JPEG, CMYK,
    ...); None when PIL is missing or cannot read it either."""
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except (OSError, ValueError):
        return None


def _jpeg_lib() -> ctypes.CDLL:
    lib = load()
    if not lib.byol_has_jpeg():
        raise RuntimeError("the native library was built without libjpeg")
    return lib


def jpeg_augment_two_views(blobs, size: int, *,
                           color_jitter_strength: float = 1.0, seed: int = 0,
                           index_base: int = 0,
                           num_threads: Optional[int] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """A list of encoded images -> two (N, size, size, 3) float32 views:
    decode of the crop window and augmentation in C++; a file the decoder
    rejects goes through PIL and the array path on the same streams (an
    undecodable one stays zero)."""
    lib = _jpeg_lib()
    n = len(blobs)
    blob, offsets, sizes = _pack_blobs(blobs)
    v1 = np.empty((n, size, size, 3), np.float32)
    v2 = np.empty((n, size, size, 3), np.float32)
    ok = np.empty((n,), np.int32)
    lib.byol_jpeg_augment_two_views(
        _ptr(blob, u8p), _ptr(offsets, u64p), _ptr(sizes, u64p), n,
        _ptr(v1, f32p), _ptr(v2, f32p), size, float(color_jitter_strength),
        seed & (2**64 - 1), index_base & (2**64 - 1), _threads(num_threads),
        _ptr(ok, i32p))
    for i in np.nonzero(ok == 0)[0]:
        img = _decode_fallback(blobs[i])
        if img is None:
            continue
        a, b = augment_two_views(img[None], size,
                                 color_jitter_strength=color_jitter_strength,
                                 seed=seed, index_base=index_base + int(i),
                                 num_threads=1)
        v1[i], v2[i] = a[0], b[0]
    return v1, v2


def jpeg_resize_batch(blobs, size: int, *,
                      num_threads: Optional[int] = None) -> np.ndarray:
    """A list of encoded images -> (N, size, size, 3) float32, resize
    only (the eval transform)."""
    lib = _jpeg_lib()
    n = len(blobs)
    blob, offsets, sizes = _pack_blobs(blobs)
    out = np.empty((n, size, size, 3), np.float32)
    ok = np.empty((n,), np.int32)
    lib.byol_jpeg_resize_batch(
        _ptr(blob, u8p), _ptr(offsets, u64p), _ptr(sizes, u64p), n,
        _ptr(out, f32p), size, _threads(num_threads), _ptr(ok, i32p))
    for i in np.nonzero(ok == 0)[0]:
        img = _decode_fallback(blobs[i])
        if img is not None:
            out[i] = resize_batch(img[None], size, num_threads=1)[0]
    return out
