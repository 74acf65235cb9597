"""ctypes binding of the hand-written Zstandard decoder
(``checkpoint/csrc/zstd_decode.cc``, RFC 8878), with the CRC-32C the
OCDBT reader checks nodes with.

g++ (``-O2``, C++17) builds the library at first use, never at import,
into ``byol_tpu_torch/checkpoint/_build/`` (listed in .gitignore) under a
name keyed by a hash of the source and the flags; a file lock serialises
concurrent builds (tests run in several processes).  A failed build
raises with the compiler's output: there is no fallback decoder.

:func:`decompress` decodes every frame of its input (skippable frames are
skipped); given ``out``, a writable buffer such as a numpy array, it
decodes straight into it and returns the number of bytes written.
Corrupt or truncated input raises ``ValueError`` naming the input offset.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "zstd_decode.cc"
BUILD_DIR = SRC.parent.parent / "_build"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_ERR_CAP = 512

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None    # the compile's wall time, or 0.0
                                         # when a built library was found

Buffer = Union[bytes, bytearray, memoryview, np.ndarray]


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libbyol_zstd_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    global build_seconds
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if out.exists():            # another process built it meanwhile
            build_seconds = 0.0
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
        cmd = ["g++", *FLAGS, "-o", str(tmp), str(SRC)]
        start = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:        # no g++
            raise RuntimeError(f"zstd decoder build: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("zstd decoder build failed: "
                               f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        build_seconds = time.perf_counter() - start
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            c_size, u8p = ctypes.c_size_t, ctypes.c_void_p
            lib.byol_zstd_decompress.argtypes = [
                u8p, c_size, u8p, c_size, ctypes.POINTER(c_size),
                ctypes.c_char_p, c_size]
            lib.byol_zstd_decompress.restype = ctypes.c_int
            lib.byol_zstd_decompress_alloc.argtypes = [
                u8p, c_size, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(c_size), ctypes.c_char_p, c_size]
            lib.byol_zstd_decompress_alloc.restype = ctypes.c_int
            lib.byol_zstd_free.argtypes = [ctypes.c_void_p]
            lib.byol_zstd_free.restype = None
            lib.byol_zstd_content_size.argtypes = [u8p, c_size]
            lib.byol_zstd_content_size.restype = ctypes.c_int64
            lib.byol_crc32c.argtypes = [u8p, c_size, ctypes.c_uint32]
            lib.byol_crc32c.restype = ctypes.c_uint32
            _lib = lib
        return _lib


def _view(buf: Buffer, writable: bool = False) -> np.ndarray:
    """A uint8 numpy view of a contiguous buffer (no copy)."""
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
        else buf.reshape(-1).view(np.uint8)
    if not arr.flags.c_contiguous:
        raise ValueError("zstd: the buffer must be contiguous")
    if writable and not arr.flags.writeable:
        raise ValueError("zstd: the output buffer is read-only")
    return arr


def _addr(arr: np.ndarray) -> int:
    return arr.ctypes.data if arr.size else 0


def content_size(src: Buffer) -> Optional[int]:
    """The decoded size the frames of ``src`` declare; None when a frame
    does not declare it."""
    arr = _view(src)
    n = load().byol_zstd_content_size(_addr(arr), arr.size)
    if n == -2:
        decompress(src)             # raises, naming the offset
        raise ValueError("zstd: frame headers cannot be walked")
    return None if n < 0 else int(n)


def decompress(src: Buffer, out: Optional[Buffer] = None
               ) -> Union[bytes, int]:
    """Decode ``src`` (one or more frames).  Without ``out``: the decoded
    bytes.  With ``out`` (a writable contiguous buffer): decode into it
    and return the number of bytes written; a frame that does not fit
    raises.  Corrupt input raises ``ValueError``."""
    lib = load()
    arr = _view(src)
    err = ctypes.create_string_buffer(_ERR_CAP)
    written = ctypes.c_size_t(0)
    if out is not None:
        dst = _view(out, writable=True)
        rc = lib.byol_zstd_decompress(_addr(arr), arr.size, _addr(dst),
                                      dst.size, ctypes.byref(written), err,
                                      _ERR_CAP)
        if rc:
            raise ValueError(f"zstd: {err.value.decode()}")
        return written.value
    size = lib.byol_zstd_content_size(_addr(arr), arr.size)
    if size >= 0:
        dst = np.empty(size, np.uint8)
        if decompress(src, dst) != size:
            raise ValueError("zstd: decoded size differs from the frames' "
                             "content sizes")
        return dst.tobytes()
    ptr = ctypes.c_void_p()
    rc = lib.byol_zstd_decompress_alloc(_addr(arr), arr.size,
                                        ctypes.byref(ptr),
                                        ctypes.byref(written), err, _ERR_CAP)
    if rc:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(ptr.value, written.value) if written.value \
            else b""
    finally:
        lib.byol_zstd_free(ptr)


def crc32c(data: Buffer, crc: int = 0) -> int:
    arr = _view(data)
    return int(load().byol_crc32c(_addr(arr), arr.size, crc))
