"""Build and load the port's CUDA kernel library.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects
are linked into ONE shared library with a plain C interface, which
:mod:`ctypes` loads.  Nothing here includes PyTorch's headers, so a build
takes seconds.

- The build runs at first use (the first kernel launch on a CUDA tensor),
  never at import: the CPU tests import every module of the package.
- It writes into ``byol_tpu_torch/ops/_build/`` (listed in .gitignore),
  under a name keyed by a hash of the sources and the flags, so an edited
  source rebuilds and an unchanged one loads the cached library.
- A file lock serialises concurrent builds (several processes starting at
  once build once; the others wait and load).
- Every C entry point returns ``cudaGetLastError()`` after its launch;
  :func:`check` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the nvcc run of this process took (0.0 when the cached library
# was loaded); the path of its log holds what ptxas said of each kernel
build_seconds = 0.0
build_log: Optional[Path] = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from byol_tpu_torch/ops/"
        "csrc/ at first use and need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libbyol_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if out.exists():            # another process built it meanwhile
            return out
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs, cmds = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            objs.append(BUILD_DIR / f"{tag}.{src.stem}.o")
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(objs[-1]),
                         str(src)])
        tmp = out.with_name(f"{tag}.so.tmp")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                *(str(o) for o in objs)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        outs = [p.communicate() for p in procs]     # all run meanwhile
        runs = [(c, p.returncode, o, e)
                for c, p, (o, e) in zip(cmds, procs, outs)]
        if all(rc == 0 for _, rc, _, _ in runs):
            proc = subprocess.run(link, capture_output=True, text=True)
            runs.append((link, proc.returncode, proc.stdout, proc.stderr))
        build_seconds = time.perf_counter() - t0
        build_log = out.with_suffix(".log")
        build_log.write_text("".join(
            " ".join(c) + "\n" + o + e for c, _, o, e in runs))
        for o in objs:
            o.unlink(missing_ok=True)
        failed = [(c, rc, e) for c, rc, _, e in runs if rc != 0]
        if failed:
            c, rc, e = failed[0]
            raise RuntimeError(f"nvcc failed with code {rc} ({c[-1]}):\n"
                               f"{e[-6000:]}")
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.byol_cuda_error_string.argtypes = [ctypes.c_int]
            lib.byol_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def entry(name: str, argtypes):
    """The C entry point ``name`` of the library, its ``argtypes`` declared
    on first use: undeclared, ctypes would pass a pointer as a 32-bit int."""
    fn = getattr(library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().byol_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
