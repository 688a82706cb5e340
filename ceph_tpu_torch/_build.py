"""Build and load the package's CUDA kernels.

At first use the sources under ``csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``build/`` beside the package (keyed by a hash of the sources and the
flags, so an edited source builds anew), and loaded with ``ctypes``.
A missing ``nvcc`` or a failed build raises: there is no other route to
the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "ec_kernels.cu",)
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build ceph_tpu_torch's kernels")


def _key() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile the sources if this hash has no library yet; returns
    (library path, the compiler's register/shared-memory report)."""
    lib = BUILD_DIR / ("libceph_ec_%s.so" % _key())
    if lib.exists():
        return lib, ""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(".so.%d.tmp" % os.getpid())
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed (%d):\n%s\n%s"
                           % (proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry's signature set."""
    with _lock:
        path, _report = build()
        lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ec_fused_xor.argtypes = [p, p, p, i, i, ll, i, p]
    lib.ec_bitplane_matmul.argtypes = [p, p, p, i, i, i, ll, p]
    lib.ec_xor_schedule.argtypes = [p, p, p, i, i, ll, i, p]
    for fn in (lib.ec_fused_xor, lib.ec_bitplane_matmul,
               lib.ec_xor_schedule):
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        raise RuntimeError("%s: CUDA launch failed with cudaError %d"
                           % (name, err))
