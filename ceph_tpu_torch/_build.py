"""Build and load the package's CUDA kernels.

At first use the sources under ``csrc/`` are compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked
into one shared library with a plain C interface, under ``build/``
beside the package (keyed by a hash of the sources and the flags, so an
edited source builds anew), and loaded with ``ctypes``.  A missing
``nvcc`` or a failed build raises: there is no other route to the
kernels.
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
SOURCES = (_PKG / "csrc" / "ec_kernels.cu",
           _PKG / "csrc" / "crush_kernels.cu")
BUILD_DIR = _PKG.parent / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")

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


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed (%d): %s\n%s"
                               % (p.returncode, " ".join(cmd), out))
    return "".join(outs)


def build() -> tuple[Path, str]:
    """Compile the sources if this hash has no library yet; returns
    (library path, the compiler's register/shared-memory report)."""
    key = _key()
    lib = BUILD_DIR / ("libceph_torch_%s.so" % key)
    if lib.exists():
        return lib, ""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "%s.%d" % (key, os.getpid())
    objs = [BUILD_DIR / ("%s.%s.o" % (src.stem, tag)) for src in SOURCES]
    tmp = lib.with_suffix(".so.%d.tmp" % os.getpid())
    try:
        report = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                       for src, o in zip(SOURCES, objs)])
        _run([[nvcc, *ARCH, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]])
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return lib, report


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry's signature set."""
    with _lock:
        path, _report = build()
        lib = ctypes.CDLL(str(path))
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_uint
    lib.ec_fused_xor.argtypes = [p, p, p, i, i, ll, i, p]
    lib.ec_bitplane_matmul.argtypes = [p, p, p, i, i, i, ll, i, p]
    lib.ec_xor_schedule.argtypes = [p, p, p, p, i, i, ll, i, p]
    lib.crush_choose.argtypes = ([p, ll, p, u, u, u, i, p, ll, p] + [i] * 6
                                  + [p, p, i, p, p, p, p, p])
    lib.crush_post.argtypes = [p, p, i, i, i, i, ll, p, p, p]
    lib.crush_hitscan.argtypes = [p, p, i, i, i, ll, p, p]
    lib.crush_rowcompact.argtypes = [p, ll, ll, i, i, i, p, p, p, p]
    for fn in (lib.ec_fused_xor, lib.ec_bitplane_matmul,
               lib.ec_xor_schedule, lib.crush_choose, lib.crush_post,
               lib.crush_hitscan, lib.crush_rowcompact):
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        raise RuntimeError("%s: CUDA launch failed with cudaError %d"
                           % (name, err))
