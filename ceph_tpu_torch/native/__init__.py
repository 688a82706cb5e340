"""Native (C) host kernels, loaded via ctypes.

The reference keeps its hot host loops in C/C++ (the crush core is
kernel-compatible C, EC rides isa-l assembly); this package is the
analog: small C sources compiled on first use into a per-checkout
shared object and exposed through ctypes, with every caller keeping a
pure-Python/numpy fallback (CEPH_TPU_NO_NATIVE=1 forces it).  Outputs
are bit-identical to the fallbacks by construction and pinned by
tests."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
# beside the package, like the CUDA library (_build.BUILD_DIR): never
# next to the source
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
_LIB = None
_TRIED = False


def _build(src: str, out: str, flags: list[str]) -> bool:
    # build to a process-unique temp and rename into place: concurrent
    # processes racing the first compile must never dlopen a
    # half-written .so
    tmp = "%s.%d.tmp" % (out, os.getpid())
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run(["gcc", *flags, src, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _flags() -> list[str]:
    flags = ["-O3", "-shared", "-fPIC"]
    # AVX2 when the host has it (the scalar path compiles regardless)
    try:
        with open("/proc/cpuinfo") as f:
            if "avx2" in f.read():
                flags.append("-mavx2")
    except OSError:
        pass
    return flags


def lib():
    """The loaded libgfec, or None (missing compiler, forced off).  The
    library's name is keyed by a hash of the source and the flags, so
    an edited source builds anew."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CEPH_TPU_NO_NATIVE"):
        return None
    src = os.path.join(_DIR, "gfec.c")
    flags = _flags()
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    so = os.path.join(BUILD_DIR, "libgfec_%s.so" % h.hexdigest()[:16])
    if not os.path.exists(so) and not _build(src, so, flags):
        return None
    try:
        L = ctypes.CDLL(so)
        L.gfec_init()
        L.gfec_matmul.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
        L.gfec_region_mad.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_ubyte,
            ctypes.c_size_t]
        _LIB = L
    except OSError:
        _LIB = None
    return _LIB
