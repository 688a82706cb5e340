"""Compression plugin registry of the CUDA port.

Counterpart of ceph_tpu/compress/__init__.py: named compressors behind
one two-method interface (Compressor.h's role).  zlib, lzma and bz2
come from the standard library; snappy and zstd register only when
their modules import; "tlz" is the device-planned LZ-class codec
(compress/tlz.py), whose sync interface is its host reference.
Callers record the algorithm name beside each blob (pool xattr / wire
flag).
"""

from __future__ import annotations

import bz2
import lzma
import zlib


class CompressorError(Exception):
    pass


# xattr names marking a compressed object image (shared by the OSD
# write path and the cls MethodContext so both see one convention)
OBJ_ALGO_ATTR = "comp-alg"
OBJ_SIZE_ATTR = "comp-size"


class Compressor:
    """One algorithm (CompressionPlugin + Compressor instance)."""

    name = ""

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, blob: bytes) -> bytes:
        raise NotImplementedError


class ZlibCompressor(Compressor):
    name = "zlib"

    # level 1: compression runs on the daemon's event loop, so the
    # default trades ratio for latency (heavier levels/algos are an
    # explicit operator choice via compression_algorithm)
    def __init__(self, level: int = 1):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, blob: bytes) -> bytes:
        try:
            return zlib.decompress(blob)
        except zlib.error as e:
            raise CompressorError("zlib: %s" % e) from None


class LzmaCompressor(Compressor):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=1)

    def decompress(self, blob: bytes) -> bytes:
        try:
            return lzma.decompress(blob)
        except lzma.LZMAError as e:
            raise CompressorError("lzma: %s" % e) from None


class Bz2Compressor(Compressor):
    name = "bz2"

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data, 1)

    def decompress(self, blob: bytes) -> bytes:
        try:
            return bz2.decompress(blob)
        except (OSError, ValueError) as e:
            raise CompressorError("bz2: %s" % e) from None


_REGISTRY: dict[str, Compressor] = {}


def register(comp: Compressor) -> None:
    _REGISTRY[comp.name] = comp


def create(name: str) -> Compressor:
    """Compressor::create: by-name factory; unknown = error."""
    c = _REGISTRY.get(name)
    if c is None:
        raise CompressorError("no compressor %r (have: %s)"
                              % (name, sorted(_REGISTRY)))
    return c


def available() -> list[str]:
    return sorted(_REGISTRY)


register(ZlibCompressor())
register(LzmaCompressor())
register(Bz2Compressor())

# "tlz": compress_async plans matches on the card, the sync interface
# is the host reference with identical bytes, so any consumer decodes
# it with the sync interface alone
from .tlz import TlzCompressor  # noqa: E402  (needs Compressor above)

register(TlzCompressor())

# optional third-party algorithms, loaded like dlopen'd plugins
try:                                    # pragma: no cover
    import snappy as _snappy

    class SnappyCompressor(Compressor):
        name = "snappy"

        def compress(self, data: bytes) -> bytes:
            return _snappy.compress(data)

        def decompress(self, blob: bytes) -> bytes:
            try:
                return _snappy.decompress(blob)
            except Exception as e:
                raise CompressorError("snappy: %s" % e) from None

    register(SnappyCompressor())
except ImportError:
    pass

try:                                    # pragma: no cover
    import zstandard as _zstd

    class ZstdCompressor(Compressor):
        name = "zstd"

        def compress(self, data: bytes) -> bytes:
            return _zstd.ZstdCompressor().compress(data)

        def decompress(self, blob: bytes) -> bytes:
            try:
                return _zstd.ZstdDecompressor().decompress(blob)
            except Exception as e:
                raise CompressorError("zstd: %s" % e) from None

    register(ZstdCompressor())
except ImportError:
    pass
