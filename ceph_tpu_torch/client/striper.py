"""Striper: one logical extent sharded over many RADOS objects.

Analog of Striper::file_to_extents (src/osdc/Striper.h:28-66 /
Striper.cc) + libradosstriper (src/libradosstriper/RadosStriperImpl.cc):
a file_layout_t (stripe_unit su, stripe_count sc, object_size os —
src/include/ceph_fs.h:70-78) round-robins su-sized blocks over sets of
sc objects, each object holding os bytes before the next object set
starts.  SURVEY §5 calls this the long-context analog: the extent math
is a closed-form integer transform, so the bulk mapping is expressed
vectorized over the block axis (numpy here; the same expressions run
under jnp for on-device batches).

Object naming follows libradosstriper: "<soid>.%016x" % objectno, with
the logical size kept as an xattr on object 0 (striper.layout carries
the layout so readers need no out-of-band metadata)."""

from __future__ import annotations

import numpy as np

SIZE_XATTR = "striper.size"
LAYOUT_XATTR = "striper.layout"


class FileLayout:
    """file_layout_t subset (stripe_unit, stripe_count, object_size)."""

    __slots__ = ("stripe_unit", "stripe_count", "object_size")

    def __init__(self, stripe_unit: int = 1 << 22,
                 stripe_count: int = 1,
                 object_size: int = 1 << 22):
        if stripe_unit <= 0 or stripe_count <= 0 or object_size <= 0:
            raise ValueError("layout fields must be positive")
        if object_size % stripe_unit:
            raise ValueError("object_size must be a multiple of "
                             "stripe_unit")
        self.stripe_unit = stripe_unit
        self.stripe_count = stripe_count
        self.object_size = object_size

    def encode(self) -> bytes:
        return b"%d:%d:%d" % (self.stripe_unit, self.stripe_count,
                              self.object_size)

    @classmethod
    def decode(cls, raw: bytes) -> "FileLayout":
        su, sc, os_ = (int(x) for x in raw.split(b":"))
        return cls(su, sc, os_)


def file_to_extents(layout: FileLayout, offset: int, length: int
                    ) -> list[tuple[int, int, int, int]]:
    """[(objectno, obj_off, len, file_off), ...] covering
    [offset, offset+length), merged per contiguous object run —
    Striper::file_to_extents' closed form, vectorized over the
    stripe-unit block axis:

        blockno   = off / su            stripeno  = blockno / sc
        stripepos = blockno % sc        setno     = stripeno / (os/su)
        objectno  = setno * sc + stripepos
        obj_off   = (stripeno % (os/su)) * su + off % su
    """
    if length <= 0:
        return []
    su = layout.stripe_unit
    sc = layout.stripe_count
    upo = layout.object_size // su          # stripe units per object
    first = offset // su
    last = (offset + length - 1) // su
    blockno = np.arange(first, last + 1, dtype=np.int64)
    stripeno = blockno // sc
    stripepos = blockno % sc
    setno = stripeno // upo
    objectno = setno * sc + stripepos
    in_obj = (stripeno % upo) * su
    # per-block source range within the file
    blk_start = np.maximum(blockno * su, offset)
    blk_end = np.minimum((blockno + 1) * su, offset + length)
    obj_off = in_obj + (blk_start - blockno * su)
    ext_len = blk_end - blk_start
    out: list[tuple[int, int, int, int]] = []
    for i in range(len(blockno)):
        o, oo, ln, fo = (int(objectno[i]), int(obj_off[i]),
                         int(ext_len[i]), int(blk_start[i]))
        if out and out[-1][0] == o \
                and out[-1][1] + out[-1][2] == oo \
                and out[-1][3] + out[-1][2] == fo:
            prev = out[-1]
            out[-1] = (prev[0], prev[1], prev[2] + ln, prev[3])
        else:
            out.append((o, oo, ln, fo))
    return out


class RadosStriper:
    """Striped object I/O over an IoCtx (libradosstriper surface)."""

    def __init__(self, ioctx, layout: FileLayout | None = None):
        self.io = ioctx
        self.layout = layout or FileLayout(stripe_unit=1 << 16,
                                           stripe_count=4,
                                           object_size=1 << 18)

    @staticmethod
    def _name(soid: str, objectno: int) -> str:
        return "%s.%016x" % (soid, objectno)

    async def _stored_layout(self, soid: str) -> FileLayout:
        """The layout the object was WRITTEN with (object-0 xattr);
        readers must not trust their own default — extents computed
        with a different layout silently map to the wrong objects."""
        try:
            raw = await self.io.getxattr(self._name(soid, 0),
                                         LAYOUT_XATTR)
            return FileLayout.decode(raw)
        except Exception:
            return self.layout

    async def write(self, soid: str, data: bytes,
                    offset: int = 0) -> None:
        import asyncio

        # appends/overwrites must honour the layout the object was
        # created with, not the handle's default
        layout = await self._stored_layout(soid)
        exts = file_to_extents(layout, offset, len(data))
        await asyncio.gather(*[
            self.io.write(self._name(soid, o),
                          data[fo - offset:fo - offset + ln], oo)
            for o, oo, ln, fo in exts])
        # logical size + layout ride object 0 (libradosstriper keeps
        # them in xattrs of the first object)
        size = 0
        try:
            size = await self.stat(soid)
        except Exception:
            pass
        new_size = max(size, offset + len(data))
        o0 = self._name(soid, 0)
        if not exts or exts[0][0] != 0:
            await self.io.write(o0, b"", 0)    # ensure object 0
        await self.io.setxattr(o0, SIZE_XATTR, b"%d" % new_size)
        await self.io.setxattr(o0, LAYOUT_XATTR, layout.encode())

    async def stat(self, soid: str) -> int:
        raw = await self.io.getxattr(self._name(soid, 0), SIZE_XATTR)
        return int(raw)

    async def read(self, soid: str, length: int = 0,
                   offset: int = 0) -> bytes:
        import asyncio

        layout = await self._stored_layout(soid)
        if length <= 0:
            length = max(0, await self.stat(soid) - offset)
        if length == 0:
            return b""
        exts = file_to_extents(layout, offset, length)

        async def fetch(o, oo, ln):
            try:
                return await self.io.read(self._name(soid, o), ln, oo)
            except Exception:
                return b""

        parts = await asyncio.gather(*[fetch(o, oo, ln)
                                       for o, oo, ln, _fo in exts])
        buf = bytearray(length)
        for (o, oo, ln, fo), part in zip(exts, parts):
            part = part[:ln]
            buf[fo - offset:fo - offset + len(part)] = part
        return bytes(buf)

    async def remove(self, soid: str) -> None:
        import asyncio

        try:
            size = await self.stat(soid)
        except Exception:
            size = 0
        layout = await self._stored_layout(soid)
        exts = file_to_extents(layout, 0, max(size, 1))
        objs = sorted({o for o, _oo, _ln, _fo in exts} | {0})

        async def rm(o):
            try:
                await self.io.remove(self._name(soid, o))
            except Exception:
                pass

        await asyncio.gather(*[rm(o) for o in objs])
