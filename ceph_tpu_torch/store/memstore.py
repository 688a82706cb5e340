"""MemStore: complete in-RAM ObjectStore (the test backend).

Mirrors src/os/memstore/MemStore.cc's role: OSD logic runs against it
without disks; transactions apply atomically under one lock and
callbacks fire synchronously (commit == apply for RAM).
"""

from __future__ import annotations

import threading
from typing import Callable

from .objectstore import (
    OP_CLONE,
    OP_CLONERANGE2,
    OP_COLL_MOVE_RENAME,
    OP_CREATE,
    OP_MKCOLL,
    OP_NOP,
    OP_OMAP_CLEAR,
    OP_OMAP_RMKEYRANGE,
    OP_OMAP_RMKEYS,
    OP_OMAP_SETHEADER,
    OP_OMAP_SETKEYS,
    OP_REMOVE,
    OP_RMATTR,
    OP_RMATTRS,
    OP_RMCOLL,
    OP_SETATTR,
    OP_SETATTRS,
    OP_SPLIT_COLLECTION2,
    OP_TOUCH,
    OP_TRUNCATE,
    OP_TRY_RENAME,
    OP_WRITE,
    OP_ZERO,
    AlreadyExists,
    NotFound,
    ObjectStore,
    StoreError,
    Transaction,
    coll_t,
    hobject_t,
)


class _Object:
    __slots__ = ("data", "xattrs", "omap", "omap_header")

    def __init__(self):
        self.data = bytearray()
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}
        self.omap_header = b""

    def clone(self) -> "_Object":
        o = _Object()
        o.data = bytearray(self.data)
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        o.omap_header = self.omap_header
        return o

    def write(self, offset: int, data: bytes) -> None:
        end = offset + len(data)
        if len(self.data) < end:
            self.data.extend(b"\x00" * (end - len(self.data)))
        self.data[offset:end] = data


class _Collection:
    __slots__ = ("bits", "objects")

    def __init__(self, bits: int = 0):
        self.bits = bits
        self.objects: dict[hobject_t, _Object] = {}


class MemStore(ObjectStore):
    def __init__(self, path: str = "", device_bytes: int = 1 << 30):
        super().__init__(path)
        self._colls: dict[coll_t, _Collection] = {}
        self._lock = threading.RLock()
        self._mounted = False
        # nominal "device" size the statfs axis reports against (RAM
        # has no real capacity edge; df still needs a denominator)
        self.device_bytes = int(device_bytes)

    # -- lifecycle ---------------------------------------------------------

    def mkfs(self) -> None:
        self._colls = {}

    def mount(self) -> None:
        self._mounted = True

    def umount(self) -> None:
        self._mounted = False

    # -- transaction application ------------------------------------------

    def queue_transactions(
        self, txs: list[Transaction],
        on_applied: Callable[[], None] | None = None,
        on_commit: Callable[[], None] | None = None,
    ) -> None:
        with self._lock:
            for tx in txs:
                self._apply(tx)
        if on_applied:
            on_applied()
        if on_commit:
            on_commit()

    def _coll(self, cid: coll_t) -> _Collection:
        c = self._colls.get(cid)
        if c is None:
            raise NotFound("collection %s" % cid)
        return c

    def _obj(self, cid: coll_t, oid: hobject_t,
             create: bool = False) -> _Object:
        c = self._coll(cid)
        o = c.objects.get(oid)
        if o is None:
            if not create:
                raise NotFound("object %s/%s" % (cid, oid))
            o = _Object()
            c.objects[oid] = o
        return o

    def _apply(self, tx: Transaction) -> None:
        for op in tx.ops:
            self._apply_op(op)

    def _apply_op(self, op: tuple) -> None:
            code = op[0]
            if code == OP_NOP:
                pass
            elif code == OP_CREATE:
                _, cid, oid = op
                c = self._coll(cid)
                if oid in c.objects:
                    raise AlreadyExists("object %s/%s" % (cid, oid))
                c.objects[oid] = _Object()
            elif code == OP_TOUCH:
                _, cid, oid = op
                self._obj(cid, oid, create=True)
            elif code == OP_WRITE:
                _, cid, oid, offset, data = op
                self._obj(cid, oid, create=True).write(offset, data)
            elif code == OP_ZERO:
                _, cid, oid, offset, length = op
                self._obj(cid, oid, create=True).write(
                    offset, b"\x00" * length)
            elif code == OP_TRUNCATE:
                _, cid, oid, length = op
                o = self._obj(cid, oid)
                if len(o.data) > length:
                    del o.data[length:]
                else:
                    o.data.extend(b"\x00" * (length - len(o.data)))
            elif code == OP_REMOVE:
                # idempotent: a replica may apply a replicated delete
                # for an object it never held (sparse images, races
                # with recovery) — the primary existence-gates the
                # client-visible ENOENT
                _, cid, oid = op
                self._coll(cid).objects.pop(oid, None)
            elif code == OP_SETATTR:
                _, cid, oid, name, val = op
                self._obj(cid, oid, create=True).xattrs[name] = val
            elif code == OP_SETATTRS:
                _, cid, oid, attrs = op
                self._obj(cid, oid, create=True).xattrs.update(attrs)
            elif code == OP_RMATTR:
                _, cid, oid, name = op
                self._obj(cid, oid).xattrs.pop(name, None)
            elif code == OP_RMATTRS:
                _, cid, oid = op
                self._obj(cid, oid).xattrs.clear()
            elif code == OP_CLONE:
                _, cid, oid, newoid = op
                c = self._coll(cid)
                c.objects[newoid] = self._obj(cid, oid).clone()
            elif code == OP_CLONERANGE2:
                _, cid, oid, newoid, srcoff, length, dstoff = op
                src = self._obj(cid, oid)
                dst = self._obj(cid, newoid, create=True)
                dst.write(dstoff, bytes(src.data[srcoff:srcoff + length]))
            elif code == OP_OMAP_CLEAR:
                _, cid, oid = op
                o = self._obj(cid, oid)
                o.omap.clear()
            elif code == OP_OMAP_SETKEYS:
                _, cid, oid, kv = op
                self._obj(cid, oid, create=True).omap.update(kv)
            elif code == OP_OMAP_RMKEYS:
                _, cid, oid, keys = op
                o = self._obj(cid, oid)
                for k in keys:
                    o.omap.pop(k, None)
            elif code == OP_OMAP_RMKEYRANGE:
                _, cid, oid, first, last = op
                o = self._obj(cid, oid)
                for k in [k for k in o.omap if first <= k < last]:
                    del o.omap[k]
            elif code == OP_OMAP_SETHEADER:
                _, cid, oid, header = op
                self._obj(cid, oid, create=True).omap_header = header
            elif code == OP_MKCOLL:
                _, cid, bits = op
                if cid in self._colls:
                    raise AlreadyExists("collection %s" % cid)
                self._colls[cid] = _Collection(bits)
            elif code == OP_RMCOLL:
                _, cid = op
                c = self._colls.pop(cid, None)
                if c is None:
                    raise NotFound("collection %s" % cid)
            elif code == OP_SPLIT_COLLECTION2:
                _, cid, bits, rem, dest = op
                src = self._coll(cid)
                dst = self._coll(dest)
                mask = (1 << bits) - 1
                moving = [oid for oid in src.objects
                          if oid.hash & mask == rem]
                for oid in moving:
                    dst.objects[oid] = src.objects.pop(oid)
                src.bits = bits
                dst.bits = bits
            elif code == OP_COLL_MOVE_RENAME:
                _, oldcid, oldoid, newcid, newoid = op
                src = self._coll(oldcid)
                o = src.objects.pop(oldoid, None)
                if o is None:
                    raise NotFound("object %s/%s" % (oldcid, oldoid))
                self._coll(newcid).objects[newoid] = o
            elif code == OP_TRY_RENAME:
                _, cid, oldoid, newoid = op
                c = self._coll(cid)
                o = c.objects.pop(oldoid, None)
                if o is not None:
                    c.objects[newoid] = o
            else:
                raise StoreError("unknown op %r" % (code,))

    # -- statfs ------------------------------------------------------------

    def statfs(self) -> dict:
        """Bytes actually held (data + xattrs + omap) against the
        nominal device size."""
        used = 0
        with self._lock:
            for c in self._colls.values():
                for o in c.objects.values():
                    used += len(o.data) + len(o.omap_header)
                    for k, v in o.xattrs.items():
                        used += len(k) + len(v)
                    for k, v in o.omap.items():
                        used += len(k) + len(v)
        total = max(self.device_bytes, used)
        return {"total": total, "used": used,
                "available": total - used}

    # -- reads -------------------------------------------------------------

    def exists(self, cid: coll_t, oid: hobject_t) -> bool:
        with self._lock:
            c = self._colls.get(cid)
            return c is not None and oid in c.objects

    def stat(self, cid: coll_t, oid: hobject_t) -> int:
        with self._lock:
            return len(self._obj(cid, oid).data)

    def read(self, cid: coll_t, oid: hobject_t, offset: int = 0,
             length: int = -1) -> bytes:
        with self._lock:
            o = self._obj(cid, oid)
            if length < 0:
                return bytes(o.data[offset:])
            return bytes(o.data[offset:offset + length])

    def getattr(self, cid: coll_t, oid: hobject_t, name: str) -> bytes:
        with self._lock:
            try:
                return self._obj(cid, oid).xattrs[name]
            except KeyError:
                raise NotFound("xattr %s" % name) from None

    def getattrs(self, cid: coll_t, oid: hobject_t) -> dict:
        with self._lock:
            return dict(self._obj(cid, oid).xattrs)

    def omap_get_header(self, cid: coll_t, oid: hobject_t) -> bytes:
        with self._lock:
            return self._obj(cid, oid).omap_header

    def omap_get(self, cid: coll_t, oid: hobject_t) -> dict:
        with self._lock:
            return dict(sorted(self._obj(cid, oid).omap.items()))

    def omap_get_values(self, cid: coll_t, oid: hobject_t, keys) -> dict:
        with self._lock:
            omap = self._obj(cid, oid).omap
            return {k: omap[k] for k in keys if k in omap}

    # -- collections -------------------------------------------------------

    def list_collections(self) -> list[coll_t]:
        with self._lock:
            return sorted(self._colls, key=lambda c: c.name)

    def collection_exists(self, cid: coll_t) -> bool:
        with self._lock:
            return cid in self._colls

    def collection_empty(self, cid: coll_t) -> bool:
        with self._lock:
            return not self._coll(cid).objects

    def collection_bits(self, cid: coll_t) -> int:
        with self._lock:
            return self._coll(cid).bits

    def collection_list(self, cid: coll_t, start: hobject_t | None = None,
                        end: hobject_t | None = None,
                        max_count: int = -1) -> list[hobject_t]:
        with self._lock:
            objs = sorted(self._coll(cid).objects,
                          key=lambda o: o.sort_key())
        if start is not None:
            sk = start.sort_key()
            objs = [o for o in objs if o.sort_key() >= sk]
        if end is not None:
            ek = end.sort_key()
            objs = [o for o in objs if o.sort_key() < ek]
        if max_count >= 0:
            objs = objs[:max_count]
        return objs
