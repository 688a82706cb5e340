"""KStore: durable ObjectStore over an ordered KeyValueDB.

The reference's KStore (src/os/kstore/) keeps everything — object
data, xattrs, omap, collection records — in RocksDB; this build keeps
the same design over the KeyValueDB abstraction (SQLite engine by
default, MemKV for tests).  One KV write batch per transaction gives
atomic commit; key encoding preserves hobject bitwise sort order so
object enumeration is a single range scan.

Reads are served from an in-RAM MemStore mirror rebuilt on mount (the
mirror IS the authoritative in-memory state; the KV holds its durable
image).  Writes apply to the mirror first, then the touched objects'
full KV images are rewritten in one atomic batch — simple, correct,
and sufficient for the PG-scale objects the OSD slice handles; a
BlueStore-class extent store refines this later.

Key layout (facet byte 'a' sorts first so a scan meets each object's
identity record before its facets):
  b'C' + 0x00 + cid-esc                      -> denc((cid, bits))
  b'O' + 0x00 + cid-esc + 0x00 + okey + 0x00 + facet
     facet b'a'            -> denc((cid, oid-tuple))
     facet b'd'            -> data blob
     facet b'h'            -> omap header
     facet b'x' + name-esc -> xattr value
     facet b'm' + key-esc  -> omap value
"""

from __future__ import annotations

import struct
from typing import Callable

from ..utils import denc
from .memstore import MemStore, _Collection, _Object
from .kv import KeyValueDB, SQLiteKV
from .objectstore import (
    OP_CLONE,
    OP_CLONERANGE2,
    OP_COLL_MOVE_RENAME,
    OP_MKCOLL,
    OP_RMCOLL,
    OP_SPLIT_COLLECTION2,
    OP_TRY_RENAME,
    ObjectStore,
    Transaction,
    coll_t,
    hobject_t,
    _rev32,
)


def _esc(b: bytes) -> bytes:
    """0x00-free escaping that preserves byte order."""
    return b.replace(b"\x00", b"\x00\xff")


def _unesc(b: bytes) -> bytes:
    return b.replace(b"\x00\xff", b"\x00")


def _okey(oid: hobject_t) -> bytes:
    return b"".join((
        struct.pack(">Q", oid.pool + (1 << 63)),
        struct.pack(">I", _rev32(oid.hash)),
        _esc(oid.nspace.encode()), b"\x00\x01",
        _esc(oid.key.encode()), b"\x00\x01",
        _esc(oid.name.encode()), b"\x00\x01",
        struct.pack(">Q", oid.snap),
    ))


def _oid_tuple(oid: hobject_t) -> tuple:
    return (oid.name, oid.pool, oid.nspace, oid.key, oid.snap, oid.hash)


def _oid_from_tuple(t) -> hobject_t:
    name, pool, nspace, key, snap, h = t
    return hobject_t(name=name, pool=pool, nspace=nspace, key=key,
                     snap=snap, hash=h)


_CPREF = b"C\x00"
_OPREF = b"O\x00"


def _ckey(cid: coll_t) -> bytes:
    return _CPREF + _esc(str(cid).encode())


def _obase(cid: coll_t, oid: hobject_t) -> bytes:
    return (_OPREF + _esc(str(cid).encode()) + b"\x00" + _okey(oid)
            + b"\x00")


def _ocollpref(cid: coll_t) -> bytes:
    return _OPREF + _esc(str(cid).encode()) + b"\x00"


class KStore(ObjectStore):
    def __init__(self, path: str, db: KeyValueDB | None = None):
        super().__init__(path)
        self.db = db if db is not None else SQLiteKV(path)
        self._mem = MemStore()

    # -- lifecycle ---------------------------------------------------------

    def mkfs(self) -> None:
        self.db.open()
        self.db.close()

    def mount(self) -> None:
        self.db.open()
        self._mem = MemStore()
        self._mem.mount()
        self._load()

    def umount(self) -> None:
        self.db.close()
        self._mem.umount()

    def statfs(self) -> dict:
        """The in-RAM image mirrors the KV contents exactly, so its
        usage accounting is this store's too."""
        return self._mem.statfs()

    def _load(self) -> None:
        for _k, v in self.db.iterate(_CPREF, _CPREF + b"\xff"):
            cidname, bits = denc.decode(v)
            self._mem._colls[coll_t(cidname)] = _Collection(bits)
        base: bytes | None = None
        obj: _Object | None = None
        for k, v in self.db.iterate(_OPREF, _OPREF + b"\xff"):
            if base is not None and k.startswith(base):
                facet = bytes(k[len(base):])
                if facet == b"d":
                    obj.data = bytearray(v)
                elif facet == b"h":
                    obj.omap_header = v
                elif facet[:1] == b"x":
                    obj.xattrs[_unesc(facet[1:]).decode()] = v
                elif facet[:1] == b"m":
                    obj.omap[_unesc(facet[1:])] = v
                continue
            if not k.endswith(b"\x00a"):
                raise ValueError("kstore: orphan facet key %r" % (k,))
            base = bytes(k[:-1])
            cidname, oid_t = denc.decode(v)
            obj = _Object()
            self._mem._colls[coll_t(cidname)].objects[
                _oid_from_tuple(oid_t)] = obj

    # -- writes ------------------------------------------------------------

    def queue_transactions(
        self, txs: list[Transaction],
        on_applied: Callable[[], None] | None = None,
        on_commit: Callable[[], None] | None = None,
    ) -> None:
        dirty: set[tuple[coll_t, hobject_t]] = set()
        dirty_colls: set[coll_t] = set()
        removed_colls: set[coll_t] = set()
        with self._mem._lock:
            for tx in txs:
                # note THEN apply per op, so a split sees exactly the
                # membership earlier ops in the same tx created
                for op in tx.ops:
                    self._note(op, dirty, dirty_colls, removed_colls)
                    self._mem._apply_op(op)
            batch = self.db.get_transaction()
            for cid in removed_colls:
                batch.rmkey(_ckey(cid))
                pref = _ocollpref(cid)
                batch.rm_range(pref, pref + b"\xff")
            for cid in dirty_colls:
                c = self._mem._colls.get(cid)
                if c is not None:
                    batch.set(_ckey(cid), denc.encode((str(cid), c.bits)))
            for cid, oid in sorted(
                    dirty, key=lambda t: (str(t[0]), t[1].sort_key())):
                self._persist(batch, cid, oid)
        if on_applied:
            on_applied()
        self.db.submit_transaction(batch)
        if on_commit:
            on_commit()

    def _note(self, op, dirty, dirty_colls, removed_colls) -> None:
        """Record which objects/collections an op touches (before it is
        applied, so splits can enumerate the pre-move membership)."""
        code = op[0]
        if code == OP_MKCOLL:
            dirty_colls.add(op[1])
            removed_colls.discard(op[1])
        elif code == OP_RMCOLL:
            removed_colls.add(op[1])
            dirty_colls.discard(op[1])
        elif code == OP_SPLIT_COLLECTION2:
            _, cid, bits, rem, dest = op
            c = self._mem._colls.get(cid)
            if c is not None:
                mask = (1 << bits) - 1
                for oid in c.objects:
                    if oid.hash & mask == rem:
                        dirty.add((cid, oid))
                        dirty.add((dest, oid))
            dirty_colls.add(cid)
            dirty_colls.add(dest)
        elif code == OP_COLL_MOVE_RENAME:
            _, oldcid, oldoid, newcid, newoid = op
            dirty.add((oldcid, oldoid))
            dirty.add((newcid, newoid))
        elif code == OP_TRY_RENAME:
            _, cid, oldoid, newoid = op
            dirty.add((cid, oldoid))
            dirty.add((cid, newoid))
        elif code in (OP_CLONE, OP_CLONERANGE2):
            dirty.add((op[1], op[2]))
            dirty.add((op[1], op[3]))
        elif len(op) >= 3 and isinstance(op[2], hobject_t):
            dirty.add((op[1], op[2]))

    def _persist(self, batch, cid: coll_t, oid: hobject_t) -> None:
        """Rewrite one object's full KV image (or clear it if gone)."""
        base = _obase(cid, oid)
        batch.rm_range(base, base + b"\xff")
        c = self._mem._colls.get(cid)
        o = c.objects.get(oid) if c is not None else None
        if o is None:
            return
        batch.set(base + b"a", denc.encode((str(cid), _oid_tuple(oid))))
        if o.data:
            batch.set(base + b"d", bytes(o.data))
        if o.omap_header:
            batch.set(base + b"h", o.omap_header)
        for name, val in o.xattrs.items():
            batch.set(base + b"x" + _esc(name.encode()), val)
        for key, val in o.omap.items():
            kb = key if isinstance(key, bytes) else key.encode()
            batch.set(base + b"m" + _esc(kb), val)

    # -- reads: delegate to the mirror ------------------------------------

    def exists(self, cid, oid):
        return self._mem.exists(cid, oid)

    def stat(self, cid, oid):
        return self._mem.stat(cid, oid)

    def read(self, cid, oid, offset=0, length=-1):
        return self._mem.read(cid, oid, offset, length)

    def getattr(self, cid, oid, name):
        return self._mem.getattr(cid, oid, name)

    def getattrs(self, cid, oid):
        return self._mem.getattrs(cid, oid)

    def omap_get_header(self, cid, oid):
        return self._mem.omap_get_header(cid, oid)

    def omap_get(self, cid, oid):
        return self._mem.omap_get(cid, oid)

    def omap_get_values(self, cid, oid, keys):
        return self._mem.omap_get_values(cid, oid, keys)

    def list_collections(self):
        return self._mem.list_collections()

    def collection_exists(self, cid):
        return self._mem.collection_exists(cid)

    def collection_empty(self, cid):
        return self._mem.collection_empty(cid)

    def collection_bits(self, cid):
        return self._mem.collection_bits(cid)

    def collection_list(self, cid, start=None, end=None, max_count=-1):
        return self._mem.collection_list(cid, start, end, max_count)
