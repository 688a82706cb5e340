"""ExtentStore: the production-class storage engine (BlueStore role).

Re-derivation of src/os/bluestore/BlueStore.cc's architecture for this
framework's L2 (queue_transactions pipeline BlueStore.cc:14141-14188,
deferred small writes, allocators, checksum-on-read), built on the
package's BlockDevice (blk.py = src/blk/) + KeyValueDB (kv.py) tiers:

* Object DATA lives on a flat block device in 4 KiB blocks; each
  onode's extent map points logical blocks at disk blocks, with a
  crc32 per block verified on every read (BlueStore csum_type crc32c).
* Object METADATA (onodes: size, extent map, xattrs, omap header) and
  omap keys live in the ordered KV, under the same bitwise-sorted key
  layout KStore uses, so collection_list is one range scan.
* BIG writes (whole blocks, large payloads) are copy-on-write: data
  goes to freshly allocated blocks and the device is flushed BEFORE
  the KV commit flips the extent map — a crash leaves the old object
  intact (BlueStore's unreferenced-space big-write path).
* SMALL writes are DEFERRED: the new whole-block images ride inside
  the same KV commit as a WAL record, and are applied to their final
  in-place location only after the commit lands (BlueStore deferred
  writes / bluestore_prefer_deferred_size).  A torn in-place block is
  unwindable because the WAL holds the full image; mount replays
  pending records idempotently.  WAL cleanup piggybacks on the next
  KV batch, which also closes the free-then-replay race: a record is
  always deleted in-or-before the batch that could recycle its blocks.
* The allocator (allocator.py) is rebuilt at mount from the onode
  extent maps — the modern reference's allocation-map-from-RocksDB
  recovery, which removes the persistent-freelist consistency problem.
* Free blocks from overwrites/removes are released only AFTER the KV
  commit that unreferences them, so committed metadata never points
  at recycled space.

Write amplification: a 4 KiB write to a 4 MiB object costs one 4 KiB
WAL record + one onode rewrite (~16 B/block of map) — not a 4 MiB
image rewrite (the KStore behavior this engine retires).
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable

from ..utils import denc
from .allocator import AllocError, ExtentAllocator
from .blk import BlockDevice, FileBlockDevice, MemBlockDevice
from .kstore import _esc, _unesc, _obase, _ocollpref, _ckey, _CPREF, \
    _OPREF, _oid_tuple, _oid_from_tuple
from .kv import KeyValueDB, MemKV, SQLiteKV
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

_WPREF = b"W\x00"
_SKEY = b"S\x00sb"
_BLOCK_REC = struct.Struct("<IIQ")      # bidx, crc32, disk offset


class ChecksumError(StoreError):
    """Data read back from the device failed its stored crc — the
    scrub tier treats this as a corrupt local shard."""


class Onode:
    """Object metadata record (BlueStore onode role): size, per-block
    extent map, xattrs, omap header.  Omap keys live beside it in the
    KV, not inside it."""

    __slots__ = ("size", "blocks", "xattrs", "omap_header")

    def __init__(self):
        self.size = 0
        self.blocks: dict[int, tuple[int, int]] = {}  # bidx->(doff,crc)
        self.xattrs: dict[str, bytes] = {}
        self.omap_header = b""

    def encode(self, cid: coll_t, oid: hobject_t) -> bytes:
        packed = b"".join(
            _BLOCK_REC.pack(b, crc, doff)
            for b, (doff, crc) in sorted(self.blocks.items()))
        return denc.encode((str(cid), _oid_tuple(oid), self.size,
                            packed, dict(self.xattrs),
                            self.omap_header))

    @classmethod
    def decode(cls, blob: bytes) -> tuple[str, hobject_t, "Onode"]:
        cidname, oid_t, size, packed, xattrs, hdr = denc.decode(blob)
        o = cls()
        o.size = size
        o.xattrs = dict(xattrs)
        o.omap_header = hdr
        for i in range(0, len(packed), _BLOCK_REC.size):
            b, crc, doff = _BLOCK_REC.unpack_from(packed, i)
            o.blocks[b] = (doff, crc)
        return cidname, _oid_from_tuple(oid_t), o


class _Coll:
    __slots__ = ("bits", "onodes")

    def __init__(self, bits: int = 0):
        self.bits = bits
        self.onodes: dict[hobject_t, Onode] = {}


class _TxContext:
    """Per-queue_transactions bookkeeping (BlueStore TransContext):
    which onodes/collections to persist, which blocks become free
    after commit, and the deferred (WAL) block images."""

    __slots__ = ("batch", "dirty", "dirty_colls", "released",
                 "deferred", "wrote_device", "omap_ops")

    def __init__(self, batch):
        self.batch = batch
        self.dirty: set[tuple[coll_t, hobject_t]] = set()
        self.dirty_colls: set[coll_t] = set()
        self.released: list[tuple[int, int]] = []
        self.deferred: dict[int, bytes] = {}    # doff -> block image
        self.wrote_device = False
        # staged omap mutations per object base key, in op order, so
        # a clone/move later in the SAME txn sees them (the committed
        # KV alone would miss same-txn omap writes)
        self.omap_ops: dict[bytes, list[tuple]] = {}

    def note_omap(self, base: bytes, op: tuple) -> None:
        self.omap_ops.setdefault(base, []).append(op)


class ExtentStore(ObjectStore):
    def __init__(self, path: str = "", db: KeyValueDB | None = None,
                 dev: BlockDevice | None = None,
                 dev_size: int = 1 << 30,
                 deferred_threshold: int = 65536):
        """``path`` is a directory holding ``block`` (the device file)
        and ``kv.db``; empty path = RAM device + RAM KV (ephemeral)."""
        super().__init__(path)
        if path:
            import os

            os.makedirs(path, exist_ok=True)
            self.db = db or SQLiteKV(path + "/kv.db")
            self.dev = dev or FileBlockDevice(path + "/block", dev_size)
        else:
            self.db = db or MemKV()
            self.dev = dev or MemBlockDevice(dev_size)
        self.bs = self.dev.block_size
        self.deferred_threshold = deferred_threshold
        self.alloc = ExtentAllocator(self.bs)
        self._colls: dict[coll_t, _Coll] = {}
        self._wal_seq = 0
        self._wal_cleanup: list[int] = []   # applied, key not yet rm'd
        self._overlay: dict[int, bytes] = {}  # committed, not applied
        # test hook: simulate a crash between KV commit and deferred
        # apply (the kill-point the WAL exists for)
        self.crash_before_deferred_apply = False

    # -- lifecycle ---------------------------------------------------------

    def mkfs(self) -> None:
        self.db.open()
        batch = self.db.get_transaction()
        batch.set(_SKEY, denc.encode({"block_size": self.bs,
                                      "dev_size": self.dev.size}))
        self.db.submit_transaction(batch)
        self.db.close()

    def mount(self) -> None:
        self.db.open()
        sb = self.db.get(_SKEY)
        if sb is not None:
            meta = denc.decode(sb)
            self.bs = meta["block_size"]
        self.dev.open()
        if sb is not None and meta["dev_size"] > self.dev.size:
            self.dev.extend(meta["dev_size"])
        self._replay_wal()
        self._load()

    def umount(self) -> None:
        self._flush_wal_cleanup()
        self.dev.flush()
        self.dev.close()
        self.db.close()
        self._colls = {}
        self._overlay = {}

    def statfs(self) -> dict:
        """Real device capacity vs the allocator's free-space view,
        PLUS the onode/omap KV footprint: metadata rides the DB, not
        the device, but it is real occupancy — `used` that omits it
        undercounts every omap-heavy workload (BlueStore folds its
        RocksDB usage into statfs the same way).  `kv_bytes` is
        broken out so `df` consumers can see the split; `available`
        stays the allocator's view of the block device (KV growth
        does not shrink extent space)."""
        total = int(self.dev.size)
        free = int(self.alloc.free_bytes)
        kv = 0
        for k, v in self.db.iterate():
            kv += len(k) + len(v)
        used = max(0, total - free) + kv
        return {"total": total, "used": used, "available": free,
                "kv_bytes": kv}

    def _replay_wal(self) -> None:
        """Apply committed-but-unapplied deferred writes.  Runs before
        the allocator rebuild, so a record targeting since-freed blocks
        just writes garbage into free space (harmless); records are
        deleted in one batch afterwards."""
        batch = self.db.get_transaction()
        n = 0
        for k, v in self.db.iterate(_WPREF, _WPREF + b"\xff"):
            (seq,) = struct.unpack(">Q", k[len(_WPREF):])
            self._wal_seq = max(self._wal_seq, seq + 1)
            for doff, data in denc.decode(v):
                if doff + len(data) > self.dev.size:
                    self.dev.extend(doff + len(data))
                self.dev.write(doff, data)
            batch.rmkey(bytes(k))
            n += 1
        if n:
            self.dev.flush()
            self.db.submit_transaction(batch)

    def _load(self) -> None:
        self._colls = {}
        for _k, v in self.db.iterate(_CPREF, _CPREF + b"\xff"):
            cidname, bits = denc.decode(v)
            self._colls[coll_t(cidname)] = _Coll(bits)
        self.alloc = ExtentAllocator(self.bs)
        self.alloc.init_add_free(0, (self.dev.size // self.bs) * self.bs)
        for k, v in self.db.iterate(_OPREF, _OPREF + b"\xff"):
            if not k.endswith(b"\x00a"):
                continue
            cidname, oid, onode = Onode.decode(v)
            self._colls[coll_t(cidname)].onodes[oid] = onode
            for doff, _crc in onode.blocks.values():
                self.alloc.init_rm_free(doff, self.bs)

    # -- helpers -----------------------------------------------------------

    def _coll(self, cid: coll_t) -> _Coll:
        c = self._colls.get(cid)
        if c is None:
            raise NotFound("collection %s" % cid)
        return c

    def _obj(self, cid: coll_t, oid: hobject_t,
             create: bool = False) -> Onode:
        c = self._coll(cid)
        o = c.onodes.get(oid)
        if o is None:
            if not create:
                raise NotFound("object %s/%s" % (cid, oid))
            o = Onode()
            c.onodes[oid] = o
        return o

    def _allocate(self, want: int) -> list[tuple[int, int]]:
        """Allocate ``want`` bytes of extents, thin-growing the device
        on ENOSPC."""
        try:
            return self.alloc.allocate(want)
        except AllocError:
            grown = max(self.dev.size * 2,
                        self.dev.size + max(want, 64 << 20))
            old = (self.dev.size // self.bs) * self.bs
            self.dev.extend(grown)
            self.alloc.init_add_free(
                old, (grown // self.bs) * self.bs - old)
            batch = self.db.get_transaction()
            batch.set(_SKEY, denc.encode({"block_size": self.bs,
                                          "dev_size": grown}))
            self.db.submit_transaction(batch)
            return self.alloc.allocate(want)

    def _allocate_block(self) -> int:
        [(off, _ln)] = self._allocate(self.bs)
        return off

    def _block_content(self, onode: Onode, bidx: int,
                       txc: _TxContext | None = None) -> bytes:
        """Current image of a logical block: staged-in-txn image wins,
        then the committed-not-applied overlay, then the device (crc
        verified), else zeros for holes."""
        m = onode.blocks.get(bidx)
        if m is None:
            return b"\x00" * self.bs
        doff, crc = m
        if txc is not None and doff in txc.deferred:
            return txc.deferred[doff]
        if doff in self._overlay:
            return self._overlay[doff]
        data = self.dev.read(doff, self.bs)
        if zlib.crc32(data) != crc:
            raise ChecksumError(
                "crc mismatch at disk off %d (block %d)" % (doff, bidx))
        return data

    # -- write pipeline ----------------------------------------------------

    def queue_transactions(
        self, txs: list[Transaction],
        on_applied: Callable[[], None] | None = None,
        on_commit: Callable[[], None] | None = None,
    ) -> None:
        batch = self.db.get_transaction()
        txc = _TxContext(batch)
        try:
            for tx in txs:
                for op in tx.ops:
                    self._apply_op(txc, op)
        except Exception:
            # a failed op must not leave RAM diverged from the KV
            # (phantom reads until restart, leaked allocations):
            # rebuild collections/onodes/allocator from committed
            # state — uncommitted COW grants return to free
            self._load()
            raise
        # persist dirty collections + onodes
        for cid in txc.dirty_colls:
            c = self._colls.get(cid)
            if c is not None:
                batch.set(_ckey(cid),
                          denc.encode((str(cid), c.bits)))
        for cid, oid in sorted(
                txc.dirty, key=lambda t: (str(t[0]), t[1].sort_key())):
            c = self._colls.get(cid)
            o = c.onodes.get(oid) if c is not None else None
            if o is not None:
                batch.set(_obase(cid, oid) + b"a", o.encode(cid, oid))
        wal_seq = -1
        if txc.deferred:
            wal_seq = self._wal_seq
            self._wal_seq += 1
            batch.set(_WPREF + struct.pack(">Q", wal_seq),
                      denc.encode(sorted(txc.deferred.items())))
        # piggyback cleanup of already-applied WAL records: they die
        # in-or-before any batch that could recycle their blocks
        for seq in self._wal_cleanup:
            batch.rmkey(_WPREF + struct.pack(">Q", seq))
        self._wal_cleanup = []
        if txc.wrote_device:
            # big-write barrier: data must be durable before the KV
            # commit makes the extent map point at it
            self.dev.flush()
        if on_applied:
            on_applied()
        self.db.submit_transaction(batch)
        # blocks unreferenced by this commit are now safe to recycle
        self.alloc.release(txc.released)
        if txc.deferred:
            self._overlay.update(txc.deferred)
            if not self.crash_before_deferred_apply:
                for doff, data in txc.deferred.items():
                    self.dev.write(doff, data)
                self.dev.flush()
                for doff in txc.deferred:
                    self._overlay.pop(doff, None)
                self._wal_cleanup.append(wal_seq)
        if on_commit:
            on_commit()

    def _flush_wal_cleanup(self) -> None:
        if not self._wal_cleanup:
            return
        batch = self.db.get_transaction()
        for seq in self._wal_cleanup:
            batch.rmkey(_WPREF + struct.pack(">Q", seq))
        self._wal_cleanup = []
        self.db.submit_transaction(batch)

    # -- op interpreter ----------------------------------------------------

    def _apply_op(self, txc: _TxContext, op: tuple) -> None:
        code = op[0]
        if code == OP_NOP:
            pass
        elif code == OP_CREATE:
            _, cid, oid = op
            c = self._coll(cid)
            if oid in c.onodes:
                raise AlreadyExists("object %s/%s" % (cid, oid))
            c.onodes[oid] = Onode()
            txc.dirty.add((cid, oid))
        elif code == OP_TOUCH:
            _, cid, oid = op
            self._obj(cid, oid, create=True)
            txc.dirty.add((cid, oid))
        elif code == OP_WRITE:
            _, cid, oid, offset, data = op
            self._do_write(txc, cid, oid, offset, data)
        elif code == OP_ZERO:
            _, cid, oid, offset, length = op
            self._do_zero(txc, cid, oid, offset, length)
        elif code == OP_TRUNCATE:
            _, cid, oid, length = op
            self._do_truncate(txc, cid, oid, length)
        elif code == OP_REMOVE:
            _, cid, oid = op
            self._do_remove(txc, cid, oid)
        elif code == OP_SETATTR:
            _, cid, oid, name, val = op
            self._obj(cid, oid, create=True).xattrs[name] = val
            txc.dirty.add((cid, oid))
        elif code == OP_SETATTRS:
            _, cid, oid, attrs = op
            self._obj(cid, oid, create=True).xattrs.update(attrs)
            txc.dirty.add((cid, oid))
        elif code == OP_RMATTR:
            _, cid, oid, name = op
            self._obj(cid, oid).xattrs.pop(name, None)
            txc.dirty.add((cid, oid))
        elif code == OP_RMATTRS:
            _, cid, oid = op
            self._obj(cid, oid).xattrs.clear()
            txc.dirty.add((cid, oid))
        elif code == OP_CLONE:
            _, cid, oid, newoid = op
            self._do_clone(txc, cid, oid, newoid)
        elif code == OP_CLONERANGE2:
            _, cid, oid, newoid, srcoff, length, dstoff = op
            src = self._obj(cid, oid)
            data = self._read_onode(src, srcoff, length, txc)
            self._do_write(txc, cid, newoid, dstoff, data)
        elif code == OP_OMAP_CLEAR:
            _, cid, oid = op
            self._obj(cid, oid)
            base = _obase(cid, oid)
            txc.batch.rm_range(base + b"m", base + b"m\xff")
            txc.note_omap(base, ("clear",))
        elif code == OP_OMAP_SETKEYS:
            _, cid, oid, kv = op
            self._obj(cid, oid, create=True)
            txc.dirty.add((cid, oid))
            base = _obase(cid, oid)
            for k, v in kv.items():
                txc.batch.set(base + b"m" + _esc(k), v)
                txc.note_omap(base, ("set", k, v))
        elif code == OP_OMAP_RMKEYS:
            _, cid, oid, keys = op
            self._obj(cid, oid)
            base = _obase(cid, oid)
            for k in keys:
                txc.batch.rmkey(base + b"m" + _esc(k))
                txc.note_omap(base, ("rm", k))
        elif code == OP_OMAP_RMKEYRANGE:
            _, cid, oid, first, last = op
            self._obj(cid, oid)
            base = _obase(cid, oid)
            fb = first if isinstance(first, bytes) else first.encode()
            lb = last if isinstance(last, bytes) else last.encode()
            txc.batch.rm_range(base + b"m" + _esc(fb),
                               base + b"m" + _esc(lb))
            txc.note_omap(base, ("range", fb, lb))
        elif code == OP_OMAP_SETHEADER:
            _, cid, oid, header = op
            self._obj(cid, oid, create=True).omap_header = header
            txc.dirty.add((cid, oid))
        elif code == OP_MKCOLL:
            _, cid, bits = op
            if cid in self._colls:
                raise AlreadyExists("collection %s" % cid)
            self._colls[cid] = _Coll(bits)
            txc.dirty_colls.add(cid)
        elif code == OP_RMCOLL:
            _, cid = op
            c = self._colls.pop(cid, None)
            if c is None:
                raise NotFound("collection %s" % cid)
            for oid, o in c.onodes.items():
                for doff, _crc in o.blocks.values():
                    txc.released.append((doff, self.bs))
            txc.batch.rmkey(_ckey(cid))
            pref = _ocollpref(cid)
            txc.batch.rm_range(pref, pref + b"\xff")
        elif code == OP_SPLIT_COLLECTION2:
            _, cid, bits, rem, dest = op
            src = self._coll(cid)
            dst = self._coll(dest)
            mask = (1 << bits) - 1
            moving = [oid for oid in src.onodes
                      if oid.hash & mask == rem]
            for oid in moving:
                self._move_object(txc, cid, oid, dest, oid)
            src.bits = bits
            dst.bits = bits
            txc.dirty_colls.add(cid)
            txc.dirty_colls.add(dest)
        elif code == OP_COLL_MOVE_RENAME:
            _, oldcid, oldoid, newcid, newoid = op
            if oldoid not in self._coll(oldcid).onodes:
                raise NotFound("object %s/%s" % (oldcid, oldoid))
            self._move_object(txc, oldcid, oldoid, newcid, newoid)
        elif code == OP_TRY_RENAME:
            _, cid, oldoid, newoid = op
            if oldoid in self._coll(cid).onodes:
                self._move_object(txc, cid, oldoid, cid, newoid)
        else:
            raise StoreError("unknown op %r" % (code,))

    # -- data-path internals ----------------------------------------------

    def _do_write(self, txc: _TxContext, cid: coll_t, oid: hobject_t,
                  offset: int, data: bytes) -> None:
        o = self._obj(cid, oid, create=True)
        txc.dirty.add((cid, oid))
        if not data:
            return
        end = offset + len(data)
        big = len(data) > self.deferred_threshold
        bs = self.bs
        b0, b1 = offset // bs, (end - 1) // bs if end else 0
        cow: list[tuple[int, bytes]] = []     # (bidx, block image)
        pos = 0
        for b in range(b0, b1 + 1):
            lo = max(offset, b * bs) - b * bs     # in-block bounds
            hi = min(end, (b + 1) * bs) - b * bs
            seg = data[pos:pos + (hi - lo)]
            pos += hi - lo
            full = (lo == 0 and hi == bs)
            if full and big:
                cow.append((b, seg))
            else:
                # deferred small path: RMW into a WAL block image
                if full:
                    img = seg
                else:
                    cur = bytearray(self._block_content(o, b, txc))
                    cur[lo:hi] = seg
                    img = bytes(cur)
                m = o.blocks.get(b)
                doff = m[0] if m is not None else self._allocate_block()
                txc.deferred[doff] = img
                o.blocks[b] = (doff, zlib.crc32(img))
        if cow:
            self._cow_write(txc, o, cow)
        if end > o.size:
            o.size = end

    def _cow_write(self, txc: _TxContext, o: Onode,
                   cow: list[tuple[int, bytes]]) -> None:
        """COW big path: ONE allocator request for all blocks, ONE
        device write per contiguous run, all pre-commit — fresh space
        only, so a lost commit leaves the old extents intact."""
        bs = self.bs
        runs = self._allocate(len(cow) * bs)
        offs = [roff + i
                for roff, rlen in runs
                for i in range(0, rlen, bs)]
        for (b, seg), doff in zip(cow, offs):
            old = o.blocks.get(b)
            if old is not None:
                txc.released.append((old[0], bs))
                txc.deferred.pop(old[0], None)
            o.blocks[b] = (doff, zlib.crc32(seg))
        i = 0
        for roff, rlen in runs:
            n = rlen // bs
            self.dev.write(roff, b"".join(seg for _b, seg
                                          in cow[i:i + n]))
            i += n
        txc.wrote_device = True

    def _do_zero(self, txc: _TxContext, cid: coll_t, oid: hobject_t,
                 offset: int, length: int) -> None:
        """Zero = punch: whole covered blocks are dropped from the map
        (reads of holes return zeros), edges are RMW-patched."""
        o = self._obj(cid, oid, create=True)
        txc.dirty.add((cid, oid))
        if length <= 0:
            return
        end = offset + length
        bs = self.bs
        for b in range(offset // bs, ((end - 1) // bs if end else 0) + 1):
            lo = max(offset, b * bs) - b * bs
            hi = min(end, (b + 1) * bs) - b * bs
            m = o.blocks.get(b)
            if lo == 0 and hi == bs:
                if m is not None:
                    txc.released.append((m[0], bs))
                    txc.deferred.pop(m[0], None)
                    del o.blocks[b]
            elif m is not None:
                cur = bytearray(self._block_content(o, b, txc))
                cur[lo:hi] = b"\x00" * (hi - lo)
                img = bytes(cur)
                txc.deferred[m[0]] = img
                o.blocks[b] = (m[0], zlib.crc32(img))
        if end > o.size:
            o.size = end

    def _do_truncate(self, txc: _TxContext, cid: coll_t,
                     oid: hobject_t, length: int) -> None:
        o = self._obj(cid, oid)
        txc.dirty.add((cid, oid))
        if length < o.size:
            bs = self.bs
            cut = (length + bs - 1) // bs
            for b in [b for b in o.blocks if b >= cut]:
                doff, _crc = o.blocks.pop(b)
                txc.released.append((doff, bs))
                txc.deferred.pop(doff, None)
            if length % bs:
                # zero the dropped tail of the keep-block so a later
                # re-extend reads zeros there (MemStore semantics)
                b = length // bs
                if b in o.blocks:
                    cur = bytearray(self._block_content(o, b, txc))
                    cur[length % bs:] = b"\x00" * (bs - length % bs)
                    img = bytes(cur)
                    doff = o.blocks[b][0]
                    txc.deferred[doff] = img
                    o.blocks[b] = (doff, zlib.crc32(img))
        o.size = length

    def _do_remove(self, txc: _TxContext, cid: coll_t,
                   oid: hobject_t) -> None:
        # idempotent, like MemStore: replicas may delete absentees
        c = self._coll(cid)
        o = c.onodes.pop(oid, None)
        if o is None:
            return
        for doff, _crc in o.blocks.values():
            txc.released.append((doff, self.bs))
            txc.deferred.pop(doff, None)
        base = _obase(cid, oid)
        txc.batch.rm_range(base, base + b"\xff")
        txc.dirty.discard((cid, oid))

    def _do_clone(self, txc: _TxContext, cid: coll_t, oid: hobject_t,
                  newoid: hobject_t) -> None:
        """Physical copy-on-clone: every mapped source block is copied
        to fresh space pre-commit.  (The reference shares blobs via
        SharedBlob refcounts; a copy is the simple correct form — the
        in-place deferred path stays free of refcount checks.)"""
        src = self._obj(cid, oid)
        if newoid in self._coll(cid).onodes:
            self._do_remove(txc, cid, newoid)
        dst = Onode()
        dst.size = src.size
        dst.xattrs = dict(src.xattrs)
        dst.omap_header = src.omap_header
        for b in src.blocks:
            img = self._block_content(src, b, txc)
            doff = self._allocate_block()
            self.dev.write(doff, img)
            txc.wrote_device = True
            dst.blocks[b] = (doff, zlib.crc32(img))
        self._coll(cid).onodes[newoid] = dst
        txc.dirty.add((cid, newoid))
        # omap copy: committed keys merged with same-txn staged ops
        sbase = _obase(cid, oid)
        dbase = _obase(cid, newoid)
        txc.batch.rm_range(dbase + b"m", dbase + b"m\xff")
        txc.note_omap(dbase, ("clear",))
        for k, v in self._omap_items(txc, sbase).items():
            txc.batch.set(dbase + b"m" + _esc(k), v)
            txc.note_omap(dbase, ("set", k, v))

    def _move_object(self, txc: _TxContext, oldcid: coll_t,
                     oldoid: hobject_t, newcid: coll_t,
                     newoid: hobject_t) -> None:
        """Rename/move: metadata re-keys; data blocks do not move."""
        src = self._coll(oldcid)
        o = src.onodes.pop(oldoid)
        dstc = self._coll(newcid)
        prev = dstc.onodes.pop(newoid, None)
        if prev is not None:
            for doff, _crc in prev.blocks.values():
                txc.released.append((doff, self.bs))
                txc.deferred.pop(doff, None)
        dstc.onodes[newoid] = o
        obase = _obase(oldcid, oldoid)
        nbase = _obase(newcid, newoid)
        txc.batch.rm_range(nbase, nbase + b"\xff")
        txc.note_omap(nbase, ("clear",))
        for k, v in self._omap_items(txc, obase).items():
            txc.batch.set(nbase + b"m" + _esc(k), v)
            txc.note_omap(nbase, ("set", k, v))
        txc.batch.rm_range(obase, obase + b"\xff")
        txc.note_omap(obase, ("clear",))
        txc.dirty.discard((oldcid, oldoid))
        txc.dirty.add((newcid, newoid))

    def _omap_items(self, txc: _TxContext, base: bytes) -> dict:
        """Committed omap of ``base`` with this txn's staged ops
        replayed on top, keyed by unescaped key bytes."""
        items = {_unesc(bytes(k[len(base) + 1:])): v
                 for k, v in self.db.iterate(base + b"m",
                                             base + b"m\xff")}
        for op in txc.omap_ops.get(base, ()):
            if op[0] == "set":
                items[op[1]] = op[2]
            elif op[0] == "rm":
                items.pop(op[1], None)
            elif op[0] == "clear":
                items.clear()
            else:
                for k in [k for k in items if op[1] <= k < op[2]]:
                    del items[k]
        return items

    def _read_onode(self, o: Onode, offset: int, length: int,
                    txc: _TxContext | None = None) -> bytes:
        if length < 0:
            length = max(0, o.size - offset)
        length = max(0, min(length, o.size - offset))
        if length == 0:
            return b""
        end = offset + length
        bs = self.bs
        parts = []
        for b in range(offset // bs, (end - 1) // bs + 1):
            img = self._block_content(o, b, txc)
            lo = max(offset, b * bs) - b * bs
            hi = min(end, (b + 1) * bs) - b * bs
            parts.append(img[lo:hi])
        return b"".join(parts)

    # -- reads -------------------------------------------------------------

    def exists(self, cid, oid):
        c = self._colls.get(cid)
        return c is not None and oid in c.onodes

    def stat(self, cid, oid):
        return self._obj(cid, oid).size

    def read(self, cid, oid, offset=0, length=-1):
        return self._read_onode(self._obj(cid, oid), offset, length)

    def getattr(self, cid, oid, name):
        try:
            return self._obj(cid, oid).xattrs[name]
        except KeyError:
            raise NotFound("xattr %s" % name) from None

    def getattrs(self, cid, oid):
        return dict(self._obj(cid, oid).xattrs)

    def omap_get_header(self, cid, oid):
        return self._obj(cid, oid).omap_header

    def omap_get(self, cid, oid):
        self._obj(cid, oid)
        base = _obase(cid, oid)
        return {_unesc(bytes(k[len(base) + 1:])): v
                for k, v in self.db.iterate(base + b"m",
                                            base + b"m\xff")}

    def omap_get_values(self, cid, oid, keys):
        self._obj(cid, oid)
        base = _obase(cid, oid)
        out = {}
        for k in keys:
            kb = k if isinstance(k, bytes) else k.encode()
            v = self.db.get(base + b"m" + _esc(kb))
            if v is not None:
                out[k] = v
        return out

    # -- collections -------------------------------------------------------

    def list_collections(self):
        return sorted(self._colls, key=lambda c: c.name)

    def collection_exists(self, cid):
        return cid in self._colls

    def collection_empty(self, cid):
        return not self._coll(cid).onodes

    def collection_bits(self, cid):
        return self._coll(cid).bits

    def collection_list(self, cid, start=None, end=None, max_count=-1):
        objs = sorted(self._coll(cid).onodes,
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
