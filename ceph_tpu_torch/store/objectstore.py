"""Transactional object store abstraction (L2).

Re-derivation of the reference's ObjectStore/Transaction contract
(src/os/ObjectStore.h, src/os/Transaction.h:110-155): collections
(one per PG plus 'meta') hold objects with three facets — byte data,
xattrs, and a sorted omap — and all mutation flows through
queue_transactions() applying a serialized op list atomically with
on_applied/on_commit notifications.

Objects are identified by ghobject_t analogs sorted in bitwise-reversed
hash order (the reference's hobject_t bitwise sort), which is what makes
collection_list() a stable scan for backfill/scrub.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Callable, Iterable

from ..ops.crush.hashes import str_hash_rjenkins


class StoreError(Exception):
    pass


class NotFound(StoreError):
    """ENOENT analog."""


class AlreadyExists(StoreError):
    """EEXIST analog."""


def _rev32(x: int) -> int:
    """Bit-reverse a 32-bit value (hobject_t::get_bitwise_key)."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & 0xFFFFFFFF


NOSNAP = 0xFFFFFFFFFFFFFFFE  # CEPH_NOSNAP
SNAPDIR = 0xFFFFFFFFFFFFFFFF


@dataclass(frozen=True)
class hobject_t:
    """Object id: (pool, namespace, name, key, snap) + cached ps hash.
    Sort order is bitwise (reversed-hash-major), as in hobject_t's
    bitwise comparator."""

    name: str
    pool: int = 0
    nspace: str = ""
    key: str = ""
    snap: int = NOSNAP
    hash: int = -1  # computed from key-or-name when < 0

    def __post_init__(self):
        if self.hash < 0:
            h = str_hash_rjenkins((self.key or self.name).encode())
            object.__setattr__(self, "hash", h)

    def sort_key(self) -> tuple:
        return (self.pool, _rev32(self.hash), self.nspace, self.key,
                self.name, self.snap)

    def __lt__(self, other: "hobject_t") -> bool:
        return self.sort_key() < other.sort_key()

    def __str__(self) -> str:
        return "%d/%s/%s/%d" % (self.pool, self.nspace or "-",
                                self.name, self.snap)


@dataclass(frozen=True)
class coll_t:
    """Collection id: a PG ('<pool>.<ps-hex>') or 'meta'."""

    name: str = "meta"

    def __str__(self) -> str:
        return self.name

    @staticmethod
    def pg(pool: int, ps: int) -> "coll_t":
        return coll_t("%d.%x" % (pool, ps))

    def is_pg(self) -> bool:
        return self.name != "meta"


# Transaction op codes (subset of Transaction.h:110-155 that the data
# path and PG lifecycle use; same names for greppability)
OP_NOP = 0
OP_CREATE = 7
OP_TOUCH = 9
OP_WRITE = 10
OP_ZERO = 11
OP_TRUNCATE = 12
OP_REMOVE = 13
OP_SETATTR = 14
OP_SETATTRS = 15
OP_RMATTR = 16
OP_CLONE = 17
OP_CLONERANGE2 = 30
OP_MKCOLL = 20
OP_RMCOLL = 21
OP_RMATTRS = 28
OP_OMAP_CLEAR = 31
OP_OMAP_SETKEYS = 32
OP_OMAP_RMKEYS = 33
OP_OMAP_SETHEADER = 34
OP_SPLIT_COLLECTION2 = 36
OP_OMAP_RMKEYRANGE = 37
OP_COLL_MOVE_RENAME = 38
OP_TRY_RENAME = 41


class Transaction:
    """An ordered op list applied atomically (ObjectStore::Transaction).

    Builder methods append (op, args...) tuples; stores interpret them
    in order.  Transactions are value objects — they carry no store
    references and can be encoded for a WAL or wire transfer.
    """

    def __init__(self):
        self.ops: list[tuple] = []

    def __len__(self) -> int:
        return len(self.ops)

    def empty(self) -> bool:
        return not self.ops

    def append(self, other: "Transaction") -> None:
        self.ops.extend(other.ops)

    # -- wire form (Transaction::encode/decode analog) ---------------------

    def to_wire(self) -> list:
        """denc-encodable op list: coll_t -> name str, hobject_t ->
        [name, pool, nspace, key, snap] list; other args pass through."""
        out = []
        for op in self.ops:
            row = []
            for a in op:
                if isinstance(a, coll_t):
                    row.append(("C", a.name))
                elif isinstance(a, hobject_t):
                    row.append(("H", a.name, a.pool, a.nspace, a.key,
                                a.snap))
                else:
                    row.append(a)
            out.append(row)
        return out

    @classmethod
    def from_wire(cls, rows: list) -> "Transaction":
        t = cls()
        for row in rows:
            op = []
            for a in row:
                if isinstance(a, tuple) and a and a[0] == "C":
                    op.append(coll_t(a[1]))
                elif isinstance(a, tuple) and a and a[0] == "H":
                    op.append(hobject_t(a[1], pool=a[2], nspace=a[3],
                                        key=a[4], snap=a[5]))
                else:
                    op.append(a)
            t.ops.append(tuple(op))
        return t

    # -- object data -------------------------------------------------------

    def nop(self):
        self.ops.append((OP_NOP,))

    def create(self, cid: coll_t, oid: hobject_t):
        self.ops.append((OP_CREATE, cid, oid))

    def touch(self, cid: coll_t, oid: hobject_t):
        self.ops.append((OP_TOUCH, cid, oid))

    def write(self, cid: coll_t, oid: hobject_t, offset: int,
              length: int, data: bytes):
        assert length == len(data)
        self.ops.append((OP_WRITE, cid, oid, offset, bytes(data)))

    def zero(self, cid: coll_t, oid: hobject_t, offset: int, length: int):
        self.ops.append((OP_ZERO, cid, oid, offset, length))

    def truncate(self, cid: coll_t, oid: hobject_t, length: int):
        self.ops.append((OP_TRUNCATE, cid, oid, length))

    def remove(self, cid: coll_t, oid: hobject_t):
        self.ops.append((OP_REMOVE, cid, oid))

    def clone(self, cid: coll_t, oid: hobject_t, newoid: hobject_t):
        self.ops.append((OP_CLONE, cid, oid, newoid))

    def clone_range(self, cid: coll_t, oid: hobject_t, newoid: hobject_t,
                    srcoff: int, length: int, dstoff: int):
        self.ops.append((OP_CLONERANGE2, cid, oid, newoid, srcoff,
                         length, dstoff))

    # -- xattrs ------------------------------------------------------------

    def setattr(self, cid: coll_t, oid: hobject_t, name: str, val: bytes):
        self.ops.append((OP_SETATTR, cid, oid, name, bytes(val)))

    def setattrs(self, cid: coll_t, oid: hobject_t, attrs: dict):
        self.ops.append((OP_SETATTRS, cid, oid,
                         {k: bytes(v) for k, v in attrs.items()}))

    def rmattr(self, cid: coll_t, oid: hobject_t, name: str):
        self.ops.append((OP_RMATTR, cid, oid, name))

    def rmattrs(self, cid: coll_t, oid: hobject_t):
        self.ops.append((OP_RMATTRS, cid, oid))

    # -- omap --------------------------------------------------------------

    def omap_clear(self, cid: coll_t, oid: hobject_t):
        self.ops.append((OP_OMAP_CLEAR, cid, oid))

    def omap_setkeys(self, cid: coll_t, oid: hobject_t, kv: dict):
        # keys normalize to bytes here so MemStore and KStore agree
        # across remounts (a str key would silently change type after
        # a KStore reload)
        self.ops.append((OP_OMAP_SETKEYS, cid, oid,
                         {(k if isinstance(k, bytes) else k.encode()):
                          bytes(v) for k, v in kv.items()}))

    def omap_rmkeys(self, cid: coll_t, oid: hobject_t,
                    keys: Iterable):
        self.ops.append((OP_OMAP_RMKEYS, cid, oid,
                         [k if isinstance(k, bytes) else k.encode()
                          for k in keys]))

    def omap_rmkeyrange(self, cid: coll_t, oid: hobject_t,
                        first: str, last: str):
        self.ops.append((OP_OMAP_RMKEYRANGE, cid, oid, first, last))

    def omap_setheader(self, cid: coll_t, oid: hobject_t, header: bytes):
        self.ops.append((OP_OMAP_SETHEADER, cid, oid, bytes(header)))

    # -- collections -------------------------------------------------------

    def create_collection(self, cid: coll_t, bits: int = 0):
        self.ops.append((OP_MKCOLL, cid, bits))

    def remove_collection(self, cid: coll_t):
        self.ops.append((OP_RMCOLL, cid))

    def split_collection(self, cid: coll_t, bits: int, rem: int,
                         dest: coll_t):
        self.ops.append((OP_SPLIT_COLLECTION2, cid, bits, rem, dest))

    def collection_move_rename(self, oldcid: coll_t, oldoid: hobject_t,
                               newcid: coll_t, newoid: hobject_t):
        self.ops.append((OP_COLL_MOVE_RENAME, oldcid, oldoid, newcid,
                         newoid))

    def try_rename(self, cid: coll_t, oldoid: hobject_t,
                   newoid: hobject_t):
        self.ops.append((OP_TRY_RENAME, cid, oldoid, newoid))


class ObjectStore:
    """The store contract every backend implements
    (src/os/ObjectStore.h: mount/umount, queue_transactions, reads)."""

    def __init__(self, path: str = ""):
        self.path = path

    # lifecycle
    def mkfs(self) -> None:
        raise NotImplementedError

    def mount(self) -> None:
        raise NotImplementedError

    def umount(self) -> None:
        raise NotImplementedError

    # writes
    def queue_transactions(
        self, txs: list[Transaction],
        on_applied: Callable[[], None] | None = None,
        on_commit: Callable[[], None] | None = None,
    ) -> None:
        raise NotImplementedError

    def apply_transaction(self, tx: Transaction) -> None:
        self.queue_transactions([tx])

    def statfs(self) -> dict:
        """Raw-capacity view {"total", "used", "available"} in bytes
        (store_statfs_t): the per-OSD axis `df` renders and MMgrReport
        ships.  RAM engines report against a nominal device size;
        ExtentStore reports its real block device + allocator state."""
        raise NotImplementedError

    # reads
    def exists(self, cid: coll_t, oid: hobject_t) -> bool:
        raise NotImplementedError

    def stat(self, cid: coll_t, oid: hobject_t) -> int:
        """Returns object size in bytes (NotFound if absent)."""
        raise NotImplementedError

    def read(self, cid: coll_t, oid: hobject_t, offset: int = 0,
             length: int = -1) -> bytes:
        raise NotImplementedError

    def getattr(self, cid: coll_t, oid: hobject_t, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, cid: coll_t, oid: hobject_t) -> dict:
        raise NotImplementedError

    def omap_get_header(self, cid: coll_t, oid: hobject_t) -> bytes:
        raise NotImplementedError

    def omap_get(self, cid: coll_t, oid: hobject_t) -> dict:
        raise NotImplementedError

    def omap_get_values(self, cid: coll_t, oid: hobject_t,
                        keys: Iterable[str]) -> dict:
        raise NotImplementedError

    # collections
    def list_collections(self) -> list[coll_t]:
        raise NotImplementedError

    def collection_exists(self, cid: coll_t) -> bool:
        raise NotImplementedError

    def collection_empty(self, cid: coll_t) -> bool:
        raise NotImplementedError

    def collection_bits(self, cid: coll_t) -> int:
        raise NotImplementedError

    def collection_list(self, cid: coll_t, start: hobject_t | None = None,
                        end: hobject_t | None = None,
                        max_count: int = -1) -> list[hobject_t]:
        """Objects in bitwise sort order, [start, end), up to
        max_count."""
        raise NotImplementedError


def pack_u64(v: int) -> bytes:
    return struct.pack(">Q", v)
