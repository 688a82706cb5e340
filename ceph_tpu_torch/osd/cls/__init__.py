"""cls: in-OSD object classes (the RADOS compute extension tier).

Analog of src/osd/ClassHandler.cc:148 (dlopen + method dispatch) and
src/cls/ (the class library): services push small atomic read-modify-
write methods INTO the OSD instead of racing GETs and SETs from the
client.  A client issues ``{"op": "call", "cls": c, "method": m,
"input": {...}}`` through the normal opcode interpreter; the method
runs on the primary against the object, reads committed state, and
stages its writes into the SAME replicated transaction as the rest of
the client op — so a cls call is atomic and ordered exactly like any
other mutation.

Differences from the reference, on purpose:

* classes are Python modules registered at import (no dlopen); the
  registry shape (class -> method -> handler+flags) matches
  ClassHandler::ClassData::register_method;
* methods declare RD or WR exactly as cls_register_cxx_method does,
  and a WR method arriving on the read path is refused (-1 EPERM),
  mirroring the reference's flag check in PrimaryLogPG::do_osd_ops;
* method results are (retcode, dict) rather than bufferlists — the
  wire layer is denc dicts everywhere in this framework.

Built-in classes (the set RBD-lite + tests lean on): ``lock``
(src/cls/lock), ``refcount`` (src/cls/refcount), ``rbd`` header
methods (src/cls/rbd subset).
"""

from __future__ import annotations

from ...store.objectstore import NotFound, Transaction, coll_t, \
    hobject_t

RD = 1
WR = 2

# errno-style results used by methods (matching the reference's use)
EPERM = -1
ENOENT = -2
EIO = -5
EACCES = -13
EEXIST = -17
EINVAL = -22
EBUSY = -16
EOPNOTSUPP = -95


class ClsError(Exception):
    """Raised by a method to abort the call with an errno result."""

    def __init__(self, code: int, msg: str = ""):
        super().__init__(msg or str(code))
        self.code = code


class MethodContext:
    """cls_method_context_t analog: the handle a method uses to read
    its object and stage writes.

    Reads see COMMITTED object state (the state at the head of this
    client op); writes are staged into the op's transaction and become
    visible with the op's atomic commit.  ``entity`` is the calling
    client's name (the reference's entity_name_t from the op context),
    which lock-style classes use as locker identity."""

    def __init__(self, store, cid: coll_t, oid: hobject_t,
                 txn: Transaction | None, entity: str,
                 whiteout: bool = False,
                 cstate: dict | None = None):
        self.store = store
        self.cid = cid
        self.oid = oid
        self.txn = txn              # None on the read path
        self.entity = entity
        self._staged_remove = False
        # snapshot-deleted head: the object is logically ABSENT even
        # though a tombstone with stale xattrs sits on disk.  Reads
        # behave as not-found; the first write resurrects it clean.
        self._whiteout = whiteout
        # pool-compressed image (comp-alg xattr): reads decompress,
        # the first data write rewrites raw (mirrors the daemon's
        # _decompress_in_txn), so class methods always see logical
        # bytes, never the physical blob.  ``cstate`` is the daemon's
        # per-txn compression state — an earlier op in the SAME
        # MOSDOp may have staged a compressed or raw image this
        # method must honor.
        self._cstate = cstate if cstate is not None else {}
        self._staged_raw: bytes | None = None

    def _comp_state(self) -> tuple[str | None, bytes | None, bool]:
        """(algo, staged image, staged?) — the txn's staged state wins
        over committed attrs.  staged image may be the RAW bytes of a
        this-txn decompression/writefull (algo None) or the raw
        source of a staged compressed blob (algo set)."""
        if self.oid in self._cstate:
            st = self._cstate[self.oid]
            if st is None:
                return (None, None, True)
            return (st[0], st[1], True)
        from ...compress import OBJ_ALGO_ATTR

        raw = None if self._whiteout else self.getxattr(OBJ_ALGO_ATTR)
        return (raw.decode() if raw else None, None, False)

    def _logical_bytes(self) -> bytes | None:
        """The logical image when the object is compressed or was
        rewritten earlier in this txn; None = committed raw state is
        authoritative."""
        algo, staged, in_txn = self._comp_state()
        if staged is not None:
            return staged
        if algo is None:
            return self._staged_raw if in_txn else None
        if in_txn:
            # staged compressed without content: cannot happen (the
            # daemon always records the raw beside a staged algo),
            # but fail safe as "empty"
            return b""
        from ...compress import CompressorError, create

        blob = self.store.read(self.cid, self.oid)
        try:
            return create(algo).decompress(blob) if blob else b""
        except CompressorError as e:
            raise ClsError(EIO, str(e)) from None

    def _decompress_for_write(self) -> None:
        algo, _staged, _in_txn = self._comp_state()
        if algo is None:
            return
        from ...compress import OBJ_ALGO_ATTR, OBJ_SIZE_ATTR

        raw = self._logical_bytes() or b""
        t = self._w()
        t.truncate(self.cid, self.oid, 0)
        t.write(self.cid, self.oid, 0, len(raw), raw)
        t.rmattr(self.cid, self.oid, OBJ_ALGO_ATTR)
        t.rmattr(self.cid, self.oid, OBJ_SIZE_ATTR)
        self._cstate[self.oid] = (None, raw)
        self._staged_raw = raw

    # -- reads (cls_cxx_read / getxattr / map_get_* ) ----------------------

    def exists(self) -> bool:
        return (not self._whiteout
                and self.store.exists(self.cid, self.oid))

    def stat(self) -> int:
        if self._whiteout:
            raise ClsError(ENOENT, "object absent")
        algo, staged, in_txn = self._comp_state()
        if staged is not None:
            return len(staged)
        if algo is not None and not in_txn:
            # committed-compressed: the logical size is one xattr
            # away — no need to decompress the whole blob
            from ...compress import OBJ_SIZE_ATTR

            raw = self.getxattr(OBJ_SIZE_ATTR)
            if raw:
                return int(raw)
        try:
            raw_img = self._logical_bytes()
            if raw_img is not None:
                return len(raw_img)
            return self.store.stat(self.cid, self.oid)
        except NotFound:
            raise ClsError(ENOENT, "object absent") from None

    def read(self, offset: int = 0, length: int = -1) -> bytes:
        if self._whiteout:
            raise ClsError(ENOENT, "object absent")
        try:
            raw = self._logical_bytes()
            if raw is None:
                return self.store.read(self.cid, self.oid, offset,
                                       length)
            if length < 0:
                return raw[offset:]
            return raw[offset:offset + length]
        except NotFound:
            raise ClsError(ENOENT, "object absent") from None

    def getxattr(self, name: str) -> bytes | None:
        if self._whiteout:
            return None
        try:
            return self.store.getattr(self.cid, self.oid, name)
        except NotFound:
            return None

    def getxattrs(self) -> dict:
        if self._whiteout:
            return {}
        try:
            return self.store.getattrs(self.cid, self.oid)
        except NotFound:
            return {}

    def omap_get(self) -> dict:
        if self._whiteout:
            return {}
        try:
            return self.store.omap_get(self.cid, self.oid)
        except NotFound:
            return {}

    def omap_get_vals(self, keys) -> dict:
        if self._whiteout:
            return {}
        try:
            return self.store.omap_get_values(self.cid, self.oid, keys)
        except NotFound:
            return {}

    # -- writes (cls_cxx_write / setxattr / map_set_vals / remove) ---------

    def _w(self) -> Transaction:
        if self.txn is None:
            raise ClsError(EPERM, "write method on read path")
        return self.txn

    def create(self) -> None:
        if self._whiteout:
            # resurrect the tombstone clean: stale non-snapshot
            # xattrs and omap must not leak into the new incarnation
            # (the snapset attr survives — the clones are still live)
            t = self._w()
            keep = ("snapset",)
            try:
                stale = [n for n in
                         self.store.getattrs(self.cid, self.oid)
                         if n not in keep]
            except NotFound:
                stale = []
            for n in stale:
                t.rmattr(self.cid, self.oid, n)
            t.omap_clear(self.cid, self.oid)
            t.setattr(self.cid, self.oid, "whiteout", b"0")
            self._whiteout = False
            return
        if not self.exists():
            self._w().touch(self.cid, self.oid)

    def write(self, offset: int, data: bytes) -> None:
        self.create()
        self._decompress_for_write()
        self._w().write(self.cid, self.oid, offset, len(data), data)

    def write_full(self, data: bytes) -> None:
        self.create()
        self._decompress_for_write()
        if self.store.exists(self.cid, self.oid):
            self._w().truncate(self.cid, self.oid, 0)
        self._w().write(self.cid, self.oid, 0, len(data), data)

    def setxattr(self, name: str, val: bytes) -> None:
        self.create()
        self._w().setattr(self.cid, self.oid, name, val)

    def rmxattr(self, name: str) -> None:
        self._w().rmattr(self.cid, self.oid, name)

    def omap_set(self, kv: dict) -> None:
        self.create()
        self._w().omap_setkeys(self.cid, self.oid, kv)

    def omap_rm(self, keys) -> None:
        self._w().omap_rmkeys(self.cid, self.oid, keys)

    def truncate(self, length: int) -> None:
        self._decompress_for_write()
        self._w().truncate(self.cid, self.oid, length)

    def remove(self) -> None:
        """Request object deletion.  NOT staged directly: the write
        interpreter performs it through the snapshot-aware delete path
        (snaps.delete_head) after the method returns, so a cls
        self-delete of a snapshotted head leaves the whiteout and
        keeps its clones readable, exactly like the 'delete' op."""
        self._w()               # write-path check only
        self._staged_remove = True


class ClassHandler:
    """class/method registry (ClassHandler::ClassData)."""

    def __init__(self):
        self._classes: dict[str, dict[str, tuple[int, object]]] = {}

    def register(self, cls: str, method: str, flags: int, fn) -> None:
        self._classes.setdefault(cls, {})[method] = (flags, fn)

    def register_class(self, cls: str, methods: dict) -> None:
        for m, (flags, fn) in methods.items():
            self.register(cls, m, flags, fn)

    def lookup(self, cls: str, method: str):
        """Returns (flags, fn) or raises ClsError like the reference's
        -EOPNOTSUPP for unknown class / method."""
        c = self._classes.get(cls)
        if c is None:
            raise ClsError(EOPNOTSUPP, "no class %r" % cls)
        m = c.get(method)
        if m is None:
            raise ClsError(EOPNOTSUPP,
                           "no method %s.%s" % (cls, method))
        return m

    def is_write(self, cls: str, method: str) -> bool:
        flags, _fn = self.lookup(cls, method)
        return bool(flags & WR)

    def call(self, cls: str, method: str, ctx: MethodContext,
             inp: dict) -> tuple[int, dict]:
        try:
            flags, fn = self.lookup(cls, method)
            if (flags & WR) and ctx.txn is None:
                raise ClsError(EPERM,
                               "%s.%s requires the write path"
                               % (cls, method))
            out = fn(ctx, dict(inp or {}))
            return 0, (out or {})
        except ClsError as e:
            return e.code, {"error": str(e)}
        except Exception as e:
            # a buggy method (bad input types, corrupt blob) must
            # fail the op, never wedge it: the reference converts
            # method exceptions to -EIO the same way
            return EIO, {"error": "%s.%s: %s" % (cls, method, e)}


def default_handler() -> ClassHandler:
    """The built-in class set, loaded per OSD (the role of the
    OSD's ClassHandler + the cls .so directory)."""
    from . import fsmeta, lock, rbd, refcount, rgw

    h = ClassHandler()
    lock.register(h)
    refcount.register(h)
    rbd.register(h)
    fsmeta.register(h)
    rgw.register(h)
    return h
