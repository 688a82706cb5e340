"""CephFS-lite: a POSIX-style filesystem over RADOS.

Condensed analog of the reference's CephFS tier (src/mds/MDSRank.h
metadata service + src/client/Client.cc POSIX client), reshaped for
this framework the way RBD-lite reshapes librbd:

* METADATA lives where the MDS keeps it — in RADOS omap objects:
  one dirfrag object per directory (``dir.<ino>``, omap: name ->
  dentry {ino, type, size, mtime...}, the CDir/CDentry store,
  src/mds/CDir.cc fetch/commit), an inode allocator object
  (``mds_inotable``, the InoTable role), and per-inode backtrace
  attrs for fsck-style reverse lookup.
* FILE DATA is striped over ``data.<ino>.<objno>`` objects with the
  SAME striper the reference's Client uses (file_to_extents).
* MUTATION ATOMICITY: every single-dentry mutation (create, mkdir,
  unlink, setattr) is ONE atomic omap/cls op on the dirfrag object —
  the role the MDS journal plays for single-dentry safety.  The
  cross-directory rename is two ops (link-then-unlink, source
  cleaned up second), which a crash can leave as a benign duplicate
  dentry — the documented gap the reference closes with its
  EUpdate journal entries; fsck() sweeps them.
* MDS PRESENCE: an ``MDSDaemon`` holds the active-mds cls_lock on the
  fs root object and renews it; clients operate library-mode (the
  libcephfs-with-embedded-client shape), while the lock provides the
  single-active-MDS failover semantic for daemon deployments.

Surface: CephFS.mkdir/create/open/write/read/readdir/stat/rename/
unlink/rmdir/truncate + fsck.
"""

from __future__ import annotations

import time

from ..client.striper import FileLayout, file_to_extents
from ..utils import denc

ROOT_INO = 1
INOTABLE_OID = "mds_inotable"
FS_ROOT_OID = "fs_root"

TYPE_DIR = "dir"
TYPE_FILE = "file"


class FSError(Exception):
    pass


class NotFoundError(FSError):
    pass


class NotEmptyError(FSError):
    pass


class ExistsError(FSError):
    pass


def _dir_oid(ino: int) -> str:
    return "dir.%x" % ino


def _data_name(ino: int, objno: int) -> str:
    return "data.%x.%08x" % (ino, objno)


class CephFS:
    """Filesystem handle (libcephfs mount analog)."""

    def __init__(self, ioctx, layout: FileLayout | None = None):
        self.io = ioctx
        self.layout = layout or FileLayout(stripe_unit=1 << 20,
                                           stripe_count=1,
                                           object_size=1 << 22)

    # -- bootstrap ----------------------------------------------------------

    async def mkfs(self) -> None:
        """Initialize the fs metadata (root dirfrag + ino table)."""
        from ..client.rados import RadosError

        try:
            await self.io.exec(INOTABLE_OID, "lock", "lock",
                               {"name": "mkfs", "cookie": "mkfs"})
        except RadosError as e:
            if e.code in (-16, -17):    # held by another / by us
                raise FSError("mkfs already ran") from None
            raise
        await self.io.omap_set(INOTABLE_OID,
                               {b"next_ino": b"%d" % (ROOT_INO + 1)})
        await self.io.omap_set(_dir_oid(ROOT_INO), {})
        await self.io.write_full(_dir_oid(ROOT_INO), b"")

    async def _alloc_ino(self) -> int:
        """InoTable allocation: atomic in-OSD increment via cls."""
        out = await self.io.exec(INOTABLE_OID, "fsmeta", "alloc_ino",
                                 {})
        return int(out["ino"])

    # -- dentries -----------------------------------------------------------

    async def _lookup(self, dir_ino: int, name: str) -> dict:
        from ..client.rados import RadosError

        try:
            kv = await self.io.omap_get(_dir_oid(dir_ino))
        except RadosError:
            raise NotFoundError("no such directory") from None
        raw = kv.get(name.encode())
        if raw is None:
            raise NotFoundError(name)
        return denc.decode(raw)

    async def _resolve(self, path: str) -> tuple[int, str, dict]:
        """Returns (parent dir ino, leaf name, leaf dentry); for "/"
        returns (0, "", root-dentry)."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            return 0, "", {"ino": ROOT_INO, "type": TYPE_DIR}
        cur = ROOT_INO
        for p in parts[:-1]:
            d = await self._lookup(cur, p)
            if d["type"] != TYPE_DIR:
                raise FSError("%s: not a directory" % p)
            cur = d["ino"]
        leaf = parts[-1]
        return cur, leaf, await self._lookup(cur, leaf)

    async def _resolve_dir(self, path: str) -> int:
        _p, _n, d = await self._resolve(path)
        if d["type"] != TYPE_DIR:
            raise FSError("%s: not a directory" % path)
        return d["ino"]

    async def _parent_of(self, path: str) -> tuple[int, str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise FSError("cannot operate on /")
        parent = "/".join(parts[:-1])
        return await self._resolve_dir("/" + parent), parts[-1]

    async def _link(self, dir_ino: int, name: str, dentry: dict,
                    exclusive: bool = True) -> None:
        """One atomic dentry insert (cls: fails EEXIST inside the
        OSD, so two racing creates cannot both win)."""
        from ..client.rados import RadosError

        try:
            await self.io.exec(_dir_oid(dir_ino), "fsmeta", "link",
                               {"name": name,
                                "dentry": denc.encode(dentry),
                                "exclusive": exclusive})
        except RadosError as e:
            if e.code == -17:
                raise ExistsError(name) from None
            if e.code == -2:
                raise NotFoundError("directory removed") from None
            raise

    # -- directory ops ------------------------------------------------------

    async def mkdir(self, path: str) -> int:
        dir_ino, name = await self._parent_of(path)
        ino = await self._alloc_ino()
        await self.io.omap_set(_dir_oid(ino), {})
        await self._link(dir_ino, name,
                         {"ino": ino, "type": TYPE_DIR,
                          "mtime": time.time()})
        # backtrace for fsck (the reference's backtrace xattr)
        await self.io.setxattr(_dir_oid(ino), "parent",
                               b"%d/%s" % (dir_ino, name.encode()))
        return ino

    async def readdir(self, path: str) -> dict[str, dict]:
        ino = await self._resolve_dir(path)
        kv = await self.io.omap_get(_dir_oid(ino))
        return {k.decode(): denc.decode(v)
                for k, v in sorted(kv.items())}

    async def rmdir(self, path: str) -> None:
        from ..client.rados import RadosError

        dir_ino, name = await self._parent_of(path)
        d = await self._lookup(dir_ino, name)
        if d["type"] != TYPE_DIR:
            raise FSError("%s: not a directory" % path)
        # atomic in-OSD empty-check + tombstone: a concurrent create
        # into this directory either lands before the seal (rmdir
        # fails ENOTEMPTY) or after it (the create fails) — never a
        # silently orphaned file
        try:
            await self.io.exec(_dir_oid(d["ino"]), "fsmeta",
                               "seal_empty", {})
        except RadosError as e:
            if e.code == -39:
                raise NotEmptyError(path) from None
            raise
        await self.io.omap_rm(_dir_oid(dir_ino), [name.encode()])
        # the sealed tombstone stays: removing it would let a racing
        # create() resurrect a fresh (unreachable) dirfrag through
        # link's ctx.create().  Tombstones are a few bytes each.
        try:
            await self.io.truncate(_dir_oid(d["ino"]), 0)
        except Exception:
            pass

    # -- file ops -----------------------------------------------------------

    async def create(self, path: str) -> "FSFile":
        dir_ino, name = await self._parent_of(path)
        ino = await self._alloc_ino()
        await self._link(dir_ino, name,
                         {"ino": ino, "type": TYPE_FILE, "size": 0,
                          "mtime": time.time()})
        return FSFile(self, dir_ino, name, ino, 0)

    async def open(self, path: str) -> "FSFile":
        dir_ino, name, d = await self._resolve(path)
        if d["type"] != TYPE_FILE:
            raise FSError("%s: not a file" % path)
        return FSFile(self, dir_ino, name, d["ino"],
                      int(d.get("size", 0)))

    async def stat(self, path: str) -> dict:
        _p, _n, d = await self._resolve(path)
        return dict(d)

    async def unlink(self, path: str) -> None:
        dir_ino, name = await self._parent_of(path)
        d = await self._lookup(dir_ino, name)
        if d["type"] == TYPE_DIR:
            raise FSError("%s: is a directory" % path)
        await self.io.omap_rm(_dir_oid(dir_ino), [name.encode()])
        await self._purge_data(d["ino"], int(d.get("size", 0)))

    async def _purge_data(self, ino: int, size: int) -> None:
        import asyncio

        objs = ({e[0] for e in file_to_extents(self.layout, 0,
                                               max(size, 1))})

        async def rm(o):
            try:
                await self.io.remove(_data_name(ino, o))
            except Exception:
                pass

        await asyncio.gather(*[rm(o) for o in objs])

    async def rename(self, src: str, dst: str) -> None:
        """Two-phase: link at the destination first, unlink the
        source second — a crash in between leaves a DUPLICATE dentry
        (both resolve to the same inode), never a lost file.  The
        reference makes this atomic via the MDS journal; fsck()
        reports leftovers."""
        norm = lambda p: "/" + "/".join(x for x in p.split("/") if x)
        if norm(dst).startswith(norm(src) + "/"):
            raise FSError("cannot move a directory into itself")
        sdir, sname = await self._parent_of(src)
        d = await self._lookup(sdir, sname)
        ddir, dname = await self._parent_of(dst)
        # refuse overwrite: silently replacing the destination would
        # orphan its inode/subtree with no reclamation path
        await self._link(ddir, dname, d, exclusive=True)
        if (sdir, sname) != (ddir, dname):
            await self.io.omap_rm(_dir_oid(sdir), [sname.encode()])
        if d["type"] == TYPE_DIR:
            await self.io.setxattr(
                _dir_oid(d["ino"]), "parent",
                b"%d/%s" % (ddir, dname.encode()))

    async def fsck(self) -> dict:
        """Duplicate-dentry sweep (the rename crash window): walks
        every dirfrag, reports inodes linked more than once."""
        seen: dict[int, list[str]] = {}
        visited: set[int] = set()
        stack = [(ROOT_INO, "/")]
        while stack:
            ino, prefix = stack.pop()
            if ino in visited:          # cycle guard
                continue
            visited.add(ino)
            kv = await self.io.omap_get(_dir_oid(ino))
            for k, v in kv.items():
                d = denc.decode(v)
                p = prefix.rstrip("/") + "/" + k.decode()
                seen.setdefault(d["ino"], []).append(p)
                if d["type"] == TYPE_DIR:
                    stack.append((d["ino"], p))
        dups = {i: sorted(ps) for i, ps in seen.items()
                if len(ps) > 1}
        return {"duplicates": dups, "inodes": len(seen)}


class FSFile:
    """Open file handle (Client::Fh): striped pread/pwrite, size
    maintained in the parent dentry on flush."""

    def __init__(self, fs: CephFS, dir_ino: int, name: str,
                 ino: int, size: int):
        self.fs = fs
        self.dir_ino = dir_ino
        self.name = name
        self.ino = ino
        self.size = size

    async def pwrite(self, offset: int, data: bytes) -> None:
        import asyncio

        exts = file_to_extents(self.fs.layout, offset, len(data))
        await asyncio.gather(*[
            self.fs.io.write(_data_name(self.ino, o),
                             data[fo - offset:fo - offset + ln], oo)
            for o, oo, ln, fo in exts])
        if offset + len(data) > self.size:
            self.size = offset + len(data)
            await self._flush_size()

    async def pread(self, offset: int, length: int) -> bytes:
        import asyncio

        length = max(0, min(length, self.size - offset))
        if length == 0:
            return b""
        exts = file_to_extents(self.fs.layout, offset, length)

        async def fetch(o, oo, ln):
            try:
                return await self.fs.io.read(
                    _data_name(self.ino, o), ln, oo)
            except Exception:
                return b""

        parts = await asyncio.gather(*[fetch(o, oo, ln)
                                       for o, oo, ln, _fo in exts])
        buf = bytearray(length)
        for (o, oo, ln, fo), part in zip(exts, parts):
            part = part[:ln]
            buf[fo - offset:fo - offset + len(part)] = part
        return bytes(buf)

    async def truncate(self, size: int) -> None:
        if size < self.size:
            old = file_to_extents(self.fs.layout, size,
                                  self.size - size)
            keep = ({e[0] for e in file_to_extents(self.fs.layout, 0,
                                                   size)}
                    if size else set())
            import asyncio

            async def rm(o):
                try:
                    await self.fs.io.remove(_data_name(self.ino, o))
                except Exception:
                    pass

            await asyncio.gather(*[rm(o) for o in
                                   {e[0] for e in old} - keep])
            # EVERY kept object trims to the smallest dropped offset
            # it holds (under striping more than one object straddles
            # the cut, and a stale tail would resurface as old bytes
            # after a later re-extend)
            cut: dict[int, int] = {}
            for o, oo, _ln, fo in old:
                if o in keep and fo >= size:
                    cut[o] = min(cut.get(o, 1 << 62), oo)
            for o, off in cut.items():
                try:
                    await self.fs.io.truncate(
                        _data_name(self.ino, o), off)
                except Exception:
                    pass
        self.size = size
        await self._flush_size()

    async def _flush_size(self) -> None:
        """Size/mtime propagate to the dentry (the cap-flush role)."""
        from ..client.rados import RadosError

        try:
            await self.fs.io.exec(
                _dir_oid(self.dir_ino), "fsmeta", "update_dentry",
                {"name": self.name, "ino": self.ino,
                 "set": {"size": self.size, "mtime": time.time()}})
        except RadosError as e:
            if e.code == -2:
                # the dentry moved (rename) or was re-owned: the data
                # write stands, the stale handle just cannot stamp
                # another file's metadata
                return
            raise


class MDSDaemon:
    """Single-active-MDS presence via cls_lock on the fs root
    (mds_lock role): hold + renew; a second daemon stays standby
    until the active one lapses (break_lock on takeover)."""

    def __init__(self, ioctx, name: str = "mds.a",
                 renew_interval: float = 2.0):
        self.io = ioctx
        self.name = name
        self.renew_interval = renew_interval
        self.active = False
        self._task = None

    async def try_become_active(self) -> bool:
        from ..client.rados import RadosError

        try:
            await self.io.exec(FS_ROOT_OID, "lock", "lock",
                               {"name": "mds_active",
                                "cookie": self.name})
            self.active = True
        except RadosError as e:
            if e.code != -16:
                raise
            self.active = False
        return self.active

    async def start(self, spawn) -> None:
        await self.try_become_active()
        self._task = spawn(self._renew_loop())

    async def _renew_loop(self) -> None:
        import asyncio
        import time as _time

        while True:
            await asyncio.sleep(self.renew_interval)
            if self.active:
                try:
                    await self.io.exec(FS_ROOT_OID, "lock", "lock",
                                       {"name": "mds_active",
                                        "cookie": self.name,
                                        "renew": True})
                except Exception:
                    self.active = False
            else:
                if not await self.try_become_active():
                    await self._maybe_break_stale(_time.time())

    async def _maybe_break_stale(self, now: float) -> None:
        """Crash takeover: a holder that stopped renewing (stamp
        older than 5 renew intervals) is forcibly broken — the
        break_lock path the reference MDSMonitor uses when an active
        MDS's beacon lapses."""
        try:
            info = await self.io.exec(FS_ROOT_OID, "lock",
                                      "get_info",
                                      {"name": "mds_active"})
        except Exception:
            return
        for holder in info.get("lockers", []):
            stamp = float(holder.get("stamp", 0) or 0)
            if stamp and now - stamp > 5 * self.renew_interval:
                try:
                    await self.io.exec(
                        FS_ROOT_OID, "lock", "break_lock",
                        {"name": "mds_active",
                         "locker": holder["locker"],
                         "cookie": holder["cookie"]})
                except Exception:
                    pass
                await self.try_become_active()
                return

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        if self.active:
            try:
                await self.io.exec(FS_ROOT_OID, "lock", "unlock",
                                   {"name": "mds_active",
                                    "cookie": self.name})
            except Exception:
                pass
            self.active = False
