"""RBD-lite: block images striped over RADOS objects.

Condensed analog of src/librbd (ImageCtx + the io/ dispatch layers)
over the striper: an image is a header object
(`rbd_header.<name>`: size + layout xattrs, the role rbd_header's
omap plays) plus data objects `rbd_data.<name>.<objectno>` addressed
by Striper::file_to_extents — the same object-map shape librbd uses
(`rbd_data.<image id>.<object no>`).  Reads of unwritten extents
return zeros (sparse images); writes allocate objects on demand.

Surface: RBD.create/remove/list/open -> Image.read/write/size/resize +
snapshots (snap_create/remove/list/set/rollback on RADOS selfmanaged
snaps — the librbd snapshot model: every image snapshot is a
selfmanaged pool snapid recorded in the header, writes carry the
image's SnapContext so data objects clone on first write,
librbd::Operations<I>::snap_create / snap_rollback).  Clones /
journaling / mirroring remain out of this slice."""

from __future__ import annotations

from ..client.striper import FileLayout, file_to_extents
from ..utils import denc

HEADER_PREFIX = "rbd_header."
DATA_PREFIX = "rbd_data."
DIR_OID = "rbd_directory"
SIZE_XATTR = "rbd.size"
LAYOUT_XATTR = "rbd.layout"
SNAPS_XATTR = "rbd.snaps"


class RBDError(Exception):
    pass


class RBD:
    """Pool-level image operations (librbd::RBD)."""

    def __init__(self, ioctx):
        self.io = ioctx

    async def create(self, name: str, size: int,
                     layout: FileLayout | None = None) -> None:
        """Header + directory registration ride cls_rbd methods: the
        exists check happens INSIDE the OSD, so two racing creates
        cannot both win (the race src/cls/rbd exists to close)."""
        from ..client.rados import RadosError

        layout = layout or FileLayout(stripe_unit=1 << 22,
                                      stripe_count=1,
                                      object_size=1 << 22)
        hdr = HEADER_PREFIX + name
        try:
            await self.io.exec(hdr, "rbd", "create",
                               {"size": size,
                                "layout": layout.encode()})
        except RadosError as e:
            if e.code == -17:
                raise RBDError("image %r exists" % name) from None
            raise
        # image directory: one omap row per image (rbd_directory)
        try:
            await self.io.exec(DIR_OID, "rbd", "dir_add",
                               {"name": name})
        except RadosError as e:
            if e.code != -17:
                raise

    async def list(self) -> list[str]:
        try:
            kv = await self.io.omap_get(DIR_OID)
        except Exception:
            return []
        return sorted(k.decode() for k in kv)

    async def remove(self, name: str) -> None:
        img = await self.open(name)
        # librbd refuses to remove an image that still has snapshots
        # or registered clone children — deleting a parent under its
        # clones is cross-image data loss
        kids = await self.io.exec(HEADER_PREFIX + name, "rbd",
                                  "children", {})
        if kids.get("children"):
            raise RBDError("image %r has clone children" % name)
        if img.snaps:
            raise RBDError("image %r has snapshots" % name)
        exts = file_to_extents(img.layout, 0, max(img._size, 1))
        import asyncio

        async def rm(o):
            try:
                await self.io.remove(img._data_name(o))
            except Exception:
                pass

        await asyncio.gather(*[rm(o) for o in
                               {e[0] for e in exts}])
        from ..client.rados import RadosError

        if img.parent is not None:
            # deregister from the parent so its snap unpins
            try:
                await self.io.exec(
                    HEADER_PREFIX + img.parent.name, "rbd",
                    "child_rm", {"snapid": img.parent_snapid,
                                 "name": name})
            except RadosError as e:
                if e.code != -2:
                    raise
        try:
            await self.io.remove(HEADER_PREFIX + name)
        except RadosError as e:
            if e.code != -2:
                raise
        try:
            await self.io.exec(DIR_OID, "rbd", "dir_remove",
                               {"name": name})
        except RadosError as e:
            if e.code != -2:
                raise

    async def clone(self, parent_name: str, parent_snap: str,
                    clone_name: str) -> None:
        """Snapshot-parent clone (librbd::clone /
        DeepCopyRequest-free COW path): the clone starts as a header
        pointing at (parent, snapid, overlap); data objects
        materialize on first write (copy-up) and reads fall through
        to the parent below the overlap."""
        from ..client.rados import RadosError

        parent = await self.open(parent_name)
        rec = parent.snaps.get(parent_snap)
        if rec is None:
            raise RBDError("no snap %r on %r"
                           % (parent_snap, parent_name))
        sid, psize = int(rec["id"]), int(rec["size"])
        hdr = HEADER_PREFIX + clone_name
        try:
            await self.io.exec(hdr, "rbd", "create",
                               {"size": psize,
                                "layout": parent.layout.encode()})
        except RadosError as e:
            if e.code == -17:
                raise RBDError("image %r exists"
                               % clone_name) from None
            raise
        # registration order matters for crash safety: the child
        # link on the PARENT lands first, so from the moment a clone
        # header could carry a parent pointer, the snap is already
        # unremovable; a crash in between leaves only a stray child
        # entry (unpinnable via child_rm), never a clone whose parent
        # snap can vanish under it
        await self.io.exec(HEADER_PREFIX + parent_name, "rbd",
                           "child_add", {"snapid": sid,
                                         "name": clone_name})
        try:
            await self.io.exec(hdr, "rbd", "set_parent",
                               {"image": parent_name, "snapid": sid,
                                "overlap": psize})
        except Exception:
            try:
                await self.io.exec(HEADER_PREFIX + parent_name,
                                   "rbd", "child_rm",
                                   {"snapid": sid,
                                    "name": clone_name})
            except Exception:
                pass
            raise
        try:
            await self.io.exec(DIR_OID, "rbd", "dir_add",
                               {"name": clone_name})
        except RadosError as e:
            if e.code != -17:
                raise

    async def open(self, name: str) -> "Image":
        hdr = HEADER_PREFIX + name
        try:
            meta = await self.io.exec(hdr, "rbd", "get_metadata", {})
            size = int(meta["size"])
            layout = FileLayout.decode(bytes(meta["layout"]))
        except Exception:
            raise RBDError("image %r does not exist" % name)
        snaps = dict(meta.get("snaps") or {})
        parent_meta = meta.get("parent")
        # each image gets its OWN IoCtx: snap context and read-snap
        # state are per-image (a shared ioctx would let one image's
        # _apply_snapc clobber another's write snapc)
        from ..client.rados import IoCtx
        img_io = IoCtx(self.io.client, self.io.pool_id)
        img = Image(img_io, name, size, layout, snaps)
        if parent_meta:
            pimg = await self.open(parent_meta["image"])
            # route the parent handle's reads at the snapshot
            psnap = next((n for n, r in pimg.snaps.items()
                          if int(r["id"]) == int(parent_meta
                                                 ["snapid"])), None)
            if psnap is not None:
                pimg.set_snap(psnap)
                img.parent = pimg
                img.parent_snapid = int(parent_meta["snapid"])
                img.overlap = int(parent_meta["overlap"])
        img._apply_snapc()
        return img


class Image:
    """One open image (librbd::Image): offset/length block I/O."""

    def __init__(self, ioctx, name: str, size: int,
                 layout: FileLayout, snaps: dict | None = None):
        self.io = ioctx
        self.name = name
        self._size = size
        self.layout = layout
        # name -> {"id": selfmanaged snapid, "size": image size then}
        self.snaps: dict = snaps or {}
        # clone linkage (parent Image handle pinned at the snap,
        # overlap = parent size at clone time); None = standalone
        self.parent: "Image | None" = None
        self.parent_snapid = 0
        self.overlap = 0

    def _data_name(self, objectno: int) -> str:
        return "%s%s.%016x" % (DATA_PREFIX, self.name, objectno)

    def size(self) -> int:
        return self._size

    # -- snapshots (librbd snap_create/rollback over selfmanaged
    # RADOS snaps; every data-object write carries the image snapc) --

    def _apply_snapc(self) -> None:
        ids = sorted((int(s["id"]) for s in self.snaps.values()),
                     reverse=True)
        self.io.set_selfmanaged_snapc(ids[0] if ids else 0, ids)

    def snap_list(self) -> dict[str, dict]:
        return dict(self.snaps)

    async def snap_create(self, snapname: str) -> int:
        """Selfmanaged snapid from the mon, then the header's snap
        table is edited by cls_rbd.snap_add — the exists check runs
        in-OSD, so racing snap_creates cannot both record."""
        from ..client.rados import RadosError

        if snapname in self.snaps:
            raise RBDError("snap %r exists" % snapname)
        sid = await self.io.selfmanaged_snap_create()
        try:
            await self.io.exec(HEADER_PREFIX + self.name, "rbd",
                               "snap_add", {"name": snapname,
                                            "snapid": sid,
                                            "size": self._size})
        except RadosError as e:
            # losing a snap_add race must not leak the allocated
            # snapid into the pool's snap bookkeeping forever
            try:
                await self.io.selfmanaged_snap_remove(sid)
            except Exception:
                pass
            if e.code == -17:
                raise RBDError("snap %r exists" % snapname) from None
            raise
        self.snaps[snapname] = {"id": sid, "size": self._size}
        self._apply_snapc()
        return sid

    async def snap_remove(self, snapname: str) -> None:
        rec = self.snaps.get(snapname)
        if rec is None:
            raise RBDError("no snap %r" % snapname)
        from ..client.rados import RadosError

        # clone children pin their parent snap: refuse before any
        # cluster-side state changes (the cls snap_remove gate
        # re-checks inside the atomic header edit)
        kids = await self.io.exec(HEADER_PREFIX + self.name, "rbd",
                                  "children", {})
        if any(int(c["snapid"]) == int(rec["id"])
               for c in kids.get("children", [])):
            raise RBDError("snap %r has clone children" % snapname)
        # cluster-side removal next: if the mon command fails the
        # header still records the snapid and removal can be retried
        # (dropping the record first would leak the clones forever)
        await self.io.selfmanaged_snap_remove(int(rec["id"]))
        try:
            await self.io.exec(HEADER_PREFIX + self.name, "rbd",
                               "snap_remove", {"name": snapname})
        except RadosError as e:
            if e.code != -2:
                # transient failure: the header still records the
                # snap — surface it so the caller retries rather
                # than silently resurrecting a dead snapid on reopen
                raise
        self.snaps.pop(snapname, None)
        self._apply_snapc()

    def set_snap(self, snapname: str | None) -> None:
        """Route reads to a snapshot (librbd snap_set); None = head.
        The image size follows the snapshot's recorded size, so reads
        through a pinned handle are bounded by what existed AT the
        snap — a later head resize must not clamp (or extend) them."""
        if snapname is None:
            self.io.set_read_snap(None)
            if getattr(self, "_head_size", None) is not None:
                self._size = self._head_size
                self._head_size = None
            return
        rec = self.snaps.get(snapname)
        if rec is None:
            raise RBDError("no snap %r" % snapname)
        if getattr(self, "_head_size", None) is None:
            self._head_size = self._size
        self._size = int(rec["size"])
        self.io.set_read_snap(int(rec["id"]))

    async def snap_rollback(self, snapname: str) -> None:
        """Restore head contents from a snapshot
        (librbd::Operations::snap_rollback): every data object is
        rewritten from its state at the snap (absent then = removed
        now), then the size reverts."""
        import asyncio

        rec = self.snaps.get(snapname)
        if rec is None:
            raise RBDError("no snap %r" % snapname)
        sid = int(rec["id"])
        snap_size = int(rec["size"])
        span = max(self._size, snap_size)
        objs = ({e[0] for e in file_to_extents(self.layout, 0, span)}
                if span else set())
        osz = self.layout.object_size

        async def roll(o):
            name = self._data_name(o)
            self.io.set_read_snap(sid)
            try:
                old = await self.io.read(name, osz, 0)
            except Exception:
                old = b""
            finally:
                self.io.set_read_snap(None)
            if old:
                await self.io.write_full(name, old)
            else:
                try:
                    await self.io.remove(name)
                except Exception:
                    pass

        await asyncio.gather(*[roll(o) for o in sorted(objs)])
        self._size = snap_size
        await self.io.exec(HEADER_PREFIX + self.name, "rbd",
                           "set_size", {"size": snap_size})

    async def resize(self, new_size: int) -> None:
        if new_size < self._size:
            # librbd shrink: drop whole objects past the new end AND
            # truncate the boundary object — a stale tail would
            # resurface as old data after a later grow (sparse reads
            # must see zeros)
            import asyncio

            old = file_to_extents(self.layout, new_size,
                                  self._size - new_size)
            keep = ({e[0] for e in
                     file_to_extents(self.layout, 0, new_size)}
                    if new_size > 0 else set())

            async def rm(o):
                try:
                    await self.io.remove(self._data_name(o))
                except Exception:
                    pass

            await asyncio.gather(*[
                rm(o) for o in {e[0] for e in old} - keep])
            # every kept straddling object trims to its smallest
            # dropped offset (striping can cut through several)
            cut: dict[int, int] = {}
            for o, oo, _ln, fo in old:
                if o in keep and fo >= new_size:
                    cut[o] = min(cut.get(o, 1 << 62), oo)
            for o, off in cut.items():
                try:
                    await self.io.truncate(self._data_name(o), off)
                except Exception:
                    pass
        self._size = new_size
        await self.io.exec(HEADER_PREFIX + self.name, "rbd",
                           "set_size", {"size": new_size})

    async def _copy_up(self, objectno: int) -> None:
        """librbd copy-up: materialize a clone object from the
        parent's SNAPSHOT before a partial write, so the untouched
        remainder of the block survives.  Reads the parent's DATA
        OBJECT directly (striping-exact for any stripe_count — the
        clone shares the parent's layout, so object numbering and
        interleave agree byte for byte)."""
        from ..client.rados import ObjectNotFound

        try:
            block = await self.parent.io.read(
                self.parent._data_name(objectno),
                self.layout.object_size, 0)
        except ObjectNotFound:
            return                      # parent never wrote it
        if block:
            await self.io.write_full(self._data_name(objectno),
                                     block)

    async def write(self, offset: int, data: bytes) -> None:
        if offset + len(data) > self._size:
            raise RBDError("write past image end (%d > %d)"
                           % (offset + len(data), self._size))
        import asyncio

        from ..client.rados import ObjectNotFound

        exts = file_to_extents(self.layout, offset, len(data))
        osz = self.layout.object_size
        # group per object: one copy-up decision per object, and the
        # object's extents apply IN ORDER after it (two concurrent
        # copy-ups in one gather could clobber each other's writes)
        by_obj: dict[int, list] = {}
        for o, oo, ln, fo in exts:
            by_obj.setdefault(o, []).append((oo, ln, fo))

        async def put(o, pieces):
            whole = any(oo == 0 and ln == osz for oo, ln, _ in pieces)
            if self.parent is not None and not whole:
                # copy-up no-ops when the parent never wrote the
                # object, so no overlap math is needed here (file
                # offsets and object numbers interleave under
                # striping — the object read is the exact unit)
                try:
                    await self.io.stat(self._data_name(o))
                except ObjectNotFound:
                    await self._copy_up(o)
            for oo, ln, fo in pieces:
                await self.io.write(
                    self._data_name(o),
                    data[fo - offset:fo - offset + ln], oo)

        await asyncio.gather(*[put(o, pieces)
                               for o, pieces in by_obj.items()])

    async def read(self, offset: int, length: int) -> bytes:
        length = max(0, min(length, self._size - offset))
        if length == 0:
            return b""
        import asyncio

        from ..client.rados import ObjectNotFound

        exts = file_to_extents(self.layout, offset, length)

        async def fetch(o, oo, ln, fo):
            try:
                return await self.io.read(self._data_name(o), ln, oo)
            except ObjectNotFound:
                # COW fall-through: below the overlap the parent's
                # snapshot serves the bytes; past it, sparse zeros
                if self.parent is not None and fo < self.overlap:
                    cov = min(ln, self.overlap - fo)
                    return await self.parent.read(fo, cov)
                return b""
            except Exception:
                return b""     # unwritten extent: sparse zeros

        parts = await asyncio.gather(*[fetch(o, oo, ln, fo)
                                       for o, oo, ln, fo in exts])
        buf = bytearray(length)
        for (o, oo, ln, fo), part in zip(exts, parts):
            part = part[:ln]
            buf[fo - offset:fo - offset + len(part)] = part
        return bytes(buf)

    async def flatten(self) -> None:
        """Sever the parent link by materializing every still-COW
        object below the overlap (librbd::Operations::flatten)."""
        if self.parent is None:
            raise RBDError("image has no parent")
        import asyncio

        from ..client.rados import ObjectNotFound

        objs = ({e[0] for e in file_to_extents(self.layout, 0,
                                               self.overlap)}
                if self.overlap else set())
        osz = self.layout.object_size

        async def mat(o):
            try:
                await self.io.stat(self._data_name(o))
            except ObjectNotFound:
                await self._copy_up(o)

        await asyncio.gather(*[mat(o) for o in sorted(objs)])
        await self.io.exec(HEADER_PREFIX + self.name, "rbd",
                           "remove_parent", {})
        await self.io.exec(HEADER_PREFIX + self.parent.name, "rbd",
                           "child_rm", {"snapid": self.parent_snapid,
                                        "name": self.name})
        self.parent = None
        self.parent_snapid = 0
        self.overlap = 0

    async def discard(self, offset: int, length: int) -> None:
        """Zero a range by dropping fully-covered objects and zeroing
        partial ones (librbd discard).  On a clone, objects under the
        parent overlap are ZEROED, never removed — removal would
        resurrect the parent's bytes through the COW fall-through."""
        import asyncio

        exts = file_to_extents(self.layout, offset, length)
        full, partial = [], []
        osz = self.layout.object_size
        for o, oo, ln, fo in exts:
            covered = (self.parent is not None
                       and fo - oo < self.overlap)
            if oo == 0 and ln == osz and not covered:
                full.append(o)
            else:
                partial.append((ln, fo))

        async def rm(o):
            try:
                await self.io.remove(self._data_name(o))
            except Exception:
                pass

        await asyncio.gather(*[rm(o) for o in full])
        # partial zeroing routes through write() so clone objects get
        # their copy-up before the zeros land
        await asyncio.gather(*[self.write(fo, b"\0" * ln)
                               for ln, fo in partial])
