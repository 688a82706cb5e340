"""cls_fsmeta: atomic filesystem-metadata primitives for CephFS-lite.

The in-OSD mutations the MDS journal + CDir locking guarantee in the
reference (src/mds/CDir.cc commit, InoTable.cc alloc), collapsed to
three methods on the metadata objects:

    alloc_ino      — atomic inode-number allocation on the inotable
    link           — dentry insert, optionally exclusive (-EEXIST
                     inside the OSD: racing creates cannot both win)
    update_dentry  — read-modify-write of dentry fields (size/mtime
                     cap flush) without clobbering concurrent renames
"""

from __future__ import annotations

from ...utils import denc
from . import EEXIST, EINVAL, ENOENT, WR, ClsError, MethodContext


def alloc_ino(ctx: MethodContext, inp: dict) -> dict:
    cur = ctx.omap_get_vals([b"next_ino"]).get(b"next_ino")
    if cur is None:
        raise ClsError(ENOENT, "no inotable (mkfs first)")
    ino = int(cur)
    ctx.omap_set({b"next_ino": b"%d" % (ino + 1)})
    return {"ino": ino}


def link(ctx: MethodContext, inp: dict) -> dict:
    name = inp.get("name", "")
    blob = inp.get("dentry")
    if not name or blob is None:
        raise ClsError(EINVAL, "bad link args")
    if ctx.getxattr("sealed"):
        # rmdir sealed this dirfrag atomically: nothing may be
        # created inside a directory that is mid-removal
        raise ClsError(ENOENT, "directory removed")
    key = name.encode()
    if inp.get("exclusive", True) and ctx.omap_get_vals([key]):
        raise ClsError(EEXIST, "dentry exists")
    ctx.create()
    ctx.omap_set({key: bytes(blob)})
    return {}


def update_dentry(ctx: MethodContext, inp: dict) -> dict:
    """Size/mtime flush.  The caller's inode must still own the
    dentry — a rename + re-create of the old name must not let a
    stale handle stamp the NEW file's metadata."""
    name = inp.get("name", "")
    key = name.encode()
    cur = ctx.omap_get_vals([key]).get(key)
    if cur is None:
        raise ClsError(ENOENT, "no such dentry")
    d = denc.decode(cur)
    want_ino = inp.get("ino")
    if want_ino is not None and int(d.get("ino", -1)) != int(want_ino):
        raise ClsError(ENOENT, "dentry re-owned (stale handle)")
    d.update(dict(inp.get("set") or {}))
    ctx.omap_set({key: denc.encode(d)})
    return {}


ENOTEMPTY = -39


def seal_empty(ctx: MethodContext, inp: dict) -> dict:
    """Atomic empty-check + tombstone for rmdir: succeeds only when
    the dirfrag has no dentries, and from then on link() refuses —
    closing the check-then-remove race."""
    if not ctx.exists():
        raise ClsError(ENOENT, "no such dirfrag")
    if ctx.omap_get():
        raise ClsError(ENOTEMPTY, "directory not empty")
    ctx.setxattr("sealed", b"1")
    return {}


def register(h) -> None:
    h.register_class("fsmeta", {
        "alloc_ino": (WR, alloc_ino),
        "link": (WR, link),
        "update_dentry": (WR, update_dentry),
        "seal_empty": (WR, seal_empty),
    })
