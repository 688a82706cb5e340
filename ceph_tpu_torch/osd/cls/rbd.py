"""cls_rbd: image header methods (src/cls/rbd/cls_rbd.cc subset).

RBD-lite's header mutations move in-OSD: create-exclusive, size
changes, and snapshot-table edits each become one atomic method, so
two clients racing image create / snap create cannot interleave
(the races the reference built cls_rbd to close).  The attr layout is
the one services/rbd.py already wrote, so pre-cls images decode
unchanged.
"""

from __future__ import annotations

from ...utils import denc
from . import (EBUSY, EEXIST, EINVAL, ENOENT, RD, WR, ClsError,
               MethodContext)

SIZE_XATTR = "rbd.size"
LAYOUT_XATTR = "rbd.layout"
SNAPS_XATTR = "rbd.snaps"
PARENT_XATTR = "rbd.parent"     # denc {"image","snapid","overlap"}
_CHILD_PREFIX = b"child."       # omap child.<snapid>.<name> on parent


def create(ctx: MethodContext, inp: dict) -> dict:
    """Initialize a header object exactly once (-EEXIST on a second
    create, checked in-OSD so a raced create cannot clobber)."""
    if ctx.getxattr(SIZE_XATTR) is not None:
        raise ClsError(EEXIST, "image exists")
    size = int(inp.get("size", 0))
    layout = inp.get("layout", b"")
    if size < 0 or not layout:
        raise ClsError(EINVAL, "bad create args")
    ctx.write_full(b"")
    ctx.setxattr(SIZE_XATTR, b"%d" % size)
    ctx.setxattr(LAYOUT_XATTR, bytes(layout))
    ctx.setxattr(SNAPS_XATTR, denc.encode({}))
    return {}


def get_metadata(ctx: MethodContext, inp: dict) -> dict:
    size = ctx.getxattr(SIZE_XATTR)
    if size is None:
        raise ClsError(ENOENT, "no image header")
    layout = ctx.getxattr(LAYOUT_XATTR) or b""
    snaps_blob = ctx.getxattr(SNAPS_XATTR)
    snaps = denc.decode(snaps_blob) if snaps_blob else {}
    out = {"size": int(size), "layout": layout, "snaps": snaps}
    parent = ctx.getxattr(PARENT_XATTR)
    if parent:
        out["parent"] = denc.decode(parent)
    return out


def set_size(ctx: MethodContext, inp: dict) -> dict:
    if ctx.getxattr(SIZE_XATTR) is None:
        raise ClsError(ENOENT, "no image header")
    size = int(inp.get("size", -1))
    if size < 0:
        raise ClsError(EINVAL, "bad size")
    ctx.setxattr(SIZE_XATTR, b"%d" % size)
    return {}


def snap_add(ctx: MethodContext, inp: dict) -> dict:
    name = inp.get("name", "")
    snapid = int(inp.get("snapid", 0))
    size = int(inp.get("size", 0))
    if not name or snapid <= 0:
        raise ClsError(EINVAL, "bad snap args")
    blob = ctx.getxattr(SNAPS_XATTR)
    if blob is None:
        raise ClsError(ENOENT, "no image header")
    snaps = denc.decode(blob)
    if name in snaps:
        raise ClsError(EEXIST, "snap exists")
    snaps[name] = {"id": snapid, "size": size}
    ctx.setxattr(SNAPS_XATTR, denc.encode(snaps))
    return {}


def snap_remove(ctx: MethodContext, inp: dict) -> dict:
    name = inp.get("name", "")
    blob = ctx.getxattr(SNAPS_XATTR)
    snaps = denc.decode(blob) if blob else {}
    if name not in snaps:
        raise ClsError(ENOENT, "no such snap")
    # a snapshot with clone children cannot be removed (the
    # protect/unprotect gate of cls_rbd, collapsed to its purpose)
    pref = _CHILD_PREFIX + (b"%d." % int(snaps[name]["id"]))
    for k in ctx.omap_get():
        if bytes(k).startswith(pref):
            raise ClsError(EBUSY, "snap has clone children")
    removed = snaps.pop(name)
    ctx.setxattr(SNAPS_XATTR, denc.encode(snaps))
    return {"id": removed["id"]}


def set_parent(ctx: MethodContext, inp: dict) -> dict:
    """Mark a CLONE's header with its parent linkage."""
    if ctx.getxattr(SIZE_XATTR) is None:
        raise ClsError(ENOENT, "no image header")
    image = inp.get("image", "")
    snapid = int(inp.get("snapid", 0))
    overlap = int(inp.get("overlap", -1))
    if not image or snapid <= 0 or overlap < 0:
        raise ClsError(EINVAL, "bad parent args")
    if ctx.getxattr(PARENT_XATTR) is not None:
        raise ClsError(EEXIST, "parent already set")
    ctx.setxattr(PARENT_XATTR, denc.encode(
        {"image": image, "snapid": snapid, "overlap": overlap}))
    return {}


def remove_parent(ctx: MethodContext, inp: dict) -> dict:
    """Flatten completion: the clone stands alone."""
    if ctx.getxattr(PARENT_XATTR) is None:
        raise ClsError(ENOENT, "no parent")
    ctx.rmxattr(PARENT_XATTR)
    return {}


def child_add(ctx: MethodContext, inp: dict) -> dict:
    """Register a clone on its PARENT's header (cls_rbd children)."""
    snapid = int(inp.get("snapid", 0))
    name = inp.get("name", "")
    if snapid <= 0 or not name:
        raise ClsError(EINVAL, "bad child args")
    ctx.omap_set({_CHILD_PREFIX + b"%d.%s" % (snapid, name.encode()):
                  b"1"})
    return {}


def child_rm(ctx: MethodContext, inp: dict) -> dict:
    snapid = int(inp.get("snapid", 0))
    name = inp.get("name", "")
    key = _CHILD_PREFIX + b"%d.%s" % (snapid, name.encode())
    if not ctx.omap_get_vals([key]):
        raise ClsError(ENOENT, "no such child")
    ctx.omap_rm([key])
    return {}


def children(ctx: MethodContext, inp: dict) -> dict:
    out = []
    for k in ctx.omap_get():
        kb = bytes(k)
        if kb.startswith(_CHILD_PREFIX):
            snap_s, _sep, name = \
                kb[len(_CHILD_PREFIX):].partition(b".")
            out.append({"snapid": int(snap_s),
                        "name": name.decode()})
    return {"children": out}


def dir_add(ctx: MethodContext, inp: dict) -> dict:
    """rbd_directory registration (-EEXIST when taken, atomically)."""
    name = inp.get("name", "")
    if not name:
        raise ClsError(EINVAL, "bad name")
    if ctx.omap_get_vals([name.encode()]):
        raise ClsError(EEXIST, "name taken")
    ctx.omap_set({name.encode(): b"1"})
    return {}


def dir_remove(ctx: MethodContext, inp: dict) -> dict:
    name = inp.get("name", "")
    if not ctx.omap_get_vals([name.encode()]):
        raise ClsError(ENOENT, "no such image")
    ctx.omap_rm([name.encode()])
    return {}


def register(h) -> None:
    h.register_class("rbd", {
        "create": (WR, create),
        "get_metadata": (RD, get_metadata),
        "set_size": (WR, set_size),
        "snap_add": (WR, snap_add),
        "snap_remove": (WR, snap_remove),
        "dir_add": (WR, dir_add),
        "dir_remove": (WR, dir_remove),
        "set_parent": (WR, set_parent),
        "remove_parent": (WR, remove_parent),
        "child_add": (WR, child_add),
        "child_rm": (WR, child_rm),
        "children": (RD, children),
    })
