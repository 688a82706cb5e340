"""cls_lock: advisory object locks executed inside the OSD.

Analog of src/cls/lock/cls_lock.cc: lock state lives in an object
xattr (``lock.<name>``), and every transition is one atomic in-OSD
method — two clients racing ``lock`` cannot both win, because the
methods serialize through the primary's op pipeline.

State blob (denc dict):
    {"type": "exclusive"|"shared", "tag": str,
     "lockers": [{"locker": entity, "cookie": str, "desc": str}]}

Methods (matching cls_lock's surface):
    lock(name, type, cookie, tag, desc, renew=False)  [WR]
    unlock(name, cookie)                              [WR]
    break_lock(name, locker, cookie)                  [WR]
    get_info(name)                                    [RD]
"""

from __future__ import annotations

import time

from ...utils import denc
from . import (EBUSY, EEXIST, EINVAL, ENOENT, RD, WR, ClsError,
               MethodContext)

LOCK_XATTR = "lock."

EXCLUSIVE = "exclusive"
SHARED = "shared"


def _load(ctx: MethodContext, name: str) -> dict | None:
    blob = ctx.getxattr(LOCK_XATTR + name)
    return denc.decode(blob) if blob else None


def _store(ctx: MethodContext, name: str, st: dict | None) -> None:
    if st is None or not st["lockers"]:
        ctx.rmxattr(LOCK_XATTR + name)
    else:
        ctx.setxattr(LOCK_XATTR + name, denc.encode(st))


def lock(ctx: MethodContext, inp: dict) -> dict:
    name = inp.get("name", "")
    ltype = inp.get("type", EXCLUSIVE)
    cookie = inp.get("cookie", "")
    tag = inp.get("tag", "")
    desc = inp.get("desc", "")
    renew = bool(inp.get("renew", False))
    if not name or ltype not in (EXCLUSIVE, SHARED):
        raise ClsError(EINVAL, "bad lock args")
    st = _load(ctx, name)
    # stamp = primary-side clock at (re)acquire/renew: liveness
    # watchers (e.g. MDS standby takeover) read it from get_info to
    # detect a holder that stopped renewing (the lock_duration role)
    me = {"locker": ctx.entity, "cookie": cookie, "desc": desc,
          "stamp": time.time()}
    if st is None:
        ctx.create()
        _store(ctx, name, {"type": ltype, "tag": tag, "lockers": [me]})
        return {}
    mine = [l for l in st["lockers"]
            if l["locker"] == ctx.entity and l["cookie"] == cookie]
    if mine:
        if not renew:
            # already held by us: cls_lock returns -EEXIST unless the
            # caller asked to renew
            raise ClsError(EEXIST, "already locked by caller")
        mine[0]["stamp"] = time.time()
        _store(ctx, name, st)
        return {}
    if st["type"] == EXCLUSIVE or ltype == EXCLUSIVE:
        if st["lockers"]:
            raise ClsError(EBUSY, "held by %s"
                           % st["lockers"][0]["locker"])
    if st.get("tag", "") != tag and st["lockers"]:
        raise ClsError(EBUSY, "tag mismatch")
    st["type"] = ltype
    st["tag"] = tag
    st["lockers"].append(me)
    _store(ctx, name, st)
    return {}


def unlock(ctx: MethodContext, inp: dict) -> dict:
    name = inp.get("name", "")
    cookie = inp.get("cookie", "")
    st = _load(ctx, name)
    if st is None:
        raise ClsError(ENOENT, "no such lock")
    keep = [l for l in st["lockers"]
            if not (l["locker"] == ctx.entity
                    and l["cookie"] == cookie)]
    if len(keep) == len(st["lockers"]):
        raise ClsError(ENOENT, "not the holder")
    st["lockers"] = keep
    _store(ctx, name, st)
    return {}


def break_lock(ctx: MethodContext, inp: dict) -> dict:
    """Forcible removal of another entity's lock (admin path)."""
    name = inp.get("name", "")
    locker = inp.get("locker", "")
    cookie = inp.get("cookie", "")
    st = _load(ctx, name)
    if st is None:
        raise ClsError(ENOENT, "no such lock")
    keep = [l for l in st["lockers"]
            if not (l["locker"] == locker and l["cookie"] == cookie)]
    if len(keep) == len(st["lockers"]):
        raise ClsError(ENOENT, "no such locker")
    st["lockers"] = keep
    _store(ctx, name, st)
    return {}


def get_info(ctx: MethodContext, inp: dict) -> dict:
    st = _load(ctx, inp.get("name", ""))
    if st is None:
        return {"lockers": [], "type": "", "tag": ""}
    return {"lockers": st["lockers"], "type": st["type"],
            "tag": st.get("tag", "")}


def register(h) -> None:
    h.register_class("lock", {
        "lock": (WR, lock),
        "unlock": (WR, unlock),
        "break_lock": (WR, break_lock),
        "get_info": (RD, get_info),
    })
