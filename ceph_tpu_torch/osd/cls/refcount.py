"""cls_refcount: tag-set reference counting with self-delete.

Analog of src/cls/refcount/cls_refcount.cc (the machinery RGW uses to
share one RADOS object among logical copies): refs are a set of tags
in an xattr; ``put`` on the last tag removes the object inside the
same atomic method — no client round-trip can race it.

An object with no refcount attr holds one implicit wildcard ref
(the reference's cls_refcount_put behavior): the first ``put``
removes it regardless of tag.  The wildcard applies only to
PRE-EXISTING objects: ``get`` on an absent object CREATES it holding
exactly [tag] (the cls_cas chunk_create_or_get_ref shape the dedup
plane's ref-or-store path depends on), never the wildcard.

Refs are canonical — duplicate tags are collapsed on every mutation,
so one logical ref can never require two ``put``s and the last
``put`` always reaches the self-delete.
"""

from __future__ import annotations

from ...utils import denc
from . import EINVAL, ENOENT, RD, WR, ClsError, MethodContext

REF_XATTR = "refcount"


def _canon(refs) -> list:
    """Order-preserving dedupe: the canonical form every mutation
    stores (a raw duplicated tag would survive one ``put`` and leak
    the object forever)."""
    seen: set = set()
    out: list = []
    for t in refs:
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def _load(ctx: MethodContext) -> list | None:
    blob = ctx.getxattr(REF_XATTR)
    return list(denc.decode(blob)) if blob else None


def get(ctx: MethodContext, inp: dict) -> dict:
    """Take (or re-take — idempotent) one tag ref.  Absent objects
    are CREATED holding exactly [tag] (cls_cas's
    chunk_create_or_get_ref shape).  Returns the object's COMMITTED
    size so a ref-or-store caller can decide "already stored?" in the
    same atomic method: size 0 means this get created (or raced the
    creation of) an empty chunk the caller must now write.
    ``created`` is true only for the one call that brought the object
    into existence — racing ref-or-store callers use it to decide who
    accounts the chunk as stored (all size-0 holders still write the
    identical content-addressed image)."""
    tag = inp.get("tag", "")
    if not tag:
        raise ClsError(EINVAL, "empty tag")
    created = not ctx.exists()
    size = 0 if created else ctx.stat()
    refs = _canon(_load(ctx) or [])
    if tag not in refs:
        refs.append(tag)
    ctx.setxattr(REF_XATTR, denc.encode(refs))
    return {"size": size, "created": created}


def put(ctx: MethodContext, inp: dict) -> dict:
    tag = inp.get("tag", "")
    if not tag:
        raise ClsError(EINVAL, "empty tag")
    if not ctx.exists():
        raise ClsError(ENOENT, "object absent")
    refs = _load(ctx)
    if refs is None:
        # implicit single wildcard ref
        ctx.remove()
        return {"removed": True}
    refs = _canon(refs)     # heal any legacy duplicated-tag list
    if tag not in refs:
        raise ClsError(ENOENT, "no such tag")
    refs.remove(tag)
    if refs:
        ctx.setxattr(REF_XATTR, denc.encode(refs))
        return {"removed": False}
    ctx.remove()
    return {"removed": True}


def set_refs(ctx: MethodContext, inp: dict) -> dict:
    refs = _canon(inp.get("refs", []))
    if not refs:
        raise ClsError(EINVAL, "empty ref list")
    ctx.setxattr(REF_XATTR, denc.encode(refs))
    return {}


def read(ctx: MethodContext, inp: dict) -> dict:
    return {"refs": _canon(_load(ctx) or [])}


def register(h) -> None:
    h.register_class("refcount", {
        "get": (WR, get),
        "put": (WR, put),
        "set": (WR, set_refs),
        "read": (RD, read),
    })
