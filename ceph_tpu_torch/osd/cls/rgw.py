"""cls_rgw: bucket-index primitives for the S3 gateway.

Analog of src/cls/rgw/cls_rgw.cc (the in-OSD bucket index RGW relies
on): the index object's omap maps object key -> entry meta, and every
mutation is one atomic in-OSD method, so concurrent PUTs/DELETEs and
listings see a consistent index.
"""

from __future__ import annotations

from ...utils import denc
from . import EEXIST, EINVAL, ENOENT, RD, WR, ClsError, MethodContext


def bucket_init(ctx: MethodContext, inp: dict) -> dict:
    """Exclusive index creation (-EEXIST when the bucket exists)."""
    if ctx.exists():
        raise ClsError(EEXIST, "bucket exists")
    ctx.create()
    ctx.omap_set({})
    return {}


def index_put(ctx: MethodContext, inp: dict) -> dict:
    key = inp.get("key", "")
    meta = inp.get("meta")
    if not key or meta is None:
        raise ClsError(EINVAL, "bad index_put args")
    if not ctx.exists():
        raise ClsError(ENOENT, "no such bucket")
    ctx.omap_set({key.encode(): denc.encode(dict(meta))})
    return {}


def index_rm(ctx: MethodContext, inp: dict) -> dict:
    key = inp.get("key", "")
    if not ctx.exists():
        raise ClsError(ENOENT, "no such bucket")
    kb = key.encode()
    if not ctx.omap_get_vals([kb]):
        raise ClsError(ENOENT, "no such key")
    ctx.omap_rm([kb])
    return {}


def index_get(ctx: MethodContext, inp: dict) -> dict:
    """Point lookup — O(1) against the omap, where index_list would
    materialize and sort the whole bucket."""
    if not ctx.exists():
        raise ClsError(ENOENT, "no such bucket")
    key = inp.get("key", "")
    kb = key.encode()
    v = ctx.omap_get_vals([kb]).get(kb)
    if v is None:
        raise ClsError(ENOENT, "no such key")
    e = denc.decode(v)
    e["key"] = key
    return {"entry": e}


def index_list(ctx: MethodContext, inp: dict) -> dict:
    """Ordered listing with marker/prefix/max (the ListBucket
    pagination contract)."""
    if not ctx.exists():
        raise ClsError(ENOENT, "no such bucket")
    marker = inp.get("marker", "")
    prefix = inp.get("prefix", "")
    maxn = int(inp.get("max", 1000))
    out = []
    truncated = False
    for k, v in sorted(ctx.omap_get().items()):
        key = bytes(k).decode()
        if marker and key <= marker:
            continue
        if prefix and not key.startswith(prefix):
            continue
        if len(out) >= maxn:
            truncated = True
            break
        e = denc.decode(v)
        e["key"] = key
        out.append(e)
    return {"entries": out, "truncated": truncated}


def index_stat(ctx: MethodContext, inp: dict) -> dict:
    if not ctx.exists():
        raise ClsError(ENOENT, "no such bucket")
    entries = ctx.omap_get()
    total = 0
    for v in entries.values():
        try:
            total += int(denc.decode(v).get("size", 0))
        except Exception:
            pass
    return {"count": len(entries), "bytes": total}


def register(h) -> None:
    h.register_class("rgw", {
        "bucket_init": (WR, bucket_init),
        "index_put": (WR, index_put),
        "index_rm": (WR, index_rm),
        "index_get": (RD, index_get),
        "index_list": (RD, index_list),
        "index_stat": (RD, index_stat),
    })
