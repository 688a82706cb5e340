"""RADOS snapshot semantics: SnapSet, clone-on-write, snap reads,
SnapMapper bookkeeping and snap trim.

Analog of the reference's object-snapshot core:
  * SnapSet per head object (src/osd/osd_types.h SnapSet: seq, clones,
    clone_size, clone_snaps) stored here as a denc dict in the head's
    "snapset" attr;
  * PrimaryLogPG::make_writeable (src/osd/PrimaryLogPG.cc): first
    write under a newer SnapContext clones the head into an hobject
    with snap = snapc.seq before the mutation applies — the clone ops
    ride the SAME replicated Transaction as the write, so replicas
    materialise identical clones with no extra protocol;
  * find_object_context snap-read resolution (PrimaryLogPG.cc): a read
    at snapid resolves to the smallest clone covering it, or the head
    when the object is unchanged since the snap;
  * SnapMapper (src/osd/SnapMapper.cc): snap -> object index rows in
    the PG meta object's omap ("sna_" prefix), maintained inside the
    write transaction, consumed by the trimmer;
  * snap trim (PrimaryLogPG::Trimming + SnapTrimEvent): when the pool
    reports removed_snaps, the primary walks the SnapMapper rows for
    each removed snap, drops the snap from each clone (deleting clones
    whose snap set empties), and replicates the per-object updates as
    ordinary logged transactions, paced through the mClock 'snaptrim'
    class.

Head deletion with live clones leaves a whiteout head (zero-length,
"whiteout" attr) carrying the SnapSet — the snapdir object's role
(PrimaryLogPG.cc SNAPDIR) without a second object id.
"""

from __future__ import annotations

from ..store.objectstore import NOSNAP, Transaction, hobject_t
from ..utils import denc

SNAPSET_ATTR = "snapset"
WHITEOUT_ATTR = "whiteout"
SNA_PREFIX = b"sna_"


def new_snapset() -> dict:
    return {"seq": 0, "clones": [], "clone_size": {},
            "clone_snaps": {}}


def load_snapset(store, cid, ho: hobject_t) -> dict | None:
    try:
        raw = store.getattr(cid, ho, SNAPSET_ATTR)
    except Exception:
        return None
    if raw is None:
        return None
    ss = denc.decode(raw)
    ss["clone_size"] = {int(k): v
                        for k, v in ss["clone_size"].items()}
    ss["clone_snaps"] = {int(k): list(v)
                         for k, v in ss["clone_snaps"].items()}
    return ss


def snapset_bytes(ss: dict) -> bytes:
    return denc.encode({
        "seq": ss["seq"], "clones": list(ss["clones"]),
        "clone_size": {str(k): v for k, v in ss["clone_size"].items()},
        "clone_snaps": {str(k): list(v)
                        for k, v in ss["clone_snaps"].items()}})


def is_whiteout(store, cid, ho: hobject_t) -> bool:
    try:
        return store.getattr(cid, ho, WHITEOUT_ATTR) == b"1"
    except Exception:
        return False


def sna_key(snap: int, oid: str) -> bytes:
    return SNA_PREFIX + b"%016x_%s" % (snap, oid.encode())


def make_writeable(store, pg, ho: hobject_t, snapc,
                   t: Transaction) -> dict | None:
    """Clone-on-first-write: if the object exists and the write's
    SnapContext carries snaps newer than the SnapSet's seq, clone the
    head to snap=snapc.seq inside `t`, record the covered snaps, and
    index them in the SnapMapper rows.  Returns the (possibly new)
    SnapSet to be persisted by the caller's mutation, or None when no
    snapshot bookkeeping applies (no snapc ever seen)."""
    if not snapc:
        return None
    seq, snap_ids = int(snapc[0]), [int(s) for s in snapc[1]]
    ss = load_snapset(store, pg.cid, ho)
    exists = store.exists(pg.cid, ho) and not is_whiteout(
        store, pg.cid, ho)
    if ss is None:
        if not snap_ids:
            return None
        ss = new_snapset()
    newer = [s for s in snap_ids if s > ss["seq"]]
    if exists and newer and seq > ss["seq"]:
        cloneid = seq
        cho = hobject_t(ho.name, pool=ho.pool, nspace=ho.nspace,
                        key=ho.key, snap=cloneid)
        t.clone(pg.cid, ho, cho)
        size = store.stat(pg.cid, ho)
        ss["clones"].append(cloneid)
        ss["clones"].sort()
        ss["clone_size"][cloneid] = size
        ss["clone_snaps"][cloneid] = sorted(newer)
        for s in newer:
            t.omap_setkeys(pg.cid, _pgmeta(pg),
                           {sna_key(s, ho.name): b"1"})
    if seq > ss["seq"]:
        ss["seq"] = seq
    return ss


def persist_snapset(pg, ho: hobject_t, ss: dict | None,
                    t: Transaction) -> None:
    if ss is not None:
        t.setattr(pg.cid, ho, SNAPSET_ATTR, snapset_bytes(ss))


def resolve_read_snap(store, pg, oid: str, snapid: int
                      ) -> hobject_t | None:
    """find_object_context: map (oid, snapid) to the store object that
    serves the read, or None for ENOENT."""
    ho = hobject_t(oid)
    if snapid in (None, NOSNAP):
        if store.exists(pg.cid, ho) and not is_whiteout(
                store, pg.cid, ho):
            return ho
        return None
    ss = load_snapset(store, pg.cid, ho)
    c = choose_clone(ss, snapid)
    if c is None:
        return None
    if c != "head":
        return hobject_t(oid, snap=c)
    # head serves: object unchanged since that snap (or never snapped)
    if store.exists(pg.cid, ho) and not is_whiteout(
            store, pg.cid, ho):
        return ho
    return None


def choose_clone(ss: dict | None, snapid: int):
    """Pure find_object_context core (PrimaryLogPG.cc:12065-12090):
    head serves only when snapid is STRICTLY newer than snapset.seq;
    otherwise the first clone >= snapid serves if its snap list covers
    snapid; no covering clone at snapid <= seq means the object did
    not exist at that snap (ENOENT).  Returns "head", a clone id, or
    None."""
    if ss is None:
        return "head"                         # never written snapped
    if snapid > ss["seq"]:
        return "head"                         # unchanged since snap
    for c in ss["clones"]:                    # ascending
        if c >= snapid:
            snaps = ss["clone_snaps"].get(c, [c])
            if snapid in snaps or (snaps and
                                   min(snaps) <= snapid <= c):
                return c
            return None                       # gap: born later
    return None                               # born after the snap


def delete_head(store, pg, ho: hobject_t, ss: dict | None,
                t: Transaction) -> bool:
    """Head removal preserving clones: whiteout when clones remain
    (the snapdir role), plain remove otherwise.  Returns True when the
    object is fully gone (no whiteout left behind)."""
    if ss is not None and ss["clones"]:
        t.truncate(pg.cid, ho, 0)
        t.setattr(pg.cid, ho, WHITEOUT_ATTR, b"1")
        persist_snapset(pg, ho, ss, t)
        return False
    t.remove(pg.cid, ho)
    return True


def _pgmeta(pg):
    from .pg import PGMETA_OID
    return PGMETA_OID


def list_snap_objects(store, pg, snap: int) -> list[str]:
    """SnapMapper query: object names holding clones for `snap`."""
    prefix = SNA_PREFIX + b"%016x_" % snap
    try:
        rows = store.omap_get(pg.cid, _pgmeta(pg))
    except Exception:
        return []
    out = []
    for k in rows:
        if k.startswith(prefix):
            out.append(k[len(prefix):].decode())
    return sorted(out)


def trim_object(store, pg, oid: str, snap: int,
                t: Transaction) -> bool:
    """Drop `snap` from oid's clone that covers it; delete the clone
    when its snap set empties (PrimaryLogPG::trim_object).  Returns
    True if anything changed."""
    ho = hobject_t(oid)
    ss = load_snapset(store, pg.cid, ho)
    if ss is None:
        t.omap_rmkeys(pg.cid, _pgmeta(pg), [sna_key(snap, oid)])
        return False
    changed = False
    for c in list(ss["clones"]):
        snaps = ss["clone_snaps"].get(c, [])
        if snap in snaps:
            snaps.remove(snap)
            changed = True
            if not snaps:
                cho = hobject_t(oid, snap=c)
                if store.exists(pg.cid, cho):
                    t.remove(pg.cid, cho)
                ss["clones"].remove(c)
                ss["clone_size"].pop(c, None)
                ss["clone_snaps"].pop(c, None)
            else:
                ss["clone_snaps"][c] = snaps
            break
    t.omap_rmkeys(pg.cid, _pgmeta(pg), [sna_key(snap, oid)])
    if not changed:
        return False
    if not ss["clones"] and is_whiteout(store, pg.cid, ho):
        # last clone gone and head is a whiteout: drop the stub
        t.remove(pg.cid, ho)
    else:
        persist_snapset(pg, ho, ss, t)
    return True
