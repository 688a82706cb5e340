"""Crash reports: post-mortem context that survives the dead daemon.

Reference analog: the crash module (src/pybind/mgr/crash + the
ceph-crash agent): an unhandled daemon exception writes a crash report
— stack, the tail of the high-verbosity LogRing, daemon identity,
fsid/epoch — into the daemon's OWN object store (the one artifact that
survives the process).  On the next boot the daemon ships pending
reports to the monitors, which persist them in a paxos-committed crash
table (`crash ls` / `crash info` / `crash archive`) and raise
RECENT_CRASH until the operator archives them.

Reports live in the store's 'meta' collection as `crash_<id>` objects,
so PG loading (which only walks PG collections) never sees them and a
wiped store legitimately forgets its crashes (the disk is gone; so is
its post-mortem state).
"""

from __future__ import annotations

import os
import time
import traceback

from ..store.objectstore import NotFound, Transaction, coll_t, hobject_t
from . import denc

META_COLL = coll_t("meta")
CRASH_PREFIX = "crash_"


def new_crash_id(stamp: float | None = None) -> str:
    """Unique id, timestamp-prefixed so `crash ls` sorts by age."""
    ts = time.strftime("%Y-%m-%dT%H:%M:%S",
                       time.gmtime(stamp or time.time()))
    return "%s_%s" % (ts, os.urandom(6).hex())


def ring_tail(ring, tail: int = 100) -> list[str]:
    """The last `tail` LogRing entries, formatted — the post-mortem
    high-verbosity context (shared by crash reports and the
    diagnostics bundle)."""
    if ring is None:
        return []
    entries = list(getattr(ring, "_ring", []))[-tail:]
    return ["%0.6f %2d %s: %s" % (ts, level, subsys, msg)
            for ts, subsys, level, msg in entries]


def build_report(daemon: str, exc: BaseException, fsid: str = "",
                 epoch: int = 0, ring=None, tail: int = 100) -> dict:
    """One crash report dict: identity + stack + the LogRing tail (the
    high-verbosity context the daemon gathered but never emitted)."""
    bt = traceback.format_exception(type(exc), exc, exc.__traceback__)
    return {
        "crash_id": new_crash_id(),
        "timestamp": time.time(),
        "entity": daemon,
        "fsid": fsid,
        "epoch": int(epoch),
        "exc_type": type(exc).__name__,
        "exc_msg": str(exc),
        "backtrace": [ln.rstrip("\n") for ln in bt],
        "ring_tail": ring_tail(ring, tail),
    }


def _ho(crash_id: str) -> hobject_t:
    return hobject_t(CRASH_PREFIX + crash_id)


def save_crash(store, report: dict) -> None:
    """Persist one report into the store's meta collection (the only
    durable thing a dying daemon can still do)."""
    t = Transaction()
    if not store.collection_exists(META_COLL):
        t.create_collection(META_COLL)
    ho = _ho(report["crash_id"])
    blob = denc.encode(report)
    t.touch(META_COLL, ho)
    t.write(META_COLL, ho, 0, len(blob), blob)
    store.apply_transaction(t)


def pending_crashes(store) -> list[dict]:
    """Reports waiting to be shipped to the monitors (boot path)."""
    out: list[dict] = []
    try:
        if not store.collection_exists(META_COLL):
            return out
        for ho in store.collection_list(META_COLL):
            if not ho.name.startswith(CRASH_PREFIX):
                continue
            try:
                out.append(dict(denc.decode(
                    store.read(META_COLL, ho))))
            except Exception:
                continue        # torn write mid-crash: skip, not raise
    except NotFound:
        return out
    out.sort(key=lambda r: r.get("timestamp", 0.0))
    return out


def remove_crash(store, crash_id: str) -> None:
    """The monitors acked (paxos-committed) this report: drop it."""
    if not store.collection_exists(META_COLL):
        return
    ho = _ho(crash_id)
    if store.exists(META_COLL, ho):
        t = Transaction()
        t.remove(META_COLL, ho)
        store.apply_transaction(t)


# -- daemon meta values (the same meta collection crash reports use) --------

CLOG_SEQ_OBJ = hobject_t("clog_seq")


def load_clog_seq(store) -> int:
    """The last clog sequence number this daemon's previous
    incarnation used (0 when none was ever persisted)."""
    try:
        if not store.collection_exists(META_COLL):
            return 0
        return int(denc.decode(store.read(META_COLL, CLOG_SEQ_OBJ)))
    except Exception:       # missing / torn: start from zero
        return 0


def save_clog_seq(store, seq: int) -> None:
    """Persist the daemon's last-used clog seq into its own store so
    a restart resumes ABOVE it: the LogMonitor dedups by (who, seq),
    so a rebooted daemon that restarted from 1 would have its fresh
    entries silently swallowed as resends of already-committed seqs
    (and could never supersede its pre-restart unacked ones)."""
    t = Transaction()
    if not store.collection_exists(META_COLL):
        t.create_collection(META_COLL)
    blob = denc.encode(int(seq))
    t.touch(META_COLL, CLOG_SEQ_OBJ)
    t.truncate(META_COLL, CLOG_SEQ_OBJ, 0)
    t.write(META_COLL, CLOG_SEQ_OBJ, 0, len(blob), blob)
    store.apply_transaction(t)


CLOG_INC_OBJ = hobject_t("clog_incarnation")


def new_clog_incarnation() -> int:
    """A fresh boot incarnation, strictly greater than any minted by
    an earlier boot of this daemon (wall-clock nanoseconds): a WIPED
    store loses the persisted seq floor, so the reborn daemon re-keys
    its clog entries under a new incarnation instead of replaying seqs
    the LogMonitor's (who, inc, seq) dedup already committed."""
    return time.time_ns()


def load_clog_incarnation(store) -> int:
    """The persisted boot incarnation (0 when none — a fresh or wiped
    store, where the caller mints a new one)."""
    try:
        if not store.collection_exists(META_COLL):
            return 0
        return int(denc.decode(store.read(META_COLL, CLOG_INC_OBJ)))
    except Exception:       # missing / torn: treat as fresh
        return 0


def save_clog_incarnation(store, inc: int) -> None:
    t = Transaction()
    if not store.collection_exists(META_COLL):
        t.create_collection(META_COLL)
    blob = denc.encode(int(inc))
    t.touch(META_COLL, CLOG_INC_OBJ)
    t.truncate(META_COLL, CLOG_INC_OBJ, 0)
    t.write(META_COLL, CLOG_INC_OBJ, 0, len(blob), blob)
    store.apply_transaction(t)
