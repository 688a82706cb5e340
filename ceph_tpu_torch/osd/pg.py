"""PG: placement group state, log, and peering for the replicated path.

Condensed re-derivation of the reference's per-PG machinery:

* PGLog (src/osd/PGLog.h): an ordered list of versioned entries
  (eversion = (epoch, ver)) used for delta recovery — a peer whose
  last_update is inside our log tail recovers only the objects named
  by the newer entries; one that diverged or fell behind the tail gets
  backfill (full object set).
* PeeringState (src/osd/PeeringState.h:587): the full boost::statechart
  is collapsed to the GetInfo -> GetLog -> Active path a fresh primary
  walks: query every acting peer's info+log (MOSDPGQuery/MOSDPGLog),
  pick the authoritative log (highest last_update — the reference's
  find_best_info), merge it, compute per-peer missing sets, activate,
  then recover by pushing whole objects (MOSDPGPush) — the
  log-based-recovery flow of doc/dev/osd_internals/log_based_pg.rst.
* Op execution (PrimaryLogPG::do_osd_ops, PrimaryLogPG.cc:5969): the
  opcode interpreter over the object store, here a name-keyed dict of
  handlers producing one ObjectStore Transaction per client op.

Durability: the log + info persist in the pgmeta object's omap
(coll_t pgmeta, like PG::prepare_write_info) within the same
transaction as the data mutation, so a restarted OSD replays exact
state.
"""

from __future__ import annotations

import time

from ..store.objectstore import Transaction, coll_t, hobject_t
from ..utils import denc

PGMETA_OID = hobject_t("__pgmeta__")


def ev_key(ev: tuple[int, int]) -> bytes:
    return b"%010d.%010d" % tuple(ev)


class LogEntry:
    """One pg-log record (pg_log_entry_t)."""

    __slots__ = ("op", "oid", "version", "prior_version")

    MODIFY = "modify"
    DELETE = "delete"

    def __init__(self, op: str, oid: str, version: tuple[int, int],
                 prior_version: tuple[int, int]):
        self.op = op
        self.oid = oid
        self.version = tuple(version)
        self.prior_version = tuple(prior_version)

    def to_wire(self) -> list:
        return [self.op, self.oid, list(self.version),
                list(self.prior_version)]

    @classmethod
    def from_wire(cls, w: list) -> "LogEntry":
        return cls(w[0], w[1], (w[2][0], w[2][1]), (w[3][0], w[3][1]))


class PGLog:
    """Bounded, ordered op log (src/osd/PGLog.h)."""

    def __init__(self):
        self.entries: list[LogEntry] = []
        self.tail: tuple[int, int] = (0, 0)  # versions <= tail trimmed

    @property
    def head(self) -> tuple[int, int]:
        return self.entries[-1].version if self.entries else self.tail

    def append(self, e: LogEntry) -> None:
        self.entries.append(e)

    def trim(self, to: tuple[int, int]) -> list[LogEntry]:
        """Drop entries <= to; returns them for omap cleanup."""
        dropped = [e for e in self.entries if e.version <= to]
        if dropped:
            self.entries = [e for e in self.entries if e.version > to]
            self.tail = max(self.tail, dropped[-1].version)
        return dropped

    def objects_since(self, since: tuple[int, int]) -> dict[str, str]:
        """oid -> final op for entries newer than `since` (the missing
        set a peer at `since` must recover)."""
        out: dict[str, str] = {}
        for e in self.entries:
            if e.version > since:
                out[e.oid] = e.op
        return out


class PGInfo:
    """pg_info_t subset: identity + log bounds."""

    def __init__(self, pool: int, ps: int):
        self.pool = pool
        self.ps = ps
        self.last_update: tuple[int, int] = (0, 0)
        self.last_complete: tuple[int, int] = (0, 0)
        self.log_tail: tuple[int, int] = (0, 0)
        self.same_interval_since = 0
        # epoch of the last completed activation: past intervals
        # older than this are settled history (pg_info_t
        # last_epoch_started, PeeringState.h:587 neighborhood)
        self.last_epoch_started = 0

    def to_wire(self) -> dict:
        return {"pool": self.pool, "ps": self.ps,
                "last_update": list(self.last_update),
                "last_complete": list(self.last_complete),
                "log_tail": list(self.log_tail),
                "same_interval_since": self.same_interval_since,
                "last_epoch_started": self.last_epoch_started}

    @classmethod
    def from_wire(cls, d: dict) -> "PGInfo":
        info = cls(d["pool"], d["ps"])
        info.last_update = tuple(d["last_update"])
        info.last_complete = tuple(d["last_complete"])
        info.log_tail = tuple(d["log_tail"])
        info.same_interval_since = d["same_interval_since"]
        info.last_epoch_started = d.get("last_epoch_started", 0)
        return info


class PGStats:
    """Cumulative per-PG I/O + recovery counters (pg_stat_t's counter
    slice, object_stat_sum_t role): the primary accumulates these on
    its op/recovery paths and ships them in the periodic mgr report
    (the MPGStats flow); the mgr's PGMap derives rates from deltas
    between two reports.  Counters are NOT persisted — a restarted or
    newly promoted primary restarts from zero, and the rate derivation
    clamps the resulting negative delta to 0 (exactly the reference's
    reported-epoch reset behavior)."""

    COUNTERS = ("read_ops", "read_bytes", "write_ops", "write_bytes",
                "recovery_ops", "recovery_bytes")

    __slots__ = COUNTERS

    def __init__(self):
        for c in self.COUNTERS:
            setattr(self, c, 0)

    def note_read(self, nbytes: int) -> None:
        self.read_ops += 1
        self.read_bytes += int(nbytes)

    def note_write(self, nbytes: int) -> None:
        self.write_ops += 1
        self.write_bytes += int(nbytes)

    def note_recovery(self, nobjects: int, nbytes: int = 0) -> None:
        self.recovery_ops += int(nobjects)
        self.recovery_bytes += int(nbytes)

    def to_wire(self) -> dict:
        return {c: getattr(self, c) for c in self.COUNTERS}


# PG lifecycle states (PeeringState.h state names, flattened)
STATE_INITIAL = "initial"
STATE_PEERING = "peering"
STATE_ACTIVE = "active"
STATE_REPLICA = "replica"  # ReplicaActive / Stray


class PG:
    """One placement group on one OSD."""

    def __init__(self, osd, pool_id: int, ps: int):
        self.osd = osd                      # owning daemon
        self.pool_id = pool_id
        self.ps = ps
        self.cid = coll_t.pg(pool_id, ps)
        self.info = PGInfo(pool_id, ps)
        self.log = PGLog()
        self.state = STATE_INITIAL
        self.up: list[int] = []
        self.acting: list[int] = []
        self.primary = -1
        self.missing: dict[str, str] = {}       # oid -> op to recover
        self.peer_missing: dict[int, dict[str, str]] = {}
        self.peer_info: dict[int, PGInfo] = {}
        self.waiting_for_active: list = []      # queued ops
        self.waiting_for_peers: dict[int, dict] = {}   # peering round
        self.recovering: set[str] = set()
        self.in_flight: dict[int, dict] = {}    # repop tid -> state
        # PastIntervals (src/osd/osd_types.h PastIntervals): one
        # record per acting-set interval since last_epoch_started:
        # {"first", "last", "up", "acting", "primary", "rw"} where
        # "rw" = the interval could have served writes (its primary's
        # up_thru reached the interval, enough acting members).
        # Cleared on activation; peering must hear from (or rule out)
        # every rw interval before claiming authority.
        self.past_intervals: list[dict] = []
        self.peering_blocked = False   # a prior rw interval has no
        #                                live member: cannot activate
        self.waiting_up_thru = 0       # epoch our up_thru must reach
        # conn -> backoff id: clients told to stop resending at this
        # PG (MOSDBackoff); released when parked ops requeue
        self.backoffs: dict = {}
        # reqid dup-detection journal (PrimaryLogPG osd_reqid_t dedup,
        # PGLog pg_log_dup_t role): (client entity, tid) -> the reply
        # already sent, so a timeout-triggered RESEND of a
        # non-idempotent op (append-style cls methods) is answered
        # from the journal instead of re-executed.  Bounded FIFO,
        # persisted in the pgmeta omap within the same transaction as
        # the write it journals.
        self.reqid_journal: dict[tuple[str, int], dict] = {}
        self.reqid_order: list[tuple[str, int]] = []
        # cumulative client-I/O + recovery counters this primary
        # accumulated (PGStats above); reported to the mgr
        self.stats = PGStats()
        # integrity plane (pg_stat_t last_scrub_stamp/
        # last_deep_scrub_stamp + the inconsistent-object residual):
        # stamps seed to creation time so a fresh cluster does not
        # storm itself with due-immediately scrubs; the periodic
        # scheduler (osd_scrub_interval / osd_deep_scrub_interval)
        # advances them, scrub_errors is the residual count the stat
        # row ships into OSD_SCRUB_ERRORS / PG_DAMAGED health —
        # cleared only by a repair scrub draining it to zero
        self.last_scrub_stamp = time.time()
        self.last_deep_scrub_stamp = self.last_scrub_stamp
        self.scrub_errors = 0

    # -- identity ----------------------------------------------------------

    @property
    def pgid(self) -> str:
        return "%d.%x" % (self.pool_id, self.ps)

    def is_primary(self) -> bool:
        return self.primary == self.osd.whoami

    # -- durable state -----------------------------------------------------

    def persist_meta(self, t: Transaction) -> None:
        t.omap_setkeys(self.cid, PGMETA_OID, {
            b"info": denc.encode(self.info.to_wire()),
            b"past_intervals": denc.encode(self.past_intervals),
        })

    def persist_log_entry(self, t: Transaction, e: LogEntry) -> None:
        t.omap_setkeys(self.cid, PGMETA_OID, {
            b"log." + ev_key(e.version): denc.encode(e.to_wire()),
        })

    def persist_scrub(self, t: Transaction) -> None:
        """Scrub stamps + residual error count, durable so a restart
        neither re-scrubs immediately nor forgets an unrepaired
        inconsistency."""
        t.omap_setkeys(self.cid, PGMETA_OID, {
            b"scrub": denc.encode([self.last_scrub_stamp,
                                   self.last_deep_scrub_stamp,
                                   self.scrub_errors]),
        })

    # -- reqid dup journal -------------------------------------------------

    @staticmethod
    def _reqid_row(src: str, tid: int) -> bytes:
        return b"dup.%s.%d" % (src.encode(), int(tid))

    def record_reqid(self, t, src: str, tid,
                     result: int, outs: list, version: int) -> None:
        """Journal one completed client write's reply, riding the same
        transaction as the write itself (atomic: a replayed store
        never has the mutation without its dup row or vice versa).

        `t` is one Transaction or a collection of them: the EC delta
        path passes EVERY per-position shard transaction, so the dup
        row replicates to each member and a promoted replica answers
        a post-primary-loss resend from its own store."""
        if not src or tid is None:
            return
        ts = (list(t) if isinstance(t, (list, tuple)) else [t])
        key = (src, int(tid))
        entry = {"result": int(result), "outs": list(outs or []),
                 "version": int(version)}
        if key not in self.reqid_journal:
            self.reqid_order.append(key)
        self.reqid_journal[key] = entry
        for txn in ts:
            txn.omap_setkeys(self.cid, PGMETA_OID,
                             {self._reqid_row(*key):
                              denc.encode(entry)})
        cap = int(self.osd.ctx.conf.get("osd_pg_log_dups_tracked",
                                        128))
        while len(self.reqid_order) > cap:
            old = self.reqid_order.pop(0)
            self.reqid_journal.pop(old, None)
            for txn in ts:
                txn.omap_rmkeys(self.cid, PGMETA_OID,
                                [self._reqid_row(*old)])

    def forget_reqid(self, src: str, tid) -> None:
        """Drop a pre-journaled reply after a FAILED commit (< k
        shards acked): the resend must re-execute, not be answered 0.
        Local store row included; replicated copies on members that
        did apply are harmless — re-execution of the same (src,tid)
        write converges to the same bytes."""
        if not src or tid is None:
            return
        key = (src, int(tid))
        if self.reqid_journal.pop(key, None) is None:
            return
        try:
            self.reqid_order.remove(key)
        except ValueError:
            pass
        t = Transaction()
        t.omap_rmkeys(self.cid, PGMETA_OID, [self._reqid_row(*key)])
        self.osd.store.apply_transaction(t)

    def lookup_reqid(self, src: str, tid) -> dict | None:
        if not src or tid is None:
            return None
        key = (src, int(tid))
        entry = self.reqid_journal.get(key)
        if entry is None:
            # replicated dup rows (the EC delta path journals inside
            # the shard transactions): a replica promoted to primary
            # serves the dup from its own store WITHOUT a reload
            try:
                raw = self.osd.store.omap_get_values(
                    self.cid, PGMETA_OID,
                    [self._reqid_row(*key)]).get(
                        self._reqid_row(*key))
            except Exception:
                raw = None
            if raw:
                entry = dict(denc.decode(raw))
                self.reqid_journal[key] = entry
                self.reqid_order.append(key)
        return entry

    def maybe_trim_log(self, t: Transaction) -> None:
        """Bound the log after appending a WRITE entry (never call
        from the bulk merge/adopt persist loops — trimming under an
        iteration over pg.log.entries would re-persist dropped rows).
        Peers that fall behind the trimmed tail are backfilled.  On
        replicas the same policy keeps the in-memory log in lockstep
        with the primary's replicated omap trims."""
        limit = self.osd.ctx.conf["osd_max_pg_log_entries"]
        if len(self.log.entries) <= limit:
            return
        keep = self.log.entries[-(limit // 2):]
        cut = keep[0].version
        for d in self.log.trim((cut[0], cut[1] - 1)):
            t.omap_rmkeys(self.cid, PGMETA_OID,
                          [b"log." + ev_key(d.version)])
        self.info.log_tail = self.log.tail

    def replace_log(self, t: Transaction, entries, tail) -> None:
        """Wholesale log replacement (full adoption / backfill):
        removes EVERY persisted log row first — leftover rows from the
        replaced history would resurrect dead entries on the next
        load()."""
        try:
            old = self.osd.store.omap_get(self.cid, PGMETA_OID)
            stale = [k for k in old if k.startswith(b"log.")]
            if stale:
                t.omap_rmkeys(self.cid, PGMETA_OID, stale)
        except Exception:
            pass
        self.log.entries = list(entries)
        self.log.tail = tuple(tail)
        self.info.log_tail = self.log.tail
        for e in self.log.entries:
            self.persist_log_entry(t, e)

    def load(self) -> bool:
        """Restore info+log from the pgmeta omap; False if absent."""
        store = self.osd.store
        try:
            data = store.omap_get(self.cid, PGMETA_OID)
        except Exception:
            return False
        if b"info" not in data:
            return False
        self.info = PGInfo.from_wire(denc.decode(data[b"info"]))
        if b"past_intervals" in data:
            self.past_intervals = [
                dict(iv) for iv in
                denc.decode(data[b"past_intervals"])]
        if b"scrub" in data:
            try:
                ss, ds, errs = denc.decode(data[b"scrub"])
                self.last_scrub_stamp = float(ss)
                self.last_deep_scrub_stamp = float(ds)
                self.scrub_errors = int(errs)
            except (ValueError, TypeError):
                pass
        entries = []
        for k, v in sorted(data.items()):
            if k.startswith(b"log."):
                entries.append(LogEntry.from_wire(denc.decode(v)))
            elif k.startswith(b"dup."):
                try:
                    src, tid_s = k[4:].rsplit(b".", 1)
                    key = (src.decode(), int(tid_s))
                except (ValueError, UnicodeDecodeError):
                    continue
                self.reqid_journal[key] = dict(denc.decode(v))
                self.reqid_order.append(key)
        self.log.entries = entries
        self.log.tail = self.info.log_tail
        return True

    def create_onstore(self) -> None:
        """Idempotent: a collection can already exist on disk from a
        previous tenure whose pgmeta never became loadable (load()
        returned False) — re-adopt it rather than failing."""
        t = Transaction()
        if not self.osd.store.collection_exists(self.cid):
            t.create_collection(self.cid)
        t.touch(self.cid, PGMETA_OID)
        self.persist_meta(t)
        self.osd.store.apply_transaction(t)


def merge_divergent(my_entries, auth_entries):
    """PGLog::merge_log / _merge_divergent_entries core: given this
    node's log and the authoritative log, find the newest COMMON entry
    (same version and object) and compute exactly the objects whose
    state can differ beyond it:

      * authoritative entries after the common point — the authority
        changed them; we need its copies;
      * our own entries after the common point (the divergent ones —
        writes nobody else acked) — they must be ROLLED BACK to the
        authority's state (push of its copy, or deletion when the
        authority never had the object).

    Returns {oid: op} of that narrow set, or None when the logs share
    no entry at all (disjoint histories — the caller falls back to the
    conservative whole-log resync, e.g. when the divergence predates
    the authoritative log's tail)."""
    auth_keys = {(tuple(e.version), e.oid) for e in auth_entries}
    common = None
    for e in reversed(my_entries):
        if (tuple(e.version), e.oid) in auth_keys:
            common = tuple(e.version)
            break
    if common is None:
        return None
    missing: dict[str, str] = {}
    for e in auth_entries:
        if tuple(e.version) > common:
            missing[e.oid] = e.op
    for e in my_entries:
        if tuple(e.version) > common:
            # divergent entry: rollback — authoritative copy wins
            missing.setdefault(e.oid, LogEntry.MODIFY)
    return missing
