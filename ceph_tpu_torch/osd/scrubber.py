"""PG scrub: chunked cross-replica/shard integrity checking + repair.

Condensed analog of src/osd/scrubber/ (scrub_machine.cc state flow,
scrub_backend.cc compare logic, PrimaryLogScrub): the primary walks the
PG's objects in chunks, asks every acting member for a scrub map of the
chunk (MOSDRepScrub -> MOSDRepScrubMap: per-object size/digest/attrs
digest — ScrubMap in osd_types.h), compares, and repairs from an
authoritative copy when asked (the `repair` flag of
do_scrub_operation).

* replicated pools — byte digests must match across replicas; the
  authoritative copy is the digest held by the majority with the
  primary breaking ties (scrub_backend.cc select_auth_object); repair
  pushes the authoritative bytes over the divergent replicas (and can
  heal the primary itself by fetching them first).
* EC pools — shards differ by construction, so integrity is checked at
  the stripe level: shallow scrub compares shard metadata
  (ec_ver/ec_size agreement); deep scrub checks every stored shard's
  byte digest against the majority-voted hinfo crc vector (and the
  hinfo attr itself against the vote — rotted integrity METADATA is
  as detectable as rotted bytes), falling back to a fetch-based
  decode vote for legacy objects; repair rewrites divergent shards
  from a re-encode of the clean ones, hinfo recomputed.

Always-on discipline (the integrity plane):

* digests are **device-offloaded**: `build_scrub_map` batches a whole
  chunk's object bytes + attr blobs into one crc32 dispatch on the
  daemon's affinity chip (ceph_tpu.device.digest, `background`
  admission class); DeviceBusy or a lost chip fails the chunk's
  digests (a replica's map then counts as unavailable) — no host loop.
* **stragglers are never conflated with absence**: a replica that
  misses the chunk deadline is retried once, then recorded in
  `result["unavailable"]` — its objects are excluded from comparison
  (not flagged absent), repair decisions that would need its vote are
  skipped for the chunk, and scrub stamps are not advanced (the round
  did not authoritatively cover the PG).
* **periodic scrubs confirm before flagging** (`recheck=True`): an
  inconsistency is only recorded if it persists across passes, so a
  client write racing the per-member map builds settles instead of
  raising PG_DAMAGED spuriously.
* every completed scrub updates `last_scrub_stamp` /
  `last_deep_scrub_stamp` and the PG's residual `scrub_errors` count,
  which ride the stat row into the mgr digest and the mon's
  OSD_SCRUB_ERRORS / PG_DAMAGED health checks — cleared only by a
  repair scrub that drains the residual to zero.
"""

from __future__ import annotations

import asyncio
import itertools
import zlib

from ..msg.messages import MOSDPGPush, MOSDRepScrub, MOSDRepScrubMap
from ..store.objectstore import NOSNAP, NotFound, Transaction, \
    hobject_t
from .pg import PG


def _skey(name: str, snap: int = NOSNAP) -> str:
    """Scrub-map key for one hobject: heads keep their (escaped)
    name, clones append "@@<snapid-hex>" — the scrubber walks the
    WHOLE snap set (scrub_backend.cc scrubs every hobject, clones
    included).  '@' in object names is escaped to '@a' so a client
    object literally named 'x@@2a' can never be conflated with the
    clone (x, 0x2a)."""
    esc = name.replace("@", "@a")
    return esc if snap == NOSNAP else "%s@@%x" % (esc, snap)


def _sobj(key: str) -> hobject_t:
    name, sep, s = key.rpartition("@@")
    if sep:
        try:
            return hobject_t(name.replace("@a", "@"), snap=int(s, 16))
        except ValueError:
            pass
    return hobject_t(key.replace("@a", "@"))


def _digest(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _attrs_blob(attrs: dict) -> bytes:
    return b"\0".join(b"%s=%s" % (k.encode(), v)
                      for k, v in sorted(attrs.items()))


def _attrs_digest(attrs: dict) -> int:
    return zlib.crc32(_attrs_blob(attrs)) & 0xFFFFFFFF


class Scrubber:
    """Per-daemon scrub engine (the primary drives its PGs)."""

    def __init__(self, osd):
        self.osd = osd
        self._tid = 0
        self._waiting: dict[int, dict] = {}

    # -- scrub maps ---------------------------------------------------------

    async def build_scrub_map(self, pg: PG, oids: list[str],
                              fetch: bool = False) -> dict:
        """{oid: {size, digest, attrs_digest, attrs[, data]}} for the
        local objects (ScrubMap::objects).  The whole chunk's digests
        (object bytes + attr blobs) dispatch as ONE device crc32
        batch on this daemon's affinity chip; a refused or failed
        dispatch raises."""
        from ..device.digest import crc32_batch
        rows: list[tuple[str, bytes, dict]] = []
        bufs: list[bytes] = []
        for oid in oids:
            ho = _sobj(oid)
            try:
                data = self.osd.store.read(pg.cid, ho)
                attrs = dict(self.osd.store.getattrs(pg.cid, ho))
            except NotFound:
                continue
            rows.append((oid, data, attrs))
            bufs.append(data)
            bufs.append(_attrs_blob(attrs))
        if not rows:
            return {}
        chip = (self.osd.device_chip.index
                if self.osd.device_chip is not None else None)
        digs, path = await crc32_batch(bufs, chip=chip,
                                       device=self.osd.device)
        try:
            if path == "device":
                self.osd.perf.inc("scrub_digest_device", len(bufs))
        except KeyError:
            pass        # bare Scrubber without the OSD counters
        out = {}
        for i, (oid, data, attrs) in enumerate(rows):
            entry = {
                "size": len(data),
                "digest": digs[2 * i],
                "attrs_digest": digs[2 * i + 1],
                "attrs": attrs,
            }
            if fetch:
                entry["data"] = data
            out[oid] = entry
        return out

    async def handle_rep_scrub(self, conn, msg: MOSDRepScrub) -> None:
        """Replica side: build and return the chunk's scrub map (or,
        in inventory mode, every hobject key we hold — the primary's
        stray sweep must see replica-only clones too).  Digesting
        rides this replica's own affinity chip."""
        from .osdmap import pg_t

        pg = self.osd.pgs.get(pg_t(msg.pool, msg.ps))
        if pg is None:
            objects = {}
        elif msg.inventory:
            objects = {_skey(h.name, h.snap): {}
                       for h in self.osd.store.collection_list(pg.cid)
                       if h.name != "__pgmeta__"}
        else:
            from ..device.runtime import DeviceBusy, DeviceLost
            try:
                objects = await self.build_scrub_map(
                    pg, msg.oids, fetch=bool(msg.fetch))
            except (DeviceBusy, DeviceLost, IOError) as e:
                # the chip refused or failed the digests: no map, so
                # the primary records this replica unavailable
                self.osd.ctx.log.info(
                    "osd", "osd.%d scrub map %d.%x failed: %r"
                    % (self.osd.whoami, msg.pool, msg.ps, e))
                return
        conn.send(MOSDRepScrubMap(pool=msg.pool, ps=msg.ps,
                                  tid=msg.tid, objects=objects))

    def handle_rep_scrub_map(self, msg: MOSDRepScrubMap) -> None:
        st = self._waiting.get(msg.tid)
        if st is None:
            return
        try:
            osd_id = int(msg.src.split(".", 1)[1])
        except (ValueError, IndexError):
            return
        st["maps"][osd_id] = msg.objects
        st["waiting"].discard(osd_id)
        if not st["waiting"]:
            st["event"].set()

    async def _gather_maps(self, pg: PG, oids: list[str],
                           fetch: bool = False,
                           members=None,
                           inventory: bool = False
                           ) -> tuple[dict, set[int]]:
        """Scrub maps from the acting members (self included).
        Returns (maps, unavailable): a member that misses the chunk
        deadline is retried ONCE (the request frame may simply have
        been lost), then recorded in `unavailable` — callers must
        treat its objects as UNKNOWN, never absent, and skip
        authority/repair decisions that would need its vote."""
        targets0 = members if members is not None else pg.acting
        maps = {}
        if members is None or self.osd.whoami in targets0:
            if inventory:
                maps[self.osd.whoami] = {
                    _skey(h.name, h.snap): {}
                    for h in self.osd.store.collection_list(pg.cid)
                    if h.name != "__pgmeta__"}
            else:
                maps[self.osd.whoami] = await self.build_scrub_map(
                    pg, oids, fetch=fetch)
        self._tid += 1
        tid = self._tid
        waiting: set[int] = set()
        ev = asyncio.Event()
        self._waiting[tid] = {"maps": maps, "waiting": waiting,
                              "event": ev}
        targets = members if members is not None else pg.acting

        def send(osd_id: int) -> None:
            addr = self.osd.osdmap.osd_addrs.get(osd_id)
            if addr:
                self.osd.msgr.send_to(addr, MOSDRepScrub(
                    pool=pg.pool_id, ps=pg.ps, tid=tid, oids=oids,
                    fetch=fetch, inventory=inventory),
                    entity_hint="osd.%d" % osd_id)

        for osd_id in targets:
            if osd_id < 0 or osd_id == self.osd.whoami:
                continue
            if not self.osd.osdmap.is_up(osd_id):
                continue
            if not self.osd.osdmap.osd_addrs.get(osd_id):
                continue
            waiting.add(osd_id)
            send(osd_id)
        timeout = float(self.osd.ctx.conf.get(
            "osd_scrub_chunk_timeout", 5.0))
        if waiting:
            for attempt in range(2):
                try:
                    await asyncio.wait_for(ev.wait(), timeout)
                    break
                except asyncio.TimeoutError:
                    if attempt == 0:
                        # retry once: the request (or the reply) may
                        # have been a lost frame, not a dead member
                        for osd_id in sorted(waiting):
                            send(osd_id)
        unavailable = set(waiting)
        self._waiting.pop(tid, None)
        return maps, unavailable

    # -- scrub driver -------------------------------------------------------

    async def scrub_pg(self, pg: PG, deep: bool = False,
                       repair: bool = False,
                       chunk: int = 25,
                       recheck: bool = False,
                       only: set | None = None) -> dict:
        """Primary-side scrub of one PG; returns
        {"errors": n, "inconsistent": [oid...], "repaired": n,
         "residual": unrepaired error count, "unavailable": [osd...]}.

        `recheck=True` (periodic / oracle scrubs) confirms every
        inconsistency across a second pass before recording it, so a
        client write racing the per-member map builds settles instead
        of flagging.  On completion the PG's scrub stamps and residual
        `scrub_errors` update (and persist), and a changed residual
        forces an immediate mgr report so the OSD_SCRUB_ERRORS /
        PG_DAMAGED health edges flow now, not at the next tick.

        `only` narrows the round to hobjects whose BASE NAME is in
        the set (heads and their clones ride together) — the
        surgical-repair path: rewrite exactly the known-bad objects
        without racing unrelated in-flight writes."""
        fr = getattr(self.osd.ctx, "flight_recorder", None)
        t_span0 = fr.now() if fr is not None else 0.0
        result = await self._scrub_once(pg, deep, repair, chunk,
                                        only=only)
        if recheck and result["errors"] and not repair:
            prev = set(result["inconsistent"])
            for _ in range(2):
                if not prev:
                    break
                await asyncio.sleep(0.1)
                again = await self._scrub_once(pg, deep, False, chunk,
                                               only=only)
                cur = set(again["inconsistent"]) & prev
                result = again
                if cur == prev:
                    break               # stable across passes: real
                prev = cur
            result["inconsistent"] = sorted(prev)
            result["errors"] = len(prev)
            result["residual"] = len(prev)
        if result.get("ran"):
            self._note_scrub_done(pg, deep, result,
                                  partial=only is not None)
        if fr is not None and result.get("ran"):
            # background-work span beside the ops it competed with
            fr.span("deep_scrub" if deep else "scrub", t_span0,
                    meta={"pgid": str(pg.pgid),
                          "errors": result.get("errors", 0),
                          "repaired": result.get("repaired", 0)})
        return result

    def _note_scrub_done(self, pg: PG, deep: bool, result: dict,
                         partial: bool = False) -> None:
        """Completed-scrub bookkeeping: perf counters, stamps (only
        when every member answered — a partial round did not
        authoritatively cover the PG), the residual error count the
        stats plane ships, and the immediate report on an edge."""
        import time as _t
        osd = self.osd
        try:
            osd.perf.inc("deep_scrubs" if deep else "scrubs")
            if result["errors"]:
                osd.perf.inc("scrub_errors_found", result["errors"])
            if result["repaired"]:
                osd.perf.inc("scrub_repaired", result["repaired"])
        except KeyError:
            pass
        prev_err = getattr(pg, "scrub_errors", 0)
        pg.scrub_errors = int(result.get("residual",
                                         result["errors"]))
        if not result.get("unavailable") and not partial:
            # an `only`-narrowed round (surgical repair) or one with
            # a straggler did not cover the PG: stamps stay put
            now = _t.time()
            pg.last_scrub_stamp = now
            if deep:
                pg.last_deep_scrub_stamp = now
        t = Transaction()
        pg.persist_scrub(t)
        osd.store.apply_transaction(t)
        if pg.scrub_errors != prev_err:
            if pg.scrub_errors:
                osd.clog.warn(
                    "pg %s %sscrub found %d inconsistencies: %s"
                    % (pg.pgid, "deep-" if deep else "",
                       pg.scrub_errors,
                       result["inconsistent"][:5]))
            else:
                osd.clog.info(
                    "pg %s repaired: scrub errors drained to zero"
                    % pg.pgid)
            # the health edge must flow through OSD -> mgr -> mon now
            osd._mgr_report_stamp = 0.0
            osd._maybe_send_mgr_report()

    async def _scrub_once(self, pg: PG, deep: bool, repair: bool,
                          chunk: int, only: set | None = None
                          ) -> dict:
        pool = self.osd.osdmap.pools.get(pg.pool_id)
        result = {"errors": 0, "inconsistent": [], "repaired": 0,
                  "residual": 0, "unavailable": []}
        if pool is None or not pg.is_primary():
            return result
        result["ran"] = True
        unavailable: set[int] = set()
        # hobject inventory from EVERY member: replica-only strays
        # (e.g. a clone a lost trim left behind) must be scrubbed too
        keys = {_skey(h.name, h.snap) for h in
                self.osd.store.collection_list(pg.cid)
                if h.name != "__pgmeta__"}
        inv, un = await self._gather_maps(pg, [], inventory=True)
        unavailable |= un
        for mm in inv.values():
            keys.update(mm)
        keys.update(_skey(e.oid) for e in pg.log.entries)
        if only is not None:
            keys = {k for k in keys if _sobj(k).name in only}
        oids = sorted(keys)
        presence: dict[str, set[int]] = {}
        # head snapset votes across members: the orphan sweep must
        # not trust a single (possibly rotted) copy
        ss_votes: dict[str, dict[bytes, int]] = {}
        for i in range(0, len(oids), chunk):
            batch = oids[i:i + chunk]
            # each chunk passes the mClock 'scrub' class so scrubbing
            # yields to client I/O and recovery under load
            from .scheduler import K_SCRUB
            await self.osd.sched.admit(K_SCRUB, cost=len(batch),
                                       key=(pg.pool_id, pg.ps))
            maps, un = await self._gather_maps(pg, batch)
            unavailable |= un
            # a straggler's vote is missing: flag among responders,
            # but never repair on an incomplete quorum
            can_repair = repair and not un
            from .snaps import SNAPSET_ATTR
            for osd_id, mm in maps.items():
                for k, row in mm.items():
                    presence.setdefault(k, set()).add(osd_id)
                    if "@@" not in k:
                        raw = row["attrs"].get(SNAPSET_ATTR)
                        if raw:
                            v = ss_votes.setdefault(k, {})
                            v[bytes(raw)] = v.get(bytes(raw), 0) + 1
            if pool.is_erasure():
                await self._compare_ec(pg, pool, batch, maps, deep,
                                       can_repair, result)
            else:
                await self._compare_replicated(pg, batch, maps,
                                              can_repair, result)
        await self._validate_snapsets(pg, presence, ss_votes,
                                      repair and not unavailable,
                                      result,
                                      complete=not unavailable)
        result["unavailable"] = sorted(unavailable)
        return result

    async def _validate_snapsets(self, pg: PG, presence, ss_votes,
                                 repair, result,
                                 complete: bool = True) -> None:
        """Snap-set consistency (scrub_backend.cc + SnapMapper roles):
        every clone a head's snapset lists must exist on some member
        (a listed-but-absent clone is unrecoverable data loss, flagged
        only), and every on-disk clone must be claimed by its head's
        snapset (orphans are flagged and, on repair, removed
        everywhere — the reference's snap-mapper repair).  Each head's
        snapset is the MAJORITY copy across members, so one rotted
        replica cannot drive a cluster-wide clone deletion.  With an
        unavailable member (`complete=False`) the sweep is skipped
        entirely: a straggler's unseen clones and snapset votes must
        never read as absence."""
        from ..utils import denc

        if not complete:
            return
        snapsets: dict[str, dict] = {}
        for name, votes in ss_votes.items():
            for raw, _n in sorted(votes.items(),
                                  key=lambda kv: -kv[1]):
                try:
                    snapsets[name] = denc.decode(raw)
                    break
                except Exception:
                    continue
            else:
                result["errors"] += 1
                result["residual"] += 1
                result["inconsistent"].append(name)
        for name, ss in snapsets.items():
            for snap in ss.get("clones", []):
                key = _skey(name, int(snap))
                if key not in presence:
                    result["errors"] += 1
                    result["residual"] += 1
                    result["inconsistent"].append(key)
                    self.osd.ctx.log.info(
                        "osd", "scrub %d.%x %s: clone listed in "
                        "snapset but absent on every member"
                        % (pg.pool_id, pg.ps, key))
        orphans = []
        for key, members in presence.items():
            ho = _sobj(key)
            if ho.snap == NOSNAP:
                continue
            ss = snapsets.get(ho.name)
            if ss is None or int(ho.snap) not in [
                    int(c) for c in ss.get("clones", [])]:
                orphans.append((key, ho, sorted(members)))
        for key, ho, members in orphans:
            result["errors"] += 1
            result["inconsistent"].append(key)
            self.osd.ctx.log.info(
                "osd", "scrub %d.%x %s: orphan clone (no snapset "
                "claims it) on %s" % (pg.pool_id, pg.ps, key, members))
            if not repair:
                result["residual"] += 1
                continue
            for osd_id in members:
                if osd_id == self.osd.whoami:
                    t = Transaction()
                    t.remove(pg.cid, ho)
                    self.osd.store.apply_transaction(t)
                else:
                    self.osd._send_osd(osd_id, MOSDPGPush(
                        pool=pg.pool_id, ps=pg.ps,
                        epoch=self.osd.osdmap.epoch,
                        pushes=[{"oid": ho.name, "snap": ho.snap,
                                 "delete": True}]))
            result["repaired"] += 1

    # -- replicated compare -------------------------------------------------

    async def _compare_replicated(self, pg: PG, oids, maps, repair,
                                  result) -> None:
        live = [o for o in pg.acting if o >= 0 and o in maps]
        for oid in oids:
            present = {o: maps[o][oid] for o in live
                       if oid in maps[o]}
            if not present:
                continue
            digests: dict[tuple, list[int]] = {}
            for o, r in present.items():
                digests.setdefault(
                    (r["size"], r["digest"], r["attrs_digest"]),
                    []).append(o)
            # content-addressed chunk objects (the dedup chunk
            # store) carry their truth in the oid — crc32 and size.
            # Candidate auth copies must MATCH the address, so a
            # majority of rotted replicas can never outvote one
            # healthy copy, and unanimous rot is still detected
            from ..dedup import parse_chunk_oid
            named = parse_chunk_oid(oid)
            keys = list(digests)
            if named is not None:
                good = [k for k in keys
                        if k[1] == named[0] and k[0] == named[1]]
                if not good:
                    # every copy disagrees with its own address:
                    # nothing to repair from — unrepairable residual
                    result["errors"] += len(present)
                    result["inconsistent"].append(oid)
                    result["residual"] += len(present)
                    self.osd.ctx.log.info(
                        "osd", "scrub %d.%x %s: all copies diverge"
                        " from the chunk address"
                        % (pg.pool_id, pg.ps, oid))
                    continue
                keys = good
            if len(digests) == 1 and len(present) == len(live) \
                    and (named is None or len(keys) == len(digests)):
                continue
            # authoritative = the majority digest, primary tiebreak
            auth_key = max(
                keys,
                key=lambda k: (len(digests[k]),
                               self.osd.whoami in digests[k]))
            bad = [o for o in live if o not in digests[auth_key]]
            result["errors"] += len(bad)
            result["inconsistent"].append(oid)
            self.osd.ctx.log.info(
                "osd", "scrub %d.%x %s: inconsistent on %s"
                % (pg.pool_id, pg.ps, oid, bad))
            if not repair:
                result["residual"] += len(bad)
                continue
            auth_osd = (self.osd.whoami
                        if self.osd.whoami in digests[auth_key]
                        else digests[auth_key][0])
            data = await self._auth_bytes(pg, oid, auth_osd)
            if data is None:
                result["residual"] += len(bad)
                continue
            attrs = present[auth_osd]["attrs"]
            repaired = 0
            ho = _sobj(oid)
            for osd_id in bad:
                if osd_id == self.osd.whoami:
                    t = Transaction()
                    t.write(pg.cid, ho, 0, len(data), data)
                    t.truncate(pg.cid, ho, len(data))
                    # attrs replace wholesale: a divergent EXTRA
                    # attr must not survive the repair (setattrs
                    # merges)
                    t.rmattrs(pg.cid, ho)
                    t.setattrs(pg.cid, ho, dict(attrs))
                    self.osd.store.apply_transaction(t)
                    repaired += 1
                else:
                    self.osd._send_osd(osd_id, MOSDPGPush(
                        pool=pg.pool_id, ps=pg.ps,
                        epoch=self.osd.osdmap.epoch,
                        pushes=[{"oid": ho.name, "snap": ho.snap,
                                 "delete": False, "data": data,
                                 "attrs": dict(attrs), "omap": {}}]))
                    repaired += 1
            result["repaired"] += repaired
            result["residual"] += max(0, len(bad) - repaired)

    async def _auth_bytes(self, pg: PG, oid: str,
                          auth_osd: int) -> bytes | None:
        if auth_osd == self.osd.whoami:
            try:
                return self.osd.store.read(pg.cid, _sobj(oid))
            except NotFound:
                return None
        maps, _un = await self._gather_maps(pg, [oid], fetch=True,
                                            members=[auth_osd])
        row = maps.get(auth_osd, {}).get(oid)
        return None if row is None else bytes(row["data"])

    # -- EC compare ---------------------------------------------------------

    @staticmethod
    def _majority_hinfo(rows: dict
                        ) -> tuple[list[int] | None, bytes | None]:
        """(crc vector, raw blob) most shards agree on, or
        (None, None) — legacy or unparseable hinfo (corrupted
        metadata must degrade to the fetch-based vote, not crash the
        scrub)."""
        votes: dict[bytes, int] = {}
        for r in rows.values():
            hv = r["attrs"].get("ec_hinfo")
            if hv:
                votes[bytes(hv)] = votes.get(bytes(hv), 0) + 1
        for hv, _n in sorted(votes.items(), key=lambda kv: -kv[1]):
            try:
                return [int(x) for x in hv.split(b",")], hv
            except ValueError:
                continue
        return None, None

    async def _compare_ec(self, pg: PG, pool, oids, maps, deep,
                          repair, result) -> None:
        from .ecbackend import SIZE_XATTR, VER_XATTR

        codec = self.osd.ec.codec(pool)
        live = [o for o in pg.acting if o >= 0 and o in maps]
        pos_of = {o: j for j, o in enumerate(pg.acting)}
        for oid in oids:
            present = {o: maps[o][oid] for o in live
                       if oid in maps[o]}
            if not present:
                continue
            # authoritative metadata = the (ver, size) group most
            # shards carry (newest version breaks ties)
            groups: dict[tuple, list[int]] = {}
            for o, r in present.items():
                key = (r["attrs"].get(VER_XATTR),
                       r["attrs"].get(SIZE_XATTR))
                groups.setdefault(key, []).append(o)
            auth_key = max(groups,
                           key=lambda k: (len(groups[k]), k[0] or b""))
            auth = {o: present[o] for o in groups[auth_key]}
            meta_bad = [o for o in present if o not in auth]
            # byte rot among the metadata-consistent shards: compare
            # each shard's shallow crc against the voted hinfo vector
            # (no byte fetch needed); a shard whose own hinfo ATTR
            # disagrees with the vote is rotted integrity metadata and
            # flags the same way; legacy objects without hinfo go
            # through the fetch-based decode vote
            byte_bad: list[int] = []
            crcs = voted_raw = None
            if deep:
                crcs, voted_raw = self._majority_hinfo(auth)
            legacy = deep and crcs is None
            if deep and crcs is not None:
                for o, r in auth.items():
                    j = pos_of.get(o)
                    if j is not None and j < len(crcs) \
                            and r["digest"] != crcs[j]:
                        byte_bad.append(o)
                    else:
                        hv = r["attrs"].get("ec_hinfo")
                        if hv is not None \
                                and bytes(hv) != voted_raw:
                            byte_bad.append(o)
            if legacy:
                byte_bad = await self._legacy_byte_vote(
                    pg, codec, oid, auth, pos_of)
            if not meta_bad and not byte_bad:
                continue
            bad = sorted(set(meta_bad) | set(byte_bad))
            result["errors"] += len(meta_bad) + len(byte_bad)
            result["inconsistent"].append(oid)
            self.osd.ctx.log.info(
                "osd", "scrub %d.%x %s: EC inconsistency "
                "(meta=%s shards=%s)"
                % (pg.pool_id, pg.ps, oid, meta_bad,
                   sorted(byte_bad)))
            if repair:
                fixed = await self._repair_ec(
                    pg, codec, oid, auth, pos_of, bad)
                result["repaired"] += fixed
                result["residual"] += max(0, len(bad) - fixed)
            else:
                result["residual"] += len(meta_bad) + len(byte_bad)

    async def _legacy_byte_vote(self, pg: PG, codec, oid: str, auth,
                                pos_of) -> list[int]:
        """No hinfo: fetch the shard bytes and vote decode subsets —
        each decode reproduces its inputs, so the re-encode agreeing
        with the most stored shards wins (sound for m >= 2)."""
        shards = await self._fetch_shards(pg, oid, list(auth), pos_of)
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        by_j = {j: buf for _o, (j, buf) in shards.items()}
        if len(by_j) < k:
            return []
        best = None
        for subset in itertools.combinations(sorted(by_j), k):
            try:
                cand = codec.encode(
                    set(range(n)),
                    codec.decode_concat(
                        {j: by_j[j] for j in subset}))
            except Exception:
                continue
            agree = sum(1 for j, buf in by_j.items()
                        if cand.get(j, b"") == buf)
            if best is None or agree > best[0]:
                best = (agree, cand)
            if agree == len(by_j):
                break
        if best is None:
            return []
        expect = best[1]
        return [o for o, (j, buf) in shards.items()
                if j in expect and expect[j] != buf]

    async def _fetch_shards(self, pg: PG, oid: str, members,
                            pos_of) -> dict:
        """{osd: (shard_index, bytes)} for the given members."""
        maps, _un = await self._gather_maps(pg, [oid], fetch=True,
                                            members=members)
        out = {}
        for osd_id, m in maps.items():
            row = m.get(oid)
            if row is None:
                continue
            j = pos_of.get(osd_id)
            if j is not None:
                out[osd_id] = (j, bytes(row["data"]))
        return out

    async def _repair_ec(self, pg: PG, codec, oid: str, auth,
                         pos_of, bad: list[int]) -> int:
        """Rebuild every divergent shard (metadata, bytes, or hinfo)
        from a decode of the clean authoritative shards and rewrite
        it with the authoritative attrs — its own shard index
        substituted and the hinfo crc vector RECOMPUTED from the
        re-encode, so a rotted hinfo attr never survives the repair
        (nor propagates from a corrupted auth member)."""
        from .ecbackend import HINFO_XATTR, hinfo_bytes

        good = [o for o in auth if o not in bad]
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        if len(good) < k:
            return 0
        shards = await self._fetch_shards(pg, oid, good, pos_of)
        chunks = {j: buf for _o, (j, buf) in shards.items()}
        try:
            expect = codec.encode(set(range(n)),
                                  codec.decode_concat(chunks))
        except (IOError, ValueError):
            return 0
        auth_attrs = dict(next(iter(auth.values()))["attrs"])
        if auth_attrs.get(HINFO_XATTR) is not None:
            auth_attrs[HINFO_XATTR] = hinfo_bytes(expect)
        repaired = 0
        for osd_id in bad:
            j = pos_of.get(osd_id)
            if j is None or j not in expect:
                continue
            attrs = dict(auth_attrs)
            attrs["ec_shard"] = b"%d" % j
            ho = _sobj(oid)
            if osd_id == self.osd.whoami:
                t = Transaction()
                t.write(pg.cid, ho, 0, len(expect[j]), expect[j])
                t.truncate(pg.cid, ho, len(expect[j]))
                t.rmattrs(pg.cid, ho)
                t.setattrs(pg.cid, ho, attrs)
                self.osd.store.apply_transaction(t)
            else:
                self.osd._send_osd(osd_id, MOSDPGPush(
                    pool=pg.pool_id, ps=pg.ps,
                    epoch=self.osd.osdmap.epoch,
                    pushes=[{"oid": ho.name, "snap": ho.snap,
                             "delete": False, "data": expect[j],
                             "attrs": attrs, "omap": {}}]))
            repaired += 1
        return repaired
