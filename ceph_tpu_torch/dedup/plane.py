"""DedupPlane: the OSD-side orchestrator of the data-reduction plane.

The primary of a dedup base pool routes every client op here (the
`_handle_op` hook, right after the compression hook).  Writes are
planned first — chunk boundaries in one device dispatch
(`chunker.boundary_batch`), fingerprints in one more
(`chunker.fingerprint_batch`), then one refcount get per unique
fingerprint against the chunk pool (ref-or-create; a zero committed
size means WE store the bytes) — and the synchronous base mutation
then rides a BACKGROUND admission grant exactly like a compression
op (the device dispatches pace themselves through ticket admission;
the grant is never held across them).  The planned manifest rides
into `_execute_write` as ``dedup_pre`` so the base mutation is one
ordinary replicated transaction; once it lands, refs the new
manifest no longer holds are put (the chunk store self-deletes on
the last put).

Chunk-pool I/O goes through `InternalObjecter` — the OSD acting as
its own minimal librados client: placement from its subscribed
OSDMap, self-primary ops looped back into `_handle_op` directly,
remote ops over the existing OSD mesh, and timeout resends with the
SAME tid so the reqid journal answers duplicates instead of
double-running a non-idempotent refcount put.

Failure policy is raw-first: any `ObjecterError` during planning
degrades the write to a RAW store (refs taken so far are rolled
back, best-effort) — an acked write never depends on the chunk pool
being healthy.
"""

from __future__ import annotations

import asyncio
import time

from ..msg.messages import MOSDOp, MOSDOpReply
from ..store.objectstore import NotFound, hobject_t
from ..utils import denc
from .chunker import (CHUNK_MIN, boundary_batch, chunk_oid,
                      fingerprint_batch, split)

# base-object xattrs (the dedup analog of compress.OBJ_*_ATTR):
# MANIFEST marks the object's data as a manifest blob; LOGICAL is the
# pre-dedup size so stat answers without materializing
OBJ_MANIFEST_ATTR = "dedup-manifest"
OBJ_LOGICAL_ATTR = "dedup-size"

# ops whose interpretation needs the raw bytes in place (a manifested
# object must be materialized before they run)
_RAW_MUTATORS = ("write", "truncate", "call", "omap-set", "omap-rm")


class ObjecterError(Exception):
    """An internal chunk-pool op could not be delivered (pool gone,
    no primary, resend budget exhausted) — distinct from a DELIVERED
    op returning a nonzero result, which the caller interprets."""


class _LoopbackConn:
    """The connection the primary hands `_handle_op` for its own
    internal ops: replies route straight back to the objecter, and
    `peer_entity` names an OSD so `_send_backoff` skips it (parked
    internal ops are requeued by the PG, never backed off)."""

    def __init__(self, objecter: "InternalObjecter"):
        self._objecter = objecter
        self.peer_entity = objecter.osd.msgr.entity
        self.peer_addr = "loopback/%s" % objecter.osd.msgr.entity
        self.is_open = True

    def send(self, msg) -> None:
        if isinstance(msg, MOSDOpReply):
            self._objecter.on_reply(msg)


class InternalObjecter:
    """Minimal Objecter for daemon-internal ops (the reference's
    cls_cas/dedup flows run client-side; here the primary IS the
    client of the chunk pool).  One op at a time per call: compute
    the target from the daemon's own OSDMap, loop back when this OSD
    is the primary, otherwise ride the OSD mesh; resend on timeout
    with the SAME tid so the reqid journal answers a duplicate of an
    already-committed (non-idempotent) refcount mutation."""

    def __init__(self, osd):
        self.osd = osd
        # tid base derived from wall clock: this daemon's reqid
        # journal rows survive a restart, so a restarted counter must
        # not collide with journaled tids of its previous life
        self._tid = (int(time.time()) & 0x7FFFFFFF) << 20
        self.inflight: dict[int, asyncio.Future] = {}
        self._loopback = _LoopbackConn(self)

    def on_reply(self, msg: MOSDOpReply) -> bool:
        fut = self.inflight.get(msg.tid)
        if fut is None:
            return False
        if not fut.done():
            fut.set_result(msg)
        return True

    async def op(self, pool_id: int, oid: str, ops: list[dict],
                 timeout: float = 5.0, attempts: int = 6
                 ) -> tuple[int, list]:
        """Execute one op list against (pool_id, oid); returns the
        reply's (result, outs).  Raises ObjecterError when the op
        cannot be delivered at all."""
        osd = self.osd
        self._tid += 1
        tid = self._tid
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self.inflight[tid] = fut
        try:
            for _ in range(max(1, attempts)):
                m = osd.osdmap
                pool = m.pools.get(pool_id) if m is not None else None
                if pool is None:
                    raise ObjecterError(
                        "pool %d gone from the map" % pool_id)
                pgid = pool.raw_pg_to_pg(
                    m.object_locator_to_pg(oid, pool_id))
                _up, _upp, _acting, primary = \
                    m.pg_to_up_acting_osds(pgid)
                if primary >= 0:
                    msg = MOSDOp(tid=tid, pool=pool_id, ps=pgid.ps,
                                 oid=oid, snapc=None, snapid=None,
                                 ops=ops, epoch=m.epoch, flags=0)
                    if primary == osd.whoami:
                        # Connection.send stamps src on the wire
                        # path; the loopback call must stamp it too
                        # (the reqid journal keys on it)
                        msg.src = osd.msgr.entity
                        osd._handle_op(self._loopback, msg)
                    else:
                        osd._send_osd(primary, msg)
                try:
                    rep = await asyncio.wait_for(
                        asyncio.shield(fut), timeout)
                    return rep.result, rep.outs
                except asyncio.TimeoutError:
                    continue    # same tid: a dup is journal-answered
            raise ObjecterError(
                "op on %d:%s undelivered after %d attempts"
                % (pool_id, oid, attempts))
        finally:
            self.inflight.pop(tid, None)


class DedupPlane:
    def __init__(self, osd):
        self.osd = osd
        self.objecter = InternalObjecter(osd)
        # per-base-pool dedup counters, shipped in osd_stats.dedup
        # and folded by the mgr digest into `dedup_pools`
        self.pool_stats: dict[int, dict[str, int]] = {}
        # write reqids currently being planned: the daemon's journal
        # dup check only covers COMMITTED ops, so a timeout resend
        # landing mid-plan must wait for the original instead of
        # planning (and accounting) the same write twice
        self._inflight: dict[tuple, asyncio.Event] = {}

    # -- stats -------------------------------------------------------------

    def _stats(self, pool_id: int) -> dict[str, int]:
        return self.pool_stats.setdefault(int(pool_id), {
            "chunks_stored": 0, "chunks_deduped": 0,
            "bytes_stored": 0, "bytes_saved": 0})

    def stats_row(self) -> dict[str, dict[str, int]]:
        return {str(pid): dict(row)
                for pid, row in self.pool_stats.items()}

    # -- manifest helpers --------------------------------------------------

    @staticmethod
    def ref_tag(base_pool: int, oid: str) -> str:
        """The refcount tag a base object holds on its chunks: tags
        are presence-based and per-base-object, so re-taking one is
        idempotent and releasing a stale one is benign."""
        return "%d:%s" % (base_pool, oid)

    def manifest_rows(self, pg, ho) -> list[list] | None:
        """The committed manifest rows ([fingerprint, size] in chunk
        order) of ``ho``, or None when the object is raw/absent."""
        store = self.osd.store
        try:
            if not store.getattr(pg.cid, ho, OBJ_MANIFEST_ATTR):
                return None
            return list(denc.decode(store.read(pg.cid, ho)))
        except NotFound:
            return None
        except Exception:
            return None     # torn/garbled manifest reads as raw

    def manifest_fps(self, pg, oid: str) -> list[str] | None:
        rows = self.manifest_rows(pg, hobject_t(oid))
        if rows is None:
            return None
        return [str(r[0]) for r in rows]

    async def materialize(self, pg, rows: list[list]) -> bytes:
        """Fetch a manifest's chunks from the chunk pool and
        reassemble the logical bytes; raises ObjecterError when the
        chunk store cannot serve them."""
        pool = self.osd.osdmap.pools.get(pg.pool_id)
        cpool = getattr(pool, "dedup_chunk_pool", -1)
        parts: list[bytes] = []
        for fp, size in rows:
            result, outs = await self.objecter.op(
                cpool, chunk_oid(str(fp)),
                [{"op": "read", "length": 0}])
            data = (outs[0].get("data") or b"") \
                if result == 0 and outs else b""
            if result != 0 or len(data) != int(size):
                raise ObjecterError(
                    "chunk %s unreadable (r=%d len=%d want=%d)"
                    % (fp, result, len(data), int(size)))
            parts.append(data)
        return b"".join(parts)

    def _reply_error(self, conn, msg, err: str, code: int = -5,
                     finish: str = "error_reply") -> None:
        conn.send(MOSDOpReply(
            tid=msg.tid, result=code,
            outs=[{"error": err} for _ in msg.ops],
            epoch=self.osd.osdmap.epoch, version=0))
        self.osd._op_finish(msg, finish)

    # -- op entry (spawned by the _handle_op hook) -------------------------

    async def handle_op(self, pg, conn, msg, writes: bool) -> None:
        """Plan async (device dispatches and chunk-store I/O pace
        themselves through ticket admission), then run the
        synchronous base mutation / read under a BACKGROUND admission
        grant like the compression path — a full queue degrades to
        unpaced execution; pacing never fails the op."""
        from ..device.runtime import (DeviceBusy, DeviceRuntime,
                                      K_BACKGROUND)
        osd = self.osd
        key = (str(msg.src), msg.tid)
        if writes:
            prior = self._inflight.get(key)
            if prior is not None:
                # in-flight duplicate: the original is still between
                # the daemon's journal dup check and its commit
                osd._op_event(msg, "waiting_for_inflight_dup")
                await prior.wait()
                dup = pg.lookup_reqid(msg.src, msg.tid)
                if dup is not None:
                    conn.send(MOSDOpReply(
                        tid=msg.tid, result=dup["result"],
                        outs=dup["outs"], epoch=osd.osdmap.epoch,
                        version=dup["version"]))
                    osd.perf.inc("dup_ops")
                    osd._op_finish(msg, "dup_answered_from_journal")
                else:
                    # the original error-replied without journaling;
                    # the client owns the retry
                    osd._op_finish(msg, "dropped_inflight_dup")
                return
            self._inflight[key] = asyncio.Event()
        chip = (osd.device_chip if osd.device_chip is not None
                else DeviceRuntime.get(osd.device).chip_for(osd.whoami))
        cost = max(1.0, sum(len(op.get("data") or b"")
                            for op in msg.ops
                            if isinstance(op, dict)) / 65536.0)
        t0 = osd.optracker.now()
        granted = False
        try:
            plan = None
            if writes:
                plan = await self._plan_write(pg, conn, msg, chip)
                if plan is None:
                    return      # error reply already sent
            else:
                if await self._maybe_read_manifested(pg, conn, msg):
                    return
            try:
                await chip.queue.admit(K_BACKGROUND, cost)
                granted = True
                osd.perf.inc("dedup_paced_ops")
            except DeviceBusy:
                # pacing, not a host route: the op's bytes were already
                # planned on the card; a full class runs it unpaced
                pass
            try:
                if writes:
                    osd._execute_write(pg, conn, msg,
                                       dedup_pre=plan["pre"])
                else:
                    osd._serve_read(pg, conn, msg)
            finally:
                if granted:
                    chip.queue.release()
                    granted = False
            if writes:
                await self._release_refs(pg, msg, plan)
        finally:
            if granted:
                chip.queue.release()
            if writes:
                ev = self._inflight.pop(key, None)
                if ev is not None:
                    ev.set()
            fr = getattr(osd.ctx, "flight_recorder", None)
            if fr is not None:
                fr.span("dedup_paced", t0,
                        meta={"pgid": str(pg.pgid),
                              "paced": granted})

    # -- read path ---------------------------------------------------------

    async def _maybe_read_manifested(self, pg, conn, msg) -> bool:
        """Serve the op list from materialized logical bytes when the
        read target is manifested; False delegates to the ordinary
        sync read path (raw objects, snapped reads resolving to raw
        clones, pgls-only lists)."""
        from ..osd import snaps as snapmod
        from ..store.objectstore import NOSNAP
        osd = self.osd
        snapid = getattr(msg, "snapid", None)
        ho = None
        if msg.oid:
            if snapid not in (None, NOSNAP):
                ho = snapmod.resolve_read_snap(
                    osd.store, pg, msg.oid, snapid)
            else:
                ho = hobject_t(msg.oid)
                if snapmod.is_whiteout(osd.store, pg.cid, ho):
                    ho = None
        rows = self.manifest_rows(pg, ho) if ho is not None else None
        if not rows:
            return False
        try:
            raw = await self.materialize(pg, rows)
        except ObjecterError as e:
            self._reply_error(conn, msg, str(e), finish="read_done")
            return True
        outs: list = []
        result = 0
        for op in msg.ops:
            name = op["op"]
            if name == "read":
                off = op.get("offset", 0)
                length = op.get("length", 0) or -1
                outs.append({"data": raw[off:] if length < 0
                             else raw[off:off + length]})
            elif name == "stat":
                outs.append({"size": len(raw)})
            else:
                o2, r2 = osd._do_read_ops(pg, msg.oid, [op], snapid,
                                          entity=msg.src)
                outs.extend(o2)
                if r2 != 0:
                    result = r2
        conn.send(MOSDOpReply(tid=msg.tid, result=result, outs=outs,
                              epoch=osd.osdmap.epoch, version=0))
        osd.perf.inc("ops")
        pg.stats.note_read(sum(len(o.get("data") or b"")
                               for o in outs if isinstance(o, dict)))
        osd._op_finish(msg, "read_done")
        return True

    # -- write path --------------------------------------------------------

    async def _plan_write(self, pg, conn, msg, chip) -> dict | None:
        """Build ``dedup_pre`` for `_execute_write`: chunk +
        fingerprint every manifestable writefull (one device dispatch
        batch each), ref-or-store each unique fingerprint, and stage
        a materialized raw image when an in-place mutator targets a
        manifested object.  Returns None when an error reply was
        already sent; otherwise the plan consumed by `_release_refs`
        after the mutation lands."""
        from ..device.runtime import DeviceBusy, DeviceLost
        osd = self.osd
        pool = osd.osdmap.pools.get(pg.pool_id)
        cpool = getattr(pool, "dedup_chunk_pool", -1)
        tag = self.ref_tag(pg.pool_id, msg.oid)
        stats = self._stats(pg.pool_id)
        snapc = getattr(msg, "snapc", None)
        # snapshots and dedup do not compose: a clone would share the
        # head's chunks without holding refs of its own, so snapped
        # writes store raw — and a manifested object is converted
        # back to raw (one ordinary replicated writefull through the
        # objecter; the snappy guard below keeps IT raw) before its
        # first snapped mutation clones anything
        snappy = bool(getattr(pool, "snaps", None)) \
            or bool(snapc and list(snapc[1]))
        old_rows = self.manifest_rows(pg, hobject_t(msg.oid)) or []
        old_fps = {str(r[0]) for r in old_rows}
        if snappy and old_rows:
            try:
                raw = await self.materialize(pg, old_rows)
                r, _outs = await self.objecter.op(
                    pg.pool_id, msg.oid,
                    [{"op": "writefull", "data": raw}])
                if r != 0:
                    raise ObjecterError("raw conversion r=%d" % r)
            except ObjecterError as e:
                self._reply_error(conn, msg, str(e))
                return None
            old_rows, old_fps = [], set()
        manifest: dict[int, tuple[bytes, int] | None] = {}
        acquired: set[str] = set()
        # plan every manifestable writefull: boundaries + fingerprints
        # in ONE device dispatch batch each, then ref-or-store per
        # unique fingerprint; any chunk-store failure degrades THIS
        # op to a raw store (its refs rolled back by _release_refs)
        wf = [(i, op["data"]) for i, op in enumerate(msg.ops)
              if op.get("op") == "writefull"]
        plan = [(i, d) for i, d in wf
                if not snappy and len(d) >= CHUNK_MIN]
        for i, _d in wf:
            manifest[i] = None      # raw unless planning succeeds
        if plan and cpool >= 0:
            try:
                cuts, cpath = await boundary_batch(
                    [d for _i, d in plan], chip=chip.index,
                    device=osd.device)
                chunks = [split(d, c)
                          for (_i, d), c in zip(plan, cuts)]
                flat = [c for cl in chunks for c in cl]
                fps_flat, fpath = await fingerprint_batch(
                    flat, chip=chip.index, device=osd.device)
                if cpath == "device":
                    osd.perf.inc("dedup_chunk_device")
                if fpath == "device":
                    osd.perf.inc("dedup_fp_device")
                osd._op_event(msg, "dedup_planned")
                # per-op fingerprint rows, then ref-or-store each
                # unique fingerprint once
                sizes: dict[str, int] = {}
                by_fp: dict[str, bytes] = {}
                per_op: list[list[str]] = []
                k = 0
                for (_i, _d), cl in zip(plan, chunks):
                    fps = fps_flat[k:k + len(cl)]
                    k += len(cl)
                    per_op.append(fps)
                    for fp, c in zip(fps, cl):
                        sizes[fp] = len(c)
                        by_fp[fp] = c
                for fp in sorted(by_fp):
                    c = by_fp[fp]
                    r, outs = await self.objecter.op(
                        cpool, chunk_oid(fp),
                        [{"op": "call", "cls": "refcount",
                          "method": "get", "input": {"tag": tag}}])
                    if r != 0:
                        raise ObjecterError(
                            "refcount.get %s r=%d" % (fp, r))
                    acquired.add(fp)
                    cls_out = outs[0].get("out") or {}
                    committed = int(cls_out.get("size", 0))
                    if committed == 0:
                        # every size-0 holder stores the bytes
                        # (idempotent: content-addressed, any racer
                        # writes the identical image)
                        r2, _o2 = await self.objecter.op(
                            cpool, chunk_oid(fp),
                            [{"op": "writefull", "data": c}])
                        if r2 != 0:
                            raise ObjecterError(
                                "chunk store %s r=%d" % (fp, r2))
                    if cls_out.get("created"):
                        # only the get that brought the chunk into
                        # existence accounts it as stored — the cls
                        # serializes on the chunk primary, so exactly
                        # one racer sees created (size alone would
                        # double-count ref-or-store races)
                        stats["chunks_stored"] += 1
                        stats["bytes_stored"] += len(c)
                        osd.perf.inc("dedup_chunks_stored")
                    else:
                        stats["chunks_deduped"] += 1
                        stats["bytes_saved"] += len(c)
                        osd.perf.inc("dedup_chunks_deduped")
                        osd.perf.inc("dedup_bytes_saved", len(c))
                for (i, d), fps in zip(plan, per_op):
                    blob = denc.encode(
                        [[fp, sizes[fp]] for fp in fps])
                    manifest[i] = (blob, len(d))
            except ObjecterError:
                # raw-first degradation: the acked write must not
                # depend on the chunk store; refs taken for THIS op
                # are rolled back by _release_refs (an orphan is
                # benign — presence-based, released on the next
                # successful rewrite or delete of this object)
                for i, _d in plan:
                    manifest[i] = None
            except (DeviceBusy, DeviceLost, IOError) as e:
                # no host route: a refused or failed dispatch (taken
                # before any ref) fails the op
                self._reply_error(conn, msg, repr(e))
                return None
        # a manifested object mutated in place (offset write,
        # truncate, cls call) needs its raw bytes staged first
        materialize = None
        if old_rows and any(op.get("op") in _RAW_MUTATORS
                            for op in msg.ops):
            try:
                materialize = await self.materialize(pg, old_rows)
            except ObjecterError as e:
                self._reply_error(conn, msg, str(e))
                return None
        return {"pre": {"manifest": manifest,
                        "materialize": materialize},
                "old_fps": old_fps, "acquired": acquired,
                "cpool": cpool, "tag": tag}

    async def _release_refs(self, pg, msg, plan: dict) -> None:
        """Release refs the committed state no longer holds: compare
        what IS stored now against everything previously held or
        acquired during planning — covers rewrites (old-new), deletes
        (all old), and failed/degraded writes (planning refs only).
        The chunk store self-deletes a chunk on its last put."""
        now_fps = set(self.manifest_fps(pg, msg.oid) or [])
        drop = (plan["old_fps"] | plan["acquired"]) - now_fps
        for fp in sorted(drop):
            try:
                await self.objecter.op(
                    plan["cpool"], chunk_oid(fp),
                    [{"op": "call", "cls": "refcount",
                      "method": "put", "input": {"tag": plan["tag"]}}])
                # ENOENT ("no such tag" / object gone) is benign:
                # tags are presence-based and this tag may have been
                # released by a racing rewrite of the same object
            except ObjecterError:
                pass    # unreachable chunk pool: orphaned ref, benign
