"""librados-equivalent client: cluster handle, IoCtx, Objecter.

Analog of src/librados (RadosClient/IoCtx) over src/osdc/Objecter.cc:
the client computes placement itself from its subscribed OSDMap
(_calc_target, Objecter.cc:2776 — the same pg_to_up_acting_osds
pipeline every daemon runs), sends MOSDOp straight to the acting
primary, and owns all retry logic: on every new map epoch it re-targets
in-flight ops and resends those whose primary moved (handle_osd_map ->
_scan_requests, Objecter.cc:1303,2091); a connection reset requeues
everything that was in flight on that session (lossy client policy —
the reference's RESETSESSION handling).
"""

from __future__ import annotations

import asyncio
import random

from ..msg import Messenger
from ..msg.messenger import ms_compress_from_conf
from ..msg.messages import (MConfig, MMonCommand, MMonCommandAck,
                            MMonEvents, MMonSubscribe, MMonWatchEvents,
                            MOSDBackoff, MOSDMapMsg, MOSDOp, MOSDOpReply,
                            MWatchNotify)
from ..osd.osdmap import OSDMap, consume_map_payload, pg_t
from ..utils.backoff import ExpBackoff
from ..utils.context import Context


class RadosError(Exception):
    def __init__(self, code: int, detail=None):
        super().__init__("rados error %d: %r" % (code, detail))
        self.code = code
        self.detail = detail


class ObjectNotFound(RadosError):
    """ENOENT surface — a RadosError subclass so callers matching the
    documented errno contract (`except RadosError as e: e.code`)
    catch it too."""

    def __init__(self, oid):
        super().__init__(-2, oid)


class _InFlight:
    __slots__ = ("tid", "pool", "oid", "ops", "future", "target",
                 "pgid", "acting", "snapc", "snapid", "backoff",
                 "next_resend", "first_sent", "trace", "top",
                 "tenant")

    def __init__(self, tid, pool, oid, ops, future, snapc=None,
                 snapid=None, tenant=None):
        self.tid = tid
        self.pool = pool
        self.oid = oid
        self.ops = ops
        self.future = future
        self.target = -1        # osd the op was last sent to
        self.pgid = None
        self.acting: list = []  # acting set at send time
        self.snapc = snapc      # (seq, [snapids desc]) on writes
        self.snapid = snapid    # read-from-snapshot id
        self.backoff = None     # ExpBackoff ramp (set on first send)
        self.next_resend = 0.0  # loop.time() the resend tick may fire
        self.first_sent = 0.0
        self.trace = None       # cross-daemon span id (reqid_t role)
        self.top = None         # TrackedOp in the client's OpTracker
        self.tenant = tenant    # tenant key stamped on every send


class RadosClient:
    """Cluster handle (librados::Rados / RadosClient)."""

    # op resend ramp: base far above a healthy op round trip so only
    # genuinely lost ops (dropped frames, dead primaries the map has
    # not yet condemned) re-fire; cap bounds recovery latency
    OP_RESEND_BASE = 0.5
    OP_RESEND_CAP = 5.0

    def __init__(self, mon_addr, ctx: Context | None = None,
                 name: str = "client.0", seed: int | None = None):
        self.ctx = ctx or Context(name)
        # mon_addr: one address or the monmap address list; commands
        # and subscriptions fail over across them (MonClient hunting)
        self.mon_addrs = ([mon_addr] if isinstance(mon_addr, str)
                          else list(mon_addr))
        self._mon_i = 0
        # seeded mode: jittered waits (op resend, mon hunting) draw
        # from a deterministic stream, for replayable fault schedules
        self.rng = (random.Random("%s|%s" % (seed, name))
                    if seed is not None else random.Random())
        from ..msg.auth import AuthContext
        self.msgr = Messenger(
            name, auth=AuthContext.from_conf(self.ctx.conf),
            compress=ms_compress_from_conf(self.ctx.conf), seed=seed)
        self.msgr.add_dispatcher(self)
        # epoch-0 empty map is the universal incremental base
        self.osdmap: OSDMap = OSDMap()
        self._map_event = asyncio.Event()
        # (epoch, future) waiters resolved by _handle_map — the
        # event-driven wait_for_epoch (no fixed-interval polling)
        self._map_waiters: list = []
        self._tid = 0
        self._inflight: dict[int, _InFlight] = {}
        self._cmd_futures: dict[int, asyncio.Future] = {}
        # (pool, oid) -> callback(payload); re-registered on map change
        self._watch_cbs: dict[tuple, object] = {}
        # cluster event-bus subscription (watch_events): callback per
        # event row, cursor = highest seq delivered.  Seqs are
        # cluster-wide identical, so the cursor survives mon failover
        # — re-subscribing anywhere resumes with no gaps or dups
        self._event_cb = None
        self._event_cursor = 0
        # (pool, ps, oid|None) -> (primary_osd, backoff_id): PGs (oid
        # None) or single degraded objects an OSD told us to stop
        # resending to (MOSDBackoff); cleared on unblock, on a primary
        # change, or on that OSD's session reset
        self._backoffs: dict[tuple, tuple] = {}
        self._resend_task = None
        # client-side op tracking (Objecter's slice of the op span):
        # every submit registers with trace id "<entity>:<tid>", which
        # rides the MOSDOp envelope into the OSD pipeline
        from ..trace import OpTracker
        self.optracker = OpTracker(self.ctx, name)

    @property
    def mon_addr(self) -> str:
        return self.mon_addrs[self._mon_i % len(self.mon_addrs)]

    def _next_mon(self) -> None:
        self._mon_i = (self._mon_i + 1) % len(self.mon_addrs)

    # -- lifecycle ---------------------------------------------------------

    async def connect(self, timeout: float = 10.0) -> None:
        """Hunt through the monmap until a monitor answers the
        subscription (MonClient::hunt), pacing attempts with an
        exponential-backoff ramp + jitter instead of a fixed 2s tick
        so a mon flap does not synchronize every client's retry."""
        deadline = asyncio.get_running_loop().time() + timeout
        hunt = ExpBackoff(base=0.3, cap=2.0, rng=self.rng)
        while True:
            self.msgr.send_to(self.mon_addr, MMonSubscribe(start=1),
                              entity_hint="mon.0")
            left = deadline - asyncio.get_running_loop().time()
            if left <= 0:
                raise asyncio.TimeoutError("no monitor reachable")
            try:
                await asyncio.wait_for(self._map_event.wait(),
                                       min(hunt.next_delay(), left))
                if self._resend_task is None:
                    self._resend_task = self.msgr.spawn(
                        self._resend_loop())
                return
            except asyncio.TimeoutError:
                self._next_mon()

    async def shutdown(self) -> None:
        await self.msgr.shutdown()
        self._resend_task = None

    def io_ctx(self, pool_name: str,
               tenant: str | None = None) -> "IoCtx":
        for pid, pool in (self.osdmap.pools if self.osdmap else {}) \
                .items():
            if pool.name == pool_name:
                return IoCtx(self, pid, tenant=tenant)
        raise ValueError("no pool %r" % pool_name)

    # -- dispatch ----------------------------------------------------------

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MConfig):
            self.ctx.conf.apply_mon_values(msg.values or {})
            return True
        if isinstance(msg, MMonEvents):
            self._handle_events(msg)
            return True
        if isinstance(msg, MOSDMapMsg):
            self._handle_map(msg)
        elif isinstance(msg, MOSDOpReply):
            self._handle_reply(msg)
        elif isinstance(msg, MMonCommandAck):
            fut = self._cmd_futures.pop(msg.tid, None)
            if fut is not None and not fut.done():
                fut.set_result((msg.result, msg.out))
        elif isinstance(msg, MOSDBackoff):
            self._handle_backoff(conn, msg)
        elif isinstance(msg, MWatchNotify):
            cb = self._watch_cbs.get((msg.pool, msg.oid))
            if cb is not None:
                try:
                    cb(bytes(msg.payload or b""))
                except Exception:
                    pass
            # ack so the notifier completes
            conn.send(MWatchNotify(pool=msg.pool, ps=msg.ps,
                                   oid=msg.oid,
                                   notify_id=msg.notify_id,
                                   payload=None, ack=True))
        else:
            return False
        return True

    def ms_handle_reset(self, conn) -> None:
        """Lossy session died: re-target in-flight ops.  Ops whose
        interval is unchanged stay queued — a dead osd produces a new
        map epoch, which is what actually re-routes them (the
        reference's kick_requests-on-reset + wait-for-map behavior).
        A reset of the MON link also dropped our subscription on the
        mon side, so renew it."""
        if conn.peer_addr in self.mon_addrs:
            if conn.peer_addr == self.mon_addr:
                self._next_mon()
            self.msgr.send_to(self.mon_addr,
                              MMonSubscribe(start=self.osdmap.epoch + 1),
                              entity_hint="mon.0")
            if self._event_cb is not None:
                # resume the event stream from the cursor — every
                # mon holds the identical committed sequence
                self.msgr.send_to(
                    self.mon_addr,
                    MMonWatchEvents(start=self._event_cursor),
                    entity_hint="mon.0")
        else:
            # an OSD session reset dropped our in-memory watches on
            # that primary even if the map is unchanged: re-register
            self._rewatch()
            # its backoffs died with the session (the reference drops
            # Backoffs on con reset): resume resending to those PGs
            osd = next((o for o, a in self.osdmap.osd_addrs.items()
                        if a == conn.peer_addr), None)
            if osd is not None:
                for key in [k for k, (po, _i) in
                            self._backoffs.items() if po == osd]:
                    del self._backoffs[key]
        self._scan_requests()

    # -- backoffs (osd_backoff / Objecter Backoff tracking) ----------------

    def _handle_backoff(self, conn, msg: MOSDBackoff) -> None:
        oid = getattr(msg, "oid", None)
        key = (msg.pool, msg.ps, oid)
        osd = next((o for o, a in self.osdmap.osd_addrs.items()
                    if a == conn.peer_addr), -1)
        if msg.op == "block":
            cur = self._backoffs.get(key)
            if cur is None or cur[1] < msg.id:
                self._backoffs[key] = (osd, msg.id)
        elif msg.op == "unblock":
            cur = self._backoffs.get(key)
            if cur is not None and cur[1] <= msg.id:
                del self._backoffs[key]
                # released: re-arm parked ops for an immediate retry
                now = asyncio.get_running_loop().time()
                for op in self._inflight.values():
                    if op.pgid is not None and \
                            (op.pool, op.pgid.ps) == key[:2] and \
                            (oid is None or op.oid == oid):
                        op.next_resend = now

    # -- event bus (watch-events subscription) -----------------------------

    def watch_events(self, callback, start: int = 0) -> None:
        """Stream the mon's committed cluster events (the reference's
        `ceph -w`): callback(row) per event, rows are
        {seq, type, stamp, message, data?} in seq order.  `start` is
        the exclusive cursor (0 = everything still retained).  The
        subscription rides the mon session: resets re-subscribe from
        the cursor, and the resend ticker renews it."""
        self._event_cb = callback
        self._event_cursor = max(int(start), 0)
        self.msgr.send_to(self.mon_addr,
                          MMonWatchEvents(start=self._event_cursor),
                          entity_hint="mon.0")

    def unwatch_events(self) -> None:
        self._event_cb = None

    def _handle_events(self, msg: MMonEvents) -> None:
        """One MMonEvents batch: rows at or below the cursor are
        duplicates (a renewal racing a push) and drop; the callback
        sees each seq exactly once, in order."""
        cb = self._event_cb
        for row in (msg.events or []):
            seq = int(row.get("seq") or 0)
            if seq <= self._event_cursor:
                continue
            self._event_cursor = seq
            if cb is not None:
                try:
                    cb(dict(row))
                except Exception:
                    pass

    def _backed_off(self, op: _InFlight) -> bool:
        """Blocked by a PG-wide backoff or an object-scoped one
        naming this op's oid (the reference's hobject-ranged
        Backoff::contains check)."""
        if op.pgid is None:
            return False
        return ((op.pool, op.pgid.ps, None) in self._backoffs
                or (op.pool, op.pgid.ps, op.oid) in self._backoffs)

    # -- maps --------------------------------------------------------------

    def _handle_map(self, msg: MOSDMapMsg) -> None:
        self.osdmap, changed = consume_map_payload(
            self.osdmap, msg.full, msg.incrementals)
        # any map receipt (even the pre-boot epoch-0 one) proves the
        # mon link is up — connect() must not hang on a fresh cluster
        self._map_event.set()
        if self._map_waiters:
            epoch = self.osdmap.epoch
            still = []
            for want, fut in self._map_waiters:
                if epoch >= want:
                    if not fut.done():
                        fut.set_result(None)
                else:
                    still.append((want, fut))
            self._map_waiters = still
        if changed and self.osdmap.epoch > 0:
            # a backoff is scoped to the primary that issued it: a
            # mapping change hands the PG to a new primary whose ops
            # must flow (it sends its own backoff if still unready)
            for key in list(self._backoffs):
                pool_id, ps, _oid = key
                if pool_id not in self.osdmap.pools:
                    del self._backoffs[key]
                    continue
                _up, _upp, _acting, primary = \
                    self.osdmap.pg_to_up_acting_osds(
                        pg_t(pool_id, ps))
                if primary != self._backoffs[key][0]:
                    del self._backoffs[key]
            self._scan_requests()
            self._rewatch()

    def _rewatch(self) -> None:
        """Re-register every watch after a map change: a primary
        migration dropped the in-memory registration on the old
        primary (librados notify_resend / re-watch behavior)."""
        for (pool_id, oid) in list(self._watch_cbs):
            self.submit_op(pool_id, oid, [{"op": "watch"}])

    def _scan_requests(self) -> None:
        """Re-target in-flight ops; resend those whose interval changed
        (Objecter::_scan_requests).  Any acting-set change counts: a
        replica death aborts the primary's in-flight repops, so the op
        must be resent even when the primary itself is unchanged."""
        for op in list(self._inflight.values()):
            if not op.oid:
                continue    # pg-targeted ops (pgls) are fire-once
            primary, pgid, acting = self._calc_target(op.pool, op.oid)
            if (primary != op.target or pgid != op.pgid
                    or acting != op.acting):
                self._send_op(op)

    # -- op submission -----------------------------------------------------

    def _calc_target(self, pool_id: int, oid: str):
        pool = self.osdmap.pools[pool_id]
        raw = self.osdmap.object_locator_to_pg(oid, pool_id)
        pgid = pool.raw_pg_to_pg(raw)  # Objecter.cc:2830
        up, upp, acting, actingp = \
            self.osdmap.pg_to_up_acting_osds(pgid)
        return actingp, pgid, acting

    def submit_op(self, pool_id: int, oid: str, ops: list[dict],
                  snapc=None, snapid=None,
                  tenant: str | None = None) -> asyncio.Future:
        self._tid += 1
        fut = asyncio.get_running_loop().create_future()
        op = _InFlight(self._tid, pool_id, oid, ops, fut,
                       snapc=snapc, snapid=snapid, tenant=tenant)
        op.trace = "%s:%d" % (self.msgr.entity, self._tid)
        op.top = self.optracker.create(
            "client_op(tid=%d pool=%d %s [%s])"
            % (self._tid, pool_id, oid,
               ",".join(o.get("op", "?") for o in ops)),
            trace=op.trace, tenant=tenant)
        self._inflight[self._tid] = op
        self._send_op(op)
        return fut

    async def list_objects(self, pool_id: int) -> list[str]:
        """Enumerate every object in the pool by walking its PGs with
        pgls ops (rados ls / Objecter pool nlist)."""
        pool = self.osdmap.pools[pool_id]
        names: list[str] = []
        for ps in range(pool.pg_num):
            pgid = pool.raw_pg_to_pg(pg_t(pool_id, ps))
            up, upp, acting, actingp =                 self.osdmap.pg_to_up_acting_osds(pgid)
            if actingp < 0:
                continue
            addr = self.osdmap.osd_addrs.get(actingp)
            if not addr:
                continue
            self._tid += 1
            fut = asyncio.get_running_loop().create_future()
            op = _InFlight(self._tid, pool_id, "", [{"op": "pgls"}],
                           fut)
            op.target = actingp
            op.pgid = pgid
            op.acting = acting
            self._inflight[self._tid] = op
            self.msgr.send_to(addr, MOSDOp(
                tid=op.tid, pool=pool_id, ps=pgid.ps, oid="",
                snapc=None, ops=op.ops, epoch=self.osdmap.epoch,
                flags=0), entity_hint="osd.%d" % actingp)
            try:
                outs = await asyncio.wait_for(fut, 10.0)
                names.extend(outs[0].get("names", []))
            except asyncio.TimeoutError:
                self._inflight.pop(op.tid, None)
        return sorted(set(names))

    def _send_op(self, op: _InFlight) -> None:
        loop = asyncio.get_running_loop()
        if op.backoff is None:
            op.backoff = ExpBackoff(base=self.OP_RESEND_BASE,
                                    cap=self.OP_RESEND_CAP,
                                    rng=self.rng)
            op.first_sent = loop.time()
        op.next_resend = loop.time() + op.backoff.next_delay()
        primary, pgid, acting = self._calc_target(op.pool, op.oid)
        op.target = primary
        op.pgid = pgid
        op.acting = acting
        if primary < 0:
            if op.top is not None:
                op.top.mark_event("no_primary")
            return  # no acting primary yet: wait for the next map
        addr = self.osdmap.osd_addrs.get(primary)
        if not addr:
            return
        m = MOSDOp(
            tid=op.tid, pool=op.pool, ps=pgid.ps, oid=op.oid,
            snapc=op.snapc, snapid=op.snapid, ops=op.ops,
            epoch=self.osdmap.epoch, flags=0)
        m.trace = op.trace
        m.tenant = op.tenant    # rides the envelope into every layer
        if op.top is not None:
            op.top.mark_event("sent_osd.%d" % primary)
        self.msgr.send_to(addr, m, entity_hint="osd.%d" % primary)

    async def _resend_loop(self) -> None:
        """Objecter op-retry ticker: any op still in flight past its
        jittered exponential-backoff deadline is re-sent (a dropped
        frame or a silently dead primary otherwise strands it until a
        map change).  PGs under an active MOSDBackoff are skipped —
        the OSD parked the op and will answer; resending would spam a
        peering PG (exactly what backoff exists to stop).

        The same ticker renews the map subscription
        (MonClient::renew_subs): publication is fire-and-forget, so
        an epoch silently lost to a partition or dropped frame would
        otherwise leave this client stale until the next commit."""
        renew_at = 0.0
        while True:
            await asyncio.sleep(0.1)
            now = asyncio.get_running_loop().time()
            if now >= renew_at:
                renew_at = now + self.ctx.conf[
                    "mon_subscribe_renew_interval"]
                self.msgr.send_to(
                    self.mon_addr,
                    MMonSubscribe(start=self.osdmap.epoch + 1),
                    entity_hint="mon.0")
                if self._event_cb is not None:
                    # renewal doubles as loss repair: any committed
                    # events a dropped push missed come back now
                    # (the cursor dedups the overlap)
                    self.msgr.send_to(
                        self.mon_addr,
                        MMonWatchEvents(start=self._event_cursor),
                        entity_hint="mon.0")
            for op in list(self._inflight.values()):
                if not op.oid or op.future.done():
                    continue    # pg-targeted (pgls) ops are fire-once
                if op.next_resend > now or self._backed_off(op):
                    continue
                self._send_op(op)

    def _handle_reply(self, msg: MOSDOpReply) -> None:
        op = self._inflight.pop(msg.tid, None)
        if op is None or op.future.done():
            return
        if op.top is not None:
            op.top.finish("reply_r%d" % (msg.result or 0))
        if msg.result == 0:
            op.future.set_result(msg.outs)
        elif msg.result == -2:
            op.future.set_exception(ObjectNotFound(op.oid))
        else:
            op.future.set_exception(RadosError(msg.result, msg.outs))

    # -- mon commands ------------------------------------------------------

    async def mon_command(self, prefix: str, timeout: float = 10.0,
                          **args) -> dict:
        """Send to the current mon; on -EHOSTDOWN (a peon's redirect,
        possibly carrying the leader's address) or a timeout, hunt
        through the monmap until the leader answers."""
        cmd = {"prefix": prefix}
        cmd.update(args)
        deadline = asyncio.get_running_loop().time() + timeout
        last_exc = None
        # hunting ramp: early retries are quick (a peon redirect
        # usually resolves in one hop), later ones back off so a
        # quorum-less cluster is not hammered (MonClient
        # reopen_session backoff)
        hunt = ExpBackoff(base=0.5, cap=2.0, rng=self.rng)
        redirect = ExpBackoff(base=0.1, cap=1.0, rng=self.rng)
        for _attempt in range(6 * len(self.mon_addrs)):
            left = deadline - asyncio.get_running_loop().time()
            if left <= 0:
                break
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_running_loop().create_future()
            self._cmd_futures[tid] = fut
            self.msgr.send_to(self.mon_addr,
                              MMonCommand(tid=tid, cmd=cmd),
                              entity_hint="mon.0")
            try:
                result, out = await asyncio.wait_for(
                    fut, min(max(hunt.next_delay(), 0.5), left))
            except asyncio.TimeoutError as e:
                last_exc = e
                self._next_mon()
                continue
            finally:
                self._cmd_futures.pop(tid, None)
            if result == -112:          # peon redirect
                leader = (out or {}).get("leader")
                if leader and leader in self.mon_addrs:
                    self._mon_i = self.mon_addrs.index(leader)
                else:
                    self._next_mon()
                await asyncio.sleep(min(redirect.next_delay(), left))
                continue
            if result != 0:
                raise RadosError(result, out)
            return out
        if last_exc is not None:
            raise RadosError(-110, {"error": "mon command timed out"})
        raise RadosError(-110, {"error": "no quorum"})

    async def wait_for_epoch(self, epoch: int,
                             timeout: float = 10.0) -> None:
        """Event-driven (no polling): _handle_map resolves the waiter
        the moment the epoch lands."""
        if self.osdmap is not None and self.osdmap.epoch >= epoch:
            return
        fut = asyncio.get_running_loop().create_future()
        self._map_waiters.append((epoch, fut))
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise TimeoutError("epoch %d not reached" % epoch) \
                from None
        finally:
            self._map_waiters = [(e, f) for e, f in self._map_waiters
                                 if f is not fut]


class IoCtx:
    """Per-pool I/O context (librados::IoCtx).

    Snapshots (librados snap API): writes carry a SnapContext — the
    pool's implicit one (pool snaps, Objecter::_op_submit) or a
    selfmanaged one set via set_selfmanaged_snapc; reads honor
    set_read_snap (IoCtx::snap_set_read)."""

    def __init__(self, client: RadosClient, pool_id: int,
                 tenant: str | None = None):
        self.client = client
        self.pool_id = pool_id
        # tenant key stamped on this handle's data-path ops: rides
        # the MOSDOp envelope into the OSD's tag books, the device
        # admission tickets, and the flight recorder's spans
        self.tenant = tenant
        self.read_snap: int | None = None    # snapid reads resolve at
        self.selfmanaged_snapc: tuple[int, list[int]] | None = None

    def _snapc(self):
        if self.selfmanaged_snapc is not None:
            return self.selfmanaged_snapc
        pool = (self.client.osdmap.pools.get(self.pool_id)
                if self.client.osdmap else None)
        if pool is not None and pool.snap_seq:
            return pool.snap_context()
        return None

    def set_read_snap(self, snapid: int | None) -> None:
        """Route subsequent reads to a snapshot (None = head)."""
        self.read_snap = snapid

    def set_selfmanaged_snapc(self, seq: int,
                              snaps: list[int] | None) -> None:
        """Application-managed write SnapContext (librados
        set_snap_write_context); snaps newest-first."""
        self.selfmanaged_snapc = ((int(seq),
                                   sorted(snaps or [], reverse=True))
                                  if seq else None)

    # -- pool snapshots (mon-managed ids) ---------------------------------

    async def _wait_pool(self, pred, timeout: float = 10.0) -> None:
        """Wait until the client's map reflects a pool mutation."""
        t0 = asyncio.get_running_loop().time()
        while not pred(self.client.osdmap.pools[self.pool_id]):
            if asyncio.get_running_loop().time() - t0 > timeout:
                raise TimeoutError("pool snap state never published")
            await asyncio.sleep(0.02)

    async def snap_create(self, name: str) -> int:
        pool = self.client.osdmap.pools[self.pool_id]
        res = await self.client.mon_command("osd pool mksnap",
                                            pool=pool.name, snap=name)
        sid = res["snapid"]
        await self._wait_pool(lambda p: sid in p.snaps)
        return sid

    async def snap_remove(self, name: str) -> None:
        pool = self.client.osdmap.pools[self.pool_id]
        sid = self.snap_lookup(name)
        await self.client.mon_command("osd pool rmsnap",
                                      pool=pool.name, snap=name)
        await self._wait_pool(lambda p: sid not in p.snaps)

    def snap_list(self) -> dict[int, str]:
        pool = self.client.osdmap.pools[self.pool_id]
        return dict(pool.snaps)

    def snap_lookup(self, name: str) -> int:
        for sid, n in self.snap_list().items():
            if n == name:
                return sid
        raise KeyError(name)

    # -- selfmanaged snapshots --------------------------------------------

    async def selfmanaged_snap_create(self) -> int:
        pool = self.client.osdmap.pools[self.pool_id]
        res = await self.client.mon_command("osd snap create",
                                            pool=pool.name)
        sid = res["snapid"]
        await self._wait_pool(lambda p: p.snap_seq >= sid)
        return sid

    async def selfmanaged_snap_remove(self, snapid: int) -> None:
        pool = self.client.osdmap.pools[self.pool_id]
        await self.client.mon_command("osd snap rm", pool=pool.name,
                                      snapid=int(snapid))

    # -- object I/O --------------------------------------------------------

    async def write(self, oid: str, data: bytes,
                    offset: int = 0) -> None:
        await self.client.submit_op(self.pool_id, oid, [
            {"op": "write", "offset": offset, "data": bytes(data)}],
            snapc=self._snapc(), tenant=self.tenant)

    async def write_full(self, oid: str, data: bytes) -> None:
        await self.client.submit_op(self.pool_id, oid, [
            {"op": "writefull", "data": bytes(data)}],
            snapc=self._snapc(), tenant=self.tenant)

    async def read(self, oid: str, length: int = 0,
                   offset: int = 0) -> bytes:
        outs = await self.client.submit_op(self.pool_id, oid, [
            {"op": "read", "offset": offset, "length": length}],
            snapid=self.read_snap, tenant=self.tenant)
        return outs[0]["data"]

    async def stat(self, oid: str) -> int:
        outs = await self.client.submit_op(self.pool_id, oid, [
            {"op": "stat"}], snapid=self.read_snap,
            tenant=self.tenant)
        return outs[0]["size"]

    async def remove(self, oid: str) -> None:
        await self.client.submit_op(self.pool_id, oid, [
            {"op": "delete"}], snapc=self._snapc(),
            tenant=self.tenant)

    async def truncate(self, oid: str, length: int) -> None:
        await self.client.submit_op(self.pool_id, oid, [
            {"op": "truncate", "length": int(length)}],
            snapc=self._snapc(), tenant=self.tenant)

    async def exec(self, oid: str, cls: str, method: str,
                   inp: dict | None = None) -> dict:
        """Run an in-OSD object-class method (librados exec /
        CEPH_OSD_OP_CALL): the primary routes it to the read or write
        interpreter by the method's registered RD/WR flags and returns
        the method's output dict.  Errors surface as RadosError with
        the method's errno-style code."""
        outs = await self.client.submit_op(self.pool_id, oid, [
            {"op": "call", "cls": cls, "method": method,
             "input": dict(inp or {})}], snapc=self._snapc())
        return outs[0].get("out", {})

    async def watch(self, oid: str, callback) -> None:
        """Register interest: callback(payload) runs on every notify
        (librados watch2).  The callback registers only after the
        primary accepted the watch — a failed op (e.g. unsupported
        pool type) must not leave a resend-forever stale entry."""
        await self.client.submit_op(self.pool_id, oid,
                                    [{"op": "watch"}])
        self.client._watch_cbs[(self.pool_id, oid)] = callback

    async def unwatch(self, oid: str) -> None:
        self.client._watch_cbs.pop((self.pool_id, oid), None)
        await self.client.submit_op(self.pool_id, oid,
                                    [{"op": "unwatch"}])

    async def notify(self, oid: str, payload: bytes = b"",
                     timeout: float = 5.0) -> int:
        """Deliver payload to every watcher; returns acked count
        (librados notify2)."""
        outs = await self.client.submit_op(self.pool_id, oid, [
            {"op": "notify", "payload": bytes(payload),
             "timeout": timeout}])
        return outs[0]["acked"]

    async def setxattr(self, oid: str, name: str, value: bytes) -> None:
        await self.client.submit_op(self.pool_id, oid, [
            {"op": "setxattr", "name": name, "value": bytes(value)}])

    async def getxattr(self, oid: str, name: str) -> bytes:
        outs = await self.client.submit_op(self.pool_id, oid, [
            {"op": "getxattr", "name": name}], snapid=self.read_snap)
        return outs[0]["value"]

    async def omap_rm(self, oid: str, keys: list[bytes]) -> None:
        await self.client.submit_op(self.pool_id, oid, [
            {"op": "omap-rm", "keys": [bytes(k) for k in keys]}])

    async def omap_set(self, oid: str, kv: dict) -> None:
        await self.client.submit_op(self.pool_id, oid, [
            {"op": "omap-set", "kv": dict(kv)}])

    async def omap_get(self, oid: str) -> dict:
        outs = await self.client.submit_op(self.pool_id, oid, [
            {"op": "omap-get"}])
        return outs[0]["kv"]
