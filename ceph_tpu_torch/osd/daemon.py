"""OSD daemon: the data-plane process serving PGs.

Condensed analog of src/osd/OSD.cc + PrimaryLogPG.cc for the replicated
path, on asyncio:

boot      OSD::init (OSD.cc:3592): mount store, load PGs from
          collections, subscribe to the monitor, MOSDBoot, consume maps.
maps      handle_osd_map / advance_map: apply incrementals in order;
          interval changes drive per-PG peering (PeeringState AdvMap).
ops       ms_fast_dispatch -> dequeue_op -> PrimaryLogPG::do_request:
          primary executes the op list (do_osd_ops interpreter),
          replicates via MOSDRepOp (ReplicatedBackend::submit_transaction,
          ReplicatedBackend.cc:465), acks -> client reply.
peering   GetInfo/GetLog via MOSDPGQuery -> MOSDPGLog; authoritative log
          selection (find_best_info), activation MOSDPGLog to replicas,
          missing-set computation.
recovery  log-based: pull objects the primary lacks (MOSDPGPull ->
          MOSDPGPush), push to replicas missing them; whole-object
          granularity (recovery_state flow of ECBackend/ReplicatedBackend
          simplified to PushOp full-object form).
failure   OSD<->OSD heartbeats (OSD.cc:5436,5575) -> MOSDFailure reports
          to the monitor with failed_for durations.

The heavy mapping work (which PGs live here) runs through the same
pg_to_up_acting_osds pipeline every node computes; bulk priming for
large pools can use parallel.mapping.OSDMapMapping.
"""

from __future__ import annotations

import asyncio
import time

from ..msg import Messenger
from ..msg.messenger import ms_compress_from_conf, Policy
from ..msg.messages import (MConfig, MMonSubscribe, MOSDAlive,
                            MOSDBackoff, MOSDBoot,
                            MOSDECSubOpRead, MOSDECSubOpReadReply,
                            MOSDECSubOpWrite, MOSDECSubOpWriteReply,
                            MOSDFailure, MOSDMapMsg, MOSDOp,
                            MOSDOpReply, MOSDPGLog, MOSDPGPush,
                            MOSDPGPushReply, MOSDPGQuery, MOSDPing,
                            MOSDRepOp, MOSDRepOpReply, MOSDRepScrub,
                            MOSDRepScrubMap, MOSDScrub, MWatchNotify)
from ..models.crushmap import ITEM_NONE
from ..store.memstore import MemStore
from ..store.objectstore import (NotFound, ObjectStore, Transaction,
                                 coll_t, hobject_t)
from ..utils import denc
from ..utils.context import Context
from .osdmap import OSDMap, consume_map_payload, pg_t
from .pg import (PG, STATE_ACTIVE, STATE_PEERING, STATE_REPLICA,
                 LogEntry, PGInfo)


# `_bulk_mapping`'s answer when the epoch must wait for the chip
_MAP_DEFERRED = object()


class OSD:
    def __init__(self, whoami: int, mon_addr,
                 ctx: Context | None = None,
                 store: ObjectStore | None = None, device=None):
        from .. import default_device
        self.whoami = whoami
        # the device this daemon's chip runs on (default: the card)
        self.device = default_device(device)
        # one address or the monmap list: maps are subscribed from one
        # mon (rotating on faults), state reports (boot/failure/alive)
        # are broadcast to all so the current leader always sees them
        self.mon_addrs = ([mon_addr] if isinstance(mon_addr, str)
                          else list(mon_addr))
        self._mon_i = whoami % max(1, len(self.mon_addrs))
        self.ctx = ctx or Context("osd.%d" % whoami)
        from ..store import create_store

        self.store = store or create_store(self.ctx.conf, whoami)
        from ..msg.auth import AuthContext
        self.msgr = Messenger(
            "osd.%d" % whoami,
            auth=AuthContext.from_conf(self.ctx.conf),
            compress=ms_compress_from_conf(self.ctx.conf))
        self.msgr.peer_policy["osd"] = Policy.lossless_peer()
        self.msgr.add_dispatcher(self)
        from .cls import default_handler
        from .ecbackend import ECPGBackend
        from .scheduler import OpScheduler
        from .scrubber import Scrubber
        from .watch import WatchRegistry

        self.cls_handler = default_handler()
        # bound at start(): this OSD's mesh chip (ChipRuntime) —
        # deterministic OSD->chip affinity, the per-chip isolation
        # domain its EC flushes and bulk mapping dispatch on
        self.device_chip = None
        self.ec = ECPGBackend(self)
        self.scrubber = Scrubber(self)
        self.watches = WatchRegistry(self)
        # request-level observability (TrackedOp/OpTracker): every
        # client op / sub-op registers here with its trace id; the
        # admin socket serves dump_ops_in_flight & friends and the
        # heartbeat loop beacons the slow-op count to the mon
        from ..trace import LogClient, OpTracker
        self.optracker = OpTracker(self.ctx, "osd.%d" % whoami)
        # cluster-log handle (LogClient): daemon events reach the
        # mon's LogMonitor (paxos-committed `log last`); entries are
        # broadcast like beacons and re-flushed until a mon acks the
        # commit
        self.clog = LogClient(self.ctx, "osd.%d" % whoami,
                              send_fn=self._send_mons)
        # crash reports recovered from the store at mount, shipped to
        # the mons until acked (MCrashReport -> crash table)
        self._crash_pending: list[dict] = []
        self._crash_ship_stamp = 0.0
        # unhandled exceptions escaping spawned tasks become crash
        # reports in the daemon's own store (the post-mortem artifact
        # that survives the process)
        self.msgr.crash_hook = self._record_crash
        self.perf = self.ctx.perf.create("osd")
        self.perf.add_u64("ops", "client ops completed")
        self.perf.add_u64("dup_ops",
                          "client resends answered from the reqid"
                          " journal")
        self.perf.add_u64("slow_ops",
                          "in-flight ops past osd_op_complaint_time")
        self.perf.add_hist("op_queue_wait",
                           "mClock shard queue wait (us, pow2)")
        self.perf.add_u64("map_deferred",
                          "map epochs whose bulk mapping waited for"
                          " this daemon's chip")
        self.perf.add_hist("op_subop_rtt",
                           "replicated sub-op round trip (us, pow2)")
        self.perf.add_hist("op_ec_batch_wait",
                           "EC encode incl device batch wait"
                           " (us, pow2)")
        self.perf.add_hist("op_ec_device_dispatch",
                           "device EC batch flush time (us, pow2)")
        # integrity plane: scrub rounds, what they found/fixed, and
        # the digests computed in device lanes
        self.perf.add_u64("scrubs", "shallow scrub rounds completed")
        self.perf.add_u64("deep_scrubs", "deep scrub rounds completed")
        self.perf.add_u64("scrub_errors_found",
                          "inconsistencies flagged by scrubs")
        self.perf.add_u64("scrub_repaired",
                          "divergent copies rewritten by repair"
                          " scrubs")
        self.perf.add_u64("scrub_digest_device",
                          "scrub digests computed in device crc32"
                          " lanes")
        self.perf.add_u64("comp_paced_ops",
                          "compression-pool ops paced through the"
                          " background device class")
        self.perf.add_u64("comp_device_blobs",
                          "writefull blobs whose tlz match planning"
                          " dispatched on this daemon's chip")
        self.perf.add_u64("comp_size_mismatches",
                          "reads refused because comp-size disagreed"
                          " with the decompressed length")
        # data-reduction plane: dedup-pool ops paced through the
        # background class, the write batches chunked and
        # fingerprinted in device lanes, and what the chunk store
        # absorbed vs deduplicated
        self.perf.add_u64("dedup_paced_ops",
                          "dedup-pool ops paced through the"
                          " background device class")
        self.perf.add_u64("dedup_chunk_device",
                          "write batches whose chunk boundaries"
                          " resolved from device candidate masks")
        self.perf.add_u64("dedup_fp_device",
                          "write batches fingerprinted in device"
                          " crc32 lanes")
        self.perf.add_u64("dedup_chunks_stored",
                          "chunks this osd stored as new chunk-pool"
                          " objects")
        self.perf.add_u64("dedup_chunks_deduped",
                          "chunks answered by an existing chunk-pool"
                          " object (a ref, no bytes)")
        self.perf.add_u64("dedup_bytes_saved",
                          "logical bytes deduplicated away (refs"
                          " instead of stored copies)")
        # the primary's side of the data-reduction plane (chunking,
        # fingerprints, refcounted chunk store, internal objecter)
        from ..dedup import DedupPlane
        self.dedup = DedupPlane(self)
        # repair-traffic plane: what recovery actually moved, split
        # by whether the minimal-shard-set (targeted) repair served
        # it or the whole-object read + re-encode fallback did
        self.perf.add_u64("repair_bytes_read",
                          "survivor shard bytes read to rebuild"
                          " lost shards")
        self.perf.add_u64("repair_bytes_moved",
                          "rebuilt shard bytes written/pushed by"
                          " recovery")
        self.perf.add_u64("repair_targeted",
                          "shards rebuilt from the codec's minimal"
                          " shard set")
        self.perf.add_u64("repair_full",
                          "shards rebuilt via whole-object read +"
                          " re-encode")
        # network observability plane: messenger lossless-resend /
        # replay / mark_down totals surfaced as per-daemon counters,
        # plus the per-peer heartbeat RTT tracker (admin:
        # dump_osd_network; beacon net slice -> OSD_SLOW_PING_TIME)
        self.perf.add_u64("msgr_resends",
                          "lossless payloads requeued for session"
                          " replay after reconnect")
        self.perf.add_u64("msgr_replays",
                          "duplicate frames absorbed by seq dedup"
                          " after reconnect")
        self.perf.add_u64("msgr_mark_downs",
                          "administrative connection teardowns")
        from .network import OsdNetwork
        self.network = OsdNetwork(self.ctx)
        self._net_prev: dict | None = None
        self._beacon_stamp = 0.0
        # one periodic scrub at a time per daemon (the reference's
        # scrubs_local bound collapsed to 1)
        self._scrub_running = False
        # long-flow progress rows (recovery drains, scrub sweeps):
        # shipped in osd_stats["progress"] each MMgrReport
        from .progress import ProgressTracker
        self.progress = ProgressTracker()
        # client write-size histogram (pow2 byte buckets, cumulative):
        # reported to the mgr for the cluster op-size profile and used
        # to derive workload-aware device warmup buckets (bucket i
        # counts writes of [2^i, 2^(i+1)) payload bytes)
        self.op_size_hist: list[int] = [0] * 32
        # tenant SLO plane: per-tenant stage histograms (pow2 µs
        # buckets, cumulative — the same shape as the perf hists) and
        # good/bad op counters, shipped in MMgrReport osd_stats so the
        # mgr's SLO engine can evaluate per-tenant burn rates.
        # Cardinality is conf-bounded (`tenant_tracking_max`):
        # overflow tenants fold into the "other" bucket rather than
        # growing the report without bound.
        self.tenant_stages: dict[str, dict[str, list[int]]] = {}
        self.tenant_ops: dict[str, dict[str, int]] = {}
        self.optracker.on_retire = self._note_op_retired
        # sharded mClock op queue (ShardedOpWQ + mClockScheduler);
        # tenant-stamped client ops run under per-tenant RWL tag books
        self.sched = OpScheduler(self.ctx)
        self.sched.on_wait = self._note_queue_wait
        # epoch-0 empty map is the universal incremental base
        self.osdmap: OSDMap = OSDMap()
        self.pgs: dict[pg_t, PG] = {}
        self.booted = False
        self.stopping = False
        self._boot_sent_epoch = -1
        self._rep_tid = 0
        self._backoff_id = 0        # monotonic MOSDBackoff ids
        self._waiting_for_map: list = []
        # map messages whose bulk mapping waits for this OSD's chip
        # (lost, or its mapping class full), replayed in epoch order
        self._deferred_maps: list = []
        # heartbeat state: peer -> last seen stamp
        self.hb_last_rx: dict[int, float] = {}
        # last observed pg_num per pool: a growth triggers the local
        # in-place PG split before mappings recompute
        self._pool_pg_num: dict[int, int] = {}
        self._tasks = []

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self.store.mount()
        # previous incarnation's crash reports (the reboot ships them
        # to the mons; the paxos-committed ack clears them here)
        from ..utils import crash as crashmod
        self._crash_pending = crashmod.pending_crashes(self.store)
        # clog seq floor: resume ABOVE the previous incarnation's
        # last-used seq (persisted per emit) so the LogMonitor's
        # (who, inc, seq) dedup never swallows reborn entries and
        # pre-restart unacked entries cannot supersede them.  A WIPED
        # store lost the floor — mint a fresh (larger) boot
        # incarnation instead, so seqs restarting from 1 re-key as
        # new entries rather than replaying committed ones
        clog_inc = crashmod.load_clog_incarnation(self.store)
        if not clog_inc:
            clog_inc = crashmod.new_clog_incarnation()
            crashmod.save_clog_incarnation(self.store, clog_inc)
        self.clog.resume_above(crashmod.load_clog_seq(self.store),
                               incarnation=clog_inc)
        self.clog.on_seq = \
            lambda s: crashmod.save_clog_seq(self.store, s)
        if self._crash_pending:
            self.ctx.log.info(
                "osd", "osd.%d found %d pending crash report(s)"
                % (self.whoami, len(self._crash_pending)))
        addr = await self.msgr.bind(host, port)
        self.sched.start(self.msgr.spawn)
        self._load_pgs()
        # device runtime: adopt this daemon's queue bounds, bind this
        # OSD to its mesh chip (deterministic affinity — co-located
        # daemons land on distinct chips, so one chip's loss degrades
        # only its own OSDs), and beacon chip-loss transitions
        # immediately (a mapping storm or chip loss must reach the
        # mon's health checks within one beacon, not one reporting
        # interval)
        from ..device.runtime import DeviceRuntime
        rt = DeviceRuntime.get(self.device)
        rt.configure(self.ctx.conf)
        self.device_chip = rt.chip_for(self.whoami)
        self.device_chip.add_listener(self._on_device_state)
        mon = self.msgr.connect_to(self.mon_addr, entity_hint="mon.0")
        mon.send(MMonSubscribe(start=1))
        self._tasks.append(self.msgr.spawn(self._mon_watchdog()))
        self._tasks.append(self.msgr.spawn(self._heartbeat_loop()))
        return addr

    def _on_device_state(self, lost: bool) -> None:
        """This OSD's mesh chip lost/healed: beacon the new state
        now, and tell the cluster log (the daemon-origin side of the
        per-chip DEVICE_LOST story; the mon clogs the health
        edge, naming the chip).  The heal edge replays the map epochs
        that waited for the chip."""
        if not lost and self._deferred_maps and not self.stopping:
            self._replay_deferred_maps()
        if self.stopping or not self.booted:
            return
        chip = (self.device_chip.index
                if self.device_chip is not None else 0)
        self.ctx.log.info(
            "osd", "osd.%d device chip %d %s"
            % (self.whoami, chip,
               "LOST: its ops fail until the probe heals it"
               if lost else "healed"))
        if lost:
            self.clog.warn("osd.%d device chip %d lost, its ops fail "
                           "until the probe heals it"
                           % (self.whoami, chip))
        else:
            self.clog.info("osd.%d device chip %d healed"
                           % (self.whoami, chip))
        self._beacon_stamp = 0.0        # bypass the report interval
        self._maybe_send_beacon()

    # -- crash telemetry (utils.crash + the mon's crash table) -------------

    def _record_crash(self, exc: BaseException) -> str | None:
        """Write a crash report — stack, LogRing tail, identity —
        into this daemon's OWN store (the artifact that survives the
        process), queued for shipping to the mons."""
        from ..utils import crash as crashmod
        try:
            report = crashmod.build_report(
                "osd.%d" % self.whoami, exc,
                fsid=getattr(self.osdmap, "fsid", "") or "",
                epoch=self.osdmap.epoch if self.osdmap else 0,
                ring=self.ctx.log.ring,
                tail=int(self.ctx.conf.get("osd_crash_ring_tail",
                                           100)))
            crashmod.save_crash(self.store, report)
        except Exception:
            return None     # the crash path must never crash
        self._crash_pending.append(report)
        self.ctx.log.error(
            "osd", "osd.%d crash recorded (%s): %s: %s"
            % (self.whoami, report["crash_id"],
               report["exc_type"], report["exc_msg"]))
        return report["crash_id"]

    def simulate_crash(self, exc: BaseException) -> str | None:
        """Test/thrasher hook: die on an injected exception exactly
        like an unhandled one — raise it for a real traceback, record
        the report, leave the daemon to be hard-stopped by the
        caller."""
        try:
            raise exc
        except type(exc) as caught:
            return self._record_crash(caught)

    def _maybe_ship_crashes(self) -> None:
        """Re-broadcast pending crash reports to every mon until the
        committed-table ack clears them (paced like beacons)."""
        if not self._crash_pending:
            return
        now = time.monotonic()
        if now - self._crash_ship_stamp < \
                self.ctx.conf["osd_beacon_report_interval"]:
            return
        self._crash_ship_stamp = now
        from ..msg.messages import MCrashReport
        self._send_mons(MCrashReport(
            reports=[dict(r) for r in self._crash_pending]))

    def _handle_crash_ack(self, crash_ids) -> None:
        from ..utils import crash as crashmod
        acked = set(crash_ids or [])
        if not acked:
            return
        for r in list(self._crash_pending):
            if r.get("crash_id") in acked:
                self._crash_pending.remove(r)
                try:
                    crashmod.remove_crash(self.store, r["crash_id"])
                except Exception:
                    pass

    async def wait_for_boot(self, timeout: float = 10.0) -> None:
        from ..utils.backoff import wait_for
        await wait_for(lambda: self.booted, timeout,
                       what="osd.%d boot" % self.whoami)

    async def shutdown(self) -> None:
        self.stopping = True
        self.sched.stop()
        await self.msgr.shutdown()
        self.store.umount()

    @property
    def mon_addr(self) -> str:
        return self.mon_addrs[self._mon_i % len(self.mon_addrs)]

    # -- observability helpers ---------------------------------------------

    def _note_queue_wait(self, klass: str, seconds: float,
                         tenant: str | None = None) -> None:
        from .scheduler import K_CLIENT
        if klass == K_CLIENT:
            self.perf.hist_sample("op_queue_wait", seconds)
            if tenant is not None:
                self.note_tenant_stage(tenant, "queue_wait", seconds)

    # -- tenant SLO accounting ---------------------------------------------

    def _tenant_key(self, tenant: str) -> str:
        """Bound tenant-label cardinality: past `tenant_tracking_max`
        distinct tenants, new ones fold into "other" (known tenants
        keep their own rows)."""
        if tenant in self.tenant_stages or tenant in self.tenant_ops:
            return tenant
        cap = int(self.ctx.conf.get("tenant_tracking_max", 64))
        known = set(self.tenant_stages) | set(self.tenant_ops)
        if len(known - {"other"}) >= cap:
            return "other"
        return tenant

    def note_tenant_stage(self, tenant: str, stage: str,
                          seconds: float) -> None:
        """One stage-latency sample for one tenant (pow2 µs buckets,
        cumulative — the per-tenant mirror of the op_* perf hists the
        SLO engine derives window deltas from)."""
        key = self._tenant_key(tenant)
        hist = self.tenant_stages.setdefault(key, {}).setdefault(
            stage, [0] * 32)
        us = max(1, int(seconds * 1e6))
        i = min(len(hist) - 1, max(0, us.bit_length() - 1))
        hist[i] += 1

    def note_tenant_op(self, tenant: str, ok: bool) -> None:
        key = self._tenant_key(tenant)
        row = self.tenant_ops.setdefault(key, {"ops": 0, "errors": 0})
        row["ops"] += 1
        if not ok:
            row["errors"] += 1

    # final events that count as availability failures for the
    # tenant's error budget (an errored reply; parked/dropped ops are
    # re-sent by the client and complete under a later record)
    _BAD_FINISH = frozenset({"error_reply", "ec_error_reply",
                             "no_such_pool"})

    def _note_op_retired(self, op) -> None:
        """OpTracker retire hook: end-to-end latency + availability
        accounting for tenant-stamped PRIMARY client ops (sub-ops are
        stages of the primary's sample, not ops of their own)."""
        if op.tenant is None or not op.desc.startswith("osd_op("):
            return
        final = op.events[-1][1]
        if final in ("dropped_not_primary", "dropped_pool_deleted",
                     "dropped_interval_change",
                     "dropped_wrong_pg_after_split"):
            return      # the client re-targets; not a completed op
        self.note_tenant_stage(op.tenant, "total", op.age)
        self.note_tenant_op(op.tenant, final not in self._BAD_FINISH)

    def note_op_size(self, nbytes: int) -> None:
        """Record one client write's payload size in the pow2
        histogram (feeds workload-aware device warmup + the mgr)."""
        if nbytes <= 0:
            return
        i = min(len(self.op_size_hist) - 1,
                max(0, int(nbytes).bit_length() - 1))
        self.op_size_hist[i] += 1

    def _track(self, msg, desc: str):
        """Register (once) a tracked op for an incoming message; the
        record rides the message object so park/requeue cycles keep
        one timeline (OpRequest wraps the Message the same way)."""
        top = getattr(msg, "_top", None)
        if top is None:
            top = self.optracker.create(
                desc, trace=getattr(msg, "trace", None),
                tenant=getattr(msg, "tenant", None))
            msg._top = top
            top.mark_event("queued")
        return top

    @staticmethod
    def _op_event(msg, event: str) -> None:
        top = getattr(msg, "_top", None)
        if top is not None:
            top.mark_event(event)

    @staticmethod
    def _op_finish(msg, event: str = "done") -> None:
        top = getattr(msg, "_top", None)
        if top is not None:
            top.finish(event)

    def _send_mons(self, msg) -> None:
        for i, addr in enumerate(self.mon_addrs):
            self.msgr.send_to(addr, msg, entity_hint="mon.%d" % i)

    async def _mon_watchdog(self) -> None:
        """A peon that stops leading (or a dead mon) leaves our boot
        unacknowledged: while unbooted, re-broadcast under a jittered
        exponential ramp (a mon outage must not see every OSD retry
        in lockstep every second).  While booted, periodically RENEW
        the map subscription (MonClient::renew_subs): map publication
        is fire-and-forget, so an epoch silently lost to a partition
        or dropped frame would otherwise leave this osd behind until
        the next commit happens to flow."""
        from ..utils.backoff import ExpBackoff
        bo = ExpBackoff(base=1.0, cap=8.0, rng=self.msgr.rng)
        renew_at = 0.0
        while not self.stopping:
            if self.booted:
                bo.reset()
                await asyncio.sleep(1.0)
                now = time.monotonic()
                if now >= renew_at:
                    renew_at = now + self.ctx.conf[
                        "mon_subscribe_renew_interval"]
                    self.msgr.send_to(
                        self.mon_addr,
                        MMonSubscribe(start=self.osdmap.epoch + 1),
                        entity_hint="mon.0")
                continue
            await bo.sleep()
            if not self.booted and self._boot_sent_epoch >= 0:
                self._boot_sent_epoch = -1
                self._send_boot()

    def _load_pgs(self) -> None:
        """Recreate PG objects from on-disk collections (OSD::load_pgs)."""
        for cid in self.store.list_collections():
            if not cid.is_pg():
                continue
            pool_s, ps_s = cid.name.split(".")
            pg = PG(self, int(pool_s), int(ps_s, 16))
            if pg.load():
                self.pgs[pg_t(pg.pool_id, pg.ps)] = pg

    # -- dispatch ----------------------------------------------------------

    def ms_handle_reset(self, conn) -> None:
        """A lossy fault on the monitor link drops our subscription on
        the mon side: re-subscribe from our current epoch."""
        self.watches.conn_reset(conn)
        if conn.peer_addr in self.mon_addrs and not self.stopping:
            if conn.peer_addr == self.mon_addr:
                self._mon_i = (self._mon_i + 1) % len(self.mon_addrs)
            self.msgr.send_to(self.mon_addr,
                              MMonSubscribe(start=self.osdmap.epoch + 1),
                              entity_hint="mon.0")

    def ms_dispatch(self, conn, msg) -> bool:
        """Fast paths (map/peering/heartbeat/completion replies) run
        inline; op-class work (client ops, rep/EC sub-ops, recovery
        pushes, scrub chunks) goes through the sharded mClock queue
        (OSD::ms_fast_dispatch -> enqueue_op -> ShardedOpWQ,
        OSD.cc:7360,9554)."""
        from .scheduler import K_CLIENT, K_RECOVERY, K_SCRUB

        def q(key, klass, fn, tenant=None):
            if self.sched.running:
                self.sched.enqueue(key, klass, fn, tenant=tenant)
            else:           # not started (unit-test direct dispatch)
                r = fn()
                if asyncio.iscoroutine(r):
                    # async handlers (scrub map builds) still run
                    asyncio.ensure_future(r)

        if isinstance(msg, MConfig):
            self.ctx.conf.apply_mon_values(msg.values or {})
            return True
        from ..msg.messages import MCrashReportAck, MLogAck
        if isinstance(msg, MLogAck):
            self.clog.handle_ack(msg.who, int(msg.last or 0),
                                 inc=getattr(msg, "inc", None))
            return True
        if isinstance(msg, MCrashReportAck):
            self._handle_crash_ack(msg.crash_ids)
            return True
        if isinstance(msg, MOSDMapMsg):
            self._handle_osd_map(msg)
        elif isinstance(msg, MOSDOp):
            ops_s = ",".join(o.get("op", "?")
                             for o in (msg.ops or []))
            self._track(msg, "osd_op(%s tid=%s %d.%x %s [%s])"
                        % (msg.src, msg.tid, msg.pool, msg.ps,
                           msg.oid, ops_s))
            q((msg.pool, msg.ps), K_CLIENT,
              lambda: self._handle_op(conn, msg),
              tenant=getattr(msg, "tenant", None))
        elif isinstance(msg, MOSDRepOp):
            self._track(msg, "rep_op(%s tid=%s %d.%x)"
                        % (msg.src, msg.tid, msg.pool, msg.ps))
            q((msg.pool, msg.ps), K_CLIENT,
              lambda: self._handle_repop(conn, msg),
              tenant=getattr(msg, "tenant", None))
        elif isinstance(msg, MOSDRepOpReply):
            self._handle_repop_reply(msg)
        elif isinstance(msg, MOSDOpReply):
            # reply to one of OUR internal ops (the dedup plane's
            # objecter acting as a chunk-pool client): route by tid
            return self.dedup.objecter.on_reply(msg)
        elif isinstance(msg, MOSDPGQuery):
            self._handle_pg_query(conn, msg)
        elif isinstance(msg, MOSDPGLog):
            self._handle_pg_log(conn, msg)
        elif isinstance(msg, MOSDPGPush):
            q((msg.pool, msg.ps), K_RECOVERY,
              lambda: self._handle_pg_push(conn, msg))
        elif isinstance(msg, MOSDPGPushReply):
            self._handle_pg_push_reply(msg)
        elif isinstance(msg, MOSDPing):
            self._handle_ping(conn, msg)
        elif isinstance(msg, MWatchNotify):
            self.watches.handle_ack(conn, msg)
        elif isinstance(msg, MOSDScrub):
            # operator-requested scrub (mon `pg scrub|deep-scrub|
            # repair`): runs asynchronously on the primary.  One
            # scrub per PG at a time — a retried command must not
            # interleave two repair passes over the same objects.
            pg = self.pgs.get(pg_t(msg.pool, msg.ps))
            if pg is None or not pg.is_primary():
                # schedule-time race (PG not instantiated yet, or
                # primaryship moved): visible, like the reference's
                # no-op scrub scheduling
                self.ctx.log.info(
                    "osd", "osd.%d ignoring scrub request for "
                    "%d.%x (not primary here)"
                    % (self.whoami, msg.pool, msg.ps))
            elif getattr(pg, "_scrub_cmd_running", False):
                self.ctx.log.info(
                    "osd", "pg %s scrub already running" % pg.pgid)
            else:
                pg._scrub_cmd_running = True

                async def run_scrub(pg=pg, deep=bool(msg.deep),
                                    repair=bool(msg.repair)):
                    try:
                        await self.scrubber.scrub_pg(
                            pg, deep=deep, repair=repair)
                    finally:
                        pg._scrub_cmd_running = False

                self.msgr.spawn(run_scrub())
        elif isinstance(msg, MOSDRepScrub):
            q((msg.pool, msg.ps), K_SCRUB,
              lambda: self.scrubber.handle_rep_scrub(conn, msg))
        elif isinstance(msg, MOSDRepScrubMap):
            self.scrubber.handle_rep_scrub_map(msg)
        elif isinstance(msg, MOSDECSubOpWrite):
            self._track(msg, "ec_sub_write(%s tid=%s %d.%x shard=%s)"
                        % (msg.src, msg.tid, msg.pool, msg.ps,
                           msg.shard))
            q((msg.pool, msg.ps), K_CLIENT,
              lambda: self.ec.handle_sub_write(conn, msg),
              tenant=getattr(msg, "tenant", None))
        elif isinstance(msg, MOSDECSubOpWriteReply):
            self.ec.handle_sub_write_reply(msg)
        elif isinstance(msg, MOSDECSubOpRead):
            q((msg.pool, msg.ps), K_CLIENT,
              lambda: self.ec.handle_sub_read(conn, msg))
        elif isinstance(msg, MOSDECSubOpReadReply):
            self.ec.handle_sub_read_reply(msg)
        else:
            return False
        return True

    # -- map handling ------------------------------------------------------

    def _handle_osd_map(self, msg: MOSDMapMsg) -> None:
        """Advance EPOCH BY EPOCH (OSD::advance_map walks every map):
        PGs must observe each intermediate interval so past_intervals
        records the acting sets that could have served writes while
        this osd was behind or down.

        Each epoch's bulk mapping runs on this OSD's chip BEFORE the
        epoch is applied: while the chip is lost (or its mapping class
        is full) that epoch and every later one wait in
        `_deferred_maps` — no epoch the bulk mapper owns is mapped by
        the host engine instead."""
        from .osdmap import Incremental, OSDMap

        if self._deferred_maps:
            self._deferred_maps.append(msg)     # keep epoch order
            return
        changed = False
        if msg.full is not None:
            m = OSDMap.decode(msg.full)
            if m.epoch > self.osdmap.epoch:
                mapping = self._bulk_mapping(m)
                if mapping is _MAP_DEFERRED:
                    self._defer_map(msg, m.epoch)
                    return
                if self.osdmap.epoch > 0 \
                        and m.epoch > self.osdmap.epoch + 1:
                    # full-map fallback across a gap: the intervals
                    # inside it cannot be reconstructed (the reference
                    # replays stored old maps; this build's mons ship
                    # contiguous incrementals, so this is the rare
                    # store-gap path) — past_intervals coverage is
                    # conservative-by-last-known here
                    self.ctx.log.info(
                        "osd", "osd.%d map jump %d -> %d: interval "
                        "history across the gap is approximate"
                        % (self.whoami, self.osdmap.epoch, m.epoch))
                # pool deletion is a TRANSITION event: on a real jump
                # (we had a nonzero epoch) drop PGs of pools gone from
                # the new map; a boot-time replay starting below the
                # pool's creation epoch must NOT drop loaded PGs
                if self.osdmap.epoch > 0:
                    self._drop_pgs_for_pools(
                        {pg.pool for pg in self.pgs}
                        - m.pools.keys())
                self.osdmap = m
                changed = True
                self._advance_pgs(mapping)
        incs = list(msg.incrementals or [])
        for i, raw in enumerate(incs):
            inc = Incremental.decode(raw)
            if inc.epoch == self.osdmap.epoch + 1:
                nm = self._next_map(inc)
                mapping = self._bulk_mapping(nm)
                if mapping is _MAP_DEFERRED:
                    self._defer_map(MOSDMapMsg(
                        fsid=msg.fsid, full=None,
                        incrementals=incs[i:]), inc.epoch)
                    break
                self.osdmap = nm
                changed = True
                if inc.old_pools:
                    self._drop_pgs_for_pools(set(inc.old_pools))
                self._advance_pgs(mapping)
        up_here = (self.osdmap.is_up(self.whoami)
                   and self.osdmap.osd_addrs.get(self.whoami)
                   == self.msgr.addr)
        if not self.booted:
            if up_here:
                self.booted = True
                self.ctx.log.info("osd", "osd.%d booted" % self.whoami)
            else:
                self._send_boot()
        elif not up_here:
            # map says we are down but we are alive: protest and
            # re-boot (OSD "wrongly marked me down" flow)
            self.booted = False
            self._boot_sent_epoch = -1
            self._send_mons(MOSDAlive(osd=self.whoami,
                                      epoch=self.osdmap.epoch))
            self._send_boot()
        if not changed or self.osdmap.epoch == 0:
            return
        self.ctx.log.debug(
            "osd", "osd.%d at epoch %d" % (self.whoami,
                                           self.osdmap.epoch))
        waiting, self._waiting_for_map = self._waiting_for_map, []
        for conn, m in waiting:
            self._handle_op(conn, m)

    def _next_map(self, inc):
        """The map after `inc`, built beside the current one, which
        stays in force until the epoch's mapping succeeded.  The
        containers apply_incremental mutates are copied; the crush map
        and its mappers are shared (apply_incremental replaces them)."""
        import copy
        nm = copy.copy(self.osdmap)
        nm.__dict__.update({k: copy.copy(v)
                            for k, v in vars(self.osdmap).items()
                            if isinstance(v, (list, dict))})
        nm.apply_incremental(inc)
        return nm

    def _bulk_mapping(self, m):
        """Map `m` on this OSD's chip once its pools sum to 256 PGs or
        more (the ParallelPGMapper role, OSDMapMapping.h:18).  None
        below that, or for a map outside the bulk mapper's scope: both
        take the exact host engine, as in the reference.
        _MAP_DEFERRED while the chip is lost (also when this pass's
        failure lost it) or its mapping class is full; any other
        failure propagates."""
        if sum(p.pg_num for p in m.pools.values()) < 256:
            return None
        from ..device.runtime import DeviceBusy, DeviceLost
        from ..ops.crush.device import OutOfDeviceScope
        from ..parallel.mapping import OSDMapMapping
        chip = self.device_chip
        try:
            return OSDMapMapping(
                m, chip=chip.index if chip is not None else None,
                device=self.device)
        except OutOfDeviceScope:
            return None
        except (DeviceBusy, DeviceLost):
            return _MAP_DEFERRED
        except Exception:
            if chip is not None and chip.lost:
                return _MAP_DEFERRED
            raise

    def _defer_map(self, msg, epoch: int) -> None:
        """Park `msg` (from `epoch` on) until the chip can map it: the
        heal edge replays a lost chip's epochs; a full mapping class
        retries shortly."""
        self._deferred_maps.append(msg)
        self.perf.inc("map_deferred")
        chip = self.device_chip
        self.ctx.log.info(
            "osd", "osd.%d defers epoch %d: chip %s %s"
            % (self.whoami, epoch, chip.index if chip else "?",
               "lost" if chip is not None and chip.lost else "busy"))
        if chip is not None and chip.lost:
            # ops parked for a newer epoch would wait for the heal
            waiting, self._waiting_for_map = self._waiting_for_map, []
            for conn, m in waiting:
                self._reply_chip_lost(conn, m)
        if chip is None or not chip.lost:
            async def retry():
                await asyncio.sleep(0.05)
                if self._deferred_maps and not self.stopping:
                    self._replay_deferred_maps()
            self.msgr.spawn(retry())

    def _reply_chip_lost(self, conn, msg) -> None:
        """-5 to an op that needs an epoch this OSD's lost chip has not
        mapped yet."""
        conn.send(MOSDOpReply(
            tid=msg.tid, result=-5,
            outs=[{"error": "osd.%d: device chip %d lost, epoch %d "
                            "waits for the heal"
                   % (self.whoami, self.device_chip.index, msg.epoch)}
                  for _ in msg.ops],
            epoch=self.osdmap.epoch, version=0))
        self._op_finish(msg, "chip_lost_map_deferred")

    def _replay_deferred_maps(self) -> None:
        pending, self._deferred_maps = self._deferred_maps, []
        for msg in pending:
            self._handle_osd_map(msg)

    def _send_boot(self) -> None:
        epoch = self.osdmap.epoch if self.osdmap else 0
        if self._boot_sent_epoch >= 0 and epoch <= self._boot_sent_epoch:
            return  # already asked; wait for a newer epoch
        self._boot_sent_epoch = epoch
        self._send_mons(MOSDBoot(osd=self.whoami, addr=self.msgr.addr,
                                 epoch=epoch))

    def _split_pgs(self, pool_id: int, pool) -> None:
        """In-place PG split after a pg_num grow (PG::split_into /
        OSD::split_pgs condensed).  With pgp_num unchanged a child PG
        keeps its parent's placement (ceph_stable_mod folds the child
        ps back onto the parent's pps), so the split is purely local:
        every acting member deterministically moves each object whose
        hash now lands in a child into the child's collection, along
        with the log entries and missing rows naming it.  All members
        run the identical function on the same map epoch, so child
        logs/infos agree at the next peering without data movement.

        Also run with no recorded previous pg_num (post-restart): the
        sweep is idempotent — objects already in the right collection
        never move.  Clone hobjects ride the generic loop (identity =
        name+snap; a clone's name hashes with its head)."""
        for pgid in [p for p in list(self.pgs) if p.pool == pool_id]:
            pg = self.pgs[pgid]
            moves: dict[int, list] = {}
            for ho in self.store.collection_list(pg.cid):
                if ho.name == "__pgmeta__":
                    continue
                target = pool.raw_pg_to_pg(
                    self.osdmap.object_locator_to_pg(
                        ho.name, pool_id)).ps
                if target != pg.ps:
                    moves.setdefault(target, []).append(ho)
            if not moves:
                continue
            self.ctx.log.info(
                "osd", "osd.%d splitting pg %s: %d objects -> %s"
                % (self.whoami, pg.pgid,
                   sum(len(v) for v in moves.values()),
                   sorted(moves)))
            for child_ps, hos in sorted(moves.items()):
                cid = pg_t(pool_id, child_ps)
                child = self.pgs.get(cid)
                if child is None:
                    child = PG(self, pool_id, child_ps)
                    child.create_onstore()
                    self.pgs[cid] = child
                t = Transaction()
                moved = {ho.name for ho in hos}
                for ho in hos:
                    t.touch(child.cid, ho)
                    data = self.store.read(pg.cid, ho)
                    t.write(child.cid, ho, 0, len(data), data)
                    for k, v in self.store.getattrs(pg.cid,
                                                    ho).items():
                        t.setattr(child.cid, ho, k, v)
                    om = self.store.omap_get(pg.cid, ho)
                    if om:
                        t.omap_setkeys(child.cid, ho, om)
                    t.remove(pg.cid, ho)
                # the child inherits the parent's log entries for its
                # objects (delta recovery stays possible) and the
                # parent's version horizon, so every member's child
                # agrees at peering
                have = {e.version for e in child.log.entries}
                for e in pg.log.entries:
                    if e.oid in moved and e.version not in have:
                        child.log.append(e)
                        child.persist_log_entry(t, e)
                if pg.info.last_update > child.info.last_update:
                    child.info.last_update = pg.info.last_update
                for oid in list(pg.missing):
                    if oid in moved:
                        child.missing[oid] = pg.missing.pop(oid)
                for osd_id, pm in pg.peer_missing.items():
                    for oid in [o for o in pm if o in moved]:
                        child.peer_missing.setdefault(
                            osd_id, {})[oid] = pm.pop(oid)
                child.persist_meta(t)
                pg.persist_meta(t)
                self.store.apply_transaction(t)

    def _advance_pgs(self, mapping=None) -> None:
        """Recompute mappings; create/advance PGs (OSD::advance_map).
        Large maps arrive with their bulk device mapping
        (`_bulk_mapping`) instead of per-PG scalar calls (the
        ParallelPGMapper role, OSDMapMapping.h:18)."""
        m = self.osdmap
        # pg_num growth: split local PGs BEFORE mappings recompute so
        # freshly-created children already hold their objects.  An
        # unknown previous value (first map after boot/restart) runs
        # the idempotent sweep too — a split may have happened while
        # this osd was down.
        for pool_id, pool in m.pools.items():
            prev = self._pool_pg_num.get(pool_id)
            if (prev is None and self.pgs) or \
                    (prev is not None and pool.pg_num > prev):
                self._split_pgs(pool_id, pool)
            self._pool_pg_num[pool_id] = pool.pg_num
        for pool_id in list(self._pool_pg_num):
            if pool_id not in m.pools:
                del self._pool_pg_num[pool_id]
        for pool_id, pool in m.pools.items():
            for ps in range(pool.pg_num):
                pgid = pg_t(pool_id, ps)
                if mapping is not None:
                    up, upp, acting, actingp = mapping.get(pgid)
                else:
                    up, upp, acting, actingp = \
                        m.pg_to_up_acting_osds(pgid)
                mine = self.whoami in acting
                pg = self.pgs.get(pgid)
                if pg is None:
                    if not mine:
                        continue
                    pg = PG(self, pool_id, ps)
                    pg.create_onstore()
                    self.pgs[pgid] = pg
                self._advance_pg(pg, up, upp, acting, actingp)

    def _drop_pgs_for_pools(self, pools: set[int]) -> None:
        for pgid in [p for p in self.pgs if p.pool in pools]:
            pg = self.pgs.pop(pgid)
            # a deleted pool answers nothing: retire tracked state so
            # parked/in-flight ops don't read as stuck forever
            for st in pg.in_flight.values():
                top = st.get("top")
                if top is not None:
                    top.finish("aborted_pool_deleted")
            for _conn, m in pg.waiting_for_active:
                self._op_finish(m, "dropped_pool_deleted")

    def _advance_pg(self, pg: PG, up, upp, acting, actingp) -> None:
        interval_changed = (acting != pg.acting or actingp != pg.primary)
        if interval_changed and pg.acting:
            # remember the data-holding set for pg_temp pinning
            pg.prev_acting = list(pg.acting)
        if interval_changed and pg.info.same_interval_since \
                and pg.acting:
            # close the ending interval into past_intervals
            # (PastIntervals::check_new_interval): it "maybe went rw"
            # iff it had a primary whose up_thru reached the interval
            # and enough acting members to meet min_size
            pool = self.osdmap.pools.get(pg.pool_id)
            members = [o for o in pg.acting if 0 <= o != ITEM_NONE]
            rw = (pg.primary >= 0 and pg.primary != ITEM_NONE
                  and len(members) >= (pool.min_size if pool else 1)
                  and (self.osdmap.get_up_thru(pg.primary)
                       >= pg.info.same_interval_since))
            pg.past_intervals.append({
                "first": pg.info.same_interval_since,
                "last": self.osdmap.epoch - 1,
                "up": list(pg.up), "acting": list(pg.acting),
                "primary": pg.primary, "rw": rw})
        pg.up, pg.acting, pg.primary = up, acting, actingp
        if not interval_changed:
            if pg.state in (STATE_ACTIVE, STATE_REPLICA):
                # ops can be parked by the min_size gate while acting
                # members are down; a peer rejoining without an
                # acting-set change (e.g. pg_temp pinning) triggers no
                # peering, so retry them on every map advance
                if pg.state == STATE_ACTIVE and pg.waiting_for_active \
                        and pg.is_primary():
                    self._requeue_waiters(pg)
                # the map may have added removed_snaps: start trimming
                self._maybe_snap_trim(pg)
            elif pg.state == STATE_PEERING and pg.is_primary():
                # same interval, new map: a blocked prior set may have
                # a member back up, or our up_thru bump may have landed
                if pg.peering_blocked:
                    self._start_peering(pg)
                elif pg.waiting_up_thru and \
                        self.osdmap.get_up_thru(self.whoami) \
                        >= pg.waiting_up_thru:
                    pg.waiting_up_thru = 0
                    self._finish_peering(pg)
                elif pg.waiting_up_thru:
                    self._request_up_thru(pg.waiting_up_thru)
                elif any(v is None and not self.osdmap.is_up(o)
                         for o, v in pg.waiting_for_peers.items()):
                    # a queried prior member died mid-round: recompute
                    # the prior set (it may now be blocked, or smaller)
                    self._start_peering(pg)
            return
        pg.info.same_interval_since = self.osdmap.epoch
        # repops aborted by the interval change will never be acked:
        # retire their tracked ops (the client re-targets and resends
        # on the same map change, so no reply is owed from here)
        for st in pg.in_flight.values():
            top = st.get("top")
            if top is not None:
                top.finish("aborted_interval_change")
        pg.in_flight.clear()
        if not pg.is_primary() and pg.waiting_for_active:
            # parked ops on a demoted primary would wait forever (only
            # a primary requeues); the client resends to the new
            # primary on this same map change — drop and retire them
            parked, pg.waiting_for_active = pg.waiting_for_active, []
            for _conn, m in parked:
                self._op_finish(m, "dropped_interval_change")
        # recovery targets that left the up/acting set die with the
        # interval: peering only refreshes entries for peers it
        # re-queries, so a departed osd's stale peer_missing would
        # otherwise read as "recovery outstanding" forever (wedging
        # active+clean) and re-kick recovery toward a ghost
        pg.peer_missing = {o: m for o, m in pg.peer_missing.items()
                           if o in pg.acting or o in pg.up}
        # registrations die with the interval; clients re-watch at the
        # new primary when they see the map change
        self.watches.pg_reset(pg.pool_id, pg.ps)
        pool = self.osdmap.pools.get(pg.pool_id)
        if pool is not None and pool.is_erasure():
            # a reshuffled acting set can leave this osd holding bytes
            # for a position it no longer has: mark them missing
            for oid, op in self.ec.scan_stale_shards(pg).items():
                pg.missing.setdefault(oid, op)
        # durable interval history: a restart mid-outage must still
        # know which past acting sets may hold newer writes
        t = Transaction()
        pg.persist_meta(t)
        self.store.apply_transaction(t)
        if pg.is_primary():
            self._start_peering(pg)
        else:
            pg.state = STATE_REPLICA

    # -- peering (primary) -------------------------------------------------

    def _build_prior(self, pg: PG) -> tuple[set[int], bool]:
        """PeeringState::build_prior: everyone who might hold writes —
        current acting peers plus live members of every past interval
        that may have gone rw.  Blocked (PG down) when some rw
        interval has NO live member at all (and we were not in it):
        its writes could exist only on the dead osds, so activating
        now could adopt stale authority."""
        prior = {o for o in pg.acting
                 if 0 <= o != self.whoami and o != ITEM_NONE}
        blocked = False
        for iv in pg.past_intervals:
            if not iv.get("rw"):
                continue
            members = [o for o in iv["acting"]
                       if 0 <= o != ITEM_NONE]
            live = [o for o in members
                    if o != self.whoami and self.osdmap.is_up(o)]
            prior.update(live)
            if members and not live and self.whoami not in members:
                blocked = True
        return prior, blocked

    def _request_up_thru(self, want: int) -> None:
        """Ask the mon to record our up_thru >= want (prepare_alive
        path); deduped per epoch so N PGs in one interval send once."""
        if getattr(self, "_up_thru_asked", (0, 0)) >= \
                (want, self.osdmap.epoch):
            return
        self._up_thru_asked = (want, self.osdmap.epoch)
        self._send_mons(MOSDAlive(osd=self.whoami,
                                  epoch=self.osdmap.epoch,
                                  want_up_thru=want))

    def _start_peering(self, pg: PG) -> None:
        pg.state = STATE_PEERING
        pg.peer_info.clear()
        pg.waiting_for_peers = {}
        pg.waiting_for_log = None
        pg.waiting_up_thru = 0
        prior, blocked = self._build_prior(pg)
        pg.peering_blocked = blocked
        if blocked:
            # PG down: every member of a maybe-rw interval is dead.
            # Hold peering until a map change brings one back
            # (PeeringState Down state)
            self.ctx.log.info(
                "osd", "pg %s down: prior rw interval has no live "
                "member" % pg.pgid)
            return
        peers = sorted(o for o in prior if self.osdmap.is_up(o)
                       or o in pg.acting)
        if not peers:
            self._finish_peering(pg)
            return
        epoch = self.osdmap.epoch
        pg.waiting_for_peers = {o: None for o in peers}
        for o in peers:
            self._send_osd(o, MOSDPGQuery(pool=pg.pool_id, ps=pg.ps,
                                          epoch=epoch, query="info",
                                          since=None))

    def _handle_pg_query(self, conn, msg: MOSDPGQuery) -> None:
        """Replica side.  query="info": peer state only (the GetInfo
        round never ships log entries).  query="log": entries newer
        than `since` (the bounded GetLog fetch, PeeringState GetLog ->
        MOSDPGLog)."""
        pg = self.pgs.get(pg_t(msg.pool, msg.ps))
        if pg is None:
            pg = PG(self, msg.pool, msg.ps)
            pg.create_onstore()
            self.pgs[pg_t(msg.pool, msg.ps)] = pg
        if msg.query == "log":
            since = tuple(msg.since) if msg.since else (0, 0)
            if since < pg.log.tail:
                # requester is behind our tail: entries cannot catch
                # it up — ship the live-object inventory so it can
                # backfill itself (reset + pull everything)
                payload = self._pack_log(pg, activate=False)
                payload["objects"] = [
                    h.name for h in
                    self.store.collection_list(pg.cid)
                    if h.name != "__pgmeta__"]
            else:
                payload = self._pack_log(pg, activate=False,
                                         since=since)
            payload["is_log_reply"] = True
        else:
            payload = self._pack_log(pg, activate=False,
                                     info_only=True)
        conn.send(MOSDPGLog(pool=msg.pool, ps=msg.ps,
                            epoch=msg.epoch, info=payload))

    def _pack_log(self, pg: PG, activate: bool,
                  since: tuple | None = None,
                  info_only: bool = False,
                  backfill: bool = False) -> dict:
        """Peering payload.  since bounds the entries to the delta a
        peer at that version needs (round-2 verdict: full logs on every
        round collapse at real log lengths); info_only ships none."""
        if info_only:
            entries = []
        elif since is not None:
            entries = [e for e in pg.log.entries if e.version > since]
        else:
            entries = pg.log.entries
        return {
            "activate": activate,
            "info": pg.info.to_wire(),
            "log": [e.to_wire() for e in entries],
            "log_tail": list(pg.log.tail),
            "since": (list(since) if since is not None else None),
            "backfill": backfill,
            # objects this osd knows it lacks (e.g. stale EC shards)
            "missing": {oid: op for oid, op in pg.missing.items()},
        }

    def _handle_pg_log(self, conn, msg: MOSDPGLog) -> None:
        pgid = pg_t(msg.pool, msg.ps)
        pg = self.pgs.get(pgid)
        if pg is None:
            return
        payload = msg.info
        if payload.get("activate"):
            self._activate_replica(conn, pg, payload)
            return
        sender = int(msg.src.split(".")[1])
        if payload.get("need_full"):
            # a replica's log diverged from the delta we sent: re-sync
            # with the full log.  When the replica shipped its log we
            # compute the divergence boundary and push ONLY the
            # affected objects (PGLog::merge_log); without it, the
            # conservative whole-log re-push
            if pg.is_primary() and pg.state == STATE_ACTIVE:
                from .pg import merge_divergent
                miss = pg.peer_missing.setdefault(sender, {})
                narrow = None
                peer_entries = [LogEntry.from_wire(w)
                                for w in payload.get("my_log") or []]
                if peer_entries:
                    narrow = merge_divergent(peer_entries,
                                             pg.log.entries)
                if narrow is not None:
                    miss.update(narrow)
                else:
                    for e in peer_entries:
                        miss.setdefault(e.oid, LogEntry.MODIFY)
                    for e in pg.log.entries:
                        miss.setdefault(e.oid, e.op)
                self._send_osd(sender, MOSDPGLog(
                    pool=pg.pool_id, ps=pg.ps,
                    epoch=self.osdmap.epoch,
                    info=self._pack_log(pg, activate=True)))
                self._kick_recovery(pg)
            return
        # primary collecting peering responses
        if pg.state != STATE_PEERING:
            return
        if payload.get("is_log_reply"):
            if getattr(pg, "waiting_for_log", None) != sender:
                return
            if self._merge_authoritative(pg, payload):
                pg.waiting_for_log = None
                self._after_log(pg)
            return
        if sender not in pg.waiting_for_peers:
            return
        pg.waiting_for_peers[sender] = payload
        if all(v is not None for v in pg.waiting_for_peers.values()):
            self._choose_authoritative(pg)

    def _choose_authoritative(self, pg: PG) -> None:
        """find_best_info: highest last_update wins.  When a peer is
        best, fetch only the entries past our own last_update (the
        GetLog bounded request) instead of having every info round
        carry whole logs."""
        best_osd = self.whoami
        best_lu = pg.info.last_update
        for osd, payload in pg.waiting_for_peers.items():
            lu = tuple(payload["info"]["last_update"])
            if lu > best_lu:
                best_lu, best_osd = lu, osd
        for osd, payload in pg.waiting_for_peers.items():
            pg.peer_info[osd] = PGInfo.from_wire(payload["info"])
        if best_osd != self.whoami and best_lu > pg.info.last_update:
            pg.waiting_for_log = best_osd
            pg.auth_osd = best_osd
            self._send_osd(best_osd, MOSDPGQuery(
                pool=pg.pool_id, ps=pg.ps, epoch=self.osdmap.epoch,
                query="log", since=list(pg.info.last_update)))
            return
        pg.auth_osd = self.whoami
        self._after_log(pg)

    def _merge_authoritative(self, pg: PG, payload: dict) -> bool:
        """PGLog::merge_log on the primary: append the authoritative
        delta when it chains onto our head.  A non-chaining delta
        means the histories diverged — re-fetch the FULL log once and
        resolve divergence by re-syncing every logged object
        (conservative divergent-entry resolution: pushes and pulls of
        authoritative copies converge the data either way).  Returns
        False while the full-log round trip is in flight."""
        entries = [LogEntry.from_wire(w) for w in payload["log"]]
        tail = tuple(payload["log_tail"])
        last_update = tuple(payload["info"]["last_update"])
        since = (tuple(payload["since"]) if payload.get("since")
                 else None)
        pool = self.osdmap.pools.get(pg.pool_id)
        mine = pg.info.last_update
        chains = (since == mine and tail <= mine
                  and (not entries or entries[0].prior_version == mine))
        t = Transaction()
        if since is not None and chains:
            # incremental: keep our prefix, append the delta
            for e in entries:
                if e.version > mine:
                    pg.missing[e.oid] = e.op
                    pg.log.append(e)
                    pg.persist_log_entry(t, e)
        elif payload.get("objects") is not None:
            # the auth log is trimmed past us: self-backfill — reset
            # our data objects and pull the authoritative inventory
            for h in self.store.collection_list(pg.cid):
                if h.name != "__pgmeta__":
                    t.remove(pg.cid, h)
            pg.missing = {o: LogEntry.MODIFY
                          for o in payload["objects"]}
            for e in entries:
                pg.missing.setdefault(e.oid, e.op)
            pg.replace_log(t, entries, tail)
        elif since is not None and since != (0, 0):
            # non-chaining delta: the partial entries are useless —
            # ask for the whole log (once; a (0,0) request's reply
            # lands in the branch below)
            self._send_osd(pg.waiting_for_log, MOSDPGQuery(
                pool=pg.pool_id, ps=pg.ps, epoch=self.osdmap.epoch,
                query="log", since=[0, 0]))
            return False
        else:
            # divergent histories, full log in hand: roll back only
            # the entries past the common boundary when the logs
            # share history (PGLog::merge_log); otherwise every oid in
            # either log gets re-synced
            from .pg import merge_divergent
            narrow = merge_divergent(pg.log.entries, entries)
            if narrow is not None:
                pg.missing.update(narrow)
            else:
                if pool is None or not pool.is_erasure():
                    for e in pg.log.entries:
                        if e.version > tail:
                            pg.missing[e.oid] = LogEntry.MODIFY
                for e in entries:
                    pg.missing[e.oid] = e.op
            pg.replace_log(t, entries, tail)
        if last_update > pg.info.last_update:
            pg.info.last_update = last_update
        pg.persist_meta(t)
        self.store.apply_transaction(t)
        return True

    def _after_log(self, pg: PG) -> None:
        """Authoritative log settled: derive each peer's missing set.
        A peer whose last_update predates our log tail cannot be
        caught up by log entries — it becomes a backfill target
        (whole-PG resync, PeeringState Backfilling)."""
        pg.backfill_targets = set()
        for osd, payload in pg.waiting_for_peers.items():
            info = pg.peer_info.get(osd)
            if info is None or payload is None:
                continue
            if osd not in pg.acting and osd not in pg.up:
                # prior-interval stray: its info (and possibly its
                # log) fed authority; it is not a recovery target
                continue
            missing = {}
            if info.last_update >= pg.log.tail:
                missing = pg.log.objects_since(info.last_update)
            else:
                pg.backfill_targets.add(osd)
                for h in self.store.collection_list(pg.cid):
                    if h.name != "__pgmeta__":
                        missing[h.name] = LogEntry.MODIFY
                for e in pg.log.entries:
                    missing.setdefault(e.oid, e.op)
            missing.update(payload.get("missing") or {})
            pg.peer_missing[osd] = missing
        self._finish_peering(pg)

    def _finish_peering(self, pg: PG) -> None:
        # up_thru gate (PeeringState::adjust_need_up_thru / WaitUpThru):
        # before activating, the map must record that we were primary-
        # capable through this interval's start — otherwise a LATER
        # peering round could not tell whether this interval went rw,
        # and a stale primary could silently adopt authority
        need = pg.info.same_interval_since
        if self.osdmap.get_up_thru(self.whoami) < need:
            pg.waiting_up_thru = need
            self._request_up_thru(need)
            return                      # resumes on the bumped map
        pg.state = STATE_ACTIVE
        pg.peering_blocked = False
        # activation settles all prior history: last_epoch_started
        # advances and past intervals are consumed
        pg.info.last_epoch_started = self.osdmap.epoch
        pg.past_intervals = []
        t = Transaction()
        pg.persist_meta(t)
        self.store.apply_transaction(t)
        self._maybe_request_pg_temp(pg)
        # up-but-not-acting members (we are serving under a pg_temp
        # pin): backfill them too, so the pin can be released once
        # they hold everything (PeeringState Backfilling with the
        # acting set pinned to the previous interval's members)
        extra = [o for o in pg.up
                 if 0 <= o != ITEM_NONE and o not in pg.acting
                 and o != self.whoami]
        for osd in extra:
            missing = {}
            for h in self.store.collection_list(pg.cid):
                if h.name != "__pgmeta__":
                    missing[h.name] = LogEntry.MODIFY
            for e in pg.log.entries:
                missing.setdefault(e.oid, e.op)
            pg.peer_missing[osd] = missing
        # activate replicas with their DELTA of the authoritative log
        # (backfill targets get the full log and a reset flag)
        for osd in list(pg.acting) + extra:
            if 0 <= osd != self.whoami and osd != ITEM_NONE:
                if osd in getattr(pg, "backfill_targets", set()) \
                        or osd in extra:
                    payload = self._pack_log(pg, activate=True,
                                             backfill=True)
                else:
                    info = pg.peer_info.get(osd)
                    since = (info.last_update if info is not None
                             else None)
                    payload = self._pack_log(pg, activate=True,
                                             since=since)
                self._send_osd(osd, MOSDPGLog(
                    pool=pg.pool_id, ps=pg.ps, epoch=self.osdmap.epoch,
                    info=payload))
        self.ctx.log.debug(
            "osd", "pg %s active on osd.%d acting=%s missing=%d"
            % (pg.pgid, self.whoami, pg.acting, len(pg.missing)))
        if pg.missing or any(pg.peer_missing.values()):
            # stat-worthy transition: this interval starts degraded /
            # misplaced — report NOW, not at the next periodic tick,
            # so the stats plane observes the rise even when recovery
            # drains it faster than the report cadence (the reference
            # sends MPGStats on pg stat changes for the same reason)
            self._mgr_report_stamp = 0.0
            self._maybe_send_mgr_report()
        self._kick_recovery(pg)
        self._maybe_snap_trim(pg)
        if not pg.missing:
            self._requeue_waiters(pg)

    def _maybe_request_pg_temp(self, pg: PG) -> None:
        """queue_want_pg_temp (PeeringState.cc): when the fresh acting
        set needs backfill but the previous interval's members are
        alive and sufficient, ask the monitor to pin acting to them so
        clients keep full-strength service during backfill
        (OSDMonitor::prepare_pgtemp commits it; cleared when backfill
        completes).  Replicated pools only — EC acting sets are
        positional and pinning them needs shard-aware ordering."""
        from ..msg.messages import MOSDPGTemp
        pool = self.osdmap.pools.get(pg.pool_id)
        if pool is None or pool.is_erasure():
            return
        pgid = pg_t(pg.pool_id, pg.ps)
        if self.osdmap.pg_temp.get(pgid):
            return                      # already pinned
        if not getattr(pg, "backfill_targets", None):
            return
        prev = [o for o in getattr(pg, "prev_acting", [])
                if 0 <= o != ITEM_NONE and self.osdmap.is_up(o)]
        if len(prev) < pool.min_size:
            return
        if set(prev) == set(pg.acting):
            return
        if getattr(pg, "_temp_req_epoch", -1) >= self.osdmap.epoch:
            return
        pg._temp_req_epoch = self.osdmap.epoch
        self._send_mons(MOSDPGTemp(
            epoch=self.osdmap.epoch,
            pgs=[[pg.pool_id, pg.ps, prev]]))

    def _maybe_clear_pg_temp(self, pg: PG) -> None:
        """Backfill complete: every up member holds everything —
        release the pg_temp pin so acting flips to the real mapping."""
        from ..msg.messages import MOSDPGTemp
        pgid = pg_t(pg.pool_id, pg.ps)
        if not self.osdmap.pg_temp.get(pgid) or not pg.is_primary():
            return
        for o in pg.up:
            if o < 0 or o == ITEM_NONE or o == self.whoami:
                continue
            if pg.peer_missing.get(o):
                return                  # still backfilling
        if getattr(pg, "_temp_clear_epoch", -1) >= self.osdmap.epoch:
            return
        pg._temp_clear_epoch = self.osdmap.epoch
        self._send_mons(MOSDPGTemp(
            epoch=self.osdmap.epoch,
            pgs=[[pg.pool_id, pg.ps, []]]))

    def _activate_replica(self, conn, pg: PG, payload: dict) -> None:
        """Replica activation: append the delta when it chains onto
        our log; on divergence ask the primary for a full re-sync
        (need_full), reporting our logged oids so it re-pushes them;
        on backfill reset the local objects first."""
        entries = [LogEntry.from_wire(w) for w in payload["log"]]
        since = (tuple(payload["since"]) if payload.get("since")
                 else None)
        tail = tuple(payload["log_tail"])
        last_update = tuple(payload["info"]["last_update"])
        t = Transaction()
        if payload.get("backfill"):
            for h in self.store.collection_list(pg.cid):
                if h.name != "__pgmeta__":
                    t.remove(pg.cid, h)
            pg.missing = {e.oid: e.op for e in entries}
            pg.replace_log(t, entries, tail)
            pg.info.last_update = last_update
        elif since is not None:
            mine = pg.info.last_update
            # the delta chains when the part BEYOND our head continues
            # exactly from it; entries at or below our head are a
            # shared prefix (a re-peering round built its delta from a
            # pre-activation info snapshot) and are skipped, not
            # grounds for a full resync.  A replica below the
            # primary's log tail has a gap no delta can cover.
            new = [e for e in entries if e.version > mine]
            chains = (since <= mine and tail <= mine
                      and (not new or new[0].prior_version == mine))
            if not chains:
                conn.send(MOSDPGLog(
                    pool=pg.pool_id, ps=pg.ps,
                    epoch=self.osdmap.epoch,
                    info={"need_full": True,
                          "my_log": [e.to_wire()
                                     for e in pg.log.entries]}))
                return
            for e in entries:
                if e.version > mine:
                    pg.missing[e.oid] = e.op
                    pg.log.append(e)
                    pg.persist_log_entry(t, e)
            if last_update > pg.info.last_update:
                pg.info.last_update = last_update
        else:
            # full log (divergence re-sync): adopt the authoritative
            # log, rolling back ONLY the divergent objects when the
            # logs share history (PGLog::merge_log); disjoint
            # histories keep the conservative whole-log resync
            from .pg import merge_divergent
            narrow = merge_divergent(pg.log.entries, entries)
            pool = self.osdmap.pools.get(pg.pool_id)
            if narrow is not None:
                pg.missing.update(narrow)
            else:
                if pool is None or not pool.is_erasure():
                    pg.missing = {}
                for e in entries:
                    pg.missing[e.oid] = e.op
            pg.replace_log(t, entries, tail)
            pg.info.last_update = last_update
        # activation consumes our interval history too: the primary's
        # authority covers it (peering heard us)
        pg.info.last_epoch_started = self.osdmap.epoch
        pg.past_intervals = []
        pg.persist_meta(t)
        self.store.apply_transaction(t)
        pg.state = STATE_REPLICA

    # -- recovery ----------------------------------------------------------

    def _kick_recovery(self, pg: PG) -> None:
        pool = self.osdmap.pools.get(pg.pool_id)
        if pool is not None and pool.is_erasure():
            self.msgr.spawn(self._ec_recover(pg))
            return
        self.msgr.spawn(self._replicated_recover(pg))

    def _span_recovery(self, pg: PG, t0: float, had: bool) -> None:
        """Record one recovery flow on the flight recorder (only
        flows that had work: the watchdog re-kicks idly)."""
        fr = getattr(self.ctx, "flight_recorder", None)
        if fr is not None and had:
            fr.span("recovery", t0, meta={"pgid": str(pg.pgid)})

    def _note_recovery_progress(self, pg: PG) -> None:
        """Drain the PG's recovery progress row: outstanding work is
        what the primary still lacks plus what its peers lack; zero
        outstanding finishes the bar."""
        outstanding = (len(pg.missing)
                       + sum(len(m)
                             for m in pg.peer_missing.values()))
        self.progress.drain("recovery/%s" % pg.pgid, outstanding)

    def _progress_rows(self) -> dict:
        """Report-time progress snapshot: refresh each primary's
        recovery drain first so a flow whose last push landed between
        reports still reaches 1.0 rather than stalling."""
        for pg in self.pgs.values():
            if pg.is_primary():
                self._note_recovery_progress(pg)
        return self.progress.rows()

    async def _replicated_recover(self, pg: PG) -> None:
        """Paced replicated recovery: pull/push in chunks, each chunk
        admitted through the mClock 'recovery' class so client I/O
        keeps its reservation during a recovery storm (the reference
        paces via osd_recovery_max_active + mClock op tags)."""
        from .scheduler import K_RECOVERY
        if getattr(pg, "_recovery_flow", False):
            return
        pg._recovery_flow = True
        had_work = bool(pg.missing
                        or any(pg.peer_missing.values()))
        if had_work:
            self.progress.start(
                "recovery", str(pg.pgid),
                total=len(pg.missing) + sum(
                    len(m) for m in pg.peer_missing.values()))
        t_rec0 = self.optracker.now()
        chunk = 16
        acting0 = list(pg.acting)
        try:
            if pg.missing:
                # pull what the primary lacks from a peer PROVEN to
                # have it: the authoritative log's owner first, else a
                # peer whose info reached the authoritative head (a
                # stale prior-interval stray also sits in peer_info —
                # pulling from it would adopt old data as recovered)
                src = None
                auth = getattr(pg, "auth_osd", self.whoami)
                if auth != self.whoami and self.osdmap.is_up(auth):
                    src = auth
                if src is None:
                    for osd, info in pg.peer_info.items():
                        if (not pg.peer_missing.get(osd)
                                and info.last_update
                                >= pg.info.last_update):
                            src = osd
                            break
                if src is None:
                    for osd in pg.acting:
                        if 0 <= osd != self.whoami and osd != ITEM_NONE:
                            src = osd
                            break
                if src is not None:
                    oids = sorted(pg.missing)
                    pg.recovering.update(oids)
                    for i in range(0, len(oids), chunk):
                        part = oids[i:i + chunk]
                        await self.sched.admit(
                            K_RECOVERY, cost=len(part),
                            key=(pg.pool_id, pg.ps))
                        if pg.acting != acting0 or self.stopping:
                            return      # interval changed: re-peer
                        self._send_osd(src, MOSDPGPush(
                            pool=pg.pool_id, ps=pg.ps,
                            epoch=self.osdmap.epoch,
                            pushes=[{"pull": True, "oids": part}]))
                return
            # push to replicas missing objects
            for osd, missing in list(pg.peer_missing.items()):
                if not missing:
                    continue
                items = sorted(missing.items())
                for i in range(0, len(items), chunk):
                    part = items[i:i + chunk]
                    await self.sched.admit(K_RECOVERY, cost=len(part),
                                           key=(pg.pool_id, pg.ps))
                    if pg.acting != acting0 or self.stopping:
                        return
                    pushes = [self._make_push(pg, oid, op)
                              for oid, op in part]
                    pg.stats.note_recovery(0, sum(
                        len(p.get("data") or b"") for p in pushes))
                    self._send_osd(osd, MOSDPGPush(
                        pool=pg.pool_id, ps=pg.ps,
                        epoch=self.osdmap.epoch, pushes=pushes))
        finally:
            pg._recovery_flow = False
            self._span_recovery(pg, t_rec0, had_work)
            if had_work:
                self._note_recovery_progress(pg)

    async def _ec_recover(self, pg: PG) -> None:
        """EC recovery: reconstruct (never copy) shards
        (ECBackend::continue_recovery_op).  The _recovery_flow guard
        keeps the heartbeat watchdog from stacking concurrent flows
        while mClock paces this one."""
        if getattr(pg, "_recovery_flow", False):
            return
        pg._recovery_flow = True
        had_work = bool(pg.missing
                        or any(pg.peer_missing.values()))
        if had_work:
            self.progress.start(
                "recovery", str(pg.pgid),
                total=len(pg.missing) + sum(
                    len(m) for m in pg.peer_missing.values()))
        t_rec0 = self.optracker.now()
        try:
            await self.ec.recover_primary_shards(pg)
            for osd_id, missing in list(pg.peer_missing.items()):
                if missing:
                    await self.ec.recover_peer_shards(pg, osd_id,
                                                      missing)
        finally:
            pg._recovery_flow = False
            self._span_recovery(pg, t_rec0, had_work)
            if had_work:
                self._note_recovery_progress(pg)
        if not pg.missing:
            self._requeue_waiters(pg)

    def _make_push(self, pg: PG, oid: str, op: str) -> dict:
        from . import snaps as snapmod
        ho = hobject_t(oid)
        if op == LogEntry.DELETE or not self.store.exists(pg.cid, ho):
            return {"oid": oid, "delete": True}
        push = {
            "oid": oid,
            "delete": False,
            "data": self.store.read(pg.cid, ho),
            "attrs": {k: v for k, v in
                      self.store.getattrs(pg.cid, ho).items()},
            "omap": self.store.omap_get(pg.cid, ho),
        }
        # snapshot clones travel with their head so a recovered
        # replica can serve snap reads (the reference recovers clones
        # as separate hobjects; whole-object pushes bundle them)
        ss = snapmod.load_snapset(self.store, pg.cid, ho)
        if ss and ss["clones"]:
            clones = []
            for c in ss["clones"]:
                cho = hobject_t(oid, snap=c)
                if not self.store.exists(pg.cid, cho):
                    continue
                clones.append({
                    "snap": c,
                    "data": self.store.read(pg.cid, cho),
                    "attrs": {k: v for k, v in
                              self.store.getattrs(pg.cid,
                                                  cho).items()},
                })
            if clones:
                push["clones"] = clones
        return push

    def _handle_pg_push(self, conn, msg: MOSDPGPush) -> None:
        pg = self.pgs.get(pg_t(msg.pool, msg.ps))
        if pg is None:
            return
        # pull request from the primary: respond with object pushes
        if msg.pushes and msg.pushes[0].get("pull"):
            oids = msg.pushes[0]["oids"]
            pushes = [self._make_push(pg, oid,
                                      pg.log.objects_since((0, 0)).get(
                                          oid, LogEntry.MODIFY))
                      for oid in oids]
            conn.send(MOSDPGPush(pool=msg.pool, ps=msg.ps,
                                 epoch=msg.epoch, pushes=pushes))
            return
        # real pushes: apply objects ("snap" targets a clone object —
        # EC clone-shard recovery)
        from ..store.objectstore import NOSNAP
        t = Transaction()
        done = []
        for push in msg.pushes:
            ho = hobject_t(push["oid"],
                           snap=push.get("snap", NOSNAP))
            if push.get("delete"):
                if self.store.exists(pg.cid, ho):
                    t.remove(pg.cid, ho)
            else:
                t.remove(pg.cid, ho) if self.store.exists(pg.cid, ho) \
                    else None
                t.touch(pg.cid, ho)
                t.write(pg.cid, ho, 0, len(push["data"]), push["data"])
                for k, v in (push.get("attrs") or {}).items():
                    t.setattr(pg.cid, ho, k, v)
                if push.get("omap"):
                    t.omap_setkeys(pg.cid, ho, push["omap"])
                for cl in push.get("clones") or ():
                    cho = hobject_t(push["oid"], snap=cl["snap"])
                    if self.store.exists(pg.cid, cho):
                        t.remove(pg.cid, cho)
                    t.touch(pg.cid, cho)
                    t.write(pg.cid, cho, 0, len(cl["data"]),
                            cl["data"])
                    for k, v in (cl.get("attrs") or {}).items():
                        t.setattr(pg.cid, cho, k, v)
            done.append(push["oid"])
            pg.missing.pop(push["oid"], None)
            pg.recovering.discard(push["oid"])
        pg.info.last_complete = pg.info.last_update
        pg.persist_meta(t)
        self.store.apply_transaction(t)
        if pg.is_primary():
            # primary pulled its own missing objects: recovery
            # progress counted here (peer pushes count on the reply)
            pg.stats.note_recovery(len(done), sum(
                len(p.get("data") or b"") for p in msg.pushes))
            self._note_recovery_progress(pg)
        conn.send(MOSDPGPushReply(pool=msg.pool, ps=msg.ps,
                                  epoch=msg.epoch, oids=done))
        if pg.is_primary() and not pg.missing:
            # primary finished pulling: now push to replicas + serve
            self._kick_recovery(pg)
            self._requeue_waiters(pg)

    def _handle_pg_push_reply(self, msg: MOSDPGPushReply) -> None:
        pg = self.pgs.get(pg_t(msg.pool, msg.ps))
        if pg is None or not pg.is_primary():
            return
        sender = int(msg.src.split(".")[1])
        pm = pg.peer_missing.get(sender)
        if pm:
            recovered = 0
            for oid in msg.oids:
                if pm.pop(oid, None) is not None:
                    recovered += 1
            pg.stats.note_recovery(recovered)
            self._note_recovery_progress(pg)
            # degraded-object writes park until their replicas are
            # whole again: re-gate them now
            if pg.waiting_for_active and pg.state == STATE_ACTIVE:
                self._requeue_waiters(pg)
        self._maybe_clear_pg_temp(pg)

    def _requeue_waiters(self, pg: PG) -> None:
        self._release_backoffs(pg)
        waiting, pg.waiting_for_active = pg.waiting_for_active, []
        for conn, msg in waiting:
            self._handle_op(conn, msg)

    # -- client backoff (PrimaryLogPG add_backoff / osd_backoff) -----------

    def _send_backoff(self, pg: PG, conn, oid: str | None = None) -> None:
        """Tell the client to stop re-sending ops for this PG (oid
        None) or one degraded object of it (the reference's
        hobject-ranged backoffs): the op is parked here and will be
        answered when the PG activates / the object recovers.  Without
        this, the Objecter's timeout-resend ramp would spam a peering /
        below-min-size PG with duplicates.  A PG-wide block supersedes
        object blocks, so none is sent while one is live."""
        if conn.peer_entity.startswith("osd"):
            return
        if (conn, None) in pg.backoffs or (conn, oid) in pg.backoffs:
            return
        self._backoff_id += 1
        pg.backoffs[(conn, oid)] = self._backoff_id
        conn.send(MOSDBackoff(pool=pg.pool_id, ps=pg.ps, op="block",
                              id=self._backoff_id, oid=oid,
                              epoch=self.osdmap.epoch))

    def _release_backoffs(self, pg: PG, oid: str | None = None) -> None:
        """Release every backoff (oid None) or just one object's."""
        if oid is None:
            backoffs, pg.backoffs = pg.backoffs, {}
        else:
            backoffs = {k: v for k, v in pg.backoffs.items()
                        if k[1] == oid}
            for k in backoffs:
                del pg.backoffs[k]
        for (conn, boid), bid in backoffs.items():
            if conn.is_open:
                conn.send(MOSDBackoff(pool=pg.pool_id, ps=pg.ps,
                                      op="unblock", id=bid, oid=boid,
                                      epoch=self.osdmap.epoch))

    # -- client ops --------------------------------------------------------

    def _handle_op(self, conn, msg: MOSDOp) -> None:
        self._op_event(msg, "reached_pg")
        if self.osdmap is None or msg.epoch > self.osdmap.epoch:
            if self._deferred_maps and self.device_chip is not None \
                    and self.device_chip.lost:
                # the epoch waits for this OSD's lost chip: the op fails
                # like the chip's other ops, it does not park until the
                # heal
                self._reply_chip_lost(conn, msg)
                return
            self._op_event(msg, "waiting_for_map")
            self._waiting_for_map.append((conn, msg))
            return
        pool = self.osdmap.pools.get(msg.pool)
        if pool is None:
            conn.send(MOSDOpReply(tid=msg.tid, result=-2, outs=[],
                                  epoch=self.osdmap.epoch, version=0))
            self._op_finish(msg, "no_such_pool")
            return
        if msg.oid:
            # split retarget: after a pg_num grow the object may now
            # belong to a child PG the sender's older map cannot see —
            # drop, the client re-targets on its next map (Objecter
            # _scan_requests); executing here would strand the write
            # in the parent PG the readers no longer consult
            actual = pool.raw_pg_to_pg(
                self.osdmap.object_locator_to_pg(msg.oid, msg.pool)).ps
            if actual != msg.ps:
                self._op_finish(msg, "dropped_wrong_pg_after_split")
                return
        pgid = pg_t(msg.pool, msg.ps)
        pg = self.pgs.get(pgid)
        if pg is None or not pg.is_primary():
            # not mine: drop — the client resends on map change
            # (Objecter handle_osd_map -> _scan_requests)
            self._op_finish(msg, "dropped_not_primary")
            return
        dup = pg.lookup_reqid(msg.src, msg.tid)
        if dup is not None:
            # reqid dup detection: a timeout-triggered resend of an
            # already-committed (possibly non-idempotent) op is
            # answered from the journal, never re-executed
            conn.send(MOSDOpReply(
                tid=msg.tid, result=dup["result"], outs=dup["outs"],
                epoch=self.osdmap.epoch, version=dup["version"]))
            self.perf.inc("dup_ops")
            self._op_finish(msg, "dup_answered_from_journal")
            return
        if pg.state != STATE_ACTIVE:
            self._op_event(msg, "waiting_for_active")
            pg.waiting_for_active.append((conn, msg))
            self._send_backoff(pg, conn)
            return
        if pool.is_erasure():
            if not self._min_size_ok(pg, pool):
                self._op_event(msg, "waiting_for_min_size")
                pg.waiting_for_active.append((conn, msg))
                self._send_backoff(pg, conn)
                return
            self.msgr.spawn(self.ec.handle_op(pg, conn, msg))
            return
        writes = any(self._op_is_write(o) for o in msg.ops)
        if not self._min_size_ok(pg, pool):
            self._op_event(msg, "waiting_for_min_size")
            pg.waiting_for_active.append((conn, msg))
            self._send_backoff(pg, conn)
            return
        if any(o["op"] in ("watch", "unwatch", "notify")
               for o in msg.ops):
            self.msgr.spawn(self._handle_watch_ops(pg, conn, msg))
            return
        oid = msg.oid
        if oid in pg.missing:
            # object-scoped backoff (the reference's hobject-ranged
            # add_backoff for degraded objects): only ops on THIS
            # object pause client-side; the rest of the PG flows
            self._op_event(msg, "waiting_for_missing_object")
            pg.waiting_for_active.append((conn, msg))
            self._send_backoff(pg, conn, oid=oid)
            self._kick_recovery(pg)
            return
        if writes and any(oid in (pg.peer_missing.get(o) or {})
                          for o in pg.acting
                          if 0 <= o != self.whoami
                          and o != ITEM_NONE
                          and o not in getattr(pg, "backfill_targets",
                                               set())):
            # wait_for_degraded_object (PrimaryLogPG.cc): a write to
            # an object a log-recovering replica still lacks would
            # ship ops (truncate, partial write) it cannot apply —
            # recover it first, then requeue.  Backfill targets are
            # exempt (their peer_missing is the WHOLE collection; the
            # reference keeps the PG writable through backfill) — the
            # replica apply path tolerates their absent objects.
            self._op_event(msg, "waiting_for_degraded_object")
            pg.waiting_for_active.append((conn, msg))
            self._send_backoff(pg, conn, oid=oid)
            self._kick_recovery(pg)
            return
        if pool.compression_mode == "force" \
                and not pool.is_erasure():
            # compression pools: the compress/decompress CPU work is
            # paced through the device runtime's background class so
            # a compressed burst cannot starve client EC dispatches
            self.msgr.spawn(
                self._compression_paced(pg, conn, msg, writes))
            return
        if getattr(pool, "dedup_chunk_pool", -1) >= 0 \
                and not pool.is_erasure():
            # dedup base pools: chunk/fingerprint planning plus the
            # chunk-store I/O are async (internal objecter) and ride
            # the same background admission class as compression
            self.msgr.spawn(
                self.dedup.handle_op(pg, conn, msg, writes))
            return
        if writes:
            self._execute_write(pg, conn, msg)
        else:
            self._serve_read(pg, conn, msg)

    def _serve_read(self, pg: PG, conn, msg) -> None:
        outs, result = self._do_read_ops(
            pg, msg.oid, msg.ops, getattr(msg, "snapid", None),
            entity=msg.src)
        conn.send(MOSDOpReply(tid=msg.tid, result=result,
                              outs=outs, epoch=self.osdmap.epoch,
                              version=0))
        self.perf.inc("ops")
        pg.stats.note_read(sum(
            len(o.get("data") or b"") for o in outs
            if isinstance(o, dict)))
        self._op_finish(msg, "read_done")

    async def _compression_paced(self, pg: PG, conn, msg,
                                 writes: bool) -> None:
        """Pool-level compress/decompress rides the device runtime's
        BACKGROUND admission class (weight below recovery): a
        compressed-pool burst queues behind the data-path dispatch
        grants instead of interleaving freely with them, so client EC
        flushes keep their share of the chip.  A full admission queue
        degrades to unpaced execution — pacing must never fail or
        park the op itself.

        Pools whose algorithm is the device-native "tlz" additionally
        plan their writefull compressions as device dispatches on
        this OSD's affinity chip (compress/tlz.compress_async) BEFORE
        the synchronous write executes; `_maybe_compress` stores the
        planned blob.  A refused or failed dispatch fails the op with
        -5: nothing compresses on the host instead."""
        from ..device.runtime import (DeviceBusy, DeviceRuntime,
                                      K_BACKGROUND)
        chip = (self.device_chip if self.device_chip is not None
                else DeviceRuntime.get(self.device).chip_for(
                    self.whoami))
        cost = max(1.0, sum(len(op.get("data") or b"")
                            for op in msg.ops
                            if isinstance(op, dict)) / 65536.0)
        t0 = self.optracker.now()
        comp_pre: dict[int, bytes] | None = None
        pool = self.osdmap.pools.get(pg.pool_id)
        if writes and pool is not None \
                and pool.compression_algorithm == "tlz":
            from ..compress import tlz
            for i, op in enumerate(msg.ops):
                if not (isinstance(op, dict)
                        and op.get("op") == "writefull"):
                    continue
                data = op.get("data") or b""
                if len(data) < 128:
                    continue    # below _maybe_compress's floor
                try:
                    blob, path = await tlz.compress_async(
                        data, chip=chip.index, klass=K_BACKGROUND,
                        device=self.device)
                except Exception as e:
                    self._reply_compress_error(conn, msg, e)
                    return
                if comp_pre is None:
                    comp_pre = {}
                comp_pre[i] = blob
                if path == "device":
                    self.perf.inc("comp_device_blobs")
        granted = False
        try:
            await chip.queue.admit(K_BACKGROUND, cost)
            granted = True
            self.perf.inc("comp_paced_ops")
        except DeviceBusy:
            # pacing, not a host route: the blobs were already planned
            # on the card; a full class runs the op unpaced
            pass
        try:
            if writes:
                self._execute_write(pg, conn, msg,
                                    comp_pre=comp_pre)
            else:
                self._serve_read(pg, conn, msg)
        finally:
            if granted:
                chip.queue.release()
            fr = getattr(self.ctx, "flight_recorder", None)
            if fr is not None:
                fr.span("compression_paced", t0,
                        meta={"pgid": str(pg.pgid),
                              "paced": granted})

    def _reply_compress_error(self, conn, msg, e) -> None:
        """A tlz write whose device planning was refused or failed."""
        conn.send(MOSDOpReply(
            tid=msg.tid, result=-5,
            outs=[{"error": repr(e)} for _ in msg.ops],
            epoch=self.osdmap.epoch, version=0))
        self._op_finish(msg, "error_reply")

    async def _handle_watch_ops(self, pg: PG, conn, msg) -> None:
        """watch/unwatch/notify ops (PrimaryLogPG do_osd_ops
        CEPH_OSD_OP_WATCH / NOTIFY)."""
        outs = []
        result = 0
        for op in msg.ops:
            name = op["op"]
            if name == "watch":
                self.watches.watch(pg, msg.oid, conn)
                outs.append({})
            elif name == "unwatch":
                self.watches.unwatch(pg, msg.oid, conn)
                outs.append({})
            elif name == "notify":
                acked = await self.watches.notify(
                    pg, msg.oid, bytes(op.get("payload") or b""),
                    timeout=float(op.get("timeout", 5.0)))
                outs.append({"acked": acked})
            else:
                outs.append({"error": "bad op %s" % name})
                result = -22
        conn.send(MOSDOpReply(tid=msg.tid, result=result, outs=outs,
                              epoch=self.osdmap.epoch, version=0))
        self._op_finish(msg, "watch_done")

    def _min_size_ok(self, pg: PG, pool) -> bool:
        """min_size gating for ALL I/O (PeeringState is_active checks:
        the reference keeps a PG inactive, blocking reads and writes,
        while |acting| < pool.min_size).  EC additionally requires k
        live shards — acking a write persisted on fewer than k shards
        would make the object durable but unreadable."""
        live = sum(1 for o in pg.acting
                   if o >= 0 and self.osdmap.is_up(o))
        need = pool.min_size
        if pool.is_erasure():
            try:
                need = max(need,
                           self.ec.codec(pool).get_data_chunk_count())
            except Exception:
                pass  # unknown profile: handle_op will fail the op
        return live >= need

    def _op_is_write(self, o: dict) -> bool:
        """Write-path routing: builder ops by name; a cls call by its
        registered method flags (PrimaryLogPG's CEPH_OSD_OP_CALL
        flag check)."""
        from .cls import ClsError

        if o["op"] in _WRITE_OPS:
            return True
        if o["op"] == "call":
            try:
                return self.cls_handler.is_write(
                    o.get("cls", ""), o.get("method", ""))
            except ClsError:
                return False    # unknown: read path reports the error
        return False

    # -- pool compression (BlueStore blob-compression role over the
    # object layer; src/compressor consumers) --------------------------

    def _maybe_compress(self, pool, pg: PG, ho, data: bytes,
                        t: Transaction, cstate: dict,
                        blob: bytes | None = None) -> bytes:
        """Full-object writes on a compression pool store the
        compressed image when it saves enough (the reference's
        required-ratio gate); the algorithm + logical size ride
        xattrs so every consumer (reads, recovery pushes, scrub) sees
        a self-describing blob.  EC pools skip — stripe math needs
        the raw bytes.  ``cstate`` tracks per-txn staged comp state
        (ho -> algo | None): later ops in the SAME MOSDOp must see
        what earlier ops staged, not the committed attrs.  ``blob``
        is the device-planned compression of exactly ``data`` (the
        tlz path); a tlz pool never compresses on the host here."""
        from ..compress import (OBJ_ALGO_ATTR, OBJ_SIZE_ATTR,
                                CompressorError, create)

        if pool is None or pool.compression_mode != "force" \
                or pool.is_erasure() or len(data) < 128:
            self._clear_comp_attrs(pg, ho, t, cstate)
            cstate[ho] = (None, data)
            return data
        if blob is None:
            if pool.compression_algorithm == "tlz":
                raise CompressorError(
                    "tlz blobs are planned on the card, not the host")
            blob = create(pool.compression_algorithm).compress(data)
        if len(blob) * 10 >= len(data) * 9:     # <10% saved: keep raw
            self._clear_comp_attrs(pg, ho, t, cstate)
            cstate[ho] = (None, data)
            return data
        t.setattr(pg.cid, ho, OBJ_ALGO_ATTR,
                  pool.compression_algorithm.encode())
        t.setattr(pg.cid, ho, OBJ_SIZE_ATTR, b"%d" % len(data))
        # keep the raw image beside the staged algo: a later op in
        # this txn cannot read the blob back (it is not applied yet)
        cstate[ho] = (pool.compression_algorithm, data)
        return blob

    def _clear_comp_attrs(self, pg: PG, ho, t: Transaction,
                          cstate: dict) -> None:
        from ..compress import OBJ_ALGO_ATTR, OBJ_SIZE_ATTR

        if self._comp_state(pg, ho, cstate)[0] is not None:
            t.rmattr(pg.cid, ho, OBJ_ALGO_ATTR)
            t.rmattr(pg.cid, ho, OBJ_SIZE_ATTR)
        cstate[ho] = None   # raw; content set by the caller's write

    def _comp_state(self, pg: PG, ho, cstate: dict | None = None
                    ) -> tuple[str | None, bytes | None]:
        """(algo, staged raw bytes) — txn-staged state wins over the
        committed attrs."""
        if cstate is not None and ho in cstate:
            st = cstate[ho]
            return (None, None) if st is None else st
        from ..compress import OBJ_ALGO_ATTR

        try:
            return (self.store.getattr(pg.cid, ho,
                                       OBJ_ALGO_ATTR).decode(), None)
        except NotFound:
            return (None, None)

    def _comp_algo(self, pg: PG, ho,
                   cstate: dict | None = None) -> str | None:
        return self._comp_state(pg, ho, cstate)[0]

    def _decompress_in_txn(self, pg: PG, ho, t: Transaction,
                           cstate: dict) -> None:
        """Partial mutations of a compressed object rewrite it raw
        first (staged in the same txn), so offset math stays exact —
        the GC/rewrite move BlueStore makes when a compressed blob is
        partially overwritten.  No-op if this txn already staged a
        raw image (cstate says None)."""
        algo, raw = self._comp_state(pg, ho, cstate)
        if algo is None:
            return
        from ..compress import OBJ_ALGO_ATTR, OBJ_SIZE_ATTR, create

        if raw is None:
            blob = self.store.read(pg.cid, ho)
            # a whiteout tombstone keeps its comp attrs but was
            # truncated to zero: its logical image is empty, not a
            # corrupt stream
            raw = create(algo).decompress(blob) if blob else b""
            if blob:
                self._check_comp_size(pg, ho, raw)
        t.truncate(pg.cid, ho, 0)
        t.write(pg.cid, ho, 0, len(raw), raw)
        t.rmattr(pg.cid, ho, OBJ_ALGO_ATTR)
        t.rmattr(pg.cid, ho, OBJ_SIZE_ATTR)
        # (None, raw): raw image staged WITH its content, so a later
        # op in this txn (e.g. a cls read) still sees logical bytes
        cstate[ho] = (None, raw)

    def _read_decompressed(self, pg: PG, ho, offset: int = 0,
                           length: int = -1) -> bytes:
        algo = self._comp_algo(pg, ho)
        if algo is None:
            return self.store.read(pg.cid, ho, offset, length)
        from ..compress import create

        raw = create(algo).decompress(self.store.read(pg.cid, ho))
        self._check_comp_size(pg, ho, raw)
        if length < 0:
            return raw[offset:]
        return raw[offset:offset + length]

    def _check_comp_size(self, pg: PG, ho, raw: bytes) -> None:
        """Decompress-side integrity: the stored `comp-size` attr and
        the decompressed length must agree, or the read fails with a
        CompressorError (EIO to the client) instead of silently
        serving truncated/padded data.  The rot is scrub-visible —
        deep scrub digests the stored blob AND the attrs, so a
        tampered blob or size attr diverges from the healthy replicas
        and repairs like any other inconsistency (the thrasher's
        `corrupt_compressed` arm proves the loop end to end)."""
        from ..compress import OBJ_SIZE_ATTR, CompressorError

        try:
            want = int(self.store.getattr(pg.cid, ho, OBJ_SIZE_ATTR))
        except (NotFound, ValueError):
            return      # no size attr staged (mid-txn states): skip
        if want != len(raw):
            self.perf.inc("comp_size_mismatches")
            raise CompressorError(
                "compressed object %s: comp-size attr %d disagrees"
                " with decompressed length %d" % (ho, want, len(raw)))

    def _stat_decompressed(self, pg: PG, ho) -> int:
        from ..compress import OBJ_SIZE_ATTR
        from ..dedup import OBJ_LOGICAL_ATTR

        try:
            # a manifested object's stored size is its manifest blob;
            # stat answers the logical (pre-dedup) size
            return int(self.store.getattr(pg.cid, ho,
                                          OBJ_LOGICAL_ATTR))
        except (NotFound, ValueError):
            pass
        try:
            return int(self.store.getattr(pg.cid, ho, OBJ_SIZE_ATTR))
        except NotFound:
            return self.store.stat(pg.cid, ho)

    # read-side op interpreter (do_osd_ops read branch)
    def _do_read_ops(self, pg: PG, oid: str, ops: list,
                     snapid: int | None = None, entity: str = ""):
        from ..store.objectstore import NOSNAP
        from . import snaps as snapmod
        if snapid not in (None, NOSNAP):
            # snapshot read: resolve to the covering clone or the
            # unmodified head (find_object_context)
            ho = snapmod.resolve_read_snap(self.store, pg, oid, snapid)
            if ho is None and any(o["op"] != "pgls" for o in ops):
                return ([{"error": "not found"}], -2)
        else:
            ho = hobject_t(oid)
            if oid and snapmod.is_whiteout(self.store, pg.cid, ho):
                ho = None
                if any(o["op"] != "pgls" for o in ops):
                    return ([{"error": "not found"}], -2)
        outs = []
        result = 0
        for op in ops:
            name = op["op"]
            try:
                if name == "read":
                    length = op.get("length", 0) or -1
                    data = self._read_decompressed(
                        pg, ho, op.get("offset", 0), length)
                    outs.append({"data": data})
                elif name == "stat":
                    outs.append({"size": self._stat_decompressed(
                        pg, ho)})
                elif name == "getxattr":
                    outs.append({"value": self.store.getattr(
                        pg.cid, ho, op["name"])})
                elif name == "omap-get":
                    outs.append({"kv": self.store.omap_get(pg.cid, ho)})
                elif name == "call":
                    from .cls import MethodContext

                    ctx = MethodContext(self.store, pg.cid, ho,
                                        None, entity)
                    code, out = self.cls_handler.call(
                        op.get("cls", ""), op.get("method", ""),
                        ctx, op.get("input") or {})
                    if code != 0:
                        outs.append(out)
                        result = code
                    else:
                        outs.append({"out": out})
                elif name == "pgls":
                    # PG object listing (the rados ls / pool
                    # enumeration primitive, PrimaryLogPG do_pg_op
                    # CEPH_OSD_OP_PGNLS); clones and whiteout heads
                    # are invisible to listing (PGNLS lists heads)
                    from ..store.objectstore import NOSNAP as _NS
                    names = sorted(
                        h.name for h in
                        self.store.collection_list(pg.cid)
                        if h.name != "__pgmeta__" and h.snap == _NS
                        and not snapmod.is_whiteout(self.store,
                                                    pg.cid, h))
                    outs.append({"names": names})
                else:
                    outs.append({"error": "bad op %s" % name})
                    result = -22
            except NotFound:
                outs.append({"error": "not found"})
                result = -2
            except Exception as e:
                from ..compress import CompressorError

                if not isinstance(e, CompressorError):
                    raise
                # corrupt blob / missing plugin: EIO, never a wedge
                outs.append({"error": str(e)})
                result = -5
        return outs, result

    def _execute_write(self, pg: PG, conn, msg: MOSDOp,
                       comp_pre: dict[int, bytes] | None = None,
                       dedup_pre: dict | None = None) -> None:
        """prepare_transaction + issue_repop (PrimaryLogPG.cc:8869,
        11394).  Snapshot bookkeeping (make_writeable) runs first so
        the clone ops ride the same replicated transaction.
        ``comp_pre`` maps op-list indices to device-planned
        compression blobs `_compression_paced` staged for writefull
        ops (byte-identical to the sync compressor's output).
        ``dedup_pre`` is the dedup plane's plan: ``manifest`` maps
        writefull op indices to a pre-built (manifest blob, logical
        size) — or None for an explicit raw store — and
        ``materialize`` carries the raw image of a manifested object
        about to be mutated in place."""
        from . import snaps as snapmod
        self._op_event(msg, "started_write")
        epoch = self.osdmap.epoch
        ver = pg.info.last_update[1] + 1
        version = (epoch, ver)
        ho = hobject_t(msg.oid)
        t = Transaction()
        outs, result = [], 0
        ss = snapmod.make_writeable(self.store, pg, ho,
                                    getattr(msg, "snapc", None), t)
        head_whiteout = snapmod.is_whiteout(self.store, pg.cid, ho)
        is_delete = False
        cstate: dict = {}   # per-txn staged compression state
        dmap = (dedup_pre or {}).get("manifest") or {}
        if dedup_pre and dedup_pre.get("materialize") is not None:
            from ..dedup import OBJ_LOGICAL_ATTR, OBJ_MANIFEST_ATTR
            raw0 = dedup_pre["materialize"]
            # a manifested object mutated in place: stage the
            # materialized raw image (and drop the manifest attrs)
            # ahead of the op list, so offset math sees logical bytes
            if self.store.exists(pg.cid, ho):
                t.truncate(pg.cid, ho, 0)
            else:
                t.touch(pg.cid, ho)
            t.write(pg.cid, ho, 0, len(raw0), raw0)
            t.rmattr(pg.cid, ho, OBJ_MANIFEST_ATTR)
            t.rmattr(pg.cid, ho, OBJ_LOGICAL_ATTR)
            cstate[ho] = (None, raw0)
        from ..compress import CompressorError
        for op_i, op in enumerate(msg.ops):
            name = op["op"]
            if name == "write":
                data = op["data"]
                off = op.get("offset", 0)
                if not self.store.exists(pg.cid, ho):
                    t.touch(pg.cid, ho)
                elif head_whiteout:
                    # resurrecting a whiteout head: clear the tombstone
                    t.setattr(pg.cid, ho, snapmod.WHITEOUT_ATTR, b"0")
                try:
                    self._decompress_in_txn(pg, ho, t, cstate)
                except CompressorError as e:
                    outs.append({"error": str(e)})
                    result = -5
                    continue
                t.write(pg.cid, ho, off, len(data), data)
                outs.append({})
            elif name == "writefull":
                data = op["data"]
                if self.store.exists(pg.cid, ho):
                    t.truncate(pg.cid, ho, 0)
                    if head_whiteout:
                        t.setattr(pg.cid, ho, snapmod.WHITEOUT_ATTR,
                                  b"0")
                else:
                    t.touch(pg.cid, ho)
                if op_i in dmap:
                    # dedup-planned writefull: store the manifest
                    # blob (or an explicit raw image when planning
                    # degraded) with the dedup attrs kept in step —
                    # dedup base pools are compression-free by mon
                    # validation, so the compression path is skipped
                    from ..dedup import (OBJ_LOGICAL_ATTR,
                                         OBJ_MANIFEST_ATTR)
                    ent = dmap[op_i]
                    if ent is not None:
                        blob, logical = ent
                        t.write(pg.cid, ho, 0, len(blob), blob)
                        t.setattr(pg.cid, ho, OBJ_MANIFEST_ATTR,
                                  b"1")
                        t.setattr(pg.cid, ho, OBJ_LOGICAL_ATTR,
                                  b"%d" % logical)
                    else:
                        t.write(pg.cid, ho, 0, len(data), data)
                        t.rmattr(pg.cid, ho, OBJ_MANIFEST_ATTR)
                        t.rmattr(pg.cid, ho, OBJ_LOGICAL_ATTR)
                    cstate[ho] = (None, data)
                    outs.append({})
                    continue
                pool0 = self.osdmap.pools.get(pg.pool_id)
                try:
                    stored = self._maybe_compress(
                        pool0, pg, ho, data, t, cstate,
                        blob=(comp_pre or {}).get(op_i))
                except CompressorError as e:
                    outs.append({"error": str(e)})
                    result = -5
                    continue
                t.write(pg.cid, ho, 0, len(stored), stored)
                outs.append({})
            elif name == "delete":
                if self.store.exists(pg.cid, ho) and not head_whiteout:
                    is_delete = snapmod.delete_head(self.store, pg,
                                                    ho, ss, t)
                    ss = None          # delete_head persisted it
                    outs.append({})
                else:
                    outs.append({"error": "not found"})
                    result = -2
            elif name == "truncate":
                try:
                    self._decompress_in_txn(pg, ho, t, cstate)
                except CompressorError as e:
                    outs.append({"error": str(e)})
                    result = -5
                    continue
                t.truncate(pg.cid, ho, op["length"])
                outs.append({})
            elif name == "setxattr":
                t.setattr(pg.cid, ho, op["name"], op["value"])
                outs.append({})
            elif name == "omap-rm":
                t.omap_rmkeys(pg.cid, ho,
                              [bytes(k) for k in op["keys"]])
                outs.append({})
            elif name == "omap-set":
                t.omap_setkeys(pg.cid, ho, op["kv"])
                outs.append({})
            elif name == "call":
                # cls method: reads committed state, stages writes
                # into this op's replicated transaction (atomic with
                # the rest of the op list)
                from .cls import MethodContext

                cctx = MethodContext(self.store, pg.cid, ho, t,
                                     msg.src, whiteout=head_whiteout,
                                     cstate=cstate)
                code, out = self.cls_handler.call(
                    op.get("cls", ""), op.get("method", ""),
                    cctx, op.get("input") or {})
                if code != 0:
                    outs.append(out)
                    result = code
                else:
                    if cctx._staged_remove and \
                            self.store.exists(pg.cid, ho) \
                            and not head_whiteout:
                        # snapshot-aware deletion, like the delete op
                        is_delete = snapmod.delete_head(
                            self.store, pg, ho, ss, t)
                        ss = None
                    outs.append({"out": out})
            elif name in _WRITE_OPS or name in ("read", "stat"):
                outs.append({"error": "mixed rw unsupported"})
                result = -22
            else:
                outs.append({"error": "bad op %s" % name})
                result = -22
        if result != 0:
            conn.send(MOSDOpReply(tid=msg.tid, result=result, outs=outs,
                                  epoch=epoch, version=0))
            self._op_finish(msg, "error_reply")
            return
        snapmod.persist_snapset(pg, ho, ss, t)
        entry = LogEntry(
            LogEntry.DELETE if is_delete else LogEntry.MODIFY,
            msg.oid, version, pg.info.last_update)
        pg.info.last_update = version
        pg.log.append(entry)
        pg.persist_log_entry(t, entry)
        pg.maybe_trim_log(t)   # rides the replicated txn to replicas
        pg.persist_meta(t)
        # reqid dup journal rides the same (replicated) transaction:
        # the mutation and its dup row land atomically everywhere, so
        # a resend after the reply was lost is answered, not re-run
        pg.record_reqid(t, msg.src, msg.tid, 0, outs, ver)
        wbytes = sum(len(op.get("data") or b"") for op in msg.ops
                     if isinstance(op, dict))
        self.note_op_size(wbytes)
        self._rep_tid += 1
        rep_tid = self._rep_tid
        waiting = set()
        txn_wire = denc.encode(t.to_wire())
        trace = getattr(msg, "trace", None)
        tenant = getattr(msg, "tenant", None)
        for osd in pg.acting:
            if osd < 0 or osd == self.whoami:
                continue
            waiting.add(osd)
            rep = MOSDRepOp(
                pool=pg.pool_id, ps=pg.ps, tid=rep_tid, txn=txn_wire,
                log_entry=entry.to_wire(), epoch=epoch,
                min_epoch=pg.info.same_interval_since,
                pg_trim_to=None)
            rep.trace = trace   # sub-op joins the client op's span
            rep.tenant = tenant
            self._send_osd(osd, rep)
        self.store.apply_transaction(t)
        if not waiting:
            conn.send(MOSDOpReply(tid=msg.tid, result=0, outs=outs,
                                  epoch=epoch, version=ver))
            self.perf.inc("ops")
            pg.stats.note_write(wbytes)
            self._op_finish(msg, "done_no_replicas")
            return
        self._op_event(msg, "sub_op_sent")
        pg.in_flight[rep_tid] = {
            "waiting": waiting, "conn": conn, "tid": msg.tid,
            "outs": outs, "version": ver, "bytes": wbytes,
            "top": getattr(msg, "_top", None),
            "t_sub": time.monotonic(),
        }

    def _handle_repop(self, conn, msg: MOSDRepOp) -> None:
        """Replica apply (ReplicatedBackend handle_message sub_op)."""
        self._op_event(msg, "started_apply")
        pgid = pg_t(msg.pool, msg.ps)
        pg = self.pgs.get(pgid)
        if pg is None:
            pg = PG(self, msg.pool, msg.ps)
            pg.create_onstore()
            self.pgs[pgid] = pg
        t = Transaction.from_wire(denc.decode(msg.txn))
        entry = LogEntry.from_wire(msg.log_entry)
        pg.log.append(entry)
        pg.info.last_update = entry.version
        # mirror the primary's trim policy so the in-memory log stays
        # in lockstep with the omap rows the replicated txn trims
        pg.maybe_trim_log(t)
        try:
            self.store.apply_transaction(t)
        except NotFound:
            # Tolerated ONLY while this replica is a known backfill /
            # recovery target for the object (pg.missing lists it):
            # the skipped ops converge via the push.  The pgmeta rows
            # later in the txn must still land, so apply op by op.
            # Anything else is real divergence and must surface.
            if not pg.missing:
                raise
            for op in t.ops:
                one = Transaction()
                one.ops.append(op)
                try:
                    self.store.apply_transaction(one)
                except NotFound:
                    ho = next((a for a in op
                               if isinstance(a, hobject_t)), None)
                    if ho is None or ho.name not in pg.missing:
                        raise
        conn.send(MOSDRepOpReply(pool=msg.pool, ps=msg.ps, tid=msg.tid,
                                 result=0, epoch=msg.epoch))
        self._op_finish(msg, "applied")

    def _handle_repop_reply(self, msg: MOSDRepOpReply) -> None:
        pg = self.pgs.get(pg_t(msg.pool, msg.ps))
        if pg is None:
            return
        st = pg.in_flight.get(msg.tid)
        if st is None:
            return
        sender = int(msg.src.split(".")[1])
        st["waiting"].discard(sender)
        top = st.get("top")
        if top is not None:
            top.mark_event("commit_rec_osd.%d" % sender)
        if not st["waiting"]:
            del pg.in_flight[msg.tid]
            t_sub = st.get("t_sub")
            if t_sub is not None:
                rtt = time.monotonic() - t_sub
                self.perf.hist_sample("op_subop_rtt", rtt)
                if top is not None and top.tenant is not None:
                    self.note_tenant_stage(top.tenant, "subop_rtt",
                                           rtt)
            if st["conn"] is not None:     # internal txns (snap trim)
                st["conn"].send(MOSDOpReply(
                    tid=st["tid"], result=0, outs=st["outs"],
                    epoch=self.osdmap.epoch, version=st["version"]))
                self.perf.inc("ops")
                pg.stats.note_write(st.get("bytes", 0))
            if top is not None:
                top.finish("done")

    # -- snapshot trim (PrimaryLogPG Trimming / SnapTrimEvent) -------------

    def _maybe_snap_trim(self, pg: PG) -> None:
        pool = self.osdmap.pools.get(pg.pool_id)
        if (pool is None or not pool.removed_snaps
                or not pg.is_primary() or pg.state != STATE_ACTIVE):
            return
        self.msgr.spawn(self._snap_trim(pg))

    def _load_purged(self, pg: PG) -> set[int]:
        from .pg import PGMETA_OID
        try:
            raw = self.store.omap_get(pg.cid, PGMETA_OID).get(
                b"purged_snaps")
        except Exception:
            return set()
        return set(denc.decode(raw)) if raw else set()

    async def _snap_trim(self, pg: PG) -> None:
        """Walk the SnapMapper rows for each removed-but-unpurged
        snap; per object, drop the snap from its clone (deleting the
        clone when its snap set empties) as a replicated, logged
        transaction — paced through the mClock 'snaptrim' class."""
        from . import snaps as snapmod
        from .pg import PGMETA_OID
        from .scheduler import K_SNAPTRIM
        if getattr(pg, "_trim_flow", False):
            return
        pg._trim_flow = True
        try:
            purged = self._load_purged(pg)
            pool = self.osdmap.pools.get(pg.pool_id)
            if pool is None:
                return
            for sid in [s for s in pool.removed_snaps
                        if s not in purged]:
                for oid in snapmod.list_snap_objects(self.store, pg,
                                                     sid):
                    await self.sched.admit(K_SNAPTRIM,
                                           key=(pg.pool_id, pg.ps))
                    if (not pg.is_primary()
                            or pg.state != STATE_ACTIVE
                            or self.stopping):
                        return
                    self._submit_trim(pg, oid, sid)
                purged.add(sid)
                t = Transaction()
                t.omap_setkeys(pg.cid, PGMETA_OID, {
                    b"purged_snaps": denc.encode(sorted(purged))})
                self.store.apply_transaction(t)
        finally:
            pg._trim_flow = False

    def _submit_trim(self, pg: PG, oid: str, sid: int) -> None:
        """One object's trim as a logged replicated transaction (the
        same wire path as a client write, no reply connection)."""
        from . import snaps as snapmod
        t = Transaction()
        snapmod.trim_object(self.store, pg, oid, sid, t)
        epoch = self.osdmap.epoch
        version = (epoch, pg.info.last_update[1] + 1)
        entry = LogEntry(LogEntry.MODIFY, oid, version,
                         pg.info.last_update)
        pg.info.last_update = version
        pg.log.append(entry)
        pool = self.osdmap.pools.get(pg.pool_id)
        if pool is not None and pool.is_erasure():
            # EC peers speak the EC sub-write channel; ship the BARE
            # trim txn (clone removal + snapset attr — identical on
            # every shard): handle_sub_write appends each shard's own
            # log/meta rows, matching submit_write's contract
            bare_wire = denc.encode(t.to_wire())
            self.ec._tid += 1
            for j, osd in enumerate(pg.acting):
                if osd < 0 or osd == self.whoami:
                    continue
                self._send_osd(osd, MOSDECSubOpWrite(
                    pool=pg.pool_id, ps=pg.ps, shard=j,
                    tid=self.ec._tid, txn=bare_wire,
                    log_entry=entry.to_wire(), epoch=epoch))
            pg.persist_log_entry(t, entry)
            pg.maybe_trim_log(t)
            pg.persist_meta(t)
            self.store.apply_transaction(t)
            return
        pg.persist_log_entry(t, entry)
        pg.maybe_trim_log(t)
        pg.persist_meta(t)
        txn_wire = denc.encode(t.to_wire())
        self._rep_tid += 1
        rep_tid = self._rep_tid
        waiting = set()
        for osd in pg.acting:
            if osd < 0 or osd == self.whoami:
                continue
            waiting.add(osd)
            self._send_osd(osd, MOSDRepOp(
                pool=pg.pool_id, ps=pg.ps, tid=rep_tid, txn=txn_wire,
                log_entry=entry.to_wire(), epoch=epoch,
                min_epoch=pg.info.same_interval_since,
                pg_trim_to=None))
        self.store.apply_transaction(t)
        if waiting:
            pg.in_flight[rep_tid] = {
                "waiting": waiting, "conn": None, "tid": 0,
                "outs": [], "version": version[1]}

    # -- heartbeats --------------------------------------------------------

    async def _heartbeat_loop(self) -> None:
        conf = self.ctx.conf
        while not self.stopping:
            await asyncio.sleep(conf["heartbeat_interval"])
            if self.osdmap is None or not self.booted:
                continue
            # recovery watchdog (OSD tick -> RecoveryPreemption /
            # queue_recovery): a push flow aborted by an interval
            # change or a dropped reply must not strand missing
            # objects — re-kick any primary PG with outstanding work
            # and re-check pg_temp release
            for pg in list(self.pgs.values()):
                if not pg.is_primary() or pg.state != STATE_ACTIVE:
                    continue
                if (pg.missing
                        or any(pg.peer_missing.get(o)
                               for o in pg.peer_missing)) \
                        and not getattr(pg, "_recovery_flow", False):
                    self._kick_recovery(pg)
                elif pg.waiting_for_active and not pg.missing:
                    # safety net against stuck parked ops: an active,
                    # whole PG with waiters means a requeue edge was
                    # lost (e.g. the push-reply that should have fired
                    # it raced an interval flip) — requeue now, gated
                    # on min_size so a still-degraded PG does not spin
                    pool = self.osdmap.pools.get(pg.pool_id)
                    if pool is not None and self._min_size_ok(pg,
                                                              pool):
                        self._requeue_waiters(pg)
                self._maybe_clear_pg_temp(pg)
            self._maybe_schedule_scrub()
            self._maybe_send_mgr_report()
            self._maybe_send_beacon()
            # event plane: re-flush unacked clog entries and pending
            # crash reports (delivery survives leader elections)
            self.clog.flush()
            self._maybe_ship_crashes()
            now = time.monotonic()
            grace = conf["heartbeat_grace"]
            # prune state for peers the map says are down, so a later
            # reboot starts with a fresh window instead of a stale
            # stamp that would instantly re-report it failed
            for osd in list(self.hb_last_rx):
                if osd >= self.osdmap.max_osd \
                        or not self.osdmap.is_up(osd):
                    del self.hb_last_rx[osd]
            # network plane housekeeping: the RTT tracker prunes by
            # the same rule, the messenger drops dead osd peers'
            # clock-offset and folded-wire entries (both tables would
            # otherwise grow forever across kill/revive cycles), the
            # wire ring takes a cumulative per-peer byte sample for
            # the chrome-trace counter tracks, and the messenger
            # resend/replay totals land in the perf counters
            alive = [osd for osd in range(self.osdmap.max_osd)
                     if self.osdmap.is_up(osd)]
            self.network.prune(alive)
            self.msgr.prune_peer_state("osd.%d" % o for o in alive)
            net_rows = self.msgr.net_dump()
            self.network.sample_wire(
                now, {k: v for k, v in net_rows.items()
                      if k.startswith("osd.")})
            self.perf.set("msgr_resends", sum(
                r["resends"] for r in net_rows.values()))
            self.perf.set("msgr_replays", sum(
                r["replays"] for r in net_rows.values()))
            self.perf.set("msgr_mark_downs", sum(
                r["mark_downs"] for r in net_rows.values()))
            for osd in range(self.osdmap.max_osd):
                if osd == self.whoami or not self.osdmap.is_up(osd):
                    continue
                addr = self.osdmap.osd_addrs.get(osd)
                if not addr:
                    continue
                self.msgr.send_to(addr, MOSDPing(
                    osd=self.whoami, op="ping", stamp=now,
                    epoch=self.osdmap.epoch),
                    entity_hint="osd.%d" % osd)
                last = self.hb_last_rx.get(osd)
                if last is None:
                    self.hb_last_rx[osd] = now
                elif now - last > grace:
                    self._send_mons(MOSDFailure(
                        target=osd, failed_for=now - last,
                        epoch=self.osdmap.epoch))

    # -- periodic scrub (the always-on integrity plane) --------------------

    def _maybe_schedule_scrub(self) -> None:
        """Drive scrubs on this primary's own schedule
        (PG::sched_scrub condensed): the PG most overdue against
        `osd_scrub_interval` / `osd_deep_scrub_interval` scrubs next,
        one at a time per daemon, paced through the mClock K_SCRUB
        class and the device runtime's background digest lanes.  Only
        clean, min_size-satisfied primary PGs are eligible — scrub
        compares copies, and a PG mid-recovery would read absent
        copies as rot."""
        if self._scrub_running or self.stopping or not self.booted:
            return
        conf = self.ctx.conf
        shallow = float(conf.get("osd_scrub_interval", 0) or 0)
        deep_iv = float(conf.get("osd_deep_scrub_interval", 0) or 0)
        if shallow <= 0 and deep_iv <= 0:
            return
        now = time.time()
        best = None             # (overdue-seconds, pg, deep)
        for pg in self.pgs.values():
            if not pg.is_primary() or pg.state != STATE_ACTIVE:
                continue
            if pg.missing or any(pg.peer_missing.get(o)
                                 for o in pg.peer_missing):
                continue
            if getattr(pg, "_scrub_cmd_running", False):
                continue
            pool = self.osdmap.pools.get(pg.pool_id)
            if pool is None or not self._min_size_ok(pg, pool):
                continue
            if deep_iv > 0 \
                    and now - pg.last_deep_scrub_stamp >= deep_iv:
                cand = (now - pg.last_deep_scrub_stamp - deep_iv,
                        pg, True)
            elif shallow > 0 \
                    and now - pg.last_scrub_stamp >= shallow:
                cand = (now - pg.last_scrub_stamp - shallow,
                        pg, False)
            else:
                continue
            if best is None or cand[0] > best[0]:
                best = cand
        if best is None:
            return
        self._scrub_running = True
        self.msgr.spawn(self._periodic_scrub(best[1], best[2]))

    async def _periodic_scrub(self, pg, deep: bool) -> None:
        """One scheduled scrub round.  recheck=True: an inconsistency
        only records if it persists across passes, so a client write
        racing the per-member map builds settles instead of raising
        PG_DAMAGED spuriously.  Failures are logged, never crash
        reports — an interval change or pool delete mid-scrub is
        routine, not a post-mortem."""
        fid = self.progress.start(
            "deep-scrub" if deep else "scrub", str(pg.pgid), total=1)
        try:
            res = await self.scrubber.scrub_pg(pg, deep=deep,
                                               recheck=True)
            if res["errors"]:
                self.ctx.log.info(
                    "osd", "osd.%d periodic %sscrub pg %s: %d "
                    "inconsistencies %s"
                    % (self.whoami, "deep-" if deep else "",
                       pg.pgid, res["errors"],
                       res["inconsistent"][:5]))
        except Exception as e:
            self.ctx.log.info(
                "osd", "osd.%d periodic scrub pg %s aborted: %r"
                % (self.whoami, pg.pgid, e))
        finally:
            self._scrub_running = False
            self.progress.finish(fid)

    def _maybe_send_beacon(self) -> None:
        """MOSDBeacon to the mons: liveness plus the slow-op count
        (in-flight ops past osd_op_complaint_time) and this OSD's
        chip state.  The monitor's HealthMonitor turns a nonzero
        cluster total into SLOW_OPS and clears it when a later beacon
        reports zero; device_lost + device_chip feed the per-chip
        DEVICE_LOST detail (only the OSDs bound to a lost chip
        report it — the rest of the mesh keeps serving on-device)."""
        from ..device.runtime import DeviceRuntime
        from ..msg.messages import MOSDBeacon
        slow = self.optracker.slow_in_flight()
        self.perf.set("slow_ops", len(slow))
        now = time.monotonic()
        if now - self._beacon_stamp < \
                self.ctx.conf["osd_beacon_report_interval"]:
            return
        self._beacon_stamp = now
        if slow:
            oldest = max(op.age for op in slow)
            self.ctx.log.info(
                "osd", "osd.%d has %d slow ops (oldest %.1fs): %s"
                % (self.whoami, len(slow), oldest,
                   slow[0].desc))
        chip = (self.device_chip
                if self.device_chip is not None
                else DeviceRuntime.get(self.device).chip_for(
                    self.whoami))
        self._send_mons(MOSDBeacon(
            osd=self.whoami, epoch=self.osdmap.epoch,
            slow_ops=len(slow),
            # per-tenant slice of the slow count (tenant-less ops
            # fold under "") so the SLOW_OPS health detail can name
            # the worst tenant; legacy mons drop the unknown field
            slow_tenants=self.optracker.slow_tenants(),
            device_lost=int(chip.lost),
            device_chip=chip.index,
            # heartbeat RTT slice (worst peers + slow set) feeding
            # the mon's OSD_SLOW_PING_TIME edge; None until a peer
            # answers a stamped ping, so the beacon stays
            # byte-stable with legacy frames
            net=self.network.beacon_slice()))

    def _obj_logical_size(self, pg: PG, ho, is_ec: bool) -> int:
        """Logical object bytes: an EC shard records the full logical
        size in its SIZE_XATTR; replicated objects report the stored
        size (compression keeps the logical size in its own attr)."""
        if is_ec:
            from .ecbackend import SIZE_XATTR
            try:
                return int(self.store.getattr(pg.cid, ho, SIZE_XATTR))
            except (NotFound, ValueError):
                pass
        try:
            return self._stat_decompressed(pg, ho)
        except NotFound:
            return 0

    def _pg_stat(self, pg: PG) -> dict:
        """One primary PG's stat row (pg_stat_t condensed): object and
        byte counts from the store, degraded / misplaced / unfound
        tallies from the peering state, and the cumulative PGStats
        counters the mgr derives rates from.

        * degraded — object copies below the pool's target redundancy:
          acting-set holes (down members count num_objects whole) plus
          every missing entry on the primary or a live acting member.
        * misplaced — copies that exist safely but sit on the wrong
          OSD: outstanding entries for up-but-not-acting targets (the
          pg_temp-pinned backfill flow a pgp_num change drives).
        * unfound — missing objects no known source can provide."""
        from ..store.objectstore import NOSNAP as _NS
        pool = self.osdmap.pools.get(pg.pool_id)
        is_ec = pool is not None and pool.is_erasure()
        num_objects = 0
        num_bytes = 0
        for h in self.store.collection_list(pg.cid):
            if h.name == "__pgmeta__" or h.snap != _NS:
                continue
            num_objects += 1
            num_bytes += self._obj_logical_size(pg, h, is_ec)
        target = pool.size if pool is not None else len(pg.acting)
        live = [o for o in pg.acting
                if 0 <= o != ITEM_NONE and self.osdmap.is_up(o)]
        # misplaced vs degraded: outstanding copies for an acting
        # member are MISPLACED when a full prior-interval holder is
        # still up outside the acting set (remap/backfill — the data
        # exists, it just sits on the wrong osd); with no live
        # ex-member the redundancy is genuinely reduced -> DEGRADED
        prev_up = [o for o in getattr(pg, "prev_acting", [])
                   if 0 <= o != ITEM_NONE and o not in pg.acting
                   and self.osdmap.is_up(o)]
        missing_copies = len(pg.missing)
        misplaced = 0
        for o, pm in pg.peer_missing.items():
            if o in pg.acting:
                if o in live:
                    if prev_up:
                        misplaced += len(pm)
                    else:
                        missing_copies += len(pm)
            else:
                misplaced += len(pm)
        degraded = (num_objects * max(0, target - len(live))
                    + missing_copies)
        # unfound: a primary-missing object with no live peer claiming
        # a complete copy (conservative but cheap approximation of the
        # reference's might_have_unfound walk)
        unfound = 0
        if pg.missing:
            have_src = any(
                not pg.peer_missing.get(o)
                for o in pg.peer_info
                if o != self.whoami and self.osdmap.is_up(o))
            unfound = 0 if have_src else len(pg.missing)
        from .pg import STATE_INITIAL, STATE_PEERING
        names = {STATE_ACTIVE: "active", STATE_REPLICA: "replica",
                 STATE_PEERING: "peering", STATE_INITIAL: "creating"}
        return {
            "pgid": pg.pgid, "pool": pg.pool_id,
            "state": names.get(pg.state, "unknown"),
            "num_objects": num_objects, "num_bytes": num_bytes,
            "degraded": degraded, "misplaced": misplaced,
            "unfound": unfound,
            "log_size": len(pg.log.entries),
            # integrity plane: the residual inconsistency count and
            # the scrub stamps (pg_stat_t last_scrub_stamp) — the
            # mgr digest folds scrub_errors into OSD_SCRUB_ERRORS /
            # PG_DAMAGED health
            "scrub_errors": getattr(pg, "scrub_errors", 0),
            "last_scrub_stamp": getattr(pg, "last_scrub_stamp", 0.0),
            "last_deep_scrub_stamp": getattr(
                pg, "last_deep_scrub_stamp", 0.0),
            **pg.stats.to_wire(),
        }

    def _maybe_send_mgr_report(self) -> None:
        """MgrClient::send_report: ship perf counters, a PG state
        summary, AND the per-PG stat rows of every PG this osd is
        primary for (the MPGStats slice riding the report — the
        OSD::ms_handle->MgrClient pipeline the mgr folds into its
        PGMap)."""
        addr = getattr(self.osdmap, "mgr_addr", "")
        if not addr:
            return
        now = time.monotonic()
        if now - getattr(self, "_mgr_report_stamp", 0.0) < \
                self.ctx.conf.get("osd_mgr_report_interval", 2.0):
            return
        self._mgr_report_stamp = now
        from ..msg.messages import MMgrReport
        from .pg import STATE_INITIAL, STATE_PEERING
        names = {STATE_ACTIVE: "active", STATE_REPLICA: "replica",
                 STATE_PEERING: "peering", STATE_INITIAL: "creating"}
        states: dict[str, int] = {}
        num_objects = 0
        pg_stats: list[dict] = []
        for pg in self.pgs.values():
            st = names.get(pg.state, "unknown")
            states[st] = states.get(st, 0) + 1
            if pg.is_primary():
                if pg.missing or any(pg.peer_missing.get(o)
                                     for o in pg.peer_missing):
                    states["recovering"] = \
                        states.get("recovering", 0) + 1
                row = self._pg_stat(pg)
                pg_stats.append(row)
                num_objects += row["num_objects"]
        try:
            statfs = self.store.statfs()
        except Exception:
            statfs = None
        # per-chip utilization integrals: this OSD reports ITS
        # affinity chip's windowed busy/queue-wait/idle fractions —
        # the mgr digest folds one row per chip and `status` renders
        # the cluster's device-utilization line from them
        device_util = None
        if self.device_chip is not None:
            try:
                device_util = {"chip": self.device_chip.index,
                               **self.device_chip.utilization()}
            except Exception:
                device_util = None
        # telemetry fabric: ship the stat rows as ONE packed columnar
        # block (parallel typed arrays, pgids/states dictionary-
        # encoded) so the mgr's merge is a vectorized scatter, not a
        # row loop; conf-gated off -> legacy dict rows (mixed fleets
        # converge to the same digest)
        pg_stats_cols = None
        if pg_stats and self.ctx.conf.get("osd_stats_columnar", True):
            from ..msg.statblock import pack_stat_rows
            try:
                pg_stats_cols = pack_stat_rows(pg_stats)
                pg_stats = None
            except Exception:
                pg_stats_cols = None    # odd pgid: keep dict rows
        self.msgr.send_to(addr, MMgrReport(
            daemon="osd.%d" % self.whoami, epoch=self.osdmap.epoch,
            perf=self.ctx.perf.dump(), pg_states=states,
            num_pgs=len(self.pgs), num_objects=num_objects,
            pg_stats=pg_stats, pg_stats_cols=pg_stats_cols,
            osd_stats={"op_size_hist_bytes_pow2":
                       list(self.op_size_hist),
                       # raw-capacity axis for `df` + the exporter
                       "statfs": statfs,
                       # per-chip device utilization (flight-recorder
                       # plane: saturation visible cluster-wide)
                       "device_util": device_util,
                       # repair-traffic plane: per-codec recovery
                       # bytes (read from survivors / moved to
                       # rebuilt shards) — folded into the digest's
                       # repair_traffic section + codec-labeled
                       # exporter families
                       "repair": {c: dict(r) for c, r in
                                  self.ec.repair_traffic.items()},
                       # data-reduction plane: per-base-pool dedup
                       # counters — folded into the digest's
                       # dedup_pools section + pool-labeled exporter
                       # families
                       "dedup": self.dedup.stats_row(),
                       # tenant SLO plane: cumulative per-tenant
                       # stage histograms + good/bad op counters —
                       # the mgr SLO engine's burn-rate input
                       "tenants": {
                           t: {"stages": {s: list(h)
                                          for s, h in
                                          self.tenant_stages.get(
                                              t, {}).items()},
                               **self.tenant_ops.get(
                                   t, {"ops": 0, "errors": 0})}
                           for t in (set(self.tenant_stages)
                                     | set(self.tenant_ops))},
                       # clog emission counters
                       # (ceph_tpu_log_messages_total)
                       "log_messages": self.clog.counts_wire(),
                       # long-flow progress rows (recovery drains,
                       # scrub sweeps) — digest progress section +
                       # progress_start/finish events on the bus
                       "progress": self._progress_rows(),
                       # network plane: per-peer wire counters, wire
                       # rates over the report interval and the RTT
                       # rollup — digest net section, net.* history
                       # series, ceph_tpu_net_* exporter families
                       "net": self._net_stats_row()}),
            entity_hint="mgr")

    def _net_stats_row(self) -> dict:
        """osd_stats["net"]: this daemon's wire/RTT slice for the mgr
        digest.  Rates are computed here, over the report interval —
        the digest is instantaneous soft state and only the producer
        knows its own cadence.  Per-peer detail is cardinality-capped
        at the messenger (worst peers kept, tail folded into
        "other")."""
        now = time.monotonic()
        cap = max(1, int(self.ctx.conf.get("net_peer_max", 32)))
        rows = self.msgr.net_dump(cap=cap)
        tx = sum(r["tx_bytes"] for r in rows.values())
        rx = sum(r["rx_bytes"] for r in rows.values())
        resends = sum(r["resends"] for r in rows.values())
        tx_bps = rx_bps = resend_rate = 0.0
        prev = self._net_prev
        if prev is not None:
            dt = max(now - prev["t"], 1e-6)
            tx_bps = max(0.0, (tx - prev["tx"]) / dt)
            rx_bps = max(0.0, (rx - prev["rx"]) / dt)
            resend_rate = max(0.0, (resends - prev["resends"]) / dt)
        self._net_prev = {"t": now, "tx": tx, "rx": rx,
                          "resends": resends}
        return {
            "tx_bytes": tx, "rx_bytes": rx,
            "tx_Bps": round(tx_bps, 1), "rx_Bps": round(rx_bps, 1),
            "resends": resends,
            "replays": sum(r["replays"] for r in rows.values()),
            "mark_downs": sum(r["mark_downs"]
                              for r in rows.values()),
            "queue_depth": sum(r["queue_depth"]
                               for r in rows.values()),
            "resend_rate": round(resend_rate, 3),
            "peers": rows,
            "rtt": self.network.summary(),
            # per-peer 5s-window RTT (ms): the cluster RTT matrix row
            "rtt_peers": {str(p): round(
                pr.ewma.get("5s", 0.0) * 1000.0, 3)
                for p, pr in sorted(self.network.peers.items())},
        }

    def _handle_ping(self, conn, msg: MOSDPing) -> None:
        if msg.op == "ping":
            conn.send(MOSDPing(osd=self.whoami, op="reply",
                               stamp=msg.stamp,
                               epoch=self.osdmap.epoch
                               if self.osdmap else 0))
        else:
            now = time.monotonic()
            self.hb_last_rx[msg.osd] = now
            # the reply echoes our ping's send stamp: RTT = now -
            # stamp.  Legacy stampless frames echo None — the RTT
            # matrix stays partial instead of the daemon failing
            if msg.stamp is not None:
                try:
                    self.network.note_rtt(
                        msg.osd, now - float(msg.stamp), now)
                except (TypeError, ValueError):
                    pass

    # -- helpers -----------------------------------------------------------

    def _send_osd(self, osd: int, msg) -> None:
        addr = self.osdmap.osd_addrs.get(osd)
        if addr:
            self.msgr.send_to(addr, msg, entity_hint="osd.%d" % osd)


_WRITE_OPS = {"write", "writefull", "delete", "truncate", "setxattr",
              "omap-set", "omap-rm"}
