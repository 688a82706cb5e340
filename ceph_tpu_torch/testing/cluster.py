"""LocalCluster: one-process mon+OSD+client cluster harness.

The shared substrate under tests/test_cluster.py, the thrasher and
``python -m ceph_tpu.cli.vstart`` (the vstart.sh /
qa/standalone/ceph-helpers.sh analog): real daemons, real wire
protocol over loopback TCP, one event loop for determinism.

Fault surface: every daemon's messenger carries a seeded
`FaultInjector` (ceph_tpu.msg.faults) when the cluster is built with
a seed, so partitions and frame faults are scriptable per node and a
failure schedule replays from its seed.
"""

from __future__ import annotations

import asyncio

from ..client import RadosClient
from ..mon import Monitor
from ..msg.faults import FaultInjector
from ..osd.daemon import OSD
from ..utils.backoff import wait_for
from ..utils.context import Context

# dev-cluster pacing: tight heartbeats and auto-out so failure
# handling is observable in seconds, not minutes
FAST_CONF = {
    "heartbeat_interval": 0.1,
    "heartbeat_grace": 0.6,
    "mon_osd_down_out_interval": 1.0,
    "mon_osd_min_down_reporters": 1,
    "osd_pool_default_pg_num": 8,
    # EC sub-reads that race a just-killed member must widen to the
    # survivors in ~1s, not the production 10s — at dev-cluster
    # heartbeat pacing a thrash round would otherwise spend minutes
    # of recovery time burning timeouts
    "osd_ec_subop_timeout": 1.0,
    # publications lost to a partition must be repaired within a
    # thrash round, not the production 10s renewal period
    "mon_subscribe_renew_interval": 2.0,
    # op tracking at dev pacing: an op in flight 5s on a healthy dev
    # cluster is genuinely stuck (production default is 30s), and
    # beacons must carry the slow count to the mon within a round
    "osd_op_complaint_time": 5.0,
    "osd_beacon_report_interval": 0.25,
    "osd_op_history_size": 64,
    # network plane at dev pacing: 40ms heartbeat RTT is slow (an
    # injected net_degrade delay of ~80ms trips it; healthy in-proc
    # pings run far under 1ms), well below the 600ms grace so a slow
    # pair warns long before it is declared dead
    "osd_slow_ping_time_ms": 40.0,
    # stats plane at dev pacing: per-PG stat rows and PGMap digests
    # must cross OSD -> mgr -> mon within a thrash round
    "osd_mgr_report_interval": 0.3,
    "mgr_stats_period": 0.25,
    "mgr_stats_stale_after": 5.0,
    # stale-row compaction (visible prune counters) within a round:
    # rows mask out of the folds at 5s and are reclaimed at 6s
    "mgr_stats_prune_after": 6.0,
    # integrity plane at dev pacing: scrub is ALWAYS ON — every PG
    # shallow-scrubs every few seconds and deep-scrubs (digest vs
    # hinfo vote) soon after, so silent rot surfaces within a thrash
    # round; a straggling scrub replica is given ~1s + one retry
    # before being recorded unavailable
    "osd_scrub_interval": 3.0,
    "osd_deep_scrub_interval": 6.0,
    "osd_scrub_chunk_timeout": 1.0,
    # flight recorder at dev pacing: keep EVERY trace (production
    # samples 1-in-N; harness oracles assert complete span trees for
    # every acked write, so nothing may drop) and a short utilization
    # window so saturation integrals react within a round
    "flight_recorder_sample": 1,
    "device_util_window": 5.0,
    # continuous dispatch at dev pacing: the per-chip stream is the
    # default architecture; a tight admission tick and the production
    # slot geometry so urgent ops never wait a flush window, and the
    # flush-mode tunables pinned so mode-comparison tests are stable
    "device_dispatch_mode": "stream",
    "device_stream_interval_us": 100,
    "device_stream_slot_words": 1 << 19,
    "device_stream_max_slots": 4,
    "ec_batch_flush_us": 300,
    "ec_batch_max_bytes": 8 << 20,
    # tenant SLO plane at dev pacing: burn windows of seconds (not
    # SRE-scale minutes) so a bully round's burn both RAISES and
    # DECAYS within a thrash round, and a small min-ops floor so
    # short bursts still produce verdicts
    "slo_fast_window": 2.0,
    "slo_slow_window": 5.0,
    "slo_min_ops": 10,
    # history plane at dev pacing: a sub-second finest tier so `perf
    # history` rows fill (and mgr-death gaps are visible) within a
    # thrash round — production tiers are 5s/30s/5min
    "history_tiers": "0.5:120,2:120,10:288",
}


def free_ports(n: int) -> list[int]:
    import socket

    socks = []
    for _ in range(n):
        so = socket.socket()
        so.bind(("127.0.0.1", 0))
        socks.append(so)
    ports = [so.getsockname()[1] for so in socks]
    for so in socks:
        so.close()
    return ports


class LocalCluster:
    """n_mons monitors (a real quorum when >1) + n_osds OSDs + one
    RadosClient.  ``seed`` arms deterministic fault injection: each
    daemon gets a FaultInjector seeded from (seed, entity) and the
    client's retry jitter draws from the same stream family."""

    def __init__(self, n_osds: int = 3, n_mons: int = 1,
                 conf: dict | None = None, seed: int | None = None,
                 with_mgr: bool = False,
                 device_chips: int | None = None, device=None):
        from .. import default_device
        self.n_osds = n_osds
        self.n_mons = n_mons
        self.conf = dict(FAST_CONF)
        self.conf.update(conf or {})
        self.seed = seed
        self.with_mgr = with_mgr
        # force the device-mesh size before daemons bind their chips
        # (None keeps the device's mesh: its card count, 1 on the CPU)
        self.device_chips = device_chips
        # every daemon's device (default: the card)
        self.device = default_device(device)
        # pool -> (epoch, host-engine mappings of its PGs): healthy()
        # maps a pool once an epoch, not once a poll
        self._health_rows: dict = {}
        self.mons: list[Monitor] = []
        self.monmap: list[tuple[str, str]] = []
        self.osds: list[OSD | None] = []
        self.mgr = None
        self.client: RadosClient | None = None

    # -- lifecycle ---------------------------------------------------------

    def _install_injector(self, msgr, entity: str) -> FaultInjector:
        if self.seed is None:
            inj = FaultInjector(0)
        else:
            import zlib
            inj = FaultInjector(
                self.seed ^ zlib.crc32(entity.encode()))
        msgr.fault_injector = inj
        return inj

    async def start(self) -> "LocalCluster":
        if self.device_chips is not None:
            from ..device.runtime import DeviceRuntime
            DeviceRuntime.reset(chips=self.device_chips,
                                device=self.device)
        if self.n_mons > 1:
            self.monmap = [("mon.%d" % i, "127.0.0.1:%d" % po)
                           for i, po in
                           enumerate(free_ports(self.n_mons))]
            for name, _a in self.monmap:
                mon = Monitor(Context(name, conf_overrides=self.conf),
                              name=name, monmap=self.monmap)
                self._install_injector(mon.msgr, name)
                await mon.start()
                self.mons.append(mon)
            await self.wait_quorum()
        else:
            mon = Monitor(Context("mon", conf_overrides=self.conf))
            self._install_injector(mon.msgr, "mon.0")
            addr = await mon.start()
            self.mons = [mon]
            self.monmap = [("mon.0", addr)]
        for i in range(self.n_osds):
            await self._start_osd(i)
        for osd in self.osds:
            await osd.wait_for_boot()
        if self.with_mgr:
            from ..mgr import Manager
            self.mgr = Manager(self.mon_addrs,
                               Context("mgr",
                                       conf_overrides=self.conf),
                               device=self.device)
            # the autonomous balancer would move PGs mid-thrash:
            # deterministic harness runs keep it off (enable
            # explicitly in balancer-focused tests)
            self.mgr.balancer_enabled = False
            self._install_injector(self.mgr.msgr, "mgr")
            await self.mgr.start()
        self.client = RadosClient(
            self.mon_addrs, seed=self.seed,
            ctx=Context("client.0", conf_overrides=self.conf))
        self._install_injector(self.client.msgr, "client.0")
        await self.client.connect()
        return self

    async def _start_osd(self, i: int, store=None) -> OSD:
        osd = OSD(i, self.mon_addrs,
                  Context("osd.%d" % i, conf_overrides=self.conf),
                  store=store, device=self.device)
        self._install_injector(osd.msgr, "osd.%d" % i)
        await osd.start()
        if i < len(self.osds):
            self.osds[i] = osd
        else:
            self.osds.append(osd)
        return osd

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.shutdown()
        if self.mgr is not None:
            await self.mgr.shutdown()
        for osd in self.osds:
            if osd is not None and not osd.stopping:
                await osd.shutdown()
        for mon in self.mons:
            await mon.shutdown()

    @property
    def mon_addrs(self) -> list[str]:
        return [a for _n, a in self.monmap]

    @property
    def live_osds(self) -> list[OSD]:
        return [o for o in self.osds
                if o is not None and not o.stopping]

    # -- mon helpers -------------------------------------------------------

    def leader(self) -> Monitor | None:
        for m in self.mons:
            if m.is_leader() and (m.mpaxos is None or m.mpaxos.active):
                return m
        return None

    async def wait_quorum(self, timeout: float = 20.0) -> Monitor:
        await wait_for(lambda: self.leader() is not None, timeout,
                       what="mon quorum")
        return self.leader()

    def injector(self, entity: str) -> FaultInjector:
        """The FaultInjector of a daemon's messenger by entity name
        ("mon.1", "osd.2", "client")."""
        if entity.startswith("mon"):
            rank = int(entity.split(".")[1]) if "." in entity else 0
            return self.mons[rank].msgr.fault_injector
        if entity.startswith("osd"):
            return self.osds[int(entity.split(".")[1])] \
                .msgr.fault_injector
        if entity.startswith("mgr") and self.mgr is not None:
            return self.mgr.msgr.fault_injector
        return self.client.msgr.fault_injector

    def partition_mon(self, rank: int) -> None:
        """Cut mon.<rank> off from every peer (mons, osds, clients):
        a bidirectional network partition enforced by its own
        injector (outbound frames dropped at send, inbound at
        receive, redial handshakes refused)."""
        self.injector("mon.%d" % rank).isolate("mon.%d" % rank)

    def heal_mon(self, rank: int) -> None:
        self.injector("mon.%d" % rank).rejoin("mon.%d" % rank)

    # -- osd helpers -------------------------------------------------------

    async def kill_osd(self, i: int) -> None:
        """Hard-stop osd.i, keeping its store (the "disk")."""
        await self.osds[i].shutdown()

    async def crash_osd(self, i: int,
                        message: str = "injected crash") -> str | None:
        """Crash osd.i on an injected exception: the daemon writes a
        crash report (stack + LogRing tail) into its OWN store, then
        hard-stops — the post-mortem flow the mon's crash table and
        RECENT_CRASH exist for.  Returns the crash_id (the report
        ships on the next boot from the surviving store)."""
        osd = self.osds[i]
        cid = osd.simulate_crash(RuntimeError(message))
        await osd.shutdown()
        return cid

    async def revive_osd(self, i: int, timeout: float = 20.0,
                         wipe: bool = False) -> OSD:
        """Restart osd.i on its surviving store with a fresh
        messenger nonce (the reboot flow peers reset sessions for).
        ``wipe=True`` restarts it on a FRESH store instead (the
        disk-replacement flow): peering sees an empty osd and
        backfill must repopulate every PG it serves."""
        store = None if wipe else self.osds[i].store
        osd = await self._start_osd(i, store=store)
        await osd.wait_for_boot(timeout)
        return osd

    async def wait_osd_down(self, i: int,
                            timeout: float = 30.0) -> None:
        await wait_for(
            lambda: not self.client.osdmap.is_up(i), timeout,
            what="osd.%d down in map" % i)

    async def wait_osd_up(self, i: int, timeout: float = 30.0) -> None:
        await wait_for(lambda: self.client.osdmap.is_up(i), timeout,
                       what="osd.%d up in map" % i)

    async def mark_out(self, i: int) -> None:
        await self.client.mon_command("osd out", id=i)

    async def mark_in(self, i: int) -> None:
        await self.client.mon_command("osd in", id=i)

    # -- mgr helpers -------------------------------------------------------

    async def kill_mgr(self) -> None:
        """Hard-stop the manager: digests stop flowing, the mons'
        staleness clock starts, and history rings record a gap."""
        if self.mgr is not None:
            await self.mgr.shutdown()
            self.mgr = None

    async def revive_mgr(self):
        """Start a FRESH manager (new PGMap, new history rings — the
        mgr is soft state): daemons re-report within an interval and
        digests resume."""
        from ..mgr import Manager
        self.mgr = Manager(self.mon_addrs,
                           Context("mgr", conf_overrides=self.conf),
                           device=self.device)
        self.mgr.balancer_enabled = False
        self._install_injector(self.mgr.msgr, "mgr")
        await self.mgr.start()
        return self.mgr

    # -- pools / health ----------------------------------------------------

    async def create_pool(self, name: str, pg_num: int = 8,
                          size: int | None = None,
                          pool_type: str = "replicated",
                          erasure_code_profile: str | None = None,
                          ) -> int:
        kw = {"pool": name, "pg_num": pg_num}
        if pool_type != "replicated":
            kw["pool_type"] = pool_type
            if erasure_code_profile:
                kw["erasure_code_profile"] = erasure_code_profile
        else:
            kw["size"] = (size if size is not None
                          else min(3, self.n_osds))
        out = await self.client.mon_command("osd pool create", **kw)
        leader = self.leader()
        if leader is not None:
            await self.client.wait_for_epoch(leader.osdmap.epoch)
        return out["pool_id"]

    # -- observability -----------------------------------------------------

    def set_clock_skew(self, entity: str, seconds: float) -> None:
        """Skew one daemon's clock (test hook for the offset
        normalization): both its op-tracker stamps and its outgoing
        frame stamps read monotonic()+seconds, exactly what a
        misaligned host clock would present."""
        if entity.startswith("osd"):
            d = self.osds[int(entity.split(".")[1])]
            d.msgr.clock_skew = seconds
            d.optracker.clock_skew = seconds
        elif entity.startswith("mon"):
            rank = int(entity.split(".")[1]) if "." in entity else 0
            self.mons[rank].msgr.clock_skew = seconds
            self.mons[rank].optracker.clock_skew = seconds
        else:
            self.client.msgr.clock_skew = seconds
            self.client.optracker.clock_skew = seconds

    def clock_offsets(self) -> dict[str, float]:
        """Per-daemon clock offset relative to the CLIENT's clock,
        solved from the per-peer estimates every messenger accumulates
        off frame send stamps (offset underestimates by one-way
        latency; the max over frames converges).  Daemons the client
        never exchanged frames with resolve transitively (replica ->
        primary -> client)."""
        msgrs = {}
        if self.client is not None:
            msgrs[self.client.msgr.entity] = self.client.msgr
        for o in self.live_osds:
            msgrs[o.msgr.entity] = o.msgr
        for m in self.mons:
            msgrs[m.msgr.entity] = m.msgr
        if self.mgr is not None:
            msgrs[self.mgr.msgr.entity] = self.mgr.msgr
        ref = (self.client.msgr.entity if self.client is not None
               else next(iter(msgrs), None))
        offsets: dict[str, float] = {ref: 0.0} if ref else {}
        # fixed-point sweep over both edge directions: m heard from s
        # with estimate (clock_s - clock_m)
        for _ in range(len(msgrs) + 1):
            changed = False
            for ent, msgr in msgrs.items():
                for src, est in msgr.clock_offsets.items():
                    if ent in offsets and src not in offsets \
                            and src in msgrs:
                        offsets[src] = offsets[ent] + est
                        changed = True
                    elif src in offsets and ent not in offsets:
                        offsets[ent] = offsets[src] - est
                        changed = True
            if not changed:
                break
        return offsets

    def op_timeline(self, trace: str) -> list[dict]:
        """Merge every daemon's tracked-op records for one trace id —
        a completed client write yields the full cross-daemon span:
        client submit/send, primary queue/execute/sub-op, replica (or
        EC shard) apply.  Stamps are normalized to the client's clock
        using the per-daemon offsets estimated from message send/recv
        stamps, so stage ordering survives skewed per-daemon clocks
        (the multi-host deployment shape); in-process daemons share
        one clock and normalize by ~0."""
        offsets = self.clock_offsets()
        out: list[dict] = []
        trackers = []
        if self.client is not None:
            trackers.append(self.client.optracker)
        # dead daemons contribute too (their historic rings survive
        # the stop — the diagnostics bundle merges a crashed
        # daemon's slice of the span); offsets default to 0 for
        # daemons no longer exchanging frames
        trackers += [o.optracker for o in self.osds if o is not None]
        trackers += [m.optracker for m in self.mons]
        for tr in trackers:
            for rec in tr.find(trace):
                off = offsets.get(rec.get("daemon"), 0.0)
                if off:
                    rec = dict(rec)
                    rec["initiated"] = rec["initiated"] - off
                    rec["events"] = [
                        {**e, "t": e["t"] - off}
                        for e in rec["events"]]
                    rec["clock_offset"] = off
                out.append(rec)
        return sorted(out, key=lambda d: d["initiated"])

    def export_trace(self, path: str | None = None,
                     traces: list | None = None) -> dict:
        """Merge every daemon's flight-recorder ring (dead daemons
        included — their rings survive the stop) plus the process
        device-ticket ring into ONE Chrome-trace / Perfetto JSON
        document, normalized onto the client's clock via the
        clock-offset solver.  ``traces`` filters op records to those
        trace ids (background + device spans always ride).  ``path``
        additionally writes the document to disk — the artifact you
        drop into https://ui.perfetto.dev."""
        from ..device import mesh
        from ..trace import recorder as flight

        rings: dict[str, list[dict]] = {}

        def take(entity: str, ctx) -> None:
            fr = getattr(ctx, "flight_recorder", None)
            if fr is None:
                return
            recs = [dict(r) for r in fr.records]
            if traces is not None:
                want = set(traces)
                recs = [r for r in recs
                        if r.get("kind") != "op"
                        or r.get("trace") in want]
            rings[entity] = recs

        if self.client is not None:
            take(self.client.msgr.entity, self.client.ctx)
        for osd in self.osds:
            if osd is not None:
                take("osd.%d" % osd.whoami, osd.ctx)
        for m in self.mons:
            take(m.msgr.entity, m.ctx)
        # per-peer wire-throughput counter tracks from the OSDs'
        # heartbeat-paced cumulative samples
        net: dict[str, list[dict]] = {}
        for osd in self.osds:
            if osd is None:
                continue
            ring = getattr(getattr(osd, "network", None),
                           "wire_ring", None)
            if ring:
                net["osd.%d" % osd.whoami] = [dict(r) for r in ring]
        doc = flight.chrome_trace(
            rings, offsets=self.clock_offsets(),
            device=flight.device_records(), net=net,
            meta={"seed": self.seed,
                  "mesh": mesh.describe(self.device)})
        if path:
            import json
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def stuck_ops(self) -> list[dict]:
        """In-flight ops past the complaint threshold on any live
        daemon — the thrasher's slow-op oracle: once the cluster is
        healthy again this must be empty."""
        out: list[dict] = []
        for osd in self.live_osds:
            out.extend(op.dump()
                       for op in osd.optracker.slow_in_flight())
        return out

    def collect_diagnostics(self, traces: list | None = None) -> dict:
        """The one-call diagnostics bundle: per-daemon perf dumps,
        in-flight/historic ops, LogRing tails (INCLUDING dead
        daemons' — the post-mortem context a crash would otherwise
        take with it), mon health/log/crash state, the pgmap digest,
        and merged cross-daemon op timelines — one JSON-able artifact
        to attach to any bug.  ``traces`` picks the op timelines to
        merge; by default the client's most recent historic ops."""
        import time as _t

        from ..utils.crash import pending_crashes, ring_tail

        out: dict = {"generated_at": _t.time(), "seed": self.seed,
                     "daemons": {}, "mons": {}}
        for osd in self.osds:
            if osd is None:
                continue
            name = "osd.%d" % osd.whoami
            d: dict = {"alive": not osd.stopping,
                       "epoch": osd.osdmap.epoch if osd.osdmap else 0,
                       "perf": osd.ctx.perf.dump(),
                       "ops_in_flight":
                           osd.optracker.dump_ops_in_flight(),
                       "historic_slow_ops":
                           osd.optracker.dump_historic_slow_ops(),
                       "ring_tail": ring_tail(osd.ctx.log.ring, 200),
                       "clog_pending": osd.clog.num_pending,
                       "clog_counts": dict(osd.clog.counts),
                       # the network block: per-peer wire telemetry
                       # (WireStats dumps) + heartbeat RTT tracking
                       "net": {
                           "wire": osd.msgr.net_dump(),
                           "rtt": osd.network.dump()}}
            try:
                d["statfs"] = osd.store.statfs()
                d["pending_crash_reports"] = [
                    r.get("crash_id")
                    for r in pending_crashes(osd.store)]
            except Exception:
                pass
            out["daemons"][name] = d
        for m in self.mons:
            health = m.health_mon.command("health", {})
            out["mons"][m.name] = {
                "leader": m.is_leader(),
                "epoch": m.osdmap.epoch,
                "health": health,
                "log_last": m.log_mon.entries[-100:],
                "crashes": [m.crash_mon._summary(r)
                            for r in m.crash_mon.reports.values()],
                "ring_tail": ring_tail(m.ctx.log.ring, 100)}
        if self.mgr is not None:
            out["mgr"] = {
                "daemons_reporting": sorted(
                    self.mgr.daemon_reports),
                "digests_sent": self.mgr.digests_sent,
                "clog_pending": self.mgr.clog.num_pending}
        out["pgmap_digest"] = self.digest()
        out["stuck_ops"] = self.stuck_ops()
        out["clock_offsets"] = self.clock_offsets()
        if self.client is not None:
            out["client"] = {
                "epoch": self.client.osdmap.epoch,
                "ops_in_flight":
                    self.client.optracker.dump_ops_in_flight()}
            if traces is None:
                traces = [r.trace
                          for r in self.client.optracker.historic[-3:]
                          if r.trace]
        out["op_timelines"] = {t: self.op_timeline(t)
                               for t in (traces or [])}
        return out

    async def wait_health(self, pool_id: int,
                          timeout: float = 30.0) -> None:
        """Every PG of the pool active+clean on the current primaries
        (no missing objects anywhere, epochs converged)."""
        await wait_for(lambda: self.healthy(pool_id), timeout,
                       what="pool %d active+clean" % pool_id)

    def healthy(self, pool_id: int) -> bool:
        from ..osd.osdmap import pg_t
        from ..osd.pg import STATE_ACTIVE

        m = None
        for osd in self.live_osds:
            if osd.osdmap is not None:
                if m is None or osd.osdmap.epoch > m.epoch:
                    m = osd.osdmap
        if m is None or pool_id not in m.pools:
            return False
        pool = m.pools[pool_id]
        alive = {o.whoami: o for o in self.live_osds}
        epoch, rows = self._health_rows.get(pool_id, (None, None))
        if epoch != m.epoch:
            rows = [m.pg_to_up_acting_osds(pg_t(pool_id, ps))
                    for ps in range(pool.pg_num)]
            self._health_rows[pool_id] = (m.epoch, rows)
        for ps in range(pool.pg_num):
            up, upp, acting, actingp = rows[ps]
            if actingp < 0 or actingp not in alive:
                return False
            prim = alive[actingp]
            if prim.osdmap is None or prim.osdmap.epoch != m.epoch:
                return False
            pg = prim.pgs.get(pg_t(pool_id, ps))
            if pg is None or pg.state != STATE_ACTIVE:
                return False
            if pg.missing or any(pm for pm in
                                 pg.peer_missing.values()):
                return False
        return True

    # -- integrity plane (scrub oracles) -----------------------------------

    def pg_primary(self, pool_id: int, ps: int):
        """(primary OSD object, its PG object) for one PG on the
        newest map a live daemon holds, or (None, None)."""
        from ..osd.osdmap import pg_t
        m = None
        for osd in self.live_osds:
            if osd.osdmap is not None:
                if m is None or osd.osdmap.epoch > m.epoch:
                    m = osd.osdmap
        if m is None or pool_id not in m.pools:
            return None, None
        _up, _upp, _acting, actingp = m.pg_to_up_acting_osds(
            pg_t(pool_id, ps))
        alive = {o.whoami: o for o in self.live_osds}
        osd = alive.get(actingp)
        if osd is None:
            return None, None
        return osd, osd.pgs.get(pg_t(pool_id, ps))

    async def scrub_pool(self, pool_id: int, deep: bool = True,
                         repair: bool = False,
                         recheck: bool = True) -> dict:
        """Scrub every PG of the pool on its live primary and fold
        the results — the thrasher's repair-to-clean oracle surface.
        recheck=True confirms inconsistencies across passes, so a
        still-running workload's in-flight writes never read as rot.
        """
        m = None
        for osd in self.live_osds:
            if osd.osdmap is not None:
                if m is None or osd.osdmap.epoch > m.epoch:
                    m = osd.osdmap
        out = {"errors": 0, "inconsistent": [], "repaired": 0,
               "unavailable": set()}
        if m is None or pool_id not in m.pools:
            return out
        for ps in range(m.pools[pool_id].pg_num):
            osd, pg = self.pg_primary(pool_id, ps)
            if osd is None or pg is None:
                continue
            res = await osd.scrubber.scrub_pg(
                pg, deep=deep, repair=repair, recheck=recheck)
            out["errors"] += res["errors"]
            out["inconsistent"].extend(res["inconsistent"])
            out["repaired"] += res["repaired"]
            out["unavailable"].update(res.get("unavailable") or ())
        out["unavailable"] = sorted(out["unavailable"])
        return out

    # -- cluster statistics plane (PGMap digest oracles) -------------------

    def digest(self) -> dict | None:
        """The freshest PGMap digest any live mon holds — the
        STATS-PLANE view of the cluster (OSD report -> mgr PGMap ->
        mon digest), deliberately not daemon-internal state, so
        oracles built on it exercise the whole pipeline."""
        best = None
        best_stamp = -1.0
        for m in self.mons:
            d = getattr(m, "mgr_digest", None)
            if d is not None and m.mgr_digest_stamp > best_stamp:
                best, best_stamp = d, m.mgr_digest_stamp
        return best

    def _digest_total(self, key: str):
        d = self.digest()
        if d is None:
            return None
        return (d.get("totals") or {}).get(key)

    def degraded_objects(self):
        """Degraded object-copy count from the digest (None until a
        digest arrives)."""
        v = self._digest_total("degraded")
        return None if v is None else int(v)

    def misplaced_objects(self):
        v = self._digest_total("misplaced")
        return None if v is None else int(v)

    def client_io_rate(self) -> float:
        """Client write+read ops/s from the digest (0.0 pre-digest)."""
        d = self.digest()
        if d is None:
            return 0.0
        t = d.get("totals") or {}
        return (float(t.get("read_ops_s") or 0.0)
                + float(t.get("write_ops_s") or 0.0))

    def recovery_rate(self) -> float:
        """Recovery objects/s from the digest (0.0 pre-digest)."""
        v = self._digest_total("recovery_ops_s")
        return 0.0 if v is None else float(v)

    # -- event bus (committed-stream oracle) -------------------------------

    def event_stream(self, start: int = 0) -> list[dict]:
        """Test oracle for the mon event bus: subscribes the harness
        client's cursor and returns the LIVE list rows append to —
        each committed event exactly once, in seq order, surviving
        mon failover (assert on seq contiguity for gap/dup checks)."""
        rows: list[dict] = []
        self.client.watch_events(rows.append, start=start)
        return rows

    async def wait_stats(self, pred, timeout: float = 30.0,
                         what: str = "stats condition") -> None:
        """Poll the digest until `pred(digest)` holds (pred receives
        the freshest digest, possibly None)."""
        await wait_for(lambda: pred(self.digest()), timeout,
                       what=what)

    async def wait_degraded_drained(
            self, timeout: float = 120.0) -> dict:
        """Stats oracle: wait until the digest reports EXACTLY zero
        degraded + misplaced objects, sampling the recovery rate on
        the way.  Returns {"max_degraded", "max_misplaced",
        "max_recovery_rate", "samples_degraded"} so callers can
        additionally assert the drain showed a live recovery rate."""
        import time as _t
        obs = {"max_degraded": 0, "max_misplaced": 0,
               "max_recovery_rate": 0.0, "samples_degraded": 0}
        deadline = _t.monotonic() + timeout
        while True:
            d = self.digest()
            if d is not None:
                deg = self.degraded_objects() or 0
                mis = self.misplaced_objects() or 0
                obs["max_degraded"] = max(obs["max_degraded"], deg)
                obs["max_misplaced"] = max(obs["max_misplaced"], mis)
                obs["max_recovery_rate"] = max(
                    obs["max_recovery_rate"], self.recovery_rate())
                if deg or mis:
                    obs["samples_degraded"] += 1
                else:
                    return obs      # drained (or never degraded)
            if _t.monotonic() > deadline:
                raise TimeoutError(
                    "degraded/misplaced never drained to zero: %r "
                    "(digest totals %r)"
                    % (obs, (d or {}).get("totals")))
            await asyncio.sleep(0.1)
