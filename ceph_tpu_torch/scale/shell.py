"""Shell OSDs: control-plane-only daemons for 1k-10k-OSD clusters.

A `ShellOSD` speaks exactly the map/boot/beacon/stats slice of the OSD
protocol over a real messenger — MMonSubscribe + MOSDBoot through the
monitor's paxos path, MOSDMapMsg consumption (full map + contiguous
incrementals), MOSDBeacon liveness, and MMgrReports carrying synthetic
per-PG stat rows for every PG it is primary of — and NOTHING else: no
object data, no stores, no peering, no recovery I/O, no peer
heartbeats.  One process can therefore boot thousands of them and
drive topology churn through the real mon/subscription fan-out, which
is the thing the scale plane exists to measure (the data plane's bulk
mapper already places 10M PGs in 0.34 s; the control plane holding 10k
subscribers is the open question).

Two costs are deliberately shared process-wide through `MapCache`
rather than paid per shell, because they are host-side decode work a
real fleet pays on separate machines, not protocol behavior:

* map decoding — the wire traffic is real (every shell receives its
  own publication frames), but the canonical OSDMap snapshot per epoch
  is decoded once and shared read-only;
* bulk PG mapping — which PGs each OSD is primary of is computed once
  per epoch through the device bulk mapper (parallel.mapping) and
  grouped by primary, exactly the shared OSDMapMapping the reference
  mgr maintains.  The pass runs on `MapCache`'s device (default: the
  card) in an executor thread; a busy or lost chip keeps the previous
  grouping until a later epoch maps, and any other failure reaches the
  callers.

Synthetic data model (drives the stats plane end-to-end): each primary
PG reports `shell_objects_per_pg` objects.  A placement change marks
the moved slots' objects MISPLACED (data exists, wrong OSD — the
mark-out/backfill shape) and a simulated backfill drains them at
`shell_recovery_objects_per_s`, bumping the cumulative recovery
counters so the mgr's rate derivation shows a live recovery rate; up
rows shorter than the pool size report the hole's objects DEGRADED
(the mark-down shape).  The rows flow OSD -> mgr PGMap -> mon digest
through the production pipeline, so `status`, `df` and the
PG_DEGRADED / misplaced-drain oracles exercise the same code paths a
full cluster does.
"""

from __future__ import annotations

import asyncio
import time

from ..msg import Messenger
from ..msg.messages import (MConfig, MMgrReport, MMonSubscribe,
                            MOSDBeacon, MOSDBoot, MOSDMapMsg)
from ..osd.osdmap import Incremental, OSDMap
from ..utils.context import Context


class MapCache:
    """Process-wide decode-once OSDMap chain + shared primary-PG
    grouping (the ParallelPGMapper/OSDMapMapping role for a shell
    fleet).  Shells treat returned snapshots as IMMUTABLE — the cache
    never applies an incremental to a shared map, it builds the next
    epoch on a private decode-copy and shares that.  `device` is where
    each epoch maps (default: the card)."""

    _KEEP = 32          # canonical epochs retained

    def __init__(self, device=None):
        from .. import default_device
        self.device = default_device(device)
        self.maps: dict[int, OSDMap] = {}
        self._incs: dict[bytes, Incremental] = {}
        self._primaries: tuple[int, dict] | None = None
        # map epoch -> epoch of the last crush change it reflects:
        # snapshots with the same crush epoch share ONE DeviceMapper
        # (re-flattening + re-JITting the bulk-mapping program per
        # weight-only churn epoch is a 20s+ synchronous stall at 1k)
        self._crush_epochs: dict[int, int] = {}
        self._shared_dmapper = None
        self._shared_dm_crush = -1
        self._build_fut = None      # single-flight rebuild handle
        self.full_decodes = 0
        self.inc_decodes = 0
        self.builds = 0             # epochs grouped through the device
        self.host_builds = 0        # maps outside the device's scope
        # rebuilds refused by a busy or lost chip: the previous
        # grouping stays (one epoch stale) until a later call maps
        self.deferred_builds = 0
        self._deferred_fut = None   # the rebuild last counted there

    def _remember(self, m: OSDMap) -> OSDMap:
        got = self.maps.setdefault(m.epoch, m)
        if len(self.maps) > self._KEEP:
            for e in sorted(self.maps)[:-self._KEEP]:
                del self.maps[e]
        return got

    def _decode_inc(self, raw: bytes) -> Incremental:
        inc = self._incs.get(raw)
        if inc is None:
            inc = Incremental.decode(raw)
            self.inc_decodes += 1
            self._incs[raw] = inc
            if len(self._incs) > 256:
                for k in list(self._incs)[:128]:
                    del self._incs[k]
        return inc

    def advance(self, cur: OSDMap, full: bytes | None,
                incrementals: list | None) -> OSDMap:
        """One shell's MOSDMapMsg payload -> the furthest shared
        snapshot reachable from `cur` (full map, then contiguous
        incrementals — the OSD::handle_osd_map shape)."""
        m = cur
        if full is not None:
            f = OSDMap.decode(full)
            self.full_decodes += 1
            if f.epoch > m.epoch:
                m = self._remember(f)
        for raw in incrementals or []:
            nxt = self.maps.get(m.epoch + 1)
            if nxt is not None:
                # chain already built by another shell: skip decode
                m = nxt
                continue
            inc = self._decode_inc(raw)
            if inc.epoch != m.epoch + 1:
                continue
            base = OSDMap.decode(m.encode())    # private copy
            base.apply_incremental(inc)
            if inc.new_crush is None:
                base._mapper = m._mapper
                self._crush_epochs[base.epoch] = \
                    self._crush_epochs.get(m.epoch, m.epoch)
            else:
                self._crush_epochs[base.epoch] = base.epoch
            m = self._remember(base)
        return m

    def _crush_epoch(self, m: OSDMap) -> int:
        # unknown lineage (full-map jump) reads as its own epoch —
        # i.e. conservatively "crush changed here"
        return self._crush_epochs.get(m.epoch, m.epoch)

    async def primaries_async(self, m: OSDMap) -> dict[int, list]:
        """The shells' entry point: the freshest available grouping,
        with at most ONE rebuild in flight process-wide, run in an
        executor thread so a multi-second bulk-mapping pass never
        stalls the event loop the whole fleet shares.  May return a
        one-epoch-stale grouping while a rebuild runs — the synthetic
        model catches up on the next tick.  A busy or lost chip keeps
        the previous grouping (counted in `deferred_builds`); any other
        failure of the rebuild is raised to every caller awaiting it."""
        import asyncio

        from ..device.runtime import DeviceBusy, DeviceLost, DeviceRuntime

        cur = self._primaries
        if cur is not None and cur[0] >= m.epoch:
            return cur[1]
        if self._build_fut is None:
            # the loop's runtime: the pass is admitted on the same
            # chips (and sees the same losses) as the loop's own work
            rt = DeviceRuntime.get(self.device)
            loop = asyncio.get_running_loop()
            fut = loop.run_in_executor(
                None, lambda: self.primaries_for(m, runtime=rt))
            self._build_fut = fut
            fut.add_done_callback(
                lambda _f: setattr(self, "_build_fut", None))
        fut = self._build_fut
        try:
            await asyncio.shield(fut)
        except (DeviceBusy, DeviceLost):
            # counted once a failed rebuild, however many callers wait
            if self._deferred_fut is not fut:
                self._deferred_fut = fut
                self.deferred_builds += 1
        cur = self._primaries
        return cur[1] if cur is not None else {}

    def primaries_for(self, m: OSDMap,
                      runtime=None) -> dict[int, list]:
        """osd -> [(pool_id, ps, up_tuple), ...] for every PG of every
        pool, computed once per epoch through the bulk mapper on
        `runtime` (default: the device's).  A map outside the mapper's
        scope takes the host engine; DeviceBusy, DeviceLost and every
        other failure propagate."""
        if self._primaries is not None \
                and self._primaries[0] == m.epoch:
            return self._primaries[1]
        from ..ops.crush.device import OutOfDeviceScope
        from ..parallel.mapping import OSDMapMapping

        # same-crush snapshots share one DeviceMapper: the flattened
        # tables are a function of the crush map only (weights/states
        # are call inputs)
        ce = self._crush_epoch(m)
        if m._dmapper is None and self._shared_dm_crush == ce:
            m._dmapper = self._shared_dmapper
        try:
            mapping = OSDMapMapping(m, runtime=runtime,
                                    device=self.device)
        except OutOfDeviceScope:
            out = self._host_grouping(m)
            self.host_builds += 1
        else:
            if m._dmapper is not None:
                self._shared_dmapper = m._dmapper
                self._shared_dm_crush = ce
            out = self._grouping(mapping)
            self.builds += 1
        self._primaries = (m.epoch, out)
        return out

    @staticmethod
    def _grouping(mapping) -> dict[int, list]:
        import numpy as np

        out: dict[int, list] = {}
        from ..models.crushmap import ITEM_NONE
        for pool_id, pm in mapping.pools.items():
            prim = np.asarray(pm.up_primary)
            up = np.asarray(pm.up)
            order = np.argsort(prim, kind="stable")
            for ps in order.tolist():
                p = int(prim[ps])
                if p < 0:
                    continue
                row = tuple(int(o) for o in up[ps]
                            if o != ITEM_NONE)
                out.setdefault(p, []).append((pool_id, ps, row))
        return out

    @staticmethod
    def _host_grouping(m: OSDMap) -> dict[int, list]:
        """The same grouping through the exact host engine, for a map
        the bulk mapper does not cover (as the OSD's map handler)."""
        from ..models.crushmap import ITEM_NONE
        from ..osd.osdmap import pg_t
        out: dict[int, list] = {}
        for pool_id in sorted(m.pools):
            for ps in range(m.pools[pool_id].pg_num):
                up, p, _acting, _ap = m.pg_to_up_acting_osds(
                    pg_t(pool_id, ps))
                if p < 0:
                    continue
                row = tuple(int(o) for o in up if o != ITEM_NONE)
                out.setdefault(p, []).append((pool_id, ps, row))
        return out


class ShellOSD:
    """One lightweight OSD shell (see module docstring)."""

    def __init__(self, whoami: int, mon_addr,
                 ctx: Context | None = None,
                 mapcache: MapCache | None = None):
        self.whoami = whoami
        self.mon_addrs = ([mon_addr] if isinstance(mon_addr, str)
                          else list(mon_addr))
        self.ctx = ctx or Context("osd.%d" % whoami)
        from ..msg.auth import AuthContext
        self.msgr = Messenger(
            "osd.%d" % whoami,
            auth=AuthContext.from_conf(self.ctx.conf))
        self.msgr.add_dispatcher(self)
        self.mapcache = mapcache or MapCache()
        self.osdmap: OSDMap = OSDMap()
        self.booted = False
        self.stopping = False
        self._boot_sent_epoch = -1
        # epoch -> monotonic stamp when this shell reached it (the
        # bench's map-epoch convergence raw data; bounded ring)
        self.epoch_times: dict[int, float] = {}
        self.objects_per_pg = int(
            self.ctx.conf.get("shell_objects_per_pg", 8))
        self.object_bytes = int(
            self.ctx.conf.get("shell_object_bytes", 1 << 20))
        self.recovery_rate = float(
            self.ctx.conf.get("shell_recovery_objects_per_s", 256.0))
        # (pool, ps) -> synthetic model row:
        #   placed: up set the data currently "lives" on
        #   up: current up row; misplaced: objects still to backfill
        self.pg_model: dict[tuple, dict] = {}
        self._recovered_ops = 0     # cumulative (rate counter source)
        self._tasks: list = []

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> str:
        addr = await self.msgr.bind(host, port)
        mon = self.msgr.connect_to(self.mon_addr,
                                   entity_hint="mon.0")
        mon.send(MMonSubscribe(start=1))
        self._tasks.append(self.msgr.spawn(self._watchdog()))
        self._tasks.append(self.msgr.spawn(self._report_loop()))
        return addr

    async def shutdown(self) -> None:
        self.stopping = True
        await self.msgr.shutdown()

    async def wait_for_boot(self, timeout: float = 30.0) -> None:
        from ..utils.backoff import wait_for
        await wait_for(lambda: self.booted, timeout,
                       what="shell osd.%d boot" % self.whoami)

    @property
    def mon_addr(self) -> str:
        return self.mon_addrs[self.whoami % len(self.mon_addrs)]

    def _send_mons(self, msg) -> None:
        for i, addr in enumerate(self.mon_addrs):
            self.msgr.send_to(addr, msg, entity_hint="mon.%d" % i)

    # -- dispatch (the whole protocol a shell speaks) ----------------------

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MOSDMapMsg):
            self._handle_osd_map(msg)
            return True
        if isinstance(msg, MConfig):
            self.ctx.conf.apply_mon_values(msg.values or {})
            return True
        return False

    def ms_handle_reset(self, conn) -> None:
        if conn.peer_addr in self.mon_addrs and not self.stopping:
            self.msgr.send_to(
                self.mon_addr,
                MMonSubscribe(start=self.osdmap.epoch + 1),
                entity_hint="mon.0")

    def _handle_osd_map(self, msg: MOSDMapMsg) -> None:
        m = self.mapcache.advance(self.osdmap, msg.full,
                                  msg.incrementals)
        if m.epoch > self.osdmap.epoch:
            self.osdmap = m
            self.epoch_times[m.epoch] = time.monotonic()
            if len(self.epoch_times) > 64:
                for e in sorted(self.epoch_times)[:-64]:
                    del self.epoch_times[e]
        up_here = (self.osdmap.is_up(self.whoami)
                   and self.osdmap.osd_addrs.get(self.whoami)
                   == self.msgr.addr)
        if not self.booted:
            if up_here:
                self.booted = True
            else:
                self._send_boot()
        elif not up_here:
            # marked down but alive: protest by re-booting (the OSD
            # "wrongly marked me down" flow — churn's map traffic)
            self.booted = False
            self._boot_sent_epoch = -1
            self._send_boot()

    def _send_boot(self) -> None:
        epoch = self.osdmap.epoch
        if 0 <= self._boot_sent_epoch and epoch <= self._boot_sent_epoch:
            return
        self._boot_sent_epoch = epoch
        self._send_mons(MOSDBoot(osd=self.whoami,
                                 addr=self.msgr.addr, epoch=epoch))

    async def _watchdog(self) -> None:
        """Boot retry ramp + periodic subscription renewal (the OSD
        _mon_watchdog condensed: publication is fire-and-forget, so a
        lost epoch must be repaired by renewal)."""
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

    # -- synthetic PG model ------------------------------------------------

    async def _update_model(self) -> None:
        grouping = await self.mapcache.primaries_async(self.osdmap)
        mine = grouping.get(self.whoami, [])
        new: dict[tuple, dict] = {}
        for pool_id, ps, up in mine:
            key = (pool_id, ps)
            row = self.pg_model.get(key)
            if row is None:
                # newly created (or newly adopted) PG: data born in
                # place — a fresh pool starts clean, an adopted
                # primary inherits the previous primary's placement
                # view conservatively as clean
                row = {"placed": up, "up": up, "misplaced": 0}
            elif up != row["up"]:
                moved = len(set(up) - set(row["placed"]))
                row["misplaced"] = self.objects_per_pg * moved
                row["up"] = up
                if not moved:
                    row["placed"] = up
            new[key] = row
        self.pg_model = new

    def _drain(self, dt: float) -> None:
        """Simulated backfill: drain misplaced objects at the
        configured rate (cluster-wide per shell), oldest PGs first,
        bumping the cumulative recovery counters the mgr derives
        rates from."""
        budget = int(self.recovery_rate * dt)
        if budget <= 0:
            return
        for row in self.pg_model.values():
            if budget <= 0:
                break
            if row["misplaced"] > 0:
                n = min(budget, row["misplaced"])
                row["misplaced"] -= n
                budget -= n
                self._recovered_ops += n
                if row["misplaced"] == 0:
                    row["placed"] = row["up"]

    def _pg_rows(self) -> list[dict]:
        rows = []
        pools = self.osdmap.pools
        for (pool_id, ps), row in self.pg_model.items():
            pool = pools.get(pool_id)
            size = pool.size if pool is not None else len(row["up"])
            degraded = self.objects_per_pg * max(
                0, size - len(row["up"]))
            rows.append({
                "pgid": "%d.%x" % (pool_id, ps),
                "pool": pool_id,
                "state": "active",
                "num_objects": self.objects_per_pg,
                "num_bytes": self.objects_per_pg * self.object_bytes,
                "degraded": degraded,
                "misplaced": row["misplaced"],
                "unfound": 0, "log_size": 0,
                "read_ops": 0, "read_bytes": 0,
                "write_ops": 0, "write_bytes": 0,
                "recovery_ops": self._recovered_ops,
                "recovery_bytes":
                    self._recovered_ops * self.object_bytes,
            })
        return rows

    # -- beacons + stats reports -------------------------------------------

    async def _report_loop(self) -> None:
        interval = float(self.ctx.conf.get("shell_report_interval",
                                           1.0))
        # de-synchronize the fleet: a fixed phase per shell, not a
        # thundering herd at t=0 (the reference jitters report timers)
        await asyncio.sleep(interval * (self.whoami % 64) / 64.0)
        last = time.monotonic()
        while not self.stopping:
            await asyncio.sleep(interval)
            if not self.booted:
                continue
            now = time.monotonic()
            await self._update_model()
            self._send_mons(MOSDBeacon(
                osd=self.whoami, epoch=self.osdmap.epoch,
                slow_ops=0, device_lost=0, device_chip=0))
            addr = getattr(self.osdmap, "mgr_addr", "")
            if addr:
                states = {"active": len(self.pg_model)}
                # telemetry fabric: a 10k-shell fleet's reports are
                # the mgr's hot path — ship packed columnar blocks
                # (vectorized mgr merge) unless conf-gated back to
                # legacy dict rows (mixed-fleet compat)
                pg_stats = self._pg_rows() or None
                pg_stats_cols = None
                if pg_stats and self.ctx.conf.get(
                        "osd_stats_columnar", True):
                    from ..msg.statblock import pack_stat_rows
                    try:
                        pg_stats_cols = pack_stat_rows(pg_stats)
                        pg_stats = None
                    except Exception:
                        pg_stats_cols = None  # odd pgid: keep rows
                self.msgr.send_to(addr, MMgrReport(
                    daemon="osd.%d" % self.whoami,
                    epoch=self.osdmap.epoch,
                    perf={}, pg_states=states,
                    num_pgs=len(self.pg_model),
                    num_objects=(len(self.pg_model)
                                 * self.objects_per_pg),
                    pg_stats=pg_stats,
                    pg_stats_cols=pg_stats_cols,
                    osd_stats=None), entity_hint="mgr")
            # drain AFTER reporting: a churn's misplaced rise must be
            # observable in at least one report before the simulated
            # backfill eats it (the stats plane is the oracle surface)
            self._drain(now - last)
            last = now
