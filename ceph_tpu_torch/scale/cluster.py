"""ScaleCluster: a 1k-10k-OSD shell cluster in one process.

The scale-plane sibling of testing.LocalCluster: real monitors (paxos,
subscription fan-out, batched boot proposals), a real manager folding
the shells' synthetic stat rows through the columnar PGMap, one
RadosClient for the command surface — and N `ShellOSD`s instead of
full OSDs, so the cluster under test is the CONTROL PLANE: boot-storm
epoch folding, per-epoch publication cost at thousands of
subscribers, map-epoch convergence after churn, digest fold cost, and
the batched balancer's deviation drain.

Scale knobs live in SCALE_CONF (longer report cadences than the
dev-cluster FAST_CONF, a mon proposal batch window so a boot storm
folds into a handful of epochs, auto-out disabled so churn is
operator-driven and measurable).
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from ..client import RadosClient
from ..mon import Monitor
from ..testing.cluster import free_ports
from ..utils.backoff import wait_for
from ..utils.context import Context
from .shell import MapCache, ShellOSD

SCALE_CONF = {
    # fold boot storms: thousands of MOSDBoots land in a few epochs
    "mon_propose_batch_window": 0.05,
    # host-grouped crush: real failure domains, and every placement
    # draw hashes O(hosts + per-host) items instead of O(osds) — the
    # flat vstart root is quadratic pain at 10k
    "mon_crush_osds_per_host": 20,
    # shells beacon/report at a fleet-friendly cadence
    "shell_report_interval": 0.5,
    "osd_beacon_report_interval": 2.0,
    "mon_subscribe_renew_interval": 15.0,
    # churn is operator-driven in scale runs: auto-out mid-measurement
    # would fold surprise epochs into the convergence figure
    "mon_osd_down_out_interval": 3600.0,
    "mgr_stats_period": 0.5,
    "mgr_stats_stale_after": 10.0,
    "osd_pool_default_pg_num": 128,
}


class ScaleCluster:
    """n_mons monitors + one mgr + n_shells ShellOSDs + a command
    client.  `boot_batch` bounds how many shells start concurrently
    (binding thousands of listeners at once starves the loop).
    `device` is where the shells' shared bulk mapping and the mgr's
    balancer run (default: the card); `device_chips` forces the
    runtime's logical mesh size, as LocalCluster's does."""

    def __init__(self, n_shells: int, n_mons: int = 1,
                 conf: dict | None = None, with_mgr: bool = True,
                 boot_batch: int = 256, device=None,
                 device_chips: int | None = None):
        from .. import default_device
        self.device = default_device(device)
        self.device_chips = device_chips
        self.n_shells = n_shells
        self.n_mons = n_mons
        self.conf = dict(SCALE_CONF)
        # report cadence scales with the fleet: everything shares ONE
        # event loop here, and 10k shells at the 300-shell cadence
        # would saturate it with report traffic (a real fleet spreads
        # this over hosts); staleness tracks the cadence so rows
        # never age out between reports
        interval = (0.5 if n_shells <= 500
                    else 2.0 if n_shells <= 2500 else 5.0)
        self.conf["shell_report_interval"] = interval
        self.conf["mgr_stats_stale_after"] = max(10.0, 5 * interval)
        # small fleets still need >= ~5 failure domains for a size-3
        # pool to place
        if n_shells < 100:
            self.conf["mon_crush_osds_per_host"] = max(
                2, n_shells // 5)
        self.conf.update(conf or {})
        self.with_mgr = with_mgr
        self.boot_batch = boot_batch
        self.mons: list[Monitor] = []
        self.monmap: list[tuple[str, str]] = []
        self.shells: list[ShellOSD | None] = []
        self.mapcache = MapCache(device=self.device)
        self.mgr = None
        self.client: RadosClient | None = None
        self.boot_seconds = 0.0

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "ScaleCluster":
        t0 = time.monotonic()
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
                await mon.start()
                self.mons.append(mon)
            await self.wait_quorum()
        else:
            mon = Monitor(Context("mon", conf_overrides=self.conf))
            addr = await mon.start()
            self.mons = [mon]
            self.monmap = [("mon.0", addr)]
        if self.with_mgr:
            from ..mgr import Manager
            self.mgr = Manager(self.mon_addrs,
                               Context("mgr",
                                       conf_overrides=self.conf),
                               device=self.device)
            self.mgr.balancer_enabled = False
            await self.mgr.start()
        self.client = RadosClient(
            self.mon_addrs,
            ctx=Context("client.0", conf_overrides=self.conf))
        await self.client.connect()
        await self.add_shells(self.n_shells)
        self.boot_seconds = time.monotonic() - t0
        return self

    async def add_shells(self, n: int,
                         timeout: float = 300.0) -> list[ShellOSD]:
        """Boot `n` more shells (initial fleet or the add-a-host churn
        leg) in bounded batches; returns once every one is up in the
        map."""
        base = len(self.shells)
        fresh: list[ShellOSD] = []
        for i in range(base, base + n):
            sh = ShellOSD(i, self.mon_addrs,
                          Context("osd.%d" % i,
                                  conf_overrides=self.conf),
                          mapcache=self.mapcache)
            self.shells.append(sh)
            fresh.append(sh)
        for i in range(0, len(fresh), self.boot_batch):
            await asyncio.gather(*[
                sh.start() for sh in fresh[i:i + self.boot_batch]])
        deadline = time.monotonic() + timeout
        for sh in fresh:
            await sh.wait_for_boot(
                max(1.0, deadline - time.monotonic()))
        return fresh

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.shutdown()
        if self.mgr is not None:
            await self.mgr.shutdown()
        # shells shut down in parallel batches (serial teardown of
        # thousands of messengers dominates the harness otherwise)
        live = [s for s in self.shells
                if s is not None and not s.stopping]
        for i in range(0, len(live), self.boot_batch):
            await asyncio.gather(*[
                s.shutdown() for s in live[i:i + self.boot_batch]])
        for mon in self.mons:
            await mon.shutdown()

    @property
    def mon_addrs(self) -> list[str]:
        return [a for _n, a in self.monmap]

    @property
    def live_shells(self) -> list[ShellOSD]:
        return [s for s in self.shells
                if s is not None and not s.stopping]

    def leader(self) -> Monitor | None:
        for m in self.mons:
            if m.is_leader() and (m.mpaxos is None
                                  or m.mpaxos.active):
                return m
        return None

    async def wait_quorum(self, timeout: float = 20.0) -> Monitor:
        await wait_for(lambda: self.leader() is not None, timeout,
                       what="mon quorum")
        return self.leader()

    # -- control-plane measurements ----------------------------------------

    async def wait_epoch_converged(self, epoch: int,
                                   timeout: float = 120.0) -> float:
        """Seconds until EVERY live shell reaches `epoch` (map-epoch
        convergence — the publication fan-out figure)."""
        t0 = time.monotonic()

        def converged() -> bool:
            return all(s.osdmap.epoch >= epoch
                       for s in self.live_shells)

        await wait_for(converged, timeout,
                       what="epoch %d on every shell" % epoch)
        return time.monotonic() - t0

    def placement_counts(self) -> np.ndarray:
        """Per-OSD up-placement counts at the leader's epoch (from
        the shared bulk mapping — the balancer stddev source)."""
        m = self.leader().osdmap
        counts = np.zeros(max(1, m.max_osd), np.int64)
        for _osd, pgs in self.mapcache.primaries_for(m).items():
            for _pool, _ps, up in pgs:
                for o in up:
                    if 0 <= o < counts.size:
                        counts[o] += 1
        return counts

    def placement_stddev(self) -> float:
        m = self.leader().osdmap
        counts = self.placement_counts()
        inn = [o for o in range(m.max_osd)
               if m.is_up(o) and m.is_in(o)]
        if not inn:
            return 0.0
        c = counts[inn].astype(np.float64)
        return float(np.sqrt(np.mean((c - c.mean()) ** 2)))

    # -- stats-plane views (digest oracles, LocalCluster's shape) ----------

    def digest(self) -> dict | None:
        best, best_stamp = None, -1.0
        for m in self.mons:
            d = getattr(m, "mgr_digest", None)
            if d is not None and m.mgr_digest_stamp > best_stamp:
                best, best_stamp = d, m.mgr_digest_stamp
        return best

    def misplaced_objects(self):
        d = self.digest()
        if d is None:
            return None
        return int((d.get("totals") or {}).get("misplaced") or 0)

    def degraded_objects(self):
        d = self.digest()
        if d is None:
            return None
        return int((d.get("totals") or {}).get("degraded") or 0)

    async def wait_misplaced_drained(self, timeout: float = 180.0,
                                     settle: float = 0.0) -> dict:
        """Misplaced-fraction drain oracle: wait for a nonzero
        misplaced count to appear (the churn landed in the stats
        plane), then for it to drain to exactly zero.  Returns
        {"max_misplaced", "drain_seconds", "max_recovery_rate"}."""
        obs = {"max_misplaced": 0, "drain_seconds": 0.0,
               "max_recovery_rate": 0.0}
        t0 = time.monotonic()
        deadline = t0 + timeout
        seen = False
        while True:
            d = self.digest()
            if d is not None:
                totals = d.get("totals") or {}
                mis = int(totals.get("misplaced") or 0)
                obs["max_misplaced"] = max(obs["max_misplaced"], mis)
                obs["max_recovery_rate"] = max(
                    obs["max_recovery_rate"],
                    float(totals.get("recovery_ops_s") or 0.0))
                if mis:
                    seen = True
                elif seen:
                    obs["drain_seconds"] = time.monotonic() - t0
                    return obs
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "misplaced never %s: %r"
                    % ("drained" if seen else "appeared", obs))
            await asyncio.sleep(settle or 0.1)

    # -- churn -------------------------------------------------------------

    async def mon_cmd(self, prefix: str, timeout: float = 60.0,
                      **args) -> dict:
        """Command channel robust to a congested loop: the mgr's
        single-future mon_command waits the FULL window (the client's
        hunting ramp caps per-attempt waits at ~2s, which a 10k-shell
        report storm can exceed)."""
        if self.mgr is not None:
            return await self.mgr.mon_command(prefix,
                                              timeout=timeout, **args)
        return await self.client.mon_command(prefix, timeout=timeout,
                                             **args)

    async def create_pool(self, name: str, pg_num: int,
                          size: int = 3) -> int:
        out = await self.mon_cmd("osd pool create", pool=name,
                                 pg_num=pg_num, size=size)
        leader = self.leader()
        if leader is not None:
            await self.client.wait_for_epoch(leader.osdmap.epoch,
                                             timeout=60.0)
        return out["pool_id"]

    async def mark_out_fraction(self, frac: float) -> list[int]:
        """Mark out `frac` of the fleet, evenly spread (the 1% churn
        leg).  Data stays (shells keep serving) — placement moves, so
        the misplaced drain starts."""
        n = max(1, int(len(self.shells) * frac))
        step = max(1, len(self.shells) // n)
        victims = list(range(0, len(self.shells), step))[:n]
        for osd in victims:
            await self.mon_cmd("osd out", id=osd)
        return victims
