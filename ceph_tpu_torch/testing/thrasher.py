"""ClusterThrasher: seeded failure schedules against a LocalCluster.

The teuthology ``Thrasher`` (qa/tasks/ceph_manager.py) analog: drive
a live cluster through OSD kills/revives, out/in weight churn,
monitor partitions and map churn while a client `Workload` keeps
writing — and assert, after every round, the invariants a storage
system exists to keep:

* no acknowledged write is ever lost (every acked object reads back
  byte-identical);
* PGs reconverge to active+clean;
* the monitors re-form quorum.

Determinism: the entire action plan (which fault, which victim, how
long to hold it) is derived up front from ``random.Random(seed)``, so
a failing run is reproduced by re-running with the seed it printed.
``ClusterThrasher(cluster, seed=S).plan`` is a pure function of
(seed, rounds, actions, cluster shape).
"""

from __future__ import annotations

import asyncio
import random
import time


class Workload:
    """Continuous client writes with acked-write tracking.

    Only writes whose ``write_full`` completed are recorded in
    ``acked`` — an in-flight write lost to a fault is not a violation
    (the client never saw the ack), a recorded one is."""

    def __init__(self, io, seed: int = 0, prefix: str = "thrash",
                 pace: float = 0.02):
        self.io = io
        self.prefix = prefix
        self.pace = pace
        self.rng = random.Random(seed)
        self.acked: dict[str, bytes] = {}
        self.write_failures: list[tuple[str, str]] = []
        self._seq = 0
        self._stop = False
        self._task: asyncio.Task | None = None

    def _payload(self, seq: int) -> bytes:
        # content derives from the seeded rng in sequence order, so a
        # replay writes identical bytes
        rep = self.rng.randrange(8, 64)
        return (b"%s|%d|" % (self.prefix.encode(), seq)) * rep

    async def write_one(self, timeout: float = 30.0) -> str | None:
        oid = "%s-%d" % (self.prefix, self._seq)
        data = self._payload(self._seq)
        self._seq += 1
        try:
            await asyncio.wait_for(self.io.write_full(oid, data),
                                   timeout)
        except Exception as e:            # unacked: not a loss
            self.write_failures.append((oid, repr(e)))
            return None
        self.acked[oid] = data
        return oid

    async def _run(self) -> None:
        while not self._stop:
            await self.write_one()
            await asyncio.sleep(self.pace)

    def start(self) -> "Workload":
        self._task = asyncio.ensure_future(self._run())
        return self

    async def stop(self) -> None:
        self._stop = True
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, 35.0)
            except asyncio.TimeoutError:
                self._task.cancel()
            self._task = None

    async def verify(self, sample: int | None = None) -> None:
        """Acknowledged writes read back byte-identical.  With
        ``sample``, checks a seeded random subset plus the newest 50
        (mid-thrash checks stay O(sample) while the acked set grows);
        without it, every acked write is read back."""
        items = list(self.acked.items())
        if sample is not None and len(items) > sample:
            # independent picker: must not consume self.rng (the
            # writer derives payload content from it in seq order)
            # (a str seed: Random() takes no tuple since Python 3.11)
            picker = random.Random("%d/%d" % (len(items), sample))
            chosen = picker.sample(items[:-50], sample - 50) \
                + items[-50:]
        else:
            chosen = items
        for oid, data in chosen:
            got = await asyncio.wait_for(self.io.read(oid), 30.0)
            assert got == data, \
                "acked write %s lost/corrupt (%d bytes -> %r...)" % (
                    oid, len(data), bytes(got[:32]))


class ClusterThrasher:
    """Seeded rounds of cluster abuse with invariant checks.

    actions: the action pool the plan draws from —
      kill_revive      — hard-stop an OSD, write through the hole,
                         revive it on the same store;
      kill_wipe_revive — hard-stop an OSD and revive it on a FRESH
                         (wiped) store: the disk-replacement flow —
                         backfill must repopulate it from scratch
                         while every acked write stays readable;
      out_in           — weight an OSD out (forcing remap + recovery)
                         and back in;
      mon_partition    — isolate one monitor bidirectionally, keep
                         writing under the degraded quorum, heal it
                         (multi-mon clusters only);
      map_churn        — burn map epochs (pool create/rm) to exercise
                         client/OSD map-chasing under load;
      pg_num_grow      — double a thrashed pool's pg_num (capped):
                         every OSD splits its PGs in place while the
                         workload keeps writing;
      pgp_num_grow     — grow pg_num then raise pgp_num to match on a
                         replicated thrashed pool: children take their
                         own placement, acting sets reshuffle, and
                         REAL backfill data movement must drain
                         (stats oracle: misplaced rises then hits 0)
                         with no lost acked writes;
      ec_profile_swap  — roll the thrashed EC pool onto a freshly
                         committed profile with identical coding
                         parameters (rename/rollout path: codec cache
                         invalidation on every OSD, zero data risk);
      device_loss      — lose EVERY chip of the runtime mid-round:
                         no write that needs the device (an EC
                         pool's encode, a tlz pool's compression)
                         acks until the heal — each fails with -5
                         and is recorded unacked — DEVICE_LOST
                         raises naming exactly the lost chips that
                         serve live OSDs, and after clear_faults the
                         probe loops heal every chip (heal_count +1,
                         warning clears) with zero lost acked writes;
      chip_loss        — lose ONE chip mid-round: device-bound
                         writes whose PG primary is bound to it fail
                         with -5 (unacked), those whose primary sits
                         on a surviving chip still ack, DEVICE_LOST
                         names exactly that chip, every surviving
                         chip's `lost` flag never flips and its
                         loss_count stays unchanged, and the probe
                         loop heals only the lost chip (warning
                         clears) with zero lost acked writes;
      osd_crash        — crash an OSD on an injected exception: the
                         report must survive in its store, surface in
                         the committed `crash ls` after revive, raise
                         RECENT_CRASH, and clear via `crash archive`;
      mixed_rmw        — the ragged/parity-delta oracle (ROADMAP
                         direction 2): seeded rounds of interleaved
                         full-object rewrites and partial overwrites
                         (boundary-crossing offsets included) on the
                         same EC objects, issued concurrently so they
                         batch; afterwards every acked write reads
                         back exactly AND every stored shard —
                         delta-updated parity and incrementally
                         re-crc'd hinfo included — must be
                         BIT-IDENTICAL to the host codec's encode of
                         the final object contents;
      corrupt_shard    — the integrity-plane oracle, EC flavor: plant
                         seeded byte/attr/hinfo rot in stored EC
                         shards via the store, then prove the scrub
                         plane end to end — deep scrub finds EXACTLY
                         the planted set (write races confirmed away
                         by the recheck pass), PG_DAMAGED and
                         OSD_SCRUB_ERRORS raise through the
                         committed OSD->mgr->mon digest path, repair
                         scrubs drain the residual to zero, health
                         clears, and every planted object reads back
                         its original bytes;
      corrupt_replica  — the replicated-pool analog (byte rot or a
                         divergent xattr on one replica);
      corrupt_compressed — the compression-plane integrity oracle:
                         plant comp-size / blob rot in stored
                         compressed images on one replica of a
                         force-compression pool, prove the read path
                         REFUSES to serve truncated data (EIO, never
                         short bytes), deep scrub finds exactly the
                         planted set, repair drains it, and the
                         original bytes read back;
      poison_mid_compress — the compression-plane fault oracle: arm
                         a one-shot device fault on every live OSD's
                         affinity chip, then drive compressible
                         writefulls through a force-compression tlz
                         pool — the mid-dispatch loss loses only the
                         dispatching chip; every write either acks,
                         reads back and every replica's stored blob
                         decompresses to it, or fails with -5 and
                         leaves no blob on any replica (no host
                         route); the chips must heal;
      poison_mid_chunk — the dedup-plane analog: chunkable writefulls
                         through a dedup pool pair; a write either
                         acks and reads back, or fails with -5 and
                         leaves no base object and no chunk ref
                         tagged with it;
      repair_compare   — the repair-traffic oracle (ROADMAP
                         direction 3): rebuild the SAME planted
                         single-shard loss on an RS pool and an LRC
                         pool through the recovery path's targeted
                         minimal-set reconstruction, and demand the
                         LRC repair read strictly fewer survivor
                         bytes than the RS repair (the locality
                         property, measured — not assumed) while
                         both rebuilt shards are bit-identical to
                         the stored originals;
      bully_tenant     — the tenant SLO-plane oracle: mid-round, a
                         bully tenant floods the thrashed pool (many
                         tenant-stamped streams, wide windows) while
                         victim streams run a modest load through
                         the same shared client; every acked write
                         of BOTH tenants must read back
                         byte-identical, and the post-round SLO
                         oracle demands that once healthy no
                         VICTIM tenant is left holding a burn or
                         latency alert (the bully being throttled
                         at its dmClock limit tag is by design, not
                         a violation).
      net_degrade      — the network-plane oracle: hold every frame
                         between one seeded OSD pair ~80ms each way
                         (past the slow-ping bar, under the ping
                         period and far under the failure grace);
                         the leader must commit OSD_SLOW_PING_TIME
                         NAMING the pair, the raise must survive a
                         leader change, writes keep landing, and
                         lifting the delay clears the committed
                         edge.

    Slow-op oracle: after every round's health check, no live OSD may
    still hold an op in flight past osd_op_complaint_time — a healthy
    cluster with a stuck op means a requeue edge was lost somewhere.

    Event-plane oracles: every healthy round must end with ZERO
    un-archived crash reports in the committed table and no ERR-level
    entries in the committed cluster log (any ERR is an unexplained
    failure); kill/revive rounds must leave the victim's
    marked-down -> boot clog sequence committed in order.

    Integrity-plane oracle (scrub_oracle, on by default): every
    healthy round additionally deep-scrubs every thrashed pool and
    demands ZERO inconsistencies — with scrub always on, every
    thrash action is implicitly also a bit-rot regression test.
    """

    ALL_ACTIONS = ("kill_revive", "kill_wipe_revive", "out_in",
                   "mon_partition", "map_churn", "pg_num_grow",
                   "pgp_num_grow", "ec_profile_swap",
                   "device_loss", "chip_loss", "osd_crash",
                   "mixed_rmw", "corrupt_shard", "corrupt_replica",
                   "corrupt_compressed", "poison_mid_compress",
                   "bully_tenant", "repair_compare", "net_degrade")

    def __init__(self, cluster, seed: int = 0, rounds: int = 3,
                 actions: tuple | list | None = None,
                 hold: float = 0.8):
        """``actions`` is either None (each round draws from the
        default pool), or an explicit round list whose items are
        action names (victim still seeded) or ``(action, arg)``
        tuples (fully pinned); ``rounds`` is ignored when an explicit
        list is given."""
        self.cluster = cluster
        self.seed = seed
        self.rng = random.Random(seed)
        self.hold = hold        # seconds a fault is held per round
        # the full plan is fixed up front: deterministic per seed
        self.plan = []
        if actions is not None:
            for item in actions:
                if isinstance(item, str):
                    self.plan.append(self._plan_one(item))
                else:
                    action, arg = item
                    self._plan_one(action)  # burn rng identically
                    self.plan.append((action, arg))
        else:
            pool = self._default_actions()
            for _ in range(rounds):
                self.plan.append(
                    self._plan_one(self.rng.choice(pool)))
        self.log: list[str] = []
        # one record per device-fault round (chip_loss, device_loss,
        # poison_mid_compress, poison_mid_chunk): acks, -5 failures,
        # heal seconds, the DEVICE_LOST raise and clear
        self.device_rounds: list[dict] = []
        self._pool_ids: list = []
        # post-round deep-scrub-clean oracle (on by default: with
        # scrub always on, every action doubles as a rot regression
        # test); tests that deliberately leave rot behind turn it off
        self.scrub_oracle = True

    def _default_actions(self) -> list[str]:
        acts = ["kill_revive", "kill_wipe_revive", "out_in",
                "map_churn"]
        if self.cluster.n_mons >= 3:
            acts.append("mon_partition")
        return acts

    def _plan_one(self, action: str) -> tuple:
        if action in ("kill_revive", "kill_wipe_revive",
                      "osd_crash"):
            return (action, self.rng.randrange(self.cluster.n_osds))
        if action == "out_in":
            return (action, self.rng.randrange(self.cluster.n_osds))
        if action == "mon_partition":
            # never plan an isolated majority: one rank only
            return (action, self.rng.randrange(self.cluster.n_mons))
        if action in ("map_churn", "pg_num_grow", "pgp_num_grow",
                      "ec_profile_swap", "device_loss",
                      "chip_loss", "mixed_rmw", "corrupt_shard",
                      "corrupt_replica", "corrupt_compressed",
                      "poison_mid_compress", "bully_tenant",
                      "repair_compare", "corrupt_dedup_index",
                      "poison_mid_chunk", "net_degrade"):
            return (action, self.rng.randrange(1 << 16))
        raise ValueError("unknown thrash action %r" % action)

    # -- execution ---------------------------------------------------------

    async def run(self, pool_ids, workloads) -> None:
        """Execute the plan round by round, checking invariants after
        each (every pool active+clean, every workload's acked writes
        intact, quorum re-formed).  ``pool_ids``/``workloads`` accept
        a single item or a list.  On any failure the seed is printed
        so the schedule can be replayed exactly."""
        pool_ids = (list(pool_ids) if isinstance(pool_ids, (list,
                                                            tuple))
                    else [pool_ids])
        workloads = (list(workloads) if isinstance(workloads,
                                                   (list, tuple))
                     else [workloads])
        self._pool_ids = pool_ids
        try:
            for n, step in enumerate(self.plan):
                self.log.append("round %d: %s" % (n, (step,)))
                await self._dispatch(step, workloads[0])
                await self._check_invariants(pool_ids, workloads)
        except BaseException:
            print("THRASH FAILED: seed=%r plan=%r log=%r"
                  % (self.seed, self.plan, self.log))
            raise

    async def _dispatch(self, step: tuple, workload: Workload) -> None:
        action, arg = step
        c = self.cluster
        if action in ("kill_revive", "kill_wipe_revive"):
            victim = arg
            await c.kill_osd(victim)
            await c.wait_osd_down(victim)
            await asyncio.sleep(self.hold)      # degraded writes
            await c.revive_osd(victim,
                               wipe=(action == "kill_wipe_revive"))
            await c.wait_osd_up(victim)
            # the event plane must record the round: a committed
            # marked-down entry for the victim, then a boot entry
            # AFTER it — the same sequence on every mon, since both
            # are paxos-committed (deterministic modulo stamps)
            await self._wait_clog_down_boot(c, victim)
        elif action == "osd_crash":
            victim = arg
            cid = await c.crash_osd(
                victim, "thrash: injected crash on osd.%d" % victim)
            assert cid is not None, "crash report was not recorded"
            await c.wait_osd_down(victim)
            await asyncio.sleep(self.hold)      # degraded writes
            await c.revive_osd(victim)
            await c.wait_osd_up(victim)
            # the report survives the daemon (store-persisted),
            # reaches the committed table, raises RECENT_CRASH, and
            # clears via archive
            await self._wait_crash_listed(c, cid)
            await self._wait_health_check(c, "RECENT_CRASH", True)
            await c.client.mon_command("crash archive", id=cid)
            await self._wait_health_check(c, "RECENT_CRASH", False)
            await self._wait_clog_down_boot(c, victim)
        elif action == "out_in":
            victim = arg
            await c.mark_out(victim)
            await asyncio.sleep(self.hold)      # remap + backfill
            await c.mark_in(victim)
        elif action == "mon_partition":
            rank = arg
            c.partition_mon(rank)
            # a structural leader() check would trust a partitioned
            # leader that does not yet know it lost quorum: probe
            # with a real command, which only a mon that can reach a
            # majority answers (survivors re-elect if the victim led)
            await asyncio.sleep(self.hold)
            await c.client.mon_command("status", timeout=30.0)
            assert (await workload.write_one()) is not None, \
                "write could not complete under mon partition"
            c.heal_mon(rank)
            await c.wait_quorum()
            await c.client.mon_command("status", timeout=30.0)
        elif action == "map_churn":
            name = "churn-%d" % arg
            await c.client.mon_command("osd pool create", pool=name,
                                       pg_num=1, size=1)
            await c.client.mon_command("osd pool rm", pool=name)
        elif action == "pg_num_grow":
            pid = self._pool_ids[arg % len(self._pool_ids)]
            pool = c.client.osdmap.pools.get(pid)
            if pool is None:
                return
            new = min(pool.pg_num * 2, 64)
            if new <= pool.pg_num:
                return              # already at the cap
            self.log.append("pg_num %s: %d -> %d"
                            % (pool.name, pool.pg_num, new))
            await c.client.mon_command("osd pool set", pool=pool.name,
                                       var="pg_num", val=new)
            await asyncio.sleep(self.hold)   # writes ride the split
        elif action == "pgp_num_grow":
            # backfill-aware placement growth: raise pg_num first
            # (in-place split, no movement), then raise pgp_num to
            # match — children get their OWN placement, the acting
            # sets reshuffle, and REAL data movement (pg_temp-pinned
            # backfill) must drain while the workload keeps writing.
            # Replicated pools only (EC acting sets are positional;
            # pinning them is out of scope, ROADMAP PR-3).
            pid = next(
                (p for p in self._pool_ids
                 if (c.client.osdmap.pools.get(p) is not None
                     and not c.client.osdmap.pools[p]
                     .erasure_code_profile)), None)
            if pid is None:
                return              # no replicated pool under thrash
            pool = c.client.osdmap.pools[pid]
            target_pg = pool.pg_num
            if pool.pgp_num >= pool.pg_num:
                target_pg = min(pool.pg_num * 2, 64)
                if target_pg <= pool.pg_num:
                    return          # already at the cap
                await c.client.mon_command(
                    "osd pool set", pool=pool.name,
                    var="pg_num", val=target_pg)
                await asyncio.sleep(self.hold)  # splits land
            self.log.append("pgp_num %s: %d -> %d"
                            % (pool.name, pool.pgp_num, target_pg))
            await c.client.mon_command(
                "osd pool set", pool=pool.name,
                var="pgp_num", val=target_pg)
            await asyncio.sleep(self.hold)   # movement under load
        elif action == "ec_profile_swap":
            pid = next(
                (p for p in self._pool_ids
                 if (c.client.osdmap.pools.get(p) is not None
                     and c.client.osdmap.pools[p]
                     .erasure_code_profile)), None)
            if pid is None:
                return              # no EC pool under thrash
            pool = c.client.osdmap.pools[pid]
            cur = dict(c.client.osdmap.erasure_code_profiles.get(
                pool.erasure_code_profile) or {})
            if not cur:
                return
            name = "thrash-swap-%d" % arg
            await c.client.mon_command("osd erasure-code-profile set",
                                       name=name, profile=cur)
            await c.client.mon_command("osd pool set", pool=pool.name,
                                       var="erasure_code_profile",
                                       val=name)
            self.log.append("ec profile %s -> %s"
                            % (pool.erasure_code_profile, name))
            assert (await workload.write_one()) is not None, \
                "write could not complete after EC profile swap"
        elif action in ("device_loss", "chip_loss"):
            await self._chip_loss_round(c, action, arg, workload)
        elif action == "mixed_rmw":
            pid = next(
                (p for p in self._pool_ids
                 if (c.client.osdmap.pools.get(p) is not None
                     and c.client.osdmap.pools[p]
                     .erasure_code_profile)), None)
            if pid is None:
                return              # no EC pool under thrash
            await self._mixed_rmw_round(c, pid, arg)
        elif action == "bully_tenant":
            pid = self._pool_ids[arg % len(self._pool_ids)]
            if c.client.osdmap.pools.get(pid) is None:
                return
            await self._bully_tenant_round(c, pid, arg)
        elif action == "repair_compare":
            by_plugin: dict[str, int] = {}
            for p in self._pool_ids:
                pool = c.client.osdmap.pools.get(p)
                if pool is None or not pool.erasure_code_profile:
                    continue
                prof = c.client.osdmap.erasure_code_profiles.get(
                    pool.erasure_code_profile) or {}
                by_plugin.setdefault(
                    prof.get("plugin", "jerasure"), p)
            rs_pid = by_plugin.get("jerasure", by_plugin.get("isa"))
            lrc_pid = by_plugin.get("lrc")
            if rs_pid is None or lrc_pid is None:
                return              # needs both flavors under thrash
            await self._repair_compare_round(c, rs_pid, lrc_pid, arg)
        elif action == "corrupt_compressed":
            pid = next(
                (p for p in self._pool_ids
                 if (c.client.osdmap.pools.get(p) is not None
                     and c.client.osdmap.pools[p]
                     .compression_mode == "force"
                     and not c.client.osdmap.pools[p]
                     .erasure_code_profile)), None)
            if pid is None:
                return              # no compression pool under thrash
            await self._corrupt_compressed_round(c, pid, arg)
        elif action == "poison_mid_compress":
            pid = next(
                (p for p in self._pool_ids
                 if (c.client.osdmap.pools.get(p) is not None
                     and c.client.osdmap.pools[p]
                     .compression_mode == "force"
                     and not c.client.osdmap.pools[p]
                     .erasure_code_profile)), None)
            if pid is None:
                return              # no compression pool under thrash
            await self._poison_mid_compress_round(c, pid, arg)
        elif action == "net_degrade":
            await self._net_degrade_round(c, arg, workload)
        elif action == "corrupt_dedup_index":
            await self._corrupt_dedup_index_round(c, arg)
        elif action == "poison_mid_chunk":
            await self._poison_mid_chunk_round(c, arg)
        elif action in ("corrupt_shard", "corrupt_replica"):
            want_ec = action == "corrupt_shard"
            pid = next(
                (p for p in self._pool_ids
                 if (c.client.osdmap.pools.get(p) is not None
                     and bool(c.client.osdmap.pools[p]
                              .erasure_code_profile) == want_ec)),
                None)
            if pid is None:
                return              # no pool of that flavor
            await self._corrupt_round(c, pid, arg, ec=want_ec)
        else:
            raise ValueError(action)

    # tenants the bully rounds flood with: violations on these are by
    # design (the limit tag throttling them IS the mechanism), so the
    # post-round SLO oracle exempts them; every OTHER tenant must end
    # the round alert-free
    BULLY_TENANTS = frozenset({"bully", "other", "mixed"})

    async def _chip_loss_round(self, c, action: str, arg: int,
                               workload) -> None:
        """The port's chip-loss oracle (no host route to degrade to):
        lose one chip (chip_loss) or every chip (device_loss), then
        write through the loss — a device-bound write whose PG primary
        is bound to a lost chip fails with -5 and stays unacked, one
        whose primary sits on a surviving chip acks — DEVICE_LOST
        names exactly the lost chips that serve live OSDs, the
        survivors never flip `lost` nor count a loss, and after
        clear_faults the probe heals each victim once and the warning
        clears.  The round's acked writes are verified with the rest
        by the post-round invariants."""
        from ..device.runtime import DeviceRuntime
        from ..utils.backoff import wait_for
        rt = DeviceRuntime.get(c.device)
        if action == "chip_loss":
            victims = [rt.chips[arg % len(rt.chips)]]
        else:
            victims = list(rt.chips)
        survivors = [sc for sc in rt.chips if sc not in victims]
        pre_loss = {sc.index: sc.loss_count for sc in rt.chips}
        pre_heal = {ch.index: ch.heal_count for ch in victims}
        lost_idx = sorted(ch.index for ch in victims)
        for ch in victims:
            ch.inject_fault(1 << 30)     # probes keep failing too
            ch.poison("thrash: %s round (chip %d)" % (action, ch.index))
        self.log.append("%s: lost chips %r" % (action, lost_idx))
        rec = {"action": action, "chips": lost_idx}
        rec.update(await self._writes_through_loss(
            c, workload, set(lost_idx), minimum=5))
        bound = sorted({o.device_chip.index for o in c.live_osds
                        if o.device_chip is not None
                        and o.device_chip.index in lost_idx})
        if bound:
            await self._wait_health_check(c, "DEVICE_LOST", True)
            check = c.leader().health_mon.checks()["DEVICE_LOST"]
            assert check.get("chips") == bound, (check, bound)
        rec["device_lost_raised"] = bool(bound)
        for sc in survivors:
            assert not sc.lost, \
                "surviving chip %d was lost in the round" % sc.index
            assert sc.loss_count == pre_loss[sc.index], \
                "surviving chip %d counted a loss" % sc.index
        t0 = time.monotonic()
        for ch in victims:
            ch.clear_faults()            # the next probe heals
        await wait_for(lambda: not any(ch.lost for ch in victims),
                       30.0, what="chips %r healed" % lost_idx)
        rec["heal_s"] = time.monotonic() - t0
        for ch in victims:
            assert ch.heal_count == pre_heal[ch.index] + 1, \
                "chip %d healed %d times" % (
                    ch.index, ch.heal_count - pre_heal[ch.index])
        await self._wait_health_check(c, "DEVICE_LOST", False)
        rec["device_lost_cleared"] = True
        for sc in survivors:
            assert not sc.lost and \
                sc.loss_count == pre_loss[sc.index], sc.index
        self.device_rounds.append(rec)

    @staticmethod
    def _primary_chip(c, pool, oid: str, lost: set) -> tuple:
        """(primary osd of `oid` in the client's map, whether its chip
        is one of `lost`)."""
        m = c.client.osdmap
        pgid = pool.raw_pg_to_pg(m.object_locator_to_pg(oid, pool.id))
        _up, _upp, _acting, prim = m.pg_to_up_acting_osds(pgid)
        osd = c.osds[prim] if 0 <= prim < len(c.osds) else None
        return prim, (osd is not None and osd.device_chip is not None
                      and osd.device_chip.index in lost)

    @staticmethod
    def _needs_device(pool) -> bool:
        """A write to `pool` dispatches on its primary's chip: an EC
        pool's encode or a tlz pool's compression plan."""
        return bool(pool.erasure_code_profile) or (
            pool.compression_mode == "force"
            and pool.compression_algorithm == "tlz")

    async def _writes_through_loss(self, c, workload, lost: set,
                                   minimum: int = 5,
                                   most: int = 24) -> dict:
        """Workload writes while the chips in `lost` are lost, each
        held to the oracle by its PG primary's chip.  At least
        `minimum`; more (up to `most`) until both a refused and an
        acked write were seen where the pool admits both.  A write
        whose PG changed primary while it ran (a map epoch landed) is
        held to neither side and counted as `moved`."""
        io = workload.io
        pool = c.client.osdmap.pools[io.pool_id]
        needs = self._needs_device(pool)
        acked = refused = moved = 0
        for n in range(most):
            if n >= minimum and (not needs or (acked and refused)):
                break
            # write_one names its object before its first await
            oid = "%s-%d" % (workload.prefix, workload._seq)
            prim, on_lost = self._primary_chip(c, pool, oid, lost)
            got = await workload.write_one()
            if self._primary_chip(c, pool, oid, lost)[0] != prim:
                moved += 1
                continue
            if needs and on_lost:
                assert got is None, \
                    "%s acked through its primary's lost chip" % oid
                err = dict(workload.write_failures).get(oid, "")
                assert "rados error -5" in err, (oid, err)
                refused += 1
            else:
                assert got is not None, \
                    "write %s to a surviving chip's primary failed: " \
                    "%s" % (oid, dict(workload.write_failures).get(oid))
                acked += 1
        return {"acked": acked, "refused": refused, "moved": moved}

    async def _bully_tenant_round(self, c, pid: int,
                                  seed: int) -> None:
        """Noisy-neighbor flood mid-round: a bully tenant's stream
        fleet floods the thrashed pool while victim streams run a
        modest load through the same shared client.  Both tenants'
        acked writes must read back byte-identical (being throttled
        is never being lossy); the post-round SLO oracle in
        _check_invariants then demands no lingering victim alert."""
        from .traffic import TrafficGenerator
        pool = c.client.osdmap.pools[pid]
        gen = TrafficGenerator.build(
            c.client, pid,
            {"victim": {"streams": 2, "window": 2,
                        "obj_bytes": 2048, "n_objects": 8},
             "bully": {"streams": 6, "window": 6,
                       "obj_bytes": 4096, "n_objects": 8}},
            seed=seed)
        stats = await asyncio.wait_for(
            gen.run(max(self.hold, 1.0)), 120.0)
        self.log.append("bully_tenant on %s: %r"
                        % (pool.name,
                           {t: (s["n"], s["errors"])
                            for t, s in stats.items()}))
        for tenant, s in stats.items():
            assert s["n"] > 0, \
                "tenant %s completed zero ops under the flood" \
                % tenant
        # zero lost acked writes, bully included — throttling must
        # never become loss
        await asyncio.wait_for(gen.verify(), 120.0)

    async def _net_degrade_round(self, c, seed: int,
                                 workload) -> None:
        """Degrade one peer link mid-round: every frame between a
        seeded OSD pair is held ~80ms each way — past the 40ms
        slow-ping bar, under the 100ms ping period (no send-queue
        buildup, so the RTT stays stable and the clear is fast), and
        far under the 600ms failure grace (the pair must degrade,
        never die).  The leader must commit an OSD_SLOW_PING_TIME
        raise NAMING the pair, the raise must survive a leader
        change (it is paxos-committed), writes must keep landing,
        and lifting the delay must clear the committed edge."""
        osds = sorted(o.whoami for o in c.live_osds)
        if len(osds) < 2:
            return
        n = len(osds)
        ai = seed % n
        a = osds[ai]
        b = osds[(ai + 1 + (seed // n) % (n - 1)) % n]
        pair = "osd.%d-osd.%d" % (min(a, b), max(a, b))
        ea, eb = "osd.%d" % a, "osd.%d" % b
        c.injector(ea).add_rule(src=ea, dst=eb,
                                delay_p=1.0, delay=0.08)
        c.injector(eb).add_rule(src=eb, dst=ea,
                                delay_p=1.0, delay=0.08)
        self.log.append("net_degrade: delaying %s" % pair)
        try:
            # the committed raise must NAME the degraded pair
            await self._wait_health_check(
                c, "OSD_SLOW_PING_TIME", True, timeout=45.0)
            chk = c.leader().health_mon.checks()[
                "OSD_SLOW_PING_TIME"]
            assert pair in (chk.get("pairs") or ()), chk
            # a degraded link is not an outage: writes keep landing
            for _ in range(3):
                assert (await workload.write_one()) is not None, \
                    "write could not complete on the degraded link"
            if c.n_mons >= 3:
                # the edge is paxos-committed: losing the leader
                # must not lose the raise (the successor re-warns
                # from the committed pair list and its own beacon
                # soft state)
                old = c.leader().rank
                c.partition_mon(old)
                await c.client.mon_command("status", timeout=30.0)
                await self._wait_health_check(
                    c, "OSD_SLOW_PING_TIME", True, timeout=45.0)
                c.heal_mon(old)
                await c.wait_quorum()
        finally:
            c.injector(ea).clear_rules()
            c.injector(eb).clear_rules()
        # delay lifted: healthy pings resume within a period and the
        # committed edge must clear
        await self._wait_health_check(
            c, "OSD_SLOW_PING_TIME", False, timeout=45.0)

    async def _slo_oracle(self, c, timeout: float = 45.0) -> None:
        """Post-round tenant SLO oracle: once the cluster is healthy
        and the burn windows have decayed, neither SLO_LATENCY nor
        SLO_BURN may still name a non-bully tenant — a victim left
        holding an alert after the fault cleared means the QoS plane
        failed to protect it (or the engine failed to clear).  The
        bully's own alerts are exempt: being throttled at its limit
        tag is the mechanism working, not a violation."""
        from ..utils.backoff import wait_for

        def pred():
            leader = c.leader()
            if leader is None:
                return False
            checks = leader.health_mon.checks()
            for name in ("SLO_LATENCY", "SLO_BURN"):
                chk = checks.get(name)
                if chk is None:
                    continue
                victims = [t for t in chk.get("tenants", ())
                           if t not in self.BULLY_TENANTS]
                if victims:
                    return False
            return True

        await wait_for(pred, timeout,
                       what="victim-tenant SLO alerts cleared")

    async def _repair_compare_round(self, c, rs_pid: int,
                                    lrc_pid: int, seed: int) -> None:
        """Plant the same single-shard loss on an RS pool and an LRC
        pool, rebuild each through the recovery path's targeted
        minimal-set reconstruction (`ECPGBackend._reconstruct_shard`
        — the exact function `recover_peer_shards` dispatches), and
        compare the survivor bytes each repair read: the LRC round
        must read strictly fewer (its local group) than the RS round
        (k whole chunks), and both rebuilt shards must be
        bit-identical to the stored originals."""
        from ..device.runtime import K_RECOVERY_EC
        from ..osd.osdmap import pg_t
        from ..store.objectstore import hobject_t
        rng = random.Random("repaircmp-%r-%d" % (self.seed, seed))
        payload = rng.randbytes(rng.randrange(16, 49) * 1024)
        read_bytes: dict[str, int] = {}
        for label, pid in (("rs", rs_pid), ("lrc", lrc_pid)):
            pool = c.client.osdmap.pools[pid]
            io = c.client.io_ctx(pool.name)
            oid = "repaircmp-%d-%s" % (seed, label)
            await asyncio.wait_for(io.write_full(oid, payload), 30.0)
            await c.wait_health(pid, timeout=120.0)
            m = c.client.osdmap
            pgid = pool.raw_pg_to_pg(
                m.object_locator_to_pg(oid, pid))
            _up, _upp, acting, prim = m.pg_to_up_acting_osds(pgid)
            alive = {o.whoami: o for o in c.live_osds}
            primary = alive.get(prim)
            assert primary is not None, "primary osd.%s dead" % prim
            pg = primary.pgs[pg_t(pid, pgid.ps)]
            # the planted loss: a non-primary DATA-shard holder (the
            # shape where LRC's locality pays; data positions come
            # from the codec's chunk mapping)
            codec = primary.ec.codec(pool)
            mapping = codec.get_chunk_mapping()
            k = codec.get_data_chunk_count()
            data_pos = ([mapping[i] for i in range(k)] if mapping
                        else list(range(k)))
            cands = [j for j in data_pos
                     if j < len(acting) and acting[j] >= 0
                     and acting[j] != prim and acting[j] in alive]
            assert cands, "no non-primary data shard to lose"
            j = cands[rng.randrange(len(cands))]
            rec = await primary.ec._reconstruct_shard(
                pg, oid, j, K_RECOVERY_EC)
            assert rec is not None, (
                "targeted %s repair fell back to the full path"
                % label)
            shard, _size, _ver, _attrs, nread = rec
            holder = alive[acting[j]]
            hpg = holder.pgs[pg_t(pid, pgid.ps)]
            stored = holder.ec._local_shard(hpg, hobject_t(oid))
            assert stored is not None and stored[0] == j, \
                "victim osd.%d does not hold shard %d" \
                % (acting[j], j)
            assert bytes(stored[1]) == shard, (
                "%s targeted repair rebuilt shard %d wrong"
                % (label, j))
            read_bytes[label] = nread
        self.log.append("repair_compare: read_bytes=%r" % read_bytes)
        assert read_bytes["lrc"] < read_bytes["rs"], (
            "LRC single-shard repair read %d bytes, not fewer than"
            " the RS repair's %d for the same loss" % (
                read_bytes["lrc"], read_bytes["rs"]))

    async def _corrupt_round(self, c, pid: int, seed: int,
                             ec: bool) -> None:
        """Plant seeded corruption in stored copies via the store and
        prove the scrub plane repairs to clean: deep scrub detects
        EXACTLY the planted set, OSD_SCRUB_ERRORS + PG_DAMAGED raise
        through the committed digest path, repair drains the residual
        to zero, health clears, and the original bytes read back."""
        from ..osd.osdmap import pg_t
        from ..store.objectstore import NotFound, Transaction, \
            hobject_t
        pool = c.client.osdmap.pools[pid]
        io = c.client.io_ctx(pool.name)
        rng = random.Random("corrupt-%r-%d" % (self.seed, seed))
        payloads = {}
        for i in range(3):
            oid = "rot-%d-%d" % (seed, i)
            payloads[oid] = rng.randbytes(rng.randrange(2, 8) * 512)
            await asyncio.wait_for(
                io.write_full(oid, payloads[oid]), 30.0)
        await c.wait_health(pid, timeout=120.0)
        m = c.client.osdmap
        alive = {o.whoami: o for o in c.live_osds}
        planted: dict = {}          # ps -> set of planted oids
        for oid in sorted(payloads)[:2]:
            pgid = pool.raw_pg_to_pg(
                m.object_locator_to_pg(oid, pid))
            _up, _upp, acting, _prim = m.pg_to_up_acting_osds(pgid)
            members = [o for o in acting if o >= 0 and o in alive]
            victim = alive[members[rng.randrange(len(members))]]
            pg = victim.pgs[pg_t(pid, pgid.ps)]
            ho = hobject_t(oid)
            mode = rng.choice(["data", "attrs", "hinfo"] if ec
                              else ["data", "attrs"])
            t = Transaction()
            if mode == "data":
                data = bytearray(victim.store.read(pg.cid, ho))
                data[rng.randrange(len(data))] ^= 0xFF
                t.write(pg.cid, ho, 0, len(data), bytes(data))
            elif mode == "hinfo":
                # rotted integrity METADATA: still a parseable crc
                # vector, just the wrong one — the majority vote must
                # out it and repair must recompute it
                try:
                    raw = victim.store.getattr(pg.cid, ho,
                                               "ec_hinfo")
                except NotFound:
                    raw = b"0"
                t.setattr(pg.cid, ho, "ec_hinfo", b"1" + raw)
            elif ec:
                # divergent shard metadata (ec_ver): the (ver, size)
                # auth group loses this member even on shallow scrub
                t.setattr(pg.cid, ho, "ec_ver", b"rot.rot")
            else:
                # replicated attr rot: a divergent EXTRA xattr —
                # repair must remove it, not merge around it
                t.setattr(pg.cid, ho, "_rot", b"planted")
            victim.store.apply_transaction(t)
            planted.setdefault(pgid.ps, set()).add(oid)
            self.log.append("corrupt: %s %s on osd.%d (%s)"
                            % (oid, mode, victim.whoami, pg.pgid))
        all_planted = {o for s in planted.values() for o in s}
        # 1. deep scrub finds EXACTLY the planted set (recheck
        #    confirms away workload write races)
        found = set()
        for ps in sorted(planted):
            osd, pg = c.pg_primary(pid, ps)
            assert osd is not None and pg is not None, (pid, ps)
            res = await osd.scrubber.scrub_pg(pg, deep=True,
                                              recheck=True)
            got = {k for k in res["inconsistent"]}
            assert got == planted[ps], (
                "deep scrub of %s found %r, planted %r"
                % (pg.pgid, sorted(got), sorted(planted[ps])))
            found |= got
        assert found == all_planted, (found, all_planted)
        # 2. the health surface raises through the committed
        #    OSD -> mgr -> mon digest path
        if c.mgr is not None:
            await self._wait_health_check(c, "OSD_SCRUB_ERRORS", True)
            await self._wait_health_check(c, "PG_DAMAGED", True)
        # 3. repair drains the residual to zero (surgical: only the
        #    known-bad objects, so an in-flight workload write can
        #    never be "repaired" mid-replication)
        for ps in sorted(planted):
            osd, pg = c.pg_primary(pid, ps)
            res = await osd.scrubber.scrub_pg(pg, deep=True,
                                              repair=True,
                                              only=planted[ps])
            assert res["repaired"] >= 1, res
            assert res["residual"] == 0, res
        # ...and a re-scrub is CLEAN (repair idempotency: nothing
        # left to find, nothing left to fix)
        for ps in sorted(planted):
            osd, pg = c.pg_primary(pid, ps)
            res = await osd.scrubber.scrub_pg(pg, deep=True,
                                              recheck=True)
            assert not (set(res["inconsistent"]) & all_planted), res
            assert res["errors"] == 0, res
        # 4. health clears (only a successful repair scrub may clear)
        if c.mgr is not None:
            await self._wait_health_check(c, "OSD_SCRUB_ERRORS",
                                          False)
            await self._wait_health_check(c, "PG_DAMAGED", False)
        # 5. the original bytes survive the whole ordeal
        for oid, want in sorted(payloads.items()):
            got = await asyncio.wait_for(io.read(oid), 30.0)
            assert got == want, \
                "corrupt round lost %s after repair" % oid

    async def _corrupt_compressed_round(self, c, pid: int,
                                        seed: int) -> None:
        """Compression-plane integrity: plant comp-size / blob rot in
        one replica's stored compressed image, prove the read path
        refuses to serve truncated data (EIO), deep scrub finds
        EXACTLY the planted set, repair drains it to zero, and the
        original bytes read back."""
        from ..compress import OBJ_SIZE_ATTR
        from ..osd.osdmap import pg_t
        from ..store.objectstore import Transaction, hobject_t
        pool = c.client.osdmap.pools[pid]
        io = c.client.io_ctx(pool.name)
        rng = random.Random("corruptcomp-%r-%d" % (self.seed, seed))
        payloads = {}
        for i in range(3):
            oid = "comprot-%d-%d" % (seed, i)
            unit = bytes(rng.randrange(0x20, 0x7F)
                         for _ in range(16))
            payloads[oid] = unit * rng.randrange(256, 1500)
            await asyncio.wait_for(
                io.write_full(oid, payloads[oid]), 30.0)
        await c.wait_health(pid, timeout=120.0)
        m = c.client.osdmap
        alive = {o.whoami: o for o in c.live_osds}
        planted: dict = {}          # ps -> set of planted oids
        for idx, oid in enumerate(sorted(payloads)[:2]):
            pgid = pool.raw_pg_to_pg(
                m.object_locator_to_pg(oid, pid))
            _up, _upp, acting, prim = m.pg_to_up_acting_osds(pgid)
            members = [o for o in acting if o >= 0 and o in alive]
            # first plant lands on the PRIMARY so the read-path guard
            # is provably exercised; the second on a seeded member
            victim = alive[prim if idx == 0 and prim in alive
                           else members[rng.randrange(len(members))]]
            pg = victim.pgs[pg_t(pid, pgid.ps)]
            ho = hobject_t(oid)
            assert victim.store.getattr(pg.cid, ho, "comp-alg"), \
                "%s stored raw on osd.%d: payload did not" \
                " compress" % (oid, victim.whoami)
            mode = rng.choice(["size_attr", "blob"])
            t = Transaction()
            if mode == "size_attr":
                # comp-size disagrees with the decompressed length:
                # without the guard this SERVES wrong-length data
                t.setattr(pg.cid, ho, OBJ_SIZE_ATTR,
                          b"%d" % (len(payloads[oid]) + 7))
            else:
                # physically truncated blob: decompression fails
                blob = victim.store.read(pg.cid, ho)
                t.truncate(pg.cid, ho, 0)
                t.write(pg.cid, ho, 0, len(blob) // 2,
                        bytes(blob[:len(blob) // 2]))
            victim.store.apply_transaction(t)
            planted.setdefault(pgid.ps, set()).add(oid)
            self.log.append("corrupt_compressed: %s %s on osd.%d"
                            % (oid, mode, victim.whoami))
            if victim.whoami == prim:
                # the guard: a read THROUGH the rotted copy fails
                # with EIO — truncated/padded bytes are never served
                outs, res = victim._do_read_ops(
                    pg, oid, [{"op": "read"}])
                assert res == -5, (
                    "rotted compressed read returned %r, not EIO"
                    % ((outs, res),))
        all_planted = {o for s in planted.values() for o in s}
        # deep scrub finds EXACTLY the planted set, repair drains it,
        # a re-scrub is clean, and the original bytes survive
        for ps in sorted(planted):
            osd, pg = c.pg_primary(pid, ps)
            res = await osd.scrubber.scrub_pg(pg, deep=True,
                                              recheck=True)
            got = set(res["inconsistent"])
            assert got == planted[ps], (
                "deep scrub of %s found %r, planted %r"
                % (pg.pgid, sorted(got), sorted(planted[ps])))
        for ps in sorted(planted):
            osd, pg = c.pg_primary(pid, ps)
            res = await osd.scrubber.scrub_pg(pg, deep=True,
                                              repair=True,
                                              only=planted[ps])
            assert res["repaired"] >= 1, res
            assert res["residual"] == 0, res
        for ps in sorted(planted):
            osd, pg = c.pg_primary(pid, ps)
            res = await osd.scrubber.scrub_pg(pg, deep=True,
                                              recheck=True)
            assert not (set(res["inconsistent"]) & all_planted), res
        for oid, want in sorted(payloads.items()):
            got = await asyncio.wait_for(io.read(oid), 30.0)
            assert got == want, \
                "corrupt_compressed lost %s after repair" % oid

    async def _poison_mid_compress_round(self, c, pid: int,
                                         seed: int) -> None:
        """Chip loss mid-compress: arm a one-shot device fault on
        every live OSD's affinity chip, then drive compressible
        writefulls through the tlz pool — the dispatching chip is lost
        mid-flight; each write either acks or fails with -5 and leaves
        no blob on any replica (no host route); the lost chips heal,
        the refused writes are written again, and every write reads
        back and decompresses from every replica's stored blob."""
        from ..compress import create
        from ..osd.osdmap import pg_t
        from ..store.objectstore import hobject_t
        from ..utils.backoff import wait_for
        pool = c.client.osdmap.pools[pid]
        if pool.compression_algorithm != "tlz":
            await c.client.mon_command(
                "osd pool set", pool=pool.name,
                var="compression_algorithm", val="tlz")
            await wait_for(
                lambda: all(
                    o.osdmap.pools.get(pid) is not None
                    and o.osdmap.pools[pid].compression_algorithm
                    == "tlz" for o in c.live_osds),
                30.0, what="tlz algorithm visible on every OSD")
            pool = c.client.osdmap.pools[pid]
        io = c.client.io_ctx(pool.name)
        rng = random.Random("poisoncomp-%r-%d" % (self.seed, seed))
        payloads = {}
        for i in range(5):
            oid = "poisoncomp-%d-%d" % (seed, i)
            unit = bytes(rng.randrange(0x20, 0x7F)
                         for _ in range(12))
            payloads[oid] = unit * rng.randrange(300, 2000)
        acked = await self._poisoned_writes(c, io, payloads,
                                            "poison_mid_compress")
        m = c.client.osdmap
        alive = {o.whoami: o for o in c.live_osds}
        members = {}
        for oid in payloads:
            pgid = pool.raw_pg_to_pg(m.object_locator_to_pg(oid, pid))
            _up, _upp, acting, _prim = m.pg_to_up_acting_osds(pgid)
            members[oid] = [(alive[o], pg_t(pid, pgid.ps))
                            for o in acting if o in alive]
        # a refused write leaves no (partial) blob on any replica; after
        # the heal it is written again and must ack
        for oid in sorted(set(payloads) - acked):
            for osd, pgid in members[oid]:
                pg = osd.pgs.get(pgid)
                assert pg is None or not osd.store.exists(
                    pg.cid, hobject_t(oid)), (
                    "refused write %s left a blob on osd.%d"
                    % (oid, osd.whoami))
            await asyncio.wait_for(io.write_full(oid, payloads[oid]),
                                   30.0)
        # every write reads back, and every stored blob decompresses to
        # the original bytes on every live replica
        for oid, want in sorted(payloads.items()):
            got = await asyncio.wait_for(io.read(oid), 30.0)
            assert got == want, \
                "acked write %s lost through the chip poison" % oid
            for osd, pgid in members[oid]:
                pg = osd.pgs.get(pgid)
                if pg is None:
                    continue
                ho = hobject_t(oid)
                algo = osd.store.getattr(pg.cid, ho, "comp-alg")
                assert algo == b"tlz", (oid, osd.whoami, algo)
                blob = osd.store.read(pg.cid, ho)
                assert create("tlz").decompress(bytes(blob)) \
                    == want, (
                    "stored blob of %s on osd.%d does not decompress"
                    " to the original bytes" % (oid, osd.whoami))

    async def _poisoned_writes(self, c, io, payloads: dict,
                               action: str) -> set:
        """Arm a one-shot fault on every live OSD's chip and write
        `payloads` concurrently: the first dispatch on each chip
        consumes its fault and loses the chip.  Each write acks or
        fails with -5 (never another way, never on a host route);
        the faults are cleared and the chips must heal.  Returns the
        acked object names and records the round."""
        from ..device.runtime import DeviceRuntime
        from ..utils.backoff import wait_for
        rt = DeviceRuntime.get(c.device)
        chips = {(o.device_chip if o.device_chip is not None
                  else rt.chip_for(o.whoami)) for o in c.live_osds}
        pre_loss = {ch.index: ch.loss_count for ch in chips}
        for ch in chips:
            ch.inject_fault(1)
        names = sorted(payloads)
        try:
            # concurrent writefulls: the first dispatch on a chip
            # consumes its fault mid-flight
            results = await asyncio.wait_for(asyncio.gather(*[
                io.write_full(oid, payloads[oid]) for oid in names],
                return_exceptions=True), 60.0)
        finally:
            for ch in chips:
                ch.clear_faults()
        t0 = time.monotonic()
        lost = sorted(ch.index for ch in chips
                      if ch.loss_count > pre_loss[ch.index])
        assert lost, "no chip consumed the armed %s fault" % action
        acked = set()
        for oid, r in zip(names, results):
            if isinstance(r, BaseException):
                assert getattr(r, "code", None) == -5, (oid, r)
            else:
                acked.add(oid)
        # the probe loops heal every poisoned chip (faults cleared)
        await wait_for(lambda: all(not ch.lost for ch in chips),
                       30.0, what="poisoned chips healed")
        self.device_rounds.append({
            "action": action, "chips": lost, "acked": len(acked),
            "refused": len(names) - len(acked),
            "heal_s": time.monotonic() - t0})
        self.log.append("%s: %d writes, %d acked, chips %r lost"
                        % (action, len(names), len(acked), lost))
        return acked

    async def _dedup_pool_pair(self, c, seed: int) -> tuple[int, int]:
        """(base pool id, chunk pool id) for the dedup rounds: an
        existing dedup binding if any pool has one, else an in-round
        pair created through the mon (both plain replicated) and
        waited visible on every live OSD."""
        from ..utils.backoff import wait_for
        for p, pool in sorted(c.client.osdmap.pools.items()):
            if getattr(pool, "dedup_chunk_pool", -1) >= 0:
                return p, pool.dedup_chunk_pool
        base = "dthrash-%d" % seed
        await c.client.mon_command("osd pool create", pool=base,
                                   pg_num=4)
        await c.client.mon_command("osd pool create",
                                   pool=base + "-chunks", pg_num=4)
        await c.client.mon_command("osd pool set", pool=base,
                                   var="dedup_chunk_pool",
                                   val=base + "-chunks")
        await wait_for(
            lambda: any(pl.name == base
                        and getattr(pl, "dedup_chunk_pool", -1) >= 0
                        for pl in c.client.osdmap.pools.values()),
            30.0, what="dedup binding visible on the client")
        pid = next(p for p, pl in c.client.osdmap.pools.items()
                   if pl.name == base)
        cpid = c.client.osdmap.pools[pid].dedup_chunk_pool
        await wait_for(
            lambda: all(
                o.osdmap is not None
                and o.osdmap.pools.get(pid) is not None
                and getattr(o.osdmap.pools[pid],
                            "dedup_chunk_pool", -1) == cpid
                for o in c.live_osds),
            30.0, what="dedup binding visible on every OSD")
        await c.wait_health(pid, timeout=120.0)
        await c.wait_health(cpid, timeout=120.0)
        return pid, cpid

    async def _corrupt_dedup_index_round(self, c, seed: int) -> None:
        """Chunk-store integrity: write a redundant corpus through a
        dedup pool, rot one content-addressed chunk object on ALL BUT
        ONE replica (identical junk, so plain majority voting would
        crown the rot), prove deep scrub detects EXACTLY the planted
        object, repair restores from the single copy that still
        matches its address, a re-scrub is clean, and every base
        object reads back byte-identical."""
        from ..dedup import CHUNK_MIN, parse_chunk_oid
        from ..osd.osdmap import pg_t
        from ..store.objectstore import Transaction, hobject_t
        pid, cpid = await self._dedup_pool_pair(c, seed)
        pool = c.client.osdmap.pools[pid]
        io = c.client.io_ctx(pool.name)
        rng = random.Random("dedrot-%r-%d" % (self.seed, seed))
        shared = rng.randbytes(5 * CHUNK_MIN)
        payloads = {}
        for i in range(4):
            oid = "dedrot-%d-%d" % (seed, i)
            payloads[oid] = shared + rng.randbytes(CHUNK_MIN // 2)
            await asyncio.wait_for(
                io.write_full(oid, payloads[oid]), 30.0)
        await c.wait_health(cpid, timeout=120.0)
        alive = {o.whoami: o for o in c.live_osds}
        # every content-addressed chunk object the store holds, via
        # the chunk-pool primaries' collections
        targets: list[tuple[int, str]] = []
        for o in c.live_osds:
            for pg in o.pgs.values():
                if pg.pool_id != cpid or not pg.is_primary():
                    continue
                for h in o.store.collection_list(pg.cid):
                    if parse_chunk_oid(h.name) is not None:
                        targets.append((pg.ps, h.name))
        assert targets, "no chunk objects landed in the chunk pool"
        targets.sort()
        ps, oid = targets[rng.randrange(len(targets))]
        m = c.client.osdmap
        _up, _upp, acting, _prim = m.pg_to_up_acting_osds(
            pg_t(cpid, ps))
        members = [o for o in acting if o >= 0 and o in alive]
        if len(members) < 2:
            return          # nothing to outvote on a 1-wide pool
        survivor = members[rng.randrange(len(members))]
        victims = [o for o in members if o != survivor]
        blob0 = alive[survivor].store.read(
            alive[survivor].pgs[pg_t(cpid, ps)].cid, hobject_t(oid))
        junk = rng.randbytes(len(blob0))        # same junk: majority
        for v in victims:
            osd = alive[v]
            pg = osd.pgs[pg_t(cpid, ps)]
            t = Transaction()
            t.truncate(pg.cid, hobject_t(oid), 0)
            t.write(pg.cid, hobject_t(oid), 0, len(junk), junk)
            osd.store.apply_transaction(t)
        self.log.append("corrupt_dedup_index: %s rotted on %r,"
                        " survivor osd.%d" % (oid, victims, survivor))
        osd, pg = c.pg_primary(cpid, ps)
        res = await osd.scrubber.scrub_pg(pg, deep=True, recheck=True)
        assert set(res["inconsistent"]) == {oid}, (
            "deep scrub of %s found %r, planted [%s]"
            % (pg.pgid, sorted(res["inconsistent"]), oid))
        res = await osd.scrubber.scrub_pg(pg, deep=True, repair=True,
                                          only={oid})
        assert res["repaired"] >= 1, res
        assert res["residual"] == 0, res
        res = await osd.scrubber.scrub_pg(pg, deep=True, recheck=True)
        assert oid not in set(res["inconsistent"]), res
        # the address-matching copy won: every replica holds the
        # original chunk bytes again, and the base corpus reads back
        for v in members:
            got = alive[v].store.read(
                alive[v].pgs[pg_t(cpid, ps)].cid, hobject_t(oid))
            assert bytes(got) == bytes(blob0), (
                "chunk %s on osd.%d not restored" % (oid, v))
        for boid, want in sorted(payloads.items()):
            got = await asyncio.wait_for(io.read(boid), 30.0)
            assert got == want, (
                "corrupt_dedup_index lost %s after repair" % boid)

    async def _poison_mid_chunk_round(self, c, seed: int) -> None:
        """Chip loss mid-chunk: arm a one-shot device fault on every
        live OSD's affinity chip, then drive chunkable writefulls
        through a dedup pool — the dispatching chip is lost
        mid-flight; a write either acks, or fails with -5 and leaves
        no base object and no chunk ref tagged with it (no host route);
        the lost chips heal, the refused writes are written again, and
        every write reads back."""
        from ..dedup import CHUNK_MIN
        from ..dedup.plane import DedupPlane
        from ..osd.cls.refcount import REF_XATTR
        from ..store.objectstore import NotFound, hobject_t
        from ..utils import denc
        pid, cpid = await self._dedup_pool_pair(c, seed)
        pool = c.client.osdmap.pools[pid]
        io = c.client.io_ctx(pool.name)
        rng = random.Random("poisonchunk-%r-%d" % (self.seed, seed))
        shared = rng.randbytes(3 * CHUNK_MIN)
        payloads = {}
        for i in range(5):
            oid = "poisonchunk-%d-%d" % (seed, i)
            payloads[oid] = shared + rng.randbytes(
                CHUNK_MIN // 4 * (i + 1))
        acked = await self._poisoned_writes(c, io, payloads,
                                            "poison_mid_chunk")
        refused = {DedupPlane.ref_tag(pid, oid): oid
                   for oid in payloads if oid not in acked}
        for o in c.live_osds:
            for pg in o.pgs.values():
                if pg.pool_id == pid:
                    for oid in refused.values():
                        assert not o.store.exists(pg.cid,
                                                  hobject_t(oid)), (
                            "refused write %s left a base object on "
                            "osd.%d" % (oid, o.whoami))
                if pg.pool_id != cpid:
                    continue
                for h in o.store.collection_list(pg.cid):
                    try:
                        raw = o.store.getattr(pg.cid, h, REF_XATTR)
                    except NotFound:
                        continue
                    tags = set(denc.decode(raw)) if raw else set()
                    dangling = tags & set(refused)
                    assert not dangling, (
                        "chunk %s on osd.%d holds refs of refused "
                        "writes %r" % (h.name, o.whoami,
                                       [refused[t] for t in dangling]))
        # after the heal the refused writes are written again and ack;
        # every write reads back
        for oid in sorted(refused.values()):
            await asyncio.wait_for(io.write_full(oid, payloads[oid]),
                                   30.0)
        for oid, want in sorted(payloads.items()):
            got = await asyncio.wait_for(io.read(oid), 30.0)
            assert got == want, \
                "acked write %s lost through the chip poison" % oid

    async def _mixed_rmw_round(self, c, pid: int, seed: int) -> None:
        """Interleaved full rewrites + partial overwrites on the same
        EC objects (seeded, one write per object per concurrent
        batch so the expected content is unambiguous), then the
        direction-2 oracle: every acked write reads back exactly and
        every stored shard is bit-identical to the host codec's
        encode of the final contents."""
        pool = c.client.osdmap.pools[pid]
        io = c.client.io_ctx(pool.name)
        rng = random.Random("mixed_rmw-%r-%d" % (self.seed, seed))
        model: dict[str, bytearray] = {}
        for i in range(4):
            oid = "mixedrmw-%d-%d" % (seed, i)
            size = rng.randrange(8, 33) * 1024
            data = rng.randbytes(size)
            await asyncio.wait_for(io.write_full(oid, data), 30.0)
            model[oid] = bytearray(data)
        oids = sorted(model)
        chunk = max(1, len(model[oids[0]]) // 2)
        for _step in range(5):
            batch = []
            for oid in oids:
                size = len(model[oid])
                roll = rng.random()
                if roll < 0.25:
                    batch.append((oid, rng.randbytes(size), None))
                elif roll < 0.5:
                    # chunk-boundary-crossing overwrite (the delta
                    # path must split it per column range)
                    ln = rng.randrange(256, 2048)
                    off = max(0, min(size - ln,
                                     chunk - ln // 2))
                    batch.append((oid, rng.randbytes(ln), off))
                else:
                    ln = rng.randrange(16, 4096)
                    off = rng.randrange(0, max(1, size - ln))
                    batch.append((oid, rng.randbytes(ln), off))
            # concurrent: partial overwrites across objects batch
            # into shared device dispatches
            await asyncio.wait_for(asyncio.gather(*[
                (io.write_full(oid, d) if off is None
                 else io.write(oid, d, off))
                for oid, d, off in batch]), 60.0)
            for oid, d, off in batch:   # all acked (gather raised
                if off is None:         # on any failure)
                    model[oid] = bytearray(d)
                else:
                    model[oid][off:off + len(d)] = d
        self.log.append("mixed_rmw: %d objects, 5 rounds" % len(oids))
        await c.wait_health(pid, timeout=120.0)
        for oid, want in sorted(model.items()):
            got = await asyncio.wait_for(io.read(oid), 30.0)
            assert got == bytes(want), \
                "acked mixed_rmw write lost/corrupt on %s" % oid
        await self._verify_ec_host_parity(c, pid, model)

    @staticmethod
    async def _verify_ec_host_parity(c, pid: int,
                                     objects: dict) -> None:
        """Every live acting member's stored shard of `objects` must
        be BIT-IDENTICAL to the host codec's encode of the expected
        payload — delta-updated parity shards and the incrementally
        maintained hinfo crcs included.  Run only on a healthy pool
        (recovery drained), so every member holds current bytes."""
        from ..ec import new_codec
        from ..osd.ecbackend import HINFO_XATTR, hinfo_bytes
        from ..osd.osdmap import pg_t
        from ..store.objectstore import hobject_t
        m = c.client.osdmap
        pool = m.pools[pid]
        profile = dict(m.erasure_code_profiles.get(
            pool.erasure_code_profile) or {})
        codec = new_codec(dict(profile, plugin=profile.get(
            "plugin", "jerasure")), device="cpu")
        n = codec.get_chunk_count()
        osd_by_id = {o.whoami: o for o in c.live_osds}
        for oid, want in sorted(objects.items()):
            expected = codec.encode(set(range(n)), bytes(want))
            hinfo = hinfo_bytes(expected)
            pgid = pool.raw_pg_to_pg(
                m.object_locator_to_pg(oid, pid))
            _up, _upp, acting, _prim = m.pg_to_up_acting_osds(pgid)
            checked = 0
            for j, osd_id in enumerate(acting):
                osd = osd_by_id.get(osd_id)
                if osd is None:
                    continue
                pg = osd.pgs.get(pg_t(pid, pgid.ps))
                if pg is None:
                    continue
                local = osd.ec._local_shard(pg, hobject_t(oid))
                assert local is not None, \
                    "%s: osd.%d holds no shard" % (oid, osd_id)
                lj, buf, size, _ver, attrs = local
                assert lj == j, (oid, osd_id, lj, j)
                assert size == len(want), (oid, size, len(want))
                assert bytes(buf) == expected[j], (
                    "mixed_rmw: shard %d of %s on osd.%d diverged "
                    "from the host codec (%d bytes)"
                    % (j, oid, osd_id, len(buf)))
                assert attrs.get(HINFO_XATTR) == hinfo, (
                    "mixed_rmw: hinfo crc of %s shard %d diverged "
                    "from a host recompute" % (oid, j))
                checked += 1
            assert checked >= codec.get_data_chunk_count(), \
                "%s: only %d shards checkable" % (oid, checked)

    @staticmethod
    async def _wait_crash_listed(c, crash_id: str,
                                 timeout: float = 30.0) -> None:
        """Poll until the crash report is in the COMMITTED table of
        the leading mon (shipped from the revived daemon's store and
        paxos-committed)."""
        from ..utils.backoff import wait_for

        def pred():
            leader = c.leader()
            return (leader is not None
                    and crash_id in leader.crash_mon.reports)

        await wait_for(pred, timeout,
                       what="crash %s in committed table" % crash_id)

    @staticmethod
    async def _wait_clog_down_boot(c, victim: int,
                                   timeout: float = 30.0) -> None:
        """The committed cluster log must show the victim's
        marked-down entry followed by its boot entry (the expected
        event sequence of a kill/revive round, identical on every mon
        because both entries are paxos-committed)."""
        from ..utils.backoff import wait_for

        def pred():
            leader = c.leader()
            if leader is None:
                return False
            down_i = boot_i = -1
            for i, e in enumerate(leader.log_mon.entries):
                msg = e.get("message", "")
                if "osd.%d marked down" % victim in msg:
                    down_i = i
                elif "osd.%d boot" % victim in msg:
                    boot_i = i
            return 0 <= down_i < boot_i

        await wait_for(pred, timeout,
                       what="clog down->boot sequence for osd.%d"
                            % victim)

    @staticmethod
    async def _wait_health_check(c, check: str, present: bool,
                                 timeout: float = 30.0) -> None:
        """Poll the leading monitor's health checks until `check` is
        (or is no longer) raised."""
        from ..utils.backoff import wait_for

        def pred():
            leader = c.leader()
            if leader is None:
                return False
            return (check in leader.health_mon.checks()) == present

        await wait_for(pred, timeout,
                       what="%s %s" % (check,
                                       "raised" if present
                                       else "cleared"))

    async def _check_invariants(self, pool_ids: list,
                                workloads: list) -> None:
        c = self.cluster
        await c.wait_quorum()
        for pool_id in pool_ids:
            await c.wait_health(pool_id, timeout=120.0)
        for wl in workloads:
            await wl.verify(sample=300)
        # integrity oracle: an un-tampered healthy round deep-scrubs
        # CLEAN on every thrashed pool (recheck confirms away the
        # still-running workload's in-flight writes) — any residual
        # inconsistency is silent rot some action just manufactured
        if self.scrub_oracle and hasattr(c, "scrub_pool"):
            for pool_id in pool_ids:
                res = await c.scrub_pool(pool_id, deep=True,
                                         recheck=True)
                assert res["errors"] == 0, (
                    "deep scrub found inconsistencies after a "
                    "healthy round: %r" % res)
        # slow-op oracle: the cluster is healthy and every acked write
        # read back — nothing may still sit in an OSD's in-flight
        # table past the complaint threshold (a parked op whose
        # requeue edge was lost would hide here forever)
        if hasattr(c, "stuck_ops"):
            stuck = c.stuck_ops()
            assert not stuck, (
                "ops stuck past osd_op_complaint_time after the "
                "cluster went healthy: %r"
                % [(s["daemon"], s["desc"], round(s["age"], 1))
                   for s in stuck[:5]])
        # event-plane oracles: a healthy round ends with ZERO
        # un-archived crash reports in the committed table (a crash
        # round archives its own before getting here) and no
        # ERR-level clog entries — the framework reserves ERR for
        # genuinely unexplained failures, so any ERR is a bug
        leader = c.leader()
        if leader is not None and hasattr(leader, "crash_mon"):
            pending = [r.get("crash_id")
                       for r in leader.crash_mon.unarchived()]
            assert not pending, (
                "healthy round ended with un-archived crash "
                "reports: %r" % pending)
            errs = [e for e in leader.log_mon.entries
                    if e.get("level") == "ERR"]
            assert not errs, (
                "unexplained ERR-level cluster log entries after a "
                "healthy round: %r"
                % [(e.get("who"), e.get("message"))
                   for e in errs[:5]])
        # network-plane oracle: a healthy round (every fault lifted,
        # every acked write verified) must not leave a slow-ping
        # alert raised — in-process peer pings run far under the bar,
        # so a lingering OSD_SLOW_PING_TIME means the clear edge was
        # lost somewhere in the counter->beacon->paxos chain
        if leader is not None and hasattr(leader, "health_mon"):
            from ..utils.backoff import wait_for
            await wait_for(
                lambda: "OSD_SLOW_PING_TIME"
                        not in leader.health_mon.checks(),
                30.0, what="slow-ping alert cleared after a "
                           "healthy round")
        # stats-plane oracle (clusters running a mgr): the PGMap
        # digest — OSD stat rows -> mgr -> mon, never internal state —
        # must drain its degraded + misplaced counts to EXACTLY zero
        # once healthy, and a drain that was visibly degraded for
        # several samples must have shown a nonzero recovery rate
        # (data moved; the stats plane saw it move)
        # tenant SLO oracle: every round that ran with tenants must
        # end alert-free for the victims — a bully capped at its
        # limit is not a violation, a victim still burning after the
        # cluster healed is (the direction-1 QoS contract, asserted
        # from the committed health surface, not internal state)
        if getattr(c, "mgr", None) is not None:
            await self._slo_oracle(c)
        if getattr(c, "mgr", None) is not None \
                and hasattr(c, "wait_degraded_drained"):
            obs = await c.wait_degraded_drained(timeout=120.0)
            assert (c.degraded_objects() or 0) == 0, obs
            if obs["samples_degraded"] >= 3 \
                    and obs["max_recovery_rate"] <= 0.0:
                # the rate window can trail the drain by one report
                # period: give it a beat before calling it a miss
                for _ in range(30):
                    if c.recovery_rate() > 0.0:
                        break
                    await asyncio.sleep(0.1)
                else:
                    raise AssertionError(
                        "degraded objects drained but the stats "
                        "plane never showed a recovery rate: %r"
                        % obs)
