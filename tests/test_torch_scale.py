"""The port's scale plane on the CPU: a 20-shell ScaleCluster boots,
maps a 256-PG pool through MapCache's bulk pass, drains the misplaced
objects of a mark-out and runs a balancer tick; MapCache's primary
grouping equals the reference's on the same map (upmaps included); a
chip lost during a rebuild keeps the previous grouping and counts it,
and the next call after the heal rebuilds; any other failure of the
rebuild reaches the caller."""

import asyncio
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from ceph_tpu.osd.osdmap import OSDMap as RefOSDMap
from ceph_tpu.scale.shell import MapCache as RefMapCache
from ceph_tpu_torch.device.runtime import (K_CLIENT_EC, K_MAPPING,
                                           DeviceBusy, DeviceRuntime)
from ceph_tpu_torch.ops.crush.device import DeviceMapper
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.scale import MapCache, ScaleCluster
from ceph_tpu_torch.utils.backoff import wait_for

torch.set_num_threads(1)

QUIET = {"log_level": 0}


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


@pytest.fixture(scope="module")
def scale_run():
    """One ScaleCluster(20) run: boot, a 256-PG pool, 10 % marked out,
    the misplaced drain and one balancer tick.  Returns what the run
    observed and the final map."""

    async def main():
        c = await ScaleCluster(20, conf=QUIET, device="cpu").start()
        try:
            mon = c.mons[0]
            up = sum(1 for o in range(mon.osdmap.max_osd)
                     if mon.osdmap.is_up(o))
            await c.create_pool("scale", pg_num=256)
            await c.wait_epoch_converged(c.leader().osdmap.epoch,
                                         timeout=30.0)
            await wait_for(
                lambda: (c.digest() or {}).get("num_pgs") == 256,
                30.0, what="digest carrying all 256 shell PGs")
            victims = await c.mark_out_fraction(0.1)
            await c.wait_epoch_converged(c.leader().osdmap.epoch,
                                         timeout=30.0)
            drain = await c.wait_misplaced_drained(timeout=60.0)
            tick = await c.mgr.balancer_tick()
            await c.wait_epoch_converged(c.leader().osdmap.epoch,
                                         timeout=30.0)
            m = c.leader().osdmap
            return {"up": up, "victims": victims, "drain": drain,
                    "tick": tick, "misplaced": c.misplaced_objects(),
                    "builds": c.mapcache.builds,
                    "host_builds": c.mapcache.host_builds,
                    "deferred": c.mapcache.deferred_builds,
                    "map": m.to_dict(),
                    "upmaps": len(m.pg_upmap_items)}
        finally:
            await c.stop()

    return run(main())


def test_scale_cluster_smoke(scale_run):
    r = scale_run
    assert r["up"] == 20
    assert len(r["victims"]) == 2
    assert r["drain"]["max_misplaced"] > 0
    assert r["misplaced"] == 0
    assert r["tick"]["candidates_scored"] >= 20
    assert r["tick"]["stddev_after"] <= r["tick"]["stddev_before"]
    # every grouping went through the bulk mapper, none deferred
    assert r["builds"] >= 2
    assert (r["host_builds"], r["deferred"]) == (0, 0)


def test_mapcache_grouping_matches_reference(scale_run):
    """The final map (host-grouped CRUSH, 10 % out, the tick's upmap
    items) grouped by the port and by ceph_tpu: identical lists."""
    assert scale_run["upmaps"] > 0
    m = OSDMap.from_dict(scale_run["map"])
    ours = MapCache(device="cpu").primaries_for(m)
    ref = RefMapCache().primaries_for(
        RefOSDMap.from_dict(scale_run["map"]))
    assert ours == ref
    assert sum(len(v) for v in ours.values()) == 256


def _map(epoch_bump: int = 0) -> OSDMap:
    from ceph_tpu_torch.cli.osdmaptool import create_simple
    m = create_simple(12, pg_num=64)
    for _ in range(epoch_bump):
        inc = m.new_incremental()
        inc.new_weight[epoch_bump] = 0x8000
        m.apply_incremental(inc)
    return m


def test_rebuild_on_a_lost_chip_keeps_the_grouping_until_the_heal():
    """A fault injected into the rebuild's launch (in the executor
    thread) loses the chip: the caller gets the previous epoch's
    grouping, the case is counted, the probe started on the loop heals
    the chip once the fault clears, and the next call rebuilds."""

    async def main():
        rt = DeviceRuntime.reset(chips=2, device="cpu")
        rt.configure({"device_max_inflight": 2, "device_queue_len": 64,
                      "device_probe_interval": 0.04})
        mc = MapCache(device="cpu")
        m1, m2 = _map(), _map(1)
        g1 = await mc.primaries_async(m1)
        assert mc.builds == 1 and g1
        chip = rt.chips[0]
        chip.inject_fault(1 << 30)
        stale = await mc.primaries_async(m2)
        assert stale is g1
        assert mc.deferred_builds == 1 and mc.builds == 1
        assert chip.lost and chip.loss_count == 1
        # the queue slot of the failed pass was given back
        assert chip.queue.inflight == 0
        chip.clear_faults()
        await wait_for(lambda: not chip.lost, 5.0, what="chip heal")
        assert chip.heal_count == 1
        g2 = await mc.primaries_async(m2)
        assert mc.builds == 2 and mc.deferred_builds == 1
        assert g2 == MapCache(device="cpu").primaries_for(m2)
        assert g2 != g1

    run(main())


def test_other_rebuild_failures_reach_the_caller(monkeypatch):
    """A plain error of the rebuild is raised to the awaiting caller,
    never swallowed into a stale grouping; the next call rebuilds."""

    async def main():
        DeviceRuntime.reset(device="cpu")
        mc = MapCache(device="cpu")
        m1, m2 = _map(), _map(1)
        g1 = await mc.primaries_async(m1)
        real = DeviceMapper.map_pool_batch

        def broken(*a, **kw):
            raise ValueError("planted rebuild failure")

        monkeypatch.setattr(DeviceMapper, "map_pool_batch", broken)
        with pytest.raises(ValueError, match="planted rebuild failure"):
            await mc.primaries_async(m2)
        assert mc.deferred_builds == 0
        assert mc._primaries[0] == m1.epoch
        monkeypatch.setattr(DeviceMapper, "map_pool_batch", real)
        g2 = await mc.primaries_async(m2)
        assert g2 != g1 and mc._primaries[0] == m2.epoch

    run(main())


def test_ticket_bookkeeping_is_safe_from_executor_threads():
    """Eight threads admit, launch and finish mapping-class tickets
    with try_admit while eight coroutines on the loop admit client
    tickets on the same chip (parking when it is full), under a short
    switch interval and asyncio's debug mode (which refuses a waiter's
    future being resolved off its loop): every parked coroutine is
    granted, every slot comes back and no dispatch or sequence number
    is lost."""
    per = 150

    def worker(chip):
        ok = 0
        for _ in range(per):
            t = chip.open_ticket(K_MAPPING, 512, 4)
            try:
                chip.try_admit(t)
            except DeviceBusy:
                continue
            chip.launch(t)
            time.sleep(0.0002)      # hold the slot: coroutines park
            chip.finish(t, ok=True)
            ok += 1
        return ok

    async def loop_side(chip):
        for _ in range(per):
            t = chip.open_ticket(K_CLIENT_EC, 512, 4)
            await chip.admit(t)
            chip.launch(t)
            await asyncio.sleep(0)
            chip.finish(t, ok=True)

    async def main():
        rt = DeviceRuntime.reset(chips=1, device="cpu")
        chip = rt.chips[0]
        chip.queue.max_inflight = 3
        loop = asyncio.get_running_loop()
        loop.set_debug(True)
        loop.slow_callback_duration = 10.0
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with ThreadPoolExecutor(8) as pool:
                futs = [loop.run_in_executor(pool, worker, chip)
                        for _ in range(8)]
                await asyncio.gather(*[loop_side(chip)
                                       for _ in range(8)])
                ok = sum(await asyncio.gather(*futs))
        finally:
            sys.setswitchinterval(old)
        assert chip.queue.inflight == 0 and not chip.queue._waiters
        assert chip.dispatches == ok + 8 * per
        assert rt._seq == 16 * per
        assert not chip.lost

    run(main(), timeout=60)
