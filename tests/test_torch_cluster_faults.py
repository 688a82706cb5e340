"""Chip loss and map handling in the port's cluster on the CPU: a lost
chip fails its OSDs' device ops with -5 (no host route, no widening of
a degraded read), the mon raises DEVICE_LOST naming the chip and clears
it after the heal; a pool set of 256 PGs or more maps through
OSDMapMapping, and an epoch that lands while an OSD's chip is lost
waits for the heal instead of taking the host engine."""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.device.runtime import DeviceRuntime
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.osd.osdmap import pg_t
from ceph_tpu_torch.testing import LocalCluster
from ceph_tpu_torch.utils.backoff import wait_for

torch.set_num_threads(1)

# a generous heartbeat grace: the harness maps a 256-PG pool with the
# host engine once an epoch, which blocks the loop on a loaded worker
CONF = {"osd_ec_subop_timeout": 1.0, "device_probe_interval": 0.04,
        "heartbeat_grace": 3.0}
PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
           "k": "2", "m": "2"}


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


def _acting(c, pid, oid):
    m = c.client.osdmap
    pgid = m.pools[pid].raw_pg_to_pg(m.object_locator_to_pg(oid, pid))
    _up, _upp, acting, primary = m.pg_to_up_acting_osds(pgid)
    return pgid, acting, primary


def _checks(c) -> dict:
    return c.leader().health_mon.checks()


def test_chip_loss_fails_its_ops_without_a_host_route():
    """Two logical chips over four OSDs (osd i on chip i % 2).  While
    chip 0 is lost: EC writes whose primary binds to it get -5 and
    dispatch nothing on it, writes to chip 1's primaries are acked, a
    degraded read on chip 0 fails with -5 without widening, and the mon
    raises DEVICE_LOST naming chip 0.  After clear_faults the probe
    heals the chip, the warning clears, every acked write reads back
    and chip 1 never counted a loss."""

    async def main():
        c = await LocalCluster(n_osds=4, conf=CONF, device="cpu",
                               device_chips=2).start()
        try:
            rt = DeviceRuntime.get("cpu")
            await c.client.mon_command("osd erasure-code-profile set",
                                       name="rs22", profile=PROFILE)
            pid = await c.create_pool("rs22", pg_num=8,
                                      pool_type="erasure",
                                      erasure_code_profile="rs22")
            await c.wait_health(pid)
            io = c.client.io_ctx("rs22")
            rng = np.random.default_rng(7)
            acked = {}
            oids = ["w%d" % i for i in range(24)]
            for oid in oids[:8]:
                acked[oid] = rng.integers(0, 256, 20000,
                                          dtype=np.uint8).tobytes()
                await io.write_full(oid, acked[oid])
            lost = rt.chips[0]
            lost.inject_fault(1 << 30)      # every probe fails
            lost.poison("test: chip 0 lost")
            before = lost.dispatches
            refused = ok = 0
            for oid in oids[8:]:
                data = rng.integers(0, 256, 20000,
                                    dtype=np.uint8).tobytes()
                _pgid, _acting_set, primary = _acting(c, pid, oid)
                if primary % 2 == 0:
                    with pytest.raises(Exception) as ei:
                        await io.write_full(oid, data)
                    assert getattr(ei.value, "code", None) == -5
                    refused += 1
                else:
                    await io.write_full(oid, data)
                    acked[oid] = data
                    ok += 1
            assert refused and ok
            assert lost.dispatches == before
            # a degraded read on the lost chip: the holder of a data
            # shard is down, so the planned shard set needs a decode;
            # the device failure fails the read instead of widening to
            # the remaining member and decoding again
            victim = next(o for o in acked
                          if _acting(c, pid, o)[2] % 2 == 0)
            _pgid, acting, primary = _acting(c, pid, victim)
            holder = next(o for j, o in enumerate(acting)
                          if j < 2 and o != primary)
            await c.kill_osd(holder)
            await c.wait_osd_down(holder)
            codec = c.osds[primary].ec._codecs["rs22"]
            decodes = []
            inner = codec.decode_concat_async

            async def counted(*a, **kw):
                decodes.append(1)
                return await inner(*a, **kw)

            codec.decode_concat_async = counted
            with pytest.raises(Exception) as ei:
                await io.read(victim)
            assert getattr(ei.value, "code", None) == -5
            assert len(decodes) == 1
            assert c.osds[primary].ec.last_read_plan["widened"] is False
            await wait_for(lambda: "DEVICE_LOST" in _checks(c), 10,
                           what="DEVICE_LOST raised")
            check = _checks(c)["DEVICE_LOST"]
            assert check["chips"] == [0]
            assert all(int(d.split()[0][4:]) % 2 == 0
                       for d in check["detail"])
            lost.clear_faults()
            t0 = asyncio.get_running_loop().time()
            await wait_for(lambda: not lost.lost, 10, what="chip heal")
            assert asyncio.get_running_loop().time() - t0 < 2.0
            await wait_for(lambda: "DEVICE_LOST" not in _checks(c), 10,
                           what="DEVICE_LOST cleared")
            for oid, data in acked.items():
                assert await io.read(oid) == data, oid
            assert rt.chips[1].loss_count == 0
            assert lost.loss_count == 1 and lost.heal_count == 1
        finally:
            await c.stop()

    run(main())


def test_map_epochs_wait_for_a_lost_chip(monkeypatch):
    """Pools summing to 256 PGs map through OSDMapMapping on each OSD's
    chip, the acting sets equal the host engine's, and an epoch that
    lands while an OSD's chip is lost is consumed after the heal —
    never mapped by the host engine at 256 PGs or more."""
    calls = []
    orig = OSD._advance_pgs

    def spy(self, mapping=None):
        pgs = sum(p.pg_num for p in self.osdmap.pools.values())
        calls.append((self.whoami, self.osdmap.epoch, pgs,
                      mapping is not None))
        return orig(self, mapping)

    monkeypatch.setattr(OSD, "_advance_pgs", spy)

    async def main():
        c = await LocalCluster(n_osds=4, conf=CONF, device="cpu",
                               device_chips=2).start()
        try:
            rt = DeviceRuntime.get("cpu")
            pid = await c.create_pool("big", pg_num=256, size=3)
            await c.wait_health(pid, timeout=60)
            m = c.leader().osdmap
            assert all(o.osdmap.epoch == m.epoch for o in c.live_osds)
            for ps in range(256):
                if ps % 16 == 0:
                    await asyncio.sleep(0)  # keep the heartbeats going
                _u, _up, acting, prim = m.pg_to_up_acting_osds(
                    pg_t(pid, ps))
                for osd in c.live_osds:
                    pg = osd.pgs.get(pg_t(pid, ps))
                    assert (pg is not None) == (osd.whoami in acting)
                    if pg is not None:
                        assert (pg.acting, pg.primary) == (acting, prim)
            lost = rt.chips[0]
            lost.inject_fault(1 << 30)
            lost.poison("test: chip 0 lost")
            sid = await c.create_pool("small", pg_num=4, size=2)
            epoch = c.leader().osdmap.epoch
            on_lost = [o for o in c.live_osds if o.whoami % 2 == 0]
            await wait_for(lambda: all(o._deferred_maps
                                       for o in on_lost), 10,
                           what="epochs deferred on the lost chip")
            assert all(o.osdmap.epoch < epoch for o in on_lost)
            assert all(o.perf.dump()["map_deferred"] >= 1
                       for o in on_lost)
            lost.clear_faults()
            await wait_for(lambda: all(o.osdmap.epoch >= epoch
                                       for o in c.live_osds), 10,
                           what="every OSD at the current epoch")
            assert not any(o._deferred_maps for o in c.live_osds)
            await c.wait_health(sid, timeout=30)
            await c.wait_health(pid, timeout=30)
            big = [x for x in calls if x[2] >= 256]
            assert big and all(x[3] for x in big), big
        finally:
            await c.stop()

    run(main())
