"""The port's thrasher on the CPU: its plan is the reference's for the
same seed (with `device_fallback` named `device_loss`), and its device
rounds hold the port's chip-loss oracle — no host route: while a chip
is lost, EC writes whose primary is bound to it fail with -5 and stay
unacked, the others ack, DEVICE_LOST names exactly the lost chips, the
survivors never count a loss, the probe heals each victim once, and
every acked write reads back.  One kill/revive + mon partition round
(the reference's smoke round) runs on the port."""

import asyncio

import pytest
import torch

from ceph_tpu.testing import ClusterThrasher as RefThrasher
from ceph_tpu_torch.device.runtime import DeviceRuntime
from ceph_tpu_torch.testing import ClusterThrasher, LocalCluster, Workload

torch.set_num_threads(1)

CONF = {"osd_ec_subop_timeout": 1.0, "device_probe_interval": 0.04}


def run(coro, timeout=240):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


class Shape:
    n_osds = 5
    n_mons = 3


def _renamed(plan):
    return [("device_loss" if a == "device_fallback" else a, arg)
            for a, arg in plan]


@pytest.mark.parametrize("seed", [7, 42, 1212])
def test_plan_matches_reference(seed):
    """Seeded plans draw the rng exactly as the reference's: the
    default pool, and an explicit list naming every action (the
    renamed one included), pinned items and all (exact equality)."""
    assert (ClusterThrasher(Shape(), seed=seed, rounds=12).plan
            == RefThrasher(Shape(), seed=seed, rounds=12).plan)
    ref_actions = list(RefThrasher.ALL_ACTIONS) + [
        ("mon_partition", 2), "poison_mid_chunk",
        "corrupt_dedup_index"]
    ours = ["device_loss" if a == "device_fallback" else a
            for a in ref_actions]
    assert (ClusterThrasher(Shape(), seed=seed, actions=ours).plan
            == _renamed(RefThrasher(Shape(), seed=seed,
                                    actions=ref_actions).plan))
    assert "device_loss" in ClusterThrasher.ALL_ACTIONS
    assert "device_fallback" not in ClusterThrasher.ALL_ACTIONS


def test_chip_loss_and_device_loss_rounds():
    """Three OSDs on three logical chips, an EC 2+1 pool under a live
    workload: a chip_loss round on chip 1, then a device_loss round."""

    async def main():
        c = await LocalCluster(n_osds=3, conf=CONF, device="cpu",
                               device_chips=3, seed=4242).start()
        try:
            rt = DeviceRuntime.get("cpu")
            assert sorted(o.device_chip.index for o in c.live_osds) \
                == [0, 1, 2]
            pid = await c.create_pool("ecmesh", pg_num=8,
                                      pool_type="erasure")
            await c.wait_health(pid)
            wl = Workload(c.client.io_ctx("ecmesh"), seed=7,
                          prefix="chiploss").start()
            th = ClusterThrasher(c, seed=11, actions=[
                ("chip_loss", 1), ("device_loss", 0)])
            th.scrub_oracle = False     # one deep scrub is enough here
            await th.run(pid, wl)
            await wl.stop()
            await wl.verify()           # every acked write intact
            assert wl.acked, "workload never acked a write"
            one, every = th.device_rounds
            assert one["chips"] == [1] and every["chips"] == [0, 1, 2]
            assert one["refused"] >= 1 and one["acked"] >= 1, one
            assert every["refused"] >= 5 and every["acked"] == 0, every
            for rec in (one, every):
                assert rec["device_lost_raised"]
                assert rec["device_lost_cleared"]
            assert [ch.loss_count for ch in rt.chips] == [1, 2, 1]
            assert [ch.heal_count for ch in rt.chips] == [1, 2, 1]
            assert not any(ch.lost for ch in rt.chips)
            assert any("rados error -5" in err
                       for _oid, err in wl.write_failures)
            res = await c.scrub_pool(pid, deep=True, recheck=True)
            assert res["errors"] == 0, res
        finally:
            await c.stop()

    run(main())


def test_smoke_thrash_kill_revive_and_mon_partition():
    """The reference's tier-1 smoke round on the port: 3 rounds of OSD
    kill/revive plus one monitor partition under a live workload,
    seeded — zero acknowledged-write loss, every PG active+clean."""

    async def main():
        c = await LocalCluster(n_osds=3, n_mons=3, seed=42,
                               device="cpu").start()
        try:
            pid = await c.create_pool("data", pg_num=8, size=3)
            await c.wait_health(pid)
            wl = Workload(c.client.io_ctx("data"), seed=42).start()
            actions = ["kill_revive", "kill_revive", "kill_revive",
                       ("mon_partition", 2)]
            th = ClusterThrasher(c, seed=42, actions=actions)
            assert th.plan == ClusterThrasher(
                c, seed=42, actions=actions).plan
            assert th.plan == RefThrasher(c, seed=42,
                                          actions=actions).plan
            await th.run(pid, wl)
            await wl.stop()
            assert wl.acked, "workload never completed a write"
            await wl.verify()
            await c.wait_health(pid)
            assert c.leader() is not None
        finally:
            await c.stop()

    run(main())


def test_verify_samples_a_large_acked_set():
    """verify(sample=) over more acked writes than the sample reads the
    sample (the newest 50 among them) and finds a lost write in it;
    the reference's tuple-seeded picker raises TypeError on Python
    3.11+ once more than `sample` writes are acked."""
    reads = []

    class IO:
        def __init__(self, store):
            self.store = store

        async def read(self, oid):
            reads.append(oid)
            return self.store[oid]

    acked = {"o%d" % i: b"x%d" % i for i in range(400)}
    wl = Workload(IO(dict(acked)))
    wl.acked = dict(acked)
    run(wl.verify(sample=300))
    assert len(reads) == 300 and reads[-50:] == list(acked)[-50:]
    wl.io.store["o399"] = b"rot"
    with pytest.raises(AssertionError, match="o399"):
        run(wl.verify(sample=300))
