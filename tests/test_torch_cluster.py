"""The port's RADOS cluster on the CPU: the same client workload through
ceph_tpu's LocalCluster and ceph_tpu_torch's LocalCluster(device="cpu")
leaves the same shard bytes and hinfo in every MemStore; degraded reads
and recovery on the port rebuild the host codec's shards; the device
planes (tlz compression, dedup, the deep-scrub digest) serve through
the OSD.  On the CPU the codecs run K1/K2/K3's plain versions."""

import asyncio
import zlib

import numpy as np
import torch

from ceph_tpu_torch.ec import new_codec
from ceph_tpu_torch.osd.ecbackend import (HINFO_XATTR, SHARD_XATTR,
                                          hinfo_bytes)
from ceph_tpu_torch.store.objectstore import (NOSNAP, Transaction,
                                              hobject_t)
from ceph_tpu_torch.testing import LocalCluster
from ceph_tpu_torch.utils.backoff import wait_for

torch.set_num_threads(1)

# the three kernels' routes: K1 (w=8 matrix), K2 (w=16), K3 (bitmatrix)
PROFILES = {
    "rs21": {"plugin": "jerasure", "technique": "reed_sol_van",
             "k": "2", "m": "1"},
    "rs22w16": {"plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "2", "w": "16"},
    "cg22": {"plugin": "jerasure", "technique": "cauchy_good",
             "k": "2", "m": "2"},
}
SIZES = (1, 4097, 65539, 300 * 1024)
CONF = {"osd_ec_subop_timeout": 1.0}


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


def _payload(name: str, i: int, n: int) -> bytes:
    rng = np.random.default_rng(zlib.crc32(b"%s/%d" % (name.encode(), i)))
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _shards(c) -> dict:
    """{(pool name, oid, shard index): (shard bytes, hinfo)} over every
    live OSD's MemStore (head objects of EC pools)."""
    out = {}
    for osd in c.live_osds:
        pools = osd.osdmap.pools
        for pg in osd.pgs.values():
            pool = pools.get(pg.pool_id)
            if pool is None or not pool.is_erasure():
                continue
            for ho in osd.store.collection_list(pg.cid):
                if ho.name.startswith("__") or ho.snap != NOSNAP:
                    continue
                attrs = osd.store.getattrs(pg.cid, ho)
                if SHARD_XATTR not in attrs:
                    continue
                key = (pool.name, ho.name, int(attrs[SHARD_XATTR]))
                val = (bytes(osd.store.read(pg.cid, ho)),
                       bytes(attrs.get(HINFO_XATTR) or b""))
                assert out.setdefault(key, val) == val, key
    return out


async def _ec_pool(c, name: str, pg_num: int = 8) -> int:
    await c.client.mon_command("osd erasure-code-profile set", name=name,
                               profile=PROFILES[name])
    pid = await c.create_pool(name, pg_num=pg_num, pool_type="erasure",
                              erasure_code_profile=name)
    await c.wait_health(pid)
    return pid


async def _parity_workload(c) -> tuple[dict, dict]:
    results = {}
    for name in PROFILES:
        await _ec_pool(c, name)
        io = c.client.io_ctx(name)
        for i, n in enumerate(SIZES):
            await io.write_full("o%d" % i, _payload(name, i, n))
        try:
            await io.write("o3", _payload(name, 99, 5000), offset=70001)
            results[(name, "partial")] = 0
        except Exception as e:      # either package's RadosError
            results[(name, "partial")] = e.code
        for i in range(len(SIZES)):
            results[(name, "o%d" % i)] = await io.read("o%d" % i)
        results[(name, "range")] = await io.read("o3", length=9000,
                                                  offset=66000)
    return results, _shards(c)


def test_cluster_parity_with_reference():
    """The same workload through the reference's cluster and the port's
    (device="cpu"): identical shard bytes and hinfo for every (pool,
    object, shard), identical reads and partial-write outcomes."""
    from ceph_tpu.testing import LocalCluster as RefCluster

    async def one(make):
        c = await make().start()
        try:
            return await _parity_workload(c)
        finally:
            await c.stop()

    ref_reads, ref_shards = run(one(lambda: RefCluster(n_osds=4,
                                                       conf=CONF)))
    reads, shards = run(one(lambda: LocalCluster(n_osds=4, conf=CONF,
                                                 device="cpu")))
    assert reads.keys() == ref_reads.keys()
    for key in ref_reads:
        assert reads[key] == ref_reads[key], key
    # every object has all k+m shards, each equal to the reference's
    assert len(ref_shards) == sum(
        len(SIZES) * (int(p["k"]) + int(p["m"])) for p in PROFILES.values())
    assert shards.keys() == ref_shards.keys()
    for key in ref_shards:
        assert shards[key] == ref_shards[key], key
    # the delta path ran where the codec has a plain matrix form
    assert reads[("rs21", "partial")] == 0
    assert reads[("rs22w16", "partial")] == 0
    patched = bytearray(_payload("rs21", 3, SIZES[3]))
    patched[70001:75001] = _payload("rs21", 99, 5000)
    assert reads[("rs21", "o3")] == bytes(patched)


def test_degraded_read_and_recovery_match_the_host_codec():
    """k=2,m=1 on four OSDs: kill one non-primary shard holder; reads
    are exact while it is down-but-in and after auto-out; recovery
    rebuilds its shards on the new member equal to the host codec's
    encode, and no acked write is lost."""
    name = "rs21"
    codec = new_codec(PROFILES[name], device="cpu")

    async def main():
        c = await LocalCluster(n_osds=4, conf=CONF, device="cpu").start()
        try:
            pid = await _ec_pool(c, name)
            io = c.client.io_ctx(name)
            acked = {}
            for i in range(8):
                oid = "d%d" % i
                acked[oid] = _payload("deg", i, 3000 + 40000 * i)
                await io.write_full(oid, acked[oid])
            m = c.client.osdmap
            pgid = m.pools[pid].raw_pg_to_pg(
                m.object_locator_to_pg("d0", pid))
            _up, _upp, acting, primary = m.pg_to_up_acting_osds(pgid)
            victim = next(o for o in acting if o != primary)
            await c.kill_osd(victim)
            await c.wait_osd_down(victim)
            for oid, data in acked.items():
                assert await asyncio.wait_for(io.read(oid), 30) == data
            await wait_for(lambda: not c.client.osdmap.is_in(victim), 30,
                           what="auto-out")
            await c.wait_health(pid, timeout=60)
            for oid, data in acked.items():
                assert await io.read(oid) == data
            shards = _shards(c)
            for oid, data in acked.items():
                enc = codec.encode(set(range(3)), data)
                for j in range(3):
                    assert shards[(name, oid, j)] == (
                        enc[j], hinfo_bytes(enc)), (oid, j)
            moved = sum(o.ec.repair_traffic.get("jerasure", {})
                        .get("objects", 0) for o in c.live_osds)
            assert moved >= 1
        finally:
            await c.stop()

    run(main())


def _corrupt(osd, pg, oid: str) -> None:
    ho = hobject_t(oid)
    data = bytearray(osd.store.read(pg.cid, ho))
    data[3] ^= 0xFF
    t = Transaction()
    t.write(pg.cid, ho, 0, len(data), bytes(data))
    osd.store.apply_transaction(t)


def test_planes_through_the_daemon():
    """One boot: a tlz pool's write_full/read round trip (its blobs
    planned on the device), a dedup pool's write and read, and a deep
    scrub of an EC pool — clean, then one corrupted shard found."""

    async def main():
        c = await LocalCluster(n_osds=3, conf=CONF, device="cpu").start()
        try:
            tid = await c.create_pool("tlzp", pg_num=4, size=3)
            for var, val in (("compression_mode", "force"),
                             ("compression_algorithm", "tlz")):
                await c.client.mon_command("osd pool set", pool="tlzp",
                                           var=var, val=val)
            bid = await c.create_pool("base", pg_num=4, size=3)
            cid = await c.create_pool("chunks", pg_num=4, size=3)
            await c.client.mon_command("osd pool set", pool="base",
                                       var="dedup_chunk_pool",
                                       val="chunks")
            await c.client.wait_for_epoch(c.leader().osdmap.epoch)
            await wait_for(
                lambda: all(getattr(o.osdmap.pools.get(bid),
                                    "dedup_chunk_pool", -1) == cid
                            for o in c.live_osds), 30,
                what="dedup binding on every OSD")
            for pid in (tid, bid, cid):
                await c.wait_health(pid)
            text = b"the quick brown fox jumps over the lazy dog " * 3000
            tio = c.client.io_ctx("tlzp")
            await tio.write_full("t0", text)
            assert await tio.read("t0") == text
            bio = c.client.io_ctx("base")
            blob = _payload("dedup", 0, 96 * 1024)
            await bio.write_full("b0", blob + blob)
            await bio.write_full("b1", blob)
            assert await bio.read("b0") == blob + blob
            assert await bio.read("b1") == blob
            dump = {}
            for o in c.live_osds:
                for k, v in o.perf.dump().items():
                    if isinstance(v, int):
                        dump[k] = dump.get(k, 0) + v
            assert dump["comp_device_blobs"] >= 1
            assert dump["dedup_chunk_device"] >= 2
            assert dump["dedup_fp_device"] >= 2
            assert dump["dedup_chunks_deduped"] >= 1

            eid = await _ec_pool(c, "rs21", pg_num=4)
            eio = c.client.io_ctx("rs21")
            await eio.write_full("e0", _payload("scrub", 0, 20000))
            res = await c.scrub_pool(eid, deep=True)
            assert res["errors"] == 0, res
            m = c.client.osdmap
            pgid = m.pools[eid].raw_pg_to_pg(
                m.object_locator_to_pg("e0", eid))
            _up, _upp, acting, primary = m.pg_to_up_acting_osds(pgid)
            bad = next(o for o in acting if o != primary)
            _corrupt(c.osds[bad], c.osds[bad].pgs[pgid], "e0")
            res = await c.scrub_pool(eid, deep=True)
            assert res["errors"] == 1 and res["inconsistent"] == ["e0"]
            digests = sum(o.perf.dump()["scrub_digest_device"]
                          for o in c.live_osds)
            assert digests > 0
        finally:
            await c.stop()

    run(main())
