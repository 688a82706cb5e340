"""The services (RBD, CephFS, RGW) over the port's cluster on the CPU:
the same calls through ceph_tpu's LocalCluster and through the port's
LocalCluster(device="cpu") return the same reads and leave the same
RADOS objects (names, bytes and omap) in every pool.  The services
stamp mtimes and upload ids from the clock, so both runs read one
deterministic clock."""

import asyncio
import importlib
import itertools

import numpy as np
import torch

torch.set_num_threads(1)

POOLS = ("rbd", "fs", "rgw")       # replicated, as the services' tests


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


class _Clock:
    """A stand-in for the services' `time` module: time() counts up."""

    def __init__(self):
        self._n = itertools.count()

    def time(self) -> float:
        return 1_000_000.0 + next(self._n)


def _mods(pkg: str) -> dict:
    return {name: importlib.import_module("%s.%s" % (pkg, name))
            for name in ("testing", "services.rbd", "services.fs",
                         "services.rgw", "client.striper")}


async def _scenario(pkg: str, cluster_kw: dict) -> tuple[list, dict]:
    """One smoke round a service; returns (every read, every RADOS
    object of the three pools as {pool: {name: (bytes, omap)}})."""
    m = _mods(pkg)
    rng = np.random.default_rng(4)
    c = await m["testing"].LocalCluster(n_osds=3, **cluster_kw).start()
    reads: list = []
    try:
        for name in POOLS:
            pid = await c.create_pool(name, pg_num=8, size=3)
            await c.wait_health(pid)
        # RBD: an image across object boundaries, a snapshot, its
        # rollback and a copy-on-write clone
        rbd_mod = m["services.rbd"]
        rbd = rbd_mod.RBD(c.client.io_ctx("rbd"))
        layout = m["client.striper"].FileLayout(
            stripe_unit=4096, stripe_count=2, object_size=16384)
        await rbd.create("disk0", 1 << 18, layout)
        img = await rbd.open("disk0")
        blob = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
        await img.write(12345, blob)
        await img.snap_create("s1")
        await img.write(16000, b"Q" * 40000)
        reads.append(await img.read(0, 1 << 18))
        img.set_snap("s1")
        reads.append(await img.read(0, 1 << 18))
        img.set_snap(None)
        await img.snap_rollback("s1")
        reads.append(await img.read(0, 1 << 18))
        await rbd.clone("disk0", "s1", "vm1")
        clone = await rbd.open("vm1")
        await clone.write(100, b"CLONE-WRITE")
        reads.append(await clone.read(0, 1 << 17))
        reads.append(sorted(await rbd.list()))
        # CephFS: a small tree, a file across object boundaries
        fs_mod = m["services.fs"]
        fs = fs_mod.CephFS(c.client.io_ctx("fs"), layout=layout)
        await fs.mkfs()
        await fs.mkdir("/home")
        await fs.mkdir("/home/user")
        f = await fs.create("/home/user/notes.txt")
        await f.pwrite(0, b"hello filesystem\n")
        await f.pwrite(40000, blob[:30000])
        g = await fs.open("/home/user/notes.txt")
        reads.append(await g.pread(0, 70000))
        reads.append((await fs.stat("/home/user/notes.txt"))["size"])
        reads.append(sorted(await fs.readdir("/home/user")))
        # RGW: bucket put/get and a multipart upload
        rgw_mod = m["services.rgw"]
        rgw = rgw_mod.RGW(c.client.io_ctx("rgw"))
        await rgw.create_bucket("photos")
        etag = await rgw.put_object("photos", "2026/cat.jpg",
                                    b"meow" * 1000)
        reads.append(etag)
        big = bytes(range(256)) * 2048          # 512 KiB
        await rgw.put_object("photos", "big.bin", big)
        reads.append(await rgw.get_object("photos", "big.bin"))
        uid = await rgw.initiate_multipart("photos", "db.dump")
        for n, part in enumerate((b"A" * 100000, b"B" * 50000,
                                  b"C" * 7), 1):
            await rgw.upload_part("photos", "db.dump", uid, n, part)
        reads.append(await rgw.complete_multipart("photos", "db.dump",
                                                  uid, [1, 2, 3]))
        reads.append(await rgw.get_object("photos", "db.dump"))
        reads.append([e["key"] for e in
                      (await rgw.list_objects("photos"))["entries"]])
        objects: dict = {}
        for name in POOLS:
            io = c.client.io_ctx(name)
            pid = next(p.id for p in c.client.osdmap.pools.values()
                       if p.name == name)
            objects[name] = {
                oid: (await io.read(oid), await io.omap_get(oid))
                for oid in sorted(await c.client.list_objects(pid))}
        return reads, objects
    finally:
        await c.stop()


def _with_clock(monkeypatch, pkg: str) -> None:
    clock = _Clock()
    for name in ("services.fs", "services.rgw"):
        monkeypatch.setattr(importlib.import_module(
            "%s.%s" % (pkg, name)), "time", clock)


def test_services_objects_and_reads_match_reference(monkeypatch):
    _with_clock(monkeypatch, "ceph_tpu")
    ref_reads, ref_objects = run(_scenario("ceph_tpu", {}))
    _with_clock(monkeypatch, "ceph_tpu_torch")
    reads, objects = run(_scenario("ceph_tpu_torch", {"device": "cpu"}))
    assert reads == ref_reads
    assert sorted(objects) == sorted(ref_objects)
    for pool in POOLS:
        assert sorted(objects[pool]) == sorted(ref_objects[pool]), pool
        for oid, got in objects[pool].items():
            assert got == ref_objects[pool][oid], (pool, oid)
    # every service left objects, and the reads saw the writes
    assert all(objects[p] for p in POOLS)
    assert reads[-1] == ["2026/cat.jpg", "big.bin", "db.dump"]
    assert reads[-2] == b"A" * 100000 + b"B" * 50000 + b"C" * 7

