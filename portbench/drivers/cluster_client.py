"""Client ops against a RADOS cluster of the port, served on the card.

Set-up boots `testing.LocalCluster` (mon, mgr and the configuration's
MemStore OSDs in this process, every daemon on one chip), creates the
erasure-code profile and pool, waits until every PG is active+clean,
prefills the objects the mix overwrites and sends a warm-up of the
mix's own ops.  The window is a closed loop of the mix's clients over
the `client/rados.py` IoCtx (`traffic.ClosedLoop`).

Once the window has closed and the card's memory peak is read, the
check judges what the cluster stores: a seeded sample of the objects
(every object of a mix of few) is read back through the client and
compared byte for byte with what the acknowledged writes put there, and
every shard of each sampled object is read from its OSD's store and
compared with the plain Reed-Solomon encode (`reference/gf256_rs.py`)
of that content.  Both counts must be 0: a write is acknowledged once
every shard of it has committed, and it reads back as written.  So must
the count of the window's ops that failed: every OSD stays up, so none
may fail, and an op that fails fast would otherwise shorten the tail.
"""

from __future__ import annotations

import asyncio
import time

from portbench import common
from portbench.reference import gf256_rs
from portbench.traffic import ClosedLoop, ObjectImage, rng_for

HISTORY = 1 << 20       # OpTracker records kept a daemon in a traced run
TICKETS = 1 << 20       # dispatch tickets kept a chip in a traced run


def run(run: common.Run, device, start: float) -> None:
    asyncio.run(_run(run, device, start))


async def _bounded(coros, limit: int) -> list:
    sem = asyncio.Semaphore(limit)

    async def one(c):
        async with sem:
            return await c

    return await asyncio.gather(*[one(c) for c in coros])


def _profile(cfg: dict) -> tuple[int, int]:
    prof = cfg["profile"]
    return int(prof["k"]), int(prof["m"])


async def _run(run: common.Run, device, start: float) -> None:
    from ceph_tpu_torch.device import runtime as rtmod
    from ceph_tpu_torch.testing import LocalCluster
    cfg, cell = run.config, run.cell
    conf = dict(cfg["conf"])
    if run.traced:
        # keep every op and ticket of the window for the readers
        conf["osd_op_history_size"] = HISTORY
        rtmod._TICKET_RING = TICKETS
    cluster = LocalCluster(n_osds=int(cfg["osds"]), with_mgr=True,
                           device=device, device_chips=int(cfg["chips"]),
                           conf=conf)
    await cluster.start()
    try:
        await _serve(run, cluster, device, start)
    finally:
        await cluster.stop()


async def _serve(run: common.Run, cluster, device, start: float) -> None:
    import torch
    from ceph_tpu_torch.device.runtime import DeviceRuntime
    cfg, cell = run.config, run.cell
    spec = cell["ops"]
    if int(spec["objects"]) > int(cfg["max_objects"]):
        raise ValueError("the mix writes more objects than the "
                         "configuration's max_objects")
    if int(spec["clients"]) > int(cfg["ops_in_flight"]):
        raise ValueError("the mix keeps more ops in flight than the "
                         "configuration's ops_in_flight")
    name = cfg["pool"]
    await cluster.client.mon_command("osd erasure-code-profile set",
                                     name=name, profile=cfg["profile"])
    pool_id = await cluster.create_pool(
        name, pg_num=int(cfg["pg_num"]), pool_type="erasure",
        erasure_code_profile=name)
    await cluster.wait_health(pool_id, timeout=600)
    io = cluster.client.io_ctx(name)
    image = ObjectImage(run.seed, int(spec["object_bytes"]))
    loop = ClosedLoop(io, spec, run.seed, image,
                      spans=run.spans if run.traced else None)
    if spec["kind"] != "write_full":
        # the objects the overwrites land in, written whole first
        async def put(i, oid):
            data = image.whole(oid, i % len(image.bases), -1 - i)
            await io.write_full(oid, data)
            image.acked_whole(oid, i % len(image.bases), -1 - i)
        await _bounded([put(i, o) for i, o in
                        enumerate(loop.names)], loop.clients)
    warm = float(cell.get("warmup_s", 5.0))
    await loop.run_until(time.monotonic() + warm)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rt = DeviceRuntime.get(device)
    with run.measuring():
        t0 = time.monotonic()
        run.setup_s = time.perf_counter() - start
        deadline = t0 + run.seconds
        ops = await loop.run_until(deadline)
        t1 = time.monotonic()
    run.window = (t0, deadline)
    run.ops = ops
    run.attempted = len(ops)
    run.failed = sum(1 for o in ops if not o["ok"])
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    k, m = _profile(cfg)
    cs = gf256_rs.chunk_size(int(spec["object_bytes"]), k)
    if spec["kind"] == "write_full":
        run.encode_bytes = (k + m) * cs * sum(
            1 for o in ops if o["ok"] and o["t1"] <= deadline)
    if run.traced:
        _collect(run, cluster, rt, t0, max(t1, deadline))
    await _check(run, cluster, io, pool_id, image, loop.clients)


def _collect(run, cluster, rt, lo: float, hi: float) -> None:
    """OpTracker records and dispatch tickets of the window."""
    for osd in cluster.live_osds:
        for op in osd.optracker.historic:
            if lo <= op.initiated <= hi:
                run.tracked.append({"desc": op.desc,
                                    "events": list(op.events)})
    for chip in rt.chips:
        for t in chip.tickets:
            if t.ok and lo <= t.t_done <= hi:
                run.tickets.append({"klass": t.klass,
                                    "device_s": t.device_s})


def _sample(run, image: ObjectImage) -> list[str]:
    """The objects the check reads: every one of a small set, else a
    seeded sample of those the window wrote, with its last write."""
    certain = sorted(o for o in image.objects if o not in image.uncertain)
    n = int(run.cell.get("check_objects", len(certain)))
    if n >= len(certain):
        return certain
    written = sorted({o["oid"] for o in run.ops if o["ok"]}
                     - image.uncertain)
    last = [o["oid"] for o in run.ops if o["ok"]][-1:]
    rng = rng_for(run.seed, 4)
    pool = written if len(written) >= n else certain
    pick = [pool[i] for i in rng.choice(len(pool), size=n, replace=False)]
    return sorted(set(pick) | (set(last) - image.uncertain))


async def _check(run, cluster, io, pool_id, image, clients: int) -> None:
    from ceph_tpu_torch.osd.ecbackend import SHARD_XATTR
    from ceph_tpu_torch.osd.osdmap import pg_t
    from ceph_tpu_torch.store.objectstore import hobject_t
    k, m = _profile(run.config)
    oids = _sample(run, image)

    async def read(oid):
        try:
            return await io.read(oid)
        except Exception as e:      # an object that cannot be read is wrong
            return e
    got = await _bounded([read(o) for o in oids], clients)
    read_bad = sum(1 for o, g in zip(oids, got) if g != image.bytes(o))
    osdmap = cluster.client.osdmap
    osds = {o.whoami: o for o in cluster.live_osds}
    shard_bad = 0
    for oid in oids:
        await asyncio.sleep(0)      # the daemons' heartbeats go on
        want = gf256_rs.encode(image.bytes(oid), k, m)
        pg = osdmap.pools[pool_id].raw_pg_to_pg(
            osdmap.object_locator_to_pg(oid, pool_id))
        _up, _upp, acting, _p = osdmap.pg_to_up_acting_osds(pg)
        for j in range(k + m):
            osd = osds.get(acting[j]) if j < len(acting) else None
            try:
                coll = osd.pgs[pg_t(pg.pool, pg.ps)].cid
                ho = hobject_t(oid)
                same = (int(osd.store.getattrs(coll, ho)[SHARD_XATTR]) == j
                        and bytes(osd.store.read(coll, ho)) == want[j])
            except Exception:   # a missing shard, PG or OSD is a mismatch
                same = False
            shard_bad += not same
    if not oids:
        raise RuntimeError("no acknowledged object to check")
    run.add_check("ops_failed", run.failed, 0)
    run.add_check("objects_read_wrong", read_bad, 0)
    run.add_check("shards_wrong", shard_bad, 0)
