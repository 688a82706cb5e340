"""vstart: a one-command dev cluster (mons + N osds) in one process.

Analog of src/vstart.sh for this framework, layered on the shared
``ceph_tpu_torch.testing.LocalCluster`` harness: boots the monitor
quorum and N MemStore OSDs on loopback TCP, every OSD bound to a chip
of ``--device`` (default: the card), optionally creates pools, then
runs a put/get smoke workload, a seeded thrash run (the teuthology
thrasher analog), or stays up serving until interrupted.

    python -m ceph_tpu_torch.cli.vstart --osds 3 --smoke
    python -m ceph_tpu_torch.cli.vstart --osds 3 --smoke --device cpu
    python -m ceph_tpu_torch.cli.vstart --osds 3 --pool data --serve
    python -m ceph_tpu_torch.cli.vstart --osds 3 --mons 3 \\
        --thrash 5 --seed 42
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from ..testing.cluster import LocalCluster


async def run(args) -> int:
    cluster = LocalCluster(n_osds=args.osds, n_mons=args.mons,
                           seed=args.seed, device=args.device)
    await cluster.start()
    for mon in cluster.mons:
        print("%s at %s" % (mon.name, mon.addr))
    for osd in cluster.osds:
        print("osd.%d at %s" % (osd.whoami, osd.msgr.addr))
    client = cluster.client
    print("cluster up at epoch %d" % client.osdmap.epoch)

    exporter = None
    if args.exporter_port:
        from ..utils.exporter import cluster_exporter

        mon0 = cluster.mons[0]
        exporter = cluster_exporter(mon0.ctx, mon0,
                                    device=cluster.device)
        eaddr = await exporter.start("127.0.0.1", args.exporter_port)
        print("prometheus exporter at http://%s/metrics" % eaddr)

    for name in args.pool or []:
        pid = await cluster.create_pool(name, pg_num=args.pg_num)
        print("pool %s id=%d" % (name, pid))

    rc = 0
    if args.smoke:
        pid = await cluster.create_pool("smoke", pg_num=8)
        io = client.io_ctx("smoke")
        payload = b"vstart smoke payload " * 64
        for i in range(16):
            await io.write_full("obj-%d" % i, payload + b"%d" % i)
        bad = 0
        for i in range(16):
            got = await io.read("obj-%d" % i)
            if got != payload + b"%d" % i:
                bad += 1
        status = await client.mon_command("status")
        print("smoke: 16 objects written+read, %d mismatches; "
              "status=%s" % (bad, status))
        rc = 1 if bad else 0
    elif args.thrash:
        from ..testing.thrasher import ClusterThrasher, Workload

        pid = await cluster.create_pool("thrash", pg_num=8)
        await cluster.wait_health(pid)
        wl = Workload(client.io_ctx("thrash"),
                      seed=args.seed or 0).start()
        thrasher = ClusterThrasher(cluster, seed=args.seed or 0,
                                   rounds=args.thrash)
        print("thrash plan (seed=%s): %s"
              % (args.seed, thrasher.plan))
        try:
            await thrasher.run(pid, wl)
            print("thrash: %d rounds clean, %d acked writes intact"
                  % (args.thrash, len(wl.acked)))
        except Exception as e:
            # self-reporting failure: the full diagnostics bundle
            # (per-daemon perf/ops/ring tails, mon health/log/crash
            # state, pgmap digest, merged op timelines) lands in a
            # temp file — the artifact to attach to the bug
            import json
            import os
            import tempfile

            fd, path = tempfile.mkstemp(prefix="ceph_tpu_diag_",
                                        suffix=".json")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(cluster.collect_diagnostics(), f,
                              indent=2, default=str, sort_keys=True)
            except Exception as de:
                path = "(diagnostics collection failed: %r)" % de
            # the flight-recorder timeline rides beside the bundle:
            # the Perfetto-openable artifact showing WHERE the failed
            # round's time went (queue wait vs device vs sub-op RTT)
            tfd, tpath = tempfile.mkstemp(
                prefix="ceph_tpu_diag_", suffix="_trace.json")
            os.close(tfd)
            try:
                cluster.export_trace(path=tpath)
            except Exception as te:
                tpath = "(trace export failed: %r)" % te
            print("thrash FAILED (replay with --seed %s): %s\n"
                  "diagnostics bundle: %s\n"
                  "flight-recorder trace (open in Perfetto): %s"
                  % (args.seed, e, path, tpath))
            rc = 1
        finally:
            await wl.stop()
    elif args.serve:
        print("serving; ctrl-c to stop")
        try:
            while True:
                await asyncio.sleep(3600)
        except (KeyboardInterrupt, asyncio.CancelledError):
            pass

    if exporter is not None:
        await exporter.stop()
    await cluster.stop()
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vstart")
    p.add_argument("--osds", type=int, default=3)
    p.add_argument("--mons", type=int, default=1)
    p.add_argument("--pool", action="append")
    p.add_argument("--pg-num", type=int, default=32)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--serve", action="store_true")
    p.add_argument("--thrash", type=int, default=0, metavar="ROUNDS",
                   help="run ROUNDS of seeded cluster thrashing "
                        "under a live workload")
    p.add_argument("--seed", type=int, default=None,
                   help="deterministic seed for fault injection / "
                        "thrash scheduling")
    p.add_argument("--device", default=None,
                   help="device every OSD's chip runs on (default: "
                        "the card; 'cpu' runs the kernels' plain "
                        "versions)")
    p.add_argument("--exporter-port", type=int, default=0,
                   help="serve Prometheus metrics on this port")
    args = p.parse_args(argv)
    return asyncio.run(run(args))


if __name__ == "__main__":
    sys.exit(main())
