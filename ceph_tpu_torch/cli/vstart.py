"""vstart: a one-command dev cluster (mons + N osds) in one process.

Analog of src/vstart.sh for this framework, layered on the shared
``ceph_tpu_torch.testing.LocalCluster`` harness: boots the monitor
quorum and N MemStore OSDs on loopback TCP, every OSD bound to a chip
of ``--device`` (default: the card), optionally creates pools, then
runs a put/get smoke workload or stays up serving until interrupted.

    python -m ceph_tpu_torch.cli.vstart --osds 3 --smoke
    python -m ceph_tpu_torch.cli.vstart --osds 3 --smoke --device cpu
    python -m ceph_tpu_torch.cli.vstart --osds 3 --pool data --serve
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
    p.add_argument("--seed", type=int, default=None,
                   help="deterministic seed for fault injection")
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
