"""rados: object-level CLI against a live cluster.

Analog of src/tools/rados (rados put/get/ls/rm/stat/df/bench):

    python -m ceph_tpu.cli.rados -m HOST:PORT[,HOST:PORT...] \\
        -p POOL put NAME FILE | get NAME FILE | ls | rm NAME \\
        | stat NAME | df | bench SECONDS write [--size N] \\
        | mksnap SNAP | rmsnap SNAP | lssnap | report [OUT.json] \\
        | trace export [OUT.json] | netstat

    Reads honor -s/--snap SNAPNAME (rados -s, snapshot reads).
    `report` writes the one-call diagnostics bundle (status, health,
    df, osd dump, recent cluster log, crash list) as JSON.
    `trace export` drives a few probe ops and writes the client's
    flight-recorder timeline as Chrome-trace / Perfetto JSON.
    `watch-events` streams the mon's committed cluster events live
    (the `ceph -w` analog; --from N resumes a cursor).
    `perf history SERIES [LABEL]` renders the mon's downsampled
    history rows for one series (--window seconds).
    `netstat` renders the cluster heartbeat RTT matrix, the slow
    peer pairs, and per-daemon wire rates (`net status`).
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

from ..client.rados import RadosClient


async def _run(args) -> int:
    ctx = None
    if args.cmd == "trace":
        # the trace verb's probe ops must all be retained whatever
        # the production sampling default is
        from ..utils.context import Context
        ctx = Context("client.trace",
                      conf_overrides={"flight_recorder_sample": 1})
    client = RadosClient(args.mon.split(","), ctx=ctx)
    await client.connect()
    try:
        if args.cmd == "df":
            # real per-pool usage from the cluster's PGMap digest
            # (the reference's `rados df` table)
            out = await client.mon_command("df")
            cols = ("POOL_NAME", "OBJECTS", "BYTES", "DEGRADED",
                    "MISPLACED", "RD_OPS/S", "WR_OPS/S")
            fmt = "%-16s %10s %12s %9s %10s %9s %9s"
            print(fmt % cols)
            for row in out.get("pools") or []:
                print(fmt % (row["name"], row["objects"],
                             row["bytes"], row["degraded"],
                             row["misplaced"],
                             "%.1f" % row["read_ops_s"],
                             "%.1f" % row["write_ops_s"]))
            total = out.get("total") or {}
            print(fmt % ("TOTAL", total.get("objects", 0),
                         total.get("bytes", 0),
                         total.get("degraded", 0),
                         total.get("misplaced", 0), "", ""))
            osds = out.get("osds") or []
            if osds:
                # raw-capacity axis: per-OSD store statfs (bytes on
                # the device, not logical x replication)
                ofmt = "%-10s %14s %14s %14s %7s"
                print()
                print(ofmt % ("OSD", "USED", "AVAIL", "TOTAL",
                              "%USE"))
                for row in osds:
                    print(ofmt % (row["name"], row["used"],
                                  row["available"], row["total"],
                                  "%.2f" % (100.0 * row["util"])))
                print(ofmt % ("RAW TOTAL", out.get("raw_used", 0),
                              "", out.get("raw_total", 0), ""))
            if not out.get("stats_available"):
                print("(no mgr digest yet: counts read as zero "
                      "until a manager reports)")
            return 0
        if args.cmd == "report":
            # one-call diagnostics bundle (the `ceph report` role):
            # every mon-served surface in one JSON artifact — the
            # thing you attach to a bug
            import json

            rep = {"generated_at": time.time()}
            for key, prefix, kw in (
                    ("status", "status", {}),
                    ("health", "health", {}),
                    ("df", "df", {}),
                    ("osd_dump", "osd dump", {}),
                    ("log_last", "log last", {"n": 100}),
                    ("crashes", "crash ls", {})):
                try:
                    rep[key] = await client.mon_command(prefix, **kw)
                except Exception as e:
                    rep[key] = {"error": repr(e)}
            blob = json.dumps(rep, indent=2, default=str,
                              sort_keys=True)
            if args.args:
                with open(args.args[0], "w") as f:
                    f.write(blob + "\n")
                print("wrote report to %s" % args.args[0])
            else:
                print(blob)
            return 0
        if args.cmd == "trace":
            # `rados -p POOL trace export [OUT.json]`: drive a few
            # probe writes+reads through the cluster and export this
            # client's flight-recorder ring as Chrome-trace JSON (the
            # client-visible slice of each op's span; daemon-side
            # lanes come from the per-daemon admin sockets'
            # dump_flight_recorder or the harness's export_trace)
            import json

            sub = args.args[0] if args.args else "export"
            if sub != "export":
                print("unknown trace subcommand %r" % sub,
                      file=sys.stderr)
                return 2
            out_path = args.args[1] if len(args.args) > 1 else None
            io = client.io_ctx(args.pool)
            n_probe = 8
            payload = b"\x42" * 4096
            for i in range(n_probe):
                await io.write_full("trace-probe-%d" % i, payload)
                await io.read("trace-probe-%d" % i)
            await asyncio.gather(
                *[io.remove("trace-probe-%d" % i)
                  for i in range(n_probe)],
                return_exceptions=True)
            await asyncio.sleep(0.1)    # last replies retire
            from ..trace import recorder as flight
            fr = client.ctx.flight_recorder
            doc = flight.chrome_trace(
                {client.msgr.entity:
                 [dict(r) for r in fr.records]},
                device=flight.device_records())
            blob = json.dumps(doc)
            if out_path:
                with open(out_path, "w") as f:
                    f.write(blob + "\n")
                print("wrote %d trace events to %s (open in "
                      "https://ui.perfetto.dev)"
                      % (len(doc["traceEvents"]), out_path))
            else:
                print(blob)
            return 0
        if args.cmd == "watch-events":
            # live committed-event stream (`ceph -w`): each row once,
            # in seq order, surviving mon failover via the cursor
            def show(row):
                print("%d %.3f [%s] %s"
                      % (row.get("seq", 0), row.get("stamp", 0.0),
                         row.get("type"), row.get("message")))
            client.watch_events(show, start=args.from_seq)
            await asyncio.Event().wait()     # stream until ^C
            return 0
        if args.cmd == "netstat":
            # `rados netstat`: the cluster heartbeat RTT matrix +
            # per-daemon wire rates, served from the mon's beacon
            # soft state and mgr digest (`net status`)
            out = await client.mon_command("net status")
            matrix = out.get("rtt_ms") or {}
            names = sorted(set(matrix)
                           | {p for row in matrix.values()
                              for p in row})
            if names:
                fmt = "%-8s" + " %8s" * len(names)
                print(fmt % ("RTT_MS", *names))
                for src in sorted(matrix):
                    row = matrix[src]
                    print(fmt % (src, *[
                        ("%.2f" % row[d]) if d in row else "-"
                        for d in names]))
            else:
                print("(no heartbeat RTT reports yet)")
            slow = out.get("slow_pairs") or []
            if slow:
                print("slow pairs: %s" % ", ".join(slow))
            daemons = out.get("daemons") or {}
            if daemons:
                dfmt = "%-8s %10s %10s %8s %8s %7s %9s"
                print()
                print(dfmt % ("DAEMON", "TX/S", "RX/S", "RESEND",
                              "REPLAY", "QDEPTH", "RTTMAX_MS"))
                for name in sorted(daemons):
                    row = daemons[name]
                    print(dfmt % (
                        name,
                        "%.0f" % row.get("tx_Bps", 0.0),
                        "%.0f" % row.get("rx_Bps", 0.0),
                        row.get("resends", 0),
                        row.get("replays", 0),
                        row.get("queue_depth", 0),
                        "%.2f" % row.get("rtt_max_ms", 0.0)))
            elif not out.get("daemons_available"):
                print("(no mgr digest yet: per-daemon wire rates "
                      "unavailable)")
            return 0
        if args.cmd == "perf":
            if not args.args or args.args[0] != "history":
                print("unknown perf subcommand %r"
                      % (args.args[:1] or [""])[0], file=sys.stderr)
                return 2
            if len(args.args) < 2:
                out = await client.mon_command("perf history")
                for series, label in out.get("series") or []:
                    print("%s%s" % (series,
                                    "[%s]" % label if label else ""))
                return 0
            kw = {"series": args.args[1], "window": args.window}
            if len(args.args) > 2:
                kw["label"] = args.args[2]
            out = await client.mon_command("perf history", **kw)
            print("%s%s tier=%ss window=%ss"
                  % (out["series"],
                     "[%s]" % out["label"] if out["label"] else "",
                     out.get("tier_s"), out.get("window")))
            fmt = "%12s %5s %12s %12s %12s %12s"
            print(fmt % ("T", "N", "MIN", "MAX", "AVG", "LAST"))
            for t, n, lo, hi, avg, last in out.get("rows") or []:
                print(fmt % (t, n, lo, hi, avg, last))
            return 0
        io = client.io_ctx(args.pool)
        if args.snap:
            if args.cmd in ("put", "rm", "bench", "mksnap", "rmsnap"):
                print("error: cannot write with -s (snapshots are "
                      "read-only)", file=sys.stderr)
                return 2
            try:
                io.set_read_snap(io.snap_lookup(args.snap))
            except KeyError:
                print("error: no snapshot %r in pool %r"
                      % (args.snap, args.pool), file=sys.stderr)
                return 2
        if args.cmd == "mksnap":
            sid = await io.snap_create(args.args[0])
            print("created pool snapshot %r (snapid %d)"
                  % (args.args[0], sid))
            return 0
        if args.cmd == "rmsnap":
            await io.snap_remove(args.args[0])
            print("removed pool snapshot %r" % args.args[0])
            return 0
        if args.cmd == "lssnap":
            snaps = io.snap_list()
            for sid in sorted(snaps):
                print("%d\t%s" % (sid, snaps[sid]))
            print("%d snaps" % len(snaps))
            return 0
        if args.cmd == "put":
            with open(args.args[1], "rb") as f:
                data = f.read()
            await io.write_full(args.args[0], data)
            print("wrote %d bytes to %s" % (len(data), args.args[0]))
        elif args.cmd == "get":
            data = await io.read(args.args[0])
            with open(args.args[1], "wb") as f:
                f.write(data)
            print("read %d bytes from %s" % (len(data), args.args[0]))
        elif args.cmd == "ls":
            for name in await client.list_objects(io.pool_id):
                print(name)
        elif args.cmd == "rm":
            await io.remove(args.args[0])
        elif args.cmd == "stat":
            size = await io.stat(args.args[0])
            print("%s size %d" % (args.args[0], size))
        elif args.cmd == "bench":
            seconds = int(args.args[0])
            size = args.size
            payload = bytes(size)
            deadline = time.perf_counter() + seconds
            n = 0
            lat = []
            inflight = []
            while time.perf_counter() < deadline:
                t0 = time.perf_counter()
                inflight.append((t0, asyncio.ensure_future(
                    io.write_full("bench_%d" % n, payload))))
                n += 1
                if len(inflight) >= 16:
                    t0w, fut = inflight.pop(0)
                    await fut
                    lat.append(time.perf_counter() - t0w)
            for t0w, fut in inflight:
                await fut
                lat.append(time.perf_counter() - t0w)
            dur = seconds
            print("wrote %d x %dB objects in %ds: %.1f op/s, "
                  "%.2f MiB/s, avg lat %.1f ms"
                  % (n, size, dur, n / dur,
                     n * size / dur / (1 << 20),
                     1000 * sum(lat) / max(1, len(lat))))
            # cleanup
            await asyncio.gather(*[io.remove("bench_%d" % i)
                                   for i in range(n)],
                                 return_exceptions=True)
        else:
            print("unknown command %r" % args.cmd, file=sys.stderr)
            return 2
        return 0
    finally:
        await client.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rados")
    p.add_argument("-m", "--mon", required=True,
                   help="monitor address(es), comma separated")
    p.add_argument("-p", "--pool", default="rbd")
    p.add_argument("-s", "--snap", default=None,
                   help="read from this pool snapshot")
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--window", type=float, default=600.0,
                   help="perf history window, seconds")
    p.add_argument("--from", dest="from_seq", type=int, default=0,
                   help="watch-events: resume after this seq")
    p.add_argument("cmd")
    p.add_argument("args", nargs="*")
    args = p.parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
