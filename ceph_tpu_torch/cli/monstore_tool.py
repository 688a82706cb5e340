"""monstore-tool: inspect and rescue a monitor's KV store.

Analog of the reference's ceph-monstore-tool (src/tools/
ceph_monstore_tool.cc): offline access to a mon store for debugging
and disaster recovery.

    python -m ceph_tpu.cli.monstore_tool <store.db> <cmd>

    dump              store overview: last map epoch, paxos bounds,
                      service-state sizes, key count
    get <key>         print one raw key (hex + best-effort decode)
    list [prefix]     list keys (optionally under a prefix)
    get-osdmap [-e N] print the stored full OSDMap (latest or epoch N)
    show-config       the centralized config service's state
    show-auth         auth registry entities (keys REDACTED)
    show-log [n]      last n cluster-log lines (default 20)

Works on the SQLite store files real monitors write (`store=` /
mon data dirs); read-only."""

from __future__ import annotations

import argparse
import json
import os
import sqlite3
import sys

from ..store.kv import SQLiteKV
from ..utils import denc


class _ROStore(SQLiteKV):
    """Truly read-only open: a forensic tool must neither create a
    fresh empty DB on a mistyped path (reporting 'store is empty' to
    an operator mid-disaster-recovery) nor touch WAL/journal state on
    a read-only-mounted host."""

    def open(self) -> None:
        if not os.path.exists(self.path):
            raise FileNotFoundError(self.path)
        self._conn = sqlite3.connect("file:%s?mode=ro" % self.path,
                                     uri=True,
                                     check_same_thread=False)


def _open(path: str) -> SQLiteKV:
    db = _ROStore(path)
    db.open()
    return db


def _decode_maybe(v: bytes):
    try:
        if v[:1] == b"V":
            from ..utils.denc import decode_versioned

            return decode_versioned(v, 255)[1]
        return denc.decode(v)
    except Exception:
        return {"__hex__": v[:64].hex() + ("..." if len(v) > 64
                                           else "")}


def _jsonable(v):
    if isinstance(v, bytes):
        return {"__hex__": v.hex()}
    if isinstance(v, dict):
        return {(k.hex() if isinstance(k, bytes) else str(k)):
                _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def cmd_dump(db: SQLiteKV) -> dict:
    keys = [k for k, _v in db.iterate()]
    out: dict = {"keys": len(keys)}
    raw = db.get(b"osdmap:last_epoch")
    if raw is not None:
        out["osdmap_last_epoch"] = denc.decode(raw)
    # paxos.py key shape: b"paxos:v%016d"
    paxos_vers = sorted(int(k[len(b"paxos:v"):])
                        for k in keys
                        if k.startswith(b"paxos:v"))
    if paxos_vers:
        out["paxos_first"] = paxos_vers[0]
        out["paxos_last"] = paxos_vers[-1]
    for label, key in (("config", b"svc:config"),
                       ("auth", b"svc:auth"), ("log", b"svc:log"),
                       ("crash", b"svc:crash")):
        raw = db.get(key)
        if raw is not None:
            v = denc.decode(raw)
            if label == "log" and isinstance(v, dict):
                v = v.get("entries") or []
            out["svc_%s_entries" % label] = len(v)
    fulls = [k for k in keys if k.startswith(b"osdmap:full:")]
    incs = [k for k in keys if k.startswith(b"osdmap:inc:")]
    out["osdmap_fulls"] = len(fulls)
    out["osdmap_incs"] = len(incs)
    return out


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="monstore_tool",
        description="inspect a monitor's KV store (read-only)")
    p.add_argument("store", help="path to the mon store .db file")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("dump")
    lp = sub.add_parser("list")
    lp.add_argument("prefix", nargs="?", default="")
    gp = sub.add_parser("get")
    gp.add_argument("key")
    mp = sub.add_parser("get-osdmap")
    mp.add_argument("-e", "--epoch", type=int, default=None)
    sub.add_parser("show-config")
    sub.add_parser("show-auth")
    lg = sub.add_parser("show-log")
    lg.add_argument("n", nargs="?", type=int, default=20)
    sub.add_parser("show-crashes")
    return p


def main(argv=None) -> int:
    try:
        args = _build_parser().parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    try:
        db = _open(args.store)
    except FileNotFoundError:
        print("no such store: %s" % args.store, file=sys.stderr)
        return 1
    try:
        if args.cmd == "dump":
            print(json.dumps(cmd_dump(db), indent=2))
            return 0
        if args.cmd == "list":
            pref = args.prefix.encode()
            for k, v in db.iterate(pref,
                                   pref + b"\xff" if pref else None):
                print("%s  (%d bytes)" % (k.decode("latin1"),
                                          len(v)))
            return 0
        if args.cmd == "get":
            v = db.get(args.key.encode())
            if v is None:
                print("no such key", file=sys.stderr)
                return 1
            print(json.dumps(_jsonable(_decode_maybe(v)), indent=2))
            return 0
        if args.cmd == "get-osdmap":
            if args.epoch is not None:
                epoch = args.epoch
            else:
                raw = db.get(b"osdmap:last_epoch")
                if raw is None:
                    print("store has no osdmap", file=sys.stderr)
                    return 1
                epoch = denc.decode(raw)
            blob = db.get(b"osdmap:full:%016d" % epoch)
            if blob is None:
                print("no full map at epoch %d" % epoch,
                      file=sys.stderr)
                return 1
            from ..osd.osdmap import OSDMap

            print(json.dumps(_jsonable(OSDMap.decode(blob).to_dict()),
                             indent=2))
            return 0
        if args.cmd == "show-config":
            raw = db.get(b"svc:config")
            print(json.dumps(_jsonable(denc.decode(raw))
                             if raw else {}, indent=2))
            return 0
        if args.cmd == "show-auth":
            raw = db.get(b"svc:auth")
            ents = denc.decode(raw) if raw else {}
            red = {e: {"key": "REDACTED",
                       "caps": dict(v.get("caps") or {})}
                   for e, v in ents.items()}
            print(json.dumps(red, indent=2))
            return 0
        if args.cmd == "show-log":
            raw = db.get(b"svc:log")
            lines = denc.decode(raw) if raw else []
            if isinstance(lines, dict):     # clog-era format
                lines = lines.get("entries") or []
            for e in lines[-args.n:]:
                print("%(stamp).3f %(who)s %(level)s: %(message)s"
                      % e)
            return 0
        if args.cmd == "show-crashes":
            raw = db.get(b"svc:crash")
            reports = denc.decode(raw) if raw else {}
            for cid in sorted(reports):
                r = reports[cid]
                print("%s %s %s: %s%s"
                      % (cid, r.get("entity"), r.get("exc_type"),
                         r.get("exc_msg"),
                         " [archived]" if r.get("archived") else ""))
            return 0
        return 2
    finally:
        db.close()


if __name__ == "__main__":
    raise SystemExit(main())
