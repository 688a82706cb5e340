"""dencoder: encode/decode/inspect the framework's wire structs.

Analog of src/tools/ceph-dencoder (the corpus-checking tool the
reference uses to guarantee rolling-upgrade compatibility): a typed
registry of every versioned struct, with

    list                      every registered type
    type <name> encode <json> JSON value -> hex blob (stdout)
    type <name> decode <hex>  hex blob -> JSON dump
    type <name> version       writer version / compat floor
    corpus <dir>              decode every <type>.<n>.hex under dir
                              and fail on any change vs the pinned
                              .json dump beside it (the ceph-object-
                              corpus check)

Hex in/out so blobs survive shell pipes; '-' reads stdin.
"""

from __future__ import annotations

import json
import os
import sys


def _to_jsonable(v):
    if isinstance(v, bytes):
        return {"__hex__": v.hex()}
    if isinstance(v, dict):
        return {(k.hex() if isinstance(k, bytes) else k):
                _to_jsonable(val) for k, val in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    return v


def _from_jsonable(v):
    if isinstance(v, dict):
        if set(v) == {"__hex__"}:
            return bytes.fromhex(v["__hex__"])
        return {k: _from_jsonable(val) for k, val in v.items()}
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


class _Type:
    def __init__(self, name, version, compat, enc, dec):
        self.name = name
        self.version = version
        self.compat = compat
        self.enc = enc          # jsonable-value -> bytes
        self.dec = dec          # bytes -> jsonable-value


def _registry() -> dict[str, _Type]:
    from ..osd.osdmap import Incremental, OSDMap
    from ..osd.pg import LogEntry, PGInfo
    from ..msg.message import (MSG_STRUCT_COMPAT, MSG_STRUCT_V,
                               decode_message, encode_message)
    from ..utils import denc

    types: dict[str, _Type] = {}

    def add(name, version, compat, enc, dec):
        types[name] = _Type(name, version, compat, enc, dec)

    add("osdmap", OSDMap.STRUCT_V, OSDMap.STRUCT_COMPAT,
        lambda v: OSDMap.from_dict(v).encode(),
        lambda b: OSDMap.decode(b).to_dict())
    add("osdmap_inc", Incremental.STRUCT_V, Incremental.STRUCT_COMPAT,
        lambda v: Incremental.from_dict(v).encode(),
        lambda b: Incremental.decode(b).to_dict())
    add("pg_info", 1, 1,
        lambda v: denc.encode(PGInfo.from_wire(v).to_wire()),
        lambda b: PGInfo.from_wire(denc.decode(b)).to_wire())
    add("pg_log_entry", 1, 1,
        lambda v: denc.encode(LogEntry.from_wire(v).to_wire()),
        lambda b: LogEntry.from_wire(denc.decode(b)).to_wire())
    add("message", MSG_STRUCT_V, MSG_STRUCT_COMPAT,
        lambda v: encode_message(_msg_from_dump(v)),
        lambda b: _msg_dump(decode_message(b)))
    add("denc", 1, 1, denc.encode, denc.decode)
    return types


def _msg_dump(m) -> dict:
    return {"type": m.TYPE, "seq": m.seq, "src": m.src,
            "fields": m.to_wire()}


def _msg_from_dump(d: dict):
    from ..msg.message import _REGISTRY

    cls = _REGISTRY[d["type"]]
    m = cls.from_wire(d["fields"])
    m.seq = d.get("seq", 0)
    m.src = d.get("src", "")
    return m


def _read_arg(arg: str) -> str:
    return sys.stdin.read() if arg == "-" else arg


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    types = _registry()
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)
    if cmd == "list":
        for t in sorted(types.values(), key=lambda t: t.name):
            print("%-14s v%d compat %d" % (t.name, t.version,
                                           t.compat))
        return 0
    if cmd == "corpus":
        if not argv:
            print("usage: dencoder corpus <dir>", file=sys.stderr)
            return 2
        return _corpus(types, argv[0])
    if cmd != "type" or len(argv) < 2:
        print("usage: dencoder list | corpus <dir> | "
              "type <name> encode|decode|version <arg>",
              file=sys.stderr)
        return 2
    t = types.get(argv[0])
    if t is None:
        print("unknown type %r (try: dencoder list)" % argv[0],
              file=sys.stderr)
        return 2
    action = argv[1]
    if action == "version":
        print("v%d compat %d" % (t.version, t.compat))
        return 0
    if action in ("encode", "decode") and len(argv) < 3:
        print("usage: dencoder type <name> %s <arg|->" % action,
              file=sys.stderr)
        return 2
    if action == "encode":
        value = _from_jsonable(json.loads(_read_arg(argv[2])))
        print(t.enc(value).hex())
        return 0
    if action == "decode":
        blob = bytes.fromhex(_read_arg(argv[2]).strip())
        print(json.dumps(_to_jsonable(t.dec(blob)), indent=2,
                         sort_keys=True))
        return 0
    print("unknown action %r" % action, file=sys.stderr)
    return 2


def _corpus(types, root: str) -> int:
    """Every pinned blob must still decode to its pinned dump AND
    re-encode deterministically — the rolling-upgrade guarantee."""
    failures = 0
    checked = 0
    for fn in sorted(os.listdir(root)):
        if not fn.endswith(".hex"):
            continue
        tname = fn.split(".")[0]
        t = types.get(tname)
        if t is None:
            print("SKIP %s (no type %r)" % (fn, tname))
            continue
        blob = bytes.fromhex(
            open(os.path.join(root, fn)).read().strip())
        jpath = os.path.join(root, fn[:-4] + ".json")
        checked += 1
        if not os.path.exists(jpath):
            failures += 1
            print("FAIL %s: missing pinned dump %s" % (fn, jpath))
            continue
        want = json.load(open(jpath))
        # JSON round-trip normalizes key types (int dict keys print
        # as strings) so the comparison is representation-stable
        got = json.loads(json.dumps(_to_jsonable(t.dec(blob))))
        if got != want:
            failures += 1
            print("FAIL %s: decode drifted" % fn)
            continue
        # re-encode determinism: the ENCODER half of the upgrade
        # guarantee — new code must still produce the pinned bytes
        # for the pinned logical value
        try:
            again = t.enc(_from_jsonable(want))
        except Exception as e:
            failures += 1
            print("FAIL %s: re-encode raised %s" % (fn, e))
            continue
        if again != blob:
            failures += 1
            print("FAIL %s: re-encode drifted (%d vs %d bytes)"
                  % (fn, len(again), len(blob)))
        else:
            print("OK   %s" % fn)
    print("%d checked, %d failed" % (checked, failures))
    return 1 if failures or not checked else 0


if __name__ == "__main__":
    raise SystemExit(main())
