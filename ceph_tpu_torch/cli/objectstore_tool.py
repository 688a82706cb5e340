"""objectstore-tool: offline PG surgery on an OSD's store.

Analog of src/tools/ceph_objectstore_tool.cc — the offline
checkpoint/repair surgeon: list PGs and objects in a (un-mounted)
KStore, export a PG (objects + xattrs + omap + pgmeta log/info) to a
portable file, import it into another store, or remove it.

    python -m ceph_tpu.cli.objectstore_tool --data-path STORE.db --op list
    python -m ceph_tpu.cli.objectstore_tool --data-path STORE.db \\
        --pgid 1.0 --op export --file pg.export
    python -m ceph_tpu.cli.objectstore_tool --data-path STORE2.db \\
        --op import --file pg.export
    python -m ceph_tpu.cli.objectstore_tool --data-path STORE.db \\
        --pgid 1.0 --op remove
"""

from __future__ import annotations

import argparse
import sys

from ..store.kstore import KStore
from ..store.objectstore import Transaction, coll_t, hobject_t
from ..utils import denc

EXPORT_MAGIC = b"ceph-tpu-pg-export-v1"


def _parse_pgid(s: str):
    pool_s, ps_s = s.split(".")
    return int(pool_s), int(ps_s, 16)


def export_pg(store, pool: int, ps: int) -> bytes:
    cid = coll_t.pg(pool, ps)
    objs = []
    for ho in store.collection_list(cid):
        objs.append({
            "name": ho.name,
            "data": store.read(cid, ho),
            "attrs": dict(store.getattrs(cid, ho)),
            "omap": dict(store.omap_get(cid, ho)),
            "omap_header": store.omap_get_header(cid, ho),
        })
    return EXPORT_MAGIC + denc.encode(
        {"pool": pool, "ps": ps, "objects": objs})


def import_pg(store, blob: bytes, force: bool = False) -> tuple:
    if not blob.startswith(EXPORT_MAGIC):
        raise ValueError("not a pg export file")
    payload = denc.decode(blob[len(EXPORT_MAGIC):])
    pool, ps = payload["pool"], payload["ps"]
    cid = coll_t.pg(pool, ps)
    existing = {c for c in store.list_collections()}
    if cid in existing and not force:
        raise ValueError("pg %d.%x already exists (use --force)"
                         % (pool, ps))
    t = Transaction()
    if cid in existing:
        for ho in store.collection_list(cid):
            t.remove(cid, ho)
    else:
        t.create_collection(cid)
    for o in payload["objects"]:
        ho = hobject_t(o["name"])
        t.touch(cid, ho)
        data = bytes(o["data"])
        t.write(cid, ho, 0, len(data), data)
        t.setattrs(cid, ho, {
            (k if isinstance(k, str) else k.decode()): bytes(v)
            for k, v in o["attrs"].items()})
        if o["omap"]:
            t.omap_setkeys(cid, ho, {bytes(k): bytes(v)
                                     for k, v in o["omap"].items()})
        if o.get("omap_header"):
            t.omap_setheader(cid, ho, bytes(o["omap_header"]))
    store.apply_transaction(t)
    return pool, ps, len(payload["objects"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="objectstore-tool")
    p.add_argument("--data-path", required=True)
    p.add_argument("--op", required=True,
                   choices=["list", "export", "import", "remove",
                            "list-pgs"])
    p.add_argument("--pgid")
    p.add_argument("--file")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)

    store = KStore(args.data_path)
    store.mount()
    try:
        if args.op in ("list", "list-pgs"):
            for cid in sorted(store.list_collections(),
                              key=lambda c: c.name):
                if not cid.is_pg():
                    continue
                pool_s, ps_s = cid.name.split(".")
                pgid = "%s.%s" % (pool_s, ps_s)
                if args.op == "list-pgs":
                    print(pgid)
                else:
                    for ho in store.collection_list(cid):
                        if ho.name != "__pgmeta__":
                            print("%s %s" % (pgid, ho.name))
            return 0
        if args.op == "export":
            pool, ps = _parse_pgid(args.pgid)
            blob = export_pg(store, pool, ps)
            with open(args.file, "wb") as f:
                f.write(blob)
            print("exported %d.%x: %d bytes" % (pool, ps, len(blob)))
            return 0
        if args.op == "import":
            with open(args.file, "rb") as f:
                blob = f.read()
            pool, ps, n = import_pg(store, blob, force=args.force)
            print("imported %d.%x: %d objects" % (pool, ps, n))
            return 0
        if args.op == "remove":
            pool, ps = _parse_pgid(args.pgid)
            cid = coll_t.pg(pool, ps)
            t = Transaction()
            for ho in store.collection_list(cid):
                t.remove(cid, ho)
            t.remove_collection(cid)
            store.apply_transaction(t)
            print("removed %d.%x" % (pool, ps))
            return 0
        return 2
    finally:
        store.umount()


if __name__ == "__main__":
    sys.exit(main())
