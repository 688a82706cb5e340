"""store subpackage — see ceph_tpu/__init__.py for the layer map."""

from __future__ import annotations


def create_store(conf, whoami: int = 0):
    """Conf-driven store factory (the osd_objectstore switch,
    src/os/ObjectStore.cc create() role).  An empty osd_data keeps
    every engine ephemeral (RAM KV / RAM block device) so test
    clusters need no directory management."""
    kind = conf["osd_objectstore"]
    data = conf["osd_data"]
    path = ("%s/osd.%d" % (data.rstrip("/"), whoami)) if data else ""
    if kind == "memstore":
        from .memstore import MemStore

        return MemStore(path,
                        device_bytes=conf["memstore_device_bytes"])
    if kind == "kstore":
        from .kstore import KStore
        from .kv import MemKV

        if path:
            import os

            os.makedirs(path, exist_ok=True)
            return KStore(path + "/kstore.db")
        return KStore("", db=MemKV())
    if kind == "extentstore":
        from .extentstore import ExtentStore

        return ExtentStore(
            path,
            dev_size=conf["extentstore_device_size"],
            deferred_threshold=conf["extentstore_deferred_threshold"])
    raise ValueError("unknown osd_objectstore %r" % kind)
