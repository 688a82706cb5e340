"""Process-wide context object tying the substrate together.

Reference analog: CephContext — the per-process bundle of config, logging,
perf counter collection, and admin socket that every component receives.
"""

from __future__ import annotations

from typing import Iterable

from .admin import AdminSocket
from .config import Config, Option
from .log import Logger, LogRing
from .perf import PerfCountersCollection


class Context:
    def __init__(
        self,
        name: str = "ceph-tpu",
        schema: Iterable[Option] = (),
        conf_overrides: dict | None = None,
    ):
        self.name = name
        self.conf = Config(schema)
        for k, v in (conf_overrides or {}).items():
            self.conf.set(k, v, source="cli")
        self.log = Logger(
            name, ring=LogRing(self.conf.get("log_ring_size", 10000))
        )
        self.log.set_global_level(self.conf["log_level"])
        self.conf.add_observer(
            "log_level", lambda _k, v: self.log.set_global_level(v)
        )
        self.perf = PerfCountersCollection()
        self.admin: AdminSocket | None = None
        admin_path = self.conf.get("admin_socket", "")
        if admin_path:
            self.admin = AdminSocket(admin_path, self)
            self.admin.start()

    def shutdown(self) -> None:
        if self.admin:
            self.admin.stop()
            self.admin = None
