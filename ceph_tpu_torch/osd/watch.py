"""Watch/notify: object interest registration + event fan-out.

Condensed analog of src/osd/Watch.cc + PrimaryLogPG's watch/notify op
handling: a client registers a watch on an object at the PG primary
("watch" op); any client's "notify" op makes the primary deliver the
payload to every live watcher (MWatchNotify) and complete the notify
once all have acked or the timeout lapses (the reference's
notify_timeout).  Watches here live in primary memory and die with the
connection (ms_handle_reset) or an interval change — the client
re-registers on map change, which is also how the reference's clients
behave after a primary migration (librados re-watch on notify_resend).
"""

from __future__ import annotations

import asyncio

from ..msg.messages import MWatchNotify


class WatchRegistry:
    """Per-daemon watch state (primary side)."""

    def __init__(self, osd):
        self.osd = osd
        # (pool, ps, oid) -> set[conn]
        self.watches: dict[tuple, set] = {}
        self._notify_id = 0
        # notify_id -> {"waiting": set[conn], "event": Event}
        self._notifies: dict[int, dict] = {}

    def watch(self, pg, oid: str, conn) -> None:
        key = (pg.pool_id, pg.ps, oid)
        self.watches.setdefault(key, set()).add(conn)

    def unwatch(self, pg, oid: str, conn) -> None:
        key = (pg.pool_id, pg.ps, oid)
        entry = self.watches.get(key)
        if entry is not None:
            entry.discard(conn)
            if not entry:
                del self.watches[key]

    def pg_reset(self, pool_id: int, ps: int) -> None:
        """Interval change: registrations die with the old acting set
        (clients re-watch at the new primary on the map change)."""
        for key in [k for k in self.watches
                    if k[0] == pool_id and k[1] == ps]:
            del self.watches[key]

    def conn_reset(self, conn) -> None:
        for key in list(self.watches):
            self.watches[key].discard(conn)
            if not self.watches[key]:
                del self.watches[key]
        for st in self._notifies.values():
            st["waiting"].discard(conn)
            if not st["waiting"] and not st["event"].is_set():
                st["event"].set()

    async def notify(self, pg, oid: str, payload: bytes,
                     timeout: float = 5.0) -> int:
        """Deliver to every watcher; returns the number that acked."""
        key = (pg.pool_id, pg.ps, oid)
        watchers = set(self.watches.get(key, set()))
        if not watchers:
            return 0
        self._notify_id += 1
        nid = self._notify_id
        ev = asyncio.Event()
        st = {"waiting": set(watchers), "acked": set(), "event": ev}
        self._notifies[nid] = st
        for conn in watchers:
            conn.send(MWatchNotify(pool=pg.pool_id, ps=pg.ps, oid=oid,
                                   notify_id=nid, payload=payload,
                                   ack=False))
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        self._notifies.pop(nid, None)
        # count explicit acks only: a watcher whose connection died
        # mid-notify is a timed-out returnee, not an ack (the reference
        # reports such watchers in the notify timeout list)
        return len(st["acked"])

    def handle_ack(self, conn, msg: MWatchNotify) -> None:
        st = self._notifies.get(msg.notify_id)
        if st is None:
            return
        st["acked"].add(conn)
        st["waiting"].discard(conn)
        if not st["waiting"]:
            st["event"].set()
