"""Daemon-side progress tracking for long-running background flows.

The reference's progress mgr module infers global recovery progress
from PGMap deltas; this build tracks it at the source instead: each
long flow (recovery drains, scrub sweeps, dedup ref-drains) registers
with its daemon's ProgressTracker, updates its done/total counts as it
runs, and the rows ride ``osd_stats["progress"]`` on the next
MMgrReport into the mgr digest — where `status` renders them as a
progress section and the mon leader diffs them into
progress_start/progress_finish events on the bus.

Fractions are clamped monotonic per flow: recovery totals can GROW
mid-drain (new peers reveal more missing objects), and a progress bar
that moves backwards reads as a bug, so `fraction` only ever rises —
`done`/`total` stay truthful for anyone doing arithmetic.  Finished
rows linger for LINGER_S so at least one report cycle ships the 1.0
row (the finish edge must reach the digest before the row vanishes).
"""

from __future__ import annotations

import time

# how long a finished flow's 1.0 row stays visible in rows()
LINGER_S = 10.0


class ProgressTracker:
    """One daemon's in-flight background flows, keyed by
    "<kind>/<key>" (e.g. "recovery/1.0s0", "scrub/2.3")."""

    def __init__(self):
        self._flows: dict[str, dict] = {}

    @staticmethod
    def _id(kind: str, key: str) -> str:
        return "%s/%s" % (kind, key)

    def start(self, kind: str, key: str, total: int) -> str:
        """Register (or restart) a flow; returns its id.  A restart
        of a finished flow (a second scrub of the same PG) begins a
        fresh bar; restarting a LIVE flow keeps its monotonic
        fraction (recovery re-kicked mid-drain is one drain)."""
        fid = self._id(kind, key)
        row = self._flows.get(fid)
        if row is None or row["finished"] is not None:
            self._flows[fid] = {
                "kind": kind, "key": key, "done": 0,
                "total": max(int(total), 0), "fraction": 0.0,
                "started": time.time(), "finished": None}
        else:
            row["total"] = max(row["total"], int(total))
        return fid

    def update(self, fid: str, done: int,
               total: int | None = None) -> None:
        row = self._flows.get(fid)
        if row is None or row["finished"] is not None:
            return
        if total is not None:
            row["total"] = max(int(total), 0)
        row["done"] = min(max(int(done), 0), row["total"])
        if row["total"] > 0:
            row["fraction"] = max(row["fraction"],
                                  row["done"] / row["total"])

    def drain(self, fid: str, outstanding: int) -> None:
        """Drain-shaped update: the flow knows how much work is LEFT
        (missing objects, queued refs), not how much is done.  Total
        grows to cover any newly-revealed work, done is derived, and
        outstanding hitting zero finishes the flow."""
        row = self._flows.get(fid)
        if row is None or row["finished"] is not None:
            return
        outstanding = max(int(outstanding), 0)
        if outstanding == 0:
            self.finish(fid)
            return
        row["total"] = max(row["total"], outstanding)
        self.update(fid, row["total"] - outstanding)

    def finish(self, fid: str) -> None:
        row = self._flows.get(fid)
        if row is None or row["finished"] is not None:
            return
        row["done"] = row["total"]
        row["fraction"] = 1.0
        row["finished"] = time.time()

    def rows(self, now: float | None = None) -> dict:
        """Report-time view: {flow id: row}; finished rows past the
        linger window prune here (the report loop is the only steady
        caller, so pruning needs no timer of its own)."""
        now = time.time() if now is None else now
        out: dict[str, dict] = {}
        for fid, row in list(self._flows.items()):
            fin = row["finished"]
            if fin is not None and now - fin > LINGER_S:
                del self._flows[fid]
                continue
            out[fid] = {"kind": row["kind"], "key": row["key"],
                        "done": row["done"], "total": row["total"],
                        "fraction": round(row["fraction"], 4)}
        return out
