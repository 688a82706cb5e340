"""Cluster log client: every daemon's handle into the mon's LogMonitor.

Reference analog: LogClient/LogChannel (src/common/LogClient.h) — the
`clog` handle daemons use for `clog->error() << ...`: entries carry a
channel ("cluster" for operator-facing events, "audit" for command
provenance), a severity, and a per-daemon sequence number; they batch
into MLog messages to the monitors, the leader commits them through
paxos (so `log last` agrees on every mon and survives elections), and
the committing mon acks with MLogAck so the client can drop them.
Entries stay queued (and are periodically re-flushed) until acked —
a leader election or dropped frame between emit and commit loses
nothing.

The channel/severity registries double as the emit lint: an
unregistered channel or level raises at the call site, so a typo'd
`clog.queue("warning", ...)` is a unit-test failure, not a silently
unaggregatable log stream.
"""

from __future__ import annotations

import time

# registered channels (LogChannel names): "cluster" is the
# operator-facing event stream (`ceph -w`), "audit" records command
# provenance.  The emit lint rejects anything else.
CHANNELS = ("cluster", "audit")

# registered severities, lowest to highest (clog_to_monitors levels)
LEVELS = ("DBG", "INF", "WRN", "ERR")


class LogClient:
    """One daemon's cluster-log handle.

    ``send_fn(msg)`` delivers an MLog to the monitors (broadcast, like
    beacons, so whichever mon leads next sees it); the mon that
    observes the paxos commit acks back and ``handle_ack`` retires the
    entries.  ``flush()`` re-sends everything still unacked — callers
    wire it into their periodic loop so entries survive leader
    elections and dropped frames.
    """

    def __init__(self, ctx, daemon: str, send_fn=None):
        self.ctx = ctx
        self.daemon = daemon
        self.send_fn = send_fn
        self._seq = 0
        # boot incarnation: entries carry (inc, seq) and the
        # LogMonitor dedups on the PAIR, ordered lexicographically —
        # a daemon reborn on a WIPED store (its persisted seq floor
        # gone) mints a fresh, larger incarnation, so its seqs
        # restarting from 1 are new entries, not swallowed resends
        self.incarnation = 0
        # unacked entries, oldest first (the LogClient log_queue)
        self.pending: list[dict] = []
        # level -> total entries ever queued (the
        # ceph_tpu_log_messages_total{daemon,level} exporter source)
        self.counts: dict[str, int] = {lv: 0 for lv in LEVELS}
        # on_seq(seq) after every emit: daemons persist the last-used
        # seq into their own store so a restart resumes ABOVE it —
        # the LogMonitor dedups by (who, inc, seq), so a seq reset
        # under an unchanged incarnation would swallow the reborn
        # daemon's entries as resends and let pre-restart unacked
        # entries supersede them
        self.on_seq = None

    def resume_above(self, seq: int, incarnation: int = 0) -> None:
        """Adopt a persisted floor: the next entry's seq is at least
        `seq`+1 (restart path; no-op when the floor is behind us).
        `incarnation` is the persisted boot incarnation — a fresh
        (wiped) store passes a newly minted one instead."""
        self._seq = max(self._seq, int(seq))
        self.incarnation = max(self.incarnation, int(incarnation))

    # -- emit (the clog->error()/warn()/info() surface) -----------------

    def queue(self, level: str, message: str,
              channel: str = "cluster") -> dict:
        """Queue one entry.  Unregistered channel/severity raises —
        the emit lint every call site passes through."""
        if channel not in CHANNELS:
            raise ValueError("unregistered clog channel %r (have %s)"
                             % (channel, CHANNELS))
        if level not in LEVELS:
            raise ValueError("unregistered clog severity %r (have %s)"
                             % (level, LEVELS))
        self._seq += 1
        if self.on_seq is not None:
            try:
                self.on_seq(self._seq)
            except Exception:
                pass        # persistence must never sink the emit
        entry = {"seq": self._seq, "inc": self.incarnation,
                 "stamp": time.time(),
                 "who": self.daemon, "channel": channel,
                 "level": level, "message": str(message)}
        self.pending.append(entry)
        self.counts[level] = self.counts.get(level, 0) + 1
        # mirror into the local ring so a crash dump shows what the
        # daemon last told (or tried to tell) the cluster
        self.ctx.log.log("mon", 0 if level == "ERR" else 1,
                         "clog %s [%s] %s" % (channel, level, message))
        return entry

    def error(self, message: str, channel: str = "cluster") -> None:
        self.queue("ERR", message, channel)
        self.flush()

    def warn(self, message: str, channel: str = "cluster") -> None:
        self.queue("WRN", message, channel)
        self.flush()

    def info(self, message: str, channel: str = "cluster") -> None:
        self.queue("INF", message, channel)
        self.flush()

    def debug(self, message: str, channel: str = "cluster") -> None:
        self.queue("DBG", message, channel)
        self.flush()

    # -- delivery ---------------------------------------------------------

    def flush(self) -> None:
        """Send every unacked entry (idempotent on the mon side: the
        LogMonitor dedups by (who, seq) at apply, so a re-flush racing
        its own ack commits nothing twice)."""
        if not self.pending or self.send_fn is None:
            return
        from ..msg.messages import MLog
        self.send_fn(MLog(entries=[dict(e) for e in self.pending]))

    def handle_ack(self, who: str, last: int,
                   inc: int | None = None) -> None:
        """A mon observed the paxos commit through entry `last` (of
        incarnation `inc`; an ack naming an OLDER incarnation is a
        stale ack for a previous life and retires nothing here)."""
        if who != self.daemon:
            return
        if inc is not None and int(inc) != self.incarnation:
            return
        self.pending = [e for e in self.pending
                        if e["seq"] > int(last)]

    @property
    def num_pending(self) -> int:
        return len(self.pending)

    def counts_wire(self) -> dict:
        """Per-level totals for the MMgrReport / exporter path."""
        return {lv: n for lv, n in self.counts.items() if n}
