"""Per-peer heartbeat RTT tracking — the OSD's network plane.

Reference analog: OSDService's ping-time tracking behind
``dump_osd_network`` (osd/OSD.cc) and the mon_warn_on_slow_ping_time
machinery feeding the OSD_SLOW_PING_TIME health check.

Every heartbeat reply echoes the ping's send stamp; the OSD feeds
``monotonic() - stamp`` here.  Per peer we keep last/min/max, a
time-decayed EWMA per window (5s/60s/15min), and a pow2-µs
histogram.  Legacy stampless pings simply never feed the tracker, so
mixed-version clusters converge with partial matrices instead of
failing.

A peer is "slow" when BOTH the 5s window average and the most recent
probe sit above the threshold: the window average makes the raise
robust to one spiky probe, the last-probe condition makes the clear
immediate once healthy pings resume (a pure EWMA would hold the
alert for many window constants after a lifted delay).
"""

from __future__ import annotations

import math
import time

# (name, tau seconds): the reference's 1min/5min ping windows plus a
# 5s window, because dev-paced clusters (FAST_CONF) live whole lives
# in under a minute
WINDOWS = (("5s", 5.0), ("60s", 60.0), ("15m", 900.0))

HIST_BUCKETS = 32


class _PeerRtt:
    __slots__ = ("last_s", "min_s", "max_s", "ewma", "hist",
                 "samples", "stamp")

    def __init__(self):
        self.last_s = 0.0
        self.min_s: float | None = None
        self.max_s = 0.0
        self.ewma: dict[str, float] = {}
        self.hist = [0] * HIST_BUCKETS
        self.samples = 0
        self.stamp = 0.0

    def note(self, rtt_s: float, now: float) -> None:
        self.last_s = rtt_s
        self.min_s = rtt_s if self.min_s is None \
            else min(self.min_s, rtt_s)
        self.max_s = max(self.max_s, rtt_s)
        dt = max(0.0, now - self.stamp) if self.samples else 0.0
        for name, tau in WINDOWS:
            cur = self.ewma.get(name)
            if cur is None:
                self.ewma[name] = rtt_s
            else:
                # time-decayed EWMA: irregular ping spacing (thrash
                # stalls, injected delays) must not change the
                # window's effective horizon
                alpha = max(1.0 - math.exp(-dt / tau), 1e-3)
                self.ewma[name] = cur + alpha * (rtt_s - cur)
        us = max(0, int(rtt_s * 1e6))
        self.hist[min(HIST_BUCKETS - 1, us.bit_length())] += 1
        self.samples += 1
        self.stamp = now


class OsdNetwork:
    """The daemon's view of its peers' ping health.

    Registers itself on the context (``ctx.osd_network``) so the
    admin socket's ``dump_osd_network`` builtin resolves it lazily —
    the same backref pattern as the op tracker and flight recorder.
    Also keeps a bounded ring of per-peer cumulative wire-byte
    samples (heartbeat-paced) that the chrome-trace exporter renders
    as per-peer throughput counter tracks.
    """

    WIRE_CAP = 512

    def __init__(self, ctx=None):
        self.ctx = ctx
        self.peers: dict[int, _PeerRtt] = {}
        self.wire_ring: list[dict] = []
        if ctx is not None:
            ctx.osd_network = self

    # -- configuration -----------------------------------------------------

    def slow_threshold_s(self) -> float:
        """Slow-ping bar: explicit conf when set, else 5% of the
        heartbeat grace — a peer eating that much of its grace budget
        in RTT is degraded long before it is declared dead."""
        ms = 0.0
        if self.ctx is not None:
            try:
                ms = float(self.ctx.conf["osd_slow_ping_time_ms"])
            except Exception:
                ms = 0.0
        if ms > 0:
            return ms / 1000.0
        grace = 6.0
        if self.ctx is not None:
            try:
                grace = float(self.ctx.conf["heartbeat_grace"])
            except Exception:
                grace = 6.0
        return grace * 0.05

    # -- ingest ------------------------------------------------------------

    def note_rtt(self, peer: int, rtt_s: float,
                 now: float | None = None) -> None:
        if rtt_s < 0:
            return
        if now is None:
            now = time.monotonic()
        pr = self.peers.get(peer)
        if pr is None:
            pr = self.peers[peer] = _PeerRtt()
        pr.note(rtt_s, now)

    def sample_wire(self, now: float, peer_rows: dict) -> None:
        """Record cumulative per-peer tx/rx byte counters (from
        ``Messenger.net_dump()``) into the bounded trace ring."""
        for peer, row in sorted(peer_rows.items()):
            self.wire_ring.append({
                "t": now, "peer": peer,
                "tx": int(row.get("tx_bytes", 0)),
                "rx": int(row.get("rx_bytes", 0))})
        drop = len(self.wire_ring) - self.WIRE_CAP
        if drop > 0:
            del self.wire_ring[:drop]

    def prune(self, alive) -> None:
        """Forget peers no longer up in the map (mirrors the
        heartbeat-state prune: a revived OSD starts a fresh row)."""
        alive = set(alive)
        for peer in list(self.peers):
            if peer not in alive:
                del self.peers[peer]

    # -- derived views -----------------------------------------------------

    def slow_peers(self) -> list[int]:
        thr = self.slow_threshold_s()
        return sorted(p for p, pr in self.peers.items()
                      if pr.ewma.get("5s", 0.0) > thr
                      and pr.last_s > thr)

    def beacon_slice(self, cap: int = 16) -> dict | None:
        """The bounded MOSDBeacon net slice: worst ``cap`` peers by
        5s-window RTT plus the slow set.  None while no peer has
        answered a stamped ping, so legacy beacons stay byte-stable.
        """
        if not self.peers:
            return None
        worst = sorted(
            self.peers,
            key=lambda p: -self.peers[p].ewma.get("5s", 0.0))
        rtt = {str(p):
               round(self.peers[p].ewma.get("5s", 0.0) * 1000.0, 3)
               for p in worst[:cap]}
        return {"rtt_ms": rtt, "slow": self.slow_peers()}

    def summary(self) -> dict:
        """Daemon-wide rollup for the mgr report / digest."""
        if not self.peers:
            return {"peers": 0, "rtt_avg_ms": 0.0, "rtt_max_ms": 0.0}
        avgs = [pr.ewma.get("5s", 0.0) for pr in self.peers.values()]
        return {
            "peers": len(self.peers),
            "rtt_avg_ms": round(sum(avgs) / len(avgs) * 1000.0, 3),
            "rtt_max_ms": round(max(avgs) * 1000.0, 3)}

    def dump(self) -> dict:
        """The ``dump_osd_network`` admin-socket payload."""
        now = time.monotonic()
        peers = {}
        for p, pr in sorted(self.peers.items()):
            peers["osd.%d" % p] = {
                "last_ms": round(pr.last_s * 1000.0, 3),
                "min_ms": round((pr.min_s or 0.0) * 1000.0, 3),
                "max_ms": round(pr.max_s * 1000.0, 3),
                "avg_ms": {name: round(
                    pr.ewma.get(name, 0.0) * 1000.0, 3)
                    for name, _tau in WINDOWS},
                "hist_us_pow2": list(pr.hist),
                "samples": pr.samples,
                "age_s": round(now - pr.stamp, 3),
            }
        return {
            "threshold_ms": round(self.slow_threshold_s() * 1000.0, 3),
            "peers": peers,
            "slow": ["osd.%d" % p for p in self.slow_peers()]}
