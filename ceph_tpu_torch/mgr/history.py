"""Cluster history plane: fixed-memory downsampled metric rings.

Every observability surface before this PR is point-in-time: the mgr
digest is soft state with a 30 s TTL, the flight-recorder rings are
bounded snapshots, and bench figures are one-shot.  Kim et al.
(arXiv:1709.05365, PAPERS.md) characterize EC-cluster behavior from
measurements *over time* — p99 trajectories, utilization shifts, the
moment a pathology starts — so this module retains exactly that: an
RRD-style multi-resolution ring store fed each stats tick from the
already-folded digest.

* **HistoryStore** — per (series, label) a small set of downsampling
  tiers (default 5 s x 120 / 30 s x 120 / 5 min x 288: ten minutes
  fine, an hour medium, a day coarse).  Each tier cell is keyed by
  its absolute bucket index ``int(t // width)`` and aggregates
  (count, min, max, sum, last).  Memory is bounded by construction:
  at most ``cap`` cells per tier per labeled series, label
  cardinality capped per series (overflow is *dropped and counted*,
  never silently folded), and a missing bucket index IS the record
  of a gap — a dead mgr leaves holes, never interpolated cells.

* **Two instances, one feed.**  The mgr owns one (ingested in
  `_stats_loop`, serving the anomaly engine + exporter families +
  bench --observe), and EVERY mon folds each arriving MMonMgrDigest
  into its own (serving `perf history` locally) — so the query
  surface needs no new mon<->mgr protocol and survives leader
  elections with whatever history that mon has witnessed.

* **AnomalyEngine** — per-series EWMA mean/variance with a one-sided
  (upper) z-score and sustained-window raise/clear rules.  The
  baseline freezes while a series is anomalous, so a sustained shift
  stays raised instead of being adapted away, and clears only when
  the signal actually returns.  Active anomalies ride the digest
  (``digest["anomalies"]``) and the mon commits them as the
  paxos-persisted PERF_ANOMALY health edge (the SLO_BURN idiom: a
  fresh leader still warns).

The series names live in ``trace.registry.HISTORY_SERIES``; the
drift lint cross-checks them against this module's extractors and
the bench/test consumers in both directions.
"""

from __future__ import annotations

import time

# default downsampling ladder: (cell width seconds, ring capacity)
HISTORY_TIERS = ((5.0, 120), (30.0, 120), (300.0, 288))


def parse_tiers(spec) -> tuple:
    """Tier ladder from conf: either the 'width_s:cells,...' string
    form the config schema carries or an already-structured
    sequence of (width, cells) pairs."""
    if isinstance(spec, str):
        return tuple(
            (float(part.split(":")[0]), int(part.split(":")[1]))
            for part in spec.split(",") if part.strip())
    return tuple((float(w), int(cap)) for w, cap in spec)

# per-cell aggregate slots
_COUNT, _MIN, _MAX, _SUM, _LAST = range(5)


def extract_samples(digest: dict) -> list:
    """Flatten one mgr digest into (series, label, value) samples —
    the single place the HISTORY_SERIES names are emitted from (the
    registry lint scans these literals).  Labels are strings (pool
    id, chip index, tenant) or None for cluster-wide series."""
    out: list = []
    totals = digest.get("totals") or {}
    for series, key in (("io.read_ops_s", "read_ops_s"),
                        ("io.write_ops_s", "write_ops_s"),
                        ("io.read_bytes_s", "read_bytes_s"),
                        ("io.write_bytes_s", "write_bytes_s"),
                        ("recovery.ops_s", "recovery_ops_s"),
                        ("recovery.bytes_s", "recovery_bytes_s")):
        out.append((series, None, float(totals.get(key) or 0.0)))
    for pid, row in (digest.get("pools") or {}).items():
        out.append(("pg.degraded", str(pid),
                    float(row.get("degraded") or 0)))
        out.append(("pg.misplaced", str(pid),
                    float(row.get("misplaced") or 0)))
    for chip, row in (digest.get("device_util") or {}).items():
        out.append(("device.busy_frac", str(chip),
                    float(row.get("busy_frac") or 0.0)))
        out.append(("device.queue_wait_frac", str(chip),
                    float(row.get("queue_wait_frac") or 0.0)))
    for tenant, row in (digest.get("slo") or {}).items():
        out.append(("tenant.p99_ms", str(tenant),
                    float(row.get("p99_ms") or 0.0)))
        burn = row.get("burn_fast")
        if burn is not None:
            out.append(("tenant.burn_fast", str(tenant),
                        float(burn)))
    repair_read = repair_moved = 0
    for row in (digest.get("repair_traffic") or {}).values():
        repair_read += int(row.get("read") or 0)
        repair_moved += int(row.get("moved") or 0)
    out.append(("repair.bytes_read", None, float(repair_read)))
    out.append(("repair.bytes_moved", None, float(repair_moved)))
    dd_stored = dd_saved = 0
    for row in (digest.get("dedup_pools") or {}).values():
        dd_stored += int(row.get("bytes_stored") or 0)
        dd_saved += int(row.get("bytes_saved") or 0)
    out.append(("dedup.bytes_stored", None, float(dd_stored)))
    out.append(("dedup.bytes_saved", None, float(dd_saved)))
    # network plane: per-daemon worst-peer RTT, send-queue depth and
    # lossless resend rate — the AnomalyEngine watches rtt/resends so
    # a degrading link pages like a degrading chip does
    for daemon, row in (digest.get("net") or {}).items():
        out.append(("net.rtt_ms", str(daemon),
                    float(row.get("rtt_max_ms") or 0.0)))
        out.append(("net.queue_depth", str(daemon),
                    float(row.get("queue_depth") or 0)))
        out.append(("net.resend_rate", str(daemon),
                    float(row.get("resend_rate") or 0.0)))
    return out


class HistoryStore:
    """The fixed-memory ring store.  `ingest` folds one digest tick;
    `query` renders downsampled rows for one labeled series over a
    window, picking the finest tier that still covers it."""

    def __init__(self, ctx=None, tiers=None):
        self.ctx = ctx
        self._tiers = parse_tiers(
            tiers or (ctx and ctx.conf.get("history_tiers"))
            or HISTORY_TIERS)
        # (series, label) -> [tier dict: bucket index -> cell list]
        self._rings: dict[tuple, list] = {}
        # series -> label set (cardinality guard)
        self._labels: dict[str, set] = {}
        self.dropped_labels = 0
        self.ticks = 0

    @property
    def tiers(self) -> tuple:
        return self._tiers

    @property
    def label_max(self) -> int:
        if self.ctx is None:
            return 32
        return int(self.ctx.conf.get("history_label_max", 32))

    # -- ingest ----------------------------------------------------------

    def ingest(self, now: float, digest: dict,
               samples: list | None = None) -> None:
        self.ticks += 1
        if samples is None:
            samples = extract_samples(digest)
        for series, label, value in samples:
            self.note(series, label, now, value)

    def note(self, series: str, label, now: float,
             value: float) -> None:
        labels = self._labels.setdefault(series, set())
        if label not in labels:
            if len(labels) >= self.label_max:
                self.dropped_labels += 1
                return
            labels.add(label)
        ring = self._rings.get((series, label))
        if ring is None:
            ring = [dict() for _ in self._tiers]
            self._rings[(series, label)] = ring
        for (width, cap), cells in zip(self._tiers, ring):
            b = int(now // width)
            cell = cells.get(b)
            if cell is None:
                cells[b] = [1, value, value, value, value]
                if len(cells) > cap:
                    floor = b - cap
                    for k in [k for k in cells if k <= floor]:
                        del cells[k]
            else:
                cell[_COUNT] += 1
                if value < cell[_MIN]:
                    cell[_MIN] = value
                if value > cell[_MAX]:
                    cell[_MAX] = value
                cell[_SUM] += value
                cell[_LAST] = value

    # -- views -----------------------------------------------------------

    def series_names(self) -> list:
        """Sorted (series, label) pairs with any retained data."""
        return sorted(self._rings,
                      key=lambda k: (k[0], k[1] or ""))

    def query(self, series: str, label=None, window: float = 600.0,
              now: float | None = None) -> dict:
        """Downsampled rows for one labeled series: the finest tier
        whose retained span covers `window`.  Rows are
        [t_bucket, count, min, max, avg, last] in time order; a
        missing bucket is a gap (the mgr was dead or the series
        unfed) — never an interpolated cell."""
        now = time.time() if now is None else now
        ring = self._rings.get((series, label))
        if ring is None:
            return {"series": series, "label": label, "rows": [],
                    "tier_s": None, "window": window}
        ti = len(self._tiers) - 1
        for i, (width, cap) in enumerate(self._tiers):
            if width * cap >= window:
                ti = i
                break
        width, _cap = self._tiers[ti]
        lo = int((now - window) // width)
        rows = []
        for b in sorted(k for k in ring[ti] if k >= lo):
            c = ring[ti][b]
            rows.append([round(b * width, 3), c[_COUNT],
                         round(c[_MIN], 6), round(c[_MAX], 6),
                         round(c[_SUM] / c[_COUNT], 6),
                         round(c[_LAST], 6)])
        return {"series": series, "label": label, "tier_s": width,
                "window": window, "rows": rows}

    def latest(self, series: str, label=None,
               now: float | None = None):
        """(last value, age seconds) of the newest retained cell for
        one labeled series across all tiers — the stale-`status`
        fallback serves it (annotated with its age) once the live
        digest passes its TTL.  None when the series was never
        fed."""
        now = time.time() if now is None else now
        ring = self._rings.get((series, label))
        if ring is None:
            return None
        best = None
        for (width, _cap), cells in zip(self._tiers, ring):
            if not cells:
                continue
            b = max(cells)
            t = (b + 1) * width
            if best is None or t > best[0]:
                best = (t, cells[b][_LAST])
        if best is None:
            return None
        return best[1], max(0.0, now - best[0])

    def labels_for(self, series: str) -> list:
        """Retained labels for one series (the stale-panel fallback
        enumerates device chips with it)."""
        return sorted((lb for s, lb in self._rings
                       if s == series and lb is not None),
                      key=str)

    def cell_count(self) -> int:
        return sum(len(cells) for ring in self._rings.values()
                   for cells in ring)

    def max_cells(self) -> int:
        """The hard cell ceiling implied by the tier caps and the
        per-series label cap — what the memory-bound test and the
        bench --observe gate assert against."""
        per_series = sum(cap for _w, cap in self._tiers)
        n_series = sum(max(1, len(v)) for v in self._labels.values())
        return per_series * n_series

    def stats(self) -> dict:
        return {"ticks": self.ticks,
                "series": len(self._rings),
                "cells": self.cell_count(),
                "dropped_labels": self.dropped_labels,
                "tiers": [[w, c] for w, c in self._tiers]}


class AnomalyEngine:
    """EWMA mean/variance per labeled series with one-sided z-score
    + sustained-window raise/clear — the committed PERF_ANOMALY
    feed.

    Defaults are deliberately deaf (z >= 6 sustained for 8 ticks
    after 60 warm-up samples): routine load swings never page; the
    planted sustained shifts the thrash oracles drive do.  The
    baseline does not absorb anomalous samples, so a persistent
    shift stays raised until the signal actually recedes."""

    def __init__(self, ctx=None):
        self.ctx = ctx
        # (series, label) -> [n, mean, var, hot, cold, active]
        self._state: dict[tuple, list] = {}
        # active anomaly name -> detail row
        self.active: dict[str, dict] = {}

    def _conf(self, key, default):
        if self.ctx is None:
            return default
        return self.ctx.conf.get(key, default)

    @property
    def watched(self) -> tuple:
        spec = self._conf("history_anomaly_series", (
            "device.busy_frac", "device.queue_wait_frac",
            "tenant.p99_ms", "tenant.burn_fast",
            "net.rtt_ms", "net.resend_rate"))
        if isinstance(spec, str):
            spec = [s.strip() for s in spec.split(",") if s.strip()]
        return tuple(spec)

    @staticmethod
    def name_of(series: str, label) -> str:
        return series if label is None else "%s[%s]" % (series, label)

    def observe(self, samples: list) -> dict:
        """Fold one tick of (series, label, value) samples; returns
        the active-anomaly map the digest carries."""
        z_raise = float(self._conf("history_anomaly_z", 6.0))
        z_clear = float(self._conf("history_anomaly_clear_z", 2.0))
        sustain = int(self._conf("history_anomaly_sustain", 8))
        clear_n = int(self._conf("history_anomaly_clear", 4))
        min_n = int(self._conf("history_anomaly_min_samples", 60))
        alpha = float(self._conf("history_anomaly_alpha", 0.05))
        watched = self.watched
        for series, label, value in samples:
            if series not in watched:
                continue
            key = (series, label)
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = [0, value, 0.0, 0, 0, False]
            n, mean, var, hot, cold, active = st
            std = max(var, 1e-12) ** 0.5
            # one-sided: only a sustained INCREASE is an anomaly (a
            # cluster going idle is a non-event, not a page)
            z = (value - mean) / std if n >= min_n else 0.0
            name = self.name_of(series, label)
            if z >= z_raise:
                hot += 1
                cold = 0
                if not active and hot >= sustain:
                    active = True
                if active:
                    self.active[name] = {
                        "series": series, "label": label,
                        "value": round(value, 6),
                        "mean": round(mean, 6),
                        "z": round(z, 2)}
            else:
                hot = 0
                if active:
                    if z < z_clear:
                        cold += 1
                        if cold >= clear_n:
                            active = False
                            cold = 0
                            self.active.pop(name, None)
                    else:
                        cold = 0
            # freeze the baseline while the series runs hot, so a
            # sustained shift cannot train itself back to normal
            if z < z_clear:
                n += 1
                d = value - mean
                if n < min_n:
                    # warm-up: flat averages converge fast from the
                    # first sample instead of chasing EWMA lag
                    mean += d / n
                    var += (d * (value - mean) - var) / n
                else:
                    mean += alpha * d
                    var = (1 - alpha) * (var + alpha * d * d)
            st[0], st[1], st[2] = n, mean, var
            st[3], st[4], st[5] = hot, cold, active
        return {k: dict(v) for k, v in sorted(self.active.items())}
