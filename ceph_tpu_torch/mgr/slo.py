"""Per-tenant SLO engine: multi-window burn rates over the tenant
stage histograms the OSDs report.

The SRE-workbook alerting model (multiwindow, multi-burn-rate) applied
to the tenant plane Kim et al. (arXiv:1709.05365) motivates: each
tenant has a **latency objective** — `slo_latency_objective` (e.g.
99%) of its ops must finish under `slo_latency_target_ms` — and an
**availability objective** sharing the same error budget (an errored
op spends budget exactly like a too-slow one).  The budget is
`1 - objective`; the **burn rate** over a window is

    burn(W) = (bad ops in W / total ops in W) / (1 - objective)

so burn 1.0 spends the budget exactly at the sustainable rate and
burn 14.4 exhausts a 30-day budget in ~2 days.  SLO_BURN raises only
when BOTH the fast and the slow window burn past their thresholds
(`slo_burn_fast` / `slo_burn_slow`) — a lone spike never pages, a
sustained burn pages fast; SLO_LATENCY is the immediate p99-over-
target breach detail beside it.

Inputs are the cumulative per-tenant stage histograms (pow2 µs
buckets) and good/bad op counters each OSD ships in MMgrReport
``osd_stats["tenants"]`` — the engine keeps a bounded ring of
aggregate snapshots per tenant and derives every window figure from
snapshot deltas, so one mgr restart costs at most one window of
history and no daemon keeps per-window state.

"Bad" latency counting is bucket-resolution conservative: a pow2
bucket counts as over-target only when its LOWER bound already
exceeds the target, so the engine never over-reports a burn from
bucket granularity.
"""

from __future__ import annotations

N_BUCKETS = 32

# every tenant stage histogram family the OSDs emit (the registry
# drift lint cross-checks these against the note_tenant_stage call
# sites): queue_wait (mClock shard dequeue), subop_rtt (replicated
# commit round trip), ec_batch_wait (encode incl batch window),
# device_dispatch (the op's own flush ticket), total (end-to-end,
# the SLO engine's latency input)
TENANT_STAGES = ("queue_wait", "subop_rtt", "ec_batch_wait",
                 "device_dispatch", "total")


def _hist_add(acc: list[int], hist) -> None:
    for i, v in enumerate(hist[:N_BUCKETS]):
        acc[i] += int(v)


def _hist_sub(a: list[int], b: list[int]) -> list[int]:
    # counter resets (OSD restart) clamp at zero: one window of
    # undercounted rate, never a negative burn
    return [max(0, x - y) for x, y in zip(a, b)]


def hist_p_ms(hist: list[int], p: float) -> float:
    """The p-quantile's bucket UPPER bound in ms (pow2-µs buckets:
    bucket i counts samples in [2^i, 2^(i+1)) µs)."""
    total = sum(hist)
    if not total:
        return 0.0
    want = p * total
    cum = 0
    for i, n in enumerate(hist):
        cum += n
        if cum >= want:
            return float(1 << (i + 1)) / 1e3
    return float(1 << len(hist)) / 1e3


def hist_over_ms(hist: list[int], target_ms: float) -> int:
    """Samples in buckets whose lower bound exceeds target_ms
    (conservative: the bucket containing the target counts good)."""
    target_us = max(1.0, target_ms * 1e3)
    out = 0
    for i, n in enumerate(hist):
        if float(1 << i) >= target_us:
            out += n
    return out


class SLOEngine:
    """Aggregates the per-daemon tenant rows into per-tenant burn
    verdicts.  One instance on the mgr; `ingest` runs per stats tick,
    `evaluate` feeds the digest (and through it the mon's
    SLO_LATENCY / SLO_BURN health checks)."""

    RING_CAP = 2048

    def __init__(self, ctx):
        self.ctx = ctx
        # tenant -> list of (t, ops, errors, total_hist) snapshots
        self._rings: dict[str, list] = {}

    # -- live conf -------------------------------------------------------

    @property
    def target_ms(self) -> float:
        return float(self.ctx.conf.get("slo_latency_target_ms",
                                       100.0))

    @property
    def objective(self) -> float:
        return float(self.ctx.conf.get("slo_latency_objective", 0.99))

    @property
    def fast_window(self) -> float:
        return float(self.ctx.conf.get("slo_fast_window", 60.0))

    @property
    def slow_window(self) -> float:
        return float(self.ctx.conf.get("slo_slow_window", 300.0))

    @property
    def min_ops(self) -> int:
        return int(self.ctx.conf.get("slo_min_ops", 30))

    # -- ingest ----------------------------------------------------------

    def ingest(self, now: float, osd_stats_rows: dict) -> None:
        """Fold one stats tick: `osd_stats_rows` is the mgr's
        live_osd_stats view ({daemon: row}); each row's "tenants"
        map carries that daemon's cumulative tenant counters.  The
        cluster aggregate (sum over daemons) becomes one ring
        snapshot per tenant."""
        agg: dict[str, dict] = {}
        for row in osd_stats_rows.values():
            for tenant, trow in (row.get("tenants") or {}).items():
                a = agg.setdefault(tenant, {
                    "ops": 0, "errors": 0,
                    "hist": [0] * N_BUCKETS})
                a["ops"] += int(trow.get("ops") or 0)
                a["errors"] += int(trow.get("errors") or 0)
                total = (trow.get("stages") or {}).get("total")
                if total:
                    _hist_add(a["hist"], total)
        horizon = 2.0 * max(self.fast_window, self.slow_window)
        for tenant, a in agg.items():
            ring = self._rings.setdefault(tenant, [])
            ring.append((now, a["ops"], a["errors"], a["hist"]))
            while ring and (now - ring[0][0] > horizon
                            or len(ring) > self.RING_CAP):
                ring.pop(0)

    # -- evaluation ------------------------------------------------------

    def _window_delta(self, ring: list, now: float, window: float):
        """(ops, bad, hist) deltas between the newest snapshot and
        the oldest one inside the window (None without two points)."""
        newest = ring[-1]
        base = None
        for snap in ring:
            if now - snap[0] <= window:
                base = snap
                break
        if base is None or base is newest:
            return None
        hist = _hist_sub(newest[3], base[3])
        ops = max(0, newest[1] - base[1])
        errors = max(0, newest[2] - base[2])
        return ops, errors, hist

    def evaluate(self, now: float) -> dict[str, dict]:
        """Per-tenant verdicts for the digest: window p99, burn rates
        over both windows, and the two alert booleans the mon turns
        into paxos-committed health edges."""
        budget = max(1e-6, 1.0 - self.objective)
        out: dict[str, dict] = {}
        for tenant, ring in self._rings.items():
            if not ring:
                continue

            def burn(win):
                d = self._window_delta(ring, now, win)
                if d is None or d[0] <= 0:
                    return None, 0, None
                ops, errors, hist = d
                bad = hist_over_ms(hist, self.target_ms) + errors
                return (bad / ops) / budget, ops, hist

            burn_fast, ops_fast, hist_fast = burn(self.fast_window)
            burn_slow, ops_slow, _h = burn(self.slow_window)
            p99 = (hist_p_ms(hist_fast, 0.99)
                   if hist_fast is not None else 0.0)
            enough = ops_fast >= self.min_ops
            lat_violation = bool(enough and p99 > self.target_ms)
            burn_alert = bool(
                enough and burn_fast is not None
                and burn_slow is not None
                and burn_fast >= float(self.ctx.conf.get(
                    "slo_burn_fast", 14.4))
                and burn_slow >= float(self.ctx.conf.get(
                    "slo_burn_slow", 6.0)))
            out[tenant] = {
                "ops_total": int(ring[-1][1]),
                "errors_total": int(ring[-1][2]),
                "window_ops": int(ops_fast),
                "p99_ms": round(p99, 3),
                "target_ms": self.target_ms,
                "burn_fast": (round(burn_fast, 3)
                              if burn_fast is not None else None),
                "burn_slow": (round(burn_slow, 3)
                              if burn_slow is not None else None),
                "latency_violation": lat_violation,
                "burn_alert": burn_alert,
            }
        return out
