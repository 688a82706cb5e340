"""Manager daemon: cluster-wide aggregation + autonomous balancing.

Condensed analog of src/mgr/ (DaemonServer.cc receiving every
daemon's perf-counter reports, ClusterState caching maps) plus the two
mgr python modules the survey calls first-class:

* prometheus — ONE scrape endpoint exposing per-OSD op counters and a
  PG-state summary for the whole cluster (pybind/mgr/prometheus);
* balancer  — a timer loop running the upmap optimizer
  (pybind/mgr/balancer/module.py Module.serve) and committing the
  computed pg_upmap_items through the monitor, so a skewed cluster
  converges without operator action.

Registration rides the map: `mgr register` stores this daemon's
address in OSDMap.mgr_addr (the MgrMap role) and every OSD's
heartbeat loop ships MMgrReport there (OSD::ms_handle ->
MgrClient::send_report in the reference).
"""

from __future__ import annotations

import asyncio

from ..msg import Messenger
from ..msg.messenger import ms_compress_from_conf
from ..msg.messages import (MConfig, MMgrReport, MMonCommand, MMonCommandAck,
                            MMonGetMap, MMonMgrDigest, MMonSubscribe,
                            MOSDMapMsg)
from ..osd.osdmap import OSDMap, consume_map_payload
from ..utils.context import Context
from ..utils.exporter import PrometheusExporter
from .pgmap import PGMap, RATE_KEYS


def _fam_header(lines: list, fam: str, kind: str,
                desc: str) -> None:
    """Append one family's `# HELP` + `# TYPE` header (the
    exposition-format pair the exporter lint requires)."""
    lines.append("# HELP %s %s" % (fam, desc))
    lines.append("# TYPE %s %s" % (fam, kind))


def ingest_prom_lines(pgmap) -> list[str]:
    """Telemetry-fabric ingest families rendered from a PGMap's
    accounting (module-level so `bench.py --scale`'s ingest leg can
    lint the exposition without a live Manager): per-format report
    row/byte counters, the apply-latency histogram, the row-loop
    fallback counter, and the visible prune counters."""
    from ..utils.exporter import hist_lines
    ing = pgmap.ingest
    lines: list[str] = []
    for fam, key in (("ceph_tpu_mgr_report_rows_total", "rows"),
                     ("ceph_tpu_mgr_report_bytes_total", "bytes")):
        _fam_header(lines, fam, "counter",
                    "MMgrReport stat %s ingested by wire format"
                    % key)
        for fmt in ("columnar", "legacy"):
            lines.append('%s{format="%s"} %d'
                         % (fam, fmt, ing[key][fmt]))
    lines.extend(hist_lines("ceph_tpu_mgr_ingest_seconds",
                            ing["seconds_hist"],
                            desc="per-report PGMap apply latency"))
    _fam_header(lines, "ceph_tpu_mgr_ingest_fallback_rows_total",
                "counter",
                "stat rows that fell back to the legacy row loop")
    lines.append("ceph_tpu_mgr_ingest_fallback_rows_total %d"
                 % ing["fallback_rows"])
    _fam_header(lines, "ceph_tpu_mgr_rows_pruned_total", "counter",
                "PGMap rows reclaimed, by prune reason")
    for reason, count in (("stale", pgmap.pruned_stale),
                          ("pool", pgmap.pruned_pool),
                          ("daemon", pgmap.pruned_daemons)):
        lines.append(
            'ceph_tpu_mgr_rows_pruned_total{reason="%s"} %d'
            % (reason, count))
    return lines


class Manager:
    def __init__(self, mon_addr, ctx: Context | None = None,
                 balance_interval: float = 5.0, device=None):
        from .. import default_device
        self.device = default_device(device)
        self.mon_addrs = ([mon_addr] if isinstance(mon_addr, str)
                          else list(mon_addr))
        self.ctx = ctx or Context("mgr")
        from ..msg.auth import AuthContext
        self.msgr = Messenger(
            "mgr", auth=AuthContext.from_conf(self.ctx.conf),
            compress=ms_compress_from_conf(self.ctx.conf))
        self.msgr.add_dispatcher(self)
        self.osdmap: OSDMap = OSDMap()
        self.balance_interval = balance_interval
        self.balancer_enabled = True
        self.balancer_rounds = 0
        self.balancer_changes = 0
        # daemon -> {"perf": .., "pg_states": .., "stamp": ..}
        self.daemon_reports: dict[str, dict] = {}
        # cluster statistics plane: per-PG stat rows folded into the
        # PGMap; a periodic digest feeds the monitors (status/df/
        # pool-stats + PG_* health)
        self.pgmap = PGMap(stale_after=float(
            self.ctx.conf.get("mgr_stats_stale_after", 15.0)))
        self.stats_period = float(
            self.ctx.conf.get("mgr_stats_period", 1.0))
        self.digests_sent = 0
        # tenant SLO plane: multi-window burn-rate engine over the
        # per-tenant stage histograms the OSDs report; its verdicts
        # ride the digest into the mon's SLO_LATENCY/SLO_BURN checks
        from .slo import SLOEngine
        self.slo = SLOEngine(self.ctx)
        # history plane: fixed-memory downsampled rings fed each
        # stats tick from the folded digest, plus the EWMA/z-score
        # anomaly rules whose verdicts ride the digest into the
        # mon's committed PERF_ANOMALY edge
        from .history import AnomalyEngine, HistoryStore
        self.history = HistoryStore(self.ctx)
        self.anomaly = AnomalyEngine(self.ctx)
        self.history_ingest_s = 0.0
        self.exporter = PrometheusExporter(self.ctx)
        # cluster-log handle: mgr events ride the same
        # LogClient -> MLog -> LogMonitor pipeline as OSD events
        from ..trace import LogClient
        self.clog = LogClient(self.ctx, "mgr",
                              send_fn=self._broadcast_mons)
        self._tid = 0
        self._cmd_futures: dict[int, asyncio.Future] = {}
        self._tasks: list = []

    def _broadcast_mons(self, msg) -> None:
        for i, addr in enumerate(self.mon_addrs):
            self.msgr.send_to(addr, msg, entity_hint="mon.%d" % i)

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    http_port: int = 0) -> str:
        addr = await self.msgr.bind(host, port)
        mon = self.msgr.connect_to(self.mon_addrs[0],
                                   entity_hint="mon.0")
        mon.send(MMonSubscribe(start=1))
        await self._register()
        self.clog.info("mgr active at %s" % self.msgr.addr)
        self.http_addr = await self.exporter.start(host, http_port)
        self._register_cluster_gauges()
        self._tasks.append(self.msgr.spawn(self._balancer_loop()))
        self._tasks.append(self.msgr.spawn(self._stats_loop()))
        self.ctx.log.info("mgr", "mgr serving at %s (metrics %s)"
                          % (addr, self.http_addr))
        return addr

    async def shutdown(self) -> None:
        await self.exporter.stop()
        await self.msgr.shutdown()

    async def _register(self) -> None:
        await self.mon_command("mgr register", addr=self.msgr.addr)

    # -- dispatch ----------------------------------------------------------

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MConfig):
            self.ctx.conf.apply_mon_values(msg.values or {})
            return True
        from ..msg.messages import MLogAck
        if isinstance(msg, MLogAck):
            self.clog.handle_ack(msg.who, int(msg.last or 0),
                                 inc=getattr(msg, "inc", None))
            return True
        if isinstance(msg, MOSDMapMsg):
            self.osdmap, _ = consume_map_payload(
                self.osdmap, msg.full, msg.incrementals)
            return True
        if isinstance(msg, MMgrReport):
            now = asyncio.get_event_loop().time()
            self.daemon_reports[msg.daemon] = {
                "perf": msg.perf or {},
                "pg_states": msg.pg_states or {},
                "num_pgs": msg.num_pgs or 0,
                "num_objects": msg.num_objects or 0,
                "epoch": msg.epoch,
                "stamp": now,
            }
            self.pgmap.apply_report(
                msg.daemon, msg.pg_stats, msg.osd_stats, now,
                pg_stats_cols=getattr(msg, "pg_stats_cols", None),
                nbytes=getattr(msg, "wire_bytes", None))
            return True
        if isinstance(msg, MMonCommandAck):
            fut = self._cmd_futures.pop(msg.tid, None)
            if fut is not None and not fut.done():
                if msg.result == 0:
                    fut.set_result(msg.out or {})
                else:
                    fut.set_exception(IOError(msg.result, msg.out))
            return True
        return False

    async def mon_command(self, prefix: str, timeout: float = 10.0,
                          **args) -> dict:
        cmd = {"prefix": prefix}
        cmd.update(args)
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_event_loop().create_future()
        self._cmd_futures[tid] = fut
        self.msgr.send_to(self.mon_addrs[0],
                          MMonCommand(tid=tid, cmd=cmd),
                          entity_hint="mon.0")
        return await asyncio.wait_for(fut, timeout)

    # -- prometheus surface ------------------------------------------------

    def _register_cluster_gauges(self) -> None:
        exp = self.exporter
        exp.add_gauge("cluster_osdmap_epoch",
                      lambda: self.osdmap.epoch, "map epoch")
        exp.add_gauge("cluster_num_osds",
                      lambda: self.osdmap.max_osd, "osds in map")
        exp.add_gauge(
            "cluster_num_up_osds",
            lambda: sum(1 for o in range(self.osdmap.max_osd)
                        if self.osdmap.is_up(o)), "up osds")
        exp.add_gauge("cluster_num_pools",
                      lambda: len(self.osdmap.pools), "pools")
        exp.add_gauge("mgr_daemons_reporting",
                      lambda: len(self.daemon_reports),
                      "daemons with a live report")
        exp.add_gauge("cluster_slow_ops", self._total_slow_ops,
                      "slow ops summed over every daemon's report")
        exp.add_gauge("balancer_rounds",
                      lambda: self.balancer_rounds,
                      "balancer optimizer runs")
        exp.add_gauge("balancer_changes",
                      lambda: self.balancer_changes,
                      "upmap items committed by the balancer")
        exp.add_gauge("history_cells",
                      lambda: self.history.cell_count(),
                      "retained history ring cells (bounded)")
        exp.add_gauge("history_ticks",
                      lambda: self.history.ticks,
                      "digest ticks folded into the history rings")
        exp.add_gauge("history_ingest_seconds",
                      lambda: round(self.history_ingest_s, 6),
                      "cumulative history-plane ingest time")
        exp.add_gauge("history_anomalies_active",
                      lambda: len(self.anomaly.active),
                      "series currently flagged by the anomaly rules")
        exp.add_renderer(self._render_reports)
        exp.add_renderer(self._render_pgmap)
        exp.add_renderer(self._render_event_plane)
        exp.add_renderer(self._render_tenants)
        exp.add_renderer(self._render_ingest)
        exp.add_renderer(self._render_net)

    def _total_slow_ops(self) -> int:
        """Cluster-wide slow-op count aggregated from the per-daemon
        reports (the mgr-side mirror of the mon's SLOW_OPS input)."""
        total = 0
        for rep in self.daemon_reports.values():
            osd_grp = (rep.get("perf") or {}).get("osd") or {}
            v = osd_grp.get("slow_ops", 0)
            if isinstance(v, (int, float)):
                total += int(v)
        return total

    def _render_reports(self) -> list[str]:
        """Per-daemon series from the MMgrReports (the prometheus
        module's per-daemon metric families).  Stage-latency
        histograms (PerfCounters pow2 buckets) render as labeled
        Prometheus histogram series.  Every family gets exactly one
        `# TYPE` line (the exposition-format requirement the exporter
        lint pins)."""
        from ..utils.exporter import hist_lines
        lines: list[str] = []
        typed: set[str] = set()

        def emit(family: str, label: str, value, kind="gauge",
                 desc=None):
            if family not in typed:
                typed.add(family)
                _fam_header(lines, family, kind,
                            desc or "per-daemon %s from MMgrReports"
                            % family.split("ceph_tpu_daemon_")[-1])
            lines.append("%s%s %g" % (family, label, value))

        pg_totals: dict[str, int] = {}
        for daemon in sorted(self.daemon_reports):
            rep = self.daemon_reports[daemon]
            label = '{daemon="%s"}' % daemon
            for grp, counters in sorted(
                    (rep.get("perf") or {}).items()):
                if not isinstance(counters, dict):
                    continue
                for cname, val in sorted(counters.items()):
                    if isinstance(val, (int, float)):
                        emit("ceph_tpu_daemon_%s_%s" % (grp, cname),
                             label, val, kind="counter")
                    elif isinstance(val, dict) \
                            and "buckets_us_pow2" in val:
                        lines.extend(hist_lines(
                            "ceph_tpu_daemon_%s_%s" % (grp, cname),
                            val["buckets_us_pow2"],
                            labels='daemon="%s"' % daemon,
                            typed=typed,
                            desc="per-daemon %s.%s latency "
                                 "histogram (us pow2 buckets)"
                                 % (grp, cname)))
            emit("ceph_tpu_daemon_num_pgs", label,
                 rep.get("num_pgs") or 0)
            emit("ceph_tpu_daemon_num_objects", label,
                 rep.get("num_objects") or 0)
            for state, n in (rep.get("pg_states") or {}).items():
                pg_totals[state] = pg_totals.get(state, 0) + n
        for state in sorted(pg_totals):
            emit("ceph_tpu_pg_state", '{state="%s"}' % state,
                 pg_totals[state],
                 desc="cluster PG count by state")
        return lines

    def _render_pgmap(self) -> list[str]:
        """PGMap-derived families: per-pool usage + IO/recovery rates
        and cluster totals — the `ceph -s` io:/recovery: lines and
        `df` columns as scrapeable series, plus the cluster op-size
        histogram the workload-aware warmup feeds on."""
        now = asyncio.get_event_loop().time()
        pools = set(self.osdmap.pools)
        per_pool = self.pgmap.pool_totals(now, pools)
        lines: list[str] = []
        gauges = ("objects", "bytes", "degraded", "misplaced",
                  "unfound", "scrub_errors") + RATE_KEYS
        for g in gauges:
            fam = "ceph_tpu_pool_%s" % g
            _fam_header(lines, fam, "gauge",
                        "per-pool %s from the PGMap fold" % g)
            for pid in sorted(per_pool):
                name = (self.osdmap.pools[pid].name
                        if pid in self.osdmap.pools else str(pid))
                lines.append('%s{pool="%s",pool_id="%d"} %g'
                             % (fam, name, pid, per_pool[pid][g]))
        totals = {g: sum(r[g] for r in per_pool.values())
                  for g in gauges}
        for g in gauges:
            fam = "ceph_tpu_cluster_%s" % g
            _fam_header(lines, fam, "gauge",
                        "cluster-total %s from the PGMap fold" % g)
            lines.append("%s %g" % (fam, totals[g]))
        # repair-traffic plane: per-codec recovery bytes summed
        # across the live fleet (read from survivors via
        # minimum_to_decode's minimal sets / moved to rebuilt
        # shards) — the codec-labeled figure the LRC-vs-RS oracle
        # compares
        repair: dict[str, dict] = {}
        for row in self.pgmap.live_osd_stats(now).values():
            for cname, rrow in (row.get("repair") or {}).items():
                agg = repair.setdefault(str(cname),
                                        {"read": 0, "moved": 0})
                agg["read"] += int(rrow.get("read", 0) or 0)
                agg["moved"] += int(rrow.get("moved", 0) or 0)
        _fam_header(lines, "ceph_tpu_repair_bytes_read_total",
                    "counter",
                    "survivor shard bytes read by recovery, by codec")
        for cname in sorted(repair):
            lines.append(
                'ceph_tpu_repair_bytes_read_total{codec="%s"} %d'
                % (cname, repair[cname]["read"]))
        _fam_header(lines, "ceph_tpu_repair_bytes_moved_total",
                    "counter",
                    "rebuilt shard bytes moved by recovery, by codec")
        for cname in sorted(repair):
            lines.append(
                'ceph_tpu_repair_bytes_moved_total{codec="%s"} %d'
                % (cname, repair[cname]["moved"]))
        # data-reduction plane: per-pool dedup counters summed
        # across the live fleet (chunks newly stored vs answered by
        # an existing content address, logical bytes that never hit
        # the chunk store) — the pool-labeled figure bench --dedup
        # cross-checks against the chunk store's actual usage
        dedup: dict[str, dict] = {}
        for row in self.pgmap.live_osd_stats(now).values():
            for pid, drow in (row.get("dedup") or {}).items():
                agg = dedup.setdefault(
                    str(pid), {"chunks_stored": 0,
                               "chunks_deduped": 0, "bytes_saved": 0})
                for kk in agg:
                    agg[kk] += int(drow.get(kk, 0) or 0)
        _fam_header(lines, "ceph_tpu_dedup_chunks_stored_total",
                    "counter",
                    "chunks newly written to the chunk store")
        for pid in sorted(dedup):
            lines.append(
                'ceph_tpu_dedup_chunks_stored_total{pool_id="%s"} %d'
                % (pid, dedup[pid]["chunks_stored"]))
        _fam_header(lines, "ceph_tpu_dedup_chunks_deduped_total",
                    "counter",
                    "chunks answered by an existing content address")
        for pid in sorted(dedup):
            lines.append(
                'ceph_tpu_dedup_chunks_deduped_total{pool_id="%s"} %d'
                % (pid, dedup[pid]["chunks_deduped"]))
        _fam_header(lines, "ceph_tpu_dedup_bytes_saved_total",
                    "counter",
                    "logical bytes that never hit the chunk store")
        for pid in sorted(dedup):
            lines.append(
                'ceph_tpu_dedup_bytes_saved_total{pool_id="%s"} %d'
                % (pid, dedup[pid]["bytes_saved"]))
        # integrity-plane summary series (the scrub_* families the
        # exporter lint pins): damaged-PG count beside the summed
        # error total the pool/cluster gauges above already carry
        _fam_header(lines, "ceph_tpu_scrub_inconsistent_pgs",
                    "gauge",
                    "PGs with unrepaired scrub inconsistencies")
        lines.append("ceph_tpu_scrub_inconsistent_pgs %d"
                     % self.pgmap.inconsistent_pgs(now, pools))
        _fam_header(lines, "ceph_tpu_scrub_errors_total", "gauge",
                    "summed scrub error count across pools")
        lines.append("ceph_tpu_scrub_errors_total %d"
                     % totals.get("scrub_errors", 0))
        hist = self.pgmap.op_size_hist(now)
        if hist:
            fam = "ceph_tpu_cluster_op_size_bytes"
            _fam_header(lines, fam, "histogram",
                        "client write size distribution "
                        "(pow2 byte buckets)")
            cum = 0
            for i, n in enumerate(hist):
                cum += n
                lines.append('%s_bucket{le="%g"} %d'
                             % (fam, float(1 << (i + 1)), cum))
            lines.append('%s_bucket{le="+Inf"} %d' % (fam, cum))
            lines.append("%s_count %d" % (fam, cum))
        return lines

    def _render_event_plane(self) -> list[str]:
        """Cluster-log emission counters
        (ceph_tpu_log_messages_total{daemon,level}) from every
        daemon's clog handle (shipped in MMgrReport osd_stats; the
        mgr contributes its own handle directly) plus the per-OSD
        statfs axis (raw capacity/utilization)."""
        now = asyncio.get_event_loop().time()
        rows = self.pgmap.live_osd_stats(now)
        lines: list[str] = []
        fam = "ceph_tpu_log_messages_total"
        _fam_header(lines, fam, "counter",
                    "cluster-log emissions by daemon and level")
        clog_rows = {d: (row.get("log_messages") or {})
                     for d, row in rows.items()}
        clog_rows["mgr"] = self.clog.counts_wire()
        for daemon in sorted(clog_rows):
            for level in sorted(clog_rows[daemon]):
                lines.append(
                    '%s{daemon="%s",level="%s"} %d'
                    % (fam, daemon, level, clog_rows[daemon][level]))
        for fam, key in (("ceph_tpu_osd_statfs_total_bytes", "total"),
                         ("ceph_tpu_osd_statfs_used_bytes", "used")):
            _fam_header(lines, fam, "gauge",
                        "per-OSD store statfs %s bytes" % key)
            for daemon in sorted(rows):
                sf = rows[daemon].get("statfs")
                if sf:
                    lines.append('%s{daemon="%s"} %d'
                                 % (fam, daemon,
                                    int(sf.get(key) or 0)))
        return lines

    def _tenant_rows(self, now: float) -> dict[str, dict]:
        """Cluster-aggregate per-tenant counters from the live daemon
        reports, with label cardinality CAPPED at `tenant_label_max`:
        the busiest tenants keep their own rows, the tail folds into
        "other" — a tenant-id flood can never blow up the exporter's
        (or the digest's) label space."""
        agg: dict[str, dict] = {}
        for row in self.pgmap.live_osd_stats(now).values():
            for tenant, trow in (row.get("tenants") or {}).items():
                a = agg.setdefault(tenant, {
                    "ops": 0, "errors": 0, "total_hist": [0] * 32})
                a["ops"] += int(trow.get("ops") or 0)
                a["errors"] += int(trow.get("errors") or 0)
                th = (trow.get("stages") or {}).get("total")
                for i, v in enumerate((th or [])[:32]):
                    a["total_hist"][i] += int(v)
        cap = max(1, int(self.ctx.conf.get("tenant_label_max", 32)))
        if len(agg) <= cap:
            return agg
        keep = sorted(agg, key=lambda t: (-agg[t]["ops"], t))[:cap - 1]
        out = {t: agg[t] for t in keep}
        other = out.setdefault("other", {
            "ops": 0, "errors": 0, "total_hist": [0] * 32})
        for t, a in agg.items():
            if t in keep:
                continue
            other["ops"] += a["ops"]
            other["errors"] += a["errors"]
            for i, v in enumerate(a["total_hist"]):
                other["total_hist"][i] += v
        return out

    def _render_tenants(self) -> list[str]:
        """Tenant-labeled families (cardinality-capped): per-tenant
        op/error totals, the end-to-end latency histogram, and the
        SLO engine's burn figures — the scrape surface of the tenant
        SLO plane."""
        import asyncio as _aio

        from ..utils.exporter import hist_lines
        now = _aio.get_event_loop().time()
        rows = self._tenant_rows(now)
        if not rows:
            return []
        lines: list[str] = []
        for fam, key in (("ceph_tpu_tenant_ops_total", "ops"),
                         ("ceph_tpu_tenant_errors_total", "errors")):
            _fam_header(lines, fam, "counter",
                        "per-tenant %s (cardinality-capped)" % key)
            for t in sorted(rows):
                lines.append('%s{tenant="%s"} %d'
                             % (fam, t, rows[t][key]))
        typed: set[str] = set()
        for t in sorted(rows):
            lines.extend(hist_lines("ceph_tpu_tenant_op_seconds",
                                    rows[t]["total_hist"],
                                    labels='tenant="%s"' % t,
                                    typed=typed,
                                    desc="per-tenant end-to-end op "
                                         "latency (us pow2 buckets)"))
        slo = self.slo.evaluate(now)
        for fam, key in (("ceph_tpu_tenant_slo_burn_fast",
                          "burn_fast"),
                         ("ceph_tpu_tenant_slo_burn_slow",
                          "burn_slow"),
                         ("ceph_tpu_tenant_p99_ms", "p99_ms")):
            _fam_header(lines, fam, "gauge",
                        "per-tenant SLO engine %s" % key)
            for t in sorted(slo):
                if t not in rows:
                    continue    # capped out of the label space
                v = slo[t].get(key)
                if v is not None:
                    lines.append('%s{tenant="%s"} %g' % (fam, t, v))
        return lines

    def _render_ingest(self) -> list[str]:
        """Telemetry-fabric ingest observability: report rows/bytes
        by wire format, apply latency, fallback + prune counters —
        the stat pipeline measured like every other plane."""
        return ingest_prom_lines(self.pgmap)

    def _render_net(self) -> list[str]:
        """Network-plane families (NET_SERIES): per-daemon resend/
        replay/queue figures, per-peer wire byte totals and the
        heartbeat RTT matrix.  Peer cardinality is capped per daemon
        like tenant labels: the busiest peers keep their own rows,
        the tail folds into "other" — a client-entity flood can
        never blow up the exporter's label space."""
        import asyncio as _aio
        now = _aio.get_event_loop().time()
        rows: dict[str, dict] = {}
        for daemon, srow in sorted(
                self.pgmap.live_osd_stats(now).items()):
            nrow = srow.get("net")
            if nrow:
                rows[daemon] = nrow
        if not rows:
            return []
        cap = max(1, int(self.ctx.conf.get("net_label_max", 8)))
        lines: list[str] = []
        for fam, key, kind, desc in (
                ("ceph_tpu_net_resends_total", "resends", "counter",
                 "lossless payloads requeued for session replay"),
                ("ceph_tpu_net_replays_total", "replays", "counter",
                 "duplicate frames absorbed by seq dedup after"
                 " reconnect"),
                ("ceph_tpu_net_mark_downs_total", "mark_downs",
                 "counter", "administrative connection teardowns"),
                ("ceph_tpu_net_queue_depth", "queue_depth", "gauge",
                 "frames waiting in send queues")):
            _fam_header(lines, fam, kind, desc)
            for daemon in rows:
                lines.append('%s{daemon="%s"} %g'
                             % (fam, daemon,
                                float(rows[daemon].get(key, 0)
                                      or 0)))

        def folded(peers: dict) -> dict:
            if len(peers) <= cap:
                return peers
            keep = sorted(peers, key=lambda p:
                          (-int(peers[p].get("tx_bytes", 0) or 0),
                           p))[:cap - 1]
            out = {p: peers[p] for p in keep}
            other = {"tx_bytes": 0, "rx_bytes": 0}
            for p, r in peers.items():
                if p in out:
                    continue
                other["tx_bytes"] += int(r.get("tx_bytes", 0) or 0)
                other["rx_bytes"] += int(r.get("rx_bytes", 0) or 0)
            out["other"] = other
            return out

        for fam, key in (("ceph_tpu_net_peer_tx_bytes_total",
                          "tx_bytes"),
                         ("ceph_tpu_net_peer_rx_bytes_total",
                          "rx_bytes")):
            _fam_header(lines, fam, "counter",
                        "per-peer wire %s (peer labels capped)"
                        % key)
            for daemon, nrow in rows.items():
                for peer, prow in sorted(folded(
                        dict(nrow.get("peers") or {})).items()):
                    lines.append('%s{daemon="%s",peer="%s"} %d'
                                 % (fam, daemon, peer,
                                    int(prow.get(key, 0) or 0)))
        fam = "ceph_tpu_net_rtt_ms"
        _fam_header(lines, fam, "gauge",
                    "per-peer heartbeat RTT, 5s window (ms)")
        for daemon, nrow in rows.items():
            rtt = dict(nrow.get("rtt_peers") or {})
            worst = sorted(rtt, key=lambda p: (-rtt[p], p))[:cap]
            for peer in sorted(worst):
                lines.append('%s{daemon="%s",peer="osd.%s"} %g'
                             % (fam, daemon, peer, rtt[peer]))
        for fam, key, desc in (
                ("ceph_tpu_net_backoff_seconds", "backoff_s",
                 "active redial backoff ramp (worst peer)"),
                ("ceph_tpu_net_handshake_seconds", "handshake_s",
                 "last completed handshake latency (worst peer)")):
            _fam_header(lines, fam, "gauge", desc)
            for daemon, nrow in rows.items():
                peers = nrow.get("peers") or {}
                v = max((float(p.get(key, 0.0) or 0.0)
                         for p in peers.values()), default=0.0)
                lines.append('%s{daemon="%s"} %g'
                             % (fam, daemon, v))
        return lines

    # -- stats loop (PGMap digest -> monitors) -----------------------------

    async def _stats_loop(self) -> None:
        """Periodically fold the PGMap into a digest and broadcast it
        to every monitor (MgrStatMonitor's report flow, broadcast like
        beacons so whichever mon leads next already holds it)."""
        while True:
            await asyncio.sleep(self.stats_period)
            self.clog.flush()       # re-send unacked clog entries
            if not self.daemon_reports:
                continue
            now = asyncio.get_event_loop().time()
            try:
                # reclaim rows the folds already ignore: dead
                # primaries past the prune window + deleted pools —
                # counted (ceph_tpu_mgr_rows_pruned_total), never
                # silent.  The pool filter only engages once the mgr
                # holds a pool table (a lagging map must not wipe
                # fresh rows; they would be refiltered next tick).
                self.pgmap.prune(
                    now,
                    pools=(set(self.osdmap.pools)
                           if self.osdmap.pools else None),
                    after=float(self.ctx.conf.get(
                        "mgr_stats_prune_after", 60.0)))
                digest = self.pgmap.digest(now, self.osdmap)
                # tenant SLO plane: ingest this tick's cumulative
                # tenant rows, evaluate the burn windows, and ship
                # the verdicts in the digest (the mon commits the
                # raise/clear edges through paxos)
                self.slo.ingest(now,
                                self.pgmap.live_osd_stats(now))
                digest["slo"] = self.slo.evaluate(now)
                # history plane: one extraction pass feeds both the
                # downsampled rings and the anomaly rules; active
                # anomalies ride the digest so the mon can commit
                # the PERF_ANOMALY raise/clear edges through paxos
                import time as _wall
                t_h0 = _wall.perf_counter()
                from .history import extract_samples
                samples = extract_samples(digest)
                self.history.ingest(_wall.time(), digest,
                                    samples=samples)
                digest["anomalies"] = self.anomaly.observe(samples)
                self.history_ingest_s += _wall.perf_counter() - t_h0
            except Exception as e:
                self.ctx.log.info("mgr", "digest failed: %r" % e)
                continue
            msg_fields = dict(digest=digest, epoch=self.osdmap.epoch)
            for i, addr in enumerate(self.mon_addrs):
                self.msgr.send_to(addr, MMonMgrDigest(**msg_fields),
                                  entity_hint="mon.%d" % i)
            self.digests_sent += 1

    # -- balancer loop -----------------------------------------------------

    async def _balancer_loop(self) -> None:
        """pybind/mgr/balancer Module.serve: periodically run the
        upmap optimizer against the current map and commit its
        pg_upmap_items through the monitor."""
        while True:
            await asyncio.sleep(self.balance_interval)
            if not self.balancer_enabled or not self.osdmap.pools:
                continue
            try:
                await self.balancer_tick()
            except Exception as e:
                self.ctx.log.info("mgr", "balancer failed: %r" % e)

    async def balancer_tick(self) -> dict:
        """One optimizer round + commit (shared by the autonomous
        loop and `bench.py --scale`).  Mode rides
        `mgr_balancer_mode`: 'batched' generates every candidate move
        and scores them in bulk device dispatches
        (scale.balancer.batched_calc_pg_upmaps — the TPU-scored
        balancer); 'sequential' keeps the reference's greedy
        calc_pg_upmaps walk.  Both emit items through the identical
        validity rules, so the committed upmaps agree in effect."""
        from ..osd.balancer import calc_pg_upmaps

        mode = str(self.ctx.conf.get("mgr_balancer_mode", "batched"))
        inc = self.osdmap.new_incremental()
        info: dict = {"mode": mode}
        if mode == "batched":
            from ..scale.balancer import batched_calc_pg_upmaps

            def opt():
                return batched_calc_pg_upmaps(
                    self.osdmap, inc, max_deviation=1.0,
                    max_changes=int(self.ctx.conf.get(
                        "mgr_balancer_max_changes", 48)),
                    device=self.device)

            if self.osdmap.max_osd >= 200:
                # big maps: the raw-row build + scoring is seconds of
                # synchronous work on a CPU backend — run it off-loop
                # so beacons/digests keep flowing (vstart-size maps
                # stay inline: cheap, and clear of any thread overlap
                # with live EC dispatch)
                res = await asyncio.get_event_loop() \
                    .run_in_executor(None, opt)
            else:
                res = opt()
            n = res.changes
            info.update(
                candidates_scored=res.candidates_scored,
                device_rounds=res.device_rounds,
                host_rounds=res.host_rounds,
                stddev_before=res.stddev_before,
                stddev_after=res.stddev_after)
        else:
            n = calc_pg_upmaps(self.osdmap, inc, max_deviation=1.0,
                               max_iterations=32, device=self.device)
        info["changes"] = n
        self.balancer_rounds += 1
        removals = [pgid for pgid in inc.old_pg_upmap_items
                    if pgid not in inc.new_pg_upmap_items]
        if n or removals:
            await self._commit_upmaps(inc, removals)
        return info

    async def _commit_upmaps(self, inc, removals) -> None:
        for pgid, items in inc.new_pg_upmap_items.items():
            try:
                if items:
                    await self.mon_command(
                        "osd pg-upmap-items", pool=pgid.pool,
                        ps=pgid.ps,
                        mappings=[list(t) for t in items])
                else:
                    await self.mon_command(
                        "osd rm-pg-upmap-items", pool=pgid.pool,
                        ps=pgid.ps)
                self.balancer_changes += 1
            except Exception as e:
                self.ctx.log.info(
                    "mgr", "upmap commit failed: %r" % e)
        for pgid in removals:
            # stale entries the optimizer retired (e.g. the source
            # osd left the raw set) — committed as removals too
            try:
                await self.mon_command(
                    "osd rm-pg-upmap-items", pool=pgid.pool,
                    ps=pgid.ps)
                self.balancer_changes += 1
            except Exception as e:
                self.ctx.log.info(
                    "mgr", "upmap removal failed: %r" % e)
