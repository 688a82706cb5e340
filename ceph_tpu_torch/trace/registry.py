"""Stage/series name registries + the drift lint.

The flight recorder, `bench.py --trace`, and the trace tests all
reference OpTracker stage names and device exporter series by string
literal.  A renamed stage at its emission site (`mark_event("...")`)
would silently break every consumer — the timeline still renders, the
bench still prints, but the renamed stage just stops matching.  This
module makes that a tier-1 lint failure instead:

* ``OP_STAGES`` / ``OP_STAGE_PREFIXES`` — the canonical registry of
  every stage name the tracker can emit (prefixes cover the dynamic
  forms like ``sent_osd.<n>``);
* ``BACKGROUND_SPANS`` — the flight recorder's background span names;
* ``DEVICE_SERIES`` — the per-chip device metric names the exporter
  publishes (checked against a live ChipRuntime, so a metrics() key
  added without registration also fails);
* ``CONSUMER_STAGE_REFS`` — which stage names each consumer file
  (bench.py, the trace tests) is known to reference.

``lint_repo()`` closes the loop in both directions: every emitted
literal must be registered, every registered name must still be
emitted somewhere, and every consumer reference must be registered
AND still literally present in the consumer's source — so a rename
anywhere in the chain fails the lint until every link is updated.
"""

from __future__ import annotations

import os
import re

# every static stage literal the tracker emits (mark_event /
# _op_event / finish / _op_finish call sites across ceph_tpu), plus
# the two implicit stamps every op carries
OP_STAGES = frozenset({
    "initiated", "done",                      # implicit (ctor/default)
    # client (client/rados.py)
    "no_primary", "redirected", "redirected_inactive",
    # mon (mon/monitor.py)
    "proposal_queued", "proposal_timeout", "error",
    # osd queue/dispatch (osd/daemon.py)
    "queued", "reached_pg", "waiting_for_map", "waiting_for_active",
    "waiting_for_min_size", "waiting_for_degraded_object",
    "waiting_for_missing_object", "started_write", "started_apply",
    "sub_op_sent", "applied", "read_done", "watch_done",
    "done_no_replicas", "error_reply", "no_such_pool",
    "dropped_not_primary", "dropped_wrong_pg_after_split",
    "dropped_interval_change", "dropped_pool_deleted",
    "dup_answered_from_journal",
    # dedup plane (dedup/plane.py)
    "dedup_planned", "waiting_for_inflight_dup",
    "dropped_inflight_dup",
    "aborted_interval_change", "aborted_pool_deleted",
    # EC backend (osd/ecbackend.py)
    "ec_write_started", "ec_encode_start", "ec_encoded",
    "device_dispatched", "device_stream_retired",
    "ec_sub_write_sent", "ec_sub_write_acked",
    "ec_sub_write_timeout", "ec_write_done", "ec_read_done",
    "ec_shard_applied", "ec_delta_rmw", "ec_delta_done",
    "ec_error_reply",
})

# dynamic stage families: the literal carries a %-format tail
OP_STAGE_PREFIXES = ("sent_osd.", "commit_rec_osd.", "reply_r")

# flight-recorder background span names (FlightRecorder.span callers)
BACKGROUND_SPANS = frozenset({
    "scrub", "deep_scrub", "recovery", "compression_paced",
    "dedup_paced",
})

# per-chip device series (ChipRuntime.metrics keys + the families
# prom_lines adds beside them)
DEVICE_SERIES = frozenset({
    "device_queue_depth", "device_inflight",
    "device_bucket_hit_ratio", "device_bucket_waste_ratio",
    "device_compile_count", "device_dispatches",
    "device_pool_hits",
    "device_pool_misses", "device_lost",
    "device_loss_count", "device_heal_count",
    "device_queue_rejected",
    "device_util_busy", "device_util_queue_wait", "device_util_idle",
    # continuous dispatch stream (device/stream.py): slot occupancy
    # (payload fraction of dispatched slot capacity), admission-loop
    # latency (mean arrival->slot-grant seconds), independent-retire
    # and pending-admission counts
    "device_slot_occupancy", "device_admission_wait",
    "device_stream_retires", "device_stream_pending",
    # repair-traffic plane (device/runtime.py note_repair): survivor
    # bytes read vs rebuilt bytes pushed by the recovery flows bound
    # to each chip — the figure the locality-aware codecs shrink
    "device_repair_bytes_read", "device_repair_bytes_moved",
    # compression plane (device/runtime.py note_compress): raw bytes
    # match-planned on each chip vs emitted container bytes — the
    # observable that force-mode pools stopped burning host CPU
    "device_compress_bytes_in", "device_compress_bytes_out",
    # dedup plane (device/runtime.py note_fingerprint): chunks/bytes
    # content-fingerprinted on each chip's CRC lanes
    "device_fingerprint_chunks", "device_fingerprint_bytes",
    # families prom_lines emits beside the metrics() gauges
    "device_chips", "device_dispatch_seconds",
})

# tenant SLO plane: the per-tenant stage-histogram names OSDs emit
# via note_tenant_stage (the mgr SLO engine's burn-rate input —
# mgr/slo.py re-exports the same tuple) and the tenant-labeled
# exporter families the mgr renders.  Both directions are linted:
# every emitted literal registered, every registered name emitted.
TENANT_STAGES = frozenset({
    "queue_wait", "subop_rtt", "ec_batch_wait", "device_dispatch",
    "total",
})

TENANT_SERIES = frozenset({
    "ceph_tpu_tenant_ops_total", "ceph_tpu_tenant_errors_total",
    "ceph_tpu_tenant_op_seconds", "ceph_tpu_tenant_slo_burn_fast",
    "ceph_tpu_tenant_slo_burn_slow", "ceph_tpu_tenant_p99_ms",
})

# telemetry fabric: the mgr's report-ingest exporter families
# (rendered by mgr/daemon.py ingest_prom_lines) — report rows/bytes
# per wire format, the apply-latency histogram, the row-loop
# fallback counter, and the visible stale/pool prune counters
MGR_SERIES = frozenset({
    "ceph_tpu_mgr_report_rows_total",
    "ceph_tpu_mgr_report_bytes_total",
    "ceph_tpu_mgr_ingest_seconds",
    "ceph_tpu_mgr_ingest_fallback_rows_total",
    "ceph_tpu_mgr_rows_pruned_total",
    # repair-traffic plane: per-codec recovery bytes (read from
    # survivors / moved to rebuilt shards) folded from the OSDs'
    # osd_stats.repair rows into the digest and rendered codec-labeled
    "ceph_tpu_repair_bytes_read_total",
    "ceph_tpu_repair_bytes_moved_total",
    # data-reduction plane: per-pool dedup counters folded from the
    # OSDs' osd_stats.dedup rows and rendered pool-labeled
    "ceph_tpu_dedup_chunks_stored_total",
    "ceph_tpu_dedup_chunks_deduped_total",
    "ceph_tpu_dedup_bytes_saved_total",
})

# history plane: the downsampled series names mgr/history.py's
# extract_samples emits from each digest tick (the `perf history`
# query namespace and the anomaly engine's watch list)
HISTORY_SERIES = frozenset({
    "io.read_ops_s", "io.write_ops_s",
    "io.read_bytes_s", "io.write_bytes_s",
    "recovery.ops_s", "recovery.bytes_s",
    "pg.degraded", "pg.misplaced",              # label: pool id
    "device.busy_frac", "device.queue_wait_frac",   # label: chip
    "tenant.p99_ms", "tenant.burn_fast",        # label: tenant
    "repair.bytes_read", "repair.bytes_moved",
    "dedup.bytes_stored", "dedup.bytes_saved",
    # network plane (label: daemon)
    "net.rtt_ms", "net.queue_depth", "net.resend_rate",
})

# network plane: the per-peer messenger telemetry fields WireStats
# dumps (msg/messenger.py — admin-socket `dump_osd_network`, the
# osd_stats net rows and collect_diagnostics all serve them) and the
# net exporter families the mgr renders.  Both directions linted.
NET_STAGES = frozenset({
    "queue_depth", "queue_wait_s", "resends", "replays",
    "mark_downs", "handshake_s", "backoff_s",
})

NET_SERIES = frozenset({
    "ceph_tpu_net_resends_total", "ceph_tpu_net_replays_total",
    "ceph_tpu_net_mark_downs_total", "ceph_tpu_net_queue_depth",
    "ceph_tpu_net_peer_tx_bytes_total",
    "ceph_tpu_net_peer_rx_bytes_total",
    "ceph_tpu_net_rtt_ms", "ceph_tpu_net_backoff_seconds",
    "ceph_tpu_net_handshake_seconds",
})

# event bus: the committed event types the mon emits (EventMonitor
# rows; `watch-events` / event_stream consumers switch on these)
EVENT_TYPES = frozenset({
    "health_edge", "clog", "osd_boot", "osd_down", "osd_out",
    "progress_start", "progress_finish",
})

# consumers referencing history series / event types by literal —
# every entry must be registered AND still present in the file
CONSUMER_HISTORY_REFS = {
    "bench.py": (
        "io.write_ops_s", "device.busy_frac",
    ),
    "tests/test_history.py": (
        "io.write_ops_s", "device.busy_frac", "tenant.p99_ms",
        "pg.degraded",
    ),
    "tests/test_net.py": (
        "net.rtt_ms", "net.resend_rate",
    ),
}

# consumers referencing the net plane (WireStats fields / exporter
# families) by literal — registered AND literally present, both ways
CONSUMER_NET_REFS = {
    "bench.py": (
        "ceph_tpu_net_rtt_ms", "ceph_tpu_net_peer_tx_bytes_total",
        "resends", "queue_depth",
    ),
    "tests/test_net.py": (
        "ceph_tpu_net_rtt_ms", "ceph_tpu_net_resends_total",
        "resends", "replays", "queue_wait_s",
    ),
}

CONSUMER_EVENT_REFS = {
    "tests/test_events.py": (
        "health_edge", "osd_boot", "osd_down",
        "progress_start", "progress_finish",
    ),
}

# consumers referencing the ingest families by literal (the bench
# ingest leg asserts its exposition render; the ingest tests pin the
# scrape surface) — every entry must be registered AND present
CONSUMER_MGR_REFS = {
    "bench.py": (
        "ceph_tpu_mgr_ingest_seconds",
        "ceph_tpu_mgr_report_rows_total",
    ),
    "tests/test_ingest.py": (
        "ceph_tpu_mgr_report_rows_total",
        "ceph_tpu_mgr_report_bytes_total",
        "ceph_tpu_mgr_ingest_seconds",
        "ceph_tpu_mgr_ingest_fallback_rows_total",
        "ceph_tpu_mgr_rows_pruned_total",
    ),
    "tests/test_ec_recovery_codecs.py": (
        "ceph_tpu_repair_bytes_read_total",
        "ceph_tpu_repair_bytes_moved_total",
    ),
    "tests/test_dedup.py": (
        "ceph_tpu_dedup_chunks_stored_total",
        "ceph_tpu_dedup_chunks_deduped_total",
        "ceph_tpu_dedup_bytes_saved_total",
    ),
}

# which stage names each consumer file references by literal; the
# lint demands every entry be registered AND literally present in the
# file, so a stage rename that misses a consumer fails here
CONSUMER_STAGE_REFS = {
    "bench.py": (
        "queued", "reached_pg", "sub_op_sent", "ec_sub_write_sent",
        "ec_sub_write_acked", "ec_encode_start", "ec_encoded",
    ),
    "tests/test_optracker.py": (
        "queued", "reached_pg", "started_write", "sub_op_sent",
        "started_apply", "applied", "ec_encode_start", "ec_encoded",
    ),
    "tests/test_flight_recorder.py": (
        "queued", "ec_encode_start", "ec_encoded", "ec_write_done",
        "device_dispatched",
    ),
    "tests/test_dispatch_stream.py": (
        "device_stream_retired",
    ),
    "tests/test_dedup.py": (
        "dedup_planned",
    ),
}

CONSUMER_SERIES_REFS = {
    "tests/test_flight_recorder.py": (
        "device_util_busy", "device_util_queue_wait",
        "device_util_idle",
    ),
    # the continuous-dispatch + repair-traffic + compression bench
    # legs and their tests consume these series by literal name
    "bench.py": (
        "device_slot_occupancy", "device_admission_wait",
        "device_repair_bytes_read", "device_repair_bytes_moved",
        "device_compress_bytes_in", "device_compress_bytes_out",
        "device_fingerprint_chunks", "device_fingerprint_bytes",
    ),
    "tests/test_tlz.py": (
        "device_compress_bytes_in", "device_compress_bytes_out",
    ),
    "tests/test_dispatch_stream.py": (
        "device_slot_occupancy", "device_admission_wait",
        "device_stream_retires", "device_stream_pending",
    ),
    "tests/test_ec_recovery_codecs.py": (
        "device_repair_bytes_read", "device_repair_bytes_moved",
    ),
    "tests/test_dedup.py": (
        "device_fingerprint_chunks", "device_fingerprint_bytes",
    ),
}

_EMIT_RES = (
    re.compile(r'\.mark_event\(\s*"([^"]+)"'),
    re.compile(r'_op_event\([^,()]+,\s*"([^"]+)"'),
    re.compile(r'\.finish\(\s*"([^"]+)"'),
    re.compile(r'_op_finish\([^,()]+,\s*"([^"]+)"'),
)

_EMIT_COND_RE = re.compile(
    r'\.mark_event\(\s*"([^"]+)"\s+if\s+.{0,120}?'
    r'else\s+"([^"]+)"\)', re.S)

_SPAN_RE = re.compile(r'\.span\(\s*\n?\s*"([^"]+)"')
_SPAN_COND_RE = re.compile(
    r'\.span\(\s*"([^"]+)"\s+if\s+.{0,120}?else\s+"([^"]+)"', re.S)


def _repo_root(root: str | None) -> str:
    return root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def _iter_sources(pkg_dir: str):
    for dirpath, _dirs, files in os.walk(pkg_dir):
        if "__pycache__" in dirpath:
            continue
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    yield path, f.read()


def emitted_stages(root: str | None = None
                   ) -> tuple[set[str], set[str], set[str]]:
    """(exact stage names, dynamic prefixes, span names) scanned from
    the ceph_tpu sources' emission call sites."""
    exact: set[str] = set()
    prefixes: set[str] = set()
    spans: set[str] = set()
    pkg = os.path.join(_repo_root(root), "ceph_tpu")
    for _path, src in _iter_sources(pkg):
        for rx in _EMIT_RES:
            for name in rx.findall(src):
                if "%" in name:
                    prefixes.add(name.split("%")[0])
                else:
                    exact.add(name)
        for a, b in _EMIT_COND_RE.findall(src):
            exact.update((a, b))
        for a, b in _SPAN_COND_RE.findall(src):
            spans.update((a, b))
        for name in _SPAN_RE.findall(src):
            if " if " not in name:
                spans.add(name)
    return exact, prefixes, spans


def stage_known(name: str) -> bool:
    if name in OP_STAGES:
        return True
    return any(name.startswith(p) for p in OP_STAGE_PREFIXES)


def lint_emissions(root: str | None = None) -> list[str]:
    """Both directions between the registry and the emission sites."""
    errors: list[str] = []
    exact, prefixes, spans = emitted_stages(root)
    for name in sorted(exact):
        if not stage_known(name):
            errors.append("emitted stage %r is not registered in"
                          " trace.registry.OP_STAGES" % name)
    for pref in sorted(prefixes):
        if pref not in OP_STAGE_PREFIXES:
            errors.append("emitted dynamic stage prefix %r is not in"
                          " OP_STAGE_PREFIXES" % pref)
    implicit = {"initiated", "done"}
    for name in sorted(OP_STAGES - exact - implicit):
        errors.append("registered stage %r is no longer emitted"
                      " anywhere" % name)
    for pref in sorted(set(OP_STAGE_PREFIXES) - prefixes):
        errors.append("registered stage prefix %r is no longer"
                      " emitted anywhere" % pref)
    for name in sorted(spans - BACKGROUND_SPANS):
        errors.append("background span %r is not registered in"
                      " BACKGROUND_SPANS" % name)
    for name in sorted(BACKGROUND_SPANS - spans):
        errors.append("registered background span %r is no longer"
                      " recorded anywhere" % name)
    return errors


def lint_device_series() -> list[str]:
    """DEVICE_SERIES must match what a live chip actually exports (a
    metrics() key added or renamed without registration fails)."""
    from ..device.runtime import DeviceRuntime
    live = set(DeviceRuntime(chips=1, device="cpu").chips[0].metrics())
    live |= {"device_chips", "device_dispatch_seconds"}
    errors = []
    for name in sorted(live - DEVICE_SERIES):
        errors.append("exported device series %r is not registered"
                      " in trace.registry.DEVICE_SERIES" % name)
    for name in sorted(DEVICE_SERIES - live):
        errors.append("registered device series %r is no longer"
                      " exported" % name)
    return errors


_TENANT_STAGE_RE = re.compile(
    r'note_tenant_stage\([^"]*?"([^"]+)"', re.S)


def lint_tenant_plane(root: str | None = None) -> list[str]:
    """Tenant SLO plane drift lint: every `note_tenant_stage` literal
    emitted anywhere in ceph_tpu must be registered in TENANT_STAGES
    (and vice versa — a renamed stage that still sits in the registry
    fails), the SLO engine's own stage tuple must match, and every
    registered tenant exporter family must literally appear in the
    mgr's renderer (so a family rename cannot silently drop a
    series)."""
    errors: list[str] = []
    base = _repo_root(root)
    pkg = os.path.join(base, "ceph_tpu")
    emitted: set[str] = set()
    for _path, src in _iter_sources(pkg):
        emitted.update(_TENANT_STAGE_RE.findall(src))
    for name in sorted(emitted - TENANT_STAGES):
        errors.append("emitted tenant stage %r is not registered in"
                      " trace.registry.TENANT_STAGES" % name)
    for name in sorted(TENANT_STAGES - emitted):
        errors.append("registered tenant stage %r is no longer"
                      " emitted anywhere" % name)
    try:
        from ..mgr.slo import TENANT_STAGES as ENGINE_STAGES
        if set(ENGINE_STAGES) != TENANT_STAGES:
            errors.append(
                "mgr.slo.TENANT_STAGES %r diverged from"
                " trace.registry.TENANT_STAGES %r"
                % (sorted(ENGINE_STAGES), sorted(TENANT_STAGES)))
    except Exception as e:
        errors.append("mgr.slo unimportable: %r" % e)
    mgr_path = os.path.join(pkg, "mgr", "daemon.py")
    try:
        with open(mgr_path) as f:
            mgr_src = f.read()
    except OSError:
        errors.append("ceph_tpu/mgr/daemon.py is missing")
        mgr_src = ""
    for fam in sorted(TENANT_SERIES):
        if fam not in mgr_src:
            errors.append(
                "registered tenant series %r is not rendered by"
                " ceph_tpu/mgr/daemon.py" % fam)
    return errors


def lint_mgr_plane(root: str | None = None) -> list[str]:
    """Telemetry-fabric drift lint: every registered mgr ingest
    family must literally appear in the mgr's renderer (a family
    rename cannot silently drop a series), and every consumer
    reference must be a registered family still literally present in
    the consumer's source."""
    errors: list[str] = []
    base = _repo_root(root)
    mgr_path = os.path.join(base, "ceph_tpu", "mgr", "daemon.py")
    try:
        with open(mgr_path) as f:
            mgr_src = f.read()
    except OSError:
        errors.append("ceph_tpu/mgr/daemon.py is missing")
        mgr_src = ""
    for fam in sorted(MGR_SERIES):
        if fam not in mgr_src:
            errors.append(
                "registered mgr ingest series %r is not rendered by"
                " ceph_tpu/mgr/daemon.py" % fam)
    for relpath, names in sorted(CONSUMER_MGR_REFS.items()):
        path = os.path.join(base, relpath)
        try:
            with open(path) as f:
                src = f.read()
        except OSError:
            errors.append("consumer %s is missing" % relpath)
            continue
        for name in names:
            if name not in MGR_SERIES:
                errors.append(
                    "%s references unregistered mgr series %r"
                    % (relpath, name))
            if name not in src:
                errors.append(
                    "%s no longer references mgr series %r (stale"
                    " CONSUMER_MGR_REFS entry?)" % (relpath, name))
    return errors


def lint_consumers(root: str | None = None) -> list[str]:
    """Every consumer reference must be a registered name AND still
    literally present in the consumer's source."""
    errors: list[str] = []
    base = _repo_root(root)
    for relpath, names in sorted(CONSUMER_STAGE_REFS.items()):
        path = os.path.join(base, relpath)
        try:
            with open(path) as f:
                src = f.read()
        except OSError:
            errors.append("consumer %s is missing" % relpath)
            continue
        for name in names:
            if not stage_known(name):
                errors.append("%s references unregistered stage %r"
                              % (relpath, name))
            if '"%s"' % name not in src:
                errors.append("%s no longer references stage %r"
                              " (stale CONSUMER_STAGE_REFS entry?)"
                              % (relpath, name))
    for relpath, names in sorted(CONSUMER_SERIES_REFS.items()):
        path = os.path.join(base, relpath)
        try:
            with open(path) as f:
                src = f.read()
        except OSError:
            errors.append("consumer %s is missing" % relpath)
            continue
        for name in names:
            if name not in DEVICE_SERIES:
                errors.append("%s references unregistered series %r"
                              % (relpath, name))
            if name not in src:
                errors.append("%s no longer references series %r"
                              % (relpath, name))
    return errors


_HISTORY_SERIES_RE = re.compile(r'"([a-z]+\.[a-z0-9_]+)"')

_EVENT_EMIT_RE = re.compile(r'\bemit(?:_event)?\(\s*"([a-z_]+)"')


def lint_history_plane(root: str | None = None) -> list[str]:
    """History-plane drift lint: every dotted series literal in
    mgr/history.py (the single emission module) must be registered
    in HISTORY_SERIES and vice versa, and every consumer reference
    must be a registered series still literally present in the
    consumer's source."""
    errors: list[str] = []
    base = _repo_root(root)
    hist_path = os.path.join(base, "ceph_tpu", "mgr", "history.py")
    try:
        with open(hist_path) as f:
            hist_src = f.read()
    except OSError:
        return ["ceph_tpu/mgr/history.py is missing"]
    emitted = set(_HISTORY_SERIES_RE.findall(hist_src))
    for name in sorted(emitted - HISTORY_SERIES):
        errors.append("history series %r emitted by mgr/history.py"
                      " is not registered in"
                      " trace.registry.HISTORY_SERIES" % name)
    for name in sorted(HISTORY_SERIES - emitted):
        errors.append("registered history series %r is no longer"
                      " emitted by mgr/history.py" % name)
    for relpath, names in sorted(CONSUMER_HISTORY_REFS.items()):
        path = os.path.join(base, relpath)
        try:
            with open(path) as f:
                src = f.read()
        except OSError:
            errors.append("consumer %s is missing" % relpath)
            continue
        for name in names:
            if name not in HISTORY_SERIES:
                errors.append(
                    "%s references unregistered history series %r"
                    % (relpath, name))
            if '"%s"' % name not in src:
                errors.append(
                    "%s no longer references history series %r"
                    " (stale CONSUMER_HISTORY_REFS entry?)"
                    % (relpath, name))
    return errors


def lint_net_plane(root: str | None = None) -> list[str]:
    """Network-plane drift lint: every registered WireStats field
    must still be a literal dump key in msg/messenger.py (the single
    emission module), every registered net exporter family must
    literally appear in the mgr's renderer, and every consumer
    reference must be registered AND still literally present in the
    consumer's source — so a rename anywhere in the
    counter->digest->exporter chain fails here."""
    errors: list[str] = []
    base = _repo_root(root)
    msgr_path = os.path.join(base, "ceph_tpu", "msg",
                             "messenger.py")
    try:
        with open(msgr_path) as f:
            msgr_src = f.read()
    except OSError:
        errors.append("ceph_tpu/msg/messenger.py is missing")
        msgr_src = ""
    for name in sorted(NET_STAGES):
        if '"%s"' % name not in msgr_src:
            errors.append(
                "registered net telemetry field %r is no longer"
                " dumped by ceph_tpu/msg/messenger.py" % name)
    mgr_path = os.path.join(base, "ceph_tpu", "mgr", "daemon.py")
    try:
        with open(mgr_path) as f:
            mgr_src = f.read()
    except OSError:
        errors.append("ceph_tpu/mgr/daemon.py is missing")
        mgr_src = ""
    for fam in sorted(NET_SERIES):
        if fam not in mgr_src:
            errors.append(
                "registered net series %r is not rendered by"
                " ceph_tpu/mgr/daemon.py" % fam)
    for relpath, names in sorted(CONSUMER_NET_REFS.items()):
        path = os.path.join(base, relpath)
        try:
            with open(path) as f:
                src = f.read()
        except OSError:
            errors.append("consumer %s is missing" % relpath)
            continue
        for name in names:
            if name not in NET_SERIES and name not in NET_STAGES:
                errors.append(
                    "%s references unregistered net name %r"
                    % (relpath, name))
            if '"%s"' % name not in src:
                errors.append(
                    "%s no longer references net name %r (stale"
                    " CONSUMER_NET_REFS entry?)" % (relpath, name))
    return errors


def lint_event_plane(root: str | None = None) -> list[str]:
    """Event-bus drift lint: every event type emitted in the mon
    package (`emit_event("...")` / the HealthMonitor's `emit("...")`
    funnel) must be registered in EVENT_TYPES and vice versa, and
    every consumer reference must be registered AND still literally
    present in the consumer's source."""
    errors: list[str] = []
    base = _repo_root(root)
    mon_pkg = os.path.join(base, "ceph_tpu", "mon")
    emitted: set[str] = set()
    for _path, src in _iter_sources(mon_pkg):
        emitted.update(_EVENT_EMIT_RE.findall(src))
    for name in sorted(emitted - EVENT_TYPES):
        errors.append("emitted event type %r is not registered in"
                      " trace.registry.EVENT_TYPES" % name)
    for name in sorted(EVENT_TYPES - emitted):
        errors.append("registered event type %r is no longer"
                      " emitted by the mon" % name)
    for relpath, names in sorted(CONSUMER_EVENT_REFS.items()):
        path = os.path.join(base, relpath)
        try:
            with open(path) as f:
                src = f.read()
        except OSError:
            errors.append("consumer %s is missing" % relpath)
            continue
        for name in names:
            if name not in EVENT_TYPES:
                errors.append(
                    "%s references unregistered event type %r"
                    % (relpath, name))
            if '"%s"' % name not in src:
                errors.append(
                    "%s no longer references event type %r (stale"
                    " CONSUMER_EVENT_REFS entry?)" % (relpath, name))
    return errors


def lint_repo(root: str | None = None) -> list[str]:
    """The tier-1 drift lint: emission sites vs registry vs consumer
    references, plus the live device-series check, the tenant SLO
    plane (stage histograms + exporter families), the mgr
    telemetry-fabric ingest families, and the history/event planes."""
    return (lint_emissions(root) + lint_device_series()
            + lint_consumers(root) + lint_tenant_plane(root)
            + lint_mgr_plane(root) + lint_history_plane(root)
            + lint_net_plane(root) + lint_event_plane(root))
