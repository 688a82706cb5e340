"""Typed, layered configuration system.

Reference analog: Ceph's option framework — options declared with
type/level/default/min/max/enum/see_also in YAML
(src/common/options/*.yaml.in), merged from layered sources
(compiled defaults < conf file < centralized mon store < env < CLI <
runtime overrides) with change observers (md_config_obs_t).

This is a fresh design: options are declared in Python as `Option`
objects grouped into schemas; a `Config` instance resolves values through
an explicit source-priority stack and notifies observers on change.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

OPT_STR = "str"
OPT_INT = "int"
OPT_FLOAT = "float"
OPT_BOOL = "bool"

_CASTS: dict[str, Callable[[Any], Any]] = {
    OPT_STR: str,
    OPT_INT: int,
    OPT_FLOAT: float,
    OPT_BOOL: lambda v: (
        v
        if isinstance(v, bool)
        else str(v).strip().lower() in ("1", "true", "yes", "on")
    ),
}

# Source priority, low to high.  Mirrors the reference's merge order:
# defaults < conf file < mon central store < env < cli < runtime.
SOURCES = ("default", "file", "mon", "env", "cli", "runtime")
_SOURCE_RANK = {s: i for i, s in enumerate(SOURCES)}


@dataclass(frozen=True)
class Option:
    """One declared configuration option."""

    name: str
    type: str = OPT_STR
    default: Any = None
    desc: str = ""
    level: str = "advanced"  # basic | advanced | dev
    min: Any = None
    max: Any = None
    enum_allowed: tuple = ()
    see_also: tuple = ()

    def cast(self, value: Any) -> Any:
        v = _CASTS[self.type](value)
        if self.min is not None and v < self.min:
            raise ValueError(f"{self.name}: {v} < min {self.min}")
        if self.max is not None and v > self.max:
            raise ValueError(f"{self.name}: {v} > max {self.max}")
        if self.enum_allowed and v not in self.enum_allowed:
            raise ValueError(f"{self.name}: {v!r} not in {self.enum_allowed}")
        return v


class Config:
    """Layered config resolver with observers.

    Values are stored per (option, source); lookup returns the value from
    the highest-priority source that has one, else the declared default.
    """

    def __init__(self, schema: Iterable[Option] = (), env_prefix: str = "CEPH_TPU_"):
        self._lock = threading.RLock()
        self._schema: dict[str, Option] = {}
        self._defaults: dict[str, Any] = {}  # pre-cast declared defaults
        self._values: dict[str, dict[str, Any]] = {}  # name -> source -> value
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        self._env_prefix = env_prefix
        self.register(DEFAULT_SCHEMA)
        self.register(schema)
        self._load_env()

    # -- schema ----------------------------------------------------------
    def register(self, options: Iterable[Option]) -> None:
        with self._lock:
            for opt in options:
                self._schema[opt.name] = opt
                if opt.default is not None:
                    self._defaults[opt.name] = opt.cast(opt.default)
        # late-registered options may have env overrides waiting
        if hasattr(self, "_env_prefix"):
            self._load_env()

    def option(self, name: str) -> Option:
        return self._schema[name]

    def schema(self) -> list[Option]:
        return sorted(self._schema.values(), key=lambda o: o.name)

    # -- sources ---------------------------------------------------------
    def load_file(self, path: str) -> None:
        """Load a JSON conf file ({option: value} or {section: {option: value}})."""
        with open(path) as f:
            data = json.load(f)
        flat: dict[str, Any] = {}
        for k, v in data.items():
            if isinstance(v, dict):
                flat.update(v)
            else:
                flat[k] = v
        # validate everything before committing anything, so a bad key or
        # value cannot leave the config half-applied
        casted = {}
        for k, v in flat.items():
            opt = self._schema.get(k)
            if opt is None:
                raise KeyError(f"unknown option {k!r} in {path}")
            casted[k] = opt.cast(v)
        for k, v in casted.items():
            self.set(k, v, source="file")

    def _load_env(self) -> None:
        for key, raw in os.environ.items():
            if key.startswith(self._env_prefix):
                name = key[len(self._env_prefix):].lower()
                if name in self._schema:
                    try:
                        self.set(name, raw, source="env")
                    except ValueError as e:
                        # a bad env var must not make the process
                        # unconstructable; warn and fall through
                        import sys

                        print(f"ceph-tpu: ignoring {key}: {e}", file=sys.stderr)

    def apply_mon_values(self, values: dict[str, Any]) -> None:
        """Apply the monitor config service's RESOLVED view: the push
        is authoritative for the whole 'mon' layer, so keys absent
        from it are cleared (a `config rm` must take effect on
        running daemons, not only after restart).  Unknown options or
        uncastable values are skipped — a newer cluster may push
        options this daemon's schema predates, and a poison value
        must never sever the dispatch loop."""
        with self._lock:
            stale = [n for n, per in self._values.items()
                     if "mon" in per and n not in values]
        for n in stale:
            try:
                self.rm(n, source="mon")
            except Exception:
                pass
        for k, v in dict(values).items():
            if k not in self._schema:
                continue
            try:
                self.set(k, v, source="mon")
            except (ValueError, TypeError, KeyError):
                continue
        return

    # -- get/set ---------------------------------------------------------
    def set(self, name: str, value: Any, source: str = "runtime") -> None:
        if source not in _SOURCE_RANK:
            raise ValueError(f"unknown config source {source!r}")
        opt = self._schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        value = opt.cast(value)
        with self._lock:
            old = self.get(name)
            self._values.setdefault(name, {})[source] = value
            new = self.get(name)
            observers = list(self._observers.get(name, ()))
        if new != old:
            for fn in observers:
                fn(name, new)

    def rm(self, name: str, source: str = "runtime") -> None:
        with self._lock:
            old = self.get(name)
            self._values.get(name, {}).pop(source, None)
            new = self.get(name)
            observers = list(self._observers.get(name, ()))
        if new != old:
            for fn in observers:
                fn(name, new)

    def get(self, name: str, default: Any = None) -> Any:
        with self._lock:
            per_source = self._values.get(name)
            if per_source:
                for source in reversed(SOURCES):
                    if source in per_source:
                        return per_source[source]
        if name in self._defaults:
            return self._defaults[name]
        return default

    def __getitem__(self, name: str) -> Any:
        if name not in self._schema:
            raise KeyError(name)
        return self.get(name)

    # -- observers -------------------------------------------------------
    def add_observer(self, name: str, fn: Callable[[str, Any], None]) -> None:
        with self._lock:
            self._observers.setdefault(name, []).append(fn)

    # -- introspection ---------------------------------------------------
    def dump(self) -> dict[str, Any]:
        return {o.name: self.get(o.name) for o in self.schema()}

    def diff(self) -> dict[str, dict[str, Any]]:
        """Non-default values per source (admin `config diff` analog)."""
        with self._lock:
            return {n: dict(per) for n, per in self._values.items() if per}


DEFAULT_SCHEMA: list[Option] = [
    Option("log_level", OPT_INT, 1, "global log level (0-20)", min=0, max=20),
    Option("log_ring_size", OPT_INT, 10000, "crash-dump ring buffer entries"),
    Option("admin_socket", OPT_STR, "", "path for admin socket, empty=disabled"),
    Option("mon_addrs", OPT_STR, "", "comma-separated monitor host:port list"),
    Option("public_addr", OPT_STR, "", "daemon bind address"),
    Option("heartbeat_interval", OPT_FLOAT, 1.0, "osd peer heartbeat period (s)"),
    Option("heartbeat_grace", OPT_FLOAT, 6.0, "failure grace before reporting (s)"),
    Option("osd_slow_ping_time_ms", OPT_FLOAT, 0.0,
           "heartbeat RTT above this raises OSD_SLOW_PING_TIME for"
           " the peer pair; 0 derives 5 percent of heartbeat_grace"),
    Option("net_peer_max", OPT_INT, 32,
           "per-peer wire-stat rows an osd_stats net report keeps;"
           " the tail folds into an 'other' row"),
    Option("net_label_max", OPT_INT, 8,
           "peer labels per daemon the net exporter families keep;"
           " the tail folds into an 'other' label"),
    Option("mon_osd_down_out_interval", OPT_FLOAT, 30.0,
           "seconds before a down osd is auto-marked out"),
    Option("mon_osd_min_down_reporters", OPT_INT, 1,
           "distinct reporters required to mark an osd down"),
    Option("mon_lease", OPT_FLOAT, 5.0, "paxos lease duration (s)"),
    Option("mon_subscribe_renew_interval", OPT_FLOAT, 10.0,
           "map-subscription renewal period (s): repairs silently "
           "lost publications (partitions, dropped frames)"),
    Option("mon_election_strategy", OPT_STR, "classic",
           "leader election strategy (ElectionLogic modes)",
           enum_allowed=("classic", "disallow", "connectivity")),
    Option("mon_disallowed_leaders", OPT_STR, "",
           "comma-separated ranks that must never lead"
           " (disallow/connectivity strategies)"),
    Option("osd_pool_default_size", OPT_INT, 3, "default replica count"),
    Option("osd_pool_default_min_size", OPT_INT, 2, "min replicas to serve IO"),
    Option("osd_pool_default_pg_num", OPT_INT, 32, "default pg count"),
    Option("osd_op_num_shards", OPT_INT, 4, "op queue shards per osd"),
    Option("osd_mclock_capacity_iops", OPT_FLOAT, 10000.0,
           "assumed per-osd op capacity for mClock tag rates"),
    Option("osd_ec_subop_timeout", OPT_FLOAT, 10.0,
           "deadline for EC sub-op acks before marking peers behind"),
    Option("osd_op_complaint_time", OPT_FLOAT, 30.0,
           "age after which an in-flight tracked op counts as slow"
           " (feeds beacons and the SLOW_OPS health warning)"),
    Option("osd_op_history_size", OPT_INT, 20,
           "completed ops kept in the OpTracker historic ring"),
    Option("osd_op_history_slow_op_size", OPT_INT, 20,
           "completed slow ops kept in the slow historic ring"),
    Option("osd_beacon_report_interval", OPT_FLOAT, 1.0,
           "period of OSD->mon beacons carrying slow-op counts"),
    Option("auth_cluster_required", OPT_STR, "none",
           "cluster auth mode: none | shared (cephx analog)"),
    Option("auth_key", OPT_STR, "",
           "shared cluster secret (the keyring role)"),
    Option("ms_secure_mode", OPT_INT, 0,
           "1 = AEAD-encrypt every frame (ProtocolV2 secure mode)"),
    Option("ms_compress", OPT_STR, "",
           "comma-separated on-wire compression preferences"
           " (msgr2 compression_onwire role); empty = off"),
    Option("osd_recovery_max_active", OPT_INT, 8,
           "max concurrent recovery ops per osd"),
    Option("osd_max_pg_log_entries", OPT_INT, 2000,
           "pg log length before trimming (peers that fall behind the"
           " trimmed tail are backfilled instead of log-recovered)"),
    Option("ec_batch_max_stripes", OPT_INT, 4096,
           "max stripes aggregated into one device EC dispatch"),
    Option("ec_batch_flush_us", OPT_INT, 300,
           "flush-mode deadline before a partial EC batch is flushed"
           " (µs): the window the DEADLINE flush rides when"
           " device_dispatch_mode=flush (the continuous stream has no"
           " flush barrier and ignores it)"),
    Option("ec_batch_max_bytes", OPT_INT, 8 << 20,
           "flush-mode size trigger: a pending EC batch at or above"
           " this many staged bytes flushes immediately instead of"
           " waiting out ec_batch_flush_us"),
    Option("osd_objectstore", OPT_STR, "memstore",
           "backing store engine (src/common/options osd_objectstore)",
           enum_allowed=("memstore", "kstore", "extentstore")),
    Option("osd_data", OPT_STR, "",
           "store directory; empty = ephemeral (RAM engines)"),
    Option("extentstore_device_size", OPT_INT, 1 << 30,
           "initial (sparse) block device size in bytes"),
    Option("extentstore_deferred_threshold", OPT_INT, 65536,
           "writes at or under this many bytes take the deferred WAL"
           " path (bluestore_prefer_deferred_size role)"),
    Option("crush_backend", OPT_STR, "auto", "crush mapping backend",
           enum_allowed=("auto", "host", "jax", "native")),
    Option("ec_backend", OPT_STR, "auto", "erasure-code compute backend",
           enum_allowed=("auto", "host", "jax", "native")),
    # -- device runtime (ceph_tpu.device) -------------------------------
    Option("device_max_inflight", OPT_INT, 2,
           "max concurrent device dispatches (runtime admission bound)"),
    Option("device_queue_len", OPT_INT, 64,
           "dispatch-queue waiters before admission raises DeviceBusy"),
    Option("device_probe_interval", OPT_FLOAT, 1.0,
           "cap of the probe backoff while the device runtime is in"
           " host-fallback (ExpBackoff heal probes)"),
    Option("device_warmup", OPT_INT, 1,
           "pre-compile common EC shape buckets when a profile's codec"
           " is first built (0 disables)"),
    Option("device_dispatch_mode", OPT_STR, "stream",
           "EC dispatch architecture: 'stream' runs the persistent"
           " per-chip dispatch stream (continuous admission into"
           " fixed-geometry slots, independent retire — the"
           " continuous-batching recipe from LLM serving);"
           " 'flush' keeps the legacy accumulate-and-flush batcher"
           " (also the stream's host-fallback/DeviceBusy degradation"
           " route and the bench baseline)",
           enum_allowed=("stream", "flush")),
    Option("device_stream_interval_us", OPT_INT, 100,
           "admission-loop idle tick (µs) of the per-chip dispatch"
           " stream: the loop wakes immediately on arrivals and slot"
           " completions, and at most this long apart otherwise"),
    Option("device_stream_slot_words", OPT_INT, 1 << 19,
           "slot-ladder geometry cap: max words one stream slot group"
           " stages (a group covers its words with the pow2 bucket"
           " ladder, so slot programs are the same compiled family"
           " flush batching uses; ops larger than this mesh-shard"
           " like oversized flushes)"),
    Option("device_stream_max_slots", OPT_INT, 4,
           "concurrent slot dispatches a chip's stream keeps in"
           " flight; further admissions stay pending in the stream"
           " (where a later-arriving urgent class can still overtake)"
           " instead of parking deep in the device queue"),
    Option("device_shard_min_words", OPT_INT, 1 << 19,
           "EC flushes at or above this many words per chunk shard"
           " column-wise across every available mesh chip (the"
           " collective-free stripe-axis split); flushes below it"
           " stay on the caller's affinity chip"),
    Option("osd_pg_log_dups_tracked", OPT_INT, 128,
           "reqid (client,tid) dup-detection journal entries kept per"
           " PG (PrimaryLogPG osd_reqid_t dedup analog)"),
    Option("osd_mgr_report_interval", OPT_FLOAT, 2.0,
           "seconds between MMgrReports (perf counters + per-PG stat"
           " rows) to the active manager"),
    Option("mgr_stats_period", OPT_FLOAT, 1.0,
           "seconds between the mgr's PGMap digests to the monitors"
           " (feeds status/df/pool-stats and PG_* health checks)"),
    Option("mgr_stats_stale_after", OPT_FLOAT, 15.0,
           "per-PG stat rows older than this are dropped from the"
           " PGMap (a dead primary's last report must age out)"),
    Option("mgr_stats_prune_after", OPT_FLOAT, 60.0,
           "per-PG stat rows (and per-daemon report extras) with no"
           " refresh within this window are COMPACTED out of the"
           " mgr's column store, visibly counted"
           " (ceph_tpu_mgr_rows_pruned_total); folds already mask"
           " them at mgr_stats_stale_after, pruning reclaims the"
           " rows"),
    Option("osd_stats_columnar", OPT_BOOL, True,
           "ship per-PG stat rows as a packed columnar block"
           " (MMgrReport pg_stats_cols, the telemetry-fabric wire"
           " format the mgr ingests as one vectorized merge); off ="
           " legacy dict-shaped rows (mixed fleets converge to the"
           " same digest either way)"),
    Option("mon_crash_warn_age", OPT_FLOAT, 14 * 24 * 3600.0,
           "un-archived crash reports newer than this raise the"
           " RECENT_CRASH health warning (mgr/crash warn_recent_"
           "interval role)"),
    Option("mon_crash_retention", OPT_FLOAT, 30 * 24 * 3600.0,
           "ARCHIVED crash reports older than this are auto-pruned"
           " from the committed crash table at commit/tick time"
           " (mgr/crash retain_interval role); <= 0 disables"),
    Option("memstore_device_bytes", OPT_INT, 1 << 30,
           "nominal device size RAM stores report in statfs (the"
           " df raw-capacity denominator)"),
    Option("osd_crash_ring_tail", OPT_INT, 100,
           "LogRing entries captured into a crash report (the"
           " post-mortem high-verbosity context)"),
    # -- flight recorder (ceph_tpu.trace.recorder) -----------------------
    Option("flight_recorder_ring", OPT_INT, 2048,
           "span records kept in each daemon's flight-recorder ring"
           " (op spans, background-work spans)"),
    Option("flight_recorder_sample", OPT_INT, 4,
           "1-in-N trace sampling for retained op records (keyed on"
           " the trace id so a sampled write is complete on every"
           " daemon; slow ops are always retained; 1 keeps every"
           " trace)"),
    Option("device_util_window", OPT_FLOAT, 10.0,
           "window (s) of the per-chip utilization integrals"
           " (busy / queue-wait / idle fractions fed to the exporter,"
           " the mgr digest and `status`)"),
    # -- integrity plane (scrub scheduling + straggler handling) ---------
    Option("osd_scrub_interval", OPT_FLOAT, 24 * 3600.0,
           "seconds between automatic shallow scrubs of each PG"
           " (osd_scrub_min_interval role); <= 0 disables periodic"
           " scrubbing"),
    Option("osd_deep_scrub_interval", OPT_FLOAT, 7 * 24 * 3600.0,
           "seconds between automatic deep scrubs of each PG"
           " (byte digests vs the hinfo crc vote); <= 0 disables"),
    Option("osd_scrub_chunk_timeout", OPT_FLOAT, 5.0,
           "deadline for a replica's scrub map per chunk; a member"
           " that misses it (after one retry) is recorded"
           " unavailable — never conflated with object absence"),
    # -- scale plane (ceph_tpu.scale) ------------------------------------
    Option("mon_crush_osds_per_host", OPT_INT, 0,
           "group booting osds into straw2 host buckets of this size"
           " (chooseleaf-over-hosts rules, real failure domains, and"
           " O(hosts + size) placement draws instead of O(osds));"
           " 0 keeps the flat vstart root"),
    Option("mon_map_catchup_max", OPT_INT, 64,
           "a subscriber more than this many epochs behind is caught"
           " up with ONE full map instead of the whole incremental"
           " history (bounds late-joiner wire cost)"),
    Option("mon_propose_batch_window", OPT_FLOAT, 0.0,
           "seconds the mon folds storm-prone fire-and-forget"
           " mutations (boots, clog appends) into one proposal before"
           " committing; 0 = commit immediately (a 10k-shell boot"
           " storm would otherwise burn one epoch + full-map encode"
           " per boot)"),
    Option("shell_report_interval", OPT_FLOAT, 1.0,
           "period of a ShellOSD's beacon + synthetic-stats report"),
    Option("shell_objects_per_pg", OPT_INT, 8,
           "synthetic objects each shell PG reports (drives the"
           " misplaced/degraded accounting at scale)"),
    Option("shell_object_bytes", OPT_INT, 1 << 20,
           "synthetic bytes per shell object"),
    Option("shell_recovery_objects_per_s", OPT_FLOAT, 256.0,
           "simulated backfill drain rate per shell (misplaced"
           " objects recovered per second)"),
    Option("mgr_balancer_mode", OPT_STR, "batched",
           "upmap optimizer flavor: 'batched' scores thousands of"
           " candidate moves per tick in one device dispatch"
           " (scale.balancer); 'sequential' keeps the reference's"
           " greedy calc_pg_upmaps walk",
           enum_allowed=("batched", "sequential")),
    Option("mgr_balancer_max_changes", OPT_INT, 48,
           "upmap items committed per batched balancer tick (bounds"
           " the per-tick mon command fan-out)"),
    # -- tenant SLO plane (per-tenant QoS + mgr/slo.py burn engine) ------
    Option("osd_mclock_tenant_reservation", OPT_FLOAT, 0.05,
           "default per-tenant dmClock reservation (fraction of osd"
           " capacity) for tenants without an osd_mclock_tenant_qos"
           " row"),
    Option("osd_mclock_tenant_weight", OPT_FLOAT, 1.0,
           "default per-tenant dmClock weight"),
    Option("osd_mclock_tenant_limit", OPT_FLOAT, 1.0,
           "default per-tenant dmClock limit (fraction of osd"
           " capacity; the hard ceiling a bully tenant is throttled"
           " at)"),
    Option("osd_mclock_tenant_qos", OPT_STR, "",
           "per-tenant dmClock RWL rows:"
           " 'tenant:res_frac:weight:lim_frac,...' — e.g."
           " 'bully:0.05:0.5:0.15,victim:0.30:4:1.0'; tenants"
           " without a row take the osd_mclock_tenant_* defaults"),
    Option("tenant_tracking_max", OPT_INT, 64,
           "distinct tenants tracked per OSD (stage histograms, op"
           " counters, tag books); overflow tenants fold into the"
           " 'other' bucket so a tenant-id flood cannot grow daemon"
           " state without bound"),
    Option("tenant_label_max", OPT_INT, 32,
           "distinct tenant label values any exporter family may"
           " carry; overflow tenants fold into tenant=\"other\""
           " (Prometheus cardinality guard)"),
    Option("slo_latency_target_ms", OPT_FLOAT, 100.0,
           "per-tenant latency objective: the op duration a"
           " 'good' op must finish under (pow2-µs bucket"
           " resolution)"),
    Option("slo_latency_objective", OPT_FLOAT, 0.99,
           "fraction of a tenant's ops that must finish under the"
           " latency target (1 - objective is the error budget the"
           " burn rates divide by)"),
    Option("slo_fast_window", OPT_FLOAT, 60.0,
           "fast burn-rate window (s) of the multi-window SLO"
           " alerts (the page-now window)"),
    Option("slo_slow_window", OPT_FLOAT, 300.0,
           "slow burn-rate window (s) — both windows must burn for"
           " SLO_BURN to raise (one spike alone never pages)"),
    Option("slo_burn_fast", OPT_FLOAT, 14.4,
           "burn-rate threshold over the fast window (14.4 = the"
           " SRE-workbook 2%%-budget-in-1h rate)"),
    Option("slo_burn_slow", OPT_FLOAT, 6.0,
           "burn-rate threshold over the slow window"),
    Option("slo_min_ops", OPT_INT, 30,
           "minimum ops observed in the fast window before a"
           " tenant's SLO verdicts count (no alerts from noise)"),
    # -- history plane (downsampled metric rings + anomaly edges) --------
    Option("history_tiers", OPT_STR, "5:120,30:120,300:288",
           "downsampling ladder of the history rings as"
           " 'width_s:cells' pairs (default: ten minutes at 5s, an"
           " hour at 30s, a day at 5min — fixed memory by"
           " construction)"),
    Option("history_label_max", OPT_INT, 32,
           "distinct label values any history series may retain;"
           " overflow labels are dropped AND counted"
           " (dropped_labels), never silently folded"),
    Option("history_anomaly_series", OPT_STR,
           "device.busy_frac,device.queue_wait_frac,"
           "tenant.p99_ms,tenant.burn_fast,"
           "net.rtt_ms,net.resend_rate",
           "comma-separated HISTORY_SERIES names the anomaly engine"
           " watches for sustained upward shifts"),
    Option("history_anomaly_z", OPT_FLOAT, 6.0,
           "one-sided z-score a watched series must sustain to"
           " raise PERF_ANOMALY (deliberately deaf: routine load"
           " swings never page)"),
    Option("history_anomaly_clear_z", OPT_FLOAT, 2.0,
           "z-score a raised series must drop below (sustained) to"
           " clear; between raise and clear the baseline is frozen"),
    Option("history_anomaly_sustain", OPT_INT, 8,
           "consecutive hot ticks before a shifted series raises"),
    Option("history_anomaly_clear", OPT_INT, 4,
           "consecutive cooled ticks before a raised series clears"),
    Option("history_anomaly_min_samples", OPT_INT, 60,
           "warm-up samples before a series' z-scores count (a"
           " fresh baseline must settle before it can page)"),
    Option("history_anomaly_alpha", OPT_FLOAT, 0.05,
           "EWMA weight of the anomaly baseline's mean/variance"
           " once warmed up"),
]
