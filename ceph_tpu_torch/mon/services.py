"""Monitor services: centralized config, auth registry, health
checks, and the cluster log.

Analogs of the reference's PaxosService quartet
(src/mon/ConfigMonitor.cc, AuthMonitor.cc, HealthMonitor.cc,
LogMonitor.cc) collapsed to the same shape this framework's
OSDMonitor uses: every mutation is a small op list riding the SAME
paxos commit stream as map changes ("svc" payload beside
"osdmap_inc"), applied deterministically on every monitor (leader,
peons, and crash-recovery replay all run the identical apply path),
with the full service state persisted in the mon KV per commit.

* ConfigMonitor — the centralized option store (`config set/get/rm/
  dump`): values are scoped to "global", an entity type ("osd",
  "mon", "client"), or one daemon ("osd.2"); every commit pushes the
  resolved per-entity view to subscribed daemons (MConfig), which
  feed their Config's "mon" source — the layer utils/config.py
  always had a slot for.
* AuthMonitor — per-entity secrets + caps (`auth get-or-create/get/
  ls/del`).  The wire handshake still rides the shared cluster key
  (msg/auth.py documents that collapse); this registry is the
  durable, replicated identity database the cephx ticket flow would
  consume.
* HealthMonitor — DERIVED state, no paxos writes: aggregates osd
  liveness, quorum shape, stuck-pg hints, and the slow-op counts
  beaconed by OSDs (SLOW_OPS) into HEALTH_OK/WARN/ERR + check list
  (`health`).
* LogMonitor — the capped cluster log (`log` / `log last`): the mon
  itself appends lifecycle events (boots, mark-downs, auto-outs), so
  `log last` answers "what just happened" exactly like
  `ceph log last`.
"""

from __future__ import annotations

import os
import time

from ..utils import denc

CONFIG_KEY = b"svc:config"
AUTH_KEY = b"svc:auth"
LOG_KEY = b"svc:log"
HEALTH_KEY = b"svc:health"
CRASH_KEY = b"svc:crash"
EVENTS_KEY = b"svc:events"

LOG_CAP = 1000
EVENT_CAP = 1000


class ConfigMonitor:
    def __init__(self, mon):
        self.mon = mon
        # who -> {option name -> value}; who = "global" | type | id
        self.values: dict[str, dict[str, str]] = {}

    # -- persistence / replay ----------------------------------------------

    def load(self) -> None:
        raw = self.mon.store.get(CONFIG_KEY)
        if raw is not None:
            self.values = {w: dict(kv)
                           for w, kv in denc.decode(raw).items()}

    def apply(self, ops: list, tx) -> None:
        """Deterministic commit apply (every mon runs this)."""
        for op in ops:
            if op[0] == "set":
                _c, who, name, value = op
                self.values.setdefault(who, {})[name] = value
            elif op[0] == "rm":
                _c, who, name = op
                self.values.get(who, {}).pop(name, None)
                if who in self.values and not self.values[who]:
                    del self.values[who]
        tx.set(CONFIG_KEY, denc.encode(self.values))

    # -- resolution ---------------------------------------------------------

    def resolved_for(self, entity: str) -> dict[str, str]:
        """global < type < exact id (ConfigMonitor's mask order)."""
        etype = entity.split(".", 1)[0]
        out: dict[str, str] = {}
        for who in ("global", etype, entity):
            out.update(self.values.get(who, {}))
        return out

    def push(self, conn, entity: str) -> None:
        from ..msg.messages import MConfig

        conn.send(MConfig(values=self.resolved_for(entity)))

    def push_all(self) -> None:
        """After a config commit: every subscriber gets its fresh
        resolved view (the reference pushes MConfig on maps_update)."""
        for conn in list(self.mon.subscribers):
            if conn.is_open:
                self.push(conn, conn.peer_entity or "client")

    # -- commands -----------------------------------------------------------

    def command(self, prefix: str, cmd: dict):
        if prefix == "config set":
            who = cmd.get("who", "global")
            name, value = cmd["name"], str(cmd["value"])
            # validate against the shared schema BEFORE committing: a
            # poison name/value in the replicated store would chase
            # every daemon forever (daemons also skip defensively)
            from ..utils.config import DEFAULT_SCHEMA

            opt = next((o for o in DEFAULT_SCHEMA if o.name == name),
                       None)
            if opt is None:
                raise ValueError("unknown option %r" % name)
            opt.cast(value)             # raises on a bad value
            self.mon.queue_svc_op("config",
                                  ("set", who, name, value))
            return {}
        if prefix == "config rm":
            self.mon.queue_svc_op(
                "config", ("rm", cmd.get("who", "global"),
                           cmd["name"]))
            return {}
        if prefix == "config get":
            return {"values": self.resolved_for(cmd.get("who",
                                                        "global"))}
        if prefix == "config dump":
            return {"values": {w: dict(kv)
                               for w, kv in self.values.items()}}
        return None


class AuthMonitor:
    def __init__(self, mon):
        self.mon = mon
        # entity -> {"key": hex str, "caps": {service: capspec}}
        self.entities: dict[str, dict] = {}

    def load(self) -> None:
        raw = self.mon.store.get(AUTH_KEY)
        if raw is not None:
            self.entities = {e: dict(v)
                             for e, v in denc.decode(raw).items()}

    def apply(self, ops: list, tx) -> None:
        for op in ops:
            if op[0] == "add":
                _c, entity, key, caps = op
                self.entities[entity] = {"key": key,
                                         "caps": dict(caps or {})}
            elif op[0] == "caps":
                _c, entity, caps = op
                if entity in self.entities:
                    self.entities[entity]["caps"] = dict(caps or {})
            elif op[0] == "del":
                self.entities.pop(op[1], None)
        tx.set(AUTH_KEY, denc.encode(self.entities))

    def command(self, prefix: str, cmd: dict):
        if prefix == "auth get-or-create":
            entity = cmd["entity"]
            ent = self.entities.get(entity)
            if ent is not None:
                return {"entity": entity, "key": ent["key"]}
            # concurrent get-or-create for one entity: the pending
            # (queued but uncommitted) add must win, or the first
            # caller gets a key the registry never stores
            for op in self.mon.pending_svc.get("auth", []):
                if op[0] == "add" and op[1] == entity:
                    return {"entity": entity, "key": op[2]}
            key = os.urandom(16).hex()
            self.mon.queue_svc_op(
                "auth", ("add", entity, key,
                         dict(cmd.get("caps") or {})))
            return {"entity": entity, "key": key}
        if prefix == "auth get":
            ent = self.entities.get(cmd["entity"])
            if ent is None:
                raise ValueError("no such entity")
            return {"entity": cmd["entity"], "key": ent["key"],
                    "caps": dict(ent.get("caps") or {})}
        if prefix == "auth caps":
            if cmd["entity"] not in self.entities:
                raise ValueError("no such entity")
            self.mon.queue_svc_op(
                "auth", ("caps", cmd["entity"],
                         dict(cmd.get("caps") or {})))
            return {}
        if prefix == "auth del":
            self.mon.queue_svc_op("auth", ("del", cmd["entity"]))
            return {}
        if prefix == "auth ls":
            return {"entities": {
                e: {"caps": dict(v.get("caps") or {})}
                for e, v in sorted(self.entities.items())}}
        return None


class HealthMonitor:
    """Health checks: mostly derived on demand, but beacon-fed soft
    state (slow-op counts, chip-loss flags) is ALSO committed
    through paxos by the leader on every transition, so a freshly
    elected leader — including one that never saw a single beacon —
    reports SLOW_OPS / DEVICE_LOST immediately instead of waiting
    one beacon round (closes the PR-2 gap).  Recent soft state wins
    over the committed snapshot (it is newer by construction); the
    committed state fills the gap until beacons reach the new
    leader."""

    # soft-state freshness window: beacons older than this defer to
    # the committed snapshot / other checks (OSD_DOWN covers daemons
    # whose beacons stopped entirely)
    SOFT_TTL = 30.0

    def __init__(self, mon):
        self.mon = mon
        # committed (paxos) snapshot: {"slow": {osd: n},
        #                              "devflb": {osd: 0 | 1+chip},
        #                              "pgdeg": n degraded objects,
        #                              "pgavail": n inactive pgs,
        #                              "scruberr": n scrub errors,
        #                              "pgdmg": n inconsistent pgs}
        # devflb values are chip-encoded (0 = on-device, 1+chip =
        # that mesh chip lost) so the health detail can name the
        # degraded chip even on a freshly elected leader.  slolat /
        # sloburn keep the VIOLATING TENANT NAMES committed (sorted
        # lists), so a fresh leader's SLO_LATENCY / SLO_BURN detail
        # still names them before any mgr digest reaches it.
        self.persisted: dict = {"slow": {}, "devflb": {},
                                "pgdeg": 0, "pgavail": 0,
                                "scruberr": 0, "pgdmg": 0,
                                "slolat": [], "sloburn": [],
                                "perfanom": [], "slowping": []}

    # -- persistence / replay ------------------------------------------

    def load(self) -> None:
        raw = self.mon.store.get(HEALTH_KEY)
        if raw is not None:
            d = denc.decode(raw)
            self.persisted = {
                "slow": {int(k): int(v)
                         for k, v in (d.get("slow") or {}).items()},
                "devflb": {int(k): int(v)
                           for k, v in
                           (d.get("devflb") or {}).items()},
                "pgdeg": int(d.get("pgdeg") or 0),
                "pgavail": int(d.get("pgavail") or 0),
                "scruberr": int(d.get("scruberr") or 0),
                "pgdmg": int(d.get("pgdmg") or 0),
                "slolat": sorted(str(t)
                                 for t in (d.get("slolat") or [])),
                "sloburn": sorted(str(t)
                                  for t in (d.get("sloburn") or [])),
                "perfanom": sorted(
                    str(t) for t in (d.get("perfanom") or [])),
                "slowping": sorted(
                    str(t) for t in (d.get("slowping") or []))}

    def apply(self, ops: list, tx) -> None:
        """Deterministic commit apply (every mon runs this)."""
        for op in ops:
            if op[0] == "slow":
                _c, osd, n = op
                if int(n):
                    self.persisted["slow"][int(osd)] = int(n)
                else:
                    self.persisted["slow"].pop(int(osd), None)
            elif op[0] == "devflb":
                _c, osd, flag = op
                if int(flag):
                    self.persisted["devflb"][int(osd)] = 1
                else:
                    self.persisted["devflb"].pop(int(osd), None)
            elif op[0] in ("pgdeg", "pgavail", "scruberr", "pgdmg"):
                self.persisted[op[0]] = int(op[1])
            elif op[0] in ("slolat", "sloburn", "perfanom",
                           "slowping"):
                self.persisted[op[0]] = sorted(
                    str(t) for t in (op[1] or []))
        tx.set(HEALTH_KEY, denc.encode(
            {"slow": dict(self.persisted["slow"]),
             "devflb": dict(self.persisted["devflb"]),
             "pgdeg": int(self.persisted["pgdeg"]),
             "pgavail": int(self.persisted["pgavail"]),
             "scruberr": int(self.persisted["scruberr"]),
             "pgdmg": int(self.persisted["pgdmg"]),
             "slolat": list(self.persisted["slolat"]),
             "sloburn": list(self.persisted["sloburn"]),
             "perfanom": list(self.persisted["perfanom"]),
             "slowping": list(self.persisted["slowping"])}))

    def _edge(self, level: str, check: str, message: str) -> None:
        """One health-check transition: clog it (the reference clogs
        every edge) AND mirror it onto the event bus, so a live
        watch-events cursor sees the raise/clear the moment it
        commits."""
        self.mon.log_mon.append(level, message)
        emit = getattr(self.mon, "emit_event", None)
        if emit is not None:
            emit("health_edge", message,
                 data={"check": check, "raised": level != "INF"})

    def maybe_commit(self, osd: int, slow: int, devflb: int) -> None:
        """Leader-side: stage a health svc op when a beacon changes
        the committed picture (transitions only — steady-state
        beacons cost no paxos rounds).  Pending-queue dedup keeps a
        beacon burst from stacking identical ops in one proposal."""
        pend = self.mon.pending_svc.get("health", [])

        def pending_val(kind):
            for op in reversed(pend):
                if op[0] == kind and int(op[1]) == osd:
                    return int(op[2])
            return None

        cur = pending_val("slow")
        if cur is None:
            cur = self.persisted["slow"].get(osd, 0)
        if int(slow) != cur:
            self.mon.queue_svc_op("health", ("slow", osd, int(slow)))
            # raise/clear edges are cluster-log events (the reference
            # clogs every health-check transition): committed beside
            # the health op, so every mon's `log last` shows them
            if (int(slow) > 0) != (cur > 0):
                if int(slow):
                    self._edge(
                        "WRN", "SLOW_OPS",
                        "Health check failed: %d slow ops on "
                        "osd.%d (SLOW_OPS)" % (int(slow), osd))
                else:
                    self._edge(
                        "INF", "SLOW_OPS",
                        "Health check cleared: SLOW_OPS "
                        "(osd.%d)" % osd)
        cur = pending_val("devflb")
        if cur is None:
            cur = self.persisted["devflb"].get(osd, 0)
        if int(devflb) != cur:
            self.mon.queue_svc_op("health",
                                  ("devflb", osd, int(devflb)))
            if int(devflb):
                self._edge(
                    "WRN", "DEVICE_LOST",
                    "Health check failed: osd.%d ops failing, "
                    "device chip %d lost "
                    "(DEVICE_LOST)" % (osd, int(devflb) - 1))
            else:
                self._edge(
                    "INF", "DEVICE_LOST",
                    "Health check cleared: DEVICE_LOST "
                    "(osd.%d)" % osd)

    def maybe_commit_digest(self, degraded: int, inactive: int,
                            scrub_errors: int = 0,
                            damaged_pgs: int = 0) -> None:
        """Leader-side: persist PGMap-digest transitions (degraded
        objects / inactive PGs / scrub errors raise-and-clear)
        through paxos, like the beacon-fed checks — a freshly elected
        leader that never saw a digest reports PG_DEGRADED /
        PG_AVAILABILITY / OSD_SCRUB_ERRORS / PG_DAMAGED immediately.
        Only the raised/cleared EDGE commits (a jittery nonzero count
        does not burn a paxos round per digest)."""
        pend = self.mon.pending_svc.get("health", [])

        def pending_val(kind):
            for op in reversed(pend):
                if op[0] == kind:
                    return int(op[1])
            return None

        for kind, val, check, what in (
                ("pgdeg", int(degraded), "PG_DEGRADED",
                 "%d objects degraded"),
                ("pgavail", int(inactive), "PG_AVAILABILITY",
                 "%d pgs inactive"),
                ("scruberr", int(scrub_errors), "OSD_SCRUB_ERRORS",
                 "%d scrub errors"),
                ("pgdmg", int(damaged_pgs), "PG_DAMAGED",
                 "Possible data damage: %d pgs inconsistent")):
            cur = pending_val(kind)
            if cur is None:
                cur = int(self.persisted[kind])
            # commit on raise/clear edges and on big count moves; a
            # steady nonzero that wobbles (recovery draining) only
            # commits when it crosses zero
            if (val > 0) != (cur > 0):
                self.mon.queue_svc_op("health", (kind, val))
                if val:
                    self._edge(
                        "WRN", check,
                        "Health check failed: %s (%s)"
                        % (what % val, check))
                else:
                    self._edge(
                        "INF", check,
                        "Health check cleared: %s" % check)

    def maybe_commit_slo(self, lat_tenants: list,
                         burn_tenants: list) -> None:
        """Leader-side: persist the SLO-violating tenant SETS from
        the mgr digest through paxos — edges only (a steady violation
        burns no paxos rounds; the list commits when it CHANGES), so
        a freshly elected leader raises SLO_LATENCY / SLO_BURN with
        the offending tenants named before any digest reaches it."""
        pend = self.mon.pending_svc.get("health", [])

        def pending_val(kind):
            for op in reversed(pend):
                if op[0] == kind:
                    return list(op[1])
            return None

        for kind, val, check in (
                ("slolat", sorted(set(map(str, lat_tenants))),
                 "SLO_LATENCY"),
                ("sloburn", sorted(set(map(str, burn_tenants))),
                 "SLO_BURN")):
            cur = pending_val(kind)
            if cur is None:
                cur = list(self.persisted[kind])
            if val == cur:
                continue
            self.mon.queue_svc_op("health", (kind, val))
            if bool(val) != bool(cur):
                if val:
                    self._edge(
                        "WRN", check,
                        "Health check failed: tenant(s) %s "
                        "%s (%s)"
                        % (",".join(val),
                           "over latency objective"
                           if kind == "slolat"
                           else "burning SLO error budget", check))
                else:
                    self._edge(
                        "INF", check,
                        "Health check cleared: %s" % check)

    def maybe_commit_anomaly(self, anomalies: dict) -> None:
        """Leader-side: persist the ACTIVE PERF_ANOMALY series names
        from the mgr digest through paxos — same edges-only contract
        as the SLO sets (a steady anomaly burns no rounds; the name
        list commits when it changes), so a freshly elected leader
        still names the shifted series before any digest reaches
        it."""
        pend = self.mon.pending_svc.get("health", [])
        val = sorted(map(str, anomalies or ()))
        cur = None
        for op in reversed(pend):
            if op[0] == "perfanom":
                cur = list(op[1])
                break
        if cur is None:
            cur = list(self.persisted["perfanom"])
        if val == cur:
            return
        self.mon.queue_svc_op("health", ("perfanom", val))
        if bool(val) != bool(cur):
            if val:
                self._edge(
                    "WRN", "PERF_ANOMALY",
                    "Health check failed: sustained perf shift on "
                    "series %s (PERF_ANOMALY)" % ",".join(val))
            else:
                self._edge(
                    "INF", "PERF_ANOMALY",
                    "Health check cleared: PERF_ANOMALY")

    def maybe_commit_slow_ping(self, pairs) -> None:
        """Leader-side: persist the SLOW-PING PEER PAIRS (the network
        plane, osd/network.py) through paxos — edges only, like the
        SLO/anomaly sets: the "osd.A-osd.B" pair list commits when it
        CHANGES, so a freshly elected leader still names the worst
        peer pairs before any beacon reaches it."""
        pend = self.mon.pending_svc.get("health", [])
        val = sorted(map(str, pairs or ()))
        cur = None
        for op in reversed(pend):
            if op[0] == "slowping":
                cur = list(op[1])
                break
        if cur is None:
            cur = list(self.persisted["slowping"])
        if val == cur:
            return
        self.mon.queue_svc_op("health", ("slowping", val))
        if bool(val) != bool(cur):
            if val:
                self._edge(
                    "WRN", "OSD_SLOW_PING_TIME",
                    "Health check failed: slow heartbeat pings on "
                    "peer pair(s) %s (OSD_SLOW_PING_TIME)"
                    % ",".join(val))
            else:
                self._edge(
                    "INF", "OSD_SLOW_PING_TIME",
                    "Health check cleared: OSD_SLOW_PING_TIME")

    # -- merged beacon views -------------------------------------------

    def _merged(self, soft: dict, committed: dict) -> dict:
        """osd -> value: fresh soft state wins, committed snapshot
        fills in for daemons this mon has not heard from; daemons the
        map says are down are excluded (they surface as OSD_DOWN)."""
        import time as _t
        now = _t.monotonic()
        m = self.mon.osdmap
        out: dict[int, int] = {}
        for osd, v in committed.items():
            if osd < m.max_osd and m.is_up(osd):
                out[osd] = v
        for osd, (v, stamp) in soft.items():
            if now - stamp < self.SOFT_TTL:
                if v:
                    out[osd] = v
                else:
                    out.pop(osd, None)
        return out

    def checks(self) -> dict:
        m = self.mon.osdmap
        out: dict[str, dict] = {}
        down = [o for o in range(m.max_osd)
                if m.exists(o) and not m.is_up(o)]
        if down:
            out["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": "%d osds down" % len(down),
                "detail": ["osd.%d is down" % o for o in down[:10]]}
        out_osds = [o for o in range(m.max_osd)
                    if m.exists(o) and m.is_out(o)]
        if out_osds:
            out["OSD_OUT"] = {
                "severity": "HEALTH_WARN",
                "summary": "%d osds out" % len(out_osds),
                "detail": []}
        if self.mon.multi:
            quorum = (self.mon.elector.quorum
                      if self.mon.elector else set())
            total = len(self.mon.monmap)
            if self.mon.is_leader() and len(quorum) < total:
                out["MON_DOWN"] = {
                    "severity": "HEALTH_WARN",
                    "summary": "%d/%d mons in quorum"
                               % (len(quorum), total),
                    "detail": []}
        # SLOW_OPS (the reference's HealthMonitor check fed by
        # MOSDBeacon slow-op counts): raised while any live daemon
        # reports in-flight ops past osd_op_complaint_time — via a
        # recent beacon OR the paxos-committed snapshot a previous
        # leader left (so a fresh leader warns immediately); clears
        # as soon as later beacons report zero (a dead osd surfaces
        # as OSD_DOWN, not SLOW_OPS)
        slow = self._merged(getattr(self.mon, "osd_slow_ops", {}),
                            self.persisted["slow"])
        slow_daemons = sorted(o for o, n in slow.items() if n > 0)
        slow_total = sum(n for n in slow.values() if n > 0)
        if slow_total:
            out["SLOW_OPS"] = {
                "severity": "HEALTH_WARN",
                "summary": "%d slow ops, daemons %s"
                           % (slow_total,
                              ["osd.%d" % o
                               for o in slow_daemons[:10]]),
                "detail": ["osd.%d has %d ops past the complaint "
                           "threshold" % (o, slow[o])
                           for o in slow_daemons[:10]]}
            # per-tenant attribution (beacon soft state): name the
            # tenant owning the most slow ops so noisy-neighbor
            # triage starts from the health line, not a dump crawl
            import time as _tt
            tnow = _tt.monotonic()
            per_tenant: dict[str, int] = {}
            for osd, (tmap, stamp) in getattr(
                    self.mon, "osd_slow_tenants", {}).items():
                if tnow - stamp >= self.SOFT_TTL or osd not in slow:
                    continue
                for t, n in (tmap or {}).items():
                    if t:       # "" = tenant-less ops
                        per_tenant[t] = per_tenant.get(t, 0) + int(n)
            if per_tenant:
                worst = max(sorted(per_tenant),
                            key=lambda t: per_tenant[t])
                out["SLOW_OPS"]["worst_tenant"] = worst
                out["SLOW_OPS"]["detail"].append(
                    "worst tenant: %s (%d slow ops)"
                    % (worst, per_tenant[worst]))
        # DEVICE_LOST: a daemon's mesh chip is lost and its device
        # ops (EC, mapping, planes) fail until the probe heals it —
        # scoped to the OSDs bound to the lost chip (the rest of the
        # mesh keeps serving).  Raised while any live daemon reports
        # it (beacon or committed snapshot); the detail names the
        # lost chip; clears when the chip heals and beacons say so.
        # Values are chip-encoded: 1+chip.
        flb = self._merged(
            getattr(self.mon, "osd_device_lost", {}),
            self.persisted["devflb"])
        flb_daemons = sorted(o for o, v in flb.items() if v)
        if flb_daemons:
            chips = sorted({int(flb[o]) - 1 for o in flb_daemons})
            out["DEVICE_LOST"] = {
                "severity": "HEALTH_WARN",
                "summary": "%d daemons failing device ops (device "
                           "chips %s lost): %s"
                           % (len(flb_daemons), chips,
                              ["osd.%d" % o
                               for o in flb_daemons[:10]]),
                "chips": chips,
                "detail": ["osd.%d device ops failing until chip %d"
                           " heals"
                           % (o, int(flb[o]) - 1)
                           for o in flb_daemons[:10]]}
        # PG_DEGRADED / PG_AVAILABILITY (the reference's PGMap-fed
        # health checks): a fresh mgr digest wins; the paxos-committed
        # snapshot a previous leader left fills in until digests reach
        # this mon (so a fresh leader warns immediately)
        import time as _t
        dig = getattr(self.mon, "mgr_digest", None)
        dig_stamp = getattr(self.mon, "mgr_digest_stamp", 0.0)
        fresh = (dig is not None
                 and _t.monotonic() - dig_stamp < self.SOFT_TTL)
        slo_detail: dict[str, dict] = {}
        if fresh:
            totals = dig.get("totals") or {}
            degraded = int(totals.get("degraded") or 0)
            unfound = int(totals.get("unfound") or 0)
            inactive = int(dig.get("inactive_pgs") or 0)
            scrub_errors = int(totals.get("scrub_errors") or 0)
            damaged = int(dig.get("inconsistent_pgs") or 0)
            slo_detail = dig.get("slo") or {}
            slo_lat = sorted(t for t, v in slo_detail.items()
                             if v.get("latency_violation"))
            slo_burn = sorted(t for t, v in slo_detail.items()
                              if v.get("burn_alert"))
            anom_detail = dig.get("anomalies") or {}
            anom = sorted(anom_detail)
        else:
            degraded = int(self.persisted["pgdeg"])
            unfound = 0
            inactive = int(self.persisted["pgavail"])
            scrub_errors = int(self.persisted["scruberr"])
            damaged = int(self.persisted["pgdmg"])
            # fresh-leader shape: the committed tenant sets carry the
            # warning until digests reach this mon
            slo_lat = list(self.persisted["slolat"])
            slo_burn = list(self.persisted["sloburn"])
            anom_detail = {}
            anom = list(self.persisted["perfanom"])
        if degraded or unfound:
            detail = ["%d object copies degraded" % degraded]
            if unfound:
                detail.append("%d objects unfound" % unfound)
            out["PG_DEGRADED"] = {
                "severity": ("HEALTH_ERR" if unfound
                             else "HEALTH_WARN"),
                "summary": "Degraded data redundancy: %d objects "
                           "degraded%s"
                           % (degraded,
                              (", %d unfound" % unfound)
                              if unfound else ""),
                "detail": detail}
        if inactive:
            out["PG_AVAILABILITY"] = {
                "severity": "HEALTH_WARN",
                "summary": "Reduced data availability: %d pgs "
                           "inactive" % inactive,
                "detail": []}
        # OSD_SCRUB_ERRORS / PG_DAMAGED (the reference's scrub-fed
        # health checks): raised while any PG's last scrub left a
        # nonzero residual inconsistency count — via a fresh digest
        # or the paxos-committed snapshot — and cleared ONLY when a
        # repair scrub drains the residual to zero (the reference's
        # "repair then re-scrub" contract)
        if scrub_errors:
            out["OSD_SCRUB_ERRORS"] = {
                "severity": "HEALTH_ERR",
                "summary": "%d scrub errors" % scrub_errors,
                "detail": []}
        if damaged:
            out["PG_DAMAGED"] = {
                "severity": "HEALTH_ERR",
                "summary": "Possible data damage: %d pgs "
                           "inconsistent" % damaged,
                "detail": ["%d scrub errors across %d pgs; run "
                           "`pg repair <pgid>` to rebuild from the "
                           "authoritative copies"
                           % (scrub_errors, damaged)]}
        # SLO_LATENCY / SLO_BURN (the tenant SLO plane, mgr/slo.py):
        # a tenant's windowed p99 over its latency objective raises
        # SLO_LATENCY; a sustained multi-window burn of its error
        # budget raises SLO_BURN.  A fresh digest carries the live
        # verdicts; the paxos-committed tenant sets fill in for a
        # freshly elected leader.
        if slo_lat:
            out["SLO_LATENCY"] = {
                "severity": "HEALTH_WARN",
                "summary": "%d tenant(s) over latency objective: %s"
                           % (len(slo_lat), slo_lat[:10]),
                "tenants": slo_lat,
                "detail": [
                    "tenant %s p99 %.1fms over target %.1fms"
                    % (t, (slo_detail.get(t) or {}).get("p99_ms", 0),
                       (slo_detail.get(t) or {}).get("target_ms", 0))
                    if t in slo_detail
                    else "tenant %s over latency objective "
                         "(committed edge)" % t
                    for t in slo_lat[:10]]}
        if slo_burn:
            out["SLO_BURN"] = {
                "severity": "HEALTH_WARN",
                "summary": "%d tenant(s) burning SLO error budget:"
                           " %s" % (len(slo_burn), slo_burn[:10]),
                "tenants": slo_burn,
                "detail": [
                    "tenant %s burn rates fast=%s slow=%s"
                    % (t, (slo_detail.get(t) or {}).get("burn_fast"),
                       (slo_detail.get(t) or {}).get("burn_slow"))
                    if t in slo_detail
                    else "tenant %s burning error budget "
                         "(committed edge)" % t
                    for t in slo_burn[:10]]}
        # PERF_ANOMALY (the history plane, mgr/history.py): a series
        # whose EWMA z-score ran hot for the sustain window.  A fresh
        # digest carries the live magnitude; the paxos-committed name
        # list fills in for a freshly elected leader.
        if anom:
            out["PERF_ANOMALY"] = {
                "severity": "HEALTH_WARN",
                "summary": "%d series shifted from baseline: %s"
                           % (len(anom), anom[:10]),
                "series": anom,
                "detail": [
                    "%s at %.4g vs baseline %.4g (z=%.1f)"
                    % (n, (anom_detail.get(n) or {}).get("value", 0),
                       (anom_detail.get(n) or {}).get("mean", 0),
                       (anom_detail.get(n) or {}).get("z", 0))
                    if n in anom_detail
                    else "%s shifted from baseline "
                         "(committed edge)" % n
                    for n in anom[:10]]}
        # OSD_SLOW_PING_TIME (the network plane, osd/network.py):
        # heartbeat RTT past the slow-ping threshold on a peer pair.
        # Fresh beacon soft state (mon.osd_net) carries the live RTT
        # magnitudes; the paxos-committed pair list fills in for a
        # freshly elected leader.
        tnow2 = _t.monotonic()
        ping_detail: dict[str, float] = {}
        ping_pairs: set[str] = set()
        saw_net = False
        for osd, (nrow, stamp) in getattr(
                self.mon, "osd_net", {}).items():
            if tnow2 - stamp >= self.SOFT_TTL:
                continue
            saw_net = True
            rtts = (nrow or {}).get("rtt_ms") or {}
            for peer in (nrow or {}).get("slow") or []:
                try:
                    p = int(peer)
                except (TypeError, ValueError):
                    continue
                pair = "osd.%d-osd.%d" % (min(osd, p), max(osd, p))
                ping_pairs.add(pair)
                ms = rtts.get(str(p))
                if ms is not None:
                    ping_detail[pair] = max(
                        ping_detail.get(pair, 0.0), float(ms))
        if saw_net:
            slow_pairs = sorted(ping_pairs)
        else:
            slow_pairs = list(self.persisted["slowping"])
        if slow_pairs:
            out["OSD_SLOW_PING_TIME"] = {
                "severity": "HEALTH_WARN",
                "summary": "Slow heartbeat pings on %d peer "
                           "pair(s): %s"
                           % (len(slow_pairs), slow_pairs[:10]),
                "pairs": slow_pairs,
                "detail": [
                    "%s heartbeat RTT %.1fms over threshold"
                    % (pr, ping_detail[pr])
                    if pr in ping_detail
                    else "%s slow heartbeat pings "
                         "(committed edge)" % pr
                    for pr in slow_pairs[:10]]}
        # RECENT_CRASH (the crash module's health check): any
        # un-archived crash report newer than mon_crash_warn_age.
        # The crash table is itself paxos-committed, so a freshly
        # elected leader warns with no extra edge state — the same
        # fresh-leader guarantee SLOW_OPS needs `persisted` for.
        crash_mon = getattr(self.mon, "crash_mon", None)
        if crash_mon is not None:
            warn_age = float(self.mon.ctx.conf.get(
                "mon_crash_warn_age", 14 * 24 * 3600.0))
            recent = crash_mon.unarchived(max_age=warn_age)
            if recent:
                out["RECENT_CRASH"] = {
                    "severity": "HEALTH_WARN",
                    "summary": "%d recent crash(es): daemons %s"
                               % (len(recent),
                                  sorted({str(r.get("entity"))
                                          for r in recent})[:10]),
                    "detail": ["%s crashed: %s: %s"
                               % (r.get("entity"), r.get("exc_type"),
                                  r.get("exc_msg"))
                               for r in recent[:10]]}
        if not m.pools and m.epoch > 0:
            pass                       # empty cluster is healthy
        return out

    def command(self, prefix: str, cmd: dict):
        if prefix != "health":
            return None
        checks = self.checks()
        if any(c["severity"] == "HEALTH_ERR"
               for c in checks.values()):
            status = "HEALTH_ERR"
        elif checks:
            status = "HEALTH_WARN"
        else:
            status = "HEALTH_OK"
        return {"status": status, "checks": checks}


class LogMonitor:
    """The capped cluster log, fed from two directions: direct
    mon-side appends (boot, mark-down, auto-out, health edges — via
    the mon's own LogClient) and MLog batches from every daemon's
    clog handle.  Entries are paxos-committed, so `log last` is
    identical on every monitor and survives leader elections;
    ``last_seq`` (per who) makes the apply idempotent against the
    LogClient's resend-until-acked delivery."""

    def __init__(self, mon):
        self.mon = mon
        self.entries: list[dict] = []       # capped ring
        self.last_seq: dict[str, int] = {}  # who -> committed seq
        # who -> boot incarnation of the committed seq: the dedup key
        # is the lexicographic (inc, seq) pair, so a daemon reborn on
        # a wiped store (fresh, larger incarnation; seqs restart at 1)
        # is never swallowed as a resend of its previous life
        self.last_inc: dict[str, int] = {}

    def committed_floor(self, who: str) -> tuple[int, int]:
        """(incarnation, seq) of the last committed entry for `who`."""
        return (self.last_inc.get(who, 0), self.last_seq.get(who, 0))

    def load(self) -> None:
        raw = self.mon.store.get(LOG_KEY)
        if raw is None:
            return
        d = denc.decode(raw)
        if isinstance(d, dict):
            self.entries = [dict(e) for e in (d.get("entries") or [])]
            self.last_seq = {w: int(s)
                             for w, s in (d.get("seq") or {}).items()}
            self.last_inc = {w: int(s)
                             for w, s in (d.get("inc") or {}).items()}
        else:                               # pre-clog bare list
            self.entries = [dict(e) for e in d]

    def apply(self, ops: list, tx) -> None:
        for op in ops:
            if op[0] != "append":
                continue
            e = dict(op[1])
            who = e.get("who") or "?"
            seq = int(e.get("seq") or 0)
            inc = int(e.get("inc") or 0)
            if seq:
                # resend dedup: a LogClient re-flush racing its own
                # ack must not commit the entry twice.  Pair order —
                # a newer incarnation always passes (and resets the
                # seq floor), same incarnation requires a higher seq
                if (inc, seq) <= self.committed_floor(who):
                    continue
                self.last_seq[who] = seq
                self.last_inc[who] = inc
            self.entries.append(e)
        if len(self.entries) > LOG_CAP:
            self.entries = self.entries[-LOG_CAP:]
        tx.set(LOG_KEY, denc.encode({"entries": self.entries,
                                     "seq": self.last_seq,
                                     "inc": self.last_inc}))

    def append(self, level: str, message: str, who: str | None = None,
               channel: str = "cluster") -> None:
        """Mon-side event (boot, mark-down, auto-out, health edges):
        routed through the mon's own clog handle so it gets a seq and
        the resend-until-acked delivery like every other daemon's
        entries; an explicit `who` (the client `log` command) queues
        directly (the command layer owns its own retry semantics)."""
        clog = getattr(self.mon, "clog", None)
        if who is None and clog is not None:
            clog.queue(level, message, channel)
            clog.flush()
            return
        self.mon.queue_svc_op("log", ("append", {
            "stamp": time.time(), "who": who or self.mon.name,
            "channel": channel, "level": level, "message": message}))

    def command(self, prefix: str, cmd: dict):
        if prefix == "log":
            self.append(cmd.get("level", "INF"),
                        str(cmd.get("message", "")),
                        who=cmd.get("who", "client"),
                        channel=cmd.get("channel", "cluster"))
            return {}
        if prefix == "log last":
            n = int(cmd.get("n", 20))
            lines = self.entries
            level = cmd.get("level")
            if level:
                lines = [e for e in lines if e.get("level") == level]
            channel = cmd.get("channel")
            if channel:
                lines = [e for e in lines
                         if e.get("channel", "cluster") == channel]
            return {"lines": lines[-n:]}
        return None


class CrashMonitor:
    """Paxos-committed crash table (the crash mgr module's store +
    `crash ls/info/archive` surface).  Because the table itself rides
    the same commit stream as map changes, a freshly elected leader
    that never heard a single report still serves `crash ls` and
    raises RECENT_CRASH immediately — the SLOW_OPS fresh-leader shape
    without separate edge state."""

    def __init__(self, mon):
        self.mon = mon
        self.reports: dict[str, dict] = {}   # crash_id -> report
        # clock hook: tests pin retention pruning to a virtual now
        self.clock = time.time

    def load(self) -> None:
        raw = self.mon.store.get(CRASH_KEY)
        if raw is not None:
            self.reports = {k: dict(v)
                            for k, v in denc.decode(raw).items()}

    def maybe_prune(self) -> None:
        """Leader-side auto-prune: ARCHIVED reports older than
        `mon_crash_retention` are removed through committed rm ops
        (every mon's table shrinks identically at apply) — the table
        stops growing without bound while un-archived reports stay
        forever (an operator never loses an unacknowledged
        post-mortem).  Runs from the mon tick and whenever fresh
        reports commit; retention <= 0 disables."""
        try:
            keep = float(self.mon.ctx.conf["mon_crash_retention"])
        except (KeyError, TypeError, ValueError):
            return
        if keep <= 0:
            return
        now = self.clock()
        pend = {op[1] for op in self.mon.pending_svc.get("crash", [])
                if op[0] == "rm"}
        for cid, r in sorted(self.reports.items()):
            if not r.get("archived") or cid in pend:
                continue
            if now - float(r.get("timestamp") or 0) > keep:
                self.mon.queue_svc_op("crash", ("rm", cid))
                self.mon.log_mon.append(
                    "INF", "crash %s pruned (archived, older than "
                    "retention)" % cid)

    def apply(self, ops: list, tx) -> None:
        for op in ops:
            if op[0] == "add":
                r = dict(op[1])
                cid = r.get("crash_id")
                if cid and cid not in self.reports:
                    r.setdefault("archived", 0)
                    self.reports[cid] = r
            elif op[0] == "archive":
                r = self.reports.get(op[1])
                if r is not None:
                    r["archived"] = 1
            elif op[0] == "rm":
                self.reports.pop(op[1], None)
        tx.set(CRASH_KEY, denc.encode(self.reports))

    def unarchived(self, max_age: float | None = None) -> list[dict]:
        """Un-archived reports (optionally only those newer than
        max_age seconds) — the RECENT_CRASH input."""
        now = time.time()
        out = [r for r in self.reports.values()
               if not r.get("archived")
               and (max_age is None
                    or now - float(r.get("timestamp") or 0) <= max_age)]
        out.sort(key=lambda r: float(r.get("timestamp") or 0))
        return out

    def _summary(self, r: dict) -> dict:
        return {"crash_id": r.get("crash_id"),
                "entity": r.get("entity"),
                "timestamp": r.get("timestamp"),
                "exc_type": r.get("exc_type"),
                "exc_msg": r.get("exc_msg"),
                "archived": bool(r.get("archived"))}

    def command(self, prefix: str, cmd: dict):
        if prefix == "crash ls":
            rows = sorted(self.reports.values(),
                          key=lambda r: float(r.get("timestamp") or 0))
            return {"crashes": [self._summary(r) for r in rows]}
        if prefix == "crash ls-new":
            return {"crashes": [self._summary(r)
                                for r in self.unarchived()]}
        if prefix == "crash info":
            r = self.reports.get(cmd.get("id"))
            if r is None:
                raise ValueError("no crash %r" % cmd.get("id"))
            return dict(r)
        if prefix == "crash archive":
            if cmd.get("id") not in self.reports:
                raise ValueError("no crash %r" % cmd.get("id"))
            self.mon.queue_svc_op("crash", ("archive", cmd["id"]))
            return {}
        if prefix == "crash archive-all":
            for cid, r in sorted(self.reports.items()):
                if not r.get("archived"):
                    self.mon.queue_svc_op("crash", ("archive", cid))
            return {}
        if prefix == "crash rm":
            self.mon.queue_svc_op("crash", ("rm", cmd.get("id")))
            return {}
        return None


class EventMonitor:
    """Bounded, sequence-numbered cluster event log — the backing
    store of the `rados watch-events` stream (the reference's
    `ceph -w`).  Events (health edges, clog ERR/WRN, osd boot / down /
    out, progress start/finish) commit through paxos as
    ``("emit", row)`` svc ops; the seq is assigned DETERMINISTICALLY
    at apply() time (``last_seq + 1``), so every monitor holds an
    identical contiguous sequence and a cursor survives a leader
    election with no gaps and no duplicate seqs.  Uncommitted pending
    events die with a failed leader — the committed stream stays
    contiguous, which is the cursor contract.  Stamps ride in the op
    payload (set at emit time on the leader), so every mon applies
    identical rows."""

    def __init__(self, mon):
        self.mon = mon
        self.events: list[dict] = []    # capped ring, seq ascending
        self.last_seq = 0

    def load(self) -> None:
        raw = self.mon.store.get(EVENTS_KEY)
        if raw is None:
            return
        d = denc.decode(raw)
        self.events = [dict(e) for e in (d.get("events") or [])]
        self.last_seq = int(d.get("last_seq") or 0)

    def apply(self, ops: list, tx) -> None:
        for op in ops:
            if op[0] != "emit":
                continue
            e = dict(op[1])
            self.last_seq += 1
            e["seq"] = self.last_seq
            self.events.append(e)
        if len(self.events) > EVENT_CAP:
            self.events = self.events[-EVENT_CAP:]
        tx.set(EVENTS_KEY, denc.encode(
            {"events": self.events, "last_seq": self.last_seq}))

    def emit(self, etype: str, message: str,
             data: dict | None = None) -> None:
        """Leader-side: stage one event for the next paxos round.
        Peons never originate events (their trigger sites — beacon
        edges, digest folds — only run on the leader anyway; this
        guard makes stray calls harmless)."""
        if not self.mon.is_leader():
            return
        row = {"type": str(etype), "message": str(message),
               "stamp": time.time()}
        if data:
            row["data"] = dict(data)
        self.mon.queue_svc_op("events", ("emit", row))

    def after(self, cursor: int, limit: int = 500) -> list[dict]:
        """Committed events with seq > cursor (the incremental read
        every MMonEvents batch and `events` command serves).  A
        cursor older than the ring floor simply starts at the floor —
        the ring is bounded; history that aged out is gone."""
        cursor = int(cursor)
        if not self.events or cursor >= self.last_seq:
            return []
        # ring is seq-ascending and contiguous: index directly
        floor = int(self.events[0]["seq"])
        start = max(0, cursor - floor + 1)
        return [dict(e) for e in self.events[start:start + limit]]

    def command(self, prefix: str, cmd: dict):
        if prefix != "events":
            return None
        rows = self.after(int(cmd.get("after", 0)),
                          limit=int(cmd.get("n", 500)))
        return {"events": rows, "last_seq": self.last_seq}
