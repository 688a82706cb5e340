"""Flight recorder: bounded span rings and the device ticket ring.

Own copy of ceph_tpu/trace/recorder.py (it imports only os, time and
zlib):

* **per-daemon span ring** (`FlightRecorder`) — a daemon's op tracker
  feeds retired ops into a bounded ring (all slow ops, plus every Nth
  trace by a trace-id hash, so one client write is kept or dropped on
  every daemon alike); background work records its own spans beside
  the ops it competes with.
* **process device ring** — every finished `DispatchTicket` lands in a
  process-wide ring (`note_ticket`, called by `ChipRuntime.finish`), so
  queue wait against device time per chip is replayable afterwards.
  On a card a ticket's `device_s` is CUDA-event time.
* **process host-span ring** — `HostSpan` records what the host does
  inside a dispatch (the placement pass's upload, seeding, launches and
  copies), on `time.time_ns()`, the clock `torch.profiler` stamps device
  events on.  Process-wide like the device ring: the bulk mapper runs
  outside any daemon (the scale plane's map cache, the balancer).
* **Chrome-trace / Perfetto exporter** (`chrome_trace`) — merges the
  rings into one JSON document: daemons render as processes, chips as
  device-lane threads, and flow arrows link one trace id's spans
  across daemons.  `validate_chrome_trace` lints the document.

The enable switch is the reference's: env CEPH_TPU_FLIGHT_RECORDER=0
turns the recorder off at import, `set_enabled` at run time.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib

# process-wide enable switch; env CEPH_TPU_FLIGHT_RECORDER=0 disables
# at import for A/B runs
_ENABLED = os.environ.get("CEPH_TPU_FLIGHT_RECORDER", "1") \
    not in ("0", "false", "no")

_DEVICE_RING_CAP = 4096
_DEVICE_RING: list[dict] = []

_SPAN_RING_CAP = 8192
# closed spans as flat tuples of atomic values, which the garbage
# collector stops tracking at its first pass over them (so a full ring
# adds nothing to the process's full collections); dicts on read
_SPAN_RING: list[tuple] = []
_next_span_id = itertools.count(1).__next__
_OPEN = threading.local()       # .span: this thread's innermost open span
_time_ns = time.time_ns
# one stamp of both clocks, so host spans (wall ns) and the device
# ring's ticket stamps (monotonic s) share one timeline
_WALL_NS0 = time.time_ns()
_MONO0 = time.monotonic()


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def trace_sampled(trace: str | None, every: int) -> bool:
    """Deterministic 1-in-N sampling keyed on the trace id, so every
    daemon that sees the same client write makes the same keep/drop
    decision and sampled traces stay complete span trees."""
    if every <= 1:
        return True
    if not trace:
        return False
    return zlib.crc32(trace.encode()) % every == 0


class FlightRecorder:
    """One daemon's bounded span ring.  Constructed by the daemon's
    OpTracker (which owns the skewable clock the stamps read) and
    published on the context as ``ctx.flight_recorder`` so the admin
    socket's builtin `dump_flight_recorder` finds it."""

    def __init__(self, ctx, daemon: str, clock=None):
        self.ctx = ctx
        self.daemon = daemon
        self._clock = clock or time.monotonic
        self.records: list[dict] = []
        self.dropped = 0            # sampled-out op records
        ctx.flight_recorder = self

    def now(self) -> float:
        return self._clock()

    # -- configuration (live, like the tracker's) ----------------------

    @property
    def ring_cap(self) -> int:
        return int(self.ctx.conf.get("flight_recorder_ring", 2048))

    @property
    def sample_every(self) -> int:
        return int(self.ctx.conf.get("flight_recorder_sample", 4))

    # -- feeds ----------------------------------------------------------

    def _append(self, rec: dict) -> None:
        self.records.append(rec)
        cap = self.ring_cap
        if len(self.records) > cap:
            del self.records[:len(self.records) - cap]

    def note_op(self, op, slow: bool = False) -> None:
        """One retired TrackedOp -> one span record.  Retention:
        every slow op (the ops worth a post-mortem), plus every Nth
        trace (`flight_recorder_sample`); traceless ops ride the
        trace hash of their daemon+desc so they sample too."""
        if not _ENABLED:
            return
        if not slow and not trace_sampled(
                op.trace or "%s#%d" % (op.daemon, op.seq),
                self.sample_every):
            self.dropped += 1
            return
        rec = {
            "kind": "op",
            "daemon": op.daemon,
            "trace": op.trace,
            "tenant": op.tenant,
            "desc": op.desc,
            "slow": bool(slow),
            "t0": op.initiated,
            "t1": op.events[-1][0],
            "events": [[t, e] for t, e in op.events],
        }
        if op.meta and op.meta.get("device_ticket"):
            rec["tickets"] = [dict(t)
                              for t in op.meta["device_ticket"]]
        self._append(rec)

    def span(self, name: str, t0: float, t1: float | None = None,
             meta: dict | None = None) -> None:
        """One background-work span (scrub, recovery, compression
        pacing): the work the utilization integrals show competing
        with the data path, placed on the same timeline."""
        if not _ENABLED:
            return
        rec = {"kind": "background", "daemon": self.daemon,
               "name": name, "t0": t0,
               "t1": self.now() if t1 is None else t1}
        if meta:
            rec["meta"] = dict(meta)
        self._append(rec)

    # -- views -----------------------------------------------------------

    def dump(self) -> dict:
        return {"daemon": self.daemon,
                "num_records": len(self.records),
                "sample_every": self.sample_every,
                "dropped": self.dropped,
                "records": [dict(r) for r in self.records],
                "host_spans": host_spans()}

    def clear(self) -> None:
        self.records.clear()
        self.dropped = 0

    def register_admin(self, admin) -> None:
        admin.register("dump_flight_recorder",
                       lambda a: self.dump(),
                       "dump the flight-recorder span ring")


# -- device ticket ring (process-wide: the mesh is shared) ---------------


def note_ticket(ticket) -> None:
    """Called by ChipRuntime.finish for every completed dispatch:
    the device-lane feed.  Duck-typed on the ticket so the trace
    package never imports the device package."""
    if not _ENABLED:
        return
    _DEVICE_RING.append({
        "seq": ticket.seq, "klass": ticket.klass,
        "bucket": ticket.bucket, "bytes": ticket.nbytes,
        "tenant": getattr(ticket, "tenant", None),
        # continuous-dispatch slot vs legacy/degradation flush: the
        # before/after is visible on the same Perfetto device lanes
        "stream": bool(getattr(ticket, "stream", False)),
        "chip": ticket.chip, "t_enqueue": ticket.t_enqueue,
        "t_admit": ticket.t_admit, "t_launch": ticket.t_launch,
        "t_done": ticket.t_done, "ok": ticket.ok,
        "queue_wait": ticket.queue_wait,
        "device_s": ticket.device_s})
    if len(_DEVICE_RING) > _DEVICE_RING_CAP:
        del _DEVICE_RING[:_DEVICE_RING_CAP // 2]


def device_records() -> list[dict]:
    return [dict(r) for r in _DEVICE_RING]


def clear_device_ring() -> None:
    _DEVICE_RING.clear()


# -- host-span ring (process-wide, beside the device ring) ---------------


class HostSpan:
    """`with HostSpan(name, counts):` records one host span into the
    process ring on exit: name, `t0_ns`/`t1_ns` (`time.time_ns()`),
    `id`, `parent` (the id of the span open around it on this thread;
    `id` stays None while the recorder is off),
    `ticket` (a dispatch ticket's seq, set by the caller on the span
    that holds the ticket; its children reach it through `parent`) and
    `counts` (the work done at that boundary, set at entry or before
    exit).  With the recorder off it records nothing."""

    __slots__ = ("name", "counts", "ticket", "id", "t0_ns", "_up")

    def __init__(self, name: str, counts: dict | None = None):
        self.name = name
        self.counts = counts
        self.ticket = None
        self.id = None

    def __enter__(self) -> "HostSpan":
        if _ENABLED:
            self._up = getattr(_OPEN, "span", None)
            _OPEN.span = self
            self.id = _next_span_id()
            self.t0_ns = _time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.id is None:
            return False
        t1 = _time_ns()
        up = _OPEN.span = self._up
        rec = (self.name, self.id, None if up is None else up.id,
               self.ticket, self.t0_ns, t1)
        c = self.counts
        _SPAN_RING.append(rec + (*c, *c.values()) if c else rec)
        if len(_SPAN_RING) > _SPAN_RING_CAP:
            del _SPAN_RING[:_SPAN_RING_CAP // 2]
        return False


def _span_record(t: tuple) -> dict:
    """A ring tuple (name, id, parent, ticket, t0_ns, t1_ns, then the
    counts' keys and their values) as a record."""
    counts = None
    if len(t) > 6:
        half = 6 + (len(t) - 6) // 2
        counts = dict(zip(t[6:half], t[half:]))
    return {"name": t[0], "id": t[1], "parent": t[2], "ticket": t[3],
            "t0_ns": t[4], "t1_ns": t[5], "counts": counts}


def host_spans() -> list[dict]:
    """The host-span ring's records, in the order the spans closed."""
    return [_span_record(t) for t in _SPAN_RING]


def drain_host_spans() -> list[dict]:
    """The host-span ring's records, removed from it."""
    n = len(_SPAN_RING)
    out = [_span_record(t) for t in _SPAN_RING[:n]]
    del _SPAN_RING[:n]
    return out


def _span_monotonic(t_ns: int) -> float:
    """A host span's stamp on the device ring's monotonic clock."""
    return _MONO0 + (t_ns - _WALL_NS0) / 1e9


# -- Chrome-trace / Perfetto export --------------------------------------


def _lane_for(lanes: list[float], t0: float) -> int:
    """Greedy interval coloring: the first lane whose previous span
    ended by t0 (concurrent ops on one daemon must not overlap on one
    Chrome-trace track — the viewer nests by containment)."""
    for i, end in enumerate(lanes):
        if t0 >= end:
            return i
    lanes.append(0.0)
    return len(lanes) - 1


def chrome_trace(rings: dict[str, list[dict]],
                 offsets: dict[str, float] | None = None,
                 device: list[dict] | None = None,
                 net: dict[str, list[dict]] | None = None,
                 meta: dict | None = None,
                 spans: list[dict] | None = None) -> dict:
    """Merge per-daemon flight-recorder rings (+ the device ticket
    ring) into one Chrome-trace JSON document.

    * each daemon is a **process** (pid); its op/background spans pack
      onto non-overlapping lane threads;
    * each op record renders as a complete (`ph:"X"`) slice with its
      stage transitions as nested sub-slices (stage `e_i` spans
      `[t_i, t_{i+1})`);
    * one trace id's records across >= 2 daemons are linked with flow
      events (`ph:"s"/"t"/"f"`) — the client write's arrow through
      the cluster;
    * the device ring is its own process with one base thread per
      chip (overlapping in-flight dispatches fan onto chip lanes);
    * `net` (daemon -> cumulative per-peer {"t","peer","tx","rx"}
      wire samples, osd/network.py's ring) renders as per-peer
      throughput counter tracks (`ph:"C"`) under each daemon's
      process — rates are clamped non-negative deltas, so a
      reconnect's counter reset shows as a zero, not a plunge;
    * `offsets` (entity -> seconds, the clock-offset solver's output)
      normalize every daemon's stamps onto one reference clock;
    * `spans` (host-span records, `host_spans()`) render as nested
      slices on the device lane of their ticket (their own, or their
      nearest ancestor's), else on a `host-spans` process, moved onto
      the device ring's clock.

    Timestamps are microseconds from the earliest record (`ts`
    monotonic per track by construction — the schema property the
    tests pin)."""
    offsets = offsets or {}
    device = device or []
    net = net or {}
    events: list[dict] = []
    flows: list[dict] = []

    def t_of(daemon, t):
        return t - offsets.get(daemon, 0.0)

    # common epoch: earliest normalized stamp across every ring
    stamps = [t_of(d, r["t0"]) for d, recs in rings.items()
              for r in recs]
    stamps += [t["t_enqueue"] for t in device]
    stamps += [t_of(d, float(row.get("t") or 0.0))
               for d, rows in net.items() for row in rows]
    spans = spans or []
    stamps += [_span_monotonic(s["t0_ns"]) for s in spans]
    t_base = min(stamps) if stamps else 0.0

    def us(t):
        return round((t - t_base) * 1e6, 3)

    pid_of = {d: i + 1 for i, d in enumerate(sorted(rings))}
    by_trace: dict[str, list[tuple[str, dict]]] = {}
    for daemon in sorted(rings):
        pid = pid_of[daemon]
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": daemon}})
        lanes: list[float] = []
        for rec in sorted(rings[daemon], key=lambda r: r["t0"]):
            t0 = t_of(daemon, rec["t0"])
            t1 = max(t0, t_of(daemon, rec["t1"]))
            tid = _lane_for(lanes, t0)
            lanes[tid] = t1
            if rec["kind"] == "op":
                args = {"trace": rec.get("trace"),
                        "tenant": rec.get("tenant"),
                        "slow": rec.get("slow", False)}
                for t in rec.get("tickets") or []:
                    args["device_ticket_seq"] = t.get("seq")
                    args["device_chip"] = t.get("chip")
                events.append({
                    "ph": "X", "name": rec["desc"], "cat": "op",
                    "pid": pid, "tid": tid, "ts": us(t0),
                    "dur": max(0.0, round((t1 - t0) * 1e6, 3)),
                    "args": args})
                evs = rec.get("events") or []
                for (ta, name), (tb, _nb) in zip(evs, evs[1:]):
                    sa = t_of(daemon, ta)
                    sb = max(sa, t_of(daemon, tb))
                    events.append({
                        "ph": "X", "name": name, "cat": "stage",
                        "pid": pid, "tid": tid, "ts": us(sa),
                        "dur": max(0.0, round((sb - sa) * 1e6, 3)),
                        "args": {"trace": rec.get("trace")}})
                if rec.get("trace"):
                    by_trace.setdefault(rec["trace"], []).append(
                        (daemon, {"pid": pid, "tid": tid,
                                  "ts": us(t0)}))
            else:
                events.append({
                    "ph": "X", "name": rec.get("name", "background"),
                    "cat": "background", "pid": pid, "tid": tid,
                    "ts": us(t0),
                    "dur": max(0.0, round((t1 - t0) * 1e6, 3)),
                    "args": dict(rec.get("meta") or {})})
        for tid in range(len(lanes)):
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tid,
                           "args": {"name": "lane-%d" % tid}})

    # flow arrows: one per trace id spanning >= 2 records, start ->
    # step -> end in timeline order (the cross-daemon link)
    for trace, nodes in sorted(by_trace.items()):
        if len(nodes) < 2:
            continue
        nodes.sort(key=lambda n: n[1]["ts"])
        fid = "0x%08x" % (zlib.crc32(trace.encode()) & 0xFFFFFFFF)
        for i, (_daemon, where) in enumerate(nodes):
            ph = "s" if i == 0 else ("f" if i == len(nodes) - 1
                                     else "t")
            ev = {"ph": ph, "name": "trace", "cat": "flow",
                  "id": fid, **where}
            if ph == "f":
                ev["bp"] = "e"
            flows.append(ev)

    # device lanes: one process, base thread per chip, overlapping
    # in-flight dispatches fan onto per-chip sub-lanes
    lane_of_seq: dict = {}
    dpid = len(pid_of) + 1
    if device:
        events.append({"ph": "M", "name": "process_name", "pid": dpid,
                       "tid": 0, "args": {"name": "device-mesh"}})
        chip_lanes: dict[int, list[float]] = {}
        named: set[int] = set()
        for t in sorted(device, key=lambda r: r["t_launch"]):
            if not t.get("t_launch") or not t.get("t_done"):
                continue
            chip = int(t.get("chip") or 0)
            lanes = chip_lanes.setdefault(chip, [])
            lane = _lane_for(lanes, t["t_launch"])
            lanes[lane] = t["t_done"]
            tid = chip * 16 + lane
            lane_of_seq[t.get("seq")] = tid
            if tid not in named:
                named.add(tid)
                events.append({
                    "ph": "M", "name": "thread_name", "pid": dpid,
                    "tid": tid,
                    "args": {"name": "chip-%d lane-%d"
                             % (chip, lane)}})
            events.append({
                "ph": "X", "name": t.get("klass", "dispatch"),
                "cat": "device", "pid": dpid, "tid": tid,
                "ts": us(t["t_launch"]),
                "dur": max(0.0, round(t["device_s"] * 1e6, 3)),
                "args": {"seq": t.get("seq"), "chip": chip,
                         "bucket": t.get("bucket"),
                         "bytes": t.get("bytes"),
                         "tenant": t.get("tenant"),
                         "stream": t.get("stream"),
                         "queue_wait": t.get("queue_wait"),
                         "ok": t.get("ok")}})
        # counter tracks (ph:"C"): per-chip in-flight dispatches
        # (busy: +1 at launch, -1 at done) and queue depth (+1 at
        # enqueue, -1 at launch), edge-walked from the same tickets
        # — Perfetto renders them as the counter view of the
        # utilization integrals, beside the slices they explain
        for chip in sorted({int(t.get("chip") or 0) for t in device}):
            edges: list[tuple[float, str, int]] = []
            for t in device:
                if int(t.get("chip") or 0) != chip:
                    continue
                if t.get("t_enqueue") and t.get("t_launch"):
                    edges.append((t["t_enqueue"], "queue_depth", 1))
                    edges.append((t["t_launch"], "queue_depth", -1))
                if t.get("t_launch") and t.get("t_done"):
                    edges.append((t["t_launch"], "busy", 1))
                    edges.append((t["t_done"], "busy", -1))
            counts = {"busy": 0, "queue_depth": 0}
            for stamp, key, delta in sorted(edges):
                counts[key] += delta
                events.append({
                    "ph": "C", "name": "chip-%d %s" % (chip, key),
                    "cat": "device", "pid": dpid, "ts": us(stamp),
                    "args": {key: counts[key]}})

    # per-peer wire-throughput counter tracks (ph:"C"): rates walked
    # from the OSDs' cumulative tx/rx wire samples (osd/network.py's
    # heartbeat-paced ring), one counter per (daemon, peer) beside
    # the daemon's own op lanes — deltas clamped non-negative so a
    # reconnect's counter reset reads as a zero, not a plunge
    if net:
        next_pid = len(pid_of) + (2 if device else 1)
        for daemon in sorted(net):
            pid = pid_of.get(daemon)
            if pid is None:
                pid = next_pid
                next_pid += 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": daemon}})
            prev: dict = {}
            for row in net[daemon]:
                t = t_of(daemon, float(row.get("t") or 0.0))
                peer = str(row.get("peer"))
                tx = int(row.get("tx") or 0)
                rx = int(row.get("rx") or 0)
                p = prev.get(peer)
                prev[peer] = (t, tx, rx)
                if p is None or t <= p[0]:
                    continue
                dt = t - p[0]
                events.append({
                    "ph": "C", "name": "net %s" % peer,
                    "cat": "net", "pid": pid, "ts": us(t),
                    "args": {
                        "tx_Bps": round(max(0, tx - p[1]) / dt, 1),
                        "rx_Bps": round(max(0, rx - p[2]) / dt, 1),
                    }})

    if spans:
        _span_slices(spans, events, lane_of_seq, dpid, us)

    # stable order: metadata first, then slices sorted by ts (a
    # stable sort keeps a stage slice after its enclosing op slice at
    # equal ts, which is what makes per-track ts monotonic AND the
    # viewer's containment nesting deterministic), flows last
    mevents = [e for e in events if e["ph"] == "M"]
    xevents = sorted((e for e in events if e["ph"] != "M"),
                     key=lambda e: e["ts"])
    return {"traceEvents": mevents + xevents + flows,
            "displayTimeUnit": "ms",
            "otherData": dict(meta or {})}


def _span_slices(spans, events, lane_of_seq, dpid, us) -> None:
    """Host spans as `X` slices: on the device lane of the ticket
    they (or their nearest ancestor) carry, when the device ring holds
    it, else on one `host-spans` process, a tree to a lane.  Parents
    go before their children, so equal stamps nest."""
    by_id = {s["id"]: s for s in spans}

    def root_of(s):     # a parent's id is below its children's
        while s["ticket"] is None and s["parent"] in by_id:
            s = by_id[s["parent"]]
        return s

    hpid = max([e["pid"] for e in events] + [0]) + 1
    lanes: list[float] = []
    lane_of_root: dict = {}
    for s in sorted(spans, key=lambda r: (r["t0_ns"], -r["t1_ns"])):
        t0 = _span_monotonic(s["t0_ns"])
        t1 = max(t0, _span_monotonic(s["t1_ns"]))
        root = root_of(s)
        tid = lane_of_seq.get(root["ticket"])
        pid = dpid
        if tid is None:
            pid = hpid
            tid = lane_of_root.get(root["id"])
            if tid is None:     # the root itself: it sorts first
                tid = lane_of_root[root["id"]] = _lane_for(lanes, t0)
                lanes[tid] = t1
        args = dict(s["counts"] or {})
        if s["ticket"] is not None:
            args["ticket"] = s["ticket"]
        events.append({"ph": "X", "name": s["name"], "cat": "host",
                       "pid": pid, "tid": tid, "ts": us(t0),
                       "dur": max(0.0, round((t1 - t0) * 1e6, 3)),
                       "args": args})
    if lane_of_root:
        events.append({"ph": "M", "name": "process_name", "pid": hpid,
                       "tid": 0, "args": {"name": "host-spans"}})
        for tid in range(len(lanes)):
            events.append({"ph": "M", "name": "thread_name",
                           "pid": hpid, "tid": tid,
                           "args": {"name": "lane-%d" % tid}})


_REQUIRED_KEYS = {
    "X": ("name", "ph", "ts", "dur", "pid", "tid"),
    "M": ("name", "ph", "pid", "args"),
    "s": ("id", "ph", "ts", "pid", "tid"),
    "t": ("id", "ph", "ts", "pid", "tid"),
    "f": ("id", "ph", "ts", "pid", "tid"),
    "C": ("name", "ph", "ts", "pid", "args"),
}


def validate_chrome_trace(doc) -> list[str]:
    """Chrome-trace schema lint (the test oracle, shaped like
    utils.exporter.validate_exposition): the document must carry a
    `traceEvents` list, every event its phase's required keys with
    numeric stamps and non-negative durations, complete (`X`) events
    in non-decreasing `ts` order per (pid, tid) track, and counter
    (`C`) events carrying numeric, never-negative sample values in
    non-decreasing `ts` order per (pid, name) counter track.
    Returns human-readable violations; empty means clean."""
    errors: list[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["document has no traceEvents list"]
    last_ts: dict[tuple, float] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errors.append("event %d: not an object" % i)
            continue
        ph = ev.get("ph")
        req = _REQUIRED_KEYS.get(ph)
        if req is None:
            errors.append("event %d: unknown phase %r" % (i, ph))
            continue
        missing = [k for k in req if k not in ev]
        if missing:
            errors.append("event %d (%s): missing keys %r"
                          % (i, ph, missing))
            continue
        if ph == "M":
            continue
        try:
            ts = float(ev["ts"])
        except (TypeError, ValueError):
            errors.append("event %d: non-numeric ts %r"
                          % (i, ev.get("ts")))
            continue
        if ph == "X":
            try:
                if float(ev["dur"]) < 0:
                    errors.append("event %d: negative dur" % i)
            except (TypeError, ValueError):
                errors.append("event %d: non-numeric dur %r"
                              % (i, ev.get("dur")))
            track = (ev["pid"], ev["tid"])
            if ts < last_ts.get(track, float("-inf")):
                errors.append(
                    "event %d: ts %.3f regresses on track %r"
                    % (i, ts, track))
            last_ts[track] = ts
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errors.append("event %d: counter without samples" % i)
                continue
            for k, v in args.items():
                if not isinstance(v, (int, float)):
                    errors.append(
                        "event %d: counter %r sample %r non-numeric"
                        % (i, k, v))
                elif v < 0:
                    errors.append(
                        "event %d: counter %r went negative (%g) — "
                        "unbalanced edge walk" % (i, k, v))
            ctrack = ("C", ev["pid"], ev["name"])
            if ts < last_ts.get(ctrack, float("-inf")):
                errors.append(
                    "event %d: counter ts %.3f regresses on %r"
                    % (i, ts, ctrack))
            last_ts[ctrack] = ts
    return errors
