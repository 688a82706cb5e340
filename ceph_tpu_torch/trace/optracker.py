"""Per-daemon op tracking: in-flight table + historic rings.

Reference analog: OpTracker (src/common/TrackedOp.h) as wired into
every daemon through OpRequest (src/osd/OpRequest.h) — ops register on
arrival, `mark_event` stamps each pipeline stage, completion moves the
op into a bounded historic ring (plus a separate slow-op ring when it
exceeded the complaint threshold), and the admin socket serves
`dump_ops_in_flight` / `dump_historic_ops` / `dump_historic_slow_ops`.

Cross-daemon correlation: every TrackedOp carries a `trace` id (the
reqid_t role) that the messenger envelope propagates into sub-ops, so
`find(trace)` across daemons rebuilds one client op's full timeline.
Stamps are `time.monotonic()` — comparable across the in-process
daemons of a LocalCluster (one clock), which is what the timeline
merge relies on.

Slow-op detection (`osd_op_complaint_time` analog): any in-flight op
older than the complaint threshold counts as slow; daemons report the
count in beacons and the monitor turns a nonzero cluster total into a
SLOW_OPS health warning that clears when the ops complete.
"""

from __future__ import annotations

import itertools
import time


class TrackedOp:
    """One tracked request on one daemon (TrackedOp/OpRequest)."""

    __slots__ = ("tracker", "seq", "trace", "desc", "daemon",
                 "initiated", "wall", "events", "finished", "meta",
                 "tenant")

    def __init__(self, tracker: "OpTracker", seq: int, desc: str,
                 trace: str | None, tenant: str | None = None):
        self.tracker = tracker
        self.seq = seq
        self.trace = trace
        self.tenant = tenant
        self.desc = desc
        self.daemon = tracker.daemon
        self.initiated = tracker.now()
        self.wall = time.time()
        self.events: list[tuple[float, str]] = [(self.initiated,
                                                 "initiated")]
        self.finished = False
        self.meta: dict | None = None

    def mark_event(self, event: str) -> None:
        if not self.finished:
            self.events.append((self.tracker.now(), event))

    def note(self, key: str, value) -> None:
        """Attach structured attribution to the op (e.g. the device
        DispatchTicket of the flush that carried its shards): rides
        the dump so timelines show exactly which dispatch served the
        op, not a sampled approximation."""
        if self.meta is None:
            self.meta = {}
        self.meta.setdefault(key, []).append(value)

    def finish(self, event: str = "done") -> None:
        """Completion: stamps the final event and retires the op into
        the tracker's historic ring (idempotent)."""
        if self.finished:
            return
        self.events.append((self.tracker.now(), event))
        self.finished = True
        self.tracker._retire(self)

    @property
    def age(self) -> float:
        """Seconds since arrival (in-flight) or total duration."""
        end = (self.events[-1][0] if self.finished
               else self.tracker.now())
        return end - self.initiated

    def dump(self) -> dict:
        out = {
            "trace": self.trace,
            "tenant": self.tenant,
            "desc": self.desc,
            "daemon": self.daemon,
            "initiated": self.initiated,
            "initiated_at": self.wall,
            "age": self.age,
            "in_flight": not self.finished,
            "events": [{"t": t, "rel": t - self.initiated,
                        "event": e} for t, e in self.events],
        }
        if self.meta:
            out["meta"] = self.meta
            tickets = self.meta.get("device_ticket")
            if tickets:
                # device-dispatched ops surface their attribution
                # first-class (not buried in meta): which chip served
                # the flush, and was the latency queue-wait or device
                # time — the dump_historic_ops answer to "where did
                # this op's milliseconds go"
                t = tickets[-1]
                out["device"] = {
                    "chip": t.get("chip"),
                    "klass": t.get("klass"),
                    "bucket": t.get("bucket"),
                    # continuous-dispatch slot vs legacy flush
                    "stream": t.get("stream"),
                    "queue_wait": t.get("queue_wait"),
                    "device_s": t.get("device_s"),
                    "dispatches": len(tickets),
                }
        return out


class OpTracker:
    """In-flight table + historic/slow rings for one daemon."""

    def __init__(self, ctx, daemon: str):
        self.ctx = ctx
        self.daemon = daemon
        self._seq = itertools.count(1)
        self.ops: dict[int, TrackedOp] = {}
        self.historic: list[TrackedOp] = []
        self.historic_slow: list[TrackedOp] = []
        # stamps read this daemon's clock: skewable (test hook) so the
        # timeline merge can prove its offset normalization against an
        # artificially skewed daemon
        self.clock_skew = 0.0
        # the context exposes the tracker so the admin socket's builtin
        # dump commands find it without plumbing (CephContext keeps the
        # same backref for its admin hooks)
        ctx.optracker = self
        # the daemon's flight-recorder ring rides the tracker: retired
        # ops feed it (sampled; slow ops always), and it shares this
        # tracker's skewable clock so recorder spans normalize with
        # the same offsets as op stamps
        from .recorder import FlightRecorder
        self.recorder = FlightRecorder(ctx, daemon, clock=self.now)
        # retire hook: the owning daemon hangs its per-tenant SLO
        # accounting here (stage histograms, good/bad op counts) —
        # fired for every retired op, after the recorder's feed
        self.on_retire = None

    def now(self) -> float:
        return time.monotonic() + self.clock_skew

    # -- configuration (live: re-read per call so `config set` acts) ---

    @property
    def complaint_time(self) -> float:
        return float(self.ctx.conf.get("osd_op_complaint_time", 30.0))

    # -- lifecycle -----------------------------------------------------

    def create(self, desc: str, trace: str | None = None,
               tenant: str | None = None) -> TrackedOp:
        op = TrackedOp(self, next(self._seq), desc, trace,
                       tenant=tenant)
        self.ops[op.seq] = op
        return op

    def _retire(self, op: TrackedOp) -> None:
        self.ops.pop(op.seq, None)
        self.historic.append(op)
        cap = int(self.ctx.conf.get("osd_op_history_size", 20))
        if len(self.historic) > cap:
            del self.historic[:len(self.historic) - cap]
        slow = op.age >= self.complaint_time
        if slow:
            self.historic_slow.append(op)
            scap = int(self.ctx.conf.get(
                "osd_op_history_slow_op_size", 20))
            if len(self.historic_slow) > scap:
                del self.historic_slow[:len(self.historic_slow) - scap]
        self.recorder.note_op(op, slow=slow)
        if self.on_retire is not None:
            try:
                self.on_retire(op)
            except Exception:
                pass    # observability must never sink the op path

    # -- slow-op detection ---------------------------------------------

    def slow_in_flight(self) -> list[TrackedOp]:
        """In-flight ops older than the complaint threshold — the
        count daemons report in beacons (SLOW_OPS feeds on it)."""
        limit = self.complaint_time
        now = time.monotonic()
        return [op for op in self.ops.values()
                if now - op.initiated >= limit]

    # -- queries -------------------------------------------------------

    def find(self, trace: str) -> list[dict]:
        """Every record (in-flight or historic) carrying `trace` —
        one daemon's slice of a cross-daemon timeline."""
        out = []
        seen = set()
        for op in list(self.ops.values()) + self.historic \
                + self.historic_slow:
            if op.trace == trace and id(op) not in seen:
                seen.add(id(op))
                out.append(op.dump())
        return out

    @staticmethod
    def _tenant_match(op: TrackedOp, tenant: str | None) -> bool:
        return tenant is None or op.tenant == tenant

    def dump_ops_in_flight(self, tenant: str | None = None) -> dict:
        """`tenant` narrows the dump to one tenant's ops (the
        noisy-neighbor triage surface: whose in-flight ops are these)."""
        ops = sorted((o for o in self.ops.values()
                      if self._tenant_match(o, tenant)),
                     key=lambda o: o.initiated)
        return {"num_ops": len(ops),
                "complaint_time": self.complaint_time,
                "tenant": tenant,
                "ops": [op.dump() for op in ops]}

    def dump_historic_ops(self, tenant: str | None = None) -> dict:
        ops = [op for op in self.historic
               if self._tenant_match(op, tenant)]
        return {"num_ops": len(ops), "tenant": tenant,
                "ops": [op.dump() for op in ops]}

    def dump_historic_slow_ops(self,
                               tenant: str | None = None) -> dict:
        ops = [op for op in self.historic_slow
               if self._tenant_match(op, tenant)]
        return {"num_ops": len(ops),
                "complaint_time": self.complaint_time,
                "tenant": tenant,
                "ops": [op.dump() for op in ops]}

    def slow_tenants(self) -> dict[str, int]:
        """tenant -> slow in-flight op count (ops with no tenant fold
        under "") — the per-tenant slice OSD beacons carry so the
        SLOW_OPS health detail can name the worst tenant."""
        out: dict[str, int] = {}
        for op in self.slow_in_flight():
            key = op.tenant or ""
            out[key] = out.get(key, 0) + 1
        return out

    # -- admin socket ---------------------------------------------------

    def register_admin(self, admin) -> None:
        admin.register(
            "dump_ops_in_flight",
            lambda a: self.dump_ops_in_flight(a.get("tenant")),
            "show in-flight tracked ops (optional tenant filter)")
        admin.register(
            "dump_historic_ops",
            lambda a: self.dump_historic_ops(a.get("tenant")),
            "show recently completed ops (optional tenant filter)")
        admin.register(
            "dump_historic_slow_ops",
            lambda a: self.dump_historic_slow_ops(a.get("tenant")),
            "show recently completed slow ops (optional tenant"
            " filter)")
        self.recorder.register_admin(admin)
