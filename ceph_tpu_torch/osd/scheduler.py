"""mClock-style op scheduler with sharded queues.

Analog of the reference's ShardedOpWQ + OpScheduler stack
(src/osd/OSD.cc:2351,3528-3533; src/osd/scheduler/mClockScheduler.h:75
over the vendored dmclock library, src/dmclock/): every message-driven
unit of OSD work is tagged with a service class and drained from
per-shard queues by a dmClock arbiter, so background work (recovery,
scrub, snap trim) cannot starve client I/O and client bursts cannot
starve recovery below its reservation.

dmClock per class keeps three virtual tags (dmclock's RWL model):

  reservation tag  r += 1/(res_fraction * capacity)   — guaranteed rate
  proportional tag p += 1/weight                      — excess sharing
  limit tag        l += 1/(lim_fraction * capacity)   — hard ceiling

Schedule: any class whose reservation tag is in the past runs first
(by earliest r); otherwise the earliest proportional tag among classes
whose limit tag is in the past; otherwise sleep until the nearest tag
matures.  Tags are clamped to `now` when a class goes idle->busy so
an idle class cannot bank credit (the standard dmClock idle rule).

Shards: `osd_op_num_shards` independent queues, PG-affine (shard =
hash(pgid) % n), each drained by one asyncio worker — per-PG op order
is preserved per class, matching the reference's shard mapping.

Two entry points:
  enqueue(key, klass, fn)  — queue a work item (fn may be sync or
                             return an awaitable); used for message
                             dispatch (client ops, rep ops, EC subops).
  admit(klass, cost)       — awaitable admission ticket used by
                             long-running background flows (recovery
                             push loops, scrub chunks, snap trim) to
                             pace themselves through the same arbiter.
"""

from __future__ import annotations

import asyncio
import time

K_CLIENT = "client"
K_RECOVERY = "recovery"
K_SCRUB = "scrub"
K_SNAPTRIM = "snaptrim"

# (reservation fraction, weight, limit fraction) of osd capacity —
# mirrors the balanced mclock profile (mClockScheduler.cc profiles:
# client gets half the capacity reserved, background recovery a
# quarter, best-effort classes ride the excess)
DEFAULT_PROFILE = {
    K_CLIENT: (0.50, 4.0, 1.00),
    K_RECOVERY: (0.25, 2.0, 0.75),
    K_SCRUB: (0.05, 1.0, 0.50),
    K_SNAPTRIM: (0.05, 1.0, 0.50),
}

# Device dispatch-queue shares (ceph_tpu.device.runtime): the same
# client/recovery proportions as the mClock profile above, plus the
# bulk-mapping class — client EC flushes outrank recovery encodes,
# which outrank whole-pool remap passes, so a mapping storm cannot
# starve client writes of the accelerator.  The background class
# (scrub digest lanes, pool-compression pacing) sits below everything
# else: always-on integrity work rides the excess, never the
# reservation.
DEVICE_DISPATCH_WEIGHTS = {
    "client-ec": DEFAULT_PROFILE[K_CLIENT][1],      # 4.0
    "recovery-ec": DEFAULT_PROFILE[K_RECOVERY][1],  # 2.0
    "mapping": 1.0,
    "background": 0.5,
}

# per-tenant dmClock row defaults (fractions of osd capacity like the
# class profile): a tenant-stamped client op runs under its tenant's
# OWN (reservation, weight, limit) tag book nested in the client
# class, so a bully tenant is throttled at its limit tag while a
# victim's reservation keeps flowing — the dmclock d-parameter model
# extended to (class, tenant) keys.  Overridden per tenant via the
# `osd_mclock_tenant_qos` conf rows ("name:res:weight:limit,...").
TENANT_DEFAULT_PROFILE = (0.05, 1.0, 1.00)


def device_admission_weight(klass: str, tenant: str | None,
                            tenant_qos: dict[str, tuple] | None,
                            ) -> float:
    """Proportional admission weight of one op at the DEVICE layer
    (the dispatch stream's WFQ tags, device/stream.py): the class
    share from DEVICE_DISPATCH_WEIGHTS times, for tenant-stamped
    client-EC work, the tenant's dmClock weight column (its
    `osd_mclock_tenant_qos` row, default TENANT_DEFAULT_PROFILE).
    Reservation and limit stay host-side in the op scheduler — the
    device honors the proportional ordering, which is the column that
    decides who a contended accelerator serves next."""
    base = DEVICE_DISPATCH_WEIGHTS.get(klass, 1.0)
    if tenant is None or klass != "client-ec":
        return base
    row = (tenant_qos or {}).get(tenant)
    wgt = row[1] if row is not None else TENANT_DEFAULT_PROFILE[1]
    return base * max(float(wgt), 1e-9)


def parse_tenant_qos(spec: str) -> dict[str, tuple]:
    """Parse the `osd_mclock_tenant_qos` conf string:
    "bully:0.05:0.5:0.15,victim:0.30:4:1.0" ->
    {tenant: (res_frac, weight, lim_frac)}.  Malformed rows are
    skipped (a poison conf value must never sever the op path)."""
    out: dict[str, tuple] = {}
    for row in (spec or "").split(","):
        row = row.strip()
        if not row:
            continue
        parts = row.split(":")
        if len(parts) != 4:
            continue
        try:
            out[parts[0]] = (float(parts[1]), float(parts[2]),
                             float(parts[3]))
        except ValueError:
            continue
    return out


class _ClassQ:
    __slots__ = ("res", "wgt", "lim", "r_tag", "p_tag", "l_tag",
                 "items")

    def __init__(self, res_rate: float, weight: float,
                 lim_rate: float):
        self.res = max(res_rate, 1e-9)
        self.wgt = max(weight, 1e-9)
        self.lim = max(lim_rate, 1e-9)
        self.r_tag = 0.0
        self.p_tag = 0.0
        self.l_tag = 0.0
        self.items: list = []          # FIFO of (fn, cost, t_enq)


class _Shard:
    """Tag books are keyed by the base class name (str) or, for
    tenant-stamped client ops, by a ("client", tenant) tuple — each
    tenant gets its OWN dmClock RWL row nested inside the client
    class, created lazily on first sight from the tenant QoS rows."""

    def __init__(self, profile: dict, capacity: float):
        self.capacity = capacity
        self.classes: dict = {
            k: _ClassQ(res * capacity, wgt, lim * capacity)
            for k, (res, wgt, lim) in profile.items()}
        self.wake = asyncio.Event()
        self.size = 0

    def ensure(self, key, res_frac: float, wgt: float,
               lim_frac: float) -> None:
        """Create the (class, tenant) tag book on first sight."""
        if key not in self.classes:
            self.classes[key] = _ClassQ(res_frac * self.capacity,
                                        wgt,
                                        lim_frac * self.capacity)

    def push(self, klass, fn, cost: float) -> None:
        q = self.classes[klass]
        now = time.monotonic()
        if not q.items:
            # idle -> busy: no banked credit
            q.r_tag = max(q.r_tag, now)
            q.l_tag = max(q.l_tag, now)
            busy_p = [c.p_tag for c in self.classes.values() if c.items]
            q.p_tag = max(q.p_tag, min(busy_p) if busy_p else q.p_tag)
        q.items.append((fn, cost, now))
        self.size += 1
        self.wake.set()

    def _pick(self) -> tuple[str, float] | None:
        """(class, 0) to run now, or (None, delay) to sleep."""
        now = time.monotonic()
        busy = [(k, q) for k, q in self.classes.items() if q.items]
        if not busy:
            return None
        # 1. reservation phase (key= keeps mixed str/tuple book keys
        # out of the comparison when tags tie)
        ready = [(q.r_tag, k) for k, q in busy if q.r_tag <= now]
        if ready:
            return ("R", min(ready, key=lambda t: t[0])[1])
        # 2. proportional phase under limit
        under = [(q.p_tag, k) for k, q in busy if q.l_tag <= now]
        if under:
            return ("P", min(under, key=lambda t: t[0])[1])
        # 3. everything limited: sleep till the nearest tag matures
        horizon = min(min(q.r_tag for _, q in busy),
                      min(q.l_tag for _, q in busy))
        return ("S", max(horizon - now, 0.0005))

    def pop(self, klass, phase: str):
        """Returns (fn, queue_wait_seconds)."""
        q = self.classes[klass]
        fn, cost, t_enq = q.items.pop(0)
        self.size -= 1
        now = time.monotonic()
        if phase == "R":
            q.r_tag = max(q.r_tag, now) + cost / q.res
            # the proportional/limit books still advance: a
            # reservation-phase grant consumes budget everywhere
            q.p_tag += cost / q.wgt
            q.l_tag = max(q.l_tag, now) + cost / q.lim
        else:
            q.p_tag += cost / q.wgt
            q.l_tag = max(q.l_tag, now) + cost / q.lim
            q.r_tag = max(q.r_tag, now) + cost / q.res
        return fn, now - t_enq


class OpScheduler:
    """Sharded dmClock arbiter; one per OSD."""

    def __init__(self, ctx=None, num_shards: int | None = None,
                 capacity_iops: float | None = None,
                 profile: dict | None = None):
        conf = getattr(ctx, "conf", None)
        if num_shards is None:
            num_shards = int(conf["osd_op_num_shards"]) if conf else 4
        if capacity_iops is None:
            capacity_iops = (float(conf["osd_mclock_capacity_iops"])
                             if conf else 10000.0)
        self.profile = dict(profile or DEFAULT_PROFILE)
        self.capacity = capacity_iops
        self.ctx = ctx
        self.shards = [_Shard(self.profile, capacity_iops)
                       for _ in range(max(1, num_shards))]
        self._workers: list[asyncio.Task] = []
        self.running = False
        # perf visibility (base classes; tenant books fold into their
        # base class here and get their own tenant_dispatched counts)
        self.dispatched = {k: 0 for k in self.profile}
        self.tenant_dispatched: dict[str, int] = {}
        # per-class queue-wait books: klass -> [count, sum_seconds];
        # on_wait(klass, seconds, tenant) additionally fires per
        # dequeue so the OSD can feed its stage-latency histograms
        # (the queue-wait stage of the op timeline, per tenant)
        self.queue_wait = {k: [0, 0.0] for k in self.profile}
        self.on_wait = None
        # tenant QoS rows parsed from conf, cached per spec string
        self._tenant_qos_spec: str | None = None
        self._tenant_qos: dict[str, tuple] = {}

    # -- tenant QoS rows ---------------------------------------------------

    def tenant_profile(self, tenant: str) -> tuple:
        """(res_frac, weight, lim_frac) for one tenant: the
        `osd_mclock_tenant_qos` conf row when present, else the
        per-tenant defaults (`osd_mclock_tenant_*`).  Re-read per
        spec-string change so `config set` acts live."""
        conf = getattr(self.ctx, "conf", None)
        if conf is None:
            return TENANT_DEFAULT_PROFILE
        spec = str(conf.get("osd_mclock_tenant_qos", "") or "")
        if spec != self._tenant_qos_spec:
            self._tenant_qos_spec = spec
            self._tenant_qos = parse_tenant_qos(spec)
        row = self._tenant_qos.get(tenant)
        if row is not None:
            return row
        return (float(conf.get("osd_mclock_tenant_reservation",
                               TENANT_DEFAULT_PROFILE[0])),
                float(conf.get("osd_mclock_tenant_weight",
                               TENANT_DEFAULT_PROFILE[1])),
                float(conf.get("osd_mclock_tenant_limit",
                               TENANT_DEFAULT_PROFILE[2])))

    def _book_key(self, sh: _Shard, klass: str, tenant: str | None):
        """Resolve the tag-book key for one item, lazily creating the
        tenant's RWL row (tenant books nest only inside the client
        class — background classes are already cluster-internal)."""
        if tenant is None or klass != K_CLIENT:
            return klass
        key = (klass, tenant)
        if key not in sh.classes:
            res, wgt, lim = self.tenant_profile(tenant)
            sh.ensure(key, res, wgt, lim)
        return key

    # -- lifecycle ---------------------------------------------------------

    def start(self, spawn) -> None:
        """spawn: task factory (Messenger.spawn) so worker lifetimes
        track the daemon's."""
        if self.running:
            return
        self.running = True
        for sh in self.shards:
            self._workers.append(spawn(self._worker(sh)))

    def stop(self) -> None:
        self.running = False
        for sh in self.shards:
            sh.wake.set()

    async def _worker(self, sh: _Shard) -> None:
        while self.running:
            if sh.size == 0:
                sh.wake.clear()
                await sh.wake.wait()
                continue
            pick = sh._pick()
            if pick is None:
                continue
            phase, val = pick
            if phase == "S":
                try:
                    await asyncio.wait_for(sh.wake.wait(), timeout=val)
                    sh.wake.clear()
                except asyncio.TimeoutError:
                    pass
                continue
            fn, waited = sh.pop(val, phase)
            base, tenant = ((val[0], val[1])
                            if isinstance(val, tuple)
                            else (val, None))
            self.dispatched[base] = self.dispatched.get(base, 0) + 1
            if tenant is not None:
                self.tenant_dispatched[tenant] = \
                    self.tenant_dispatched.get(tenant, 0) + 1
            book = self.queue_wait[base]
            book[0] += 1
            book[1] += waited
            if self.on_wait is not None:
                try:
                    self.on_wait(base, waited, tenant)
                except Exception:
                    pass    # observability must never sink the worker
            try:
                r = fn()
                if asyncio.iscoroutine(r) or isinstance(r, asyncio.Future):
                    await r
            except Exception:       # worker must survive op failures
                import traceback
                traceback.print_exc()

    # -- entry points ------------------------------------------------------

    def shard_of(self, key) -> int:
        return hash(key) % len(self.shards)

    def enqueue(self, key, klass: str, fn, cost: float = 1.0,
                tenant: str | None = None) -> None:
        sh = self.shards[self.shard_of(key)]
        sh.push(self._book_key(sh, klass, tenant), fn, cost)

    async def admit(self, klass: str, cost: float = 1.0,
                    key=0, tenant: str | None = None) -> None:
        """Admission ticket for background flows: resolves when the
        arbiter grants `cost` units to `klass` (or to the tenant's
        own tag book when `tenant` is given)."""
        if not self.running:
            return
        loop = asyncio.get_event_loop()
        fut = loop.create_future()

        def grant():
            if not fut.done():
                fut.set_result(None)

        sh = self.shards[self.shard_of(key)]
        sh.push(self._book_key(sh, klass, tenant), grant, cost)
        await fut
