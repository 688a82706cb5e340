"""Tenant traffic generator: hundreds of client streams, one process.

The contended-workload half of ROADMAP direction 1 (Kim et al.,
arXiv:1709.05365: online-EC stores degrade under exactly this mix):
``TenantStream`` multiplexes one tenant's op stream over the SHARED
RadosClient messenger — no per-stream sockets or daemons — with a
bounded per-stream in-flight window (the Objecter-side admission
analog), and ``TrafficGenerator`` drives any number of streams
concurrently, folding per-tenant latency percentiles out the other
side.

The canonical scenario is the noisy neighbor: a bully tenant floods
(many streams, wide windows) while victims run a modest steady load —
with per-tenant dmClock rows configured (`osd_mclock_tenant_qos`),
the bully is throttled at its limit tag and the victims' p99 holds.
`bench.py --traffic` publishes exactly that figure behind a
regression gate; the thrasher's `bully_tenant` action replays it
mid-fault-schedule.

Acked-write tracking mirrors testing.thrasher.Workload: only writes
whose future resolved are recorded, and `verify()` reads every one
back byte-identical — a bully being throttled must never turn into a
bully losing acknowledged data.
"""

from __future__ import annotations

import asyncio
import random


def pctl_ms(samples: list[float], p: float) -> float:
    """p-quantile of latency samples, in ms (0.0 when empty)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(p * len(s)))] * 1e3


class TenantStream:
    """One tenant-stamped op stream with a bounded in-flight window.

    `window` concurrent slots each loop submit -> await; the op mix
    is seeded (`read_frac` of reads against already-acked objects,
    writes otherwise), so a schedule replays from its seed."""

    def __init__(self, client, pool_id: int, tenant: str,
                 prefix: str, window: int = 4,
                 obj_bytes: int = 4096, n_objects: int = 16,
                 read_frac: float = 0.0, seed: int = 0,
                 op_timeout: float = 30.0):
        self.client = client
        self.pool_id = pool_id
        self.tenant = tenant
        self.prefix = prefix
        self.window = max(1, int(window))
        self.obj_bytes = int(obj_bytes)
        self.n_objects = max(1, int(n_objects))
        self.read_frac = float(read_frac)
        self.op_timeout = float(op_timeout)
        self.rng = random.Random("%s|%s|%d" % (tenant, prefix, seed))
        self.latencies: list[float] = []    # seconds, completed ops
        self.errors = 0
        self.ops_done = 0
        self.acked: dict[str, bytes] = {}   # oid -> last acked bytes

    def _payload(self, oid: str) -> bytes:
        rep = self.rng.randrange(1, 4)
        base = ("%s|%s|%d|" % (self.prefix, oid,
                               self.rng.randrange(1 << 30))).encode()
        out = base * max(1, self.obj_bytes // max(1, len(base)) * rep)
        return out[:max(1, self.obj_bytes)]

    async def _one_op(self) -> None:
        oid = "%s-%d" % (self.prefix,
                         self.rng.randrange(self.n_objects))
        reads_ok = self.acked and self.rng.random() < self.read_frac
        t0 = asyncio.get_event_loop().time()
        try:
            if reads_ok:
                roid = self.rng.choice(sorted(self.acked))
                outs = await asyncio.wait_for(
                    self.client.submit_op(
                        self.pool_id, roid,
                        [{"op": "read", "offset": 0, "length": 0}],
                        tenant=self.tenant),
                    self.op_timeout)
                assert outs[0]["data"] == self.acked[roid], \
                    "acked write %s read back wrong bytes" % roid
            else:
                data = self._payload(oid)
                await asyncio.wait_for(
                    self.client.submit_op(
                        self.pool_id, oid,
                        [{"op": "writefull", "data": data}],
                        tenant=self.tenant),
                    self.op_timeout)
                self.acked[oid] = data
        except AssertionError:
            raise
        except Exception:
            self.errors += 1
            return
        self.latencies.append(
            asyncio.get_event_loop().time() - t0)
        self.ops_done += 1

    async def _slot(self, stop_at: float) -> None:
        loop = asyncio.get_event_loop()
        while loop.time() < stop_at:
            await self._one_op()

    async def run(self, duration: float) -> "TenantStream":
        stop_at = asyncio.get_event_loop().time() + float(duration)
        await asyncio.gather(*[self._slot(stop_at)
                               for _ in range(self.window)])
        return self

    async def verify(self) -> None:
        """Every acked write reads back byte-identical (the
        zero-lost-acked-writes oracle of the bully round)."""
        for oid, want in sorted(self.acked.items()):
            outs = await asyncio.wait_for(
                self.client.submit_op(
                    self.pool_id, oid,
                    [{"op": "read", "offset": 0, "length": 0}],
                    tenant=self.tenant), self.op_timeout)
            got = outs[0]["data"]
            assert got == want, \
                "acked write %s of tenant %s lost/corrupt" \
                % (oid, self.tenant)


class TrafficGenerator:
    """Run any number of TenantStreams concurrently over one shared
    client and fold per-tenant figures."""

    def __init__(self, streams: list[TenantStream]):
        self.streams = list(streams)

    @classmethod
    def build(cls, client, pool_id: int, tenants: dict[str, dict],
              seed: int = 0) -> "TrafficGenerator":
        """tenants: {tenant: {"streams": n, "window": w,
        "obj_bytes": b, "n_objects": o, "read_frac": f}} — hundreds
        of streams per process is the intended scale (each is just a
        few coroutines on the shared messenger)."""
        streams = []
        for tenant, spec in sorted(tenants.items()):
            for i in range(int(spec.get("streams", 1))):
                streams.append(TenantStream(
                    client, pool_id, tenant,
                    prefix="%s-s%d" % (tenant, i),
                    window=int(spec.get("window", 4)),
                    obj_bytes=int(spec.get("obj_bytes", 4096)),
                    n_objects=int(spec.get("n_objects", 16)),
                    read_frac=float(spec.get("read_frac", 0.0)),
                    seed=seed + i))
        return cls(streams)

    async def run(self, duration: float) -> dict[str, dict]:
        t0 = asyncio.get_event_loop().time()
        await asyncio.gather(*[s.run(duration)
                               for s in self.streams])
        wall = max(1e-9, asyncio.get_event_loop().time() - t0)
        return self.tenant_stats(wall)

    async def verify(self) -> None:
        for s in self.streams:
            await s.verify()

    def tenant_stats(self, wall_s: float) -> dict[str, dict]:
        """{tenant: {streams, n, errors, ops_s, p50_ms, p99_ms}}."""
        by_tenant: dict[str, list[TenantStream]] = {}
        for s in self.streams:
            by_tenant.setdefault(s.tenant, []).append(s)
        out: dict[str, dict] = {}
        for tenant, streams in sorted(by_tenant.items()):
            lats: list[float] = []
            for s in streams:
                lats.extend(s.latencies)
            out[tenant] = {
                "streams": len(streams),
                "n": len(lats),
                "errors": sum(s.errors for s in streams),
                "ops_s": round(len(lats) / wall_s, 2),
                "p50_ms": round(pctl_ms(lats, 0.50), 3),
                "p99_ms": round(pctl_ms(lats, 0.99), 3),
            }
        return out
