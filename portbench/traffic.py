"""The general traffic generator: every mix is a workload file's
parameters read here, with everything drawn from the run's seed.

`ClosedLoop` is a rewritten copy of the closed loop of the program's
`testing/traffic.py` `TenantStream`: a fixed number of clients, each
sending its next op only once the last is acknowledged, with the
acknowledged writes tracked so that they can be read back.  Here the
op stream is a workload's `ops` section:

    {"clients": 4, "kind": "write_full", "object_bytes": 4194304,
     "objects": 512}                        whole objects, names cycled
    {"clients": 4, "kind": "write", "object_bytes": 4194304,
     "objects": 64, "io_bytes": 4096}       aligned overwrites at random
                                            offsets of prefilled objects

Every seed writes the same sizes at the same concurrency; the seed
chooses the names' order, the offsets and the bytes.  No two ops in
flight touch the same bytes, so the expected content of each object is
the last acknowledged write to each of its ranges.

`EpochStream` makes map epochs from a workload's `epochs` section:

    {"flap": {"max_out": 10, "max_step": 10}}
        each epoch marks 1..max_step devices out (reweight 0) or back in
        (0x10000), with at most max_out out at once
    {"host_weight": {"step_min": 1024, "step_max": 4096,
                     "min": 32768, "max": 98304}}
        each epoch steps the CRUSH weight of every device of one host up
        or down by a drawn amount, within [min, max]

Imports numpy and the standard library only.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

HEADER = 64     # bytes of each whole-object payload that name the write


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator for one purpose of one run; any seed up to 2**64."""
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


class ObjectImage:
    """The expected content of the objects a mix writes.

    Whole-object payloads are a seeded base buffer with a header naming
    the write; overwrites are seeded bytes from one pool.  `bytes(oid)`
    gives what the object must hold once every tracked write is
    acknowledged; a write that failed leaves its object uncertain."""

    def __init__(self, seed: int, object_bytes: int, bases: int = 8):
        rng = rng_for(seed, 1)
        self.object_bytes = int(object_bytes)
        self.bases = [rng.bytes(self.object_bytes) for _ in range(bases)]
        self.pool = rng.bytes(16 << 20)
        # oid -> (base, serial) of its last whole write, or its bytes
        # once a range of it has been overwritten
        self.objects: dict[str, tuple | bytearray] = {}
        self.uncertain: set[str] = set()

    def whole(self, oid: str, base: int, serial: int) -> bytes:
        head = ("%s|%d|" % (oid, serial)).encode().ljust(HEADER, b".")
        return head[:HEADER] + self.bases[base][HEADER:]

    def acked_whole(self, oid: str, base: int, serial: int) -> None:
        self.objects[oid] = (base, serial)

    def acked_range(self, oid: str, offset: int, data: bytes) -> None:
        cur = self.objects[oid]
        if isinstance(cur, tuple):
            cur = self.objects[oid] = bytearray(self.whole(oid, *cur))
        cur[offset:offset + len(data)] = data

    def bytes(self, oid: str) -> bytes:
        cur = self.objects[oid]
        if isinstance(cur, tuple):
            return self.whole(oid, *cur)
        return bytes(cur)


class ClosedLoop:
    """`clients` coroutines, each submit -> await -> submit, over one
    IoCtx, until a deadline on the monotonic clock."""

    def __init__(self, io, spec: dict, seed: int, image: ObjectImage,
                 op_timeout: float = 120.0, spans=None):
        self.io = io
        self.clients = int(spec["clients"])
        self.kind = spec["kind"]
        self.objects = int(spec["objects"])
        self.io_bytes = int(spec.get("io_bytes", image.object_bytes))
        self.image = image
        self.rng = rng_for(seed, 2)
        self.names = ["obj-%d" % i
                      for i in self.rng.permutation(self.objects)]
        self.op_timeout = float(op_timeout)
        self.spans = spans
        self.serial = 0
        self.busy: set = set()          # (oid, block) of ops in flight
        self.ops: list[dict] = []

    def _next(self) -> tuple[str, int, bytes, tuple]:
        """(oid, offset, data, key) of the next op; its key is held
        while it is in flight (for a whole write it also names the
        payload's base and serial)."""
        while True:
            self.serial += 1
            if self.kind == "write_full":
                oid = self.names[self.serial % self.objects]
                if (oid, -1) in self.busy:
                    continue
                base = int(self.rng.integers(len(self.image.bases)))
                return (oid, 0, self.image.whole(oid, base, self.serial),
                        (oid, -1, base, self.serial))
            blocks = self.image.object_bytes // self.io_bytes
            oid = self.names[int(self.rng.integers(self.objects))]
            blk = int(self.rng.integers(blocks))
            key = (oid, blk)
            if key in self.busy:
                continue
            at = int(self.rng.integers(len(self.image.pool)
                                       - self.io_bytes))
            return (oid, blk * self.io_bytes,
                    self.image.pool[at:at + self.io_bytes], key)

    async def _op(self, oid: str, offset: int, data: bytes) -> None:
        if self.kind == "write_full":
            await self.io.write_full(oid, data)
        else:
            await self.io.write(oid, data, offset=offset)

    async def _client(self, deadline: float) -> None:
        while time.monotonic() < deadline:
            oid, offset, data, key = self._next()
            self.busy.add(key[:2])
            rec = {"t0": time.monotonic(), "bytes": len(data),
                   "kind": self.kind, "oid": oid, "ok": False}
            t0_ns = time.time_ns()
            try:
                await asyncio.wait_for(self._op(oid, offset, data),
                                       self.op_timeout)
                rec["ok"] = True
            except Exception as e:      # counted as failed, never retried
                rec["error"] = repr(e)
                self.image.uncertain.add(oid)
            rec["t1"] = time.monotonic()
            if self.spans is not None:
                self.spans.add("client %s in flight" % self.kind, t0_ns,
                               time.time_ns())
            self.busy.discard(key[:2])
            if rec["ok"]:
                if self.kind == "write_full":
                    self.image.acked_whole(oid, key[2], key[3])
                else:
                    self.image.acked_range(oid, offset, data)
            self.ops.append(rec)

    async def run_until(self, deadline: float) -> list[dict]:
        """Run every client until `deadline`, then wait for the ops in
        flight; returns the records of the ops started."""
        start = len(self.ops)
        await asyncio.gather(*[self._client(deadline)
                               for _ in range(self.clients)])
        return self.ops[start:]


class EpochStream:
    """Seeded map changes, one incremental's worth per `next()`: the
    reweights (osd_weight, 16.16) and the devices' CRUSH weights."""

    def __init__(self, spec: dict, seed: int, n_devices: int,
                 per_host: int, crush_weight: int = 0x10000):
        self.spec = spec
        self.rng = rng_for(seed, 3)
        self.n = int(n_devices)
        self.per_host = int(per_host)
        self.reweight = np.full(self.n, 0x10000, dtype=np.int64)
        self.crush = np.full(self.n, int(crush_weight), dtype=np.int64)

    def next(self) -> dict:
        """The changes of one epoch: {"reweight": {dev: w}} and/or
        {"crush": new device CRUSH weights}."""
        out: dict = {}
        flap = self.spec.get("flap")
        if flap is not None:
            out["reweight"] = self._flap(int(flap["max_out"]),
                                         int(flap["max_step"]))
        hw = self.spec.get("host_weight")
        if hw is not None:
            self._step_host(hw)
            out["crush"] = self.crush.copy()
        return out

    def _flap(self, max_out: int, max_step: int) -> dict[int, int]:
        out_now = np.nonzero(self.reweight == 0)[0]
        in_now = np.nonzero(self.reweight != 0)[0]
        room = max_out - len(out_now)
        mark_out = len(out_now) == 0 or (room > 0
                                         and self.rng.random() < 0.5)
        if mark_out:
            k = int(self.rng.integers(1, min(room, max_step) + 1))
            pick = self.rng.choice(in_now, size=k, replace=False)
            w = 0
        else:
            k = int(self.rng.integers(1, min(len(out_now), max_step) + 1))
            pick = self.rng.choice(out_now, size=k, replace=False)
            w = 0x10000
        self.reweight[pick] = w
        return {int(d): w for d in pick}

    def _step_host(self, hw: dict) -> None:
        hosts = self.n // self.per_host
        h = int(self.rng.integers(hosts))
        step = int(self.rng.integers(int(hw["step_min"]),
                                     int(hw["step_max"]) + 1))
        sl = slice(h * self.per_host, (h + 1) * self.per_host)
        cur = int(self.crush[sl][0])
        up = cur + step <= int(hw["max"]) and (
            cur - step < int(hw["min"]) or self.rng.random() < 0.5)
        self.crush[sl] = cur + step if up else cur - step
