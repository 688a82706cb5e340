"""Per-process device runtime for the CUDA port: the substrate under the
batched EC products, one ``ChipRuntime`` per card.

Counterpart of ceph_tpu/device/runtime.py.  It keeps three concerns per
chip:

* **bucket-ladder staging** — flushes stage as power-of-two segments
  covering the exact ragged flush total (`ragged_plan`), so only the
  ladder's tail rounds up; `note_program` counts the distinct
  (matrix, w, bucket) shapes dispatched and `note_staging` the padding.
* **pinned staging pool** — bucket-sized, page-locked host buffers
  leased and released across flushes instead of allocated per flush
  (`BufferPool`), so the copy to the card runs asynchronously.
* **dispatch queue with admission backpressure** — bounded in-flight
  dispatches, weighted-fair across service classes (client-EC /
  recovery-EC / mapping / background, the weights of the mClock
  op-scheduler profile); queue-full raises `DeviceBusy`, which fails
  the dispatch.  The port has no host route to degrade to: a refused
  or failed dispatch reaches the awaiting callers as an error.

**Chip loss.**  A dispatch that fails for any reason but `DeviceBusy`
or a `ValueError` (a shape or scope error is the caller's, not the
card's) marks its chip *lost* (`ChipRuntime.finish` applies this rule
once for every caller), as does `poison(reason)` or an injected fault
(`inject_fault`, consumed by `launch` and by the probe).  A lost chip
refuses admission with `DeviceLost` before anything is staged or
launched, so its ops fail at once (the stream and the batcher turn the
refusal into `IOError` on their futures) until a probe loop — a tiny
torch op on the chip and a synchronise, paced by `ExpBackoff` — heals
it.  After a sticky CUDA error the probe keeps failing and the chip
stays lost.  `route(None)` takes the first available chip and raises
`DeviceLost` when every chip is lost; an explicit chip is honoured
while lost, so its ops fail in their own isolation domain; shard plans
leave lost chips out.  The state is `lost` / `lost_reason` /
`loss_count` / `heal_count` with the metrics `device_lost`,
`device_loss_count`, `device_heal_count` and `device_lost_chips`:
the reference calls it "fallback", because there a lost chip's work
re-runs on the host, and counts `host_fallbacks`.  The port has no
such route, so it has neither.

Every dispatch carries a `DispatchTicket` (chip, class, bucket, bytes,
enqueue/admit/launch/done stamps) whose device time comes from CUDA
events recorded on the chip's stream.  Each finished ticket feeds the
flight recorder's device ring (`trace.recorder.note_ticket`) and its
chip's power-of-two microsecond histogram of device time
(`dispatch_buckets_us`, the `device_dispatch_seconds` series of
`prom_lines`).  `configure(conf)` adopts a daemon's settings and
`warmup_ec` runs a coding matrix's common buckets once at boot.
"""

from __future__ import annotations

import asyncio
import contextlib
import heapq
import time

import numpy as np
import torch

from .. import default_device
from ..trace import recorder as flight
from . import mesh

# service classes (the device-side analog of the mClock op classes)
K_CLIENT_EC = "client-ec"
K_RECOVERY_EC = "recovery-ec"
K_MAPPING = "mapping"
K_BACKGROUND = "background"

# class shares of the mClock op-scheduler profile (client 4, recovery 2)
DEVICE_DISPATCH_WEIGHTS = {
    K_CLIENT_EC: 4.0,
    K_RECOVERY_EC: 2.0,
    K_MAPPING: 1.0,
    K_BACKGROUND: 0.5,
}
# per-tenant dmClock row defaults (reservation, weight, limit)
TENANT_DEFAULT_PROFILE = (0.05, 1.0, 1.00)


def device_admission_weight(klass: str, tenant: str | None,
                            tenant_qos: dict[str, tuple] | None) -> float:
    """Proportional admission weight of one op at the device layer:
    the class share times, for tenant-stamped client-EC work, the
    tenant's dmClock weight column."""
    base = DEVICE_DISPATCH_WEIGHTS.get(klass, 1.0)
    if tenant is None or klass != K_CLIENT_EC:
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


class DeviceBusy(Exception):
    """Admission rejected: the dispatch queue is at its bound."""


class DeviceLost(Exception):
    """The chip is lost (a failed dispatch, `poison` or an injected
    fault): admission and launch refuse until a probe heals it."""


class DispatchTicket:
    """One device dispatch's identity + timeline.

    Stamps: t_enqueue (admission requested) -> t_admit (queue granted)
    -> t_launch (dispatch handed to the device) -> t_done, on the host
    clock.  On a card, `launch` and `finish` also record CUDA events on
    the chip's stream, and `device_s` is the time between them on the
    device.  `t_enqueue` may be passed explicitly so the wait an op
    spent before the dispatch existed counts too.  `tenant` is the
    single tenant every batched item agreed on, "mixed", or None;
    `stream` marks a slot dispatch of the continuous per-chip stream."""

    __slots__ = ("seq", "klass", "bucket", "nbytes", "chip",
                 "t_enqueue", "t_admit", "t_launch", "t_done", "ok",
                 "error", "tenant", "stream", "ev_launch", "ev_done",
                 "_device_s")

    def __init__(self, seq: int, klass: str, bucket: int, nbytes: int,
                 chip: int = 0, tenant: str | None = None,
                 t_enqueue: float | None = None,
                 stream: bool = False):
        self.seq = seq
        self.klass = klass
        self.bucket = bucket
        self.nbytes = nbytes
        self.chip = chip
        self.tenant = tenant
        self.stream = bool(stream)
        self.t_enqueue = (time.monotonic() if t_enqueue is None
                          else float(t_enqueue))
        self.t_admit = 0.0
        self.t_launch = 0.0
        self.t_done = 0.0
        self.ok = False
        self.error: str | None = None
        self.ev_launch = None
        self.ev_done = None
        self._device_s: float | None = None

    @property
    def queue_wait(self) -> float:
        return max(0.0, (self.t_admit or self.t_enqueue)
                   - self.t_enqueue)

    @property
    def device_s(self) -> float:
        """Seconds of the dispatch on the device: CUDA-event time on a
        card, host launch -> done otherwise."""
        if self._device_s is not None:
            return self._device_s
        if not self.t_done or not self.t_launch:
            return 0.0
        return max(0.0, self.t_done - self.t_launch)


class BufferPool:
    """Free-lists of bucket-sized host staging tensors keyed (shape,
    dtype): page-locked when the chip is a card, so the copy to the
    device runs asynchronously.  Leased buffers come back zeroed —
    bucket padding must be zero for GF bit-parity with the unpadded
    host encode."""

    def __init__(self, pinned: bool = False, max_per_key: int = 4):
        self.pinned = pinned
        self.max_per_key = max_per_key
        self._free: dict[tuple, list[torch.Tensor]] = {}
        self.hits = 0
        self.misses = 0
        self.outstanding = 0

    def lease(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        free = self._free.get(key)
        if free:
            buf = free.pop()
            buf.zero_()
            self.hits += 1
        else:
            buf = torch.zeros(shape, dtype=dtype, pin_memory=self.pinned)
            self.misses += 1
        self.outstanding += 1
        return buf

    def release(self, buf: torch.Tensor) -> None:
        """Return a buffer whose last copy to the device has completed."""
        self.outstanding -= 1
        free = self._free.setdefault((tuple(buf.shape), buf.dtype), [])
        if len(free) < self.max_per_key:
            free.append(buf)

    def drop(self, buf: torch.Tensor) -> None:
        """Forget a buffer that a failed dispatch may still be reading."""
        self.outstanding -= 1


class DispatchQueue:
    """Bounded in-flight dispatches with weighted-fair admission.

    Start-time fair queueing over virtual time: each class keeps a
    finish tag advanced by cost/weight per grant, waiters are served
    in tag order — so under contention client-EC (weight 4) gets ~4x
    the grants of mapping (weight 1).  `admit` parks the caller while
    the queue has room; once `max_queue` waiters are parked further
    admissions raise DeviceBusy."""

    def __init__(self, weights: dict[str, float],
                 max_inflight: int = 2, max_queue: int = 64):
        self.weights = dict(weights)
        self.max_inflight = max(1, int(max_inflight))
        self.max_queue = max(0, int(max_queue))
        self.inflight = 0
        self._vt = 0.0                      # virtual clock
        self._finish: dict[str, float] = {}
        self._seq = 0
        # heap of (finish_tag, seq, klass, cost, future)
        self._waiters: list = []
        self.rejected = 0

    @property
    def depth(self) -> int:
        return self.inflight + len(self._waiters)

    def _tag(self, klass: str, cost: float) -> float:
        w = self.weights.get(klass, 1.0)
        start = max(self._vt, self._finish.get(klass, 0.0))
        fin = start + cost / max(w, 1e-9)
        self._finish[klass] = fin
        return fin

    def try_admit(self, klass: str, cost: float = 1.0) -> None:
        """Synchronous, non-blocking admission (the bulk mapper's
        path — it runs outside a coroutine).  Raises DeviceBusy when
        a grant would overtake parked waiters or exceed the bound."""
        if self.inflight >= self.max_inflight or self._waiters:
            self.rejected += 1
            raise DeviceBusy("device dispatch queue at depth %d"
                             % self.depth)
        self._vt = max(self._vt, self._finish.get(klass, 0.0))
        self._tag(klass, cost)
        self.inflight += 1

    async def admit(self, klass: str, cost: float = 1.0) -> None:
        if self.inflight < self.max_inflight and not self._waiters:
            self._tag(klass, cost)
            self.inflight += 1
            return
        if len(self._waiters) >= self.max_queue:
            self.rejected += 1
            raise DeviceBusy("device dispatch queue full (%d waiting)"
                             % len(self._waiters))
        fut = asyncio.get_running_loop().create_future()
        self._seq += 1
        heapq.heappush(self._waiters,
                       (self._tag(klass, cost), self._seq, klass,
                        cost, fut))
        await fut

    def release(self) -> None:
        self.inflight = max(0, self.inflight - 1)
        while self.inflight < self.max_inflight and self._waiters:
            tag, _seq, klass, _cost, fut = heapq.heappop(self._waiters)
            self._vt = max(self._vt, tag)
            if fut.cancelled():
                continue
            self.inflight += 1
            fut.set_result(None)


_MIN_BUCKET = 512          # words: floor so tiny flushes share one bucket
_TICKET_RING = 512
_HIST_BUCKETS = 32         # power-of-two microsecond histogram

# bucket-ladder cap: a ragged flush stages at most this many pow2
# segments; the tail-only rounding then bounds waste at ~n / 2^(cap-1)
# of the flush, while more segments would trade the padding win back
# for per-dispatch overhead
_RAGGED_MAX_SEGMENTS = 6

# words at/above which a flush shards across the mesh's chips (the
# zero-collective stripe-axis split)
_SHARD_MIN_WORDS = 1 << 19


class ChipRuntime:
    """One chip's isolation domain: its device, DispatchQueue,
    BufferPool, bucket accounting, ticket ring and chip-loss state."""

    def __init__(self, rt: "DeviceRuntime", index: int,
                 weights: dict[str, float], max_inflight: int,
                 max_queue: int):
        self.rt = rt
        self.index = int(index)
        self.device = mesh.device_for(self.index, rt.device)
        self.queue = DispatchQueue(weights, max_inflight, max_queue)
        self.pool = BufferPool(pinned=self.device.type == "cuda")
        # bucket bookkeeping: distinct (kind, matrix, w, bucket) shapes
        self.programs: set[tuple] = set()
        self.compile_count = 0
        self.bucket_hits = 0
        self.bucket_misses = 0
        # ragged staging accounting: payload vs bucket-padded words,
        # plus the pad a whole-flush pow2 bucket would have burned
        self.staged_payload_words = 0
        self.staged_pad_words = 0
        self.staged_pow2_pad_words = 0
        # background planes: raw bytes match-planned and the containers
        # emitted from those plans; chunks and bytes fingerprinted
        self.compress_bytes_in = 0
        self.compress_bytes_out = 0
        # recovery flows bound to this chip: survivor bytes read and
        # rebuilt bytes pushed
        self.repair_bytes_read = 0
        self.repair_bytes_moved = 0
        self.fingerprint_chunks = 0
        self.fingerprint_bytes = 0
        # dispatch telemetry
        self.tickets: list[DispatchTicket] = []     # bounded ring
        self.dispatch_buckets_us = [0] * _HIST_BUCKETS
        self.dispatches = 0
        # chip-loss state
        self.lost = False
        self.lost_reason: str | None = None
        self.loss_count = 0
        self.heal_count = 0
        self._fault_budget = 0         # injected failures outstanding
        self._probe_task = None
        self._listeners: list = []     # fn(lost: bool) on each transition
        # continuous dispatch stream, created on first stream-mode submit
        self._stream = None

    @property
    def stream(self):
        """This chip's persistent dispatch stream (lazy)."""
        if self._stream is None:
            from .stream import DispatchStream
            self._stream = DispatchStream(self)
        return self._stream

    # -- placement ---------------------------------------------------------

    def place(self, arr) -> torch.Tensor:
        """Copy a host tensor (or numpy array) to this chip's device;
        from pinned staging the copy is asynchronous on the current
        stream."""
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(arr)
        return arr.to(self.device, non_blocking=True)

    # -- buckets -----------------------------------------------------------

    def note_program(self, kind: str, key: tuple) -> bool:
        """Record a dispatch shape; True when this (kind, key) had never
        run on THIS chip before."""
        pk = (kind,) + tuple(key)
        if pk in self.programs:
            self.bucket_hits += 1
            return False
        self.programs.add(pk)
        self.compile_count += 1
        self.bucket_misses += 1
        return True

    def note_staging(self, payload_words: int,
                     padded_words: int) -> None:
        """Account one flush's staging: `payload_words` real columns
        staged into `padded_words` of bucket capacity, and what a
        whole-flush pow2 bucket would have padded."""
        self.staged_payload_words += max(0, int(payload_words))
        self.staged_pad_words += max(
            0, int(padded_words) - int(payload_words))
        self.staged_pow2_pad_words += max(
            0, DeviceRuntime.bucket_for(payload_words)
            - int(payload_words))

    def note_repair(self, bytes_read: int, bytes_moved: int) -> None:
        """Account one shard repair's traffic on this chip: survivor
        bytes sourced (what minimum_to_decode's minimal shard set
        fetched) and rebuilt bytes pushed (device_repair_bytes_read /
        _moved)."""
        self.repair_bytes_read += max(0, int(bytes_read))
        self.repair_bytes_moved += max(0, int(bytes_moved))

    def note_compress(self, bytes_in: int, bytes_out: int) -> None:
        """Account one device-planned compression: raw bytes in,
        container bytes out (device_compress_bytes_in/_out)."""
        self.compress_bytes_in += max(0, int(bytes_in))
        self.compress_bytes_out += max(0, int(bytes_out))

    def note_fingerprint(self, chunks: int, nbytes: int) -> None:
        """Account one device-fingerprinted chunk batch
        (device_fingerprint_chunks/_bytes)."""
        self.fingerprint_chunks += max(0, int(chunks))
        self.fingerprint_bytes += max(0, int(nbytes))

    # -- tickets -----------------------------------------------------------

    def open_ticket(self, klass: str, bucket: int, nbytes: int,
                    tenant: str | None = None,
                    t_enqueue: float | None = None,
                    stream: bool = False) -> DispatchTicket:
        return DispatchTicket(self.rt.next_seq(), klass, bucket,
                              nbytes, chip=self.index, tenant=tenant,
                              t_enqueue=t_enqueue, stream=stream)

    def _refuse_if_lost(self) -> None:
        if self.lost:
            raise DeviceLost("chip %d is lost (%s)"
                             % (self.index, self.lost_reason))

    async def admit(self, ticket: DispatchTicket,
                    cost: float | None = None) -> None:
        """Admit in weighted-fair order, waiting for room; raises
        DeviceBusy when the queue is full and DeviceLost when the chip
        is lost (before the wait, and again if it was lost during it)."""
        self._refuse_if_lost()
        await self.queue.admit(
            ticket.klass,
            cost if cost is not None
            else max(1.0, ticket.nbytes / 65536.0))
        if self.lost:
            self.queue.release()
            self._refuse_if_lost()
        ticket.t_admit = time.monotonic()

    def try_admit(self, ticket: DispatchTicket,
                  cost: float | None = None) -> None:
        """Admit now or raise DeviceBusy / DeviceLost (callers outside
        a coroutine)."""
        self._refuse_if_lost()
        self.queue.try_admit(
            ticket.klass,
            cost if cost is not None
            else max(1.0, ticket.nbytes / 65536.0))
        ticket.t_admit = time.monotonic()

    @contextlib.asynccontextmanager
    async def staged_dispatch(self, klass: str, bucket: int, nbytes: int,
                              shape: tuple, kind: str):
        """One background-plane dispatch: admission (DeviceBusy and
        DeviceLost propagate), then (ticket, stage), a zeroed uint8 staging
        buffer of `shape` leased from the pool.  The body fills the
        stage, stamps `launch(ticket)`, runs its program and copies the
        result to the host.  On a clean exit the ticket finishes and
        the (kind, shape) program and the staging are accounted; an
        exception fails the ticket and raises IOError."""
        ticket = self.open_ticket(klass, bucket, nbytes)
        await self.admit(ticket)
        stage = self.pool.lease(shape, torch.uint8)
        try:
            yield ticket, stage
        except Exception as e:
            self.finish(ticket, ok=False, error=e)
            self.pool.drop(stage)
            raise IOError("%s dispatch failed: %r" % (kind, e)) from e
        self.finish(ticket, ok=True)
        self.pool.release(stage)
        self.note_program(kind, tuple(shape))
        # staging accounting in words, like the EC ladder
        self.note_staging(nbytes // 4, stage.numel() // 4)

    def _event(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def launch(self, ticket: DispatchTicket) -> None:
        """Stamp launch (and record its CUDA event on a card); consumes
        one injected fault if armed and raises DeviceLost."""
        ticket.t_launch = time.monotonic()
        if self._fault_budget > 0:
            self._fault_budget -= 1
            raise DeviceLost("injected device fault (chip %d)"
                             % self.index)
        ticket.ev_launch = self._event()

    def finish(self, ticket: DispatchTicket, ok: bool = True,
               error: Exception | None = None) -> None:
        """Close an admitted ticket.  A failure `error` other than
        DeviceBusy or a ValueError (the caller's shape or scope error)
        marks the chip lost."""
        ticket.t_done = time.monotonic()
        ticket.ok = ok
        ticket.error = repr(error) if error is not None else None
        if ok and ticket.ev_launch is not None:
            ticket.ev_done = self._event()
            ticket.ev_done.synchronize()
            ticket._device_s = ticket.ev_launch.elapsed_time(
                ticket.ev_done) / 1e3
        self.queue.release()
        self.tickets.append(ticket)
        if len(self.tickets) > _TICKET_RING:
            del self.tickets[:_TICKET_RING // 2]
        if ok:
            self.dispatches += 1
            us = max(1, int(ticket.device_s * 1e6))
            self.dispatch_buckets_us[
                min(_HIST_BUCKETS - 1, us.bit_length() - 1)] += 1
        elif error is not None and not isinstance(
                error, (DeviceBusy, ValueError)):
            self.poison(error)
        flight.note_ticket(ticket)

    # -- chip loss ---------------------------------------------------------

    @property
    def available(self) -> bool:
        return not self.lost

    def add_listener(self, fn) -> None:
        """fn(lost: bool) on every loss/heal transition of THIS chip."""
        self._listeners.append(fn)

    def _notify(self) -> None:
        for fn in list(self._listeners):
            try:
                fn(self.lost)
            except Exception:
                pass        # observability must never sink the runtime

    def poison(self, reason) -> None:
        """Mark this chip lost; under a running event loop a probe loop
        retries the chip under ExpBackoff until it heals (without one,
        `heal()` is the caller's).  Other chips are untouched."""
        if self.lost:
            return
        self.lost = True
        self.lost_reason = repr(reason)
        self.loss_count += 1
        self._notify()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        if self._probe_task is None:
            self._probe_task = loop.create_task(self._probe_loop())

    def heal(self) -> None:
        if not self.lost:
            return
        self.lost = False
        self.lost_reason = None
        self.heal_count += 1
        self._notify()

    def inject_fault(self, n: int = 1) -> None:
        """Arm n deterministic dispatch failures on this chip; probes
        consume from the same budget, so the chip stays lost until the
        budget drains (or clear_faults())."""
        self._fault_budget += int(n)

    def clear_faults(self) -> None:
        self._fault_budget = 0

    def _run_probe(self) -> None:
        """One probe: a tiny torch op on the chip's device and a
        synchronise; raises on failure (an injected fault included)."""
        if self._fault_budget > 0:
            self._fault_budget -= 1
            raise DeviceLost("injected device fault (probe, chip %d)"
                             % self.index)
        x = torch.zeros(8, dtype=torch.int32, device=self.device) + 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if int(x.sum()) != 8:
            raise DeviceLost("probe on chip %d read a wrong sum"
                             % self.index)

    async def _probe_loop(self) -> None:
        from ..utils.backoff import ExpBackoff
        bo = ExpBackoff(base=self.rt._probe_base,
                        cap=self.rt._probe_cap)
        try:
            while self.lost:
                await bo.sleep()
                try:
                    self._run_probe()
                except Exception:
                    continue
                self.heal()
        finally:
            self._probe_task = None

    # -- telemetry ---------------------------------------------------------

    @property
    def bucket_hit_ratio(self) -> float:
        total = self.bucket_hits + self.bucket_misses
        return self.bucket_hits / total if total else 1.0

    @property
    def bucket_waste_ratio(self) -> float:
        """Fraction of staged bucket capacity that was padding."""
        total = self.staged_payload_words + self.staged_pad_words
        return self.staged_pad_words / total if total else 0.0

    def utilization(self, window: float | None = None,
                    now: float | None = None) -> dict:
        """Windowed utilization integrals over the ticket ring:
        ``busy_frac`` (device seconds per wall second), ``queue_wait_frac``
        (admission-wait seconds per wall second) and ``idle_frac``."""
        w = float(window if window is not None
                  else self.rt.util_window)
        t_now = time.monotonic() if now is None else now
        lo = t_now - w
        busy = qwait = 0.0
        for t in self.tickets:
            if not t.t_done or t.t_done <= lo:
                continue
            if t.ok:
                busy += min(t.device_s, t.t_done - lo)
            admit_end = t.t_admit or t.t_done
            if admit_end > lo:
                qwait += min(t.queue_wait, admit_end - lo)
        busy_frac = busy / w if w > 0 else 0.0
        qw_frac = qwait / w if w > 0 else 0.0
        return {"window_s": round(w, 3),
                "busy_frac": round(busy_frac, 4),
                "queue_wait_frac": round(qw_frac, 4),
                "idle_frac": round(max(0.0, 1.0 - busy_frac), 4)}

    def metrics(self) -> dict:
        util = self.utilization()
        s = self._stream
        return {
            "device_queue_depth": self.queue.depth,
            "device_inflight": self.queue.inflight,
            "device_bucket_hit_ratio": round(self.bucket_hit_ratio, 4),
            "device_bucket_waste_ratio": round(self.bucket_waste_ratio,
                                               4),
            "device_compile_count": self.compile_count,
            "device_dispatches": self.dispatches,
            "device_pool_hits": self.pool.hits,
            "device_pool_misses": self.pool.misses,
            "device_queue_rejected": self.queue.rejected,
            "device_lost": int(self.lost),
            "device_loss_count": self.loss_count,
            "device_heal_count": self.heal_count,
            "device_util_busy": util["busy_frac"],
            "device_util_queue_wait": util["queue_wait_frac"],
            "device_util_idle": util["idle_frac"],
            "device_slot_occupancy": round(
                s.slot_occupancy if s is not None else 1.0, 4),
            "device_admission_wait": round(
                s.admission_wait_mean if s is not None else 0.0, 6),
            "device_stream_retires": s.retired if s is not None else 0,
            "device_stream_pending": s.pending if s is not None else 0,
            "device_compress_bytes_in": self.compress_bytes_in,
            "device_compress_bytes_out": self.compress_bytes_out,
            "device_fingerprint_chunks": self.fingerprint_chunks,
            "device_fingerprint_bytes": self.fingerprint_bytes,
            "device_repair_bytes_read": self.repair_bytes_read,
            "device_repair_bytes_moved": self.repair_bytes_moved,
        }


class DeviceRuntime:
    """One per (event loop, device).  The batcher routes every dispatch
    through here onto a chip (``route``): an explicit chip index, or
    the first chip for chip-less callers."""

    def __init__(self, weights: dict[str, float] | None = None,
                 max_inflight: int = 2, max_queue: int = 64,
                 chips: int | None = None, device=None):
        self.device = default_device(device)
        if weights is None:
            weights = DEVICE_DISPATCH_WEIGHTS
        n = int(chips) if chips else mesh.chip_count(self.device)
        self._seq = 0
        # probe ramp of a lost chip (configure: device_probe_interval)
        self._probe_base = 0.05
        self._probe_cap = 1.0
        self.shard_min_words = _SHARD_MIN_WORDS
        self.util_window = 10.0     # utilization-integral window (s)
        # continuous dispatch stream (device.stream): mode + geometry;
        # "stream" is the default, "flush" the accumulate-and-flush
        # batcher
        self.dispatch_mode = "stream"
        self.stream_interval = 100e-6   # admission-loop idle tick (s)
        self.stream_slot_words = 1 << 19  # slot-group geometry cap
        self.stream_max_slots = 4         # in-flight slots per chip
        # per-tenant dmClock rows the stream orders admission by
        self.tenant_qos: dict[str, tuple] = {}
        self.chips: list[ChipRuntime] = [
            ChipRuntime(self, i, weights, max_inflight, max_queue)
            for i in range(max(1, n))]

    # -- lifecycle ---------------------------------------------------------

    # instances of synchronous callers (no running loop), per device
    _sync: dict[str, "DeviceRuntime"] = {}

    @classmethod
    def _registry(cls) -> dict:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return cls._sync
        reg = getattr(loop, "_ceph_tpu_torch_runtimes", None)
        if reg is None:
            reg = {}
            loop._ceph_tpu_torch_runtimes = reg
        return reg

    @classmethod
    def get(cls, device=None) -> "DeviceRuntime":
        """The running loop's instance for `device` (default: the card);
        its lifetime tracks the loop's.  Synchronous callers with no
        running loop share a process-wide instance per device."""
        dev = default_device(device)
        reg = cls._registry()
        inst = reg.get(str(dev))
        if inst is None:
            inst = cls(device=dev)
            reg[str(dev)] = inst
        return inst

    @classmethod
    def reset(cls, chips: int | None = None, device=None,
              **kwargs) -> "DeviceRuntime":
        """Fresh instance bound to the running loop for `device`;
        `chips` forces the logical mesh size."""
        inst = cls(chips=chips, device=device, **kwargs)
        cls._registry()[str(inst.device)] = inst
        return inst

    def configure(self, conf) -> None:
        """Adopt daemon config (OSD boot): per-chip queue bounds, probe
        ramp, mesh shard threshold, utilization window, the stream's
        mode and geometry, per-tenant admission rows and the batcher's
        flush triggers.  Missing keys leave a setting as it is."""
        try:
            max_inflight = max(1, int(conf["device_max_inflight"]))
            max_queue = int(conf["device_queue_len"])
            for c in self.chips:
                c.queue.max_inflight = max_inflight
                c.queue.max_queue = max_queue
            self.probe_interval = float(conf["device_probe_interval"])
            self._probe_base = self.probe_interval / 4.0
            self._probe_cap = self.probe_interval
        except (KeyError, TypeError):
            pass
        try:
            self.shard_min_words = max(
                _MIN_BUCKET, int(conf["device_shard_min_words"]))
        except (KeyError, TypeError, ValueError):
            pass
        try:
            self.util_window = max(
                0.1, float(conf["device_util_window"]))
        except (KeyError, TypeError, ValueError):
            pass
        try:
            self.dispatch_mode = str(conf["device_dispatch_mode"])
            self.stream_interval = max(
                1e-6, int(conf["device_stream_interval_us"]) / 1e6)
            self.stream_slot_words = max(
                _MIN_BUCKET, int(conf["device_stream_slot_words"]))
            self.stream_max_slots = max(
                1, int(conf["device_stream_max_slots"]))
        except (KeyError, TypeError, ValueError):
            pass
        try:
            self.tenant_qos = parse_tenant_qos(
                str(conf.get("osd_mclock_tenant_qos", "") or ""))
        except Exception:
            pass
        # the running loop's flush batcher adopts the window/size
        # triggers (the stream ignores both)
        try:
            from ..ec.batcher import DeviceBatcher
            bat = DeviceBatcher.get()
            bat.window_us = max(1, int(conf["ec_batch_flush_us"]))
            bat.max_batch_bytes = max(
                1 << 12, int(conf["ec_batch_max_bytes"]))
        except (KeyError, TypeError, ValueError, RuntimeError):
            pass

    # -- mesh placement ----------------------------------------------------

    def chip(self, index: int | None = None) -> ChipRuntime:
        """Chip by index (modulo the mesh), or the default chip."""
        return self.chips[int(index or 0) % len(self.chips)]

    def chip_for(self, osd_id: int) -> ChipRuntime:
        """The chip OSD `osd_id` binds to: deterministic modulo
        affinity, so co-located daemons land on distinct chips and a
        chip loss takes a knowable OSD subset."""
        return self.chips[mesh.affinity(osd_id, len(self.chips))]

    def route(self, chip: int | None) -> ChipRuntime:
        """Resolve a dispatch target.  An explicit chip is honoured
        even while lost (the caller's chip is its isolation domain: its
        ops fail there rather than borrow a neighbour); None picks the
        first available chip and raises DeviceLost when every chip is
        lost."""
        if chip is not None:
            return self.chip(chip)
        for c in self.chips:
            if c.available:
                return c
        raise DeviceLost("every chip of the mesh is lost (%s)"
                         % self.lost_reason)

    def chip_available(self, chip: int | None = None) -> bool:
        """An explicit chip's state, or whether any chip is available."""
        if chip is not None:
            return self.chip(chip).available
        return self.available

    def available_chips(self) -> list[ChipRuntime]:
        return [c for c in self.chips if c.available]

    def shard_plan(self, chip: ChipRuntime, n_words: int,
                   unit: int = 1) -> list[tuple[ChipRuntime, int, int]]:
        """Column ranges for one flush: [(chip, lo, hi)].  A flush at
        or above `shard_min_words` (columns times `unit` words a
        column) splits contiguously across the owning chip plus every
        other available chip and reassembles bit-identically (GF parity
        is column-independent).  Below the threshold (or with one chip
        to use) the plan is the single owning chip."""
        n_words = int(n_words)
        targets = [chip] + [c for c in self.chips
                            if c.available and c is not chip]
        if (n_words * unit < self.shard_min_words
                or len(targets) == 1):
            return [(chip, 0, n_words)]
        per = -(-n_words // len(targets))       # ceil
        plan = []
        lo = 0
        for c in targets:
            hi = min(n_words, lo + per)
            if hi <= lo:
                break
            plan.append((c, lo, hi))
            lo = hi
        return plan

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # -- shape buckets -----------------------------------------------------

    @staticmethod
    def bucket_for(n_words: int, min_bucket: int | None = None) -> int:
        """Pad target: next power of two >= n, floored at `min_bucket`
        (default _MIN_BUCKET) so micro-flushes share one bucket."""
        n = max(int(n_words), min_bucket or _MIN_BUCKET)
        return 1 << (n - 1).bit_length()

    @classmethod
    def ragged_plan(cls, n_words: int,
                    max_segments: int | None = None,
                    min_bucket: int | None = None
                    ) -> list[tuple[int, int]]:
        """Bucket ladder for one ragged flush: [(lo, segment_bucket)]
        covering `n_words` columns with power-of-two segments.  Only
        the ladder's TAIL rounds up — greedy largest-pow2-first, final
        remainder to its own bucket.  When the ladder would pad as much
        as the single pow2 bucket it degenerates to that bucket (one
        dispatch beats several for equal padding).  `min_bucket`
        (default _MIN_BUCKET) floors the buckets: a bitmatrix family's
        columns are whole windows, so it stages from one."""
        n = max(int(n_words), 1)
        floor = min_bucket or _MIN_BUCKET
        single = cls.bucket_for(n, floor)
        cap = max_segments or _RAGGED_MAX_SEGMENTS
        plan: list[tuple[int, int]] = []
        lo = 0
        remaining = n
        while len(plan) < cap - 1 and remaining > floor:
            p = 1 << (remaining.bit_length() - 1)
            plan.append((lo, p))
            lo += p
            remaining -= p
        if remaining > 0:
            b = cls.bucket_for(remaining, floor)
            plan.append((lo, b))
            lo += b
        if lo >= single:
            return [(0, single)]
        return plan

    async def warmup_ec(self, matrix, w: int,
                        buckets: tuple = (1024, 4096, 16384),
                        chip: int | None = None) -> None:
        """Run one GF(2^w) coding matrix's common buckets once on a chip
        at boot (the caller's, else the first available): each builds
        the kernel library at first use and launches K1 (w=8) or K2, so
        the first client flushes find their bucket accounted.  A
        failure marks the chip lost and returns; nothing is encoded
        elsewhere.  A codec's families are `device_families()`."""
        from ..ec.batcher import BitmatrixFamily, DeviceBatcher
        if isinstance(w, BitmatrixFamily):
            raise ValueError("warmup_ec takes a GF(2^w) matrix family")
        try:
            target = self.route(chip)
        except DeviceLost:
            return
        w = int(w)
        matrix_key = tuple(tuple(int(v) for v in r) for r in matrix)
        k = len(matrix_key[0])
        dtype = {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}[w]
        for b in buckets:
            if not target.available:
                return
            key = ("ec", matrix_key, w, int(b))
            if key in target.programs:
                continue
            buf = target.pool.lease((k, int(b)), dtype)
            try:
                enc = DeviceBatcher._encoder(matrix_key, w,
                                             str(target.device))
                DeviceBatcher._run(enc, target.place(buf)).cpu()
            except Exception as e:
                target.pool.drop(buf)
                target.poison(e)
                return
            target.pool.release(buf)
            target.note_program("ec", (matrix_key, w, int(b)))
            await asyncio.sleep(0)      # yield between buckets

    # -- aggregate views ---------------------------------------------------

    def _sum(self, attr: str) -> int:
        return sum(getattr(c, attr) for c in self.chips)

    @property
    def bucket_waste_ratio(self) -> float:
        """Mesh-aggregate staging waste: padded words that carried no
        payload over total staged capacity."""
        pay = self._sum("staged_payload_words")
        pad = self._sum("staged_pad_words")
        return pad / (pay + pad) if (pay + pad) else 0.0

    @property
    def compile_count(self) -> int:
        return self._sum("compile_count")

    @property
    def bucket_hits(self) -> int:
        return self._sum("bucket_hits")

    @property
    def loss_count(self) -> int:
        return self._sum("loss_count")

    @property
    def heal_count(self) -> int:
        return self._sum("heal_count")

    @property
    def lost(self) -> bool:
        """Whole-mesh loss: every chip lost (per chip: `chips[i].lost`)."""
        return all(c.lost for c in self.chips)

    @property
    def lost_reason(self) -> str | None:
        for c in self.chips:
            if c.lost_reason:
                return c.lost_reason
        return None

    @property
    def available(self) -> bool:
        return any(c.available for c in self.chips)

    def add_listener(self, fn) -> None:
        """Mesh-wide listener: fires on every chip's transition."""
        for c in self.chips:
            c.add_listener(fn)

    def poison(self, reason) -> None:
        """Whole-mesh loss: every chip is marked lost."""
        for c in self.chips:
            c.poison(reason)

    def heal(self) -> None:
        for c in self.chips:
            c.heal()

    def inject_fault(self, n: int = 1) -> None:
        """Arm n failures on EVERY chip (the whole-device loss shape);
        one chip's is `chips[i].inject_fault`."""
        for c in self.chips:
            c.inject_fault(n)

    def clear_faults(self) -> None:
        for c in self.chips:
            c.clear_faults()

    def dispatch_pctls(self) -> dict:
        """p50/p99 (ms) of device time over every chip's ticket ring."""
        samples = sorted(t.device_s for c in self.chips
                         for t in c.tickets if t.ok)
        if not samples:
            return {"n": 0}
        n = len(samples)

        def at(p):
            return round(samples[min(n - 1, int(p / 100.0 * n))] * 1e3,
                         4)

        return {"n": n, "p50": at(50), "p99": at(99)}

    def metrics(self) -> dict:
        """Mesh-aggregate metric map."""
        return {
            "device_chips": len(self.chips),
            "device_queue_depth": sum(c.queue.depth for c in self.chips),
            "device_inflight": sum(c.queue.inflight for c in self.chips),
            "device_bucket_waste_ratio": round(self.bucket_waste_ratio,
                                               4),
            "device_compile_count": self.compile_count,
            "device_dispatches": self._sum("dispatches"),
            "device_pool_hits": sum(c.pool.hits for c in self.chips),
            "device_pool_misses": sum(c.pool.misses for c in self.chips),
            "device_queue_rejected": sum(c.queue.rejected
                                         for c in self.chips),
            "device_lost": int(self.lost),
            "device_loss_count": self.loss_count,
            "device_heal_count": self.heal_count,
            "device_lost_chips": sum(1 for c in self.chips if c.lost),
        }

    def prom_lines(self, prefix: str = "ceph_tpu") -> list[str]:
        """Prometheus exposition lines: every chip's series carries a
        ``chip`` label, beside the unlabeled mesh-size gauge; each
        family's TYPE is emitted once across chips."""
        from ..utils.exporter import hist_lines
        lines = ["# HELP %s_device_chips chips in the device mesh"
                 % prefix,
                 "# TYPE %s_device_chips gauge" % prefix,
                 "%s_device_chips %d" % (prefix, len(self.chips))]
        typed: set[str] = set()
        hist_typed: set[str] = set()
        for c in self.chips:
            label = 'chip="%d"' % c.index
            for name, val in sorted(c.metrics().items()):
                base = "%s_%s" % (prefix, name)
                if base not in typed:
                    typed.add(base)
                    lines.append("# HELP %s per-chip %s" % (base, name))
                    lines.append("# TYPE %s gauge" % base)
                lines.append("%s{%s} %g" % (base, label, float(val)))
            lines.extend(hist_lines(
                "%s_device_dispatch_seconds" % prefix,
                c.dispatch_buckets_us, labels=label,
                typed=hist_typed,
                desc="per-chip dispatch device time "
                     "(us pow2 buckets)"))
        return lines
