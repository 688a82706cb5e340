"""Device EC dispatch with cross-object batching.

Counterpart of ceph_tpu/ec/batcher.py.  4 KiB stripes are tiny against
launch and copy latency: the card only pays off when many in-flight
stripes ride one dispatch, so this layer aggregates them.

Two dispatch architectures share this module's staging/encode path:

* **stream** (``DeviceRuntime.dispatch_mode == "stream"``, the
  default): `encode` is a thin enqueue shim onto the caller chip's
  persistent dispatch stream (device.stream), whose slot dispatches
  call back into `stream_dispatch` below;
* **flush**: concurrent `encode` calls in the same event loop are
  queued per (coding matrix, w, service class, chip, device) key and
  flushed as ONE dispatch — when the pending payload reaches
  `max_batch_bytes` or when the oldest entry has waited `window_us`.

Every dispatch routes through the per-chip runtime (device.runtime):

* the batch is **ragged**: items of heterogeneous width pack
  contiguously along the column axis, and the total stages across a
  pow2 **bucket ladder** (``DeviceRuntime.ragged_plan``), so only the
  ladder's tail rounds up (zero padding is exact under GF linearity:
  parity columns of the pad are zeros that are sliced off);
* admission is weighted-fair across classes with bounded in-flight
  dispatches per chip;
* an oversized flush shards column-wise across the chips and
  reassembles bit-identically;
* each dispatch carries a DispatchTicket delivered to per-item
  `on_ticket` callbacks.

Nothing here re-encodes on the host.  A full admission queue
(DeviceBusy) or a failed launch fails the awaiting futures with
IOError, as the reference does for a host-codec error.

Decode/reconstruct rides the same queue: a reconstruction is an encode
with the cached inverted matrix, so degraded reads and recovery batch
with ordinary writes.

Two product families ride it, keyed apart so they never share a batch:
GF(2^w) matrices over w-bit words (``w`` an int; K1 or K2), and the
jerasure bitmatrix codes (``w`` a ``BitmatrixFamily(w, packetsize)``;
K3 through ``BitmatrixEncoder``), whose items are (k, nw,
w*packetsize) chunk windows and whose columns are windows.
"""

from __future__ import annotations

import asyncio
import functools
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device.runtime import DeviceRuntime, K_CLIENT_EC
from .kernels import (BitmatrixEncoder, DeviceEncoder, FusedEncoder,
                      reconstruction)

_WORD_DTYPE = {8: np.uint8, 16: np.uint16, 32: np.uint32}
_TORCH_WORD = {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}


class BitmatrixFamily(NamedTuple):
    """The product family of a jerasure bitmatrix code, passed where a
    GF(2^w) job passes its word width: its items are (k, nw,
    w*packetsize) uint8 chunk windows, a column is one window, and the
    product runs on K3 (``BitmatrixEncoder.run_windows``)."""
    w: int
    packetsize: int


def family(w):
    """A job's family key: the int word width of a GF(2^w) matrix, or a
    BitmatrixFamily."""
    return w if isinstance(w, BitmatrixFamily) else int(w)


def column_bytes(w) -> int:
    """Bytes one column of a family's item holds in each row: a word,
    or a window of w*packetsize bytes."""
    if isinstance(w, BitmatrixFamily):
        return w.w * w.packetsize
    return int(w) // 8


def tenant_label(tenants) -> str | None:
    """A dispatch's tenant attribution: the one tenant every batched
    item agreed on, "mixed" when several tenants' stripes share the
    dispatch, None for tenant-less work."""
    distinct = {t for t in tenants if t is not None}
    if not distinct:
        return None
    if len(distinct) == 1:
        return next(iter(distinct))
    return "mixed"


class _PendingBatch:
    __slots__ = ("arrays", "futures", "tickets", "tenants", "n_words",
                 "timer", "t_first")

    def __init__(self):
        self.arrays: list[np.ndarray] = []   # each [k, n_i] words
        self.futures: list[asyncio.Future] = []
        self.tickets: list = []              # per-item on_ticket cbs
        self.tenants: list = []              # per-item tenant keys
        self.n_words = 0
        self.timer = None
        # first item's arrival: the flush ticket's t_enqueue, so
        # queue_wait includes the batch-window wait
        self.t_first = time.monotonic()

    def tenant_label(self) -> str | None:
        return tenant_label(self.tenants)


class DeviceBatcher:
    """Batches GF(2^w) region products across concurrent callers.

    One instance per event loop (get() is loop-local); flush keys are
    (matrix-tuple, w, klass, chip, device)."""

    def __init__(self, window_us: int = 300,
                 max_batch_bytes: int = 8 << 20):
        self.window_us = window_us
        self.max_batch_bytes = max_batch_bytes
        self._pending: dict[tuple, _PendingBatch] = {}
        self._tasks: set = set()
        self.batches_flushed = 0
        self.sharded_flushes = 0

    @classmethod
    def get(cls) -> "DeviceBatcher":
        """Per-event-loop instance, stored ON the running loop so its
        lifetime tracks the loop's."""
        loop = asyncio.get_running_loop()
        inst = getattr(loop, "_ceph_tpu_torch_ec_batcher", None)
        if inst is None:
            inst = cls()
            loop._ceph_tpu_torch_ec_batcher = inst
        return inst

    @staticmethod
    @functools.lru_cache(maxsize=256)
    def _encoder(matrix_key: tuple, w, device: str):
        """The kernel for one (matrix, w) on one device: K1
        (FusedEncoder) for w=8, K2 (DeviceEncoder) for w=16/32 and for
        w=8 under CEPH_TPU_EC_FUSED=0, K3 (BitmatrixEncoder) for a
        bitmatrix family."""
        matrix = [list(row) for row in matrix_key]
        if isinstance(w, BitmatrixFamily):
            return BitmatrixEncoder(matrix, w.w, device)
        if w == 8 and os.environ.get("CEPH_TPU_EC_FUSED") != "0":
            return FusedEncoder(matrix, device)
        return DeviceEncoder(matrix, w, device)

    @staticmethod
    def _run(enc, data: torch.Tensor) -> torch.Tensor:
        """[k, n] words (or [k, n, window] bytes) on the device -> [m, n]
        (or [m, n, window]) on the device."""
        if isinstance(enc, BitmatrixEncoder):
            return enc.run_windows(data)
        if isinstance(enc, FusedEncoder):
            # byte layout as little-endian uint32 lanes (n is a bucket,
            # a power of two >= 512, so a multiple of 4)
            return enc.run32(data.view(torch.uint32)).view(torch.uint8)
        return enc(data)

    async def encode(self, matrix: list[list[int]], w,
                     data: np.ndarray, klass: str = K_CLIENT_EC,
                     on_ticket=None, chip: int | None = None,
                     tenant: str | None = None,
                     device=None) -> np.ndarray:
        """data [k, n] words -> [m, n] parity words, batched with any
        concurrent callers using the same (matrix, w, klass, chip) on
        `device` (default: the card).  For a bitmatrix code, `matrix`
        is its 0/1 bitmatrix, `w` its BitmatrixFamily and data [k, nw,
        w*packetsize] chunk windows -> [m, nw, w*packetsize].

        `on_ticket` (if given) receives the dispatch's DispatchTicket
        (the primary shard's ticket when the flush sharded across the
        mesh).  Raises IOError when the dispatch failed."""
        rt = DeviceRuntime.get(device)
        if rt.dispatch_mode == "stream":
            return await rt.route(chip).stream.encode(
                matrix, family(w), np.ascontiguousarray(data),
                klass, on_ticket=on_ticket, tenant=tenant)
        matrix_key = (matrix if isinstance(matrix, tuple)
                      else tuple(tuple(r) for r in matrix))
        key = (matrix_key, family(w), klass,
               None if chip is None else int(chip), str(rt.device))
        loop = asyncio.get_running_loop()
        pb = self._pending.get(key)
        if pb is None:
            pb = _PendingBatch()
            self._pending[key] = pb
        fut = loop.create_future()
        pb.arrays.append(np.ascontiguousarray(data))
        pb.futures.append(fut)
        pb.tickets.append(on_ticket)
        pb.tenants.append(tenant)
        pb.n_words += data.shape[1]
        if (pb.n_words * data.shape[0] * column_bytes(w)
                >= self.max_batch_bytes):
            self._flush(key)
        elif pb.timer is None:
            pb.timer = loop.call_later(self.window_us / 1e6,
                                       self._flush, key)
        return await fut

    def _flush(self, key) -> None:
        """Detach the pending batch and dispatch it as a task."""
        pb = self._pending.pop(key, None)
        if pb is None:
            return
        if pb.timer is not None:
            pb.timer.cancel()
        task = asyncio.get_running_loop().create_task(
            self._flush_async(key, pb))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _device_dispatch(self, rt, target, matrix_key, w,
                               klass: str, parts: list[np.ndarray],
                               n: int, tenant: str | None,
                               t_enqueue: float | None,
                               stream: bool):
        """The device path both architectures ride: shard plan ->
        single-chip or mesh-sharded encode.  Returns (out, ticket);
        raises when the dispatch failed."""
        w = family(w)
        plan = rt.shard_plan(target, n, column_bytes(w))
        if len(plan) == 1:
            return await self._encode_shard(
                target, matrix_key, w, klass, parts, n,
                tenant=tenant, t_enqueue=t_enqueue, stream=stream)
        return await self._encode_sharded(
            plan, matrix_key, w, klass, parts,
            tenant=tenant, t_enqueue=t_enqueue, stream=stream)

    async def stream_dispatch(self, chip, matrix_key, w,
                              klass: str, parts: list[np.ndarray],
                              n: int, tenant: str | None = None,
                              t_enqueue: float | None = None):
        """One stream slot's dispatch (device.stream DispatchStream):
        the same device path flushes ride.  Returns (out, ticket);
        raises when the dispatch failed."""
        out, ticket = await self._device_dispatch(
            chip.rt, chip, matrix_key, w, klass, parts, n, tenant,
            t_enqueue, stream=True)
        self.batches_flushed += 1
        return out, ticket

    async def _flush_async(self, key, pb: _PendingBatch) -> None:
        matrix_key, w, klass, chip_idx, device = key
        rt = DeviceRuntime.get(device)
        try:
            out, ticket = await self._device_dispatch(
                rt, rt.route(chip_idx), matrix_key, w, klass,
                pb.arrays, pb.n_words, pb.tenant_label(), pb.t_first,
                stream=False)
        except Exception as e:
            # the awaiting callers must see the failure, never hang
            for fut in pb.futures:
                if not fut.done():
                    fut.set_exception(IOError("EC encode failed: %r" % e))
            return
        self.batches_flushed += 1
        self._deliver(pb, out, ticket)

    @staticmethod
    def _deliver(pb: _PendingBatch, out: np.ndarray, ticket) -> None:
        off = 0
        for arr, fut, cb in zip(pb.arrays, pb.futures, pb.tickets):
            ni = arr.shape[1]
            if not fut.done():
                fut.set_result(out[:, off:off + ni])
            if cb is not None:
                try:
                    cb(ticket)
                except Exception:
                    pass    # attribution must never sink the flush
            off += ni

    async def _encode_shard(self, chip, matrix_key, w,
                            klass: str, parts: list[np.ndarray],
                            n: int, tenant: str | None = None,
                            t_enqueue: float | None = None,
                            stream: bool = False):
        """One chip's slice of a flush: admit on the chip's queue,
        stage the ragged total into its pooled bucket-ladder buffers,
        dispatch on its device.  Returns (parity [m, n], ticket).

        Items pack contiguously along the column axis across a bucket
        ladder of pow2 segments, each staged in its own pinned buffer;
        only the ladder's tail rounds up, and GF parity is
        column-independent, so the segment split is exact.  Items may
        span segment boundaries; offsets stay global column offsets,
        so `_deliver`'s slicing is unchanged.  A bitmatrix family's
        columns are whole windows (its ladder starts at one window), so
        each segment permutes to bit-rows on its own.  DeviceBusy and
        launch failures propagate to the caller."""
        bitmatrix = isinstance(w, BitmatrixFamily)
        dtype = torch.uint8 if bitmatrix else _TORCH_WORD[w]
        tail = tuple(parts[0].shape[2:])
        k = parts[0].shape[0]
        plan = chip.rt.ragged_plan(n, min_bucket=1 if bitmatrix else None)
        padded = sum(seg for _lo, seg in plan)
        ticket = chip.open_ticket(klass, padded,
                                  n * k * column_bytes(w),
                                  tenant=tenant, t_enqueue=t_enqueue,
                                  stream=stream)
        await chip.admit(ticket)
        bufs: list[torch.Tensor] = []
        ok = False
        try:
            for _lo, seg in plan:
                bufs.append(chip.pool.lease((k, seg) + tail, dtype))
            # pack items contiguously across the ladder (an item can
            # straddle two segments); leased buffers come back zeroed
            # so segment tails are exact GF zero columns
            views = [b.numpy() for b in bufs]
            si, soff = 0, 0
            for arr in parts:
                ni, pos = arr.shape[1], 0
                while pos < ni:
                    take = min(plan[si][1] - soff, ni - pos)
                    views[si][:, soff:soff + take] = arr[:, pos:pos + take]
                    soff += take
                    pos += take
                    if soff == plan[si][1]:
                        si += 1
                        soff = 0
            chip.launch(ticket)
            enc = self._encoder(matrix_key, w, str(chip.device))
            outs = []
            used = n
            for (_lo, seg), buf in zip(plan, bufs):
                chip.note_program("ec", (matrix_key, w, seg))
                u = min(seg, used)
                outs.append(self._run(enc, chip.place(buf))[:, :u])
                used -= u
            dev_out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
            # the copy back waits for the stream, so the staging
            # buffers are free to reuse once it returns
            out = dev_out.cpu().numpy()
            chip.finish(ticket, ok=True)
            chip.note_staging(n, padded)
            ok = True
            return out, ticket
        except Exception as e:
            chip.finish(ticket, ok=False, error=e)
            raise
        finally:
            for buf in bufs:
                if ok:
                    chip.pool.release(buf)
                else:
                    chip.pool.drop(buf)

    async def _encode_sharded(self, plan, matrix_key, w,
                              klass: str, arrays: list[np.ndarray],
                              tenant: str | None = None,
                              t_enqueue: float | None = None,
                              stream: bool = False):
        """Mesh-shard one oversized flush across the plan's chips:
        contiguous column slices encode concurrently and reassemble
        bit-identically.  Returns (parity, primary ticket)."""
        flat = (arrays[0] if len(arrays) == 1
                else np.concatenate(arrays, axis=1))
        self.sharded_flushes += 1
        parts = await asyncio.gather(*[
            self._encode_shard(chip, matrix_key, w, klass,
                               [flat[:, lo:hi]], hi - lo,
                               tenant=tenant, t_enqueue=t_enqueue,
                               stream=stream)
            for chip, lo, hi in plan])
        out = np.concatenate([p for p, _t in parts], axis=1)
        return out, parts[0][1]


def reconstruct_matrix(k: int, w: int, matrix: list[list[int]],
                       erased: tuple[int, ...],
                       have: tuple[int, ...]):
    """(rows, chosen): rows rebuild `erased` chunks directly from the
    `chosen` survivors (kernels.reconstruction).  Cached per erasure
    signature so a recovery sweep pays the O(k^3) GF inversion once,
    like ErasureCodeIsaTableCache."""
    key = (k, w, tuple(tuple(r) for r in matrix), erased, have)
    return _reconstruct_matrix_cached(key)


@functools.lru_cache(maxsize=512)
def _reconstruct_matrix_cached(key):
    k, w, matrix_t, erased, have = key
    return reconstruction([list(r) for r in matrix_t], k, w, erased, have)
