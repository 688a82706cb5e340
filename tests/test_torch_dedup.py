"""The dedup chunker of ceph_tpu_torch against the JAX package.

`candidate_mask` against the reference's jitted program on the same
staged segments, the numpy oracles and the chunk-oid helpers against
the reference's, and `boundary_batch` / `fingerprint_batch`
(device="cpu") against the reference's `chunk_host` and zlib, across
several dispatches.  No route reaches a host oracle: a full queue
fails with DeviceBusy, a failed dispatch with IOError, and the
reference's environment switches change nothing.  Every comparison
is exact.
"""

import asyncio
import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.dedup import chunker as ref
from ceph_tpu_torch import dedup
from ceph_tpu_torch.dedup import chunker as ch
from ceph_tpu_torch.device import digest
from ceph_tpu_torch.device.runtime import DeviceBusy, DeviceRuntime

torch.set_num_threads(1)


def run(coro):
    return asyncio.run(coro)


def _blobs(seed=11, n=9):
    """tests/test_dedup.py's batch: random sizes below 4 x CHUNK_AVG,
    plus an empty blob."""
    rng = random.Random(seed)
    return [rng.randbytes(rng.randrange(1, 4 * ch.CHUNK_AVG))
            for _ in range(n)] + [b""]


def test_constants_equal_reference():
    assert (ch.CHUNK_MIN, ch.CHUNK_AVG, ch.CHUNK_MAX, ch.SEG, ch.MARGIN,
            ch._MIX1, ch._MIX2, ch._MAGIC, ch._MIN_LANES, ch._MAX_LANES,
            ch.CHUNK_OID_PREFIX) == (
        ref.CHUNK_MIN, ref.CHUNK_AVG, ref.CHUNK_MAX, ref.SEG, ref.MARGIN,
        ref._MIX1, ref._MIX2, ref._MAGIC, ref._MIN_LANES, ref._MAX_LANES,
        ref.CHUNK_OID_PREFIX)
    assert ch.CHUNK_MAX == digest.DEVICE_MAX_BYTES


def test_candidate_mask_equals_reference_program():
    """Staged segments with margins, short bodies, an all-0xff body
    (the mix's largest grams) and a body crafted to hit."""
    lanes = 8
    rng = np.random.default_rng(21)
    blob = rng.integers(0, 256, 3 * ch.SEG + 1000, dtype=np.uint8)
    segs, _ns = ch._segments([blob.tobytes(), b"\xff" * ch.SEG,
                              b"short body"])
    stage = np.zeros((lanes, ch.MARGIN + ch.SEG), np.uint8)
    lens = ch._stage_segments(segs, lanes, stage)
    ref_stage = np.zeros_like(stage)
    assert np.array_equal(ref._stage_segments(segs, lanes, ref_stage), lens)
    assert np.array_equal(ref_stage, stage)
    want = np.asarray(ref._kernel(lanes)(jnp.asarray(stage),
                                         jnp.asarray(lens)))
    got = ch.candidate_mask(torch.from_numpy(stage), torch.from_numpy(lens))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert want.any()
    assert np.array_equal(ch._mask_lanes_host(stage, lens), want)
    assert np.array_equal(ref._mask_lanes_host(stage, lens), want)


def test_host_oracles_and_helpers_equal_reference():
    rng = random.Random(7)
    for size in (0, 1, ch.CHUNK_MIN - 1, ch.CHUNK_MIN, ch.CHUNK_AVG,
                 5 * ch.CHUNK_AVG + 137, 40 * ch.CHUNK_AVG):
        data = rng.randbytes(size)
        mask = ch.candidate_mask_host(data)
        assert np.array_equal(mask, ref.candidate_mask_host(data))
        cuts = ch.chunk_host(data)
        assert cuts == ref.chunk_host(data)
        assert cuts == ch.resolve_cuts(mask, size)
        assert ch.split(data, cuts) == ref.split(data, cuts)
    for data in (bytes(100000), b"abcdefgh" * 20000):   # forced cuts
        assert ch.chunk_host(data) == ref.chunk_host(data)
    fp = ch.fingerprint(0xDEADBEEF, 12345)
    assert fp == ref.fingerprint(0xDEADBEEF, 12345)
    assert ch.chunk_oid(fp) == ref.chunk_oid(fp)
    for oid in (ch.chunk_oid(fp), "rbd_data.1", "chunk.nothex00-10",
                "chunk.0011223344-10", "chunk.00112233-zz"):
        assert ch.parse_chunk_oid(oid) == ref.parse_chunk_oid(oid)


def test_boundary_and_fingerprint_batch_equal_reference():
    blobs = _blobs()

    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        cuts, path = await dedup.boundary_batch(blobs, device="cpu")
        chunks = [c for b, cc in zip(blobs, cuts) for c in ch.split(b, cc)]
        fps, fpath = await dedup.fingerprint_batch(chunks, chip=0,
                                                   device="cpu")
        return rt.chips[0], cuts, path, chunks, fps, fpath

    chip, cuts, path, chunks, fps, fpath = run(main())
    assert (path, fpath) == ("device", "device")
    assert cuts == [ref.chunk_host(b) for b in blobs]
    assert fps == [ref.fingerprint(zlib.crc32(c), len(c)) for c in chunks]
    for c in chunks[:-1]:
        assert len(c) <= ch.CHUNK_MAX
    m = chip.metrics()
    assert m["device_fingerprint_chunks"] == len(chunks)
    assert m["device_fingerprint_bytes"] == sum(map(len, blobs))
    assert chip.programs == {("cdc", 32, ch.MARGIN + ch.SEG),
                             ("crc32", 32, 16384)}


def test_boundary_batch_takes_lane_capped_dispatches():
    """40 segments of one blob plus a small one: a 32-lane and a
    16-lane dispatch, margins carried across segment boundaries."""
    rng = np.random.default_rng(5)
    blobs = [rng.integers(0, 256, 39 * ch.SEG + 77,
                          dtype=np.uint8).tobytes(), b"x" * 5000]

    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        cuts, path = await dedup.boundary_batch(blobs, device="cpu")
        return rt.chips[0], cuts, path

    chip, cuts, path = run(main())
    assert path == "device"
    assert cuts == [ref.chunk_host(b) for b in blobs]
    assert chip.programs == {("cdc", 32, ch.MARGIN + ch.SEG),
                             ("cdc", 16, ch.MARGIN + ch.SEG)}


def test_empty_batches_dispatch_nothing():
    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        a = await dedup.boundary_batch([], device="cpu")
        b = await dedup.boundary_batch([b"", b""], device="cpu")
        c = await dedup.fingerprint_batch([], device="cpu")
        return rt.chips[0], a, b, c

    chip, a, b, c = run(main())
    assert (a, b, c) == (([], "host"), ([[], []], "host"), ([], "host"))
    assert chip.dispatches == 0 and chip.fingerprint_chunks == 0


def _no_host(*a, **kw):
    raise AssertionError("host oracle reached from the async path")


def _forbid_host(monkeypatch):
    for name in ("candidate_mask_host", "_mask_lanes_host", "chunk_host"):
        monkeypatch.setattr(ch, name, _no_host)
    monkeypatch.setattr(digest, "crc32_host", _no_host)


def test_full_queue_fails_with_device_busy(monkeypatch):
    _forbid_host(monkeypatch)

    async def main():
        rt = DeviceRuntime.reset(device="cpu", max_inflight=1,
                                 max_queue=0)
        rt.chips[0].queue.inflight = 1
        with pytest.raises(DeviceBusy):
            await dedup.boundary_batch(_blobs(), device="cpu")
        with pytest.raises(DeviceBusy):
            await dedup.fingerprint_batch([b"chunk"], device="cpu")
        return rt.chips[0]

    chip = run(main())
    assert chip.queue.rejected == 2 and chip.fingerprint_chunks == 0


def test_failed_dispatch_fails_with_ioerror(monkeypatch):
    def refused(*a, **kw):
        raise RuntimeError("cdc: CUDA launch failed")

    _forbid_host(monkeypatch)
    monkeypatch.setattr(ch, "candidate_mask", refused)
    monkeypatch.setattr(digest, "digest_lanes", refused)

    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        with pytest.raises(IOError, match="launch failed"):
            await dedup.boundary_batch(_blobs(), device="cpu")
        # the failed dispatch lost the chip: heal it so the next one
        # reaches its program
        assert rt.chips[0].lost
        rt.heal()
        with pytest.raises(IOError, match="launch failed"):
            await dedup.fingerprint_batch([b"chunk"], device="cpu")
        return rt.chips[0]

    chip = run(main())
    assert chip.queue.inflight == 0 and chip.pool.outstanding == 0
    assert [t.ok for t in chip.tickets] == [False, False]
    assert chip.fingerprint_chunks == 0 and chip.loss_count == 2


def test_offload_switches_and_host_oracles_change_nothing(monkeypatch):
    blobs = _blobs(seed=3, n=4)
    want = [ref.chunk_host(b) for b in blobs]
    for var in ("CEPH_TPU_DEDUP_OFFLOAD", "CEPH_TPU_SCRUB_OFFLOAD",
                "CEPH_TPU_EC_OFFLOAD"):
        monkeypatch.setenv(var, "0")
    _forbid_host(monkeypatch)
    cuts, path = run(dedup.boundary_batch(blobs, device="cpu"))
    assert (cuts, path) == (want, "device")
    fps, fpath = run(dedup.fingerprint_batch(blobs, device="cpu"))
    assert fpath == "device"
    assert fps == [ref.fingerprint(zlib.crc32(b), len(b)) for b in blobs]
