"""The scrub digest plane of ceph_tpu_torch against the JAX package.

`digest_lanes` against the reference's jitted program on the same
staged lanes, the tables and host helpers against the reference's,
and `crc32_batch(device="cpu")` against zlib: the reference's length
classes, buffers over a lane, and a buffer over one dispatch's
staging bound, which splits into several dispatches.  No route
reaches a host oracle: a full queue fails with DeviceBusy, a failed
dispatch with IOError, and the reference's environment switches
change nothing.  Integer functions: every comparison is exact.
"""

import asyncio
import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.device import digest as ref
from ceph_tpu_torch.device import digest as dg
from ceph_tpu_torch.device.runtime import DeviceBusy, DeviceRuntime

torch.set_num_threads(1)

CPU = torch.device("cpu")
# tests/test_scrub.py's length classes
SIZES = (0, 1, 3, 7, 255, 256, 257, 1000, 4096, 4097, 12345)


def _bufs(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
            for s in sizes]


def run(coro):
    return asyncio.run(coro)


@pytest.mark.parametrize("width", [256, 16384])
def test_digest_lanes_equal_reference_program(width):
    """The torch body equals the reference's jitted `_kernel` bit for
    bit; the bytes past each lane's length are random, not zero, so
    the mask is what keeps them out."""
    lanes = 8
    rng = np.random.default_rng(width)
    stage = rng.integers(0, 256, (lanes, width), dtype=np.uint8)
    lens = np.array([0, 1, 7, width // 3, width // 2 + 1, width - 1,
                     width, 255], np.int32)
    want = np.asarray(ref._kernel(lanes, width)(
        jnp.asarray(stage), jnp.asarray(lens),
        jnp.asarray(ref._tables(width)[0])))
    got = dg.digest_lanes(torch.from_numpy(stage), torch.from_numpy(lens),
                          dg._device_table(width, CPU))
    got = got.numpy().view(np.uint32)
    assert np.array_equal(got, want)
    z = dg._tables(width)[1]
    assert [int(g) ^ int(z[n]) for g, n in zip(got, lens)] == [
        zlib.crc32(stage[i, :n].tobytes()) for i, n in enumerate(lens)]


def test_tables_and_host_helpers_equal_reference():
    assert (dg.DEVICE_MAX_BYTES, dg.DEVICE_MAX_STAGE_BYTES) == (
        ref.DEVICE_MAX_BYTES, ref.DEVICE_MAX_STAGE_BYTES)
    assert np.array_equal(dg._byte_table(), ref._byte_table())
    for width in (256, 1024):
        for mine, theirs in zip(dg._tables(width), ref._tables(width)):
            assert np.array_equal(mine, theirs)
    bufs = _bufs(3, SIZES)
    assert dg.crc32_host(bufs) == ref.crc32_host(bufs)
    rng = random.Random(5)
    for _ in range(20):
        a = rng.randbytes(rng.randrange(0, 3000))
        b = rng.randbytes(rng.randrange(0, 40000))
        ca, cb = zlib.crc32(a), zlib.crc32(b)
        got = dg.crc32_combine(ca, cb, len(b))
        assert got == ref.crc32_combine(ca, cb, len(b))
        assert got == zlib.crc32(a + b)


def test_crc32_batch_length_classes_and_folded_buffers():
    """The reference's length classes in one dispatch, and buffers
    over a lane folded from their segments, all on the device path."""
    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        bufs = _bufs(11, SIZES)
        out, path = await dg.crc32_batch(bufs, device="cpu")
        assert path == "device"
        assert out == [zlib.crc32(b) for b in bufs]
        rng = np.random.default_rng(12)
        big = [b"x" * (dg.DEVICE_MAX_BYTES + 1),
               rng.integers(0, 256, 3 * dg.DEVICE_MAX_BYTES + 17,
                            dtype=np.uint8).tobytes(), b"", b"z"]
        out, path = await dg.crc32_batch(big, chip=1, device="cpu")
        assert path == "device"
        assert out == [zlib.crc32(b) for b in big]
        chip = rt.chips[0]
        assert chip.dispatches == 2
        assert chip.programs == {("crc32", 16, 16384), ("crc32", 8, 16384)}
        assert chip.queue.inflight == 0 and chip.pool.outstanding == 0

    run(main())


def test_crc32_batch_over_the_staging_bound_splits():
    """A buffer whose segments stage more than DEVICE_MAX_STAGE_BYTES
    stays on the device in several dispatches (the reference took the
    host loop), with zlib's digest."""
    huge = [b"y" * (dg.DEVICE_MAX_STAGE_BYTES + 1), b"abc"]

    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        out, path = await dg.crc32_batch(huge, device="cpu")
        return rt.chips[0], out, path

    chip, out, path = run(main())
    assert path == "device"
    assert out == [zlib.crc32(b) for b in huge]
    assert chip.dispatches == 2
    # 2048 lanes x 16 KiB is exactly the bound
    assert chip.programs == {("crc32", 2048, 16384), ("crc32", 8, 16384)}


def test_empty_batches_dispatch_nothing():
    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        assert await dg.crc32_batch([], device="cpu") == ([], "host")
        assert await dg.crc32_batch([b"", b""], device="cpu") == (
            [0, 0], "host")
        return rt.chips[0].dispatches

    assert run(main()) == 0


def test_full_queue_fails_with_device_busy(monkeypatch):
    monkeypatch.setattr(dg, "crc32_host", _no_host)

    async def main():
        rt = DeviceRuntime.reset(device="cpu", max_inflight=1,
                                 max_queue=0)
        rt.chips[0].queue.inflight = 1      # a dispatch holds the card
        with pytest.raises(DeviceBusy):
            await dg.crc32_batch(_bufs(1, SIZES), device="cpu")
        return rt.chips[0]

    chip = run(main())
    assert chip.queue.rejected == 1 and chip.pool.outstanding == 0


def test_failed_dispatch_fails_with_ioerror(monkeypatch):
    def refused(*a, **kw):
        raise RuntimeError("digest: CUDA launch failed")

    monkeypatch.setattr(dg, "digest_lanes", refused)
    monkeypatch.setattr(dg, "crc32_host", _no_host)

    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        with pytest.raises(IOError, match="launch failed"):
            await dg.crc32_batch(_bufs(1, SIZES), device="cpu")
        return rt.chips[0]

    chip = run(main())
    assert chip.queue.inflight == 0 and chip.pool.outstanding == 0
    assert [t.ok for t in chip.tickets] == [False]


def _no_host(*a, **kw):
    raise AssertionError("host oracle reached from the async path")


def test_offload_switches_and_host_oracles_change_nothing(monkeypatch):
    """The reference's environment switches select nothing, and the
    async path never calls zlib or crc32_host."""
    bufs = _bufs(2, SIZES + (40000,))
    want = [zlib.crc32(b) for b in bufs]
    for var in ("CEPH_TPU_SCRUB_OFFLOAD", "CEPH_TPU_EC_OFFLOAD"):
        monkeypatch.setenv(var, "0")
    monkeypatch.setattr(dg, "crc32_host", _no_host)
    monkeypatch.setattr(zlib, "crc32", _no_host)
    out, path = run(dg.crc32_batch(bufs, device="cpu"))
    assert (out, path) == (want, "device")
