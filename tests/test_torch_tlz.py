"""The compression plane of ceph_tpu_torch against the JAX package.

`match_plan` against the reference's jitted program on
tests/test_tlz.py's segments, the numpy oracles and the container
against the reference's, and `compress_async(device="cpu")` on the
seeded parity corpora, byte-equal to the reference's `compress_host`
(seed 0 hashes to the pinned corpus digest).  The registry's own
copy.  No route reaches a host oracle: a full queue fails with
DeviceBusy, a failed dispatch with IOError, and the reference's
environment switches change nothing.  Every comparison is exact.
"""

import asyncio
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu import compress as ref_compress
from ceph_tpu.compress import tlz as ref_tlz
from ceph_tpu.device import lzkernel as ref_lz
from ceph_tpu_torch import compress
from ceph_tpu_torch.compress import tlz
from ceph_tpu_torch.device import lzkernel as lz
from ceph_tpu_torch.device.runtime import DeviceBusy, DeviceRuntime

torch.set_num_threads(1)

T = lz.TLZ_BLOCK
# tests/test_tlz.py's pinned digest of the seed-0 parity corpus
_CORPUS_SHA = ("6b5a8a918a2b73648cdf56451168ba36e0e6ce3cd285582b0b595d"
               "576f27ab79")


def _parity_corpus(seed: int) -> list[bytes]:
    """tests/test_tlz.py's seeded mixed corpus: text, zero, random."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(10):
        size = int(rng.integers(1, 5 * T))
        kind = i % 3
        if kind == 0:
            unit = rng.integers(0x20, 0x7F, 16, dtype=np.uint8).tobytes()
            out.append((unit * (size // 16 + 1))[:size])
        elif kind == 1:
            out.append(bytes(size))
        else:
            out.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    return out


def _segments():
    """tests/test_tlz.py's plan-parity segments."""
    rng = np.random.default_rng(11)
    return [
        bytes(T),
        rng.integers(0, 256, T, dtype=np.uint8).tobytes(),
        (b"lorem ipsum dolor " * 400)[:T],
        rng.integers(0, 4, T, dtype=np.uint8).tobytes(),
        b"tail-block-shorter-than-width" * 9,
        b"\xff" * T,                        # the hash's largest gram
    ]


def run(coro):
    return asyncio.run(coro)


def test_format_constants_equal_reference():
    assert (lz.TLZ_BLOCK, lz.MAX_MATCH, lz.MIN_MATCH, lz._HBITS,
            lz._HASH_MUL, lz._MIN_LANES, lz._MAX_LANES) == (
        ref_lz.TLZ_BLOCK, ref_lz.MAX_MATCH, ref_lz.MIN_MATCH,
        ref_lz._HBITS, ref_lz._HASH_MUL, ref_lz._MIN_LANES,
        ref_lz._MAX_LANES)
    assert (tlz.MAGIC, compress.OBJ_ALGO_ATTR, compress.OBJ_SIZE_ATTR) == (
        ref_tlz.MAGIC, ref_compress.OBJ_ALGO_ATTR,
        ref_compress.OBJ_SIZE_ATTR)


def test_mul32_is_the_uint32_product():
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        np.array([0, 1, 0xFFFF, 0x10000, 2**32 - 1],
                                 np.uint64)])
    for c in (lz._HASH_MUL, np.uint32(0x85EBCA77)):
        want = (a.astype(np.uint32) * c).astype(np.int64)
        got = lz.mul32(torch.from_numpy(a.astype(np.int64)), int(c))
        assert np.array_equal(got.numpy(), want)


def test_match_plan_equals_reference_program_and_oracles():
    lanes = 8
    stage, lens = ref_lz._stage_blocks(_segments(), lanes)
    mine = lz._stage_blocks(_segments(), lanes)
    assert np.array_equal(mine[0], stage) and np.array_equal(mine[1], lens)
    want_c, want_m = (np.asarray(a) for a in ref_lz._kernel(lanes, T)(
        jnp.asarray(stage), jnp.asarray(lens)))
    got_c, got_m = lz.match_plan(torch.from_numpy(stage),
                                 torch.from_numpy(lens))
    assert got_c.dtype == got_m.dtype == torch.int32
    assert np.array_equal(got_c.numpy(), want_c)
    assert np.array_equal(got_m.numpy(), want_m)
    host_c, host_m = lz.match_plan_host(stage, lens)
    ref_c, ref_m = ref_lz.match_plan_host(stage, lens)
    assert np.array_equal(host_c, ref_c) and np.array_equal(host_m, ref_m)
    assert np.array_equal(host_c, want_c) and np.array_equal(host_m, want_m)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compress_async_equals_reference_host(seed):
    """compress_async on the seeded parity corpus: the reference's
    compress_host bytes, decoded by both decoders; seed 0 hashes to
    the pinned digest."""
    corpus = _parity_corpus(seed)

    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        sha = hashlib.sha256()
        for data in corpus:
            blob, path = await tlz.compress_async(data, device="cpu")
            assert path == "device"
            assert blob == ref_tlz.compress_host(data)
            assert tlz.decompress(blob) == data
            assert ref_tlz.decompress(blob) == data
            sha.update(blob)
        return rt.chips[0], sha.hexdigest()

    chip, digest = run(main())
    if seed == 0:
        assert digest == _CORPUS_SHA
    assert chip.dispatches == len(corpus)
    m = chip.metrics()
    assert m["device_compress_bytes_in"] == sum(map(len, corpus))
    assert m["device_compress_bytes_out"] > 0


def test_match_batch_takes_lane_capped_dispatches():
    """70 blocks: a 64-lane and an 8-lane dispatch, equal to the
    oracle; compress_host (planned 64 blocks at a time) equals the
    reference's one-shot plan."""
    rng = np.random.default_rng(7)
    text = rng.integers(0x20, 0x7F, 24, dtype=np.uint8).tobytes()
    data = b"".join(
        (text * 200)[:T] if i % 2 else
        rng.integers(0, 256, T, dtype=np.uint8).tobytes()
        for i in range(69)) + b"short tail" * 30
    segs = tlz._blocks_of(data)
    assert len(segs) == 70

    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        c, m, path = await lz.match_batch(segs, device="cpu")
        blob, _ = await tlz.compress_async(data, device="cpu")
        return rt.chips[0], c, m, path, blob

    chip, c, m, path, blob = run(main())
    want_c, want_m = lz.match_plan_host(*lz._stage_blocks(segs, len(segs)))
    assert path == "device"
    assert np.array_equal(c, want_c) and np.array_equal(m, want_m)
    assert chip.programs == {("tlz", 64, T), ("tlz", 8, T)}
    assert blob == tlz.compress_host(data) == ref_tlz.compress_host(data)


def test_empty_input_dispatches_nothing():
    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        blob, path = await tlz.compress_async(b"", device="cpu")
        c, m, mpath = await lz.match_batch([], device="cpu")
        return rt.chips[0], blob, path, c.shape, mpath

    chip, blob, path, shape, mpath = run(main())
    assert (blob, path) == (ref_tlz.compress_host(b""), "host")
    assert (shape, mpath) == ((0, T), "host")
    assert chip.dispatches == 0 and tlz.decompress(blob) == b""


def test_registry_equals_reference():
    for name in ("zlib", "lzma", "bz2", "tlz"):
        assert name in compress.available()
        mine, theirs = compress.create(name), ref_compress.create(name)
        data = b"registry round trip " * 500
        assert mine.name == name
        assert mine.compress(data) == theirs.compress(data)
        assert mine.decompress(theirs.compress(data)) == data
    assert set(compress.available()) == set(ref_compress.available())
    with pytest.raises(compress.CompressorError):
        compress.create("lz77")
    with pytest.raises(compress.CompressorError):
        compress.create("zlib").decompress(b"not zlib")


def test_decompress_rejects_corrupt_streams():
    blob = tlz.compress_host(_parity_corpus(0)[0])
    for bad in (blob[:len(blob) // 2], blob + b"trailing", blob[:12],
                b"XXXX" + blob[4:]):
        with pytest.raises(compress.CompressorError):
            tlz.decompress(bad)


def _no_host(*a, **kw):
    raise AssertionError("host oracle reached from the async path")


def test_full_queue_fails_with_device_busy(monkeypatch):
    monkeypatch.setattr(lz, "match_plan_host", _no_host)
    monkeypatch.setattr(tlz, "match_plan_host", _no_host)

    async def main():
        rt = DeviceRuntime.reset(device="cpu", max_inflight=1,
                                 max_queue=0)
        rt.chips[0].queue.inflight = 1
        with pytest.raises(DeviceBusy):
            await tlz.compress_async(bytes(3 * T), device="cpu")
        return rt.chips[0]

    chip = run(main())
    assert chip.queue.rejected == 1 and chip.compress_bytes_in == 0


def test_failed_dispatch_fails_with_ioerror(monkeypatch):
    def refused(*a, **kw):
        raise RuntimeError("tlz: CUDA launch failed")

    monkeypatch.setattr(lz, "match_plan", refused)
    monkeypatch.setattr(lz, "match_plan_host", _no_host)
    monkeypatch.setattr(tlz, "match_plan_host", _no_host)

    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        with pytest.raises(IOError, match="launch failed"):
            await tlz.compress_async(bytes(3 * T), device="cpu")
        return rt.chips[0]

    chip = run(main())
    assert chip.queue.inflight == 0 and chip.pool.outstanding == 0
    assert [t.ok for t in chip.tickets] == [False]
    assert chip.compress_bytes_in == 0


def test_offload_switches_and_host_oracles_change_nothing(monkeypatch):
    data = _parity_corpus(1)[0]
    want = ref_tlz.compress_host(data)
    for var in ("CEPH_TPU_COMPRESS_OFFLOAD", "CEPH_TPU_EC_OFFLOAD"):
        monkeypatch.setenv(var, "0")
    monkeypatch.setattr(lz, "match_plan_host", _no_host)
    monkeypatch.setattr(tlz, "match_plan_host", _no_host)
    assert run(tlz.compress_async(data, device="cpu")) == (want, "device")
