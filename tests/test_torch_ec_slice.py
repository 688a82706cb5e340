"""The ceph_tpu_torch EC slice as a whole against the JAX package.

new_codec(profile, device="cpu") -> encode_async / decode_async /
delta_async, through the dispatch stream or the flush batcher, the
per-chip runtime and the kernels' plain versions, held bit for bit
against the reference codec's sync encode / decode / parity_delta and
against the reference's own encode_async (CEPH_TPU_EC_OFFLOAD=1).
Many concurrent ops of mixed widths exercise the ragged staging and the
slot grouping.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu.device.runtime import DeviceRuntime as RefRuntime
from ceph_tpu.ec.plugin import ErasureCodePluginRegistry
from ceph_tpu_torch.device.runtime import DeviceRuntime
from ceph_tpu_torch.ec import kernels as K
from ceph_tpu_torch.ec import new_codec
from ceph_tpu_torch.ec.batcher import DeviceBatcher

torch.set_num_threads(1)

PROFILES = [
    dict(plugin="isa", technique="reed_sol_van", k=8, m=3),
    dict(plugin="isa", technique="cauchy", k=6, m=3),
    dict(plugin="jerasure", technique="reed_sol_van", k=2, m=1),
    dict(plugin="jerasure", technique="reed_sol_r6_op", k=4, m=2),
    dict(plugin="jerasure", technique="reed_sol_van", k=4, m=2, w=16),
    dict(plugin="jerasure", technique="reed_sol_van", k=3, m=2, w=32),
]
_IDS = ["%s-%s-k%dm%d-w%d" % (p["plugin"], p["technique"], p["k"], p["m"],
                              p.get("w", 8)) for p in PROFILES]


def _profile(p):
    return {k: str(v) for k, v in p.items()}


def _codecs(p):
    ref = ErasureCodePluginRegistry.instance().factory(p["plugin"],
                                                       _profile(p))
    return new_codec(_profile(p), device="cpu"), ref


def _objects(seed, k, count=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(1, 3 * 1024 * k)),
                         dtype=np.uint8).tobytes() for _ in range(count)]


def _deltas(seed, k, count=12):
    """Partial overwrites of mixed lengths touching 1..k data chunks;
    odd lengths are sub-word on w=16/32 codecs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(1, 1500))
        touched = rng.choice(k, 1 + i % k, replace=False)
        out.append({int(j): rng.integers(0, 256, n, dtype=np.uint8)
                    .tobytes() for j in touched})
    return out


@pytest.mark.parametrize("mode", ["stream", "flush"])
@pytest.mark.parametrize("p", PROFILES, ids=_IDS)
def test_slice_matches_reference_sync_codec(p, mode):
    port, ref = _codecs(p)
    k, n = port.get_data_chunk_count(), port.get_chunk_count()
    objs = _objects(sum(map(ord, str(p))), k)
    deltas = _deltas(7, k)
    want = set(range(n))
    erase_sets = [(0,), (1, k)] if n - k >= 2 else [(1,)]

    async def run():
        rt = DeviceRuntime.get("cpu")
        rt.dispatch_mode = mode
        enc = await asyncio.gather(*[port.encode_async(want, o)
                                     for o in objs])
        degraded = []
        for er in erase_sets:
            reads = [{i: e[i] for i in range(n) if i not in er}
                     for e in enc[:6]]
            degraded.append((er, reads, await asyncio.gather(*[
                port.decode_async(set(er), r) for r in reads])))
        concat = await port.decode_concat_async(degraded[0][1][0])
        dl = await asyncio.gather(*[port.delta_async(d) for d in deltas])
        return enc, degraded, concat, dl, rt

    enc, degraded, concat, dl, rt = asyncio.run(run())
    for o, e in zip(objs, enc):
        assert e == ref.encode(want, o)
    for er, reads, got in degraded:
        for r, g in zip(reads, got):
            assert g == ref.decode(set(er), r)
    assert concat == ref.decode_concat(degraded[0][1][0])
    for d, g in zip(deltas, dl):
        assert g == ref.parity_delta(d)
    # every op went through the device path: staged, ticketed, dispatched
    chip = rt.chips[0]
    assert chip.dispatches >= 1 + len(erase_sets)
    assert chip.staged_payload_words > 0
    assert all(t.ok for t in chip.tickets)


@pytest.mark.parametrize("p", [PROFILES[0], PROFILES[4], PROFILES[5]],
                         ids=[_IDS[0], _IDS[4], _IDS[5]])
def test_slice_matches_reference_encode_async(p, monkeypatch):
    """The port's encode_async / delta_async == the reference's own
    device path (XLA program on the CPU) on the same concurrent ops."""
    monkeypatch.setenv("CEPH_TPU_EC_OFFLOAD", "1")
    port, ref = _codecs(p)
    k, n = port.get_data_chunk_count(), port.get_chunk_count()
    objs = _objects(5, k, count=12)
    deltas = _deltas(9, k, count=6)
    want = set(range(n))

    async def run(codec, **kw):
        enc = await asyncio.gather(*[codec.encode_async(want, o, **kw)
                                     for o in objs])
        dl = await asyncio.gather(*[codec.delta_async(d, **kw)
                                    for d in deltas])
        return enc, dl

    assert asyncio.run(run(port)) == asyncio.run(run(ref))


# ---------------------------------------------------------------------------
# runtime arithmetic against the reference
# ---------------------------------------------------------------------------

_WIDTHS = sorted({1, 2, 511, 512, 513, 1000, 1023, 1024, 1025, 4096,
                  4097, 6000, 12289, 65535, 65536, 100_000, 300_001,
                  (1 << 19) - 1, 1 << 19, (1 << 19) + 7, 1_500_000,
                  3 << 20} | {int(x) for x in np.random.default_rng(3)
                              .integers(1, 1 << 22, 40)})


def test_bucket_for_and_ragged_plan_match_reference():
    for n in _WIDTHS:
        assert DeviceRuntime.bucket_for(n) == RefRuntime.bucket_for(n), n
        assert DeviceRuntime.ragged_plan(n) == RefRuntime.ragged_plan(n), n
        for cap in (1, 2, 4):
            assert (DeviceRuntime.ragged_plan(n, cap)
                    == RefRuntime.ragged_plan(n, cap)), (n, cap)


@pytest.mark.parametrize("chips", [1, 3, 4])
def test_shard_plan_matches_reference(chips):
    port = DeviceRuntime(chips=chips, device="cpu")
    ref = RefRuntime(chips=chips)
    for owner in range(chips):
        for n in _WIDTHS:
            got = [(c.index, lo, hi) for c, lo, hi in
                   port.shard_plan(port.chips[owner], n)]
            want = [(c.index, lo, hi) for c, lo, hi in
                    ref.shard_plan(ref.chips[owner], n)]
            assert got == want, (owner, n)


def test_sharded_flush_reassembles():
    """An oversized flush splits across logical chips and reassembles
    bit-identically."""
    port, ref = _codecs(PROFILES[0])
    n = port.get_chunk_count()
    obj = _objects(4, 8, count=1)[0] * 6

    async def run():
        rt = DeviceRuntime.reset(chips=3, device="cpu")
        rt.dispatch_mode = "flush"
        rt.shard_min_words = 1024
        out = await port.encode_async(set(range(n)), obj)
        return out, DeviceBatcher.get().sharded_flushes, rt

    out, sharded, rt = asyncio.run(run())
    assert out == ref.encode(set(range(n)), obj)
    assert sharded == 1
    assert sum(c.dispatches for c in rt.chips) == 3


# ---------------------------------------------------------------------------
# batching, tickets, kernel choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["stream", "flush"])
def test_concurrent_calls_batch_and_deliver_tickets(mode):
    port, ref = _codecs(dict(plugin="isa", technique="reed_sol_van",
                             k=4, m=2))
    rng = np.random.default_rng(3)
    objs = [rng.integers(0, 256, 4096 * 4, dtype=np.uint8).tobytes()
            for _ in range(16)]
    tickets = []

    async def run():
        DeviceRuntime.get("cpu").dispatch_mode = mode
        outs = await asyncio.gather(*[
            port.encode_async(set(range(6)), o, on_ticket=tickets.append,
                              tenant="t%d" % (i % 2))
            for i, o in enumerate(objs)])
        return outs, DeviceBatcher.get().batches_flushed

    outs, flushes = asyncio.run(run())
    assert flushes <= 2, flushes
    assert len(tickets) == 16 and all(t.ok for t in tickets)
    assert {t.tenant for t in tickets} <= {"mixed", "t0", "t1"}
    assert all(t.stream == (mode == "stream") for t in tickets)
    for o, out in zip(objs, outs):
        assert out == ref.encode(set(range(6)), o)


def test_fused_switch_selects_bitplane_kernel(monkeypatch):
    """CEPH_TPU_EC_FUSED=0 puts w=8 on K2, as in the reference; w=8
    defaults to K1 and w=16/32 always take K2."""
    from ceph_tpu_torch.ec.kernels import DeviceEncoder, FusedEncoder
    key = ((1, 1), (1, 2))
    DeviceBatcher._encoder.cache_clear()
    try:
        assert isinstance(DeviceBatcher._encoder(key, 8, "cpu"),
                          FusedEncoder)
        assert isinstance(DeviceBatcher._encoder(key, 16, "cpu"),
                          DeviceEncoder)
        DeviceBatcher._encoder.cache_clear()
        monkeypatch.setenv("CEPH_TPU_EC_FUSED", "0")
        assert isinstance(DeviceBatcher._encoder(key, 8, "cpu"),
                          DeviceEncoder)
        port, ref = _codecs(PROFILES[1])
        obj = _objects(8, 6, count=1)[0]
        assert (asyncio.run(port.encode_async(set(range(9)), obj))
                == ref.encode(set(range(9)), obj))
    finally:
        DeviceBatcher._encoder.cache_clear()


# ---------------------------------------------------------------------------
# failures reach the caller; nothing re-encodes on the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["stream", "flush"])
def test_device_busy_fails_the_op(mode, monkeypatch):
    def no_host(*a, **kw):
        raise AssertionError("host codec reached from the async path")

    port, _ref = _codecs(PROFILES[0])
    monkeypatch.setattr(port, "encode_chunks", no_host)
    obj = _objects(1, 8, count=1)[0]

    async def run():
        rt = DeviceRuntime.reset(device="cpu", max_inflight=1,
                                 max_queue=0)
        rt.dispatch_mode = mode
        rt.chips[0].queue.inflight = 1       # a dispatch holds the card
        with pytest.raises(IOError, match="DeviceBusy"):
            await port.encode_async(set(range(11)), obj)
        return rt

    rt = asyncio.run(run())
    assert rt.chips[0].queue.rejected == 1


@pytest.mark.parametrize("mode", ["stream", "flush"])
def test_launch_failure_fails_every_awaiting_op(mode, monkeypatch):
    def refused(*a, **kw):
        raise RuntimeError("fused_xor: CUDA launch failed")

    monkeypatch.setattr(K, "fused_xor", refused)
    port, _ref = _codecs(PROFILES[0])
    objs = _objects(2, 8, count=5)

    async def run():
        rt = DeviceRuntime.get("cpu")
        rt.dispatch_mode = mode
        res = await asyncio.gather(*[port.encode_async(set(range(11)), o)
                                     for o in objs],
                                   return_exceptions=True)
        return res, rt

    res, rt = asyncio.run(run())
    assert all(isinstance(r, IOError) for r in res), res
    assert rt.chips[0].pool.outstanding == 0
    assert rt.chips[0].queue.inflight == 0
    assert not any(t.ok for t in rt.chips[0].tickets)


# ---------------------------------------------------------------------------
# admission: the same classes, weights and order as the reference
# ---------------------------------------------------------------------------


async def _yield():
    fut = asyncio.get_running_loop().create_future()
    asyncio.get_running_loop().call_soon(fut.set_result, None)
    await fut


def _grant_order(queue_cls, weights):
    classes = ["mapping", "client-ec", "recovery-ec", "background",
               "client-ec", "client-ec", "recovery-ec", "mapping"] * 3

    async def run():
        q = queue_cls(weights, max_inflight=1, max_queue=64)
        await q.admit("client-ec")          # holds the only slot
        order = []

        async def one(i, klass):
            await q.admit(klass, cost=1.0 + i % 3)
            order.append(i)

        tasks = [asyncio.ensure_future(one(i, c))
                 for i, c in enumerate(classes)]
        await _yield()
        for _ in classes:
            q.release()
            await _yield()
        await asyncio.gather(*tasks)
        return order

    return asyncio.run(run())


def test_dispatch_queue_grant_order_matches_reference():
    from ceph_tpu.device.runtime import DispatchQueue as RefQueue
    from ceph_tpu.osd.scheduler import DEVICE_DISPATCH_WEIGHTS as REF_W
    from ceph_tpu_torch.device.runtime import (DEVICE_DISPATCH_WEIGHTS,
                                               DispatchQueue)
    assert DEVICE_DISPATCH_WEIGHTS == REF_W
    port = _grant_order(DispatchQueue, DEVICE_DISPATCH_WEIGHTS)
    assert port == _grant_order(RefQueue, REF_W)
    assert sorted(port) == list(range(24))


def test_stream_admission_weights_match_reference():
    from ceph_tpu.osd.scheduler import device_admission_weight as ref
    from ceph_tpu_torch.device.runtime import device_admission_weight
    qos = {"gold": (0.3, 4.0, 1.0), "bronze": (0.05, 0.5, 0.2)}
    for klass in ("client-ec", "recovery-ec", "mapping", "background",
                  "other"):
        for tenant in (None, "gold", "bronze", "unknown"):
            for rows in (None, qos):
                assert (device_admission_weight(klass, tenant, rows)
                        == ref(klass, tenant, rows))
