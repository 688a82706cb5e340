"""The port runtime's chip-loss and observability surface, on the CPU:
a lost chip fails its ops at admission with IOError (nothing is staged
or launched) until a probe heals it; shard plans, routing, the bulk
mapper and the balancer honour the loss; configure, the exporter's
helpers, the backoff ramp and the flight recorder's Chrome trace match
the JAX package's on the same inputs.

Runtimes are logical meshes of up to four chips on the CPU (``chips``,
``device="cpu"``), so the kernels run their plain versions.
"""

import asyncio
import random
import time

import numpy as np
import pytest
import torch

from ceph_tpu.device.runtime import DeviceRuntime as RefRuntime
from ceph_tpu.ec.batcher import DeviceBatcher as RefBatcher
from ceph_tpu.trace import recorder as ref_recorder
from ceph_tpu.utils import backoff as ref_backoff
from ceph_tpu.utils import exporter as ref_exporter

from ceph_tpu_torch.device.runtime import (DeviceBusy, DeviceLost,
                                           DeviceRuntime)
from ceph_tpu_torch.ec import new_codec
from ceph_tpu_torch.ec.batcher import DeviceBatcher
from ceph_tpu_torch.models.crushmap import (CHOOSELEAF_FIRSTN, EMIT,
                                            STRAW2, TAKE, CrushMap)
from ceph_tpu_torch.osd.osdmap import (OSD_EXISTS, OSD_UP, Incremental,
                                       OSDMap, PGPool)
from ceph_tpu_torch.parallel.mapping import OSDMapMapping
from ceph_tpu_torch.scale.balancer import batched_calc_pg_upmaps
from ceph_tpu_torch.trace import recorder
from ceph_tpu_torch.utils import backoff, exporter

torch.set_num_threads(1)

RS = {"plugin": "isa", "technique": "reed_sol_van", "k": "4", "m": "2"}
FAST_PROBE = {"device_max_inflight": 2, "device_queue_len": 64,
              "device_probe_interval": 0.04,
              "device_shard_min_words": 1024}


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _data(n=120_000, seed=29) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


async def _until(pred, timeout: float) -> float:
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("condition not reached")
        await asyncio.sleep(0.005)
    return time.monotonic() - t0


def _osdmap(hosts=4, per_host=3, pg_num=64) -> OSDMap:
    crush = CrushMap()
    ids = [crush.add_bucket(STRAW2, 1,
                            list(range(h * per_host, (h + 1) * per_host)),
                            [0x10000] * per_host, id=-(h + 2)).id
           for h in range(hosts)]
    crush.add_bucket(STRAW2, 2, ids, [per_host * 0x10000] * hosts, id=-1)
    crush.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1),
                    (EMIT, 0, 0)], id=0)
    m = OSDMap()
    inc = Incremental(epoch=1)
    inc.new_max_osd = hosts * per_host
    inc.new_crush = crush
    inc.new_pools[1] = PGPool(id=1, name="rbd", pg_num=pg_num, size=3,
                              crush_rule=0)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(hosts * per_host):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x8000 if o % 5 == 0 else 0x10000
    m.apply_incremental(inc)
    return m


# -- loss, admission, routing ------------------------------------------------


def test_injected_fault_fails_the_op_and_loses_only_that_chip():
    codec = new_codec(RS, device="cpu")
    data = _data()
    host = codec.encode(set(range(6)), data)

    async def main():
        rt = DeviceRuntime.reset(chips=4, device="cpu")
        rt.configure(FAST_PROBE)
        rt.chips[2].inject_fault(1)
        with pytest.raises(IOError, match="injected device fault"):
            await codec.encode_async(set(range(6)), data)
        assert [c.lost for c in rt.chips] == [False, False, True, False]
        assert rt.chips[2].loss_count == 1 and rt.loss_count == 1
        failed = [t for t in rt.chips[2].tickets if not t.ok]
        assert len(failed) == 1 and "injected" in failed[0].error
        assert rt.metrics()["device_lost_chips"] == 1
        # chip 2 leaves the next sharded flush's plan; the op is exact
        rt.chips[2].inject_fault(1 << 30)      # keep it lost
        out = await codec.encode_async(set(range(6)), data)
        assert all(out[i] == host[i] for i in host)
        assert rt.chips[2].dispatches == 0
        assert all(rt.chips[i].dispatches >= 2 for i in (0, 1, 3))

    run(main())


def test_admission_on_a_lost_chip_stages_and_launches_nothing():
    codec = new_codec(RS, device="cpu")
    data = _data(8000)

    async def main():
        rt = DeviceRuntime.reset(chips=4, device="cpu")
        chip = rt.chips[1]
        chip.poison(RuntimeError("gone"))
        before = (chip.pool.hits, chip.pool.misses, chip.pool.outstanding,
                  chip.queue.inflight, chip.compile_count)
        with pytest.raises(IOError, match="chip 1 is lost"):
            await codec.encode_async(set(range(6)), data, chip=1)
        ticket = chip.open_ticket("client-ec", 512, 4096)
        with pytest.raises(DeviceLost):
            chip.try_admit(ticket)
        with pytest.raises(DeviceLost):
            await chip.admit(ticket)
        assert (chip.pool.hits, chip.pool.misses, chip.pool.outstanding,
                chip.queue.inflight, chip.compile_count) == before
        assert not [t for t in chip.tickets if t.ok]
        assert ticket.t_admit == 0.0
        # the other chips still serve
        out = await codec.encode_async(set(range(6)), data, chip=0)
        assert out == codec.encode(set(range(6)), data)

    run(main())


def test_queued_stream_ops_on_a_lost_chip_fail():
    codec = new_codec(RS, device="cpu")
    blobs = [_data(4000, seed=s) for s in range(6)]

    async def main():
        rt = DeviceRuntime.reset(chips=2, device="cpu")
        tasks = [asyncio.ensure_future(
            codec.encode_async(set(range(6)), b, chip=0)) for b in blobs]
        await asyncio.sleep(0)
        stream = rt.chips[0].stream
        assert stream.pending == len(blobs)
        rt.chips[0].poison("lost while ops wait")
        got = await asyncio.gather(*tasks, return_exceptions=True)
        assert all(isinstance(g, IOError) for g in got), got
        assert stream.pending == 0 and rt.chips[0].dispatches == 0

    run(main())


def test_shard_plans_skip_lost_chips_but_keep_the_owner():
    rt = DeviceRuntime.reset(chips=4, device="cpu")
    rt.shard_min_words = 1024
    rt.chips[1].poison("x")
    plan = rt.shard_plan(rt.chips[0], 4096)
    assert [c.index for c, _lo, _hi in plan] == [0, 2, 3]
    assert plan[-1][2] == 4096
    plan = rt.shard_plan(rt.chips[1], 4096)
    assert [c.index for c, _lo, _hi in plan] == [1, 0, 2, 3]
    assert [c.index for c in rt.available_chips()] == [0, 2, 3]
    assert rt.route(None) is rt.chips[0]
    rt.chips[0].poison("y")
    assert rt.route(None) is rt.chips[2]
    assert rt.route(1) is rt.chips[1]          # explicit: honoured
    assert not rt.chip_available(1) and rt.chip_available()


def test_mapping_and_balancer_raise_on_a_lost_chip():
    m = _osdmap()
    rt = DeviceRuntime.reset(chips=4, device="cpu")
    rt.chips[2].poison("x")
    with pytest.raises(DeviceLost):
        OSDMapMapping(m, chip=2, device="cpu")
    with pytest.raises(IOError, match="balancer dispatch refused"):
        batched_calc_pg_upmaps(m, m.new_incremental(), max_deviation=0.1,
                               chip=2, device="cpu")
    # the chip-less passes ran on chip 0; chip 2 took no ticket
    assert rt.chips[2].tickets == [] and rt.chips[0].tickets
    res = batched_calc_pg_upmaps(m, m.new_incremental(),
                                 max_deviation=0.1, chip=1, device="cpu")
    assert res.device_rounds >= 1 and res.host_rounds == 0
    rt.poison("whole mesh")
    with pytest.raises(DeviceLost, match="every chip"):
        OSDMapMapping(m, device="cpu")
    with pytest.raises(DeviceLost, match="every chip"):
        batched_calc_pg_upmaps(m, m.new_incremental(), device="cpu")
    assert not rt.available and rt.lost


def test_failed_scoring_dispatch_loses_the_chip(monkeypatch):
    """A fault inside the balancer's scoring dispatch finishes its
    ticket failed, marks the chip lost and reaches the caller as
    IOError; DeviceBusy at admission reaches it as itself."""
    from ceph_tpu_torch.scale import balancer as scale
    m = _osdmap()
    rt = DeviceRuntime.reset(chips=2, device="cpu")

    def broken(*_a):
        raise RuntimeError("device fault")

    monkeypatch.setattr(scale, "_score_pass", broken)
    with pytest.raises(IOError, match="device fault"):
        batched_calc_pg_upmaps(m, m.new_incremental(), max_deviation=0.1,
                               chip=1, device="cpu")
    assert rt.chips[1].lost and not rt.chips[0].lost
    assert [t.ok for t in rt.chips[1].tickets] == [False]
    rt.chips[1].heal()
    rt.chips[1].queue.max_inflight = 1
    rt.chips[1].queue.inflight = 1
    with pytest.raises(DeviceBusy):
        batched_calc_pg_upmaps(m, m.new_incremental(), max_deviation=0.1,
                               chip=1, device="cpu")
    assert not rt.chips[1].lost and rt.chips[1].queue.rejected == 1


def test_probe_heals_a_chip_once_its_faults_clear():
    codec = new_codec(RS, device="cpu")
    data = _data(8000)
    host = codec.encode(set(range(6)), data)

    async def main():
        rt = DeviceRuntime.reset(chips=2, device="cpu")
        rt.configure(FAST_PROBE)
        assert (rt._probe_base, rt._probe_cap) == (0.01, 0.04)
        chip = rt.chips[1]
        chip.inject_fault(1 << 30)
        with pytest.raises(IOError):
            await codec.encode_async(set(range(6)), data, chip=1)
        await asyncio.sleep(0.2)               # probes fail meanwhile
        assert chip.lost and chip.heal_count == 0
        chip.clear_faults()
        assert await _until(lambda: not chip.lost, 2.0) < 2.0
        assert chip.heal_count == 1 and chip.lost_reason is None
        out = await codec.encode_async(set(range(6)), data, chip=1)
        assert out == host and chip.dispatches == 1

    run(main())


def test_whole_mesh_loss_fails_chipless_ops_and_heals():
    codec = new_codec(RS, device="cpu")
    data = _data(8000)

    async def main():
        rt = DeviceRuntime.reset(chips=4, device="cpu")
        rt.configure(FAST_PROBE)
        events = []
        rt.add_listener(events.append)
        rt.inject_fault(1 << 30)
        rt.poison(RuntimeError("mesh down"))
        assert rt.lost and rt.metrics()["device_lost_chips"] == 4
        with pytest.raises(DeviceLost, match="every chip"):
            rt.route(None)
        with pytest.raises(DeviceLost):
            await codec.encode_async(set(range(6)), data)
        rt.clear_faults()
        await _until(lambda: rt.available_chips() == rt.chips, 2.0)
        assert rt.heal_count == 4 and not rt.lost
        assert events == [True] * 4 + [False] * 4
        out = await codec.encode_async(set(range(6)), data)
        assert out == codec.encode(set(range(6)), data)

    run(main())


def test_poison_without_a_loop_waits_for_a_manual_heal():
    rt = DeviceRuntime.reset(chips=2, device="cpu")
    seen = []
    rt.chips[0].add_listener(seen.append)
    rt.chips[0].poison("sync caller")
    rt.chips[0].poison("again")                 # no second transition
    assert rt.chips[0]._probe_task is None and rt.chips[0].loss_count == 1
    rt.chips[0].inject_fault(1)
    with pytest.raises(DeviceLost, match="probe"):
        rt.chips[0]._run_probe()
    rt.chips[0]._run_probe()                    # a real op on the CPU
    rt.heal()
    assert seen == [True, False] and rt.heal_count == 1


# -- configure, exporter, backoff, recorder ----------------------------------


CONFS = {
    "full": {"device_max_inflight": 3, "device_queue_len": 17,
             "device_probe_interval": 0.5,
             "device_shard_min_words": 100, "device_util_window": 2.5,
             "device_dispatch_mode": "flush",
             "device_stream_interval_us": 250,
             "device_stream_slot_words": 4096,
             "device_stream_max_slots": 2,
             "osd_mclock_tenant_qos": "a:0.1:2:0.5,bad,b:x:1:1,c:0.2:3:1",
             "ec_batch_flush_us": 50, "ec_batch_max_bytes": 100},
    "partial": {"device_probe_interval": 0.04,
                "device_shard_min_words": "2048",
                "device_util_window": None,
                "device_stream_interval_us": 10},
    "malformed": {"device_shard_min_words": "many",
                  "device_util_window": "wide",
                  "device_dispatch_mode": "stream",
                  "device_stream_interval_us": "soon",
                  "ec_batch_flush_us": "x",
                  "osd_mclock_tenant_qos": 7},
    "raising": {"device_max_inflight": "two", "device_queue_len": 1},
}


def _settings(rt, batcher) -> dict:
    return {
        "queues": [(c.queue.max_inflight, c.queue.max_queue)
                   for c in rt.chips],
        "probe": (rt._probe_base, rt._probe_cap,
                  getattr(rt, "probe_interval", None)),
        "scalars": (rt.shard_min_words, rt.util_window, rt.dispatch_mode,
                    rt.stream_interval, rt.stream_slot_words,
                    rt.stream_max_slots),
        "tenant_qos": rt.tenant_qos,
        "batcher": (batcher.window_us, batcher.max_batch_bytes),
    }


@pytest.mark.parametrize("name", sorted(CONFS))
def test_configure_matches_reference(name):
    conf = CONFS[name]

    async def configure(rt, batcher_cls):
        try:
            rt.configure(conf)
            raised = None
        except Exception as e:          # the reference's own shape
            raised = type(e)
        return raised, _settings(rt, batcher_cls.get())

    want = run(configure(RefRuntime(chips=2), RefBatcher))
    got = run(configure(DeviceRuntime(chips=2, device="cpu"),
                        DeviceBatcher))
    assert got == want
    if name == "raising":
        assert got[0] is ValueError


def _copy(typed):
    return None if typed is None else set(typed)


def test_hist_lines_backoff_and_lints_match_reference():
    for buckets, labels in (([0] * 32, ""), ([1, 0, 5, 2], 'chip="0"'),
                            ([3] * 8, 'daemon="osd.1",chip="2"')):
        for typed in (None, {"x_seconds"}, set()):
            assert (exporter.hist_lines("x_seconds", buckets, labels,
                                        typed=_copy(typed), desc="d")
                    == ref_exporter.hist_lines("x_seconds", buckets,
                                               labels, typed=_copy(typed),
                                               desc="d"))
    assert exporter._metric_name("a.b", "", "c-d") == \
        ref_exporter._metric_name("a.b", "", "c-d")
    docs = ["# HELP a x\n# TYPE a gauge\na 1\n",
            "a 1\n", "# TYPE b gauge\nb{c=\"1\"} nan\nb{c=\"2\"} x\n",
            "\n".join("# HELP t x\n# TYPE t gauge" if i == 0 else
                      't{tenant="%d"} 1' % i for i in range(70))]
    for doc in docs:
        assert (exporter.validate_exposition(doc)
                == ref_exporter.validate_exposition(doc))
        assert (exporter.validate_exposition(doc, None)
                == ref_exporter.validate_exposition(doc, None))
    for seed in (0, 7):
        mine = backoff.ExpBackoff(0.01, 0.3, rng=random.Random(seed))
        theirs = ref_backoff.ExpBackoff(0.01, 0.3,
                                        rng=random.Random(seed))
        for _ in range(12):
            assert mine.next_delay() == theirs.next_delay()
            assert mine.state() == theirs.state()
        mine.reset()
        theirs.reset()
        assert mine.peek() == theirs.peek()


def test_prom_lines_pass_both_lints():
    codec = new_codec(RS, device="cpu")

    async def main():
        rt = DeviceRuntime.reset(chips=3, device="cpu")
        await codec.encode_async(set(range(6)), b"z" * 4096)
        rt.chips[2].poison("x")
        return "\n".join(exporter.device_runtime_lines(device="cpu"))

    text = run(main())
    assert exporter.validate_exposition(text) == []
    assert ref_exporter.validate_exposition(text) == []
    assert "ceph_tpu_device_chips 3" in text
    assert 'ceph_tpu_device_lost{chip="2"} 1' in text
    assert 'ceph_tpu_device_lost{chip="0"} 0' in text
    assert 'ceph_tpu_device_dispatches{chip="0"} 1' in text
    assert 'ceph_tpu_device_dispatch_seconds_count{chip="0"} 1' in text
    assert text.count("# TYPE ceph_tpu_device_lost gauge") == 1
    for name in ("fallback", "host_fallbacks"):
        assert "device_%s" % name not in text


def test_chrome_trace_of_the_device_ring_passes_the_reference_lint():
    codec = new_codec(RS, device="cpu")
    data = _data(8000)

    async def main():
        recorder.clear_device_ring()
        rt = DeviceRuntime.reset(chips=2, device="cpu")
        await codec.encode_async(set(range(6)), data)
        rt.chips[1].inject_fault(1)
        with pytest.raises(IOError):
            await codec.encode_async(set(range(6)), data, chip=1)
        await codec.encode_async(set(range(6)), data, chip=0)
        return recorder.device_records()

    records = run(main())
    assert [r["ok"] for r in records] == [True, False, True]
    assert [r["chip"] for r in records] == [0, 1, 0]
    for build in (recorder.chrome_trace, ref_recorder.chrome_trace):
        doc = build({}, device=records)
        assert ref_recorder.validate_chrome_trace(doc) == []
        assert recorder.validate_chrome_trace(doc) == []
        assert sum(1 for e in doc["traceEvents"]
                   if e.get("cat") == "device" and e["ph"] == "X") == 3
    assert recorder.chrome_trace({}, device=records) == \
        ref_recorder.chrome_trace({}, device=records)


def test_warmup_ec_accounts_its_buckets():
    """tests/test_device_runtime.py's warmup case on the port, and
    every family of an LRC through device_families()."""
    isa = new_codec({"plugin": "isa", "technique": "reed_sol_van",
                     "k": "2", "m": "1"}, device="cpu")
    lrc = new_codec({"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
                    device="cpu")

    async def main():
        rt = DeviceRuntime.reset(device="cpu")
        (matrix, w), = isa.device_families()
        await rt.warmup_ec(matrix, w, buckets=(1024, 4096))
        assert rt.compile_count == 2 and rt.chips[0].pool.misses == 2
        await rt.warmup_ec(matrix, w, buckets=(1024, 4096))
        assert rt.compile_count == 2            # already warm
        await isa.encode_async({0, 1, 2}, b"w" * 1500)  # 750 w -> 1024
        assert rt.compile_count == 2 and rt.bucket_hits >= 1
        fams = {(tuple(map(tuple, m)), w) for m, w in
                lrc.device_families()}
        for matrix, w in fams:
            await rt.warmup_ec(matrix, w, buckets=(1024, 4096))
        assert rt.compile_count == 2 + 2 * len(fams)
        # a lost chip is left alone; a failing warmup loses the chip
        rt.chips[0].poison("x")
        await rt.warmup_ec(matrix, w, buckets=(512,))
        assert rt.compile_count == 2 + 2 * len(fams)
        rt.heal()
        with pytest.raises(ValueError, match="GF"):
            await rt.warmup_ec(*_bitmatrix_family())
        return rt

    rt = run(main())
    assert not rt.chips[0].lost


def _bitmatrix_family():
    codec = new_codec({"plugin": "jerasure", "technique": "cauchy_good",
                       "k": "4", "m": "2"}, device="cpu")
    return codec.device_families()[0]


def test_failed_warmup_loses_the_chip(monkeypatch):
    isa = new_codec({"plugin": "isa", "k": "2", "m": "1"}, device="cpu")

    def broken(*_a):
        raise RuntimeError("no kernel library")

    async def main():
        rt = DeviceRuntime.reset(chips=2, device="cpu")
        monkeypatch.setattr(DeviceBatcher, "_run", staticmethod(broken))
        await rt.warmup_ec(*isa.device_families()[0], chip=1)
        assert rt.chips[1].lost and "no kernel library" in \
            rt.chips[1].lost_reason
        assert rt.compile_count == 0 and not rt.chips[0].lost
        assert rt.chips[1].pool.outstanding == 0

    run(main())
