"""One discipline for every mapping-class ticket
(`parallel.mapping.MappingDispatch`): OSDMapMapping's pool passes, the
upmap balancer's raw rows and the scale balancer's scoring rounds.  A
refusal at admission finishes no ticket and leaves the queue as it was;
a fault at launch finishes the ticket failed and loses the chip.  The
runtime itself records no host span when it closes a ticket.  On the
CPU (`device="cpu"`: the kernels' plain versions)."""

import numpy as np
import pytest

from ceph_tpu_torch.device.runtime import (DEVICE_DISPATCH_WEIGHTS,
                                           DeviceBusy, DeviceLost,
                                           DeviceRuntime)
from ceph_tpu_torch.models.crushmap import (CHOOSELEAF_FIRSTN, EMIT,
                                            STRAW2, TAKE, CrushMap)
from ceph_tpu_torch.osd.balancer import _pool_raw
from ceph_tpu_torch.osd.osdmap import (OSD_EXISTS, OSD_UP, Incremental,
                                       OSDMap, PGPool)
from ceph_tpu_torch.parallel.mapping import OSDMapMapping
from ceph_tpu_torch.scale.balancer import _dispatch_score
from ceph_tpu_torch.trace import recorder


def _osdmap() -> OSDMap:
    """4 straw2 hosts of 3 OSDs, chooseleaf firstn host, one size-3
    pool of 16 PGs."""
    crush = CrushMap()
    hosts = [crush.add_bucket(STRAW2, 1, [3 * h, 3 * h + 1, 3 * h + 2],
                              [0x10000] * 3, id=-(h + 2)).id
             for h in range(4)]
    crush.add_bucket(STRAW2, 2, hosts, [0x30000] * 4, id=-1)
    crush.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1),
                    (EMIT, 0, 0)], id=0)
    m = OSDMap()
    inc = Incremental(epoch=1)
    inc.new_max_osd = 12
    inc.new_crush = crush
    inc.new_pools[1] = PGPool(id=1, name="p", pg_num=16, size=3,
                              crush_rule=0)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(12):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x10000
    m.apply_incremental(inc)
    return m


def _score_arrays():
    """A two-candidate scoring table (`scale.balancer._score_pass`)."""
    rows = np.array([[0, 3, 6], [1, 4, 7]], dtype=np.int64)
    return (rows, rows // 3, np.array([0, 1], dtype=np.int64),
            np.array([0, 1], dtype=np.int64),
            np.array([9, 10], dtype=np.int64),
            np.array([[1.0, -1.0], [2.0, -2.0]]),
            np.array([True, True]), np.array([3, 3], dtype=np.int64))


def _upmap_raw(rt):
    m = _osdmap()
    return _pool_raw(m, m.pools[1], "cpu")


CALLERS = {
    "osdmapmapping": lambda rt: OSDMapMapping(_osdmap(), runtime=rt),
    "upmap_balancer": _upmap_raw,
    "scale_balancer": lambda rt: _dispatch_score(rt.chips[0],
                                                 *_score_arrays()),
}


@pytest.fixture(autouse=True)
def _ring():
    was = recorder.enabled()
    recorder.set_enabled(True)
    recorder.drain_host_spans()
    yield
    recorder.set_enabled(was)
    recorder.drain_host_spans()


def test_the_callers_dispatch_when_the_chip_is_free():
    for name, call in CALLERS.items():
        rt = DeviceRuntime.reset(device="cpu")
        call(rt)
        tickets = rt.chips[0].tickets
        assert [(t.klass, t.ok) for t in tickets] == [("mapping", True)], \
            name
        assert rt.chips[0].queue.inflight == 0


@pytest.mark.parametrize("failure", ["busy_at_admission",
                                     "fault_at_launch"])
@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_one_discipline_for_every_mapping_ticket(caller, failure):
    rt = DeviceRuntime.reset(device="cpu")
    chip = rt.chips[0]
    recorder.drain_host_spans()
    if failure == "busy_at_admission":
        chip.queue.max_inflight = 1
        chip.queue.inflight = 1
        with pytest.raises(DeviceBusy):
            CALLERS[caller](rt)
        assert chip.tickets == [] and not chip.lost
        assert (chip.queue.inflight, chip.queue.depth) == (1, 1)
        assert chip.queue.rejected == 1
        finished = []
    else:
        chip.inject_fault(1)
        raised, match = (
            (IOError, "balancer dispatch failed: DeviceLost")
            if caller == "scale_balancer"
            else (DeviceLost, "injected device fault"))
        with pytest.raises(raised, match=match):
            CALLERS[caller](rt)
        assert [t.ok for t in chip.tickets] == [False]
        assert "injected device fault" in chip.tickets[0].error
        assert chip.lost and rt.chips[0].queue.inflight == 0
        finished = ["map.finish"]
    names = [s["name"] for s in recorder.drain_host_spans()
             if s["name"] in ("map.admit", "map.finish")]
    assert names == ["map.admit"] + finished


def test_the_runtime_records_no_span_when_it_closes_a_ticket():
    rt = DeviceRuntime.reset(device="cpu")
    chip = rt.chips[0]
    recorder.drain_host_spans()
    for klass in DEVICE_DISPATCH_WEIGHTS:
        for ok, error in ((True, None), (False, ValueError("scope"))):
            ticket = chip.open_ticket(klass, 512, 4096)
            chip.try_admit(ticket)
            chip.launch(ticket)
            chip.finish(ticket, ok=ok, error=error)
    assert recorder.drain_host_spans() == []
    assert [t.ok for t in chip.tickets] == [True, False] * len(
        DEVICE_DISPATCH_WEIGHTS)
    assert not chip.lost and chip.queue.inflight == 0
