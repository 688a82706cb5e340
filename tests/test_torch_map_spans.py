"""Host spans on the port's map-epoch path (trace/recorder.py `HostSpan`):
their names and nesting in an OSDMapMapping build, their stamps, their
tickets, their threads, the recorder's switch and cap, and the
operator's views (`FlightRecorder.dump`, `chrome_trace`).  On the CPU:
`device="cpu"` takes the same `map_pool_state` path as the card."""

import json
import sys
import threading
import time
import types

import pytest

from ceph_tpu_torch.device.runtime import DeviceLost, DeviceRuntime
from ceph_tpu_torch.models.crushmap import (CHOOSELEAF_FIRSTN, EMIT,
                                            STRAW2, TAKE, CrushMap)
from ceph_tpu_torch.osd.osdmap import (OSD_EXISTS, OSD_UP, Incremental,
                                       OSDMap, PGPool, pg_t)
from ceph_tpu_torch.parallel.mapping import OSDMapMapping
from ceph_tpu_torch.trace import recorder
from ceph_tpu_torch.trace.recorder import HostSpan

# span -> the span it lies in (one pool's subtree repeats per pool)
TREE = {"mapping.build": None, "mapping.ticket": "mapping.build",
        "mapping.rows": "mapping.build", "map.admit": "mapping.ticket",
        "map.upload": "mapping.ticket", "map.choose": "mapping.ticket",
        "map.post": "mapping.ticket",
        "map.copyout": "mapping.ticket", "map.finish": "mapping.ticket"}
ISSUE_ORDER = ["map.admit", "map.upload", "map.choose", "map.post",
               "map.copyout", "map.finish"]


def _osdmap(pools=2, upmap=True) -> OSDMap:
    """4 straw2 hosts of 3 OSDs, chooseleaf firstn host, `pools` size-3
    pools of 32 PGs; pool 2 (if any) carries one pg_upmap entry."""
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
    for pid in range(1, pools + 1):
        inc.new_pools[pid] = PGPool(id=pid, name="p%d" % pid, pg_num=32,
                                    size=3, crush_rule=0)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(12):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x10000
    if upmap and pools >= 2:
        inc.new_pg_upmap[pg_t(2, 3)] = [0, 3, 6]
    m.apply_incremental(inc)
    return m


@pytest.fixture(autouse=True)
def _ring():
    was = recorder.enabled()
    recorder.set_enabled(True)
    recorder.drain_host_spans()
    yield
    recorder.set_enabled(was)
    recorder.drain_host_spans()


def _build(m, rt=None):
    rt = rt or DeviceRuntime(device="cpu")
    t0 = time.time_ns()
    mapping = OSDMapMapping(m, runtime=rt)
    t1 = time.time_ns()
    return mapping, rt, recorder.drain_host_spans(), (t0, t1)


def _parent_name(by_id, s):
    p = by_id.get(s["parent"])
    return p["name"] if p else None


def test_a_build_records_the_span_tree():
    _mapping, _rt, spans, _ = _build(_osdmap())
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert _parent_name(by_id, s) == TREE[s["name"]], s
    names = [s["name"] for s in spans]
    assert names.count("mapping.build") == 1
    assert names.count("mapping.ticket") == 2
    assert names.count("mapping.rows") == 2
    for t in (s for s in spans if s["name"] == "mapping.ticket"):
        kids = sorted((s for s in spans if s["parent"] == t["id"]),
                      key=lambda s: s["t0_ns"])
        assert [k["name"] for k in kids] == ISSUE_ORDER


def test_the_spans_carry_their_counts():
    m = _osdmap()
    _mapping, _rt, spans, _ = _build(m)
    one = {s["name"]: s["counts"] for s in spans}
    assert one["mapping.build"] == {"pools": 2}
    # K4 hashes the lanes' pps seeds: no span of their own
    assert "map.seed" not in one
    # the plan's positions and its indep flag beside the lanes
    assert one["map.choose"] == {"lanes": 32, "slots": 3, "indep": 0}
    # reweights (int32) and keep (bool) for 12 OSDs; no primary affinity
    assert one["map.upload"] == {"bytes": 12 * 4 + 12}
    # up rows [32, 3] and primaries [32], int32
    assert one["map.copyout"] == {"bytes": 32 * 3 * 4 + 32 * 4}
    rows = sorted(s["counts"]["excepted"] for s in spans
                  if s["name"] == "mapping.rows")
    assert rows == [0, 1]


def test_children_lie_inside_parents_and_the_call():
    _mapping, _rt, spans, (t0, t1) = _build(_osdmap())
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert t0 <= s["t0_ns"] <= s["t1_ns"] <= t1
        p = by_id.get(s["parent"])
        if p is not None:
            assert p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"]


def test_each_ticket_span_carries_a_finished_ticket():
    _mapping, rt, spans, _ = _build(_osdmap())
    seqs = {t.seq for t in rt.chips[0].tickets if t.klass == "mapping"}
    tickets = [s for s in spans if s["name"] == "mapping.ticket"]
    assert {s["ticket"] for s in tickets} == seqs and len(seqs) == 2
    ids = {s["id"] for s in tickets}
    for s in spans:
        if s["name"].startswith("map."):
            assert s["parent"] in ids and s["ticket"] is None
        elif s["name"] != "mapping.ticket":
            assert s["ticket"] is None


def test_two_threads_keep_separate_parent_chains():
    maps = {"A": _osdmap(pools=1), "B": _osdmap(pools=2)}
    rt = DeviceRuntime(device="cpu", max_inflight=4)
    gate = threading.Barrier(2)
    errors = []

    def work(tag):
        try:
            gate.wait(timeout=30)
            for _ in range(3):
                with HostSpan(tag):
                    OSDMapMapping(maps[tag], runtime=rt)
        except Exception as e:          # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in maps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    spans = recorder.drain_host_spans()
    by_id = {s["id"]: s for s in spans}

    def root(s):
        while s["parent"] is not None:
            s = by_id[s["parent"]]
        return s["name"]

    per_root = {"A": 0, "B": 0}
    for s in spans:
        if s["name"] in maps:
            assert s["parent"] is None
            continue
        tag = root(s)
        per_root[tag] += 1
        if s["name"] == "mapping.build":
            assert s["counts"] == {"pools": len(maps[tag].pools)}
            assert by_id[s["parent"]]["name"] == tag
        else:
            assert _parent_name(by_id, s) == TREE[s["name"]]
    # a build: itself, and per pool a ticket, its 6 phases and the rows
    assert per_root == {"A": 3 * (1 + 8), "B": 3 * (1 + 2 * 8)}


def test_a_disabled_recorder_records_no_span():
    recorder.set_enabled(False)
    _mapping, _rt, spans, _ = _build(_osdmap())
    assert spans == []
    with HostSpan("x") as span:
        pass
    assert span.ticket is None and recorder.host_spans() == []


def test_the_ring_stays_within_its_cap():
    cap = recorder._SPAN_RING_CAP
    for i in range(cap + 100):
        with HostSpan("x", {"i": i}):
            pass
        assert len(recorder.host_spans()) <= cap
    kept = recorder.drain_host_spans()
    assert kept[-1]["counts"] == {"i": cap + 99}
    assert recorder.host_spans() == []


def test_a_failed_launch_closes_its_ticket_span():
    rt = DeviceRuntime(device="cpu")
    rt.chips[0].inject_fault(1)
    with pytest.raises(DeviceLost):
        OSDMapMapping(_osdmap(pools=1), runtime=rt)
    spans = recorder.drain_host_spans()
    assert sorted(s["name"] for s in spans) == sorted(
        ["mapping.build", "mapping.ticket", "map.admit", "map.finish"])
    ticket = rt.chips[0].tickets[-1]
    assert not ticket.ok
    assert next(s for s in spans
                if s["name"] == "mapping.ticket")["ticket"] == ticket.seq


def test_the_balancer_pass_records_the_bulk_mapper_spans():
    from ceph_tpu_torch.osd.balancer import _pool_raw
    m = _osdmap(pools=1)
    rows = _pool_raw(m, m.pools[1], device="cpu")
    assert len(rows) == 32
    names = sorted(s["name"] for s in recorder.drain_host_spans())
    assert names == sorted(["map.admit", "map.upload", "map.choose",
                            "map.post", "map.finish"])


def test_dump_carries_the_process_span_ring():
    ctx = types.SimpleNamespace(conf={})
    fr = recorder.FlightRecorder(ctx, "osd.0")
    OSDMapMapping(_osdmap(pools=1), runtime=DeviceRuntime(device="cpu"))
    dump = fr.dump()
    assert dump["host_spans"] == recorder.host_spans()
    assert {s["name"] for s in dump["host_spans"]} == set(TREE)
    dump["host_spans"][0]["name"] = "changed"
    assert recorder.host_spans()[0]["name"] != "changed"
    json.dumps(dump)


def test_chrome_trace_renders_a_builds_spans():
    recorder.clear_device_ring()
    OSDMapMapping(_osdmap(), runtime=DeviceRuntime(device="cpu"))
    spans = recorder.host_spans()
    device = recorder.device_records()
    assert len(device) == 2
    doc = recorder.chrome_trace({}, device=device, spans=spans)
    assert recorder.validate_chrome_trace(doc) == []
    procs = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert set(procs) == {"device-mesh", "host-spans"}
    slices = [e for e in doc["traceEvents"]
              if e["ph"] == "X" and e["cat"] == "host"]
    assert len(slices) == len(spans)
    lane = {e["args"]["seq"]: (e["pid"], e["tid"])
            for e in doc["traceEvents"] if e.get("cat") == "device"
            and e["ph"] == "X"}
    for e in slices:
        if e["name"] in ("mapping.build", "mapping.rows"):
            assert e["pid"] == procs["host-spans"]
        elif e["name"] == "mapping.ticket":
            assert (e["pid"], e["tid"]) == lane[e["args"]["ticket"]]
        else:
            assert e["pid"] == procs["device-mesh"]
    # a ticket's device slice lies inside its ticket span
    for t in (e for e in slices if e["name"] == "mapping.ticket"):
        d = next(e for e in doc["traceEvents"] if e.get("cat") == "device"
                 and e["ph"] == "X"
                 and e["args"]["seq"] == t["args"]["ticket"])
        assert t["ts"] <= d["ts"] <= d["ts"] + d["dur"] <= \
            t["ts"] + t["dur"] + 1.0
    # without the device ring every span goes to the host track
    alone = recorder.chrome_trace({}, spans=spans)
    assert recorder.validate_chrome_trace(alone) == []
    assert {e["pid"] for e in alone["traceEvents"] if e["ph"] == "X"} == \
        {1}


def test_chrome_trace_without_spans_is_unchanged():
    recorder.clear_device_ring()
    OSDMapMapping(_osdmap(), runtime=DeviceRuntime(device="cpu"))
    device = recorder.device_records()
    plain = json.dumps(recorder.chrome_trace({}, device=device))
    for spans in (None, []):
        assert json.dumps(recorder.chrome_trace(
            {}, device=device, spans=spans)) == plain
