"""The readers of the program's host spans in the placement cell, on
planted span rings and device traces, and on toy runs of that cell."""

import itertools

import pytest
from torch.autograd import DeviceType

from portbench import common, program_spans
from portbench import run as harness
from portbench.tests import toy

SPAN_READERS = ("map_issue_host_ms", "map_copyout_ms",
                "map_ticket_busy_ms", "map_device_ops")
MS = 1_000_000          # ns in a ms


def read(name, run):
    return harness.load_module("metrics", name).read(run)


class Ring:
    """A planted span ring: records as the program's `host_spans` gives
    them, oldest closed first."""

    def __init__(self):
        self.records = []
        self.ids = itertools.count(1)

    def add(self, name, t0, t1, parent=None, counts=None):
        rec = {"name": name, "id": next(self.ids),
               "parent": parent["id"] if parent else None, "ticket": None,
               "t0_ns": t0, "t1_ns": t1, "counts": counts}
        return rec

    def build(self, base, pools=1):
        """One build from `base` ns: per pool a 3 ms ticket holding
        upload 0.1, seed 1.5, choose 0.2, post 0.3 and copyout 0.4 ms,
        then 10 ns of rows; records entered as they close."""
        end = base + pools * (3 * MS + 10)
        build = self.add("mapping.build", base, end, counts={"pools": pools})
        closed = []
        for p in range(pools):
            t = base + p * (3 * MS + 10)
            ticket = self.add("mapping.ticket", t, t + 3 * MS, build)
            ticket["ticket"] = 100 + p
            for name, ms in (("map.upload", 0.1), ("map.seed", 1.5),
                             ("map.choose", 0.2), ("map.post", 0.3),
                             ("map.copyout", 0.4)):
                d = int(ms * MS)
                closed.append(self.add(name, t, t + d, ticket))
                t += d
            closed.append(ticket)
            t = ticket["t1_ns"]
            closed.append(self.add("mapping.rows", t, t + 10, build))
        closed.append(build)
        self.records += closed
        return closed


class Event:
    def __init__(self, name, a, b, kind=DeviceType.CUDA):
        self.a, self.b, self.kind = a, b, kind

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def device_type(self):
        return self.kind


class Profiler:
    """A stopped profiler as `Run.profiler` holds it, for its events."""

    def __init__(self, events):
        evs = [Event(*e) for e in events]
        kineto = type("K", (), {"events": lambda self: evs})()
        inner = type("P", (), {"kineto_results": kineto})()
        self.prof = type("Prof", (), {"profiler": inner})()


@pytest.fixture
def ring(monkeypatch):
    r = Ring()
    monkeypatch.setattr(program_spans, "ring", lambda: list(r.records))
    r.records.append(r.add("older", 0, MS))
    return r


def planted(events, lo=2 * MS, hi=100 * MS):
    """A traced run over profiler `events` (name, t0, t1[, device type]),
    whose DeviceTrace holds the device ones of positive length, as the
    harness's Profiler.stop takes them."""
    run = common.Run({}, {}, 1, 1.0, True)
    dev = [(n, a, b) for n, a, b, *kind in events
           if kind in ([], [DeviceType.CUDA]) and b > a]
    run.trace = common.DeviceTrace(dev, lo, hi, [])
    run.profiler = Profiler(events)
    return run


def test_phase_readers_sum_the_span_durations(ring):
    for b in (10, 20, 30):
        ring.build(b * MS)
    run = planted([])
    assert read("map_issue_host_ms", run) == pytest.approx(2.1)
    assert read("map_copyout_ms", run) == pytest.approx(0.4)


def test_a_build_of_two_pools_sums_both_passes(ring):
    ring.build(10 * MS, pools=2)
    run = planted([])
    assert read("map_issue_host_ms", run) == pytest.approx(4.2)
    assert read("map_copyout_ms", run) == pytest.approx(0.8)


def test_ticket_busy_clips_device_intervals_to_the_ticket(ring):
    b = 10 * MS
    ring.build(b)
    events = [("k", b - MS, b + MS // 2),           # straddles the start
              ("k", b + MS, b + MS + MS // 4),      # inside
              ("k", b + MS + MS // 8, b + 2 * MS),  # overlaps the last
              ("k", b + 3 * MS - MS // 4, b + 5 * MS),  # straddles the end
              ("k", b + 6 * MS, b + 7 * MS),        # outside
              ("host", b + MS, b + 2 * MS, DeviceType.CPU),  # not a device op
              ("empty", b + MS, b + MS)]            # no length
    run = planted(events)
    # 0.5 + (1.0 .. 2.0) 1.0 + 0.25 inside the [b, b + 3 ms] ticket
    assert read("map_ticket_busy_ms", run) == pytest.approx(1.75)
    # starts inside: the three that begin after b and before b + 3 ms
    assert read("map_device_ops", run) == 3.0


def test_ticket_readers_take_the_median_over_builds(ring):
    bases = [10 * MS, 20 * MS, 30 * MS]
    for b in bases:
        ring.build(b)
    events = [("k", b + MS, b + MS + n * MS // 10)
              for b, n in zip(bases, (1, 2, 9)) for _ in range(n)]
    run = planted(events)
    assert read("map_ticket_busy_ms", run) == pytest.approx(0.2)
    assert read("map_device_ops", run) == 2.0


def test_builds_outside_the_window_are_left_out(ring):
    ring.build(10 * MS)
    slow = ring.build(20 * MS)
    ring.build(40 * MS)
    slow[1]["t1_ns"] += 5 * MS      # a slower seed, inside the window
    run = planted([], lo=15 * MS, hi=30 * MS)
    assert read("map_issue_host_ms", run) == pytest.approx(7.1)


def test_unfinished_builds_are_left_out(ring):
    ring.build(10 * MS, pools=2)
    ring.records = [r for r in ring.records if r["name"] != "mapping.rows"
                    or r["t0_ns"] < 14 * MS]    # its second pool failed
    kept = ring.build(20 * MS)
    kept[0]["t1_ns"] += 2 * MS
    run = planted([])
    assert len(program_spans.builds(run)) == 1
    assert read("map_issue_host_ms", run) == pytest.approx(4.1)


def test_builds_the_ring_trimmed_are_left_out(ring):
    # the ring drops its oldest records: a build that began before the
    # oldest kept record closed may have lost children, whole or not
    ring.build(10 * MS)
    kept = ring.build(20 * MS)
    kept[0]["t1_ns"] += 2 * MS
    ring.records = ring.records[3:]
    run = planted([])
    trees = program_spans.builds(run)
    assert [t[-1]["t0_ns"] for t in trees] == [20 * MS]
    assert read("map_issue_host_ms", run) == pytest.approx(4.1)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_run_without_program_spans_reads_none(name, ring):
    run = planted([("k", 10 * MS, 11 * MS)])
    assert read(name, run) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_program_without_a_span_ring_reads_none(name, monkeypatch):
    from ceph_tpu_torch.trace import recorder
    monkeypatch.delattr(recorder, "host_spans")
    run, line = toy.run("crush-pg32k-flap", traced=True, seconds=0.5)
    assert line["correct"] is True
    assert program_spans.ring() == []
    assert read(name, run) is None
    assert name not in line["metrics"]


@pytest.mark.parametrize("name", SPAN_READERS)
def test_readers_need_a_trace(name, ring):
    ring.build(10 * MS)
    run = planted([])
    run.trace = None
    assert read(name, run) is None


def test_device_ops_need_the_profiler(ring):
    ring.build(10 * MS)
    run = planted([("k", 11 * MS, 12 * MS)])
    run.profiler = None
    assert read("map_device_ops", run) is None


TREE = {"mapping.build": None, "mapping.ticket": "mapping.build",
        "mapping.rows": "mapping.build", "map.admit": "mapping.ticket",
        "map.upload": "mapping.ticket", "map.seed": "mapping.ticket",
        "map.choose": "mapping.ticket", "map.post": "mapping.ticket",
        "map.copyout": "mapping.ticket", "map.finish": "mapping.ticket"}


def test_a_traced_toy_run_reads_whole_span_trees_of_its_window():
    run, line = toy.run("crush-pg32k-flap", traced=True, seconds=1.0)
    assert line["correct"] is True
    trees = program_spans.builds(run)
    assert trees and len(trees) <= len(run.epochs)
    for tree in trees:
        by_id = {s["id"]: s for s in tree}
        assert sorted(s["name"] for s in tree) == sorted(TREE)
        for s in tree:
            parent = by_id.get(s["parent"])
            assert (parent["name"] if parent else None) == TREE[s["name"]]
            assert run.trace.lo <= s["t0_ns"] <= s["t1_ns"] <= run.trace.hi
    for name in SPAN_READERS[:2]:
        assert line["metrics"][name]["value"] > 0
    # no device events on the CPU: none inside any ticket
    assert line["metrics"]["map_ticket_busy_ms"]["value"] == 0.0
    assert line["metrics"]["map_device_ops"]["value"] == 0.0


def test_an_untraced_toy_run_reads_no_span_metric():
    run, line = toy.run("crush-pg32k-flap", traced=False, seconds=1.0)
    assert line["correct"] is True and run.epochs
    assert all("spans" not in e for e in run.epochs)
    assert not run.spans.items
    assert not set(SPAN_READERS) & set(line["metrics"])
