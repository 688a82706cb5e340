"""The erasure-coded placement cell on the CPU at toy size: a sound run is
correct, the planted fault and the control the cell names turn its check,
the `downout` mix keeps its limits, and the reader of the choose step's
device time (`map_choose_device_ms`) on planted span rings."""

import numpy as np
import pytest

from portbench import control, program_spans
from portbench import run as harness
from portbench.drivers import osdmap_epochs_ec as drv
from portbench.tests import toy
from portbench.tests.test_portbench_spans import MS, Ring, planted

CELL = "crush-ec83-pg64k-downout"


def _toy_cfg() -> tuple[dict, dict]:
    ov = toy.overrides(CELL)
    cell = harness.load_json(harness.HERE / "workloads" / (CELL + ".json"))
    cell.update(ov["cell"])
    cfg = harness.load_json(harness.HERE / "configs"
                            / (cell["config"] + ".json"))
    cfg.update(ov["config"])
    return cfg, cell


def test_a_toy_run_is_correct_with_holes_where_osds_are_down():
    run, line = toy.run(CELL, seed=2**34 + 9)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for e in run.kept.values():
        down = np.nonzero(~e["isup"])[0]
        assert not np.isin(e["up"], down).any()
        assert e["up"].shape[1] == drv.pool_size(run.config)


def test_the_altered_fault_turns_the_check():
    with control.placement_patch("altered"):
        _run, line = toy.run(CELL, seconds=2.0)
    assert line["correct"] is False
    assert line["checks"]["pgs_placed_wrong"]["value"] > 0


def test_the_ignore_out_control_reads_wrong_placements():
    """The reference with reweights ignored against the true one, on an
    epoch of the mix with out OSDs."""
    cfg, cell = _toy_cfg()
    n = cfg["hosts"] * cfg["per_host"]
    stream = drv.DownOutStream(cell["epochs"]["downout"], 2**33 + 5, n)
    while not (stream.reweight == 0).any():
        stream.next()
    sample = drv.check_sample(cfg, cell, 2**33 + 5)
    true = drv.reference_rows(cfg, sample, stream.reweight, stream.up)
    ctrl = drv.reference_rows(cfg, sample, stream.reweight, stream.up,
                              ignore_out=True)
    wrong = ((true[0] != ctrl[0]).any(axis=1) | (true[1] != ctrl[1]))
    assert wrong.sum() > 0


@pytest.mark.parametrize("seed", [1, 2**33 + 5, 2**62 + 17])
def test_the_downout_mix_keeps_its_limits(seed):
    spec = {"max_step": 10, "max_failed": 20}
    stream = drv.DownOutStream(spec, seed, 7200)
    seen = set()
    for _ in range(400):
        before = (~stream.up).sum()
        move = stream.next()
        (kind, osds), = move.items()
        seen.add(kind)
        assert 1 <= len(osds) <= 10
        out = stream.reweight == 0
        assert (~stream.up).sum() <= 20 and not (out & stream.up).any()
        if kind == "down":
            assert (~stream.up).sum() == before + len(osds)
    assert seen == {"down", "out", "revive"}
    # a toy map: at most a quarter of its OSDs fail
    small = drv.DownOutStream(spec, seed, 12)
    for _ in range(100):
        small.next()
        assert (~small.up).sum() <= 3


@pytest.fixture
def ring(monkeypatch):
    r = Ring()
    monkeypatch.setattr(program_spans, "ring", lambda: list(r.records))
    r.records.append(r.add("older", 0, MS))
    return r


def _read(run):
    return harness.load_module("metrics", "map_choose_device_ms").read(run)


def test_choose_device_ms_sums_a_builds_passes(ring):
    for base, pools, ns in ((10, 1, 1_500_000), (20, 2, 400_000),
                            (40, 1, 2_000_000)):
        for rec in ring.build(base * MS, pools=pools):
            if rec["name"] == "mapping.ticket":
                rec["counts"] = {"choose_ns": ns}
    # builds of 1.5, 0.8 (two passes of 0.4) and 2.0 ms
    assert _read(planted([])) == pytest.approx(1.5)


def test_choose_device_ms_reads_none_without_the_count(ring):
    ring.build(10 * MS)
    assert _read(planted([])) is None
    run = planted([])
    run.trace = None
    assert _read(run) is None
