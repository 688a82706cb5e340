"""The harness on the CPU: every cell's driver at a toy size, the result
line's keys, the files found by name, BENCHMARK.json's limits, and the
modules a run loads."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as harness
from portbench.tests import toy

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_at_toy_size(cell, traced):
    run, line = toy.run(cell, traced=traced)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    wanted = {m["name"] for m in harness.cell_metrics(BENCH, cell, traced)}
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device trace: those readers find nothing
        wanted = {n for n in wanted if "idle" not in n
                  and "roofline" not in n}
    assert set(line["metrics"]) == wanted
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and set(m) == {"value", "unit"}
    json.dumps(line)


def test_every_cell_has_a_setup_and_an_e2e_and_a_layer_metric():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.cell_metrics(BENCH, cell, True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_files_are_found_by_name():
    here = ROOT / "portbench"
    for w in BENCH["workloads"]:
        cell = harness.load_json(here / "workloads" / (w["name"] + ".json"))
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert (here / "drivers" / (cell["driver"] + ".py")).exists()
    for c in BENCH["configs"]:
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert hasattr(harness.load_module("metrics", m["name"]), "read")


def test_benchmark_json_keeps_the_contract_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    metric_names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in metric_names
        metric_names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200
        assert m["workloads"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests import toy\n"
            "from portbench import run\n"
            "for cell in %r:\n"
            "    toy.run(cell, seconds=0.5)\n"
            "print(run.forbidden_modules())\n" % (str(ROOT), CELLS))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card_or_the_program(tmp_path):
    (tmp_path / "portbench").mkdir()
    subprocess.run(["cp", "-r", str(ROOT / "portbench"), str(tmp_path)],
                   check=True)
    (tmp_path / "BENCHMARK.json").write_bytes(
        (ROOT / "BENCHMARK.json").read_bytes())
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELLS[0], "--seed", str(2**33), "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "crush-pg32k-flap", "--seed", str(2**33 + 1),
                          "--seconds", "3", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=340)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0


def test_failed_ops_and_epochs_make_a_run_incorrect():
    from portbench import common
    run = common.Run({}, {}, 1, 1.0, False)
    run.add_check("pgs_placed_wrong", 0, 0)
    run.failed = 1
    run.add_check("epochs_failed", run.failed, 0)
    assert run.correct is False


def test_epoch_sample_is_seeded_uniform_and_keeps_the_last():
    from portbench.drivers.osdmap_epochs import EpochSample
    picks = []
    for _ in range(2):
        s = EpochSample(2**33 + 3, 6)
        for i in range(1000):
            wanted = s.offer(i)
            assert i in wanted and len(wanted) <= 6
        picks.append(s.picked())
    assert picks[0] == picks[1] and 999 in picks[0] and len(picks[0]) == 6
    other = EpochSample(2**33 + 4, 6)
    for i in range(1000):
        other.offer(i)
    assert other.picked() != picks[0]
