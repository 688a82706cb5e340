"""The checks catch what they exist to catch: each control and each
planted fault, at a toy size on the CPU, turns `correct` false; sound
runs of the same sizes stay correct (test_portbench_harness)."""

import pytest

from portbench import control
from portbench.tests import toy


@pytest.mark.parametrize("cell", ["ec83-write-4m", "ec83-randwrite-4k"])
@pytest.mark.parametrize("name", ["parity_uncommitted", "unchanged", "half",
                                  "altered"])
def test_client_check_fails_under(cell, name):
    if cell == "ec83-randwrite-4k" and name in ("half", "altered"):
        pytest.skip("the overwrite path encodes no whole object: "
                    "covered by parity_uncommitted and unchanged")
    with control.client_patch(name):
        _run, line = toy.run(cell)
    assert line["correct"] is False, line["checks"]


# the placement cell's flaps, and a mix that steps hosts' CRUSH weights
# (the generator's other kind of epoch, which a later cell may use)
HOST_WEIGHT = {"epochs": {"host_weight": {"step_min": 1024, "step_max": 4096,
                                          "min": 32768, "max": 98304}}}
MIXES = {"flap": None, "host_weight": HOST_WEIGHT}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("name", ["unchanged", "half", "altered"])
def test_placement_check_fails_under(mix, name):
    with control.placement_patch(name):
        _run, line = toy.run("crush-pg32k-flap", seconds=2.0,
                             cell=MIXES[mix])
    assert line["correct"] is False, line["checks"]


def test_host_weight_mix_runs_correct():
    _run, line = toy.run("crush-pg32k-flap", cell=HOST_WEIGHT)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("mix,kind", [("flap", "ignore_out"),
                                      ("host_weight", "stale_crush")])
def test_placement_control_reads_wrong_placements(mix, kind):
    ov = {"cell": dict(toy.PLACEMENT["cell"], **(MIXES[mix] or {})),
          "config": toy.PLACEMENT["config"]}
    got = control.placement_control("crush-pg32k-flap", 2**33 + 5, 40, kind,
                                    ov)
    assert got["pgs_placed_wrong"] > 0


def test_each_cell_names_its_control():
    for cell in toy.harness.load_json(toy.harness.ROOT / "BENCHMARK.json")[
            "workloads"]:
        spec = toy.harness.load_json(toy.harness.HERE / "workloads"
                                     / (cell["name"] + ".json"))
        assert spec["control"] in (("parity_uncommitted",)
                                   if spec["driver"] == "cluster_client"
                                   else ("ignore_out", "stale_crush"))
