"""Toy sizes of every cell, for runs on the CPU: the configuration's
and the workload's keys that shrink it, nothing else changed."""

from portbench import run as harness

CLIENT = {"config": {"profile": {"plugin": "isa", "technique": "reed_sol_van",
                                 "k": "2", "m": "1"},
                     "osds": 3, "pg_num": 8},
          "cell": {"warmup_s": 0.5, "check_objects": 4}}
PLACEMENT = {"config": {"hosts": 4, "per_host": 3, "pg_num": 4000},
             "cell": {"check_pgs": 512, "check_epochs": 3,
                      "warmup_epochs": 1}}


def overrides(cell_name: str) -> dict:
    cell = harness.load_json(harness.HERE / "workloads"
                             / (cell_name + ".json"))
    if cell["driver"] == "cluster_client":
        ov = {"config": dict(CLIENT["config"]), "cell": dict(CLIENT["cell"])}
        ops = dict(cell["ops"], object_bytes=65536, objects=8)
        ov["cell"]["ops"] = ops
        return ov
    ov = {"config": dict(PLACEMENT["config"]),
          "cell": dict(PLACEMENT["cell"])}
    epochs = dict(cell["epochs"])
    if "flap" in epochs:
        epochs["flap"] = {"max_out": 2, "max_step": 2}
    ov["cell"]["epochs"] = epochs
    return ov


def run(cell_name: str, seed: int = 2**33 + 7, seconds: float = 1.5,
        traced: bool = False, cell: dict | None = None):
    """One toy run; `cell` replaces further keys of the workload."""
    import time

    import torch
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    ov = overrides(cell_name)
    ov["cell"].update(cell or {})
    return harness.run_cell(bench, cell_name, seed, seconds, traced,
                            torch.device("cpu"), ov,
                            start=time.perf_counter())
