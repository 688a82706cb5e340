"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Reads the cell from `BENCHMARK.json` and `portbench/workloads/NAME.json`,
its configuration from `portbench/configs/<config>.json`, and runs the
driver the workload names (`portbench/drivers/<driver>.py`) on the card:
set-up, warm-up, a measured window of S seconds (under the profiler
with --trace 1), then the check against the plain reference.  Every
metric is read by its own reader, `portbench/metrics/<metric>.py`: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
ones.  The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device, (breakdown,) checks.  The numbers
compared are also the last lines of standard error.

Exits non-zero and prints no result without a CUDA device (or with fewer
than the cell asks for), when the program cannot be imported, and when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the served path is host-bound Python,
# and pools of spinning worker threads that wake for large CPU copies
# take cores from it; set before numpy or torch starts its pools
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")
LIMIT_S = 340       # a run that has not ended by then exits with 70


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py, by file (names may hold dots)."""
    path = HERE / kind / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_%s_%s" % (kind, name.replace(".", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones untraced (those
    listing it, or with no list, every cell's), the per-layer ones that
    list it traced."""
    if not traced:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device, overrides: dict | None = None,
             start: float = START):
    """Run one cell; returns (Run, result line as a dict).  `overrides`
    replace keys of the workload ("cell") and configuration ("config")
    files, for runs at a toy size on the CPU."""
    from portbench import common
    overrides = overrides or {}
    cell = load_json(HERE / "workloads" / (cell_name + ".json"))
    cell.update(overrides.get("cell", {}))
    config = load_json(HERE / "configs" / (cell["config"] + ".json"))
    config.update(overrides.get("config", {}))
    run = common.Run(cell, config, seed, seconds, traced)
    driver = load_module("drivers", cell["driver"])
    if traced:
        run.profiler = common.Profiler(run.spans)
        run.profiler.start()
    driver.run(run, device, start)
    if traced:
        run.trace = run.profiler.stop()
    metrics = {}
    for m in cell_metrics(bench, cell_name, traced):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device),
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, (v, lim) in run.checks.items()}
    return run, line


def device_kind(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _overdue() -> None:
    print("the run did not end within %d s" % LIMIT_S, file=sys.stderr,
          flush=True)
    os._exit(70)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print("no workload %r in BENCHMARK.json" % args.workload,
              file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("this cell needs %d CUDA device(s); found %d"
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 3
    watchdog = threading.Timer(LIMIT_S, _overdue)
    watchdog.daemon = True
    watchdog.start()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run, line = run_cell(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print("JAX or the JAX package was loaded: %s" % ", ".join(found),
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print("check %s = %s (limit %s)" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
