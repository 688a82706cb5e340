"""apply_inc_ms: p50, in ms, over the window's epochs of the benchmark's
span around OSDMap.apply_incremental (osd/osdmap.py)."""

from portbench.common import quantile


def read(run):
    return quantile([(e["t_applied"] - e["t0"]) * 1e3 for e in run.epochs
                     if e["ok"]], 0.5)
