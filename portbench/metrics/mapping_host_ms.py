"""mapping_host_ms: p50, in ms, over the window's epochs of the
OSDMapMapping build's wall time less its mapping ticket's device_s: the
host's share of a build (parallel/mapping.py)."""

from portbench.common import quantile


def read(run):
    return quantile([(e["t1"] - e["t_applied"] - e["device_s"]) * 1e3
                     for e in run.epochs
                     if e["ok"] and e["device_s"] is not None], 0.5)
