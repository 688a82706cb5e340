"""map_ticket_device_ms: p50, in ms, over the window's epochs of the
mapping ticket's device_s (CUDA events around the pool pass: K4/K5 and
the copies to the host; device/runtime.py, ops/crush/device.py)."""

from portbench.common import quantile


def read(run):
    return quantile([e["device_s"] * 1e3 for e in run.epochs
                     if e["ok"] and e["device_s"] is not None], 0.5)
