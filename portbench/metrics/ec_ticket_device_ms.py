"""ec_ticket_device_ms: p50, in ms, of DispatchTicket.device_s (CUDA
events from launch to finish on the chip's stream) over the client EC
tickets finished in the window (device/runtime.py)."""

from portbench.common import quantile


def read(run):
    return quantile([t["device_s"] * 1e3 for t in run.tickets
                     if t["klass"] == "client-ec"], 0.5)
