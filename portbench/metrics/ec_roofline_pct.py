"""ec_roofline_pct: the least time the card needs for the window's
acknowledged whole-object encodes (each data byte read once, each parity
byte written once, over HBM3's 3.35 TB/s), as a share of the device's
busy time in the window (the union of every kernel and copy interval
in the profiler's trace)."""

from portbench.common import HBM3_BYTES_PER_S


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.encode_bytes:
        return None
    return 100.0 * (run.encode_bytes / HBM3_BYTES_PER_S) / run.trace.busy_s
