"""op_p95_ms: 95th percentile, in ms, of the latency from submission to
acknowledgement of every client op started in the window (an op
acknowledged after the close counts with its whole wait; a failed op
counts with the time it took to fail)."""

from portbench.common import quantile


def read(run):
    return quantile([(o["t1"] - o["t0"]) * 1e3 for o in run.ops], 0.95)
