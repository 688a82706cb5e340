"""osd_queue_wait_ms: p50, in ms, over the window's client ops on every
OSD (OpTracker records "osd_op(...)"), from `queued` to `reached_pg`:
the wait in the OSD's op queue (osd/daemon.py)."""

from portbench.common import stage_ms


def read(run):
    return stage_ms(run, "osd_op(", "queued", "reached_pg")
