"""device_idle_pct.placement: 100 less the share of the window in which an
operation ran on the card (the union of the profiler's device
intervals), in the placement cells."""


def read(run):
    if run.trace is None or run.trace.events == 0:
        return None
    return run.trace.idle_pct
