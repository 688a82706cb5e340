"""map_ticket_busy_ms: p50, in ms, over the window's OSDMapMapping builds
that the program's span ring still holds (`portbench/program_spans.py`),
of the card's busy time inside the build's `mapping.ticket` host spans:
the union of the profiler's device intervals (`DeviceTrace.busy`), each
clipped to the span.  Beside map_ticket_device_ms, the stream's span
between the ticket's two CUDA events, host launch time included.  None
without a trace or where the program keeps no spans."""

import bisect

from portbench import program_spans
from portbench.common import quantile


def busy_ns(busy, ends, a: int, b: int) -> int:
    """Nanoseconds of the sorted disjoint intervals `busy` (with their
    `ends`) that lie inside [a, b]."""
    total = 0
    i = bisect.bisect_right(ends, a)
    while i < len(busy) and busy[i][0] < b:
        lo, hi = busy[i]
        total += min(hi, b) - max(lo, a)
        i += 1
    return total


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.busy
    ends = [hi for _lo, hi in busy]
    return quantile([sum(busy_ns(busy, ends, a, b)
                         for a, b in program_spans.tickets(t)) / 1e6
                     for t in program_spans.builds(run)], 0.5)
