"""map_device_ops: p50 over the window's OSDMapMapping builds that the
program's span ring still holds (`portbench/program_spans.py`), of the
number of device operations (kernels and copies in the profiler's trace)
that start inside the build's `mapping.ticket` host spans.  None without
a trace or where the program keeps no spans."""

import bisect

from portbench import program_spans
from portbench.common import quantile


def read(run):
    trees = program_spans.builds(run)
    if not trees:
        return None
    spans = [s for t in trees for s in program_spans.tickets(t)]
    starts = program_spans.device_starts(
        run, min(a for a, _b in spans), max(b for _a, b in spans))
    if starts is None:
        return None
    return quantile([sum(bisect.bisect_right(starts, b)
                         - bisect.bisect_left(starts, a)
                         for a, b in program_spans.tickets(t))
                     for t in trees], 0.5)
