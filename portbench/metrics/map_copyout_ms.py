"""map_copyout_ms: p50, in ms, over the window's OSDMapMapping builds
that the program's span ring still holds (`portbench/program_spans.py`),
of the program's host span `map.copyout`: the wait for the stream and
the copy of the up rows and primaries to host memory (ops/crush/device.py
`map_pool_batch`).  None where the program keeps no spans."""

from portbench import program_spans
from portbench.common import quantile


def read(run):
    return quantile([program_spans.span_ms(t, ("map.copyout",))
                     for t in program_spans.builds(run)], 0.5)
