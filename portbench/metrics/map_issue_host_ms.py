"""map_issue_host_ms: p50, in ms, over the window's OSDMapMapping builds
that the program's span ring still holds (`portbench/program_spans.py`),
of the summed durations of the program's host spans `map.upload`,
`map.seed`, `map.choose` and `map.post`: the host's time to issue the
placement pass's device work (ops/crush/device.py, the
ops/crush/kernels.py wrappers).  None where the program keeps no spans."""

from portbench import program_spans
from portbench.common import quantile

PHASES = ("map.upload", "map.seed", "map.choose", "map.post")


def read(run):
    return quantile([program_spans.span_ms(t, PHASES)
                     for t in program_spans.builds(run)], 0.5)
