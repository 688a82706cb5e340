"""map_choose_device_ms: p50, in ms, over the window's OSDMapMapping builds
that the program's span ring still holds (`portbench/program_spans.py`),
of the summed count `choose_ns` of the build's `mapping.ticket` spans:
the pool passes' K4 launches timed on the chip's stream, between two
CUDA events the bulk mapper records around them (ops/crush/device.py).
None where the program keeps no spans or records no such count."""

from portbench import program_spans
from portbench.common import quantile


def read(run):
    per_build = []
    for tree in program_spans.builds(run):
        counts = [(s["counts"] or {}).get("choose_ns") for s in tree
                  if s["name"] == "mapping.ticket"]
        if counts and None not in counts:
            per_build.append(sum(counts) / 1e6)
    return quantile(per_build, 0.5)
