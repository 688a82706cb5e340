"""ec_encode_wait_ms: p50, in ms, over the window's client ops on every
primary, from `ec_encode_start` to `ec_encoded`: batching, staging and
the dispatch as the op sees them (ec/base.py, ec/batcher.py,
device/stream.py).  Only whole-object writes carry these stamps."""

from portbench.common import stage_ms


def read(run):
    return stage_ms(run, "osd_op(", "ec_encode_start", "ec_encoded")
