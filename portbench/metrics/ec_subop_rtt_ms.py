"""ec_subop_rtt_ms: p50, in ms, over the window's client ops on every
primary, from `ec_sub_write_sent` to `ec_sub_write_acked`: the shard
sub-writes' round trip through the messenger and the replicas
(msg/messenger.py, osd/ecbackend.py)."""

from portbench.common import stage_ms


def read(run):
    return stage_ms(run, "osd_op(", "ec_sub_write_sent",
                    "ec_sub_write_acked")
