"""L0 substrate: config, logging, perf counters, admin socket, context.

Reference analog: src/common/ (CephContext, md_config_t, dout, PerfCounters,
AdminSocket — see SURVEY.md §2.1 L0 row).
"""

from .config import Config, Option, OPT_BOOL, OPT_FLOAT, OPT_INT, OPT_STR
from .context import Context
from .log import Logger, LogRing
from .perf import PerfCounters, PerfCountersCollection

__all__ = [
    "Config",
    "Option",
    "OPT_BOOL",
    "OPT_FLOAT",
    "OPT_INT",
    "OPT_STR",
    "Context",
    "Logger",
    "LogRing",
    "PerfCounters",
    "PerfCountersCollection",
]
