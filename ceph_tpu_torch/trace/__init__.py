"""Request-level observability: tracked ops + cross-daemon spans.

Analog of src/common/TrackedOp.{h,cc} (OpTracker / TrackedOp /
OpRequest::mark_event) plus the trace-id propagation the reference
gets from reqid_t riding every sub-op: each daemon keeps an in-flight
table and a historic ring of per-op event timelines, and the trace id
travels in the message envelope so one client op's full cross-daemon
path (client -> mClock queue -> PG -> replicated/EC sub-ops -> device
EC batch -> commit) is reconstructable after the fact.
"""

from .logclient import LogClient
from .optracker import OpTracker, TrackedOp
from .recorder import FlightRecorder

__all__ = ["FlightRecorder", "LogClient", "OpTracker", "TrackedOp"]
