"""In-process cluster harnesses for tests and the vstart CLI.

The teuthology/qa tier of this framework: `LocalCluster` boots real
daemons (mon quorum + OSDs + client) on loopback TCP inside one event
loop; `ClusterThrasher` drives it through seeded failure schedules
while a `Workload` keeps client traffic live and invariants checked.
"""

from .cluster import LocalCluster
from .thrasher import ClusterThrasher, Workload
from .traffic import TenantStream, TrafficGenerator

__all__ = ["LocalCluster", "ClusterThrasher", "Workload",
           "TenantStream", "TrafficGenerator"]
