"""In-process cluster harness for tests and the vstart CLI.

`LocalCluster` boots real daemons (mon quorum + OSDs + client, and
optionally the mgr) on loopback TCP inside one event loop, every OSD
bound to a chip of the port's device runtime.
"""

from .cluster import LocalCluster

__all__ = ["LocalCluster"]
