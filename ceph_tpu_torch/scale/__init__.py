"""Scale plane: the control-plane-at-production-scale subsystem.

Three pieces:

* `ShellOSD` / `MapCache` (shell.py) — lightweight OSD shells
  speaking only the map/boot/beacon/stats protocol, so one process
  can boot 1k-10k subscribers through the real mon/paxos path; the
  shells' primary grouping maps once an epoch on the device;
* `ScaleCluster` (cluster.py) — the harness: batched shell boots,
  churn drivers, map-epoch convergence and misplaced-drain oracles;
* `batched_calc_pg_upmaps` (balancer.py) — the batched upmap
  balancer: thousands of candidate moves ranked in one device
  dispatch per round, committed through the exact calc_pg_upmaps
  validity rules.

The columnar PGMap the mgr folds shell reports with lives in
ceph_tpu_torch.mgr.pgmap (it serves vstart-scale clusters too).
"""

from .balancer import BalancerResult, batched_calc_pg_upmaps
from .cluster import SCALE_CONF, ScaleCluster
from .shell import MapCache, ShellOSD

__all__ = ["BalancerResult", "batched_calc_pg_upmaps", "MapCache",
           "SCALE_CONF", "ScaleCluster", "ShellOSD"]
