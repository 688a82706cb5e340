"""L4 cluster control plane: monitor (map authority) + paxos log.

Analog of src/mon/ — see monitor.py (Monitor/OSDMonitor service logic)
and paxos.py (the durable consensus log).
"""

from .monitor import Monitor
from .paxos import Paxos

__all__ = ["Monitor", "Paxos"]
