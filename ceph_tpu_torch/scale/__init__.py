"""Scale plane: the batched upmap balancer (balancer.py), thousands of
candidate moves ranked in one device dispatch per round and committed
through the exact calc_pg_upmaps validity rules."""

from .balancer import BalancerResult, batched_calc_pg_upmaps

__all__ = ["BalancerResult", "batched_calc_pg_upmaps"]
