"""Exponential backoff with decorrelated jitter.

Own copy of ceph_tpu/utils/backoff.py's ``ExpBackoff``: a geometric
ramp from ``base`` to ``cap`` where each step is jittered across
``[interval/2, interval]``, so many waiters kicked by the same event do
not retry in lockstep.  The runtime's chip probe loop paces its retries
with it.

The RNG is injected so a seeded harness gets a replayable wait
schedule; pass nothing for wall-clock use.
"""

from __future__ import annotations

import asyncio
import random


class ExpBackoff:
    """One retry ramp: ``next_delay()`` yields base, ~2*base, ...
    capped at ``cap``; ``reset()`` re-arms after a success."""

    __slots__ = ("base", "cap", "factor", "rng", "_interval",
                 "attempts")

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 factor: float = 2.0,
                 rng: random.Random | None = None):
        self.base = float(base)
        self.cap = float(cap)
        self.factor = float(factor)
        self.rng = rng or random
        self._interval = self.base
        self.attempts = 0

    def reset(self) -> None:
        self._interval = self.base
        self.attempts = 0

    def peek(self) -> float:
        """The un-jittered current interval (for tests/telemetry)."""
        return self._interval

    def state(self) -> dict:
        """Telemetry: the current un-jittered interval and how many
        steps the ramp has taken since the last reset (0: idle)."""
        return {"interval_s": self._interval, "attempts": self.attempts}

    def next_delay(self) -> float:
        """Advance the ramp and return the jittered wait."""
        interval = self._interval
        self.attempts += 1
        self._interval = min(self._interval * self.factor, self.cap)
        return interval / 2.0 + self.rng.random() * (interval / 2.0)

    async def sleep(self) -> float:
        d = self.next_delay()
        await asyncio.sleep(d)
        return d
