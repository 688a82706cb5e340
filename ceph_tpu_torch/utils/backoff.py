"""Exponential backoff with decorrelated jitter.

Analog of the reference's retry pacing knobs (mon client hunting
backoff ``mon_client_hunt_interval_backoff``, objecter op retry and
the osd_backoff ramp in src/common/options) folded into one reusable
primitive: a geometric ramp from ``base`` to ``cap`` where each step
is jittered across ``[interval/2, interval]`` so a thousand clients
kicked by the same map epoch do not resend in lockstep.

The RNG is injected so a seeded harness (FaultInjector / thrasher)
gets a replayable wait schedule; pass nothing for wall-clock use.
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
        """Introspection hook for telemetry (the messenger's net
        plane renders the active redial ramp): current un-jittered
        interval plus how many steps the ramp has taken since the
        last reset — 0 attempts means the ramp is idle."""
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


async def wait_for(pred, timeout: float, base: float = 0.01,
                   cap: float = 0.5,
                   rng: random.Random | None = None,
                   what: str = "condition") -> None:
    """Poll ``pred()`` under an exponential-backoff schedule until it
    holds or ``timeout`` elapses (raises TimeoutError).  Replaces the
    fixed-interval ``while: sleep(0.02)`` spins: early checks are
    tight (fast tests stay fast), steady-state polling decays toward
    ``cap`` so a wedged cluster is not busy-polled."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    bo = ExpBackoff(base=base, cap=cap, rng=rng)
    while not pred():
        left = deadline - loop.time()
        if left <= 0:
            raise TimeoutError("%s not reached in %.1fs"
                               % (what, timeout))
        await asyncio.sleep(min(bo.next_delay(), left))


async def event_wait_for(event: asyncio.Event, pred, timeout: float,
                         what: str = "condition") -> None:
    """Event-driven variant: wait on ``event`` (cleared after each
    wake) and re-check ``pred`` — for producers that signal every
    state change (e.g. the client's map event).  A small cap-bound
    timeout per wait guards against a lost signal."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        left = deadline - loop.time()
        if left <= 0:
            raise TimeoutError("%s not reached in %.1fs"
                               % (what, timeout))
        event.clear()
        if pred():      # signal raced the clear
            return
        try:
            await asyncio.wait_for(event.wait(), min(left, 0.5))
        except asyncio.TimeoutError:
            pass
