"""Per-daemon performance counters.

Reference analog: PerfCounters (src/common/perf_counters.h) — typed
counters (u64 count, time, averages with count+sum, histograms) grouped
per subsystem, dumped over the admin socket (`perf dump`) and aggregated
by the manager.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any


class _Counter:
    __slots__ = ("kind", "value", "count", "sum", "buckets", "desc")

    def __init__(self, kind: str, desc: str = ""):
        self.kind = kind
        self.value = 0
        self.count = 0
        self.sum = 0.0
        self.buckets: list[int] | None = None
        self.desc = desc


class PerfCounters:
    """A named group of counters (one per daemon subsystem).

    Kinds:
      u64   — monotonically increasing or gauge integer
      time  — accumulated seconds
      avg   — (count, sum) pair; dump reports mean
      hist  — power-of-two latency histogram in microseconds
    """

    HIST_BUCKETS = 32  # 2^0 .. 2^31 µs

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, _Counter] = {}

    # -- declaration -----------------------------------------------------
    def add_u64(self, name: str, desc: str = "") -> None:
        with self._lock:
            self._counters[name] = _Counter("u64", desc)

    def add_time(self, name: str, desc: str = "") -> None:
        with self._lock:
            self._counters[name] = _Counter("time", desc)

    def add_avg(self, name: str, desc: str = "") -> None:
        with self._lock:
            self._counters[name] = _Counter("avg", desc)

    def add_hist(self, name: str, desc: str = "") -> None:
        c = _Counter("hist", desc)
        c.buckets = [0] * self.HIST_BUCKETS
        with self._lock:
            self._counters[name] = c

    # -- mutation --------------------------------------------------------
    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name].value += by

    def dec(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name].value -= by

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._counters[name].value = value

    def tinc(self, name: str, seconds: float) -> None:
        with self._lock:
            c = self._counters[name]
            c.sum += seconds
            c.count += 1

    def avg_add(self, name: str, sample: float) -> None:
        with self._lock:
            c = self._counters[name]
            c.sum += sample
            c.count += 1

    def hist_sample(self, name: str, seconds: float) -> None:
        us = max(0.0, seconds * 1e6)
        bucket = min(self.HIST_BUCKETS - 1, int(math.log2(us)) if us >= 1 else 0)
        with self._lock:
            self._counters[name].buckets[bucket] += 1

    class _Timer:
        __slots__ = ("pc", "name", "t0")

        def __init__(self, pc: "PerfCounters", name: str):
            self.pc, self.name = pc, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.pc.tinc(self.name, time.perf_counter() - self.t0)
            return False

    def timed(self, name: str) -> "_Timer":
        return self._Timer(self, name)

    # -- dump ------------------------------------------------------------
    def descriptions(self) -> dict[str, str]:
        """name -> declared help text (the exporter's # HELP source)."""
        with self._lock:
            return {name: c.desc for name, c in self._counters.items()}

    def dump(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        with self._lock:
            for name, c in self._counters.items():
                if c.kind == "u64":
                    out[name] = c.value
                elif c.kind in ("time", "avg"):
                    out[name] = {
                        "count": c.count,
                        "sum": c.sum,
                        "avg": (c.sum / c.count) if c.count else 0.0,
                    }
                elif c.kind == "hist":
                    out[name] = {"buckets_us_pow2": list(c.buckets)}
        return out


class PerfCountersCollection:
    """All counter groups in one process; `perf dump` walks this."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: dict[str, PerfCounters] = {}

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            pc = self._groups.get(name)
            if pc is None:
                pc = self._groups[name] = PerfCounters(name)
            return pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._groups.pop(name, None)

    def dump(self) -> dict[str, Any]:
        with self._lock:
            groups = dict(self._groups)
        return {name: pc.dump() for name, pc in groups.items()}

    def descriptions(self) -> dict[str, dict[str, str]]:
        with self._lock:
            groups = dict(self._groups)
        return {name: pc.descriptions()
                for name, pc in groups.items()}
