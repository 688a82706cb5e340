"""Leveled, per-subsystem logging with a crash-dump ring buffer.

Reference analog: Ceph's dout/ldout macros with per-subsystem debug levels
(src/common/dout.h) and the async Log thread keeping a bounded in-memory
ring of recent entries that is dumped on crash (src/log/Log.h).

Design: a `LogRing` always records (cheaply) at a high "gather" level;
entries at or below the subsystem's output level are also emitted to the
sink (stderr/file).  On fatal errors the ring is dumped, giving post-hoc
high-verbosity context without paying the IO cost up front.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import TextIO

# Per-subsystem (output_level, gather_level) defaults; subsystem names
# mirror the framework's package layout.
DEFAULT_SUBSYS_LEVELS: dict[str, tuple[int, int]] = {
    "none": (1, 5),
    "crush": (1, 5),
    "ec": (1, 5),
    "osd": (1, 5),
    "mon": (1, 5),
    "msg": (0, 5),
    "client": (1, 5),
    "store": (1, 5),
    "paxos": (1, 5),
    "heartbeat": (1, 5),
    "bench": (1, 5),
}


class LogRing:
    """Bounded ring of recent log entries, dumped on crash."""

    def __init__(self, capacity: int = 10000):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def append(self, entry: tuple) -> None:
        with self._lock:
            self._ring.append(entry)

    def dump(self, out: TextIO = sys.stderr) -> None:
        with self._lock:
            entries = list(self._ring)
        out.write(f"--- begin dump of recent events ({len(entries)}) ---\n")
        for ts, subsys, level, msg in entries:
            out.write(f"{_fmt_ts(ts)} {level:2d} {subsys}: {msg}\n")
        out.write("--- end dump of recent events ---\n")


def _fmt_ts(ts: float) -> str:
    frac = int((ts % 1) * 1e6)
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(ts)) + f".{frac:06d}"


class Logger:
    """Entry point: `log = Logger(name); log.debug(subsys, msg, level=10)`.

    `dout(subsys, level)` returns True if the message would be emitted or
    gathered, letting callers skip expensive formatting — the analog of
    the reference's compile-time `dout` gating.
    """

    def __init__(
        self,
        name: str = "ceph-tpu",
        ring: LogRing | None = None,
        sink: TextIO | None = None,
        levels: dict[str, tuple[int, int]] | None = None,
    ):
        self.name = name
        self.ring = ring or LogRing()
        self._sink = sink if sink is not None else sys.stderr
        self._levels = dict(DEFAULT_SUBSYS_LEVELS)
        if levels:
            self._levels.update(levels)
        self._lock = threading.Lock()
        self._crash_hook_installed = False

    def set_level(self, subsys: str, output: int, gather: int | None = None) -> None:
        g = gather if gather is not None else max(output, 5)
        self._levels[subsys] = (output, g)

    def set_global_level(self, output: int, gather: int | None = None) -> None:
        """Raise/lower the output level of every subsystem at once (the
        `log_level` config option applies here)."""
        for subsys in list(self._levels):
            g = gather if gather is not None else max(output, self._levels[subsys][1])
            self._levels[subsys] = (output, g)

    def would_log(self, subsys: str, level: int) -> bool:
        out, gather = self._levels.get(subsys, self._levels["none"])
        return level <= max(out, gather)

    def log(self, subsys: str, level: int, msg: str) -> None:
        out_level, gather_level = self._levels.get(subsys, self._levels["none"])
        if level > out_level and level > gather_level:
            return
        ts = time.time()
        if level <= gather_level:
            self.ring.append((ts, subsys, level, msg))
        if level <= out_level:
            with self._lock:
                self._sink.write(
                    f"{_fmt_ts(ts)} {self.name} {level:2d} {subsys}: {msg}\n"
                )

    # convenience levels
    def error(self, subsys: str, msg: str) -> None:
        self.log(subsys, 0, msg)

    def info(self, subsys: str, msg: str) -> None:
        self.log(subsys, 1, msg)

    def debug(self, subsys: str, msg: str, level: int = 10) -> None:
        self.log(subsys, level, msg)

    def dump_recent(self, out: TextIO | None = None) -> None:
        self.ring.dump(out or self._sink)

    def install_crash_dump(self) -> None:
        """Dump the ring when the process dies on an unhandled exception."""
        if self._crash_hook_installed:
            return
        self._crash_hook_installed = True
        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            # let the previous hook print the traceback exactly once,
            # then append the high-verbosity ring
            prev_hook(exc_type, exc, tb)
            self.dump_recent()

        sys.excepthook = hook


_global_logger: Logger | None = None
_global_lock = threading.Lock()


def global_logger() -> Logger:
    global _global_logger
    with _global_lock:
        if _global_logger is None:
            _global_logger = Logger(f"ceph-tpu.{os.getpid()}")
        return _global_logger
