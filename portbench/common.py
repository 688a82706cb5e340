"""What every driver and metric reader of the benchmark shares: the record
of one run, quantiles, host spans and the reduction of a profiler trace
to device busy time, the busiest device operations and the longest idle
gaps.

Imports torch and the standard library only; nothing of the program.
"""

from __future__ import annotations

import contextlib
import statistics
import time

HBM3_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at 700 W
NAME_CHARS = 160                # a device operation's name, cut to this


def quantile(values, q: float):
    """The q-quantile (0 < q < 1) of `values` by the inclusive method of
    `statistics.quantiles`; None when there is nothing to read."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    n = 100
    cuts = statistics.quantiles(vals, n=n, method="inclusive")
    return float(cuts[int(round(q * n)) - 1])


class Run:
    """Everything one run measured, for the metric readers.

    Drivers fill what their traffic has: `ops` (client ops of the
    window: dicts with t0, t1, bytes, ok, kind), `epochs` (map epochs of
    the window: t0, t_applied, t1, device_s, ok), `kept` (the rows of
    the epochs the check recomputes, by index in `epochs`), `tracked`
    (OpTracker records of the window), `tickets` (dispatch tickets
    finished in the window), `encode_bytes` (bytes that the window's
    acked full-object encodes need); the harness adds `trace` (a
    DeviceTrace) on a traced run."""

    def __init__(self, cell: dict, config: dict, seed: int,
                 seconds: float, traced: bool):
        self.cell = cell
        self.config = config
        self.seed = seed
        self.seconds = float(seconds)
        self.traced = traced
        self.setup_s: float | None = None
        self.window: tuple[float, float] | None = None
        self.ops: list[dict] = []
        self.epochs: list[dict] = []
        self.kept: dict[int, dict] = {}
        self.tracked: list[dict] = []
        self.tickets: list[dict] = []
        self.encode_bytes = 0
        self.attempted = 0
        self.failed = 0
        self.checks: dict[str, tuple[float, float]] = {}
        self.memory_peak_bytes = 0
        self.trace: DeviceTrace | None = None
        self.spans = Spans()
        self.profiler: Profiler | None = None

    def measuring(self):
        """The context the driver measures its window in."""
        if self.profiler is None:
            return contextlib.nullcontext()
        return self.profiler.window()

    def add_check(self, name: str, value: float, limit: float) -> None:
        """A number compared, with the largest value that passes."""
        self.checks[name] = (value, limit)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v <= lim for v, lim in self.checks.values())


def stage_ms(run: Run, desc: str, first: str, last: str):
    """p50 in ms, over the window's OpTracker records whose description
    starts with `desc`, of the time from event `first` to event `last`
    (each op's first stamp of each)."""
    gaps = []
    for op in run.tracked:
        if not op["desc"].startswith(desc):
            continue
        stamps = {}
        for t, ev in op["events"]:
            stamps.setdefault(ev, t)
        if first in stamps and last in stamps:
            gaps.append((stamps[last] - stamps[first]) * 1e3)
    return quantile(gaps, 0.5)


class Spans:
    """Host spans the benchmark opens around its own calls, on the
    wall clock in ns (the profiler's clock), for naming idle gaps."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []
        self.enabled = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def add(self, name: str, t0_ns: int, t1_ns: int) -> None:
        if self.enabled:
            self.items.append((name, t0_ns, t1_ns))


def union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    """A profiler window reduced: device intervals clipped to the
    window (ns), their union's seconds, the device operations by time
    and the idle gaps named by the host span that covers them."""

    def __init__(self, device_events, lo_ns: int, hi_ns: int,
                 spans: list[tuple[str, int, int]]):
        self.lo, self.hi = lo_ns, hi_ns
        clipped = []
        by_name: dict[str, float] = {}
        for name, a, b in device_events:
            a, b = max(a, lo_ns), min(b, hi_ns)
            if b <= a:
                continue
            clipped.append((a, b))
            name = name[:NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        self.busy = union(clipped)
        self.events = len(clipped)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e9
        self.window_s = (hi_ns - lo_ns) / 1e9
        self.device_ops = sorted(by_name.items(),
                                 key=lambda kv: -kv[1])[:10]
        gaps = []
        prev = lo_ns
        for a, b in self.busy + [(hi_ns, hi_ns)]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        self.idle_gaps = [(self._name(g, spans), (g[1] - g[0]) / 1e9)
                          for g in gaps[:10]]

    @staticmethod
    def _name(gap, spans) -> str:
        """The shortest benchmark span covering the gap's midpoint."""
        mid = (gap[0] + gap[1]) // 2
        best = None
        for name, a, b in spans:
            if a <= mid <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "host (outside the benchmark's spans)"

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


class Profiler:
    """torch.profiler over the whole run, recording the card's activity
    only (kernels, copies, sets; on a machine without a card, the CPU's,
    which holds no device event): host work is not traced, so the
    window's pace stays that of an untraced run.  It starts before the
    program does and stops after the program has shut down: starting or
    stopping it stalls the process for seconds, which a live cluster
    takes as failed heartbeats.  The profiler stamps device events on the
    wall clock in ns, as `time.time_ns()` does, so the window and the host
    spans are clipped and named on its timeline."""

    def __init__(self, spans: Spans):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self.spans = spans
        spans.enabled = True
        self.host = (0, 0)

    def start(self) -> None:
        self.prof.start()

    @contextlib.contextmanager
    def window(self):
        """Mark the measured window on the wall clock."""
        host0 = time.time_ns()
        yield
        self.host = (host0, time.time_ns())

    def stop(self) -> DeviceTrace:
        from torch.autograd import DeviceType
        self.prof.stop()
        evs = self.prof.profiler.kineto_results.events()
        dev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in evs
               if e.device_type() == DeviceType.CUDA
               and e.duration_ns() > 0]
        return DeviceTrace(dev, *self.host, self.spans.items)
