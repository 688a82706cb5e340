"""Prometheus metrics exporter.

Analog of src/exporter/ (the standalone ceph-exporter scraping daemon
perf counters) + the mgr prometheus module's text surface: an asyncio
HTTP endpoint rendering the process's PerfCountersCollection — and any
registered gauge callables (cluster state: osd counts, pg states,
epoch) — in the Prometheus exposition format.

    exp = PrometheusExporter(ctx)
    exp.add_gauge("ceph_osd_up", lambda: n_up, "up osds")
    await exp.start("127.0.0.1", 9283)     # the mgr module's port
"""

from __future__ import annotations

import asyncio
import re
from typing import Callable

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(*parts: str) -> str:
    return _NAME_RE.sub("_", "_".join(p for p in parts if p))


def hist_lines(base: str, buckets: list,
               labels: str = "", typed: set | None = None,
               desc: str = "") -> list[str]:
    """Prometheus histogram series from a PerfCounters power-of-two
    microsecond histogram (bucket i counts samples < 2^(i+1) µs).
    `labels` is an optional pre-rendered label body ('daemon="osd.0"')
    merged into each bucket's le label — the per-daemon form the mgr
    renders from MMgrReports.  `typed` is an optional cross-call set
    of family names that already emitted their `# HELP`/`# TYPE`
    header: the header is emitted exactly once even when the same
    base renders for many daemons (the exposition-format rule the
    lint pins)."""
    lines = []
    header = ["# HELP %s %s" % (base, desc or "pow2 histogram"),
              "# TYPE %s histogram" % base]
    if typed is not None:
        if base not in typed:
            typed.add(base)
            lines.extend(header)
    elif not labels:
        lines.extend(header)
    cum = 0
    sep = "," if labels else ""
    for i, n in enumerate(buckets):
        cum += n
        lines.append('%s_bucket{%s%sle="%g"} %d'
                     % (base, labels, sep, float(2 ** (i + 1)), cum))
    lines.append('%s_bucket{%s%sle="+Inf"} %d'
                 % (base, labels, sep, cum))
    lines.append("%s_count{%s} %d" % (base, labels, cum)
                 if labels else "%s_count %d" % (base, cum))
    return lines


class PrometheusExporter:
    def __init__(self, ctx, prefix: str = "ceph_tpu"):
        self.ctx = ctx
        self.prefix = prefix
        self._gauges: dict[str, tuple[Callable, str]] = {}
        self._server: asyncio.AbstractServer | None = None

    def add_gauge(self, name: str, fn: Callable[[], float],
                  desc: str = "") -> None:
        self._gauges[name] = (fn, desc)

    def add_renderer(self, fn: Callable[[], list]) -> None:
        """Custom line source appended to the exposition (labeled
        per-daemon series the flat gauge registry cannot express —
        the mgr's per-report metric families)."""
        self.__dict__.setdefault("_renderers", []).append(fn)

    def render(self) -> str:
        """The exposition document (text format 0.0.4)."""
        lines: list[str] = []
        for name, (fn, desc) in sorted(self._gauges.items()):
            try:
                v = float(fn())
            except Exception:
                continue
            lines.append("# HELP %s %s"
                         % (name, desc or "gauge %s" % name))
            lines.append("# TYPE %s gauge" % name)
            lines.append("%s %g" % (name, v))
        dump = self.ctx.perf.dump()
        descs = self.ctx.perf.descriptions()
        for group, counters in sorted(dump.items()):
            for cname, val in sorted(counters.items()):
                base = _metric_name(self.prefix, group, cname)
                desc = (descs.get(group) or {}).get(cname) \
                    or "perf counter %s.%s" % (group, cname)
                if isinstance(val, dict) \
                        and "buckets_us_pow2" in val:
                    lines.extend(hist_lines(base,
                                            val["buckets_us_pow2"],
                                            desc=desc))
                elif isinstance(val, dict):
                    # avg/time counters dump {avgcount, sum, ...}
                    for sub, sv in sorted(val.items()):
                        if isinstance(sv, (int, float)):
                            lines.append("# HELP %s_%s %s (%s)"
                                         % (base, sub, desc, sub))
                            lines.append("# TYPE %s_%s counter"
                                         % (base, sub))
                            lines.append("%s_%s %g" % (base, sub, sv))
                elif isinstance(val, (int, float)):
                    lines.append("# HELP %s %s" % (base, desc))
                    lines.append("# TYPE %s counter" % base)
                    lines.append("%s %g" % (base, val))
        for fn in self.__dict__.get("_renderers", []):
            try:
                lines.extend(fn())
            except Exception:
                pass
        return "\n".join(lines) + "\n"

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            req = await asyncio.wait_for(reader.readline(), 5.0)
            while True:
                line = await asyncio.wait_for(reader.readline(), 5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            path = req.split(b" ")[1] if len(req.split(b" ")) > 1 \
                else b"/"
            if path.rstrip(b"/") in (b"", b"/metrics"):
                body = self.render().encode()
                writer.write(
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: text/plain; version=0.0.4\r\n"
                    b"Content-Length: %d\r\n\r\n" % len(body))
                writer.write(body)
            else:
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"Content-Length: 0\r\n\r\n")
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        finally:
            writer.close()

    async def start(self, host: str = "127.0.0.1",
                    port: int = 0) -> str:
        self._server = await asyncio.start_server(self._handle, host,
                                                  port)
        addr = self._server.sockets[0].getsockname()
        return "%s:%d" % (addr[0], addr[1])

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?\s+(?P<value>\S+)$")


def validate_exposition(text: str,
                        max_label_card: int | None = 64
                        ) -> list[str]:
    """Lint an exposition document (text format 0.0.4): every emitted
    series must carry a valid metric name and belong to a family that
    declared BOTH a `# HELP` and a `# TYPE` line before its first
    sample (histogram `_bucket`/`_count`/`_sum` suffixes resolve to
    their base family).  Returns a list of human-readable violations
    — empty means clean.  Guards the growing series surface: a family
    added without its header breaks real Prometheus servers (or ships
    undocumented) only at scrape time; this makes it a unit-test
    failure instead.

    Cardinality guard: no (family, label) pair may carry more than
    `max_label_card` distinct label VALUES (None disables).  An
    unbounded label set — e.g. a tenant label fed raw tenant ids
    instead of the capped fold-into-"other" rows — is the classic
    Prometheus cardinality bomb; this makes it a lint failure before
    it becomes a TSDB incident."""
    errors: list[str] = []
    typed: set[str] = set()
    helped: set[str] = set()
    # (family, label name) -> set of observed label values
    label_vals: dict[tuple[str, str], set] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 3 and parts[1] == "TYPE":
                if not _VALID_NAME_RE.match(parts[2]):
                    errors.append("line %d: bad family name %r"
                                  % (ln, parts[2]))
                typed.add(parts[2])
            elif len(parts) >= 3 and parts[1] == "HELP":
                helped.add(parts[2])
            continue
        m = _SERIES_RE.match(line)
        if m is None:
            errors.append("line %d: unparseable series %r"
                          % (ln, line))
            continue
        name = m.group("name")
        if not _VALID_NAME_RE.match(name):
            errors.append("line %d: bad metric name %r" % (ln, name))
            continue
        family = name
        for suffix in ("_bucket", "_count", "_sum"):
            if name.endswith(suffix) and name[:-len(suffix)] in typed:
                family = name[:-len(suffix)]
                break
        if family not in typed:
            errors.append("line %d: series %r has no # TYPE line"
                          % (ln, name))
        if family not in helped:
            errors.append("line %d: series %r has no # HELP line"
                          % (ln, name))
        if max_label_card is not None and m.group("labels"):
            for lm in _LABEL_RE.finditer(m.group("labels")):
                key = (family, lm.group(1))
                vals = label_vals.setdefault(key, set())
                vals.add(lm.group(2))
        try:
            float(m.group("value"))
        except ValueError:
            errors.append("line %d: non-numeric value %r"
                          % (ln, m.group("value")))
    if max_label_card is not None:
        for (family, label), vals in sorted(label_vals.items()):
            if len(vals) > max_label_card:
                errors.append(
                    "family %r label %r carries %d distinct values "
                    "(cap %d): unbounded label set"
                    % (family, label, len(vals), max_label_card))
    return errors


_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


_VALID_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def device_runtime_lines(prefix: str = "ceph_tpu",
                         device=None) -> list[str]:
    """Device-runtime metric family (ceph_tpu.device): queue depth,
    bucket hit ratio, the ragged staging waste ratio
    (``device_bucket_waste_ratio`` — padded-but-empty over total
    staged words, the figure the bucket ladder exists to keep near
    zero), compile count, chip-loss state, the windowed utilization
    integrals (``device_util_busy`` / ``device_util_queue_wait`` /
    ``device_util_idle`` — the per-chip saturation signal the flight
    recorder's accounting derives), the continuous-dispatch stream
    gauges (``device_slot_occupancy`` — payload fraction of dispatched
    slot capacity, ``device_admission_wait`` — mean arrival->grant
    seconds of the admission loop, plus the independent-retire and
    pending counts), and the device_dispatch_seconds
    histogram — every dispatch ticket feeds these, so the
    accelerator's behavior is scrapeable beside the daemon counters.
    Every series carries a ``chip`` label (one per mesh chip, so a
    single lost chip is visible as ITS series flipping) plus the
    unlabeled mesh-size gauge.  `device`: the runtime's device
    (default: the card)."""
    from ..device.runtime import DeviceRuntime
    return DeviceRuntime.get(device).prom_lines(prefix)


def cluster_exporter(ctx, mon, device=None) -> PrometheusExporter:
    """Exporter pre-wired with the mgr prometheus module's core
    cluster gauges, fed from a monitor's map, plus the process's
    device-runtime series."""
    exp = PrometheusExporter(ctx)
    exp.add_renderer(lambda: device_runtime_lines(device=device))
    exp.add_gauge("ceph_osdmap_epoch", lambda: mon.osdmap.epoch,
                  "current osdmap epoch")
    exp.add_gauge("ceph_osd_count", lambda: mon.osdmap.max_osd,
                  "total osds")
    exp.add_gauge(
        "ceph_osd_up",
        lambda: sum(1 for o in range(mon.osdmap.max_osd)
                    if mon.osdmap.is_up(o)), "up osds")
    exp.add_gauge(
        "ceph_osd_in",
        lambda: sum(1 for o in range(mon.osdmap.max_osd)
                    if mon.osdmap.is_in(o)), "in osds")
    exp.add_gauge("ceph_pool_count", lambda: len(mon.osdmap.pools),
                  "pools")
    return exp
