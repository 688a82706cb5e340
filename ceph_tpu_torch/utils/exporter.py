"""Prometheus text surface of the device runtime.

Own copy of the parts of ceph_tpu/utils/exporter.py the runtime needs:
`hist_lines` renders a power-of-two microsecond histogram,
`validate_exposition` lints an exposition document (text format 0.0.4)
and `device_runtime_lines` renders a runtime's chip-labeled series
(`DeviceRuntime.prom_lines`).  The HTTP exporter and the cluster gauges
need a daemon context and a monitor, which the port does not have yet.
"""

from __future__ import annotations

import re

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
    """The device runtime's metric family for `device` (default: the
    card): queue depth, bucket hit ratio, staging waste, compile count,
    chip-loss state (``device_lost``, ``device_loss_count``,
    ``device_heal_count``), the windowed utilization integrals, the
    dispatch stream's gauges and the ``device_dispatch_seconds``
    histogram of CUDA-event device time.  Every series carries a
    ``chip`` label (so one lost chip shows as ITS series flipping),
    beside the unlabeled mesh-size gauge."""
    from ..device.runtime import DeviceRuntime
    return DeviceRuntime.get(device).prom_lines(prefix)
