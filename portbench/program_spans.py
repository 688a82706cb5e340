"""The program's own host spans of the placement pass, for the readers of
the placement cell.

The program keeps its closed host spans in a process-wide ring
(`ceph_tpu_torch.trace.recorder.host_spans`: name, id, parent, ticket,
`t0_ns`/`t1_ns` on `time.time_ns()`, the clock the profiler stamps
device events on).  The ring is bounded, so when the readers run it
holds the spans of the window's last builds only: a few hundred epochs
of the placement cell.  The readers take the p50 over those builds.
Where the program has no such ring, or the run no trace, they read
nothing.

Imports torch and the standard library only, and the program's recorder
at read time.
"""

from __future__ import annotations


def ring() -> list[dict]:
    """The program's host-span records, oldest first; [] where the
    program keeps none."""
    try:
        from ceph_tpu_torch.trace import recorder
    except ImportError:
        return []
    read = getattr(recorder, "host_spans", None)
    return read() if read is not None else []


def builds(run) -> list[list[dict]]:
    """The span trees of the `OSDMapMapping` builds inside the run's
    traced window that the ring holds whole, oldest first: each a list
    of the build's `mapping.build` span and its descendants.  A build is
    whole when it started after the ring's oldest record closed (spans
    enter the ring as they close, so the ring's trimming dropped none of
    its children) and it closed one `mapping.rows` span a pool (every
    pool's pass finished)."""
    if run.trace is None:
        return []
    recs = ring()
    if not recs:
        return []
    lo, hi = run.trace.lo, max(run.trace.lo, run.trace.hi)
    first_close = recs[0]["t1_ns"]
    by_id = {r["id"]: r for r in recs}
    trees: dict[int, list[dict]] = {}
    for r in recs:
        if (r["name"] == "mapping.build" and r["parent"] is None
                and r["t0_ns"] > first_close
                and lo <= r["t0_ns"] and r["t1_ns"] <= hi):
            trees[r["id"]] = []
    for r in recs:
        root = r
        while root["parent"] is not None and root["parent"] in by_id:
            root = by_id[root["parent"]]
        if root["id"] in trees:
            trees[root["id"]].append(r)
    out = []
    for tree in trees.values():
        build = next(s for s in tree if s["name"] == "mapping.build")
        pools = (build["counts"] or {}).get("pools")
        rows = sum(1 for s in tree if s["name"] == "mapping.rows")
        if pools is not None and rows == pools:
            out.append(tree)
    out.sort(key=lambda t: min(s["t0_ns"] for s in t))
    return out


def span_ms(tree: list[dict], names) -> float:
    """Summed duration, in ms, of the tree's spans of these names."""
    return sum(s["t1_ns"] - s["t0_ns"] for s in tree
               if s["name"] in names) / 1e6


def tickets(tree: list[dict]) -> list[tuple[int, int]]:
    """The (t0_ns, t1_ns) of the tree's `mapping.ticket` spans."""
    return [(s["t0_ns"], s["t1_ns"]) for s in tree
            if s["name"] == "mapping.ticket"]


def device_starts(run, lo: int, hi: int) -> list[int] | None:
    """Sorted start stamps (ns) of the traced run's device operations
    (kernels and copies: the profiler's device events of positive
    length, as the run's DeviceTrace takes them) that start in [lo, hi],
    read again from the stopped profiler; None without one."""
    prof = getattr(run, "profiler", None)
    if prof is None:
        return None
    from torch.autograd import DeviceType
    starts = []
    for e in prof.prof.profiler.kineto_results.events():
        t = e.start_ns()
        if (lo <= t <= hi and e.device_type() == DeviceType.CUDA
                and e.duration_ns() > 0):
            starts.append(t)
    starts.sort()
    return starts
