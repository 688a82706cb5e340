"""Map epochs through the port's placement path, as every OSD's map
handler and the scale plane's MapCache take them.

Set-up builds the configuration's map (`ceph_tpu_torch.osd.osdmap.
OSDMap`: straw2 hosts of straw2 devices under a straw2 root, one
replicated pool) with every device up and in, maps it once (which loads
the kernel library) and runs the mix's warm-up epochs.  The window is a
closed loop of epochs: each one's changes are drawn from the seed
(`traffic.EpochStream`) and made into an `Incremental` beforehand, as a
monitor would send it, and the epoch is timed from
`OSDMap.apply_incremental` to a usable `parallel.mapping.OSDMapMapping`
on the card.  After each epoch the rows of a seeded sample of PGs are
kept while the epoch stays in the check's sample (`EpochSample`).

Once the window has closed and the card's memory peak is read, the
check recomputes the kept rows of a seeded sample of the window's
epochs (its last among them) with the plain straw2 reference
(`reference/straw2.py`) from the epoch's reweights and CRUSH weights,
and counts the PGs whose up set or up primary differs: it must be 0.
So must the count of epochs that failed: a failed epoch maps nothing,
and the window's epochs would otherwise seem to pass faster.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import common
from portbench.reference import straw2
from portbench.traffic import EpochStream, rng_for


def build_crush(cfg: dict, weights: np.ndarray):
    """The configuration's CRUSH map of the port at these device
    weights (16.16), with its one rule."""
    from ceph_tpu_torch.models.crushmap import STRAW2, CrushMap
    crush = CrushMap()
    per = int(cfg["per_host"])
    hosts = []
    for h in range(int(cfg["hosts"])):
        items = list(range(h * per, (h + 1) * per))
        hosts.append(crush.add_bucket(
            STRAW2, 1, items, [int(w) for w in weights[h * per:(h + 1)
                                                         * per]],
            id=-(h + 2)).id)
    crush.add_bucket(STRAW2, 2, hosts,
                     [crush.buckets[h].weight for h in hosts], id=-1)
    crush.add_rule([tuple(s) for s in cfg["rule"]], id=0)
    return crush


def reference_tree(cfg: dict, weights: np.ndarray) -> straw2.CrushTree:
    per = int(cfg["per_host"])
    hosts = int(cfg["hosts"])
    buckets = {}
    for h in range(hosts):
        ws = weights[h * per:(h + 1) * per]
        buckets[-(h + 2)] = (1, list(range(h * per, (h + 1) * per)), ws)
    buckets[-1] = (2, [-(h + 2) for h in range(hosts)],
                   [int(weights[h * per:(h + 1) * per].sum())
                    for h in range(hosts)])
    return straw2.CrushTree(buckets, hosts * per)


def initial_map(cfg: dict, stream: EpochStream):
    from ceph_tpu_torch.osd.osdmap import (OSD_EXISTS, OSD_UP, Incremental,
                                           OSDMap, PGPool)
    n = int(cfg["hosts"]) * int(cfg["per_host"])
    m = OSDMap()
    inc = Incremental(epoch=1)
    inc.new_max_osd = n
    inc.new_crush = build_crush(cfg, stream.crush)
    inc.new_pools[int(cfg["pool_id"])] = PGPool(
        id=int(cfg["pool_id"]), name="rbd", pg_num=int(cfg["pg_num"]),
        size=int(cfg["size"]), crush_rule=0)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(n):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x10000
    m.apply_incremental(inc)
    return m


class EpochSample:
    """The window's finished epochs that the check recomputes: a uniform
    sample of `n - 1` of them drawn from the seed as they finish
    (reservoir sampling), and the last.  The same seed and number of
    epochs give the same sample, so a control reads the same epochs."""

    def __init__(self, seed: int, n: int):
        self.k = max(0, int(n) - 1)
        self.rng = rng_for(seed, 6)
        self.slots: list[int] = []
        self.seen = 0
        self.last: int | None = None

    def offer(self, i: int) -> set[int]:
        """Epoch i finished: the epochs whose rows are still wanted."""
        if len(self.slots) < self.k:
            self.slots.append(i)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.slots[j] = i
        self.seen += 1
        self.last = i
        return self.picked()

    def picked(self) -> set[int]:
        return set(self.slots) | ({self.last} if self.last is not None
                                  else set())


def run(run: common.Run, device, start: float) -> None:
    import torch
    from ceph_tpu_torch.device.runtime import K_MAPPING, DeviceRuntime
    from ceph_tpu_torch.parallel.mapping import OSDMapMapping
    cfg, cell = run.config, run.cell
    n = int(cfg["hosts"]) * int(cfg["per_host"])
    pool_id = int(cfg["pool_id"])
    stream = EpochStream(cell["epochs"], run.seed, n, int(cfg["per_host"]),
                         int(cfg["crush_weight"]))
    m = initial_map(cfg, stream)
    chip = DeviceRuntime.get(device).chips[0]
    sample = np.sort(rng_for(run.seed, 5).choice(
        int(cfg["pg_num"]), size=int(cell["check_pgs"]), replace=False))
    spans = run.spans

    def epoch() -> tuple[dict, dict | None]:
        """One epoch's record, and the sample's rows (None if it failed)."""
        with spans.span("next epoch's incremental (mon side)"):
            change = stream.next()
            inc = m.new_incremental()
            for d, w in change.get("reweight", {}).items():
                inc.new_weight[d] = w
            if "crush" in change:
                inc.new_crush = build_crush(cfg, change["crush"])
        t0 = time.monotonic()
        try:
            with spans.span("OSDMap.apply_incremental"):
                m.apply_incremental(inc)
            t1 = time.monotonic()
            with spans.span("OSDMapMapping"):
                mapping = OSDMapMapping(m, device=device)
        except Exception as e:      # counted as failed
            return ({"t0": t0, "t1": time.monotonic(), "ok": False,
                     "error": repr(e)}, None)
        t2 = time.monotonic()
        ticket = next((t for t in reversed(chip.tickets)
                       if t.klass == K_MAPPING and t.ok
                       and t.t_done >= t1), None)
        pm = mapping.pools[pool_id]
        rec = {"t0": t0, "t_applied": t1, "t1": t2, "ok": True,
               "device_s": ticket.device_s if ticket else None}
        rows = {"up": pm.up[sample], "primary": pm.up_primary[sample],
                "reweight": stream.reweight.copy(),
                "crush": stream.crush.copy()}
        return rec, rows

    OSDMapMapping(m, device=device)
    for _ in range(int(cell.get("warmup_epochs", 3))):
        epoch()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    records: list[dict] = []
    kept: dict[int, dict] = {}
    picks = EpochSample(run.seed, int(cell["check_epochs"]))
    with run.measuring():
        t0 = time.monotonic()
        run.setup_s = time.perf_counter() - start
        deadline = t0 + run.seconds
        while time.monotonic() < deadline:
            rec, rows = epoch()
            i = len(records)
            records.append(rec)
            if rows is None:
                run.failed += 1
                continue
            kept[i] = rows
            wanted = picks.offer(i)
            for j in [j for j in kept if j not in wanted]:
                del kept[j]
    run.window = (t0, deadline)
    run.epochs = records
    run.kept = kept
    run.attempted = len(records)
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    _check(run, sample)


def count_wrong(run, sample: np.ndarray) -> int:
    """PGs of the sample, over the kept epochs, whose up set or up
    primary differs from the reference's for that epoch's map."""
    cfg = run.config
    if not run.kept:
        raise RuntimeError("no epoch of the window finished")
    alive = np.ones(int(cfg["hosts"]) * int(cfg["per_host"]), dtype=bool)
    wrong = 0
    for i in sorted(run.kept):
        e = run.kept[i]
        up, prim = straw2.up_sets(
            reference_tree(cfg, e["crush"]), cfg["rule"], int(cfg["size"]),
            sample, int(cfg["pg_num"]), int(cfg["pool_id"]),
            e["reweight"], alive, alive)
        bad = ((e["up"].astype(np.int64) != up).any(axis=1)
               | (e["primary"].astype(np.int64) != prim))
        wrong += int(bad.sum())
    return wrong


def _check(run: common.Run, sample: np.ndarray) -> None:
    run.add_check("epochs_failed", run.failed, 0)
    run.add_check("pgs_placed_wrong", count_wrong(run, sample), 0)
