"""Map epochs of an erasure-coded pool through the port's placement path,
as every OSD's map handler takes them.

Set-up builds the configuration's map (`ceph_tpu_torch.osd.osdmap.
OSDMap`: a straw2 root of straw2 racks of straw2 hosts of devices, one
erasure pool under the configuration's indep rule) with every device up
and in, maps it once (which loads the kernel library) and runs the mix's
warm-up epochs.  The window is a closed loop of epochs: each one's
change is drawn from the seed (`DownOutStream`) and made into an
`Incremental` beforehand, as a monitor would send it, and the epoch is
timed from `OSDMap.apply_incremental` to a usable `parallel.mapping.
OSDMapMapping` on the card, as `osdmap_epochs.py` times it.  After each
epoch the rows of a seeded sample of PGs are kept while the epoch stays
in the check's sample (`osdmap_epochs.EpochSample`).

Once the window has closed and the card's memory peak is read, the check
recomputes the kept rows of the sampled epochs with the plain indep
reference (`reference/crush_indep.py`) from the epoch's reweights and
up set, and counts the PGs whose positional up row or up primary
differs: it must be 0.  So must the count of epochs that failed.

The `downout` mix (a workload's `epochs` section):

    {"downout": {"max_step": 10, "max_failed": 20}}
        each epoch makes one move, drawn among those possible: mark
        1..max_step up OSDs down (they stay in: their shards are holes),
        mark 1..max_step of the down OSDs out (reweight 0: CRUSH moves
        their shards), or bring 1..max_step out OSDs back up and in;
        at most max_failed OSDs are down or out at once (at most a
        quarter of the map's OSDs)

A map at toy size with fewer hosts than the pool's k + m shards (the
benchmark's CPU tests) takes one shard a host (`pool_size`), and its
racks are no more than its hosts (`layout`).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import common
from portbench.drivers.osdmap_epochs import EpochSample
from portbench.reference import crush_indep
from portbench.traffic import rng_for

IN = 0x10000


def layout(cfg: dict) -> tuple[int, int, int]:
    """(racks, hosts a rack, OSDs a host): the racks no more than the
    hosts."""
    hosts, per = int(cfg["hosts"]), int(cfg["per_host"])
    per_rack = max(1, min(int(cfg["hosts_per_rack"]), hosts))
    return -(-hosts // per_rack), per_rack, per


def pool_size(cfg: dict) -> int:
    """The pool's shards: k + m, or one a host where a map at toy size
    has fewer hosts than that (the failure domain holds one shard)."""
    return min(int(cfg["size"]), int(cfg["hosts"]))


def buckets(cfg: dict, weights: np.ndarray) -> dict:
    """{bucket id: (type, items, weights)} of the configuration's tree
    at these device CRUSH weights (16.16): the root -1 (type 3), racks
    -2.. (type 2), hosts after them (type 1) of devices (type 0)."""
    racks, per_rack, per = layout(cfg)
    hosts = int(cfg["hosts"])
    out = {}
    host_ids = [-(2 + racks + h) for h in range(hosts)]
    for h, hid in enumerate(host_ids):
        devs = list(range(h * per, (h + 1) * per))
        out[hid] = (1, devs, [int(weights[d]) for d in devs])
    rack_ids = [-(2 + r) for r in range(racks)]
    for r, rid in enumerate(rack_ids):
        hs = host_ids[r * per_rack:(r + 1) * per_rack]
        out[rid] = (2, hs, [sum(out[h][2]) for h in hs])
    out[-1] = (3, rack_ids, [sum(out[r][2]) for r in rack_ids])
    return out


def build_crush(cfg: dict, weights: np.ndarray):
    """The configuration's CRUSH map of the port, with its one rule."""
    from ceph_tpu_torch.models.crushmap import STRAW2, CrushMap
    crush = CrushMap()
    for bid, (btype, items, ws) in sorted(buckets(cfg, weights).items(),
                                          key=lambda kv: kv[1][0]):
        crush.add_bucket(STRAW2, btype, items, ws, id=bid)
    crush.add_rule([tuple(s) for s in cfg["rule"]], id=0)
    return crush


def reference_tree(cfg: dict, weights: np.ndarray) -> crush_indep.Tree:
    n = int(cfg["hosts"]) * int(cfg["per_host"])
    return crush_indep.Tree(buckets(cfg, weights), n)


class DownOutStream:
    """Seeded OSD failures, one incremental's worth per `next()`: the
    reweights (16.16) and the up flags after it."""

    def __init__(self, spec: dict, seed: int, n_devices: int):
        self.rng = rng_for(seed, 3)
        self.n = int(n_devices)
        self.max_step = int(spec["max_step"])
        self.max_failed = max(1, min(int(spec["max_failed"]),
                                     self.n // 4))
        self.reweight = np.full(self.n, IN, dtype=np.int64)
        self.up = np.ones(self.n, dtype=bool)

    def next(self) -> dict[str, list[int]]:
        """The epoch's move: {"down": OSDs}, {"out": OSDs} or
        {"revive": OSDs}."""
        down = np.nonzero(~self.up & (self.reweight != 0))[0]
        out = np.nonzero(self.reweight == 0)[0]
        room = self.max_failed - len(down) - len(out)
        moves = [m for m, ok in (("down", room > 0), ("out", len(down)),
                                 ("revive", len(out))) if ok]
        move = moves[int(self.rng.integers(len(moves)))]
        pool = {"down": np.nonzero(self.up)[0], "out": down,
                "revive": out}[move]
        most = room if move == "down" else len(pool)
        k = int(self.rng.integers(1, min(most, self.max_step) + 1))
        pick = np.sort(self.rng.choice(pool, size=k, replace=False))
        if move == "down":
            self.up[pick] = False
        elif move == "out":
            self.reweight[pick] = 0
        else:
            self.up[pick] = True
            self.reweight[pick] = IN
        return {move: [int(d) for d in pick]}


def initial_map(cfg: dict):
    from ceph_tpu_torch.osd.osdmap import (OSD_EXISTS, OSD_UP,
                                           POOL_TYPE_ERASURE, Incremental,
                                           OSDMap, PGPool)
    n = int(cfg["hosts"]) * int(cfg["per_host"])
    m = OSDMap()
    inc = Incremental(epoch=1)
    inc.new_max_osd = n
    inc.new_crush = build_crush(
        cfg, np.full(n, int(cfg["crush_weight"]), dtype=np.int64))
    inc.new_pools[int(cfg["pool_id"])] = PGPool(
        id=int(cfg["pool_id"]), name="ecpool", type=POOL_TYPE_ERASURE,
        pg_num=int(cfg["pg_num"]), size=pool_size(cfg),
        min_size=int(cfg["k"]) + 1, crush_rule=0,
        erasure_code_profile="k%dm%d" % (int(cfg["k"]), int(cfg["m"])))
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(n):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = IN
    m.apply_incremental(inc)
    return m


def incremental(m, change: dict):
    """The monitor's incremental for one move of the stream."""
    from ceph_tpu_torch.osd.osdmap import OSD_UP
    inc = m.new_incremental()
    for d in change.get("down", ()):
        inc.new_state[d] = OSD_UP           # xor: clears the up bit
    for d in change.get("out", ()):
        inc.new_weight[d] = 0
    for d in change.get("revive", ()):
        inc.new_state[d] = OSD_UP           # xor: sets it again
        inc.new_weight[d] = IN
    return inc


def check_sample(cfg: dict, cell: dict, seed: int) -> np.ndarray:
    return np.sort(rng_for(seed, 5).choice(
        int(cfg["pg_num"]), size=int(cell["check_pgs"]), replace=False))


def run(run: common.Run, device, start: float) -> None:
    import torch
    from ceph_tpu_torch.device.runtime import K_MAPPING, DeviceRuntime
    from ceph_tpu_torch.parallel.mapping import OSDMapMapping
    cfg, cell = run.config, run.cell
    n = int(cfg["hosts"]) * int(cfg["per_host"])
    pool_id = int(cfg["pool_id"])
    stream = DownOutStream(cell["epochs"]["downout"], run.seed, n)
    m = initial_map(cfg)
    chip = DeviceRuntime.get(device).chips[0]
    sample = check_sample(cfg, cell, run.seed)
    spans = run.spans

    def epoch() -> tuple[dict, dict | None]:
        """One epoch's record, and the sample's rows (None if it failed)."""
        with spans.span("next epoch's incremental (mon side)"):
            inc = incremental(m, stream.next())
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
                "isup": stream.up.copy()}
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
    run.add_check("epochs_failed", run.failed, 0)
    run.add_check("pgs_placed_wrong", count_wrong(run, sample), 0)


def reference_rows(cfg: dict, sample: np.ndarray, reweight: np.ndarray,
                   isup: np.ndarray, ignore_out: bool = False):
    """(up, primary) of the sample by the plain reference, for an epoch
    of these reweights and up flags (every device exists)."""
    n = int(cfg["hosts"]) * int(cfg["per_host"])
    tree = reference_tree(
        cfg, np.full(n, int(cfg["crush_weight"]), dtype=np.int64))
    return crush_indep.up_sets(
        tree, cfg["rule"], pool_size(cfg), sample, int(cfg["pg_num"]),
        int(cfg["pool_id"]), reweight, np.ones(n, dtype=bool), isup,
        ignore_out=ignore_out)


def count_wrong(run, sample: np.ndarray) -> int:
    """PGs of the sample, over the kept epochs, whose positional up row
    or up primary differs from the reference's for that epoch's map."""
    if not run.kept:
        raise RuntimeError("no epoch of the window finished")
    wrong = 0
    for i in sorted(run.kept):
        e = run.kept[i]
        up, prim = reference_rows(run.config, sample, e["reweight"],
                                  e["isup"])
        bad = ((e["up"].astype(np.int64) != up).any(axis=1)
               | (e["primary"].astype(np.int64) != prim))
        wrong += int(bad.sum())
    return wrong
