"""Batched upmap balancer: thousands of candidates scored per tick.

Own copy of ceph_tpu/scale/balancer.py, the scale-plane replacement for
the sequential `calc_pg_upmaps` walk (osd/balancer.py): instead of
probing one (PG, overfull, underfull) combination at a time through
python loops, each optimizer round materialises EVERY candidate move —
all PGs holding any overfull OSD x the underfull OSD set — as flat
arrays and scores them in ONE pass on the card (`_score_pass`, a torch
program); the host then greedily commits the best-scoring
non-conflicting moves.

Correctness: scoring only RANKS candidates.  Every accepted move is
re-validated and applied through `BalancerState.try_move` — the exact
raw-vs-up item-rewrite, `_apply_upmap` replay and failure-domain
rules `calc_pg_upmaps` itself uses — so emitted pg_upmap_items are
identical in effect to the sequential optimizer's validity contract
by construction.

Dispatch discipline mirrors parallel/mapping.py: one DispatchTicket
(mapping class, non-blocking admission) per scoring round on the
caller's chip (`chip`, else the runtime's first available one) of the
runtime for `device` (default: the card).  There is no host scoring
route: a full queue raises `DeviceBusy`; a lost chip or a failed
dispatch raises `IOError`, and the failure marks the chip lost (the
runtime's rule in `ChipRuntime.finish`).  `host_rounds` stays 0.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device.runtime import DeviceLost, DeviceRuntime, K_MAPPING
from ..models.crushmap import ITEM_NONE
from ..osd.balancer import BalancerState
from ..osd.osdmap import Incremental, OSDMap

_NO_DOMAIN = -1


@dataclass
class BalancerResult:
    """One batched tick's outcome + telemetry: the stddev before and
    after, the scoring tickets, and the host seconds spent building
    the candidate tables (`build_s`) and committing moves
    (`commit_s`).  `host_rounds` is always 0: no round scores on the
    host."""

    changes: int = 0
    rounds: int = 0
    candidates_scored: int = 0
    device_rounds: int = 0
    host_rounds: int = 0
    stddev_before: float = 0.0
    stddev_after: float = 0.0
    tickets: list = field(default_factory=list)
    build_s: float = 0.0
    commit_s: float = 0.0


def _stddev(counts: dict[int, int], target: dict[int, float]) -> float:
    if not target:
        return 0.0
    dev = np.array([counts[o] - target[o] for o in target], np.float64)
    return float(np.sqrt(np.mean(dev * dev)))


def _score_pass(rows, dom_rows, cand_pg, cand_from, cand_to,
                dev, ok_target, dom_to):
    """The vectorized candidate scorer, on tensors of one device
    (integer and boolean ops, and one float64 difference rounded to
    float32, so every device gives the same verdicts).

    rows      [C, S] int64 effective-up rows per candidate (ITEM_NONE
              pad)
    dom_rows  [C, S] int64 failure domain per row slot (_NO_DOMAIN where
              the pool has no single-domain rule or for padding)
    cand_*    [C] int64 candidate triples (row already gathered per pg)
    dev       [C, 2] float64 deviation of the from/to osds
    ok_target [C] bool: target up+in and not ITEM_NONE
    dom_to    [C] int64 failure domain of the target osd

    Returns (valid [C] bool, score [C] float32): score ranks by
    deviation improvement; invalid candidates score -inf.
    """
    frm = cand_from[:, None]
    to = cand_to[:, None]
    at_from = rows == frm
    member = at_from.any(dim=1)
    absent = (rows != to).all(dim=1)
    # failure-domain validity: replace from's slot domain with the
    # target's, then demand pairwise-unique non-missing domains — only
    # when the pool HAS a single-domain rule (else domains are
    # _NO_DOMAIN across the row and the plain no-duplicate-osd rule
    # applies, like the reference's type-0 stack)
    swapped = torch.where(at_from, dom_to[:, None], dom_rows)
    occupied = rows != ITEM_NONE
    has_dom = (occupied & (dom_rows == _NO_DOMAIN)).sum(dim=1) == 0
    s = rows.shape[1]
    pair = (occupied[:, :, None] & occupied[:, None, :]
            & ~torch.eye(s, dtype=torch.bool, device=rows.device))
    dup = ((swapped[:, :, None] == swapped[:, None, :])
           & pair).flatten(1).any(dim=1)
    osd_swapped = torch.where(at_from, to, rows)
    osd_dup = ((osd_swapped[:, :, None] == osd_swapped[:, None, :])
               & pair).flatten(1).any(dim=1)
    dom_ok = torch.where(has_dom, ~dup, ~osd_dup)
    valid = member & absent & ok_target & dom_ok
    score = (dev[:, 0] - dev[:, 1]).to(torch.float32)
    score = torch.where(valid, score,
                        torch.full_like(score, float("-inf")))
    return valid, score


def _dispatch_score(chip, *arrays):
    """Run one scoring pass on the chip under a mapping-class ticket
    (non-blocking admission, mapping.py's discipline).  Returns (valid,
    score, ticket) as numpy arrays and the ticket; raises DeviceBusy
    when the queue is full and IOError when the chip is lost or the
    dispatch failed (which finishes the ticket failed, so the chip is
    marked lost)."""
    cand = int(arrays[2].shape[0])
    ticket = chip.open_ticket(K_MAPPING, chip.rt.bucket_for(cand),
                              cand * arrays[0].shape[1] * 4)
    try:
        chip.try_admit(ticket)
    except DeviceLost as e:
        raise IOError("balancer dispatch refused: %r" % e) from e
    try:
        chip.launch(ticket)
        placed = [chip.place(a) for a in arrays]
        valid, score = _score_pass(*placed)
        valid = valid.cpu().numpy()
        score = score.cpu().numpy()
    except Exception as e:
        chip.finish(ticket, ok=False, error=e)
        raise IOError("balancer dispatch failed: %r" % e) from e
    chip.finish(ticket, ok=True)
    return valid, score, ticket


def batched_calc_pg_upmaps(osdmap: OSDMap, inc: Incremental,
                           max_deviation: float = 1.0,
                           max_rounds: int = 8,
                           max_changes: int = 64,
                           max_over: int = 64,
                           max_under: int = 64,
                           pools: list[int] | None = None,
                           chip: int | None = None,
                           device=None) -> BalancerResult:
    """The batched optimizer tick: fill inc.new_pg_upmap_items /
    old_pg_upmap_items like calc_pg_upmaps, but evaluate candidates in
    bulk scoring dispatches on `device` (default: the card) instead of
    a sequential walk."""
    res = BalancerResult()
    st = BalancerState(osdmap, pools, device)
    if not st.pool_ids or not st.target:
        return res
    res.stddev_before = _stddev(st.counts, st.target)
    res.stddev_after = res.stddev_before

    # dense per-osd lookup tables (all pools share the osd id space)
    n_osd = osdmap.max_osd
    up_in = np.zeros(n_osd, bool)
    for o in st.target:
        up_in[o] = True
    # per-pool domain tables; ITEM_NONE-safe gather via a pad slot
    dom_tables: dict[int, np.ndarray] = {}
    for pid, domains in st.pg_domains.items():
        tbl = np.full(n_osd + 1, _NO_DOMAIN, np.int64)
        if domains:
            for o, d in domains.items():
                if 0 <= o < n_osd:
                    tbl[o] = d
        dom_tables[pid] = tbl

    pgs = list(st.pg_up)
    pg_index = {pg: i for i, pg in enumerate(pgs)}
    size = max((len(up) for up in st.pg_up.values()), default=0)
    if not pgs or not size:
        return res
    rows = np.full((len(pgs), size), ITEM_NONE, np.int64)
    pool_col = np.empty(len(pgs), np.int64)
    for i, pg in enumerate(pgs):
        up = st.pg_up[pg]
        rows[i, :len(up)] = up
        pool_col[i] = pg.pool

    rt = DeviceRuntime.get(device)
    eps = 1e-4
    for _ in range(max_rounds):
        if res.changes >= max_changes:
            break
        res.rounds += 1
        t_build = time.perf_counter()
        counts = np.zeros(n_osd, np.float64)
        target = np.zeros(n_osd, np.float64)
        for o in st.target:
            counts[o] = st.counts[o]
            target[o] = st.target[o]
        dev = counts - target
        # per-round focus sets: the WORST max_over/max_under osds.
        # At 10k osds the full cross product is tens of millions of
        # candidates per round; the worst-first caps keep one round's
        # table in the tens of thousands while successive rounds walk
        # down the deviation tail (log the cap so a bounded sweep is
        # never mistaken for exhaustive)
        over_osds = sorted((o for o in st.target
                            if dev[o] > max_deviation),
                           key=lambda o: -dev[o])[:max_over]
        under_osds = sorted((o for o in st.target if dev[o] < -eps),
                            key=lambda o: dev[o])[:max_under]
        if not over_osds or not under_osds:
            res.build_s += time.perf_counter() - t_build
            break

        # candidate table: every (pg holding an overfull osd) x
        # (underfull osd) pair, built in one membership pass
        member = np.isin(rows, np.asarray(over_osds)) \
            & (rows != ITEM_NONE)
        pg_i, slot = np.nonzero(member)
        if not pg_i.size:
            res.build_s += time.perf_counter() - t_build
            break
        n_under = len(under_osds)
        cand_pg = np.repeat(pg_i, n_under)
        cand_from = np.repeat(rows[pg_i, slot], n_under)
        cand_to = np.tile(np.asarray(under_osds, np.int64),
                          pg_i.size)
        cand_rows = rows[cand_pg]
        cand_pools = pool_col[cand_pg]
        # domain gather per candidate row (pool-specific tables);
        # ITEM_NONE pads gather the table's pad slot
        dom_rows = np.full_like(cand_rows, _NO_DOMAIN)
        dom_to = np.full(cand_to.shape, _NO_DOMAIN, np.int64)
        safe = np.where((cand_rows >= 0) & (cand_rows < n_osd),
                        cand_rows, n_osd)
        for pid, tbl in dom_tables.items():
            sel = cand_pools == pid
            if sel.any():
                dom_rows[sel] = tbl[safe[sel]]
                dom_to[sel] = tbl[np.clip(cand_to[sel], 0, n_osd)]
        dev_pair = np.stack([dev[np.clip(cand_from, 0, n_osd - 1)],
                             dev[np.clip(cand_to, 0, n_osd - 1)]],
                            axis=1)
        ok_target = (cand_to >= 0) & (cand_to < n_osd) \
            & up_in[np.clip(cand_to, 0, n_osd - 1)]

        arrays = (cand_rows, dom_rows, cand_pg, cand_from, cand_to,
                  dev_pair, ok_target, dom_to)
        res.candidates_scored += int(cand_pg.size)
        res.build_s += time.perf_counter() - t_build
        valid, score, ticket = _dispatch_score(rt.route(chip), *arrays)
        res.tickets.append(ticket)
        res.device_rounds += 1

        t_commit = time.perf_counter()
        order = np.argsort(-score, kind="stable")
        moved_pgs: set[int] = set()
        round_moves = 0
        for ci in order:
            if not valid[ci] or score[ci] <= 0:
                break
            if res.changes >= max_changes:
                break
            i = int(cand_pg[ci])
            if i in moved_pgs:
                continue
            over = int(cand_from[ci])
            under = int(cand_to[ci])
            # deviation drift within the round: a move only stays
            # worthwhile while its endpoints remain over/underfull
            if dev[over] <= max_deviation or dev[under] >= -eps:
                continue
            new_row = st.try_move(pgs[i], over, under)
            if new_row is None:
                continue
            moved_pgs.add(i)
            rows[i, :] = ITEM_NONE
            rows[i, :len(new_row)] = new_row
            dev[over] -= 1.0
            dev[under] += 1.0
            res.changes += 1
            round_moves += 1
        res.commit_s += time.perf_counter() - t_commit
        if not round_moves:
            break

    st.fill_incremental(inc)
    res.stddev_after = _stddev(st.counts, st.target)
    return res
