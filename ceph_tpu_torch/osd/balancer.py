"""Upmap balancer: calc_pg_upmaps.

Own copy of ceph_tpu/osd/balancer.py, the condensed analog of
OSDMap::calc_pg_upmaps (src/osd/OSDMap.cc:5159) — the flagship consumer
of bulk mapping (the mgr balancer module drives it): compute every PG's
up set through the device bulk mapper, measure
per-OSD deviation from the weight-proportional target, and emit
pg_upmap_items exceptions that move PGs from overfull to underfull
OSDs until the deviation is within max_deviation or no further
progress is possible.

Placement correctness mirrors the reference's candidate validation
(try_pg_upmap + _choose_type_stack cleaning, CrushWrapper.h:1529):

* a move must not put two up-set members into the same failure domain
  (the rule's chooseleaf type), validated against the crush tree;
* the remap target must be up+in and absent from the PG's up set;
* item rewrites are computed against the RAW (pre-upmap) mapping: an
  existing (X -> over) exception is rewritten to (X -> under), never
  stacked as (over -> under) — the raw set does not contain `over`,
  so a stacked item would be a no-op and removing the old one would
  silently bounce the PG back (OSDMap::calc_pg_upmaps does the same
  raw-vs-up bookkeeping).

The prologue (`BalancerState`) maps every pool on `device` (default:
the card; raises without one unless device="cpu"), each pass under a
mapping-class ticket on the runtime's first available chip, as
`OSDMapMapping` does.  A map outside the device mapper's scope (a
non-straw2 bucket, a multi-choose rule: `OutOfDeviceScope`) is a
property of the map, not a failure: its pools take the exact host
engine, as in the reference.  Everything else — a full queue
(`DeviceBusy`), a lost chip (`DeviceLost`), a failed pass — propagates.
"""

from __future__ import annotations

import numpy as np

from ..device.runtime import DeviceRuntime, K_MAPPING
from ..models.crushmap import (CHOOSE_FIRSTN, CHOOSE_INDEP,
                               CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP,
                               ITEM_NONE)
from ..ops.crush.device import OutOfDeviceScope
from .osdmap import (FLAG_HASHPSPOOL, OSD_EXISTS, OSD_UP, Incremental,
                     OSDMap, pg_t)


def _failure_domains(osdmap: OSDMap, ruleno: int) -> dict[int, int] | None:
    """osd -> failure-domain bucket id for the rule's chooseleaf type,
    or None when the rule spreads over devices directly (type 0) or
    has no single choose step (validation then only blocks duplicate
    OSDs, like the reference's type-0 stack)."""
    rule = osdmap.crush.rules.get(ruleno)
    if rule is None:
        return None
    want_type = None
    for op, arg1, arg2 in rule.steps:
        if op in (CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP,
                  CHOOSE_FIRSTN, CHOOSE_INDEP):
            if want_type is not None:
                return None          # multi-step: no single domain
            want_type = arg2
    if not want_type:
        return None
    domains: dict[int, int] = {}

    def walk(bid: int, domain: int | None) -> None:
        b = osdmap.crush.buckets.get(bid)
        if b is None:
            return
        d = bid if b.type == want_type else domain
        for child in b.items:
            if child < 0:
                walk(child, d)
            elif d is not None:
                domains[child] = d

    children = {c for b in osdmap.crush.buckets.values()
                for c in b.items if c < 0}
    for bid in osdmap.crush.buckets:
        if bid not in children:
            walk(bid, None)
    return domains


def _apply_items(osdmap: OSDMap, raw: list[int],
                 items: list[tuple[int, int]]) -> list[int]:
    """Mirror of OSDMap._apply_upmap's pg_upmap_items pass: an item
    applies only when its target is absent from the row, its source
    present, and the target not weighted out."""
    row = list(raw)
    for osd_from, osd_to in items or ():
        if osd_to in row:
            continue
        if (osd_to != ITEM_NONE and 0 <= osd_to < osdmap.max_osd
                and osdmap.osd_weight[osd_to] == 0):
            continue
        for i, o in enumerate(row):
            if o == osd_from:
                row[i] = osd_to
                break
    return row


def _effective_up(osdmap: OSDMap, raw: list[int],
                  items: list[tuple[int, int]]) -> list[int]:
    row = _apply_items(osdmap, raw, items)
    return [o for o in row
            if o != ITEM_NONE and osdmap.exists(o) and osdmap.is_up(o)]


def _pool_raw(osdmap: OSDMap, pool, device=None) -> list[list[int]]:
    """Pre-upmap raw rows (down OSDs included, like _pg_to_raw_osds)
    for every PG: the bulk mapper's MapState on `device` under a
    mapping-class ticket, or the host engine for a map outside device
    scope.  Only building the mapper and the rule's plan decides the
    scope; a failure after that propagates."""
    try:
        dm = osdmap.device_mapper(device)
        dm._plan(pool.crush_rule, pool.size)
    except OutOfDeviceScope:
        rows = []
        for ps in range(pool.pg_num):
            raw, _pps = osdmap._pg_to_raw_osds(pool, pg_t(pool.id, ps))
            rows.append([o for o in raw if o != ITEM_NONE])
        return rows
    chip = DeviceRuntime.get(dm.device).route(None)
    ticket = chip.open_ticket(K_MAPPING, chip.rt.bucket_for(pool.pg_num),
                              pool.pg_num * pool.size * 4)
    chip.try_admit(ticket)
    try:
        chip.launch(ticket)
        state = np.asarray(osdmap.osd_state, dtype=np.int32)
        st = dm.map_pool_state(
            pool.crush_rule, pool.size, pool.pg_num, pool.pgp_num,
            pool.pgp_num_mask, pool.id,
            bool(pool.flags & FLAG_HASHPSPOOL), osdmap.osd_weight,
            (state & OSD_EXISTS) != 0, (state & OSD_UP) != 0, None,
            pool.can_shift_osds())
        raw_np = st.raw[:pool.pg_num].cpu().numpy()
    except Exception as e:
        chip.finish(ticket, ok=False, error=e)
        raise
    chip.finish(ticket, ok=True)
    return [[o for o in row if o != ITEM_NONE]
            for row in raw_np.tolist()]


class BalancerState:
    """The shared prologue of both optimizers (sequential
    calc_pg_upmaps and the batched scale-plane scorer): raw and
    effective-up rows per PG, pg_upmap-pinned placements, per-pool
    failure domains, the cleaned existing-items table, and the
    weight-proportional target/deviation accounting."""

    __slots__ = ("osdmap", "pool_ids", "pg_raw", "pg_up", "pinned",
                 "pg_domains", "existing", "new_items", "weights",
                 "target", "counts")

    def __init__(self, osdmap: OSDMap, pools: list[int] | None,
                 device=None):
        self.osdmap = osdmap
        pool_ids = sorted(pools if pools is not None
                          else osdmap.pools)
        self.pool_ids = [p for p in pool_ids if p in osdmap.pools]
        self.pg_raw: dict[pg_t, list[int]] = {}
        self.pg_up: dict[pg_t, list[int]] = {}
        self.pinned: dict[pg_t, list[int]] = {}
        self.pg_domains: dict[int, dict[int, int] | None] = {}
        for pid in self.pool_ids:
            pool = osdmap.pools[pid]
            raw_rows = _pool_raw(osdmap, pool, device)
            self.pg_domains[pid] = _failure_domains(osdmap,
                                                    pool.crush_rule)
            for ps in range(pool.pg_num):
                pg = pg_t(pid, ps)
                if pg in osdmap.pg_upmap:
                    # explicit pg_upmap pins override items entirely
                    # (OSDMap._apply_upmap); count their real
                    # placement but never try to move them
                    up, _, _, _ = osdmap.pg_to_up_acting_osds(pg)
                    self.pinned[pg] = up
                    continue
                self.pg_raw[pg] = raw_rows[ps]
                self.pg_up[pg] = _effective_up(
                    osdmap, raw_rows[ps],
                    osdmap.pg_upmap_items.get(pg, []))

        # weight-proportional target over up+in osds
        self.weights = {o: osdmap.osd_weight[o] / 0x10000
                        for o in range(osdmap.max_osd)
                        if osdmap.is_up(o) and osdmap.is_in(o)}
        total_w = sum(self.weights.values())
        total_placements = (
            sum(len(up) for up in self.pg_up.values())
            + sum(len(up) for up in self.pinned.values()))
        self.target = ({o: total_placements * w / total_w
                        for o, w in self.weights.items()}
                       if total_w > 0 else {})
        self.counts = {o: 0 for o in self.weights}
        for ups in (self.pg_up, self.pinned):
            for up in ups.values():
                for o in up:
                    if o in self.counts:
                        self.counts[o] += 1

        self.existing = {pg: items
                         for pg, items in osdmap.pg_upmap_items.items()
                         if pg.pool in set(self.pool_ids)}
        # retire no-op entries up front (source left the raw set or
        # the item no longer applies) — the reference's
        # clean_pg_upmaps pass
        self.new_items: dict[pg_t, list[tuple[int, int]]] = {}
        for pg, items in self.existing.items():
            if pg in self.pinned:
                self.new_items[pg] = list(items)  # pg_upmap mask: keep
                continue
            raw = self.pg_raw.get(pg, [])
            row = list(raw)
            kept = []
            for f, t in items:
                if f in row and t not in row:
                    row = [t if o == f else o for o in row]
                    kept.append((f, t))
            self.new_items[pg] = kept

    def row_valid(self, pg: pg_t, row: list[int]) -> bool:
        if len(set(row)) != len(row):
            return False
        domains = self.pg_domains.get(pg.pool)
        if domains is None:
            return True
        doms = [domains.get(o) for o in row]
        return None not in doms and len(set(doms)) == len(doms)

    def try_move(self, pg: pg_t, over: int,
                 under: int) -> list[int] | None:
        """Attempt the move `over` -> `under` for one PG through the
        EXACT reference validity rules (raw-vs-up item rewrite,
        _apply_upmap replay, failure-domain validation).  On success
        the state (items, up row, counts) is updated and the new
        effective up row returned; None = invalid, state untouched.
        Both optimizers commit moves ONLY through here, so their
        emitted items are identical in effect by construction."""
        up = self.pg_up.get(pg)
        if up is None or over not in up or under in up:
            return None
        raw = self.pg_raw[pg]
        # rewrite against the RAW mapping: if `over` is a raw member,
        # add (over, under); else an existing item (X -> over) must
        # exist — rewrite it to (X -> under), never stack
        # (over -> under) no-ops
        items = [t for t in self.new_items.get(pg, [])
                 if t[1] != over]
        if over in raw:
            items = [t for t in items if t[0] != over]
            items.append((over, under))
        else:
            src = next((f for f, t in self.new_items.get(pg, [])
                        if t == over), None)
            if src is None or src not in raw:
                return None
            items = [t for t in items if t[0] != src]
            items.append((src, under))
        # the REAL effect of the new item list (replayed via
        # _apply_upmap semantics over the raw row) is what must be
        # validated and accounted — dropping an item can silently
        # restore its source, so the old up row is not a reliable base
        new_row = _effective_up(self.osdmap, raw, items)
        if over in new_row or not self.row_valid(pg, new_row):
            return None
        if sum(1 for o in new_row if o == under) != 1:
            return None
        self.new_items[pg] = items
        for o in up:
            if o in self.counts:
                self.counts[o] -= 1
        for o in new_row:
            if o in self.counts:
                self.counts[o] += 1
        self.pg_up[pg] = new_row
        return new_row

    def fill_incremental(self, inc: Incremental) -> None:
        for pg, items in self.new_items.items():
            if items != self.existing.get(pg, []):
                if items:
                    inc.new_pg_upmap_items[pg] = items
                elif pg in self.existing:
                    inc.old_pg_upmap_items.append(pg)
        for pg in self.existing:
            if pg not in self.new_items:
                inc.old_pg_upmap_items.append(pg)


def calc_pg_upmaps(osdmap: OSDMap, inc: Incremental,
                   max_deviation: float = 1.0,
                   max_iterations: int = 100,
                   pools: list[int] | None = None,
                   device=None) -> int:
    """Fill inc.new_pg_upmap_items / old_pg_upmap_items; returns the
    number of changes (OSDMap.cc:5159 contract).  The prologue maps on
    `device` (default: the card)."""
    st = BalancerState(osdmap, pools, device)
    if not st.pool_ids or not st.target:
        return 0

    changes = 0
    for _ in range(max_iterations):
        deviations = {o: st.counts[o] - st.target[o]
                      for o in st.counts}
        over = max(deviations, key=lambda o: deviations[o])
        if deviations[over] <= max_deviation:
            break
        under_sorted = sorted(deviations, key=lambda o: deviations[o])
        moved = False
        for pg, up in st.pg_up.items():
            if over not in up:
                continue
            for under in under_sorted:
                if deviations[under] >= -0.0001:
                    break  # nobody meaningfully underfull
                if under in up:
                    continue
                if st.try_move(pg, over, under) is None:
                    continue
                changes += 1
                moved = True
                break
            if moved:
                break
        if not moved:
            break

    st.fill_incremental(inc)
    return changes
