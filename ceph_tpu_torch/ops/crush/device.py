"""Bulk CRUSH mapping on the card: every PG of a pool is one lane.

Counterpart of ceph_tpu/ops/crush/device.py, the replacement for the
reference's threaded bulk mapper (src/osd/OSDMapMapping.h:18-120
ParallelPGMapper) and the inner loops it shards (crush_do_rule /
crush_choose_firstn / crush_choose_indep, src/crush/mapper.c:438-821).
Results are bit-identical to the host engine (``ops.crush.host``) and
the reference golden vectors.

The straw2 draw is exact: ``trunc((crush_ln(u) - 2^48) / w)`` in 64-bit
integers, as the host engine computes it, taken without a division from
a per-weight reciprocal and one integer correction.  So no draw is ever
uncertain, and the machinery a 32-bit float draw needs — certainty
bounds, exact top-k resolution, a scalar host fallback for the residue
— has no counterpart here.

The whole choose step of a lane — the descents, collision checks,
reweight rejection, chooseleaf recursion and retry loops
(mapper.c:438-821) — is one thread of K4 (``kernels.choose``), so a
pass over a chunk of lanes is one launch and no lane is left
unfinished.  The post-CRUSH filter is K5 (``kernels.post``) for pools
without primary affinity; ``MapState.remap`` finds the lanes a
cluster-state change touches with K6 (``kernels.hitscan``) and K7
(``kernels.rowcompact``) and recomputes only those.

Device scope (the modern "optimal" tunables profile): straw2 buckets at
every level, choose_local_tries == choose_local_fallback_tries == 0,
rules of shape TAKE -> one CHOOSE/CHOOSELEAF step -> EMIT, descents of
at most ``kernels.MAX_LEVELS`` (16) levels.  A map or rule outside it
raises ``OutOfDeviceScope`` (a ValueError) when the mapper or a rule's
plan is built; the host engine remains the general spec.

Every tensor lives on the mapper's device (the card unless the caller
passes ``device="cpu"``, which runs the kernels' plain versions).  The
entry points run under ``torch.inference_mode`` (no autograd
bookkeeping per operation), so a MapState's tensors are inference
tensors: read them, or clone them before writing.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import default_device
from ...models.crushmap import (
    CHOOSE_FIRSTN,
    CHOOSE_INDEP,
    CHOOSELEAF_FIRSTN,
    CHOOSELEAF_INDEP,
    EMIT,
    ITEM_NONE,
    SET_CHOOSE_TRIES,
    SET_CHOOSELEAF_TRIES,
    SET_CHOOSELEAF_STABLE,
    SET_CHOOSELEAF_VARY_R,
    STRAW2,
    TAKE,
    CrushMap,
)
from ...trace.recorder import HostSpan
from . import kernels as K

M32 = K.M32

CEPH_OSD_MAX_PRIMARY_AFFINITY = 0x10000
CEPH_OSD_DEFAULT_PRIMARY_AFFINITY = 0x10000


class OutOfDeviceScope(ValueError):
    """The map or rule lies outside the device mapper's scope (see the
    module doc): a property of the map, which callers may answer with
    the host engine, unlike a failed pass."""

# ---------------------------------------------------------------------------
# flattened map
# ---------------------------------------------------------------------------


class FlatMap:
    """CrushMap flattened to dense arrays (bucket index bid = -1 - id),
    held on the device as ``tables`` (kernels.CrushTables)."""

    def __init__(self, m: CrushMap, choose_args_name: str | None = None,
                 device=None):
        for b in m.buckets.values():
            if b.alg != STRAW2:
                raise OutOfDeviceScope(
                    "device mapper requires straw2 buckets (bucket %d has "
                    "alg %d)" % (b.id, b.alg))
        t = m.tunables
        if t.choose_local_tries or t.choose_local_fallback_tries:
            raise OutOfDeviceScope(
                "device mapper requires local tries == 0")
        B = m.max_buckets or 1
        S = max((b.size for b in m.buckets.values()), default=1) or 1
        self.B, self.S = B, S
        self.max_devices = m.max_devices
        self.tunables = t
        size = np.zeros(B, np.int32)
        btype = np.zeros(B, np.int32)
        items = np.zeros((B, S), np.int32)
        ids = np.zeros((B, S), np.int32)
        cargs = (m.choose_args.get(choose_args_name)
                 if choose_args_name else None)
        n_pos = 1
        if cargs:
            n_pos = max((len(ws.weight_sets) for ws in cargs.values()
                         if ws.weight_sets), default=1) or 1
        pos_w = np.zeros((n_pos, B, S), np.int64)
        for b in m.buckets.values():
            bid = -1 - b.id
            size[bid] = b.size
            btype[bid] = b.type
            items[bid, :b.size] = b.items
            ids[bid, :b.size] = b.items
            for p in range(n_pos):
                pos_w[p, bid, :b.size] = b.item_weights
            if cargs and b.id in cargs:
                ws = cargs[b.id]
                if ws.ids is not None:
                    ids[bid, :b.size] = ws.ids
                if ws.weight_sets:
                    for p in range(n_pos):
                        src = ws.weight_sets[min(p, len(ws.weight_sets) - 1)]
                        pos_w[p, bid, :b.size] = src
        depth: dict[int, int] = {}

        def _depth(bid_id: int) -> int:
            if bid_id in depth:
                return depth[bid_id]
            b = m.buckets[bid_id]
            d = 1 + max((_depth(i) for i in b.items if i < 0), default=0)
            depth[bid_id] = d
            return d

        self.max_depth = max((_depth(i) for i in m.buckets), default=1)
        self.n_pos = n_pos
        self.rules = dict(m.rules)
        self._ids_np = ids
        self._items_np = items
        self._w_np = pos_w
        self._size_np = size
        self._btype_np = btype
        self.tables = K.CrushTables(items, ids, pos_w, size, btype,
                                    m.max_devices, default_device(device))


# ---------------------------------------------------------------------------
# post-CRUSH pipeline
# ---------------------------------------------------------------------------


def _post_process(raw, seeds, keep, aff, can_shift: bool):
    """_remove_nonexistent_osds + _raw_to_up_osds + _pick_primary +
    _apply_primary_affinity (OSDMap.cc:2626-2802) over the whole batch.

    raw int32 [L, S] with ITEM_NONE holes; seeds int64 [L] pps values
    (read only with affinities); keep bool [D] exists & up; aff int32
    [D] 16.16 primary affinities or None.  The filter, compaction and
    first-survivor primary are K5; the affinity form adjusts its result
    here.  Only valid for PGs with no upmap/pg_temp exception (the bulk
    mapper recomputes those rows on the host scalar path)."""
    up, prim = K.post(raw.contiguous(), keep, can_shift)
    if aff is None:
        return up, prim
    D = keep.shape[0]
    L, S = up.shape
    slots = torch.arange(S, device=up.device)
    nonnone = up != ITEM_NONE
    has = nonnone.any(dim=1)
    first = K.first_slot(nonnone).clamp(max=S - 1)
    a = aff[up.clamp(0, D - 1).to(torch.int64)].to(torch.int64)
    row_applies = (nonnone & (a != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY)).any(
        dim=1)
    h = K.hash32_2(seeds[:, None], up.to(torch.int64) & M32) >> 16
    rejected = (a < CEPH_OSD_MAX_PRIMARY_AFFINITY) & (h >= a)
    accept = nonnone & ~rejected
    pos = torch.where(accept.any(dim=1),
                      K.first_slot(accept).clamp(max=S - 1), first)
    applies = row_applies & has
    new_prim = up.gather(1, pos[:, None])[:, 0]
    prim = torch.where(applies, new_prim, prim)
    if can_shift:
        # move the new primary to the front, shifting [0..pos) right
        i = slots[None, :]
        rotated = torch.where(
            i == 0, new_prim[:, None],
            torch.where(i <= pos[:, None], torch.roll(up, 1, dims=1), up))
        up = torch.where(applies[:, None], rotated, up)
    return up.contiguous(), prim


# ---------------------------------------------------------------------------
# rule driver
# ---------------------------------------------------------------------------


class _Cluster:
    """The per-call cluster state on the device."""

    __slots__ = ("w", "keep", "aff")

    def __init__(self, w, keep, aff):
        self.w = w
        self.keep = keep
        self.aff = aff


class MapState:
    """Result of a whole-pool mapping pass, on the device: the raw
    (pre-filter) rows, the up rows and primaries, plus the host-side
    inputs needed to validate incremental remaps.

    Incremental validity (remap): with the crush map fixed, a lane's
    draw sequence depends only on (x, r) and the reweight rejections
    (mapper.c:402-416).  A rejection outcome changes only for OSDs
    whose reweight changed; under a DECREASE every lane that ever
    accepted the OSD carries it in a raw result slot (a pick either
    lands in the row or collides with an earlier slot holding the same
    OSD), so lanes without a changed OSD in their raw row replay the
    identical sequence.  Up/down/affinity changes only affect the
    post-CRUSH filter, which also reads the raw row.  Reweight
    INCREASES flip previously-hash-rejected lanes that are not
    identifiable from the rows — those take a full pass.

    ``recomputed`` counts the lanes recomputed after the pass's
    full-width choose: 0 for a full pass (K4 takes every lane's retries
    to their end in its one launch per chunk), the touched lanes for an
    incremental remap."""

    __slots__ = ("dm", "ruleno", "result_max", "pg_num", "pgp_num",
                 "pgp_mask", "pool_id", "hashps", "can_shift",
                 "use_aff", "raw", "up", "prim", "w_np", "ex_np",
                 "iu_np", "af_np", "recomputed")

    def __init__(self, dm, ruleno, result_max, pg_num, pgp_num,
                 pgp_mask, pool_id, hashps, can_shift, use_aff, raw, up,
                 prim, w_np, ex_np, iu_np, af_np, recomputed):
        self.dm = dm
        self.ruleno = ruleno
        self.result_max = result_max
        self.pg_num = pg_num
        self.pgp_num = pgp_num
        self.pgp_mask = pgp_mask
        self.pool_id = pool_id
        self.hashps = hashps
        self.can_shift = can_shift
        self.use_aff = use_aff
        self.raw = raw          # [pg_num, slots] int32, before the filter
        self.up = up            # [pg_num, slots] int32
        self.prim = prim        # [pg_num] int32
        self.w_np = w_np
        self.ex_np = ex_np
        self.iu_np = iu_np
        self.af_np = af_np
        self.recomputed = recomputed

    @torch.inference_mode()
    def remap(self, dev_weights, exists, isup, aff=None) -> "MapState":
        """New MapState after a cluster-state change, recomputing only
        the affected lanes when the change qualifies (see the class
        doc); otherwise a full pass."""
        use_aff = aff is not None
        w_np, ex_np, iu_np, af_np = _host_state(dev_weights, exists, isup,
                                                aff)

        def full():
            return self.dm.map_pool_state(
                self.ruleno, self.result_max, self.pg_num,
                self.pgp_num, self.pgp_mask, self.pool_id, self.hashps,
                w_np, ex_np, iu_np, aff, self.can_shift)

        if (use_aff != self.use_aff
                or w_np.shape != self.w_np.shape
                or ex_np.shape != self.ex_np.shape):
            return full()
        changed = ((w_np != self.w_np) | (ex_np != self.ex_np)
                   | (iu_np != self.iu_np) | (af_np != self.af_np))
        if not changed.any():
            return self
        if (w_np > self.w_np).any():
            return full()        # reweight increase: not incremental
        dm = self.dm
        cl = dm._cluster(w_np, ex_np, iu_np, af_np, use_aff)
        hit = K.hitscan(self.raw, dm._put(changed))
        # expected hits per row group: a lane is hit if any of its S raw
        # slots holds a changed OSD; size the slots with a ~6-sigma
        # margin (an overflow is seen in cnt and retried wider)
        frac = float(changed.sum()) / max(1, ex_np.shape[0])
        mu = dm.RC_ROW * min(1.0, int(self.raw.shape[1]) * frac)
        kt = 128 * int(-(-(mu + 6.0 * mu ** 0.5 + 16.0) // 128))
        lanes = dm._compact(hit, self.pg_num, min(kt, dm.RC_ROW))
        raw, up, prim = (self.raw.clone(), self.up.clone(),
                         self.prim.clone())
        dm._settle(dm._plan(self.ruleno, self.result_max),
                   K.PpsSeeds(self.pgp_num, self.pgp_mask, self.pool_id,
                              self.hashps),
                   raw, up, prim, cl, self.can_shift, lanes=lanes)
        return MapState(
            dm, self.ruleno, self.result_max, self.pg_num,
            self.pgp_num, self.pgp_mask, self.pool_id, self.hashps,
            self.can_shift, self.use_aff, raw, up, prim, w_np,
            ex_np, iu_np, af_np, int(lanes.numel()))


def _host_state(dev_weights, exists, isup, aff):
    w_np = np.asarray(dev_weights, dtype=np.int32)
    ex_np = np.asarray(exists, dtype=bool)
    iu_np = np.asarray(isup, dtype=bool)
    af_np = (np.asarray(aff, dtype=np.int32) if aff is not None
             else np.zeros((ex_np.shape[0],), np.int32))
    return w_np, ex_np, iu_np, af_np


class DeviceMapper:
    """Bulk do_rule on the device for straw2 maps with single-choose
    rules.

    do_rule_batch(ruleno, xs, result_max, dev_weights) mirrors
    CrushWrapper::do_rule over a whole batch of inputs; results carry
    ITEM_NONE holes exactly like the host engine.  map_pool_state maps
    a whole pool (K4 hashes each PG's pps seed in the PG's thread)
    through the post-CRUSH pipeline and keeps the result on the device
    for incremental remaps.
    """

    # lanes per K4 launch: bounds each launch's scratch (chooseleaf's
    # outer picks, K5's up rows and primaries) beside the pool's rows
    CHUNK = 1 << 20
    # rowcompact geometry: lanes per row group
    RC_ROW = 2048

    def __init__(self, crushmap: CrushMap,
                 choose_args_name: str | None = None, device=None):
        self.device = default_device(device)
        self.fm = FlatMap(crushmap, choose_args_name, self.device)
        self.map = crushmap
        self._plans: dict[tuple, K.ChoosePlan] = {}

    def _put(self, a, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, dtype=dtype)

    def _cluster(self, w_np, ex_np, iu_np, af_np, use_aff) -> _Cluster:
        return _Cluster(self._put(w_np, torch.int32),
                        self._put(ex_np & iu_np),
                        self._put(af_np, torch.int32) if use_aff else None)

    def _plan(self, ruleno: int, result_max: int) -> K.ChoosePlan:
        key = (ruleno, result_max)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = self._make_plan(ruleno, result_max)
        return plan

    def _make_plan(self, ruleno: int, result_max: int) -> K.ChoosePlan:
        rule = self.fm.rules[ruleno]
        t = self.fm.tunables
        tries = t.choose_total_tries + 1     # historical off-by-one
        leaf_tries = 0
        vary_r = t.chooseleaf_vary_r
        stable = t.chooseleaf_stable
        take_id = None
        plan = None
        for op, arg1, arg2 in rule.steps:
            if op == TAKE:
                take_id = arg1
            elif op == SET_CHOOSE_TRIES:
                if arg1 > 0:
                    tries = arg1
            elif op == SET_CHOOSELEAF_TRIES:
                if arg1 > 0:
                    leaf_tries = arg1
            elif op == SET_CHOOSELEAF_VARY_R:
                if arg1 >= 0:
                    vary_r = arg1
            elif op == SET_CHOOSELEAF_STABLE:
                if arg1 >= 0:
                    stable = arg1
            elif op in (CHOOSE_FIRSTN, CHOOSELEAF_FIRSTN,
                        CHOOSE_INDEP, CHOOSELEAF_INDEP):
                if plan is not None:
                    raise OutOfDeviceScope(
                        "device mapper supports a single choose step")
                if take_id is None or take_id >= 0:
                    raise OutOfDeviceScope(
                        "choose without a bucket take")
                numrep = arg1
                if numrep <= 0:
                    numrep += result_max
                firstn = op in (CHOOSE_FIRSTN, CHOOSELEAF_FIRSTN)
                leaf = op in (CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP)
                plan = (take_id, numrep, arg2, firstn, leaf)
            elif op == EMIT:
                pass
        if plan is None:
            raise OutOfDeviceScope("rule has no choose step")
        take_id, numrep, want_type, firstn, leaf = plan
        if firstn:
            recurse = (leaf_tries if leaf_tries
                       else (1 if t.chooseleaf_descend_once else tries))
        else:
            recurse = leaf_tries if leaf_tries else 1
        outer_ds = self._depth_sizes([take_id], want_type)
        if leaf:
            starts = [b.id for b in self.map.buckets.values()
                      if b.type == want_type]
            inner_ds = self._depth_sizes(starts, 0)
        else:
            inner_ds = ()
        return K.ChoosePlan(take_id=take_id, numrep=numrep,
                            want_type=want_type, firstn=firstn, leaf=leaf,
                            tries=tries, recurse=recurse, vary_r=vary_r,
                            stable=stable, outer_ds=outer_ds,
                            inner_ds=inner_ds,
                            slots=min(numrep, result_max))

    def _depth_sizes(self, start_bucket_ids: list[int],
                     want_type: int) -> tuple:
        """depth_sizes[d] = max size of any bucket reachable at depth d
        by walking bucket children from the start set (static per
        rule/map).  The walk stops once no child bucket can continue
        the descent — children of the wanted type are terminal (the
        draw 'reach'es them), so e.g. a root->host chooseleaf descent
        costs one draw level, not the tree height."""
        m = self.map
        sizes = []
        level = {b for b in start_bucket_ids if b in m.buckets}
        seen_levels = 0
        while level and seen_levels < 64:    # cycle guard
            sizes.append(max(
                (m.buckets[b].size for b in level), default=1) or 1)
            level = {c for b in level for c in m.buckets[b].items
                     if c < 0 and c in m.buckets
                     and m.buckets[c].type != want_type}
            seen_levels += 1
        return tuple(sizes) if sizes else (1,)

    def _compact(self, hit, pg_num: int, kt: int):
        """Hit lanes in ascending order, through K7 (the slot count
        widened while a row group overflows it)."""
        while True:
            idx, valid, cnt = K.rowcompact(hit, self.RC_ROW, kt, pg_num)
            rowmax = int(cnt.max()) if cnt.numel() else 0
            if rowmax <= kt:
                break
            kt = min(self.RC_ROW, 128 * (-(-rowmax * 2 // 128)))
        return idx[valid].to(torch.int64)

    def _settle(self, p: K.ChoosePlan, pps: K.PpsSeeds, raw, up, prim,
                cl: _Cluster, can_shift, lanes=None,
                marks: list | None = None):
        """Map lanes and write their rows back: every row of `raw`
        (`lanes` None, written by slices) or the ps values of the int64
        tensor `lanes` (written by index).  Per CHUNK lanes, one K4
        launch, whose threads hash their lanes' pps seeds from `pps`,
        and the post-CRUSH filter.  `marks`, where given, takes a
        (start, end) pair of stamps around each K4 launch
        (`kernels.choose`)."""
        n = raw.shape[0] if lanes is None else lanes.numel()
        for lo in range(0, n, self.CHUNK):
            hi = min(n, lo + self.CHUNK)
            if lanes is None:
                at = slice(lo, hi)
                seeds = pps._replace(base=lo, count=hi - lo)
            else:
                at = lanes[lo:hi]
                seeds = pps._replace(lanes=at)
            with HostSpan("map.choose", {"lanes": hi - lo,
                                         "slots": p.slots,
                                         "indep": int(not p.firstn)}):
                # the seeds come back only where the primary affinity
                # filter reads them
                xs = (torch.empty(hi - lo, dtype=torch.int64,
                                  device=self.device)
                      if cl.aff is not None else None)
                r = K.choose(self.fm.tables, p, None, cl.w, pps=seeds,
                             xs_out=xs, marks=marks)
            with HostSpan("map.post"):
                u, pr = _post_process(r, xs, cl.keep, cl.aff, can_shift)
                raw[at] = r
                up[at] = u
                prim[at] = pr

    def map_pool_batch(self, ruleno: int, result_max: int, pg_num: int,
                       pgp_num: int, pgp_num_mask: int, pool_id: int,
                       hashpspool: bool, dev_weights, exists, isup,
                       aff=None, can_shift: bool = True,
                       marks: list | None = None):
        """Whole-pool pg->up pipeline as dense numpy arrays; thin
        wrapper over map_pool_state (which keeps everything on the
        device for consumers that chain incremental remaps)."""
        state = self.map_pool_state(
            ruleno, result_max, pg_num, pgp_num, pgp_num_mask, pool_id,
            hashpspool, dev_weights, exists, isup, aff, can_shift,
            marks=marks)
        with HostSpan("map.copyout",
                      {"bytes": state.up.nbytes + state.prim.nbytes}):
            return state.up.cpu().numpy(), state.prim.cpu().numpy()

    @torch.inference_mode()
    def map_pool_state(self, ruleno: int, result_max: int, pg_num: int,
                       pgp_num: int, pgp_num_mask: int, pool_id: int,
                       hashpspool: bool, dev_weights, exists, isup,
                       aff=None, can_shift: bool = True,
                       marks: list | None = None) -> MapState:
        """Full pass returning a MapState: `_settle` over every lane."""
        use_aff = aff is not None
        with HostSpan("map.upload") as span:
            w_np, ex_np, iu_np, af_np = _host_state(dev_weights, exists,
                                                    isup, aff)
            cl = self._cluster(w_np, ex_np, iu_np, af_np, use_aff)
            span.counts = {"bytes": w_np.nbytes + ex_np.nbytes
                           + (af_np.nbytes if use_aff else 0)}
        p = self._plan(ruleno, result_max)
        raw = torch.empty((pg_num, p.slots), dtype=torch.int32,
                          device=self.device)
        up = torch.empty_like(raw)
        prim = torch.empty(pg_num, dtype=torch.int32, device=self.device)
        self._settle(p, K.PpsSeeds(int(pgp_num), int(pgp_num_mask),
                                   int(pool_id), bool(hashpspool)),
                     raw, up, prim, cl, can_shift, marks=marks)
        return MapState(
            self, ruleno, result_max, pg_num, pgp_num, pgp_num_mask,
            pool_id, bool(hashpspool), bool(can_shift), use_aff,
            raw, up, prim, w_np, ex_np, iu_np, af_np, 0)

    @torch.inference_mode()
    def do_rule_batch(self, ruleno: int, xs, result_max: int,
                      dev_weights) -> np.ndarray:
        """xs: int array [L] of inputs (pps values); dev_weights: int32
        [max_devices] 16.16 reweights.  Returns [L, numrep] int32 with
        ITEM_NONE holes."""
        p = self._plan(ruleno, result_max)
        xs_t = self._put(np.asarray(xs, dtype=np.int64) & M32)
        w = self._put(np.asarray(dev_weights, dtype=np.int32))
        out = []
        for lo in range(0, xs_t.shape[0], self.CHUNK):
            out.append(K.choose(self.fm.tables, p,
                                xs_t[lo:lo + self.CHUNK], w))
        if not out:
            return np.zeros((0, p.slots), np.int32)
        return torch.cat(out).cpu().numpy()


def load_reference_state(state: dict, device=None):
    """The reference's map and cluster state -> the port's DeviceMapper
    and tensors.

    state: {"map": CrushMap.to_dict(), "osd_weight": [D] int,
    "exists": [D] bool, "isup": [D] bool, optional "primary_affinity":
    [D] int and "choose_args_name"} (numpy or lists).  Returns
    (DeviceMapper, {"osd_weight": int32, "exists": bool, "isup": bool,
    "keep": bool, "primary_affinity": int32 or None}) on the device."""
    dm = DeviceMapper(CrushMap.from_dict(state["map"]),
                      state.get("choose_args_name"), device)
    aff = state.get("primary_affinity")
    w_np, ex_np, iu_np, af_np = _host_state(
        state["osd_weight"], state["exists"], state["isup"], aff)
    return dm, {"osd_weight": dm._put(w_np, torch.int32),
                "exists": dm._put(ex_np), "isup": dm._put(iu_np),
                "keep": dm._put(ex_np & iu_np),
                "primary_affinity": (dm._put(af_np, torch.int32)
                                     if aff is not None else None)}
