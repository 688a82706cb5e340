"""Bulk PG mapping: the whole cluster's PG->OSD table in one device pass
per pool.

Counterpart of ceph_tpu/parallel/mapping.py, the replacement for the
reference's ParallelPGMapper thread pool (src/osd/OSDMapMapping.h:
18-120, used by the mgr and by OSDMonitor to prime pg_temp at
OSDMonitor.cc:728-735,1067): all PGs of a pool become one batch through
the device mapper (ops.crush.device), which fuses do_rule with the
post-CRUSH pipeline (up-filter, compaction, primary pick, primary
affinity — OSDMap.cc:2626-2802).  Results stay dense numpy arrays per
pool; the sparse exception tables (pg_upmap*, pg_temp, primary_temp)
are applied by recomputing only the excepted PGs through the exact
host pipeline — the semantics of those tables, as in the reference.

Each pool pass is admitted on the routed chip of the device runtime
under the "mapping" class (weight below client/recovery EC), with the
non-blocking admission of synchronous callers, and carries a
DispatchTicket.  Every mapping-class ticket (these passes, the upmap
balancer's raw rows, the scale balancer's scoring rounds) is opened and
closed by `MappingDispatch`, which owns the host spans `map.admit` and
`map.finish`.  There is no host route to degrade to: a map outside
the device scope (ValueError), a full admission queue (DeviceBusy) or a
device fault fails the build.
"""

from __future__ import annotations

import numpy as np

from .. import default_device
from ..device.runtime import DeviceRuntime, K_MAPPING
from ..models.crushmap import ITEM_NONE
from ..osd.osdmap import (FLAG_HASHPSPOOL, OSD_EXISTS, OSD_UP, OSDMap,
                          PGPool, pg_t)
from ..trace.recorder import HostSpan


class PoolMapping:
    """Dense up/acting arrays for one pool ([pg_num, size] int32 with
    ITEM_NONE holes; compacted rows for replicated pools)."""

    __slots__ = ("pool_id", "can_shift", "up", "up_primary", "acting",
                 "acting_primary")

    def __init__(self, pool: PGPool, up: np.ndarray,
                 up_primary: np.ndarray):
        self.pool_id = pool.id
        self.can_shift = pool.can_shift_osds()
        self.up = up
        self.up_primary = up_primary
        self.acting = up.copy()
        self.acting_primary = up_primary.copy()

    def _row(self, arr: np.ndarray, ps: int) -> list[int]:
        row = arr[ps].tolist()
        if self.can_shift:
            return [v for v in row if v != ITEM_NONE]
        return row

    def get(self, ps: int) -> tuple[list[int], int, list[int], int]:
        return (self._row(self.up, ps), int(self.up_primary[ps]),
                self._row(self.acting, ps), int(self.acting_primary[ps]))


class MappingDispatch:
    """`with MappingDispatch(chip, lanes, nbytes) as ticket:` runs its
    body as one mapping-class dispatch on `chip`: the ticket (bucket
    `chip.rt.bucket_for(lanes)`) is opened, admitted with the
    non-blocking form of synchronous callers and launched inside the
    host span `map.admit`, and closed inside `map.finish`, failed when
    the launch or the body raises (which marks the chip lost unless the
    error is DeviceBusy or a ValueError).  A refusal at admission
    (DeviceBusy, DeviceLost) propagates with no ticket finished.
    `span`, where given, carries the ticket's seq; `ticket` is the
    admitted ticket, None until admission."""

    def __init__(self, chip, lanes: int, nbytes: int,
                 span: HostSpan | None = None):
        self.chip = chip
        self.lanes = lanes
        self.nbytes = nbytes
        self.span = span
        self.ticket = None

    def __enter__(self):
        chip = self.chip
        try:
            with HostSpan("map.admit"):
                ticket = chip.open_ticket(
                    K_MAPPING, chip.rt.bucket_for(self.lanes), self.nbytes)
                if self.span is not None:
                    self.span.ticket = ticket.seq
                chip.try_admit(ticket)
                self.ticket = ticket
                chip.launch(ticket)     # may raise an injected fault
        except Exception as e:
            self.__exit__(type(e), e, None)
            raise
        return ticket

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.ticket is not None:
            with HostSpan("map.finish"):
                self.chip.finish(self.ticket, ok=exc is None, error=exc)
        return False


def pool_pass_args(osdmap: OSDMap, pool: PGPool) -> dict:
    """The bulk mapper's arguments for one pass over `pool`
    (`DeviceMapper.map_pool_batch` / `map_pool_state` keywords): the
    pool's fields and the map's reweights, exists/up masks and primary
    affinities."""
    state = np.asarray(osdmap.osd_state, dtype=np.int32)
    aff = (np.asarray(osdmap.osd_primary_affinity, dtype=np.int32)
           if osdmap.osd_primary_affinity is not None else None)
    return dict(ruleno=pool.crush_rule, result_max=pool.size,
                pg_num=pool.pg_num, pgp_num=pool.pgp_num,
                pgp_num_mask=pool.pgp_num_mask, pool_id=pool.id,
                hashpspool=bool(pool.flags & FLAG_HASHPSPOOL),
                dev_weights=osdmap.osd_weight,
                exists=(state & OSD_EXISTS) != 0,
                isup=(state & OSD_UP) != 0, aff=aff,
                can_shift=pool.can_shift_osds())


class OSDMapMapping:
    """Caches up/acting for every PG of every pool (OSDMapMapping.h:174)
    as dense arrays.  `device` picks the card (default) or, when the
    caller asks, the CPU; a given runtime brings its own."""

    def __init__(self, osdmap: OSDMap, runtime=None,
                 chip: int | None = None, device=None):
        self.epoch = osdmap.epoch
        self.pools: dict[int, PoolMapping] = {}
        with HostSpan("mapping.build", {"pools": len(osdmap.pools)}):
            self._build(osdmap, runtime, chip, device)

    def _build(self, osdmap: OSDMap, runtime, chip: int | None,
               device) -> None:
        """One pass per pool, each under a mapping-class ticket on the
        routed chip.  Sync context (map advance runs outside any op
        coroutine, or an executor thread), so admission is the
        non-blocking form; DeviceBusy reaches the caller."""
        if runtime is None:
            runtime = DeviceRuntime.get(default_device(device))
        dm = None
        for pool in osdmap.pools.values():
            target = runtime.route(chip)
            if dm is None:
                dm = osdmap.device_mapper(target.device)
            args = pool_pass_args(osdmap, pool)
            with HostSpan("mapping.ticket") as span:
                with MappingDispatch(target, pool.pg_num,
                                     pool.pg_num * pool.size * 4,
                                     span) as ticket:
                    up, prim = dm.map_pool_batch(
                        **args, marks=ticket.phase_marks)
                if ticket.phase_s is not None:
                    # the pass's K4 launches, timed on the chip's stream
                    span.counts = {"choose_ns": int(ticket.phase_s * 1e9)}
            with HostSpan("mapping.rows") as span:
                pm = PoolMapping(pool, up, prim)
                span.counts = {"excepted": self._apply_exceptions(
                    osdmap, pool, pm)}
            self.pools[pool.id] = pm

    # -- sparse exceptions -------------------------------------------------

    def _apply_exceptions(self, osdmap: OSDMap, pool: PGPool,
                          pm: PoolMapping) -> int:
        """Recompute the (few) PGs carrying upmap entries through the
        exact scalar pipeline and overwrite their rows.  A PG with only
        temp entries keeps the device's up row and up primary (the
        pipeline's up side, which temp does not touch) and takes its
        acting side from the temp overlay (`_get_temp_osds`), as the
        pipeline does.  Returns the number of PGs rewritten."""
        upmapped: set[int] = set()
        for table in (osdmap.pg_upmap, osdmap.pg_upmap_items,
                      osdmap.pg_upmap_primaries):
            for pg in table:
                if pg.pool == pool.id and pg.ps < pool.pg_num:
                    upmapped.add(pg.ps)
        temp: set[int] = set()
        for table in (osdmap.pg_temp, osdmap.primary_temp):
            for pg in table:
                if pg.pool == pool.id and pg.ps < pool.pg_num:
                    temp.add(pg.ps)
        for ps in upmapped:
            pg = pg_t(pool.id, ps)
            up, upp, acting, actingp = osdmap.pg_to_up_acting_osds(pg)
            self._write_row(pm.up, ps, up)
            pm.up_primary[ps] = upp
            self._write_row(pm.acting, ps, acting)
            pm.acting_primary[ps] = actingp
        for ps in temp - upmapped:
            acting, actingp = osdmap._get_temp_osds(pool, pg_t(pool.id,
                                                               ps))
            if not acting:
                acting = pm._row(pm.up, ps)
                if actingp == -1:
                    actingp = int(pm.up_primary[ps])
            self._write_row(pm.acting, ps, acting)
            pm.acting_primary[ps] = actingp
        return len(upmapped | temp)

    @staticmethod
    def _write_row(arr: np.ndarray, ps: int, vals: list[int]) -> None:
        n = min(len(vals), arr.shape[1])
        arr[ps, :n] = vals[:n]
        arr[ps, n:] = ITEM_NONE

    # -- lookup ------------------------------------------------------------

    def get(self, pg: pg_t) -> tuple[list[int], int, list[int], int]:
        pm = self.pools.get(pg.pool)
        if pm is None or pg.ps >= pm.up.shape[0]:
            return [], -1, [], -1
        return pm.get(pg.ps)

