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
DispatchTicket.  There is no host route to degrade to: a map outside
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


class OSDMapMapping:
    """Caches up/acting for every PG of every pool (OSDMapMapping.h:174)
    as dense arrays.  `device` picks the card (default) or, when the
    caller asks, the CPU; a given runtime or mapper brings its own."""

    def __init__(self, osdmap: OSDMap, device_mapper=None,
                 runtime=None, chip: int | None = None, device=None):
        self.epoch = osdmap.epoch
        self.pools: dict[int, PoolMapping] = {}
        self.device_pools = 0      # pools mapped on the device
        self.scalar_pools = 0      # kept at 0: no pool maps on the host
        self._build(osdmap, device_mapper, runtime, chip, device)

    def _build(self, osdmap: OSDMap, device_mapper, runtime,
               chip: int | None, device) -> None:
        state = np.asarray(osdmap.osd_state, dtype=np.int32)
        exists = (state & OSD_EXISTS) != 0
        isup = (state & OSD_UP) != 0
        aff = (np.asarray(osdmap.osd_primary_affinity, dtype=np.int32)
               if osdmap.osd_primary_affinity is not None else None)
        if runtime is None:
            runtime = DeviceRuntime.get(
                device_mapper.device if device_mapper is not None
                else default_device(device))
        dm = device_mapper
        for pool in osdmap.pools.values():
            target = runtime.route(chip)
            if dm is None:
                dm = osdmap.device_mapper(target.device)
            up, prim = self._map_pool_ticketed(osdmap, pool, dm, target,
                                               exists, isup, aff)
            self.device_pools += 1
            pm = PoolMapping(pool, up, prim)
            self._apply_exceptions(osdmap, pool, pm)
            self.pools[pool.id] = pm

    def _map_pool_ticketed(self, osdmap, pool, dm, chip, exists, isup,
                           aff):
        """One pool pass under a mapping-class ticket on the routed
        chip.  Sync context (map advance runs outside any op
        coroutine), so admission is the non-blocking form; DeviceBusy
        reaches the caller."""
        ticket = chip.open_ticket(K_MAPPING,
                                  chip.rt.bucket_for(pool.pg_num),
                                  pool.pg_num * pool.size * 4)
        chip.try_admit(ticket)
        chip.launch(ticket)
        try:
            up, prim = self._map_pool_device(osdmap, pool, dm, exists,
                                             isup, aff)
        except Exception as e:
            chip.finish(ticket, ok=False, error=e)
            raise
        chip.finish(ticket, ok=True)
        return up, prim

    # -- vectorized pool mapping ------------------------------------------

    def _map_pool_device(self, osdmap: OSDMap, pool: PGPool, dm,
                         exists, isup, aff):
        return dm.map_pool_batch(
            pool.crush_rule, pool.size, pool.pg_num, pool.pgp_num,
            pool.pgp_num_mask, pool.id,
            bool(pool.flags & FLAG_HASHPSPOOL), osdmap.osd_weight,
            exists, isup, aff, can_shift=pool.can_shift_osds())

    # -- sparse exceptions -------------------------------------------------

    def _apply_exceptions(self, osdmap: OSDMap, pool: PGPool,
                          pm: PoolMapping) -> None:
        """Recompute the (few) PGs carrying upmap/temp entries through
        the exact scalar pipeline and overwrite their rows."""
        excepted: set[int] = set()
        for table in (osdmap.pg_upmap, osdmap.pg_upmap_items,
                      osdmap.pg_upmap_primaries, osdmap.pg_temp,
                      osdmap.primary_temp):
            for pg in table:
                if pg.pool == pool.id and pg.ps < pool.pg_num:
                    excepted.add(pg.ps)
        for ps in excepted:
            pg = pg_t(pool.id, ps)
            up, upp, acting, actingp = osdmap.pg_to_up_acting_osds(pg)
            self._write_row(pm.up, ps, up)
            pm.up_primary[ps] = upp
            self._write_row(pm.acting, ps, acting)
            pm.acting_primary[ps] = actingp

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


def pps_for_pool(pool: PGPool, ps: np.ndarray) -> np.ndarray:
    """Vectorized raw_pg_to_pps over a pool's ps range."""
    from ..ops.crush.hashes import pps_seed_v
    return pps_seed_v(ps, pool.pgp_num, pool.pgp_num_mask, pool.id,
                      bool(pool.flags & FLAG_HASHPSPOOL))
