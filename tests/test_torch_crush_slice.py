"""The CRUSH placement slice of the port, on the CPU, against the JAX
package: ``DeviceMapper.map_pool_state`` / ``map_pool_batch`` /
``do_rule_batch``, ``MapState.remap`` and ``OSDMapMapping``.

Every value is an integer, so every comparison is exact.  Each of the
reference's bulk programs costs several seconds to compile on the CPU,
so one is compiled: the full pass of a replicated chooseleaf pool
without affinity.  The port's remaps are held against that pass of the
changed state (the reference proves its own remap equal to it,
test_crush_device.py::TestMapStateRemap) and, for a reweight increase,
against the reference's ``remap`` itself.  The reference's
``OSDMapMapping`` is held through its exact host route (the scalar
pipeline its own tests prove equal to its device route), and every
other case against the host engine (``host.Mapper``,
``pg_to_up_acting_osds``) and the golden CRUSH vectors.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from ceph_tpu.models.crushmap import (CHOOSE_FIRSTN, CHOOSE_INDEP,
                                      CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP,
                                      EMIT, STRAW2, TAKE, CrushMap,
                                      WeightSet)
from ceph_tpu.ops.crush.device import DeviceMapper as RefMapper
from ceph_tpu.ops.crush.hashes import pps_seed_v
from ceph_tpu.ops.crush.host import Mapper
from ceph_tpu.osd.osdmap import (OSD_EXISTS, OSD_UP, POOL_TYPE_ERASURE,
                                 Incremental, OSDMap, PGPool, pg_t)
from ceph_tpu.parallel.mapping import OSDMapMapping as RefMapping

from ceph_tpu_torch.device.runtime import DeviceBusy, DeviceRuntime
from ceph_tpu_torch.models.crushmap import CrushMap as PCrushMap
from ceph_tpu_torch.ops.crush import device as PD
from ceph_tpu_torch.osd.osdmap import OSDMap as POSDMap
from ceph_tpu_torch.parallel.mapping import OSDMapMapping, pps_for_pool

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NONE = 0x7FFFFFFF
PG = 1024           # lanes of the full-pass pool


def _hosts_map(hosts=6, per_host=5, seed=1):
    rng = random.Random(seed)
    m = CrushMap()
    ids = []
    for h in range(hosts):
        items = list(range(h * per_host, (h + 1) * per_host))
        w = [rng.choice([0x10000, 0x18000, 0x20000]) for _ in items]
        ids.append(m.add_bucket(STRAW2, 1, items, w, id=-(h + 2)).id)
    m.add_bucket(STRAW2, 2, ids, [m.buckets[h].weight for h in ids], id=-1)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1), (EMIT, 0, 0)],
               id=0)
    m.add_rule([(TAKE, -1, 0), (CHOOSELEAF_INDEP, 0, 1), (EMIT, 0, 0)],
               id=1)
    m.add_rule([(TAKE, -1, 0), (CHOOSE_FIRSTN, 0, 0), (EMIT, 0, 0)], id=2)
    m.add_rule([(TAKE, -1, 0), (CHOOSE_INDEP, 0, 1), (EMIT, 0, 0)], id=3)
    return m


def _port(m: CrushMap) -> PCrushMap:
    return PCrushMap.from_dict(m.to_dict())


def _np(t):
    return t.cpu().numpy()


def _host_rows(m, ruleno, xs, rmax, w, cargs=None):
    host = Mapper(m)
    out = np.full((len(xs), rmax), NONE, np.int32)
    for i, x in enumerate(xs):
        row = host.do_rule(ruleno, int(x), rmax, list(w),
                           choose_args=cargs)
        out[i, :len(row)] = row
    return out


# ---------------------------------------------------------------------------
# map_pool_state and remap (replicated chooseleaf pool, no affinity)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool_pass():
    """The reference mapper (compiled once) and the port's, with K7's
    row groups small enough that the remaps compact several."""
    m = _hosts_map()
    n = 30
    ref = RefMapper(m)
    port = PD.DeviceMapper(_port(m), device="cpu")
    port.RC_ROW = 128           # several row groups, a ragged one
    args = (0, 3, PG - 5, PG - 5, PG - 1, 1, True)
    state = {"w": np.full(n, 0x10000, np.int32),
             "ex": np.ones(n, bool), "iu": np.ones(n, bool)}

    def ref_pass(w, ex, iu):
        st = ref.map_pool_state(*args, w, ex, iu, None, True)
        return tuple(np.asarray(a) for a in (st.raw, st.up, st.prim))

    st = port.map_pool_state(*args, state["w"], state["ex"], state["iu"],
                             None, True)
    return m, ref, port, args, state, ref_pass, st


def _same(st, want):
    raw, up, prim = want
    pg = st.pg_num
    assert np.array_equal(_np(st.raw)[:pg], raw[:pg])
    assert np.array_equal(_np(st.up), up[:pg])
    assert np.array_equal(_np(st.prim), prim[:pg])


def test_map_pool_state_matches_reference(pool_pass):
    m, _ref, _port_dm, args, s, ref_pass, st = pool_pass
    _same(st, ref_pass(s["w"], s["ex"], s["iu"]))
    # K4 finishes every lane's retries in the full pass: none recomputed
    assert st.recomputed == 0
    assert (st.raw.dtype, st.up.dtype, st.prim.dtype) == (torch.int32,) * 3
    pps = pps_seed_v(np.arange(st.pg_num), args[3], args[4], args[5], True)
    assert np.array_equal(_np(st.raw), _host_rows(m, 0, pps, 3, s["w"]))


def test_remap_decrease_matches_full_pass(pool_pass):
    _m, _ref, _dm, _args, s, ref_pass, st = pool_pass
    w1, iu1 = s["w"].copy(), s["iu"].copy()
    for o in (2, 11, 23):
        w1[o] = 0
        iu1[o] = False
    w1[17] = 0x8000              # partial decrease
    st1 = st.remap(w1, s["ex"], iu1)
    assert 0 < st1.recomputed < st.pg_num
    _same(st1, ref_pass(w1, s["ex"], iu1))
    # chained incremental stays exact; the first state is untouched
    w2 = w1.copy()
    w2[5] = 0
    st2 = st1.remap(w2, s["ex"], iu1)
    _same(st2, ref_pass(w2, s["ex"], iu1))
    _same(st, ref_pass(s["w"], s["ex"], s["iu"]))
    assert st.remap(s["w"], s["ex"], s["iu"]) is st


def test_remap_up_down_only_matches_full_pass(pool_pass):
    _m, _ref, _dm, _args, s, ref_pass, st = pool_pass
    iu = s["iu"].copy()
    iu[[4, 9]] = False
    ex = s["ex"].copy()
    ex[20] = False
    st1 = st.remap(s["w"], ex, iu)
    _same(st1, ref_pass(s["w"], ex, iu))


def test_remap_increase_takes_full_pass_like_reference(pool_pass):
    _m, ref, _dm, args, s, ref_pass, st = pool_pass
    w1 = s["w"].copy()
    w1[[3, 8]] = 0
    st1 = st.remap(w1, s["ex"], s["iu"])
    w2 = w1.copy()
    w2[3] = 0x10000              # an increase: the full pass
    st2 = st1.remap(w2, s["ex"], s["iu"])
    assert st2.recomputed < st1.recomputed
    rst = ref.map_pool_state(*args, w1, s["ex"], s["iu"], None, True)
    rst2 = rst.remap(w2, s["ex"], s["iu"], None)
    _same(st2, tuple(np.asarray(a) for a in (rst2.raw, rst2.up, rst2.prim)))


def test_map_pool_batch_is_the_state(pool_pass):
    _m, _ref, dm, args, s, _rp, st = pool_pass
    up, prim = dm.map_pool_batch(*args, s["w"], s["ex"], s["iu"])
    assert np.array_equal(up, _np(st.up))
    assert np.array_equal(prim, _np(st.prim))


# ---------------------------------------------------------------------------
# OSDMapMapping
# ---------------------------------------------------------------------------


def _cluster(ec_only: bool, n_hosts=6, per_host=4, pg_num=256):
    """A small cluster map (reference OSDMap): one straw2 root over hosts
    over osds; an erasure pool (chooseleaf indep) and, unless ec_only, a
    replicated pool; churn: down OSDs, reweights, primary affinity,
    pg_temp, primary_temp, upmap and upmap items."""
    m = OSDMap()
    crush = _hosts_map(n_hosts, per_host, seed=3)
    n = n_hosts * per_host
    inc = Incremental(epoch=1)
    inc.new_max_osd = n
    inc.new_crush = crush
    inc.new_pools[2] = PGPool(id=2, name="ec", pg_num=pg_num, size=5,
                              type=POOL_TYPE_ERASURE, crush_rule=1,
                              min_size=4)
    if not ec_only:
        inc.new_pools[1] = PGPool(id=1, name="rbd", pg_num=pg_num - 56,
                                  size=3, crush_rule=0)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(n):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x10000
        inc.new_up_client[o] = "127.0.0.1:%d" % (6800 + o)
    m.apply_incremental(inc)
    rng = random.Random(0)
    inc = m.new_incremental()
    for o in rng.sample(range(n), 3):
        inc.new_state[o] = OSD_UP          # down
    for o in rng.sample(range(n), 3):
        inc.new_weight[o] = rng.choice([0, 0x8000])
    for o in rng.sample(range(n), 4):
        inc.new_primary_affinity[o] = rng.choice([0, 0x4000, 0xC000])
    inc.new_pg_temp[pg_t(2, 3)] = [1, 5, 9, 13, 17]
    inc.new_primary_temp[pg_t(2, 4)] = 9
    inc.new_pg_upmap[pg_t(2, 7)] = [0, 4, 8, 12, 16]
    inc.new_pg_upmap_items[pg_t(2, 8)] = [(rng.randrange(n),
                                           rng.randrange(n))]
    if not ec_only:
        inc.new_pg_upmap_items[pg_t(1, 4)] = [(2, 21)]
        inc.new_pg_temp[pg_t(1, 5)] = [3, 7, 11]
    m.apply_incremental(inc)
    return m


def _assert_host_parity(ref_map, mapping):
    for pool in ref_map.pools.values():
        for ps in range(pool.pg_num):
            pg = pg_t(pool.id, ps)
            assert mapping.get(pg) == ref_map.pg_to_up_acting_osds(pg), pg


class _HostRoute:
    """Sends the reference OSDMapMapping down its exact scalar pipeline
    (it takes that route on a ValueError from the device mapper)."""

    def map_pool_batch(self, *a, **kw):
        raise ValueError("host route")


def test_osdmapmapping_matches_reference():
    ref_map = _cluster(ec_only=False)
    port_map = POSDMap.from_dict(ref_map.to_dict())
    ref = RefMapping(ref_map, device_mapper=_HostRoute())
    got = OSDMapMapping(port_map, device="cpu")
    assert (got.device_pools, got.scalar_pools) == (2, 0)
    assert (ref.device_pools, ref.scalar_pools) == (0, 2)
    for pid, pm in ref.pools.items():
        for attr in ("up", "up_primary", "acting", "acting_primary"):
            assert np.array_equal(getattr(got.pools[pid], attr),
                                  getattr(pm, attr)), (pid, attr)
    ps = np.arange(256)
    assert np.array_equal(pps_for_pool(port_map.pools[2], ps),
                          pps_seed_v(ps, 256, 255, 2, True))


def test_osdmapmapping_matches_host():
    ref_map = _cluster(ec_only=True)
    port_map = POSDMap.from_dict(ref_map.to_dict())
    got = OSDMapMapping(port_map, device="cpu")
    assert (got.device_pools, got.scalar_pools) == (1, 0)
    _assert_host_parity(ref_map, got)
    for pool in port_map.pools.values():
        for ps in (0, 3, 4, 5, 7, 8):
            pg = pg_t(pool.id, ps)
            assert (port_map.pg_to_up_acting_osds(pg)
                    == ref_map.pg_to_up_acting_osds(pg))


def test_osdmapmapping_busy_queue_fails_the_build():
    """A full admission queue reaches the caller: there is no scalar
    route to degrade to."""
    port_map = POSDMap.from_dict(_cluster(ec_only=True).to_dict())
    rt = DeviceRuntime(device="cpu", max_inflight=1)
    rt.chips[0].queue.inflight = 1
    with pytest.raises(DeviceBusy):
        OSDMapMapping(port_map, runtime=rt)
    assert rt.chips[0].queue.rejected == 1
    rt.chips[0].queue.inflight = 0
    mapping = OSDMapMapping(port_map, runtime=rt)
    assert mapping.device_pools == 1
    assert rt.chips[0].dispatches == 1 and rt.chips[0].queue.inflight == 0
    assert rt.chips[0].tickets[-1].klass == "mapping"


# ---------------------------------------------------------------------------
# do_rule_batch: rule shapes, failures, choose_args, golden vectors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ruleno,rmax", [(0, 3), (1, 4), (2, 3), (3, 5),
                                         (0, 7), (1, 7)])
def test_do_rule_batch_matches_host(ruleno, rmax):
    """firstn and indep, leaf and not, more replicas than hosts; with a
    dead host, reweights and zero-weight items."""
    m = _hosts_map(seed=7)
    w = [0x10000] * 30
    for d in (0, 1, 2, 3, 4, 17):
        w[d] = 0
    w[12] = 0x4000
    m.buckets[-3].item_weights[1] = 0
    # more replicas than live hosts run every retry round, on the host
    # engine too: fewer inputs there
    n = 16 if rmax > 5 else 400
    xs = (np.arange(n, dtype=np.int64) * 2654435761) % (1 << 32)
    dm = PD.DeviceMapper(_port(m), device="cpu")
    assert np.array_equal(dm.do_rule_batch(ruleno, xs, rmax, w),
                          _host_rows(m, ruleno, xs, rmax, w))


def test_do_rule_batch_choose_args_matches_host():
    m = _hosts_map(seed=11)
    rng = random.Random(5)
    cargs = {}
    for bid, b in m.buckets.items():
        sets = [[rng.choice([0, 0x8000, 0x10000, 0x20000]) for _ in b.items]
                for _ in range(3)]
        ids = ([rng.randrange(1 << 20) for _ in b.items] if bid == -1
               else None)
        cargs[bid] = WeightSet(bucket_id=bid, weight_sets=sets, ids=ids)
    m.choose_args["opt"] = cargs
    dm = PD.DeviceMapper(_port(m), "opt", device="cpu")
    assert dm.fm.n_pos == 3
    xs = np.arange(600, dtype=np.int64)
    w = [0x10000] * 30
    w[6] = 0
    for ruleno in (0, 1):
        assert np.array_equal(dm.do_rule_batch(ruleno, xs, 3, w),
                              _host_rows(m, ruleno, xs, 3, w, cargs))


def test_do_rule_batch_crowded_map_matches_host():
    """A crowded map (4 hosts x 3 OSDs, one out, one partly rejected):
    many lanes retry a replica more than three times."""
    m = _hosts_map(hosts=4, per_host=3, seed=5)
    w = [0x10000] * 12
    w[3] = 0
    w[7] = 0x6000
    xs = (np.arange(400, dtype=np.int64) * 40503) % (1 << 32)
    dm = PD.DeviceMapper(_port(m), device="cpu")
    for ruleno, rmax in ((0, 3), (1, 4)):
        assert np.array_equal(dm.do_rule_batch(ruleno, xs, rmax, w),
                              _host_rows(m, ruleno, xs, rmax, w))


with open(os.path.join(GOLDEN, "crush_mappings.json")) as _f:
    _GOLDEN_CASES = json.load(_f)


@pytest.mark.parametrize("name", sorted(_GOLDEN_CASES))
def test_golden_crush_mappings(name):
    """Replay the reference-generated golden vectors; a map or rule
    outside the device scope must raise ValueError (legacy tunables,
    non-straw2 buckets, multi-choose rules) and nothing else."""
    case = _GOLDEN_CASES[name]
    m = PCrushMap.from_dict(case["map"])
    try:
        dm = PD.DeviceMapper(m, case.get("choose_args_name"), device="cpu")
    except ValueError:
        assert (any(b.alg != STRAW2 for b in m.buckets.values())
                or m.tunables.choose_local_tries
                or m.tunables.choose_local_fallback_tries), name
        return
    groups: dict[tuple, list] = {}
    for qi, (ruleno, x, rmax) in enumerate(case["queries"]):
        groups.setdefault((ruleno, rmax), []).append((qi, x))
    ran = 0
    for (ruleno, rmax), pairs in groups.items():
        try:
            got = dm.do_rule_batch(ruleno, [x for _, x in pairs], rmax,
                                   case["reweights"])
        except ValueError:
            steps = m.rules[ruleno].steps
            assert sum(op in (CHOOSE_FIRSTN, CHOOSE_INDEP,
                              CHOOSELEAF_FIRSTN, CHOOSELEAF_INDEP)
                       for op, _a, _b in steps) != 1, (name, ruleno)
            continue
        for row, (qi, x) in zip(got, pairs):
            want = case["results"][qi]
            want = want + [NONE] * (rmax - len(want))
            assert row.tolist() == want, (name, ruleno, x)
        ran += 1
    assert ran > 0, name


def test_out_of_scope_maps_raise():
    m = _hosts_map()
    m.add_rule([(TAKE, -1, 0), (CHOOSE_FIRSTN, 2, 1),
                (CHOOSELEAF_FIRSTN, 1, 0), (EMIT, 0, 0)], id=9)
    dm = PD.DeviceMapper(_port(m), device="cpu")
    with pytest.raises(ValueError, match="single choose"):
        dm.do_rule_batch(9, [1, 2], 3, [0x10000] * 30)
    legacy = _port(m)
    legacy.tunables.choose_local_tries = 2
    with pytest.raises(ValueError, match="local tries"):
        PD.DeviceMapper(legacy, device="cpu")
