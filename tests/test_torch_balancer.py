"""The upmap balancer of the port, on the CPU, against the JAX package:
``_score_pass``, ``BalancerState``, ``calc_pg_upmaps``,
``batched_calc_pg_upmaps`` and ``osdmaptool``.

The candidate scorer is held bit for bit against the reference's on
seeded tables (numpy, and ``jax.numpy`` once).  The optimizers run at
``device="cpu"`` (the bulk mapper's plain K4/K5) on the 48-OSD,
1024-PG skewed-host map of tests/test_scale.py and on a map carrying a
``pg_upmap`` pin and stale ``pg_upmap_items``; each must emit the
reference's items, changes, stddevs and candidate counts.  The
reference's answers are computed once per module (its first bulk pass
compiles for ~10 s on the CPU).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.cli import osdmaptool as ref_tool
from ceph_tpu.models.crushmap import (CHOOSELEAF_FIRSTN, EMIT, STRAW2,
                                      TAKE, UNIFORM, CrushMap)
from ceph_tpu.osd import balancer as ref_bal
from ceph_tpu.osd.osdmap import (OSD_EXISTS, OSD_UP, Incremental, OSDMap,
                                 PGPool, pg_t)
from ceph_tpu.scale import balancer as ref_scale

from ceph_tpu_torch.cli import osdmaptool as tool
from ceph_tpu_torch.device.runtime import DeviceRuntime, K_MAPPING
from ceph_tpu_torch.ops.crush.device import DeviceMapper
from ceph_tpu_torch.osd import balancer as bal
from ceph_tpu_torch.osd.osdmap import OSDMap as POSDMap
from ceph_tpu_torch.scale import balancer as scale

torch.set_num_threads(1)

ITEM_NONE = 0x7FFFFFFF


def _skewed_host_map(hosts=12, per_host=4, pg_num=1024, size=3,
                     alg=STRAW2):
    """tests/test_scale.py's map: every 5th OSD at half weight."""
    n_osds = hosts * per_host
    crush = CrushMap()
    host_ids = []
    for h in range(hosts):
        items = list(range(h * per_host, (h + 1) * per_host))
        b = crush.add_bucket(alg, 1, items, [0x10000] * per_host,
                             id=-(h + 2))
        host_ids.append(b.id)
    crush.add_bucket(STRAW2, 2, host_ids,
                     [crush.buckets[h].weight for h in host_ids], id=-1)
    crush.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1),
                    (EMIT, 0, 0)], id=0)
    m = OSDMap()
    inc = Incremental(epoch=1)
    inc.new_max_osd = n_osds
    inc.new_crush = crush
    inc.new_pools[1] = PGPool(id=1, name="p", pg_num=pg_num, size=size,
                              crush_rule=0)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(n_osds):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x8000 if o % 5 == 0 else 0x10000
    m.apply_incremental(inc)
    return m


def _pin(m) -> None:
    """Give the skewed map a pg_upmap pin, one live and two stale
    pg_upmap_items entries (a source no longer in the raw row, a
    target already in it) and one OSD down."""
    pool = m.pools[1]
    inc = m.new_incremental()
    raw3, _ = m._pg_to_raw_osds(pool, pg_t(1, 3))
    inc.new_pg_upmap[pg_t(1, 3)] = [47, 43, 39]
    raw5, _ = m._pg_to_raw_osds(pool, pg_t(1, 5))
    free = next(o for o in range(48) if all(o // 4 != r // 4
                                            for r in raw5))
    inc.new_pg_upmap_items[pg_t(1, 5)] = [(raw5[0], free)]
    raw7, _ = m._pg_to_raw_osds(pool, pg_t(1, 7))
    gone = next(o for o in range(48) if o not in raw7)
    inc.new_pg_upmap_items[pg_t(1, 7)] = [(gone, raw7[0])]
    raw9, _ = m._pg_to_raw_osds(pool, pg_t(1, 9))
    inc.new_pg_upmap_items[pg_t(1, 9)] = [(raw9[0], raw9[1])]
    inc.new_state[46] = OSD_UP          # xor: down
    m.apply_incremental(inc)


MAPS = ("pinned", "skewed")


def _port(m) -> POSDMap:
    return POSDMap.from_dict(m.to_dict())


def _items(inc) -> dict:
    return {(pg.pool, pg.ps): [tuple(t) for t in items]
            for pg, items in inc.new_pg_upmap_items.items()}


def _old(inc) -> list:
    return sorted((pg.pool, pg.ps) for pg in inc.old_pg_upmap_items)


def _keyed(d: dict) -> dict:
    """pg_t-keyed rows or item lists, keyed by (pool, ps), items as
    tuples (the port's map comes through to_dict / from_dict)."""
    return {(pg.pool, pg.ps): [tuple(t) if isinstance(t, (list, tuple))
                               else t for t in v]
            for pg, v in d.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's answers, computed once: per map, its
    BalancerState, a batched tick at the defaults and at
    max_deviation 0.5, and calc_pg_upmaps(0.5, 100).  The pinned map
    is the skewed one after an incremental, so the reference's bulk
    mapper (kept across it, the crush map unchanged) compiles once."""
    out = {}
    m = _skewed_host_map()
    for name in ("skewed", "pinned"):
        if name == "pinned":
            _pin(m)
        st = ref_bal.BalancerState(m, None)
        ticks = {}
        for dev in (1.0, 0.5):
            inc = m.new_incremental()
            res = ref_scale.batched_calc_pg_upmaps(m, inc,
                                                   max_deviation=dev)
            ticks[dev] = (res, inc)
        inc = m.new_incremental()
        n = ref_bal.calc_pg_upmaps(m, inc, 0.5, 100)
        out[name] = {"map": m.to_dict(), "state": st, "ticks": ticks,
                     "calc": (n, inc)}
    return out


# -- the candidate scorer ---------------------------------------------------


def _score_tables(seed: int, c: int, s: int):
    """Candidate tables covering ITEM_NONE pads, _NO_DOMAIN rows,
    swaps into a duplicate domain, sources absent from the row,
    targets already in it, and rejected targets."""
    rng = np.random.default_rng(seed)
    n_osd = 24
    rows = np.stack([rng.permutation(n_osd)[:s] for _ in range(c)])
    rows = rows.astype(np.int64)
    pad = rng.random((c, s)) < 0.15
    pad[:, 0] = False
    rows[pad] = ITEM_NONE
    dom = rng.integers(0, 6, n_osd + 1)
    dom[n_osd] = -1
    no_dom = rng.random(c) < 0.3
    safe = np.where(rows == ITEM_NONE, n_osd, rows)
    dom_rows = dom[safe]
    dom_rows[no_dom] = -1
    dom_rows[(rng.random((c, s)) < 0.05)] = -1     # one slot unknown
    slot = rng.integers(0, s, c)
    cand_from = rows[np.arange(c), slot]
    absent = rng.random(c) < 0.1
    cand_from[absent] = rng.integers(0, n_osd, absent.sum())
    cand_to = rng.integers(0, n_osd, c).astype(np.int64)
    dom_to = dom[cand_to]
    dom_to[no_dom] = -1
    dev = rng.normal(0.0, 3.0, (c, 2))
    dev[rng.random(c) < 0.1] = 0.1 + 1.0 / 3.0     # rounding ties
    ok_target = rng.random(c) < 0.9
    return (rows, dom_rows, np.arange(c, dtype=np.int64), cand_from,
            cand_to, dev, ok_target, dom_to)


@pytest.mark.parametrize("seed,c,s", [(1, 4000, 3), (2, 1500, 6),
                                      (3, 257, 1), (4, 64, 11)])
def test_score_pass_matches_reference(seed, c, s):
    tables = _score_tables(seed, c, s)
    want_valid, want_score = ref_scale._score_pass(np, *tables)
    valid, score = scale._score_pass(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in tables])
    assert valid.dtype == torch.bool and score.dtype == torch.float32
    assert np.array_equal(valid.numpy(), want_valid)
    assert np.array_equal(score.numpy().view(np.uint32),
                          want_score.view(np.uint32))
    assert 0 < int(valid.sum()) < c
    if seed == 1:
        jv, js = ref_scale._score_pass(jnp, *map(jnp.asarray, tables))
        assert np.array_equal(valid.numpy(), np.asarray(jv))
        assert np.array_equal(score.numpy().view(np.uint32),
                              np.asarray(js).view(np.uint32))


# -- the optimizers at device="cpu" -----------------------------------------


@pytest.mark.parametrize("name", MAPS)
def test_balancer_state_matches_reference(ref, name):
    want = ref[name]["state"]
    st = bal.BalancerState(POSDMap.from_dict(ref[name]["map"]), None,
                           device="cpu")
    assert st.pool_ids == want.pool_ids
    for attr in ("pg_raw", "pg_up", "pinned", "new_items", "existing"):
        assert _keyed(getattr(st, attr)) == _keyed(getattr(want, attr)), \
            attr
    assert st.pg_domains == want.pg_domains
    assert st.counts == want.counts and st.target == want.target
    if name == "pinned":
        assert _keyed(st.pinned) and _keyed(st.existing)


@pytest.mark.parametrize("name,max_dev", [("skewed", 1.0),
                                          ("skewed", 0.5),
                                          ("pinned", 1.0),
                                          ("pinned", 0.5)])
def test_batched_matches_reference(ref, name, max_dev):
    want, want_inc = ref[name]["ticks"][max_dev]
    m = POSDMap.from_dict(ref[name]["map"])
    rt = DeviceRuntime.reset(device="cpu")
    inc = m.new_incremental()
    res = scale.batched_calc_pg_upmaps(m, inc, max_deviation=max_dev,
                                       device="cpu")
    assert _items(inc) == _items(want_inc)
    assert _old(inc) == _old(want_inc)
    for attr in ("changes", "rounds", "candidates_scored",
                 "device_rounds", "stddev_before", "stddev_after"):
        assert getattr(res, attr) == getattr(want, attr), attr
    assert res.changes > 0 and res.stddev_after < res.stddev_before
    assert res.host_rounds == 0 and res.device_rounds == res.rounds
    ring = rt.chips[0].tickets
    for t in res.tickets:
        assert t.klass == K_MAPPING and t.ok and t in ring
    assert max(t.nbytes for t in res.tickets) >= 1000 * 4


@pytest.mark.parametrize("name", MAPS)
def test_calc_pg_upmaps_matches_reference(ref, name):
    want_n, want_inc = ref[name]["calc"]
    m = POSDMap.from_dict(ref[name]["map"])
    inc = m.new_incremental()
    assert bal.calc_pg_upmaps(m, inc, 0.5, 100, device="cpu") == want_n
    assert _items(inc) == _items(want_inc)
    assert _old(inc) == _old(want_inc)


def test_batched_items_replay_through_the_reference_rules(ref):
    """tests/test_scale.py's replay on the port: sources are raw
    members, up sets keep distinct OSDs and failure domains, the item
    list's effect equals the applied map's up set, and the reported
    stddev equals the applied map's."""
    m = POSDMap.from_dict(ref["skewed"]["map"])
    inc = m.new_incremental()
    res = scale.batched_calc_pg_upmaps(m, inc, max_deviation=0.5,
                                       device="cpu")
    m2 = POSDMap.decode(m.encode())
    m2.apply_incremental(inc)
    domains = bal._failure_domains(m2, 0)
    assert m2.pg_upmap_items
    for pg, items in m2.pg_upmap_items.items():
        raw, _ = m2._pg_to_raw_osds(m2.pools[pg.pool], pg)
        assert all(f in raw for f, _t in items), (pg, items, raw)
        up, _, _, _ = m2.pg_to_up_acting_osds(pg)
        doms = [domains.get(o) for o in up]
        assert len(set(up)) == len(up)
        assert None not in doms and len(set(doms)) == len(doms)
        assert bal._effective_up(m2, raw, items) == up
    st2 = bal.BalancerState(m2, None, device="cpu")
    assert abs(scale._stddev(st2.counts, st2.target)
               - res.stddev_after) < 1e-9


def test_out_of_scope_map_takes_the_host_engine():
    """A uniform host bucket is outside the device mapper's scope: the
    pool's raw rows come from the exact host engine, as the
    reference's do, and both optimizers give the reference's items."""
    m = _skewed_host_map(hosts=6, pg_num=128, alg=UNIFORM)
    pm = _port(m)
    pool = m.pools[1]
    assert (bal._pool_raw(pm, pm.pools[1], "cpu")
            == ref_bal._pool_raw(m, pool))
    inc, pinc = m.new_incremental(), pm.new_incremental()
    want = ref_scale.batched_calc_pg_upmaps(m, inc, max_deviation=0.5)
    res = scale.batched_calc_pg_upmaps(pm, pinc, max_deviation=0.5,
                                       device="cpu")
    assert _items(pinc) == _items(inc) and res.changes == want.changes
    inc, pinc = m.new_incremental(), pm.new_incremental()
    assert (bal.calc_pg_upmaps(pm, pinc, 0.5, 100, device="cpu")
            == ref_bal.calc_pg_upmaps(m, inc, 0.5, 100))
    assert _items(pinc) == _items(inc)


def test_value_error_inside_the_pass_is_not_swallowed(monkeypatch):
    """Only OutOfDeviceScope selects the host engine: a ValueError
    raised by the device pass itself propagates, and the failed ticket
    is recorded without losing the chip."""
    pm = _port(_skewed_host_map(hosts=4, pg_num=64))

    def broken(*_a, **_k):
        raise ValueError("kernel shape error")

    def no_host(*_a, **_k):
        raise AssertionError("reached the host engine")

    monkeypatch.setattr(DeviceMapper, "map_pool_state", broken)
    monkeypatch.setattr(POSDMap, "_pg_to_raw_osds", no_host)
    rt = DeviceRuntime.reset(device="cpu")
    with pytest.raises(ValueError, match="kernel shape error"):
        bal.BalancerState(pm, None, device="cpu")
    with pytest.raises(ValueError, match="kernel shape error"):
        scale.batched_calc_pg_upmaps(pm, pm.new_incremental(),
                                     device="cpu")
    chip = rt.chips[0]
    assert not chip.lost and chip.queue.inflight == 0
    assert [t.ok for t in chip.tickets] == [False, False]


# -- osdmaptool ---------------------------------------------------------------


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_osdmaptool_matches_reference(tmp_path, capsys):
    ref_map = str(tmp_path / "ref.bin")
    port_map = str(tmp_path / "port.bin")
    args = ["--createsimple", "12", "--pg-num", "64"]
    _run(ref_tool.main, args + [ref_map], capsys)
    out = _run(tool.main, args + [port_map], capsys)
    assert "12 osds, pool rbd pg_num=64" in out
    with open(ref_map, "rb") as a, open(port_map, "rb") as b:
        assert a.read() == b.read()
    want = json.loads(_run(ref_tool.main, [ref_map, "--print"], capsys))
    assert json.loads(_run(tool.main, [port_map, "--print"],
                           capsys)) == want
    want = json.loads(_run(ref_tool.main, [ref_map, "--test-map-pgs"],
                           capsys))
    for extra in ([], ["--bulk", "--device", "cpu"]):
        got = json.loads(_run(tool.main, [port_map, "--test-map-pgs"]
                              + extra, capsys))
        assert got == want, extra
    outs = {}
    for main, src, name in ((ref_tool.main, ref_map, "ref"),
                            (tool.main, port_map, "port")):
        dst = str(tmp_path / (name + "-up.bin"))
        argv = [src, "--upmap", dst, "--upmap-deviation", "0.5"]
        if name == "port":
            argv += ["--device", "cpu"]
        line = _run(main, argv, capsys)
        with open(dst, "rb") as f:
            outs[name] = (line, POSDMap.decode(f.read()))
    assert outs["port"][0].split(";")[0] == outs["ref"][0].split(";")[0]
    got, want = (_keyed(outs[n][1].pg_upmap_items) for n in ("port", "ref"))
    assert got and got == want
