"""Erasure-coded placement on the port's bulk mapper: an 8+3 pool under
Ceph's indep rule (set_chooseleaf_tries 5, set_choose_tries 100,
chooseleaf indep 0 type host) on a root -> rack -> host -> OSD map,
against the benchmark's plain reference (`portbench/reference/
crush_indep.py`) and the port's scalar host engine, through epochs that
mark OSDs down, out and back in; and the spans the pass records.

On the CPU `device="cpu"` runs the kernels' plain versions; the one
`cuda` test runs K4/K5 on the card and skips without one."""

import numpy as np
import pytest

from ceph_tpu_torch.models.crushmap import ITEM_NONE
from ceph_tpu_torch.ops.crush.host import Mapper
from ceph_tpu_torch.osd.osdmap import OSD_UP
from ceph_tpu_torch.parallel.mapping import OSDMapMapping
from ceph_tpu_torch.trace import recorder
from portbench.drivers import osdmap_epochs_ec as drv
from portbench.reference import crush_indep, straw2

# the configuration's shape at toy size: 4 racks x 4 hosts x 3 OSDs
CFG = {"hosts": 16, "per_host": 3, "hosts_per_rack": 4,
       "crush_weight": 0x10000,
       "rule": [[9, 5, 0], [8, 100, 0], [1, -1, 0], [7, 0, 1], [4, 0, 0]],
       "pool_id": 1, "pg_num": 512, "size": 11, "k": 8, "m": 3}
N = 48
MIX = {"max_step": 4, "max_failed": 12}


def _mapped(m, device="cpu"):
    pm = OSDMapMapping(m, device=device).pools[CFG["pool_id"]]
    return pm.up.astype(np.int64), pm.up_primary.astype(np.int64)


def _reference(reweight, isup, ps=None):
    ps = np.arange(CFG["pg_num"]) if ps is None else ps
    return drv.reference_rows(CFG, ps, np.asarray(reweight, np.int64),
                              np.asarray(isup, bool))


def _advance(seed, want):
    """The map after the mix's first epoch (from the second on) whose
    state `want` names: "down" (OSDs down, none out), "out" (some out)
    or "revive" (its move brought OSDs back)."""
    m = drv.initial_map(CFG)
    stream = drv.DownOutStream(MIX, seed, N)
    for i in range(60):
        change = stream.next()
        m.apply_incremental(drv.incremental(m, change))
        downs = (~stream.up).sum()
        outs = (stream.reweight == 0).sum()
        if i and {"down": downs and not outs, "out": outs,
                  "revive": "revive" in change}[want]:
            return m, stream
    raise AssertionError("the mix made no %s epoch" % want)


@pytest.mark.parametrize("want", ["down", "out", "revive"])
@pytest.mark.parametrize("seed", [2**33 + 11, 2**40 + 3])
def test_positional_rows_match_the_reference(seed, want):
    m, stream = _advance(seed, want)
    up, prim = _mapped(m)
    ref_up, ref_prim = _reference(stream.reweight, stream.up)
    assert np.array_equal(up, ref_up)
    assert np.array_equal(prim, ref_prim)
    # positional: every row keeps 11 positions, holes where OSDs are down
    assert up.shape == (CFG["pg_num"], CFG["size"])
    down = np.nonzero(~stream.up)[0]
    assert not np.isin(up, down).any()


def _host_rows(crush, xs, reweight):
    mapper = Mapper(crush)
    return np.array([mapper.do_rule(0, int(x), CFG["size"],
                                    [int(w) for w in reweight])
                     for x in xs], dtype=np.int64)


@pytest.mark.parametrize("case", ["all_in", "some_out", "hosts_out"])
def test_raw_rows_match_the_host_engine(case):
    """The reference's raw rows against the host engine's do_rule and
    K4's plain version; with 12 of 16 hosts out, 7 positions find no
    host and fall back to ITEM_NONE after the rule's 100 tries."""
    reweight = np.full(N, 0x10000, dtype=np.int64)
    npg = 48
    if case == "some_out":
        reweight[[1, 5, 9, 20, 33]] = 0
        reweight[[2, 40]] = 0x8000
    elif case == "hosts_out":
        reweight[:12 * 3] = 0
        npg = 4
    crush = drv.build_crush(CFG, np.full(N, 0x10000))
    tree = drv.reference_tree(CFG, np.full(N, 0x10000))
    xs = straw2.pps(np.arange(npg), CFG["pg_num"], CFG["pool_id"])
    ref = crush_indep.do_rule(tree, CFG["rule"], xs, CFG["size"], reweight)
    assert np.array_equal(_host_rows(crush, xs, reweight), ref)
    from ceph_tpu_torch.ops.crush.device import DeviceMapper
    k4 = DeviceMapper(crush, device="cpu").do_rule_batch(
        0, xs, CFG["size"], reweight.astype(np.int32))
    assert np.array_equal(k4.astype(np.int64), ref)
    if case == "hosts_out":
        placed = (ref != ITEM_NONE).sum(axis=1)
        assert (placed == 4).all()       # one shard on each host still in
        assert (ref[ref != ITEM_NONE] >= 36).all()


@pytest.mark.parametrize("change", ["down", "out"])
def test_indep_keeps_positions(change):
    """A down OSD leaves a hole at its position and no other shard
    moves; an out OSD's position is refilled, in its host unless the
    rule's 5 leaf tries all draw it, and the other ten keep their OSDs
    there.  Rows that never held the OSD do not change."""
    m = drv.initial_map(CFG)
    up0, _ = _mapped(m)
    d = int(np.bincount(up0[up0 != ITEM_NONE]).argmax())
    had = (up0 == d).any(axis=1)
    inc = m.new_incremental()
    inc.new_state[d] = OSD_UP
    m.apply_incremental(inc)
    if change == "down":
        up1, prim1 = _mapped(m)
        assert np.array_equal(up1, np.where(up0 == d, ITEM_NONE, up0))
        first = np.argmax(up1 != ITEM_NONE, axis=1)
        assert np.array_equal(prim1, up1[np.arange(len(up1)), first])
        return
    inc = m.new_incremental()
    inc.new_weight[d] = 0
    m.apply_incremental(inc)
    up1, _ = _mapped(m)
    assert np.array_equal(up1[~had], up0[~had])
    pos = np.argmax(up0[had] == d, axis=1)
    rows = np.arange(had.sum())
    refill = up1[had][rows, pos]
    assert (refill != d).all() and (refill != ITEM_NONE).all()
    same_host = refill // CFG["per_host"] == d // CFG["per_host"]
    assert same_host.mean() > 0.9
    others = np.ones_like(up0[had], dtype=bool)
    others[rows, pos] = False
    kept = (up1[had] == up0[had]) | ~others
    assert kept[same_host].all()


def _spans(m, device):
    was = recorder.enabled()
    recorder.set_enabled(True)
    recorder.drain_host_spans()
    try:
        OSDMapMapping(m, device=device)
        return recorder.drain_host_spans()
    finally:
        recorder.set_enabled(was)


def test_the_pass_counts_its_choose_step():
    """`map.choose` carries the plan's positions and its indep flag; the
    ticket span the pass's timed choose step (`choose_ns`: CUDA events
    on a card; on the CPU, where the plain kernels run in the caller's
    thread, the host clock), inside the ticket's own device time."""
    from ceph_tpu_torch.device.runtime import DeviceRuntime
    spans = _spans(drv.initial_map(CFG), "cpu")
    choose = [s["counts"] for s in spans if s["name"] == "map.choose"]
    assert choose == [{"lanes": 512, "slots": 11, "indep": 1}]
    ticket = next(s for s in spans if s["name"] == "mapping.ticket")
    chip = DeviceRuntime.get("cpu").chips[0]
    t = next(t for t in chip.tickets if t.seq == ticket["ticket"])
    assert 0 < ticket["counts"]["choose_ns"] <= t.device_s * 1e9


@pytest.mark.cuda
def test_ec_pass_on_card_matches_and_times_its_choose_step():
    """At the configuration's full map (7200 OSDs, 159 KB packed: K4's
    unstaged form) a 65536-PG pass on the card equals the reference on
    a sample, and its ticket span's `choose_ns` lies in (0, device_s]."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from ceph_tpu_torch.device.runtime import DeviceRuntime
    from ceph_tpu_torch.ops.crush import kernels as K
    cfg = dict(CFG, hosts=360, per_host=20, hosts_per_rack=20,
               pg_num=65536)
    m = drv.initial_map(cfg)
    dev = torch.device("cuda", 0)
    tables = m.device_mapper(dev).fm.tables
    assert K.LN_BYTES + tables.packed.shape[0] > K.CHOOSE_SMEM_MAX
    spans = _spans(m, dev)
    ticket = next(s for s in spans if s["name"] == "mapping.ticket")
    chip = DeviceRuntime.get(dev).chips[0]
    t = next(t for t in chip.tickets if t.seq == ticket["ticket"])
    assert 0 < ticket["counts"]["choose_ns"] <= t.device_s * 1e9
    pm = OSDMapMapping(m, device=dev).pools[cfg["pool_id"]]
    ps = np.random.default_rng(5).choice(cfg["pg_num"], 2048,
                                         replace=False)
    n = cfg["hosts"] * cfg["per_host"]
    up, prim = drv.reference_rows(cfg, ps, np.full(n, 0x10000),
                                  np.ones(n, bool))
    assert np.array_equal(pm.up[ps].astype(np.int64), up)
    assert np.array_equal(pm.up_primary[ps].astype(np.int64), prim)
